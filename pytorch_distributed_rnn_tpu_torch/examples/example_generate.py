"""Train a tiny char LM and sample from it (the counterpart of the JAX
package's ``examples/example_generate.py``).

Trains a 1-layer ``CharRNN`` with Adam for 300 steps on a deterministic
successor stream (each token's successor is fixed, so the LM can drive
its next-token loss to about 0), then decodes greedily and with
temperature sampling.  Greedy decoding must reproduce the successor
chain; the printed check asserts it.

    python -m pytorch_distributed_rnn_tpu_torch.examples.example_generate [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from pytorch_distributed_rnn_tpu_torch.models import CharRNN
from pytorch_distributed_rnn_tpu_torch.utils import resolve_device

VOCAB = 32
SEED = 0
STEPS = 300


def successor(tok):
    """The ground-truth next token: a fixed permutation of the vocab."""
    return (7 * tok + 3) % VOCAB


def run(device="cuda", state_dict=None) -> dict:
    """Train from ``state_dict`` (default: seeded), decode; returns the
    final loss and the greedy and sampled sequences."""
    device = resolve_device(device)
    model = CharRNN(vocab_size=VOCAB, embed_dim=16, hidden_dim=64, layer_dim=1,
                    impl="scan", generator=torch.Generator().manual_seed(SEED))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=3e-3)
    rng = np.random.RandomState(SEED)
    loss = None
    for _ in range(STEPS):
        start = rng.randint(0, VOCAB, size=(16, 1)).astype(np.int64)
        seq = [start]
        for _ in range(24):
            seq.append(successor(seq[-1]))
        tokens = torch.from_numpy(np.concatenate(seq, axis=1)).to(device)
        loss = model.loss(tokens)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
    loss = loss.item()
    print(f"final next-token loss after {STEPS} steps: {loss:.4f}")

    model.eval()
    prompt = torch.tensor([[1, successor(1)]], device=device)
    greedy = model.generate(prompt, 8, temperature=0.0)[0].tolist()
    expected = [1, successor(1)]
    for _ in range(8):
        expected.append(successor(expected[-1]))
    print(f"greedy decode:   {greedy}")
    print(f"successor chain: {expected}")
    if greedy != expected:
        raise RuntimeError("greedy decode diverged from the chain")

    generator = torch.Generator(device=device).manual_seed(42)
    sampled = model.generate(prompt, 8, generator=generator, temperature=1.0)[0].tolist()
    print(f"temperature 1.0: {sampled}")
    print("generation ok")
    return {"loss": loss, "greedy": greedy, "sampled": sampled}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return run(device=parser.parse_args(argv).device)


if __name__ == "__main__":
    main(sys.argv[1:])
