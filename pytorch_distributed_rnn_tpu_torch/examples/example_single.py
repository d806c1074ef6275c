"""Single-process smoke test: one forward, backward and SGD step of a lone
Linear(10, 10) under MSE, then the parameters printed (the counterpart of
the JAX package's ``examples/example_single.py``).

    python -m pytorch_distributed_rnn_tpu_torch.examples.example_single [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from pytorch_distributed_rnn_tpu_torch.examples import LEARNING_RATE
from pytorch_distributed_rnn_tpu_torch.ops.initializers import linear_init
from pytorch_distributed_rnn_tpu_torch.ops.losses import mse_loss
from pytorch_distributed_rnn_tpu_torch.utils import resolve_device


def run(state_dict=None, inputs=None, device="cuda") -> float:
    """One step from ``state_dict`` (``{"weight", "bias"}``; default seeded)
    on ``inputs`` (``(x, labels)``, each (20, 10); default seeded normal
    draws); prints the updated parameters and returns their sum."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(0)
    layer = torch.nn.Linear(10, 10)
    with torch.no_grad():
        for name, value in (state_dict or linear_init(generator, 10, 10)).items():
            getattr(layer, name).copy_(torch.as_tensor(value))
    if inputs is None:
        inputs = (torch.randn((20, 10), generator=generator),
                  torch.randn((20, 10), generator=generator))
    layer = layer.to(device)
    x, labels = (torch.as_tensor(v, dtype=torch.float32).to(device) for v in inputs)
    mse_loss(layer(x), labels).backward()
    with torch.no_grad():
        for p in layer.parameters():
            p.sub_(LEARNING_RATE * p.grad)
    params = {name: p.detach().cpu() for name, p in layer.named_parameters()}
    print(params)
    return sum(float(p.sum()) for p in params.values())


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return run(device=parser.parse_args(argv).device)


if __name__ == "__main__":
    main(sys.argv[1:])
