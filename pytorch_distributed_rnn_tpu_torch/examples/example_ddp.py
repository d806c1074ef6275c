"""Data-parallel rank-parity smoke test, DDP flavour (the counterpart of
the JAX package's ``examples/example_ddp.py``, after the reference's
``example_ddp.py``).

Every rank holds a seeded ``ToyModel``; ``DistributedDataParallel``
(``parallel/dp.py:wrap_ddp``) broadcasts rank 0's parameters at
construction and averages the gradients in the backward; SGD at lr 0.001
on the 24-sample set at ``12 // world`` rows a step.  The reference's
quirk is kept: no sampler, so every rank walks the whole set.  Prints each
rank's ``initial``, ``synced``, and per step ``grad`` (the previous step's
averaged gradient sum), ``batch``, ``loss`` and ``parameters`` sums, then
``PARITY-OK <sum>`` when every rank ends with the same parameters.

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m pytorch_distributed_rnn_tpu_torch.examples.example_ddp [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from pytorch_distributed_rnn_tpu_torch.examples import (
    LEARNING_RATE,
    SAMPLES,
    check_parity,
    example_main,
    param_sum,
    toy_data,
)
from pytorch_distributed_rnn_tpu_torch.models import ToyModel
from pytorch_distributed_rnn_tpu_torch.ops.losses import mse_loss
from pytorch_distributed_rnn_tpu_torch.parallel import dp


def run(group, state_dict=None) -> float:
    world, rank, device = group.size, group.rank, group.device
    if world > 12:
        raise SystemExit(f"this example's 24-sample dataset supports at most 12 ranks "
                         f"(per-rank batch = 12 // world); got world={world}")
    model = ToyModel()
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(device)
    print("rank", rank, "initial:", param_sum(model))
    ddp = dp.wrap_ddp(model, group)
    print("rank", rank, "synced:", param_sum(model))
    features, labels = toy_data(device)
    batch_size = 12 // world
    optimizer = torch.optim.SGD(model.parameters(), lr=LEARNING_RATE)
    last_grad = None
    for start in range(0, SAMPLES, batch_size):
        x, y = features[start:start + batch_size], labels[start:start + batch_size]
        print("rank", rank, "grad:", last_grad)
        print("rank", rank, "batch:", float(x.sum() + y.sum()))
        optimizer.zero_grad()
        loss = mse_loss(ddp(x), y)
        loss.backward()
        optimizer.step()
        print("rank", rank, "loss:", float(loss.detach()))
        print("rank", rank, "parameters:", param_sum(model))
        last_grad = sum(float(p.grad.sum()) for p in model.parameters())
    return check_parity(group, param_sum(model), device)


def main(argv=None) -> float:
    return example_main(run, argv, "DDP rank-parity smoke test on the toy model")


if __name__ == "__main__":
    main(sys.argv[1:])
