"""Data-parallel rank-parity smoke test, Horovod flavour (the counterpart
of the JAX package's ``examples/example_horovod.py``).

Rank 0's parameters are broadcast first (``parallel/dp.py:broadcast_params``,
``hvd.broadcast_parameters``); each rank trains on its own shard of the
24-sample set from ``DistributedSampler(24, world, rank, seed=0)`` at
``12 // world`` rows a step, and the gradients are averaged inside the
optimizer's step (``dp.DistributedOptimizer``); SGD at lr 0.001.  Prints
each rank's ``initial``, ``synced``, and per step ``inputs``, ``labels``,
``loss`` and ``parameters`` sums, then ``PARITY-OK <sum>``.

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m pytorch_distributed_rnn_tpu_torch.examples.example_horovod [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from pytorch_distributed_rnn_tpu_torch.data.sampler import DistributedSampler
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
    dp.broadcast_params(model.parameters(), group)
    print("rank", rank, "synced:", param_sum(model))
    features, labels = toy_data(device)
    batch_size = 12 // world
    shard = torch.from_numpy(DistributedSampler(SAMPLES, world, rank, seed=0).indices())
    optimizer = dp.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LEARNING_RATE), group)
    for start in range(0, SAMPLES // world, batch_size):
        idx = shard[start:start + batch_size].to(device)
        x, y = features[idx], labels[idx]
        print("rank", rank, "inputs:", float(x.sum()))
        print("rank", rank, "labels:", float(y.sum()))
        optimizer.zero_grad()
        loss = mse_loss(model(x), y)
        loss.backward()
        optimizer.step()
        print("rank", rank, "loss:", float(loss.detach()))
        print("rank", rank, "parameters:", param_sum(model))
    return check_parity(group, param_sum(model), device)


def main(argv=None) -> float:
    return example_main(run, argv, "Horovod-flavour rank-parity smoke test on the toy model")


if __name__ == "__main__":
    main(sys.argv[1:])
