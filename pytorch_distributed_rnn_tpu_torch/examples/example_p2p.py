"""Point-to-point smoke test (the counterpart of the JAX package's
``examples/example_p2p.py``, after the reference's
``example_distributed.py``): rank 0's 1.0 is relayed around the ranks
with ``send``/``recv``, rank r receiving from r - 1 and sending to r + 1;
each rank prints ``Rank  i  has data  1.0``.

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m pytorch_distributed_rnn_tpu_torch.examples.example_p2p [--device cpu]
"""

from __future__ import annotations

import sys

import torch

from pytorch_distributed_rnn_tpu_torch.examples import example_main


def run(group, state_dict=None) -> float:
    rank, world = group.rank, group.size
    data = torch.zeros(1, device=group.device)
    if rank == 0:
        data += 1
    else:
        group.recv_(data, rank - 1)
    if rank + 1 < world:
        group.send(data, rank + 1)
    value = float(data[0])
    print("Rank ", rank, " has data ", value)
    if value != 1.0:
        raise RuntimeError(f"rank {rank} received {value}, not 1.0")
    return value


def main(argv=None) -> float:
    return example_main(run, argv, "send/recv relay of rank 0's 1.0")


if __name__ == "__main__":
    main(sys.argv[1:])
