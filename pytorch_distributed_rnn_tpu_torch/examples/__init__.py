"""The reference's toy-model examples on the port, the counterparts of the
JAX package's ``examples/example_{single,ddp,horovod,p2p}.py``.

The data-parallel ones run one process a rank under ``torchrun``::

    python -m torch.distributed.run --nproc-per-node W \\
        -m pytorch_distributed_rnn_tpu_torch.examples.example_ddp [--device cpu]

(``example_horovod``, ``example_p2p`` alike; ``example_single`` runs
alone), on the card unless ``--device cpu`` is given.  Each prints the
reference's per-rank lines and, for the data-parallel ones, ``PARITY-OK
<sum>`` when every rank ends with the same parameters.  Each ``run``
takes its initial parameters (a ``state_dict``; ``--init PATH`` on the
command line) so that tests can start it from JAX's, and returns the
final parameter sum.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

SAMPLES = 24
LEARNING_RATE = 0.001


def param_sum(model) -> float:
    """``sum(parameter.sum() for parameter in model.parameters())``."""
    return sum(float(p.detach().sum()) for p in model.parameters())


def toy_data(device) -> tuple:
    """The examples' 24 samples: ``np.random.RandomState(0).randn`` features
    (24, 10), then labels (24, 5)."""
    rng = np.random.RandomState(0)
    features = rng.randn(SAMPLES, 10).astype(np.float32)
    labels = rng.randn(SAMPLES, 5).astype(np.float32)
    return torch.from_numpy(features).to(device), torch.from_numpy(labels).to(device)


def check_parity(group, final: float, device) -> float:
    """Every rank's final sum gathered; raises unless all equal rank 0's
    within 1e-6 (the reference's success criterion), else prints
    ``PARITY-OK``."""
    sums = group.all_gather(torch.tensor([final], dtype=torch.float64, device=device)).tolist()
    if any(abs(s - sums[0]) >= 1e-6 for s in sums):
        raise RuntimeError(f"rank divergence: {sums}")
    print("PARITY-OK", sums[0])
    return sums[0]


def example_main(run, argv, description: str):
    """Parse ``--device`` and ``--init``, join the launch's process group
    (``parallel/collectives.py``), ``run(group, state_dict)``, leave."""
    from pytorch_distributed_rnn_tpu_torch.parallel import collectives
    from pytorch_distributed_rnn_tpu_torch.utils import resolve_device

    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--init", type=Path, default=None,
                        help="initial parameters: a torch.save'd state_dict (default: seeded)")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    state = torch.load(args.init, weights_only=True) if args.init else None
    group = collectives.init_process_group(args.device)
    try:
        return run(group, state)
    finally:
        collectives.destroy(group)
