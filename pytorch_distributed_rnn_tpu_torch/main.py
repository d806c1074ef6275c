"""CLI entry point of the PyTorch port: global flags + a strategy subcommand.

The flag surface of the JAX package's ``main.py``, plus ``--device
{cuda,cpu}`` (default ``cuda``; without a card the run fails and says to
pass ``--device cpu``).  The subcommands are ``local`` and the
data-parallel strategies, one process a rank: ``distributed`` (DDP) and
``horovod`` over ``torch.distributed``, and ``distributed-native`` over
the framework's C++ TCP ring (``--bucketed-comm`` and ``--bucket-mb``
bucket its gradient traffic); ``--sharded-update``, on by default, shards
the Adam step of all three.  ``--model`` takes ``rnn``, ``char`` and
``attention``.
``local``, ``distributed`` and ``horovod`` train each epoch through
CUDA-graph replays of their train step unless DEBUG logging asks for each
batch's values, and ``--fuse-run`` replays it over the whole run
(``training/base.py``; a gloo world runs the same step uncaptured).  The resilience and
memory flags: ``--max-bad-steps K`` (skip a step with non-finite
gradients on the device, abort past K in a row), ``--faults SPEC`` (the
``resilience/faults.py`` schedule, also ``PDRNN_CHAOS``), ``--resume
auto`` (the newest valid checkpoint of ``--checkpoint-directory``),
``--grad-accum K`` (``local``: K microbatches a step) and ``--remat``
(recompute each RNN layer or encoder block in the backward).  The
telemetry flags, on every strategy: ``--metrics PATH`` (a JSONL sidecar
a rank, ``obs/recorder.py``; ``PDRNN_METRICS``), ``--metrics-sample-every
N``, ``--live [HOST:]PORT`` and ``--live-port-file PATH`` (the live plane,
``obs/live.py``; ``PDRNN_LIVE``), ``--profile DIR`` and ``--profile-steps
A:B`` (``obs/profile.py``); read the sidecars with ``python -m
pytorch_distributed_rnn_tpu_torch.obs``.
Flags whose machinery is not ported yet are parsed and rejected loudly
when set to anything but their default.

Run:
  python -m pytorch_distributed_rnn_tpu_torch.main --dataset-path data local
  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m pytorch_distributed_rnn_tpu_torch.main --dataset-path data distributed
  python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m pytorch_distributed_rnn_tpu_torch.main --dataset-path data distributed-native
  MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 WORLD_SIZE=2 RANK=0 \
      python -m pytorch_distributed_rnn_tpu_torch.main --dataset-path data distributed-native
      (and RANK=1 in a second shell: the ring's own rendezvous, no torchrun)
  python -m pytorch_distributed_rnn_tpu_torch.main --model char --cell gru \
      --hidden-units 512 --seq-length 128 --batch-size 256 --dropout 0 local
  python -m pytorch_distributed_rnn_tpu_torch.main --model attention \
      --hidden-units 128 --num-heads 4 --batch-size 256 --dropout 0 local
  python -m pytorch_distributed_rnn_tpu_torch.main --dataset-path data \
      --metrics m.jsonl --live 0 --live-port-file port local
  python -m pytorch_distributed_rnn_tpu_torch.obs summarize m.jsonl
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from pytorch_distributed_rnn_tpu_torch.utils import resolve_device

DEFAULT_CHECKPOINT_DIR = Path("models")
DEFAULT_DATASET_PATH = Path("data")
NOT_PORTED = "not ported yet (ROADMAP.md, port queue: 'Flags the port rejects')"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="PyTorch/CUDA distributed RNN trainer")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the run executes (default cuda; no silent fallback)")
    parser.add_argument("--checkpoint-directory", default=DEFAULT_CHECKPOINT_DIR, type=Path)
    parser.add_argument("--dataset-path", default=DEFAULT_DATASET_PATH, type=Path)
    parser.add_argument("--output-path", default=None, type=Path)
    parser.add_argument("--stacked-layer", default=2, type=int)
    parser.add_argument("--hidden-units", default=32, type=int)
    parser.add_argument("--epochs", default=100, type=int)
    parser.add_argument("--validation-fraction", default=0.1, type=float)
    parser.add_argument("--batch-size", default=1440, type=int)
    parser.add_argument("--learning-rate", default=0.0025, type=float)
    parser.add_argument("--dropout", default=0.1, type=float)
    parser.add_argument("--log", default="INFO")
    parser.add_argument("--num-threads", default=4, type=int,
                        help="accepted for CLI compatibility only")
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument("--no-validation", action="store_true")
    parser.add_argument("--cell", default="lstm", choices=["lstm", "gru"],
                        help="recurrent cell; both run the fused kernels on the card "
                        "up to 512 hidden units")
    parser.add_argument("--model", default="rnn", choices=["rnn", "attention", "char", "moe"],
                        help="model family; the port trains rnn (motion classifier), "
                        "char (char LM) and attention (attention classifier, "
                        "--hidden-units wide, --stacked-layer blocks)")
    parser.add_argument("--seq-length", default=None, type=int, metavar="T",
                        help="--model char only: tokens per window (default 128)")
    parser.add_argument("--num-heads", default=4, type=int, help="--model attention only")
    parser.add_argument("--num-experts", default=4, type=int, help="--model moe only")
    parser.add_argument("--moe-top-k", default=1, type=int, choices=[1, 2],
                        help="--model moe only")
    parser.add_argument("--moe-router", default="token", choices=["token", "expert"],
                        help="--model moe only")
    parser.add_argument("--moe-capacity-factor", default=2.0, type=float, metavar="F",
                        help="--model moe only")
    parser.add_argument("--moe-group-size", default=None, type=int, metavar="G",
                        help="--model moe only")
    parser.add_argument("--resume", default=None, type=Path, metavar="PATH",
                        help="restore model and optimizer state from a checkpoint "
                        "file before training; 'auto' takes the newest valid checkpoint "
                        "of --checkpoint-directory (past corrupt ones) and trains only the "
                        "epochs after it, or starts fresh")
    parser.add_argument("--checkpoint-every", default=0, type=int, metavar="N",
                        help="also write checkpoint-epoch-N.ckpt every N epochs")
    parser.add_argument("--keep-checkpoints", default=0, type=int, metavar="N",
                        help="keep only the newest N epoch checkpoints (0 = all)")
    parser.add_argument("--max-bad-steps", default=0, type=int, metavar="K",
                        help="skip an update whose gradients hold a NaN or an Inf (on the "
                        "device: parameters and Adam state unchanged) and abort past K "
                        "consecutive ones (0 = off; parameter-server: no effect)")
    parser.add_argument("--faults", default=None, metavar="SPEC",
                        help="fault-injection schedule, e.g. 'step:3:nan,epoch:2:kill,"
                        "net:delay:5' (resilience/faults.py; PDRNN_CHAOS when unset)")
    parser.add_argument("--grad-accum", default=1, type=int, metavar="K",
                        help="local: split each batch into K equal microbatches and "
                        "accumulate their gradients into one update (the data-parallel "
                        "strategies reject K > 1, as the JAX trainers do)")
    parser.add_argument("--sharded-update", default=True, action=argparse.BooleanOptionalAction,
                        help="distributed, horovod and distributed-native: reduce-scatter "
                        "the gradient, step Adam on each rank's 1/world slice, all-gather "
                        "the parameters (default on); inert on local")
    parser.add_argument("--bucketed-comm", default=True, action=argparse.BooleanOptionalAction,
                        help="distributed-native with --sharded-update: split the ring's "
                        "reduce-scatter and all-gather into --bucket-mb buckets that "
                        "overlap the Adam steps (default on); inert elsewhere")
    parser.add_argument("--bucket-mb", default=25.0, type=float, metavar="MB",
                        help="distributed-native: the wire size of a bucket (default 25, "
                        "DDP's bucket_cap_mb); inert elsewhere")
    parser.add_argument("--precision", default="f32", choices=["f32", "bf16"],
                        help="bf16: bfloat16 recurrence or encoder blocks, float32 "
                        "parameters and head")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each RNN layer (or encoder block) in the backward "
                        "instead of keeping its activations (same bits, less memory)")
    parser.add_argument("--checkpoint-format", default="gathered",
                        choices=["gathered", "sharded"], help=f"sharded is {NOT_PORTED}")
    parser.add_argument("--checkpoint-async", action="store_true", help=NOT_PORTED)
    parser.add_argument("--fuse-run", action="store_true",
                        help="local, distributed and horovod: run the whole training as one "
                        "device program (a CUDA graph of the train step replayed over every "
                        "batch of every epoch) even at INFO logging; needs --no-validation, "
                        "no --checkpoint-every and, with dropout, a batch size dividing the "
                        "training set (distributed, horovod: each rank's shard); "
                        "distributed-native and parameter-server: rejected (the host "
                        "handles every batch)")
    parser.add_argument("--profile", default=None, type=Path, metavar="DIR",
                        help="write a torch.profiler Chrome trace (host, and the card's "
                        "kernels) of the training run into DIR")
    parser.add_argument("--profile-steps", default=None, metavar="A:B",
                        help="bound the --profile trace to optimizer steps [A, B)")
    parser.add_argument("--metrics", default=None, type=Path, metavar="PATH",
                        help="structured run telemetry: rank-tagged JSONL events (steps, "
                        "epochs, collectives, checkpoints, faults, the efficiency ledger) "
                        "to PATH (-r<rank> siblings for other ranks), written by a "
                        "background thread; PDRNN_METRICS when unset")
    parser.add_argument("--metrics-sample-every", default=None, type=int, metavar="N",
                        help="every N-th step (and step 1) synchronizes the device to "
                        "measure its wall time (default 16, PDRNN_METRICS_SAMPLE)")
    parser.add_argument("--live", default=None, metavar="[HOST:]PORT",
                        help="live plane (needs --metrics): rank 0 serves GET /metrics, "
                        "/health, /events and /fleet, the other ranks push to it, and a "
                        "watchdog flags stalls, NaN streaks and loss spikes "
                        "(PDRNN_WATCHDOG_STALL seconds); PDRNN_LIVE when unset")
    parser.add_argument("--live-port-file", default=None, type=Path, metavar="PATH",
                        help="write 'host port' of the live endpoint here once bound "
                        "(finds a --live 0 ephemeral port)")

    sub_parser = parser.add_subparsers(title="Available commands",
                                       metavar="command [options ...]")
    sub_parser.required = True
    from pytorch_distributed_rnn_tpu_torch import training

    training.add_sub_commands(sub_parser)
    return parser


def reject_unported(args):
    """Exit loudly on any flag whose machinery the port does not have yet,
    and on the flags ``distributed-native`` rejects, with the JAX trainer's
    reasons."""
    if args.strategy == "parameter-server":
        from pytorch_distributed_rnn_tpu_torch import param_server

        param_server.reject_unported(args)
    if args.strategy == "distributed-native":
        from pytorch_distributed_rnn_tpu_torch.training import native_ddp

        rejected = {native_ddp.FUSE_RUN_REJECTED: args.fuse_run,
                    native_ddp.CHECKPOINT_ASYNC_REJECTED: args.checkpoint_async,
                    native_ddp.CHECKPOINT_SHARDED_REJECTED: args.checkpoint_format != "gathered"}
        reasons = [reason for reason, on in rejected.items() if on]
        if reasons:
            raise SystemExit("; ".join(reasons))
    unported = {
        "--checkpoint-format sharded": args.checkpoint_format != "gathered",
        "--checkpoint-async": args.checkpoint_async,
    }
    chosen = [flag for flag, on in unported.items() if on]
    if chosen:
        raise SystemExit(f"{', '.join(chosen)}: {NOT_PORTED}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    args.argv = argv  # what a spawned world's ranks run again
    reject_unported(args)
    resolve_device(args.device)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
