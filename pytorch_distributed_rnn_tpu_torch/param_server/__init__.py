"""The ``parameter-server`` strategy: coordinator-owned parameters, remote
updates.  The counterpart of the JAX package's ``param_server/``, without
elastic membership.

The master process (rank 0) owns the flat parameters and Adam's state;
workers (ranks 1..W-1) compute local gradients, push them and pull fresh
params over the framework's C++ TCP transport (``runtime/native.py``).
``--ps-mode async`` applies each push on arrival, ``sync`` averages one
push a worker a round (``--ps-quorum``/``--ps-sync-timeout`` let a round
degrade or fail loudly); ``--ps-transport-retries`` retries an exchange.

Run the whole world on one machine by omitting ``--rank`` (one process a
rank, every role on ``--device``; ranks share the card):

  python -m pytorch_distributed_rnn_tpu_torch.main --dataset-path data \\
      parameter-server --world-size 3 --ps-mode sync

or one role a process with ``--rank R --world-size W --master-address
HOST --master-port PORT``.  The flags of the elastic world and of the
master's checkpoints, and the fault actions that need the elastic roster
(``respawn``, ``preempt``), are parsed with JAX's defaults and rejected
when set (:func:`reject_unported`).
"""

from __future__ import annotations

# the reasons main.py:reject_unported gives
ELASTIC_REJECTED = ("not ported yet: elastic membership comes with the elastic half of "
                    "ROADMAP A7 (the transport's star and listener entries and the supervisor)")
CHECKPOINT_REJECTED = ("not ported yet: the master's checkpoints and its bootstrap from them "
                       "(--resume, and --resume auto, under parameter-server) come with the "
                       "rest of ROADMAP A5")
FAULTS_ELASTIC_REJECTED = (
    "not ported yet under parameter-server: JAX handles these fault actions with the "
    "elastic roster (a respawned or preempted worker rejoins it), which comes with the "
    "elastic half of ROADMAP A7")
FUSE_RUN_REJECTED = (
    "--fuse-run: parameter-server workers push gradients and pull parameters over the host's "
    "TCP transport every step, so the host handles every batch and the run cannot be one "
    "device program")


def add_sub_command(sub_parser):
    parser = sub_parser.add_parser("parameter-server")
    parser.add_argument("--world-size", type=int, default=2)
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--master-address", type=str, default="127.0.0.1")
    parser.add_argument("--master-port", type=str, default="29500")
    parser.add_argument(
        "--ps-mode", choices=["async", "sync"], default="async",
        help="async: apply each worker's gradient on arrival (reference-style); sync: average "
        "one gradient per worker per step")
    parser.add_argument(
        "--ps-quorum", type=float, default=1.0, metavar="F",
        help="sync mode: fraction of workers whose gradients close a round once "
        "--ps-sync-timeout expires (1.0 = strict, a straggler is fatal; 0.5 = degrade to "
        "half the world and keep training).  Dead workers are dropped from later rounds "
        "while at least ceil(F x workers) survive")
    parser.add_argument(
        "--ps-sync-timeout", type=float, default=300.0, metavar="SECONDS",
        help="sync mode: how long a round waits for stragglers before erroring "
        "(--ps-quorum 1.0) or degrading (< 1.0)")
    parser.add_argument(
        "--ps-transport-retries", type=int, default=3, metavar="N",
        help="worker-side retries (exponential backoff + jitter) for a failed push/pull "
        "exchange before giving up; the whole retry storm is capped at --ps-sync-timeout")
    parser.add_argument("--elastic", action="store_true", help=ELASTIC_REJECTED)
    parser.add_argument("--min-workers", type=int, default=1, metavar="N",
                        help=ELASTIC_REJECTED)
    parser.add_argument("--ps-max-respawns", type=int, default=3, metavar="N",
                        help=ELASTIC_REJECTED)
    parser.add_argument("--ps-join-timeout", type=float, default=60.0, metavar="SECONDS",
                        help=ELASTIC_REJECTED)
    parser.add_argument("--ps-rejoin", action="store_true", help=ELASTIC_REJECTED)
    parser.add_argument("--ps-worker-id", type=int, default=None, metavar="ID",
                        help=ELASTIC_REJECTED)
    parser.add_argument("--ps-checkpoint-rounds", type=int, default=0, metavar="N",
                        help=CHECKPOINT_REJECTED)
    parser.set_defaults(func=execute, strategy="parameter-server")


def reject_unported(args):
    """Exit loudly on the flags whose machinery the port's parameter
    server does not have yet."""
    elastic = [flag for flag, on in (
        ("--elastic", args.elastic),
        ("--min-workers", args.min_workers != 1),
        ("--ps-max-respawns", args.ps_max_respawns != 3),
        ("--ps-join-timeout", args.ps_join_timeout != 60.0),
        ("--ps-rejoin", args.ps_rejoin),
        ("--ps-worker-id", args.ps_worker_id is not None),
    ) if on]
    reasons = []
    if elastic:
        reasons.append(f"{', '.join(elastic)}: {ELASTIC_REJECTED}")
    checkpoint = [flag for flag, on in (
        ("--ps-checkpoint-rounds", args.ps_checkpoint_rounds > 0),
        ("--resume under parameter-server", args.resume is not None),
    ) if on]
    if checkpoint:
        reasons.append(f"{', '.join(checkpoint)}: {CHECKPOINT_REJECTED}")
    if args.fuse_run:
        reasons.append(FUSE_RUN_REJECTED)
    if args.faults:
        from pytorch_distributed_rnn_tpu_torch.resilience.faults import FaultSchedule

        try:
            events = FaultSchedule.parse(args.faults).events
        except ValueError as exc:
            raise SystemExit(str(exc)) from None
        elastic_actions = sorted({e.action for e in events if e.action in ("respawn", "preempt")})
        if elastic_actions:
            reasons.append(f"--faults {', '.join(elastic_actions)}: {FAULTS_ELASTIC_REJECTED}")
    if reasons:
        raise SystemExit("; ".join(reasons))


def execute(args):
    from pytorch_distributed_rnn_tpu_torch.param_server.runner import run
    from pytorch_distributed_rnn_tpu_torch.training.families import family_of

    if family_of(args) == "moe":
        raise SystemExit("--model moe is not ported yet - parameter-server --model moe comes "
                         "with the MoE family (ROADMAP A9)")
    return run(args)
