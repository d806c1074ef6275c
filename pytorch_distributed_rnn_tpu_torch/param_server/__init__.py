"""The ``parameter-server`` strategy: coordinator-owned parameters, remote
updates.  The counterpart of the JAX package's ``param_server/``.

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
HOST --master-port PORT``.  ``--ps-checkpoint-rounds N`` makes the master
write its state every N updates, and ``--resume`` (``auto`` or a path)
bootstraps it from the newest valid checkpoint under
``--checkpoint-directory``, in the JAX package's format
(``runner.py:MasterCheckpoints``).  ``--elastic`` supervises the workers
of a spawn-mode world (``--min-workers``, ``--ps-max-respawns``): a dead
one is respawned and rejoins through REGISTER within the master's
``--ps-join-timeout``; ``--ps-rejoin [--ps-worker-id ID]`` re-enters a
running elastic world by hand.  The ``respawn`` and ``preempt`` fault
actions drive that path, as in JAX.
"""

from __future__ import annotations

# the reason main.py:reject_unported gives
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
    parser.add_argument(
        "--elastic", action="store_true",
        help="elastic membership: the master accepts REGISTER (re)joins mid-run on the "
        "rendezvous listener, and (in spawn mode) a supervisor respawns dead workers with the "
        "same WORKER-ID - the stable membership identity, decoupled from the transport RANK "
        "(the socket slot a respawn plugs back into).  A rejoiner receives a STATE_SYNC "
        "(current params + its push-seq watermark) and enters the next sync round")
    parser.add_argument(
        "--min-workers", type=int, default=1, metavar="N",
        help="elastic spawn mode: the supervisor keeps the run alive while at least N workers "
        "are live or completed; below the floor (respawn budgets exhausted) it tears the world "
        "down")
    parser.add_argument("--ps-max-respawns", type=int, default=3, metavar="N",
                        help="elastic spawn mode: respawn budget per worker slot")
    parser.add_argument(
        "--ps-join-timeout", type=float, default=60.0, metavar="SECONDS",
        help="elastic: how long the master holds a dead member on the roster awaiting its "
        "REGISTER rejoin before abandoning it (an abandoned loss is what counts against "
        "--ps-quorum)")
    parser.add_argument(
        "--ps-rejoin", action="store_true",
        help="multi-node rank mode: (re)enter a running --elastic world - star-join the "
        "transport at --rank and REGISTER instead of the initial rendezvous (the manual "
        "analogue of the spawn-mode supervisor's respawn)")
    parser.add_argument(
        "--ps-worker-id", type=int, default=None, metavar="ID",
        help="with --ps-rejoin: the stable worker-id to register under (default: the "
        "transport rank).  The id keys the data shard, dropout stream and push-seq watermark; "
        "the rank is just the socket slot")
    parser.add_argument(
        "--ps-checkpoint-rounds", type=int, default=0, metavar="N",
        help="master: write a crash-safe checkpoint of the authoritative params + optimizer "
        "state to --checkpoint-directory every N applied updates (and once at the end); with "
        "--resume auto a restarted master bootstraps from the newest valid one.  0 disables")
    parser.set_defaults(func=execute, strategy="parameter-server")


def reject_unported(args):
    """Exit loudly on what the port's parameter server does not run, and
    on a bad ``--faults`` spec before any process starts."""
    if args.fuse_run:
        raise SystemExit(FUSE_RUN_REJECTED)
    if args.faults:
        from pytorch_distributed_rnn_tpu_torch.resilience.faults import FaultSchedule

        try:
            FaultSchedule.parse(args.faults)
        except ValueError as exc:
            raise SystemExit(str(exc)) from None


def execute(args):
    from pytorch_distributed_rnn_tpu_torch.param_server.runner import run
    from pytorch_distributed_rnn_tpu_torch.training.families import family_of

    if family_of(args) == "moe":
        raise SystemExit("--model moe is not ported yet - parameter-server --model moe comes "
                         "with the MoE family (ROADMAP A9)")
    return run(args)
