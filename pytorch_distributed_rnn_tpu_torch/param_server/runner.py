"""Parameter-server launcher: the master and worker roles, and the world.
The non-elastic part of the JAX package's ``param_server/runner.py``.

Rank 0 is the master, ranks 1..W-1 the workers.  Two ways to start a
world:

- rank mode (``--rank R``): this process runs rank R's role, one process
  a role (a multi-node layout; every role dials ``--master-address``/
  ``--master-port``);
- spawn mode (no ``--rank``): this process spawns the whole world on
  this machine, one process a rank running the port's CLI with the same
  arguments and ``--rank`` set (``utils/worlds.py:spawn_world``), and
  waits for it.  Unlike the JAX runner, which forces every child onto the
  CPU, every role runs on ``--device``: ranks share the card.

The master builds the model from ``--seed`` exactly as ``local`` does (so
its initial parameters are ``local``'s) and keeps the flat parameters and
Adam's state on its device (:class:`FlatAdam`).  Rank 0 builds the
transport library and the kernels before the other ranks load them, and
writes the data cache before they read it.  Rank 1 writes
``history.json``.  Each role ends with a summary line: the master's
updates and the time of their parts, a worker's steps, host and exchange
ms a step and kernel launches, and each rank's parameters as their sum
and the sha256 of their float32 bytes.

Telemetry: each role resolves its own recorder (``--metrics``: the
master's sidecar is rank 0's, a worker's its ``-r<rank>`` sibling) with
its SIGUSR2 stack dump; ``--live`` makes the master the anchor that
serves ``/metrics`` and ``/health`` and the workers push to it.
``--profile DIR`` traces each role's whole run and ``--profile-steps
A:B`` each worker's steps, into rank-suffixed traces: every role is its
own process here (the JAX strategy refuses both, its parent process
traces nothing).

``--faults`` runs in the workers, each with the schedule bound to its
rank (``@rank`` events), and its ``net:*`` events are exported onto the
transport's environment before any ``Communicator`` or spawned process
exists.  ``--max-bad-steps`` logs JAX's warning and changes nothing: the
master's finite-gradient check is the integrity guard here.

The elastic world (``--elastic``: a supervisor that respawns workers,
star joins, REGISTER) and the master's checkpoints
(``--ps-checkpoint-rounds``, the bootstrap from ``--resume``) are not
ported: ``main.py:reject_unported`` names them.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import statistics
import sys
import time
from pathlib import Path

import torch

from pytorch_distributed_rnn_tpu_torch.ops.adam import adam_update_
from pytorch_distributed_rnn_tpu_torch.runtime import native

log = logging.getLogger(__name__)


class FlatAdam:
    """The master's update: Adam (``ops/adam.py:adam_update_`` in its host
    step form, betas (0.9, 0.999), eps 1e-8) on the one flat float32
    parameter vector on ``device``.  Each call copies the gradient host ->
    device, steps, and copies the parameters back into a host buffer
    (pinned on the card), which it returns.  ``seconds`` keeps each call's
    time of each part (``h2d``, ``adam``, ``d2h``; on the card each ends
    in a synchronise)."""

    def __init__(self, flat: torch.Tensor, learning_rate: float, device):
        self.device = torch.device(device)
        self.learning_rate = float(learning_rate)
        self.params = flat.detach().to(self.device, dtype=torch.float32, copy=True)
        self.grad = torch.zeros_like(self.params)
        self.exp_avg = torch.zeros_like(self.params)
        self.exp_avg_sq = torch.zeros_like(self.params)
        self.host = torch.empty(self.params.shape, dtype=torch.float32,
                                pin_memory=self.device.type == "cuda")
        self.host.copy_(self.params)
        self.steps = 0
        self.seconds = {"h2d": [], "adam": [], "d2h": []}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def __call__(self, grads: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        self.grad.copy_(grads)
        self._sync()
        t1 = time.perf_counter()
        self.steps += 1
        adam_update_([self.params], [self.grad], [self.exp_avg], [self.exp_avg_sq], self.steps,
                     self.learning_rate, 0.9, 0.999, 1e-8)
        self._sync()
        t2 = time.perf_counter()
        self.host.copy_(self.params)
        t3 = time.perf_counter()
        for part, seconds in (("h2d", t1 - t0), ("adam", t2 - t1), ("d2h", t3 - t2)):
            self.seconds[part].append(seconds)
        return self.host


def mean_and_median_ms(seconds: list) -> str:
    """``"mean / median"`` in ms, the median over all but the first (the
    first use of a kernel, a handle or a peer pays one-off costs)."""
    if not seconds:
        return "- / -"
    rest = seconds[1:] or seconds
    return f"{1e3 * statistics.fmean(seconds):.4f} / {1e3 * statistics.median(rest):.4f}"


def step_times(trainer) -> dict:
    """A worker's host and exchange seconds of each step: a step's host
    time runs from the previous step's adoption to its own (the first from
    the start of training), its exchange from the push to the adoption."""
    ends = [end for _, end in trainer.exchange_log]
    starts = [trainer.train_started, *ends[:-1]]
    return {"host": [b - a for a, b in zip(starts, ends)],
            "exchange": [end - start for start, end in trainer.exchange_log]}


def flat_parameters(model) -> torch.Tensor:
    """The wire order: every parameter flattened, in ``parameters()``
    order, float32 on the host."""
    return torch.cat([p.detach().reshape(-1).float().cpu() for p in model.parameters()])


def parameters_digest(flat: torch.Tensor) -> str:
    """The sha256 of the parameters' float32 bytes (equal digests: equal
    bits)."""
    return hashlib.sha256(flat.detach().float().cpu().contiguous().numpy().tobytes()).hexdigest()


def parameters_line(rank: int, flat: torch.Tensor) -> str:
    """The rank-parity observable: the parameters' sum and digest."""
    return (f"{rank}: parameters: {float(flat.double().sum()):.10f} "
            f"sha256 {parameters_digest(flat)}")


def _role_device(args, rank: int) -> torch.device:
    """``cpu``, or card ``rank % count`` (ranks beyond the cards share them)."""
    if torch.device(args.device).type == "cpu":
        return torch.device("cpu")
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    return device


def _join_world(args, rank: int, device: torch.device):
    """This rank's transport (rank 0 builds the library, the others wait
    for it), the kernels built by rank 0 before the others load them (on
    the card), and the datasets, rank 0 first (it may write the cache)."""
    from pytorch_distributed_rnn_tpu_torch.parallel import collectives
    from pytorch_distributed_rnn_tpu_torch.training import families

    if rank == 0:
        native.build_native_library()
    else:
        native.wait_for_library()
    comm = native.Communicator(args.master_address, int(args.master_port), rank,
                               args.world_size)
    try:
        if device.type == "cuda":
            collectives.build_kernels_once(comm)
        if rank != 0:
            comm.barrier()
        datasets = families.load_datasets(args)
        if rank == 0:
            comm.barrier()
    except BaseException:
        comm.close()
        raise
    return comm, datasets


def _telemetry(args, rank: int, role: str, faults=None):
    """This role's recorder (the NULL recorder without ``--metrics``),
    its live plane (None without ``--live``) and the whole-run trace of
    ``--profile`` without ``--profile-steps`` (a null context else)."""
    import contextlib

    from pytorch_distributed_rnn_tpu_torch.obs.profile import run_trace
    from pytorch_distributed_rnn_tpu_torch.obs.recorder import MetricsRecorder

    recorder = MetricsRecorder.resolve(args, rank=rank, meta={"role": role})
    plane = None
    if recorder.enabled:
        from pytorch_distributed_rnn_tpu_torch.obs.live import LivePlane
        from pytorch_distributed_rnn_tpu_torch.obs.watchdog import install_stack_dump_handler

        install_stack_dump_handler(recorder.path)
        plane = LivePlane.resolve(args, recorder, rank=rank, role=role, faults=faults)
    profile = getattr(args, "profile", None)
    trace = (run_trace(profile, _role_device(args, rank), rank)
             if profile and not getattr(args, "profile_steps", None)
             else contextlib.nullcontext())
    return recorder, plane, trace


def _close_telemetry(recorder, plane) -> None:
    # the plane after the recorder: the final digest lands first
    recorder.close()
    if plane is not None:
        plane.close()


def run_master(args) -> torch.Tensor:
    """Rank 0: serve the workers until each is done; returns the final
    flat parameters."""
    from pytorch_distributed_rnn_tpu_torch.param_server.master import ParameterServerMaster
    from pytorch_distributed_rnn_tpu_torch.training import families

    device = _role_device(args, 0)
    comm, (training_set, _, _) = _join_world(args, 0, device)
    # no fault schedule here: faults fire in the workers' data paths
    recorder, plane, trace = _telemetry(args, 0, "master")
    try:
        with comm, trace:
            flat = flat_parameters(families.build_model(args, training_set))
            update = FlatAdam(flat, args.learning_rate, device)
            master = ParameterServerMaster(comm, update.host, update,
                                           sync_mode=args.ps_mode == "sync",
                                           sync_timeout=args.ps_sync_timeout,
                                           quorum=args.ps_quorum, recorder=recorder)
            final = master.serve()
    finally:
        _close_telemetry(recorder, plane)
    total = [sum(parts) for parts in zip(*update.seconds.values())]
    parts = ", ".join(f"{part} {mean_and_median_ms(s)}" for part, s in update.seconds.items())
    log.info(f"ps master: {master.updates_applied} updates ({args.ps_mode}); update ms a call, "
             f"mean / median after the first: {parts}, total {mean_and_median_ms(total)}; "
             f"flat vector {4 * flat.numel()} bytes")
    log.info(parameters_line(0, final))
    return final


def run_worker(args, rank: int):
    """Worker ``rank``: train against the master; returns the trainer.  A
    SIGTERM drain deregisters after the in-flight exchange and returns
    normally (exit 0)."""
    from pytorch_distributed_rnn_tpu_torch.obs.profile import StepTraceCapture
    from pytorch_distributed_rnn_tpu_torch.param_server.worker import (
        ParameterServerWorkerTrainer,
    )
    from pytorch_distributed_rnn_tpu_torch.parallel.launch import launch_counts
    from pytorch_distributed_rnn_tpu_torch.resilience.membership import (
        DrainRequested,
        DrainSignal,
    )
    from pytorch_distributed_rnn_tpu_torch import training
    from pytorch_distributed_rnn_tpu_torch.training import families

    # the preemption notice: SIGTERM requests a drain, honoured at the
    # next step boundary
    drain = DrainSignal().install()
    # this worker's schedule: @rank events bound to it
    faults = training.resolve_faults(args, rank=rank)
    device = _role_device(args, rank)
    comm, (training_set, _, _) = _join_world(args, rank, device)
    recorder, plane, trace = _telemetry(args, rank, "worker", faults)
    train_history = None
    try:
        with comm:
            model = families.build_model(args, training_set)
            trainer = families.wrap_trainer(args, ParameterServerWorkerTrainer)(
                model, training_set, args.batch_size, args.learning_rate, comm=comm,
                worker_rank=rank, num_workers=args.world_size - 1, seed=args.seed,
                device=device, transport_retries=args.ps_transport_retries,
                # retry storms must die inside the round they retry into
                transport_deadline_s=args.ps_sync_timeout, drain_signal=drain,
                grad_accum=args.grad_accum, faults=faults, recorder=recorder,
                profile_steps=StepTraceCapture.resolve(args))
            t0 = time.perf_counter()
            try:
                with trace:
                    _, train_history, _ = trainer.train(epochs=args.epochs)
                trainer.finish()
            except DrainRequested:
                trainer.deregister()
                # a voluntary leave is success: the process exits 0
                log.warning(f"worker {rank} drained on SIGTERM")
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
    finally:
        _close_telemetry(recorder, plane)
    times = step_times(trainer)
    launches = {name: n for name, n in launch_counts().items() if n}
    log.info(f"ps worker {rank}: {len(trainer.exchange_log)} steps in {wall:.3f} s; ms a step, "
             f"mean / median after the first: host {mean_and_median_ms(times['host'])}, "
             f"exchange {mean_and_median_ms(times['exchange'])}; launches "
             f"{json.dumps(launches, sort_keys=True)}")
    log.info(parameters_line(rank, flat_parameters(trainer.model)))
    if rank == 1 and train_history is not None:
        with open("history.json", "w") as file:
            json.dump({"train_history": train_history, "validation_history": []}, file)
    return trainer


def _spawn(args) -> int:
    """The whole world on this machine: one process a rank, each the
    port's CLI with this run's arguments and ``--rank`` set."""
    from pytorch_distributed_rnn_tpu_torch.utils.worlds import spawn_world

    native.build_native_library()  # once, before the ranks load it
    repo = str(Path(__file__).resolve().parent.parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo, env.get("PYTHONPATH")) if p)
    rank_cmds = [([sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.main", *args.argv,
                   "--rank", str(rank)], env) for rank in range(args.world_size)]
    results = spawn_world(rank_cmds, timeout=None, capture=False, check=False)
    failed = {rank: rc for rank, (rc, _, _) in enumerate(results) if rc != 0}
    if not failed:
        return 0
    # quorum-degraded sync mode tolerates dead WORKERS at the process
    # level too, as the master does in the run: the run succeeded if the
    # master finished (it enforced quorum on every round) and a quorum of
    # workers completed
    num_workers = args.world_size - 1
    survivors = num_workers - sum(1 for rank in failed if rank >= 1)
    if (args.ps_mode == "sync" and args.ps_quorum < 1.0 and 0 not in failed
            and survivors >= max(1, math.ceil(args.ps_quorum * num_workers))):
        log.warning(f"parameter-server run degraded: worker process(es) {sorted(failed)} "
                    f"died ({failed}), {survivors}/{num_workers} workers completed "
                    "(quorum held)")
        return 0
    raise SystemExit(f"parameter-server processes failed: {failed} (rank: exit code)")


def run(args):
    if args.world_size < 2:
        raise SystemExit("parameter-server needs --world-size >= 2")
    logging.basicConfig(level=args.log)
    logging.getLogger().setLevel(args.log)
    if args.max_bad_steps:
        # JAX's warning (param_server/runner.py): the optimizer lives on the
        # master, so a worker-side guard would never see an update
        log.warning(
            "--max-bad-steps has no effect under the parameter-server "
            "strategy: the master asserts gradient integrity per push "
            "instead (quorum mode drops a worker whose pushes fail)"
        )
    # the schedule's net events onto the transport's PDRNN_FAULT_*
    # environment before any communicator (or spawned child, which
    # inherits it) exists
    from pytorch_distributed_rnn_tpu_torch.resilience.faults import FaultSchedule

    FaultSchedule.resolve(args)
    if args.rank is None:
        return _spawn(args)
    if not 0 <= args.rank < args.world_size:
        raise SystemExit(f"--rank {args.rank} is outside the world of {args.world_size}")
    if args.rank == 0:
        return run_master(args)
    return run_worker(args, args.rank)
