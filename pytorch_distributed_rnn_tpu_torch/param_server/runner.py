"""Parameter-server launcher: the master and worker roles, and the world.
The counterpart of the JAX package's ``param_server/runner.py``.

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

Elastic mode (``--elastic``): in spawn mode the workers are supervised
(``launcher/supervisor.py:ElasticSupervisor``) around an unsupervised
master: a worker that dies is respawned with the same worker-id, star-
joins the transport and re-enters through REGISTER/STATE_SYNC; a
SIGTERM-drained worker flushes its in-flight gradient, DEREGISTERs and
exits 0.  The master accepts (re)joins mid-run and holds a dead member
for ``--ps-join-timeout`` seconds.  ``--min-workers`` is the pool's floor
and ``--ps-max-respawns`` each slot's budget.  In rank mode ``--ps-rejoin
[--ps-worker-id ID]`` is the manual re-entry of a running elastic world.
A respawned incarnation drops its schedule's deterministic lifetime
faults (``FaultSchedule.for_rejoin``), which already fired.

The master's checkpoints: ``--ps-checkpoint-rounds N`` snapshots the
master's state every N updates under its round lock (device copies of the
flat parameters and Adam's moments, and the count), and
:class:`AsyncCheckpointWriter`'s thread writes the newest snapshot outside
every lock, in the JAX package's format (``training/checkpoint.py``): the
parameters by name in JAX's tree, ``optax.adam``'s state, the
checkpoint's ordinal as its epoch and loss 0.0, as JAX's master writes
them.  At the end the final state is written synchronously.  With
``--resume`` (``auto`` or a path) the master bootstraps from the newest
valid checkpoint under ``--checkpoint-directory`` (written by either
framework), maps its tree onto the flat vector by name, and continues the
ordinals; the workers adopt its parameters at their initial pull.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import statistics
import sys
import threading
import time
from pathlib import Path

import torch

from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch.ops.adam import adam_update_
from pytorch_distributed_rnn_tpu_torch.runtime import native

log = logging.getLogger(__name__)

# how long an elastic world's workers may take to exit after the master did
WORKER_EXIT_GRACE_S = 30.0


class AsyncCheckpointWriter:
    """Coalescing background checkpoint writer for the master.

    ``apply_update`` runs under the master's round lock, so writing the
    state to disk inline would stall every worker's reply behind file
    I/O.  :meth:`submit` parks the newest snapshot (copies taken under the
    lock) and the writer thread persists it outside every lock;
    back-to-back submissions coalesce: only the most recent pending
    snapshot is written."""

    def __init__(self, write):
        self._write = write
        self._cv = threading.Condition()
        self._snap = None
        self._stop = False
        self._thread = threading.Thread(target=self._run, name="ps-ckpt-writer", daemon=True)
        self._thread.start()

    def submit(self, *snap) -> None:
        with self._cv:
            self._snap = snap
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._snap is None and not self._stop:
                    self._cv.wait()
                snap, self._snap = self._snap, None
                if snap is None:
                    return
            self._write(*snap)

    def close(self, timeout: float = 60.0) -> None:
        """Stop the writer, dropping any still-pending snapshot (the caller
        writes the final state synchronously)."""
        with self._cv:
            self._snap = None
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=timeout)


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

    @torch.no_grad()
    def snapshot(self) -> tuple:
        """``(params, exp_avg, exp_avg_sq, steps)``: copies on the device,
        taken between updates (under the master's round lock)."""
        return (self.params.clone(), self.exp_avg.clone(), self.exp_avg_sq.clone(), self.steps)

    @torch.no_grad()
    def load(self, params, exp_avg, exp_avg_sq, steps: int) -> None:
        """Adopt a restored state: flat float32 vectors and Adam's count."""
        for mine, theirs in ((self.params, params), (self.exp_avg, exp_avg),
                             (self.exp_avg_sq, exp_avg_sq)):
            mine.copy_(theirs)
        self.steps = int(steps)
        self.host.copy_(self.params)

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


def _join_world(args, rank: int, device: torch.device, rejoin: bool = False):
    """This rank's transport (rank 0 builds the library, the others wait
    for it), the kernels built by rank 0 before the others load them (on
    the card), and the datasets, rank 0 first (it may write the cache).
    A rejoining worker star-joins a running world, whose library, kernels
    and data cache exist already."""
    from pytorch_distributed_rnn_tpu_torch.parallel import collectives
    from pytorch_distributed_rnn_tpu_torch.training import families

    if rank == 0:
        native.build_native_library()
    else:
        native.wait_for_library()
    comm = native.Communicator(args.master_address, int(args.master_port), rank,
                               args.world_size, star=rejoin)
    if rejoin:
        try:
            return comm, families.load_datasets(args)
        except BaseException:
            comm.close()
            raise
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


class MasterCheckpoints:
    """The master's checkpoints (``--ps-checkpoint-rounds``, ``--resume``):
    its state as the JAX package's master writes it, ``unravel(flat)`` and
    ``optax.adam``'s state by parameter name, the checkpoint's ordinal as
    its epoch.  ``params`` maps the model's parameter names, in the wire
    order, to tensors of their shapes."""

    def __init__(self, directory, every: int, params: dict, update: FlatAdam):
        self.directory = directory
        self.every = int(every or 0)
        self.params = params
        self.update = update
        self.count = 0  # the next checkpoint's ordinal
        self.write_ms = []
        self.writer = (AsyncCheckpointWriter(self.save)
                       if self.every and directory else None)

    def bootstrap(self) -> Path | None:
        """Adopt the newest valid checkpoint under the directory (None:
        none there); the ordinals continue from its epoch."""
        from pytorch_distributed_rnn_tpu_torch.training.checkpoint import (
            find_latest_checkpoint,
            load_checkpoint,
        )

        latest = find_latest_checkpoint(self.directory) if self.directory else None
        if latest is None:
            return None
        names = list(self.params)
        model_state, opt_state, meta = load_checkpoint(latest, names=names)
        flat = interop.state_dict_to_flat(model_state, names)
        state = opt_state["state"]
        if state:
            moments = [interop.state_dict_to_flat({n: state[i][key] for i, n in enumerate(names)},
                                                  names) for key in ("exp_avg", "exp_avg_sq")]
            steps = int(state[0]["step"])
        else:
            moments, steps = [torch.zeros_like(flat), torch.zeros_like(flat)], 0
        self.update.load(flat, *moments, steps)
        self.count = int(meta["epoch"])
        log.info(f"master bootstrap: restored {latest} (checkpoint ordinal {self.count}); "
                 f"parameters sha256 {parameters_digest(self.update.host)}")
        return latest

    def after_update(self, updates: int) -> None:
        """Under the round lock, after an update: every ``every`` updates,
        a snapshot for the writer."""
        if self.writer is not None and updates % self.every == 0:
            self.writer.submit(*self.update.snapshot(), updates)

    def save(self, params, exp_avg, exp_avg_sq, steps: int, updates: int) -> Path:
        from pytorch_distributed_rnn_tpu_torch.training.checkpoint import save_checkpoint

        t0 = time.perf_counter()
        model_state = interop.flat_to_state_dict(params.cpu(), self.params)
        opt_state = {"state": {}}
        if steps > 0:
            avg = interop.flat_to_state_dict(exp_avg.cpu(), self.params)
            avg_sq = interop.flat_to_state_dict(exp_avg_sq.cpu(), self.params)
            opt_state["state"] = {
                i: {"step": torch.tensor(float(steps)), "exp_avg": avg[n],
                    "exp_avg_sq": avg_sq[n]} for i, n in enumerate(self.params)}
        path = save_checkpoint(self.directory, self.count, model_state, opt_state, loss=0.0)
        self.count += 1
        self.write_ms.append(1e3 * (time.perf_counter() - t0))
        log.info(f"master checkpoint: {path} @ update {updates} ({self.write_ms[-1]:.3f} ms)")
        return path

    def close(self, updates: int) -> None:
        """Drain the writer, then write the final state synchronously."""
        if self.writer is not None:
            self.writer.close()
            self.save(*self.update.snapshot(), updates)


def run_master(args) -> torch.Tensor:
    """Rank 0: serve the workers until each is done; returns the final
    flat parameters."""
    from pytorch_distributed_rnn_tpu_torch.param_server.master import ParameterServerMaster
    from pytorch_distributed_rnn_tpu_torch.training import families

    device = _role_device(args, 0)
    comm, (training_set, _, _) = _join_world(args, 0, device)
    # no fault schedule here: faults fire in the workers' data paths
    recorder, plane, trace = _telemetry(args, 0, "master")
    checkpoints = None
    try:
        with comm, trace:
            model = families.build_model(args, training_set)
            flat = flat_parameters(model)
            update = FlatAdam(flat, args.learning_rate, device)
            checkpoints = MasterCheckpoints(args.checkpoint_directory, args.ps_checkpoint_rounds,
                                            dict(model.named_parameters()), update)
            if args.resume is not None:
                # a restarted master hands the workers its trained state
                checkpoints.bootstrap()
            def apply_update(grads):
                # under the master's round lock, as JAX's apply_update runs;
                # the master counts this update once it returns
                fresh = update(grads)
                checkpoints.after_update(master.updates_applied + 1)
                return fresh

            master = ParameterServerMaster(comm, update.host, apply_update,
                                           sync_mode=args.ps_mode == "sync",
                                           sync_timeout=args.ps_sync_timeout,
                                           quorum=args.ps_quorum, recorder=recorder,
                                           elastic=args.elastic,
                                           join_timeout=args.ps_join_timeout)
            final = master.serve()
            checkpoints.close(master.updates_applied)
    finally:
        if checkpoints is not None and checkpoints.writer is not None:
            checkpoints.writer.close()
        _close_telemetry(recorder, plane)
    total = [sum(parts) for parts in zip(*update.seconds.values())]
    parts = ", ".join(f"{part} {mean_and_median_ms(s)}" for part, s in update.seconds.items())
    log.info(f"ps master: {master.updates_applied} updates ({args.ps_mode}); update ms a call, "
             f"mean / median after the first: {parts}, total {mean_and_median_ms(total)}; "
             f"flat vector {4 * flat.numel()} bytes")
    if checkpoints.write_ms:
        log.info(f"ps master: {len(checkpoints.write_ms)} checkpoints, write ms "
                 f"{mean_and_median_ms([ms / 1e3 for ms in checkpoints.write_ms])}")
    log.info(parameters_line(0, final))
    return final


def run_worker(args, rank: int, worker_id: int | None = None, rejoin: bool = False):
    """Worker ``rank``: train against the master; returns the trainer.  A
    SIGTERM drain deregisters after the in-flight exchange and returns
    normally (exit 0).  ``rejoin=True`` is the elastic path: the transport
    is star-joined (the master's acceptor installs the rank) and the run
    enters through REGISTER/STATE_SYNC instead of the initial pull, under
    ``worker_id`` (default: the rank)."""
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
    if rejoin and faults is not None:
        # a respawned incarnation must not replay the deterministic
        # lifetime fault that killed its predecessor
        faults = faults.for_rejoin()
    device = _role_device(args, rank)
    comm, (training_set, _, _) = _join_world(args, rank, device, rejoin=rejoin)
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
                worker_id=worker_id if worker_id is not None else rank, register=rejoin,
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
    if trainer.state_sync is not None:
        sync = trainer.state_sync
        log.info(f"ps worker {rank}: state sync at update {sync['step']}, push seq "
                 f"{sync['seq']}, epoch {sync['epoch']}; parameters sha256 "
                 f"{parameters_digest(sync['params'])}; first push "
                 f"{trainer.first_push_s} s after the process started")
    log.info(parameters_line(rank, flat_parameters(trainer.model)))
    if rank == 1 and train_history is not None:
        with open("history.json", "w") as file:
            json.dump({"train_history": train_history, "validation_history": []}, file)
    return trainer


def _rank_command(args, rank: int, *extra) -> tuple[list, dict]:
    """``(argv, env)`` of rank ``rank``'s process: the port's CLI with this
    run's arguments, ``--rank`` and ``extra`` set."""
    repo = str(Path(__file__).resolve().parent.parent.parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo, env.get("PYTHONPATH")) if p)
    return ([sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.main", *args.argv,
             "--rank", str(rank), *extra], env)


def _run_elastic(args) -> int:
    """The supervised elastic spawn world: the master runs unsupervised
    (it owns the state); the workers are supervised - a death is
    respawned with the same worker-id (rejoining through REGISTER) until
    the slot's budget runs out; a drain or completion (exit 0) is
    terminal."""
    import subprocess

    from pytorch_distributed_rnn_tpu_torch.launcher.supervisor import (
        ElasticSupervisor,
        PopenProcess,
        supervision_alert_hook,
    )
    from pytorch_distributed_rnn_tpu_torch.obs.live import resolve_event_push

    def start(rank, *extra):
        argv, env = _rank_command(args, rank, *extra)
        return PopenProcess(subprocess.Popen(argv, env=env))

    master = start(0)

    def spawn_worker(rank, worker_id, rejoin):
        return start(rank, "--ps-worker-id", str(worker_id), *(["--ps-rejoin"] if rejoin else []))

    # supervisor events -> the live plane's alerts (the parent has no
    # recorder: rank 0's sidecar belongs to the master)
    supervisor = ElasticSupervisor(spawn_worker, min_workers=args.min_workers,
                                   max_respawns=args.ps_max_respawns,
                                   on_event=supervision_alert_hook(push=resolve_event_push(args)))
    supervisor.launch(range(1, args.world_size))
    healthy = supervisor.supervise(lambda: master.exitcode)
    if not healthy:
        log.error(f"elastic supervisor: worker pool fell below --min-workers "
                  f"{supervisor.min_workers} with no respawn budget left; tearing down")
        master.terminate()
    master.join()
    if healthy:
        # the workers the master released are exiting: let them finish
        # before the reap, so that their exit codes are their own
        deadline = time.monotonic() + WORKER_EXIT_GRACE_S
        for slot in supervisor.slots.values():
            slot.process.join(timeout=max(0.0, deadline - time.monotonic()))
    # the master's exit ends the run: reap what remains without respawning
    supervisor.shutdown()
    verdict = supervisor.verdict()
    log.info(f"elastic supervisor verdict: {verdict}")
    if not healthy or master.exitcode != 0:
        raise SystemExit(f"elastic parameter-server run failed: master exit {master.exitcode}, "
                         f"supervisor {verdict}")
    return 0


def _spawn(args) -> int:
    """The whole world on this machine: one process a rank, each the
    port's CLI with this run's arguments and ``--rank`` set."""
    from pytorch_distributed_rnn_tpu_torch.utils.worlds import spawn_world

    native.build_native_library()  # once, before the ranks load it
    if args.elastic:
        return _run_elastic(args)
    rank_cmds = [_rank_command(args, rank) for rank in range(args.world_size)]
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
    # --ps-rejoin: the manual elastic re-entry, star-join + REGISTER under
    # the given (or the rank's) worker-id
    return run_worker(args, args.rank, worker_id=args.ps_worker_id, rejoin=args.ps_rejoin)
