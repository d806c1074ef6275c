"""Process-per-rank data parallelism over the TCP ring: ``distributed-native``.

The counterpart of the JAX package's ``training/native_ddp.py``: each rank
is a process holding a replica, computes forward and backward on its
device, moves the gradient through the C++ ring of ``runtime/native.py``
(the framework's MPI stand-in) and applies Adam itself; identical updates
from identical averaged gradients keep the replicas equal (the DDP
invariant).  What the JAX trainer does, this one does:

- ``batch_size // world`` rows a rank a step, from the rank's shard of a
  ``DistributedSampler``;
- rank 0 alone evaluates, checkpoints and writes ``history.json``; rank 0's
  parameters are broadcast over the ring at construction;
- each rank draws dropout masks from its own generator, seeded as
  ``training/distributed.py`` seeds it (rank 0 draws ``local``'s masks);
- the train loss in the history is the rank's own local mean (the JAX
  native trainer's behaviour; ``distributed`` averages over ranks), log
  lines and the perf line carry the rank, and each run ends with the
  rank-parity observables ``"{rank}: parameters: {sum:.10f}"`` and
  ``"{rank}: parameters sha256 {hex}"`` (of the parameters' float32
  bytes: equal digests, equal bits) and the ring's mean
  ``comm_wait_s``/``comm_active_s`` an update.

Three update schedules (:meth:`NativeDDPTrainer._optimizer_step`):

- replicated (``--no-sharded-update``): one allreduce of the flat
  gradient, divided by the world, then Adam on every parameter;
- sharded (``--sharded-update``, the default): the padded flat gradient
  reduce-scattered, divided by the world, Adam on this rank's 1/world
  slice (``parallel/sharded_update.py:ShardedUpdate.update_``), the fresh
  slices all-gathered.  Bucketed (``--bucketed-comm``, the default): the
  shard range split by ``parallel/bucketing.py`` into ``--bucket-mb``
  buckets, every bucket's reduce-scatter posted first, then bucket by
  bucket: wait, Adam, post its all-gather (which overlaps the next
  bucket's Adam); then the all-gathers waited.  ``--no-bucketed-comm`` is
  the same schedule over one bucket.  Bucket b's wire vector is the
  columns ``[lo, hi)`` of the ``(world, shard)`` gradient, so the ring sums
  every element in the order of the whole reduce-scatter, and the three
  schedules give the same bits (at worlds 1 and 2; the replicated
  allreduce chunks the unpadded vector).

The ring runs on the host.  On the card the gradient (or each bucket's
columns) is copied once a step into reused pinned host buffers, the stream
is synchronised before the ring reads them, and results go back with
``non_blocking`` copies on the current stream; on the CPU the ring gets
fresh tensors.  It never gets a view of a parameter or of a gradient.
Each step's ``(comm_wait_s, comm_active_s)`` - the time the host sat
blocked in the ring, and the collectives' own time on its worker - is
``_last_step_comm`` (and ``comm_log`` keeps every step's).

Checkpoints hold ``torch.optim.Adam``'s unsharded state: at each epoch end
of a world that checkpoints, every rank gathers its Adam slice and its
dropout generator's state over the ring and rank 0 writes the gathered
state, so a ``distributed-native`` checkpoint resumes under ``local`` and
``distributed``, and the reverse, and a world of its size resumes each
rank's dropout stream.

With ``--metrics`` each step event carries the ring's ``comm_wait_s``
and ``overlap_frac`` (``training/base.py``).

Launch: one process a rank with ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
``WORLD_SIZE`` set (no launcher: a world of 1), subcommand
``distributed-native``; :func:`launch_world` spawns such a world.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from pathlib import Path

import torch

from pytorch_distributed_rnn_tpu_torch.data.sampler import DistributedSampler
from pytorch_distributed_rnn_tpu_torch.parallel.bucketing import DEFAULT_BUCKET_MB
from pytorch_distributed_rnn_tpu_torch.parallel.sharded_update import ShardedUpdate
from pytorch_distributed_rnn_tpu_torch.runtime import native
from pytorch_distributed_rnn_tpu_torch.training.base import Trainer
from pytorch_distributed_rnn_tpu_torch.training.distributed import _RANK_SEED_STRIDE, _adam

# the JAX trainer's reasons (training/native_ddp.py) for the flags it rejects
CHECKPOINT_ASYNC_REJECTED = (
    "--checkpoint-async needs --checkpoint-format sharded, which "
    "distributed-native does not support (the TCP ring has no process "
    "group to coordinate a sharded save)")
CHECKPOINT_SHARDED_REJECTED = (
    "distributed-native checkpoints are gathered files that rank 0 writes; "
    "--checkpoint-format sharded needs a world that coordinates a sharded "
    "save (the TCP ring has none)")
FUSE_RUN_REJECTED = (
    "--fuse-run: distributed-native moves the gradients over the host's TCP "
    "ring every step, so the host handles every batch and the run cannot be "
    "one device program")


class _RingGather:
    """The ring as :class:`ShardedUpdate`'s gather: a device tensor from
    every rank, concatenated in rank order (a collective)."""

    def __init__(self, comm):
        self.comm = comm

    def all_gather(self, shard: torch.Tensor) -> torch.Tensor:
        return self.comm.allgather(shard.cpu()).reshape(-1).to(shard.device)


class NativeDDPTrainer(Trainer):
    """One rank of a ``distributed-native`` world on ``comm`` (a
    ``runtime.native.Communicator``, or any object with its collectives)."""

    # the host moves the gradients every step: the per-batch loop only
    GRAPH_STEP = False
    # as the JAX trainer (native_ddp.py): the step is the ring's schedule
    SUPPORTS_GRAD_ACCUM = False

    def __init__(self, model, training_set, batch_size: int, learning_rate: float,
                 validation_set=None, test_set=None, checkpoint_dir=None,
                 seed: int | None = None, checkpoint_every: int = 0, keep_checkpoints: int = 0,
                 fuse_run: bool = False, device="cuda", comm=None, sharded_update: bool = True,
                 bucketed_comm: bool = True, bucket_mb: float = DEFAULT_BUCKET_MB,
                 checkpoint_format: str = "gathered", checkpoint_async: bool = False,
                 grad_accum: int = 1, faults=None, max_bad_steps: int = 0, recorder=None,
                 profile_steps=None):
        if comm is None:
            raise ValueError("NativeDDPTrainer needs the ring (comm=)")
        if checkpoint_async:
            raise ValueError(CHECKPOINT_ASYNC_REJECTED)
        if checkpoint_format == "sharded":
            raise ValueError(CHECKPOINT_SHARDED_REJECTED)
        rank, world = comm.rank, comm.world_size
        super().__init__(model, training_set, max(1, batch_size // world), learning_rate,
                         validation_set=validation_set if rank == 0 else None,
                         test_set=test_set if rank == 0 else None,
                         checkpoint_dir=checkpoint_dir if rank == 0 else None, seed=seed,
                         checkpoint_every=checkpoint_every, keep_checkpoints=keep_checkpoints,
                         fuse_run=fuse_run, device=device, grad_accum=grad_accum, faults=faults,
                         max_bad_steps=max_bad_steps, recorder=recorder,
                         profile_steps=profile_steps)
        seed = seed if seed is not None else 0
        self.comm = comm
        self.rank = rank
        self.world_size = world
        self.sampler = DistributedSampler(len(training_set), num_replicas=world, rank=rank,
                                          seed=seed)
        self.dropout_generator.manual_seed((seed ^ 0x5EED) + rank * _RANK_SEED_STRIDE)
        # whether the world checkpoints: the epoch-end gather is a
        # collective, so every rank decides alike (only rank 0 keeps the
        # directory)
        self._ckpt_world = checkpoint_dir is not None
        self._ckpt_cache = None
        self._dropout_cache = None
        self.comm_log = []
        self._pinned = {}
        guarded = self.guard is not None
        self.sharded_update = bool(sharded_update)
        adam = _adam(self.model.parameters(), learning_rate,
                     guarded=guarded and not self.sharded_update)
        self.bucket_plan = None
        if self.sharded_update:
            self.optimizer = ShardedUpdate(adam, world, rank, group=_RingGather(comm),
                                           guarded=guarded)
            if bucketed_comm:
                self.bucket_plan = self.optimizer.bucket_plan(bucket_mb)
        else:
            self.optimizer = adam
        self._broadcast_params()

    # -- staging between the device and the ring --------------------------------

    def _host(self, slot: str, shape, dtype: torch.dtype) -> torch.Tensor:
        """A reused pinned host buffer (the card), or a fresh one (the CPU)."""
        if self.device.type != "cuda":
            return torch.empty(shape, dtype=dtype)
        key = (slot, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _to_host(self, slot: str, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor``'s values in a host buffer the ring may read (and
        write): on the card an asynchronous copy into the slot's pinned
        buffer, complete only after :meth:`_fence`; on the CPU ``tensor``
        itself when it is contiguous (callers pass tensors they made),
        else a copy."""
        if self.device.type != "cuda":
            return tensor.contiguous()
        return self._host(slot, tensor.shape, tensor.dtype).copy_(tensor, non_blocking=True)

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        """A ring result on the device, queued on the current stream (a
        pinned buffer is rewritten only after the next step's fence)."""
        return host.to(self.device, non_blocking=True)

    @torch.no_grad()
    def _broadcast_params(self) -> None:
        """Rank 0's parameters on every rank (the DDP construction's
        broadcast)."""
        params = list(self.model.parameters())
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        host = self._to_host("broadcast", flat)
        self._fence()
        fresh = self._to_device(self.comm.broadcast(host, root=0))
        offset = 0
        for p in params:
            p.copy_(fresh[offset: offset + p.numel()].view_as(p))
            offset += p.numel()

    # -- the update schedules -----------------------------------------------------

    @torch.no_grad()
    def _optimizer_step(self) -> None:
        if self.sharded_update:
            wait_s, active_s = self._sharded_step()
        else:
            wait_s, active_s = self._replicated_step()
        self._last_step_comm = (wait_s, active_s)
        self.comm_log.append(self._last_step_comm)

    def _replicated_step(self) -> tuple[float, float]:
        """One allreduce of the flat gradient, divided by the world, then
        Adam on every parameter."""
        params = [p for p in self.model.parameters()]
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        host = self._to_host("grad", flat)
        self._fence()  # the backward and the copy, outside the ring's time
        t0 = time.perf_counter()
        summed = self.comm.allreduce(host)
        seconds = time.perf_counter() - t0
        mean = self._to_device(summed).div_(self.world_size)
        offset = 0
        for g in grads:
            g.copy_(mean[offset: offset + g.numel()].view_as(g))
            offset += g.numel()
        self.optimizer.step()
        return seconds, seconds

    def _sharded_step(self) -> tuple[float, float]:
        """Reduce-scatter, Adam on this rank's slice, all-gather, bucket by
        bucket over the plan's ranges of the shard (one range without a
        plan)."""
        su = self.optimizer
        world = self.world_size
        bounds = self.bucket_plan.bounds if self.bucket_plan is not None else ((0, su.shard),)
        g_cols = su.ravel([p.grad for p in su.params]).view(world, su.shard)
        wait_s = active_s = 0.0

        def finish(handle):
            nonlocal wait_s, active_s
            t0 = time.perf_counter()
            out = self.comm.wait(handle)
            wait_s += time.perf_counter() - t0
            active_s += handle.comm_seconds
            return out

        # every bucket's reduce-scatter posted before any result is read
        staged = [self._to_host(f"rs-in{b}", g_cols[:, lo:hi]) for b, (lo, hi) in
                  enumerate(bounds)]
        self._fence()
        reduce_scatters = [
            self.comm.reduce_scatter_async(host.reshape(-1),
                                           out=self._host(f"rs-out{b}", (hi - lo,), su.dtype))
            for b, ((lo, hi), host) in enumerate(zip(bounds, staged))]
        p_shard = su.shard_slice(su.ravel(su.params), self.rank)
        finite = None
        if su.nonfinite is not None:
            # the verdict is global: every reduce-scatter lands first, then
            # one flag a rank is summed over the ring (on the host, where
            # the reduced slices are)
            reduced = [finish(handle) for handle in reduce_scatters]
            t0 = time.perf_counter()
            bad_sum = self.comm.allreduce(su.local_bad(*reduced))
            seconds = time.perf_counter() - t0
            wait_s += seconds
            active_s += seconds
            finite = su.global_verdict(bad_sum).to(self.device)
            reduce_scatters = reduced
        su.advance(finite)
        all_gathers = []
        for b, (lo, hi) in enumerate(bounds):
            landed = reduce_scatters[b]
            g_sub = self._to_device(landed if finite is not None else finish(landed)).div_(world)
            p_sub = p_shard[lo:hi]
            su.update_(p_sub, g_sub, lo, finite)
            host = self._to_host(f"ag-in{b}", p_sub)
            self._fence()  # this bucket's Adam; later buckets still stream
            all_gathers.append(self.comm.allgather_async(
                host, out=self._host(f"ag-out{b}", (world * (hi - lo),), su.dtype)))
        su.record(finite)
        fresh = torch.empty(world, su.shard, dtype=su.dtype, device=self.device)
        for b, (lo, hi) in enumerate(bounds):
            fresh[:, lo:hi].copy_(finish(all_gathers[b]), non_blocking=True)
        torch._foreach_copy_(su.params, su.unravel(fresh.view(-1)))
        return wait_s, active_s

    # -- checkpoints ----------------------------------------------------------------

    def _train_epoch(self, formatter, eager=None):
        result = super()._train_epoch(formatter, eager)
        if self._ckpt_world:
            # every rank gathers (collectives); rank 0 writes the result
            if self.sharded_update:
                self._ckpt_cache = self.optimizer.state_dict()
            state = self.dropout_generator.get_state()
            gathered = self.comm.allgather(state.double())  # bytes, exact in float64
            self._dropout_cache = [row.to(torch.uint8) for row in
                                   gathered.reshape(self.world_size, -1)]
        return result

    def _dropout_states(self) -> list:
        if self._dropout_cache is None:
            raise RuntimeError("a checkpoint before any epoch-end gather: no dropout streams")
        return self._dropout_cache

    def _collective_ops(self) -> dict:
        """A step's ring collectives: one reduce-scatter and one all-gather
        a bucket (the guard's one-flag allreduce besides), or one
        allreduce of the flat gradient."""
        su = self.optimizer
        if not self.sharded_update:
            params = list(self.model.parameters())
            return {"all_reduce": {"count": 1, "bytes": sum(p.numel() * p.element_size()
                                                             for p in params)}}
        buckets = len(self.bucket_plan.bounds) if self.bucket_plan is not None else 1
        flat = self.world_size * su.shard * torch.tensor([], dtype=su.dtype).element_size()
        ops = {"reduce_scatter": {"count": buckets, "bytes": flat},
               "all_gather": {"count": buckets, "bytes": flat}}
        if su.nonfinite is not None:
            ops["all_reduce"] = {"count": 1, "bytes": 4}
        return ops

    def _checkpoint_opt_state(self) -> dict:
        if not self.sharded_update:
            return super()._checkpoint_opt_state()
        if self._ckpt_cache is None:
            raise RuntimeError("a sharded-update checkpoint before any epoch-end gather: "
                               "no unsharded state")
        return self._ckpt_cache


# -- the CLI rank ------------------------------------------------------------------


def rank_device(device: str) -> torch.device:
    """``cpu``, or ``cuda:(LOCAL_RANK or RANK) % device_count()`` (ranks
    beyond the cards share them)."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    return torch.device("cuda", local % torch.cuda.device_count())


def ring_from_env() -> native.Communicator:
    """This rank's ring: rank 0 builds the library (the others wait for
    it), then the rendezvous of ``runtime.native.init_from_env``."""
    if int(os.environ.get("RANK", "0")) == 0:
        native.build_native_library()
    else:
        native.wait_for_library()
    return native.init_from_env()


def execute(args):
    """The ``distributed-native`` subcommand on this rank: the ring from the
    launcher's environment, the kernels built by rank 0 before the others
    load them (on the card), then the shared run (``training._train``), and
    the rank-parity line."""
    from pytorch_distributed_rnn_tpu_torch import training
    from pytorch_distributed_rnn_tpu_torch.parallel import collectives

    logging.basicConfig(level=args.log)
    logging.getLogger().setLevel(args.log)
    device = rank_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # before the ring: its net:* events set the transport's fault environment
    faults = training.resolve_faults(args, rank=int(os.environ.get("RANK", "0")))
    with ring_from_env() as comm:
        if device.type == "cuda":
            collectives.build_kernels_once(comm)
        trainer = training._train(args, NativeDDPTrainer, comm, device=device, comm=comm,
                                  sharded_update=args.sharded_update,
                                  bucketed_comm=args.bucketed_comm, bucket_mb=args.bucket_mb,
                                  faults=faults)
        # the rank-parity observable: the same on every rank iff the
        # replicas stayed equal
        flat = torch.cat([p.detach().reshape(-1) for p in trainer.model.parameters()])
        logging.info(f"{comm.rank}: parameters: {float(flat.double().sum()):.10f}")
        training.log_parameter_digest(comm.rank, trainer.model)
        if trainer.comm_log:
            wait_s, active_s = (sum(column) / len(trainer.comm_log)
                                for column in zip(*trainer.comm_log))
            logging.info(f"{comm.rank}: ring: {len(trainer.comm_log)} updates, comm_wait_s "
                         f"{wait_s:.6f}, comm_active_s {active_s:.6f} an update")
    return trainer


def launch_world(world_size: int, argv, *, device: str, master_port: int | None = None,
                 cwd=None, timeout: float = 600.0, check: bool = True):
    """Spawn a local world of ``world_size`` processes, each running
    ``python -m pytorch_distributed_rnn_tpu_torch.main --device DEVICE
    <argv> distributed-native`` with the rendezvous environment set (a free
    port when ``master_port`` is None).  ``device`` (``"cuda"`` or
    ``"cpu"``) has no default: a world runs on the CPU only when asked.  Returns ``(returncode, stdout,
    stderr)`` a rank, in rank order; raises if a rank outlives ``timeout``
    seconds, and with ``check`` if a rank fails (a world killed on purpose
    passes ``check=False``)."""
    from pytorch_distributed_rnn_tpu_torch.utils.worlds import free_ports, spawn_world

    port = master_port if master_port is not None else free_ports(1)[0]
    repo = str(Path(__file__).resolve().parent.parent.parent)
    rank_cmds = []
    for rank in range(world_size):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank))
        env["PYTHONPATH"] = os.pathsep.join(p for p in (repo, env.get("PYTHONPATH")) if p)
        rank_cmds.append(([sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.main",
                           "--device", device, *map(str, argv), "distributed-native"], env))
    return spawn_world(rank_cmds, timeout=timeout, cwd=cwd, check=check)
