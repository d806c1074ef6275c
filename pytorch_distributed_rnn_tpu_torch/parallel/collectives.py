"""Process groups and flat collectives over ``torch.distributed``.

The counterpart of the JAX package's ``parallel/collectives.py``.  There,
"ranks" are positions on a mesh axis of one SPMD program and the
collectives are ``psum``/``pmean`` inside ``shard_map``.  Here, as in the
reference (``mpirun`` with DDP or Horovod), each rank is a process: the
launcher (``torchrun``, or :mod:`.launch`) sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, and
:func:`init_process_group` joins the group they name.  With none set the
world is 1.

Backend rule (:func:`choose_backend`), decided up front from the ranks on
this host and the cards it has:

- ``--device cpu``: ``gloo``.
- On the card, one rank a GPU: ``nccl``, rank r on ``cuda:LOCAL_RANK``.
- On the card, more ranks than GPUs: NCCL refuses two ranks on one device,
  so the ranks share the cards (``cuda:LOCAL_RANK % count``) over ``gloo``.
  Gloo reduces only host tensors for most collectives (its GPU support
  covers broadcast and allreduce alone), so in that arm every collective
  of this module moves its buffer through a pinned host buffer.

The helpers work on one flat buffer a call, the coalesced form of the JAX
``pmean_tree``/``psum_tree``/``broadcast_from``.  Averages are a sum of
values each prescaled by 1/world, as DDP's reducer prescales its buckets;
the sharded update (``parallel/sharded_update.py``) reduce-scatters the
same prescaled buffer, so its slice has the same bits as the allreduce's.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def choose_backend(device_type: str, local_world: int, device_count: int) -> str:
    """``gloo`` on the CPU and where more ranks than cards share a host,
    else ``nccl``."""
    if device_type == "cpu":
        return "gloo"
    if device_count < 1:
        raise RuntimeError("CUDA is not available on this machine; pass --device cpu "
                           "to run on the CPU")
    return "nccl" if local_world <= device_count else "gloo"


def padded_size(size: int, world: int) -> int:
    """``size`` rounded up to a multiple of ``world``: the length of every
    flat buffer the helpers reduce, so that the replicated and the sharded
    update move identical buffers."""
    return -(-size // world) * world


@dataclass
class World:
    """This process's place in the group: its rank, the world size, its
    device and the backend.  ``created`` says whether
    :func:`init_process_group` made the group (then :func:`destroy` ends
    it)."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    backend: str
    created: bool = False
    _pinned: dict = field(default_factory=dict, repr=False)

    @property
    def host_staged(self) -> bool:
        """Whether collectives go through host buffers (gloo on the card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _host(self, tensor: torch.Tensor, slot: str) -> torch.Tensor:
        """A pinned host buffer of ``tensor``'s shape, one a slot, reused."""
        key = (slot, tuple(tensor.shape), tensor.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _to_wire(self, tensor: torch.Tensor, slot: str) -> torch.Tensor:
        if not self.host_staged:
            return tensor
        return self._host(tensor, slot).copy_(tensor)

    # -- flat collectives -----------------------------------------------------

    def all_reduce_sum_(self, flat: torch.Tensor) -> torch.Tensor:
        wire = self._to_wire(flat, "reduce")
        dist.all_reduce(wire, op=dist.ReduceOp.SUM)
        return flat if wire is flat else flat.copy_(wire)

    def all_reduce_mean_(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` (length a multiple of the world) averaged over the
        ranks in place: prescaled by 1/world, then summed."""
        flat.mul_(1.0 / self.size)
        return self.all_reduce_sum_(flat)

    def reduce_scatter_mean(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's 1/world slice of the average of ``flat``, prescaled
        by 1/world as :meth:`all_reduce_mean_` is (``flat`` is scaled in
        place)."""
        flat.mul_(1.0 / self.size)
        wire = self._to_wire(flat, "scatter-in")
        out = torch.empty(flat.numel() // self.size, dtype=flat.dtype, device=wire.device)
        dist.reduce_scatter_tensor(out, wire, op=dist.ReduceOp.SUM)
        return out.to(flat.device)

    def all_gather(self, shard: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        """Every rank's ``shard`` in rank order, one flat tensor (``out``
        when given)."""
        if out is None:
            out = torch.empty(shard.numel() * self.size, dtype=shard.dtype, device=shard.device)
        wire_in = self._to_wire(shard, "gather-in")
        wire_out = self._host(out, "gather-out") if self.host_staged else out
        dist.all_gather_into_tensor(wire_out, wire_in)
        return out if wire_out is out else out.copy_(wire_out)

    def broadcast_(self, flat: torch.Tensor, src: int = 0) -> torch.Tensor:
        wire = self._to_wire(flat, "broadcast")
        dist.broadcast(wire, src=src)
        return flat if wire is flat else flat.copy_(wire)

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    # -- tensor lists, coalesced into one flat buffer ---------------------------

    def _coalesced_(self, tensors, reduce) -> None:
        tensors = list(tensors)
        size = sum(t.numel() for t in tensors)
        flat = torch.zeros(padded_size(size, self.size), dtype=tensors[0].dtype,
                           device=tensors[0].device)
        torch.cat([t.reshape(-1) for t in tensors], out=flat[:size])
        reduce(flat)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()

    def pmean_(self, tensors) -> None:
        """Each tensor replaced by its average over the ranks (the JAX
        ``pmean_tree``), one coalesced allreduce."""
        self._coalesced_(tensors, self.all_reduce_mean_)

    def psum_(self, tensors) -> None:
        """Each tensor replaced by its sum over the ranks (``psum_tree``)."""
        self._coalesced_(tensors, self.all_reduce_sum_)

    def broadcast_from_(self, tensors, src: int = 0) -> None:
        """Each tensor replaced by rank ``src``'s (``broadcast_from``)."""
        self._coalesced_(tensors, lambda flat: self.broadcast_(flat, src))


def init_process_group(device: str = "cuda", init_method: str | None = None) -> World:
    """Join (or, when the process has one, describe) the process group of
    this launch: ``gloo`` or ``nccl`` by :func:`choose_backend`, the rank's
    device made current.  Rendezvous at ``init_method`` when given, else
    through ``MASTER_ADDR``/``MASTER_PORT``; a world of 1 with neither
    needs no rendezvous."""
    rank = int(os.environ.get("RANK", "0"))
    size = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(size)))
    device_type = torch.device(device).type
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = choose_backend(device_type, local_world, count)
    rank_device = torch.device("cpu") if device_type == "cpu" else torch.device(
        "cuda", local_rank % count)
    if dist.is_initialized():
        if dist.get_world_size() != size or dist.get_rank() != rank:
            raise RuntimeError("the process group differs from RANK/WORLD_SIZE")
        return World(rank, size, local_rank, rank_device, dist.get_backend())
    if rank_device.type == "cuda":
        torch.cuda.set_device(rank_device)
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size)
    elif "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=size)
    elif size == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        raise RuntimeError(f"WORLD_SIZE={size} without MASTER_ADDR: start the ranks with "
                           "torchrun (python -m torch.distributed.run)")
    if rank == 0 and backend == "gloo" and rank_device.type == "cuda":
        log.info(f"{local_world} ranks share {count} card(s) over gloo (NCCL takes one rank "
                 "a card); collectives go through pinned host buffers")
    return World(rank, size, local_rank, rank_device, backend, created=True)


def destroy(world: World) -> None:
    """End the process group if :func:`init_process_group` made it."""
    if world.created and dist.is_initialized():
        dist.destroy_process_group()


def build_kernels_once(world: World, build=None) -> None:
    """Rank 0 builds the kernel libraries (``_build.build_all``); the other
    ranks wait at a barrier and then load what it built, so one launch
    runs one ``nvcc`` a source."""
    if world.rank == 0:
        if build is None:
            from pytorch_distributed_rnn_tpu_torch import _build

            build = _build.build_all
        build()
    world.barrier()
