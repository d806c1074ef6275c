"""Data-parallel gradient synchronisation: the DDP and Horovod flavours.

The counterpart of the JAX package's ``parallel/dp.py``.  The reference
gets data parallelism from wrappers: torch DDP's reducer allreduces
gradient buckets during ``backward()`` (``trainer/ddp.py:19``), Horovod's
``DistributedOptimizer`` allreduces inside ``step()`` and
``broadcast_parameters`` syncs the weights at the start
(``trainer/horovod.py:33-42``).  The port keeps both hooks:

- :func:`wrap_ddp` wraps the model in ``DistributedDataParallel`` with
  :func:`flat_mean_hook` as its communication hook;
- :class:`DistributedOptimizer` wraps an optimizer and averages the local
  gradients first thing in its ``step()``;
- :func:`broadcast_params` gives every rank rank 0's parameters.

Both flavours average the same buffer: the gradients in ``parameters()``
order, raveled and zero-padded to a multiple of the world, prescaled by
1/world and summed (``World.pmean_``).  DDP's own reducer would allreduce
its buckets, which hold the parameters in another order; Gloo's sum of an
element depends on where it sits in the buffer (at 3 and 4 ranks), so the
hook moves the buckets' gradients into that one buffer.  The hook waits
for the last bucket of a backward pass and reduces them all at once (the
motion classifier's gradients fill one bucket).  With ``--sharded-update``
neither wrapper is used: the sharded update reduce-scatters that same
buffer (``parallel/sharded_update.py``), which is why the JAX docstring
says both flavours share its one body (``dp.py:93-99``).
"""

import torch
from torch.nn.parallel import DistributedDataParallel


def broadcast_params(params, group, root: int = 0) -> None:
    """Every rank takes rank ``root``'s parameters: the
    ``hvd.broadcast_parameters`` analogue (one coalesced broadcast)."""
    with torch.no_grad():
        group.broadcast_from_(list(params), root)


class DistributedOptimizer:
    """``hvd.DistributedOptimizer``: ``step()`` averages the local
    gradients over the ranks (prescaled by 1/world, then summed, in one
    coalesced allreduce), then steps ``optimizer``.  Its state is the
    wrapped optimizer's."""

    def __init__(self, optimizer, group):
        self.optimizer = optimizer
        self.group = group

    def zero_grad(self, set_to_none: bool = True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @property
    def nonfinite(self):
        """The wrapped optimizer's non-finite counters (None: unguarded)."""
        return getattr(self.optimizer, "nonfinite", None)

    @torch.no_grad()
    def step(self):
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        self.group.pmean_([p.grad for p in params])
        self.optimizer.step()

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: dict):
        self.optimizer.load_state_dict(state)


class FlatMeanState:
    """The state of :func:`flat_mean_hook`: the parameters in their order,
    the process group, and the buckets of this backward pass so far."""

    def __init__(self, params, group):
        self.params = list(params)
        self.group = group
        self.pending = []


def flat_mean_hook(state, bucket):
    """DDP communication hook: the gradients of every bucket averaged as
    one flat buffer in ``parameters()`` order (``World.pmean_``), the
    buffer the Horovod flavour and the sharded update reduce too.  Early
    buckets get a future that completes with the last bucket."""
    future = torch.futures.Future()
    state.pending.append((bucket, future))
    if bucket.is_last():
        grads = {}
        for b, _ in state.pending:
            grads.update({id(p): g for p, g in zip(b.parameters(), b.gradients())})
        state.group.pmean_([grads[id(p)] for p in state.params])
        for b, f in state.pending:
            f.set_result(b.buffer())
        state.pending = []
    return future


def wrap_ddp(model, group):
    """``model`` in ``DistributedDataParallel`` (its construction broadcasts
    rank 0's parameters and buffers), reduced by :func:`flat_mean_hook`."""
    device_ids = [group.device.index] if group.device.type == "cuda" else None
    ddp = DistributedDataParallel(model, device_ids=device_ids, find_unused_parameters=False)
    ddp.register_comm_hook(FlatMeanState(model.parameters(), group), flat_mean_hook)
    return ddp
