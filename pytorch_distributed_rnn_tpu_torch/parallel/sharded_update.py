"""Cross-replica sharded weight update (PAPERS.md 2004.13336).

The counterpart of the JAX package's ``parallel/sharded_update.py``, its
SPMD and process-per-rank parts (the bucket plan of the native ring is not
ported).  Instead of allreducing the whole gradient and running the whole
Adam step on every rank, each rank

1. reduce-scatters the flat gradient, prescaled by 1/world as DDP's
   reducer prescales (``World.reduce_scatter_mean``),
2. runs Adam on its 1/world slice (``ops/adam.py:adam_update_``),
3. all-gathers the fresh parameters (``all_gather_into_tensor``),
4. and unravels them into the module's parameters.

Layout: the parameters in ``parameters()`` order, raveled into one vector
of ``size`` elements and zero-padded to ``padded = shard * world``; rank r
owns ``[r * shard, (r + 1) * shard)`` and keeps only that slice of Adam's
``exp_avg`` and ``exp_avg_sq``.  :meth:`ShardedUpdate.replicated_opt_state`
and :meth:`ShardedUpdate.flat_opt_state` are the bijection between that flat
state and ``torch.optim.Adam``'s per-parameter ``state_dict``, so
checkpoints always carry the unsharded layout and resume under any
strategy.

Because the reduce-scatter's slice has the bits of the allreduce of the
same buffer, and Adam's result for an element does not depend on where the
element sits, the sharded update equals the replicated one bit for bit.
"""

from __future__ import annotations

import torch

from pytorch_distributed_rnn_tpu_torch.ops.adam import adam_update_
from pytorch_distributed_rnn_tpu_torch.parallel.collectives import padded_size


class ShardedUpdate:
    """The sharded Adam step for ONE (optimizer, world) binding, with the
    optimizer's interface (``zero_grad``, ``step``, ``state_dict``,
    ``load_state_dict``).  ``optimizer`` (an ``ops.adam.Adam``) supplies
    the parameters and hyperparameters and is never stepped itself.
    ``group`` (a ``collectives.World``) is needed only to step and to
    gather the state; the layout methods work without it."""

    def __init__(self, optimizer, world_size: int, rank: int = 0, group=None):
        if len(optimizer.param_groups) != 1:
            raise ValueError("ShardedUpdate takes an optimizer with one parameter group")
        self.optimizer = optimizer
        self.params = list(optimizer.param_groups[0]["params"])
        self.world = int(world_size)
        self.rank = int(rank)
        self.group = group
        self.size = sum(p.numel() for p in self.params)
        self.padded = padded_size(self.size, self.world)
        self.shard = self.padded // self.world
        self.dtype = self.params[0].dtype
        device = self.params[0].device
        self.steps = 0
        self.exp_avg = torch.zeros(self.shard, dtype=self.dtype, device=device)
        self.exp_avg_sq = torch.zeros(self.shard, dtype=self.dtype, device=device)

    # -- layout ---------------------------------------------------------------

    def pad_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """Zero-pad a raveled vector of ``size`` elements to ``padded``."""
        out = torch.zeros(self.padded, dtype=flat.dtype, device=flat.device)
        out[: self.size] = flat
        return out

    def shard_slice(self, flat: torch.Tensor, rank: int) -> torch.Tensor:
        return flat[rank * self.shard: (rank + 1) * self.shard]

    def ravel(self, tensors) -> torch.Tensor:
        """Tensors shaped like the parameters -> one padded flat vector."""
        flat = torch.zeros(self.padded, dtype=self.dtype, device=self.params[0].device)
        torch.cat([t.detach().reshape(-1) for t in tensors], out=flat[: self.size])
        return flat

    def unravel(self, flat: torch.Tensor) -> list:
        """A padded (or ``size``-long) flat vector -> views shaped like the
        parameters."""
        views, offset = [], 0
        for p in self.params:
            views.append(flat[offset: offset + p.numel()].view_as(p))
            offset += p.numel()
        return views

    # -- the step ---------------------------------------------------------------

    def zero_grad(self, set_to_none: bool = True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self):
        group = self.optimizer.param_groups[0]
        beta1, beta2 = group["betas"]
        g_shard = self.group.reduce_scatter_mean(self.ravel([p.grad for p in self.params]))
        p_shard = self.shard_slice(self.ravel(self.params), self.rank)
        self.steps += 1
        adam_update_([p_shard], [g_shard], [self.exp_avg], [self.exp_avg_sq], self.steps,
                     group["lr"], beta1, beta2, group["eps"])
        fresh = self.group.all_gather(p_shard)
        torch._foreach_copy_(self.params, self.unravel(fresh))

    # -- layout bijection (checkpoints stay unsharded) ----------------------------

    def replicated_opt_state(self, flat_state: dict) -> dict:
        """``{"step", "exp_avg", "exp_avg_sq"}`` with padded flat vectors ->
        ``torch.optim.Adam``'s ``state_dict`` (no state before the first
        step, as Adam has none)."""
        template = self.optimizer.state_dict()
        step = int(flat_state["step"])
        state = {}
        if step > 0:
            moments = zip(self.unravel(flat_state["exp_avg"]),
                          self.unravel(flat_state["exp_avg_sq"]))
            for i, (m, v) in enumerate(moments):
                state[i] = {"step": torch.tensor(float(step), dtype=torch.float32),
                            "exp_avg": m.clone(), "exp_avg_sq": v.clone()}
        return {"state": state, "param_groups": template["param_groups"]}

    def flat_opt_state(self, std_state: dict) -> dict:
        """``torch.optim.Adam``'s ``state_dict`` -> the padded flat state."""
        state = std_state["state"]
        if not state:
            zeros = torch.zeros(self.padded, dtype=self.dtype)
            return {"step": 0, "exp_avg": zeros, "exp_avg_sq": zeros.clone()}
        per_param = [state[i] for i in range(len(self.params))]
        return {
            "step": int(per_param[0]["step"]),
            "exp_avg": self.pad_flat(torch.cat([s["exp_avg"].reshape(-1) for s in per_param])),
            "exp_avg_sq": self.pad_flat(
                torch.cat([s["exp_avg_sq"].reshape(-1) for s in per_param])),
        }

    def state_dict(self) -> dict:
        """The unsharded ``torch.optim.Adam`` layout.  A collective: every
        rank calls it (each rank holds only its slice of the moments)."""
        flat_state = {"step": self.steps,
                      "exp_avg": self.group.all_gather(self.exp_avg).cpu(),
                      "exp_avg_sq": self.group.all_gather(self.exp_avg_sq).cpu()}
        return self.replicated_opt_state(flat_state)

    def load_state_dict(self, std_state: dict):
        """Adopt this rank's slice of an unsharded Adam state, and its
        hyperparameters."""
        self.optimizer.param_groups[0].update(
            {k: v for k, v in std_state["param_groups"][0].items() if k != "params"})
        flat = self.flat_opt_state(std_state)
        self.steps = flat["step"]
        device = self.exp_avg.device
        self.exp_avg = self.shard_slice(flat["exp_avg"], self.rank).to(device, copy=True)
        self.exp_avg_sq = self.shard_slice(flat["exp_avg_sq"], self.rank).to(device, copy=True)
