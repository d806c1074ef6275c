"""Adam with the ``optax.adam`` update, in ``torch.optim.Adam``'s state layout.

The data-parallel strategies keep one invariant of the JAX package: the
sharded update (``parallel/sharded_update.py``), which runs Adam on a flat
1/world slice of the raveled parameters, gives the same bits as the
replicated update, which runs it on each parameter.  That holds only if
both run one elementwise program whose result for an element does not
depend on where the element sits in its tensor.  :func:`adam_update_` is
that program: every step is one ``torch._foreach_*`` call of a single
IEEE operation (a product, a sum, a quotient, a square root), so no
kernel fuses two of them into one rounding in some positions and not in
others.  The replicated path calls it on the list of parameters, the
sharded path on a list of one flat shard.

The formula is ``optax.adam``'s (``eps_root = 0``)::

    m = b1 m + (1 - b1) g           v = b2 v + (1 - b2) g g
    p = p - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

:class:`Adam` keeps ``torch.optim.Adam``'s parameter groups and
per-parameter state (``step``, ``exp_avg``, ``exp_avg_sq``), so its
``state_dict`` loads into ``torch.optim.Adam`` (the ``local`` trainer's)
and the reverse: a checkpoint of any strategy resumes in any other.
"""

from __future__ import annotations

import torch


def adam_update_(params, grads, exp_avgs, exp_avg_sqs, step: int, lr: float,
                 beta1: float, beta2: float, eps: float) -> None:
    """One Adam step in place on lists of same-shaped tensors (``step`` is
    the count after this step, from 1)."""
    torch._foreach_mul_(exp_avgs, beta1)
    torch._foreach_add_(exp_avgs, torch._foreach_mul(grads, 1.0 - beta1))
    torch._foreach_mul_(exp_avg_sqs, beta2)
    squares = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(squares, 1.0 - beta2)
    torch._foreach_add_(exp_avg_sqs, squares)
    updates = torch._foreach_div(exp_avgs, 1.0 - beta1 ** step)
    denoms = torch._foreach_div(exp_avg_sqs, 1.0 - beta2 ** step)
    torch._foreach_sqrt_(denoms)
    torch._foreach_add_(denoms, eps)
    torch._foreach_div_(updates, denoms)
    torch._foreach_mul_(updates, lr)
    torch._foreach_sub_(params, updates)


class Adam(torch.optim.Adam):
    """``torch.optim.Adam``'s groups and state, stepped by
    :func:`adam_update_`.  ``step`` stays a float32 CPU tensor a parameter,
    as ``torch.optim.Adam`` keeps it."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, lr=lr, betas=betas, eps=eps)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            for p, state in zip(params, states):
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            steps = [state["step"] for state in states]
            torch._foreach_add_(steps, 1.0)
            beta1, beta2 = group["betas"]
            adam_update_(params, [p.grad for p in params],
                         [state["exp_avg"] for state in states],
                         [state["exp_avg_sq"] for state in states],
                         int(steps[0]), group["lr"], beta1, beta2, group["eps"])
        return None
