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
``state_dict`` loads into ``torch.optim.Adam`` and the reverse: a
checkpoint of any strategy resumes in any other.

:class:`DeviceStepAdam`, the ``local`` trainer's, keeps its step count on
the parameters' device, so that a CUDA graph that captured its step sees
the count of each replay in the bias corrections ``1 - b^t``, which the
host form would freeze at their values during capture.  The trainer's
eager loop and its graph path both step it, so the two are bitwise
comparable by construction.

The guarded update (``--max-bad-steps``) is ``optax.apply_if_finite``'s
counterpart inside the same program: :func:`adam_update_` with a
``finite`` verdict (a 0-d bool on the device, :meth:`NonFiniteCounters.
verdict`: ``isfinite`` of every gradient element) computes the step into
new tensors and selects them, or the old values, with ``torch.where``, so
a step whose gradients hold a NaN or an Inf leaves the parameters and
both moments as they were, and the caller leaves Adam's count where it
was.  :class:`NonFiniteCounters` keeps ``notfinite_count`` (reset to 0 by a
finite step) and ``total_notfinite`` on the device.  Nothing syncs with
the host, so the local trainer's CUDA graph captures the guarded step; on
a finite step the result has the unguarded update's bits.
"""

from __future__ import annotations

import torch


def adam_update_(params, grads, exp_avgs, exp_avg_sqs, step, lr: float,
                 beta1: float, beta2: float, eps: float, finite=None) -> None:
    """One Adam step in place on lists of same-shaped tensors.  ``step`` is
    the count after this step, from 1: a Python int (the host form), or a
    0-d float64 tensor on the parameters' device (the device form, whose
    bias corrections are computed there: nothing of the step goes through
    the host).  The device form computes them in float64, as the host
    form's Python floats are, and rounds them to the parameters' float32
    as the host form's division does: on the CPU both forms give the same
    bits.  On the card they round apart, so every update of the port that
    a bitwise comparison meets takes the device form: the trainers', the
    sharded update's and the parameter server's.

    ``finite`` (a 0-d bool tensor on the device, or None: unguarded) is
    the guarded update's verdict: the step is computed into new tensors
    by the same operations, and each parameter and moment takes the new
    value where ``finite`` holds and keeps its own where not."""
    if isinstance(step, torch.Tensor):
        bias1 = [(1.0 - torch.pow(beta1, step)).float()] * len(params)
        bias2 = [(1.0 - torch.pow(beta2, step)).float()] * len(params)
    else:
        bias1, bias2 = 1.0 - beta1 ** step, 1.0 - beta2 ** step
    guarded = finite is not None
    if guarded:
        m = torch._foreach_mul(exp_avgs, beta1)
        v = torch._foreach_mul(exp_avg_sqs, beta2)
    else:
        torch._foreach_mul_(exp_avgs, beta1)
        torch._foreach_mul_(exp_avg_sqs, beta2)
        m, v = exp_avgs, exp_avg_sqs
    torch._foreach_add_(m, torch._foreach_mul(grads, 1.0 - beta1))
    squares = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(squares, 1.0 - beta2)
    torch._foreach_add_(v, squares)
    updates = torch._foreach_div(m, bias1)
    denoms = torch._foreach_div(v, bias2)
    torch._foreach_sqrt_(denoms)
    torch._foreach_add_(denoms, eps)
    torch._foreach_div_(updates, denoms)
    torch._foreach_mul_(updates, lr)
    if not guarded:
        torch._foreach_sub_(params, updates)
        return
    fresh = torch._foreach_sub(params, updates)
    for olds, news in ((params, fresh), (exp_avgs, m), (exp_avg_sqs, v)):
        for old, new in zip(olds, news):
            torch.where(finite, new, old, out=old)  # one pass, in place


class NonFiniteCounters:
    """``optax.apply_if_finite``'s two counters on the device, in one int32
    tensor ``counts``: ``[notfinite_count, total_notfinite]`` (the
    consecutive non-finite steps, reset by a finite step, and all of
    them).  :meth:`read` takes both in one device-to-host copy."""

    def __init__(self, device):
        self.counts = torch.zeros(2, dtype=torch.int32, device=device)

    @staticmethod
    def verdict(grads) -> torch.Tensor:
        """Whether every element of every gradient is finite: a 0-d bool on
        their device.  Per element: a sum or a norm could overflow on
        finite values."""
        flags = [torch.isfinite(g).all() for g in grads]
        return flags[0] if len(flags) == 1 else torch.stack(flags).all()

    def record_(self, finite: torch.Tensor) -> None:
        """Count one step with verdict ``finite``, on the device."""
        bad = (~finite).to(torch.int32)
        # consecutive -> (consecutive + 1) * bad, total -> total + bad
        self.counts.mul_(torch.stack([bad, torch.ones_like(bad)])).add_(bad)

    def read(self) -> tuple[int, int]:
        consecutive, total = self.counts.tolist()
        return consecutive, total

    def state_dict(self) -> dict:
        consecutive, total = self.read()
        return {"notfinite_count": consecutive, "total_notfinite": total}

    def load_state_dict(self, state: dict) -> None:
        self.counts.copy_(torch.tensor([state["notfinite_count"], state["total_notfinite"]],
                                       dtype=torch.int32))


class Adam(torch.optim.Adam):
    """``torch.optim.Adam``'s groups and state, stepped by
    :func:`adam_update_`.  ``step`` stays a float32 CPU tensor a parameter,
    as ``torch.optim.Adam`` keeps it."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, lr=lr, betas=betas, eps=eps)

    def _group_states(self, group) -> tuple:
        """The group's parameters that have a gradient and their states,
        made on first use."""
        params = [p for p in group["params"] if p.grad is not None]
        states = [self.state[p] for p in params]
        for p, state in zip(params, states):
            if not state:
                state["step"] = torch.zeros((), dtype=torch.float32)
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return params, states

    def _update(self, group, params, states, step, finite=None) -> None:
        beta1, beta2 = group["betas"]
        adam_update_(params, [p.grad for p in params],
                     [state["exp_avg"] for state in states],
                     [state["exp_avg_sq"] for state in states],
                     step, group["lr"], beta1, beta2, group["eps"], finite)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            params, states = self._group_states(group)
            if not params:
                continue
            steps = [state["step"] for state in states]
            torch._foreach_add_(steps, 1.0)
            self._update(group, params, states, int(steps[0]))
        return None


class DeviceStepAdam(Adam):
    """:class:`Adam` with the step count on the parameters' device: one
    float64 0-d tensor, which every step adds 1 to there and
    :func:`adam_update_` reads in its device form.  Nothing of
    :meth:`step` reads the host, so a CUDA graph can capture it.  The
    parameters step together (every step gives each of them a gradient).

    The per-parameter ``state["step"]`` keeps ``torch.optim.Adam``'s layout,
    a float32 CPU tensor; it is brought up to the device count (one device
    read) when :meth:`state_dict` is taken, and the device count is set
    from it when a ``state_dict`` is loaded.

    ``guarded=True`` makes every step the guarded update, its verdict over
    every gradient, with ``nonfinite`` (:class:`NonFiniteCounters`) counting
    the skipped steps; a skipped step leaves the count as it was.  The
    counters stay out of ``state_dict`` (``torch.optim.Adam``'s layout): a
    checkpoint carries them in a section of their own."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 guarded: bool = False):
        super().__init__(params, lr=lr, betas=betas, eps=eps)
        self.device_steps = None  # made at the first step or load
        self.nonfinite = (NonFiniteCounters(self.param_groups[0]["params"][0].device)
                          if guarded else None)

    def _steps_on(self, device) -> torch.Tensor:
        if self.device_steps is None:
            self.device_steps = torch.zeros((), dtype=torch.float64, device=device)
        return self.device_steps

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        if len(self.param_groups) != 1:
            raise ValueError("DeviceStepAdam keeps one step count: one parameter group")
        group = self.param_groups[0]
        params, states = self._group_states(group)
        if not params:
            return None
        steps = self._steps_on(params[0].device)
        if self.nonfinite is None:
            steps.add_(1.0)
            self._update(group, params, states, steps)
            return None
        finite = self.nonfinite.verdict([p.grad for p in params])
        steps.add_(finite.double())
        self._update(group, params, states, steps, finite)
        self.nonfinite.record_(finite)
        return None

    def state_dict(self):
        if self.device_steps is not None:
            count = self.device_steps.item()
            for state in self.state.values():
                state["step"].fill_(count)
        return super().state_dict()

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        states = list(self.state.values())
        if states:
            device = self.param_groups[0]["params"][0].device
            self._steps_on(device).fill_(float(states[0]["step"]))
