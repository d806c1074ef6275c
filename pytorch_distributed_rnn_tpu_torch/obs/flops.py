"""Analytic FLOP and byte count of one train step, the efficiency ledger's
MFU numerator.

The counterpart of the JAX package's ``obs/flops.py``, which walks the
traced jaxpr of the step.  Here the step runs once on fake tensors
(``FakeTensorMode``: ``meta`` storage, shapes and dtypes only, nothing
computed, posing as CPU tensors) under :class:`FlopCountMode`, a
``TorchDispatchMode`` that sees every aten op of the forward, the loss,
the backward and the Adam update.  Two limits decide that design: the
port's kernels are ctypes calls that no dispatch mode sees, so the count
runs their plain versions (the RNN layers take the fused path wherever
the card's would, whose kernel wrappers take their plain versions for
CPU tensors; attention takes the dense path, as JAX's count is held
against its dense path), and ``torch.utils.flop_counter.FlopCounterMode``
counts matrix products only.

The costing rules are the JAX module's:

- a matrix product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv``,
  ``dot``): ``2 * output_elements * contraction_size``; the added term of
  ``addmm``/``baddbmm`` is one more op an output element, as JAX counts
  the separate ``add``;
- data movement (views, copies, concatenation, gathers, fills, tensor
  creation): 0;
- any other op: 1 an output element (transcendentals not weighted); an
  in-place op (``add_``, ``_foreach_mul_``) writes its first operand.

JAX counts its primitives, and some aten ops are several of them: softmax,
GELU, an activation's backward and ``mean`` are counted as the ops of
torch's own decomposition of them (``_DECOMPOSED``).

One rule keeps the count the step's rather than autograd's: the gradient
of an indexed slice (``x_proj[:, t]`` in the scan) is a zero tensor of
the whole with the slice in it, and autograd sums those with ``add``.
JAX stacks the per-step cotangents instead.  An ``add`` that takes such a
scattered gradient is counted as the data move it is (0), and its result
stays scattered.

The count is exact (no loop of unknown trip count), and it is the step
as executed: with ``--remat`` it includes the recomputed forward, and
the LSTM backward at H=33..110, which recomputes its gates, their
products.
"""

from __future__ import annotations

import copy
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# the products and the index of their left operand's contraction dimension
_MATMULS = {
    aten.mm.default: "mm", aten.addmm.default: "addmm", aten.bmm.default: "bmm",
    aten.baddbmm.default: "baddbmm", aten.mv.default: "mv", aten.dot.default: "dot",
}

# ops that move, view, fill or create data without arithmetic
_ZERO_FLOP_NAMES = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
    "squeeze", "unsqueeze", "select", "slice", "as_strided", "alias", "detach",
    "split", "split_with_sizes", "unbind", "chunk", "narrow", "diagonal",
    "view_as_real", "view_as_complex", "unfold", "lift_fresh", "lift_fresh_copy",
    "clone", "copy", "copy_", "_to_copy", "contiguous", "cat", "stack", "index",
    "index_select", "gather", "embedding", "select_backward", "slice_backward",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "fill", "fill_",
    "zero", "zero_", "empty", "empty_like", "empty_strided", "new_zeros", "new_ones",
    "new_empty", "new_full", "new_empty_strided", "scalar_tensor", "arange", "_local_scalar_dense",
    "resize_", "set_", "masked_fill", "_foreach_copy", "_foreach_zero", "to",
    "convert_element_type", "broadcast_in_dim",
})

# composite ops counted as the ops they decompose into (torch's
# decompositions), as JAX counts its primitives: softmax as max, sub, exp,
# sum and div; an activation's backward as its products
_DECOMPOSED = [aten.gelu, aten.gelu_backward, aten._softmax, aten._softmax_backward_data,
               aten._log_softmax, aten._log_softmax_backward_data, aten.sigmoid_backward,
               aten.tanh_backward, aten.mean]

# the ops whose result is a slice's gradient scattered into zeros
_SCATTERS = frozenset({"select_backward", "slice_backward"})


def _elems(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _matmul_flops(name: str, args, out) -> int:
    if name in ("mm", "bmm", "mv"):
        k = args[0].shape[-1]
    elif name in ("addmm", "baddbmm"):
        k = args[1].shape[-1]
    else:  # dot
        k = args[0].shape[0]
    return 2 * _elems(out.shape) * int(k)


def _tensors(value) -> list:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (tuple, list)):
        return [v for v in value if isinstance(v, torch.Tensor)]
    return []


class FlopCountMode(TorchDispatchMode):
    """Counts the FLOPs of the aten ops run inside it under the rules
    above: ``flops`` in all, ``matmul_flops`` of the products, and
    ``by_op`` ({op name: FLOPs})."""

    def __init__(self):
        super().__init__()
        from torch._decomp import get_decompositions

        self._decompositions = get_decompositions(_DECOMPOSED)
        self.by_op: dict[str, int] = {}
        self.matmul_flops = 0
        self._scattered: dict[int, weakref.ref] = {}  # id -> the tensor

    @property
    def flops(self) -> int:
        return sum(self.by_op.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        decomposition = None if func in _MATMULS else self._decompositions.get(func)
        if decomposition is not None:
            # a composite op (softmax, gelu, an activation's backward) is
            # counted as the core ops it decomposes into, as JAX counts
            # its primitives
            with self:
                out = decomposition(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if func in _MATMULS:
            flops = _matmul_flops(_MATMULS[func], args, out)
            self.matmul_flops += flops
            if _MATMULS[func] in ("addmm", "baddbmm"):
                self._add("add", _elems(out.shape))
        elif name in _SCATTERS:
            self._mark_scattered(out)
            return out
        elif name.rstrip("_") in _ZERO_FLOP_NAMES or name in _ZERO_FLOP_NAMES:
            return out
        elif name.rstrip("_") == "add" and any(map(self._is_scattered, _tensors(list(args)))):
            self._mark_scattered(out)
            return out
        else:
            written = _tensors(out) or (_tensors(args[0]) if name.endswith("_") else [])
            flops = sum(_elems(o.shape) for o in written)
        self._add(name, flops)
        return out

    def _mark_scattered(self, out) -> None:
        for t in _tensors(out):
            self._scattered[id(t)] = weakref.ref(t)

    def _is_scattered(self, t: torch.Tensor) -> bool:
        ref = self._scattered.get(id(t))
        return ref is not None and ref() is t

    def _add(self, name: str, flops: int) -> None:
        if flops:
            self.by_op[name] = self.by_op.get(name, 0) + flops


def _fake_model(model: torch.nn.Module, fake_mode) -> torch.nn.Module:
    """A copy of ``model`` whose parameters and buffers are fake CPU
    tensors of ``fake_mode`` (nothing of the real ones is copied), on the
    path the card takes: an RNN's fused layers where its kernels take the
    width, else the scan; attention's dense path."""
    from pytorch_distributed_rnn_tpu_torch.ops.rnn import resolve_rnn_impl

    memo = {}
    with fake_mode:
        for p in model.parameters():
            memo[id(p)] = torch.nn.Parameter(
                torch.empty(p.shape, dtype=p.dtype), requires_grad=p.requires_grad)
        for b in model.buffers():
            memo[id(b)] = torch.empty(b.shape, dtype=b.dtype)
    clone = copy.deepcopy(model, memo)
    if hasattr(clone, "cell"):
        hidden = clone.rnn[0]["w_hh"].shape[1]
        clone.impl = resolve_rnn_impl("auto", clone.cell, hidden, "cuda")
    elif hasattr(clone, "impl"):
        clone.impl = "dense"
    return clone


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# a recurrent model's step at these sequence lengths of its batch rows
# (sequence dimension 1) gives the count's affine law in the length
_SHORT_LENGTHS = (3, 4)


def _count_step(trainer, rows: int, length: int | None) -> FlopCountMode:
    """One counted train step of ``trainer`` over ``rows`` rows of its
    training features (cut to ``length`` along dimension 1 where given),
    on a fake copy of its model."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from pytorch_distributed_rnn_tpu_torch.ops.adam import DeviceStepAdam

    features, labels = trainer._device_train_data()
    shape = tuple(features.shape[1:])
    if length is not None:
        shape = (length,) + shape[1:]
    fake_mode = FakeTensorMode()
    model = _fake_model(trainer.model, fake_mode)
    clone = copy.copy(trainer)
    clone.model = model
    clone.device = torch.device("cpu")
    clone.dropout_generator = torch.Generator().manual_seed(0)
    model.train()
    with fake_mode:
        x = torch.empty((rows,) + shape, dtype=features.dtype)
        y = torch.empty((rows,) + tuple(labels.shape[1:]), dtype=labels.dtype)
        clone.optimizer = DeviceStepAdam(model.parameters(), lr=trainer.learning_rate,
                                         betas=(0.9, 0.999), eps=1e-8,
                                         guarded=trainer.guard is not None)
        with FlopCountMode() as mode:
            clone._gradients(x, y)
            if trainer.UPDATES_LOCALLY:
                clone.optimizer.step()
    return mode


def step_flop_stats(trainer, rows: int, extrapolate: bool = True) -> dict:
    """FLOPs and boundary bytes of one train step of ``trainer`` over a
    batch of ``rows`` rows: ``{"flops", "matmul_flops", "by_op",
    "arg_bytes", "out_bytes", "exact"}``.  The step is the trainer's own
    (its loss, its microbatches, its dropout) with an unsharded Adam
    update where it updates locally (``UPDATES_LOCALLY``), run on a
    fake copy of its model; ``arg_bytes`` counts the parameters, Adam's
    moments and the batch, ``out_bytes`` the updated parameters and
    moments and the loss and ``correct``.

    A recurrent model (a ``cell``) runs a Python loop over the sequence,
    one fake op costing about 0.2 ms of host time: at T=128 a count takes
    seconds.  Each op of its step is run once a step, or once a time step,
    so every term of the count is affine in the sequence length L, and with
    ``extrapolate`` the count at L is read off the counts at L = 3 and 4:
    c(L) = c(3) + (c(4) - c(3)) (L - 3), the same integers as a count at L
    (``tests/test_torch_ledger.py`` holds the two equal)."""
    features, labels = trainer._device_train_data()
    length = features.shape[1] if features.ndim > 1 else None
    if (extrapolate and hasattr(trainer.model, "cell") and length is not None
            and length > _SHORT_LENGTHS[1]):
        short, longer = (_count_step(trainer, rows, n) for n in _SHORT_LENGTHS)
        scale = length - _SHORT_LENGTHS[0]

        def at_length(a: int, b: int) -> int:
            return a + (b - a) * scale

        by_op = {name: at_length(short.by_op.get(name, 0), longer.by_op.get(name, 0))
                 for name in set(short.by_op) | set(longer.by_op)}
        matmul_flops = at_length(short.matmul_flops, longer.matmul_flops)
    else:
        mode = _count_step(trainer, rows, None)
        by_op, matmul_flops = mode.by_op, mode.matmul_flops
    by_op = {name: n for name, n in by_op.items() if n}
    param_bytes = _nbytes(trainer.model.parameters())
    batch_bytes = rows * (features[0].numel() * features.element_size()
                          + labels[0].numel() * labels.element_size())
    return {
        "flops": sum(by_op.values()),
        "matmul_flops": matmul_flops,
        "by_op": dict(sorted(by_op.items(), key=lambda kv: -kv[1])),
        "arg_bytes": 3 * param_bytes + batch_bytes,
        "out_bytes": 3 * param_bytes + 8,
        "exact": True,
    }
