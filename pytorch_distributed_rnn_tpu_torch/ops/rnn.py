"""RNN layers: one batched input projection, then the serial recurrence.

The counterpart of ``pytorch_distributed_rnn_tpu/ops/rnn.py``.  The input
projection for all timesteps is one ``(B*T, in) x (in, 4H)`` product; the
recurrence then carries only the ``(B, H) x (H, 4H)`` product and the gate
math.  The ``scan`` path runs that recurrence as a Python loop over T (a
few small launches per step on the card); the ``fused`` path runs it
through the hand-written kernels of ``ops/fused_rnn.py``.  Weight layout
and gate order follow torch (``w_ih`` (4H, in), gates i, f, g, o; GRU
r, z, n), the same as the JAX package, so parameters carry over by name.
"""

from __future__ import annotations

import torch

from pytorch_distributed_rnn_tpu_torch.ops.fused_rnn import (
    gru_kernel_supports,
    gru_layer_fused,
    kernel_supports,
    lstm_layer_fused,
)
from pytorch_distributed_rnn_tpu_torch.ops.initializers import lstm_uniform


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def init_rnn_layer(generator, input_size: int, hidden_size: int,
                   cell: str = "lstm", dtype=torch.float32) -> dict:
    """One layer's params, torch layout: ``w_ih`` (G*H, in), ``w_hh``
    (G*H, H), ``b_ih``, ``b_hh`` (G*H,), G = 4 (LSTM) or 3 (GRU), all
    U(-1/sqrt(H), 1/sqrt(H))."""
    gates = {"lstm": 4, "gru": 3}[cell] * hidden_size
    shapes = {
        "w_ih": (gates, input_size),
        "w_hh": (gates, hidden_size),
        "b_ih": (gates,),
        "b_hh": (gates,),
    }
    return {
        name: lstm_uniform(generator, shape, hidden_size, dtype)
        for name, shape in shapes.items()
    }


# ---------------------------------------------------------------------------
# Single layers
# ---------------------------------------------------------------------------


def lstm_input_proj(params, x):
    """Every timestep's LSTM pre-activation in one product: ``x`` (..., in)
    -> (..., 4H), with both bias vectors folded in.  Shared by the scan
    and fused paths.  The biases are summed first, so the backward reduces
    the (N, 4H) gate gradient into a bias gradient once, not twice."""
    return x @ params["w_ih"].T + (params["b_ih"] + params["b_hh"])


def gru_input_proj(params, x):
    """Every timestep's GRU input-side pre-activation: (B, T, 3H) with
    ``b_ih`` folded in.  ``b_hh`` stays out: the hidden-side n-bias sits
    inside the ``r *`` product, so it joins in the recurrent step."""
    return x @ params["w_ih"].T + params["b_ih"]


def lstm_step(w_hh_t, carry, xp_t):
    """One LSTM gate step.  ``xp_t`` (B, 4H) is the pre-activation with
    the input projection and both biases folded in; ``carry`` is (h, c).

    Mixed-precision contract: the carry stays float32, only the product
    runs in the compute dtype, and the emitted output takes ``xp_t``'s
    dtype.  All casts are no-ops in float32."""
    h, c = carry
    gates = (xp_t + h.to(xp_t.dtype) @ w_hh_t).float()
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h.to(xp_t.dtype)


def lstm_layer(params, x, h0=None, c0=None):
    """One LSTM layer over ``x`` (B, T, in): ``(outputs (B, T, H),
    (h_T, c_T))``.  The initial carry defaults to zeros, as in torch's
    ``nn.LSTM``."""
    batch, seq_len, _ = x.shape
    hidden = params["w_hh"].shape[1]
    x_proj = lstm_input_proj(params, x)
    w_hh_t = params["w_hh"].T
    zeros = x.new_zeros((batch, hidden), dtype=torch.float32)
    carry = (
        zeros if h0 is None else h0.float(),
        zeros if c0 is None else c0.float(),
    )
    outputs = []
    for t in range(seq_len):
        carry, out = lstm_step(w_hh_t, carry, x_proj[:, t])
        outputs.append(out)
    h_t, c_t = carry
    return torch.stack(outputs, dim=1), (h_t.to(x.dtype), c_t.to(x.dtype))


def gru_step(w_hh_t, b_hh, h, xp_t):
    """One GRU gate step (gate order r, z, n): ``xp_t`` (B, 3H) carries
    the input projection and ``b_ih``; ``b_hh`` joins the hidden-side
    product here because the n-gate's hidden bias sits inside ``r *``.
    Mixed-precision contract as :func:`lstm_step`."""
    h_proj = (h.to(xp_t.dtype) @ w_hh_t + b_hh).float()
    xr, xz, xn = xp_t.float().chunk(3, dim=-1)
    hr, hz, hn = h_proj.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    h = (1.0 - z) * n + z * h
    return h, h.to(xp_t.dtype)


def gru_layer(params, x, h0=None):
    """One GRU layer over ``x`` (B, T, in): ``(outputs (B, T, H), h_T)``,
    torch semantics ``n = tanh(x_n + b_in + r * (h @ w_hn.T + b_hn))``."""
    batch, seq_len, _ = x.shape
    hidden = params["w_hh"].shape[1]
    x_proj = gru_input_proj(params, x)
    w_hh_t = params["w_hh"].T
    h = x.new_zeros((batch, hidden), dtype=torch.float32) if h0 is None else h0.float()
    outputs = []
    for t in range(seq_len):
        h, out = gru_step(w_hh_t, params["b_hh"], h, x_proj[:, t])
        outputs.append(out)
    return torch.stack(outputs, dim=1), h.to(x.dtype)


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------


def dtype_of(precision: str):
    """The one precision-string -> compute-dtype mapping (None = float32)."""
    return torch.bfloat16 if precision == "bf16" else None


def resolve_rnn_impl(impl: str, cell: str, hidden: int | None = None,
                     device=None) -> str:
    """Resolve the recurrence implementation.

    ``"scan"``: the Python loop over T.  ``"fused"``: the hand-written
    kernels of ``ops/fused_rnn.py`` (their plain versions on CPU tensors).
    ``"auto"`` takes ``fused`` for an LSTM or a GRU on a CUDA device at
    every hidden size the cell's kernels take, 1..512 for both
    (``kernel_supports``, ``gru_kernel_supports``: one block up to H=110
    or 126, a 16-CTA cluster above), else ``scan``.  Explicit ``fused`` is
    honoured on a CPU device at any hidden size, since the plain versions
    take every width (as the JAX package honours it, in interpret mode);
    on any other device, and where ``device`` is None (not known), it
    raises at a hidden size the kernels do not take: no quiet fallback."""
    if impl not in ("auto", "scan", "fused"):
        raise ValueError(f"unknown rnn impl {impl!r}")
    if cell not in ("lstm", "gru"):
        raise ValueError(f"unknown cell {cell!r}")
    supports = kernel_supports if cell == "lstm" else gru_kernel_supports
    fits = hidden is None or supports(hidden)
    kind = None if device is None else torch.device(device).type
    if impl == "auto":
        return "fused" if kind == "cuda" and fits else "scan"
    if impl == "fused" and not fits and kind != "cpu":
        raise ValueError(
            f"no fused {cell.upper()} kernel for hidden={hidden}; use impl='scan'"
        )
    return impl


def interlayer_dropout(out, generator: torch.Generator, dropout: float):
    """The between-layer dropout block: keep each element with
    probability ``1 - dropout`` (mask drawn from ``generator``) and scale
    the kept ones by ``1 / (1 - dropout)``."""
    keep = 1.0 - dropout
    mask = torch.rand(out.shape, generator=generator, device=out.device) < keep
    return torch.where(mask, out / keep, torch.zeros_like(out))


def stacked_rnn(layers, x, cell: str = "lstm", *, dropout: float = 0.0,
                generator=None, impl: str = "auto", compute_dtype=None):
    """Apply a stack of RNN layers, with dropout between layers (not after
    the last), as torch's stacked ``nn.LSTM(dropout=...)`` places it.

    ``generator=None`` is eval mode: no dropout even when ``dropout > 0``.
    ``compute_dtype`` (e.g. ``torch.bfloat16``) casts parameters and
    activations for the layer compute; the parameters themselves stay in
    their own dtype.  Returns ``(outputs (B, T, H), per-layer finals)``."""
    hidden = layers[0]["w_hh"].shape[1] if layers else None
    impl = resolve_rnn_impl(impl, cell, hidden, x.device)
    if cell == "gru":
        layer_fn = gru_layer_fused if impl == "fused" else gru_layer
    else:
        layer_fn = lstm_layer_fused if impl == "fused" else lstm_layer

    finals = []
    out = x if compute_dtype is None else x.to(compute_dtype)
    for idx, layer in enumerate(layers):
        if compute_dtype is not None:
            layer = {name: p.to(compute_dtype) for name, p in layer.items()}
        out, final = layer_fn(layer, out)
        finals.append(final)
        if dropout > 0.0 and generator is not None and idx < len(layers) - 1:
            out = interlayer_dropout(out, generator, dropout)
    return out, finals


def stacked_rnn_decode_step(layers, carries, x, cell: str = "lstm"):
    """One autoregressive token step through a stacked RNN.

    ``x`` (B, in) is the current token's embedding; ``carries`` are the
    per-layer final states :func:`stacked_rnn` returns (LSTM ``(h, c)``
    pairs, GRU ``h``).  Returns ``(new_carries, h_top (B, H))``.  Decode
    runs in float32 (sampling is sensitive to logit rounding); carries
    are cast on entry, so the finals of a reduced-precision prefill may be
    handed over unchanged."""
    h_in = x
    new_carries = []
    for layer, state in zip(layers, carries):
        if cell == "lstm":
            xp = lstm_input_proj(layer, h_in)
            (h, c), h_in = lstm_step(layer["w_hh"].T, tuple(s.float() for s in state), xp)
            new_carries.append((h, c))
        elif cell == "gru":
            xp = gru_input_proj(layer, h_in)
            h, h_in = gru_step(layer["w_hh"].T, layer["b_hh"], state.float(), xp)
            new_carries.append(h)
        else:
            raise ValueError(f"unknown cell {cell!r}")
    return new_carries, h_in


def head_logits(head, h):
    """The LM vocab head, float32 whatever the backbone's dtype:
    ``head`` ``{"weight" (V, H), "bias" (V,)}``, ``h`` (..., H) ->
    (..., V)."""
    return h.float() @ head["weight"].T + head["bias"]
