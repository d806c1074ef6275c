"""Fused LSTM time loop: hand-written Hopper kernels plus plain twins.

The port of the LSTM half of ``pytorch_distributed_rnn_tpu/ops/
pallas_rnn.py``.  Two CUDA kernels carry the serial part of every LSTM
layer on the card:

- ``lstm_fwd`` (``csrc/lstm_fwd.cu``) replaces ``pallas_rnn.py:
  _lstm_fwd_kernel``: the forward recurrence, h and c in float32, h_all
  and c_all stored in the input dtype.
- ``lstm_bwd`` (``csrc/lstm_bwd.cu``) replaces ``pallas_rnn.py:
  _lstm_bwd_kernel``: the reverse sweep that recomputes the gates and
  emits the gate cotangents (= ``dx_proj``), ``dh0`` and ``dc0``.

Both are bound by bytes at the motion model's shape (the notes in the
sources give the arithmetic); both keep W_hh^T resident in shared memory
and loop over T inside one block per batch tile.  The input projection
and ``dW_hh`` stay plain matrix products (``torch.matmul``), as the JAX
package leaves them to XLA.

Each wrapper takes the kernel's plain PyTorch version (``lstm_fwd_plain``
/ ``lstm_bwd_plain``) only for CPU tensors; on CUDA tensors it launches
the kernel or raises.  ``LAUNCHES`` counts kernel launches, so a run can
show its main path went through the kernels.

Mixed precision follows the JAX *fused* kernel: the recurrent product is
``h_f32 @ w`` in float32 even for bf16 weights, and the backward reads the
stored (bf16) h and c.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches since the last reset_launch_counts(), by kernel name
LAUNCHES = {"lstm_fwd": 0, "lstm_bwd": 0}

BLOCK_B = 16  # batch rows per block: 1440 rows -> 90 blocks on the card's 132 SMs
_ROWS_PER_THREAD = 4  # kRowsPerThread in csrc/lstm_common.cuh
_MAX_THREADS = 1024
_MAX_SMEM_BYTES = 232_448  # dynamic shared memory one Hopper block may use
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_supports(hidden: int) -> bool:
    """Whether both kernels take this hidden size: a block of
    ``hidden * BLOCK_B / 4`` threads fits 1024, and W_hh^T (row stride
    4H + 1) plus the backward's per-tile state, the larger of the two
    kernels' (csrc/lstm_bwd.cu:bwd_smem_bytes), fit one block's shared
    memory: up to H=110."""
    smem = 4 * (hidden * (4 * hidden + 1) + 5 * BLOCK_B * hidden)
    return (
        hidden >= 1
        and hidden * (BLOCK_B // _ROWS_PER_THREAD) <= _MAX_THREADS
        and smem <= _MAX_SMEM_BYTES
    )


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------


def lstm_fwd_plain(x_proj, h0, c0, w_hh_t):
    """``x_proj`` (T, B, 4H), ``h0``/``c0`` (B, H), ``w_hh_t`` (H, 4H) ->
    ``h_all``, ``c_all`` (T, B, H) in ``x_proj``'s dtype."""
    dtype = x_proj.dtype
    w = w_hh_t.float()
    h, c = h0.float(), c0.float()
    h_all, c_all = [], []
    for t in range(x_proj.shape[0]):
        gates = x_proj[t].float() + h @ w
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        h_all.append(h.to(dtype))
        c_all.append(c.to(dtype))
    return torch.stack(h_all), torch.stack(c_all)


def lstm_bwd_plain(x_proj, h_all, c_all, h0, c0, w_hh_t, dh_all, dh_T, dc_T):
    """Reverse sweep: returns ``dx_proj`` (T, B, 4H) and ``dh0``, ``dc0``
    (B, H), all in ``x_proj``'s dtype."""
    dtype = x_proj.dtype
    w = w_hh_t.float()
    dh, dc = dh_T.float(), dc_T.float()
    dx = [None] * x_proj.shape[0]
    for t in reversed(range(x_proj.shape[0])):
        h_prev = (h_all[t - 1] if t > 0 else h0).float()
        c_prev = (c_all[t - 1] if t > 0 else c0).float()
        gates = x_proj[t].float() + h_prev @ w
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        dh = dh + dh_all[t].float()
        tanh_c = torch.tanh(c_all[t].float())
        dc = dc + dh * o * (1.0 - tanh_c * tanh_c)
        d_gates = torch.cat(
            [
                dc * g * i * (1.0 - i),
                dc * c_prev * f * (1.0 - f),
                dc * i * (1.0 - g * g),
                dh * tanh_c * o * (1.0 - o),
            ],
            dim=-1,
        )
        dx[t] = d_gates.to(dtype)
        dh = d_gates @ w.T
        dc = dc * f
    return torch.stack(dx), dh.to(dtype), dc.to(dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _library(name: str):
    from pytorch_distributed_rnn_tpu_torch import _build

    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        n_ptr = {"lstm_fwd": 6, "lstm_bwd": 12}[name]
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _check(name, tensors, shapes):
    """Device, dtype, shape and contiguity checks before a launch."""
    first = tensors[0]
    if first.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {first.dtype} not supported (float32, bfloat16)")
    for t, shape in zip(tensors, shapes):
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on {t.device} and {first.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {first.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    seq_len, batch, hidden = shapes[-1][0], shapes[-1][1], shapes[-1][2] // 4
    if seq_len < 1 or batch < 1 or not kernel_supports(hidden):
        raise ValueError(
            f"{name}: no kernel for T={seq_len} B={batch} H={hidden} (see kernel_supports)"
        )


def _launch(name, fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def lstm_fwd(x_proj, h0, c0, w_hh_t):
    """Forward time loop: ``h_all``, ``c_all`` (T, B, H).  CPU tensors take
    :func:`lstm_fwd_plain`; CUDA tensors launch ``csrc/lstm_fwd.cu``."""
    if x_proj.device.type == "cpu":
        return lstm_fwd_plain(x_proj, h0, c0, w_hh_t)
    if x_proj.device.type != "cuda":
        raise ValueError(f"lstm_fwd: runs on CPU or CUDA tensors, got {x_proj.device}")
    seq_len, batch, gate_dim = x_proj.shape
    hidden = gate_dim // 4
    _check(
        "lstm_fwd", [h0, c0, w_hh_t, x_proj],
        [(batch, hidden), (batch, hidden), (hidden, gate_dim),
         (seq_len, batch, 4 * hidden)],
    )
    h_all = torch.empty((seq_len, batch, hidden), dtype=x_proj.dtype, device=x_proj.device)
    c_all = torch.empty_like(h_all)
    with torch.cuda.device(x_proj.device):
        _launch(
            "lstm_fwd", _library("lstm_fwd"),
            x_proj.data_ptr(), h0.data_ptr(), c0.data_ptr(), w_hh_t.data_ptr(),
            h_all.data_ptr(), c_all.data_ptr(),
            seq_len, batch, hidden, BLOCK_B, _DTYPE_CODES[x_proj.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    return h_all, c_all


def lstm_bwd(x_proj, h_all, c_all, h0, c0, w_hh_t, dh_all, dh_T, dc_T):
    """Reverse sweep: ``dx_proj`` (T, B, 4H), ``dh0``, ``dc0`` (B, H).  CPU
    tensors take :func:`lstm_bwd_plain`; CUDA tensors launch
    ``csrc/lstm_bwd.cu``."""
    if x_proj.device.type == "cpu":
        return lstm_bwd_plain(x_proj, h_all, c_all, h0, c0, w_hh_t, dh_all, dh_T, dc_T)
    if x_proj.device.type != "cuda":
        raise ValueError(f"lstm_bwd: runs on CPU or CUDA tensors, got {x_proj.device}")
    seq_len, batch, gate_dim = x_proj.shape
    hidden = gate_dim // 4
    seq = (seq_len, batch, hidden)
    state = (batch, hidden)
    _check(
        "lstm_bwd",
        [h_all, c_all, h0, c0, w_hh_t, dh_all, dh_T, dc_T, x_proj],
        [seq, seq, state, state, (hidden, gate_dim), seq, state, state,
         (seq_len, batch, gate_dim)],
    )
    dx_proj = torch.empty_like(x_proj)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    with torch.cuda.device(x_proj.device):
        _launch(
            "lstm_bwd", _library("lstm_bwd"),
            x_proj.data_ptr(), h_all.data_ptr(), c_all.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), w_hh_t.data_ptr(),
            dh_all.data_ptr(), dh_T.data_ptr(), dc_T.data_ptr(),
            dx_proj.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            seq_len, batch, hidden, BLOCK_B, _DTYPE_CODES[x_proj.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    return dx_proj, dh0, dc0


# ---------------------------------------------------------------------------
# Autograd binding and the layer API
# ---------------------------------------------------------------------------


class FusedLSTMScan(torch.autograd.Function):
    """Differentiable fused LSTM time loop, the semantics of the JAX
    package's ``fused_lstm_scan`` custom VJP.

    ``forward(x_proj (T, B, 4H), w_hh_t (H, 4H), h0, c0 (B, H))``
    returns ``(h_all (T, B, H), h_T, c_T)``."""

    @staticmethod
    def forward(ctx, x_proj, w_hh_t, h0, c0):
        h_all, c_all = lstm_fwd(x_proj, h0, c0, w_hh_t)
        ctx.save_for_backward(x_proj, h_all, c_all, h0, c0, w_hh_t)
        return h_all, h_all[-1].clone(), c_all[-1].clone()

    @staticmethod
    def backward(ctx, dh_all, dh_T, dc_T):
        x_proj, h_all, c_all, h0, c0, w_hh_t = ctx.saved_tensors
        dtype = x_proj.dtype
        dx_proj, dh0, dc0 = lstm_bwd(
            x_proj, h_all, c_all, h0, c0, w_hh_t,
            dh_all.to(dtype).contiguous(), dh_T.to(dtype).contiguous(),
            dc_T.to(dtype).contiguous(),
        )
        # dW_hh^T = sum_t h_{t-1}^T d_gates[t]: one product over all (t, b)
        h_prev = torch.cat([h0[None], h_all[:-1]])
        dw_hh_t = (
            h_prev.reshape(-1, h_prev.shape[-1]).float().T
            @ dx_proj.reshape(-1, dx_proj.shape[-1]).float()
        ).to(dtype)
        return dx_proj, dw_hh_t, dh0, dc0


def lstm_layer_fused(params, x, h0=None, c0=None):
    """Drop-in for ``ops.rnn.lstm_layer`` running the time loop through the
    fused kernels: ``x`` (B, T, in) -> ``(outputs (B, T, H), (h_T, c_T))``.
    The ragged last batch tile is masked inside the kernels, so no padding
    is added."""
    from pytorch_distributed_rnn_tpu_torch.ops.rnn import lstm_input_proj

    batch = x.shape[0]
    hidden = params["w_hh"].shape[1]
    dtype = x.dtype
    # time-major straight out of the projection: no (T, B, 4H) copy, and
    # the bias gradients reduce over contiguous rows; a stacked layer's
    # input x is the previous h_all transposed, so x.transpose is free
    x_proj = lstm_input_proj(params, x.transpose(0, 1))  # (T, B, 4H)
    if h0 is None:
        h0 = x.new_zeros((batch, hidden), dtype=dtype)
    if c0 is None:
        c0 = x.new_zeros((batch, hidden), dtype=dtype)
    h_all, h_t, c_t = FusedLSTMScan.apply(
        x_proj, params["w_hh"].T.contiguous(), h0.to(dtype).contiguous(),
        c0.to(dtype).contiguous(),
    )
    return h_all.transpose(0, 1), (h_t, c_t)
