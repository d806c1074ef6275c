"""Fused LSTM and GRU time loops: hand-written Hopper kernels plus plain twins.

The port of ``pytorch_distributed_rnn_tpu/ops/pallas_rnn.py``.  Four CUDA
kernels carry the serial part of every LSTM and GRU layer on the card:

- ``lstm_fwd`` (``csrc/lstm_fwd.cu``) replaces ``pallas_rnn.py:
  _lstm_fwd_kernel``: the forward recurrence, h and c in float32, h_all
  and c_all stored in the input dtype.
- ``lstm_bwd`` (``csrc/lstm_bwd.cu``) replaces ``pallas_rnn.py:
  _lstm_bwd_kernel``: the reverse sweep that recomputes the gates and
  emits the gate cotangents (= ``dx_proj``), ``dh0`` and ``dc0``.
- ``gru_fwd`` (``csrc/gru_fwd.cu``) replaces ``pallas_rnn.py:
  _gru_fwd_kernel``: the GRU forward recurrence, ``b_hh`` inside the
  hidden-side product, h in float32, h_all stored in the input dtype.
- ``gru_bwd`` (``csrc/gru_bwd.cu``) replaces ``pallas_rnn.py:
  _gru_bwd_kernel``: the reverse sweep that emits ``dx_proj``, the
  hidden-side gate cotangents ``dhgates`` and ``dh0``.

Every kernel takes 1 <= H <= 512, in two variants chosen by width.  Up
to H=110 (LSTM) or H=126 (GRU), one block holds all of W_hh^T and owns a
tile of batch rows for the whole sequence (the LSTM forward holds each
thread's share of W_hh^T in registers up to H=32, in shared memory above:
``lstm_fwd_tile``).  Above, W_hh^T is split over a cluster of
``GRU_CLUSTER_CTAS`` blocks (``csrc/cluster_common.cuh``), each holding
the columns of its own units' gates in shared memory: the forwards
exchange h_t through distributed shared memory, the backwards partial
contractions.  Where an LSTM's float32 slice does not fit in shared
memory (above H=448 forward, 464 backward), its last rows sit in
registers.
``lstm_fwd_tile``, ``lstm_bwd_tile``, ``gru_tile`` and ``gru_bwd_tile``
are the dispatch rules.  The input projection, ``dW_hh`` and ``db_hh``
stay plain matrix products and sums (``torch.matmul``), as the JAX
package leaves them to XLA.  Where the LSTM runs its cluster variant, its
forward also saves the activated gates, which the backward reads in place
of recomputing them (``lstm_saves_gates``; ``FusedLSTMScan`` keeps them in
place of ``x_proj``).

Each wrapper takes the kernel's plain PyTorch version (``*_plain``) only
for CPU tensors; on CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts kernel launches, so a run can show its main path went
through the kernels.

Mixed precision follows the JAX *fused* kernels: the recurrent product is
``h_f32 @ w`` in float32 even for bf16 weights, and the backward reads the
stored (bf16) h (and c).
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches since the last reset_launch_counts(), by kernel name
LAUNCHES = {"lstm_fwd": 0, "lstm_bwd": 0, "gru_fwd": 0, "gru_bwd": 0}

BLOCK_B = 16  # batch rows per block: 1440 rows -> 90 blocks on the card's 132 SMs
# the LSTM forward's batch rows a block up to H=32, where W_hh^T sits in
# registers: 1440 rows -> 360 blocks of 128 threads, about 3 an SM
LSTM_FWD_BLOCK_B = 4
LSTM_FWD_REG_HIDDEN = 32  # kRegHidden in csrc/lstm_fwd.cu
_LSTM_FWD_MAX_THREADS = 512  # kFwdMaxThreads in csrc/lstm_fwd.cu
MAX_HIDDEN = 512  # kClusterMaxHidden in csrc/cluster_common.cuh
# the cluster variants: CTAs a cluster (kClusterCtas in
# csrc/cluster_common.cuh, both cells) and batch rows a cluster of each
# kernel (kFwdClusterRows in csrc/{gru,lstm}_fwd.cu, kClusterRows in
# csrc/{gru,lstm}_bwd.cu)
GRU_CLUSTER_CTAS = 16
GRU_FWD_CLUSTER_ROWS = 8
GRU_CLUSTER_ROWS = 4
LSTM_FWD_CLUSTER_ROWS = 8
# the LSTM forward's rows a cluster where its float32 slice's last rows sit
# in registers (kFwdTailClusterRows in csrc/lstm_fwd.cu)
LSTM_FWD_TAIL_CLUSTER_ROWS = 4
LSTM_BWD_CLUSTER_ROWS = 4
_VARIANTS = {"smem": 0, "cluster": 1}  # the variant codes of the C entries
_ROWS_PER_THREAD = 4  # kRowsPerThread in csrc/lstm_common.cuh
_MAX_SMEM_BYTES = 232_448  # dynamic shared memory one Hopper block may use
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (pointer arguments, int arguments) of each kernel's C entry point
_SIGNATURES = {"lstm_fwd": (7, 6), "lstm_bwd": (13, 6), "gru_fwd": (5, 6), "gru_bwd": (10, 6)}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_supports(hidden: int) -> bool:
    """Whether both LSTM kernels take this hidden size: 1 <= H <= 512, in
    float32 and bfloat16.  Up to H=110 W_hh^T is staged in one block's
    shared memory (:func:`lstm_fwd_tile`, :func:`lstm_bwd_tile`).  Above
    it both kernels spread W_hh^T over a 16-CTA cluster, each CTA holding
    an (H, 4 ceil(H/16)) slice: 264 KiB in float32 at H=512, more than a
    CTA's shared memory, so from H=449 (forward) and H=465 (backward) its
    last rows sit in registers; the range ends at 512, as the GRU's."""
    return 1 <= hidden <= MAX_HIDDEN


def _lstm_w_in_smem(hidden: int) -> bool:
    """W_hh^T (row stride 4H + 1) plus the backward's per-tile state
    (``csrc/lstm_bwd.cu:bwd_smem_bytes``) fit one block, whose
    ``hidden * BLOCK_B / 4`` threads fit 1024: up to H=110."""
    smem = 4 * (hidden * (4 * hidden + 1) + 5 * BLOCK_B * hidden)
    return hidden * (BLOCK_B // _ROWS_PER_THREAD) <= 1024 and smem <= _MAX_SMEM_BYTES


def _lstm_fwd_slice_fits(hidden: int, itemsize: int) -> bool:
    """Whether the LSTM forward cluster's W_hh^T slice, in its dtype, fits
    a CTA's shared memory beside the tiles of 8 rows
    (``csrc/lstm_fwd.cu:fwd_smem_rows``): bf16 always, float32 up to
    H=448."""
    units = -(-hidden // GRU_CLUSTER_CTAS)
    octets = -(-4 * units // 8)
    stride = 8 * octets + 4 if itemsize == 4 else 8 * (octets | 1)
    rows = LSTM_FWD_CLUSTER_ROWS
    tiles = 4 * ((GRU_CLUSTER_CTAS + 2) * units * rows + rows * 8 * octets)
    return tiles + hidden * stride * itemsize <= _MAX_SMEM_BYTES


def lstm_fwd_tile(hidden: int, dtype=torch.float32) -> tuple[int, str]:
    """The LSTM forward's ``(batch rows a tile, variant)`` at this width
    and dtype.  ``"smem"`` up to H=110, one block of ``hidden * rows``
    threads (rows a multiple of 4, one row per lane of a 4-lane group):
    ``LSTM_FWD_BLOCK_B`` rows up to H=32, where each thread's share of
    W_hh^T sits in its registers and small blocks share an SM; above it,
    where W_hh^T sits in shared memory, as many rows as 512 threads take,
    at most 16.  ``"cluster"`` above H=110, a cluster of
    ``GRU_CLUSTER_CTAS`` blocks on ``LSTM_FWD_CLUSTER_ROWS`` rows, or on
    ``LSTM_FWD_TAIL_CLUSTER_ROWS`` where the float32 slice does not fit in
    shared memory (above H=448)."""
    if not _lstm_w_in_smem(hidden):
        if _lstm_fwd_slice_fits(hidden, dtype.itemsize):
            return LSTM_FWD_CLUSTER_ROWS, "cluster"
        return LSTM_FWD_TAIL_CLUSTER_ROWS, "cluster"
    if hidden <= LSTM_FWD_REG_HIDDEN:
        return LSTM_FWD_BLOCK_B, "smem"
    return min(BLOCK_B, 4 * (_LSTM_FWD_MAX_THREADS // (4 * hidden))), "smem"


def lstm_bwd_tile(hidden: int) -> tuple[int, str]:
    """The LSTM backward's ``(batch rows a tile, variant)`` at this width:
    ``"smem"`` (one block, W_hh^T in its shared memory) up to H=110, else
    ``"cluster"`` (a cluster of ``GRU_CLUSTER_CTAS`` blocks on
    ``LSTM_BWD_CLUSTER_ROWS`` rows)."""
    if _lstm_w_in_smem(hidden):
        return BLOCK_B, "smem"
    return LSTM_BWD_CLUSTER_ROWS, "cluster"


def lstm_saves_gates(hidden: int) -> bool:
    """Whether the LSTM forward saves its activated gates for the backward
    at this width: where both run the cluster variant (H > 110), whose
    backward reads them in place of recomputing the gates from h."""
    return lstm_bwd_tile(hidden)[1] == "cluster"


def gru_kernel_supports(hidden: int) -> bool:
    """Whether both GRU kernels take this hidden size: 1 <= H <= 512, in
    float32 and bfloat16.  Up to H=126 W_hh^T is staged in one block's
    shared memory.  Above it both kernels spread W_hh^T over a 16-CTA
    cluster, each CTA holding an (H, 3 ceil(H/16)) float32 slice: 200 KiB
    at H=512, which is where the range ends."""
    return 1 <= hidden <= MAX_HIDDEN


def _gru_w_in_smem(hidden: int) -> bool:
    """W_hh^T (row stride 3H + 1) plus the backward's per-tile state
    (``csrc/gru_bwd.cu:bwd_smem_bytes``) fit one block: up to H=126."""
    return 4 * (hidden * (3 * hidden + 1) + 5 * BLOCK_B * hidden) <= _MAX_SMEM_BYTES


def gru_tile(hidden: int) -> tuple[int, str]:
    """The GRU forward's ``(batch rows a tile, variant)`` at this width:
    ``"smem"`` (one block, W_hh^T in its shared memory) up to H=126, else
    ``"cluster"`` (a cluster of ``GRU_CLUSTER_CTAS`` blocks on
    ``GRU_FWD_CLUSTER_ROWS`` rows)."""
    if _gru_w_in_smem(hidden):
        return BLOCK_B, "smem"
    return GRU_FWD_CLUSTER_ROWS, "cluster"


def gru_bwd_tile(hidden: int) -> tuple[int, str]:
    """The GRU backward's ``(batch rows a tile, variant)`` at this width:
    ``"smem"`` (one block, W_hh^T in its shared memory) up to H=126, else
    ``"cluster"`` (a cluster of ``GRU_CLUSTER_CTAS`` blocks on
    ``GRU_CLUSTER_ROWS`` rows)."""
    if _gru_w_in_smem(hidden):
        return BLOCK_B, "smem"
    return GRU_CLUSTER_ROWS, "cluster"


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------


def lstm_fwd_plain(x_proj, h0, c0, w_hh_t):
    """``x_proj`` (T, B, 4H), ``h0``/``c0`` (B, H), ``w_hh_t`` (H, 4H) ->
    ``h_all``, ``c_all`` (T, B, H) and the activated gates i, f, g, o
    (T, B, 4H), all in ``x_proj``'s dtype."""
    dtype = x_proj.dtype
    w = w_hh_t.float()
    h, c = h0.float(), c0.float()
    h_all, c_all, gates = [], [], []
    for t in range(x_proj.shape[0]):
        i, f, g, o = (x_proj[t].float() + h @ w).chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        h_all.append(h.to(dtype))
        c_all.append(c.to(dtype))
        gates.append(torch.cat([i, f, g, o], dim=-1).to(dtype))
    return torch.stack(h_all), torch.stack(c_all), torch.stack(gates)


def lstm_bwd_plain(x_proj, h_all, c_all, h0, c0, w_hh_t, dh_all, dh_T, dc_T, gates=None):
    """Reverse sweep: returns ``dx_proj`` (T, B, 4H) and ``dh0``, ``dc0``
    (B, H), all in ``dh_all``'s dtype.  Each step's activated gates are
    recomputed from ``x_proj`` and the stored h_{t-1}, or read from
    ``gates`` (the forward's, (T, B, 4H)) where it is given, and then
    ``x_proj`` and ``h_all`` are not read."""
    dtype = dh_all.dtype
    w = w_hh_t.float()
    dh, dc = dh_T.float(), dc_T.float()
    dx = [None] * dh_all.shape[0]
    for t in reversed(range(dh_all.shape[0])):
        c_prev = (c_all[t - 1] if t > 0 else c0).float()
        if gates is None:
            h_prev = (h_all[t - 1] if t > 0 else h0).float()
            i, f, g, o = (x_proj[t].float() + h_prev @ w).chunk(4, dim=-1)
            i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        else:
            i, f, g, o = gates[t].float().chunk(4, dim=-1)
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


def _gru_gates(x_proj_t, h_prev, w, b):
    """r, z, n and the hidden-side n pre-activation h_n of one GRU step,
    in float32; ``b_hh`` joins the hidden-side product."""
    xr, xz, xn = x_proj_t.float().chunk(3, dim=-1)
    hr, hz, hn = (h_prev @ w + b).chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    return r, z, torch.tanh(xn + r * hn), hn


def gru_fwd_plain(x_proj, h0, w_hh_t, b_hh):
    """``x_proj`` (T, B, 3H) with ``b_ih`` folded in, ``h0`` (B, H),
    ``w_hh_t`` (H, 3H), ``b_hh`` (3H,) -> ``h_all`` (T, B, H) in
    ``x_proj``'s dtype."""
    dtype = x_proj.dtype
    w, b = w_hh_t.float(), b_hh.float()
    h = h0.float()
    h_all = []
    for t in range(x_proj.shape[0]):
        _, z, n, _ = _gru_gates(x_proj[t], h, w, b)
        h = (1.0 - z) * n + z * h
        h_all.append(h.to(dtype))
    return torch.stack(h_all)


def gru_bwd_plain(x_proj, h_all, h0, w_hh_t, b_hh, dh_all, dh_T):
    """Reverse sweep, recomputing each step's gates from the stored
    h_{t-1}: returns ``dx_proj`` and ``dhgates`` = [dr, dz, dn * r]
    (T, B, 3H) and ``dh0`` (B, H), all in ``x_proj``'s dtype."""
    dtype = x_proj.dtype
    w, b = w_hh_t.float(), b_hh.float()
    dh = dh_T.float()
    dx, dhg = [None] * x_proj.shape[0], [None] * x_proj.shape[0]
    for t in reversed(range(x_proj.shape[0])):
        h_prev = (h_all[t - 1] if t > 0 else h0).float()
        r, z, n, hn = _gru_gates(x_proj[t], h_prev, w, b)
        dh = dh + dh_all[t].float()
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dz = dh * (h_prev - n) * z * (1.0 - z)
        dr = dn * hn * r * (1.0 - r)
        d_hgates = torch.cat([dr, dz, dn * r], dim=-1)
        dx[t] = torch.cat([dr, dz, dn], dim=-1).to(dtype)
        dhg[t] = d_hgates.to(dtype)
        dh = dh * z + d_hgates @ w.T
    return torch.stack(dx), torch.stack(dhg), dh.to(dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _library(name: str):
    from pytorch_distributed_rnn_tpu_torch import _build

    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        n_ptr, n_int = _SIGNATURES[name]
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _check(name, tensors, shapes):
    """Device, dtype, shape and contiguity checks before a launch; the
    last shape is the gate tensor's (T, B, G*H)."""
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
    lstm = name.startswith("lstm")
    supports = kernel_supports if lstm else gru_kernel_supports
    seq_len, batch, hidden = shapes[-1][0], shapes[-1][1], shapes[-1][2] // (4 if lstm else 3)
    if seq_len < 1 or batch < 1 or not supports(hidden):
        raise ValueError(
            f"{name}: no kernel for T={seq_len} B={batch} H={hidden} (see {supports.__name__})"
        )


def _launch(name, fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def lstm_fwd(x_proj, h0, c0, w_hh_t):
    """Forward time loop: ``h_all``, ``c_all`` (T, B, H) and, where
    :func:`lstm_saves_gates`, the activated gates (T, B, 4H) for the
    backward, else None.  CPU tensors take :func:`lstm_fwd_plain`; CUDA
    tensors launch ``csrc/lstm_fwd.cu`` in the variant
    :func:`lstm_fwd_tile` names, or raise."""
    hidden = x_proj.shape[-1] // 4
    if x_proj.device.type == "cpu":
        h_all, c_all, gates = lstm_fwd_plain(x_proj, h0, c0, w_hh_t)
        return h_all, c_all, gates if lstm_saves_gates(hidden) else None
    if x_proj.device.type != "cuda":
        raise ValueError(f"lstm_fwd: runs on CPU or CUDA tensors, got {x_proj.device}")
    seq_len, batch, gate_dim = x_proj.shape
    _check(
        "lstm_fwd", [h0, c0, w_hh_t, x_proj],
        [(batch, hidden), (batch, hidden), (hidden, gate_dim),
         (seq_len, batch, 4 * hidden)],
    )
    block_b, variant = lstm_fwd_tile(hidden, x_proj.dtype)
    h_all = torch.empty((seq_len, batch, hidden), dtype=x_proj.dtype, device=x_proj.device)
    c_all = torch.empty_like(h_all)
    gates = torch.empty_like(x_proj) if lstm_saves_gates(hidden) else None
    with torch.cuda.device(x_proj.device):
        _launch(
            "lstm_fwd", _library("lstm_fwd"),
            x_proj.data_ptr(), h0.data_ptr(), c0.data_ptr(), w_hh_t.data_ptr(),
            h_all.data_ptr(), c_all.data_ptr(), None if gates is None else gates.data_ptr(),
            seq_len, batch, hidden, block_b, _VARIANTS[variant], _DTYPE_CODES[x_proj.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    return h_all, c_all, gates


def lstm_bwd(x_proj, h_all, c_all, h0, c0, w_hh_t, dh_all, dh_T, dc_T, gates=None):
    """Reverse sweep: ``dx_proj`` (T, B, 4H), ``dh0``, ``dc0`` (B, H).
    Where :func:`lstm_saves_gates`, it reads the forward's activated
    ``gates`` (then ``x_proj`` may be None), elsewhere it recomputes them
    from ``x_proj`` (then ``gates`` is None).  CPU tensors take
    :func:`lstm_bwd_plain`; CUDA tensors launch ``csrc/lstm_bwd.cu`` in the
    variant :func:`lstm_bwd_tile` names, or raise."""
    gate_src = x_proj if gates is None else gates
    seq_len, batch, gate_dim = gate_src.shape
    hidden = gate_dim // 4
    if (gates is not None) != lstm_saves_gates(hidden):
        need = "needs" if lstm_saves_gates(hidden) else "takes no"
        raise ValueError(f"lstm_bwd: H={hidden} {need} saved gates (lstm_saves_gates)")
    if gate_src.device.type == "cpu":
        return lstm_bwd_plain(x_proj, h_all, c_all, h0, c0, w_hh_t, dh_all, dh_T, dc_T, gates)
    if gate_src.device.type != "cuda":
        raise ValueError(f"lstm_bwd: runs on CPU or CUDA tensors, got {gate_src.device}")
    seq = (seq_len, batch, hidden)
    state = (batch, hidden)
    _check(
        "lstm_bwd",
        [h_all, c_all, h0, c0, w_hh_t, dh_all, dh_T, dc_T, gate_src],
        [seq, seq, state, state, (hidden, gate_dim), seq, state, state,
         (seq_len, batch, gate_dim)],
    )
    block_b, variant = lstm_bwd_tile(hidden)
    dx_proj = torch.empty_like(gate_src)
    dh0 = torch.empty_like(h0)
    dc0 = torch.empty_like(c0)
    with torch.cuda.device(gate_src.device):
        _launch(
            "lstm_bwd", _library("lstm_bwd"),
            None if x_proj is None else x_proj.data_ptr(), h_all.data_ptr(), c_all.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), w_hh_t.data_ptr(),
            dh_all.data_ptr(), dh_T.data_ptr(), dc_T.data_ptr(),
            None if gates is None else gates.data_ptr(),
            dx_proj.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            seq_len, batch, hidden, block_b, _VARIANTS[variant], _DTYPE_CODES[gate_src.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    return dx_proj, dh0, dc0


def gru_fwd(x_proj, h0, w_hh_t, b_hh):
    """GRU forward time loop: ``h_all`` (T, B, H).  CPU tensors take
    :func:`gru_fwd_plain`; CUDA tensors launch ``csrc/gru_fwd.cu`` in the
    variant :func:`gru_tile` names, or raise."""
    if x_proj.device.type == "cpu":
        return gru_fwd_plain(x_proj, h0, w_hh_t, b_hh)
    if x_proj.device.type != "cuda":
        raise ValueError(f"gru_fwd: runs on CPU or CUDA tensors, got {x_proj.device}")
    seq_len, batch, gate_dim = x_proj.shape
    hidden = gate_dim // 3
    _check(
        "gru_fwd", [h0, w_hh_t, b_hh, x_proj],
        [(batch, hidden), (hidden, gate_dim), (gate_dim,), (seq_len, batch, 3 * hidden)],
    )
    block_b, variant = gru_tile(hidden)
    h_all = torch.empty((seq_len, batch, hidden), dtype=x_proj.dtype, device=x_proj.device)
    with torch.cuda.device(x_proj.device):
        _launch(
            "gru_fwd", _library("gru_fwd"),
            x_proj.data_ptr(), h0.data_ptr(), w_hh_t.data_ptr(), b_hh.data_ptr(),
            h_all.data_ptr(),
            seq_len, batch, hidden, block_b, _VARIANTS[variant], _DTYPE_CODES[x_proj.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    return h_all


def gru_bwd(x_proj, h_all, h0, w_hh_t, b_hh, dh_all, dh_T):
    """Reverse sweep: ``dx_proj``, ``dhgates`` (T, B, 3H) and ``dh0``
    (B, H).  CPU tensors take :func:`gru_bwd_plain`; CUDA tensors launch
    ``csrc/gru_bwd.cu`` in the variant :func:`gru_bwd_tile` names, or
    raise."""
    if x_proj.device.type == "cpu":
        return gru_bwd_plain(x_proj, h_all, h0, w_hh_t, b_hh, dh_all, dh_T)
    if x_proj.device.type != "cuda":
        raise ValueError(f"gru_bwd: runs on CPU or CUDA tensors, got {x_proj.device}")
    seq_len, batch, gate_dim = x_proj.shape
    hidden = gate_dim // 3
    seq = (seq_len, batch, hidden)
    state = (batch, hidden)
    _check(
        "gru_bwd", [h_all, h0, w_hh_t, b_hh, dh_all, dh_T, x_proj],
        [seq, state, (hidden, gate_dim), (gate_dim,), seq, state, (seq_len, batch, gate_dim)],
    )
    block_b, variant = gru_bwd_tile(hidden)
    dx_proj = torch.empty_like(x_proj)
    dhgates = torch.empty_like(x_proj)
    dh0 = torch.empty_like(h0)
    with torch.cuda.device(x_proj.device):
        _launch(
            "gru_bwd", _library("gru_bwd"),
            x_proj.data_ptr(), h_all.data_ptr(), h0.data_ptr(), w_hh_t.data_ptr(),
            b_hh.data_ptr(), dh_all.data_ptr(), dh_T.data_ptr(),
            dx_proj.data_ptr(), dhgates.data_ptr(), dh0.data_ptr(),
            seq_len, batch, hidden, block_b, _VARIANTS[variant],
            _DTYPE_CODES[x_proj.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    return dx_proj, dhgates, dh0


def cluster_shape(kernel: str, hidden: int, batch: int, dtype=torch.float32) -> dict:
    """How the cluster variant of ``kernel`` (``"lstm_fwd"``, ``"lstm_bwd"``,
    ``"gru_fwd"`` or ``"gru_bwd"``) runs at this width, batch and dtype on
    the current card: CTAs and batch rows a cluster, the clusters resident
    at once (``cudaOccupancyMaxActiveClusters``), the dynamic shared memory
    a CTA and the waves of clusters; for the LSTM kernels also the rows of
    each CTA's W_hh^T slice held in shared memory (the others out of it).
    Raises where not even one cluster fits."""
    from pytorch_distributed_rnn_tpu_torch import _build

    fn = getattr(_build.load(kernel), f"{kernel}_cluster_shape")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(hidden, batch, _DTYPE_CODES[dtype], out)
    if err != 0:
        raise RuntimeError(f"{kernel} cluster variant at H={hidden}: CUDA error {err}")
    ctas, rows, active, smem, slice_rows = out
    clusters = -(-batch // rows)
    shape = {"ctas": ctas, "rows": rows, "active_clusters": active, "smem_bytes": smem,
             "clusters": clusters, "waves": -(-clusters // active)}
    if kernel.startswith("lstm"):
        shape["smem_slice_rows"] = slice_rows
    return shape


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
        h_all, c_all, gates = lstm_fwd(x_proj, h0, c0, w_hh_t)
        # where the forward saved the activated gates, the backward reads
        # them in place of x_proj, which is then not kept
        ctx.saved_gates = gates is not None
        ctx.save_for_backward(x_proj if gates is None else gates, h_all, c_all, h0, c0, w_hh_t)
        return h_all, h_all[-1].clone(), c_all[-1].clone()

    @staticmethod
    def backward(ctx, dh_all, dh_T, dc_T):
        first, h_all, c_all, h0, c0, w_hh_t = ctx.saved_tensors
        x_proj, gates = (None, first) if ctx.saved_gates else (first, None)
        dtype = first.dtype
        dx_proj, dh0, dc0 = lstm_bwd(
            x_proj, h_all, c_all, h0, c0, w_hh_t,
            dh_all.to(dtype).contiguous(), dh_T.to(dtype).contiguous(),
            dc_T.to(dtype).contiguous(), gates,
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


class FusedGRUScan(torch.autograd.Function):
    """Differentiable fused GRU time loop, the semantics of the JAX
    package's ``fused_gru_scan`` custom VJP.

    ``forward(x_proj (T, B, 3H), w_hh_t (H, 3H), b_hh (3H,), h0 (B, H))``
    returns ``(h_all (T, B, H), h_T)``."""

    @staticmethod
    def forward(ctx, x_proj, w_hh_t, b_hh, h0):
        h_all = gru_fwd(x_proj, h0, w_hh_t, b_hh)
        ctx.save_for_backward(x_proj, h_all, h0, w_hh_t, b_hh)
        return h_all, h_all[-1].clone()

    @staticmethod
    def backward(ctx, dh_all, dh_T):
        x_proj, h_all, h0, w_hh_t, b_hh = ctx.saved_tensors
        dtype = x_proj.dtype
        dx_proj, dhgates, dh0 = gru_bwd(
            x_proj, h_all, h0, w_hh_t, b_hh,
            dh_all.to(dtype).contiguous(), dh_T.to(dtype).contiguous(),
        )
        # dW_hh^T = sum_t h_{t-1}^T dhgates[t] and db_hh = sum dhgates:
        # one product and one reduction over all (t, b)
        h_prev = torch.cat([h0[None], h_all[:-1]])
        dhg = dhgates.reshape(-1, dhgates.shape[-1]).float()
        dw_hh_t = (h_prev.reshape(-1, h_prev.shape[-1]).float().T @ dhg).to(dtype)
        db_hh = dhg.sum(dim=0).to(dtype)
        return dx_proj, dw_hh_t, db_hh, dh0


def gru_layer_fused(params, x, h0=None):
    """Drop-in for ``ops.rnn.gru_layer`` running the time loop through the
    fused kernels: ``x`` (B, T, in) -> ``(outputs (B, T, H), h_T)``.  As
    :func:`lstm_layer_fused`: time-major projection, no padding."""
    from pytorch_distributed_rnn_tpu_torch.ops.rnn import gru_input_proj

    batch = x.shape[0]
    hidden = params["w_hh"].shape[1]
    dtype = x.dtype
    x_proj = gru_input_proj(params, x.transpose(0, 1))  # (T, B, 3H), b_ih only
    if h0 is None:
        h0 = x.new_zeros((batch, hidden), dtype=dtype)
    h_all, h_t = FusedGRUScan.apply(
        x_proj, params["w_hh"].T.contiguous(), params["b_hh"].contiguous(),
        h0.to(dtype).contiguous(),
    )
    return h_all.transpose(0, 1), h_t
