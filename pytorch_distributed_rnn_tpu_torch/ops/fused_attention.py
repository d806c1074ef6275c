"""Flash attention: hand-written Hopper kernels plus plain twins.

The port of ``pytorch_distributed_rnn_tpu/ops/pallas_attention.py``.  Three
CUDA kernels carry the attention of every encoder block on the card:

- ``flash_fwd`` (``csrc/flash_fwd.cu``) replaces ``pallas_attention.py:
  _fwd_kernel``: ``o = softmax(q k^T * scale) v`` by the online softmax,
  and the row logsumexp ``lse`` the backward recomputes from.
- ``flash_dq`` (``csrc/flash_bwd.cu``) replaces ``_dq_kernel``: dQ, one
  block per query tile looping over the key tiles.
- ``flash_dkv`` (``csrc/flash_bwd.cu``) replaces ``_dkv_kernel``: dK and
  dV, one block per key tile looping over the query tiles.

The kernels take contiguous ``(B*H, T, D)`` tensors, float32 or bfloat16,
any T and a head dim D of 1 to 128; ``lse`` and ``delta`` are ``(B*H, Tq)``
float32.  ``scale = D ** -0.5`` multiplies the float32 product, and each
operand the TPU kernel casts to the input dtype before a product (p before
p.V, ds before ds.K, p for dV, ds for dK) is rounded to it.  Every product
sums in float32.  The dtype picks the kernels: bfloat16 runs all three on
the tensor cores (``mma.sync``, with p and ds kept in registers between
products), float32 on the CUDA cores (TF32 would miss the float32
tolerance).  Causal masking works on the runtime global positions
``q_offset``/``k_offset`` of the first query and key, and a query that sees
no key gives ``o = 0`` and ``lse = -inf``.  ``delta = rowsum(dO * O)`` is
plain torch, as ``_delta_of`` is XLA outside the TPU kernels.

Each wrapper takes the kernel's plain PyTorch version (``*_plain``) only
for CPU tensors; on CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts kernel launches, so a run can show its main path went
through the kernels.  The ring composition (``ring_flash_attention``,
``_merge_partials``) waits for the sequence-parallel strategies.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches since the last reset_launch_counts(), by kernel name
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
# the source (library) each kernel's C entry point lives in
LIBRARIES = {"flash_fwd": "flash_fwd", "flash_dq": "flash_bwd", "flash_dkv": "flash_bwd"}
MAX_HEAD_DIM = 128  # kMaxHeadDim in csrc/flash_common.cuh
BLOCK_ROWS = 64  # rows of a query or key tile (kBlockM, kBlockN): one block's share
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# pointer arguments of each kernel's C entry point; then the ints bh, t_q,
# t_k, d, the float scale, the ints causal, q_off, k_off, dtype, the stream
_POINTERS = {"flash_fwd": 5, "flash_dq": 7, "flash_dkv": 8}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def resolve_attention_impl(impl: str, device=None, head_dim: int | None = None) -> str:
    """``auto`` -> ``flash`` on a CUDA device at a head dim the kernels
    take (up to ``MAX_HEAD_DIM``; None: not known, taken as fitting),
    ``dense`` elsewhere (the plain flash versions on the CPU are right but
    slower than the dense path); ``dense`` and ``flash`` stand as given,
    so an explicit ``flash`` above ``MAX_HEAD_DIM`` on the card raises in
    the kernels' check."""
    if impl not in ("auto", "dense", "flash"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "auto":
        on_cuda = device is not None and torch.device(device).type == "cuda"
        fits = head_dim is None or head_dim <= MAX_HEAD_DIM
        return "flash" if on_cuda and fits else "dense"
    return impl


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------


def _visible(t_q, t_k, causal, q_offset, k_offset, device):
    """(Tq, Tk) bool: which scores take part (``_block_mask``), or None
    when all do."""
    if not causal:
        return None
    q_pos = torch.arange(t_q, device=device)[:, None] + q_offset
    k_pos = torch.arange(t_k, device=device)[None, :] + k_offset
    return q_pos >= k_pos


def _scores(q, k):
    """``(q k^T) * D ** -0.5`` in float32, the scale after the product."""
    return (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5


def flash_fwd_plain(q, k, v, causal=False, q_offset=0, k_offset=0):
    """``q`` (BH, Tq, D), ``k``/``v`` (BH, Tk, D) -> ``o`` (BH, Tq, D) in
    q's dtype and ``lse`` (BH, Tq) float32; p is cast to v's dtype before
    p.V, and a row with no visible key gives o = 0, lse = -inf."""
    s = _scores(q, k)
    mask = _visible(q.shape[1], k.shape[1], causal, q_offset, k_offset, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))  # fully masked rows: exp(nan)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    acc = p.to(v.dtype).float() @ v.float()
    o = (acc / l_safe).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l_safe), torch.full_like(l, float("-inf")))
    return o, lse[..., 0]


def _recompute(q, k, v, do, lse, delta, causal, q_offset, k_offset):
    """``p = exp(s - lse)`` scrubbed of masked and non-finite entries
    (``_recompute_p``) and ``ds = p (dO v^T - delta) * scale``, float32."""
    p = torch.exp(_scores(q, k) - lse[..., None])
    mask = _visible(q.shape[1], k.shape[1], causal, q_offset, k_offset, q.device)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    p = torch.where(torch.isfinite(p), p, torch.zeros_like(p))
    dp = do.float() @ v.float().transpose(-1, -2)
    return p, p * (dp - delta[..., None]) * q.shape[-1] ** -0.5


def flash_dq_plain(q, k, v, do, lse, delta, causal=False, q_offset=0, k_offset=0):
    """dQ (BH, Tq, D) in q's dtype: ``ds`` cast to k's dtype before ds.K."""
    _, ds = _recompute(q, k, v, do, lse, delta, causal, q_offset, k_offset)
    return (ds.to(k.dtype).float() @ k.float()).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal=False, q_offset=0, k_offset=0):
    """dK, dV (BH, Tk, D) in k's and v's dtypes: ``p`` cast to dO's dtype
    before p^T.dO, ``ds`` to q's dtype before ds^T.Q."""
    p, ds = _recompute(q, k, v, do, lse, delta, causal, q_offset, k_offset)
    dv = p.to(do.dtype).float().transpose(-1, -2) @ do.float()
    dk = ds.to(q.dtype).float().transpose(-1, -2) @ q.float()
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _library(name: str):
    from pytorch_distributed_rnn_tpu_torch import _build

    fn = getattr(_build.load(LIBRARIES[name]), name)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * _POINTERS[name] + [ctypes.c_int] * 4 + [ctypes.c_float]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _check(name, q, k, v, rows=()):
    """Device, dtype, shape and contiguity checks before a launch: ``q``
    (BH, Tq, D), ``k``/``v`` (BH, Tk, D) in q's dtype, and the ``(tensor,
    shape, dtype)`` triples of ``rows`` (the backward's dO, lse, delta:
    :func:`_bwd_rows`); returns (BH, Tq, Tk, D)."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    if q.ndim != 3 or k.ndim != 3:
        raise ValueError(f"{name}: wants (B*H, T, D) tensors, got {tuple(q.shape)}")
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    want = [(k, (bh, t_k, d), q.dtype), (v, (bh, t_k, d), q.dtype)]
    want += [(t, shape, dtype) for t, shape, dtype in rows]
    for t, shape, dtype in [(q, (bh, t_q, d), q.dtype), *want]:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if bh < 1 or t_q < 1 or t_k < 1 or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"{name}: no kernel for BH={bh} Tq={t_q} Tk={t_k} D={d} (D up to {MAX_HEAD_DIM})"
        )
    return bh, t_q, t_k, d


def _require_cuda(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: runs on CPU or CUDA tensors, got {q.device}")


def _launch(name, pointers, sizes, causal, q_offset, k_offset, dtype):
    bh, t_q, t_k, d = sizes
    err = _library(name)(
        *pointers, bh, t_q, t_k, d, d ** -0.5, int(causal), int(q_offset), int(k_offset),
        _DTYPE_CODES[dtype], torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _bwd_rows(q, do, lse, delta):
    """The backward's extra inputs for :func:`_check`."""
    bh, t_q, d = q.shape
    return [(do, (bh, t_q, d), q.dtype), (lse, (bh, t_q), torch.float32),
            (delta, (bh, t_q), torch.float32)]


def flash_fwd(q, k, v, causal=False, q_offset=0, k_offset=0):
    """``(o, lse)``.  CPU tensors take :func:`flash_fwd_plain`; CUDA tensors
    launch ``csrc/flash_fwd.cu``."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, q_offset, k_offset)
    _require_cuda("flash_fwd", q)
    sizes = _check("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(sizes[:2], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("flash_fwd", (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                              lse.data_ptr()), sizes, causal, q_offset, k_offset, q.dtype)
    return o, lse


def flash_dq(q, k, v, do, lse, delta, causal=False, q_offset=0, k_offset=0):
    """dQ.  CPU tensors take :func:`flash_dq_plain`; CUDA tensors launch
    ``csrc/flash_bwd.cu:flash_dq``."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal, q_offset, k_offset)
    _require_cuda("flash_dq", q)
    sizes = _check("flash_dq", q, k, v, _bwd_rows(q, do, lse, delta))
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch("flash_dq", (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
                sizes, causal, q_offset, k_offset, q.dtype)
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal=False, q_offset=0, k_offset=0):
    """``(dK, dV)``.  CPU tensors take :func:`flash_dkv_plain`; CUDA tensors
    launch ``csrc/flash_bwd.cu:flash_dkv``."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal, q_offset, k_offset)
    _require_cuda("flash_dkv", q)
    sizes = _check("flash_dkv", q, k, v, _bwd_rows(q, do, lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("flash_dkv", (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                              lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
                sizes, causal, q_offset, k_offset, q.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# Autograd binding and the attention API
# ---------------------------------------------------------------------------


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention on (B*H, T, D), the semantics of the
    JAX package's ``_flash`` custom VJP: the forward saves ``(q, k, v, o,
    lse)``; the backward forms ``delta = rowsum(dO * O)`` in float32 and
    runs the dQ and the dK/dV kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset):
        o, lse = flash_fwd(q, k, v, causal, q_offset, k_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, q_offset, k_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(o.dtype).contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = flash_dq(q, k, v, do, lse, delta, *ctx.mask)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, q_offset: int = 0, k_offset: int = 0):
    """Fused flash attention, drop-in for :func:`ops.attention.mha_attention`.

    ``q`` (B, H, Tq, D), ``k``/``v`` (B, H, Tk, D) -> (B, H, Tq, D);
    ``q_offset``/``k_offset`` are the global positions of the first query
    and key, so causal masking works on sequence chunks.  Differentiable
    through the dQ and dK/dV kernels.  The JAX function's ``block_q`` /
    ``block_k`` are TPU tiling (multiples of 128 lanes) and have no
    counterpart: the Hopper tile sizes belong to the kernels."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention wants (B, H, T, D) inputs, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    b, h, t_q, d = q.shape
    o = FlashAttention.apply(
        q.reshape(b * h, t_q, d).contiguous(),
        k.reshape(b * h, k.shape[2], d).contiguous(),
        v.reshape(b * h, v.shape[2], d).contiguous(),
        causal, q_offset, k_offset,
    )
    return o.reshape(b, h, t_q, d)
