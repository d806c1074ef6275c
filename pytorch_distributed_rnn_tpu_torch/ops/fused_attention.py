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
- ``flash_dqkv`` (``csrc/flash_bwd.cu``) replaces both of those and
  ``_delta_of`` for float32 at short key lengths: one block per head forms
  delta, S and dP once and writes dQ, dK and dV (:func:`flash_bwd_route`
  picks it or the split pair by shape and dtype).

The kernels take the heads as a head-major batch of rows: each q-side
tensor (q, o, dO, dQ) as ``(B, Tq, H, D)`` and each k-side one (k, v, dK,
dV) as ``(B, Tk, H, D)``, addressed by their (batch, head, row) strides
with unit stride in D, so the model's views of its projections go in
without a copy; ``(B*H, T, D)`` tensors are the same layout with H = 1.
float32 or bfloat16, any T and a head dim D of 1 to 128 (``flash_dqkv``:
float32, Tq and Tk up to ``DQKV_MAX_LEN``, D up to
``DQKV_MAX_HEAD_DIM``); ``lse`` and ``delta`` are ``(B*H, Tq)`` float32,
contiguous.  Outputs take their inputs' layout (o and dQ q's, dK k's, dV
v's).  ``scale = D ** -0.5`` multiplies the float32 product, and each
operand the TPU kernel casts to the input dtype before a product (p
before p.V, ds before ds.K, p for dV, ds for dK) is rounded to it.  Every
product sums in float32.  The dtype picks the kernels: bfloat16 runs all
three on the tensor cores (``mma.sync``, with p and ds kept in registers
between products); float32 runs the forward and ``flash_dqkv`` on the
tensor cores in 3xTF32 (each operand split into two TF32 parts, three
products: TF32 alone would miss the float32 tolerance) and the split
backward beyond ``flash_dqkv``'s range on the CUDA cores.  Causal masking works on the runtime global positions
``q_offset``/``k_offset`` of the first query and key, and a query that sees
no key gives ``o = 0`` and ``lse = -inf``.  On the split route ``delta =
rowsum(dO * O)`` is plain torch, as ``_delta_of`` is XLA outside the TPU
kernels; ``flash_dqkv`` forms it itself.

Each wrapper takes the kernel's plain PyTorch version (``*_plain``) only
for CPU tensors; on CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts kernel launches, so a run can show its main path went
through the kernels; a launch captured in a CUDA graph counts at each
replay (``utils/graphs.py:count_launch``).  The ring composition
(``ring_flash_attention``, ``_merge_partials``) waits for the
sequence-parallel strategies.
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_distributed_rnn_tpu_torch.utils.graphs import count_launch

# kernel launches since the last reset_launch_counts(), by kernel name
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_dqkv": 0}
# the source (library) each kernel's C entry point lives in
LIBRARIES = {"flash_fwd": "flash_fwd", "flash_dq": "flash_bwd", "flash_dkv": "flash_bwd",
             "flash_dqkv": "flash_bwd"}
MAX_HEAD_DIM = 128  # kMaxHeadDim in csrc/flash_common.cuh
# flash_dqkv's range, Tq and Tk up to DQKV_MAX_LEN (kDqkvMaxKeys and
# kDqkvMaxHeadDim in csrc/flash_bwd.cu): a head's K and V sit in one
# block's shared memory
DQKV_MAX_LEN = 128
DQKV_MAX_HEAD_DIM = 64
BLOCK_ROWS = 64  # rows of a query or key tile (kBlockM, kBlockN): one block's share
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# pointer arguments of each kernel's C entry point; then the strides (3 a
# strided tensor, in pointer order), the ints bh, heads, t_q, t_k, d, the
# float scale, the ints causal, q_off, k_off, dtype, the stream
_POINTERS = {"flash_fwd": 5, "flash_dq": 7, "flash_dkv": 8, "flash_dqkv": 9}


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


def flash_bwd_route(t_q: int, t_k: int, d: int, dtype) -> str:
    """The backward's kernels at this shape and dtype: ``"dqkv"`` (one
    ``flash_dqkv`` launch) for float32 with Tq and Tk up to
    ``DQKV_MAX_LEN`` and D up to ``DQKV_MAX_HEAD_DIM``, else ``"split"``
    (``flash_dq`` and ``flash_dkv``, delta in torch; on the card they take
    float32 and bfloat16 and refuse other dtypes).  The CPU takes the same
    route through the plain versions.  A dtype that is not floating point
    raises."""
    if not dtype.is_floating_point:
        raise TypeError(f"flash backward: dtype {dtype} not supported (a floating dtype)")
    short = t_q <= DQKV_MAX_LEN and t_k <= DQKV_MAX_LEN and d <= DQKV_MAX_HEAD_DIM
    return "dqkv" if dtype == torch.float32 and short else "split"


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


def _by_head(x):
    """A (B, T, H, D) tensor as its (B, H, T, D) view; (B*H, T, D) as it is."""
    return x.transpose(1, 2) if x.ndim == 4 else x


def _head_rows(rows, x):
    """``lse`` or ``delta`` (B*H, Tq) as the (..., Tq) rows of ``x``'s
    by-head view."""
    return rows.reshape(_by_head(x).shape[:-1])


def _like(x, value):
    """``value`` (by head) in a new tensor of ``x``'s dtype and layout: the
    kernels write every output in its input's layout."""
    out = torch.empty_like(x)
    _by_head(out).copy_(value)
    return out


def flash_fwd_plain(q, k, v, causal=False, q_offset=0, k_offset=0):
    """``q`` (B, Tq, H, D) or (BH, Tq, D), ``k``/``v`` (B, Tk, H, D) or
    (BH, Tk, D) -> ``o`` in q's dtype and layout and ``lse`` (BH, Tq)
    float32; p is cast to v's dtype before p.V, and a row with no visible
    key gives o = 0, lse = -inf."""
    s = _scores(_by_head(q), _by_head(k))
    mask = _visible(q.shape[1], k.shape[1], causal, q_offset, k_offset, q.device)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))  # fully masked rows: exp(nan)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    acc = p.to(v.dtype).float() @ _by_head(v).float()
    lse = torch.where(l > 0, m + torch.log(l_safe), torch.full_like(l, float("-inf")))
    return _like(q, (acc / l_safe).to(q.dtype)), lse[..., 0].reshape(-1, q.shape[1])


def _recompute(q, k, v, do, lse, delta, causal, q_offset, k_offset):
    """``p = exp(s - lse)`` scrubbed of masked and non-finite entries
    (``_recompute_p``) and ``ds = p (dO v^T - delta) * scale``, float32, by
    head."""
    qh, kh = _by_head(q), _by_head(k)
    p = torch.exp(_scores(qh, kh) - _head_rows(lse, q)[..., None])
    mask = _visible(q.shape[1], k.shape[1], causal, q_offset, k_offset, q.device)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    p = torch.where(torch.isfinite(p), p, torch.zeros_like(p))
    dp = _by_head(do).float() @ _by_head(v).float().transpose(-1, -2)
    return p, p * (dp - _head_rows(delta, q)[..., None]) * q.shape[-1] ** -0.5


def _dq_of(ds, q, k):
    """dQ in q's dtype and layout: ``ds`` cast to k's dtype before ds.K."""
    return _like(q, (ds.to(k.dtype).float() @ _by_head(k).float()).to(q.dtype))


def _dkv_of(p, ds, q, k, v, do):
    """dK, dV in k's and v's dtypes and layouts: ``p`` cast to dO's dtype
    before p^T.dO, ``ds`` to q's dtype before ds^T.Q."""
    dv = p.to(do.dtype).float().transpose(-1, -2) @ _by_head(do).float()
    dk = ds.to(q.dtype).float().transpose(-1, -2) @ _by_head(q).float()
    return _like(k, dk.to(k.dtype)), _like(v, dv.to(v.dtype))


def _delta(do, o):
    """``rowsum(dO * O)`` in float32 (``_delta_of``), (B*H, Tq)."""
    return (_by_head(do).float() * _by_head(o).float()).sum(dim=-1).reshape(-1, o.shape[1])


def flash_dq_plain(q, k, v, do, lse, delta, causal=False, q_offset=0, k_offset=0):
    """dQ in q's dtype and layout."""
    _, ds = _recompute(q, k, v, do, lse, delta, causal, q_offset, k_offset)
    return _dq_of(ds, q, k)


def flash_dkv_plain(q, k, v, do, lse, delta, causal=False, q_offset=0, k_offset=0):
    """dK, dV in k's and v's dtypes and layouts."""
    p, ds = _recompute(q, k, v, do, lse, delta, causal, q_offset, k_offset)
    return _dkv_of(p, ds, q, k, v, do)


def flash_dqkv_plain(q, k, v, o, do, lse, causal=False, q_offset=0, k_offset=0):
    """``(dQ, dK, dV)`` from the forward's ``o`` and ``lse``: delta, p and
    ds formed once for all three products (``_bwd_impl`` with
    ``_delta_of``)."""
    p, ds = _recompute(q, k, v, do, lse, _delta(do, o), causal, q_offset, k_offset)
    return (_dq_of(ds, q, k), *_dkv_of(p, ds, q, k, v, do))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _library(name: str):
    from pytorch_distributed_rnn_tpu_torch import _build

    fn = getattr(_build.load(LIBRARIES[name]), name)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * _POINTERS[name] + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _row_strides(t) -> list:
    """The (batch, head, row) element strides the kernels address a
    (B, T, H, D) tensor by, a (B*H, T, D) one as H = 1; a dimension of size
    1 gets stride 0 (any stride addresses it)."""
    if t.ndim == 3:
        sizes, strides = (t.shape[0], 1, t.shape[1]), (t.stride(0), 0, t.stride(1))
    else:
        sizes, strides = (t.shape[0], t.shape[2], t.shape[1]), (t.stride(0), t.stride(2),
                                                                 t.stride(1))
    return [stride if size > 1 else 0 for size, stride in zip(sizes, strides)]


def _check(name, q, k, v, rows=()):
    """Device, dtype, shape and layout checks before a launch: ``q`` (B, Tq,
    H, D) or (BH, Tq, D), ``k``/``v`` (B, Tk, H, D) or (BH, Tk, D) in q's
    dtype, and the ``(tensor, shape, dtype)`` triples of ``rows`` (the
    backward's dO, lse, delta: :func:`_bwd_rows`).  Every tensor of q's rank
    has unit stride in D (any other strides); the (BH, Tq) float32 ones are
    contiguous.  Returns (BH, H, Tq, Tk, D)."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    if q.ndim not in (3, 4) or k.ndim != q.ndim:
        raise ValueError(f"{name}: wants (B, T, H, D) or (B*H, T, D) tensors, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}")
    t_q, t_k, d = q.shape[1], k.shape[1], q.shape[-1]
    heads = q.shape[2] if q.ndim == 4 else 1
    bh = q.shape[0] * heads
    k_shape = (q.shape[0], t_k, *q.shape[2:])
    want = [(k, k_shape, q.dtype), (v, k_shape, q.dtype)]
    want += [(t, shape, dtype) for t, shape, dtype in rows]
    for t, shape, dtype in [(q, tuple(q.shape), q.dtype), *want]:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        if (t.ndim == 2 and not t.is_contiguous()) or (t.ndim > 2 and t.stride(-1) != 1
                                                       and d > 1):
            raise ValueError(f"{name}: tensors must have unit stride in D (lse and delta "
                             "contiguous)")
    if bh < 1 or t_q < 1 or t_k < 1 or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"{name}: no kernel for BH={bh} Tq={t_q} Tk={t_k} D={d} (D up to {MAX_HEAD_DIM})"
        )
    return bh, heads, t_q, t_k, d


def _require_cuda(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: runs on CPU or CUDA tensors, got {q.device}")


def _launch(name, tensors, sizes, causal, q_offset, k_offset, dtype):
    """The C entry point on ``tensors`` in its pointer order, the strides of
    the strided ones (all but lse and delta) beside them."""
    bh, heads, t_q, t_k, d = sizes
    strides = [n for t in tensors if t.ndim > 2 for n in _row_strides(t)]
    err = _library(name)(
        *(t.data_ptr() for t in tensors), (ctypes.c_longlong * len(strides))(*strides), bh,
        heads, t_q, t_k, d, d ** -0.5, int(causal), int(q_offset), int(k_offset),
        _DTYPE_CODES[dtype], torch.cuda.current_stream().cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    count_launch(LAUNCHES, name)


def _rows_shape(q) -> tuple:
    """(B*H, Tq): the shape of ``lse`` and ``delta`` for ``q``."""
    return q.shape[0] * (q.shape[2] if q.ndim == 4 else 1), q.shape[1]


def _bwd_rows(q, do, lse, delta):
    """The backward's extra inputs for :func:`_check`."""
    return [(do, tuple(q.shape), q.dtype), (lse, _rows_shape(q), torch.float32),
            (delta, _rows_shape(q), torch.float32)]


def flash_fwd(q, k, v, causal=False, q_offset=0, k_offset=0):
    """``(o, lse)``, o in q's layout.  CPU tensors take
    :func:`flash_fwd_plain`; CUDA tensors launch ``csrc/flash_fwd.cu``."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, q_offset, k_offset)
    _require_cuda("flash_fwd", q)
    sizes = _check("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(_rows_shape(q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("flash_fwd", (q, k, v, o, lse), sizes, causal, q_offset, k_offset, q.dtype)
    return o, lse


def flash_dq(q, k, v, do, lse, delta, causal=False, q_offset=0, k_offset=0):
    """dQ in q's layout.  CPU tensors take :func:`flash_dq_plain`; CUDA
    tensors launch ``csrc/flash_bwd.cu:flash_dq``."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal, q_offset, k_offset)
    _require_cuda("flash_dq", q)
    sizes = _check("flash_dq", q, k, v, _bwd_rows(q, do, lse, delta))
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch("flash_dq", (q, k, v, do, lse, delta, dq), sizes, causal, q_offset, k_offset,
                q.dtype)
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal=False, q_offset=0, k_offset=0):
    """``(dK, dV)`` in k's and v's layouts.  CPU tensors take
    :func:`flash_dkv_plain`; CUDA tensors launch
    ``csrc/flash_bwd.cu:flash_dkv``."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal, q_offset, k_offset)
    _require_cuda("flash_dkv", q)
    sizes = _check("flash_dkv", q, k, v, _bwd_rows(q, do, lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("flash_dkv", (q, k, v, do, lse, delta, dk, dv), sizes, causal, q_offset,
                k_offset, q.dtype)
    return dk, dv


def flash_dqkv(q, k, v, o, do, lse, causal=False, q_offset=0, k_offset=0):
    """``(dQ, dK, dV)`` in one launch, each in its input's layout.  CPU
    tensors take :func:`flash_dqkv_plain`; CUDA tensors launch
    ``csrc/flash_bwd.cu:flash_dqkv``, which takes what
    :func:`flash_bwd_route` sends it (float32, Tq and Tk up to
    ``DQKV_MAX_LEN``, D up to ``DQKV_MAX_HEAD_DIM``) and nothing else."""
    if q.device.type == "cpu":
        return flash_dqkv_plain(q, k, v, o, do, lse, causal, q_offset, k_offset)
    _require_cuda("flash_dqkv", q)
    rows = [(o, tuple(q.shape), q.dtype), (do, tuple(q.shape), q.dtype),
            (lse, _rows_shape(q), torch.float32)]
    sizes = _check("flash_dqkv", q, k, v, rows)
    _, _, t_q, t_k, d = sizes
    if flash_bwd_route(t_q, t_k, d, q.dtype) != "dqkv":
        raise ValueError(f"flash_dqkv: no kernel for Tq={t_q} Tk={t_k} D={d} {q.dtype} "
                         f"(float32, T up to {DQKV_MAX_LEN}, D up to {DQKV_MAX_HEAD_DIM})")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("flash_dqkv", (q, k, v, o, do, lse, dq, dk, dv), sizes, causal, q_offset,
                k_offset, q.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Autograd binding and the attention API
# ---------------------------------------------------------------------------


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention on (B, T, H, D) (or (B*H, T, D))
    tensors, the semantics of the JAX package's ``_flash`` custom VJP: the
    forward saves ``(q, k, v, o, lse)``; the backward takes
    :func:`flash_bwd_route`'s kernels, one ``flash_dqkv`` (delta formed
    inside), or ``delta = rowsum(dO * O)`` in float32 and the dQ and the
    dK/dV kernel.  dO is read in the layout it arrives in; only one without
    unit stride in D, which the kernels refuse, is copied."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset):
        o, lse = flash_fwd(q, k, v, causal, q_offset, k_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, q_offset, k_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(o.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        if flash_bwd_route(q.shape[1], k.shape[1], q.shape[-1], q.dtype) == "dqkv":
            dq, dk, dv = flash_dqkv(q, k, v, o, do, lse, *ctx.mask)
        else:
            delta = _delta(do, o)
            dq = flash_dq(q, k, v, do, lse, delta, *ctx.mask)
            dk, dv = flash_dkv(q, k, v, do, lse, delta, *ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, q_offset: int = 0, k_offset: int = 0):
    """Fused flash attention, drop-in for :func:`ops.attention.mha_attention`.

    ``q`` (B, H, Tq, D), ``k``/``v`` (B, H, Tk, D) -> (B, H, Tq, D);
    ``q_offset``/``k_offset`` are the global positions of the first query
    and key, so causal masking works on sequence chunks.  Differentiable
    through the backward kernels of :func:`flash_bwd_route`.  The kernels
    read each input through its (B, T, H, D) view, which for the heads the
    model splits off its projections (``models/attention.py:_split_heads``)
    is the projection itself: no copy.  An input whose D is not of unit
    stride is copied here (``contiguous``), the one layout the kernels
    refuse.  The result is the (B, H, Tq, D) view of an output in q's
    layout, so merging the heads back is a view too.  The JAX function's
    ``block_q`` / ``block_k`` are TPU tiling (multiples of 128 lanes) and
    have no counterpart: the Hopper tile sizes belong to the kernels."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention wants (B, H, T, D) inputs, got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")

    def by_row(x):
        x = x.transpose(1, 2)
        return x if x.stride(-1) == 1 else x.contiguous()

    o = FlashAttention.apply(by_row(q), by_row(k), by_row(v), causal, q_offset, k_offset)
    return o.transpose(1, 2)
