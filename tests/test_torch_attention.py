"""The port's attention family against the JAX package's, on the CPU.

``ops/fused_attention.py`` (the flash kernels' plain versions, the
``FlashAttention`` binding and ``flash_attention``) against the JAX
``flash_attention`` in Pallas interpret mode (also on the heads
``_split_heads`` makes of (B, T, H*D) projections, forward and
gradients) and the JAX kernels' own ``_fwd_impl``/``_bwd_impl``
(``flash_dqkv_plain`` against ``_bwd_impl`` with ``_delta_of``; on
(B*H, T, D) rows and on the (B, T, H, D) layout), and against
``mha_attention``; the backward's route (``flash_bwd_route``); the
kernels' (batch, head, row) strides (``_row_strides``) and that the
classifier's flash path hands the wrappers its projections' own storage;
``ops/attention.py:mha_attention``; ``models/attention.py`` (layer norm,
the GELU epilogue, ``AttentionClassifier`` forward and gradients with
weights carried over by ``interop``); a two-epoch ``local`` loss history
against the JAX trainer from the same initial weights (rtol 1e-4, as
``test_torch_training.py``); the CLI's ``--model attention`` handling.
Tolerances: the JAX attention tests' (f32 1e-5 forward, gradients rtol
1e-4 / atol 1e-5, bf16 2e-2) for the attention functions, the JAX model
tests' (f32 1e-5 forward and 1e-4 gradients, bf16 5e-2) for the model.

The ``cuda``-marked tests hold the CUDA kernels against the plain
versions on a card (bf16 there at 1e-2 of each output's largest value),
on (B*H, T, D) rows and on the (B, T, H, D) layout, the f32 forward at
its tile edges, check that two ``flash_dqkv`` launches give the same
bits, and skip without one; JAX is imported inside the tests that use it, so
on a card (where JAX is not installed) they run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_attention.py
"""

import json

import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch import main as port_main
from pytorch_distributed_rnn_tpu_torch.data import (
    MotionDataset,
    generate_har_arrays,
    write_synthetic_har_cache,
)
from pytorch_distributed_rnn_tpu_torch.models import AttentionClassifier
from pytorch_distributed_rnn_tpu_torch.models import attention as tattn
from pytorch_distributed_rnn_tpu_torch.ops import fused_attention as fa
from pytorch_distributed_rnn_tpu_torch.ops.attention import mha_attention
from pytorch_distributed_rnn_tpu_torch.training import Trainer

ATOL, RTOL_GRAD, ATOL_GRAD, BF16_ATTN = 1e-5, 1e-4, 1e-5, 2e-2
F32_FWD, F32_GRAD, BF16 = 1e-5, 1e-4, 5e-2
BF16_KERNEL = 1e-2  # of each output's largest value: one bf16 ulp is 2^-7 of it
HISTORY_RTOL = 1e-4
SEED = 123456789


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _qkv(t_q=128, t_k=None, b=2, h=4, d=16, seed=0):
    """q, k, v (B, H, T, D) float32 numpy arrays from a seed."""
    t_k = t_q if t_k is None else t_k
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, t, d).astype(np.float32) for t in (t_q, t_k, t_k))


def _jax(arrays, dtype="f32"):
    import jax.numpy as jnp

    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    return tuple(jnp.asarray(a).astype(jdt) for a in arrays)


def _torch(arrays, dtype="f32", grad=False):
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    return tuple(torch.from_numpy(a).to(tdt).requires_grad_(grad) for a in arrays)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype("float32"))


# ---------------------------------------------------------------------------
# flash attention against the JAX flash kernel and mha_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 16, 32])
@pytest.mark.parametrize("t", [64, 128, 200])
def test_flash_forward_matches_jax(t, d, causal):
    from pytorch_distributed_rnn_tpu.ops.attention import mha_attention as jax_mha
    from pytorch_distributed_rnn_tpu.ops.pallas_attention import flash_attention as jax_flash

    arrays = _qkv(t_q=t, b=1, h=4, d=d, seed=t + d)
    got = fa.flash_attention(*_torch(arrays), causal=causal)
    for want in (jax_flash(*_jax(arrays), causal=causal), jax_mha(*_jax(arrays), causal=causal)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize(
    "t_q,t_k,causal,q_offset,k_offset",
    [(96, 160, False, 0, 0), (64, 64, True, 128, 64), (160, 96, True, 32, 0)],
)
def test_flash_lengths_and_offsets_match_jax(t_q, t_k, causal, q_offset, k_offset):
    from pytorch_distributed_rnn_tpu.ops.attention import mha_attention as jax_mha
    from pytorch_distributed_rnn_tpu.ops.pallas_attention import flash_attention as jax_flash

    arrays = _qkv(t_q=t_q, t_k=t_k, b=2, h=2, seed=5)
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)
    got = fa.flash_attention(*_torch(arrays), **kw)
    assert got.shape == (2, 2, t_q, 16)
    for want in (jax_flash(*_jax(arrays), **kw), jax_mha(*_jax(arrays), **kw)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=ATOL, atol=ATOL)


def test_chunk_with_no_visible_keys_is_zero_with_lse_minus_inf():
    """Queries strictly before every key: o exactly 0 and lse = -inf, as
    the JAX kernel gives (the dense path gives NaN there)."""
    from pytorch_distributed_rnn_tpu.ops.pallas_attention import flash_attention as jax_flash

    arrays = _qkv(t_q=32, t_k=32, b=1, h=2, seed=3)
    got = fa.flash_attention(*_torch(arrays), causal=True, q_offset=0, k_offset=512)
    assert torch.equal(got, torch.zeros_like(got))
    np.testing.assert_array_equal(
        _np(jax_flash(*_jax(arrays), causal=True, q_offset=0, k_offset=512)), 0.0)
    q, k, v = (t.reshape(2, 32, 16) for t in _torch(arrays))
    o, lse = fa.flash_fwd(q, k, v, causal=True, q_offset=0, k_offset=512)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.isneginf(lse).all() and lse.shape == (2, 32)


def test_flash_bf16_matches_jax():
    from pytorch_distributed_rnn_tpu.ops.attention import mha_attention as jax_mha
    from pytorch_distributed_rnn_tpu.ops.pallas_attention import flash_attention as jax_flash

    arrays = _qkv(t_q=128, d=32, seed=2)
    got = fa.flash_attention(*_torch(arrays, "bf16"))
    assert got.dtype == torch.bfloat16
    for want in (jax_flash(*_jax(arrays, "bf16")), jax_mha(*_jax(arrays, "bf16"))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_ATTN, atol=BF16_ATTN)


@pytest.mark.parametrize(
    "causal,q_offset,t_k", [(False, 0, 160), (True, 0, 160), (True, 64, 128)],
)
def test_flash_grads_match_jax(causal, q_offset, t_k):
    """Gradients of all three inputs at a ragged T=160, and with offsets,
    against the JAX flash backward and the dense gradients."""
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_rnn_tpu.ops.attention import mha_attention as jax_mha
    from pytorch_distributed_rnn_tpu.ops.pallas_attention import flash_attention as jax_flash

    arrays = _qkv(t_q=160 if t_k == 160 else 64, t_k=t_k, b=1, h=4, seed=7)
    kw = dict(causal=causal, q_offset=q_offset)
    q, k, v = _torch(arrays, grad=True)
    torch.sin(fa.flash_attention(q, k, v, **kw)).sum().backward()
    for attn in (jax_flash, jax_mha):
        want = jax.grad(lambda *a: jnp.sum(jnp.sin(attn(*a, **kw))),  # noqa: B023
                        argnums=(0, 1, 2))(*_jax(arrays))
        for name, got, w in zip("qkv", (q.grad, k.grad, v.grad), want):
            np.testing.assert_allclose(_np(got), _np(w), rtol=RTOL_GRAD, atol=ATOL_GRAD,
                                       err_msg=f"d{name}")


def _heads_layout(a, heads):
    """(B*H, T, D) numpy rows as the (B, T, H, D) tensor layout the kernels
    read (a view of a (B, T, H*D) projection); ``heads`` 1 keeps the
    (B*H, T, D) form."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if heads == 1:
        return t
    bh, n, d = t.shape
    return t.reshape(bh // heads, heads, n, d).transpose(1, 2).contiguous()


def _flat_heads(t):
    """A (B, T, H, D) tensor's rows as (B*H, T, D); (B*H, T, D) as it is."""
    return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3]) if t.ndim == 4 else t


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "t,causal,q_offset,k_offset",
    [(200, False, 0, 0), (200, True, 0, 0), (64, True, 128, 64), (128, True, 32, 0)],
)
def test_flash_on_split_head_views_matches_jax(dtype, t, causal, q_offset, k_offset):
    """``flash_attention`` on the (B, H, T, D) views that the model's
    ``_split_heads`` makes of (B, T, H*D) projections (the layout the
    kernels read without a copy) against the JAX ``flash_attention``
    (Pallas interpret mode) on the same split: the output and the
    gradients of the three projections."""
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_rnn_tpu.ops.pallas_attention import flash_attention as jax_flash

    b, h, d = 2, 3, 16
    rng = np.random.RandomState(t + q_offset)
    proj = [rng.randn(b, t, h * d).astype(np.float32) for _ in range(3)]
    w = rng.randn(b, h, t, d).astype(np.float32)
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)
    tp = _torch(proj, dtype, grad=True)
    views = [tattn._split_heads(x, h) for x in tp]
    assert not views[0].is_contiguous() and views[0].transpose(1, 2).is_contiguous()
    out = fa.flash_attention(*views, **kw)
    (out.float() * torch.from_numpy(w)).sum().backward()

    def loss(*xs):
        split = [x.reshape(b, t, h, d).transpose(0, 2, 1, 3) for x in xs]
        return jnp.sum(jax_flash(*split, **kw).astype(jnp.float32) * w)

    jp = _jax(proj, dtype)
    want = jax_flash(*(x.reshape(b, t, h, d).transpose(0, 2, 1, 3) for x in jp), **kw)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*jp)
    fwd_tol = ATOL if dtype == "f32" else BF16_ATTN
    rtol, atol = (RTOL_GRAD, ATOL_GRAD) if dtype == "f32" else (BF16_ATTN, BF16_ATTN)
    np.testing.assert_allclose(_np(out), _np(want), rtol=fwd_tol, atol=fwd_tol)
    for name, x, g in zip("qkv", tp, grads):
        np.testing.assert_allclose(_np(x.grad), _np(g), rtol=rtol, atol=atol, err_msg=f"d{name}")


def test_model_path_hands_the_kernels_the_projections(monkeypatch):
    """On the classifier's flash path the kernels' wrappers get q, k and v
    in the projections' own storage ((B, T, H, D) views: no head-split
    copy), the backward gets the forward's o and a dO of unit stride in D,
    and ``block_epilogue`` merges the heads of ``flash_fwd``'s o as a view
    (no merge copy)."""
    seen = {"linear": []}
    linear, epilogue = tattn._linear, tattn.block_epilogue
    fwd, dqkv = fa.flash_fwd, fa.flash_dqkv

    def record_linear(p, x):
        seen["linear"].append(linear(p, x))
        return seen["linear"][-1]

    def record_fwd(q, k, v, *args):
        seen["fwd"] = (q, k, v)
        seen["o"], lse = fwd(q, k, v, *args)
        return seen["o"], lse

    def record_dqkv(q, k, v, o, do, *args):
        seen["dqkv"] = (q, k, v, o, do)
        return dqkv(q, k, v, o, do, *args)

    def record_epilogue(params, x, attn_out, **kw):
        seen["attn_out"] = attn_out
        return epilogue(params, x, attn_out, **kw)

    monkeypatch.setattr(tattn, "_linear", record_linear)
    monkeypatch.setattr(tattn, "block_epilogue", record_epilogue)
    monkeypatch.setattr(fa, "flash_fwd", record_fwd)
    monkeypatch.setattr(fa, "flash_dqkv", record_dqkv)
    b, t, dim, heads = 3, 24, 16, 2
    model = AttentionClassifier(input_dim=9, dim=dim, depth=1, num_heads=heads, impl="flash")
    x = torch.from_numpy(np.random.RandomState(0).randn(b, t, 9).astype(np.float32))
    model(x).sum().backward()

    projections = seen["linear"][1:4]  # embed, then wq, wk, wv
    for name, got, proj in zip("qkv", seen["fwd"], projections):
        assert got.shape == (b, t, heads, dim // heads), name
        assert got.data_ptr() == proj.data_ptr() and got._base is not None, name
        assert fa._row_strides(got) == [t * dim, dim // heads, dim], name
    fa._check("flash_fwd", *seen["fwd"])  # the layout the card's kernels take
    q, k, v, o, do = seen["dqkv"]
    assert [a.data_ptr() for a in (q, k, v, o)] == [a.data_ptr() for a in (*seen["fwd"],
                                                                            seen["o"])]
    assert do.stride(-1) == 1
    merged = tattn._merge_heads(seen["attn_out"])
    assert merged.data_ptr() == seen["o"].data_ptr() and merged.shape == (b, t, dim)


@pytest.mark.parametrize(
    "shape,permute,want",
    [((2, 5, 3, 8), None, [120, 8, 24]),  # (B, T, H, D) of a (B, T, H*D) projection
     ((2, 3, 5, 8), (0, 2, 1, 3), [120, 40, 8]),  # (B, H, T, D) storage seen as (B, T, H, D)
     ((6, 5, 8), None, [40, 0, 8]),  # (B*H, T, D): H = 1
     ((1, 5, 1, 8), None, [0, 0, 8]),  # a dimension of size 1: stride 0
     ((4, 1, 8), None, [8, 0, 0])],
)
def test_row_strides(shape, permute, want):
    t = torch.zeros(shape)
    if permute is not None:
        t = t.permute(permute)
    assert fa._row_strides(t) == want


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "causal,q_offset,k_offset,t,d,heads",
    [pytest.param(False, 0, 0, 100, 16, 1, id="False-0-0"),
     pytest.param(True, 32, 0, 100, 16, 1, id="True-32-0"),
     # a head dim of whole 16-byte chunks but not of whole 16-column
     # k-steps (the card's bf16 kernels pad it in shared memory), over two
     # JAX blocks
     pytest.param(False, 0, 0, 200, 72, 1, id="False-0-0-T200-D72"),
     pytest.param(True, 32, 0, 200, 72, 1, id="True-32-0-T200-D72"),
     # the (B, T, H, D) layout of the model's projections, 3 heads
     pytest.param(True, 32, 0, 100, 16, 3, id="H3-True-32-0"),
     pytest.param(False, 0, 0, 200, 72, 3, id="H3-False-0-0-T200-D72")],
)
def test_plain_versions_match_jax_kernels(dtype, causal, q_offset, k_offset, t, d, heads):
    """``flash_{fwd,dq,dkv}_plain`` against the JAX kernels themselves
    (``_fwd_impl``, ``_bwd_impl``, lse and delta lane-replicated there),
    at a ragged length padded to the JAX blocks, on (B*H, T, D) tensors and
    on the (B, T, H, D) layout (the outputs in their inputs' layout)."""
    import jax.numpy as jnp

    from pytorch_distributed_rnn_tpu.ops import pallas_attention as jpa

    bh, blk = 3, 128
    rng = np.random.RandomState(11)
    q, k, v, do = (rng.randn(bh, t, d).astype(np.float32) for _ in range(4))
    tol = ATOL if dtype == "f32" else BF16_ATTN

    def pad(a):
        return jnp.pad(a, ((0, 0), (0, -(-t // blk) * blk - t), (0, 0)))

    jq, jk, jv, jdo = (pad(a) for a in _jax((q, k, v, do), dtype))
    offs = jnp.array([q_offset, k_offset], jnp.int32)
    j_o, j_lse = jpa._fwd_impl(jq, jk, jv, offs, causal, blk, blk, t, t)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tq, tk, tv, tdo = (_heads_layout(a, heads).to(tdt) for a in (q, k, v, do))
    o, lse = fa.flash_fwd_plain(tq, tk, tv, causal, q_offset, k_offset)
    assert o.shape == tq.shape and o.stride() == tq.stride() and lse.shape == (bh, t)
    np.testing.assert_allclose(_np(_flat_heads(o)), _np(j_o[:, :t]), rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse[:, :t, 0]), rtol=tol, atol=tol)

    j_delta = jpa._delta_of(jdo, j_o)
    j_dq, j_dk, j_dv = jpa._bwd_impl(jq, jk, jv, jdo, j_lse, j_delta, offs, causal, blk, blk,
                                     t, t)
    delta = fa._delta(tdo, o)
    dq = fa.flash_dq_plain(tq, tk, tv, tdo, lse, delta, causal, q_offset, k_offset)
    dk, dv = fa.flash_dkv_plain(tq, tk, tv, tdo, lse, delta, causal, q_offset, k_offset)
    assert dq.dtype == dk.dtype == dv.dtype == tq.dtype
    for name, got, want, like in (("dq", dq, j_dq, tq), ("dk", dk, j_dk, tk),
                                  ("dv", dv, j_dv, tv)):
        assert got.shape == like.shape and got.stride() == like.stride(), name
        np.testing.assert_allclose(_np(_flat_heads(got)), _np(want[:, :t]), rtol=tol * 10,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize(
    "t_q,t_k,d,causal,q_offset,k_offset,heads",
    [pytest.param(100, 100, 16, False, 0, 0, 1, id="T100-D16"),
     pytest.param(100, 100, 16, True, 32, 0, 1, id="T100-D16-causal-32-0"),
     pytest.param(200, 200, 72, False, 0, 0, 1, id="T200-D72"),
     pytest.param(200, 200, 72, True, 32, 0, 1, id="T200-D72-causal-32-0"),
     pytest.param(64, 64, 16, True, 128, 64, 1, id="causal-offsets-128-64"),
     pytest.param(96, 160, 32, False, 0, 0, 1, id="cross-96-160"),
     pytest.param(77, 100, 30, True, 40, 0, 1, id="ragged-77-100-causal"),
     # every query before every key: dQ, dK and dV are exactly 0
     pytest.param(32, 32, 32, True, 0, 512, 1, id="no-visible-key"),
     # the (B, T, H, D) layout of the model's projections, 3 heads
     pytest.param(77, 100, 30, True, 40, 0, 3, id="H3-ragged-77-100-causal"),
     pytest.param(128, 128, 32, False, 0, 0, 3, id="H3-T128-D32")],
)
def test_dqkv_plain_matches_jax_kernels(t_q, t_k, d, causal, q_offset, k_offset, heads):
    """``flash_dqkv_plain`` (delta formed inside) against the JAX kernels
    ``_bwd_impl`` with ``_delta_of`` in float32, the forward's o and lse
    from ``_fwd_impl``, at lengths padded to the JAX blocks, on (B*H, T, D)
    tensors and on the (B, T, H, D) layout."""
    import jax.numpy as jnp

    from pytorch_distributed_rnn_tpu.ops import pallas_attention as jpa

    bh, blk = 3, 128
    rng = np.random.RandomState(t_q + t_k + d)
    q, do = (rng.randn(bh, t_q, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(bh, t_k, d).astype(np.float32) for _ in range(2))

    def pad(a):
        return jnp.pad(a, ((0, 0), (0, -(-a.shape[1] // blk) * blk - a.shape[1]), (0, 0)))

    jq, jk, jv, jdo = (pad(a) for a in _jax((q, k, v, do)))
    offs = jnp.array([q_offset, k_offset], jnp.int32)
    j_o, j_lse = jpa._fwd_impl(jq, jk, jv, offs, causal, blk, blk, t_q, t_k)
    j_grads = jpa._bwd_impl(jq, jk, jv, jdo, j_lse, jpa._delta_of(jdo, j_o), offs, causal, blk,
                            blk, t_q, t_k)
    tq, tk, tv, tdo = (_heads_layout(a, heads) for a in (q, k, v, do))
    o, lse = fa.flash_fwd_plain(tq, tk, tv, causal, q_offset, k_offset)
    got = fa.flash_dqkv_plain(tq, tk, tv, o, tdo, lse, causal, q_offset, k_offset)
    for name, g, want, like in zip(("dq", "dk", "dv"), got, j_grads, (tq, tk, tv)):
        assert g.dtype == torch.float32 and g.shape == like.shape and g.stride() == like.stride()
        np.testing.assert_allclose(_np(_flat_heads(g)), _np(want[:, :like.shape[1]]),
                                   rtol=F32_GRAD, atol=F32_GRAD, err_msg=name)
    if k_offset == 512:
        assert not any(g.any() for g in got)


@pytest.mark.parametrize(
    "t_q,t_k,d,dtype,want",
    [(128, 128, 32, torch.float32, "dqkv"),  # the attention CLI's heads
     (128, 128, 8, torch.float32, "dqkv"),
     (128, 128, 64, torch.float32, "dqkv"),
     (96, 160, 32, torch.float32, "split"),
     (1024, 1024, 128, torch.float32, "split"),  # long context
     (128, 128, 72, torch.float32, "split"),
     (129, 128, 32, torch.float32, "split"),
     (128, 128, 32, torch.bfloat16, "split"),
     (1024, 1024, 128, torch.bfloat16, "split"),
     (128, 128, 32, torch.float64, "split")],  # CPU only: the plain versions
)
def test_flash_bwd_route(t_q, t_k, d, dtype, want):
    assert fa.flash_bwd_route(t_q, t_k, d, dtype) == want


@pytest.mark.parametrize("dtype", [torch.int32, torch.bool])
def test_flash_bwd_route_rejects_unknown_dtype(dtype):
    with pytest.raises(TypeError, match="not supported"):
        fa.flash_bwd_route(128, 128, 32, dtype)


@pytest.mark.parametrize(
    "dtype,t,want",
    [("f32", 20, {"flash_dqkv_plain"}), ("f32", 160, {"flash_dq_plain", "flash_dkv_plain"}),
     ("bf16", 20, {"flash_dq_plain", "flash_dkv_plain"})],
)
def test_cpu_backward_takes_its_routes_plain_version(dtype, t, want, monkeypatch):
    """On CPU tensors ``FlashAttention.backward`` walks the route the card
    would take, through the plain versions, and launches nothing."""
    called = set()
    for name in ("flash_dqkv_plain", "flash_dq_plain", "flash_dkv_plain"):
        def record(*args, _name=name, _fn=getattr(fa, name), **kw):
            called.add(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(fa, name, record)
    fa.reset_launch_counts()
    q, k, v = _torch(_qkv(t_q=t, b=1, h=2, d=8), dtype, grad=True)
    fa.flash_attention(q, k, v, causal=True).float().sum().backward()
    assert called == want
    assert not any(fa.LAUNCHES.values()), fa.LAUNCHES
    assert q.grad.shape == k.grad.shape == v.grad.shape == (1, 2, t, 8)


def test_plain_backward_is_the_gradient_of_plain_forward():
    """The FlashAttention backward (delta, dQ, dK/dV) is the autograd
    gradient of the plain forward's math, in float64."""
    arrays = _qkv(t_q=24, t_k=40, b=1, h=2, d=8, seed=4)
    q, k, v = (torch.from_numpy(a).double().requires_grad_() for a in arrays)
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    w = torch.randn(1, 2, 24, 8, dtype=torch.float64)
    kw = dict(causal=True, q_offset=20, k_offset=0)
    (fa.flash_attention(q, k, v, **kw) * w).sum().backward()
    (mha_attention(q2, k2, v2, **kw) * w).sum().backward()
    for got, want in ((q.grad, q2.grad), (k.grad, k2.grad), (v.grad, v2.grad)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# mha_attention and resolve_attention_impl
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "causal,q_offset,k_offset,dtype",
    [(False, 0, 0, "f32"), (True, 0, 0, "f32"), (True, 128, 64, "f32"), (True, 0, 512, "f32"),
     (False, 0, 0, "bf16")],
)
def test_mha_attention_matches_jax(causal, q_offset, k_offset, dtype):
    """The dense path, the NaN of a query with no visible key included
    (k_offset 512)."""
    from pytorch_distributed_rnn_tpu.ops.attention import mha_attention as jax_mha

    arrays = _qkv(t_q=48, t_k=64, b=2, h=2, seed=6)
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)
    got = mha_attention(*_torch(arrays, dtype), **kw)
    want = jax_mha(*_jax(arrays, dtype), **kw)
    tol = ATOL if dtype == "f32" else BF16_ATTN
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, equal_nan=True)
    assert np.isnan(_np(got)).all() == (k_offset == 512)


@pytest.mark.parametrize(
    "impl,device,want",
    [("auto", "cpu", "dense"), ("auto", "cuda", "flash"), ("auto", None, "dense"),
     ("dense", "cuda", "dense"), ("flash", "cpu", "flash")],
)
def test_resolve_attention_impl(impl, device, want):
    assert fa.resolve_attention_impl(impl, device) == want


# fault C2: auto takes dense above the kernels' head dim on the card, and
# an explicit flash there raises in the kernels' check
@pytest.mark.parametrize(
    "impl,head_dim,want",
    [("auto", 128, "flash"), ("auto", 129, "dense"), ("auto", 256, "dense"),
     ("flash", 256, "flash"), ("dense", 32, "dense")],
)
def test_resolve_attention_impl_by_head_dim(impl, head_dim, want):
    assert fa.resolve_attention_impl(impl, "cuda", head_dim) == want


def test_explicit_flash_above_the_kernel_head_dim_raises():
    q = torch.zeros(2, 8, 256)
    with pytest.raises(ValueError, match="D up to 128"):
        fa._check("flash_fwd", q, q, q)


def test_resolve_attention_impl_rejects_unknown():
    with pytest.raises(ValueError, match="unknown attention impl"):
        fa.resolve_attention_impl("ring")


# ---------------------------------------------------------------------------
# wrappers: CPU path, argument checks
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    fa.reset_launch_counts()
    q, k, v = _torch(_qkv(t_q=20, b=1, h=2, d=8), grad=True)
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    assert not any(fa.LAUNCHES.values()), fa.LAUNCHES
    assert q.grad is not None and k.grad is not None and v.grad is not None


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_dq", "flash_dkv", "flash_dqkv"])
def test_wrappers_reject_devices_other_than_cpu_and_cuda(kernel):
    q = torch.zeros(2, 5, 8, device="meta")
    rows = torch.zeros(2, 5, device="meta")
    args = {"flash_fwd": (q, q, q), "flash_dqkv": (q, q, q, q, q, rows)}.get(
        kernel, (q, q, q, q, rows, rows))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        getattr(fa, kernel)(*args)


@pytest.mark.parametrize(
    "bad,exc",
    [("dtype", TypeError), ("shape", ValueError), ("layout", ValueError),
     ("head_dim", ValueError), ("lse_dtype", TypeError)],
)
def test_wrapper_argument_checks(bad, exc):
    bh, t, d = 2, 6, 8
    q, k, v, do = (torch.zeros(bh, t, d) for _ in range(4))
    lse, delta = torch.zeros(bh, t), torch.zeros(bh, t)
    if bad == "dtype":
        q = q.half()
    elif bad == "shape":
        v = torch.zeros(bh, t + 1, d)
    elif bad == "layout":
        k = torch.zeros(bh, d, t).transpose(1, 2)
    elif bad == "head_dim":
        q, k, v, do = (torch.zeros(bh, t, 129) for _ in range(4))
    else:
        lse = lse.double()
    with pytest.raises(exc):
        fa._check("flash_dq", q, k, v, fa._bwd_rows(q, do, lse, delta))


# ---------------------------------------------------------------------------
# the model's pieces and the classifier against the JAX model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm_matches_jax(dtype):
    from pytorch_distributed_rnn_tpu.models.attention import _layer_norm as jax_ln

    rng = np.random.RandomState(1)
    x = (3.0 + 2.0 * rng.randn(4, 7, 16)).astype(np.float32)
    scale, bias = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    got = tattn._layer_norm(*_torch((x, scale, bias), dtype))
    want = jax_ln(*_jax((x, scale, bias), dtype))
    tol = F32_FWD if dtype == "f32" else BF16
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _jax_block(dim=16, heads=2, seed=0):
    import jax

    from pytorch_distributed_rnn_tpu.models.attention import init_block

    return jax.tree.map(np.asarray, init_block(jax.random.PRNGKey(seed), dim, heads))


def _torch_block(params):
    return {name: {k: torch.from_numpy(np.array(a)) for k, a in p.items()}
            for name, p in params.items()}


def test_block_epilogue_matches_jax():
    """Output projection, residual and the tanh-approximate GELU MLP."""
    from pytorch_distributed_rnn_tpu.models.attention import block_epilogue as jax_epilogue

    params = _jax_block()
    rng = np.random.RandomState(2)
    x = rng.randn(3, 10, 16).astype(np.float32)
    attn = rng.randn(3, 2, 10, 8).astype(np.float32)
    got = tattn.block_epilogue(_torch_block(params), *_torch((x, attn)))
    want = jax_epilogue(params, *_jax((x, attn)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_FWD, atol=F32_FWD)


def test_apply_block_with_injected_attention_matches_jax():
    from pytorch_distributed_rnn_tpu.models.attention import apply_block as jax_apply_block
    from pytorch_distributed_rnn_tpu.ops.attention import mha_attention as jax_mha

    params = _jax_block(seed=4)
    x = np.random.RandomState(3).randn(2, 12, 16).astype(np.float32)
    got = tattn.apply_block(_torch_block(params), torch.from_numpy(x), 2,
                            lambda q, k, v: mha_attention(q, k, v, causal=True))
    want = jax_apply_block(params, _jax((x,))[0], 2,
                           lambda q, k, v: jax_mha(q, k, v, causal=True))
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_FWD, atol=F32_FWD)


def _pair(precision="f32", impl="dense", dim=16, heads=2, depth=2, seed=3):
    import jax

    from pytorch_distributed_rnn_tpu.models import AttentionClassifier as JaxClassifier

    jax_model = JaxClassifier(input_dim=9, dim=dim, depth=depth, num_heads=heads,
                              output_dim=6, precision=precision, impl=impl)
    params = jax_model.init(jax.random.PRNGKey(seed))
    model = AttentionClassifier(input_dim=9, dim=dim, depth=depth, num_heads=heads,
                                output_dim=6, precision=precision, impl=impl)
    model.load_state_dict(interop.jax_params_to_state_dict(params))
    return jax_model, params, model


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_classifier_logits_and_grads_match_jax(precision, impl):
    """dim 16, 2 heads, depth 2, T=16 on weights from the JAX init: logits
    and the gradient of every parameter (the whole position table
    included)."""
    import jax
    import jax.numpy as jnp

    jax_model, params, model = _pair(precision, impl)
    rng = np.random.RandomState(8)
    x = rng.randn(3, 16, 9).astype(np.float32)
    w = rng.randn(3, 6).astype(np.float32)
    fwd_tol = F32_FWD if precision == "f32" else BF16
    grad_tol = F32_GRAD if precision == "f32" else BF16

    logits = model.eval()(torch.from_numpy(x))
    want = jax_model.apply(params, jnp.asarray(x))
    assert logits.dtype == torch.float32 and logits.shape == (3, 6)
    np.testing.assert_allclose(_np(logits), np.asarray(want), rtol=fwd_tol, atol=fwd_tol)

    (logits * torch.from_numpy(w)).sum().backward()
    j_grads = jax.grad(lambda p: jnp.sum(jax_model.apply(p, jnp.asarray(x)) * w))(params)
    j_grads = interop.jax_params_to_state_dict(j_grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), j_grads[name].numpy(), rtol=grad_tol,
                                   atol=grad_tol, err_msg=name)


def test_parameter_names_follow_the_jax_tree():
    jax_model, params, model = _pair(depth=1)
    assert sorted(model.state_dict()) == sorted(interop.jax_params_to_state_dict(params))
    assert model.pos.shape == (4096, 16)
    assert model.blocks[0]["fc1"]["weight"].shape == (64, 16)


def test_interop_round_trip_of_attention_params():
    import jax

    _, params, _ = _pair()
    back = interop.state_dict_to_jax_params(interop.jax_params_to_state_dict(params))
    flat_a, tree_a = jax.tree.flatten(jax.tree.map(np.asarray, params))
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_position_table_is_small_normal_from_the_generator():
    model = AttentionClassifier(dim=32, max_len=512, generator=torch.Generator().manual_seed(5))
    again = AttentionClassifier(dim=32, max_len=512, generator=torch.Generator().manual_seed(5))
    assert torch.equal(model.pos, again.pos)
    assert abs(model.pos.std().item() - 0.02) < 1e-3 and abs(model.pos.mean().item()) < 1e-3


def test_dim_not_divisible_by_heads_raises():
    with pytest.raises(ValueError, match="divisible by num_heads"):
        AttentionClassifier(dim=30, num_heads=4)


def test_dropout_in_train_mode_only():
    model = AttentionClassifier(dim=16, num_heads=2, dropout=0.3)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 9).astype(np.float32))
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        model.train()(x)
    a = model(x, torch.Generator().manual_seed(1))
    b = model(x, torch.Generator().manual_seed(2))
    assert not torch.allclose(a, b)
    model.eval()
    torch.testing.assert_close(model(x), model(x, torch.Generator().manual_seed(1)))


# ---------------------------------------------------------------------------
# the trainer against the JAX trainer, and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_two_epoch_history_matches_jax_trainer(impl):
    import jax

    from pytorch_distributed_rnn_tpu.data import MotionDataset as JaxMotionDataset
    from pytorch_distributed_rnn_tpu.models import AttentionClassifier as JaxClassifier
    from pytorch_distributed_rnn_tpu.training.base import Trainer as JaxTrainer

    arrays = [generate_har_arrays(n, seq_length=16, seed=s) for n, s in ((160, 0), (32, 1), (32, 2))]
    jax_sets = [JaxMotionDataset(*a) for a in arrays]
    jt = JaxTrainer(JaxClassifier(input_dim=9, dim=16, depth=2, num_heads=2, output_dim=6),
                    jax_sets[0], batch_size=64, learning_rate=2.5e-3,
                    validation_set=jax_sets[1], test_set=jax_sets[2], seed=SEED)
    init = jax.tree.map(np.array, jt.params)
    jax_params, jax_train, jax_valid = jt.train(epochs=2)

    train, valid, test = (MotionDataset(*a) for a in arrays)
    model = AttentionClassifier(input_dim=9, dim=16, depth=2, num_heads=2, output_dim=6,
                                impl=impl)
    model.load_state_dict(interop.jax_params_to_state_dict(init))
    trainer = Trainer(model, train, batch_size=64, learning_rate=2.5e-3, validation_set=valid,
                      test_set=test, seed=SEED, device="cpu")
    _, train_history, valid_history = trainer.train(epochs=2)

    np.testing.assert_allclose(train_history, jax_train, rtol=HISTORY_RTOL)
    np.testing.assert_allclose(valid_history, jax_valid, rtol=HISTORY_RTOL)
    want = interop.jax_params_to_state_dict(jax_params)
    steps = 2 * -(-len(train) // 64)
    for name, got in trainer.model.state_dict().items():
        if name.endswith("wk.bias"):
            # its gradient is 0 in exact arithmetic (a key bias shifts a
            # query's scores alike, and softmax ignores the shift), so
            # Adam turns rounding noise into steps of up to lr each
            assert (got - want[name]).abs().max() <= 2.5e-3 * steps, name
        else:
            np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=name)


@pytest.fixture
def cache_dir(tmp_path):
    return write_synthetic_har_cache(tmp_path / "data", num_train=120, num_test=20, seq_length=8)


def test_cli_attention_local_run(cache_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = port_main.main([
        "--device", "cpu", "--model", "attention", "--hidden-units", "8", "--num-heads", "2",
        "--stacked-layer", "1", "--batch-size", "48", "--dropout", "0", "--epochs", "2",
        "--seed", "2", "--dataset-path", str(cache_dir),
        "--checkpoint-directory", str(tmp_path / "models"), "local",
    ])
    history = json.loads((tmp_path / "history.json").read_text())
    assert len(history["train_history"]) == len(history["validation_history"]) == 2
    assert all(np.isfinite(history["train_history"] + history["validation_history"]))
    model = trainer.model
    assert isinstance(model, AttentionClassifier) and len(model.blocks) == 1
    assert (model.num_heads, model.embed["weight"].shape) == (2, (8, 9))
    assert (tmp_path / "models" / "best-model.ckpt").exists()


def test_cli_rejects_dim_not_divisible_by_heads(cache_dir):
    with pytest.raises(ValueError, match="divisible by num_heads"):
        port_main.main(["--device", "cpu", "--dataset-path", str(cache_dir), "--model",
                        "attention", "--hidden-units", "30", "--num-heads", "4", "local"])


# ---------------------------------------------------------------------------
# the CUDA kernels on a card
# ---------------------------------------------------------------------------


def _cuda_rows(bh, t, d, dtype, gen, layout):
    """Random O(1) rows of BH heads on the card: (BH, T, D) (``flat``), or
    in the kernels' (B, T, H, D) layout with H = 2 where BH is even, as a
    view of a (B, T, H*D) projection (``projection``) or of (B, H, T, D)
    storage (``by-head``)."""
    if layout == "flat":
        return torch.randn(bh, t, d, generator=gen, device="cuda").to(dtype)
    heads = 2 if bh % 2 == 0 else 1
    if layout == "projection":
        x = torch.randn(bh // heads, t, heads * d, generator=gen, device="cuda").to(dtype)
        return x.view(bh // heads, t, heads, d)
    x = torch.randn(bh // heads, heads, t, d, generator=gen, device="cuda").to(dtype)
    return x.transpose(1, 2)


def _assert_kernel_close(got, want, tol, dtype):
    """float32 elementwise at ``tol``; bf16 at 1e-2 of the largest value."""
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    else:
        err, peak = (got - want).abs().max().item(), want.abs().max().item()
        assert err <= BF16_KERNEL * peak, (err, peak)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["flat", "projection"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# the CLI shape (D=32), the CLI default width (D=8), the long-context
# head (D=128), a ragged T, cross lengths, causal offsets, a chunk that
# sees no key, the long-context shape causal (the diagonal tiles) and a
# head dim of whole 16-byte chunks but not of whole 16-column k-steps
@pytest.mark.parametrize(
    "bh,t_q,t_k,d,causal,q_offset,k_offset",
    [(64, 128, 128, 32, False, 0, 0), (16, 128, 128, 8, False, 0, 0),
     (8, 300, 300, 128, True, 0, 0), (6, 96, 160, 32, False, 0, 0),
     (6, 64, 64, 16, True, 128, 64), (4, 32, 32, 32, True, 0, 512),
     (5, 77, 200, 100, True, 150, 0), (64, 1024, 1024, 128, True, 0, 0),
     (16, 128, 128, 72, False, 0, 0)],
)
def test_cuda_kernels_match_plain_versions(bh, t_q, t_k, d, causal, q_offset, k_offset, dtype,
                                           layout):
    """Every kernel against its plain version, on (BH, T, D) rows and on
    the (B, T, H, D) views of projections (dO then in another layout, the
    (B, H, T, D) storage's: each tensor is read by its own strides)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")

    def assert_kernel_close(got, want, tol):
        assert got.shape == want.shape and got.stride() == want.stride()
        _assert_kernel_close(got, want, tol, dtype)

    gen = torch.Generator(device="cuda").manual_seed(bh * t_q + d)
    q, k, v = (_cuda_rows(bh, t, d, dtype, gen, layout) for t in (t_q, t_k, t_k))
    do = _cuda_rows(bh, t_q, d, dtype, gen, "flat" if layout == "flat" else "by-head")
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, **kw)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
    assert_kernel_close(o, o_p, F32_FWD)
    torch.testing.assert_close(lse, lse_p, rtol=F32_FWD, atol=F32_FWD)
    delta = fa._delta(do, o_p)
    args = (q, k, v, do, lse_p, delta)
    assert_kernel_close(fa.flash_dq(*args, **kw), fa.flash_dq_plain(*args, **kw), F32_GRAD)
    for got, want in zip(fa.flash_dkv(*args, **kw), fa.flash_dkv_plain(*args, **kw)):
        assert_kernel_close(got, want, F32_GRAD)
    fused = fa.flash_bwd_route(t_q, t_k, d, dtype) == "dqkv"
    if fused:
        fused_args = (q, k, v, o_p, do, lse_p)
        for got, want in zip(fa.flash_dqkv(*fused_args, **kw),
                             fa.flash_dqkv_plain(*fused_args, **kw)):
            assert_kernel_close(got, want, F32_GRAD)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1,
                           "flash_dqkv": int(fused)}


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["none", "causal-offsets", "no-visible-key"])
@pytest.mark.parametrize("d", [1, 8, 31, 32, 64, 100, 128])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 128, 200, 1024])
def test_cuda_f32_forward_edges_match_plain(t, d, mask):
    """The float32 forward (3xTF32 on the tensor cores) against its plain
    version at the edges of its tiles (T around the 64-key tile and the
    128-row block, D padded to 16, 32, 64, 128, unaligned rows at D=1, 31,
    100), on the (B, T, H, D) views of projections, causal with offsets and
    a chunk with no visible key (o = 0, lse = -inf)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(t * 131 + d)
    q, k, v = (_cuda_rows(4, t, d, torch.float32, gen, "projection") for _ in range(3))
    kw = {"none": dict(causal=False), "causal-offsets": dict(causal=True, q_offset=37, k_offset=5),
          "no-visible-key": dict(causal=True, q_offset=0, k_offset=t)}[mask]
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, **kw)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] == 1 and o.stride() == q.stride()
    _assert_kernel_close(o, o_p, F32_FWD, torch.float32)
    torch.testing.assert_close(lse, lse_p, rtol=F32_FWD, atol=F32_FWD)
    if mask == "no-visible-key":
        assert torch.equal(o, torch.zeros_like(o)) and torch.isneginf(lse).all()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bh,t_q,t_k,d,causal,q_offset,k_offset",
    [(1024, 128, 128, 32, False, 0, 0), (16, 77, 100, 30, True, 40, 0),
     (16, 128, 128, 64, False, 0, 0)],
)
def test_cuda_dqkv_is_bitwise_repeatable(bh, t_q, t_k, d, causal, q_offset, k_offset):
    """``flash_dqkv`` has one writer for every output element and no
    atomics: two launches on the same inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(t_q + t_k + d)
    q, do = (torch.randn(bh, t_q, d, generator=gen, device="cuda") for _ in range(2))
    k, v = (torch.randn(bh, t_k, d, generator=gen, device="cuda") for _ in range(2))
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)
    o, lse = fa.flash_fwd_plain(q, k, v, **kw)
    first = fa.flash_dqkv(q, k, v, o, do, lse, **kw)
    second = fa.flash_dqkv(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
