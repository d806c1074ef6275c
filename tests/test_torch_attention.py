"""The port's attention family against the JAX package's, on the CPU.

``ops/fused_attention.py`` (the flash kernels' plain versions, the
``FlashAttention`` binding and ``flash_attention``) against the JAX
``flash_attention`` in Pallas interpret mode and the JAX kernels' own
``_fwd_impl``/``_bwd_impl``, and against ``mha_attention``;
``ops/attention.py:mha_attention``; ``models/attention.py`` (layer norm,
the GELU epilogue, ``AttentionClassifier`` forward and gradients with
weights carried over by ``interop``); a two-epoch ``local`` loss history
against the JAX trainer from the same initial weights (rtol 1e-4, as
``test_torch_training.py``); the CLI's ``--model attention`` handling.
Tolerances: the JAX attention tests' (f32 1e-5 forward, gradients rtol
1e-4 / atol 1e-5, bf16 2e-2) for the attention functions, the JAX model
tests' (f32 1e-5 forward and 1e-4 gradients, bf16 5e-2) for the model.

The ``cuda``-marked tests hold the CUDA kernels against the plain
versions on a card (bf16 there at 1e-2 of each output's largest value)
and skip without one; JAX is imported inside the tests that use it, so
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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "causal,q_offset,k_offset,t,d",
    [pytest.param(False, 0, 0, 100, 16, id="False-0-0"),
     pytest.param(True, 32, 0, 100, 16, id="True-32-0"),
     # a head dim of whole 16-byte chunks but not of whole 16-column
     # k-steps (the card's bf16 kernels pad it in shared memory), over two
     # JAX blocks
     pytest.param(False, 0, 0, 200, 72, id="False-0-0-T200-D72"),
     pytest.param(True, 32, 0, 200, 72, id="True-32-0-T200-D72")],
)
def test_plain_versions_match_jax_kernels(dtype, causal, q_offset, k_offset, t, d):
    """``flash_{fwd,dq,dkv}_plain`` against the JAX kernels themselves
    (``_fwd_impl``, ``_bwd_impl``, lse and delta lane-replicated there),
    at a ragged length padded to the JAX blocks."""
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
    tq, tk, tv, tdo = _torch((q, k, v, do), dtype)
    o, lse = fa.flash_fwd_plain(tq, tk, tv, causal, q_offset, k_offset)
    np.testing.assert_allclose(_np(o), _np(j_o[:, :t]), rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse[:, :t, 0]), rtol=tol, atol=tol)

    j_delta = jpa._delta_of(jdo, j_o)
    j_dq, j_dk, j_dv = jpa._bwd_impl(jq, jk, jv, jdo, j_lse, j_delta, offs, causal, blk, blk,
                                     t, t)
    delta = (tdo.float() * o.float()).sum(-1)
    dq = fa.flash_dq_plain(tq, tk, tv, tdo, lse, delta, causal, q_offset, k_offset)
    dk, dv = fa.flash_dkv_plain(tq, tk, tv, tdo, lse, delta, causal, q_offset, k_offset)
    assert dq.dtype == dk.dtype == dv.dtype == tq.dtype
    for name, got, want in (("dq", dq, j_dq), ("dk", dk, j_dk), ("dv", dv, j_dv)):
        np.testing.assert_allclose(_np(got), _np(want[:, :t]), rtol=tol * 10, atol=tol,
                                   err_msg=name)


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


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_dq", "flash_dkv"])
def test_wrappers_reject_devices_other_than_cpu_and_cuda(kernel):
    q = torch.zeros(2, 5, 8, device="meta")
    rows = torch.zeros(2, 5, device="meta")
    args = (q, q, q) if kernel == "flash_fwd" else (q, q, q, q, rows, rows)
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


@pytest.mark.cuda
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
def test_cuda_kernels_match_plain_versions(bh, t_q, t_k, d, causal, q_offset, k_offset, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")

    def assert_kernel_close(got, want, tol):
        got, want = got.float(), want.float()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        else:
            err, peak = (got - want).abs().max().item(), want.abs().max().item()
            assert err <= BF16_KERNEL * peak, (err, peak)

    gen = torch.Generator(device="cuda").manual_seed(bh * t_q + d)

    def rand(t):
        return torch.randn(bh, t, d, generator=gen, device="cuda").to(dtype)

    q, k, v, do = rand(t_q), rand(t_k), rand(t_k), rand(t_q)
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, **kw)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
    assert_kernel_close(o, o_p, F32_FWD)
    torch.testing.assert_close(lse, lse_p, rtol=F32_FWD, atol=F32_FWD)
    delta = (do.float() * o_p.float()).sum(-1)
    args = (q, k, v, do, lse_p, delta)
    assert_kernel_close(fa.flash_dq(*args, **kw), fa.flash_dq_plain(*args, **kw), F32_GRAD)
    for got, want in zip(fa.flash_dkv(*args, **kw), fa.flash_dkv_plain(*args, **kw)):
        assert_kernel_close(got, want, F32_GRAD)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
