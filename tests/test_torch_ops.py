"""The PyTorch port's ops against the JAX package's, on the CPU.

Same numpy inputs (seeded) through both; tolerances are stated per test:
f32 forward 1e-5 and gradients 1e-4, bf16 5e-2 (the JAX package's own
kernel-test tolerances).  TF32 never applies here (CPU).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu.ops import losses as jlosses
from pytorch_distributed_rnn_tpu.ops import rnn as jrnn
from pytorch_distributed_rnn_tpu_torch.ops import initializers as tinit
from pytorch_distributed_rnn_tpu_torch.ops import losses as tlosses
from pytorch_distributed_rnn_tpu_torch.ops import rnn as trnn

F32_FWD, F32_GRAD, BF16 = 1e-5, 1e-4, 5e-2


def _layer(rng, cell, in_dim, hidden):
    gates = (4 if cell == "lstm" else 3) * hidden
    bound = 1.0 / math.sqrt(hidden)
    shapes = {"w_ih": (gates, in_dim), "w_hh": (gates, hidden),
              "b_ih": (gates,), "b_hh": (gates,)}
    return {k: rng.uniform(-bound, bound, s).astype(np.float32) for k, s in shapes.items()}


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype=torch.float32, grad=False):
    return {k: torch.tensor(v, dtype=dtype, requires_grad=grad) for k, v in tree.items()}


def _np(t):
    return np.asarray(t.detach().float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hidden", [8, 32, 128])
def test_lstm_uniform_bounds_and_moments(hidden):
    gen = torch.Generator().manual_seed(hidden)
    w = tinit.lstm_uniform(gen, (200_000,), hidden)
    k = 1.0 / math.sqrt(hidden)
    assert w.dtype == torch.float32
    assert w.abs().max().item() <= k
    # U(-k, k): mean 0, variance k^2 / 3; 200k samples -> ~0.4% noise
    assert abs(w.mean().item()) < 0.01 * k
    assert abs(w.var().item() / (k * k / 3.0) - 1.0) < 0.02


@pytest.mark.parametrize("in_features,out_features", [(32, 6), (9, 128)])
def test_linear_init_matches_torch_default_distribution(in_features, out_features):
    gen = torch.Generator().manual_seed(0)
    p = tinit.linear_init(gen, in_features, out_features)
    assert p["weight"].shape == (out_features, in_features)
    assert p["bias"].shape == (out_features,)
    bound = 1.0 / math.sqrt(in_features)
    for t in p.values():
        assert t.abs().max().item() <= bound


def test_initializers_draw_from_the_generator_only():
    a = tinit.lstm_uniform(torch.Generator().manual_seed(5), (64,), 16)
    torch.manual_seed(123)  # the global RNG must not matter
    b = tinit.lstm_uniform(torch.Generator().manual_seed(5), (64,), 16)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(reduction):
    rng = np.random.RandomState(0)
    logits = rng.randn(37, 6).astype(np.float32) * 3
    labels = rng.randint(0, 6, 37)
    got = tlosses.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), reduction)
    want = jlosses.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), reduction)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_FWD, atol=F32_FWD)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_mse_matches_jax(reduction):
    rng = np.random.RandomState(1)
    a, b = rng.randn(2, 5, 7).astype(np.float32)
    got = tlosses.mse_loss(torch.from_numpy(a), torch.from_numpy(b), reduction)
    want = jlosses.mse_loss(jnp.asarray(a), jnp.asarray(b), reduction)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_FWD, atol=F32_FWD)


def test_unknown_reduction_raises():
    with pytest.raises(ValueError, match="reduction"):
        tlosses.mse_loss(torch.zeros(2), torch.zeros(2), "avg")


# ---------------------------------------------------------------------------
# input projections and layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_input_proj_matches_jax(cell):
    rng = np.random.RandomState(2)
    p = _layer(rng, cell, 9, 16)
    x = rng.randn(5, 11, 9).astype(np.float32)
    tfn = trnn.lstm_input_proj if cell == "lstm" else trnn.gru_input_proj
    jfn = jrnn.lstm_input_proj if cell == "lstm" else jrnn.gru_input_proj
    got = tfn(_torch(p), torch.from_numpy(x))
    want = jfn(_jax(p), jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_FWD, atol=F32_FWD)


def _layer_case(cell, dtype_name, seed=3, batch=6, seq=13, in_dim=9, hidden=16):
    rng = np.random.RandomState(seed)
    p = _layer(rng, cell, in_dim, hidden)
    x = rng.randn(batch, seq, in_dim).astype(np.float32)
    tdt = torch.float32 if dtype_name == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype_name == "f32" else jnp.bfloat16
    return p, x, tdt, jdt


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_layer_forward_matches_jax(cell, dtype_name):
    p, x, tdt, jdt = _layer_case(cell, dtype_name)
    tol = F32_FWD if dtype_name == "f32" else BF16
    tfn = trnn.lstm_layer if cell == "lstm" else trnn.gru_layer
    jfn = jrnn.lstm_layer if cell == "lstm" else jrnn.gru_layer
    t_out, t_fin = tfn(_torch(p, tdt), torch.tensor(x, dtype=tdt))
    j_out, j_fin = jfn(_jax(p, jdt), jnp.asarray(x, jdt))
    assert t_out.dtype == tdt
    np.testing.assert_allclose(_np(t_out), _np(j_out), rtol=tol, atol=tol)
    t_fin = t_fin if cell == "lstm" else (t_fin,)
    j_fin = j_fin if cell == "lstm" else (j_fin,)
    for a, b in zip(t_fin, j_fin):
        np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


# the motion width (2 x 32) through the fused GRU, whose forward saves r, z,
# n and h_n there for its backward to read: the stack's outputs and every
# gradient against the JAX fused stack (Pallas interpret mode), on a batch
# that is no whole number of 4-row quads
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_stacked_fused_gru_at_h32_matches_jax(dtype_name):
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as tfr

    rng = np.random.RandomState(12)
    layers = [_layer(rng, "gru", 9, 32), _layer(rng, "gru", 32, 32)]
    x = rng.randn(7, 10, 9).astype(np.float32)
    tdt = None if dtype_name == "f32" else torch.bfloat16
    jdt = None if dtype_name == "f32" else jnp.bfloat16
    fwd_tol, grad_tol = (F32_FWD, F32_GRAD) if dtype_name == "f32" else (BF16, BF16)
    assert tfr.gru_saves_gates(32)
    t_layers = [_torch(l, grad=True) for l in layers]
    tx = torch.tensor(x, requires_grad=True)
    t_out, _ = trnn.stacked_rnn(t_layers, tx, "gru", impl="fused", compute_dtype=tdt)
    (t_out.float() ** 2).sum().backward()

    def loss(ls, xx):
        out, _ = jrnn.stacked_rnn(ls, xx, "gru", impl="fused", compute_dtype=jdt)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, j_out), (j_layers, j_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        [_jax(l) for l in layers], jnp.asarray(x))
    np.testing.assert_allclose(_np(t_out), _np(j_out), rtol=fwd_tol, atol=fwd_tol)
    for t_l, j_l in zip(t_layers, j_layers):
        for name in t_l:
            np.testing.assert_allclose(_np(t_l[name].grad), _np(j_l[name]), rtol=grad_tol,
                                       atol=grad_tol, err_msg=name)
    np.testing.assert_allclose(_np(tx.grad), _np(j_x), rtol=grad_tol, atol=grad_tol)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_layer_gradients_match_jax(cell):
    p, x, _, _ = _layer_case(cell, "f32", seed=4)
    tfn = trnn.lstm_layer if cell == "lstm" else trnn.gru_layer
    jfn = jrnn.lstm_layer if cell == "lstm" else jrnn.gru_layer
    tp = _torch(p, grad=True)
    tx = torch.tensor(x, requires_grad=True)
    out, _ = tfn(tp, tx)
    (out ** 2).sum().backward()

    def loss(params, xx):
        o, _ = jfn(params, xx)
        return jnp.sum(o ** 2)

    jp, jx = jax.grad(loss, argnums=(0, 1))(_jax(p), jnp.asarray(x))
    for name in p:
        np.testing.assert_allclose(_np(tp[name].grad), _np(jp[name]),
                                   rtol=F32_GRAD, atol=F32_GRAD, err_msg=name)
    np.testing.assert_allclose(_np(tx.grad), _np(jx), rtol=F32_GRAD, atol=F32_GRAD)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_stacked_rnn_matches_jax(cell, dtype_name):
    rng = np.random.RandomState(5)
    layers = [_layer(rng, cell, 9, 16), _layer(rng, cell, 16, 16)]
    x = rng.randn(4, 10, 9).astype(np.float32)
    tdt = None if dtype_name == "f32" else torch.bfloat16
    jdt = None if dtype_name == "f32" else jnp.bfloat16
    tol = F32_FWD if dtype_name == "f32" else BF16
    t_out, _ = trnn.stacked_rnn([_torch(l) for l in layers], torch.from_numpy(x), cell,
                                impl="scan", compute_dtype=tdt)
    j_out, _ = jrnn.stacked_rnn([_jax(l) for l in layers], jnp.asarray(x), cell,
                                impl="scan", compute_dtype=jdt)
    np.testing.assert_allclose(_np(t_out), _np(j_out), rtol=tol, atol=tol)


def test_dtype_of_matches_jax_mapping():
    assert trnn.dtype_of("bf16") is torch.bfloat16
    assert trnn.dtype_of("f32") is None
    assert jrnn.dtype_of("bf16") == jnp.bfloat16 and jrnn.dtype_of("f32") is None


# ---------------------------------------------------------------------------
# impl resolution and dropout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "impl,cell,hidden,device,want",
    [
        ("auto", "lstm", 32, "cpu", "scan"),
        ("auto", "lstm", 32, "cuda", "fused"),
        ("auto", "lstm", 110, "cuda", "fused"),  # one block
        ("auto", "lstm", 512, "cuda", "fused"),  # over a cluster
        ("auto", "lstm", 513, "cuda", "scan"),  # past the kernels' range
        ("auto", "lstm", 1280, "cuda", "scan"),
        ("auto", "gru", 32, "cuda", "fused"),  # W_hh^T in registers
        ("auto", "gru", 512, "cuda", "fused"),  # over a cluster
        ("auto", "gru", 513, "cuda", "scan"),
        ("auto", "gru", 512, "cpu", "scan"),
        ("fused", "lstm", 32, "cpu", "fused"),
        ("fused", "gru", 32, "cpu", "fused"),
        ("scan", "lstm", 32, "cuda", "scan"),
        # explicit fused on the CPU at any width: the plain versions take it
        ("fused", "lstm", 128, "cpu", "fused"),
        ("fused", "gru", 513, "cpu", "fused"),
    ],
)
def test_resolve_rnn_impl(impl, cell, hidden, device, want):
    assert trnn.resolve_rnn_impl(impl, cell, hidden, torch.device(device)) == want


# explicit fused past the kernels' widths raises on the card (no quiet
# fallback); resolve_rnn_impl reads only the device's type, so no card is
# needed to check it
@pytest.mark.parametrize(
    "impl,cell,hidden",
    [("fused", "gru", 513), ("fused", "lstm", 1280), ("bogus", "lstm", 32), ("auto", "rnn", 32)],
)
def test_resolve_rnn_impl_rejects(impl, cell, hidden):
    device = "cuda" if impl == "fused" else "cpu"
    with pytest.raises(ValueError):
        trnn.resolve_rnn_impl(impl, cell, hidden, torch.device(device))


@pytest.mark.parametrize("cell,hidden", [("lstm", 513), ("gru", 513)])
def test_resolve_rnn_impl_unknown_device_keeps_the_width_check(cell, hidden):
    with pytest.raises(ValueError, match="no fused"):
        trnn.resolve_rnn_impl("fused", cell, hidden)


# fault C1: explicit fused on the CPU returns the JAX fused path's outputs
# (there in Pallas interpret mode), also at a width the card's kernels do
# not take (GRU 513)
@pytest.mark.parametrize("cell,hidden", [("lstm", 128), ("gru", 513)])
def test_explicit_fused_past_the_kernel_widths_matches_jax_on_cpu(cell, hidden):
    rng = np.random.RandomState(11)
    layers = [_layer(rng, cell, 9, hidden)]
    x = rng.randn(3, 5, 9).astype(np.float32)
    t_out, t_fin = trnn.stacked_rnn([_torch(l) for l in layers], torch.from_numpy(x), cell,
                                    impl="fused")
    j_out, j_fin = jrnn.stacked_rnn([_jax(l) for l in layers], jnp.asarray(x), cell,
                                    impl="fused")
    assert t_out.shape == (3, 5, hidden)
    np.testing.assert_allclose(_np(t_out), _np(j_out), rtol=F32_FWD, atol=F32_FWD)
    t_states = t_fin[0] if cell == "lstm" else (t_fin[0],)
    j_states = j_fin[0] if cell == "lstm" else (j_fin[0],)
    for got, want in zip(t_states, j_states):
        np.testing.assert_allclose(_np(got), _np(want), rtol=F32_FWD, atol=F32_FWD)


def test_interlayer_dropout_statistics():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(400, 500)
    y = trnn.interlayer_dropout(x, gen, 0.25)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1.0 / 0.75))


def test_stacked_rnn_dropout_only_with_generator():
    rng = np.random.RandomState(6)
    layers = [_torch(_layer(rng, "lstm", 9, 8)), _torch(_layer(rng, "lstm", 8, 8))]
    x = torch.from_numpy(rng.randn(3, 5, 9).astype(np.float32))
    plain, _ = trnn.stacked_rnn(layers, x, impl="scan")
    evald, _ = trnn.stacked_rnn(layers, x, dropout=0.5, impl="scan")
    assert torch.equal(plain, evald)
    a, _ = trnn.stacked_rnn(layers, x, dropout=0.5, generator=torch.Generator().manual_seed(1),
                            impl="scan")
    b, _ = trnn.stacked_rnn(layers, x, dropout=0.5, generator=torch.Generator().manual_seed(1),
                            impl="scan")
    assert torch.equal(a, b) and not torch.equal(a, plain)
