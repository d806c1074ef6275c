"""The port's fused GRU (the GRU half of ``ops/fused_rnn.py``) against the
JAX package's ``fused_gru_scan`` / ``gru_layer_fused``.

On the CPU the port's wrappers take the kernels' plain versions; the JAX
fused GRU runs its Pallas bodies in interpret mode, as its own tests do.
Tolerances are the JAX kernel tests': f32 1e-5 forward and 1e-4
gradients, bf16 5e-2.  The ``cuda``-marked test holds the CUDA kernels
against the plain versions on a card (bf16 there at 1e-2 of each output's
largest value) and skips without one; JAX is imported inside the tests
that use it, so on a card (where JAX is not installed) it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_gru.py
"""

import math

import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr
from pytorch_distributed_rnn_tpu_torch.ops import rnn as trnn

F32_FWD, F32_GRAD, BF16 = 1e-5, 1e-4, 5e-2
BF16_KERNEL = 1e-2  # of each output's largest value: one bf16 ulp is 2^-7 of it
NAMES = ("w_ih", "w_hh", "b_ih", "b_hh")


def _tol(dtype_name, f32):
    return f32 if dtype_name == "f32" else BF16


def _dtypes(dtype_name):
    import jax.numpy as jnp

    if dtype_name == "f32":
        return torch.float32, jnp.float32
    return torch.bfloat16, jnp.bfloat16


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype("float32"))


def _scan_case(batch, seq=9, hidden=8, seed=0):
    """Kernel-level inputs: x_proj (T, B, 3H), W_hh^T, b_hh, a nonzero h0,
    and O(1) cotangents for h_all and h_T."""
    rng = np.random.RandomState(seed)
    bound = 1.0 / math.sqrt(hidden)
    return {
        "x_proj": rng.randn(seq, batch, 3 * hidden).astype(np.float32),
        "w_hh_t": rng.uniform(-bound, bound, (hidden, 3 * hidden)).astype(np.float32),
        "b_hh": rng.uniform(-bound, bound, (3 * hidden,)).astype(np.float32),
        "h0": (0.5 * rng.randn(batch, hidden)).astype(np.float32),
        "dh_all": rng.randn(seq, batch, hidden).astype(np.float32),
        "dh_T": rng.randn(batch, hidden).astype(np.float32),
    }


def _layer_case(batch, seq=12, in_dim=9, hidden=16, seed=0):
    rng = np.random.RandomState(seed)
    bound = 1.0 / math.sqrt(hidden)
    shapes = {"w_ih": (3 * hidden, in_dim), "w_hh": (3 * hidden, hidden),
              "b_ih": (3 * hidden,), "b_hh": (3 * hidden,)}
    params = {k: rng.uniform(-bound, bound, s).astype(np.float32) for k, s in shapes.items()}
    x = rng.randn(batch, seq, in_dim).astype(np.float32)
    h0 = (0.5 * rng.randn(batch, hidden)).astype(np.float32)
    return params, x, h0


# ---------------------------------------------------------------------------
# the kernels' plain versions and the autograd binding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("batch", [5, 8])
def test_plain_versions_match_jax_kernels(batch, dtype_name):
    """``gru_fwd_plain``/``gru_bwd_plain`` against the Pallas bodies of
    ``_gru_fwd_pallas``/``_gru_bwd_pallas``: h_all, and dx_proj, dhgates,
    dh0 from the same stored h_all."""
    import jax.numpy as jnp

    from pytorch_distributed_rnn_tpu.ops.pallas_rnn import _gru_bwd_pallas, _gru_fwd_pallas

    tdt, jdt = _dtypes(dtype_name)
    c = _scan_case(batch, seed=batch)
    j = {k: jnp.asarray(v, jdt) for k, v in c.items()}
    t = {k: torch.tensor(v, dtype=tdt) for k, v in c.items()}
    j_h = _gru_fwd_pallas(j["x_proj"], j["h0"], j["w_hh_t"], j["b_hh"][None], block_b=batch)
    t_h = fr.gru_fwd_plain(t["x_proj"], t["h0"], t["w_hh_t"], t["b_hh"])
    assert t_h.dtype == tdt and t_h.shape == (9, batch, 8)
    tol = _tol(dtype_name, F32_FWD)
    np.testing.assert_allclose(_f32(t_h), _f32(j_h), rtol=tol, atol=tol)

    j_out = _gru_bwd_pallas(j["x_proj"], j_h, j["h0"], j["w_hh_t"], j["b_hh"][None],
                            j["dh_all"], j["dh_T"], block_b=batch)
    # both sweeps read the JAX forward's stored h_all
    t_out = fr.gru_bwd_plain(t["x_proj"], torch.tensor(_f32(j_h), dtype=tdt), t["h0"],
                             t["w_hh_t"], t["b_hh"], t["dh_all"], t["dh_T"])
    tol = _tol(dtype_name, F32_GRAD)
    for got, want, name in zip(t_out, j_out, ("dx_proj", "dhgates", "dh0")):
        assert got.dtype == tdt
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("batch", [5, 8])
def test_fused_scan_vjp_matches_jax(batch, dtype_name):
    """``FusedGRUScan`` outputs and every cotangent (x_proj, W_hh^T, b_hh,
    h0) against ``jax.vjp`` of ``fused_gru_scan``."""
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_rnn_tpu.ops.pallas_rnn import fused_gru_scan

    tdt, jdt = _dtypes(dtype_name)
    c = _scan_case(batch, seed=10 + batch)
    j = {k: jnp.asarray(v, jdt) for k, v in c.items()}
    (j_h, j_hT), vjp = jax.vjp(
        lambda xp, w, b, h0: fused_gru_scan(xp, w, b, h0, batch),
        j["x_proj"], j["w_hh_t"], j["b_hh"][None], j["h0"],
    )
    j_grads = vjp((j["dh_all"], j["dh_T"]))

    inputs = [torch.tensor(c[k], dtype=tdt, requires_grad=True)
              for k in ("x_proj", "w_hh_t", "b_hh", "h0")]
    t_h, t_hT = fr.FusedGRUScan.apply(*inputs)
    t_grads = torch.autograd.grad(
        (t_h, t_hT), inputs,
        (torch.tensor(c["dh_all"], dtype=tdt), torch.tensor(c["dh_T"], dtype=tdt)),
    )
    fwd_tol, grad_tol = _tol(dtype_name, F32_FWD), _tol(dtype_name, F32_GRAD)
    for got, want in ((t_h, j_h), (t_hT, j_hT)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=fwd_tol, atol=fwd_tol)
    for got, want, name in zip(t_grads, j_grads, ("x_proj", "w_hh_t", "b_hh", "h0")):
        assert got.dtype == tdt
        np.testing.assert_allclose(_f32(got).reshape(np.shape(want)), _f32(want),
                                   rtol=grad_tol, atol=grad_tol, err_msg=name)


@pytest.mark.parametrize("batch", [4, 11])
def test_plain_backward_is_the_gradient_of_plain_forward(batch):
    """``gru_bwd_plain`` (hand-derived) plus the wrapper's dW/db against
    autograd through ``gru_fwd_plain``."""
    gen = torch.Generator().manual_seed(batch)
    t, h = 7, 6
    x_proj = torch.randn(t, batch, 3 * h, generator=gen, requires_grad=True)
    h0 = torch.randn(batch, h, generator=gen, requires_grad=True)
    w = (0.3 * torch.randn(h, 3 * h, generator=gen)).requires_grad_(True)
    b = (0.1 * torch.randn(3 * h, generator=gen)).requires_grad_(True)
    dh_all, dh_t = torch.randn(t, batch, h, generator=gen), torch.randn(batch, h, generator=gen)
    h_all = fr.gru_fwd_plain(x_proj, h0, w, b)
    loss = (h_all * dh_all).sum() + (h_all[-1] * dh_t).sum()
    auto = torch.autograd.grad(loss, (x_proj, w, b, h0))
    h_all, h_t = fr.FusedGRUScan.apply(x_proj, w, b, h0)
    fused = torch.autograd.grad((h_all, h_t), (x_proj, w, b, h0), (dh_all, dh_t))
    for got, want, name in zip(fused, auto, ("x_proj", "w_hh_t", "b_hh", "h0")):
        torch.testing.assert_close(got, want, rtol=F32_GRAD, atol=F32_GRAD, msg=name)


# ---------------------------------------------------------------------------
# layers, stacks and the motion model
# ---------------------------------------------------------------------------


# batch 12: the JAX picker's one tile; batch 13: ragged against the port's 16-row tile
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("batch", [12, 13])
def test_fused_layer_forward_and_grads_match_jax(batch, dtype_name):
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_rnn_tpu.ops.pallas_rnn import gru_layer_fused as j_fused

    tdt, jdt = _dtypes(dtype_name)
    params, x, h0 = _layer_case(batch, seed=batch)
    tp = {k: torch.tensor(v, dtype=tdt, requires_grad=True) for k, v in params.items()}
    tx, th0 = (torch.tensor(a, dtype=tdt, requires_grad=True) for a in (x, h0))
    t_out, t_h = fr.gru_layer_fused(tp, tx, th0)
    assert t_out.dtype == tdt and t_out.shape == (batch, 12, 16)
    ((t_out.float() ** 2).sum() + (t_h.float() * th0.float()).sum()).backward()

    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    jx, jh0 = jnp.asarray(x, jdt), jnp.asarray(h0, jdt)

    def loss(p, xx, hh):
        out, h = j_fused(p, xx, hh)
        f32 = jnp.float32
        return jnp.sum(out.astype(f32) ** 2) + jnp.sum(h.astype(f32) * hh.astype(f32))

    j_out, j_h = j_fused(jp, jx, jh0)
    grads = jax.grad(loss, argnums=(0, 1, 2))(jp, jx, jh0)
    fwd_tol, grad_tol = _tol(dtype_name, F32_FWD), _tol(dtype_name, F32_GRAD)
    for got, want in ((t_out, j_out), (t_h, j_h)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=fwd_tol, atol=fwd_tol)
    for name in NAMES:
        np.testing.assert_allclose(_f32(tp[name].grad), _f32(grads[0][name]),
                                   rtol=grad_tol, atol=grad_tol, err_msg=name)
    for got, want, name in ((tx, grads[1], "x"), (th0, grads[2], "h0")):
        np.testing.assert_allclose(_f32(got.grad), _f32(want), rtol=grad_tol, atol=grad_tol,
                                   err_msg=name)


def test_fused_layer_default_state_matches_scan_layer():
    params, x, _ = _layer_case(7, seed=3)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    out_f, h_f = fr.gru_layer_fused(tp, torch.from_numpy(x))
    out_s, h_s = trnn.gru_layer(tp, torch.from_numpy(x))
    torch.testing.assert_close(out_f, out_s, rtol=F32_FWD, atol=F32_FWD)
    torch.testing.assert_close(h_f, h_s, rtol=F32_FWD, atol=F32_FWD)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_stacked_fused_gru_matches_jax(dtype_name):
    import jax.numpy as jnp

    from pytorch_distributed_rnn_tpu.ops import rnn as jrnn

    tdt, jdt = _dtypes(dtype_name)
    rng = np.random.RandomState(5)
    layers = [_layer_case(1, in_dim=9, seed=6)[0], _layer_case(1, in_dim=16, seed=7)[0]]
    x = rng.randn(6, 10, 9).astype(np.float32)
    t_out, t_fin = trnn.stacked_rnn(
        [{k: torch.from_numpy(v) for k, v in lay.items()} for lay in layers],
        torch.from_numpy(x), "gru", impl="fused",
        compute_dtype=None if dtype_name == "f32" else tdt)
    j_out, j_fin = jrnn.stacked_rnn(
        [{k: jnp.asarray(v) for k, v in lay.items()} for lay in layers],
        jnp.asarray(x), "gru", impl="fused",
        compute_dtype=None if dtype_name == "f32" else jdt)
    tol = _tol(dtype_name, F32_FWD)
    np.testing.assert_allclose(_f32(t_out), _f32(j_out), rtol=tol, atol=tol)
    for got, want in zip(t_fin, j_fin):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_motion_gru_logits_and_grads_match_jax(dtype_name):
    """``MotionModel(cell="gru", impl="fused")`` against the JAX model on
    copied weights: logits and every parameter gradient of a CE loss."""
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_rnn_tpu.models.motion import MotionModel as JaxMotionModel
    from pytorch_distributed_rnn_tpu.ops.losses import cross_entropy_loss as j_ce
    from pytorch_distributed_rnn_tpu_torch import interop
    from pytorch_distributed_rnn_tpu_torch.models import MotionModel
    from pytorch_distributed_rnn_tpu_torch.ops.losses import cross_entropy_loss

    precision = "f32" if dtype_name == "f32" else "bf16"
    jax_model = JaxMotionModel(hidden_dim=16, layer_dim=2, cell="gru", impl="fused",
                               precision=precision)
    params = jax_model.init(jax.random.PRNGKey(4))
    model = MotionModel(hidden_dim=16, layer_dim=2, cell="gru", impl="fused",
                        precision=precision)
    model.load_state_dict(interop.jax_params_to_state_dict(params))
    rng = np.random.RandomState(8)
    x = rng.randn(7, 14, 9).astype(np.float32)
    y = rng.randint(0, 6, 7)

    logits = model.eval()(torch.from_numpy(x))
    cross_entropy_loss(logits, torch.from_numpy(y)).backward()

    def loss(p):
        return j_ce(jax_model.apply(p, jnp.asarray(x)), jnp.asarray(y))

    j_logits = jax_model.apply(params, jnp.asarray(x))
    j_grads = interop.jax_params_to_state_dict(jax.grad(loss)(params))
    fwd_tol, grad_tol = _tol(dtype_name, F32_FWD), _tol(dtype_name, F32_GRAD)
    assert logits.dtype == torch.float32 and logits.shape == (7, 6)
    np.testing.assert_allclose(_f32(logits), _f32(j_logits), rtol=fwd_tol, atol=fwd_tol)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(_f32(p.grad), j_grads[name].numpy(), rtol=grad_tol,
                                   atol=grad_tol, err_msg=name)


# ---------------------------------------------------------------------------
# wrappers: CPU path, supported widths, argument checks
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    fr.reset_launch_counts()
    params, x, _ = _layer_case(4, seed=1)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    out, _ = fr.gru_layer_fused(tp, torch.from_numpy(x))
    out.sum().backward()
    assert not any(fr.LAUNCHES.values()), fr.LAUNCHES


@pytest.mark.parametrize(
    "hidden,ok",
    [(1, True), (32, True), (126, True), (127, True), (512, True), (513, False), (0, False)],
)
def test_gru_kernel_supports(hidden, ok):
    assert fr.gru_kernel_supports(hidden) is ok


# the forward's dispatch rule: W_hh^T and the backward's 16-row tile state
# fit one block's shared memory up to H=126; wider layers run over a
# 16-CTA cluster on 8-row tiles
@pytest.mark.parametrize(
    "hidden,tile", [(1, (16, "smem")), (32, (16, "smem")), (126, (16, "smem")),
                    (127, (8, "cluster")), (512, (8, "cluster")), (300, (8, "cluster"))],
)
def test_gru_tile(hidden, tile):
    assert fr.gru_tile(hidden) == tile


# the backward's dispatch rule: one block with all of W_hh^T in its shared
# memory up to H=126, a 16-CTA cluster on 4-row tiles above it
@pytest.mark.parametrize(
    "hidden,tile", [(1, (16, "smem")), (32, (16, "smem")), (126, (16, "smem")),
                    (127, (4, "cluster")), (300, (4, "cluster")), (512, (4, "cluster"))],
)
def test_gru_bwd_tile(hidden, tile):
    assert fr.gru_bwd_tile(hidden) == tile


@pytest.mark.parametrize(
    "bad,exc",
    [("dtype", TypeError), ("shape", ValueError), ("layout", ValueError), ("hidden", ValueError)],
)
def test_wrapper_argument_checks(bad, exc):
    t, b, h = 4, 3, 8
    x_proj = torch.zeros(t, b, 3 * h)
    h0, w, bias = torch.zeros(b, h), torch.zeros(h, 3 * h), torch.zeros(3 * h)
    shapes = [(b, h), (h, 3 * h), (3 * h,), (t, b, 3 * h)]
    if bad == "dtype":
        h0 = h0.half()
    elif bad == "shape":
        bias = torch.zeros(3 * h + 1)
    elif bad == "layout":
        w = torch.zeros(3 * h, h).T
    else:
        h = 513
        x_proj = torch.zeros(t, b, 3 * h)
        h0, w, bias = torch.zeros(b, h), torch.zeros(h, 3 * h), torch.zeros(3 * h)
        shapes = [(b, h), (h, 3 * h), (3 * h,), (t, b, 3 * h)]
    with pytest.raises(exc):
        fr._check("gru_fwd", [h0, w, bias, x_proj], shapes)


@pytest.mark.parametrize("kernel", ["gru_fwd", "gru_bwd"])
def test_wrappers_reject_devices_other_than_cpu_and_cuda(kernel):
    t, b, h = 3, 2, 8
    x_proj = torch.zeros(t, b, 3 * h, device="meta")
    state = torch.zeros(b, h, device="meta")
    seq = torch.zeros(t, b, h, device="meta")
    w = torch.zeros(h, 3 * h, device="meta")
    bias = torch.zeros(3 * h, device="meta")
    args = ((x_proj, state, w, bias) if kernel == "gru_fwd"
            else (x_proj, seq, state, w, bias, seq, state))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        getattr(fr, kernel)(*args)


# ---------------------------------------------------------------------------
# the CUDA kernels on a card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# the main paths' shapes, and the edges of the two W paths: H=126 is the
# widest shared-memory tile (504 threads), H=127 the narrowest read from
# device memory in the forward and over a cluster in the backward (ragged
# H=127 the narrowest over a cluster in both kernels (a ragged last CTA),
# H=1 the narrowest of all; H=200 and 300 split unevenly over the cluster's
# 16 CTAs, B=250 and 37 leave ragged last tiles of the forward's 8 rows and
# the backward's 4
@pytest.mark.parametrize(
    "hidden,batch",
    [(32, 1440), (32, 735), (512, 256), (512, 204), (1, 5), (126, 37), (127, 37),
     (200, 64), (300, 37), (512, 250), (512, 37)],
)
def test_cuda_kernels_match_plain_versions(hidden, batch, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")

    def assert_kernel_close(got, want, tol):
        got, want = got.float(), want.float()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        else:
            err, peak = (got - want).abs().max().item(), want.abs().max().item()
            assert err <= BF16_KERNEL * peak, (err, peak)

    gen = torch.Generator(device="cuda").manual_seed(batch)
    t = 128
    x_proj = torch.randn(t, batch, 3 * hidden, generator=gen, device="cuda").to(dtype)
    h0 = (0.5 * torch.randn(batch, hidden, generator=gen, device="cuda")).to(dtype)
    w = (torch.randn(hidden, 3 * hidden, generator=gen, device="cuda") / hidden ** 0.5).to(dtype)
    b = (0.1 * torch.randn(3 * hidden, generator=gen, device="cuda")).to(dtype)
    fr.reset_launch_counts()
    h_k = fr.gru_fwd(x_proj, h0, w, b)
    h_p = fr.gru_fwd_plain(x_proj, h0, w, b)
    assert_kernel_close(h_k, h_p, F32_FWD)
    # O(1) cotangents, so the gradients are not small beside the tolerance
    dh_all = torch.randn(t, batch, hidden, generator=gen, device="cuda").to(dtype)
    dh_t = torch.randn(batch, hidden, generator=gen, device="cuda").to(dtype)
    args = (x_proj, h_p, h0, w, b, dh_all, dh_t)
    for got, want in zip(fr.gru_bwd(*args), fr.gru_bwd_plain(*args)):
        assert_kernel_close(got, want, F32_GRAD)
    torch.cuda.synchronize()
    assert fr.LAUNCHES == {"lstm_fwd": 0, "lstm_bwd": 0, "gru_fwd": 1, "gru_bwd": 1}
