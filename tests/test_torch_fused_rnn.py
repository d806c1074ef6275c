"""The port's fused LSTM (``ops/fused_rnn.py``) against the JAX package's.

On the CPU the port's wrappers take the kernels' plain versions; the JAX
``lstm_layer_fused`` runs its Pallas kernels in interpret mode, as its own
tests do.  Forward and every gradient (params, x, h0, c0), f32 at
1e-5 / 1e-4 and bf16 at 5e-2 (the JAX kernel tests' tolerances).  The
``cuda``-marked test holds the CUDA kernels against the plain versions
(bf16 there at 1e-2 of each output's largest value) and skips without a
card.  JAX is imported inside the tests that use it,
so on a card (where JAX is not installed) the ``cuda`` test runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_rnn.py
"""

import math

import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr
from pytorch_distributed_rnn_tpu_torch.ops.rnn import lstm_layer

F32_FWD, F32_GRAD, BF16 = 1e-5, 1e-4, 5e-2
# bf16 kernel against its plain version, of each output's largest value:
# both carry float32 and round what they store to bf16, so they differ by at
# most one bf16 ulp of the largest value (2^-7 of it)
BF16_KERNEL = 1e-2
NAMES = ("w_ih", "w_hh", "b_ih", "b_hh")


def _case(batch, seq=12, in_dim=9, hidden=16, seed=0):
    rng = np.random.RandomState(seed)
    bound = 1.0 / math.sqrt(hidden)
    shapes = {"w_ih": (4 * hidden, in_dim), "w_hh": (4 * hidden, hidden),
              "b_ih": (4 * hidden,), "b_hh": (4 * hidden,)}
    params = {k: rng.uniform(-bound, bound, s).astype(np.float32) for k, s in shapes.items()}
    x = rng.randn(batch, seq, in_dim).astype(np.float32)
    h0 = 0.5 * rng.randn(batch, hidden).astype(np.float32)
    c0 = 0.5 * rng.randn(batch, hidden).astype(np.float32)
    return params, x, h0, c0


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype("float32"))


def _loss_torch(out, h, c):
    return (out.float() ** 2).sum() + (h.float() * c.float()).sum()


# batch 12: one JAX tile; batch 13: ragged against the port's 16-row tile
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("batch", [12, 13])
def test_fused_layer_forward_and_grads_match_jax(batch, dtype_name):
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_rnn_tpu.ops.pallas_rnn import lstm_layer_fused as j_fused

    params, x, h0, c0 = _case(batch, seed=batch)
    tdt = torch.float32 if dtype_name == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype_name == "f32" else jnp.bfloat16
    fwd_tol = F32_FWD if dtype_name == "f32" else BF16
    grad_tol = F32_GRAD if dtype_name == "f32" else BF16

    tp = {k: torch.tensor(v, dtype=tdt, requires_grad=True) for k, v in params.items()}
    tx, th0, tc0 = (torch.tensor(a, dtype=tdt, requires_grad=True) for a in (x, h0, c0))
    t_out, (t_h, t_c) = fr.lstm_layer_fused(tp, tx, th0, tc0)
    assert t_out.dtype == tdt and t_out.shape == (batch, 12, 16)
    _loss_torch(t_out, t_h, t_c).backward()

    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    jx, jh0, jc0 = (jnp.asarray(a, jdt) for a in (x, h0, c0))
    j_out, (j_h, j_c) = j_fused(jp, jx, jh0, jc0)

    def loss(p, xx, hh, cc):
        out, (h, c) = j_fused(p, xx, hh, cc)
        f32 = jnp.float32
        return jnp.sum(out.astype(f32) ** 2) + jnp.sum(h.astype(f32) * c.astype(f32))

    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(jp, jx, jh0, jc0)

    for got, want in ((t_out, j_out), (t_h, j_h), (t_c, j_c)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=fwd_tol, atol=fwd_tol)
    for name in NAMES:
        np.testing.assert_allclose(_f32(tp[name].grad), _f32(grads[0][name]),
                                   rtol=grad_tol, atol=grad_tol, err_msg=name)
    for got, want, name in ((tx, grads[1], "x"), (th0, grads[2], "h0"), (tc0, grads[3], "c0")):
        np.testing.assert_allclose(_f32(got.grad), _f32(want), rtol=grad_tol,
                                   atol=grad_tol, err_msg=name)


def test_fused_layer_default_state_matches_scan_layer():
    params, x, _, _ = _case(7, seed=3)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    out_f, (h_f, c_f) = fr.lstm_layer_fused(tp, torch.from_numpy(x))
    out_s, (h_s, c_s) = lstm_layer(tp, torch.from_numpy(x))
    for a, b in ((out_f, out_s), (h_f, h_s), (c_f, c_s)):
        torch.testing.assert_close(a, b, rtol=F32_FWD, atol=F32_FWD)


@pytest.mark.parametrize("batch", [5, 17])
def test_plain_backward_is_the_gradient_of_plain_forward(batch):
    """``lstm_bwd_plain`` (hand-derived) against autograd through
    ``lstm_fwd_plain``: the two plain versions agree with each other."""
    gen = torch.Generator().manual_seed(batch)
    t, h = 9, 8
    x_proj = torch.randn(t, batch, 4 * h, generator=gen, requires_grad=True)
    h0 = torch.randn(batch, h, generator=gen, requires_grad=True)
    c0 = torch.randn(batch, h, generator=gen, requires_grad=True)
    w = (0.3 * torch.randn(h, 4 * h, generator=gen)).requires_grad_(True)
    dh_all, dh_t, dc_t = (torch.randn(s, generator=gen) for s in ((t, batch, h), (batch, h), (batch, h)))
    h_all, c_all = fr.lstm_fwd_plain(x_proj, h0, c0, w)
    loss = (h_all * dh_all).sum() + (h_all[-1] * dh_t).sum() + (c_all[-1] * dc_t).sum()
    auto = torch.autograd.grad(loss, (x_proj, h0, c0))
    dx, dh0, dc0 = fr.lstm_bwd_plain(x_proj.detach(), h_all.detach(), c_all.detach(), h0.detach(),
                                     c0.detach(), w.detach(), dh_all, dh_t, dc_t)
    for got, want in zip((dx, dh0, dc0), auto):
        torch.testing.assert_close(got, want, rtol=F32_GRAD, atol=F32_GRAD)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    fr.reset_launch_counts()
    params, x, _, _ = _case(4, seed=1)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    out, _ = fr.lstm_layer_fused(tp, torch.from_numpy(x))
    out.sum().backward()
    assert fr.LAUNCHES == {"lstm_fwd": 0, "lstm_bwd": 0}


# up to H=110 the backward's shared memory fits one block; H=300 also
# overflows the 1024 threads of a block
@pytest.mark.parametrize(
    "hidden,ok",
    [(1, True), (32, True), (64, True), (110, True), (111, False), (300, False), (0, False)],
)
def test_kernel_supports(hidden, ok):
    assert fr.kernel_supports(hidden) is ok


@pytest.mark.parametrize(
    "bad,exc",
    [("dtype", TypeError), ("shape", ValueError), ("layout", ValueError), ("hidden", ValueError)],
)
def test_wrapper_argument_checks(bad, exc):
    t, b, h = 4, 3, 8
    x_proj = torch.zeros(t, b, 4 * h)
    h0, c0, w = torch.zeros(b, h), torch.zeros(b, h), torch.zeros(h, 4 * h)
    shapes = [(b, h), (b, h), (h, 4 * h), (t, b, 4 * h)]
    if bad == "dtype":
        h0 = h0.half()
    elif bad == "shape":
        c0 = torch.zeros(b + 1, h)
    elif bad == "layout":
        w = torch.zeros(4 * h, h).T
    else:
        x_proj = torch.zeros(t, b, 4 * 200)
        h0, c0, w = torch.zeros(b, 200), torch.zeros(b, 200), torch.zeros(200, 800)
        shapes = [(b, 200), (b, 200), (200, 800), (t, b, 800)]
    with pytest.raises(exc):
        fr._check("lstm_fwd", [h0, c0, w, x_proj], shapes)


@pytest.mark.parametrize("kernel", ["lstm_fwd", "lstm_bwd"])
def test_wrappers_reject_devices_other_than_cpu_and_cuda(kernel):
    t, b, h = 3, 2, 8
    x_proj = torch.zeros(t, b, 4 * h, device="meta")
    state = torch.zeros(b, h, device="meta")
    seq = torch.zeros(t, b, h, device="meta")
    w = torch.zeros(h, 4 * h, device="meta")
    args = ((x_proj, state, state, w) if kernel == "lstm_fwd"
            else (x_proj, seq, seq, state, state, w, seq, state, state))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        getattr(fr, kernel)(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1440, 735])
def test_cuda_kernels_match_plain_versions(batch, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    def assert_kernel_close(got, want, tol):
        got, want = got.float(), want.float()
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        else:
            err, peak = (got - want).abs().max().item(), want.abs().max().item()
            assert err <= BF16_KERNEL * peak, (err, peak)

    tol_f, tol_b = F32_FWD, F32_GRAD
    gen = torch.Generator(device="cuda").manual_seed(batch)
    t, h = 128, 32
    x_proj = torch.randn(t, batch, 4 * h, generator=gen, device="cuda").to(dtype)
    h0 = (0.5 * torch.randn(batch, h, generator=gen, device="cuda")).to(dtype)
    c0 = (0.5 * torch.randn(batch, h, generator=gen, device="cuda")).to(dtype)
    w = (0.2 * torch.randn(h, 4 * h, generator=gen, device="cuda")).to(dtype)
    fr.reset_launch_counts()
    h_k, c_k = fr.lstm_fwd(x_proj, h0, c0, w)
    h_p, c_p = fr.lstm_fwd_plain(x_proj, h0, c0, w)
    assert_kernel_close(h_k, h_p, tol_f)
    assert_kernel_close(c_k, c_p, tol_f)
    # O(1) cotangents, so the gradients are not small beside the tolerance
    dh_all, dh_t, dc_t = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                          for s in ((t, batch, h), (batch, h), (batch, h)))
    args = (x_proj, h_p, c_p, h0, c0, w, dh_all, dh_t, dc_t)
    for got, want in zip(fr.lstm_bwd(*args), fr.lstm_bwd_plain(*args)):
        assert_kernel_close(got, want, tol_b)
    torch.cuda.synchronize()
    assert fr.LAUNCHES == {"lstm_fwd": 1, "lstm_bwd": 1}
