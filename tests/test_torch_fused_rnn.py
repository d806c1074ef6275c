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

from pytorch_distributed_rnn_tpu_torch import interop
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


def _check_against_jax(params, x, h0, c0, dtype_name, torch_params):
    """``lstm_layer_fused`` of the port (``torch_params``, float32 tensors
    of ``params``) against the JAX one: outputs, final state and the
    gradients of every parameter and input."""
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_rnn_tpu.ops.pallas_rnn import lstm_layer_fused as j_fused

    batch, seq = x.shape[:2]
    hidden = h0.shape[1]
    tdt = torch.float32 if dtype_name == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype_name == "f32" else jnp.bfloat16
    fwd_tol = F32_FWD if dtype_name == "f32" else BF16
    grad_tol = F32_GRAD if dtype_name == "f32" else BF16

    tp = {k: v.detach().to(tdt).requires_grad_(True) for k, v in torch_params.items()}
    tx, th0, tc0 = (torch.tensor(a, dtype=tdt, requires_grad=True) for a in (x, h0, c0))
    t_out, (t_h, t_c) = fr.lstm_layer_fused(tp, tx, th0, tc0)
    assert t_out.dtype == tdt and t_out.shape == (batch, seq, hidden)
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


# batch 12: one JAX tile; batch 13: ragged against the port's 16-row tile
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("batch", [12, 13])
def test_fused_layer_forward_and_grads_match_jax(batch, dtype_name):
    params, x, h0, c0 = _case(batch, seed=batch)
    _check_against_jax(params, x, h0, c0, dtype_name,
                       {k: torch.from_numpy(v) for k, v in params.items()})


# the widths of the cluster variant on the card: the narrowest (111, whose
# units split unevenly over the 16 CTAs) and 128; the weights come over
# through interop as a one-layer tree, as a trained model's do
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("hidden", [111, 128])
def test_fused_layer_matches_jax_at_cluster_widths(hidden, dtype_name):
    params, x, h0, c0 = _case(5, seq=6, hidden=hidden, seed=hidden)
    state = interop.jax_params_to_state_dict({"rnn": [params]})
    assert fr.lstm_fwd_tile(hidden)[1] == fr.lstm_bwd_tile(hidden)[1] == "cluster"
    _check_against_jax(params, x, h0, c0, dtype_name,
                       {k: state[f"rnn.0.{k}"] for k in NAMES})


# the motion width, where the backward reads the forward's saved gates: a
# batch of 37 (ragged against the card's 4-row tiles), in one JAX tile
def _h32_case(batch=37, seq=10, seed=32):
    rng = np.random.RandomState(seed)
    hidden = 32
    x_proj = rng.randn(seq, batch, 4 * hidden).astype(np.float32)
    w = (0.2 * rng.randn(hidden, 4 * hidden)).astype(np.float32)
    h0, c0 = (0.5 * rng.randn(batch, hidden).astype(np.float32) for _ in range(2))
    cot = [rng.randn(*s).astype(np.float32)
           for s in ((seq, batch, hidden), (batch, hidden), (batch, hidden))]
    return x_proj, w, h0, c0, cot


def test_plain_backward_on_saved_gates_matches_jax_kernel_at_h32():
    """``lstm_bwd_plain`` with the forward's gates at H=32 against the JAX
    ``_lstm_bwd_pallas`` (Pallas interpret mode), which recomputes them."""
    import jax.numpy as jnp

    from pytorch_distributed_rnn_tpu.ops.pallas_rnn import _lstm_bwd_pallas

    x_proj, w, h0, c0, (dh_all, dh_t, dc_t) = _h32_case()
    t = [torch.from_numpy(a) for a in (x_proj, h0, c0, w)]
    h_all, c_all, gates = fr.lstm_fwd_plain(*t[:3], t[3])
    assert fr.lstm_saves_gates(32)
    got = fr.lstm_bwd_plain(None, h_all, c_all, t[1], t[2], t[3], *map(torch.from_numpy,
                                                                      (dh_all, dh_t, dc_t)),
                            gates=gates)
    want = _lstm_bwd_pallas(*map(jnp.asarray, (x_proj, h_all.numpy(), c_all.numpy(), h0, c0, w,
                                               dh_all, dh_t, dc_t)), block_b=x_proj.shape[1])
    for name, a, b in zip(("dx_proj", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=F32_GRAD, atol=F32_GRAD, err_msg=name)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16", "bf16-saturated"])
@pytest.mark.parametrize("hidden", [32, 111])
def test_plain_backward_on_saved_gates_matches_jax_kernel_by_width(hidden, dtype_name):
    """``lstm_bwd_plain`` reading the plain forward's gates at both widths
    that save them (H=32, and 111, the narrowest cluster width) against
    ``_lstm_bwd_pallas`` (Pallas interpret mode), which recomputes them in
    float32, and against itself recomputing them: dx_proj, dh0, dc0.  In
    bf16 the saved gates are rounded to bf16 and the backward forms i(1-i),
    f(1-f), o(1-o) and 1-g^2 from them; ``bf16-saturated`` scales x_proj by
    8 so that most i, f and o sit within 0.01 of 0 or 1, where those
    factors lose most of their relative precision."""
    import jax.numpy as jnp

    from pytorch_distributed_rnn_tpu.ops.pallas_rnn import _lstm_bwd_pallas

    saturated = dtype_name == "bf16-saturated"
    tdt = torch.float32 if dtype_name == "f32" else torch.bfloat16
    jdt = jnp.float32 if dtype_name == "f32" else jnp.bfloat16
    tol = F32_GRAD if dtype_name == "f32" else BF16
    rng = np.random.RandomState(hidden)
    batch, seq = 5, 8
    x_proj = rng.randn(seq, batch, 4 * hidden).astype(np.float32) * (8.0 if saturated else 1.0)
    w = (0.2 * (32 / hidden) ** 0.5 * rng.randn(hidden, 4 * hidden)).astype(np.float32)
    h0, c0 = (0.5 * rng.randn(batch, hidden).astype(np.float32) for _ in range(2))
    cot = [rng.randn(*s).astype(np.float32)
           for s in ((seq, batch, hidden), (batch, hidden), (batch, hidden))]
    t = [torch.tensor(a, dtype=tdt) for a in (x_proj, h0, c0, w, *cot)]
    h_all, c_all, gates = fr.lstm_fwd_plain(*t[:4])
    assert fr.lstm_saves_gates(hidden)
    if saturated:
        ifo = torch.cat([gates[..., :2 * hidden], gates[..., 3 * hidden:]], dim=-1).float()
        assert ((ifo - 0.5).abs() > 0.49).float().mean() > 0.5
    got = fr.lstm_bwd_plain(None, h_all, c_all, *t[1:], gates=gates)
    recomputed = fr.lstm_bwd_plain(t[0], h_all, c_all, *t[1:])
    want = _lstm_bwd_pallas(*(jnp.asarray(_f32(a), jdt) for a in (x_proj, h_all, c_all, h0, c0,
                                                                   w, *cot)), block_b=batch)
    for name, a, b, r in zip(("dx_proj", "dh0", "dc0"), got, want, recomputed):
        assert a.dtype == tdt
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=tol, atol=tol, err_msg=name)
        np.testing.assert_allclose(_f32(a), _f32(r), rtol=tol, atol=tol, err_msg=name)


def test_fused_scan_matches_jax_fused_scan_at_h32():
    """``FusedLSTMScan`` at H=32 on a ragged batch against the JAX
    ``fused_lstm_scan``: h_all and the final state, and the gradients of
    x_proj, W_hh^T, h0 and c0."""
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_rnn_tpu.ops.pallas_rnn import fused_lstm_scan

    x_proj, w, h0, c0, (dh_all, dh_t, dc_t) = _h32_case()
    batch = x_proj.shape[1]
    tx, tw, th, tc = (torch.tensor(a, requires_grad=True) for a in (x_proj, w, h0, c0))
    h_all, h_t, c_t = fr.FusedLSTMScan.apply(tx, tw, th, tc, True)
    cot = [torch.from_numpy(a) for a in (dh_all, dh_t, dc_t)]
    ((h_all * cot[0]).sum() + (h_t * cot[1]).sum() + (c_t * cot[2]).sum()).backward()

    def loss(xp, ww, hh, cc):
        out, (hT, cT) = fused_lstm_scan(xp, ww, hh, cc, batch)
        return jnp.sum(out * dh_all) + jnp.sum(hT * dh_t) + jnp.sum(cT * dc_t), (out, hT, cT)

    (_, outs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (x_proj, w, h0, c0)))
    for a, b in zip((h_all, h_t, c_t), outs):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=F32_FWD, atol=F32_FWD)
    for name, a, b in zip(("x_proj", "w_hh_t", "h0", "c0"), (tx, tw, th, tc), grads):
        np.testing.assert_allclose(_f32(a.grad), _f32(b), rtol=F32_GRAD, atol=F32_GRAD,
                                   err_msg=name)


def test_fused_layer_default_state_matches_scan_layer():
    params, x, _, _ = _case(7, seed=3)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    out_f, (h_f, c_f) = fr.lstm_layer_fused(tp, torch.from_numpy(x))
    out_s, (h_s, c_s) = lstm_layer(tp, torch.from_numpy(x))
    for a, b in ((out_f, out_s), (h_f, h_s), (c_f, c_s)):
        torch.testing.assert_close(a, b, rtol=F32_FWD, atol=F32_FWD)


@pytest.mark.parametrize("batch", [5, 17])
def test_plain_backward_is_the_gradient_of_plain_forward(batch):
    """``lstm_bwd_plain`` (hand-derived), recomputing the gates and reading
    the forward's saved gates, against autograd through ``lstm_fwd_plain``:
    the plain versions agree with each other."""
    gen = torch.Generator().manual_seed(batch)
    t, h = 9, 8
    x_proj = torch.randn(t, batch, 4 * h, generator=gen, requires_grad=True)
    h0 = torch.randn(batch, h, generator=gen, requires_grad=True)
    c0 = torch.randn(batch, h, generator=gen, requires_grad=True)
    w = (0.3 * torch.randn(h, 4 * h, generator=gen)).requires_grad_(True)
    dh_all, dh_t, dc_t = (torch.randn(s, generator=gen) for s in ((t, batch, h), (batch, h), (batch, h)))
    h_all, c_all, gates = fr.lstm_fwd_plain(x_proj, h0, c0, w)
    loss = (h_all * dh_all).sum() + (h_all[-1] * dh_t).sum() + (c_all[-1] * dc_t).sum()
    auto = torch.autograd.grad(loss, (x_proj, h0, c0))
    args = (h_all.detach(), c_all.detach(), h0.detach(), c0.detach(), w.detach(), dh_all, dh_t,
            dc_t)
    for got_all in (fr.lstm_bwd_plain(x_proj.detach(), *args),
                    fr.lstm_bwd_plain(None, *args, gates=gates.detach())):
        for got, want in zip(got_all, auto):
            torch.testing.assert_close(got, want, rtol=F32_GRAD, atol=F32_GRAD)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    fr.reset_launch_counts()
    params, x, _, _ = _case(4, seed=1)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    out, _ = fr.lstm_layer_fused(tp, torch.from_numpy(x))
    out.sum().backward()
    assert not any(fr.LAUNCHES.values()), fr.LAUNCHES


# 1..512: one block up to H=110, a cluster above; 513 is past the range,
# as for the GRU
@pytest.mark.parametrize(
    "hidden,ok",
    [(1, True), (32, True), (64, True), (110, True), (111, True), (300, True), (512, True),
     (513, False), (0, False)],
)
def test_kernel_supports(hidden, ok):
    assert fr.kernel_supports(hidden) is ok


# the forward's rows a block: 4 up to H=32 (W_hh^T in registers), then as
# many as 512 threads take (W_hh^T in shared memory), at most 16, up to
# H=110; a cluster on 8 rows above where the slice fits in shared memory
# (bf16 always); the f32 tensor-core cluster kernel (H=449..512) on the
# rows its C side takes at a batch, without one on the most it takes (40)
@pytest.mark.parametrize(
    "hidden,dtype,tile",
    [(1, torch.float32, (4, "smem")), (32, torch.float32, (4, "smem")),
     (33, torch.float32, (12, "smem")), (64, torch.float32, (8, "smem")),
     (110, torch.bfloat16, (4, "smem")), (110, torch.float32, (4, "smem")),
     (111, torch.float32, (8, "cluster")), (448, torch.float32, (8, "cluster")),
     (449, torch.float32, (40, "cluster")), (512, torch.float32, (40, "cluster")),
     (512, torch.bfloat16, (8, "cluster"))],
)
def test_lstm_fwd_tile(hidden, dtype, tile):
    assert fr.lstm_fwd_tile(hidden, dtype) == tile
    rows, variant = tile
    assert rows % 4 == 0 and (variant == "cluster" or rows * hidden <= 512)


# the backward: one block on 4 rows up to H=32 (W_hh^T in registers), of 16
# rows up to H=110, a cluster on 4 rows above
@pytest.mark.parametrize(
    "hidden,tile",
    [(1, (4, "smem")), (32, (4, "smem")), (33, (16, "smem")), (110, (16, "smem")),
     (111, (4, "cluster")), (451, (4, "cluster")), (512, (4, "cluster"))],
)
def test_lstm_bwd_tile(hidden, tile):
    assert fr.lstm_bwd_tile(hidden) == tile


# the forward saves its activated gates up to H=32 and where both kernels
# run the cluster variant, and the backward then needs them (and takes none
# elsewhere)
@pytest.mark.parametrize("hidden,saves", [(32, True), (110, False), (111, True), (512, True)])
def test_lstm_saves_gates(hidden, saves):
    assert fr.lstm_saves_gates(hidden) is saves
    t, b = 3, 2
    x_proj = torch.randn(t, b, 4 * hidden, generator=torch.Generator().manual_seed(hidden))
    h0 = c0 = torch.zeros(b, hidden)
    w = 0.1 * torch.randn(hidden, 4 * hidden, generator=torch.Generator().manual_seed(1))
    h_all, c_all, gates = fr.lstm_fwd(x_proj, h0, c0, w)
    assert (gates is not None) is saves
    cot = (torch.ones(t, b, hidden), torch.zeros(b, hidden), torch.zeros(b, hidden))
    wrong = None if saves else fr.lstm_fwd_plain(x_proj, h0, c0, w)[2]
    with pytest.raises(ValueError, match="saved gates"):
        fr.lstm_bwd(x_proj, h_all, c_all, h0, c0, w, *cot, wrong)
    want = fr.lstm_bwd(x_proj, h_all, c_all, h0, c0, w, *cot, gates)
    torch.testing.assert_close(want[0], fr.lstm_bwd_plain(x_proj, h_all, c_all, h0, c0, w, *cot)[0])


# where autograd runs no backward (evaluation, generate), the forward saves
# no gates, and h_all is the same; with grad it saves them where
# lstm_saves_gates says
@pytest.mark.parametrize("hidden", [32, 64, 111])
def test_no_grad_forward_saves_no_gates(hidden, monkeypatch):
    gen = torch.Generator().manual_seed(hidden)
    x_proj = torch.randn(4, 3, 4 * hidden, generator=gen)
    h0, c0 = torch.randn(3, hidden, generator=gen), torch.randn(3, hidden, generator=gen)
    w = (0.1 * torch.randn(hidden, 4 * hidden, generator=gen)).requires_grad_(True)
    h_ng, c_ng, g_ng = fr.lstm_fwd(x_proj, h0, c0, w.detach(), save_gates=False)
    h_all, c_all, gates = fr.lstm_fwd(x_proj, h0, c0, w.detach())
    assert g_ng is None and (gates is not None) is fr.lstm_saves_gates(hidden)
    assert torch.equal(h_ng, h_all) and torch.equal(c_ng, c_all)
    seen = []
    real = fr.lstm_fwd

    def spy(*args):
        out = real(*args)
        seen.append(out[2] is not None)
        return out

    monkeypatch.setattr(fr, "lstm_fwd", spy)
    with torch.no_grad():
        out = fr.FusedLSTMScan.apply(x_proj, w, h0, c0, False)[0]
    layer = {"w_ih": torch.zeros(4 * hidden, 2), "w_hh": w.detach().T.requires_grad_(True),
             "b_ih": torch.zeros(4 * hidden), "b_hh": torch.zeros(4 * hidden)}
    grad_out = fr.lstm_layer_fused(layer, torch.zeros(3, 4, 2))[0]
    with torch.no_grad():
        fr.lstm_layer_fused(layer, torch.zeros(3, 4, 2))
    assert torch.equal(out, h_all)
    assert grad_out.requires_grad
    assert seen == [False, fr.lstm_saves_gates(hidden), False]


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
        x_proj = torch.zeros(t, b, 4 * 513)
        h0, c0, w = torch.zeros(b, 513), torch.zeros(b, 513), torch.zeros(513, 4 * 513)
        shapes = [(b, 513), (b, 513), (513, 4 * 513), (t, b, 4 * 513)]
    with pytest.raises(exc):
        fr._check("lstm_fwd", shapes[0][1], [h0, c0, w, x_proj], shapes)


@pytest.mark.parametrize("kernel", ["lstm_fwd", "lstm_bwd"])
def test_wrappers_reject_devices_other_than_cpu_and_cuda(kernel):
    t, b, h = 3, 2, 8
    x_proj = torch.zeros(t, b, 4 * h, device="meta")
    state = torch.zeros(b, h, device="meta")
    seq = torch.zeros(t, b, h, device="meta")
    w = torch.zeros(h, 4 * h, device="meta")
    # up to H=32 the backward reads the forward's saved gates (x_proj's shape)
    args = ((x_proj, state, state, w) if kernel == "lstm_fwd"
            else (x_proj, seq, seq, state, state, w, seq, state, state, x_proj))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        getattr(fr, kernel)(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# the motion shape, its last train batch and its evaluation batch; ragged
# last tiles (37 rows); the widest W in registers (32), the narrowest (1)
# and the widest (110) with W in shared memory, with a ragged warp (110 x 4
# = 440 threads); the cluster kernels: the char LM's train and evaluation
# batches and generate's 8 prompts at 512, the narrowest width (111),
# widths that split unevenly over the 16 CTAs, both sides of the f32
# slice's fit in shared memory (forward 448 / 449, where the tensor-core
# kernel starts; backward 464 / 465), ragged last tiles at 512
@pytest.mark.parametrize(
    "hidden,batch",
    [(32, 1440), (32, 768), (32, 735), (32, 37), (1, 5), (33, 37), (110, 64), (110, 37),
     (512, 256), (512, 104), (512, 204), (512, 8), (111, 37), (200, 64), (300, 37),
     (448, 37), (449, 37), (464, 37), (465, 37), (512, 250), (512, 37)],
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

    tol_f, tol_b = F32_FWD, F32_GRAD
    gen = torch.Generator(device="cuda").manual_seed(batch)
    t, h = 128, hidden
    x_proj = torch.randn(t, batch, 4 * h, generator=gen, device="cuda").to(dtype)
    h0 = (0.5 * torch.randn(batch, h, generator=gen, device="cuda")).to(dtype)
    c0 = (0.5 * torch.randn(batch, h, generator=gen, device="cuda")).to(dtype)
    # W of the same scale at every width (0.2 at H=32)
    w = (0.2 * (32 / h) ** 0.5 * torch.randn(h, 4 * h, generator=gen, device="cuda")).to(dtype)
    fr.reset_launch_counts()
    h_k, c_k, g_k = fr.lstm_fwd(x_proj, h0, c0, w)
    h_p, c_p, g_p = fr.lstm_fwd_plain(x_proj, h0, c0, w)
    assert_kernel_close(h_k, h_p, tol_f)
    assert_kernel_close(c_k, c_p, tol_f)
    assert (g_k is not None) is fr.lstm_saves_gates(h)
    if g_k is not None:
        assert_kernel_close(g_k, g_p, tol_f)
    rows, variant = fr.lstm_fwd_tile(h, dtype, batch)
    if variant == "cluster" and rows != fr.LSTM_FWD_CLUSTER_ROWS:
        # the tensor-core kernel: the fewest whole 8-row tiles that run the
        # batch in one wave of the resident clusters, at most 40
        shape = fr.cluster_shape("lstm_fwd", h, batch, dtype)
        assert rows % 8 == 0 and rows <= fr.LSTM_FWD_TC_MAX_ROWS
        assert shape["waves"] == 1 or rows == fr.LSTM_FWD_TC_MAX_ROWS
        assert rows == 8 or -(-batch // (rows - 8)) > shape["active_clusters"]
    # O(1) cotangents, so the gradients are not small beside the tolerance
    dh_all, dh_t, dc_t = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                          for s in ((t, batch, h), (batch, h), (batch, h)))
    args = (x_proj, h_p, c_p, h0, c0, w, dh_all, dh_t, dc_t,
            g_p if fr.lstm_saves_gates(h) else None)
    for got, want in zip(fr.lstm_bwd(*args), fr.lstm_bwd_plain(*args)):
        assert_kernel_close(got, want, tol_b)
    torch.cuda.synchronize()
    assert fr.LAUNCHES == {"lstm_fwd": 1, "lstm_bwd": 1, "gru_fwd": 0, "gru_bwd": 0}
