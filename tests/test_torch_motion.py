"""The port's ``MotionModel`` against the JAX package's, with the JAX
weights carried over by ``interop``; plus the ``interop`` round trip.
Tolerances: f32 1e-5, bf16 5e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu.models.motion import MotionModel as JaxMotionModel
from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch.models import MotionModel


def _pair(cell="lstm", precision="f32", impl="scan", hidden=16, layers=2, dropout=0.0):
    jax_model = JaxMotionModel(hidden_dim=hidden, layer_dim=layers, cell=cell,
                               precision=precision, dropout=dropout)
    params = jax_model.init(jax.random.PRNGKey(3))
    model = MotionModel(hidden_dim=hidden, layer_dim=layers, cell=cell, impl=impl,
                        precision=precision, dropout=dropout)
    model.load_state_dict(interop.jax_params_to_state_dict(params))
    return jax_model, params, model


@pytest.mark.parametrize(
    "cell,precision,impl",
    [("lstm", "f32", "scan"), ("lstm", "f32", "fused"), ("lstm", "bf16", "scan"),
     ("lstm", "bf16", "fused"), ("gru", "f32", "scan"), ("gru", "bf16", "scan")],
)
def test_forward_matches_jax(cell, precision, impl):
    jax_model, params, model = _pair(cell, precision, impl)
    x = np.random.RandomState(0).randn(5, 14, 9).astype(np.float32)
    want = np.asarray(jax_model.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    tol = 1e-5 if precision == "f32" else 5e-2
    assert got.dtype == np.float32 and got.shape == (5, 6)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_parameter_names_follow_the_jax_tree():
    model = MotionModel(hidden_dim=8, layer_dim=2)
    assert sorted(model.state_dict()) == sorted(
        [f"rnn.{i}.{n}" for i in range(2) for n in ("w_ih", "w_hh", "b_ih", "b_hh")]
        + ["fc.weight", "fc.bias"]
    )


@pytest.mark.parametrize("layers", [1, 3])
def test_interop_round_trip(layers):
    params = JaxMotionModel(hidden_dim=8, layer_dim=layers).init(jax.random.PRNGKey(layers))
    state = interop.jax_params_to_state_dict(params)
    back = interop.state_dict_to_jax_params(state)
    flat_a, tree_a = jax.tree.flatten(jax.tree.map(np.asarray, params))
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    model = MotionModel(hidden_dim=8, layer_dim=layers)
    model.load_state_dict(state)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, state[key], rtol=0, atol=0)


def test_init_draws_the_jax_distributions():
    model = MotionModel(hidden_dim=32, layer_dim=2, generator=torch.Generator().manual_seed(0))
    state = model.state_dict()
    bound = 1.0 / np.sqrt(32)
    for key, value in state.items():
        assert value.abs().max().item() <= bound + 1e-7, key
    same = MotionModel(hidden_dim=32, layer_dim=2, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(v, same.state_dict()[k]) for k, v in state.items())


def test_dropout_in_train_mode_only():
    _, _, model = _pair(dropout=0.5)
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 10, 9).astype(np.float32))
    with torch.no_grad():
        model.eval()
        a, b = model(x), model(x, torch.Generator().manual_seed(0))
        assert torch.equal(a, b)  # eval mode ignores the generator
        model.train()
        c = model(x, torch.Generator().manual_seed(0))
        d = model(x, torch.Generator().manual_seed(0))
        assert torch.equal(c, d) and not torch.equal(a, c)
        with pytest.raises(ValueError, match="Generator"):
            model(x)
