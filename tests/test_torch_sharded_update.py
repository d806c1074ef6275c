"""The sharded Adam update's layout and arithmetic, on the CPU in one
process (the spawned worlds of ``test_torch_distributed.py`` hold the whole
step, with its collectives, bit for bit against the replicated one).

- The padded-ravel layout of the full-width motion model (2 x 32 LSTM,
  14150 parameters) against the JAX ``ShardedUpdate``'s at worlds 1-4:
  the same ``size``, ``shard`` and ``padded``, and the same numbers from
  ``shard_slice`` and ``pad_flat``.
- The bijection between ``torch.optim.Adam``'s per-parameter state and the
  flat sharded state round-trips bit for bit at worlds 1-4.
- Adam on each rank's flat slice equals Adam on each parameter bit for bit,
  and the port's Adam agrees with ``optax.adam``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_rnn_tpu.models import MotionModel as JaxMotionModel
from pytorch_distributed_rnn_tpu.parallel.sharded_update import ShardedUpdate as JaxShardedUpdate
from pytorch_distributed_rnn_tpu_torch.models import MotionModel
from pytorch_distributed_rnn_tpu_torch.ops.adam import Adam, adam_update_
from pytorch_distributed_rnn_tpu_torch.parallel.sharded_update import ShardedUpdate

WORLDS = [1, 2, 3, 4]
LR = 2.5e-3


def _model():
    return MotionModel(hidden_dim=32, layer_dim=2, generator=torch.Generator().manual_seed(0))


def _grads(params, seed):
    """Gradients of mixed magnitudes, shaped like ``params``."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(p.shape, generator=gen) * 10.0 ** torch.randint(-4, 2, p.shape,
                                                                         generator=gen)
            for p in params]


def _trained_adam(model, steps=3):
    """An ``Adam`` over ``model`` after ``steps`` steps on random gradients."""
    params = list(model.parameters())
    opt = Adam(params, lr=LR)
    for step in range(steps):
        for p, g in zip(params, _grads(params, step)):
            p.grad = g
        opt.step()
    return opt


@pytest.mark.parametrize("world", WORLDS)
def test_layout_matches_jax(world):
    jax_params = JaxMotionModel(hidden_dim=32, layer_dim=2).init(jax.random.PRNGKey(0))
    theirs = JaxShardedUpdate(optax.adam(LR), jax_params, world)
    ours = ShardedUpdate(Adam(_model().parameters(), lr=LR), world)
    assert (ours.size, ours.shard, ours.padded) == (theirs.size, theirs.shard, theirs.padded)
    assert ours.size == 14150 and ours.padded - ours.size == {1: 0, 2: 0, 3: 1, 4: 2}[world]
    flat = np.arange(ours.size, dtype=np.float32) + 0.5
    padded = ours.pad_flat(torch.from_numpy(flat))
    np.testing.assert_array_equal(padded.numpy(), theirs.pad_flat(flat))
    for rank in range(world):
        np.testing.assert_array_equal(ours.shard_slice(padded, rank).numpy(),
                                      theirs.shard_slice(theirs.pad_flat(flat), rank))


@pytest.mark.parametrize("world", WORLDS)
def test_layout_bijection_round_trips(world):
    """Adam's state -> the flat state -> each rank's slice (``load_state_dict``)
    -> the slices gathered -> Adam's state, bit for bit."""
    model = _model()
    std = _trained_adam(model).state_dict()
    ranks = [ShardedUpdate(Adam(model.parameters(), lr=LR), world, rank) for rank in range(world)]
    for sharded in ranks:
        sharded.load_state_dict(std)
    gathered = {"step": ranks[0].steps,
                "exp_avg": torch.cat([r.exp_avg for r in ranks]),
                "exp_avg_sq": torch.cat([r.exp_avg_sq for r in ranks])}
    back = ranks[0].replicated_opt_state(gathered)
    assert back["param_groups"] == std["param_groups"]
    assert back["state"].keys() == std["state"].keys()
    for i, state in std["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(back["state"][i][key], state[key]), (i, key)
    pad = ranks[0].padded - ranks[0].size  # the last rank's tail is padding, kept zero
    assert not ranks[-1].exp_avg[ranks[0].shard - pad:].any()


def test_fresh_state_maps_to_no_state():
    sharded = ShardedUpdate(Adam(_model().parameters(), lr=LR), 4, 1)
    fresh = torch.optim.Adam(_model().parameters(), lr=LR).state_dict()
    sharded.load_state_dict(fresh)
    assert sharded.steps == 0 and not sharded.exp_avg.any()
    flat = sharded.flat_opt_state(fresh)
    assert sharded.replicated_opt_state(flat)["state"] == {}


@pytest.mark.parametrize("world", WORLDS)
def test_adam_on_shards_matches_per_parameter_adam_bitwise(world):
    """Each rank's ``adam_update_`` on its slice of the raveled (padded)
    parameters and gradients, gathered, equals ``Adam`` on each parameter."""
    replicated = _model()
    opt = Adam(list(replicated.parameters()), lr=LR)
    layout = ShardedUpdate(Adam(_model().parameters(), lr=LR), world)
    flat_p = layout.ravel([p.detach() for p in _model().parameters()])
    m, v = torch.zeros(layout.padded), torch.zeros(layout.padded)
    for step in range(1, 6):
        grads = _grads(list(replicated.parameters()), step)
        for p, g in zip(replicated.parameters(), grads):
            p.grad = g.clone()
        opt.step()
        flat_g = layout.ravel(grads)
        for rank in range(world):
            part = [layout.shard_slice(t, rank) for t in (flat_p, flat_g, m, v)]
            adam_update_([part[0]], [part[1]], [part[2]], [part[3]], step, LR, 0.9, 0.999, 1e-8)
    for p, q in zip(replicated.parameters(), layout.unravel(flat_p)):
        assert torch.equal(p.detach(), q)
    std = opt.state_dict()["state"]
    for i, (mi, vi) in enumerate(zip(layout.unravel(m), layout.unravel(v))):
        assert torch.equal(std[i]["exp_avg"], mi) and torch.equal(std[i]["exp_avg_sq"], vi)


def test_adam_matches_optax():
    """Five steps of the port's ``Adam`` against ``optax.adam`` from the
    same parameters on the same gradients, within float32 rounding (optax
    forms the bias corrections in float32, the port in float64)."""
    model = _model()
    params = list(model.parameters())
    jax_params = [jnp.array(p.detach().numpy(), copy=True) for p in params]
    opt, tx = Adam(params, lr=LR), optax.adam(LR)
    state = tx.init(jax_params)
    for step in range(5):
        grads = _grads(params, step)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        updates, state = tx.update([jnp.array(g.numpy(), copy=True) for g in grads], state,
                                   jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
    for p, q in zip(params, jax_params):
        # the parameters lie within (-1, 1): one float32 ulp of 1 absolute
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), rtol=1e-6,
                                   atol=float(np.finfo(np.float32).eps))


def test_adam_state_loads_into_torch_adam_and_back():
    """``Adam``'s ``state_dict`` is ``torch.optim.Adam``'s: each loads the
    other's, and a step from the loaded state stays within float32
    rounding of the other."""
    model = _model()
    ours = _trained_adam(model)
    theirs = torch.optim.Adam(model.parameters(), lr=LR)
    theirs.load_state_dict(ours.state_dict())
    again = Adam(model.parameters(), lr=1.0)
    again.load_state_dict(theirs.state_dict())
    assert again.param_groups[0]["lr"] == LR
    for i, state in ours.state_dict()["state"].items():
        loaded = again.state_dict()["state"][i]
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(loaded[key], state[key]), (i, key)
