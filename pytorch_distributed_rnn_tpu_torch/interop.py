"""Parameters between the JAX package and the port.

The JAX package's params are nested dicts and lists of arrays already in
torch layout: ``MotionModel`` ``{"rnn": [{"w_ih", "w_hh", "b_ih", "b_hh"},
...], "fc": {"weight", "bias"}}``, ``CharRNN`` ``{"embed", "rnn": [...],
"head": {...}}``, ``AttentionClassifier`` ``{"embed": {"weight", "bias"},
"pos", "blocks": [{"ln1": {"scale", "bias"}, "wq": {...}, ...}, ...],
"head": {...}}``.  The port's modules name each tensor by its path in that
tree, dict keys and list indices joined by dots (``rnn.0.w_ih``,
``embed``, ``blocks.1.ln2.scale``).  So converting is naming and copying;
no array is transposed, and the tree comes back in the shape JAX
flattens.  Inputs are anything ``numpy.asarray`` takes (jax arrays
included); outputs are numpy arrays or CPU tensors, and nothing here
imports JAX.

The JAX tree order, for every family: the maps of a tree that JAX hands
to ``flax.serialization.to_bytes`` have their keys sorted (the trainer's
params and optax's moments come out of ``jax.tree.map``, which rebuilds
every dict in sorted key order), and a list's items keep their order
(flax writes them as maps keyed ``"0"``, ``"1"``, ...).  The port's
``state_dict()`` has the module's order (``rnn.0.b_hh, ...,
fc.weight, fc.bias``), which Adam's state indices follow.  So
:func:`state_dict_to_tree` sorts, and the readers take the module's
parameter names (``names``) to put a decoded tree back in module order.

Adam's state: the port keeps ``torch.optim.Adam``'s layout (``step``,
``exp_avg``, ``exp_avg_sq`` a parameter, indices in parameter order);
``optax.adam``'s is ``(ScaleByAdamState(count, mu, nu), EmptyState())``,
and ``optax.apply_if_finite`` (``--max-bad-steps``) wraps it in
``ApplyIfFiniteState(notfinite_count, last_finite, total_notfinite,
inner_state)``.  :func:`adam_state_to_optax` and
:func:`optax_to_adam_state` map one onto the other in flax's state-dict
form (tuples as maps keyed by index, named tuples as maps of their
fields), with the dtypes optax keeps (int32 counts, a bool).

The parameter server's wire vector is the port's ``parameters()`` order
flattened, JAX's the ``ravel_pytree`` order of the sorted tree:
:func:`flat_to_state_dict` and :func:`state_dict_to_flat` go between the
port's vector and the parameters by name (which the checkpoint's tree
holds), never by position.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array, dtype=np.float32, copy=True))


def _array(tensor) -> np.ndarray:
    return tensor.detach().cpu().float().numpy()


def jax_params_to_state_dict(params) -> dict[str, torch.Tensor]:
    """A JAX param tree -> the port model's ``state_dict()``."""
    state = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, sub in node.items():
                walk(sub, (*path, str(key)))
        elif isinstance(node, (list, tuple)):
            for i, sub in enumerate(node):
                walk(sub, (*path, str(i)))
        else:
            state[".".join(path)] = _tensor(node)

    walk(params, ())
    return state


def state_dict_to_jax_params(state) -> dict:
    """The port's ``state_dict`` -> the JAX param tree, as float32 numpy
    arrays in the JAX tree order: a path component of digits is a list
    index."""
    return _lists(state_dict_to_tree({name: _array(t) for name, t in state.items()}))


def state_dict_to_tree(state) -> dict:
    """A mapping of dotted names to leaves -> the tree in flax's state-dict
    form and the JAX tree order: nested dicts with sorted keys, a list as
    a dict keyed ``"0"``, ``"1"``, ... in index order.  Leaves stay as they
    are (tensors keep their dtype)."""
    tree: dict = {}
    for name, leaf in state.items():
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return _ordered(tree)


def _ordered(node):
    if not isinstance(node, dict):
        return node
    digits = bool(node) and all(key.isdigit() for key in node)
    keys = sorted(node, key=int) if digits else sorted(node)
    return {key: _ordered(node[key]) for key in keys}


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(key.isdigit() for key in node):
        return [_lists(node[key]) for key in sorted(node, key=int)]
    return {key: _lists(sub) for key, sub in node.items()}


def _tree_leaf(tree, name: str):
    """The leaf of ``tree`` (state-dict form: lists as index-keyed maps)
    at the dotted ``name``."""
    node = tree
    for key in name.split("."):
        node = node[key]
    return node


def tree_to_state_dict(tree, names) -> dict[str, torch.Tensor]:
    """A decoded tree -> ``{name: tensor}`` in the order of ``names`` (the
    module's parameter names); tensors keep the tree's dtype."""
    return {name: _as_tensor(_tree_leaf(tree, name)) for name in names}


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().clone()
    return torch.from_numpy(np.array(leaf, copy=True))


def _host(tensor) -> torch.Tensor:
    return tensor.detach().cpu()


# -- Adam's state ------------------------------------------------------------


def adam_state_to_optax(opt_state_dict, params, guard=None) -> dict:
    """``torch.optim.Adam``'s ``state_dict`` -> ``optax.adam``'s state in
    flax's state-dict form: ``{"0": {"count", "mu", "nu"}, "1": {}}``.
    ``params`` maps the module's parameter names, in parameter order (the
    state's indices), to the parameters (their shapes and dtypes make the
    zero moments of an optimizer that has not stepped).  ``guard`` (the
    ``{"notfinite_count", "total_notfinite"}`` counters, or None) wraps it
    as ``optax.apply_if_finite``'s state; ``last_finite`` is whether the
    last step was finite, which its consecutive count says."""
    names = list(params)
    state = opt_state_dict.get("state", {}) if opt_state_dict else {}
    if state:
        per_param = [state[i] for i in range(len(names))]
        count = int(per_param[0]["step"])
        mu = {n: _host(s["exp_avg"]) for n, s in zip(names, per_param)}
        nu = {n: _host(s["exp_avg_sq"]) for n, s in zip(names, per_param)}
    else:
        count = 0
        mu = {n: torch.zeros_like(_host(p)) for n, p in params.items()}
        nu = {n: torch.zeros_like(_host(p)) for n, p in params.items()}
    inner = {"0": {"count": np.asarray(count, np.int32), "mu": state_dict_to_tree(mu),
                   "nu": state_dict_to_tree(nu)},
             "1": {}}
    if guard is None:
        return inner
    consecutive = int(guard["notfinite_count"])
    return {"notfinite_count": np.asarray(consecutive, np.int32),
            "last_finite": np.asarray(consecutive == 0),
            "total_notfinite": np.asarray(int(guard["total_notfinite"]), np.int32),
            "inner_state": inner}


def optax_to_adam_state(tree, names) -> tuple[dict, dict | None]:
    """The inverse of :func:`adam_state_to_optax`: ``(state_dict, guard)``,
    ``state_dict`` in ``torch.optim.Adam``'s layout with indices in the
    order of ``names`` and one parameter group holding only ``params``
    (the caller's optimizer keeps its hyperparameters), ``guard`` the
    counters or None where the tree has no ``apply_if_finite`` wrapper.
    A count of 0 is an optimizer that has not stepped: no state."""
    guard = None
    if "inner_state" in tree:
        guard = {"notfinite_count": int(tree["notfinite_count"]),
                 "total_notfinite": int(tree["total_notfinite"])}
        tree = tree["inner_state"]
    adam = tree["0"]
    count = int(adam["count"])
    state = {}
    if count > 0:
        mu = tree_to_state_dict(adam["mu"], names)
        nu = tree_to_state_dict(adam["nu"], names)
        for i, name in enumerate(names):
            state[i] = {"step": torch.tensor(float(count), dtype=torch.float32),
                        "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    return {"state": state, "param_groups": [{"params": list(range(len(names)))}]}, guard


# -- the parameter server's flat vector ------------------------------------------------


def flat_to_state_dict(flat, params) -> dict[str, torch.Tensor]:
    """The port's flat wire vector (``parameters()`` order) -> ``{name:
    tensor}``.  ``params`` maps the parameter names, in parameter order,
    to tensors of their shapes."""
    flat = torch.as_tensor(flat).detach().cpu()
    state, offset = {}, 0
    for name, p in params.items():
        n = p.numel()
        state[name] = flat[offset: offset + n].reshape(p.shape).clone()
        offset += n
    if offset != flat.numel():
        raise ValueError(f"a flat vector of {flat.numel()} values for {offset} parameters")
    return state


def state_dict_to_flat(state, names) -> torch.Tensor:
    """``{name: tensor}`` -> the port's flat wire vector: the tensors at
    ``names`` (the parameter names in ``parameters()`` order), flattened,
    float32."""
    return torch.cat([_as_tensor(state[name]).reshape(-1).float() for name in names])
