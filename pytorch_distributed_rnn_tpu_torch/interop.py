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
    """The port's ``state_dict`` -> the JAX param tree, as numpy arrays:
    a path component of digits is a list index."""
    tree: dict = {}
    for name, tensor in state.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = _array(tensor)
    return _lists(tree)


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node and all(key.isdigit() for key in node):
        return [_lists(node[key]) for key in sorted(node, key=int)]
    return {key: _lists(sub) for key, sub in node.items()}
