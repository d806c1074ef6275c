"""Parameters between the JAX package and the port.

The JAX package's params are nested dicts of arrays already in torch
layout: ``MotionModel`` ``{"rnn": [{"w_ih", "w_hh", "b_ih", "b_hh"}, ...],
"fc": {"weight", "bias"}}``, ``CharRNN`` ``{"embed", "rnn": [...],
"head": {"weight", "bias"}}``.  The port's modules name the same tensors
``embed``, ``rnn.<i>.<name>``, ``fc.<name>`` and ``head.<name>``.  So
converting is naming and copying; no array is transposed.  Inputs are
anything ``numpy.asarray`` takes (jax arrays included); outputs are numpy
arrays or CPU tensors, and nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

RNN_NAMES = ("w_ih", "w_hh", "b_ih", "b_hh")
LINEAR_NAMES = ("weight", "bias")
HEADS = ("fc", "head")  # the motion classifier's and the char LM's


def _tensor(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array, dtype=np.float32, copy=True))


def _array(tensor) -> np.ndarray:
    return tensor.detach().cpu().float().numpy()


def jax_params_to_state_dict(params) -> dict[str, torch.Tensor]:
    """A JAX param tree -> the port model's ``state_dict()``."""
    state = {}
    if "embed" in params:
        state["embed"] = _tensor(params["embed"])
    for i, layer in enumerate(params["rnn"]):
        for name in RNN_NAMES:
            state[f"rnn.{i}.{name}"] = _tensor(layer[name])
    for head in HEADS:
        if head in params:
            for name in LINEAR_NAMES:
                state[f"{head}.{name}"] = _tensor(params[head][name])
    return state


def state_dict_to_jax_params(state) -> dict:
    """The port's ``state_dict`` -> the JAX param tree, as numpy arrays."""
    layers = sorted({int(key.split(".")[1]) for key in state if key.startswith("rnn.")})
    params = {
        "rnn": [{name: _array(state[f"rnn.{i}.{name}"]) for name in RNN_NAMES}
                for i in layers],
    }
    if "embed" in state:
        params["embed"] = _array(state["embed"])
    for head in HEADS:
        if f"{head}.weight" in state:
            params[head] = {name: _array(state[f"{head}.{name}"]) for name in LINEAR_NAMES}
    return params
