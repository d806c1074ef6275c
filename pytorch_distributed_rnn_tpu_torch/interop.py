"""Parameters between the JAX package and the port.

The JAX package's ``MotionModel`` params are a nested dict of arrays,
``{"rnn": [{"w_ih", "w_hh", "b_ih", "b_hh"}, ...], "fc": {"weight",
"bias"}}``, already in torch layout.  The port's ``MotionModel`` names the
same tensors ``rnn.<i>.<name>`` and ``fc.<name>``.  So converting is
naming and copying; no array is transposed.  Inputs are anything
``numpy.asarray`` takes (jax arrays included); outputs are numpy arrays
or CPU tensors, and nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

RNN_NAMES = ("w_ih", "w_hh", "b_ih", "b_hh")
FC_NAMES = ("weight", "bias")


def _tensor(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array, dtype=np.float32, copy=True))


def jax_params_to_state_dict(params) -> dict[str, torch.Tensor]:
    """The JAX param tree -> the port's ``MotionModel.state_dict()``."""
    state = {}
    for i, layer in enumerate(params["rnn"]):
        for name in RNN_NAMES:
            state[f"rnn.{i}.{name}"] = _tensor(layer[name])
    for name in FC_NAMES:
        state[f"fc.{name}"] = _tensor(params["fc"][name])
    return state


def state_dict_to_jax_params(state) -> dict:
    """The port's ``state_dict`` -> the JAX param tree, as numpy arrays."""
    layers = sorted({int(key.split(".")[1]) for key in state if key.startswith("rnn.")})
    return {
        "rnn": [
            {name: state[f"rnn.{i}.{name}"].detach().cpu().float().numpy()
             for name in RNN_NAMES}
            for i in layers
        ],
        "fc": {name: state[f"fc.{name}"].detach().cpu().float().numpy()
               for name in FC_NAMES},
    }
