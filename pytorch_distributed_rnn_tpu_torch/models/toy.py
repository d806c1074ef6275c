"""Toy MLP of the data-parallel examples, the counterpart of the JAX
package's ``models/toy.py``: Linear(10, 10) -> ReLU -> Linear(10, 5),
trained with MSE and SGD by ``examples/`` to check that every rank ends
with the same parameters.  Its ``state_dict`` names (``net1.weight``,
``net1.bias``, ``net2.*``) are the paths of the JAX param tree, so
``interop.jax_params_to_state_dict`` carries JAX's weights in unchanged."""

from __future__ import annotations

import torch
from torch import nn

from pytorch_distributed_rnn_tpu_torch.ops.initializers import linear_init


class ToyModel(nn.Module):
    def __init__(self, in_dim: int = 10, hidden_dim: int = 10, out_dim: int = 5,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.net1 = nn.Linear(in_dim, hidden_dim)
        self.net2 = nn.Linear(hidden_dim, out_dim)
        with torch.no_grad():
            for layer, (fan_in, fan_out) in ((self.net1, (in_dim, hidden_dim)),
                                             (self.net2, (hidden_dim, out_dim))):
                init = linear_init(generator, fan_in, fan_out)
                layer.weight.copy_(init["weight"])
                layer.bias.copy_(init["bias"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net2(torch.relu(self.net1(x)))
