"""Motion sequence classifier: stacked RNN + last-timestep Linear head.

The counterpart of ``pytorch_distributed_rnn_tpu/models/motion.py``: a
stacked LSTM (default 2 x 32) over (B, 128, 9) windows and a Linear head
on the last timestep's hidden state, logits out.  Parameter names follow
the JAX tree (``rnn.<i>.{w_ih,w_hh,b_ih,b_hh}``, ``fc.{weight,bias}``), so
``interop`` carries weights across by name.
"""

from __future__ import annotations

import torch
from torch import nn

from pytorch_distributed_rnn_tpu_torch.ops.initializers import linear_init
from pytorch_distributed_rnn_tpu_torch.ops.rnn import (
    dtype_of,
    init_rnn_layer,
    stacked_rnn,
)


class MotionModel(nn.Module):
    """``logits = model(x, generator)``: ``x`` (B, T, input_dim) ->
    (B, output_dim).  Inter-layer dropout runs in train mode only, with
    its mask drawn from ``generator``; the head runs in float32 whatever
    ``precision`` the recurrence uses.  ``remat`` recomputes each RNN layer
    in the backward (``--remat``)."""

    def __init__(self, input_dim: int = 9, hidden_dim: int = 32,
                 layer_dim: int = 2, output_dim: int = 6, cell: str = "lstm",
                 impl: str = "auto", precision: str = "f32",
                 dropout: float = 0.0, generator: torch.Generator | None = None,
                 remat: bool = False):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cell = cell
        self.impl = impl
        self.precision = precision
        self.dropout = dropout
        self.remat = remat  # recompute each RNN layer in the backward
        self.rnn = nn.ModuleList(
            nn.ParameterDict({
                name: nn.Parameter(p) for name, p in init_rnn_layer(
                    generator, input_dim if i == 0 else hidden_dim,
                    hidden_dim, cell,
                ).items()
            })
            for i in range(layer_dim)
        )
        self.fc = nn.Linear(hidden_dim, output_dim)
        with torch.no_grad():
            for name, p in linear_init(generator, hidden_dim, output_dim).items():
                getattr(self.fc, name).copy_(p)

    def forward(self, x, generator: torch.Generator | None = None):
        train_dropout = self.training and self.dropout > 0.0
        if train_dropout and generator is None:
            raise ValueError("train-mode dropout needs a torch.Generator")
        outputs, _ = stacked_rnn(
            list(self.rnn), x, self.cell, dropout=self.dropout,
            generator=generator if train_dropout else None, impl=self.impl,
            compute_dtype=dtype_of(self.precision), remat=self.remat,
        )
        return self.fc(outputs[:, -1, :].float())
