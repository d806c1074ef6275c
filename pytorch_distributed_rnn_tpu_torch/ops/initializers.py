"""Torch-default initializers drawn from an explicit ``torch.Generator``.

The counterpart of ``pytorch_distributed_rnn_tpu/ops/initializers.py``:
``nn.LSTM``/``nn.GRU`` draw every weight and bias from U(-k, k) with
k = 1/sqrt(hidden_size); ``nn.Linear`` draws weight and bias from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)); the char LM's embedding is
N(0, 1) / sqrt(embed_dim).  The distributions match the JAX
package's; the bitstreams do not (``torch.Generator`` is not
``jax.random``), so parity tests copy weights instead of re-seeding.
"""

from __future__ import annotations

import math

import torch


def uniform_bound(generator: torch.Generator, shape, bound: float,
                  dtype=torch.float32) -> torch.Tensor:
    """Sample U(-bound, bound) on the generator's device."""
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return (2.0 * u - 1.0) * bound


def lstm_uniform(generator: torch.Generator, shape, hidden_size: int,
                 dtype=torch.float32) -> torch.Tensor:
    """torch.nn.LSTM / nn.GRU default: U(-1/sqrt(H), 1/sqrt(H))."""
    return uniform_bound(generator, shape, 1.0 / math.sqrt(hidden_size), dtype)


def embedding_init(generator: torch.Generator, vocab_size: int,
                   embed_dim: int, dtype=torch.float32) -> torch.Tensor:
    """The char LM's embedding table: N(0, 1) scaled by
    ``embed_dim ** -0.5``, shape (vocab, embed)."""
    table = torch.randn((vocab_size, embed_dim), generator=generator,
                        dtype=dtype, device=generator.device)
    return table * embed_dim ** -0.5


def linear_init(generator: torch.Generator, in_features: int,
                out_features: int, dtype=torch.float32) -> dict:
    """torch.nn.Linear default init, torch layout:
    ``{"weight": (out, in), "bias": (out,)}``."""
    bound = 1.0 / math.sqrt(in_features)
    return {
        "weight": uniform_bound(generator, (out_features, in_features), bound, dtype),
        "bias": uniform_bound(generator, (out_features,), bound, dtype),
    }
