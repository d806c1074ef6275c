"""Character-level RNN language model: embedding -> stacked LSTM/GRU ->
per-timestep vocab head.

The counterpart of ``pytorch_distributed_rnn_tpu/models/char_rnn.py``.  The
recurrence is ``ops/rnn.stacked_rnn`` (scan or the fused kernels), the head
``ops/rnn.head_logits`` (float32).  Parameter names follow the JAX tree
(``embed``, ``rnn.<i>.{w_ih,w_hh,b_ih,b_hh}``, ``head.{weight,bias}``), so
``interop`` carries weights across by name.  ``char_rnn_50m()`` pins the
~50M-parameter preset.
"""

from __future__ import annotations

import torch
from torch import nn

from pytorch_distributed_rnn_tpu_torch.ops.initializers import embedding_init, linear_init
from pytorch_distributed_rnn_tpu_torch.ops.losses import cross_entropy_loss
from pytorch_distributed_rnn_tpu_torch.ops.rnn import (
    dtype_of,
    head_logits,
    init_rnn_layer,
    stacked_rnn,
    stacked_rnn_decode_step,
)


class CharRNN(nn.Module):
    """``logits = model(tokens, generator)`` maps (B, T) int tokens to
    (B, T, vocab) next-token logits.  Inter-layer dropout runs in train
    mode only, its mask drawn from ``generator``."""

    def __init__(self, vocab_size: int = 256, embed_dim: int = 128,
                 hidden_dim: int = 256, layer_dim: int = 2, cell: str = "lstm",
                 impl: str = "auto", precision: str = "f32", dropout: float = 0.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.vocab_size = vocab_size
        self.cell = cell
        self.impl = impl
        self.precision = precision
        self.dropout = dropout
        self.embed = nn.Parameter(embedding_init(generator, vocab_size, embed_dim))
        self.rnn = nn.ModuleList(
            nn.ParameterDict({
                name: nn.Parameter(p) for name, p in init_rnn_layer(
                    generator, embed_dim if i == 0 else hidden_dim, hidden_dim, cell,
                ).items()
            })
            for i in range(layer_dim)
        )
        self.head = nn.ParameterDict({
            name: nn.Parameter(p)
            for name, p in linear_init(generator, hidden_dim, vocab_size).items()
        })

    def forward(self, tokens, generator: torch.Generator | None = None):
        """tokens (B, T) int -> logits (B, T, vocab), float32."""
        train_dropout = self.training and self.dropout > 0.0
        if train_dropout and generator is None:
            raise ValueError("train-mode dropout needs a torch.Generator")
        outputs, _ = stacked_rnn(
            list(self.rnn), self.embed[tokens.long()], self.cell,
            dropout=self.dropout, generator=generator if train_dropout else None,
            impl=self.impl, compute_dtype=dtype_of(self.precision),
        )
        return head_logits(self.head, outputs)

    def loss(self, tokens, generator: torch.Generator | None = None):
        """Next-token cross entropy: predict tokens[:, 1:] from
        tokens[:, :-1], mean over all positions."""
        logits = self(tokens[:, :-1], generator)
        return cross_entropy_loss(logits.reshape(-1, self.vocab_size),
                                  tokens[:, 1:].reshape(-1))

    @torch.no_grad()
    def generate(self, prompt, length: int, generator: torch.Generator | None = None,
                 temperature: float = 1.0):
        """Autoregressive sampling: ``prompt`` (B, Tp) int -> (B, Tp + length).

        The prompt runs through one ``stacked_rnn`` pass (the prefill, on
        the fused kernels where ``impl`` resolves to them), whose per-layer
        finals seed a loop of single-token ``stacked_rnn_decode_step``s.
        ``temperature=0`` is greedy argmax (no generator needed); otherwise
        tokens are drawn from ``softmax(logits / temperature)`` with
        ``generator``.  Generation runs in float32 whatever ``precision``
        says: sampling is sensitive to logit rounding."""
        if temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if prompt.ndim != 2 or prompt.shape[1] < 1:
            raise ValueError(
                "prompt must be (batch, >=1 tokens); an empty prompt has "
                "no last-step logits to seed decoding"
            )
        greedy = temperature == 0.0
        if not greedy and generator is None:
            raise ValueError("sampling (temperature > 0) needs a torch.Generator")

        layers = list(self.rnn)
        outputs, carries = stacked_rnn(layers, self.embed[prompt.long()], self.cell,
                                       impl=self.impl)
        logits = head_logits(self.head, outputs[:, -1, :])
        sampled = []
        for step in range(length):
            if greedy:
                tok = logits.argmax(dim=-1)
            else:
                probs = torch.softmax(logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
            sampled.append(tok.to(prompt.dtype))
            if step + 1 < length:  # the last token's logits are never read
                carries, h_top = stacked_rnn_decode_step(layers, carries, self.embed[tok],
                                                         self.cell)
                logits = head_logits(self.head, h_top)
        return torch.cat([prompt, *(t[:, None] for t in sampled)], dim=1)


def char_rnn_50m(impl: str = "auto", precision: str = "f32") -> CharRNN:
    """The ~50M-parameter stacked-LSTM LM preset: vocab 256, embed 512,
    4 x 1280 hidden (49.9M parameters)."""
    return CharRNN(vocab_size=256, embed_dim=512, hidden_dim=1280, layer_dim=4,
                   cell="lstm", impl=impl, precision=precision)


def num_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
