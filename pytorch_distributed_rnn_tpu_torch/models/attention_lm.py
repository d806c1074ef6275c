"""Causal attention language model, the counterpart of
``pytorch_distributed_rnn_tpu/models/attention_lm.py``.

The attention family's LM: the pre-norm encoder blocks of
``models/attention.py`` (``init_block``, ``block_qkv``, ``block_epilogue``:
one definition of the block math) run causally over token embeddings with
a vocab head, on the dense ``ops/attention.py:mha_attention``.  Parameter
names follow the JAX tree (``embed``, ``pos``, ``blocks.<i>.*``,
``ln_f.{scale,bias}``, ``head.{weight,bias}``), so ``interop`` carries
weights across by name.

Decode keeps a fixed-capacity KV cache ``(B, depth, heads, C, head_dim)``
written in place at a device position per row (slots decode at their own
depths under continuous batching), never a growing concatenation.  Cache
columns past a row's position are masked to ``-inf`` before the softmax,
so their probabilities are exactly 0 and the same request decodes to the
same tokens under ``generate``'s tight ``Tp + length`` cache and the
serving engine's ``max_len`` cache.  :func:`attention_prefill` and
:func:`attention_decode_step` are shared with ``serving/adapters.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from pytorch_distributed_rnn_tpu_torch.models.attention import (
    _layer_norm,
    _linear,
    _params,
    block_epilogue,
    block_qkv,
    init_block,
)
from pytorch_distributed_rnn_tpu_torch.ops.attention import mha_attention
from pytorch_distributed_rnn_tpu_torch.ops.initializers import (
    embedding_init,
    linear_init,
    position_init,
)
from pytorch_distributed_rnn_tpu_torch.ops.losses import cross_entropy_loss


def _cache_write(cache, kv, pos):
    """Write this step's K or V rows into one layer's cache in place:
    ``cache`` (B, H, C, D), ``kv`` (B, H, 1, D), ``pos`` (B,) a device
    tensor of per-row column indices."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, pos] = kv[:, :, 0]


def attention_decode_step(model, k_cache, v_cache, pos, tok):
    """One cached step: ``tok`` (B,) at positions ``pos`` (B,) ->
    ``(k_cache, v_cache, logits (B, vocab))``, the caches
    (B, depth, H, C, head_dim) written in place and returned.

    Attention spans the cache columns ``<= pos`` (this token's K/V
    written first); later columns are ``-inf``-masked, which reproduces
    :func:`mha_attention`'s causal row for this position."""
    h = (model.embed[tok.long()] + model.pos[pos.long()])[:, None, :]  # (B, 1, D)
    cols = torch.arange(k_cache.shape[3], device=k_cache.device)
    visible = (cols[None, :] <= pos[:, None])[:, None, None, :]
    for li, blk in enumerate(model.block_params()):
        q, k, v = block_qkv(blk, h, model.num_heads)  # (B, H, 1, hd)
        _cache_write(k_cache[:, li], k, pos)
        _cache_write(v_cache[:, li], v, pos)
        keys, values = k_cache[:, li], v_cache[:, li]
        s = (q.float() @ keys.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
        s = s.masked_fill(~visible, float("-inf"))
        p = torch.softmax(s, dim=-1)
        h = block_epilogue(blk, h, p.to(values.dtype) @ values)
    top = _layer_norm(h[:, 0], model.ln_f["scale"], model.ln_f["bias"])
    return k_cache, v_cache, _linear(model.head, top)


def attention_prefill(model, tokens, cache_len: int):
    """The prompt pass filling a fresh KV cache: ``tokens`` (B, T) with
    T <= ``cache_len`` -> ``(k_cache, v_cache, logits (B, T, vocab))``,
    the caches (B, depth, H, cache_len, head_dim) holding the prompt's
    K/V in columns [0, T).  Rows past a caller's true prompt length are
    causal garbage that column masking at decode, and the decode steps'
    overwrites, keep invisible."""
    b, t = tokens.shape
    h = model.embed[tokens.long()] + model.pos[:t]
    shape = (b, model.depth, model.num_heads, cache_len, model.head_dim)
    k_cache = h.new_zeros(shape)
    v_cache = h.new_zeros(shape)
    for li, blk in enumerate(model.block_params()):
        q, k, v = block_qkv(blk, h, model.num_heads)  # (B, H, T, hd)
        k_cache[:, li, :, :t] = k
        v_cache[:, li, :, :t] = v
        h = block_epilogue(blk, h, mha_attention(q, k, v, causal=True))
    top = _layer_norm(h, model.ln_f["scale"], model.ln_f["bias"])
    return k_cache, v_cache, _linear(model.head, top)


class AttentionLM(nn.Module):
    """``logits = model(tokens)`` maps (B, T) int tokens to (B, T, vocab)
    next-token logits through causally masked pre-norm encoder blocks
    (dense attention, float32, no dropout, as the JAX model)."""

    def __init__(self, vocab_size: int = 256, dim: int = 64, depth: int = 2,
                 num_heads: int = 4, max_len: int = 512,
                 generator: torch.Generator | None = None):
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError(
                f"dim {dim} must be divisible by num_heads {num_heads} (head "
                "splitting would silently truncate projections)"
            )
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.vocab_size = vocab_size
        self.dim = dim
        self.depth = depth
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.max_len = max_len
        self.embed = nn.Parameter(embedding_init(generator, vocab_size, dim))
        self.pos = nn.Parameter(position_init(generator, max_len, dim))
        self.blocks = nn.ModuleList(
            nn.ModuleDict({name: _params(p) for name, p in init_block(generator, dim).items()})
            for _ in range(depth)
        )
        self.ln_f = _params({"scale": torch.ones(dim), "bias": torch.zeros(dim)})
        self.head = _params(linear_init(generator, dim, vocab_size))

    def block_params(self):
        """Each block's params as the nested dicts the block functions take."""
        return [{name: dict(p.items()) for name, p in block.items()} for block in self.blocks]

    def forward(self, tokens, generator: torch.Generator | None = None):
        """tokens (B, T) int -> logits (B, T, vocab).  ``generator`` is
        accepted for the trainers' model signature and unused (no
        dropout)."""
        t = tokens.shape[1]
        if t > self.max_len:
            raise ValueError(f"sequence length {t} exceeds max_len {self.max_len}")
        h = self.embed[tokens.long()] + self.pos[:t]
        for blk in self.block_params():
            q, k, v = block_qkv(blk, h, self.num_heads)
            h = block_epilogue(blk, h, mha_attention(q, k, v, causal=True))
        h = _layer_norm(h, self.ln_f["scale"], self.ln_f["bias"])
        return _linear(self.head, h)

    def loss(self, tokens, generator: torch.Generator | None = None):
        """Next-token cross entropy (``CharRNN.loss`` semantics)."""
        logits = self(tokens[:, :-1])
        return cross_entropy_loss(logits.reshape(-1, self.vocab_size),
                                  tokens[:, 1:].reshape(-1))

    @torch.no_grad()
    def generate(self, prompt, length: int, generator: torch.Generator | None = None,
                 temperature: float = 1.0):
        """``prompt`` (B, Tp) int -> (B, Tp + length), as
        ``CharRNN.generate``: one causal prefill fills a ``Tp + length``
        KV cache, then single-token :func:`attention_decode_step`s decode.
        ``temperature=0`` is greedy argmax; otherwise tokens are drawn from
        ``softmax(logits / temperature)`` with ``generator``."""
        if temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if prompt.ndim != 2 or prompt.shape[1] < 1:
            raise ValueError(
                "prompt must be (batch, >=1 tokens); an empty prompt has "
                "no last-step logits to seed decoding"
            )
        if prompt.shape[1] + length > self.max_len:
            raise ValueError(
                f"prompt ({prompt.shape[1]}) + length ({length}) exceeds "
                f"max_len {self.max_len}: the bounded KV cache (and the "
                "learned positions) end there"
            )
        greedy = temperature == 0.0
        if not greedy and generator is None:
            raise ValueError("sampling (temperature > 0) needs a torch.Generator")

        b, tp = prompt.shape
        k_cache, v_cache, logits_all = attention_prefill(self, prompt, tp + length)
        logits = logits_all[:, -1, :]
        pos = torch.full((b,), tp, dtype=torch.long, device=prompt.device)
        sampled = []
        for step in range(length):
            if greedy:
                tok = logits.argmax(dim=-1)
            else:
                probs = torch.softmax(logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
            sampled.append(tok.to(prompt.dtype))
            if step + 1 < length:  # the last token's logits are never read
                k_cache, v_cache, logits = attention_decode_step(self, k_cache, v_cache,
                                                                 pos, tok)
                pos = pos + 1
        return torch.cat([prompt, *(t[:, None] for t in sampled)], dim=1)
