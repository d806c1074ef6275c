"""Per-family prefill and decode-step functions for the serving engine,
the counterparts of the JAX package's ``serving/adapters.py``.

An adapter binds one model family to the engine's two device programs:

- ``prefill(prompt (1, L), length (1,))`` consumes one request's
  bucket-padded prompt and returns ``(seq_state, logits (1, vocab))``,
  the per-sequence decode state the engine writes into a batch slot;
- ``step(state, tok (B,), pos (B,))`` advances every slot one token and
  returns ``(state, logits (B, vocab))``.

Every adapter reuses the family's decode functions (the ones its
``generate`` is built from), so a request decoded inside a continuous
batch produces the tokens of its single-request ``generate``.  Prompt
padding never reaches the decode state: the RNN families run a masked
prefill (carries update only while ``t < length``, with ``length`` a
device tensor), and the attention family's padded KV-cache columns are
masked until a decoded token overwrites each.  Masking, not exact-length
programs, is what lets one captured prefill a bucket serve every prompt
length.  Every function here takes and returns tensors only, so the
engine can capture it in a CUDA graph.
"""

from __future__ import annotations

import torch

from pytorch_distributed_rnn_tpu_torch.models.attention_lm import (
    AttentionLM,
    attention_decode_step,
    attention_prefill,
)
from pytorch_distributed_rnn_tpu_torch.models.char_rnn import CharRNN
from pytorch_distributed_rnn_tpu_torch.ops.rnn import head_logits, stacked_rnn_decode_step


def _zero_carries(batch: int, hidden: int, layers: int, cell: str, device) -> list:
    """Blank stacked-RNN carries, every leaf a distinct tensor (the engine
    writes each slot's leaves in place)."""

    def carry():
        if cell == "lstm":
            return (torch.zeros((batch, hidden), device=device),
                    torch.zeros((batch, hidden), device=device))
        return torch.zeros((batch, hidden), device=device)

    return [carry() for _ in range(layers)]


def masked_rnn_prefill(layers, embeds, length, cell: str):
    """Stacked-RNN prefill over a padded prompt: ``embeds`` (B, L, in),
    ``length`` (B,) a device tensor of true prompt lengths.  Runs
    single-token decode steps over the padded extent; carries update only
    while ``t < length``, and the top-layer hidden at ``t == length - 1``
    is kept as the last step's features.  Returns ``(carries, last_h
    (B, H))``."""
    batch, steps, _ = embeds.shape
    hidden = layers[0]["w_hh"].shape[1]
    carries = _zero_carries(batch, hidden, len(layers), cell, embeds.device)
    last_h = embeds.new_zeros((batch, hidden), dtype=torch.float32)
    for t in range(steps):
        new_carries, h_top = stacked_rnn_decode_step(layers, carries, embeds[:, t], cell)
        keep = (t < length)[:, None]  # (B, 1) broadcasts over hidden
        if cell == "lstm":
            carries = [tuple(torch.where(keep, n, o) for n, o in zip(new, old))
                       for new, old in zip(new_carries, carries)]
        else:
            carries = [torch.where(keep, new, old) for new, old in zip(new_carries, carries)]
        last_h = torch.where((t == length - 1)[:, None], h_top, last_h)
    return carries, last_h


class CharRNNAdapter:
    """CharRNN: the decode state is the stacked cells' carries (LSTM
    ``(h, c)`` a layer, GRU ``h``, each (B, H))."""

    family = "char"

    def __init__(self, model: CharRNN):
        self.model = model
        self.vocab_size = model.vocab_size
        self.max_context = None  # recurrent state: no positional bound
        self.hidden = model.rnn[0]["w_hh"].shape[1]

    def state_template(self, batch: int) -> dict:
        return {"carries": _zero_carries(batch, self.hidden, len(self.model.rnn),
                                         self.model.cell, self.model.embed.device)}

    def prefill(self, prompt, length):
        model = self.model
        carries, last_h = masked_rnn_prefill(list(model.rnn), model.embed[prompt.long()],
                                             length, model.cell)
        return {"carries": carries}, head_logits(model.head, last_h)

    def step(self, state, tok, pos):
        model = self.model
        carries, h_top = stacked_rnn_decode_step(list(model.rnn), state["carries"],
                                                 model.embed[tok.long()], model.cell)
        return {"carries": carries}, head_logits(model.head, h_top)


class AttentionLMAdapter:
    """AttentionLM: the decode state is fixed-capacity KV caches; the
    model's ``max_len`` bounds prompt + generated tokens a request."""

    family = "attention"

    def __init__(self, model: AttentionLM):
        self.model = model
        self.vocab_size = model.vocab_size
        self.max_context = model.max_len
        self.cache_len = model.max_len

    def state_template(self, batch: int) -> dict:
        model = self.model
        shape = (batch, model.depth, model.num_heads, self.cache_len, model.head_dim)
        device = model.embed.device
        return {"k": torch.zeros(shape, device=device), "v": torch.zeros(shape, device=device)}

    def prefill(self, prompt, length):
        k_cache, v_cache, logits_all = attention_prefill(self.model, prompt, self.cache_len)
        # the true prompt's last-step logits (padded rows are causal
        # garbage), indexed on the device so one program serves the bucket
        rows = torch.arange(prompt.shape[0], device=prompt.device)
        return {"k": k_cache, "v": v_cache}, logits_all[rows, length - 1]

    def step(self, state, tok, pos):
        # a free slot's position runs on past the cache between requests;
        # a slot that decodes never passes cache_len - 1 (the engine's
        # context budget), so the clamp changes no live row
        pos = pos.clamp(max=self.cache_len - 1)
        k_cache, v_cache, logits = attention_decode_step(self.model, state["k"], state["v"],
                                                         pos, tok)
        return {"k": k_cache, "v": v_cache}, logits


def adapter_for(model):
    """The adapter matching ``model``'s family (loud on unknowns)."""
    if isinstance(model, CharRNN):
        return CharRNNAdapter(model)
    if isinstance(model, AttentionLM):
        return AttentionLMAdapter(model)
    raise TypeError(
        f"no serving adapter for {type(model).__name__} - the port serves CharRNN and "
        "AttentionLM; the MoE LM (and its adapter) comes with ROADMAP A9"
    )
