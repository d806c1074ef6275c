"""Attention sequence classifier: the long-context model family.

The counterpart of ``pytorch_distributed_rnn_tpu/models/attention.py``: a
pre-norm Transformer encoder over (B, T, features) windows, mean pooled
into class logits.  Every block's attention is the dense
``ops.attention.mha_attention`` or the flash kernels of
``ops.fused_attention`` (``impl``; ``auto`` takes ``flash`` on the card at a head dim of at
most 128, ``dense`` above it).
Parameter names follow the JAX tree (``embed.{weight,bias}``, ``pos``,
``blocks.<i>.{ln1,ln2}.{scale,bias}``,
``blocks.<i>.{wq,wk,wv,wo,fc1,fc2}.{weight,bias}``, ``head.{weight,bias}``),
so ``interop`` carries weights across by name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_rnn_tpu_torch.ops.attention import mha_attention
from pytorch_distributed_rnn_tpu_torch.ops.fused_attention import (
    flash_attention,
    resolve_attention_impl,
)
from pytorch_distributed_rnn_tpu_torch.ops.initializers import linear_init, position_init
from pytorch_distributed_rnn_tpu_torch.ops.rnn import (
    apply_dropout,
    dropout_mask,
    dtype_of,
    interlayer_dropout,
    rematerialized,
)


def _layer_norm(x, scale, bias, eps: float = 1e-5):
    """Statistics in float32 whatever x's dtype (population variance), the
    normalised value cast back to x's dtype before ``* scale + bias``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * scale + bias


def init_block(generator: torch.Generator, dim: int, mlp_ratio: int = 4):
    """One pre-norm encoder block's params: nested dicts of tensors (the
    heads split no parameter, so unlike the JAX function it takes no
    ``num_heads``)."""
    return {
        "ln1": {"scale": torch.ones(dim), "bias": torch.zeros(dim)},
        "wq": linear_init(generator, dim, dim),
        "wk": linear_init(generator, dim, dim),
        "wv": linear_init(generator, dim, dim),
        "wo": linear_init(generator, dim, dim),
        "ln2": {"scale": torch.ones(dim), "bias": torch.zeros(dim)},
        "fc1": linear_init(generator, dim, mlp_ratio * dim),
        "fc2": linear_init(generator, mlp_ratio * dim, dim),
    }


def _linear(p, x):
    return x @ p["weight"].T + p["bias"]


def _split_heads(x, num_heads: int):
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def block_qkv(params, x, num_heads: int):
    """Pre-norm + QKV projections -> q, k, v (B, H, T, D)."""
    y = _layer_norm(x, **params["ln1"])
    return tuple(_split_heads(_linear(params[w], y), num_heads) for w in ("wq", "wk", "wv"))


def block_masks(params, x, generator, dropout: float) -> tuple:
    """The block's three dropout keep-masks for input ``x`` (B, T, dim),
    drawn from ``generator`` in the order and at the shapes the block's
    epilogue draws them (attention projection, FFN activation, FFN
    output): passed to the block, they give its bits."""
    lead = x.shape[:-1]
    widths = (params["wo"]["weight"].shape[0], params["fc1"]["weight"].shape[0],
              params["fc2"]["weight"].shape[0])
    return tuple(dropout_mask((*lead, width), generator, dropout, x.device) for width in widths)


def block_epilogue(params, x, attn_out, dropout: float = 0.0, generator=None, masks=None):
    """Output projection + residual + MLP (GELU, tanh approximation as
    ``jax.nn.gelu``).  With ``dropout > 0`` and a ``generator`` (train
    mode), dropout masks the attention projection, the FFN activation and
    the FFN output; ``masks`` (:func:`block_masks`) in place of the
    generator gives those masks; neither is eval mode."""
    train = dropout > 0.0 and (generator is not None or masks is not None)

    def drop(t, i):
        if masks is not None:
            return apply_dropout(t, masks[i], dropout)
        return interlayer_dropout(t, generator, dropout)

    attn_proj = _linear(params["wo"], _merge_heads(attn_out))
    if train:
        attn_proj = drop(attn_proj, 0)
    x = x + attn_proj
    y = F.gelu(_linear(params["fc1"], _layer_norm(x, **params["ln2"])), approximate="tanh")
    if train:
        y = drop(y, 1)
    y = _linear(params["fc2"], y)
    if train:
        y = drop(y, 2)
    return x + y


def apply_block(params, x, num_heads: int, attention=None, dropout: float = 0.0,
                generator=None, masks=None):
    """One encoder block.  ``attention(q, k, v) -> out`` defaults to the
    dense :func:`mha_attention`; it is the injection point of the
    sequence-parallel strategies."""
    q, k, v = block_qkv(params, x, num_heads)
    attn = attention if attention is not None else mha_attention
    return block_epilogue(params, x, attn(q, k, v), dropout=dropout, generator=generator,
                          masks=masks)


class AttentionClassifier(nn.Module):
    """``logits = model(x, generator)``: ``x`` (B, T, input_dim) ->
    (B, output_dim).  ``precision="bf16"`` runs the blocks in bfloat16
    (their params cast inside the forward, so the gradients reach the
    float32 params); the embedding, the position add, the mean pool and the
    head stay float32.  Dropout runs in train mode only, its masks drawn
    from ``generator``.  ``remat`` recomputes each encoder block in the
    backward (``--remat``); its masks are drawn before the block, in the
    block's own order, so a recompute reuses them and the run keeps the
    bits it has without ``remat``."""

    def __init__(self, input_dim: int = 9, dim: int = 64, depth: int = 2, num_heads: int = 4,
                 output_dim: int = 6, max_len: int = 4096, dropout: float = 0.0,
                 impl: str = "auto", precision: str = "f32",
                 generator: torch.Generator | None = None, remat: bool = False):
        super().__init__()
        if dim % num_heads != 0:
            raise ValueError(
                f"dim {dim} must be divisible by num_heads {num_heads} (head "
                "splitting would silently truncate projections)"
            )
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.dropout = dropout
        self.impl = impl
        self.precision = precision
        self.remat = remat
        self.embed = _params(linear_init(generator, input_dim, dim))
        self.pos = nn.Parameter(position_init(generator, max_len, dim))
        self.blocks = nn.ModuleList(
            nn.ModuleDict({name: _params(p) for name, p in
                           init_block(generator, dim).items()})
            for _ in range(depth)
        )
        self.head = _params(linear_init(generator, dim, output_dim))

    def forward(self, x, generator: torch.Generator | None = None, attention=None):
        """``attention`` overrides every block's attention (the
        sequence-parallel injection point); by default ``impl`` picks the
        dense or the flash path."""
        train_dropout = self.training and self.dropout > 0.0
        if train_dropout and generator is None:
            raise ValueError("train-mode dropout needs a torch.Generator")
        if (attention is None
                and resolve_attention_impl(self.impl, x.device, self.head_dim) == "flash"):
            attention = flash_attention
        dtype = dtype_of(self.precision) or torch.float32
        h = (_linear(self.embed, x) + self.pos[: x.shape[1]]).to(dtype)
        recompute = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            params = {name: {k: t.to(dtype) for k, t in p.items()} for name, p in block.items()}
            if not recompute:
                h = apply_block(params, h, self.num_heads, attention, dropout=self.dropout,
                                generator=generator if train_dropout else None)
                continue
            masks = block_masks(params, h, generator, self.dropout) if train_dropout else None
            h = rematerialized(
                lambda p, x, m: apply_block(p, x, self.num_heads, attention,
                                            dropout=self.dropout, masks=m),
                params, h, masks)
        return _linear(self.head, h.float().mean(dim=1))


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({name: nn.Parameter(t) for name, t in tensors.items()})
