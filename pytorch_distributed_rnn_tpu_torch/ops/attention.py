"""Dense multi-head attention, the counterpart of
``pytorch_distributed_rnn_tpu/ops/attention.py:mha_attention``.

The ``impl="dense"`` path of the attention family and the numerics
reference of the flash kernels (``ops/fused_attention.py``): plain torch on
any device.  The sequence-parallel compositions of the JAX module
(``ring_attention``, ``_online_update``, ``ulysses_attention``) wait for the
port's sequence-parallel strategies.
"""

from __future__ import annotations

import torch


def mha_attention(q, k, v, *, causal: bool = False, q_offset: int = 0, k_offset: int = 0):
    """Reference multi-head attention.

    ``q`` (B, H, Tq, D), ``k``/``v`` (B, H, Tk, D) -> (B, H, Tq, D) in v's
    dtype.  The scores are float32, ``(q k^T) * D ** -0.5``; the
    probabilities are cast to v's dtype before ``p v``.  ``q_offset`` /
    ``k_offset`` are the global positions of the first query and key, so
    causal masking works on sequence chunks.  A query that sees no key
    gives NaN, as the JAX function does (its softmax over -inf)."""
    s = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        q_pos = q_offset + torch.arange(q.shape[2], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[2], device=q.device)
        s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), float("-inf"))
    p = torch.softmax(s, dim=-1)
    return p.to(v.dtype) @ v
