"""Losses with torch ``nn`` semantics, the counterpart of
``pytorch_distributed_rnn_tpu/ops/losses.py``: cross entropy on logits
and integer labels, and mean squared error, each with ``mean``, ``sum``
or ``none`` reduction."""

from __future__ import annotations

import torch


def _reduce(values: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return values.mean()
    if reduction == "sum":
        return values.sum()
    if reduction == "none":
        return values
    raise ValueError(f"unknown reduction {reduction!r}")


def cross_entropy_loss(logits, labels, reduction: str = "mean"):
    """Softmax cross entropy: ``logits`` (N, C), ``labels`` (N,) int."""
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -log_probs.gather(-1, labels.long()[:, None])[:, 0]
    return _reduce(nll, reduction)


def mse_loss(pred, target, reduction: str = "mean"):
    """Squared error, averaged over every element by default."""
    return _reduce(torch.square(pred - target), reduction)
