"""Language-model loss adapter: the local trainer x the char-LM family.

The counterpart of the JAX package's ``training/lm.py``.  The trainer
turns every batch into a loss through ``_loss_and_metrics(x, y,
generator)`` (``training/base.py``), and the fused run through its
weighted form; the LM's next-token objective differs only there, so
:func:`wrap_lm_trainer` mixes :class:`LMLossMixin` over a trainer class
and the sampler, epoch loop, checkpoints and perf line apply to LM
training unchanged.
"""

from __future__ import annotations

from pytorch_distributed_rnn_tpu_torch.ops.losses import cross_entropy_loss


class LMLossMixin:
    """The loss surface for token-window batches.

    A batch is ``(tokens (B, T+1) int32, dummy labels)``: inputs are
    ``tokens[:, :-1]``, targets ``tokens[:, 1:]``.  The loss is the mean
    next-token cross entropy; ``correct`` is the SUM over sequences of each
    sequence's mean next-token accuracy, so the trainer's ``correct /
    len(dataset)`` is the mean token accuracy."""

    def _logits_and_targets(self, x, generator):
        logits = self._net()(x[:, :-1], generator).float()
        return logits, x[:, 1:].long()

    def _loss_and_metrics(self, x, y, generator=None):
        del y  # the targets come from the window itself
        logits, targets = self._logits_and_targets(x, generator)
        loss = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
        acc = (logits.argmax(dim=-1) == targets).float().mean(dim=1)
        return loss, acc.sum()

    def _weighted_loss_and_metrics(self, x, y, w, generator=None):
        """Per-sequence weights (the fused run's zero-padded tail): the
        weighted mean of the sequences' mean losses, the plain loss for
        all-ones weights up to rounding."""
        del y
        logits, targets = self._logits_and_targets(x, generator)
        nll = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                                 reduction="none").reshape(targets.shape)
        loss = (nll.mean(dim=1) * w).sum() / w.sum()
        acc = (logits.argmax(dim=-1) == targets).float().mean(dim=1)
        return loss, (acc * (w > 0)).sum()


_WRAPPED: dict = {}


def wrap_lm_trainer(trainer_class):
    """The trainer class with the LM loss mixed in (cached per base class)."""
    cls = _WRAPPED.get(trainer_class)
    if cls is None:
        cls = type(f"LM{trainer_class.__name__}", (LMLossMixin, trainer_class), {})
        _WRAPPED[trainer_class] = cls
    return cls
