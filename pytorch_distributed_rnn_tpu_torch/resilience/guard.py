"""Non-finite-step guard and checkpoint auto-resume: the counterpart of the
JAX package's ``resilience/guard.py``, without optax.

- :class:`NonFiniteGuard` is the host half of the guard.  The device half
  is the guarded Adam update (``ops/adam.py``: :func:`adam_update_` with a
  ``finite`` verdict, :class:`NonFiniteCounters`), ``optax.apply_if_finite``'s
  counterpart: a step whose gradients hold a NaN or an Inf leaves the
  parameters, Adam's moments and its count as they were and advances the
  counters, all on the device.  :meth:`NonFiniteGuard.check` reads the
  counters (one device-to-host copy) and aborts loudly past K consecutive
  bad steps - transient bad batches are survived, a diverging run still
  fails fast.
- :func:`resume_latest` restores a trainer from the newest VALID
  checkpoint in a directory, falling back across corrupt or truncated
  files (``training/checkpoint.py`` CRC verification) - the restart half
  of the kill faults in ``resilience/faults.py``.
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)


class NonFiniteAbort(RuntimeError):
    """Raised when more than ``limit`` consecutive steps were non-finite."""


class NonFiniteGuard:
    """Skip-and-count non-finite update steps; abort past ``limit``
    consecutive ones.

    The trainer builds its optimizer guarded (``guarded=True``) when it has
    a guard; ``check`` reads that optimizer's :class:`NonFiniteCounters`.
    Call it at step granularity on per-batch paths and at epoch boundaries
    on the graph paths: the device has already rejected the bad updates
    either way, so a later check only delays the abort, never corrupts
    state.
    """

    def __init__(self, limit: int):
        if limit < 1:
            raise ValueError(f"bad-step limit must be >= 1, got {limit}")
        self.limit = int(limit)
        self.total_skipped = 0
        # structured telemetry: a recorder bound by the trainer turns every
        # newly observed skip into a 'nan_skip' event (the telemetry half)
        self.recorder = None

    def check(self, counters):
        """Inspect the counters (``(consecutive, total)`` from
        ``counters.read()``); raise :class:`NonFiniteAbort` past the
        consecutive limit."""
        consecutive, total = counters.read()
        if total > self.total_skipped:
            log.warning(
                f"non-finite gradients: skipped {total - self.total_skipped} "
                f"step(s) (total {total}, consecutive {consecutive})"
            )
            if self.recorder is not None and self.recorder.enabled:
                self.recorder.record(
                    "nan_skip", new=total - self.total_skipped,
                    total=total, consecutive=consecutive,
                )
            self.total_skipped = total
        if consecutive > self.limit:
            raise NonFiniteAbort(
                f"{consecutive} consecutive non-finite update steps "
                f"(limit {self.limit}, {total} skipped in total): the run "
                "is diverging, not glitching - aborting instead of "
                "training in place"
            )


def resume_latest(trainer, checkpoint_dir):
    """Auto-resume: restore ``trainer`` from the newest valid checkpoint
    under ``checkpoint_dir`` (``--resume auto``).

    Candidates are tried newest-first; a corrupt or truncated file is
    logged and skipped so resume falls back to the previous valid one.
    Every skip also lands as a ``checkpoint_fallback`` event on the
    trainer's recorder, where it has one.  Returns the checkpoint
    metadata, or ``None`` when no usable checkpoint exists (fresh start).
    """
    from pytorch_distributed_rnn_tpu_torch.training.checkpoint import (
        CheckpointCorruptError,
        checkpoint_candidates,
    )

    skipped: list[tuple[str, str]] = []

    def _record_fallbacks(chosen):
        recorder = getattr(trainer, "recorder", None)
        if recorder is None or not recorder.enabled:
            return
        for path, reason in skipped:
            recorder.record(
                "checkpoint_fallback", path=path, reason=reason,
                chosen=chosen,
            )

    for path in checkpoint_candidates(checkpoint_dir):
        try:
            meta = trainer.resume_from(path, advance_epoch=True)
        except CheckpointCorruptError as exc:
            log.warning(
                f"auto-resume: skipping corrupt checkpoint {path}: {exc}"
            )
            skipped.append((str(path), str(exc)))
            continue
        log.info(
            f"auto-resume: restored {path} (epoch {meta['epoch']}, "
            f"loss {meta['loss']:.6f})"
        )
        _record_fallbacks(str(path))
        return meta
    _record_fallbacks(None)
    return None
