"""Step-bounded ``torch.profiler`` trace capture, and the whole-run trace.

The counterpart of the JAX package's ``obs/profile.py``.  ``--profile
DIR`` alone traces the whole run (:func:`run_trace`); ``--profile-steps
A:B`` bounds the capture to optimizer steps ``[A, B)``
(:class:`StepTraceCapture`).  Both record the host and, on the card, the
device (CPU and CUDA activities) and write a Chrome trace into ``DIR``:
``trace[-r<rank>].json`` for the run, ``steps-A-B[-r<rank>].json`` for a
step range.

A short profiler window late in a process can lose device records
(ROADMAP C5): the window opens ``MARGIN_S`` of host-only time before
step A (no step is added), and closes after a device synchronize that
follows step B-1 and another margin, as ``utils/ab.py:device_profile``
does.  A profiler that fails (a build without CUPTI) must not kill the
run: the first failure logs one warning and disables the capture.
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path

log = logging.getLogger(__name__)

# host-only time inside the window before its first step and after its
# last (utils/ab.py:PROFILE_MARGIN_S)
MARGIN_S = 0.1


def _activities(device):
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if device is not None and str(device).startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    return activities


def _trace_name(stem: str, rank: int) -> str:
    return f"{stem}.json" if rank == 0 else f"{stem}-r{rank}.json"


def _synchronize(device) -> None:
    import torch

    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StepTraceCapture:
    """Start and stop ``torch.profiler`` around the optimizer steps
    ``[start, stop)`` of a run (run-relative step addresses)."""

    def __init__(self, trace_dir, start: int, stop: int):
        if start < 0 or stop <= start:
            raise ValueError(
                f"profile step range must satisfy 0 <= A < B, got {start}:{stop}")
        self.trace_dir = Path(trace_dir)
        self.start = int(start)
        self.stop = int(stop)
        self.device = None  # bound by the trainer
        self.rank = 0
        self.path = None  # the Chrome trace, once written
        self._prof = None
        self._captured = False
        self._disabled = False

    @classmethod
    def parse_range(cls, spec: str) -> tuple[int, int]:
        """``"A:B"`` -> ``(A, B)``; a malformed spec fails loudly."""
        head, sep, tail = str(spec).partition(":")
        if not sep:
            raise ValueError(f"--profile-steps wants A:B (half-open step range), got {spec!r}")
        try:
            start, stop = int(head), int(tail)
        except ValueError as exc:
            raise ValueError(f"--profile-steps wants integer steps A:B, got {spec!r}") from exc
        if start < 0 or stop <= start:
            raise ValueError(f"--profile-steps needs 0 <= A < B, got {spec!r}")
        return start, stop

    @classmethod
    def resolve(cls, args) -> "StepTraceCapture | None":
        """``--profile-steps A:B`` into the ``--profile DIR`` directory;
        None without the flag."""
        spec = getattr(args, "profile_steps", None)
        if not spec:
            return None
        trace_dir = getattr(args, "profile", None)
        if not trace_dir:
            raise SystemExit("--profile-steps bounds a capture and needs --profile DIR "
                             "for the trace directory")
        start, stop = cls.parse_range(spec)
        return cls(trace_dir, start, stop)

    def bind(self, device, rank: int = 0) -> None:
        """The device the steps run on (its activity is recorded) and the
        rank that names the trace file."""
        self.device = device
        self.rank = int(rank)

    def on_step_start(self, step: int) -> None:
        if self._disabled or self._prof is not None or self._captured:
            return
        if step < self.start or step >= self.stop:
            return
        try:
            from torch.profiler import profile

            self._prof = profile(activities=_activities(self.device))
            self._prof.__enter__()
        except Exception as exc:  # no profiler here: skip, loudly
            self._prof = None
            self._disabled = True
            log.warning(f"profiler trace capture unavailable ({type(exc).__name__}: {exc}); "
                        "skipping --profile-steps")
            return
        time.sleep(MARGIN_S)

    def on_step_end(self, step: int) -> None:
        if self._prof is None or step < self.stop - 1:
            return
        self._stop_trace()

    def _stop_trace(self) -> None:
        prof, self._prof = self._prof, None
        try:
            # the steps' device work lands inside the window
            _synchronize(self.device)
            time.sleep(MARGIN_S)
            prof.__exit__(None, None, None)
            self.trace_dir.mkdir(parents=True, exist_ok=True)
            self.path = self.trace_dir / _trace_name(f"steps-{self.start}-{self.stop}",
                                                     self.rank)
            prof.export_chrome_trace(str(self.path))
            self._captured = True
        except Exception as exc:  # pragma: no cover - profiler-specific
            self._disabled = True
            log.warning(f"profiler stop failed: {exc}")

    def close(self) -> dict:
        """Stop a capture still open (the run ended inside the range);
        returns the ``profile`` event's fields."""
        if self._prof is not None:
            self._stop_trace()
        return {"dir": str(self.trace_dir), "start": self.start, "stop": self.stop,
                "captured": self._captured}


@contextlib.contextmanager
def run_trace(trace_dir, device, rank: int = 0):
    """``--profile DIR`` without ``--profile-steps``: the whole body
    traced (host, and the card's device), written as
    ``DIR/trace[-r<rank>].json``."""
    from torch.profiler import profile

    trace_dir = Path(trace_dir)
    with profile(activities=_activities(device)) as prof:
        try:
            yield prof
        finally:
            _synchronize(device)
    trace_dir.mkdir(parents=True, exist_ok=True)
    path = trace_dir / _trace_name("trace", rank)
    prof.export_chrome_trace(str(path))
    log.info(f"profile: wrote {path}")
