"""Rolling rate windows and the request-latency histogram: the parts of
the JAX package's ``obs/live.py`` that the serving engine reads (its
``stats`` rates and its latency histogram).  The digests, the exporter
and the live plane are not ported yet.  Plain ``threading.Lock`` where the
JAX module wraps its locks in its debug lock checker."""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque

from pytorch_distributed_rnn_tpu_torch.obs.summary import percentile

# the shared rate horizon: serving stats-op rates answer "over the last
# minute"
RATE_HORIZON_S = 60.0


class RollingWindow:
    """Bounded (monotonic-time, value) observation window.

    Two bounds compose: observations older than ``horizon_s`` are
    evicted, and ``maxlen`` caps memory however fast observations
    arrive.  Rates divide by the EFFECTIVE window - ``min(horizon,
    age-of-window)`` - so a server 10 s into its life reports an honest
    10 s rate instead of a 60 s-diluted one.  Thread-safe."""

    def __init__(self, horizon_s: float = RATE_HORIZON_S,
                 maxlen: int = 4096):
        self.horizon_s = float(horizon_s)
        self._items: deque[tuple[float, float]] = deque(maxlen=int(maxlen))
        self._lock = threading.Lock()  # guards: _items
        self._created = time.perf_counter()

    def observe(self, value: float, tm: float | None = None) -> None:
        now = time.perf_counter() if tm is None else float(tm)
        with self._lock:
            self._items.append((now, float(value)))
            self._evict(now)

    def _evict(self, now: float) -> None:  # holds: _lock
        cutoff = now - self.horizon_s
        items = self._items
        while items and items[0][0] < cutoff:
            items.popleft()

    def values(self, now: float | None = None) -> list[float]:
        now = time.perf_counter() if now is None else now
        with self._lock:
            self._evict(now)
            return [v for _, v in self._items]

    def last(self) -> float | None:
        with self._lock:
            return self._items[-1][1] if self._items else None

    def _window_s(self, now: float) -> float:
        return max(1e-9, min(self.horizon_s, now - self._created))

    def count_rate(self, now: float | None = None) -> float:
        """Observations per second over the effective window."""
        now = time.perf_counter() if now is None else now
        return len(self.values(now)) / self._window_s(now)

    def sum_rate(self, now: float | None = None) -> float:
        """Sum of observed values per second over the effective window
        (tokens/s when each observation is a request's token count)."""
        now = time.perf_counter() if now is None else now
        return sum(self.values(now)) / self._window_s(now)

    def stats(self, now: float | None = None) -> dict:
        """``{count, mean, p50, p95, last}`` over the live window (the
        percentile convention is ``obs/summary.percentile`` - shared
        with every post-hoc summary)."""
        values = self.values(now)
        if not values:
            return {"count": 0, "mean": None, "p50": None, "p95": None,
                    "last": None}
        ordered = sorted(values)
        return {
            "count": len(values),
            "mean": sum(values) / len(values),
            "p50": percentile(ordered, 0.50),
            "p95": percentile(ordered, 0.95),
            "last": values[-1],
        }


# THE request-latency histogram spec (the JAX package's edges):
# Prometheus' conventional buckets; the +Inf bucket is implicit (it
# equals ``count``).
LATENCY_BUCKETS_S = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def request_latency_histogram() -> "LatencyHistogram":
    """The one constructor for the request-latency histogram, so the
    bucket edges can never drift apart."""
    return LatencyHistogram(LATENCY_BUCKETS_S)


class LatencyHistogram:
    """Fixed-bucket latency histogram with OpenMetrics exemplars.

    Cumulative counts over :data:`LATENCY_BUCKETS_S` (``le`` inclusive,
    the Prometheus convention); each finite bucket remembers the LAST
    traced observation that landed in it (trace_id + value + wall
    stamp), so a slow-tail bucket on ``/metrics`` links straight to a
    trace pullable with ``pdrnn-metrics trace``.  Untraced observations
    still count - they just carry no exemplar.  Thread-safe."""

    def __init__(self, buckets=LATENCY_BUCKETS_S):
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # last = overflow
        self._sum = 0.0
        self._count = 0
        self._exemplars: list[dict | None] = [None] * len(self.buckets)
        self._lock = threading.Lock()  # guards: _counts, _sum, _count, _exemplars

    def observe(self, seconds: float,
                trace_id: str | None = None) -> None:
        seconds = float(seconds)
        index = bisect.bisect_left(self.buckets, seconds)
        with self._lock:
            self._counts[index] += 1
            self._sum += seconds
            self._count += 1
            if trace_id is not None and index < len(self.buckets):
                self._exemplars[index] = {
                    "trace_id": str(trace_id), "value": seconds,
                    "t": time.time(),
                }

    def snapshot(self) -> dict | None:
        """Digest form: cumulative ``buckets`` (le/count/exemplar?),
        ``sum``, ``count``; None while empty (an idle source should not
        export an all-zero histogram)."""
        with self._lock:
            if self._count == 0:
                return None
            counts = list(self._counts)
            exemplars = [
                None if e is None else dict(e) for e in self._exemplars
            ]
            total, count = self._sum, self._count
        buckets, running = [], 0
        for i, le in enumerate(self.buckets):
            running += counts[i]
            entry: dict = {"le": le, "count": running}
            if exemplars[i] is not None:
                entry["exemplar"] = exemplars[i]
            buckets.append(entry)
        return {"buckets": buckets, "sum": total, "count": count}
