"""Live observability plane: rolling windows, digests, and the exporter.

Everything ``obs/`` built so far is post-hoc - the sidecar is read after
the run exits.  This module is the in-run half: each process keeps a
BOUNDED rolling window of its recent telemetry (step times, loss,
data-wait, queue depth) fed from the same ``MetricsRecorder.record``
stream the sidecar gets, and a :class:`LiveExporter` that rides the
recorder's existing writer thread (no new thread) to push periodic
JSON digests to the rank-0/master aggregator (``obs/aggregator.py``),
which serves them over ``GET /metrics`` (Prometheus), ``/health``,
``/events`` and ``/fleet``.

Hot-path contract (the zero-overhead pin extends here):

- live export OFF (no ``--live`` flag / ``PDRNN_LIVE`` env, or telemetry
  off entirely) = nothing exists: no window, no exporter, no watchdog,
  no HTTP server, NO new threads, and the step program is untouched;
- live export ON adds one ``observe_event`` call inside ``record()``
  (which is already off the hot path - trainers emit step events in a
  deferred post-loop batch) and digest pushes on the writer thread's
  wake cadence.

:class:`RollingWindow` is THE windowing implementation - the serving
engine's ``stats`` op computes its req/s / tokens/s / shed/s rates from
the same class (one implementation, not two).

Wire contract: a digest is one JSON object POSTed to the aggregator's
``/push``; its ``id`` (``<role>-<rank>``) keys the fleet table.  Fields
(all optional beyond ``id``/``role``/``rank``/``t``):

=================== =======================================================
field               meaning
=================== =======================================================
id, role, rank, pid digest source identity (role: trainer | master |
                    worker | serve | supervisor)
t, tm               wall / monotonic stamp of the digest build
seq                 per-process digest counter (monotone)
progress            last step noted via ``note_progress``
progress_age_s      seconds since progress last ADVANCED (exporter-side
                    tracking - the live analogue of the sidecar
                    heartbeat-vs-progress health split)
finished            a ``run_summary`` landed (the run is over)
steps_total         step events observed since process start (counter)
step_s              {count, mean, p50, p95, last} over the window
loss                {last, mean, nonfinite_streak} over the window
data_wait_s_mean    window mean input-pipeline wait
queue_depth         {last, p95} over the window (serving / PS)
goodput_60s         fraction of the last minute spent in step compute
                    (windowed ``sum_rate`` of step durations, clamped
                    to 1) - the live analogue of the post-hoc ledger's
                    goodput
mfu_60s             windowed model-FLOPs utilisation: the analytic
                    per-step FLOPs the trainer recorded in its
                    ``collectives`` event x step rate / local peak
                    (absent until that event arrives)
nan_skips_total     non-finite guard skips (counter)
faults_total        {action: count} chaos faults fired (counter)
alerts_total        alert events observed (counter)
alerts              recent watchdog alerts (seq-tagged; the aggregator
                    dedupes by (id, seq) so re-pushed digests are safe)
roster              latest elastic-roster counts (master digests)
drained_slots       rank slots that DEREGISTERed voluntarily - the
                    aggregator classifies their silence as drained,
                    not dead
drained             this source itself is draining / drained
                    (``note_drained`` - a SIGTERMed serving replica
                    finishing in-flight work); the aggregator
                    classifies its silence as drained, not dead
serving             serving-engine gauge block (queue depth, windowed
                    req/s / tokens/s / shed/s, latency/TTFT p50/p95)
=================== =======================================================
"""

from __future__ import annotations

import bisect
import json
import logging
import math
import os
import threading
import time
from collections import deque

from pytorch_distributed_rnn_tpu_torch.obs.summary import percentile

log = logging.getLogger(__name__)

# env half of the CLI contract (the --live flag beats it), mirroring
# PDRNN_METRICS: spawned worker processes inherit the aggregator address
# without CLI plumbing
LIVE_ENV = "PDRNN_LIVE"
LIVE_PORT_FILE_ENV = "PDRNN_LIVE_PORT_FILE"
LIVE_PUSH_EVERY_ENV = "PDRNN_LIVE_PUSH_EVERY"

# the shared rate horizon: serving stats-op rates and live digests both
# answer "over the last minute"
RATE_HORIZON_S = 60.0

_DEFAULT_PUSH_EVERY_S = 1.0
_PUSH_TIMEOUT_S = 1.0
_ALERT_RING = 64  # recent alerts carried per digest


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


# THE request-latency histogram spec, shared by every layer that
# observes or interprets request latency: the serving engine and the
# fleet router construct their histograms via
# ``request_latency_histogram()`` below, and the time-series store
# (``obs/store.py``) interpolates window quantiles and SLO burn
# fractions over the SAME edges - cross-layer burn-rate math compares
# like with like by construction.  Prometheus' conventional buckets;
# the +Inf bucket is implicit (it equals ``count``).  The aggregator
# renders these as the series named by ``REQUEST_LATENCY_SERIES``.
LATENCY_BUCKETS_S = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

REQUEST_LATENCY_SERIES = "pdrnn_request_latency_seconds"


def request_latency_histogram() -> "LatencyHistogram":
    """The one constructor for the request-latency histogram behind
    ``REQUEST_LATENCY_SERIES`` - engine and router both build theirs
    here, so the bucket edges can never drift apart."""
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


def parse_live_spec(spec: str) -> tuple[str, int]:
    """``PORT`` or ``HOST:PORT`` -> (host, port).  The bare-port form
    binds/targets localhost - the single-machine spawn-world default."""
    spec = str(spec).strip()
    host, _, port_s = spec.rpartition(":")
    if not host:
        host, port_s = "127.0.0.1", spec
    try:
        port = int(port_s)
    except ValueError as exc:
        raise ValueError(
            f"bad live spec {spec!r} (want PORT or HOST:PORT)"
        ) from exc
    return host, port


def _finite_or_none(value):
    try:
        value = float(value)
    except (TypeError, ValueError):
        return None
    return value if math.isfinite(value) else None


def serving_idle(serving: dict | None) -> bool:
    """THE idleness predicate for a serving gauge block: no active
    slots and an empty queue means there is no work to progress on, so
    frozen decode-step progress is idleness, not a stall.  Shared by
    the in-process watchdog and the aggregator's health classifier so
    the two can never disagree about the same process."""
    return (
        serving is not None
        and not serving.get("active")
        and not serving.get("queue_depth")
    )


class LiveExporter:
    """Per-process live state + digest push.

    Fed by ``MetricsRecorder.record`` (``observe_event``); drained by
    the recorder's writer thread (``maybe_push`` on its wake cadence -
    no thread of its own).  ``sink`` is either a local
    :class:`~pytorch_distributed_rnn_tpu_torch.obs.aggregator.Aggregator`
    (rank 0 exports in-process, no HTTP to self) or an aggregator base
    URL (``http://host:port``) for remote ranks.  Push failures are
    swallowed - live telemetry must never kill the run."""

    def __init__(self, recorder, sink, *, role: str = "trainer",
                 push_every_s: float | None = None):
        self.recorder = recorder
        self.sink = sink
        self.role = str(role)
        self.rank = int(getattr(recorder, "rank", 0))
        self.id = f"{self.role}-{self.rank}"
        if push_every_s is None:
            push_every_s = float(
                os.environ.get(LIVE_PUSH_EVERY_ENV, _DEFAULT_PUSH_EVERY_S)
            )
        self.push_every_s = max(0.05, float(push_every_s))

        self.step_s = RollingWindow()
        self.loss = RollingWindow()
        self.data_wait_s = RollingWindow()
        self.queue_depth = RollingWindow()

        self._lock = threading.Lock()  # guards: _steps_total, _nan_skips, _faults, _alerts_total, _alerts
        self._steps_total = 0
        self._nan_skips = 0
        self._faults: dict[str, int] = {}
        self._alerts_total = 0
        self._alerts: deque[dict] = deque(maxlen=_ALERT_RING)
        self._roster = None
        self._drained_slots: set[int] = set()
        self.finished = False
        self.drained = False
        self.loss_nonfinite_streak = 0

        # efficiency-ledger live inputs: the trainer's collectives event
        # carries the analytic per-step model FLOPs; peak FLOPS is
        # resolved lazily (torch is already up in-process when training)
        self._model_flops_per_step = None
        self._peak_flops_total = None

        self._sources: list = []  # callables returning digest sub-dicts
        self._digest_seq = 0
        self._last_push = 0.0
        self._push_errors = 0
        # exporter-side progress tracking: progress_age_s in the digest
        # is the live analogue of the sidecar's heartbeat-vs-progress
        # split, computed here so the aggregator needs no clock deals
        self._progress_seen = None
        self._progress_tm = time.perf_counter()

    # -- feeding (any thread, via recorder.record) ---------------------------

    def observe_event(self, event: dict) -> None:
        kind = event.get("kind")
        if kind == "step":
            step_s = event.get("fenced_s")
            if step_s is None:
                step_s = event.get("dispatch_s")
            tm = time.perf_counter()  # windows use ARRIVAL time: the
            # trainer's deferred post-loop batch carries past dispatch
            # stamps, but window residency should reflect recency
            if step_s is not None:
                self.step_s.observe(step_s, tm)
            if event.get("data_wait_s") is not None:
                self.data_wait_s.observe(event["data_wait_s"], tm)
            if event.get("queue_depth") is not None:
                self.queue_depth.observe(event["queue_depth"], tm)
            loss = event.get("loss")
            with self._lock:
                self._steps_total += 1
                if loss is not None:
                    if _finite_or_none(loss) is None:
                        self.loss_nonfinite_streak += 1
                    else:
                        self.loss_nonfinite_streak = 0
                        self.loss.observe(loss, tm)
        elif kind == "nan_skip":
            with self._lock:
                self._nan_skips = int(event.get("total", self._nan_skips + 1))
        elif kind == "fault":
            action = str(event.get("action"))
            with self._lock:
                self._faults[action] = self._faults.get(action, 0) + 1
        elif kind == "alert":
            with self._lock:
                self._alerts_total += 1
                # fleet-born alerts (aggregator straggler findings the
                # master records) must not ride BACK in the digest - the
                # aggregator already has them
                if event.get("seq") is not None and not event.get("fleet"):
                    self._alerts.append({
                        k: v for k, v in event.items()
                        if k not in ("kind", "tm")
                    })
        elif kind == "collectives":
            flops = _finite_or_none(event.get("model_flops_per_step"))
            if flops is not None and flops > 0:
                with self._lock:
                    self._model_flops_per_step = flops
        elif kind == "run_summary":
            self.finished = True
        elif kind in ("member_join", "member_drain", "member_dead"):
            with self._lock:
                roster = {
                    k: event[k] for k in
                    ("joined", "drained", "dead", "done")
                    if k in event
                }
                if roster:
                    self._roster = roster
                slot = event.get("rank_slot")
                if slot is not None:
                    if kind == "member_drain":
                        self._drained_slots.add(int(slot))
                    else:
                        self._drained_slots.discard(int(slot))

    def note_drained(self) -> None:
        """Mark this source as voluntarily draining (a SIGTERMed serving
        replica finishing in-flight work before exit): every subsequent
        digest carries ``drained`` so the aggregator classifies the
        source's eventual silence as ``drained``, never ``dead``."""
        self.drained = True

    def note_alert(self, alert: dict) -> None:
        """Watchdog-side entry: queue an alert for the next digest (the
        sidecar ``alert`` event is recorded separately and feeds
        ``observe_event`` - this direct path exists for callers without
        a recorder, e.g. the supervisor pusher)."""
        with self._lock:
            self._alerts_total += 1
            self._alerts.append(dict(alert))

    def add_source(self, source) -> None:
        """Register a callable returning a dict merged into every digest
        under its own key (the serving engine contributes its gauge
        block this way)."""
        self._sources.append(source)

    # -- progress ------------------------------------------------------------

    def progress_age_s(self, now: float | None = None) -> float | None:
        """Seconds since ``note_progress`` last ADVANCED; None before
        the first noted step.  Refreshes the change stamp as a side
        effect (shared by the digest build and the watchdog)."""
        now = time.perf_counter() if now is None else now
        progress = getattr(self.recorder, "progress", None)
        with self._lock:
            if progress is None:
                return None
            if progress != self._progress_seen:
                self._progress_seen = progress
                self._progress_tm = now
            return now - self._progress_tm

    def source_snapshot(self) -> dict:
        """Merged extra-source dicts (watchdog SLO checks read serving
        gauges here without waiting for a digest)."""
        merged: dict = {}
        for source in self._sources:
            try:
                merged.update(source() or {})
            except Exception:  # pragma: no cover - sources must not kill
                log.exception("live: digest source failed")
        return merged

    # -- digest build + push -------------------------------------------------

    def digest(self, now: float | None = None) -> dict:
        now = time.perf_counter() if now is None else now
        age = self.progress_age_s(now)
        with self._lock:
            self._digest_seq += 1
            body = {
                "id": self.id, "role": self.role, "rank": self.rank,
                "pid": os.getpid(), "seq": self._digest_seq,
                "t": time.time(), "tm": now,
                "push_every_s": self.push_every_s,
                "progress": self._progress_seen,
                "progress_age_s": age,
                "finished": self.finished,
                "steps_total": self._steps_total,
                "nan_skips_total": self._nan_skips,
                "faults_total": dict(self._faults),
                "alerts_total": self._alerts_total,
                "alerts": list(self._alerts),
                "loss_nonfinite_streak": self.loss_nonfinite_streak,
            }
            if self._roster is not None:
                body["roster"] = dict(self._roster)
            if self._drained_slots:
                body["drained_slots"] = sorted(self._drained_slots)
            if self.drained:
                body["drained"] = True
        body["step_s"] = self.step_s.stats(now)
        loss_stats = self.loss.stats(now)
        body["loss"] = {
            "last": loss_stats["last"], "mean": loss_stats["mean"],
            "nonfinite_streak": body.pop("loss_nonfinite_streak"),
        }
        body["data_wait_s_mean"] = self.data_wait_s.stats(now)["mean"]
        depth = self.queue_depth.stats(now)
        body["queue_depth"] = {"last": depth["last"], "p95": depth["p95"]}
        body["goodput_60s"] = self.goodput_60s(now)
        body["mfu_60s"] = self.mfu_60s(now)
        body.update(self.source_snapshot())
        return body

    # -- live efficiency (the in-run half of obs/ledger.py) ------------------

    def goodput_60s(self, now: float | None = None) -> float | None:
        """Fraction of the effective window spent inside step compute
        (sum of step durations / window seconds, clamped to 1 - deferred
        batch arrival can momentarily stack more step-seconds than
        wall-seconds).  None before the first step lands."""
        now = time.perf_counter() if now is None else now
        if not self.step_s.values(now):
            return None
        return min(1.0, self.step_s.sum_rate(now))

    def mfu_60s(self, now: float | None = None) -> float | None:
        """Windowed MFU: analytic per-step model FLOPs (learned from the
        trainer's ``collectives`` event) x windowed step rate / local
        peak FLOPS.  None until the flops figure arrives or when no
        peak is resolvable."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            flops = self._model_flops_per_step
        if flops is None or not self.step_s.values(now):
            return None
        peak = self._resolve_peak()
        if not peak:
            return None
        return flops * self.step_s.count_rate(now) / peak

    def _resolve_peak(self) -> float | None:
        if self._peak_flops_total is None:
            try:
                from pytorch_distributed_rnn_tpu_torch.utils.hw import (
                    local_peak_flops,
                )

                self._peak_flops_total = float(
                    local_peak_flops().get("peak_flops_total") or 0.0
                )
            except Exception:  # pragma: no cover - peak must not kill
                self._peak_flops_total = 0.0
        return self._peak_flops_total or None

    def maybe_push(self) -> bool:
        """Writer-thread hook: push a digest when the cadence elapsed."""
        now = time.perf_counter()
        if now - self._last_push < self.push_every_s:
            return False
        self.push_now(now)
        return True

    def push_now(self, now: float | None = None) -> None:
        self._last_push = time.perf_counter() if now is None else now
        digest = self.digest(self._last_push)
        push_digest(self.sink, digest)


def push_digest(sink, digest: dict) -> bool:
    """Deliver one digest to ``sink``: a local Aggregator object (direct
    call) or an aggregator base URL (HTTP POST ``/push``).  Returns
    delivery success; failures are logged at debug (a dead aggregator
    must not spam or kill the run)."""
    if sink is None:
        return False
    if not isinstance(sink, str):
        try:
            sink.ingest(digest)
            return True
        except Exception:  # pragma: no cover - defensive
            log.exception("live: local aggregator ingest failed")
            return False
    import urllib.request

    req = urllib.request.Request(
        sink.rstrip("/") + "/push",
        data=json.dumps(digest, default=_jsonable).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=_PUSH_TIMEOUT_S):
            return True
    except (OSError, ValueError) as exc:
        log.debug(f"live: digest push to {sink} failed: {exc}")
        return False


def _jsonable(value):
    try:
        return float(value)
    except (TypeError, ValueError):
        return str(value)


def resolve_push_url(args, host: str, port: int,
                     wait_s: float = 10.0) -> str | None:
    """Push-target resolution for non-anchor processes.  An explicit
    port is used as-is.  Port 0 (ephemeral) is only knowable through
    the anchor's ``--live-port-file`` / ``PDRNN_LIVE_PORT_FILE``, so
    wait for it to appear (spawn worlds share a filesystem and the
    anchor binds before its rendezvous).  Unresolvable = a LOUD warning
    and no sink - pushing to the literal port 0 would silently drop
    every digest."""
    if port != 0:
        return f"http://{host}:{port}"
    port_file = (
        getattr(args, "live_port_file", None)
        or os.environ.get(LIVE_PORT_FILE_ENV)
    )
    if port_file:
        from pathlib import Path

        path = Path(port_file)
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            try:
                fields = path.read_text().split()
                if len(fields) == 2:
                    return f"http://{fields[0]}:{int(fields[1])}"
            except (OSError, ValueError):
                pass
            time.sleep(0.1)
    log.warning(
        "live: --live port 0 but no readable --live-port-file; this "
        "process cannot locate the aggregator - digest push disabled "
        "(give multi-process worlds an explicit port, or share a "
        "port file)"
    )
    return None


class EventPusher:
    """Minimal alert-only pusher for processes WITHOUT a recorder (the
    elastic supervisor parent): wraps each event as a digest carrying
    one alert, so supervisor respawn/collapse events land in the
    aggregator's ``/events`` and ``/metrics`` next to the fleet's.

    ``sink`` may also be a zero-arg callable resolved per push - the
    supervisor constructs its pusher BEFORE the master child binds an
    ephemeral --live 0 port, so the port-file lookup must be lazy."""

    def __init__(self, sink, *, role: str = "supervisor", rank: int = 0):
        self.sink = sink
        self.role, self.rank = str(role), int(rank)
        self.id = f"{self.role}-{self.rank}"
        self._seq = 0
        self._alerts_total = 0

    def push(self, kind: str, severity: str = "warning", **fields) -> None:
        self._seq += 1
        self._alerts_total += 1
        alert = {"alert": kind, "severity": severity, "seq": self._seq,
                 "t": time.time(), **fields}
        sink = self.sink() if callable(self.sink) else self.sink
        push_digest(sink, {
            "id": self.id, "role": self.role, "rank": self.rank,
            "pid": os.getpid(), "seq": self._seq,
            "t": time.time(), "tm": time.perf_counter(),
            # event-only source: it pushes when something HAPPENS, not
            # on a cadence - /health must not classify its silence as a
            # death
            "ephemeral": True,
            "alerts_total": self._alerts_total, "alerts": [alert],
        })


def resolve_event_push(args, *, role: str = "supervisor",
                       wait_s: float = 2.0):
    """The supervisor-parent push wiring, shared by every supervised
    runner (elastic PS, MPMD stages, streaming actors): an
    :class:`EventPusher` ``push`` bound to the run's aggregator, or
    ``None`` when the live plane is off.  Gated on BOTH ``--live`` and
    ``--metrics`` (matching LivePlane.resolve: live rides the metrics
    writer thread, so live-without-metrics is rejected there too).  The
    sink is lazy: with ``--live 0`` the anchor child binds its
    ephemeral port after the supervisor constructs the pusher, so the
    port file is only readable at push time."""
    from pytorch_distributed_rnn_tpu_torch.obs.recorder import METRICS_ENV

    live_spec = getattr(args, "live", None) or os.environ.get(LIVE_ENV)
    if not live_spec:
        return None
    if not (getattr(args, "metrics", None) or os.environ.get(METRICS_ENV)):
        return None
    host, port = parse_live_spec(live_spec)
    return EventPusher(
        lambda: resolve_push_url(args, host, port, wait_s=wait_s),
        role=role,
    ).push


class LivePlane:
    """The wired-together live plane of ONE process: exporter (+local
    aggregator HTTP server when this process is the rank-0/master
    anchor) + anomaly watchdog.  ``resolve`` is the one construction
    path every entry point shares (``--live`` flag beats the
    ``PDRNN_LIVE`` env), so live export can never be silently dropped
    by one of them; returns None when live export is off or telemetry
    is off entirely (the zero-overhead contract: nothing constructed,
    no threads)."""

    def __init__(self, exporter, aggregator=None, server=None,
                 watchdog=None, store=None):
        self.exporter = exporter
        self.aggregator = aggregator
        self.server = server
        self.watchdog = watchdog
        self.store = store

    @classmethod
    def resolve(cls, args, recorder, *, rank: int = 0,
                role: str = "trainer", faults=None,
                serve_here: bool | None = None):
        spec = getattr(args, "live", None) or os.environ.get(LIVE_ENV)
        if not spec or not getattr(recorder, "enabled", False):
            return None
        host, port = parse_live_spec(spec)
        if serve_here is None:
            serve_here = rank == 0
        # --slo objectives parse once here (the one construction path):
        # they arm the per-QoS watchdog SLO detector on EVERY live
        # process, and the anchor's store burns budgets against them
        from pytorch_distributed_rnn_tpu_torch.obs.store import parse_slo_args

        slo = parse_slo_args(getattr(args, "slo", None))
        aggregator = server = store = None
        if serve_here:
            from pytorch_distributed_rnn_tpu_torch.obs.aggregator import (
                Aggregator,
                AggregatorServer,
            )
            from pytorch_distributed_rnn_tpu_torch.obs.store import (
                DEFAULT_BURN_WINDOWS_S,
                TimeSeriesStore,
                store_path_for,
            )
            from pytorch_distributed_rnn_tpu_torch.obs.watchdog import (
                resolve_stall_after,
            )

            # the anchor owns the history: the store rides the
            # aggregator's ingest path (push handler threads / this
            # process's writer-thread pushes - no thread of its own),
            # snapshotting next to the sidecar for cold reads
            windows = getattr(args, "slo_windows", None)
            if windows:
                fast_s, _, slow_s = str(windows).partition(",")
                windows = (float(fast_s), float(slow_s))
            store = TimeSeriesStore(
                slo=slo,
                burn_windows_s=windows or DEFAULT_BURN_WINDOWS_S,
                snapshot_path=(
                    store_path_for(recorder.path)
                    if getattr(recorder, "path", None) else None
                ),
            )
            aggregator = Aggregator(
                stall_after_s=resolve_stall_after(), recorder=recorder,
                store=store,
            )
            server = AggregatorServer(aggregator, host=host, port=port)
            port_file = (
                getattr(args, "live_port_file", None)
                or os.environ.get(LIVE_PORT_FILE_ENV)
            )
            if port_file:
                from pathlib import Path

                port_file = Path(port_file)
                port_file.parent.mkdir(parents=True, exist_ok=True)
                port_file.write_text(f"{server.host} {server.port}\n")
            sink = aggregator
        else:
            sink = resolve_push_url(args, host, port)
        exporter = LiveExporter(recorder, sink, role=role)
        recorder.attach_live(exporter)

        from pytorch_distributed_rnn_tpu_torch.obs.watchdog import (
            AnomalyWatchdog,
        )

        watchdog = AnomalyWatchdog.resolve(
            recorder, exporter, faults=faults, slo=slo, store=store
        )
        if watchdog is not None:
            watchdog.start()
        log.info(
            f"live plane up: role={role} rank={rank} "
            + (f"serving http://{server.host}:{server.port}" if server
               else f"pushing to {sink}")
        )
        return cls(exporter, aggregator, server, watchdog, store)

    def close(self) -> None:
        """Stop the watchdog and the HTTP server; idempotent.  Call
        AFTER ``recorder.close()`` so the final digest push (finished
        state) lands before the server goes away."""
        if self.watchdog is not None:
            self.watchdog.close()
        if self.server is not None:
            self.server.close()
        if self.store is not None:
            # final snapshot regardless of the periodic throttle: a run
            # shorter than the cadence still leaves its history on disk
            try:
                self.store.write_snapshot()
            except OSError as exc:  # pragma: no cover - disk trouble
                log.warning(f"store snapshot on close failed: {exc}")
