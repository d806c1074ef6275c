"""Bounded time-series store: the historical half of the live plane.

The aggregator (``obs/aggregator.py``) keeps the LATEST digest per
source - every scrape forgets the past, so nothing upstream can answer
"is queue depth growing?", "what was p95 over the last 5 minutes?", or
"are we burning the SLO error budget?".  This module retains bounded
history behind those questions, fed from the aggregator's existing
``/push`` ingest path - digests arrive on ``/push`` handler threads (or
the anchor's recorder writer thread for the in-process sink), so the
store adds NO thread of its own, and the zero-overhead contract holds:
with the live plane off no store is constructed and ``record()`` is
untouched (the store lives entirely on the aggregator side of the
digest wire).

Ladder downsampling
-------------------

Each series keeps a short raw tail plus fixed-resolution tiers
(raw -> 10 s -> 60 s), every tier a bounded deque:

- **gauges** downsample to ``{min, mean, max, last, count}`` per bucket;
- **counters** (process-cumulative ``*_total`` values carried in
  digests) downsample to per-bucket ``increase``/``rate`` - consecutive
  deltas clamped at zero, so a respawned process's counter reset can
  never produce a negative rate and monotonicity survives both replica
  and aggregator restarts;
- **latency histograms** keep the last cumulative
  ``LatencyHistogram.snapshot()`` per bucket (the quantile sketch:
  window quantiles interpolate over bucket-count deltas between two
  cumulative snapshots, on the SAME ``obs/live.LATENCY_BUCKETS_S``
  edges the engine and router observe into - like compares with like).

``query(name, labels, window, agg)`` picks the finest tier whose
horizon covers the window.  Time is the STORE's monotonic clock stamped
at ingest (never the digest's ``tm`` - each process's perf_counter has
its own epoch, and never wall time - NTP steps would corrupt windows);
wall stamps ride along for display and cold snapshots only.  The
last-ingest stamp per source is monotone by construction, so gap-aware
derivatives (``rate_of``) and staleness checks never divide across a
paused digest stream: a source mid-checkpoint that resumes pushing
contributes slopes only over post-gap samples.

SLO burn rates (Google SRE multi-window)
----------------------------------------

``--slo 'qos=high:p95_ms=250:availability=99.9'`` objectives are parsed
here (:func:`parse_slo`).  For each objective the store computes the
error-budget burn rate over a fast and a slow window (defaults 5 m /
1 h): ``burn = observed-bad-fraction / budgeted-bad-fraction``; burn 1.0
consumes the budget exactly, so alerts fire strictly ABOVE 1.0 on both
windows (fast catches the onset, slow confirms it is not a blip) and
clear when the fast window recovers.  Availability burns over
disruption events - router view: errors + sheds (per objective QoS) +
reroutes (a reroute is a client-visible hit whose root cause is an
unavailable replica); engine view: failed + shed.  Latency burns over
the fraction of requests above the objective's ``p95_ms`` (budget: 5 %
may exceed it - the p95 contract), interpolated from histogram deltas.

Capacity signals
----------------

Derived per ingest (throttled to ~1 Hz) and queryable as series:
slot utilization (``active / num_slots``), queue growth d/dt (gap-safe
slope), per-replica goodput headroom (peak observed token rate x free
slot fraction), and an advisory ``recommended_replicas`` gauge -
demand over per-replica capacity at a target utilization, so a dead
replica's redistributed load (queue growth, inflight spike) raises the
recommendation while the fleet is degraded.  All of it is published on
``/metrics`` (see the registry in ``obs/aggregator.py``), served as
JSON on ``GET /series``, and rendered by ``pdrnn-metrics top``.

Snapshots: ``maybe_snapshot`` (rides the ingest cadence, throttled)
writes the downsampled tiers as JSONL next to the sidecar
(``<sidecar-stem>-store.jsonl``) via temp-file + ``os.replace`` -
crash-tolerant cold history for ``pdrnn-plan``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import threading
import time
from collections import deque
from pathlib import Path

from pytorch_distributed_rnn_tpu_torch.obs.live import (
    LATENCY_BUCKETS_S,
    REQUEST_LATENCY_SERIES,
)

log = logging.getLogger(__name__)

# the JAX package's fleet router's QoS classes (serving/fleet/router.py),
# which ``--slo`` objectives name
QOS_CLASSES = ("high", "normal", "low")

# Google SRE-style fast/slow burn windows (seconds)
DEFAULT_BURN_WINDOWS_S = (300.0, 3600.0)
# the p95 objective's implicit budget: 5% of requests may exceed the
# latency threshold (that is what "p95 <= X" tolerates)
LATENCY_BUDGET_FRAC = 0.05

# ladder tiers: (resolution_s, horizon_s); raw keeps RAW_HORIZON_S
RAW_HORIZON_S = 180.0
TIER_SPECS = ((10.0, 1800.0), (60.0, 7200.0))

_RAW_MAXLEN = 2048
_SOURCE_FORGET_S = 600.0  # known-replica horizon for capacity math
_CAPACITY_LOOKAHEAD_S = 5.0
_DERIVE_EVERY_S = 1.0
_SNAPSHOT_EVERY_S = 30.0
_GAP_S = 5.0  # a derivative never spans a larger inter-sample gap


def store_path_for(sidecar_path) -> Path:
    """The one cold-history location per aggregator: next to the
    (rank-suffixed) sidecar, ``<stem>-store.jsonl`` - the same adjacency
    convention as the watchdog's ``<stem>-stacks.txt``."""
    sidecar_path = Path(sidecar_path)
    return sidecar_path.with_name(f"{sidecar_path.stem}-store.jsonl")


# ---------------------------------------------------------------------------
# SLO objectives


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One per-QoS-class service-level objective (``--slo`` grammar:
    ``qos=high:p95_ms=250:availability=99.9``; both targets optional,
    at least one required)."""

    qos: str
    p95_ms: float | None = None
    availability: float | None = None  # percent, e.g. 99.9

    @property
    def availability_budget_frac(self) -> float | None:
        """The error budget as a fraction: 99.9% -> 0.001."""
        if self.availability is None:
            return None
        return (100.0 - self.availability) / 100.0

    def describe(self) -> str:
        parts = [f"qos={self.qos}"]
        if self.p95_ms is not None:
            parts.append(f"p95_ms={self.p95_ms:g}")
        if self.availability is not None:
            parts.append(f"availability={self.availability:g}")
        return ":".join(parts)


def parse_slo(spec: str) -> SloObjective:
    """One ``--slo`` value -> :class:`SloObjective`.  Grammar:
    colon-separated ``key=value`` fields; ``qos`` is required and must
    be a known class; at least one of ``p95_ms`` / ``availability``."""
    fields: dict[str, str] = {}
    for part in str(spec).split(":"):
        part = part.strip()
        if not part:
            continue
        key, eq, value = part.partition("=")
        if not eq:
            raise ValueError(
                f"bad --slo field {part!r} in {spec!r} (want key=value)"
            )
        fields[key.strip()] = value.strip()
    unknown = set(fields) - {"qos", "p95_ms", "availability"}
    if unknown:
        raise ValueError(
            f"unknown --slo field(s) {sorted(unknown)} in {spec!r}"
        )
    qos = fields.get("qos")
    if not qos:
        raise ValueError(f"--slo {spec!r} needs qos=<class>")
    if qos not in QOS_CLASSES:
        raise ValueError(
            f"--slo qos {qos!r} not one of {'|'.join(QOS_CLASSES)}"
        )
    p95_ms = availability = None
    if "p95_ms" in fields:
        p95_ms = float(fields["p95_ms"])
        if p95_ms <= 0:
            raise ValueError(f"--slo p95_ms must be > 0, got {p95_ms}")
    if "availability" in fields:
        availability = float(fields["availability"])
        if not 0.0 < availability < 100.0:
            raise ValueError(
                f"--slo availability must be in (0, 100), got {availability}"
            )
    if p95_ms is None and availability is None:
        raise ValueError(
            f"--slo {spec!r} needs p95_ms= and/or availability="
        )
    return SloObjective(qos=qos, p95_ms=p95_ms, availability=availability)


def parse_slo_args(values) -> tuple[SloObjective, ...]:
    """Repeatable ``--slo`` flag values -> objectives (one per QoS
    class; a duplicate class is a config error, not a silent merge)."""
    if values is None:
        return ()
    if isinstance(values, str):
        values = [values]
    objectives = [parse_slo(v) for v in values]
    seen: set[str] = set()
    for obj in objectives:
        if obj.qos in seen:
            raise ValueError(f"duplicate --slo for qos={obj.qos!r}")
        seen.add(obj.qos)
    return tuple(objectives)


# ---------------------------------------------------------------------------
# series plumbing


def _labels_key(labels: dict | None) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def _labels_match(key: tuple, want: dict | None) -> bool:
    if not want:
        return True
    have = dict(key)
    return all(have.get(str(k)) == str(v) for k, v in want.items())


def _hist_tuple(snapshot: dict) -> tuple | None:
    """Normalize a ``LatencyHistogram.snapshot()`` to
    ``(cum_counts_per_finite_le, total_count, total_sum)``."""
    try:
        counts = tuple(int(b["count"]) for b in snapshot["buckets"])
        return counts, int(snapshot["count"]), float(snapshot["sum"])
    except (KeyError, TypeError, ValueError):
        return None


def quantile_from_deltas(les, cum_counts, total, q) -> float | None:
    """Interpolated quantile over histogram bucket-count DELTAS
    (``cum_counts`` cumulative per finite ``le``; observations past the
    last edge clamp to it - the sketch cannot see further)."""
    if total <= 0:
        return None
    target = float(q) * total
    prev_le, prev_cum = 0.0, 0
    for le, cum in zip(les, cum_counts):
        if cum >= target:
            span = cum - prev_cum
            frac = 1.0 if span <= 0 else (target - prev_cum) / span
            return prev_le + frac * (float(le) - prev_le)
        prev_le, prev_cum = float(le), cum
    return float(les[-1])


def frac_above_from_deltas(les, cum_counts, total,
                           threshold_s) -> float | None:
    """Fraction of delta observations ABOVE ``threshold_s``,
    interpolating inside the straddling bucket."""
    if total <= 0:
        return None
    threshold_s = float(threshold_s)
    prev_le, prev_cum = 0.0, 0
    for le, cum in zip(les, cum_counts):
        le = float(le)
        if le >= threshold_s:
            span = le - prev_le
            frac = 1.0 if span <= 0 else (threshold_s - prev_le) / span
            below = prev_cum + frac * (cum - prev_cum)
            return max(0.0, min(1.0, 1.0 - below / total))
        prev_le, prev_cum = le, cum
    # threshold beyond the last finite edge: only overflow counts above
    return max(0.0, min(1.0, 1.0 - cum_counts[-1] / total
                        if cum_counts else 1.0))


class _Series:
    """One (name, labels) series: raw tail + downsampled tiers."""

    __slots__ = ("name", "labels", "kind", "raw", "tiers", "prev")

    def __init__(self, name: str, labels: tuple, kind: str,
                 tier_specs) -> None:
        self.name = name
        self.labels = labels
        self.kind = kind
        self.raw: deque = deque(maxlen=_RAW_MAXLEN)
        self.tiers: dict[float, deque] = {
            res: deque(maxlen=int(horizon / res) + 2)
            for res, horizon in tier_specs
        }
        self.prev = None  # last cumulative value (counter/hist resets)

    # -- append + incremental downsample ------------------------------------

    def append(self, tm: float, t: float, value) -> None:
        if self.kind == "hist":
            self._append_hist(tm, t, value)
            return
        value = float(value)
        self.raw.append((tm, t, value))
        if self.kind == "counter":
            prev = self.prev if self.prev is not None else value
            inc = max(0.0, value - prev)  # reset clamps at zero
            self.prev = value
            for res, buckets in self.tiers.items():
                idx = int(tm // res)
                if buckets and buckets[-1]["i"] == idx:
                    b = buckets[-1]
                    b["inc"] += inc
                    b["last"] = value
                    b["tm"] = tm
                    b["t"] = t
                else:
                    buckets.append({"i": idx, "tm0": tm, "tm": tm, "t": t,
                                    "inc": inc, "last": value})
        else:  # gauge
            for res, buckets in self.tiers.items():
                idx = int(tm // res)
                if buckets and buckets[-1]["i"] == idx:
                    b = buckets[-1]
                    b["min"] = min(b["min"], value)
                    b["max"] = max(b["max"], value)
                    b["sum"] += value
                    b["count"] += 1
                    b["last"] = value
                    b["tm"] = tm
                    b["t"] = t
                else:
                    buckets.append({"i": idx, "tm": tm, "t": t,
                                    "min": value, "max": value,
                                    "sum": value, "count": 1,
                                    "last": value})

    def _append_hist(self, tm: float, t: float, value: tuple) -> None:
        counts, total, total_sum = value
        self.raw.append((tm, t, counts, total, total_sum))
        for res, buckets in self.tiers.items():
            idx = int(tm // res)
            entry = {"i": idx, "tm": tm, "t": t, "counts": counts,
                     "count": total, "sum": total_sum}
            if buckets and buckets[-1]["i"] == idx:
                buckets[-1] = entry  # last cumulative snapshot wins
            else:
                buckets.append(entry)

    # -- reads (store lock held by caller) ----------------------------------

    def raw_points(self, since_tm: float) -> list:
        return [p for p in self.raw if p[0] >= since_tm]

    def tier_points(self, res: float, since_tm: float) -> list[dict]:
        return [b for b in self.tiers[res] if b["tm"] >= since_tm]

    def hist_delta(self, since_tm: float) -> tuple | None:
        """Cumulative delta across the window: last snapshot in window
        minus last snapshot before it (zeros when none - the process
        started inside the window).  Counter resets clamp at zero."""
        if self.kind != "hist" or not self.raw:
            return None
        end = base = None
        for point in self.raw:
            if point[0] < since_tm:
                base = point
            else:
                end = point
        if end is None:
            return None
        les = LATENCY_BUCKETS_S
        if base is None or base[3] > end[3]:  # none before, or a reset
            return end[2], end[3], end[4]
        counts = tuple(
            max(0, e - b) for e, b in zip(end[2], base[2])
        )
        return counts, max(0, end[3] - base[3]), max(0.0, end[4] - base[4])

    def counter_increase(self, since_tm: float) -> float:
        """Clamped increase over the window from raw points (deltas
        between consecutive in-window points, plus the step in from the
        last pre-window point)."""
        if self.kind != "counter":
            return 0.0
        prev = None
        total = 0.0
        for tm, _t, value in self.raw:
            if tm >= since_tm and prev is not None:
                total += max(0.0, value - prev)
            prev = value
        return total


class TimeSeriesStore:
    """Bounded multi-tier telemetry history + SLO burn + capacity."""

    def __init__(self, *, slo=(), burn_windows_s=DEFAULT_BURN_WINDOWS_S,
                 snapshot_path=None,
                 snapshot_every_s: float = _SNAPSHOT_EVERY_S,
                 raw_horizon_s: float = RAW_HORIZON_S,
                 tier_specs=TIER_SPECS,
                 stale_after_s: float = 5.0,
                 gap_s: float = _GAP_S,
                 slots_target_frac: float = 0.8):
        self.slo = tuple(slo)
        fast, slow = (float(w) for w in burn_windows_s)
        if not 0 < fast < slow:
            raise ValueError(
                f"burn windows must satisfy 0 < fast < slow, "
                f"got ({fast}, {slow})"
            )
        self.burn_windows_s = (fast, slow)
        self.snapshot_path = (
            None if snapshot_path is None else Path(snapshot_path)
        )
        self.snapshot_every_s = float(snapshot_every_s)
        self.raw_horizon_s = float(raw_horizon_s)
        self.tier_specs = tuple(
            (float(r), float(h)) for r, h in tier_specs
        )
        self.stale_after_s = float(stale_after_s)
        self.gap_s = float(gap_s)
        self.slots_target_frac = float(slots_target_frac)
        self._lock = threading.Lock()  # guards: _series, _sources, _healthy_load, _last_derive_tm, _last_snapshot_tm
        self._series: dict[tuple, _Series] = {}
        # per-source capacity inputs; last_tm is stamped MONOTONICALLY
        # from the store's own clock at ingest (never digest-carried
        # stamps - remote perf_counter epochs differ; never wall time -
        # NTP steps), so staleness and gap checks are exact
        self._sources: dict[str, dict] = {}
        self._healthy_load = None  # EWMA demand/replica, full fleet only
        self._last_derive_tm = None
        self._last_snapshot_tm = None

    # -- ingestion (on /push handler threads - no thread of our own) --------

    def ingest(self, digest: dict, now: float | None = None) -> None:
        """Extract series from one digest; called by
        ``Aggregator.ingest`` outside the aggregator's lock (lock order:
        never both held)."""
        now = time.perf_counter() if now is None else float(now)
        t = time.time()
        source = str(digest.get("id") or "")
        if not source or digest.get("ephemeral"):
            return  # event-only pushers carry alerts, not gauges
        role = str(digest.get("role") or "")
        labels = {"source": source, "role": role}
        with self._lock:
            entry = self._sources.setdefault(source, {"last_tm": now})
            # monotone by construction: perf_counter never steps back,
            # and a re-ingest can only move the stamp forward
            entry["last_tm"] = max(entry["last_tm"], now)
            entry["role"] = role
            entry["serving"] = digest.get("serving")
            entry["router"] = digest.get("router")
            entry["drained"] = bool(digest.get("drained"))
            self._ingest_locked(digest, labels, now, t)
            self._derive_locked(now, t)
        self.maybe_snapshot(now)

    def _put(self, name: str, labels: dict, kind: str, tm: float,
             t: float, value) -> None:  # holds: _lock
        if value is None:
            return
        if kind != "hist":
            try:
                value = float(value)
            except (TypeError, ValueError):
                return
            if not math.isfinite(value):
                return
        key = (name, _labels_key(labels))
        series = self._series.get(key)
        if series is None:
            series = _Series(name, key[1], kind, self.tier_specs)
            self._series[key] = series
        series.append(tm, t, value)

    def _ingest_locked(self, digest: dict, labels: dict, tm: float,
                       t: float) -> None:  # holds: _lock
        put = self._put
        put("pdrnn_steps_total", labels, "counter", tm, t,
            digest.get("steps_total") or None)
        loss = digest.get("loss") or {}
        put("pdrnn_loss", labels, "gauge", tm, t, loss.get("last"))
        put("pdrnn_goodput", labels, "gauge", tm, t,
            digest.get("goodput_60s"))
        serving = digest.get("serving") or {}
        router = digest.get("router") or {}
        depth = digest.get("queue_depth") or {}
        if serving:
            put("pdrnn_queue_depth", labels, "gauge", tm, t,
                serving.get("queue_depth"))
        elif depth.get("last") is not None:
            put("pdrnn_queue_depth", labels, "gauge", tm, t,
                depth.get("last"))
        if serving:
            put("pdrnn_serving_requests_total", labels, "counter", tm, t,
                serving.get("requests"))
            put("pdrnn_serving_requests_shed_total", labels, "counter",
                tm, t, serving.get("requests_shed"))
            put("pdrnn_serving_requests_failed_total", labels, "counter",
                tm, t, serving.get("requests_failed"))
            put("pdrnn_serving_tokens_total", labels, "counter", tm, t,
                serving.get("tokens_out"))
            put("pdrnn_serving_active", labels, "gauge", tm, t,
                serving.get("active"))
            put("pdrnn_serving_slots", labels, "gauge", tm, t,
                serving.get("num_slots"))
            put("pdrnn_serving_request_rate_per_s", labels, "gauge",
                tm, t, serving.get("req_per_s_60s"))
            put("pdrnn_serving_tokens_rate_per_s", labels, "gauge",
                tm, t, serving.get("tokens_per_s_60s"))
            for q, key in (("0.5", "latency_s_p50"),
                           ("0.95", "latency_s_p95")):
                put("pdrnn_serving_latency_seconds",
                    {**labels, "quantile": q}, "gauge", tm, t,
                    serving.get(key))
            active = serving.get("active")
            slots = serving.get("num_slots")
            if active is not None and slots:
                put("pdrnn_slot_utilization", labels, "gauge", tm, t,
                    float(active) / float(slots))
            hist = _hist_tuple(serving.get("latency_hist") or {})
            if hist is not None:
                put(REQUEST_LATENCY_SERIES, labels, "hist", tm, t, hist)
        if router:
            put("pdrnn_router_routed_total", labels, "counter", tm, t,
                router.get("routed"))
            put("pdrnn_router_errors_total", labels, "counter", tm, t,
                router.get("errors"))
            put("pdrnn_router_rerouted_total", labels, "counter", tm, t,
                router.get("rerouted"))
            put("pdrnn_router_retries_total", labels, "counter", tm, t,
                router.get("retries"))
            for qos, count in (router.get("shed") or {}).items():
                put("pdrnn_router_shed_total", {**labels, "qos": qos},
                    "counter", tm, t, count)
            put("pdrnn_router_inflight", labels, "gauge", tm, t,
                router.get("inflight"))
            put("pdrnn_router_max_inflight", labels, "gauge", tm, t,
                router.get("max_inflight"))
            put("pdrnn_router_request_rate_per_s", labels, "gauge",
                tm, t, router.get("req_per_s_60s"))
            for q, key in (("0.5", "latency_s_p50"),
                           ("0.95", "latency_s_p95")):
                put("pdrnn_router_latency_seconds",
                    {**labels, "quantile": q}, "gauge", tm, t,
                    router.get(key))
            for qos, p95 in (router.get("latency_s_p95_by_qos")
                             or {}).items():
                put("pdrnn_router_latency_seconds",
                    {**labels, "quantile": "0.95", "qos": qos},
                    "gauge", tm, t, p95)
            for state, count in (router.get("replicas") or {}).items():
                put("pdrnn_router_replicas", {**labels, "state": state},
                    "gauge", tm, t, count)
            hist = _hist_tuple(router.get("latency_hist") or {})
            if hist is not None:
                put(REQUEST_LATENCY_SERIES, labels, "hist", tm, t, hist)

    def _derive_locked(self, tm: float, t: float) -> None:  # holds: _lock
        """Append derived capacity/burn series on the ingest cadence,
        throttled to ~1 Hz so an N-source fleet does not multiply the
        fleet-level series by its own size."""
        if self._last_derive_tm is not None \
                and tm - self._last_derive_tm < _DERIVE_EVERY_S:
            return
        self._last_derive_tm = tm
        cap = self._capacity_locked(tm)
        put = self._put
        for source, sig in cap["sources"].items():
            labels = {"source": source}
            put("pdrnn_queue_growth_per_s", labels, "gauge", tm, t,
                sig.get("queue_growth_per_s"))
            put("pdrnn_goodput_headroom", labels, "gauge", tm, t,
                sig.get("goodput_headroom_tokens_per_s"))
        put("pdrnn_replicas_live", {}, "gauge", tm, t,
            cap.get("replicas_live"))
        put("pdrnn_recommended_replicas", {}, "gauge", tm, t,
            cap.get("recommended_replicas"))
        for burn in self._burn_rates_locked(tm):
            put("pdrnn_slo_burn_rate",
                {"qos": burn["qos"],
                 "window": format(burn["window_s"], "g")},
                "gauge", tm, t, burn["burn_rate"])

    # -- queries -------------------------------------------------------------

    def series_names(self) -> list[dict]:
        with self._lock:
            return [
                {"name": name, "labels": dict(labels), "kind": s.kind}
                for (name, labels), s in sorted(self._series.items())
            ]

    def _pick_tier(self, window: float) -> float | None:
        """None = raw; otherwise the finest tier covering the window."""
        if window <= self.raw_horizon_s:
            return None
        for res, horizon in self.tier_specs:
            if window <= horizon:
                return res
        return self.tier_specs[-1][0]

    def query(self, name: str, labels: dict | None = None, *,
              window: float = 60.0, agg: str | None = None,
              now: float | None = None) -> dict:
        """Downsampled history for every series matching ``name`` (and
        the ``labels`` subset): the finest tier whose horizon covers
        ``window``.  ``agg`` reduces each series to one value - gauges:
        ``min|mean|max|last``; counters: ``rate|increase``; histograms:
        ``p50|p95|p99|count``."""
        now = time.perf_counter() if now is None else float(now)
        window = float(window)
        since = now - window
        res = self._pick_tier(window)
        out = []
        with self._lock:
            matches = [
                s for (sname, skey), s in sorted(self._series.items())
                if sname == name and _labels_match(skey, labels)
            ]
            for s in matches:
                body: dict = {
                    "labels": dict(s.labels), "kind": s.kind,
                    "resolution_s": res or 0.0,
                    "points": self._points_locked(s, res, since),
                }
                if agg:
                    body["agg"] = agg
                    body["value"] = self._agg_locked(s, res, since, agg)
                out.append(body)
        return {"name": name, "window_s": window, "series": out}

    def _points_locked(self, s: _Series, res: float | None,
                       since: float) -> list[dict]:  # holds: _lock
        if res is None:
            if s.kind == "hist":
                return [
                    {"tm": tm, "t": t, "count": c, "sum": total}
                    for tm, t, _counts, c, total in s.raw_points(since)
                ]
            return [
                {"tm": tm, "t": t, "value": v}
                for tm, t, v in s.raw_points(since)
            ]
        points = []
        for b in s.tier_points(res, since):
            if s.kind == "gauge":
                points.append({
                    "tm": b["tm"], "t": b["t"], "min": b["min"],
                    "mean": b["sum"] / b["count"], "max": b["max"],
                    "last": b["last"], "count": b["count"],
                })
            elif s.kind == "counter":
                points.append({
                    "tm": b["tm"], "t": b["t"], "increase": b["inc"],
                    "rate": b["inc"] / res,
                })
            else:
                points.append({
                    "tm": b["tm"], "t": b["t"], "count": b["count"],
                    "sum": b["sum"],
                })
        return points

    def _agg_locked(self, s: _Series, res: float | None, since: float,
                    agg: str):  # holds: _lock
        if s.kind == "hist":
            delta = s.hist_delta(since)
            if delta is None:
                return None
            counts, total, _sum = delta
            if agg == "count":
                return total
            if agg in ("p50", "p95", "p99"):
                return quantile_from_deltas(
                    LATENCY_BUCKETS_S, counts, total,
                    float(agg[1:]) / 100.0,
                )
            raise ValueError(f"bad hist agg {agg!r} (p50|p95|p99|count)")
        if s.kind == "counter":
            increase = s.counter_increase(since)
            if agg == "increase":
                return increase
            if agg == "rate":
                pts = s.raw_points(since)
                if len(pts) < 2:
                    return None
                span = pts[-1][0] - pts[0][0]
                return None if span <= 0 else increase / span
            raise ValueError(f"bad counter agg {agg!r} (rate|increase)")
        values = [v for _tm, _t, v in s.raw_points(since)]
        if res is not None:  # beyond raw: reduce over tier buckets
            buckets = s.tier_points(res, since)
            if agg == "min":
                return min((b["min"] for b in buckets), default=None)
            if agg == "max":
                return max((b["max"] for b in buckets), default=None)
            if agg == "mean":
                count = sum(b["count"] for b in buckets)
                return None if not count else (
                    sum(b["sum"] for b in buckets) / count
                )
            if agg == "last":
                return buckets[-1]["last"] if buckets else None
            raise ValueError(f"bad gauge agg {agg!r} (min|mean|max|last)")
        if not values:
            return None
        if agg == "min":
            return min(values)
        if agg == "max":
            return max(values)
        if agg == "mean":
            return sum(values) / len(values)
        if agg == "last":
            return values[-1]
        raise ValueError(f"bad gauge agg {agg!r} (min|mean|max|last)")

    def rate_of(self, name: str, labels: dict | None = None, *,
                window: float = 30.0,
                now: float | None = None) -> float | None:
        """Gap-safe d/dt of a gauge: least-squares slope over the
        CONTIGUOUS tail segment of raw points (consecutive gaps <=
        ``gap_s``) inside the window.  A paused-then-resumed source
        contributes only post-gap samples; a stale series (last point
        older than ``gap_s``) yields None rather than a slope across
        silence."""
        now = time.perf_counter() if now is None else float(now)
        with self._lock:
            matches = [
                s for (sname, skey), s in self._series.items()
                if sname == name and _labels_match(skey, labels)
                and s.kind == "gauge"
            ]
            if not matches:
                return None
            pts: list[tuple[float, float]] = []
            for s in matches:
                pts.extend(
                    (tm, v) for tm, _t, v in s.raw_points(now - window)
                )
        pts.sort()
        if not pts or now - pts[-1][0] > self.gap_s:
            return None
        tail = [pts[-1]]
        for tm, v in reversed(pts[:-1]):
            if tail[-1][0] - tm > self.gap_s:
                break
            tail.append((tm, v))
        tail.reverse()
        if len(tail) < 2 or tail[-1][0] - tail[0][0] <= 0:
            return None
        n = len(tail)
        mean_t = sum(tm for tm, _ in tail) / n
        mean_v = sum(v for _, v in tail) / n
        var = sum((tm - mean_t) ** 2 for tm, _ in tail)
        if var <= 0:
            return None
        cov = sum((tm - mean_t) * (v - mean_v) for tm, v in tail)
        return cov / var

    def last_ingest_age_s(self, source: str,
                          now: float | None = None) -> float | None:
        now = time.perf_counter() if now is None else float(now)
        with self._lock:
            entry = self._sources.get(str(source))
            return None if entry is None else now - entry["last_tm"]

    # -- SLO burn ------------------------------------------------------------

    def _window_counter_increase(self, name: str, labels: dict | None,
                                 since: float) -> float:  # holds: _lock
        total = 0.0
        for (sname, skey), s in self._series.items():
            if sname == name and _labels_match(skey, labels):
                total += s.counter_increase(since)
        return total

    def _window_hist_delta(self, role: str,
                           since: float) -> tuple:  # holds: _lock
        counts = [0] * len(LATENCY_BUCKETS_S)
        total = 0
        for (sname, skey), s in self._series.items():
            if sname != REQUEST_LATENCY_SERIES or s.kind != "hist":
                continue
            if not _labels_match(skey, {"role": role}):
                continue
            delta = s.hist_delta(since)
            if delta is None:
                continue
            for i, c in enumerate(delta[0]):
                counts[i] += c
            total += delta[1]
        return tuple(counts), total

    def _burn_rates_locked(self, now: float) -> list[dict]:  # holds: _lock
        out = []
        router_view = any(
            sname == "pdrnn_router_routed_total"
            for (sname, _), _s in self._series.items()
        )
        role = "router" if router_view else "serve"
        for obj in self.slo:
            for window in self.burn_windows_s:
                since = now - window
                entry = {
                    "qos": obj.qos, "window_s": window,
                    "objective": obj.describe(),
                }
                burns = []
                if obj.availability is not None:
                    budget = obj.availability_budget_frac
                    if router_view:
                        # disruption events: final errors, this class's
                        # sheds, and reroutes - a reroute succeeded on a
                        # sibling, but its root cause is an unavailable
                        # replica, which is exactly what the budget
                        # meters (errors/reroutes are not QoS-labelled:
                        # fleet-wide, charged to every objective)
                        bad = (
                            self._window_counter_increase(
                                "pdrnn_router_errors_total", None, since)
                            + self._window_counter_increase(
                                "pdrnn_router_shed_total",
                                {"qos": obj.qos}, since)
                            + self._window_counter_increase(
                                "pdrnn_router_rerouted_total", None,
                                since)
                        )
                        good = self._window_counter_increase(
                            "pdrnn_router_routed_total", None, since)
                    else:
                        bad = (
                            self._window_counter_increase(
                                "pdrnn_serving_requests_failed_total",
                                None, since)
                            + self._window_counter_increase(
                                "pdrnn_serving_requests_shed_total",
                                None, since)
                        )
                        good = self._window_counter_increase(
                            "pdrnn_serving_requests_total", None, since)
                    total = good + bad
                    frac = 0.0 if total <= 0 else bad / total
                    entry["availability_bad"] = bad
                    entry["availability_total"] = total
                    burns.append(0.0 if budget <= 0 else frac / budget)
                if obj.p95_ms is not None:
                    counts, total = self._window_hist_delta(role, since)
                    frac = frac_above_from_deltas(
                        LATENCY_BUCKETS_S, counts, total,
                        obj.p95_ms / 1e3,
                    )
                    entry["latency_total"] = total
                    if frac is not None:
                        entry["latency_frac_above"] = frac
                        burns.append(frac / LATENCY_BUDGET_FRAC)
                entry["burn_rate"] = max(burns) if burns else 0.0
                out.append(entry)
        return out

    def burn_rates(self, now: float | None = None) -> list[dict]:
        """One entry per (objective, window): the error-budget burn rate
        plus its inputs.  Burn 1.0 = consuming the budget exactly."""
        now = time.perf_counter() if now is None else float(now)
        with self._lock:
            return self._burn_rates_locked(now)

    def burn_snapshot(self, now: float | None = None) -> dict:
        """Per-objective alert inputs: ``{qos: {fast, slow, fire}}``.
        ``fire`` is True only when BOTH windows burn strictly above 1.0
        (fast catches the onset, slow confirms it is not a blip;
        exactly-at-budget does NOT fire - burning the whole budget and
        no more is the contract, not a breach)."""
        rates = self.burn_rates(now)
        fast_w, slow_w = self.burn_windows_s
        out: dict[str, dict] = {}
        for entry in rates:
            slot = out.setdefault(entry["qos"], {
                "fast": 0.0, "slow": 0.0,
                "objective": entry["objective"],
            })
            if entry["window_s"] == fast_w:
                slot["fast"] = entry["burn_rate"]
            elif entry["window_s"] == slow_w:
                slot["slow"] = entry["burn_rate"]
        for slot in out.values():
            slot["fire"] = slot["fast"] > 1.0 and slot["slow"] > 1.0
        return out

    # -- capacity ------------------------------------------------------------

    def _capacity_locked(self, now: float) -> dict:  # holds: _lock
        sources: dict[str, dict] = {}
        serve_live = serve_known = 0
        demand_slots = 0.0
        slot_counts: list[float] = []
        for source, entry in list(self._sources.items()):
            age = now - entry["last_tm"]
            if age > _SOURCE_FORGET_S:
                del self._sources[source]
                continue
            serving = entry.get("serving") or {}
            sig: dict = {"age_s": age, "role": entry.get("role")}
            if serving:
                serve_known += 1
                live = age <= self.stale_after_s \
                    and not entry.get("drained")
                sig["live"] = live
                active = serving.get("active")
                slots = serving.get("num_slots")
                depth = serving.get("queue_depth")
                if active is not None and slots:
                    sig["slot_utilization"] = (
                        float(active) / float(slots)
                    )
                growth = self._rate_of_locked(
                    "pdrnn_queue_depth", {"source": source}, now)
                sig["queue_growth_per_s"] = growth
                peak = self._gauge_peak_locked(
                    "pdrnn_serving_tokens_rate_per_s",
                    {"source": source}, now)
                if peak is not None and slots and active is not None:
                    # spare tokens/s estimate: the replica's peak
                    # observed rate scaled by its free slot fraction
                    free_frac = max(
                        0.0, 1.0 - float(active) / float(slots))
                    sig["goodput_headroom_tokens_per_s"] = (
                        peak * free_frac
                    )
                if live:
                    serve_live += 1
                    if slots:
                        slot_counts.append(float(slots))
                    demand_slots += float(active or 0) \
                        + float(depth or 0)
                    if growth is not None and growth > 0:
                        demand_slots += growth * _CAPACITY_LOOKAHEAD_S
            sources[source] = sig
        cap: dict = {"sources": sources}
        if serve_known:
            # engine view: demand in SLOTS vs per-replica slot capacity
            # at the target utilization - a dead replica's redistributed
            # queue shows up as survivor demand and raises the ask
            slots_per = (
                sum(slot_counts) / len(slot_counts) if slot_counts
                else None
            )
            cap["replicas_live"] = serve_live
            cap["replicas_known"] = serve_known
            cap["demand_slots"] = demand_slots
            if slots_per:
                cap["recommended_replicas"] = max(1, math.ceil(
                    demand_slots / (self.slots_target_frac * slots_per)
                ))
            return cap
        # router view: pool states carry liveness; demand is router
        # inflight (plus its growth) against the per-replica load the
        # fleet carried while FULLY healthy (EWMA baseline) - a killed
        # replica spikes inflight while the baseline holds, and the
        # live-fraction derate below covers the fast-request regime, so
        # the recommendation rises exactly over the dead-replica interval
        states: dict[str, float] = {}
        inflight = 0.0
        router_sources = []
        for source, entry in self._sources.items():
            router = entry.get("router") or {}
            if not router or now - entry["last_tm"] > self.stale_after_s:
                continue
            router_sources.append(source)
            inflight += float(router.get("inflight") or 0)
            for state, count in (router.get("replicas") or {}).items():
                states[state] = states.get(state, 0) + float(count)
        if not router_sources:
            return cap
        total = sum(states.values())
        live = states.get("healthy", 0.0) + states.get("half_open", 0.0)
        growth = self._rate_of_locked("pdrnn_router_inflight", None, now)
        demand = inflight + max(0.0, growth or 0.0) * _CAPACITY_LOOKAHEAD_S
        for source in router_sources:
            sources[source]["queue_growth_per_s"] = growth
        if total and live >= total and demand > 0:
            per_replica = demand / total
            self._healthy_load = (
                per_replica if self._healthy_load is None
                else 0.7 * self._healthy_load + 0.3 * per_replica
            )
        cap["replicas_live"] = live
        cap["replicas_known"] = total
        cap["demand_inflight"] = demand
        baseline = self._healthy_load
        recommended = max(1.0, total)
        if baseline and baseline > 0:
            recommended = max(
                recommended,
                math.ceil(demand / max(
                    baseline, 1e-9) * self.slots_target_frac),
            )
        if total and live < total and self._window_counter_increase(
                "pdrnn_router_routed_total", None, now - 30.0) > 0:
            # dead replica(s) while traffic flows: derate the ask by the
            # observed live fraction (3 configured at 2/3 live need
            # ceil(3 / (2/3)) = 5 provisioned for 3 live) so replacement
            # capacity is advised for as long as the outage lasts - the
            # inflight spike alone is invisible when requests are much
            # faster than the eject window.  Clears when the pool heals
            recommended = max(
                recommended, math.ceil(total * total / max(live, 1.0)),
            )
        cap["recommended_replicas"] = int(recommended)
        return cap

    def _rate_of_locked(self, name, labels, now):  # holds: _lock
        # rate_of re-takes the lock; inline the hot part instead
        matches = [
            s for (sname, skey), s in self._series.items()
            if sname == name and _labels_match(skey, labels)
            and s.kind == "gauge"
        ]
        pts: list[tuple[float, float]] = []
        for s in matches:
            pts.extend((tm, v) for tm, _t, v in s.raw_points(now - 30.0))
        pts.sort()
        if not pts or now - pts[-1][0] > self.gap_s:
            return None
        tail = [pts[-1]]
        for tm, v in reversed(pts[:-1]):
            if tail[-1][0] - tm > self.gap_s:
                break
            tail.append((tm, v))
        tail.reverse()
        if len(tail) < 2:
            return None
        n = len(tail)
        mean_t = sum(tm for tm, _ in tail) / n
        mean_v = sum(v for _, v in tail) / n
        var = sum((tm - mean_t) ** 2 for tm, _ in tail)
        if var <= 0:
            return None
        return sum(
            (tm - mean_t) * (v - mean_v) for tm, v in tail
        ) / var

    def _gauge_peak_locked(self, name, labels, now,
                           window=600.0):  # holds: _lock
        res = self._pick_tier(window) or self.tier_specs[0][0]
        peak = None
        for (sname, skey), s in self._series.items():
            if sname != name or not _labels_match(skey, labels) \
                    or s.kind != "gauge":
                continue
            for b in s.tier_points(res, now - window):
                peak = b["max"] if peak is None else max(peak, b["max"])
        return peak

    def capacity(self, now: float | None = None) -> dict:
        """Fleet capacity signals: per-source utilization / queue growth
        / headroom plus the advisory ``recommended_replicas``."""
        now = time.perf_counter() if now is None else float(now)
        with self._lock:
            return self._capacity_locked(now)

    # -- Prometheus ----------------------------------------------------------

    def prometheus_samples(self, now: float | None = None) -> list:
        """Capacity + burn gauges in ``render_prometheus`` sample form
        (appended to the aggregator's exposition)."""
        now = time.perf_counter() if now is None else float(now)
        samples: list = []

        def add(name, labels, value):
            if value is not None:
                samples.append((name, labels, value, "gauge"))

        cap = self.capacity(now)
        for source, sig in cap["sources"].items():
            labels = {"source": source}
            add("pdrnn_slot_utilization", labels,
                sig.get("slot_utilization"))
            add("pdrnn_queue_growth_per_s", labels,
                sig.get("queue_growth_per_s"))
            add("pdrnn_goodput_headroom", labels,
                sig.get("goodput_headroom_tokens_per_s"))
        add("pdrnn_replicas_live", {}, cap.get("replicas_live"))
        add("pdrnn_recommended_replicas", {},
            cap.get("recommended_replicas"))
        for burn in self.burn_rates(now):
            add("pdrnn_slo_burn_rate",
                {"qos": burn["qos"],
                 "window": format(burn["window_s"], "g")},
                burn["burn_rate"])
        return samples

    # -- snapshots -----------------------------------------------------------

    def maybe_snapshot(self, now: float | None = None) -> Path | None:
        """Throttled snapshot on the ingest cadence (no timer thread);
        returns the path when one was written."""
        if self.snapshot_path is None:
            return None
        now = time.perf_counter() if now is None else float(now)
        with self._lock:
            if self._last_snapshot_tm is not None \
                    and now - self._last_snapshot_tm \
                    < self.snapshot_every_s:
                return None
            self._last_snapshot_tm = now
        return self.write_snapshot()

    def write_snapshot(self, path=None) -> Path | None:
        """Write the downsampled tiers as JSONL (one meta line, one line
        per series) via temp-file + ``os.replace`` - a crash mid-write
        leaves the previous snapshot intact, never a torn file."""
        path = self.snapshot_path if path is None else Path(path)
        if path is None:
            return None
        with self._lock:
            lines = [json.dumps({
                "kind": "store_meta", "schema": 1, "t": time.time(),
                "slo": [obj.describe() for obj in self.slo],
                "burn_windows_s": list(self.burn_windows_s),
                "tiers_s": [r for r, _ in self.tier_specs],
            })]
            for (name, labels), s in sorted(self._series.items()):
                tiers = {}
                for res, _horizon in self.tier_specs:
                    tiers[format(res, "g")] = [
                        {k: v for k, v in b.items() if k != "i"}
                        for b in s.tiers[res]
                    ]
                lines.append(json.dumps({
                    "kind": "series", "name": name,
                    "labels": dict(labels), "series_kind": s.kind,
                    "tiers": tiers,
                }, default=str))
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(path.name + ".tmp")
            tmp.write_text("\n".join(lines) + "\n")
            os.replace(tmp, path)
            return path
        except OSError as exc:
            log.warning(f"store: snapshot to {path} failed: {exc}")
            return None


def load_snapshot(path) -> dict:
    """Read a store snapshot back (``pdrnn-plan``'s cold-history entry
    point): ``{"meta": {...}, "series": [...]}``.  Torn trailing lines
    (a crash between writes cannot produce one, but a foreign truncation
    can) are skipped, not fatal."""
    meta: dict = {}
    series: list[dict] = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            entry = json.loads(line)
        except ValueError:
            continue
        if entry.get("kind") == "store_meta":
            meta = entry
        elif entry.get("kind") == "series":
            series.append(entry)
    return {"meta": meta, "series": series}
