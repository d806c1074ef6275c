"""Fleet aggregator: digest ingestion, live health, Prometheus export.

The rank-0/master half of the live plane (``obs/live.py``): every
process pushes periodic JSON digests here; the aggregator keeps the
latest digest per source, classifies liveness with the SAME semantics
as the post-hoc classifier (``obs/summary.rank_health``: ok / stalled /
dead / drained / finished - here on live digests instead of sidecar
event streams), detects fleet-level stragglers, and serves it all over
a tiny stdlib HTTP server:

- ``GET /metrics`` - Prometheus text exposition (version 0.0.4).
  Counters are PROCESS-cumulative values carried in the digests
  (``*_total``), so an aggregator restart reports the same counter
  values the moment digests arrive again - monotonicity survives the
  restart because the aggregator never owns a counter.  Gauges with
  NaN/Inf values are dropped from the exposition (Prometheus ingests
  NaN as a real sample that poisons aggregation).  Label values are
  escaped per the exposition spec (backslash, double-quote, newline).
- ``GET /health`` - per-source status JSON; HTTP 200 when every source
  is ok/finished/drained, 503 when any is stalled/dead (probe-able).
- ``GET /events`` - recent alerts (watchdog + fleet), newest last.
- ``GET /fleet`` - the raw digest table (what ``pdrnn-metrics watch``
  renders).
- ``GET /series?name=...&window=...`` - downsampled history from the
  bound time-series store (``obs/store.py``; 404 when none is bound).
  Optional ``agg`` (gauge ``min|mean|max|last``, counter
  ``rate|increase``, histogram ``p50|p95|p99|count``) and any other
  query key as a label filter.  Without ``name``: the series catalog.
- ``POST /push`` - digest ingestion.  When a store is bound, every
  ingested digest also feeds it (on this handler thread / the anchor's
  writer thread - the store never runs a thread of its own).

Prometheus metric names (documented next to the sidecar event schema in
``obs/recorder.py``; labels ``rank``/``role`` on all per-source series):

=============================================== ============ ==========
name                                            type         source
=============================================== ============ ==========
pdrnn_up                                        gauge        freshness
pdrnn_last_push_age_seconds                     gauge        aggregator
pdrnn_progress_age_seconds                      gauge        digest
pdrnn_steps_total                               counter      digest
pdrnn_step_seconds{quantile="0.5"|"0.95"}       gauge        window
pdrnn_step_seconds_mean                         gauge        window
pdrnn_loss                                      gauge        window
pdrnn_data_wait_seconds_mean                    gauge        window
pdrnn_queue_depth                               gauge        window
pdrnn_goodput                                   gauge        window
pdrnn_mfu                                       gauge        window
pdrnn_nan_skips_total                           counter      digest
pdrnn_faults_total{action=...}                  counter      digest
pdrnn_alerts_total                              counter      digest
pdrnn_serving_requests_total                    counter      engine
pdrnn_serving_requests_shed_total               counter      engine
pdrnn_serving_requests_failed_total             counter      engine
pdrnn_serving_tokens_total                      counter      engine
pdrnn_serving_request_rate_per_s                gauge        window
pdrnn_serving_tokens_rate_per_s                 gauge        window
pdrnn_serving_shed_rate_per_s                   gauge        window
pdrnn_serving_latency_seconds{quantile=...}     gauge        window
pdrnn_serving_ttft_seconds{quantile=...}        gauge        window
pdrnn_router_inflight                           gauge        router
pdrnn_router_replicas{state=...}                gauge        router
pdrnn_router_routed_total                       counter      router
pdrnn_router_rerouted_total                     counter      router
pdrnn_router_retries_total                      counter      router
pdrnn_router_hedges_total                       counter      router
pdrnn_router_hedge_wins_total                   counter      router
pdrnn_router_shed_total{qos=...}                counter      router
pdrnn_router_errors_total                       counter      router
pdrnn_router_request_rate_per_s                 gauge        window
pdrnn_router_latency_seconds{quantile=...}      gauge        window
pdrnn_request_latency_seconds{le=...}           histogram    histogram
pdrnn_slot_utilization{source=...}              gauge        store
pdrnn_queue_growth_per_s{source=...}            gauge        store
pdrnn_goodput_headroom{source=...}              gauge        store
pdrnn_replicas_live                             gauge        store
pdrnn_recommended_replicas                      gauge        store
pdrnn_slo_burn_rate{qos=...,window=...}         gauge        store
=============================================== ============ ==========

The ``store``-sourced series (capacity + SLO burn; present only when a
time-series store is bound, i.e. on the live-plane anchor) are derived
history, not digest pass-throughs: ``pdrnn_slot_utilization`` is
``active / num_slots`` per serving source; ``pdrnn_queue_growth_per_s``
is the gap-safe queue-depth slope (never computed across a paused
digest stream); ``pdrnn_goodput_headroom`` estimates spare tokens/s
from the peak observed rate times the free slot fraction;
``pdrnn_replicas_live`` / ``pdrnn_recommended_replicas`` are the fleet
liveness count and the advisory scale target (demand over per-replica
capacity at the target utilization); ``pdrnn_slo_burn_rate`` is the
error-budget burn per ``--slo`` objective and burn window (label
``window`` in seconds, e.g. ``"300"``/``"3600"``).  The same numbers
are queryable with history via ``GET /series`` and rendered by
``pdrnn-metrics top``.

``pdrnn_request_latency_seconds`` is the request-latency histogram
(``obs/live.LatencyHistogram``): the serving engine and the router each
carry one in their digests, exported as cumulative ``_bucket{le=...}``
series plus ``_sum``/``_count``, distinguished by the ``role`` label.
Buckets that last saw a TRACED request carry an OpenMetrics-style
exemplar suffix (``# {trace_id="..."} value timestamp``) so a latency
spike on a dashboard links straight to ``pdrnn-metrics trace --request``
on that trace id.  Prometheus's classic text parser ignores everything
after ``#``, so the suffix is backward-compatible noise to a 0.0.4
scraper and an exemplar to an OpenMetrics one.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


log = logging.getLogger(__name__)

_DEFAULT_STALE_AFTER_S = 5.0
_EVENTS_MAXLEN = 512
_STRAGGLER_FRAC = 0.5
_STRAGGLER_MIN_SAMPLES = 4

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

HEALTHY_STATUSES = ("ok", "finished", "drained")


def escape_label_value(value) -> str:
    """Prometheus exposition label-value escaping: backslash first, then
    double-quote and newline (the spec's three escapes)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _render_value(value: float) -> str:
    # integers render without a fraction (counter idiom); floats use
    # repr for round-trip fidelity
    if value == int(value) and abs(value) < 2 ** 53:
        return str(int(value))
    return repr(value)


def _render_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _exemplar_suffix(exemplar: dict) -> str:
    """OpenMetrics exemplar: `` # {trace_id="..."} value timestamp``.
    A classic text-format parser stops at the ``#`` (comment), so the
    suffix degrades to nothing on scrapers that predate exemplars."""
    trace_id = exemplar.get("trace_id")
    value = exemplar.get("value")
    if trace_id is None or value is None:
        return ""
    suffix = (
        f' # {{trace_id="{escape_label_value(trace_id)}"}} '
        f"{_render_value(float(value))}"
    )
    if exemplar.get("t") is not None:
        suffix += f" {_render_value(float(exemplar['t']))}"
    return suffix


def _histogram_lines(name: str, labels: dict, snapshot: dict) -> list[str]:
    """One ``LatencyHistogram.snapshot()`` as exposition lines: the
    cumulative ``_bucket{le=...}`` series (finite buckets carry their
    exemplar when one was observed), the spec-mandated ``+Inf`` bucket,
    then ``_sum`` and ``_count``."""
    lines = []
    for bucket in snapshot.get("buckets") or ():
        line = (
            f"{name}_bucket"
            f'{_render_labels({**labels, "le": format(float(bucket["le"]), "g")})}'
            f" {int(bucket['count'])}"
        )
        exemplar = bucket.get("exemplar")
        if exemplar:
            line += _exemplar_suffix(exemplar)
        lines.append(line)
    lines.append(
        f'{name}_bucket{_render_labels({**labels, "le": "+Inf"})} '
        f"{int(snapshot['count'])}"
    )
    lines.append(
        f"{name}_sum{_render_labels(labels)} "
        f"{_render_value(float(snapshot['sum']))}"
    )
    lines.append(
        f"{name}_count{_render_labels(labels)} {int(snapshot['count'])}"
    )
    return lines


def render_prometheus(samples) -> str:
    """``[(name, labels-dict, value, type), ...]`` -> exposition text.

    Groups samples by metric name (one ``# TYPE`` line per name, first
    occurrence's type wins), escapes label values, and DROPS any sample
    whose value is not finite - a NaN gauge poisons every downstream
    ``avg()``/``sum()``, and absence is the Prometheus idiom for "no
    observation".  A sample whose type is ``"histogram"`` carries a
    ``LatencyHistogram.snapshot()`` dict as its value and expands into
    the ``_bucket``/``_sum``/``_count`` series under one ``# TYPE``
    line, with per-bucket exemplars when present."""
    by_name: dict[str, tuple[str, list[str]]] = {}
    order: list[str] = []

    def series_for(name: str, mtype: str) -> list[str]:
        if name not in by_name:
            by_name[name] = (mtype, [])
            order.append(name)
        return by_name[name][1]

    for name, labels, value, mtype in samples:
        if mtype == "histogram":
            if not isinstance(value, dict) or value.get("count") is None:
                continue
            series_for(name, mtype).extend(
                _histogram_lines(name, labels or {}, value)
            )
            continue
        try:
            value = float(value)
        except (TypeError, ValueError):
            continue
        if not math.isfinite(value):
            continue
        series_for(name, mtype).append(
            f"{name}{_render_labels(labels or {})} {_render_value(value)}"
        )
    lines = []
    for name in order:
        mtype, series = by_name[name]
        lines.append(f"# TYPE {name} {mtype}")
        lines.extend(series)
    return "\n".join(lines) + ("\n" if lines else "")


class Aggregator:
    """Latest-digest-per-source fleet state + alert ring."""

    def __init__(self, *, stale_after_s: float = _DEFAULT_STALE_AFTER_S,
                 stall_after_s: float = 10.0,
                 straggler_frac: float = _STRAGGLER_FRAC,
                 recorder=None, events_maxlen: int = _EVENTS_MAXLEN,
                 store=None):
        self.stale_after_s = float(stale_after_s)
        self.stall_after_s = float(stall_after_s)
        self.straggler_frac = float(straggler_frac)
        # the master/rank-0 recorder: fleet-level findings (stragglers)
        # are recorded as ``alert`` events into ITS sidecar, marked
        # fleet=True so the local exporter does not echo them back
        self.recorder = recorder
        # optional time-series store (obs/store.py): fed from ingest on
        # the pushing thread, queried by /series and /metrics; None
        # keeps the aggregator history-free (the pre-store behavior)
        self.store = store
        self._lock = threading.Lock()  # guards: _peers, _events, _seen_alert_seq, _peer_pids, _straggling, _fleet_seq
        self._peers: dict[str, dict] = {}  # id -> {digest, received_tm}
        self._events: deque[dict] = deque(maxlen=int(events_maxlen))
        self._seen_alert_seq: dict[str, int] = {}
        # pid per source: a RESPAWNED worker keeps its id but restarts
        # its watchdog's alert seq at 1 - the dedupe watermark must
        # reset with the incarnation or the new process's alerts are
        # silently dropped until they pass the dead one's high water
        self._peer_pids: dict[str, object] = {}
        self._straggling: set[str] = set()
        self._fleet_seq = 0

    # -- ingestion -----------------------------------------------------------

    def ingest(self, digest: dict) -> None:
        if not isinstance(digest, dict) or not digest.get("id"):
            raise ValueError("digest must be a dict with an 'id'")
        now = time.perf_counter()
        source = str(digest["id"])
        with self._lock:
            pid = digest.get("pid")
            if pid is not None and self._peer_pids.get(source, pid) != pid:
                # new incarnation under the same id: fresh seq space
                self._seen_alert_seq.pop(source, None)
            if pid is not None:
                self._peer_pids[source] = pid
            self._peers[source] = {"digest": digest, "received_tm": now}
            for alert in digest.get("alerts") or []:
                self._note_alert_locked(alert, source)
        # feed the store OUTSIDE the fleet lock (lock order: the two are
        # never held together) with the aggregator's OWN receive stamp -
        # digest-carried tm is another process's perf_counter epoch
        if self.store is not None:
            try:
                self.store.ingest(digest, now)
            except Exception:  # pragma: no cover - history must not
                log.exception("store: ingest failed")  # kill ingestion
        self._check_stragglers(now)

    def note_alert(self, alert: dict, source: str = "fleet") -> None:
        with self._lock:
            self._note_alert_locked(alert, source)

    def peek(self, source_id: str) -> dict | None:
        """Latest digest pushed by ``source_id`` (None when unseen).
        The fleet router's load-hint read path: replica digests double
        as the load signal (``serving.active + queue_depth``), so
        least-loaded dispatch needs no second telemetry channel."""
        with self._lock:
            entry = self._peers.get(str(source_id))
            return None if entry is None else entry["digest"]

    def _note_alert_locked(self, alert: dict, source: str) -> None:
        seq = alert.get("seq")
        if seq is not None:
            # (source, seq) dedupe: digests re-carry their recent-alert
            # ring on every push
            if self._seen_alert_seq.get(source, -1) >= int(seq):
                return
            self._seen_alert_seq[source] = int(seq)
        self._events.append({"source": source, **alert})

    # -- fleet-level checks --------------------------------------------------

    def _check_stragglers(self, now: float) -> None:
        """Live straggler detection across the fleet's step windows: a
        source whose window-mean step time exceeds the fleet median by
        ``straggler_frac`` is flagged once per episode (re-armed when it
        returns under), with the finding recorded as a fleet ``alert``
        event on the master recorder when one is bound."""
        import statistics

        # episode latch + fleet seq mutate UNDER the lock (concurrent
        # /push handler threads race this check; an unguarded latch can
        # double-flag or mint duplicate seqs the dedupe then drops);
        # alert emission happens outside it - note_alert re-takes the
        # lock and the master recorder does file I/O
        pending: list[dict] = []
        with self._lock:
            timed = [
                (pid, entry["digest"]["step_s"]["mean"])
                for pid, entry in self._peers.items()
                if isinstance(entry["digest"].get("step_s"), dict)
                and entry["digest"]["step_s"].get("mean") is not None
                and entry["digest"]["step_s"].get(
                    "count", 0) >= _STRAGGLER_MIN_SAMPLES
            ]
            if len(timed) < 2:
                return
            # true median (interpolated for even fleets): with 2 peers a
            # nearest-rank median would EQUAL the slow peer and no
            # straggler could ever be flagged
            median = statistics.median(m for _, m in timed)
            if median <= 0:
                return
            for pid, mean in timed:
                excess = mean / median - 1.0
                if excess > self.straggler_frac \
                        and pid not in self._straggling:
                    self._straggling.add(pid)
                    self._fleet_seq += 1
                    pending.append({
                        "alert": "straggler", "severity": "warning",
                        "seq": self._fleet_seq, "t": time.time(),
                        "peer": pid, "step_s_mean": mean,
                        "median_s": median, "excess_frac": excess,
                    })
                elif excess <= self.straggler_frac:
                    self._straggling.discard(pid)
        for alert in pending:
            self.note_alert(alert, source="fleet")
            if self.recorder is not None and self.recorder.enabled:
                self.recorder.record("alert", fleet=True, **alert)

    # -- views ---------------------------------------------------------------

    def _status(self, digest: dict, age_s: float,
                drained_slots: set[int]) -> str:
        if digest.get("drained"):
            # a voluntary leave (``LiveExporter.note_drained`` - the
            # SIGTERM drain of a serving replica) beats everything:
            # fresh while it finishes in-flight work, stale after it
            # exits - never "dead", and not "finished" either (the
            # router pool cares that it LEFT, not that it completed)
            return "drained"
        if digest.get("finished"):
            return "finished"
        if age_s > self.stale_after_s:
            rank = digest.get("rank")
            if rank is not None and int(rank) in drained_slots:
                return "drained"
            return "dead"
        progress_age = digest.get("progress_age_s")
        if progress_age is not None and progress_age > self.stall_after_s:
            # an IDLE serving engine is not stalled (the shared
            # predicate - obs/live.serving_idle - so this classifier
            # and the in-process watchdog can never disagree)
            from pytorch_distributed_rnn_tpu_torch.obs.live import serving_idle

            if serving_idle(digest.get("serving")):
                return "ok"
            return "stalled"
        return "ok"

    def health(self, now: float | None = None) -> dict:
        """Per-source liveness with the sidecar classifier's vocabulary,
        on live digests: ``finished`` beats everything, a stale source
        whose rank the roster drained is ``drained`` (voluntary leave),
        stale otherwise is ``dead``, fresh-but-frozen ``progress_age_s``
        is ``stalled``."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            peers = {
                pid: (dict(entry["digest"]), now - entry["received_tm"])
                for pid, entry in self._peers.items()
            }
        # the union of every source's drained slots: the master's digest
        # carries the roster story for workers that stopped pushing
        drained_slots: set[int] = set()
        roster = None
        for digest, _ in peers.values():
            drained_slots.update(digest.get("drained_slots") or ())
            if digest.get("roster") is not None:
                roster = digest["roster"]
        sources = []
        for pid, (digest, age_s) in sorted(peers.items()):
            if digest.get("ephemeral"):
                # event-only pushers (the supervisor): alerts and
                # metrics count, liveness does not - they push when
                # something happens, not on a cadence
                continue
            sources.append({
                "id": pid,
                "role": digest.get("role"),
                "rank": digest.get("rank"),
                "status": self._status(digest, age_s, drained_slots),
                "last_push_age_s": age_s,
                "progress": digest.get("progress"),
                "progress_age_s": digest.get("progress_age_s"),
            })
        ok = all(s["status"] in HEALTHY_STATUSES for s in sources)
        report = {"ok": ok, "sources": sources}
        if roster is not None:
            report["roster"] = roster
        return report

    def fleet(self, now: float | None = None) -> dict:
        """The digest table + statuses (the ``watch`` CLI's payload)."""
        health = {s["id"]: s for s in self.health(now)["sources"]}
        with self._lock:
            peers = {
                pid: dict(entry["digest"])
                for pid, entry in self._peers.items()
            }
        for pid, digest in peers.items():
            if digest.get("ephemeral"):
                # event-only pushers carry alerts, not liveness
                digest["status"] = "events"
                continue
            digest["status"] = health.get(pid, {}).get("status")
            digest["last_push_age_s"] = health.get(pid, {}).get(
                "last_push_age_s"
            )
        return {"sources": peers}

    def events(self, limit: int = 100) -> list[dict]:
        with self._lock:
            items = list(self._events)
        return items[-int(limit):]

    # -- Prometheus ----------------------------------------------------------

    def prometheus_text(self, now: float | None = None) -> str:
        now = time.perf_counter() if now is None else now
        health = {s["id"]: s for s in self.health(now)["sources"]}
        with self._lock:
            peers = [
                (pid, dict(entry["digest"]), now - entry["received_tm"])
                for pid, entry in sorted(self._peers.items())
            ]
        samples: list = []

        def add(name, labels, value, mtype="gauge"):
            if value is None:
                return
            samples.append((name, labels, value, mtype))

        for pid, digest, age_s in peers:
            labels = {
                "rank": digest.get("rank", ""),
                "role": digest.get("role", ""),
            }
            if digest.get("ephemeral"):
                # event-only pushers (the supervisor) have no liveness
                # story: exporting pdrnn_up 0 forever would fire every
                # min(pdrnn_up) alerting rule over nothing - only their
                # counters are real
                add("pdrnn_alerts_total", labels,
                    digest.get("alerts_total"), "counter")
                continue
            status = health.get(pid, {}).get("status")
            add("pdrnn_up", labels,
                1 if status in ("ok", "stalled") else 0)
            add("pdrnn_last_push_age_seconds", labels, age_s)
            add("pdrnn_progress_age_seconds", labels,
                digest.get("progress_age_s"))
            add("pdrnn_steps_total", labels, digest.get("steps_total"),
                "counter")
            step = digest.get("step_s") or {}
            add("pdrnn_step_seconds", {**labels, "quantile": "0.5"},
                step.get("p50"))
            add("pdrnn_step_seconds", {**labels, "quantile": "0.95"},
                step.get("p95"))
            add("pdrnn_step_seconds_mean", labels, step.get("mean"))
            loss = digest.get("loss") or {}
            add("pdrnn_loss", labels, loss.get("last"))
            add("pdrnn_data_wait_seconds_mean", labels,
                digest.get("data_wait_s_mean"))
            depth = digest.get("queue_depth") or {}
            add("pdrnn_queue_depth", labels, depth.get("last"))
            # efficiency-ledger live gauges (obs/ledger.py is the
            # post-hoc source of truth; these are windowed estimates)
            add("pdrnn_goodput", labels, digest.get("goodput_60s"))
            add("pdrnn_mfu", labels, digest.get("mfu_60s"))
            add("pdrnn_nan_skips_total", labels,
                digest.get("nan_skips_total"), "counter")
            for action, count in (digest.get("faults_total") or {}).items():
                add("pdrnn_faults_total", {**labels, "action": action},
                    count, "counter")
            add("pdrnn_alerts_total", labels, digest.get("alerts_total"),
                "counter")
            serving = digest.get("serving") or {}
            add("pdrnn_serving_requests_total", labels,
                serving.get("requests"), "counter")
            add("pdrnn_serving_requests_shed_total", labels,
                serving.get("requests_shed"), "counter")
            add("pdrnn_serving_requests_failed_total", labels,
                serving.get("requests_failed"), "counter")
            add("pdrnn_serving_tokens_total", labels,
                serving.get("tokens_out"), "counter")
            add("pdrnn_serving_request_rate_per_s", labels,
                serving.get("req_per_s_60s"))
            add("pdrnn_serving_tokens_rate_per_s", labels,
                serving.get("tokens_per_s_60s"))
            add("pdrnn_serving_shed_rate_per_s", labels,
                serving.get("shed_per_s_60s"))
            for q, key in (("0.5", "latency_s_p50"), ("0.95",
                                                     "latency_s_p95")):
                add("pdrnn_serving_latency_seconds",
                    {**labels, "quantile": q}, serving.get(key))
            for q, key in (("0.5", "ttft_s_p50"), ("0.95", "ttft_s_p95")):
                add("pdrnn_serving_ttft_seconds",
                    {**labels, "quantile": q}, serving.get(key))
            add("pdrnn_request_latency_seconds", labels,
                serving.get("latency_hist"), "histogram")
            router = digest.get("router") or {}
            add("pdrnn_router_inflight", labels, router.get("inflight"))
            for state, count in (router.get("replicas") or {}).items():
                add("pdrnn_router_replicas", {**labels, "state": state},
                    count)
            add("pdrnn_router_routed_total", labels, router.get("routed"),
                "counter")
            add("pdrnn_router_rerouted_total", labels,
                router.get("rerouted"), "counter")
            add("pdrnn_router_retries_total", labels,
                router.get("retries"), "counter")
            add("pdrnn_router_hedges_total", labels, router.get("hedges"),
                "counter")
            add("pdrnn_router_hedge_wins_total", labels,
                router.get("hedge_wins"), "counter")
            for qos, count in (router.get("shed") or {}).items():
                add("pdrnn_router_shed_total", {**labels, "qos": qos},
                    count, "counter")
            add("pdrnn_router_errors_total", labels, router.get("errors"),
                "counter")
            add("pdrnn_router_request_rate_per_s", labels,
                router.get("req_per_s_60s"))
            for q, key in (("0.5", "latency_s_p50"), ("0.95",
                                                     "latency_s_p95")):
                add("pdrnn_router_latency_seconds",
                    {**labels, "quantile": q}, router.get(key))
            add("pdrnn_request_latency_seconds", labels,
                router.get("latency_hist"), "histogram")
        if self.store is not None:
            # capacity + burn gauges (store-derived; see the registry
            # table above) join the exposition under the same render
            samples.extend(self.store.prometheus_samples(now))
        return render_prometheus(samples)

    def series(self, name: str | None = None,
               labels: dict | None = None, *, window: float = 60.0,
               agg: str | None = None) -> dict | list | None:
        """``GET /series`` body: the store's downsampled history for
        ``name`` (catalog when None); None when no store is bound."""
        if self.store is None:
            return None
        if not name:
            return self.store.series_names()
        return self.store.query(name, labels, window=window, agg=agg)


class AggregatorServer:
    """Threaded stdlib HTTP front end for one :class:`Aggregator`."""

    def __init__(self, aggregator: Aggregator, host: str = "127.0.0.1",
                 port: int = 0):
        self.aggregator = aggregator
        handler = _make_handler(aggregator)
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            # 0.1s shutdown poll: close() returns promptly (the default
            # 0.5s poll costs half a second per server teardown)
            target=lambda: self._httpd.serve_forever(poll_interval=0.1),
            name="pdrnn-live-http", daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:  # pragma: no cover - already closed
            pass
        self._thread.join(timeout=5.0)


def _make_handler(aggregator: Aggregator):
    class Handler(BaseHTTPRequestHandler):
        # live telemetry must not spam stderr per scrape
        def log_message(self, fmt, *args):  # noqa: D102
            log.debug("live-http: " + fmt % args)

        def _reply(self, code: int, body: bytes, content_type: str):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, payload, code: int = 200):
            body = json.dumps(payload, default=str).encode()
            self._reply(code, body, "application/json")

        def _series(self):
            if aggregator.store is None:
                self._reply_json(
                    {"error": "no time-series store bound "
                              "(not the live-plane anchor?)"}, 404)
                return
            from urllib.parse import parse_qsl, urlsplit

            params = dict(parse_qsl(urlsplit(self.path).query))
            name = params.pop("name", None)
            try:
                window = float(params.pop("window", 60.0))
                agg = params.pop("agg", None) or None
                # every remaining query key is a label filter
                body = aggregator.series(
                    name, params or None, window=window, agg=agg)
            except ValueError as exc:
                self._reply_json({"error": str(exc)}, 400)
                return
            self._reply_json(body)

        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            try:
                if path == "/metrics":
                    self._reply(200, aggregator.prometheus_text().encode(),
                                PROMETHEUS_CONTENT_TYPE)
                elif path == "/health":
                    report = aggregator.health()
                    self._reply_json(report,
                                     200 if report["ok"] else 503)
                elif path == "/events":
                    self._reply_json(aggregator.events())
                elif path == "/fleet":
                    self._reply_json(aggregator.fleet())
                elif path == "/series":
                    self._series()
                else:
                    self._reply_json({"error": f"unknown path {path}"}, 404)
            except BrokenPipeError:  # scraper went away mid-reply
                pass

        def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
            path = self.path.split("?", 1)[0].rstrip("/")
            if path != "/push":
                self._reply_json({"error": f"unknown path {path}"}, 404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                digest = json.loads(self.rfile.read(length) or b"{}")
                aggregator.ingest(digest)
            except (ValueError, TypeError) as exc:
                self._reply_json({"error": str(exc)}, 400)
                return
            self._reply_json({"ok": True}, 200)

    return Handler
