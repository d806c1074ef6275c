"""Structured run telemetry: rank-tagged JSONL event stream.

The reference's only machine-readable telemetry is ONE regex-parsed
stderr line per run (``training/formatter.py`` perf line), which says
nothing about *where* time goes and silently vanishes when a run
crashes.  :class:`MetricsRecorder` is the structured replacement:
every process appends per-step / per-epoch / subsystem events to a
JSONL sidecar, buffered in memory and flushed by a background thread so
nothing rides the training hot path.  The legacy perf line is untouched
- the sidecar is an addition, not a replacement (``evaluation/
analysis.py`` prefers it and falls back to the regex).

Hot-path contract:

- disabled telemetry is :data:`NULL_RECORDER` - a no-op object with NO
  flush thread and ``enabled = False``, so instrumented call sites cost
  one attribute check (the zero-overhead guard test pins this);
- ``record()`` appends a dict to an in-memory buffer under a lock and
  (past a threshold) *signals* the writer thread - it never touches the
  filesystem itself;
- device fencing (a stream synchronize) happens only on a sampled
  cadence (``sample_every``), so steady-state dispatch stays async.

Event schema (``schema = 2``; one JSON object per line, every event
carries ``kind``, ``t`` (unix seconds), ``tm`` (monotonic seconds,
``time.perf_counter`` - the clock ALL in-run deltas and the timeline
alignment use, immune to NTP steps that can reorder or negate ``t``
deltas) and ``rank``.  Schema-1 sidecars (no ``tm``) still load for
summaries; only the timeline exporter requires schema 2):

=================== =======================================================
kind                payload
=================== =======================================================
meta                schema, sample_every, argv? - always the FIRST line;
                    its (t, tm) pair is the rank's wall<->monotonic anchor
step                step, epoch, loss, dispatch_s, data_wait_s,
                    fenced_s (sampled steps only); comm_wait_s +
                    overlap_frac when the strategy runs host
                    collectives (native ring - wall blocked in
                    collectives, and the wire-time share hidden behind
                    compute); tm is the step's dispatch START
                    (overridden by the trainer), so the timeline can
                    synthesize the per-step sub-spans
epoch               epoch, steps, loss, acc, wall_s, path (scan|step|host)
eval                epoch (null = test), loss, acc
collectives         ops {hlo-op: {count, bytes}}, bytes_per_step - traced
                    once per run from the live step program; plus the
                    efficiency ledger's analytic cost of the same trace
                    (obs/flops.py): model_flops_per_step,
                    model_flops_exact, arg_bytes, out_bytes
compile             step, seconds, cache_size - a step function's trace
                    cache grew AFTER its warm-up compile (a retrace:
                    shape drift, weak types, donation mismatch);
                    seconds is that step's dispatch wall, which the
                    ledger moves from the compute to the compile phase
                    and `pdrnn-metrics summarize` counts as recompiles
checkpoint_save     epoch, best, seconds, format
checkpoint_restore  path, epoch, seconds
nan_skip            new, total, consecutive
fault               action, trigger, where
span                name, cat, dur_s (+ attrs); tm/t are the span START
                    (obs/spans.py - the trace-timeline duration event)
heartbeat           seq, progress (last step noted via note_progress) -
                    emitted by the writer thread on its wake cadence, so
                    a stalled rank keeps proving it is alive while its
                    progress freezes (pdrnn-metrics health)
ps_exchange         what (push|pull), step, seconds, retries
ps_round            updates, gathered, expected, degraded
ps_worker_dead      worker, error
ps_summary          updates, degraded_rounds, workers_lost, rejoins
member_join         worker_id, rank_slot, incarnation, via, rejoin +
                    roster counts - a member (re)entered the elastic
                    world (resilience/membership.py)
member_drain        worker_id, rank_slot, seq + roster counts -
                    voluntary leave (SIGTERM drain / DEREGISTER);
                    pdrnn-metrics health classifies the rank drained,
                    not dead
member_dead         worker_id, rank_slot, error + roster counts -
                    involuntary loss (transport death), rejoinable via
                    REGISTER
checkpoint_fallback path, reason, chosen - a corrupt checkpoint was
                    skipped during --resume auto and resume fell back
stage_restart       stage, resume_step, ckpt - a respawned MPMD stage
                    restored its per-stage checkpoint and is re-dialing
                    its neighbors (parallel/mpmd.py); pdrnn-metrics
                    health classifies the rank recovering, not stalled,
                    until its first post-restart step lands
replay              stage, link, count, from_seq, to_seq - a surviving
                    link end replayed buffered microbatch frames to a
                    restarted neighbor during the watermark handshake
                    (runtime/stage.py)
alert               alert (stall | stall_cleared | nan_streak |
                    loss_spike | slo_breach | slo_recovered | slo_burn
                    | slo_burn_cleared | straggler | worker_respawn |
                    worker_lost | pool_collapse),
                    severity (warning|info), seq (per-emitter monotone)
                    + detector fields; slo_breach/slo_recovered carry
                    the breaching ``qos`` class (absent = the
                    deprecated class-blind env threshold) and
                    slo_burn/slo_burn_cleared carry qos,
                    burn_rate_fast/_slow, objective and windows_s (the
                    store's multi-window error-budget burn,
                    obs/store.py); chaos_fired carries the fault
                    schedule's fired counters when chaos is active and
                    fleet=True marks aggregator-born findings
                    (obs/watchdog.py + obs/aggregator.py; the live
                    plane's /events and the Prometheus exposition in
                    obs/aggregator.py mirror this stream)
profile             dir, start, stop, captured
experience_reject   worker_id, seq, reason (duplicate | stale |
                    backoff | stale_at_apply | poisoned) + verdict
                    fields - one EXPERIENCE push the streaming learner
                    refused, counted never silently dropped
                    (streaming/learner.py)
params_refresh      worker_id, from_version, to_version - an actor
                    pulled fresh params (PARAMS_AT) after a STALE
                    verdict or on its proactive refresh cadence
actor_reconnect     worker_id, attempts, seq, version - an actor
                    re-registered with a (reincarnated) learner and
                    resumes pushing above its seq watermark;
                    pdrnn-metrics health treats a registered actor
                    with no push since as recovering, not stalled
learner_summary     updates, final_version, rejoins + ingest counters
                    - the streaming learner's verdict line
run_summary         memory_mb, duration_s, device_peaks_mb, steps,
                    nan_skipped, faults_fired, ledger (the trainer's
                    efficiency block: model_flops_per_step, backend,
                    device_kind/count, peak_flops_total,
                    peak_flops_estimated - see obs/ledger.py); the
                    PS master's variant
                    carries roster counts + rejoins + degraded_rounds;
                    the streaming learner's adds experience_batches,
                    experience_per_s, updates_per_s, stale_rejected,
                    queue_sheds, duplicates, poisoned,
                    staleness_p50/p95, final_version
=================== =======================================================

Span names on the ``member`` lane: ``state_sync`` (REGISTER -> params
adoption, emitted by both master and the joining worker - the
streaming actor/learner pair reuses it with the learner version in the
step slot).  Span names on the ``actor`` lane: ``experience_push``
(actor-side push exchange incl. retries/backoffs) and
``learner_update`` (one applied update with its staleness).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from pathlib import Path

from pytorch_distributed_rnn_tpu_torch.obs.spans import NULL_SPAN, Span

log = logging.getLogger(__name__)

SCHEMA_VERSION = 2

# env half of the CLI contract (the --metrics flag beats it), mirroring
# PDRNN_CHAOS: spawned worker processes inherit telemetry without CLI
# plumbing through every launcher layer
METRICS_ENV = "PDRNN_METRICS"
METRICS_SAMPLE_ENV = "PDRNN_METRICS_SAMPLE"
METRICS_HEARTBEAT_ENV = "PDRNN_METRICS_HEARTBEAT"

_DEFAULT_SAMPLE_EVERY = 16
_FLUSH_THRESHOLD = 256  # events buffered before the writer is signalled
_FLUSH_INTERVAL_S = 2.0  # writer wake cadence even below the threshold
_DEFAULT_HEARTBEAT_S = 5.0  # heartbeat cadence (0 disables)


def rank_suffixed(path, rank: int) -> Path:
    """The per-process sidecar path: rank 0 keeps ``path`` verbatim (the
    single-process case stays simple), other ranks insert ``-r<rank>``
    before the suffix so a multi-process world never interleaves writers
    in one file."""
    path = Path(path)
    if rank == 0:
        return path
    return path.with_name(f"{path.stem}-r{rank}{path.suffix}")


class NullRecorder:
    """Telemetry off: every hook is a no-op and ``enabled`` is False so
    instrumented loops skip their bookkeeping entirely - no thread, no
    fencing, no buffering."""

    enabled = False
    rank = 0
    sample_every = 0
    path = None

    def record(self, kind: str, **fields) -> None:  # noqa: PD105 - null object
        pass

    def is_sample_step(self, step: int) -> bool:
        return False

    def span(self, name: str, cat: str = "train", **attrs):
        """Disabled tracing: the shared no-op context manager - no clock
        reads, no allocation (the span half of the zero-overhead pin)."""
        return NULL_SPAN

    def emit_span(self, name, tm_start, dur_s, cat="train",  # noqa: PD105
                  **attrs) -> None:
        pass

    def note_progress(self, step: int) -> None:  # noqa: PD105 - null object
        pass

    progress = None

    def attach_live(self, live) -> None:
        raise RuntimeError(
            "live export needs an enabled recorder (--metrics / "
            "PDRNN_METRICS); the null recorder has no event stream to "
            "window"
        )

    def flush(self) -> None:  # noqa: PD105 - null object by design
        pass

    def close(self) -> None:  # noqa: PD105 - null object by design
        pass

    def __bool__(self) -> bool:
        return False


NULL_RECORDER = NullRecorder()


class MetricsRecorder:
    """Buffered JSONL event writer with a background flush thread."""

    enabled = True

    def __init__(self, path, rank: int = 0,
                 sample_every: int = _DEFAULT_SAMPLE_EVERY,
                 flush_threshold: int = _FLUSH_THRESHOLD,
                 meta: dict | None = None,
                 heartbeat_every_s: float = _DEFAULT_HEARTBEAT_S):
        if sample_every < 1:
            raise ValueError(
                f"metrics sample cadence must be >= 1, got {sample_every}"
            )
        self.rank = int(rank)
        self.sample_every = int(sample_every)
        self.path = rank_suffixed(path, self.rank)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # lock-order: MetricsRecorder._io_lock -> MetricsRecorder._lock
        self._lock = threading.Lock()  # guards: _buffer
        self._io_lock = threading.Lock()
        self._buffer: list[dict] = []
        self._flush_threshold = int(flush_threshold)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._closed = False
        # heartbeats ride the writer thread's existing wake cadence (no
        # extra thread); 0 disables them.  The wake timeout shrinks to
        # the heartbeat interval when that is the tighter cadence.
        self._heartbeat_every = max(0.0, float(heartbeat_every_s))
        self._wake_timeout = (
            min(_FLUSH_INTERVAL_S, self._heartbeat_every)
            if self._heartbeat_every > 0 else _FLUSH_INTERVAL_S
        )
        self._hb_seq = 0
        # last step noted by the instrumented loops (note_progress): a
        # bare int store, read by the writer thread's heartbeats so a
        # stalled rank's heartbeats visibly stop advancing
        self._progress = None
        # the live plane (obs/live.py): None unless attach_live was
        # called - record() feeds it and the writer thread pushes its
        # digests, so live export adds NO thread of its own
        self._live = None
        # wall<->monotonic anchor: t and tm below describe the SAME
        # instant, so anchor + any event's tm reconstructs its wall time
        # on THIS rank's clock (obs/timeline.py aligns across ranks)
        t_wall, t_mono = time.time(), time.perf_counter()
        self._anchor = t_wall - t_mono
        # meta is the FIRST line, written synchronously: a sidecar that
        # exists always declares its schema, even if the run dies before
        # the first flush
        head = {
            "kind": "meta", "t": t_wall, "tm": t_mono, "rank": self.rank,
            "schema": SCHEMA_VERSION, "sample_every": self.sample_every,
        }
        head.update(meta or {})
        with open(self.path, "w") as f:
            f.write(json.dumps(head) + "\n")
        self._thread = threading.Thread(
            target=self._writer, name="pdrnn-metrics", daemon=True
        )
        self._thread.start()

    # -- construction --------------------------------------------------------

    @classmethod
    def resolve(cls, args, rank: int = 0, meta: dict | None = None):
        """The ONE CLI resolution path (``--metrics`` flag beats the
        ``PDRNN_METRICS`` env), shared by every strategy entry point so
        telemetry can never be silently dropped by one of them.  Returns
        :data:`NULL_RECORDER` when telemetry is off."""
        spec = getattr(args, "metrics", None) or os.environ.get(METRICS_ENV)
        if not spec:
            return NULL_RECORDER
        sample = getattr(args, "metrics_sample_every", None)
        if sample is None:
            sample = int(
                os.environ.get(METRICS_SAMPLE_ENV, _DEFAULT_SAMPLE_EVERY)
            )
        heartbeat = float(
            os.environ.get(METRICS_HEARTBEAT_ENV, _DEFAULT_HEARTBEAT_S)
        )
        return cls(spec, rank=rank, sample_every=int(sample), meta=meta,
                   heartbeat_every_s=heartbeat)

    # -- hot-path API --------------------------------------------------------

    def record(self, kind: str, **fields) -> None:
        # the (t, tm) stamp pair describes the record() instant; callers
        # emitting DEFERRED events (the trainer's post-loop step flush,
        # emit_span) override tm to the phase's true start - t is then
        # re-derived from the construction anchor so the two always
        # describe the SAME instant (the invariant the timeline's
        # cross-rank alignment and any t - tm anchor math rest on)
        event = {
            "kind": kind, "t": time.time(), "tm": time.perf_counter(),
            "rank": self.rank,
        }
        if "tm" in fields and "t" not in fields:
            event["t"] = self._anchor + float(fields["tm"])
        event.update(fields)
        live = self._live
        if live is not None:
            try:
                live.observe_event(event)
            except Exception:  # live telemetry must never kill the run
                log.exception("live window update failed")
        with self._lock:
            self._buffer.append(event)
            signal = len(self._buffer) >= self._flush_threshold
        if signal:
            self._wake.set()

    def span(self, name: str, cat: str = "train", **attrs) -> Span:
        """Context manager timing a ``span`` event (obs/spans.py)."""
        return Span(self, name, cat, attrs)

    def emit_span(self, name, tm_start, dur_s, cat="train",
                  **attrs) -> None:
        """Deferred span emission: ``tm_start`` is a ``perf_counter``
        value captured when the phase began; ``record`` derives the
        wall stamp from the construction-time anchor so t and tm stay
        one clock pair even across NTP steps."""
        self.record(
            "span", name=name, cat=cat, tm=float(tm_start),
            dur_s=float(dur_s), **attrs,
        )

    def note_progress(self, step: int) -> None:
        """Cheap per-step liveness note (one int store, no lock): the
        writer thread's heartbeats carry the latest value, so
        ``pdrnn-metrics health`` can tell a stalled rank (heartbeats
        fresh, progress frozen) from a dead one (heartbeats stale)."""
        self._progress = int(step)

    @property
    def progress(self) -> int | None:
        """The last ``note_progress`` value (live-plane/watchdog read)."""
        return self._progress

    def attach_live(self, live) -> None:
        """Bind a live exporter (obs/live.py): ``record`` feeds its
        rolling windows and the writer thread pushes its digests on the
        existing wake cadence - live export adds no thread here."""
        self._live = live

    def is_sample_step(self, step: int) -> bool:
        """Whether this step pays the fencing round-trip (step wall-time
        measurement): every ``sample_every``-th step, plus step 1 - the
        first STEADY-STATE step (step 0 carries the compile and is
        excluded from timing summaries), so even a short run has one
        honest fenced wall-time sample."""
        return step == 1 or step % self.sample_every == 0

    # -- writer --------------------------------------------------------------

    def _writer(self):
        next_hb = time.perf_counter() + self._heartbeat_every
        while not self._stop.is_set():
            self._wake.wait(timeout=self._wake_timeout)
            self._wake.clear()
            if self._heartbeat_every > 0:
                now = time.perf_counter()
                if now >= next_hb:
                    self._hb_seq += 1
                    self.record(
                        "heartbeat", seq=self._hb_seq,
                        progress=self._progress,
                    )
                    next_hb = now + self._heartbeat_every
            live = self._live
            if live is not None:
                try:
                    live.maybe_push()
                except Exception:  # pragma: no cover - must never kill
                    log.exception("live digest push failed")
            self._drain()
        self._drain()

    def _drain(self):
        # _io_lock serializes WHOLE drains: a caller-thread flush() (e.g.
        # the pre-kill chaos flush) racing the writer thread's timed drain
        # must not interleave its batch's buffered chunks mid-line with
        # the other's - a single torn line fails the strict loader for
        # the whole sidecar.  Holding it across the swap also keeps batch
        # order = record order.
        with self._io_lock:
            with self._lock:
                batch, self._buffer = self._buffer, []
            if not batch:
                return
            try:
                with open(self.path, "a") as f:
                    for event in batch:
                        f.write(json.dumps(event, default=_jsonable) + "\n")
            except OSError as exc:  # telemetry must never kill the run
                log.warning(f"metrics flush to {self.path} failed: {exc}")

    def flush(self) -> None:
        """Synchronous drain (tests and run teardown)."""
        self._drain()

    def close(self) -> None:
        """Stop the writer thread and flush everything; idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5.0)
        self._drain()
        live = self._live
        if live is not None:
            # final digest AFTER the last drain: it carries the
            # run_summary-derived finished flag, so a live /health shows
            # the source finished instead of going dead
            try:
                live.push_now()
            except Exception:  # pragma: no cover - must never kill
                log.exception("final live digest push failed")

    def __del__(self):  # pragma: no cover - GC timing is interpreter-specific
        try:
            self.close()
        except Exception:
            pass


def _jsonable(value):
    """Last-resort coercion for numpy scalars and 0-d tensors riding in events."""
    try:
        return float(value)
    except (TypeError, ValueError):
        return str(value)
