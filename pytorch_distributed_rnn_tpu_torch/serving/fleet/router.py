"""The fleet router: QoS admission, deadline-bounded dispatch, retry,
hedging, drain (a copy of the JAX package's ``serving/fleet/router.py``;
host code, no torch).

:class:`RouterCore` is the transport-free request path (unit-testable
with fake replicas through the pool's ``dial`` factory);
:class:`RouterServer` wraps it in the same JSONL-over-TCP front end a
single ``serve`` presents, so clients - the load generator
included - cannot tell a fleet from a replica.

Request lifecycle::

    admit (QoS budget)  ->  dispatch (least-loaded pick)
        -> relay events  ->  final done/error back to the client
        -> on transport failure: retry a SIBLING replica
           (backoff from resilience/retry.py, trimmed to the deadline)

The robustness contracts, in order of importance:

- **exactly-once accounting**: every admitted request ends in exactly
  one of done/error; sheds and drain rejections are counted at
  admission.  ``done + shed + errors == submitted`` is the drill's
  gate and ``stats()`` exposes every term.
- **idempotent retry only**: the router assigns a seed to any generate
  that arrives without one, so EVERY dispatch is deterministic and a
  re-dispatch to a sibling replica gives the tokens the first would
  have (the seed pins the decode; replicas share the checkpoint; on the
  card a batched product may move a near-tie, as a served request's
  tokens against its single-request ``generate`` may).  A streaming request that
  already relayed tokens to the client is FAILED on transport loss,
  never replayed - replaying would re-emit prefix tokens and no
  dedupe exists client-side.
- **deadline propagation**: ``deadline_ms`` (or ``--deadline-ms``)
  bounds the whole dispatch+retry+hedge tree; the remaining budget
  arms every connect/read and trims the backoff schedule
  (``resilience/retry.backoff_delays(deadline_s=...)``).
- **priority shedding**: past graduated shares of the admission budget
  (``QOS_ADMIT_FRAC``) low sheds first, then normal, then high - an
  EXPLICIT overload error with ``shed: true``, never a silent drop.
- **hedging** (``--hedge-after-ms``): a non-streaming request whose
  primary dispatch is silent past the threshold gets a second dispatch
  to a sibling; first final reply wins, the loser is cancelled
  (connection closed, pool release neutral - a slow replica is not a
  failed one).  Stream requests never hedge: two streams cannot be
  merged token-wise.

Distributed tracing (``obs/tracectx.py``): the router is the fleet's
trace EDGE.  A request arriving with a ``trace`` wire field extends the
client's context; otherwise ``--trace-sample RATE`` head-samples fresh
roots.  A traced request gets a ``route`` span covering its whole stay,
one ``attempt`` child span per dispatch (retries and both hedge legs
each their own - sibling re-dispatches are finally distinguishable in
replica sidecars), and the re-minted per-attempt context rides the
forwarded message so the replica's queue_wait/prefill/decode spans nest
under the attempt that caused them.  Untraced requests allocate no
context and their forwarded bytes are untouched.
"""

from __future__ import annotations

import itertools
import json
import logging
import queue
import socket
import threading
import time

from pytorch_distributed_rnn_tpu_torch.obs.live import (
    RollingWindow,
    request_latency_histogram,
)
from pytorch_distributed_rnn_tpu_torch.obs.recorder import NULL_RECORDER
from pytorch_distributed_rnn_tpu_torch.obs.tracectx import (
    TraceContext,
    should_sample,
)
from pytorch_distributed_rnn_tpu_torch.resilience.retry import backoff_delays
from pytorch_distributed_rnn_tpu_torch.serving.fleet.pool import Replica
from pytorch_distributed_rnn_tpu_torch.serving.protocol import (
    ProtocolError,
    encode_line,
)

log = logging.getLogger(__name__)

QOS_CLASSES = ("high", "normal", "low")

# admission shares of --max-inflight per class: low is shed first (past
# half the budget), normal next, high rides to the full budget - the
# graceful-degradation ordering under overload
QOS_ADMIT_FRAC = {"high": 1.0, "normal": 0.85, "low": 0.5}


class DispatchError(RuntimeError):
    """A dispatch failed at the transport level (dial/read/protocol):
    the replica is charged a breaker failure; the request may retry a
    sibling if its stream never started."""


class _Cancelled(Exception):
    """A hedge loser was cancelled - neutral, nobody is at fault."""


class RouterCore:
    """The request path: admission, dispatch, retry, hedge, accounting."""

    def __init__(self, pool, *, max_inflight: int = 64, retries: int = 2,
                 retry_base_delay_s: float = 0.05,
                 hedge_after_ms: float | None = None,
                 default_deadline_ms: float | None = None,
                 connect_timeout_s: float = 2.0,
                 io_timeout_s: float = 30.0,
                 recorder=None, seed: int = 0,
                 trace_sample: float = 0.0):
        self.pool = pool
        self.max_inflight = int(max_inflight)
        self.retries = int(retries)
        self.retry_base_delay_s = float(retry_base_delay_s)
        self.hedge_after_ms = (
            None if hedge_after_ms is None else float(hedge_after_ms)
        )
        self.default_deadline_ms = (
            None if default_deadline_ms is None
            else float(default_deadline_ms)
        )
        self.connect_timeout_s = float(connect_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self.seed = int(seed)
        self.trace_sample = float(trace_sample)
        self._seed_seq = itertools.count()
        # head-sampling sequence for router-minted trace roots (only
        # consumed when sampling is on and the request arrived untraced)
        self._trace_seq = itertools.count(1)
        self._lock = threading.Lock()  # guards: _inflight, _submitted, _done, _errors, _shed, _drain_rejected, _retries, _rerouted, _hedges, _hedge_wins, _stream_aborts, _draining, _route_span_open
        self._inflight = 0
        self._submitted = 0
        self._done = 0
        self._errors = 0
        self._shed = dict.fromkeys(QOS_CLASSES, 0)
        self._drain_rejected = 0
        self._retries = 0
        self._rerouted = 0
        self._hedges = 0
        self._hedge_wins = 0
        self._stream_aborts = 0
        self._draining = False
        # one route span in flight at a time: concurrent handler threads
        # all share the router's single timeline lane, and the trace
        # validator (rightly) rejects partially-overlapping spans on one
        # lane - non-candidates just skip the span, the latency window
        # still sees every request
        self._route_span_open = False
        # thread-safe on their own: read outside the stats lock
        self._completions = RollingWindow()
        self._latency_s = RollingWindow()
        # request-latency histogram behind the aggregator's
        # pdrnn_request_latency_seconds series; traced completions stamp
        # their bucket's exemplar with their trace_id.  Constructed via
        # the SHARED spec (obs/live.request_latency_histogram) so the
        # engine's buckets and the store's quantile sketches line up.
        self._latency_hist = request_latency_histogram()
        # per-QoS latency windows behind latency_s_p95_by_qos: the
        # store and watchdog scope --slo objectives per class with them
        self._latency_by_qos = {
            q: RollingWindow() for q in QOS_CLASSES
        }

    # -- admission -----------------------------------------------------------

    def _admit(self, qos: str) -> str:
        allowed = max(1, int(self.max_inflight * QOS_ADMIT_FRAC[qos]))
        with self._lock:
            if self._draining:
                self._drain_rejected += 1
                return "draining"
            if self._inflight >= allowed:
                self._shed[qos] += 1
                return "shed"
            self._inflight += 1
            self._submitted += 1
            return "ok"

    def begin_drain(self) -> None:
        with self._lock:
            self._draining = True

    def inflight_count(self) -> int:
        with self._lock:
            return self._inflight

    # -- the request path ----------------------------------------------------

    def handle_generate(self, msg: dict, send) -> dict:
        """Route one generate request; every path sends exactly one
        final ``done``/``error`` to the client (token events are relayed
        as they arrive for streams).  Returns the final payload."""
        request_id = str(msg.get("id", ""))
        qos = str(msg.get("priority", "normal")).lower()
        if qos not in QOS_CLASSES:
            final = {
                "id": request_id, "event": "error",
                "error": f"unknown priority {qos!r} "
                         f"({'|'.join(QOS_CLASSES)})",
            }
            send(final)
            return final
        if "seed" not in msg:
            # the idempotency pin: a router-assigned seed makes every
            # dispatch deterministic, so a retry to a sibling replica
            # reproduces the decode bit-identically
            msg["seed"] = (self.seed * 1_000_003
                           + next(self._seed_seq)) & 0x7FFFFFFF
        verdict = self._admit(qos)
        if verdict != "ok":
            if verdict == "draining":
                error = "router draining - not accepting requests"
            else:
                error = (
                    f"router overloaded - {qos} priority shed past "
                    f"admission budget"
                )
            self.recorder.record("route_shed", qos=qos,
                                 request=request_id, reason=verdict)
            final = {"id": request_id, "event": "error", "error": error,
                     "shed": True, "qos": qos}
            send(final)
            return final

        # trace edge: extend the sender's context, or head-sample a
        # fresh root when --trace-sample is on.  An untraced request
        # constructs NO context (the zero-overhead pin) and is forwarded
        # byte-identical.
        route_ctx = None
        if self.recorder.enabled:
            if "trace" in msg:
                incoming = TraceContext.from_wire(msg.get("trace"))
                if incoming is not None:
                    route_ctx = incoming.child()
            elif self.trace_sample > 0.0 and should_sample(
                    next(self._trace_seq), self.trace_sample):
                route_ctx = TraceContext.mint(qos=qos)

        deadline_ms = msg.get("deadline_ms", self.default_deadline_ms)
        expiry = (
            None if deadline_ms is None
            else time.monotonic() + float(deadline_ms) / 1e3
        )
        t0 = time.perf_counter()
        span_t0 = span_dur = None
        with self._lock:
            if not self._route_span_open:
                self._route_span_open = True
                # start time taken under the lock: acquisition is
                # serialized after the previous candidate's release (and
                # its end-time measurement), so candidate spans nest
                span_t0 = time.perf_counter()
        try:
            final, meta = self._route(msg, send, expiry, route_ctx)
        finally:
            if span_t0 is not None:
                span_dur = time.perf_counter() - span_t0
            with self._lock:
                self._inflight -= 1
                if span_t0 is not None:
                    self._route_span_open = False
        elapsed = time.perf_counter() - t0
        final = {"id": request_id, **final, **meta}
        ok = final.get("event") == "done"
        with self._lock:
            if ok:
                self._done += 1
                if meta.get("attempts", 1) > 1:
                    self._rerouted += 1
            else:
                self._errors += 1
            submitted = self._submitted
        if ok:
            self._completions.observe(1.0)
            self._latency_s.observe(elapsed)
            self._latency_by_qos[qos].observe(elapsed)
            self._latency_hist.observe(
                elapsed, trace_id=None if route_ctx is None
                else route_ctx.trace_id,
            )
            if span_t0 is not None and \
                    self.recorder.is_sample_step(submitted):
                self.recorder.emit_span(
                    "route", span_t0, span_dur, cat="router",
                    replica=meta.get("replica"),
                    attempts=meta.get("attempts"), qos=qos,
                )
        if route_ctx is not None:
            # the request-level trace span: emitted for EVERY traced
            # request (unlike the sampled timeline-lane span above) so
            # the assembled tree never misses its router root, and the
            # client learns its trace_id from the final payload
            self.recorder.emit_span(
                "route", t0, elapsed, cat="trace", request=request_id,
                qos=qos, replica=meta.get("replica"),
                attempts=meta.get("attempts"),
                outcome=final.get("event"),
                **route_ctx.span_fields(),
            )
            final["trace_id"] = route_ctx.trace_id
        send(final)
        return final

    def _route(self, msg: dict, send, expiry,
               route_ctx=None) -> tuple[dict, dict]:
        """Dispatch with retry/hedge; returns (final-payload, meta).
        With a ``route_ctx`` every dispatch attempt forks a child
        context, forwards it on a COPIED message, and emits an
        ``attempt`` span - the original ``msg`` is never mutated, so
        untraced forwarding stays byte-identical."""
        stream = bool(msg.get("stream"))
        relayed = {"tokens": 0}
        relay = send if stream else None
        remaining = (
            None if expiry is None else expiry - time.monotonic()
        )
        delays = backoff_delays(
            self.retries, base_delay=self.retry_base_delay_s,
            seed=int(msg["seed"]), deadline_s=remaining,
        )
        hedge_first = self.hedge_after_ms is not None and not stream
        tried: list[int] = []
        attempts = 0
        hedged = False
        last_error = "no healthy replica available"
        for attempt in range(self.retries + 1):
            if expiry is not None and time.monotonic() >= expiry:
                with self._lock:
                    self._retries += max(0, attempts - 1)
                return ({
                    "event": "error",
                    "error": f"deadline exceeded after {attempts} "
                             f"attempt(s): {last_error}",
                }, {"attempts": attempts})
            replica = self.pool.pick(exclude=tried)
            if replica is None:
                break
            tried.append(replica.replica_id)
            attempts += 1
            hedge_now = hedge_first and attempt == 0
            att_ctx = att_msg = att_t0 = None
            if route_ctx is not None and not hedge_now:
                att_ctx = route_ctx.child()
                att_msg = {**msg, "trace": att_ctx.to_wire()}
                att_t0 = time.perf_counter()
            try:
                if hedge_now:
                    reply, hedge_replica, hedged = self._dispatch_hedged(
                        replica, msg, expiry, tried,
                        route_ctx=route_ctx, attempt_index=attempts,
                    )
                    replica = hedge_replica
                else:
                    reply = self._dispatch(
                        replica, msg if att_msg is None else att_msg,
                        relay, relayed, expiry,
                    )
                    if att_ctx is not None:
                        self._emit_attempt_span(
                            att_ctx, att_t0, replica.replica_id,
                            attempts, reply.get("event"),
                        )
            except DispatchError as exc:
                if att_ctx is not None:
                    self._emit_attempt_span(
                        att_ctx, att_t0, replica.replica_id, attempts,
                        "transport_error",
                    )
                last_error = str(exc)
                if relayed["tokens"]:
                    # the stream already reached the client: a replay
                    # would re-emit its prefix - fail loudly instead
                    with self._lock:
                        self._stream_aborts += 1
                    return ({
                        "event": "error",
                        "error": f"stream interrupted after "
                                 f"{relayed['tokens']} token(s): "
                                 f"{last_error}; a started stream is "
                                 f"never replayed",
                        "stream_aborted": True,
                    }, {"attempts": attempts,
                        "replica": replica.replica_id})
                if attempt < len(delays):
                    time.sleep(delays[attempt])
                continue
            if reply.get("event") == "error" and (
                reply.get("shed") or reply.get("draining")
            ):
                # the replica rejected before executing anything -
                # idempotent by construction, a sibling may have room
                last_error = str(reply.get("error"))
                if attempt < len(delays):
                    time.sleep(delays[attempt])
                continue
            with self._lock:
                self._retries += attempts - 1
            meta = {"replica": replica.replica_id, "attempts": attempts}
            if hedged:
                meta["hedged"] = True
            return reply, meta
        with self._lock:
            self._retries += max(0, attempts - 1)
        return ({
            "event": "error",
            "error": f"retry budget exhausted after {attempts} "
                     f"attempt(s): {last_error}",
        }, {"attempts": attempts})

    def _emit_attempt_span(self, ctx, t0: float, replica_id: int,
                           attempt: int, outcome,
                           hedge: bool = False) -> None:
        """One dispatch attempt's trace span (child of the route span):
        retries and hedge legs each carry their own context, so sibling
        re-dispatches stay distinguishable in the assembled tree."""
        self.recorder.emit_span(
            "attempt", t0, time.perf_counter() - t0, cat="trace",
            replica=replica_id, attempt=attempt, outcome=outcome,
            hedge=True if hedge else None, **ctx.span_fields(),
        )

    # -- single dispatch -----------------------------------------------------

    def _dispatch(self, replica: Replica, msg: dict, relay, relayed,
                  expiry, cancel_box: dict | None = None) -> dict:
        """One attempt against one replica: dial, send, relay events,
        return the final reply.  Raises :class:`DispatchError` on any
        transport/protocol failure (charged to the replica's breaker),
        :class:`_Cancelled` when a hedge winner closed us out (neutral
        release)."""
        timeout = self.connect_timeout_s
        if expiry is not None:
            timeout = max(0.05, min(timeout, expiry - time.monotonic()))
        try:
            conn = replica.dial(connect_timeout_s=timeout,
                                io_timeout_s=self.io_timeout_s)
        except (OSError, ProtocolError) as exc:
            self.pool.release(replica, ok=False)
            raise DispatchError(
                f"dial replica {replica.replica_id}: {exc}"
            ) from exc
        if cancel_box is not None:
            cancel_box["conn"] = conn
        ok: bool | None = None
        try:
            conn.send(msg)
            while True:
                if expiry is not None:
                    remaining = expiry - time.monotonic()
                    if remaining <= 0:
                        raise socket.timeout(
                            "request deadline exceeded mid-dispatch"
                        )
                    conn.set_deadline(min(self.io_timeout_s, remaining))
                reply = conn.recv()
                event = reply.get("event")
                if event == "token":
                    relayed["tokens"] += 1
                    if relay is not None:
                        relay(reply)
                    continue
                if event in ("done", "error"):
                    ok = True
                    return reply
                raise ProtocolError(f"unexpected event {reply}")
        except (OSError, ProtocolError, ValueError) as exc:
            if cancel_box is not None and cancel_box.get("cancelled"):
                raise _Cancelled() from exc
            ok = False
            raise DispatchError(
                f"replica {replica.replica_id}: {exc}"
            ) from exc
        finally:
            conn.close()
            self.pool.release(replica, ok=ok)

    # -- hedging -------------------------------------------------------------

    def _dispatch_hedged(self, primary: Replica, msg: dict, expiry,
                         tried: list, route_ctx=None,
                         attempt_index: int = 1):
        """Primary dispatch with a tail-latency hedge: when the primary
        is silent past ``hedge_after_ms``, dispatch a sibling; the
        first FINAL reply wins and the loser is cancelled (socket
        closed, neutral pool release).  With a ``route_ctx`` each leg
        forwards its OWN child context and emits its own ``attempt``
        span (the loser's with outcome ``cancelled``).  Returns
        ``(reply, winning replica, hedged?)``; raises
        :class:`DispatchError` when every launched dispatch failed."""
        results: queue.Queue = queue.Queue()
        runners: list[tuple[Replica, dict]] = []

        def launch(replica: Replica, hedge: bool = False):
            box = {"conn": None, "cancelled": False}
            runners.append((replica, box))
            ctx, leg_msg = None, msg
            if route_ctx is not None:
                ctx = route_ctx.child()
                leg_msg = {**msg, "trace": ctx.to_wire()}

            def run():
                t0 = None if ctx is None else time.perf_counter()
                state = {"tokens": 0}
                try:
                    reply = self._dispatch(replica, leg_msg, None, state,
                                           expiry, cancel_box=box)
                    if ctx is not None:
                        self._emit_attempt_span(
                            ctx, t0, replica.replica_id, attempt_index,
                            reply.get("event"), hedge=hedge,
                        )
                    results.put((replica, reply, None))
                except _Cancelled:
                    if ctx is not None:
                        self._emit_attempt_span(
                            ctx, t0, replica.replica_id, attempt_index,
                            "cancelled", hedge=hedge,
                        )
                except DispatchError as exc:
                    if ctx is not None:
                        self._emit_attempt_span(
                            ctx, t0, replica.replica_id, attempt_index,
                            "transport_error", hedge=hedge,
                        )
                    results.put((replica, None, exc))

            threading.Thread(
                target=run, daemon=True,
                name=f"pdrnn-router-dispatch-{replica.replica_id}",
            ).start()

        def get(timeout_s: float):
            try:
                return results.get(timeout=max(0.0, timeout_s))
            except queue.Empty:
                return None

        launch(primary)
        budget = self.io_timeout_s + self.connect_timeout_s + 5.0
        if expiry is not None:
            budget = min(budget, max(0.05, expiry - time.monotonic()))
        first = get(min(self.hedge_after_ms / 1e3, budget))
        hedged = False
        if first is None:
            secondary = self.pool.pick(exclude=tried)
            if secondary is not None:
                tried.append(secondary.replica_id)
                hedged = True
                with self._lock:
                    self._hedges += 1
                self.recorder.record(
                    "hedge", primary=primary.replica_id,
                    secondary=secondary.replica_id,
                    request=str(msg.get("id", "")),
                )
                launch(secondary, hedge=True)
            first = get(budget)
        if first is not None and first[1] is None and len(runners) == 2:
            # the first finisher FAILED; give the other dispatch its
            # chance before declaring the attempt dead
            second = get(budget)
            first = second if second is not None else first
        if first is None:
            raise DispatchError(
                f"no reply from replica {primary.replica_id} within "
                f"{budget:.1f}s"
            )
        winner, reply, err = first
        for replica, box in runners:
            if replica is winner:
                continue
            box["cancelled"] = True
            conn = box.get("conn")
            if conn is not None:
                conn.close()
        if reply is None:
            raise err
        if hedged and winner is not primary:
            with self._lock:
                self._hedge_wins += 1
        return reply, winner, hedged

    # -- views ---------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            body = {
                "submitted": self._submitted, "done": self._done,
                "errors": self._errors, "shed": dict(self._shed),
                "shed_total": sum(self._shed.values()),
                "drain_rejected": self._drain_rejected,
                "inflight": self._inflight, "retries": self._retries,
                "rerouted": self._rerouted, "hedges": self._hedges,
                "hedge_wins": self._hedge_wins,
                "stream_aborts": self._stream_aborts,
                "draining": self._draining,
            }
        latency = self._latency_s.stats()
        body["req_per_s_60s"] = self._completions.count_rate()
        body["latency_s_p50"] = latency["p50"]
        body["latency_s_p95"] = latency["p95"]
        body["pool"] = self.pool.snapshot()
        return body

    def live_source(self) -> dict:
        """The ``router`` gauge block riding every live digest (the
        aggregator exports it as ``pdrnn_router_*``)."""
        stats = self.stats()
        block = {
            "inflight": stats["inflight"], "routed": stats["done"],
            "rerouted": stats["rerouted"], "retries": stats["retries"],
            "hedges": stats["hedges"],
            "hedge_wins": stats["hedge_wins"],
            "errors": stats["errors"], "shed": stats["shed"],
            "drain_rejected": stats["drain_rejected"],
            "replicas": stats["pool"]["states"],
            "max_inflight": self.max_inflight,
            "req_per_s_60s": stats["req_per_s_60s"],
            "latency_s_p50": stats["latency_s_p50"],
            "latency_s_p95": stats["latency_s_p95"],
        }
        by_qos = {
            qos: window.stats()["p95"]
            for qos, window in self._latency_by_qos.items()
            if window.values()
        }
        if by_qos:
            # per-class p95 (the --slo scoping input: watchdog + store)
            block["latency_s_p95_by_qos"] = by_qos
        hist = self._latency_hist.snapshot()
        if hist is not None:
            block["latency_hist"] = hist
        return {"router": block}

    def summary_fields(self) -> dict:
        """The ``run_summary`` contribution (``ROUTER_SUMMARY_KEYS`` in
        ``obs/summary.py`` passes these through ``pdrnn-metrics
        summarize`` verbatim)."""
        stats = self.stats()
        return {
            "routed": stats["done"], "rerouted": stats["rerouted"],
            "retries": stats["retries"], "hedges": stats["hedges"],
            "hedge_wins": stats["hedge_wins"],
            "router_shed": stats["shed_total"],
            "router_errors": stats["errors"],
            "stream_aborts": stats["stream_aborts"],
            "replica_ejections": stats["pool"]["ejections"],
            "replica_readmissions": stats["pool"]["readmissions"],
            "drain_rejected": stats["drain_rejected"],
        }


class RouterServer:
    """JSONL-over-TCP front end for one :class:`RouterCore` - the same
    accept/reader-thread shape as ``serving/server.py`` minus the
    engine (dispatch happens on the connection thread: the router's
    concurrency = its clients')."""

    def __init__(self, core: RouterCore, host: str = "127.0.0.1",
                 port: int = 0, recorder=None):
        self.core = core
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self._listener.setsockopt(
                socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._listener.bind((host, port))
            self._listener.listen(128)
            self.host, self.port = self._listener.getsockname()[:2]
        except Exception:
            self._listener.close()
            raise
        self._stop = threading.Event()
        self._conns_lock = threading.Lock()  # guards: _conns
        self._conns: set[socket.socket] = set()
        self._threads: list[threading.Thread] = []
        self._started = False
        self._t_start = time.perf_counter()

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._started:
            return
        self._started = True
        self.core.pool.start()
        accept_thread = threading.Thread(
            target=self._accept_loop, name="pdrnn-router-accept",
            daemon=True,
        )
        self._threads = [accept_thread]
        accept_thread.start()
        log.info(f"router: listening on {self.host}:{self.port}")

    def wait_ready(self, timeout_s: float = 60.0) -> bool:
        return self.core.pool.wait_ready(timeout_s=timeout_s)

    def shutdown(self, drain_timeout_s: float = 30.0):
        """SIGTERM drain: stop accepting and admitting, let in-flight
        dispatches finish (bounded), then flush telemetry; idempotent."""
        if self._stop.is_set():
            return
        self.core.begin_drain()
        # shutdown() wakes the accept loop's blocked accept(); close()
        # alone leaves it waiting on Linux (until the join's timeout)
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:  # not connected/listening: nothing to wake
            pass
        self._listener.close()
        deadline = time.monotonic() + float(drain_timeout_s)
        while self.core.inflight_count() > 0 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        self._stop.set()
        for thread in self._threads:
            thread.join(timeout=10.0)
        self.core.pool.close()
        # force-drop any client connection whose reader has not exited
        # yet: after this, nothing of ours may still hold a socket
        with self._conns_lock:
            victims = list(self._conns)
            self._conns.clear()
        for sock in victims:
            try:
                sock.close()
            except OSError:  # pragma: no cover - already closed
                pass
        if self.recorder.enabled:
            self.recorder.record(
                "router_drain",
                inflight_at_close=self.core.inflight_count(),
            )
            self.recorder.record(
                "run_summary",
                duration_s=time.perf_counter() - self._t_start,
                **self.core.summary_fields(),
            )
            self.recorder.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- accept / connection side --------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                # deadline-free by contract: shutdown() closing the
                # listener unblocks this accept with OSError
                conn, _addr = self._listener.accept()
            except OSError:  # listener closed = shutdown
                return
            handler = threading.Thread(
                target=self._handle, args=(conn,),
                name="pdrnn-router-conn", daemon=True,
            )
            handler.start()

    def _handle(self, conn: socket.socket):
        wlock = threading.Lock()
        alive = {"ok": True}
        with self._conns_lock:
            self._conns.add(conn)

        def send(obj: dict):
            # dispatch threads (hedges) and the reader both write here;
            # a vanished client must not take the router down with it
            with wlock:
                if not alive["ok"]:
                    return
                try:
                    # client-paced by contract: a timeout here would
                    # drop slow-but-alive clients; dead peers surface
                    # as OSError and just mark the conn down
                    conn.sendall(encode_line(obj))
                except OSError:
                    alive["ok"] = False

        rfile = conn.makefile("r", encoding="utf-8")
        try:
            for line in rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                    if not isinstance(msg, dict):
                        raise ValueError("messages are JSON objects")
                except ValueError as exc:
                    send({"event": "error", "error": f"bad request: {exc}"})
                    continue
                self._dispatch_op(msg, send)
                if self._stop.is_set():
                    break
        except OSError:
            pass
        finally:
            alive["ok"] = False
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                rfile.close()
            finally:
                conn.close()

    # -- ops -----------------------------------------------------------------

    def _dispatch_op(self, msg: dict, send):
        op = msg.get("op")
        if op == "ping":
            info = self.core.pool.pong_info()
            if info is None:
                send({
                    "event": "error",
                    "error": "no replica has answered a ping yet",
                })
                return
            counts = self.core.pool.state_counts()
            send({
                **info, "event": "pong",
                "fleet": {
                    "replicas": len(self.core.pool.replicas),
                    **counts,
                },
            })
        elif op == "stats":
            send({"event": "stats", **self.core.stats()})
        elif op == "generate":
            # the relayed token stream + the terminal done/error from
            # handle_generate
            self.core.handle_generate(msg, send)
        else:
            send({
                "id": msg.get("id"), "event": "error",
                "error": f"unknown op {op!r} (generate|ping|stats)",
            })
