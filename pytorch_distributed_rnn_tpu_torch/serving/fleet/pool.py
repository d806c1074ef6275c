"""Health-checked replica pool: membership, load signal, circuit breaking
(a copy of the JAX package's ``serving/fleet/pool.py``).

The router's view of the fleet.  Each :class:`Replica` is an address
plus a ``dial`` factory producing one JSONL connection per dispatch
(the same connection-per-request shape as the load generator - tests
inject in-memory fakes through the same factory, so none of the breaker
or dispatch logic needs a socket to exercise).

Replica state machine (the classic circuit breaker, per replica)::

    healthy --[eject_after consecutive failures]--> open
    open    --[cooldown_s elapsed]---------------> half_open
    half_open --[half_open_probes ping successes
                 OR one successful trial request]-> healthy  (readmit)
    half_open --[any failure]--------------------> open      (re-open)
    any     --[drain()]--------------------------> draining  (never picked)

Failures are counted from BOTH paths that can observe one: the health
loop's periodic pings (a SIGKILLed replica is ejected without waiting
for traffic to hit it) and dispatch outcomes reported by the router
(``release(replica, ok=False)``).  Re-admission is symmetric: a
recovering replica comes back through half-open probing - consecutive
ping successes, or one successful trial request when the healthy set
is empty - never by silently resetting the breaker.

Load signal for least-loaded dispatch: the router's own in-flight count
per replica (always available) plus an optional ``load_hint(replica)``
callable the CLI wires to the live plane's aggregator digests (queue
depth + active slots from each replica's ``serving`` gauge block), so
a replica busy with OTHER clients' work is avoided even before this
router has sent it anything.

Locking: one pool lock (``fleet.pool``, a plain ``threading.Lock``)
guards all mutable per-replica state; pings and dispatches - anything
that can block - run strictly outside it.
"""

from __future__ import annotations

import logging
import socket
import threading
import time

from pytorch_distributed_rnn_tpu_torch.serving.protocol import (
    ProtocolError,
    decode_line,
    encode_line,
)

log = logging.getLogger(__name__)

HEALTHY = "healthy"
OPEN = "open"
HALF_OPEN = "half_open"
DRAINING = "draining"

REPLICA_STATES = (HEALTHY, OPEN, HALF_OPEN, DRAINING)


class TcpReplicaConnection:
    """One dialed JSONL connection to a replica (the real transport
    behind a :class:`Replica`'s ``dial``; tests substitute in-memory
    fakes with the same ``send``/``recv``/``set_deadline``/``close``
    surface)."""

    def __init__(self, host: str, port: int,
                 connect_timeout_s: float = 2.0,
                 io_timeout_s: float = 30.0):
        self.sock = socket.create_connection(
            (host, port), timeout=connect_timeout_s
        )
        try:
            self.sock.settimeout(io_timeout_s)
            self._rfile = self.sock.makefile("r", encoding="utf-8")
        except Exception:
            self.sock.close()
            raise

    def send(self, obj: dict) -> None:
        self.sock.sendall(encode_line(obj))

    def recv(self) -> dict:
        line = self._rfile.readline()
        if not line:
            raise ProtocolError("replica closed the connection")
        return decode_line(line)

    def set_deadline(self, seconds: float) -> None:
        """Bound the NEXT read; the router re-arms this with the
        request's remaining deadline before every receive."""
        self.sock.settimeout(max(0.05, float(seconds)))

    def close(self) -> None:
        try:
            self._rfile.close()
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class Replica:
    """One pool member: identity + dial factory + breaker state.

    All mutable fields are guarded by the owning pool's lock."""

    def __init__(self, replica_id: int, host: str | None = None,
                 port: int | None = None, dial=None):
        self.replica_id = int(replica_id)
        self.host = host
        self.port = port
        if dial is None:
            if host is None or port is None:
                raise ValueError("a Replica needs host/port or a dial")
            dial = (
                lambda connect_timeout_s=2.0, io_timeout_s=30.0:
                TcpReplicaConnection(
                    host, int(port), connect_timeout_s=connect_timeout_s,
                    io_timeout_s=io_timeout_s,
                )
            )
        self.dial = dial
        self.state = HEALTHY
        self.inflight = 0
        self.consecutive_failures = 0
        self.opened_tm: float | None = None
        self.trial_inflight = False
        self.probe_successes = 0
        self.dispatched = 0
        self.failures = 0
        self.ejections = 0
        self.readmissions = 0
        self.info: dict = {}
        self.last_pong_tm: float | None = None


class ReplicaPool:
    """The router's replica set: health loop + breaker + pick/release."""

    def __init__(self, replicas, *, eject_after: int = 3,
                 cooldown_s: float = 2.0, half_open_probes: int = 2,
                 health_every_s: float = 0.5,
                 connect_timeout_s: float = 2.0,
                 ping_timeout_s: float = 2.0,
                 load_hint=None, on_event=None):
        """``on_event(kind, **fields)`` observes breaker transitions
        (``replica_eject`` / ``replica_probe`` / ``replica_readmit``) -
        the router wires it to its recorder so the transitions land on
        the ``router`` timeline lane.  Hook failures are swallowed."""
        replicas = list(replicas)
        self.replicas: dict[int, Replica] = {
            r.replica_id: r for r in replicas
        }
        if len(self.replicas) != len(replicas):
            raise ValueError("replica ids must be unique")
        self.eject_after = int(eject_after)
        self.cooldown_s = float(cooldown_s)
        self.half_open_probes = int(half_open_probes)
        self.health_every_s = float(health_every_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.ping_timeout_s = float(ping_timeout_s)
        self.load_hint = load_hint
        self._on_event = on_event
        self._lock = threading.Lock()
        self._ready = threading.Event()  # first pong seen
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- events --------------------------------------------------------------

    def _emit(self, events) -> None:
        """Fire queued (kind, fields) transitions - strictly OUTSIDE the
        pool lock (observers record to sidecars / push digests)."""
        if self._on_event is None:
            return
        for kind, fields in events:
            try:
                self._on_event(kind, **fields)
            except Exception:  # observability must never kill routing
                log.exception(f"fleet: on_event({kind}) hook failed")

    # -- breaker transitions (all called under the pool lock) ----------------

    def _advance_breakers_locked(self, now: float) -> list:
        events = []
        for replica in self.replicas.values():
            if replica.state == OPEN and replica.opened_tm is not None \
                    and now - replica.opened_tm >= self.cooldown_s:
                replica.state = HALF_OPEN
                replica.probe_successes = 0
                replica.trial_inflight = False
                events.append(("replica_probe", {
                    "replica": replica.replica_id, "phase": "half_open",
                }))
        return events

    def _mark_failure_locked(self, replica: Replica, now: float,
                             reason: str) -> list:
        replica.consecutive_failures += 1
        replica.failures += 1
        replica.probe_successes = 0
        if replica.state == HALF_OPEN:
            # the probe/trial failed: straight back to open, fresh
            # cooldown - a flapping replica never oscillates into the
            # healthy set
            replica.state = OPEN
            replica.opened_tm = now
            return [("replica_eject", {
                "replica": replica.replica_id, "reason": reason,
                "reopened": True,
            })]
        if replica.state == HEALTHY \
                and replica.consecutive_failures >= self.eject_after:
            replica.state = OPEN
            replica.opened_tm = now
            replica.ejections += 1
            return [("replica_eject", {
                "replica": replica.replica_id, "reason": reason,
                "consecutive_failures": replica.consecutive_failures,
            })]
        return []

    def _mark_success_locked(self, replica: Replica, via: str) -> list:
        replica.consecutive_failures = 0
        if replica.state == HALF_OPEN:
            replica.state = HEALTHY
            replica.readmissions += 1
            return [("replica_readmit", {
                "replica": replica.replica_id, "via": via,
            })]
        return []

    # -- dispatch interface --------------------------------------------------

    def _load_key(self, replica: Replica):  # holds: _lock
        hint = 0.0
        if self.load_hint is not None:
            try:
                hint = float(self.load_hint(replica) or 0.0)
            except Exception:  # hint sources must not kill dispatch
                hint = 0.0
        return (replica.inflight + hint, replica.replica_id)

    def pick(self, exclude=()) -> Replica | None:
        """Reserve the least-loaded healthy replica (a pick increments
        its in-flight count atomically - callers MUST ``release``).

        ``exclude`` holds replica ids already tried for this request
        (retry/hedge siblings); when every healthy replica is excluded
        the exclusion is dropped rather than failing the request - a
        retry against the same replica beats no retry at all.  With no
        healthy replica, a half-open one may take a single in-flight
        TRIAL request (the request-path half of half-open probing)."""
        exclude = set(exclude)
        now = time.monotonic()
        with self._lock:
            events = self._advance_breakers_locked(now)
            healthy = [r for r in self.replicas.values()
                       if r.state == HEALTHY]
            fresh = [r for r in healthy if r.replica_id not in exclude]
            candidates = fresh or healthy
            picked = None
            if candidates:
                picked = min(candidates, key=self._load_key)
            else:
                trials = sorted(
                    (r for r in self.replicas.values()
                     if r.state == HALF_OPEN and not r.trial_inflight),
                    key=lambda r: (r.replica_id in exclude,
                                   r.replica_id),
                )
                if trials:
                    picked = trials[0]
                    picked.trial_inflight = True
                    events.append(("replica_probe", {
                        "replica": picked.replica_id, "phase": "trial",
                    }))
            if picked is not None:
                picked.inflight += 1
                picked.dispatched += 1
        self._emit(events)
        return picked

    def release(self, replica: Replica, ok: bool | None) -> None:
        """Return a pick: ``ok=True`` feeds the breaker a success,
        ``ok=False`` a failure, ``ok=None`` is neutral (a cancelled
        hedge loser - the replica did nothing wrong)."""
        now = time.monotonic()
        with self._lock:
            replica.inflight = max(0, replica.inflight - 1)
            replica.trial_inflight = False
            if ok is True:
                events = self._mark_success_locked(replica, via="request")
            elif ok is False:
                events = self._mark_failure_locked(replica, now,
                                                   reason="dispatch")
            else:
                events = []
        self._emit(events)

    def drain(self, replica_id: int) -> None:
        """Mark a replica draining: never picked again (its own server
        finishes what it already owns)."""
        with self._lock:
            replica = self.replicas[int(replica_id)]
            replica.state = DRAINING
        self._emit([("replica_drain", {"replica": int(replica_id)})])

    # -- health loop ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._health_loop, name="pdrnn-router-health",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def wait_ready(self, timeout_s: float = 30.0) -> bool:
        """Block until at least one replica has answered a ping (the
        router CLI gates its port-file write on this, so a client that
        can connect can also be served a pong)."""
        return self._ready.wait(timeout=timeout_s)

    def _health_loop(self) -> None:
        self.check_once()  # immediate first pass: readiness without
        # waiting out one full cadence
        while not self._stop.wait(timeout=self.health_every_s):
            self.check_once()

    def check_once(self) -> None:
        """One health pass: ping every non-draining replica, feed the
        breaker, advance cooldowns.  Pings run OUTSIDE the pool lock."""
        now = time.monotonic()
        with self._lock:
            events = self._advance_breakers_locked(now)
            targets = [r for r in self.replicas.values()
                       if r.state != DRAINING]
        self._emit(events)
        for replica in targets:
            ok, info = self._ping(replica)
            now = time.monotonic()
            with self._lock:
                if ok:
                    replica.last_pong_tm = now
                    replica.info = info or {}
                    replica.consecutive_failures = 0
                    if replica.state == HALF_OPEN:
                        replica.probe_successes += 1
                        events = [("replica_probe", {
                            "replica": replica.replica_id,
                            "phase": "ping", "ok": True,
                            "successes": replica.probe_successes,
                        })]
                        if replica.probe_successes \
                                >= self.half_open_probes:
                            replica.state = HEALTHY
                            replica.readmissions += 1
                            events.append(("replica_readmit", {
                                "replica": replica.replica_id,
                                "via": "ping_probes",
                            }))
                    else:
                        events = []
                else:
                    events = self._mark_failure_locked(replica, now,
                                                       reason="ping")
            self._emit(events)
            if ok:
                self._ready.set()

    def _ping(self, replica: Replica) -> tuple[bool, dict | None]:
        try:
            conn = replica.dial(
                connect_timeout_s=self.connect_timeout_s,
                io_timeout_s=self.ping_timeout_s,
            )
        except (OSError, ProtocolError):
            return False, None
        try:
            conn.send({"op": "ping"})
            reply = conn.recv()
            if reply.get("event") != "pong":
                return False, None
            return True, reply
        except (OSError, ProtocolError, ValueError):
            return False, None
        finally:
            conn.close()

    # -- views ---------------------------------------------------------------

    def pong_info(self) -> dict | None:
        """The most recent pong payload of any replica (healthy
        preferred) - the router's own ping reply is built from it."""
        with self._lock:
            ordered = sorted(
                (r for r in self.replicas.values() if r.info),
                key=lambda r: (r.state != HEALTHY, r.replica_id),
            )
            return dict(ordered[0].info) if ordered else None

    def state_counts(self) -> dict:
        counts = dict.fromkeys(REPLICA_STATES, 0)
        with self._lock:
            for replica in self.replicas.values():
                counts[replica.state] += 1
        return counts

    def snapshot(self) -> dict:
        """Per-replica detail + state counts (the router's stats op)."""
        with self._lock:
            members = [
                {
                    "replica": r.replica_id, "host": r.host,
                    "port": r.port, "state": r.state,
                    "inflight": r.inflight,
                    "dispatched": r.dispatched, "failures": r.failures,
                    "consecutive_failures": r.consecutive_failures,
                    "ejections": r.ejections,
                    "readmissions": r.readmissions,
                }
                for r in sorted(self.replicas.values(),
                                key=lambda r: r.replica_id)
            ]
        counts = dict.fromkeys(REPLICA_STATES, 0)
        for member in members:
            counts[member["state"]] += 1
        return {
            "replicas": members, "states": counts,
            "ejections": sum(m["ejections"] for m in members),
            "readmissions": sum(m["readmissions"] for m in members),
        }
