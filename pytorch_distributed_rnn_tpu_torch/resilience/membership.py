"""World membership for the parameter server: the roster, its lifecycle,
and drain signals.  The non-elastic part of the JAX package's
``resilience/membership.py``.

- :class:`Member` / :class:`Roster` - the master's membership table.  A
  member has a stable **worker-id** and a transport **rank**; in a fixed
  world the two are equal (the launch-time bootstrap).  State machine::

      joined --(DEREGISTER)--> drained     (voluntary, exits 0)
      joined --(transport death)--> dead
      joined --(DONE)--> done

- push-seq high-water dedupe (:meth:`Roster.note_push`): a worker
  numbers its pushes, and a retried exchange re-sends the same number,
  so the master can tell a push whose reply leg failed (already applied)
  from a new one and never applies a gradient twice.

- :class:`DrainSignal` - the worker-side half of preemption-aware
  drain: a SIGTERM handler that *requests* a drain instead of dying, so
  the worker can flush its in-flight gradient, DEREGISTER, and exit 0.

The elastic entries - a respawned member re-entering through REGISTER
(``join`` with an incarnation count and the rejoin window) and
``restore_watermarks`` - come with the elastic half of ROADMAP A7.  A
fixed world's launch set is not membership telemetry (no ``member_join``
events, as the JAX master bootstraps it quietly); a drain and a death are
logged and recorded (``member_drain``, ``member_dead``, with the roster's
counts) on the recorder the roster is given.
"""

from __future__ import annotations

import logging
import signal
import threading
from dataclasses import dataclass

log = logging.getLogger(__name__)

# member lifecycle states
JOINED = "joined"
DRAINED = "drained"
DEAD = "dead"
DONE = "done"

_TERMINAL = (DRAINED, DONE)


class DrainRequested(Exception):
    """A voluntary-leave request (SIGTERM) observed at a step boundary:
    the worker has flushed its in-flight gradient and should DEREGISTER
    and exit 0."""


@dataclass
class Member:
    """One participant of a parameter-server world."""

    worker_id: int
    rank: int
    state: str = JOINED
    push_seq: int = 0  # high-water APPLIED push seq (dedupe + progress)
    error: str | None = None

    @property
    def terminal(self) -> bool:
        return self.state in _TERMINAL


class Roster:
    """The master's membership table, keyed by worker-id.

    Thread-safe at the method level (every service thread touches it);
    the internal lock is a leaf - no method calls out while holding it -
    so it composes under the master's round lock.
    """

    def __init__(self, recorder=None):
        from pytorch_distributed_rnn_tpu_torch.obs.recorder import NULL_RECORDER

        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self._lock = threading.Lock()  # guards _members, _by_rank
        self._members: dict[int, Member] = {}
        self._by_rank: dict[int, int] = {}

    def bootstrap(self, ranks) -> None:
        """Seed the roster with the launch-time workers: worker-id ==
        rank."""
        with self._lock:
            for rank in ranks:
                rank = int(rank)
                self._members[rank] = Member(worker_id=rank, rank=rank)
                self._by_rank[rank] = rank

    # -- transitions ---------------------------------------------------------

    def drain(self, rank: int, seq: int | None = None) -> Member | None:
        """Voluntary leave (DEREGISTER): terminal, exits the quorum
        denominator without burning its budget."""
        member = self._transition(rank, DRAINED)
        if member is not None:
            self._emit("member_drain", member, seq=seq, **self.counts())
        return member

    def mark_dead(self, rank: int, error: str | None = None) -> Member | None:
        """Involuntary loss (transport death): the member stays on the
        roster as ``dead``."""
        member = self._transition(rank, DEAD)
        if member is not None:
            member.error = error
            self._emit("member_dead", member, error=error, **self.counts())
        return member

    def complete(self, rank: int) -> Member | None:
        """Normal completion (DONE op): terminal, successful."""
        return self._transition(rank, DONE)

    def _transition(self, rank: int, state: str) -> Member | None:
        with self._lock:
            member = self._members.get(self._by_rank.get(rank))
            if member is None:
                return None
            member.state = state
            return member

    # -- push-seq watermark --------------------------------------------------

    def note_push(self, rank: int, seq: int) -> bool:
        """Advance the member's push-seq high-water mark.  Returns False
        for a DUPLICATE (seq at or below the watermark): a retried
        exchange whose original applied - the gradient must not be
        applied again."""
        with self._lock:
            member = self._members.get(self._by_rank.get(rank))
            if member is None:
                return True  # unrostered comms (unit-scripted) pass through
            if seq <= member.push_seq:
                return False
            member.push_seq = seq
            return True

    # -- queries -------------------------------------------------------------

    def member_for_rank(self, rank: int) -> Member | None:
        with self._lock:
            return self._members.get(self._by_rank.get(rank))

    def members(self) -> list[Member]:
        with self._lock:
            return list(self._members.values())

    def round_ranks(self) -> set[int]:
        """Ranks expected in a sync-round rendezvous: the joined ones."""
        with self._lock:
            return {m.rank for m in self._members.values() if m.state == JOINED}

    def all_terminal(self) -> bool:
        with self._lock:
            return all(m.terminal for m in self._members.values())

    def counts(self) -> dict:
        with self._lock:
            counts = dict.fromkeys((JOINED, DRAINED, DEAD, DONE), 0)
            for m in self._members.values():
                counts[m.state] += 1
            return counts

    def _emit(self, kind: str, member: Member, **fields) -> None:
        log.info(f"membership: {kind} worker_id={member.worker_id} rank={member.rank} "
                 f"{fields.get('error') or ''}".rstrip())
        if self.recorder.enabled:
            self.recorder.record(kind, worker_id=member.worker_id, rank_slot=member.rank,
                                 incarnation=0, **fields)


class DrainSignal:
    """Worker-side preemption notice: SIGTERM sets a flag; the training
    loop observes it at the next step boundary (after the in-flight
    gradient exchange completed) and raises :class:`DrainRequested`.

    The handler itself does no I/O and never raises - a signal landing
    mid-``send`` must not tear the wire protocol; the *flush* semantics
    come from checking only between exchanges.
    """

    def __init__(self):
        self.requested = False
        self._installed = False

    def install(self) -> "DrainSignal":
        """Install the SIGTERM handler (main thread only - a rank's
        process qualifies).  Idempotent."""
        if not self._installed:
            signal.signal(signal.SIGTERM, self._on_sigterm)
            self._installed = True
        return self

    def _on_sigterm(self, signum, frame):
        self.requested = True
        log.warning(
            "SIGTERM: drain requested - will flush the in-flight "
            "gradient, deregister, and exit 0 at the next step boundary"
        )

    def check(self) -> None:
        """Raise :class:`DrainRequested` if a drain was requested."""
        if self.requested:
            raise DrainRequested("SIGTERM drain requested")
