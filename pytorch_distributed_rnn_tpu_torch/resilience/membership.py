"""Elastic world membership for the parameter server: the roster, its
lifecycle, and drain signals.  A copy of the JAX package's
``resilience/membership.py`` (plain ``threading`` locks).

- :class:`Member` / :class:`Roster` - the master's live membership
  table.  A member has a stable **worker-id** decoupled from its
  transport **rank**: the rank is a socket slot (reused when a
  supervisor respawns the worker), the worker-id is the logical
  participant whose gradient stream, push-seq watermark and incarnation
  count survive the respawn.  State machine::

      joined --(DEREGISTER)--> drained     (voluntary, exits 0)
      joined --(transport death)--> dead --(REGISTER)--> joined
      joined --(DONE)--> done

  Every transition emits a structured obs event (``member_join`` /
  ``member_drain`` / ``member_dead``) carrying the roster counts; a fixed
  world's launch set joins quietly (``bootstrap(quiet=True)``).

- push-seq high-water dedupe (:meth:`Roster.note_push`): the per-member
  watermark persists across service-thread incarnations, which is what
  guarantees a rejoining worker's stale in-flight push is DROPPED, not
  double-averaged, and that a retried exchange whose original applied is
  not applied twice.

- :class:`DrainSignal` - the worker-side preemption-aware SIGTERM
  drain: a SIGTERM handler that *requests* a drain instead of dying, so
  the worker can flush its in-flight gradient, DEREGISTER, and exit 0
  (distinguishable in telemetry from a crash).
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from dataclasses import dataclass

log = logging.getLogger(__name__)

# member lifecycle states
JOINED = "joined"
DRAINED = "drained"
DEAD = "dead"
DONE = "done"

_TERMINAL = (DRAINED, DONE)


class DrainRequested(Exception):
    """A voluntary-leave request (SIGTERM / chaos ``preempt``) observed
    at a step boundary: the worker has flushed its in-flight gradient
    and should DEREGISTER and exit 0."""


@dataclass
class Member:
    """One logical participant of an elastic world."""

    worker_id: int
    rank: int
    state: str = JOINED
    incarnation: int = 1  # bumped on every (re)join
    push_seq: int = 0  # high-water APPLIED push seq (dedupe + progress)
    synced: bool = True  # has pushed since (re)join: counted in rounds
    died_tm: float | None = None  # monotonic death stamp (rejoin window)
    error: str | None = None

    @property
    def terminal(self) -> bool:
        return self.state in _TERMINAL


class Roster:
    """The master's live membership table, keyed by worker-id.

    Thread-safe at the method level (service threads, the elastic
    acceptor and the completion waiter all touch it); the internal lock
    is a leaf - no method calls out while holding it - so it composes
    under the master's round lock.
    """

    def __init__(self, recorder=None):
        from pytorch_distributed_rnn_tpu_torch.obs.recorder import NULL_RECORDER

        self.recorder = recorder if recorder is not None else NULL_RECORDER
        # a LEAF lock by contract: roster methods never call out
        # while holding it (the master takes its round lock first, never
        # the other way around)
        self._lock = threading.Lock()  # guards: _members, _by_rank
        self._members: dict[int, Member] = {}
        self._by_rank: dict[int, int] = {}
        self.rejoins = 0

    # -- construction --------------------------------------------------------

    def bootstrap(self, ranks, quiet: bool = False) -> None:
        """Seed the roster with the launch-time workers: worker-id ==
        initial rank (the ids only *diverge* from ranks for members that
        join later or respawn into reused slots).  ``quiet`` suppresses
        the per-member ``member_join`` events - a fixed (non-elastic)
        world's launch set is not membership telemetry."""
        for rank in ranks:
            self.join(int(rank), int(rank), event="bootstrap", quiet=quiet)

    # -- transitions ---------------------------------------------------------

    def join(self, worker_id: int, rank: int,
             event: str = "register", quiet: bool = False) -> Member:
        """(Re)join: a fresh member enters ``joined``; a known one - the
        respawn path - re-enters it with its incarnation bumped and its
        push-seq watermark PRESERVED (the double-count guard).  Any
        member arriving via REGISTER - fresh or respawned - enters the
        NEXT sync round (synced only after its first push), so an
        in-flight round never blocks on a joiner's data load + model
        build; only launch-time bootstrap members are expected from
        round one."""
        with self._lock:
            member = self._members.get(worker_id)
            if member is None:
                member = Member(worker_id=worker_id, rank=rank,
                                synced=(event == "bootstrap"))
                self._members[worker_id] = member
                rejoin = False
            else:
                member.incarnation += 1
                member.state = JOINED
                member.rank = rank
                member.died_tm = None
                member.error = None
                # the rejoiner enters the NEXT sync round: it is not
                # counted in the rendezvous until its first push lands,
                # so an in-flight round never blocks on its model build
                member.synced = False
                rejoin = True
                self.rejoins += 1
            self._by_rank[rank] = worker_id
            counts = self._counts_locked()
        if not quiet:
            self._emit("member_join", member, via=event, rejoin=rejoin,
                       **counts)
        return member

    def drain(self, rank: int, seq: int | None = None) -> Member | None:
        """Voluntary leave (DEREGISTER): terminal, exits the quorum
        denominator without burning its budget."""
        member = self._transition(rank, DRAINED)
        if member is not None:
            self._emit("member_drain", member, seq=seq, **self.counts())
        return member

    def mark_dead(self, rank: int, error: str | None = None) -> Member | None:
        """Involuntary loss (transport death): the member stays on the
        roster as ``dead`` and may re-enter - only via REGISTER."""
        member = self._transition(rank, DEAD)
        if member is not None:
            member.died_tm = time.perf_counter()
            member.error = error
            self._emit("member_dead", member, error=error, **self.counts())
        return member

    def complete(self, rank: int) -> Member | None:
        """Normal completion (DONE op): terminal, successful."""
        return self._transition(rank, DONE)

    def _transition(self, rank: int, state: str) -> Member | None:
        with self._lock:
            worker_id = self._by_rank.get(rank)
            member = self._members.get(worker_id)
            if member is None:
                return None
            member.state = state
            return member

    # -- push-seq watermark --------------------------------------------------

    def note_push(self, rank: int, seq: int) -> bool:
        """Advance the member's push-seq high-water mark.  Returns False
        for a DUPLICATE (seq at or below the watermark): a retried
        exchange whose original applied, or a rejoined worker's stale
        in-flight push - either way the gradient must not be applied
        again.  A member's first post-join push also marks it synced
        (counted in sync-round rendezvous from the next round on)."""
        with self._lock:
            member = self._members.get(self._by_rank.get(rank))
            if member is None:
                return True  # unrostered comms (unit-scripted) pass through
            if seq <= member.push_seq:
                return False
            member.push_seq = seq
            member.synced = True
            return True

    def watermarks(self) -> dict[int, int]:
        """Per-worker-id push-seq watermark snapshot - what a streaming
        learner persists alongside its params so the exactly-once
        guarantee survives ITS OWN restart, not just the pushers'."""
        with self._lock:
            return {m.worker_id: m.push_seq for m in self._members.values()}

    def restore_watermarks(self, watermarks: dict) -> None:
        """Re-seed watermarks from a checkpoint (the learner-failover
        inverse of :meth:`watermarks`).  Known members only RAISE their
        mark; unknown worker-ids are pre-rostered as ``dead`` (rankless)
        so they re-enter only via REGISTER - and their first post-restart
        push dedupes against the restored mark instead of re-applying
        experience the dead incarnation already trained on."""
        now = time.perf_counter()
        with self._lock:
            for worker_id, seq in watermarks.items():
                worker_id, seq = int(worker_id), int(seq)
                member = self._members.get(worker_id)
                if member is None:
                    member = Member(worker_id=worker_id, rank=-1,
                                    state=DEAD, synced=False, died_tm=now)
                    self._members[worker_id] = member
                member.push_seq = max(member.push_seq, seq)

    # -- queries -------------------------------------------------------------

    def member_for_rank(self, rank: int) -> Member | None:
        with self._lock:
            return self._members.get(self._by_rank.get(rank))

    def get(self, worker_id: int) -> Member | None:
        with self._lock:
            return self._members.get(worker_id)

    def members(self) -> list[Member]:
        with self._lock:
            return list(self._members.values())

    def round_ranks(self) -> set[int]:
        """Ranks expected in a sync-round rendezvous: joined AND synced
        (a just-rejoined member is excluded until its first push)."""
        with self._lock:
            return {
                m.rank for m in self._members.values()
                if m.state == JOINED and m.synced
            }

    def dead_members(self) -> list[Member]:
        with self._lock:
            return [m for m in self._members.values() if m.state == DEAD]

    def all_terminal(self) -> bool:
        with self._lock:
            return all(m.terminal for m in self._members.values())

    def counts(self) -> dict:
        with self._lock:
            return self._counts_locked()

    def _counts_locked(self) -> dict:
        counts = dict.fromkeys((JOINED, DRAINED, DEAD, DONE), 0)
        for m in self._members.values():
            counts[m.state] += 1
        return {
            "joined": counts[JOINED], "drained": counts[DRAINED],
            "dead": counts[DEAD], "done": counts[DONE],
        }

    # -- telemetry -----------------------------------------------------------

    def _emit(self, kind: str, member: Member, **fields) -> None:
        log.info(
            f"membership: {kind} worker_id={member.worker_id} "
            f"rank={member.rank} incarnation={member.incarnation}"
        )
        if self.recorder is not None and self.recorder.enabled:
            self.recorder.record(
                kind, worker_id=member.worker_id, rank_slot=member.rank,
                incarnation=member.incarnation, **fields,
            )


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
        """Install the SIGTERM handler (main thread only - spawned
        strategy processes qualify).  Idempotent."""
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
