"""Parameter-server master: owns the parameters, the optimizer state and
the roster.  The counterpart of the JAX package's
``param_server/master.py``.

A single process holds the authoritative flat parameter vector and the
optimizer; workers never talk to each other.  Workers push local
gradients, the master applies the update and returns fresh params.

Concurrency: one service thread per worker (each worker owns a dedicated
socket); updates run under a lock, so gradient application is serialized
but arrival order is free (``async``).  ``sync_mode=True`` instead
gathers one gradient from every live worker, averages, and applies a
single update (DDP-equivalent math).  The average sums the gradients in
worker-rank order and then divides by their count, so a sync run gives
the same bits at any worker count and arrival order (JAX's ``np.mean``
over the arrival-ordered gather differs from it by rounding only).

Every push is checked before it is applied: its size, and that every
value is finite - the reference asserted that gradients reached the
master each batch; this asserts their integrity.

Membership is a live object (``resilience/membership.py``): every worker
is a rostered member with a stable worker-id decoupled from its
transport rank.  A REGISTER (re)joins a member: it receives a STATE_SYNC
(current params, the master's update count, its own push-seq watermark)
and enters the next sync round.  ``elastic=True`` runs an acceptor on
the rendezvous listener, so a respawned or new worker can star-join
mid-run; each accepted rank gets a service thread of a new generation (a
stale thread of an older one exits without touching the new socket), a
dead member is held on the roster for ``join_timeout`` seconds awaiting
its rejoin, and the run ends when no member is joined and no dead one is
inside its window (:meth:`ParameterServerMaster._await_membership_
terminal`).  A push from an unrostered rank, or from a dead member that
did not REGISTER, is refused; a rejoiner's stale push (at or below its
watermark) is not applied again.  A SIGTERM-drained worker leaves via
DEREGISTER: the roster shrinks voluntarily, without burning the quorum
budget.

Telemetry (``recorder``, the master's rank-0 sidecar), as the JAX
master records it: a ``ps_round`` span a round (sync: from the round's
first push to its update, with its gathered and expected counts and
each worker's push seq; async: the update, under the lock), a
``ps_worker_dead`` event, a ``state_sync`` span a REGISTER, the roster's
``member_join`` (elastic worlds), ``member_dead`` and ``member_drain``,
and at the end ``ps_summary`` and a ``run_summary`` with the roster's
counts and rejoins.
"""

from __future__ import annotations

import hashlib
import logging
import math
import threading
import time

import torch

from pytorch_distributed_rnn_tpu_torch.param_server import protocol
from pytorch_distributed_rnn_tpu_torch.resilience import membership

log = logging.getLogger(__name__)

# the rank slots an elastic master reserves beyond its launch world
ELASTIC_RANK_HEADROOM = 8


class ParameterServerMaster:
    def __init__(self, comm, flat_params: torch.Tensor, apply_update, sync_mode: bool = False,
                 sync_timeout: float = 300.0, quorum: float = 1.0, recorder=None,
                 elastic: bool = False, join_timeout: float = 60.0):
        """``apply_update(flat_grads) -> flat_params`` advances the owned
        state by one optimizer step and returns the new flat params (a
        float32 CPU tensor the master sends as they are).
        ``sync_timeout`` bounds how long a sync round waits for
        stragglers.  ``quorum`` is the fraction of workers whose
        gradients suffice to close a sync round once ``sync_timeout``
        expires: at the default 1.0 a straggler past the timeout is fatal
        (strict DDP-equivalent rounds), while e.g. 0.5 lets the round
        DEGRADE - average what arrived, apply, release the waiters - and
        a straggler's late gradient joins the next round.

        ``elastic`` accepts REGISTER (re)joins mid-run on the rendezvous
        listener: a dead worker is held on the roster for
        ``join_timeout`` seconds awaiting its respawn before being
        abandoned; worker deaths are tolerated (pending rejoin) even at
        quorum 1.0, and the final verdict fails only when an abandoned
        loss leaves fewer than the quorum's worth of done or drained
        workers.  The transport keeps ``ELASTIC_RANK_HEADROOM`` rank
        slots beyond the launch world for new joiners."""
        if not 0.0 < quorum <= 1.0:
            raise ValueError(f"quorum must be in (0, 1], got {quorum}")
        from pytorch_distributed_rnn_tpu_torch.obs.recorder import NULL_RECORDER

        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self.comm = comm
        self.params = flat_params
        self.apply_update = apply_update
        self.sync_mode = sync_mode
        self.sync_timeout = float(sync_timeout)
        self.quorum = float(quorum)
        self.elastic = bool(elastic)
        self.join_timeout = float(join_timeout)
        # lock order: _gen_lock -> lock -> Roster._lock (a dying service
        # thread holds _gen_lock through _mark_dead, which takes the round
        # lock and then the roster's; nothing takes them the other way)
        self.lock = threading.Lock()
        self.num_params = int(flat_params.numel())
        self.updates_applied = 0
        self.degraded_rounds = 0
        self.roster = membership.Roster(recorder=self.recorder)
        # a fixed world's launch set is not membership telemetry
        self.roster.bootstrap(range(1, self.comm.world_size), quiet=not self.elastic)
        # sync-mode rendezvous state: the gradients, each worker's push
        # seq and when the round's first push arrived
        self._pending: dict[int, torch.Tensor] = {}
        self._round_seqs: dict[int, int] = {}
        self._round_tm0 = None
        self._sync_cv = threading.Condition(self.lock)
        # elastic bookkeeping: each rank's service-thread generation (a
        # stale thread dying after its rank was re-accepted must not mark
        # the new incarnation dead) and the tolerated deaths a rejoin
        # clears.  A thread that passes the stale check holds _gen_lock
        # through its _mark_dead, so the mark lands before the replacement
        # thread exists (and so before the new incarnation can REGISTER)
        self._thread_gen: dict[int, int] = {}
        self._gen_lock = threading.Lock()  # guards: _thread_gen
        self._tolerated: dict[int, BaseException] = {}
        self._member_cv = threading.Condition(threading.Lock())

    def serve(self) -> torch.Tensor:
        """Block until the roster reaches a terminal state: every member
        done (DONE) or drained (DEREGISTER), with no dead member still
        inside its rejoin window.  A failure in a worker's service thread
        (socket error, integrity check) is re-raised here so the master
        process reports failure - except where deaths are tolerated
        (quorum-degraded sync mode, or any elastic world): a dying worker
        is then marked dead, dropped from later rounds and awaited for a
        rejoin, and only a quorum-breaking abandoned loss fails the run.
        Returns the final flat params."""
        serve_tm0 = time.perf_counter()
        num_workers = self.comm.world_size - 1
        errors: dict[int, BaseException] = {}
        tolerate = self.elastic or (self.sync_mode and self.quorum < 1.0)
        stop_accept = threading.Event()

        def guarded(worker, gen):
            try:
                self._serve_worker(worker, gen=gen)
            except BaseException as exc:  # noqa: BLE001 - propagated below
                with self._gen_lock:
                    if self._thread_gen.get(worker) != gen:
                        # a newer incarnation owns this rank already (the
                        # respawn raced this thread's death detection)
                        log.info(f"stale service thread for rank {worker} exited "
                                 f"({type(exc).__name__}); rank re-owned")
                    elif tolerate:
                        self._tolerated[worker] = exc
                        self._mark_dead(worker, exc)
                    else:
                        errors[worker] = exc
            finally:
                with self._member_cv:
                    self._member_cv.notify_all()

        def spawn(worker):
            with self._gen_lock:
                gen = self._thread_gen.get(worker, 0) + 1
                self._thread_gen[worker] = gen
            t = threading.Thread(target=guarded, args=(worker, gen), daemon=True)
            t.start()
            return t

        if self.elastic and hasattr(self.comm, "reserve"):
            # before any service thread: the reserve reallocates the peer
            # table, which must not race an in-flight send or recv
            self.comm.reserve(self.comm.world_size + ELASTIC_RANK_HEADROOM)
        threads = [spawn(w) for w in range(1, self.comm.world_size)]

        acceptor = None
        if self.elastic and hasattr(self.comm, "accept_peer"):
            def accept_loop():
                while not stop_accept.is_set():
                    rank = self.comm.accept_peer(timeout_s=0.25)
                    if rank is not None:
                        log.info(f"elastic accept: rank {rank} connected; awaiting REGISTER")
                        threads.append(spawn(rank))

            acceptor = threading.Thread(target=accept_loop, daemon=True)
            acceptor.start()

        if not self.elastic:
            for t in threads:
                t.join()
        else:
            self._await_membership_terminal(errors)
            stop_accept.set()
            if acceptor is not None:
                acceptor.join(timeout=5.0)
            for t in list(threads):
                t.join(timeout=5.0)

        if errors:
            worker, exc = next(iter(errors.items()))
            raise RuntimeError(
                f"parameter-server worker thread(s) failed: {sorted(errors)} "
                f"(first: worker {worker})"
            ) from exc
        members = self.roster.members()
        lost = [m for m in members if m.state == membership.DEAD]
        survivors = sum(1 for m in members if m.state in (membership.DONE, membership.DRAINED))
        if lost and survivors < self._quorum_count(num_workers):
            raise RuntimeError(
                f"parameter server lost quorum: {sorted(m.rank for m in lost)} worker(s) "
                f"{'abandoned (rejoin window expired)' if self.elastic else 'died'}, "
                f"{survivors} survivor(s) < quorum {self._quorum_count(num_workers)}"
            ) from self._tolerated.get(lost[0].rank)
        counts = self.roster.counts()
        log.info(
            f"parameter server done: {self.updates_applied} updates applied, roster "
            f"{counts}"
            + (f", {self.degraded_rounds} degraded round(s)" if self.degraded_rounds else "")
            + (f", {self.roster.rejoins} rejoin(s)" if self.roster.rejoins else "")
        )
        self.recorder.record("ps_summary", updates=self.updates_applied,
                             degraded_rounds=self.degraded_rounds, workers_lost=len(lost),
                             rejoins=self.roster.rejoins)
        # the roster's verdict, where the summaries read a run's outcome
        self.recorder.record("run_summary", duration_s=time.perf_counter() - serve_tm0,
                             steps=self.updates_applied, roster=counts,
                             rejoins=self.roster.rejoins, degraded_rounds=self.degraded_rounds)
        self.recorder.flush()
        return self.params

    def _await_membership_terminal(self, errors):
        """The elastic completion wait: the run is over when no member is
        still joined and every dead member's rejoin window has expired (a
        rejoin re-enters ``joined`` and keeps the run alive)."""
        while not errors:
            members = self.roster.members()
            now = time.perf_counter()
            joined = [m for m in members if m.state == membership.JOINED]
            awaiting = [m for m in members if m.state == membership.DEAD
                        and m.died_tm is not None and now - m.died_tm < self.join_timeout]
            if not joined and not awaiting:
                return
            with self._member_cv:
                self._member_cv.wait(timeout=0.2)

    def _mark_dead(self, worker: int, exc: BaseException):
        """Involuntary loss: drop a dead worker from the rendezvous so
        later rounds close over the survivors instead of timing out on
        it; if the in-flight round now has every live worker's gradient,
        close it here."""
        log.warning(f"worker {worker} dropped from the sync rendezvous "
                    f"({type(exc).__name__}: {exc}); degrading to survivors")
        self.recorder.record("ps_worker_dead", worker=worker,
                             error=f"{type(exc).__name__}: {str(exc)[:200]}")
        self.roster.mark_dead(worker, error=f"{type(exc).__name__}: {str(exc)[:200]}")
        self._rendezvous_leave(worker)

    def _rendezvous_leave(self, worker: int):
        """A member left the round rendezvous (death or drain): discard
        its in-flight contribution and close the round if the survivors
        now cover it.  The roster transition must already have happened
        (``round_ranks`` excludes the leaver)."""
        with self._sync_cv:
            self._pending.pop(worker, None)
            self._round_seqs.pop(worker, None)
            live = len(self.roster.round_ranks())
            if self._pending and len(self._pending) >= max(1, live):
                self._close_round()

    def _serve_worker(self, worker: int, gen: int | None = None):
        while True:
            if gen is not None:
                with self._gen_lock:
                    stale = self._thread_gen.get(worker) != gen
                if stale:
                    # the rank's socket slot was re-accepted while this
                    # thread served a request: the new socket belongs to
                    # the replacement thread
                    return
            opcode, grads, seq = protocol.recv_request(self.comm, worker, self.num_params)
            if opcode == protocol.OP_DONE:
                self.roster.complete(worker)
                return
            if opcode == protocol.OP_REGISTER:
                self._register_worker(worker, worker_id=seq or worker)
                continue
            if opcode == protocol.OP_DEREGISTER:
                # voluntary leave (preemption-aware drain): exits the
                # rendezvous and the quorum denominator without burning
                # the quorum budget - and exits this thread cleanly
                self.roster.drain(worker, seq=seq)
                self._rendezvous_leave(worker)
                return
            if opcode == protocol.OP_PULL:
                with self.lock:
                    # the reply carries the params it was snapshotted
                    # against: sent under the lock, no update interleaves
                    protocol.send_params(self.comm, worker, self.params)
                continue
            if opcode != protocol.OP_PUSH:
                raise RuntimeError(f"worker {worker} sent opcode {opcode}, which the parameter "
                                   "server does not handle")
            member = self.roster.member_for_rank(worker)
            if member is None and self.elastic:
                # a star-joined rank pushing without REGISTER: unrostered
                # gradients are never averaged in (its pending entry could
                # close a round early against a rendezvous that does not
                # count it) - entry is through the join protocol only
                raise RuntimeError(f"push from unrostered rank {worker} without REGISTER; "
                                   "elastic-world entry requires the join protocol")
            if member is not None and member.state == membership.DEAD:
                # a rank marked dead whose transport recovered re-enters
                # through REGISTER (state sync and watermarks), never by
                # reappearing: its stale stream could double-count
                raise RuntimeError(f"push from dead member (worker-id {member.worker_id}, "
                                   f"rank {worker}) without REGISTER; membership re-entry "
                                   "requires the join protocol")
            if not self.roster.note_push(worker, seq):
                # at or below the member's push-seq watermark: a retried
                # push whose original made it through but whose reply leg
                # failed, or a rejoined worker's stale in-flight push.  The
                # gradient is already accounted for - do not average it in
                # twice, just resend the current params
                log.warning(f"worker {worker} re-sent push seq {seq}; replying with current "
                            "params without re-applying")
                with self.lock:
                    protocol.send_params(self.comm, worker, self.params)
                continue
            if grads is None or grads.numel() != self.num_params:
                raise RuntimeError(f"worker {worker} pushed a malformed gradient")
            if not bool(torch.isfinite(grads).all()):
                raise RuntimeError(
                    f"worker {worker} pushed non-finite gradients (the reference asserts "
                    "gradient presence per batch; this asserts integrity)"
                )
            if self.sync_mode:
                self._push_sync(worker, grads, seq)
            else:
                with self.lock:
                    # the span inside the lock: updates are serialized, so
                    # the spans on the master's ps row do not overlap
                    t0 = time.perf_counter()
                    self.params = self.apply_update(grads)
                    self.updates_applied += 1
                    protocol.send_params(self.comm, worker, self.params)
                    if self.recorder.enabled:
                        self.recorder.emit_span("ps_round", t0, time.perf_counter() - t0,
                                                cat="ps", round=self.updates_applied,
                                                worker=worker, seq=seq, mode="async")

    def _register_worker(self, worker: int, worker_id: int):
        """The join protocol's master half: roster the (re)join, then reply
        with a STATE_SYNC - the current params, the master's update count
        and the member's push-seq watermark - so the joiner adopts
        authoritative state and numbers its pushes above everything
        already applied."""
        t0 = time.perf_counter()
        member = self.roster.join(worker_id, worker)
        self._tolerated.pop(worker, None)
        with self.lock:
            step_watermark = self.updates_applied
            seq_watermark = member.push_seq
            protocol.send_state_sync(self.comm, worker, self.params, step_watermark,
                                     seq_watermark)
            digest = hashlib.sha256(self.params.contiguous().numpy().tobytes()).hexdigest()
        log.info(f"state sync: worker-id {worker_id} (rank {worker}, incarnation "
                 f"{member.incarnation}) <- {self.num_params} params @ update {step_watermark}, "
                 f"push-seq watermark {seq_watermark}; parameters sha256 {digest}")
        if self.recorder.enabled:
            self.recorder.emit_span("state_sync", t0, time.perf_counter() - t0, cat="member",
                                    worker_id=worker_id, rank_slot=worker,
                                    incarnation=member.incarnation, step=step_watermark,
                                    seq=seq_watermark)
        with self._member_cv:
            self._member_cv.notify_all()

    def _close_round(self, degraded: bool = False):  # holds: lock
        """Average the gathered gradients (summed in worker-rank order,
        then divided by their count), apply ONE update, reply to every
        worker owed fresh params, wake the waiters.  Caller holds the
        lock."""
        ranks = sorted(self._pending)
        expected = len(self.roster.round_ranks())
        tm0, self._round_tm0 = self._round_tm0, None
        seqs = {str(w): s for w, s in self._round_seqs.items() if s is not None}
        self._round_seqs = {}
        total = self._pending[ranks[0]].clone()
        for w in ranks[1:]:
            total.add_(self._pending[w])
        self.params = self.apply_update(total.div_(len(ranks)))
        self.updates_applied += 1
        if self.recorder.enabled:
            now = time.perf_counter()
            # the push seq each worker contributed: what the timeline's
            # clock alignment pairs with the workers' push exchanges
            self.recorder.emit_span("ps_round", now if tm0 is None else tm0,
                                    0.0 if tm0 is None else now - tm0, cat="ps",
                                    round=self.updates_applied, gathered=len(ranks),
                                    expected=expected, degraded=degraded, mode="sync",
                                    seqs=seqs)
        for w in ranks:
            try:
                protocol.send_params(self.comm, w, self.params)
            except Exception as exc:
                if self.quorum >= 1.0 and not self.elastic:
                    raise
                # a worker that died between push and reply: its service
                # thread also fails and marks it dead; the broken reply
                # must not kill the thread closing the round for the others
                log.warning(f"reply to worker {w} failed ({exc}); leaving it to the "
                            "rendezvous death path")
        self._pending.clear()
        self._sync_cv.notify_all()

    def _quorum_count(self, num_workers: int) -> int:
        return max(1, math.ceil(self.quorum * num_workers))

    def _push_sync(self, worker: int, grads: torch.Tensor, seq: int | None = None):
        """Gather one gradient per live synced worker, average, apply
        once, release.

        On straggler timeout the round degrades to the configured quorum
        (``quorum < 1`` and enough gradients arrived) or fails loudly
        (strict mode, or not even a quorum delivered).  A member that
        (re)joined mid-round is not expected until its first push lands:
        it enters the next round."""
        with self._sync_cv:
            num_workers = max(1, len(self.roster.round_ranks()))
            if not self._pending:
                self._round_tm0 = time.perf_counter()
            self._pending[worker] = grads
            self._round_seqs[worker] = seq
            if len(self._pending) >= num_workers:
                self._close_round()
                return
            generation = self.updates_applied
            completed = self._sync_cv.wait_for(lambda: self.updates_applied > generation,
                                               timeout=self.sync_timeout)
            if completed:
                return
            # wait_for re-checks under the lock, so exactly one waiter
            # observes the still-open round and owns the timeout decision;
            # later waiters see updates_applied advanced and return above
            num_workers = max(1, len(self.roster.round_ranks()))
            missing = num_workers - len(self._pending)
            if self.quorum < 1.0 and len(self._pending) >= self._quorum_count(num_workers):
                self.degraded_rounds += 1
                log.warning(
                    f"sync round degraded to quorum: {len(self._pending)}/{num_workers} "
                    f"gradient(s) after {self.sync_timeout}s ({missing} straggler(s)); applying "
                    f"the partial average (degraded rounds so far: {self.degraded_rounds})"
                )
                self._close_round(degraded=True)
                return
            # a straggler never delivered and no quorum covers it: fail
            # loudly instead of silently proceeding with stale parameters
            raise RuntimeError(
                f"sync-mode round timed out after {self.sync_timeout}s waiting on {missing} "
                f"missing gradient(s) (worker {worker} was waiting; quorum "
                f"{self._quorum_count(num_workers)}/{num_workers} "
                f"{'not met' if self.quorum < 1.0 else 'disabled'})"
            )

