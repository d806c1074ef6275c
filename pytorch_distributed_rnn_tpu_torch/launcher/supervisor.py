"""Process supervisors: watch, respawn, rejoin (the part of the JAX
package's ``launcher/supervisor.py`` that the parameter server and the
serving fleet use).

:class:`RespawnSupervisor` watches spawned processes on one machine - the
local analogue of a k8s restart policy or a preemptible-VM instance
group:

- each slot keeps its stable **worker-id** across respawns: the
  relaunched process re-enters under the same identity (a PS worker
  star-joins and REGISTERs under its id; a fleet replica rebinds the port
  its slot was launched on);
- a process exiting **0** is terminal (normal completion or a SIGTERM
  drain) - never respawned;
- a nonzero/signal exit is a death: respawned with ``rejoin=True`` up
  to ``max_respawns`` times per slot (a fixed delay - the model rebuild
  dominates);
- when a slot's respawn budget is exhausted, the supervisor keeps the
  run alive only while at least ``min_workers`` slots remain live or
  completed.

The supervisor is deliberately dumb about *state*: everything a respawn
needs to continue correctly lives outside it, which is what makes the
kill -> respawn path drillable with the chaos actions in
``resilience/faults.py``.  :class:`ElasticSupervisor` is the parameter
server's flavor and :class:`ReplicaSupervisor` the serving fleet's.  The
pipeline stages' and the streaming actors' (``StageSupervisor``,
``ActorSupervisor`` in the JAX package) come with their strategies
(ROADMAP.md A7, A8).
"""

from __future__ import annotations

import logging
import signal
import subprocess
import time
from dataclasses import dataclass, field

log = logging.getLogger(__name__)


class PopenProcess:
    """Adapts :class:`subprocess.Popen` to the process contract the
    supervisors poll (``is_alive``/``exitcode``/``terminate``/``join``)."""

    def __init__(self, proc: subprocess.Popen):
        self.proc = proc

    @property
    def pid(self) -> int:
        return self.proc.pid

    def is_alive(self) -> bool:
        return self.proc.poll() is None

    @property
    def exitcode(self):
        return self.proc.poll()

    def terminate(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()

    def join(self, timeout: float | None = None) -> None:
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass


@dataclass
class _Slot:
    """One supervised process slot (worker-id == launch rank)."""

    worker_id: int
    rank: int
    process: object
    respawns: int = 0
    completed: bool = False
    failed: bool = False
    history: list = field(default_factory=list)  # exit codes observed


class RespawnSupervisor:
    """The respawn/min-workers core: watches spawned processes, reaps
    exits, respawns deaths into the same slot."""

    def __init__(self, spawn_worker, *, min_workers: int = 1,
                 max_respawns: int = 3, respawn_delay_s: float = 0.1,
                 poll_s: float = 0.05, on_event=None):
        """``spawn_worker(rank, worker_id, rejoin) -> process`` launches
        one process (``process`` needs ``is_alive()``, ``exitcode`` and
        ``terminate()``/``join()``).

        ``on_event(kind, **fields)`` is an optional observer hook fired
        on supervision transitions (``worker_respawn`` / ``worker_lost``
        / ``pool_collapse``): the PS runner wires it to the live plane's
        alert pusher (``obs/live.EventPusher``), the MPMD runner to its
        supervisor sidecar - the supervisor itself stays
        transport-agnostic.  Hook failures are swallowed."""
        self._spawn_worker = spawn_worker
        self.min_workers = int(min_workers)
        self.max_respawns = int(max_respawns)
        self.respawn_delay_s = float(respawn_delay_s)
        self.poll_s = float(poll_s)
        self.slots: dict[int, _Slot] = {}
        self.total_respawns = 0
        self._on_event = on_event

    def _emit(self, kind: str, **fields) -> None:
        if self._on_event is None:
            return
        try:
            self._on_event(kind, **fields)
        except Exception:  # observability must never kill supervision
            log.exception(f"supervisor: on_event({kind}) hook failed")

    def launch(self, ranks) -> None:
        """Spawn the initial process set (worker-id == launch rank)."""
        for rank in ranks:
            proc = self._spawn_worker(rank, rank, False)
            self.slots[rank] = _Slot(worker_id=rank, rank=rank,
                                     process=proc)

    def adopt(self, rank: int, worker_id: int | None = None):
        """Elastic JOIN: spawn a brand-new slot mid-run (a worker that
        did not exist at launch) and supervise it like the rest - the
        process half of a roster ``join``.  The new slot gets the full
        respawn budget; ``min_workers`` is unchanged (joining must
        never make an already-healthy pool collapsible)."""
        worker_id = rank if worker_id is None else int(worker_id)
        if worker_id in self.slots:
            raise ValueError(
                f"worker-id {worker_id} already supervised; a respawn "
                f"reuses its slot, only a NEW identity can be adopted"
            )
        proc = self._spawn_worker(rank, worker_id, False)
        self.slots[worker_id] = _Slot(worker_id=worker_id, rank=rank,
                                      process=proc)
        self._emit("worker_join", worker_id=worker_id, rank=rank)
        return proc

    # -- monitoring ----------------------------------------------------------

    def _live_or_completed(self) -> int:
        return sum(
            1 for s in self.slots.values()
            if s.completed or (not s.failed and s.process.is_alive())
        )

    def poll(self) -> bool:
        """One supervision pass: reap exits, respawn deaths.  Returns
        False when the pool has fallen below ``min_workers`` with no
        respawn budget left (the caller should tear down)."""
        for slot in self.slots.values():
            if slot.completed or slot.failed or slot.process.is_alive():
                continue
            code = slot.process.exitcode
            slot.history.append(code)
            if code == 0:
                # normal completion OR a SIGTERM drain: both are
                # voluntary exits the world already accounted for
                slot.completed = True
                log.info(
                    f"supervisor: worker-id {slot.worker_id} exited 0 "
                    f"(terminal)"
                )
                continue
            if slot.respawns >= self.max_respawns:
                slot.failed = True
                log.error(
                    f"supervisor: worker-id {slot.worker_id} died "
                    f"(exit {code}) with no respawn budget left "
                    f"({self.max_respawns} used)"
                )
                self._emit("worker_lost", worker_id=slot.worker_id,
                           rank=slot.rank, exit_code=code,
                           respawns_used=slot.respawns)
                continue
            slot.respawns += 1
            self.total_respawns += 1
            log.warning(
                f"supervisor: worker-id {slot.worker_id} died "
                f"(exit {code}); respawning into rank {slot.rank} "
                f"(respawn {slot.respawns}/{self.max_respawns})"
            )
            self._emit("worker_respawn", worker_id=slot.worker_id,
                       rank=slot.rank, exit_code=code,
                       respawn=slot.respawns,
                       max_respawns=self.max_respawns)
            time.sleep(self.respawn_delay_s)
            slot.process = self._spawn_worker(
                slot.rank, slot.worker_id, True
            )
        healthy = self._live_or_completed() >= self.min_workers
        if not healthy:
            self._emit("pool_collapse", min_workers=self.min_workers,
                       live_or_completed=self._live_or_completed())
        return healthy

    def supervise(self, until_exit) -> bool:
        """Supervision loop anchored on an UNSUPERVISED process: poll
        until ``until_exit()`` returns an exit code (the PS master
        finishing) or the pool collapses below the floor.  Returns True
        while healthy, False on collapse."""
        while until_exit() is None:
            if not self.poll():
                return False
            time.sleep(self.poll_s)
        return True

    def supervise_all(self) -> bool:
        """Supervision loop with NO external anchor: poll until every
        slot is terminal (completed or failed) or the pool collapses.
        Returns True iff every slot completed - the MPMD shape, where
        all processes are supervised peers."""
        while True:
            if not self.poll():
                return False
            if all(s.completed or s.failed for s in self.slots.values()):
                return all(s.completed for s in self.slots.values())
            time.sleep(self.poll_s)

    def shutdown(self, timeout_s: float = 10.0) -> None:
        """Terminate whatever is still running, reap everything, and
        settle the final per-slot verdicts - without respawning (the
        run is over)."""
        for slot in self.slots.values():
            if slot.process.is_alive():
                slot.process.terminate()
        deadline = time.monotonic() + timeout_s
        for slot in self.slots.values():
            slot.process.join(timeout=max(0.1, deadline - time.monotonic()))
            if not slot.completed and not slot.failed \
                    and not slot.process.is_alive():
                slot.history.append(slot.process.exitcode)
                slot.completed = slot.process.exitcode == 0
                slot.failed = not slot.completed

    def verdict(self) -> dict:
        """Supervision outcome for logs/telemetry."""
        return {
            "workers": len(self.slots),
            "completed": sum(1 for s in self.slots.values() if s.completed),
            "failed": sum(1 for s in self.slots.values() if s.failed),
            "respawns": self.total_respawns,
        }


def supervision_alert_hook(recorder=None, push=None):
    """The ONE ``on_event`` wiring for every supervisor flavor, so PS,
    stage and actor supervisors emit ``worker_respawn`` /
    ``worker_lost`` / ``pool_collapse`` (and elastic ``worker_join``)
    alerts uniformly instead of each runner hand-rolling the plumbing:

    - ``recorder`` (a :class:`~..obs.recorder.MetricsRecorder`): each
      event lands in the supervisor's sidecar and is flushed
      immediately - supervision events are rare and must survive a
      teardown;
    - ``push`` (the live plane's ``EventPusher.push``): the same event
      goes to the fleet aggregator as an alert.

    Returns ``None`` when there is nothing to wire (the supervisor then
    skips hook dispatch entirely)."""
    if recorder is None and push is None:
        return None

    def on_event(kind, **fields):
        if recorder is not None and recorder.enabled:
            recorder.record(kind, **fields)
            recorder.flush()
        if push is not None:
            push(kind, **fields)

    return on_event


class ElasticSupervisor(RespawnSupervisor):
    """PS flavor: supervises the WORKER processes around an
    unsupervised master (the master owns the state; its exit anchors
    :meth:`supervise`).  A respawned worker star-joins the transport on
    the same rank and REGISTERs under the same worker-id, so the
    master's push-seq watermark and data shard carry over."""


class ReplicaSupervisor(RespawnSupervisor):
    """Serving-fleet flavor (``serving/fleet/``): the ``serve``
    engine REPLICAS behind the router are supervised; the router itself
    is the unsupervised anchor (it owns no model state and dying with
    it is an outage, not a degradation).  A respawned replica rebinds
    the SAME host:port its slot was launched on, so the router's static
    pool entry stays valid and the circuit breaker re-admits it through
    half-open probing once its pings succeed - no re-registration
    protocol needed.  A SIGTERM drain (stop dispatching, finish
    in-flight, DEREGISTER via the drained digest) exits 0 and is
    terminal; the floor is the minimum replica count that keeps the
    fleet serving - losing replicas degrades capacity, never
    correctness (requests reroute)."""
