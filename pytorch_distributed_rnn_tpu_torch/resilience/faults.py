"""Deterministic, seedable fault-injection schedules: a copy of the JAX
package's ``resilience/faults.py`` (pure Python), with
:meth:`FaultSchedule.corrupt_batch` writing NaN through torch.

The reference benchmarked under injected network faults (``tc netem``
delay 0-400 ms / loss 0-15 % around every run, fabfile.py:130-191); the
TPU port reproduces that half through the native transport's
``PDRNN_FAULT_DELAY_MS`` / ``PDRNN_FAULT_LOSS_PROB`` env contract
(``runtime/native.py``).  A :class:`FaultSchedule` extends the same idea
to the rest of the stack - data pipeline, gradients, process lifetime -
with triggers addressed to exact steps/epochs (or seeded per-step
probabilities), so a chaos run is exactly reproducible.

Spec grammar (``--faults`` flag / ``PDRNN_CHAOS`` env)::

    event[,event...]
    event := step:<n>:<action>[:<arg>]      fire at optimizer step n (0-based,
                                            run-relative)
           | epoch:<n>:<action>[:<arg>]     fire at the start of epoch n
           | prob:<p>:<action>[:<arg>]      fire each step with probability p
                                            (seeded, per-step deterministic)
           | net:delay:<ms>                 transport delay (PDRNN_FAULT_* bridge)
           | net:loss:<prob>                transport loss (PDRNN_FAULT_* bridge)
           | net:flap:<s>                   periodic connection drop: every s
                                            seconds the process's serving
                                            listeners close every open peer
                                            connection (PDRNN_FAULT_FLAP_S
                                            bridge) - a FLAKY replica/link,
                                            distinct from kill: the process
                                            survives, its connections do not
           | seed:<int>                     RNG seed for prob events (default 0)
    action := nan                           corrupt the step's batch to NaN
                                            (non-finite grads; pairs with the
                                            NonFiniteGuard skip path)
            | stall[:<seconds>]             data-loader stall (default 0.25 s)
            | slow[:<frac>]                 SUSTAINED straggler: from the
                                            addressed step/epoch on, every
                                            producer item is delayed by frac x
                                            the time since the previous one
                                            (default 0.5) - a degraded node,
                                            not a hung one; fires (and is
                                            counted/recorded) once, at
                                            activation
            | exc                           data-loader exception (ChaosError)
            | kill                          SIGKILL this process (simulated
                                            preemption; pairs with --resume auto)
            | respawn                       abrupt crash exit (nonzero, no
                                            cleanup): the death an elastic
                                            supervisor respawns - pairs with
                                            parameter-server --elastic to drill
                                            kill -> respawn -> REGISTER rejoin
            | preempt                       SIGTERM this process (graceful
                                            preemption notice): a PS worker
                                            drains - flushes its in-flight
                                            gradient, DEREGISTERs, exits 0

An event may carry an ``@<rank>`` suffix (``epoch:1:kill@2``): it then
fires only in the process bound to that rank via :meth:`FaultSchedule.
for_rank` (the parameter-server runner binds each worker's rank), so a
multi-process chaos run can preempt ONE worker while the rest survive.
Unsuffixed events fire everywhere.

Example: ``step:3:nan,step:7:stall:0.5,epoch:2:kill@1,net:delay:100,seed:7``.
"""

from __future__ import annotations

import logging
import os
import random
import signal
import time
from dataclasses import dataclass

log = logging.getLogger(__name__)

CHAOS_ENV = "PDRNN_CHAOS"
# the native transport's netem-analogue contract (runtime/native.py reads
# these at Communicator construction) - the ONE mechanism a fault sweep
# and the --faults schedule share
FAULT_DELAY_ENV = "PDRNN_FAULT_DELAY_MS"
FAULT_LOSS_ENV = "PDRNN_FAULT_LOSS_PROB"
# connection-flap half of the same contract: consumers that own peer
# connections (the serving TCP front end; reusable by MPMD/PS link
# tests) drop every open connection each period - the flaky-replica
# mode the router drill needs, distinct from killing the process
FAULT_FLAP_ENV = "PDRNN_FAULT_FLAP_S"

_ACTIONS = ("nan", "stall", "slow", "exc", "kill", "respawn", "preempt")
_TRIGGERS = ("step", "epoch", "prob")
_DEFAULT_STALL_S = 0.25
_DEFAULT_SLOW_FRAC = 0.5
# a sustained-slow delay is proportional to the inter-item gap; cap it so
# a one-off long gap (checkpoint, compile) cannot snowball into a stall
_SLOW_DELAY_CAP_S = 1.0
# process-lifetime actions (maybe_kill handles all three): how each dies
_LIFETIME_ACTIONS = ("kill", "respawn", "preempt")
# the respawn action's abrupt-crash exit code: nonzero so a supervisor
# classifies it as a death (respawn), never as completion/drain
RESPAWN_EXIT_CODE = 17


# why `nan` is refused for integer features: a NaN cannot be stored in a
# token id, and the JAX package's corrupt_batch casts it to token 0
NAN_NEEDS_FLOAT = (
    "the 'nan' fault needs floating-point features: the char LM's inputs are "
    "integer token ids, which cannot hold a NaN (the JAX package's "
    "corrupt_batch casts the NaN to token 0, a finite batch the non-finite "
    "guard never sees), so --faults ...:nan is rejected for --model char")


class ChaosError(RuntimeError):
    """An injected data-pipeline failure (the ``exc`` action)."""


def fault_env(fault_type: str | None, fault_value: float) -> dict[str, str]:
    """The ``PDRNN_FAULT_*`` env for one netem-analogue rule - shared by
    the bench sweep's command synthesis and :meth:`FaultSchedule.network_env`
    so the two can never drift apart."""
    if not fault_type or not fault_value:
        return {}
    if fault_type == "delay":
        return {FAULT_DELAY_ENV: str(fault_value)}
    if fault_type == "loss":
        return {FAULT_LOSS_ENV: str(fault_value)}
    if fault_type == "flap":
        return {FAULT_FLAP_ENV: str(fault_value)}
    raise ValueError(
        f"unknown fault type {fault_type!r} (delay|loss|flap)"
    )


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``trigger`` addresses when, ``action`` what."""

    trigger: str  # step | epoch | prob
    at: float  # step/epoch index, or probability for prob triggers
    action: str  # nan | stall | exc | kill
    arg: float | None = None  # stall seconds
    rank: int | None = None  # only fire in the process bound to this rank

    def __str__(self):
        base = f"{self.trigger}:{self.at:g}:{self.action}"
        if self.arg is not None:
            base += f":{self.arg:g}"
        if self.rank is not None:
            base += f"@{self.rank}"
        return base


class FaultSchedule:
    """A parsed chaos spec; owns trigger matching and action execution.

    Deterministic by construction: step/epoch triggers are exact
    addresses, and ``prob`` triggers draw from ``random.Random((seed,
    step, event_index))`` - stateless per (step, event), so concurrent
    queries from the producer thread and the consumer loop cannot
    reorder draws.
    """

    def __init__(self, events: list[FaultEvent], network=(), seed: int = 0,
                 rank: int | None = None):
        for e in events:
            if e.trigger not in _TRIGGERS:
                raise ValueError(f"unknown trigger {e.trigger!r}")
            if e.action not in _ACTIONS:
                raise ValueError(f"unknown action {e.action!r}")
        self.events = tuple(events)
        self.network = tuple(network)  # ((type, value), ...)
        self.seed = int(seed)
        # the process's rank for @rank-qualified events: None (unbound)
        # fires only unqualified events
        self.rank = rank
        # observability: {action: count} of faults actually fired
        self.fired: dict[str, int] = {}
        # structured telemetry (the JAX package's obs/recorder.py; the
        # port's telemetry half binds it): the trainer binds its
        # recorder here so every fired fault becomes a 'fault' event; a
        # late attribute (not a constructor arg) so resilience stays
        # importable without the obs package in the picture
        self.recorder = None
        # sustained-straggler state (`slow` action): 0.0 = inactive;
        # once an event's address matches, the fraction sticks for the
        # rest of this incarnation
        self._slow_frac = 0.0
        self._slow_prev_tm: float | None = None

    # -- construction --------------------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "FaultSchedule":
        events, network = [], []
        seed = 0
        for raw in str(spec).split(","):
            part = raw.strip()
            if not part:
                continue
            body, _, rank_s = part.partition("@")
            fields = body.split(":")
            kind = fields[0]
            try:
                rank = int(rank_s) if rank_s else None
                if kind == "seed":
                    (seed,) = fields[1:]
                    seed = int(seed)
                elif kind == "net":
                    _, net_type, net_value = fields
                    fault_env(net_type, float(net_value) or 1e-9)  # validate
                    network.append((net_type, float(net_value)))
                elif kind in _TRIGGERS:
                    at = float(fields[1])
                    action = fields[2]
                    arg = float(fields[3]) if len(fields) > 3 else None
                    if action == "stall" and arg is None:
                        arg = _DEFAULT_STALL_S
                    if action == "slow" and arg is None:
                        arg = _DEFAULT_SLOW_FRAC
                    events.append(FaultEvent(kind, at, action, arg, rank))
                else:
                    raise ValueError(f"unknown trigger {kind!r}")
            except (IndexError, ValueError) as exc:
                raise ValueError(
                    f"bad fault event {part!r} in spec {spec!r}: {exc}"
                ) from exc
        return cls(events, network, seed)

    @classmethod
    def from_env(cls, env=None) -> "FaultSchedule | None":
        """The ``PDRNN_CHAOS`` contract: a schedule for every run in the
        process, without touching the CLI (how the chaos CI job and the
        bench harness inject)."""
        spec = (env if env is not None else os.environ).get(CHAOS_ENV)
        return cls.parse(spec) if spec else None

    @classmethod
    def resolve(cls, args, rank: int | None = None) -> "FaultSchedule | None":
        """The ONE CLI resolution path (``--faults`` flag beats the
        ``PDRNN_CHAOS`` env), shared by every strategy entry point so a
        flag can never be silently dropped by one of them: binds the
        rank (for ``@rank`` events) and exports net events onto the
        transport contract as a side effect."""
        spec = getattr(args, "faults", None)
        faults = cls.parse(spec) if spec else cls.from_env()
        if faults is None:
            return None
        if rank is not None:
            faults = faults.for_rank(rank)
        faults.export_network()
        return faults

    def __str__(self):
        parts = [str(e) for e in self.events]
        parts += [f"net:{t}:{v:g}" for t, v in self.network]
        if self.seed:
            parts.append(f"seed:{self.seed}")
        return ",".join(parts)

    # -- network bridge ------------------------------------------------------

    def network_env(self) -> dict[str, str]:
        """``PDRNN_FAULT_*`` vars for this schedule's net events."""
        env: dict[str, str] = {}
        for net_type, value in self.network:
            env.update(fault_env(net_type, value))
        return env

    def export_network(self, env=None):
        """Export net events into ``env`` (default ``os.environ``) so
        communicators constructed after this point - including ones in
        spawned child processes - pick the faults up."""
        target = os.environ if env is None else env
        for key, value in self.network_env().items():
            target[key] = value

    # -- rank binding --------------------------------------------------------

    def for_rank(self, rank: int) -> "FaultSchedule":
        """Bind the schedule to one process's rank so ``@rank``-qualified
        events can fire there (the parameter-server runner binds each
        worker).  Counters are fresh - each process owns its own."""
        bound = FaultSchedule(list(self.events), self.network, self.seed,
                              rank=int(rank))
        bound.recorder = self.recorder
        return bound

    def for_rejoin(self) -> "FaultSchedule":
        """The schedule for a RESPAWNED incarnation (elastic supervisor
        relaunch): deterministic step/epoch-addressed process-lifetime
        events (kill/respawn/preempt) are dropped - they already fired
        in the incarnation they terminated, and fault step/epoch
        addresses are run-relative, so replaying them would kill every
        respawn at the same address and no rejoin drill could ever
        reach completion.  Probabilistic lifetime events (a flaky
        worker) and all data-path events persist."""
        kept = [
            e for e in self.events
            if not (e.action in _LIFETIME_ACTIONS
                    and e.trigger in ("step", "epoch"))
        ]
        bound = FaultSchedule(kept, self.network, self.seed, rank=self.rank)
        bound.recorder = self.recorder
        return bound

    # -- trigger matching ----------------------------------------------------

    @property
    def has_step_events(self) -> bool:
        return any(
            e.trigger in ("step", "prob") for e in self.events
            if e.rank is None or e.rank == self.rank
        )

    def _matches(self, trigger_kinds, index: int):
        for i, e in enumerate(self.events):
            if e.rank is not None and e.rank != self.rank:
                continue
            if e.trigger in ("step", "epoch") and e.trigger in trigger_kinds:
                if int(e.at) == index:
                    yield e
            elif e.trigger == "prob" and "prob" in trigger_kinds:
                # stateless integer mix (NOT a shared RNG stream): the
                # draw for (seed, step, event) is the same whatever order
                # the producer thread and consumer loop ask in
                mixed = (self.seed * 1_000_003 + index) * 1_000_003 + i
                if random.Random(mixed).random() < e.at:
                    yield e

    def fired_snapshot(self) -> dict[str, int]:
        """Copy of the fired-fault counters (``{action: count}``), the
        field a watchdog alert carries as ``chaos_fired`` in the JAX
        package, so a drill's INJECTED stall is distinguishable from an
        organic hang."""
        return dict(self.fired)

    def _fire(self, event: FaultEvent, where: str):
        self.fired[event.action] = self.fired.get(event.action, 0) + 1
        log.warning(f"chaos: injecting {event} at {where}")
        if self.recorder is not None and self.recorder.enabled:
            self.recorder.record(
                "fault", action=event.action, trigger=event.trigger,
                where=where,
            )
            if event.action in ("kill", "respawn"):
                # SIGKILL/_exit joins no flush thread: drain NOW or the
                # event (the whole point of chaos telemetry) dies with us
                self.recorder.flush()

    # -- action execution ----------------------------------------------------

    def _timed_stall(self, event: FaultEvent, **where):
        """Sleep out a stall fault; with a recorder bound, the stall's
        extent lands as a ``fault_stall`` span on the trace timeline's
        resilience row (the fault mark says WHEN, the span says HOW
        LONG the pipeline was held)."""
        t0 = time.perf_counter()
        time.sleep(event.arg or _DEFAULT_STALL_S)
        rec = self.recorder
        if rec is not None and rec.enabled:
            rec.emit_span(
                "fault_stall", t0, time.perf_counter() - t0,
                cat="resilience", **where,
            )

    def on_producer_item(self, step: int):
        """Data-pipeline faults for the batch feeding step ``step`` -
        called in the loader/prefetch PRODUCER so stalls and exceptions
        originate where real loader failures do (and must propagate
        through the prefetch thread to the consumer)."""
        for e in self._matches(("step", "prob"), step):
            if e.action == "stall":
                self._fire(e, f"loader step {step}")
                self._timed_stall(e, step=step)
            elif e.action == "slow":
                self._activate_slow(e, f"loader step {step}")
            elif e.action == "exc":
                self._fire(e, f"loader step {step}")
                raise ChaosError(
                    f"injected data-loader failure at step {step} ({e})"
                )
        self._apply_slow()

    def _activate_slow(self, event: FaultEvent, where: str):
        """Latch a sustained-straggler fraction.  Fires (counter +
        telemetry) once per activation, not per delayed item - the
        degradation is continuous, the event marks its onset."""
        frac = float(event.arg or _DEFAULT_SLOW_FRAC)
        if frac > self._slow_frac:
            self._fire(event, where)
            self._slow_frac = frac
            self._slow_prev_tm = time.perf_counter()

    def _apply_slow(self):
        """Delay this producer item by ``frac`` x the inter-item gap -
        a node running at 1/(1+frac) speed, not a one-shot hang."""
        if not self._slow_frac:
            return
        now = time.perf_counter()
        if self._slow_prev_tm is not None:
            delay = min(self._slow_frac * (now - self._slow_prev_tm),
                        _SLOW_DELAY_CAP_S)
            if delay > 0:
                time.sleep(delay)
        self._slow_prev_tm = time.perf_counter()

    @property
    def slow_active(self) -> bool:
        """Whether a sustained ``slow`` fault has latched (observability
        for drills asserting the straggler actually degraded)."""
        return self._slow_frac > 0

    def corrupt_batch(self, step: int, batch):
        """Non-finite-gradient injection: replace step ``step``'s features
        with NaN (NaN activations -> NaN loss -> NaN grads), exercising
        the NonFiniteGuard skip path end to end.  Integer features (the
        char LM's token ids) cannot hold a NaN: this raises there (the
        JAX package's ``jnp.full_like`` casts the NaN to token 0, a
        finite batch the guard never sees; see :data:`NAN_NEEDS_FLOAT`)."""
        for e in self._matches(("step", "prob"), step):
            if e.action == "nan":
                import torch

                features, labels = batch
                if not torch.is_floating_point(features):
                    raise ValueError(NAN_NEEDS_FLOAT)
                self._fire(e, f"step {step}")
                return torch.full_like(features, float("nan")), labels
        return batch

    def has_action(self, action: str) -> bool:
        """Whether an event of this process (unqualified, or ``@`` its
        rank) takes ``action``."""
        return any(e.action == action for e in self.events
                   if e.rank is None or e.rank == self.rank)

    def maybe_kill(self, *, step: int | None = None,
                   epoch: int | None = None):
        """Process-lifetime faults at the addressed step/epoch:

        - ``kill``: SIGKILL - no cleanup, no atexit, exactly like a
          preempted VM (pairs with --resume auto);
        - ``respawn``: abrupt nonzero exit - the crash an elastic
          supervisor respawns into the same worker-id;
        - ``preempt``: SIGTERM - the graceful preemption notice.  A PS
          worker's DrainSignal turns it into a drain (flush in-flight
          gradient, DEREGISTER, exit 0); processes without a handler
          die with the default disposition.

        Epoch triggers fire at epoch START (work since the last
        checkpoint is lost, the case auto-resume exists for)."""
        if step is not None:
            events = [e for e in self._matches(("step", "prob"), step)
                      if e.action in _LIFETIME_ACTIONS]
            where = f"step {step}"
        else:
            events = [e for e in self._matches(("epoch",), epoch)
                      if e.action in _LIFETIME_ACTIONS]
            where = f"epoch {epoch}"
        for e in events:
            self._fire(e, where)
            if e.action == "preempt":
                # deliverable mid-run: the handler only sets a flag, so
                # the step in flight completes before the drain
                os.kill(os.getpid(), signal.SIGTERM)
                continue
            logging.shutdown()  # flush handlers; SIGKILL/_exit won't
            if e.action == "respawn":
                os._exit(RESPAWN_EXIT_CODE)
            os.kill(os.getpid(), signal.SIGKILL)

    def on_epoch_start(self, epoch: int):
        """Epoch-granularity faults (kill/stall/exc; nan is per-step)."""
        self.maybe_kill(epoch=epoch)
        for e in self._matches(("epoch",), epoch):
            if e.action == "stall":
                self._fire(e, f"epoch {epoch}")
                self._timed_stall(e, epoch=epoch)
            elif e.action == "slow":
                self._activate_slow(e, f"epoch {epoch}")
            elif e.action == "exc":
                self._fire(e, f"epoch {epoch}")
                raise ChaosError(f"injected failure at epoch {epoch} ({e})")
