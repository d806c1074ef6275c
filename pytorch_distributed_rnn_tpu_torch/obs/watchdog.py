"""Anomaly watchdog + all-thread stack dumps for hang diagnosis.

The in-process half of live anomaly detection: a small daemon thread
(one per process, only when the live plane is on) that watches the
exporter's rolling windows and the recorder's progress note for

- **stalls** - heartbeats stay fresh (the writer thread lives) while
  ``note_progress`` freezes past ``stall_after_s``: the chaos harness's
  ``stall`` fault, a hung collective, a starved loader.  On detection
  the watchdog dumps ALL thread stacks via :mod:`faulthandler` to a
  sidecar-adjacent file (``<sidecar-stem>-stacks.txt``) - the
  post-mortem a wedged run never gets to write itself - and emits a
  structured ``alert`` event;
- **NaN streaks** - ``nan_streak`` consecutive non-finite losses;
- **loss spikes** - the newest loss above ``loss_spike_factor`` x the
  rolling window median;
- **serving SLO breaches** - windowed p95 latency above a per-QoS
  ``--slo`` objective (``qos=high:p95_ms=250:availability=99.9``; the
  router's per-class p95 when available, the block p95 otherwise).
  The legacy global ``PDRNN_WATCHDOG_SLO_P95_MS`` env is DEPRECATED -
  still honored as a default objective with a loud warning when no
  ``--slo`` is configured;
- **SLO budget burn** - when the anchor's time-series store
  (``obs/store.py``) is bound, multi-window error-budget burn rates per
  objective: episodic ``slo_burn`` alerts fire when BOTH the fast and
  slow windows burn strictly above 1.0 and ``slo_burn_cleared`` marks
  the fast window's recovery - the Google SRE fast-catch/slow-confirm
  pattern riding the same structured-alert path;
- **goodput collapse** - the exporter's windowed goodput estimate
  (``goodput_60s``: fraction of the last minute inside step compute,
  the live half of ``obs/ledger.py``) falls below the
  ``PDRNN_WATCHDOG_GOODPUT`` floor while the run is still making
  nominal progress - the "alive but mostly waiting" failure mode a
  stall detector cannot see.  Armed only when the env knob is set.

Alerts are recorded as normal sidecar events (kind ``alert``, schema in
``obs/recorder.py``) and flushed immediately, so ``pdrnn-metrics
summarize``/``timeline`` see them for free AND they are on disk while
the run is still wedged; they also ride the next live digest into the
aggregator's ``/events``.  Each detector is episodic: one alert when
the condition starts, re-armed when it clears (an ``info`` clear event
marks recovery), so a long stall cannot flood the stream.

Chaos link (``resilience/faults.py``): when a fault schedule is bound,
every alert carries a ``chaos_fired`` snapshot of the schedule's fired
counters - a drill's injected stall is distinguishable from an organic
one in the event stream.

:func:`install_stack_dump_handler` is the on-demand half (satellite):
every long-lived entrypoint registers SIGUSR2 via
``faulthandler.register`` - a C-level handler, so it dumps even when
the Python main thread is wedged below the interpreter - appending to
the same stacks file the watchdog uses.
"""

from __future__ import annotations

import faulthandler
import logging
import math
import os
import signal
import threading
import time
from pathlib import Path

log = logging.getLogger(__name__)

WATCHDOG_ENV = "PDRNN_WATCHDOG"  # "0" disables the watchdog outright
WATCHDOG_STALL_ENV = "PDRNN_WATCHDOG_STALL"  # seconds (default 10)
# DEPRECATED: the global serving SLO (ms).  Use per-QoS --slo
# objectives instead; the env is still honored as a default objective
# (with a loud warning) when no --slo is configured.
WATCHDOG_SLO_ENV = "PDRNN_WATCHDOG_SLO_P95_MS"
WATCHDOG_GOODPUT_ENV = "PDRNN_WATCHDOG_GOODPUT"  # goodput floor (0..1)

_DEFAULT_STALL_AFTER_S = 10.0
_DEFAULT_NAN_STREAK = 3
_DEFAULT_SPIKE_FACTOR = 10.0
_SPIKE_MIN_SAMPLES = 8

STACK_DUMP_SIGNAL = getattr(signal, "SIGUSR2", None)

# faulthandler.register keeps the file object alive forever; track it so
# repeated installs (tests, respawns) replace instead of leak
_signal_dump_file = None


def resolve_stall_after(env=None) -> float:
    return float(
        (env or os.environ).get(WATCHDOG_STALL_ENV, _DEFAULT_STALL_AFTER_S)
    )


def stacks_path_for(sidecar_path) -> Path:
    """The one stack-dump location per process: next to the (rank-
    suffixed) sidecar, ``<stem>-stacks.txt`` - uploaded by CI alongside
    the metrics artifact."""
    sidecar_path = Path(sidecar_path)
    return sidecar_path.with_name(f"{sidecar_path.stem}-stacks.txt")


def dump_stacks(path, reason: str = "") -> Path | None:
    """Append a headered all-thread stack dump to ``path``; returns the
    path, or None when the dump failed (diagnosis must never kill the
    patient)."""
    path = Path(path)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as f:
            f.write(
                f"\n==== pdrnn stack dump pid={os.getpid()} "
                f"reason={reason or 'unspecified'} t={time.time():.3f}\n"
            )
            f.flush()
            faulthandler.dump_traceback(file=f, all_threads=True)
        return path
    except OSError as exc:
        log.warning(f"watchdog: stack dump to {path} failed: {exc}")
        return None


def install_stack_dump_handler(sidecar_path) -> Path | None:
    """Register SIGUSR2 -> all-thread stack dump into the sidecar-
    adjacent stacks file (``kill -USR2 <pid>`` is the on-demand hang
    diagnosis every long-lived entrypoint installs).  C-level via
    ``faulthandler.register``, so it fires even when the main thread is
    wedged below Python.  Returns the dump path (None on platforms
    without SIGUSR2)."""
    global _signal_dump_file
    if STACK_DUMP_SIGNAL is None:  # pragma: no cover - non-POSIX
        return None
    if threading.current_thread() is not threading.main_thread():
        # a rank run as a thread (tests) leaves the process's signal
        # handling to its main thread
        return None
    path = stacks_path_for(sidecar_path)
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        f = open(path, "a")
    except OSError as exc:  # pragma: no cover - unwritable sidecar dir
        log.warning(f"stack-dump handler not installed: {exc}")
        return None
    faulthandler.register(STACK_DUMP_SIGNAL, file=f, all_threads=True,
                          chain=False)
    if _signal_dump_file is not None:
        try:
            _signal_dump_file.close()
        except OSError:  # pragma: no cover
            pass
    # the handler file deliberately lives until process exit (replaced
    # only by a re-install above)
    _signal_dump_file = f
    log.info(f"stack-dump handler: SIGUSR2 -> {path}")
    return path


class AnomalyWatchdog:
    """One daemon thread of in-run anomaly detection per process."""

    def __init__(self, recorder, exporter, *, faults=None,
                 stall_after_s: float = _DEFAULT_STALL_AFTER_S,
                 check_every_s: float | None = None,
                 nan_streak: int = _DEFAULT_NAN_STREAK,
                 loss_spike_factor: float = _DEFAULT_SPIKE_FACTOR,
                 slo=(), slo_p95_s: float | None = None,
                 store=None, goodput_floor: float | None = None,
                 dump_dir_hint=None):
        self.recorder = recorder
        self.exporter = exporter
        self.faults = faults
        self.stall_after_s = float(stall_after_s)
        self.check_every_s = (
            float(check_every_s) if check_every_s is not None
            else max(0.1, min(1.0, self.stall_after_s / 4))
        )
        self.nan_streak = int(nan_streak)
        self.loss_spike_factor = float(loss_spike_factor)
        # per-QoS --slo objectives; the deprecated global slo_p95_s
        # (env) stays a single class-blind default when no --slo is set
        self.slo = tuple(slo)
        self.slo_p95_s = slo_p95_s
        # the anchor's time-series store (None elsewhere): arms the
        # budget-burn detector
        self.store = store
        self.goodput_floor = goodput_floor
        self.stacks_path = stacks_path_for(
            dump_dir_hint or recorder.path or "pdrnn-metrics.jsonl"
        )
        self._seq = 0
        self._stop = threading.Event()
        self._thread = None
        # per-detector episode latches (one alert per episode)
        self._in_stall = False
        self._in_nan = False
        self._in_spike = False
        self._in_slo: dict[str, bool] = {}  # per-QoS breach episodes
        self._in_burn: dict[str, bool] = {}  # per-QoS burn episodes
        self._in_goodput = False

    @classmethod
    def resolve(cls, recorder, exporter, *, faults=None, slo=(),
                store=None, env=None) -> "AnomalyWatchdog | None":
        """Env-tuned construction (``PDRNN_WATCHDOG=0`` disables;
        ``PDRNN_WATCHDOG_STALL`` seconds; ``PDRNN_WATCHDOG_GOODPUT``
        arms the goodput-collapse detector with a 0..1 floor).  ``slo``
        objectives (the ``--slo`` flag) arm the per-QoS SLO detector
        and - with a ``store`` bound - the budget-burn detector; the
        DEPRECATED ``PDRNN_WATCHDOG_SLO_P95_MS`` env still arms a
        global default when no objectives are configured."""
        env = env or os.environ
        if env.get(WATCHDOG_ENV, "1") in ("0", "off", "false"):
            return None
        slo_ms = env.get(WATCHDOG_SLO_ENV)
        if slo_ms and not slo:
            log.warning(
                f"{WATCHDOG_SLO_ENV} is DEPRECATED: the global p95 "
                "threshold cannot distinguish QoS classes - use "
                "--slo 'qos=<class>:p95_ms=<ms>[:availability=<pct>]' "
                "(repeatable, one per class); honoring the env as a "
                "default objective for every class this run"
            )
        elif slo_ms and slo:
            log.warning(
                f"{WATCHDOG_SLO_ENV} ignored: --slo objectives are "
                "configured and take precedence"
            )
            slo_ms = None
        goodput = env.get(WATCHDOG_GOODPUT_ENV)
        return cls(
            recorder, exporter, faults=faults, slo=slo, store=store,
            stall_after_s=resolve_stall_after(env),
            slo_p95_s=float(slo_ms) / 1e3 if slo_ms else None,
            goodput_floor=float(goodput) if goodput else None,
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="pdrnn-watchdog", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.check_every_s):
            try:
                self.check()
            except Exception:  # pragma: no cover - must never die loudly
                log.exception("watchdog: check failed")

    # -- detection -----------------------------------------------------------

    def check(self, now: float | None = None) -> None:
        """One detection pass (public for tests/drills)."""
        now = time.perf_counter() if now is None else now
        self._check_stall(now)
        self._check_loss()
        self._check_slo()
        self._check_burn(now)
        self._check_goodput(now)

    def _check_stall(self, now: float) -> None:
        age = self.exporter.progress_age_s(now)
        if age is None or self.exporter.finished:
            return
        from pytorch_distributed_rnn_tpu_torch.obs.live import serving_idle

        if serving_idle(self.exporter.source_snapshot().get("serving")):
            # an idle serving engine has no work to progress on: frozen
            # decode-step count is idleness, not a hang
            self._in_stall = False
            return
        if age > self.stall_after_s:
            if not self._in_stall:
                self._in_stall = True
                dumped = dump_stacks(
                    self.stacks_path,
                    reason=f"stall progress_age={age:.1f}s",
                )
                self._alert(
                    "stall", progress=self.exporter.recorder.progress,
                    progress_age_s=age,
                    stall_after_s=self.stall_after_s,
                    stacks=str(dumped) if dumped else None,
                )
        elif self._in_stall:
            self._in_stall = False
            self._alert("stall_cleared", severity="info",
                        progress=self.exporter.recorder.progress)

    def _check_loss(self) -> None:
        streak = self.exporter.loss_nonfinite_streak
        if streak >= self.nan_streak:
            if not self._in_nan:
                self._in_nan = True
                self._alert("nan_streak", streak=streak)
        else:
            self._in_nan = False
        stats = self.exporter.loss.stats()
        last, p50 = stats["last"], stats["p50"]
        if (
            stats["count"] >= _SPIKE_MIN_SAMPLES
            and last is not None and p50 is not None and p50 > 0
            and math.isfinite(last)
        ):
            if last > self.loss_spike_factor * p50:
                if not self._in_spike:
                    self._in_spike = True
                    self._alert("loss_spike", loss=last, window_p50=p50,
                                factor=self.loss_spike_factor)
            else:
                self._in_spike = False

    def _check_slo(self) -> None:
        # per-QoS --slo objectives; the deprecated global env threshold
        # degrades to one class-blind check (qos None) when no --slo
        checks = [
            (obj.qos, obj.p95_ms / 1e3) for obj in self.slo
            if obj.p95_ms is not None
        ]
        if not checks and self.slo_p95_s is not None:
            checks = [(None, float(self.slo_p95_s))]
        if not checks:
            return
        snapshot = self.exporter.source_snapshot()
        serving = snapshot.get("serving") or {}
        router = snapshot.get("router") or {}
        block = router or serving
        if not block:
            return
        by_qos = router.get("latency_s_p95_by_qos") or {}
        for qos, threshold_s in checks:
            # the router carries per-class p95; the engine's block p95
            # is class-blind, so an objective without one checks the
            # block (the honest approximation until the engine splits
            # latency by QoS)
            p95 = by_qos.get(qos, block.get("latency_s_p95"))
            if p95 is None:
                continue
            key = qos or "*"
            latched = self._in_slo.get(key, False)
            if p95 > threshold_s:
                if not latched:
                    self._in_slo[key] = True
                    self._alert("slo_breach", qos=qos,
                                latency_s_p95=p95,
                                slo_p95_s=threshold_s,
                                queue_depth=serving.get("queue_depth"))
            elif latched:
                self._in_slo[key] = False
                self._alert("slo_recovered", severity="info",
                            qos=qos, latency_s_p95=p95,
                            slo_p95_s=threshold_s)

    def _check_burn(self, now: float) -> None:
        """Episodic error-budget burn alerts off the anchor's store:
        fire when BOTH windows burn strictly above 1.0 (fast catches,
        slow confirms), clear when the fast window recovers."""
        if self.store is None or not self.slo:
            return
        for qos, burn in self.store.burn_snapshot(now).items():
            latched = self._in_burn.get(qos, False)
            if burn["fire"] and not latched:
                self._in_burn[qos] = True
                self._alert(
                    "slo_burn", qos=qos,
                    burn_rate_fast=burn["fast"],
                    burn_rate_slow=burn["slow"],
                    objective=burn.get("objective"),
                    windows_s=list(self.store.burn_windows_s),
                )
            elif latched and burn["fast"] <= 1.0:
                self._in_burn[qos] = False
                self._alert(
                    "slo_burn_cleared", severity="info", qos=qos,
                    burn_rate_fast=burn["fast"],
                    burn_rate_slow=burn["slow"],
                )

    def _check_goodput(self, now: float) -> None:
        if self.goodput_floor is None or self.exporter.finished:
            return
        goodput = self.exporter.goodput_60s(now)
        # demand a populated step window: warm-up and the pre-first-step
        # gap report None / near-zero goodput without being a collapse
        stats = self.exporter.step_s.stats(now)
        if goodput is None or stats["count"] < _SPIKE_MIN_SAMPLES:
            return
        if goodput < self.goodput_floor:
            if not self._in_goodput:
                self._in_goodput = True
                self._alert(
                    "goodput_collapse", goodput_60s=goodput,
                    goodput_floor=self.goodput_floor,
                    step_s_mean=stats["mean"],
                )
        elif self._in_goodput:
            self._in_goodput = False
            self._alert("goodput_recovered", severity="info",
                        goodput_60s=goodput,
                        goodput_floor=self.goodput_floor)

    # -- emission ------------------------------------------------------------

    def _alert(self, kind: str, severity: str = "warning",
               **fields) -> None:
        self._seq += 1
        payload = {"alert": kind, "severity": severity, "seq": self._seq}
        payload.update(
            (k, v) for k, v in fields.items() if v is not None
        )
        if self.faults is not None and self.faults.fired:
            payload["chaos_fired"] = self.faults.fired_snapshot()
        log.warning(f"watchdog: {kind} {fields}")
        # the sidecar event is the system of record; flush NOW so the
        # alert is on disk while the run is still wedged (the live-drill
        # acceptance: the alert lands BEFORE the run exits).  The live
        # digest picks it up via observe_event -> _alerts.
        self.recorder.record("alert", **payload)
        self.recorder.flush()
