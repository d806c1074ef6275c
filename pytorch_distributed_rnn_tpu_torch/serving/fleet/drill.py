"""Kill-mid-burst fleet drill: replicas die, the router reroutes (the
counterpart of the JAX package's ``serving/fleet/drill.py``).

``spawn_fleet`` runs N ``serve`` replicas (``python -m
pytorch_distributed_rnn_tpu_torch.serving serve``, each with the
``--device`` of ``replica_args``; on one card every replica holds its own
CUDA context and graphs) under a
:class:`~pytorch_distributed_rnn_tpu_torch.launcher.supervisor.ReplicaSupervisor`
(subprocesses - the drill must prove PROCESSES survive) plus one
``router`` in front.  Each replica learns an ephemeral port at
first launch and a respawn REBINDS that same port, so the router's
static pool entry stays valid and the breaker re-admits the new
incarnation through half-open pings.

``run_fleet_drill`` is the scenario ``loadgen --spawn-fleet`` runs: fleet up, load through the router, SIGKILL one
replica mid-burst, fleet down.  Acceptance is graceful degradation:

- the degradation window (per-second report timeline) CLOSES - traffic
  reroutes to the survivors and the respawned replica rejoins;
- exactly-once accounting holds on BOTH sides of the wire:
  ``done + shed + errors == submitted`` in the load report, and the
  router's own ledger agrees - no duplicated and no lost completions;
- the supervisor respawned the kill (``respawns >= 1``) and every
  process exits clean on teardown.

When the router is started with a live plane (``--live`` +
``--live-port-file`` in ``router_args``), the drill also runs a
:class:`_LiveProbe` against the anchor for the whole burst plus a
short grace window: it scrapes ``/events`` and ``/series`` and attaches
the observability verdict under ``report["fleet"]["live"]`` - did the
SLO error-budget ``slo_burn`` alert fire AND clear, and did the store's
``pdrnn_recommended_replicas`` capacity signal rise while the killed
replica was down.  A caller asserts on that JSON instead of racing the
burst with shell polling.
"""

from __future__ import annotations

import contextlib
import logging
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from pytorch_distributed_rnn_tpu_torch.launcher.supervisor import (
    ReplicaSupervisor,
)
from pytorch_distributed_rnn_tpu_torch.serving.drill import trace_handles
from pytorch_distributed_rnn_tpu_torch.serving.loadgen import (
    LoadConfig,
    run_load,
)
from pytorch_distributed_rnn_tpu_torch.serving.protocol import ServingClient

log = logging.getLogger(__name__)


class FleetSpawnError(RuntimeError):
    """A fleet process died or never became ready."""


class _PopenProc:
    """Adapts :class:`subprocess.Popen` to the process contract
    :class:`RespawnSupervisor` polls (``is_alive``/``exitcode``/
    ``terminate``/``join``)."""

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


def _await_file(path: Path, what: str, timeout_s: float,
                dead=None) -> list[str]:
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            fields = path.read_text().split()
            if len(fields) == 2:
                return fields
        except OSError:
            pass
        if dead is not None and dead() is not None:
            raise FleetSpawnError(
                f"{what} exited with {dead()} before becoming ready"
            )
        if time.monotonic() > deadline:
            raise FleetSpawnError(f"{what} not ready after {timeout_s}s")
        time.sleep(0.05)


def _router_live_port_file(router_args) -> Path | None:
    """The ``--live-port-file`` value inside ``router_args``, if any -
    how the drill learns where the router anchored its live plane."""
    args = list(router_args or [])
    for i, arg in enumerate(args):
        if arg == "--live-port-file" and i + 1 < len(args):
            return Path(args[i + 1])
        if arg.startswith("--live-port-file="):
            return Path(arg.split("=", 1)[1])
    return None


class _LiveProbe:
    """Polls the router's live anchor (``/events`` + ``/series``) on a
    background thread while the burst runs.  All state is written by
    the probe thread only and read after :meth:`finish` joins it, so no
    lock is needed."""

    def __init__(self, host: str, port: int):
        self.base = f"http://{host}:{port}"
        self.polls = 0
        self.errors = 0
        self.burn_fired = False
        self.burn_cleared = False
        self.recommended: list[float] = []
        self.live_replicas: list[float] = []
        self.series_scrape: dict | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="pdrnn-fleet-live-probe", daemon=True,
        )

    def start(self) -> None:
        self._thread.start()

    def _fetch(self, path: str):
        import json
        import urllib.request

        with urllib.request.urlopen(self.base + path,
                                    timeout=5.0) as resp:
            return json.loads(resp.read())

    def _poll_once(self) -> None:
        try:
            events = self._fetch("/events")
            # replay the whole (bounded) event log each poll: cleared
            # only counts when it follows a fire for the same key
            burning: set = set()
            for event in events:
                kind = event.get("alert")
                key = (event.get("source"), event.get("qos"))
                if kind == "slo_burn":
                    self.burn_fired = True
                    burning.add(key)
                elif kind == "slo_burn_cleared" and key in burning:
                    burning.discard(key)
                    self.burn_cleared = True
            for name, sink in (
                ("pdrnn_recommended_replicas", self.recommended),
                ("pdrnn_replicas_live", self.live_replicas),
            ):
                resp = self._fetch(
                    f"/series?name={name}&window=120&agg=last")
                series = resp.get("series") or []
                value = series[0].get("value") if series else None
                if value is not None:
                    sink.append(float(value))
            if self.series_scrape is None:
                scrape = self._fetch(
                    "/series?name=pdrnn_router_request_rate_per_s"
                    "&window=60")
                if scrape.get("series"):
                    self.series_scrape = scrape
            self.polls += 1
        except (OSError, ValueError):
            self.errors += 1

    def _run(self) -> None:
        while not self._stop.wait(timeout=0.5):
            self._poll_once()

    def finish(self, grace_s: float = 15.0) -> None:
        """Keep polling past the burst until a fired burn alert has
        cleared (or the grace expires), then stop the thread."""
        deadline = time.monotonic() + grace_s
        while (time.monotonic() < deadline
               and not (self.burn_fired and self.burn_cleared)):
            time.sleep(0.3)
        self._stop.set()
        self._thread.join(timeout=5.0)

    def verdict(self) -> dict:
        rec = self.recommended
        return {
            "polls": self.polls,
            "errors": self.errors,
            "burn_fired": self.burn_fired,
            "burn_cleared": self.burn_cleared,
            "recommended_replicas": {
                "min": min(rec) if rec else None,
                "peak": max(rec) if rec else None,
                "last": rec[-1] if rec else None,
                "samples": len(rec),
            },
            "recommended_rose": bool(rec and max(rec) > min(rec)),
            "replicas_live_min": (
                min(self.live_replicas) if self.live_replicas else None
            ),
            "series_scrape_ok": self.series_scrape is not None,
        }


class FleetHandle:
    """What ``spawn_fleet`` yields: the router address plus the levers
    the drill pulls (kill a replica, read the supervision verdict)."""

    def __init__(self, host: str, port: int, supervisor,
                 router_proc: subprocess.Popen):
        self.host = host
        self.port = port
        self.supervisor = supervisor
        self.router_proc = router_proc

    def kill_replica(self, worker_id: int) -> int:
        """SIGKILL the CURRENT incarnation of a replica slot (ids are
        1..N); returns the killed pid.  The supervisor notices the
        nonzero exit and respawns into the same port."""
        slot = self.supervisor.slots[int(worker_id)]
        pid = slot.process.pid
        slot.process.kill()
        log.warning(
            f"fleet drill: SIGKILLed replica {worker_id} (pid {pid})"
        )
        return pid

    def router_stats(self, timeout_s: float = 10.0) -> dict:
        with ServingClient(self.host, self.port,
                           timeout_s=timeout_s) as client:
            return client.stats()


@contextlib.contextmanager
def spawn_fleet(replica_args: list[str], n: int, *,
                router_args: list[str] | None = None,
                max_respawns: int = 2,
                ready_timeout_s: float = 180.0,
                stop_timeout_s: float = 30.0):
    """Run N supervised replicas + a router; yields a
    :class:`FleetHandle` once the router reports ready (first pong).

    ``replica_args`` are the ``serve`` model/engine flags shared
    by every replica (the drill adds identity/port flags itself);
    ``router_args`` extend the ``router`` invocation."""
    if n < 1:
        raise ValueError(f"a fleet needs >= 1 replica, got {n}")
    with tempfile.TemporaryDirectory(prefix="pdrnn-fleet-") as tmp:
        tmpdir = Path(tmp)
        port_files = {
            k: tmpdir / f"replica-{k}.port" for k in range(1, n + 1)
        }
        learned: dict[int, tuple[str, int]] = {}

        def spawn_replica(rank: int, worker_id: int,
                          rejoin: bool) -> _PopenProc:
            cmd = [
                sys.executable, "-m",
                "pytorch_distributed_rnn_tpu_torch.serving", "serve",
                *replica_args, "--replica-id", str(worker_id),
            ]
            if rejoin:
                # rebind the SAME learned port: the router's static
                # pool entry stays valid and half-open pings re-admit
                # the new incarnation without any re-registration
                host, port = learned[worker_id]
                cmd += ["--host", host, "--port", str(port)]
            else:
                cmd += ["--port", "0", "--port-file",
                        str(port_files[worker_id])]
            return _PopenProc(subprocess.Popen(cmd))

        supervisor = ReplicaSupervisor(
            spawn_replica, min_workers=1, max_respawns=max_respawns,
            respawn_delay_s=0.2,
        )
        router_proc = None
        stop_polling = threading.Event()
        try:
            supervisor.launch(range(1, n + 1))
            for worker_id, path in port_files.items():
                proc = supervisor.slots[worker_id].process
                host, port = _await_file(
                    path, f"replica {worker_id}", ready_timeout_s,
                    dead=lambda proc=proc: proc.exitcode,
                )
                learned[worker_id] = (host, int(port))

            router_port_file = tmpdir / "router.port"
            router_cmd = [
                sys.executable, "-m",
                "pytorch_distributed_rnn_tpu_torch.serving.fleet",
                "--replica-port-files",
                ",".join(str(port_files[k]) for k in range(1, n + 1)),
                "--port", "0", "--port-file", str(router_port_file),
                *(router_args or []),
            ]
            router_proc = subprocess.Popen(router_cmd)
            host, port = _await_file(
                router_port_file, "router", ready_timeout_s,
                dead=router_proc.poll,
            )

            def poll_loop():
                while not stop_polling.wait(timeout=supervisor.poll_s):
                    if not supervisor.poll():
                        log.error("fleet drill: pool collapsed below "
                                  "the replica floor")
                        return

            poller = threading.Thread(
                target=poll_loop, name="pdrnn-fleet-supervise",
                daemon=True,
            )
            poller.start()
            yield FleetHandle(host, int(port), supervisor, router_proc)
        finally:
            if router_proc is not None and router_proc.poll() is None:
                router_proc.send_signal(signal.SIGTERM)
                try:
                    router_proc.wait(timeout=stop_timeout_s)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    router_proc.kill()
                    router_proc.wait()
            # stop supervision BEFORE terminating replicas: the SIGTERM
            # drain exits 0, but a still-running poll loop could race a
            # slot's reap against shutdown's
            stop_polling.set()
            supervisor.shutdown(timeout_s=stop_timeout_s)


def run_fleet_drill(replica_args: list[str], cfg: LoadConfig, *,
                    n: int = 3, kill_after_s: float | None = None,
                    kill_index: int = 1,
                    router_args: list[str] | None = None,
                    ready_timeout_s: float = 180.0) -> dict:
    """Fleet up, load through the router, optionally SIGKILL one
    replica mid-burst, fleet down.  Returns the load report extended
    with the drill verdict under ``fleet``:

    - ``accounting_ok``: client side (``done + shed + errors ==
      requests``) AND the router's ledger (``submitted == done +
      errors`` with sheds/drain rejections accounted at admission);
    - ``respawns``: supervisor respawn count (>= 1 when a kill was
      scheduled and landed);
    - ``window_closed``: the degradation window is bounded away from
      the run's end - service RECOVERED after the kill;
    - ``router`` / ``supervision``: the raw stats for the report file.
    """
    with spawn_fleet(
        replica_args, n, router_args=router_args,
        ready_timeout_s=ready_timeout_s,
    ) as fleet:
        probe = None
        live_port_file = _router_live_port_file(router_args)
        if live_port_file is not None:
            host, port = _await_file(
                live_port_file, "router live plane", ready_timeout_s,
                dead=fleet.router_proc.poll,
            )
            probe = _LiveProbe(host, int(port))
            probe.start()
        cfg = LoadConfig(**{**cfg.__dict__, "host": fleet.host,
                            "port": fleet.port})
        killed = {"pid": None}
        timer = None
        if kill_after_s is not None:
            timer = threading.Timer(
                float(kill_after_s),
                lambda: killed.update(
                    pid=fleet.kill_replica(kill_index)),
            )
            timer.daemon = True
            timer.start()
        try:
            report = run_load(cfg)
        finally:
            if timer is not None:
                timer.cancel()
        if probe is not None:
            # grace: the clear needs the fast burn window to slide
            # clean of the burst before the watchdog can emit it
            probe.finish()
        router_stats = fleet.router_stats()
        supervision = fleet.supervisor.verdict()
    router_stats.pop("event", None)
    client_ok = (
        report["done"] + report["shed"] + report["errors"]
        == report["requests"]
    )
    router_ok = (
        router_stats["submitted"]
        == router_stats["done"] + router_stats["errors"]
    )
    window = report["degradation_window_s"]
    # recovered = the last degraded second is strictly inside the run:
    # at least one CLEAN second followed it (a window butted against
    # the end of the load would mean we never saw the fleet healthy
    # again)
    window_closed = (
        window is None or window[1] < int(report["wall_s"]) - 1
        or report["timeline"][-1]["second"] > window[1]
    )
    report["fleet"] = {
        "replicas": n,
        "killed_pid": killed["pid"],
        "kill_after_s": kill_after_s,
        "respawns": supervision["respawns"],
        "accounting_ok": bool(client_ok and router_ok),
        "client_accounting_ok": bool(client_ok),
        "router_accounting_ok": bool(router_ok),
        "window_closed": bool(window_closed),
        "router": router_stats,
        "supervision": supervision,
        "router_exit": fleet.router_proc.returncode,
    }
    if probe is not None:
        report["fleet"]["live"] = probe.verdict()
    report["trace_handles"] = trace_handles(report)
    return report
