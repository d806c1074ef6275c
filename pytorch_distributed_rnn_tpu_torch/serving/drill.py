"""SLO drill: a spawned server meets traffic (the counterpart of the JAX
package's ``serving/drill.py``).

``spawn_server`` runs ``python -m pytorch_distributed_rnn_tpu_torch.serving
serve ...`` as a subprocess (the deployment shape: the drill must prove
the PROCESS serves and exits cleanly), waits for the port file, and tears
it down with SIGTERM on exit.  ``run_drill`` is the scenario ``loadgen
--spawn-server`` runs: start a server, drive the configured load, and
return ``(report, server_exit_code)``.  Fault injection (``--faults``)
comes with the port's ``resilience/``.
"""

from __future__ import annotations

import contextlib
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from pytorch_distributed_rnn_tpu_torch.serving.loadgen import LoadConfig, run_load


class ServerSpawnError(RuntimeError):
    """The spawned server died or never became ready."""


@contextlib.contextmanager
def spawn_server(serve_args: list[str], *, ready_timeout_s: float = 120.0,
                 stop_timeout_s: float = 30.0):
    """Run the port's ``serve <serve_args>`` in a subprocess.

    Yields ``(host, port, proc)`` once the server wrote its port file;
    on exit sends SIGTERM and waits.  ``proc.returncode`` is available
    after the ``with`` block; callers asserting graceful shutdown check
    it is 0.
    """
    with tempfile.TemporaryDirectory(prefix="pdrnn-serve-") as tmp:
        port_file = Path(tmp) / "port"
        cmd = [
            sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.serving",
            "serve", *serve_args, "--port-file", str(port_file),
        ]
        proc = subprocess.Popen(cmd)
        try:
            deadline = time.monotonic() + ready_timeout_s
            while not port_file.exists():
                if proc.poll() is not None:
                    raise ServerSpawnError(
                        f"server exited with {proc.returncode} before "
                        f"becoming ready: {' '.join(cmd)}"
                    )
                if time.monotonic() > deadline:
                    raise ServerSpawnError(
                        f"server not ready after {ready_timeout_s}s"
                    )
                time.sleep(0.05)
            host, port = port_file.read_text().split()
            yield host, int(port), proc
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=stop_timeout_s)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    proc.kill()
                    proc.wait()


def run_drill(serve_args: list[str], cfg: LoadConfig,
              ready_timeout_s: float = 120.0) -> tuple[dict, int]:
    """Spawn, load, tear down.  Returns ``(report, server_exit_code)``
    with ``report['server_exit']`` filled in too."""
    with spawn_server(
        serve_args, ready_timeout_s=ready_timeout_s
    ) as (host, port, proc):
        cfg = LoadConfig(**{**cfg.__dict__, "host": host, "port": port})
        report = run_load(cfg)
    report["server_exit"] = proc.returncode
    report["server_pid"] = proc.pid
    report["trace_handles"] = trace_handles(report)
    return report, proc.returncode


def trace_handles(report: dict) -> list[str]:
    """The distinct trace ids a failed drill should pull with
    ``pdrnn-metrics trace``: slowest requests first, then every SLO
    violation (order-preserving dedup)."""
    handles: list[str] = []
    for entry in [*report.get("slowest", ()),
                  *report.get("slo_violations", ())]:
        trace_id = entry.get("trace_id")
        if trace_id and trace_id not in handles:
            handles.append(trace_id)
    return handles
