"""The port's live plane (``obs/live.py``, ``obs/aggregator.py``,
``obs/watchdog.py``) on the CPU:

- the Prometheus text and the health report of the port's aggregator
  equal the JAX package's on the same digests (hand-made ones, and one
  the port's exporter made from a recorder's events);
- a CLI run with ``--metrics --live 0 --live-port-file`` answers
  ``/metrics`` and ``/health`` while it runs, its watchdog raises the
  stall alert under a ``stall`` fault longer than ``PDRNN_WATCHDOG_STALL``
  and clears it (a later stall shorter than the threshold holds the run
  while the watchdog sees the progress move on), and the run ends on the
  bits of the same run without telemetry.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from pytorch_distributed_rnn_tpu.obs.aggregator import Aggregator as JaxAggregator
from pytorch_distributed_rnn_tpu.obs.aggregator import render_prometheus as jax_render
from pytorch_distributed_rnn_tpu_torch import main as port_main
from pytorch_distributed_rnn_tpu_torch.data import write_synthetic_har_dataset
from pytorch_distributed_rnn_tpu_torch.obs.aggregator import Aggregator, render_prometheus
from pytorch_distributed_rnn_tpu_torch.obs.live import LiveExporter
from pytorch_distributed_rnn_tpu_torch.obs.recorder import MetricsRecorder
from pytorch_distributed_rnn_tpu_torch.obs.summary import load_events
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import load_checkpoint

ROOT = Path(__file__).resolve().parent.parent
T0, TM0 = 1_800_000_000.0, 5_000.0


def _digest(source_id="trainer-0", rank=0, role="trainer", **over):
    body = {
        "id": source_id, "role": role, "rank": rank, "seq": 1, "t": T0, "tm": TM0,
        "progress": 5, "progress_age_s": 0.1, "finished": False,
        "steps_total": 10, "nan_skips_total": 0, "faults_total": {},
        "alerts_total": 0, "alerts": [],
        "step_s": {"count": 8, "mean": 0.01, "p50": 0.01, "p95": 0.012, "last": 0.01},
        "loss": {"last": 1.5, "mean": 1.6, "nonfinite_streak": 0},
        "data_wait_s_mean": 0.001, "queue_depth": {"last": 2, "p95": 4},
    }
    body.update(over)
    return body


def _exporter_digest(tmp_path) -> dict:
    """A digest the port's exporter makes from a recorder's events."""
    rec = MetricsRecorder(tmp_path / "m.jsonl", heartbeat_every_s=0)
    exporter = LiveExporter(rec, Aggregator(), role="trainer")
    rec.attach_live(exporter)
    for i in range(6):
        rec.record("step", step=i, loss=2.0 - 0.1 * i, dispatch_s=0.004, fenced_s=0.01,
                   data_wait_s=0.001)
        rec.note_progress(i)
    rec.record("fault", action="stall", trigger="step", where="step 3")
    rec.record("nan_skip", new=1, total=1, consecutive=1)
    digest = exporter.digest()
    rec.close()
    return dict(digest, t=T0, tm=TM0)


def test_prometheus_and_health_match_jax(tmp_path, monkeypatch):
    digests = [
        _digest(),
        _digest("trainer-1", rank=1, progress_age_s=30.0, steps_total=7,
                faults_total={"stall": 1}),
        _digest("trainer-2", rank=2, loss={"last": float("nan"), "mean": 1.0,
                                           "nonfinite_streak": 3}),
        _digest("master-0", rank=0, role="master", finished=True, alerts_total=1,
                alerts=[{"alert": "stall", "severity": "warning", "seq": 1, "t": T0}]),
        dict(_exporter_digest(tmp_path), id="trainer-3", rank=3),
    ]
    # both aggregators read the monotonic clock too: one frozen instant
    monkeypatch.setattr(time, "perf_counter", lambda: TM0 + 2.0)
    ours, theirs = Aggregator(), JaxAggregator()
    for digest in digests:
        ours.ingest(json.loads(json.dumps(digest)))
        theirs.ingest(json.loads(json.dumps(digest)))
    now = T0 + 2.0
    assert ours.prometheus_text(now=now) == theirs.prometheus_text(now=now)
    assert ours.health(now=now) == theirs.health(now=now)
    samples = [("m_total", {"rank": "0"}, 3, "counter"), ("g", {"role": 'a"b'}, 0.25, "gauge"),
               ("bad", {}, float("nan"), "gauge")]
    assert render_prometheus(samples) == jax_render(samples)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=2.0) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def _argv(*extra):
    return ["--device", "cpu", "--dataset-path", "har", "--epochs", "4", "--batch-size", "48",
            "--seed", "7", "--hidden-units", "8", "--stacked-layer", "1", "--dropout", "0.1",
            "--no-validation", "--checkpoint-every", "1", *extra, "local"]


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The CLI with the live plane, a 3 s stall at step 1 and a 0.6 s one
    at step 6 (the watchdog at 1 s) as a subprocess, polled while it runs;
    returns what the polls saw and the run's files."""
    tmp = tmp_path_factory.mktemp("live")
    write_synthetic_har_dataset(tmp / "har", num_train=120, num_test=16, seq_length=12)
    env = dict(os.environ, PDRNN_WATCHDOG_STALL="1", PDRNN_METRICS_HEARTBEAT="0.2")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.main",
         *_argv("--checkpoint-directory", "live-models", "--metrics", "m.jsonl",
                "--metrics-sample-every", "2", "--faults", "step:1:stall:3,step:6:stall:0.6",
                "--live", "0", "--live-port-file", "port.txt")],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    seen = {"metrics": None, "health": [], "stalled": None}
    try:
        deadline = time.time() + 120.0
        port_file = tmp / "port.txt"
        while time.time() < deadline and not port_file.exists() and proc.poll() is None:
            time.sleep(0.05)
        host, port = port_file.read_text().split()
        base = f"http://{host}:{port}"
        while time.time() < deadline and proc.poll() is None:
            code, body = _get(base + "/health")
            seen["health"].append(code)
            report = json.loads(body)
            if any(s["status"] == "stalled" for s in report["sources"]):
                seen["stalled"] = report
                seen["metrics"] = _get(base + "/metrics")
                break
            time.sleep(0.1)
    finally:
        out, err = proc.communicate(timeout=120.0)
    return {"tmp": tmp, "rc": proc.returncode, "err": err, "seen": seen}


def test_live_endpoints_answer_during_a_cpu_run(drill):
    assert drill["rc"] == 0, drill["err"][-3000:]
    seen = drill["seen"]
    assert seen["stalled"] is not None, seen["health"]
    code, text = seen["metrics"]
    assert code == 200 and "pdrnn_steps_total" in text and "pdrnn_progress_age_seconds" in text


def test_watchdog_flags_the_stall_and_its_clearing(drill):
    events = load_events(drill["tmp"] / "m.jsonl")
    alerts = [e["alert"] for e in events if e["kind"] == "alert"]
    assert "stall" in alerts and "stall_cleared" in alerts
    assert alerts.index("stall") < alerts.index("stall_cleared")
    stall = next(e for e in events if e["kind"] == "alert" and e["alert"] == "stall")
    assert stall["chaos_fired"] == {"stall": 1}
    assert (drill["tmp"] / "m-stacks.txt").exists()
    assert any(e["kind"] == "span" and e["name"] == "fault_stall" for e in events)


def test_live_run_ends_on_the_bits_of_a_run_without_telemetry(drill):
    """The same run without --metrics and --live (and a short stall: the
    same fault schedule, so the same per-batch loop) in this process."""
    tmp = drill["tmp"]
    here = os.getcwd()
    os.chdir(tmp)
    try:
        port_main.main(_argv("--checkpoint-directory", "plain-models",
                             "--faults", "step:1:stall:0.01"))
    finally:
        os.chdir(here)
    live, _, _ = load_checkpoint(tmp / "live-models" / "checkpoint-epoch-4.ckpt")
    plain, _, _ = load_checkpoint(tmp / "plain-models" / "checkpoint-epoch-4.ckpt")
    for key, value in plain.items():
        assert torch.equal(live[key], value), key
