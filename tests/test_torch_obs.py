"""The port's telemetry (``obs/``, the trainer's hooks) against the JAX
package's, on the CPU:

- the port's sidecar from a small ``local`` run is read by JAX's
  ``summarize_file``, ``ledger_run`` and ``build_chrome_trace`` +
  ``validate_chrome_trace``, and JAX's sidecar (``tests/test_obs.py``'s
  ``TestTrainerTelemetry`` configuration) by the port's;
- the port's readers give JAX's output on the same files, a torn final
  line and a schema-1 file among them;
- the event kinds and their counts equal the JAX trainer's on the same
  run (the same initial weights, validation and a checkpoint an epoch);
- a run with a recorder ends on the bits of a run without one, and a run
  without telemetry starts no thread;
- the port's CLI (``python -m pytorch_distributed_rnn_tpu_torch.obs``)
  summarizes, ledgers and exports the port's sidecar.
"""

import collections
import json
import threading

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_rnn_tpu.data import MotionDataset as JaxMotionDataset
from pytorch_distributed_rnn_tpu.models import MotionModel as JaxMotionModel
from pytorch_distributed_rnn_tpu.obs import ledger as jax_ledger
from pytorch_distributed_rnn_tpu.obs import summary as jax_summary
from pytorch_distributed_rnn_tpu.obs import timeline as jax_timeline
from pytorch_distributed_rnn_tpu.obs.recorder import MetricsRecorder as JaxRecorder
from pytorch_distributed_rnn_tpu.training import Trainer as JaxTrainer
from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch.data import MotionDataset, generate_har_arrays
from pytorch_distributed_rnn_tpu_torch.models import MotionModel
from pytorch_distributed_rnn_tpu_torch.obs import ledger, summary, timeline
from pytorch_distributed_rnn_tpu_torch.obs.cli import main as obs_main
from pytorch_distributed_rnn_tpu_torch.obs.recorder import NULL_RECORDER, MetricsRecorder
from pytorch_distributed_rnn_tpu_torch.training import Trainer

SEED = 123456789


def _arrays():
    return generate_har_arrays(96, seq_length=24, seed=0), generate_har_arrays(32, 24, seed=1)


def _jax_run(path, checkpoint_dir=None):
    """``TestTrainerTelemetry``'s run (96 windows, batch 24, hidden 16, one
    layer, 2 epochs, a fence every 2 steps), with validation and a
    checkpoint an epoch where ``checkpoint_dir`` is given; returns its
    initial parameters."""
    train, valid = _arrays()
    rec = JaxRecorder(path, sample_every=2, heartbeat_every_s=0)
    trainer = JaxTrainer(JaxMotionModel(input_dim=9, hidden_dim=16, layer_dim=1, output_dim=6),
                         JaxMotionDataset(*train), batch_size=24, learning_rate=2.5e-3, seed=SEED,
                         recorder=rec, validation_set=JaxMotionDataset(*valid),
                         checkpoint_dir=checkpoint_dir, checkpoint_every=1 if checkpoint_dir else 0)
    init = jax.tree.map(np.array, trainer.params)
    trainer.train(epochs=2)
    rec.close()
    return init


def _port_trainer(init, recorder=None, checkpoint_dir=None):
    train, valid = _arrays()
    model = MotionModel(input_dim=9, hidden_dim=16, layer_dim=1, output_dim=6)
    model.load_state_dict(interop.jax_params_to_state_dict(init))
    return Trainer(model, MotionDataset(*train), 24, 2.5e-3, seed=SEED, device="cpu",
                   recorder=recorder, validation_set=MotionDataset(*valid),
                   checkpoint_dir=checkpoint_dir, checkpoint_every=1 if checkpoint_dir else 0)


@pytest.fixture(scope="module")
def sidecars(tmp_path_factory):
    """The JAX run's and the port's sidecars of the same run, and the
    port trainer."""
    tmp = tmp_path_factory.mktemp("obs")
    init = _jax_run(tmp / "jax.jsonl", tmp / "jax-models")
    rec = MetricsRecorder(tmp / "port.jsonl", sample_every=2, heartbeat_every_s=0)
    trainer = _port_trainer(init, rec, tmp / "port-models")
    trainer.train(epochs=2)
    rec.close()
    return {"jax": tmp / "jax.jsonl", "port": tmp / "port.jsonl", "init": init,
            "trainer": trainer, "tmp": tmp}


def _same(a, b):
    """Equal as JSON (NaN equal to NaN)."""
    assert json.dumps(a, sort_keys=True, default=str) == json.dumps(b, sort_keys=True,
                                                                      default=str)


def test_port_sidecar_reads_with_the_jax_readers(sidecars):
    path = sidecars["port"]
    events = jax_summary.load_events(path)
    assert events[0]["kind"] == "meta" and events[0]["schema"] == 2
    s = jax_summary.summarize_file(path)
    assert s["steps"] == 8 and s["epochs"] == 2 and s["step_s_mean"] > 0
    assert s["loss_last"] == [e["loss"] for e in events if e["kind"] == "step"][-1]
    run = jax_ledger.ledger_run(path)
    rank = run["ranks"][0]
    assert sum(rank["fractions"].values()) == pytest.approx(1.0, abs=1e-6)
    assert run["aggregate"]["mfu_est"] > 0
    trace = jax_timeline.build_chrome_trace(jax_timeline.load_run(path))
    jax_timeline.validate_chrome_trace(trace)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "eval" in names


def test_jax_sidecar_reads_with_the_port_readers(sidecars):
    path = sidecars["jax"]
    s = summary.summarize_file(path)
    assert s["steps"] == 8 and s["epochs"] == 2
    run = ledger.ledger_run(path)
    assert sum(run["ranks"][0]["fractions"].values()) == pytest.approx(1.0, abs=1e-6)
    timeline.validate_chrome_trace(timeline.build_chrome_trace(timeline.load_run(path)))


def _torn(path, out):
    text = path.read_text()
    out.write_text(text + '{"kind": "step", "t": 1.0, "tm": 2.')  # cut mid-append
    return out


def _schema1(path, out):
    lines = []
    for line in path.read_text().splitlines():
        event = json.loads(line)
        event.pop("tm", None)
        if event["kind"] == "meta":
            event["schema"] = 1
        lines.append(json.dumps(event))
    out.write_text("\n".join(lines) + "\n")
    return out


@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.parametrize("variant", ["plain", "torn", "schema1"])
def test_port_readers_give_the_jax_readers_output(sidecars, source, variant):
    path = sidecars[source]
    if variant == "torn":
        path = _torn(path, sidecars["tmp"] / f"{source}-torn.jsonl")
    elif variant == "schema1":
        path = _schema1(path, sidecars["tmp"] / f"{source}-schema1.jsonl")
    _same(summary.load_events(path), jax_summary.load_events(path))
    _same(summary.summarize_file(path), jax_summary.summarize_file(path))
    events = summary.load_events(path)
    now = events[-1]["t"] + 1.0
    _same(summary.rank_health(events, now=now), jax_summary.rank_health(events, now=now))
    if variant == "schema1":
        # the ledger and the timeline need schema 2, in both packages
        for read in (ledger.ledger_run, jax_ledger.ledger_run,
                     lambda p: timeline.build_chrome_trace(timeline.load_run(p)),
                     lambda p: jax_timeline.build_chrome_trace(jax_timeline.load_run(p))):
            with pytest.raises(ValueError):
                read(path)
        return
    peak = {"peak_flops_total": 1e12, "estimated": True, "device": "test"}
    _same(ledger.ledger_run(path, peak=peak), jax_ledger.ledger_run(path, peak=peak))
    ours = timeline.build_chrome_trace(timeline.load_run(path))
    _same(ours, jax_timeline.build_chrome_trace(jax_timeline.load_run(path)))


def _kinds(path):
    events = summary.load_events(path)
    kinds = collections.Counter(e["kind"] for e in events)
    kinds.update(f"span:{e['name']}" for e in events if e["kind"] == "span")
    return kinds, events


def test_event_kinds_and_counts_equal_the_jax_trainers(sidecars):
    port, port_events = _kinds(sidecars["port"])
    jax_kinds, jax_events = _kinds(sidecars["jax"])
    assert port == jax_kinds
    assert port["step"] == 8 and port["checkpoint_save"] >= 2 and port["eval"] == 2
    for events in (port_events, jax_events):
        assert [e["path"] for e in events if e["kind"] == "epoch"] == ["step", "step"]
        fenced = [e["step"] for e in events if e["kind"] == "step" and e["fenced_s"] is not None]
        assert fenced == [0, 1, 2, 4, 6]  # step 1 and every 2nd: the sampled steps
    # the losses the step events carry are the run's, as JAX's are
    port_losses = [e["loss"] for e in port_events if e["kind"] == "step"]
    jax_losses = [e["loss"] for e in jax_events if e["kind"] == "step"]
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    run = [e for e in port_events if e["kind"] == "run_summary"][0]
    assert run["ledger"]["peak_flops_estimated"] and run["ledger"]["model_flops_per_step"] > 0
    collectives = [e for e in port_events if e["kind"] == "collectives"][0]
    assert collectives["ops"] == {} and collectives["bytes_per_step"] == 0


def test_a_recorded_run_ends_on_the_bits_of_an_unrecorded_one(sidecars):
    plain = _port_trainer(sidecars["init"])
    plain.train(epochs=2)
    recorded = sidecars["trainer"]
    for key, value in plain.model.state_dict().items():
        assert torch.equal(recorded.model.state_dict()[key], value), key
    ours, theirs = recorded.optimizer.state_dict(), plain.optimizer.state_dict()
    for index, state in theirs["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(ours["state"][index][name], state[name])


def test_no_telemetry_starts_no_thread():
    before = threading.active_count()
    train, _ = _arrays()
    model = MotionModel(input_dim=9, hidden_dim=8, layer_dim=1, output_dim=6)
    trainer = Trainer(model, MotionDataset(*train), 48, 2.5e-3, seed=SEED, device="cpu")
    assert trainer.recorder is NULL_RECORDER
    trainer.train(epochs=1)
    assert threading.active_count() == before
    assert not any(t.name == "pdrnn-metrics" for t in threading.enumerate())
    assert MetricsRecorder.resolve(type("Args", (), {"metrics": None})()) is NULL_RECORDER


def test_port_cli_reads_the_port_sidecar(sidecars, capsys):
    path = str(sidecars["port"])
    assert obs_main(["summarize", path]) == 0
    assert obs_main(["ledger", path]) == 0
    out = sidecars["tmp"] / "port.trace.json"
    assert obs_main(["timeline", path, "-o", str(out)]) == 0
    timeline.validate_chrome_trace(json.loads(out.read_text()))
    assert obs_main(["health", path]) == 0
    text = capsys.readouterr().out
    assert "steps" in text and "goodput" in text
