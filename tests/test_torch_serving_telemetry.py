"""The port's serving telemetry and chaos (``pytorch_distributed_rnn_tpu_
torch/serving/{engine,server,cli,drill}.py``) on the CPU, held against the
JAX package's engine on the same weights (carried over by ``interop``) and
the same seeded request mix: the sidecars' event kinds and counts, the
summaries, ``live_source``'s keys, and under ``step:N:stall``, ``nan`` and
``exc`` the same failed requests, ``chaos_absorbed`` and tokens.  Then the
JAX package's own cases (``tests/test_serving.py``'s telemetry and chaos,
``tests/test_serving_server.py``'s drill and tracing) against the port, the
C4 budget with telemetry and a fault schedule armed, and the serve CLI's
flags."""

import json
import threading
import time
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from pytorch_distributed_rnn_tpu.models import AttentionLM as JaxAttentionLM
from pytorch_distributed_rnn_tpu.models import CharRNN as JaxCharRNN
from pytorch_distributed_rnn_tpu.obs.recorder import MetricsRecorder as JaxRecorder
from pytorch_distributed_rnn_tpu.obs.summary import summarize_file as jax_summarize
from pytorch_distributed_rnn_tpu.resilience.faults import FaultSchedule as JaxFaults
from pytorch_distributed_rnn_tpu.serving import adapters as jax_adapters
from pytorch_distributed_rnn_tpu.serving.buckets import BucketSpec as JaxBucketSpec
from pytorch_distributed_rnn_tpu.serving.engine import ServingEngine as JaxServingEngine
from pytorch_distributed_rnn_tpu.serving.scheduler import ServeRequest as JaxServeRequest
from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch.models import AttentionLM, CharRNN
from pytorch_distributed_rnn_tpu_torch.obs.recorder import NULL_RECORDER, MetricsRecorder
from pytorch_distributed_rnn_tpu_torch.obs.summary import summarize_file
from pytorch_distributed_rnn_tpu_torch.resilience.faults import FaultSchedule
from pytorch_distributed_rnn_tpu_torch.serving import cli
from pytorch_distributed_rnn_tpu_torch.serving.adapters import adapter_for
from pytorch_distributed_rnn_tpu_torch.serving.buckets import BucketSpec
from pytorch_distributed_rnn_tpu_torch.serving.engine import ServingEngine, TorchCalls
from pytorch_distributed_rnn_tpu_torch.serving.protocol import ServingClient
from pytorch_distributed_rnn_tpu_torch.serving.scheduler import ServeRequest
from pytorch_distributed_rnn_tpu_torch.serving.server import ServingServer
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import save_checkpoint

VOCAB = 48
FAMILIES = ["char-lstm", "char-gru", "attention"]


def _pair(family: str = "char-lstm", seed: int = 1):
    """The JAX model, its params, and the port model holding them."""
    if family == "attention":
        jax_model = JaxAttentionLM(vocab_size=VOCAB, dim=32, depth=2, num_heads=4, max_len=64)
        model = AttentionLM(vocab_size=VOCAB, dim=32, depth=2, num_heads=4, max_len=64)
    else:
        cell = family.split("-")[1]
        jax_model = JaxCharRNN(vocab_size=VOCAB, embed_dim=16, hidden_dim=24, layer_dim=2,
                               cell=cell, impl="scan")
        model = CharRNN(vocab_size=VOCAB, embed_dim=16, hidden_dim=24, layer_dim=2, cell=cell,
                        impl="scan")
    params = jax_model.init(jax.random.PRNGKey(seed))
    model.load_state_dict(interop.jax_params_to_state_dict(params))
    return jax_model, params, model.eval()


def make_engine(model, **kwargs):
    defaults = dict(num_slots=4, bucket_spec=BucketSpec((8, 16)), max_new_tokens=12)
    defaults.update(kwargs)
    return ServingEngine(adapter_for(model), **defaults)


def make_jax_engine(jax_model, params, **kwargs):
    defaults = dict(num_slots=4, bucket_spec=JaxBucketSpec((8, 16)), max_new_tokens=12)
    defaults.update(kwargs)
    return JaxServingEngine(jax_adapters.adapter_for(jax_model), params, **defaults)


def mixed_requests(n, rng, max_prompt=15, max_new=12, cls=ServeRequest, temps=(0.0, 0.7, 1.0)):
    requests = []
    for i in range(n):
        plen = int(rng.randint(1, max_prompt + 1))
        requests.append(cls(
            prompt=rng.randint(0, VOCAB, size=plen).tolist(),
            max_new_tokens=int(rng.randint(1, max_new + 1)),
            temperature=temps[i % len(temps)], seed=1000 + i, id=str(i),
        ))
    return requests


def reference_tokens(model, request) -> list:
    generator = torch.Generator().manual_seed(request.seed)
    out = model.generate(torch.tensor([request.prompt]), request.max_new_tokens,
                         generator=generator, temperature=request.temperature)
    return out[0, len(request.prompt):].tolist()


def assert_matches_reference(model, requests):
    for r in requests:
        assert r.status == "done", (r.id, r.status, r.error)
        assert r.tokens == reference_tokens(model, r), f"request {r.id} diverged from generate"


def event_counts(path) -> Counter:
    """``kind`` (spans: ``span:<name>``) -> count, without the meta line."""
    counts = Counter()
    for line in path.read_text().splitlines():
        event = json.loads(line)
        kind = event["kind"]
        if kind == "meta":
            continue
        counts[f"span:{event['name']}" if kind == "span" else kind] += 1
    return counts


def run_both(family, tmp_path, n, seed, *, faults=None):
    """The same seeded mix through the JAX engine and the port's, each with
    a recorder (and its own parse of ``faults``); returns both engines'
    requests, sidecar paths, final stats and live sources."""
    jax_model, params, model = _pair(family)
    out = {}
    for side in ("jax", "torch"):
        path = tmp_path / f"{side}.jsonl"
        if side == "jax":
            recorder = JaxRecorder(path, sample_every=4, heartbeat_every_s=0.0)
            schedule = JaxFaults.parse(faults) if faults else None
            engine = make_jax_engine(jax_model, params, faults=schedule, recorder=recorder)
            requests = mixed_requests(n, np.random.RandomState(seed), cls=JaxServeRequest)
        else:
            recorder = MetricsRecorder(path, sample_every=4, heartbeat_every_s=0.0)
            schedule = FaultSchedule.parse(faults) if faults else None
            engine = make_engine(model, faults=schedule, recorder=recorder)
            requests = mixed_requests(n, np.random.RandomState(seed))
        engine.warmup()
        for r in requests:
            assert engine.submit(r), r.error
        engine.drain()
        live = engine.live_source()
        stats = engine.stats()
        engine.close()
        recorder.close()
        out[side] = {"requests": requests, "path": path, "stats": stats, "live": live,
                     "faults": schedule}
    return out, model


# ---------------------------------------------------------------------------
# the engine's telemetry against the JAX engine's


@pytest.mark.parametrize("family", FAMILIES)
def test_engine_sidecar_and_live_source_match_jax(family, tmp_path):
    """8 mixed requests through 4 slots on both engines, each recording:
    the same event kinds and counts (``step``, ``prefill`` spans,
    ``request``, ``run_summary``), the same summarized requests and
    tokens, the same ``live_source`` keys, and greedy tokens equal."""
    both, _ = run_both(family, tmp_path, 8, seed=4)
    jax_counts, counts = event_counts(both["jax"]["path"]), event_counts(both["torch"]["path"])
    assert counts == jax_counts
    assert counts["run_summary"] == 1 and counts["request"] == 8
    assert counts["span:prefill"] == 8 and counts["step"] > 0
    summary, jax_summary = (summarize_file(both["torch"]["path"]),
                            jax_summarize(both["jax"]["path"]))
    for key in ("steps", "requests", "requests_shed", "requests_failed", "tokens_out"):
        assert summary[key] == jax_summary[key], key
    assert set(both["torch"]["live"]) == set(both["jax"]["live"]) == {"serving"}
    assert set(both["torch"]["live"]["serving"]) == set(both["jax"]["live"]["serving"])
    assert set(both["torch"]["stats"]) == set(both["jax"]["stats"])
    for r, j in zip(both["torch"]["requests"], both["jax"]["requests"]):
        assert r.status == j.status == "done"
        if r.temperature == 0:
            assert r.tokens == j.tokens, r.id


def test_serving_telemetry_summarizes_and_exports(tmp_path):
    _, _, model = _pair()
    metrics = tmp_path / "serve.jsonl"
    recorder = MetricsRecorder(metrics, sample_every=4, heartbeat_every_s=0.0)
    engine = make_engine(model, recorder=recorder)
    engine.warmup()
    requests = mixed_requests(8, np.random.RandomState(4))
    for r in requests:
        engine.submit(r)
    engine.drain()
    engine.close()
    recorder.close()
    assert_matches_reference(model, requests)

    summary = summarize_file(metrics)
    assert summary["steps"] > 0 and summary["step_s_mean"] is not None
    assert summary["requests"] == 8
    assert summary["latency_s_p95"] >= summary["latency_s_p50"] > 0
    assert summary["ttft_s_p50"] > 0
    assert summary["queue_depth_max"] >= 0
    assert summary["tokens_per_s"] > 0 and summary["duration_s"] > 0

    from pytorch_distributed_rnn_tpu_torch.obs.cli import main as metrics_main
    from pytorch_distributed_rnn_tpu_torch.obs.timeline import (
        validate_chrome_trace,
        write_chrome_trace,
    )

    assert metrics_main(["summarize", str(metrics)]) == 0
    trace = write_chrome_trace(metrics, tmp_path / "serve.trace.json")
    validate_chrome_trace(trace)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "prefill" in names and "request" in names


def test_stats_rolling_window_rates():
    from pytorch_distributed_rnn_tpu_torch.obs.live import RollingWindow

    _, _, model = _pair()
    engine = make_engine(model, max_queue=2)
    assert isinstance(engine._completions, RollingWindow)
    engine.warmup()
    stats = engine.stats()
    assert stats["req_per_s_60s"] == 0.0 and stats["shed_per_s_60s"] == 0.0
    for r in mixed_requests(6, np.random.RandomState(2)):
        engine.submit(r)
        engine.drain()
    stats = engine.stats()
    assert stats["req_per_s_60s"] > 0 and stats["tokens_per_s_60s"] > 0
    assert stats["tokens_per_s_60s"] == pytest.approx(
        stats["req_per_s_60s"] * stats["tokens_out"] / stats["requests"], rel=0.3)
    shed = sum(0 if engine.submit(r) else 1 for r in mixed_requests(8, np.random.RandomState(3)))
    assert shed > 0
    assert engine.stats()["shed_per_s_60s"] > 0
    engine.drain()
    engine.close()


class _CountAll(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls += 1
        return func(*args, **(kwargs or {}))


def test_live_source_mirrors_stats_op():
    """The digest block and the stats op give the same numbers, and the
    block is read from host counters alone: no torch call (it runs on the
    exporter's thread, and only the engine thread touches the device)."""
    _, _, model = _pair()
    engine = make_engine(model)
    engine.warmup()
    for r in mixed_requests(4, np.random.RandomState(5)):
        engine.submit(r)
    engine.drain()
    with _CountAll() as mode:
        block = engine.live_source()["serving"]
    assert mode.calls == 0
    stats = engine.stats()
    for key in ("requests", "requests_shed", "tokens_out", "latency_s_p95", "queue_depth"):
        assert block[key] == stats[key], key
    assert block["req_per_s_60s"] == pytest.approx(stats["req_per_s_60s"], rel=0.05)
    assert block["num_slots"] == 4 and block["latency_hist"]["count"] == 4
    engine.close()


def test_serving_telemetry_off_by_default_is_null():
    _, _, model = _pair()
    engine = make_engine(model)
    assert engine.recorder is NULL_RECORDER and not engine.recorder.enabled
    engine.warmup()
    r = ServeRequest(prompt=[1, 2], max_new_tokens=2)
    engine.submit(r)
    engine.drain()
    assert r.status == "done"


# ---------------------------------------------------------------------------
# chaos against the JAX engine


@pytest.mark.parametrize("spec", ["step:2:stall:0.2", "step:3:nan", "step:1:exc"])
def test_chaos_outcomes_match_jax(spec, tmp_path):
    """The same fault on the same mix (9 requests, 4 slots): the same
    failed request ids, ``chaos_absorbed`` and fired counters, the fault
    in both sidecars, greedy survivors' tokens equal to JAX's and every
    survivor's equal to the port's ``generate``."""
    both, model = run_both("char-lstm", tmp_path, 9, seed=6, faults=spec)
    port, ref = both["torch"], both["jax"]
    failed = [r.id for r in port["requests"] if r.status != "done"]
    assert failed == [r.id for r in ref["requests"] if r.status != "done"]
    assert bool(failed) == spec.endswith("nan")
    for r in port["requests"]:
        if r.status != "done":
            assert r.error == "non-finite logits during decode (chaos fault or poisoned " \
                              "checkpoint)"
    assert port["stats"]["chaos_absorbed"] == ref["stats"]["chaos_absorbed"]
    assert port["stats"]["requests_failed"] == ref["stats"]["requests_failed"] == len(failed)
    assert port["faults"].fired == ref["faults"].fired == {spec.split(":")[2]: 1}
    survivors = [r for r in port["requests"] if r.status == "done"]
    assert_matches_reference(model, survivors)
    for r, j in zip(port["requests"], ref["requests"]):
        if r.status == "done" and r.temperature == 0:
            assert r.tokens == j.tokens, r.id
    counts, jax_counts = event_counts(port["path"]), event_counts(ref["path"])
    assert counts == jax_counts and counts["fault"] == 1


@pytest.mark.chaos
def test_stall_fault_holds_the_loop_but_requests_complete(tmp_path):
    _, _, model = _pair()
    faults = FaultSchedule.parse("step:2:stall:0.3")
    metrics = tmp_path / "chaos.jsonl"
    recorder = MetricsRecorder(metrics, heartbeat_every_s=0.0)
    engine = make_engine(model, faults=faults, recorder=recorder)
    engine.warmup()
    requests = mixed_requests(4, np.random.RandomState(6))
    t0 = time.perf_counter()
    for r in requests:
        engine.submit(r)
    engine.drain()
    elapsed = time.perf_counter() - t0
    engine.close()
    recorder.close()
    assert_matches_reference(model, requests)
    assert faults.fired.get("stall") == 1
    assert elapsed >= 0.3
    text = metrics.read_text()
    assert '"kind": "fault"' in text
    assert '"fault_stall"' in text


@pytest.mark.chaos
def test_nan_fault_fails_requests_cleanly_and_service_recovers():
    _, _, model = _pair()
    faults = FaultSchedule.parse("step:1:nan")
    engine = make_engine(model, faults=faults)
    engine.warmup()
    poisoned = mixed_requests(2, np.random.RandomState(8), max_new=12)
    for r in poisoned:
        r.max_new_tokens = max(r.max_new_tokens, 3)
        engine.submit(r)
    engine.drain()
    assert all(r.status == "error" and "non-finite" in r.error for r in poisoned)
    assert engine.stats()["requests_failed"] == 2
    # the poison was written into the persistent buffer the step graph
    # reads, and the failed slots' successors start from a clean join
    fresh = mixed_requests(3, np.random.RandomState(9))
    for i, r in enumerate(fresh):
        r.id = f"fresh-{i}"
        engine.submit(r)
    engine.drain()
    assert_matches_reference(model, fresh)


@pytest.mark.chaos
def test_exception_fault_is_absorbed():
    _, _, model = _pair()
    faults = FaultSchedule.parse("step:1:exc")
    engine = make_engine(model, faults=faults)
    engine.warmup()
    requests = mixed_requests(3, np.random.RandomState(10))
    for r in requests:
        engine.submit(r)
    engine.drain()
    assert_matches_reference(model, requests)
    assert engine.stats()["chaos_absorbed"] == 1


# ---------------------------------------------------------------------------
# C4: the decode step's Python->torch calls with telemetry and chaos armed


def test_calls_a_step_with_metrics_and_faults_armed(tmp_path):
    """With a recorder and a fault schedule armed, a decode step where no
    fault fires makes the calls it makes without them (CPU: the draw, the
    step, the result copy - at most 4), the firing step adds only its
    ``faults`` calls, and after warm-up no program is traced, for traced
    and untraced requests alike."""
    from pytorch_distributed_rnn_tpu_torch.obs.tracectx import TraceContext

    _, _, model = _pair()
    recorder = MetricsRecorder(tmp_path / "c4.jsonl", sample_every=1, heartbeat_every_s=0.0)
    faults = FaultSchedule.parse("step:1000:nan,step:2000:stall:1,step:5:exc")
    engine = make_engine(model, recorder=recorder, faults=faults)
    engine.warmup()
    snapshot = engine.retrace_snapshot()
    assert snapshot == {"prefill": 2, "step": 1, "join": 1}
    requests = mixed_requests(8, np.random.RandomState(12))
    for i, r in enumerate(requests):
        if i % 2:
            r.trace = TraceContext.mint()
        assert engine.submit(r)
    steps = 0
    with torch.no_grad(), TorchCalls(engine) as calls:
        while engine.batcher.has_work:
            steps += engine.run_step(wait_s=0.0)
    engine.close()
    recorder.close()
    assert steps > 5 and faults.fired == {"exc": 1}
    assert "faults" not in calls.counts  # no fault fired a torch call
    per_step = calls.counts["draw"] + calls.counts["step"] + calls.counts["result"]
    assert calls.counts["step"] == calls.counts["result"] == steps
    assert per_step <= 4 * steps
    assert calls.counts["join"] == 2 * len(requests)
    assert engine.retraces_since(snapshot) == {}
    assert_matches_reference(model, requests)
    assert engine.stats()["chaos_absorbed"] == 1


def test_a_firing_nan_fault_adds_calls_only_on_its_step(tmp_path):
    _, _, model = _pair()
    engine = make_engine(model, faults=FaultSchedule.parse("step:2:nan"))
    engine.warmup()
    for r in mixed_requests(2, np.random.RandomState(13), temps=(0.0,)):
        r.max_new_tokens = 6
        engine.submit(r)
    with torch.no_grad(), TorchCalls(engine) as calls:
        engine.drain()
    assert 0 < calls.counts["faults"] <= 3
    assert engine.stats()["requests_failed"] == 2


# ---------------------------------------------------------------------------
# the server: traced requests, tracing off, the chaos drill


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The char LM at width 24 (vocab 256) from the JAX initial weights,
    written as a port checkpoint."""
    jax_model = JaxCharRNN(vocab_size=256, embed_dim=24, hidden_dim=24, layer_dim=2,
                           impl="scan")
    params = jax_model.init(jax.random.PRNGKey(3))
    model = CharRNN(vocab_size=256, embed_dim=24, hidden_dim=24, layer_dim=2, impl="scan")
    model.load_state_dict(interop.jax_params_to_state_dict(params))
    optimizer = torch.optim.Adam(model.parameters())
    path = save_checkpoint(tmp_path_factory.mktemp("telemetry-ckpt"), 0, model.state_dict(),
                           optimizer.state_dict(), 1.0)
    return path, model.eval()


def make_server(model, metrics_path=None):
    recorder = (MetricsRecorder(metrics_path, heartbeat_every_s=0.0)
                if metrics_path is not None else NULL_RECORDER)
    engine = ServingEngine(adapter_for(model), num_slots=4, bucket_spec=BucketSpec((8, 16)),
                           max_new_tokens=16, recorder=recorder)
    engine.warmup()
    return ServingServer(engine, model_name="char", recorder=recorder)


def test_traced_request_assembles_into_engine_lifecycle_tree(checkpoint, tmp_path):
    from pytorch_distributed_rnn_tpu_torch.obs.trace import assemble_traces, validate_trace_tree
    from pytorch_distributed_rnn_tpu_torch.obs.tracectx import TraceContext

    _, model = checkpoint
    metrics = tmp_path / "traced.jsonl"
    ctx = TraceContext.mint(qos="high")
    with make_server(model, metrics_path=metrics) as server:
        with ServingClient(server.host, server.port) as client:
            reply = client.generate(prompt=[1, 2, 3], max_new_tokens=4, request_id="tr1",
                                    trace=ctx, stream=True)
    assert reply["event"] == "done"
    trees = assemble_traces([metrics], request=ctx.trace_id)
    assert len(trees) == 1
    tree = trees[0]
    validate_trace_tree(tree)
    assert tree.request == "tr1"
    assert tree.root.name == "request" and tree.root.span_id == ctx.span_id
    names = {n.name for n in tree.root.walk()}
    assert {"queue_wait", "prefill", "decode", "stream_emit"} <= names
    assert sum(tree.critical_path().values()) == 1.0


def test_tracing_off_is_pinned_zero_overhead(checkpoint, tmp_path):
    """An untraced request constructs no TraceContext server-side, its wire
    request has the pre-tracing keys, and a traced request captures (on
    the CPU: traces) no program."""
    from pytorch_distributed_rnn_tpu_torch.obs.tracectx import TraceContext
    from pytorch_distributed_rnn_tpu_torch.serving.protocol import (
        build_generate_request,
        encode_line,
    )

    req = build_generate_request([1, 2], request_id="w", max_new_tokens=2)
    assert set(req) == {"op", "id", "max_new_tokens", "temperature", "stream", "prompt"}
    untraced_bytes = encode_line(req)
    traced = build_generate_request([1, 2], request_id="w", max_new_tokens=2,
                                    trace=TraceContext.mint())
    assert set(traced) - set(req) == {"trace"}
    _, model = checkpoint
    with make_server(model, metrics_path=tmp_path / "zero.jsonl") as server:
        warm = server.engine.retrace_snapshot()
        before = TraceContext.minted
        with ServingClient(server.host, server.port) as client:
            assert client.generate(prompt=[5, 6], max_new_tokens=3)["event"] == "done"
            assert TraceContext.minted == before
            assert server.engine.retrace_snapshot() == warm
            reply = client.generate(prompt=[5, 6], max_new_tokens=3, trace=TraceContext.mint())
            assert reply["event"] == "done"
            assert server.engine.retrace_snapshot() == warm
    assert encode_line(build_generate_request([1, 2], request_id="w",
                                              max_new_tokens=2)) == untraced_bytes


def test_serve_shutdown_closes_the_recorder_with_a_run_summary(checkpoint, tmp_path):
    _, model = checkpoint
    metrics = tmp_path / "close.jsonl"
    with make_server(model, metrics_path=metrics) as server:
        with ServingClient(server.host, server.port) as client:
            assert client.generate(prompt=[4], max_new_tokens=2)["event"] == "done"
    counts = event_counts(metrics)
    assert counts["run_summary"] == 1 and counts["request"] == 1
    assert summarize_file(metrics)["requests"] == 1


@pytest.mark.chaos
def test_slo_drill_under_stall_fault(checkpoint, tmp_path):
    """A subprocess server with a stall fault stays up, queues load through
    the stall (the degradation window opens), recovers (it closes before
    the run ends), and exits 0 on SIGTERM; the fault is in its sidecar and
    the sidecar counts the requests the load generator saw done."""
    from pytorch_distributed_rnn_tpu_torch.serving.drill import run_drill
    from pytorch_distributed_rnn_tpu_torch.serving.loadgen import LoadConfig

    path, _ = checkpoint
    metrics = tmp_path / "drill-metrics.jsonl"
    report, exit_code = run_drill(
        ["--device", "cpu", "--checkpoint", str(path), "--model", "char", "--vocab-size", "256",
         "--hidden-units", "24", "--stacked-layer", "2", "--slots", "4",
         "--prompt-buckets", "8,16", "--max-new-tokens", "16", "--max-queue", "8",
         "--faults", "step:40:stall:1.5", "--metrics", str(metrics)],
        LoadConfig(requests=60, rate=25.0, prompt_len_max=14, new_tokens_min=4,
                   new_tokens_max=10, temperature=0.8, seed=3, slo_p95_ms=400.0,
                   timeout_s=120.0),
    )
    assert exit_code == 0 and report["server_exit"] == 0
    assert report["done"] > 0 and report["errors"] == 0, report["error_samples"]
    assert report["done"] + report["shed"] == 60
    assert report["degraded_seconds"], "stall fault produced no degradation window"
    window = report["degradation_window_s"]
    assert window is not None and window[1] <= report["timeline"][-1]["second"]
    text = metrics.read_text()
    assert '"kind": "fault"' in text
    assert summarize_file(metrics)["requests"] == report["done"]


# ---------------------------------------------------------------------------
# the serve CLI's telemetry flags


def test_serve_cli_accepts_telemetry_and_fleet_flags(checkpoint, tmp_path, monkeypatch):
    """``serve`` with every telemetry, chaos and fleet flag: it parses
    them, serves, stops through its SIGTERM handler (called here, not sent)
    with exit 0, and writes a sidecar and a live port file."""
    import signal

    path, _ = checkpoint
    metrics, live_port, port_file = (tmp_path / "m.jsonl", tmp_path / "live.port",
                                     tmp_path / "port")
    argv = ["--device", "cpu", "--checkpoint", str(path), "--model", "char",
            "--hidden-units", "24", "--stacked-layer", "2", "--slots", "2",
            "--prompt-buckets", "8", "--max-new-tokens", "4", "--port-file", str(port_file),
            "--metrics", str(metrics), "--metrics-sample-every", "2", "--live", "0",
            "--live-port-file", str(live_port), "--slo", "qos=normal:p95_ms=500",
            "--slo-windows", "5,30", "--faults", "step:1:exc", "--drain-timeout", "5"]
    args = cli.build_serve_parser().parse_args(argv)
    assert (args.metrics_sample_every, args.slo, args.slo_windows, args.faults,
            args.drain_timeout, args.replica_id) == (2, ["qos=normal:p95_ms=500"], "5,30",
                                                     "step:1:exc", 5.0, None)
    handlers, result = {}, {}
    monkeypatch.setattr(signal, "signal", lambda sig, handler: handlers.__setitem__(sig, handler))

    def client():
        try:
            deadline = time.monotonic() + 60
            while not port_file.exists() and time.monotonic() < deadline:
                time.sleep(0.05)
            host, port = port_file.read_text().split()
            with ServingClient(host, int(port)) as c:
                result["reply"] = c.generate(prompt=[1, 2], max_new_tokens=3)
        finally:
            if signal.SIGTERM in handlers:
                handlers[signal.SIGTERM](signal.SIGTERM, None)

    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    rc = cli.serve_main(argv)
    thread.join(timeout=30)
    assert not thread.is_alive()
    assert rc == 0 and result["reply"]["event"] == "done"
    assert live_port.read_text().split()[0] == "127.0.0.1"
    counts = event_counts(metrics)
    assert counts["fault"] == 1 and counts["request"] == 1 and counts["run_summary"] == 1
