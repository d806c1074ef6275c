"""The port's serving fleet with real engines on the CPU
(``pytorch_distributed_rnn_tpu_torch/serving/fleet/``,
``launcher/supervisor.py``), the JAX package's ``tests/test_fleet_drill.py``
against the port: a retried dispatch through the router has the tokens of
the port's single-request ``generate`` and, greedy, of JAX's, on weights
that JAX trained and ``interop`` carried over; ``net:flap`` drops open
connections; the kill-mid-burst drill (``slow``, ``chaos``).  Then the
supervisor against JAX's on the same fake process deaths, the router's
entry point, and the no-card failure of a replica."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_rnn_tpu.data.synthetic import generate_char_tokens
from pytorch_distributed_rnn_tpu.launcher import supervisor as jax_supervisor
from pytorch_distributed_rnn_tpu.models import CharRNN as JaxCharRNN
from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch.launcher import supervisor
from pytorch_distributed_rnn_tpu_torch.models import CharRNN
from pytorch_distributed_rnn_tpu_torch.obs.recorder import MetricsRecorder
from pytorch_distributed_rnn_tpu_torch.serving import cli
from pytorch_distributed_rnn_tpu_torch.serving.__main__ import main as serving_main
from pytorch_distributed_rnn_tpu_torch.serving.adapters import adapter_for
from pytorch_distributed_rnn_tpu_torch.serving.buckets import BucketSpec
from pytorch_distributed_rnn_tpu_torch.serving.engine import ServingEngine
from pytorch_distributed_rnn_tpu_torch.serving.fleet.pool import Replica, ReplicaPool
from pytorch_distributed_rnn_tpu_torch.serving.fleet.router import RouterCore
from pytorch_distributed_rnn_tpu_torch.serving.protocol import ProtocolError, ServingClient
from pytorch_distributed_rnn_tpu_torch.serving.server import ServingServer
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import save_checkpoint

MODEL_ARGS = dict(vocab_size=256, embed_dim=24, hidden_dim=24, layer_dim=2, impl="scan")
REPLICA_FLAGS = ["--model", "char", "--vocab-size", "256", "--hidden-units", "24",
                 "--stacked-layer", "2", "--slots", "4", "--prompt-buckets", "8,16",
                 "--max-new-tokens", "16", "--max-queue", "16"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The char LM trained 25 Adam steps by the JAX package (as JAX's fleet
    tests train it), carried into the port and written as a port
    checkpoint.  Returns ``(path, port model, jax model, jax params)``."""
    jax_model = JaxCharRNN(**MODEL_ARGS)
    params = jax_model.init(jax.random.PRNGKey(0))
    tokens = jnp.asarray(generate_char_tokens(32, 33, vocab_size=256, seed=0))
    opt = optax.adam(5e-3)
    opt_state = opt.init(params)

    @jax.jit
    def step(p, s):
        loss, grads = jax.value_and_grad(jax_model.loss)(p, tokens)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    loss = None
    for _ in range(25):
        params, opt_state, loss = step(params, opt_state)
    model = CharRNN(**MODEL_ARGS)
    model.load_state_dict(interop.jax_params_to_state_dict(params))
    optimizer = torch.optim.Adam(model.parameters())
    path = save_checkpoint(tmp_path_factory.mktemp("fleet-ckpt"), 0, model.state_dict(),
                           optimizer.state_dict(), float(loss))
    return path, model.eval(), jax_model, params


def make_replica_server(model, **kwargs):
    engine = ServingEngine(adapter_for(model), num_slots=4, bucket_spec=BucketSpec((8, 16)),
                           max_new_tokens=16, max_queue=32)
    engine.warmup()
    server = ServingServer(engine, model_name="char", **kwargs)
    server.start()
    return server


def port_generate(model, prompt, n, temperature, seed) -> list:
    generator = torch.Generator().manual_seed(seed)
    out = model.generate(torch.tensor([prompt]), n, generator=generator, temperature=temperature)
    return out[0, len(prompt):].tolist()


# ---------------------------------------------------------------------------
# a retried dispatch has the tokens of the single-request reference


@pytest.mark.parametrize("temperature", [0.8, 0.0], ids=["sampled", "greedy"])
def test_retried_dispatch_is_bit_identical_to_reference(trained, temperature):
    """Replica A alone answers a seeded request; A is shut down and the
    same request goes through the router over {dead A, B}: the dial fails,
    the retry re-dispatches to B, and B gives A's tokens - the port's
    ``generate``'s, and greedy, the JAX package's ``generate``'s."""
    _, model, jax_model, params = trained
    server_a, server_b = make_replica_server(model), make_replica_server(model)
    prompt = np.random.RandomState(11).randint(0, 256, size=6).tolist()
    try:
        with ServingClient(server_a.host, server_a.port, timeout_s=30.0) as client:
            reference = client.generate(prompt=prompt, max_new_tokens=8,
                                        temperature=temperature, seed=1234)
        assert reference["event"] == "done"
        server_a.shutdown()
        pool = ReplicaPool([Replica(1, host=server_a.host, port=server_a.port),
                            Replica(2, host=server_b.host, port=server_b.port)],
                           eject_after=1, health_every_s=3600.0)
        core = RouterCore(pool, retries=2, retry_base_delay_s=0.01)
        final = core.handle_generate(
            {"op": "generate", "id": "parity", "prompt": prompt, "max_new_tokens": 8,
             "temperature": temperature, "seed": 1234}, [].append)
        assert final["event"] == "done" and final["attempts"] == 2
        assert final["tokens"] == reference["tokens"]
        assert final["tokens"] == port_generate(model, prompt, 8, temperature, 1234)
        if temperature == 0:
            ref = jax_model.generate(params, jnp.asarray([prompt], jnp.int32), 8,
                                     key=jax.random.PRNGKey(1234), temperature=0.0)
            assert final["tokens"] == np.asarray(ref)[0, len(prompt):].tolist()
        stats = core.stats()
        assert stats["rerouted"] == 1
        assert stats["submitted"] == stats["done"] + stats["errors"]
    finally:
        server_a.shutdown()
        server_b.shutdown()


def test_traced_retry_assembles_across_router_and_replica(trained, tmp_path):
    """A traced request through the router over {dead A, B}, both
    recording into one sidecar family: the tree crosses the router's and
    the replica's sidecars, with a failed and a served ``attempt``."""
    from pytorch_distributed_rnn_tpu_torch.obs.trace import assemble_traces, validate_trace_tree

    _, model, _, _ = trained
    family = tmp_path / "fleet.jsonl"
    replica_rec = MetricsRecorder(family, rank=2, heartbeat_every_s=0.0,
                                  meta={"role": "serve"})
    engine = ServingEngine(adapter_for(model), num_slots=4, bucket_spec=BucketSpec((8, 16)),
                           max_new_tokens=16, recorder=replica_rec)
    engine.warmup()
    server_b = ServingServer(engine, model_name="char", recorder=replica_rec)
    server_b.start()
    dead = make_replica_server(model)
    dead.shutdown()
    router_rec = MetricsRecorder(family, rank=0, heartbeat_every_s=0.0, meta={"role": "router"})
    try:
        pool = ReplicaPool([Replica(1, host=dead.host, port=dead.port),
                            Replica(2, host=server_b.host, port=server_b.port)],
                           eject_after=1, health_every_s=3600.0)
        core = RouterCore(pool, retries=2, retry_base_delay_s=0.01, recorder=router_rec,
                          trace_sample=1.0)
        final = core.handle_generate(
            {"op": "generate", "id": "traced", "prompt": [1, 2, 3], "max_new_tokens": 4,
             "seed": 5}, [].append)
        assert final["event"] == "done" and final["attempts"] == 2
    finally:
        server_b.shutdown()
        router_rec.close()
    trees = assemble_traces([family])
    assert len(trees) == 1
    tree = trees[0]
    validate_trace_tree(tree)
    assert tree.root.name == "route" and len(tree.processes) == 2
    attempts = [c for c in tree.root.children if c.name == "attempt"]
    assert [a.attrs["attempt"] for a in attempts] == [1, 2]
    assert {c.name for c in attempts[1].children} >= {"queue_wait", "prefill", "decode"}
    assert sum(tree.critical_path().values()) == 1.0


# ---------------------------------------------------------------------------
# net:flap


def test_net_flap_drops_open_connections(trained):
    """A ``net:flap:<s>`` server keeps serving but severs every open client
    connection each period."""
    _, model, _, _ = trained
    engine = ServingEngine(adapter_for(model), num_slots=2, bucket_spec=BucketSpec((8,)),
                           max_new_tokens=8, max_queue=8)
    engine.warmup()
    server = ServingServer(engine, model_name="char", flap_s=0.1)
    server.start()
    try:
        client = ServingClient(server.host, server.port, timeout_s=5.0)
        client.ping()
        deadline = time.monotonic() + 10.0
        dropped = False
        while time.monotonic() < deadline:
            try:
                client.ping()
                time.sleep(0.02)
            except (ProtocolError, OSError):
                dropped = True
                break
        assert dropped, "flap never severed the open connection"
        client.close()
        with ServingClient(server.host, server.port, timeout_s=5.0) as again:
            assert again.ping()["event"] == "pong"
    finally:
        server.shutdown()


def test_flap_period_comes_from_the_fault_schedule_env(monkeypatch, trained):
    from pytorch_distributed_rnn_tpu_torch.resilience.faults import FAULT_FLAP_ENV, FaultSchedule

    env = FaultSchedule.parse("net:flap:0.25").network_env()
    assert env == {FAULT_FLAP_ENV: "0.25"}
    monkeypatch.setenv(FAULT_FLAP_ENV, "0.25")
    _, model, _, _ = trained
    engine = ServingEngine(adapter_for(model), num_slots=1, bucket_spec=BucketSpec((8,)),
                           max_new_tokens=2)
    server = ServingServer(engine)
    assert server.flap_s == 0.25
    server.shutdown()


# ---------------------------------------------------------------------------
# kill-mid-burst: the full subprocess drill


@pytest.mark.slow
@pytest.mark.chaos
def test_kill_mid_burst_fleet_drill(trained):
    """Supervised replica subprocesses (``--device cpu``) behind a router
    subprocess, one replica SIGKILLed mid-burst: traffic reroutes, the
    supervisor respawns the corpse into the same port, the degradation
    window closes, and done + shed + errors == submitted on both sides."""
    from pytorch_distributed_rnn_tpu_torch.serving.fleet.drill import run_fleet_drill
    from pytorch_distributed_rnn_tpu_torch.serving.loadgen import LoadConfig

    path, _, _, _ = trained
    report = run_fleet_drill(
        ["--device", "cpu", "--checkpoint", str(path), *REPLICA_FLAGS],
        LoadConfig(requests=60, rate=30.0, prompt_len_max=14, new_tokens_min=4,
                   new_tokens_max=8, temperature=0.8, seed=5, slo_p95_ms=1500.0,
                   timeout_s=120.0, connect_timeout_s=10.0),
        n=2, kill_after_s=1.5, kill_index=1,
        router_args=["--retries", "2", "--eject-after", "2", "--cooldown-s", "0.5",
                     "--health-every-s", "0.2"],
    )
    fleet = report["fleet"]
    assert report["done"] + report["shed"] + report["errors"] == 60
    assert fleet["client_accounting_ok"], report
    assert fleet["router_accounting_ok"], fleet["router"]
    assert fleet["killed_pid"] is not None
    assert fleet["respawns"] >= 1, fleet["supervision"]
    assert fleet["window_closed"], report["degraded_seconds"]
    assert report["done"] > 0 and fleet["router_exit"] == 0
    router = fleet["router"]
    assert router["submitted"] == router["done"] + router["errors"]


def test_router_live_port_file_parsing():
    from pathlib import Path

    from pytorch_distributed_rnn_tpu_torch.serving.fleet.drill import _router_live_port_file

    assert _router_live_port_file(["--retries", "2", "--live-port-file", "/tmp/p"]) == \
        Path("/tmp/p")
    assert _router_live_port_file(["--live-port-file=/tmp/p", "--retries", "2"]) == \
        Path("/tmp/p")
    assert _router_live_port_file(["--retries", "2"]) is None
    assert _router_live_port_file([]) is None
    assert _router_live_port_file(None) is None
    assert _router_live_port_file(["--live-port-file"]) is None


# ---------------------------------------------------------------------------
# the entry points


def test_router_subcommand_runs_the_router(capsys):
    """``serving router`` is the fleet router: its parser (every flag of
    JAX's ``pdrnn-router``), here stopped at the missing replica set."""
    from pytorch_distributed_rnn_tpu.serving.fleet.cli import build_router_parser as jax_parser
    from pytorch_distributed_rnn_tpu_torch.serving.fleet.cli import build_router_parser

    with pytest.raises(SystemExit) as exc:
        serving_main(["router"])
    assert exc.value.code == 2
    assert "--replicas" in capsys.readouterr().err
    flags = {a.dest for a in build_router_parser()._actions}
    assert flags == {a.dest for a in jax_parser()._actions}


def test_loadgen_fleet_flags_parse_and_need_replica_args(capsys):
    args = cli.build_loadgen_parser().parse_args(
        ["--spawn-fleet", "3", "--replica-args", "x", "--router-args", "--retries 2",
         "--fleet-kill-after-s", "2", "--fleet-kill-index", "2"])
    assert (args.spawn_fleet, args.replica_args, args.router_args, args.fleet_kill_after_s,
            args.fleet_kill_index) == (3, "x", "--retries 2", 2.0, 2)
    assert cli.loadgen_main(["--spawn-fleet", "2"]) == 2
    assert "--spawn-fleet needs --replica-args" in capsys.readouterr().err


def test_replica_on_cuda_without_a_card_names_device_cpu(trained):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the no-card failure cannot show")
    path, _, _, _ = trained
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.serve_main(["--checkpoint", str(path), *REPLICA_FLAGS, "--replica-id", "1",
                        "--drain-timeout", "5"])


# ---------------------------------------------------------------------------
# the supervisor against JAX's


class _FakeProc:
    """A process that exits with ``code`` after ``polls`` liveness polls."""

    def __init__(self, code, polls=1):
        self.code, self.polls, self.pid = code, polls, 0

    def is_alive(self):
        self.polls -= 1
        return self.polls >= 0

    @property
    def exitcode(self):
        return None if self.polls >= 0 else self.code

    def terminate(self):
        self.polls = -1

    def join(self, timeout=None):
        pass


def _supervise(module, script):
    """Run ``module.ReplicaSupervisor`` over fake processes whose exit codes
    come from ``script[worker_id]`` in launch order; returns the
    supervision events, the verdict and each slot's exit history."""
    events = []
    codes = {k: list(v) for k, v in script.items()}

    def spawn(rank, worker_id, rejoin):
        return _FakeProc(codes[worker_id].pop(0))

    sup = module.ReplicaSupervisor(
        spawn, min_workers=1, max_respawns=2, respawn_delay_s=0.0, poll_s=0.0,
        on_event=module.supervision_alert_hook(push=lambda kind, **f: events.append((kind, f))))
    sup.launch([1, 2, 3])
    healthy = [sup.poll() for _ in range(6)]
    sup.shutdown(timeout_s=0.1)
    return events, sup.verdict(), {k: s.history for k, s in sup.slots.items()}, healthy


@pytest.mark.parametrize("script", [
    {1: [-9, 0], 2: [0], 3: [1, 1, 1]},
    {1: [-9, -9, -9], 2: [-9, -9, -9], 3: [-9, -9, -9]},
], ids=["respawn-and-exhaust", "collapse"])
def test_replica_supervisor_matches_jax(script):
    port = _supervise(supervisor, script)
    assert port == _supervise(jax_supervisor, script)
    events, verdict, _history, _healthy = port
    assert verdict["respawns"] >= 2
    assert {kind for kind, _ in events} >= {"worker_respawn", "worker_lost"}


def test_supervision_alert_hook_records_and_flushes(tmp_path):
    from pytorch_distributed_rnn_tpu_torch.obs.summary import load_events

    assert supervisor.supervision_alert_hook() is None
    recorder = MetricsRecorder(tmp_path / "sup.jsonl", heartbeat_every_s=0.0)
    hook = supervisor.supervision_alert_hook(recorder=recorder)
    hook("worker_respawn", worker_id=1, exit_code=-9)
    # flushed at once: a SIGKILL of the supervisor's process right after
    # would not lose it
    kinds = [e["kind"] for e in load_events(tmp_path / "sup.jsonl")]
    assert "worker_respawn" in kinds
    recorder.close()
