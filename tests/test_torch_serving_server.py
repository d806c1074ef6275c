"""The port's serving over TCP on the CPU (``pytorch_distributed_rnn_tpu_
torch/serving/{server,protocol,cli,drill}.py``): a checkpoint of a char LM
that the port trained a few Adam steps behind the JSON-lines server, the
JAX package's socket-level cases (``tests/test_serving_server.py``;
its telemetry ones are in ``tests/test_torch_serving_telemetry.py``).  Each served request matches the port's
single-request ``generate``.  No JAX here: the ``cuda`` case runs on the
card with ``python -m pytest --noconftest -m cuda
tests/test_torch_serving_server.py``."""

import json
import socket
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from pytorch_distributed_rnn_tpu_torch.data import generate_char_tokens
from pytorch_distributed_rnn_tpu_torch.models import CharRNN
from pytorch_distributed_rnn_tpu_torch.obs.tracectx import TraceContext
from pytorch_distributed_rnn_tpu_torch.serving import cli
from pytorch_distributed_rnn_tpu_torch.serving.__main__ import main as serving_main
from pytorch_distributed_rnn_tpu_torch.serving.adapters import adapter_for
from pytorch_distributed_rnn_tpu_torch.serving.buckets import BucketSpec
from pytorch_distributed_rnn_tpu_torch.serving.engine import ServingEngine
from pytorch_distributed_rnn_tpu_torch.serving.protocol import (
    ServingClient,
    decode_line,
    encode_line,
)
from pytorch_distributed_rnn_tpu_torch.serving.scheduler import ServeRequest
from pytorch_distributed_rnn_tpu_torch.serving.server import ServingServer
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import (
    CheckpointCorruptError,
    find_latest_checkpoint,
    load_model_params,
    save_checkpoint,
)

ROOT = Path(__file__).resolve().parent.parent
WIDTH = 24
MODEL_FLAGS = ["--model", "char", "--vocab-size", "256", "--hidden-units", str(WIDTH),
               "--stacked-layer", "2"]


def make_model() -> CharRNN:
    return CharRNN(vocab_size=256, embed_dim=WIDTH, hidden_dim=WIDTH, layer_dim=2, impl="scan")


@pytest.fixture(scope="module")
def trained_checkpoint(tmp_path_factory):
    """A real checkpoint: the char LM trained 25 Adam steps on the
    synthetic motif stream, written through the trainers' checkpoint
    path.  Returns its path and the trained model."""
    torch.manual_seed(0)
    model = make_model()
    tokens = torch.from_numpy(generate_char_tokens(32, 33, vocab_size=256, seed=0)).long()
    optimizer = torch.optim.Adam(model.parameters(), lr=5e-3)
    for _ in range(25):
        loss = model.loss(tokens)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
    path = save_checkpoint(tmp_path_factory.mktemp("serve-ckpt"), 0, model.state_dict(),
                           optimizer.state_dict(), loss.item())
    return path, model.eval()


def make_server(model, **engine_kwargs):
    defaults = dict(num_slots=6, bucket_spec=BucketSpec((8, 16)), max_new_tokens=16,
                    max_queue=64)
    defaults.update(engine_kwargs)
    engine = ServingEngine(adapter_for(model), **defaults)
    engine.warmup()
    return ServingServer(engine, model_name="char")


def reference(model, spec) -> list:
    generator = torch.Generator(device=model.embed.device).manual_seed(spec["seed"])
    prompt = torch.tensor([spec["prompt"]], device=model.embed.device)
    out = model.generate(prompt, spec["max_new_tokens"], generator=generator,
                         temperature=spec["temperature"])
    return out[0, len(spec["prompt"]):].tolist()


# ---------------------------------------------------------------------------
# checkpoint -> serving model


def test_load_model_params_round_trips_and_rejects_damage(trained_checkpoint, tmp_path):
    path, trained = trained_checkpoint
    model = make_model()
    meta = load_model_params(path, model)
    assert meta["epoch"] == 1
    for (name, a), b in zip(model.state_dict().items(), trained.state_dict().values()):
        assert torch.equal(a, b), name
    clipped = tmp_path / "clipped.ckpt"
    clipped.write_bytes(path.read_bytes()[:-20])
    with pytest.raises(CheckpointCorruptError):
        load_model_params(clipped, make_model())
    # a flipped byte in the optimizer section fails the load too, though
    # the serving loader never deserializes that section
    damaged = tmp_path / "damaged.ckpt"
    blob = bytearray(path.read_bytes())
    blob[-5] ^= 0xFF
    damaged.write_bytes(bytes(blob))
    with pytest.raises(CheckpointCorruptError, match="opt section CRC"):
        load_model_params(damaged, make_model())
    with pytest.raises(CheckpointCorruptError, match="does not fit"):
        load_model_params(path, CharRNN(vocab_size=256, embed_dim=8, hidden_dim=8, layer_dim=2))


def test_find_latest_checkpoint_orders_and_skips_corrupt_files(trained_checkpoint, tmp_path):
    path, _ = trained_checkpoint
    for name in ("checkpoint-epoch-2.ckpt", "checkpoint-epoch-10.ckpt", "best-model.ckpt"):
        (tmp_path / name).write_bytes(path.read_bytes())
    (tmp_path / "checkpoint-epoch-11.ckpt").write_bytes(path.read_bytes()[:100])
    assert find_latest_checkpoint(tmp_path) == tmp_path / "checkpoint-epoch-10.ckpt"
    for name in ("checkpoint-epoch-10.ckpt", "checkpoint-epoch-2.ckpt"):
        (tmp_path / name).unlink()
    assert find_latest_checkpoint(tmp_path) == tmp_path / "best-model.ckpt"
    assert find_latest_checkpoint(tmp_path / "missing") is None


# ---------------------------------------------------------------------------
# end to end: a real checkpoint, 50 concurrent mixed requests


def test_e2e_50_concurrent_requests_match_reference(trained_checkpoint):
    path, _ = trained_checkpoint
    args = cli.build_serve_parser().parse_args(
        ["--device", "cpu", "--checkpoint", str(path.parent), *MODEL_FLAGS])
    model, meta = cli.load_served_model(args)
    assert meta["epoch"] == 1
    gen = torch.Generator().manual_seed(0)
    specs = [{
        "prompt": torch.randint(0, 256, (int(torch.randint(1, 13, (1,), generator=gen)),),
                                generator=gen).tolist(),
        "max_new_tokens": [4, 8][i % 2], "temperature": [0.0, 0.9][i % 2], "seed": 5000 + i,
    } for i in range(50)]
    replies = [None] * len(specs)

    with make_server(model) as server:
        def fire(i):
            with ServingClient(server.host, server.port) as client:
                replies[i] = client.generate(request_id=str(i), **specs[i])

        threads = [threading.Thread(target=fire, args=(i,), daemon=True)
                   for i in range(len(specs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        stats = server.engine.stats()

    assert all(r is not None for r in replies), "requests timed out"
    for i, (spec, reply) in enumerate(zip(specs, replies)):
        assert reply["event"] == "done", (i, reply)
        assert reply["tokens"] == reference(model, spec), f"request {i} diverged"
        assert reply["latency_ms"] >= 0 and reply["ttft_ms"] is not None
    assert stats["requests"] == 50 and stats["requests_shed"] == 0
    assert stats["trace_counts"] == {"prefill": 2, "step": 1, "join": 1}


# ---------------------------------------------------------------------------
# protocol behaviours


def test_streaming_tokens_arrive_in_order(trained_checkpoint):
    _, model = trained_checkpoint
    with make_server(model) as server:
        streamed = []
        with ServingClient(server.host, server.port) as client:
            reply = client.generate(prompt=[1, 2, 3], max_new_tokens=6, temperature=0.0,
                                    stream=True,
                                    on_token=lambda idx, tok: streamed.append((idx, tok)))
    assert reply["event"] == "done"
    assert [idx for idx, _ in streamed] == list(range(6))
    assert [tok for _, tok in streamed] == reply["tokens"]


def test_text_prompt_round_trip(trained_checkpoint):
    _, model = trained_checkpoint
    with make_server(model) as server:
        with ServingClient(server.host, server.port) as client:
            reply = client.generate(text="hello", max_new_tokens=4, temperature=0.0, seed=3)
    assert reply["event"] == "done"
    assert reply["tokens"] == reference(model, {"prompt": list(b"hello"), "max_new_tokens": 4,
                                                "temperature": 0.0, "seed": 3})
    assert isinstance(reply["text"], str) and len(reply["text"]) == 4


def test_ping_stats_and_bad_requests(trained_checkpoint):
    _, model = trained_checkpoint
    with make_server(model) as server:
        with ServingClient(server.host, server.port) as client:
            pong = client.ping()
            assert (pong["vocab_size"], pong["slots"], pong["prompt_buckets"]) == (256, 6,
                                                                                   [8, 16])
            reply = client.request({"op": "nope"})
            assert reply["event"] == "error" and "unknown op" in reply["error"]
            reply = client.generate(prompt=[999], max_new_tokens=2)
            assert reply["event"] == "error" and "prompt ids" in reply["error"]
            reply = client.generate(prompt=list(range(20)), max_new_tokens=2)
            assert reply["event"] == "error" and "bucket" in reply["error"]
            # a bigint seed is rejected at submit, not on the engine thread
            reply = client.generate(prompt=[1], max_new_tokens=2, seed=2 ** 64)
            assert reply["event"] == "error" and "seed" in reply["error"]
            reply = client.generate(prompt=[1], max_new_tokens=2)
            assert reply["event"] == "done"
            client.sock.sendall(b"not json\n")
            assert client._recv()["event"] == "error"
            stats = client.stats()
            assert stats["event"] == "stats" and stats["tokens_out"] == 2
            assert "trace_counts" not in stats


def test_overload_sheds_with_explicit_error(trained_checkpoint):
    """A pipelined burst far past slots + queue depth is answered with
    explicit shed errors while the admitted requests complete."""
    _, model = trained_checkpoint
    with make_server(model, num_slots=1, max_queue=2) as server:
        sock = socket.create_connection((server.host, server.port), timeout=60.0)
        rfile = sock.makefile("r", encoding="utf-8")
        burst = 12
        for i in range(burst):
            sock.sendall(encode_line({"op": "generate", "id": str(i), "prompt": [1, 2],
                                      "max_new_tokens": 16, "temperature": 0.0}))
        done = shed = 0
        while done + shed < burst:
            reply = decode_line(rfile.readline())
            if reply["event"] == "done":
                done += 1
            else:
                assert reply.get("shed") is True, reply
                shed += 1
        rfile.close()
        sock.close()
    assert shed > 0 and done >= 1


def test_drain_finishes_in_flight_work_and_rejects_new(trained_checkpoint):
    """``shutdown(drain=True)``: a request decoding when the drain starts
    completes; a generate that arrives while draining gets an explicit
    rejection."""
    _, model = trained_checkpoint
    server = make_server(model, max_new_tokens=128)
    server.start()
    sock = socket.create_connection((server.host, server.port), timeout=60.0)
    rfile = sock.makefile("r", encoding="utf-8")
    sock.sendall(encode_line({"op": "generate", "id": "a", "prompt": [1, 2],
                              "max_new_tokens": 128, "stream": True}))
    assert decode_line(rfile.readline())["event"] == "token"
    drain = threading.Thread(target=server.shutdown, kwargs={"drain": True}, daemon=True)
    drain.start()
    assert server._draining.wait(timeout=10.0)
    sock.sendall(encode_line({"op": "generate", "id": "b", "prompt": [3],
                              "max_new_tokens": 2}))
    finals = {}
    while len(finals) < 2:
        reply = decode_line(rfile.readline())
        if reply["event"] != "token":
            finals[reply["id"]] = reply
    drain.join(timeout=30.0)
    rfile.close()
    sock.close()
    assert not drain.is_alive()
    assert finals["a"]["event"] == "done" and finals["a"]["token_count"] == 128
    assert finals["b"]["event"] == "error" and finals["b"]["draining"] is True


def test_request_ids_are_unique_and_traces_ride_the_request(trained_checkpoint):
    _, model = trained_checkpoint
    traces = []
    with make_server(model) as server:
        submit = server.engine.submit

        def spy(request):
            traces.append(request.trace)
            return submit(request)

        server.engine.submit = spy
        with ServingClient(server.host, server.port) as a, \
                ServingClient(server.host, server.port) as b:
            replies = [a.generate(prompt=[1], max_new_tokens=2),
                       a.generate(prompt=[1], max_new_tokens=2),
                       b.generate(prompt=[1], max_new_tokens=2)]
            minted = TraceContext.minted
            traced = a.generate(prompt=[5, 6], max_new_tokens=3,
                                trace=TraceContext.mint(qos="high"))
            mine = b.generate(prompt=[1], max_new_tokens=2, request_id="mine")
    assert all(r["event"] == "done" for r in replies + [traced, mine])
    ids = [r["id"] for r in replies]
    assert len(set(ids)) == 3 and "0" not in ids
    assert mine["id"] == "mine"
    assert traces[:3] == [None] * 3  # untraced requests construct no context
    assert traces[3].baggage == {"qos": "high"} and TraceContext.minted == minted + 2


# ---------------------------------------------------------------------------
# the CLI: the drill, the rejected model family, the device


def test_drill_through_the_loadgen_cli(trained_checkpoint, tmp_path):
    """``loadgen --spawn-server``: a server subprocess from the checkpoint
    directory, 24 Poisson requests, SIGTERM; no errors, exit code 0."""
    path, _ = trained_checkpoint
    report_path = tmp_path / "report.json"
    serve_args = ["--device", "cpu", "--checkpoint", str(path.parent), *MODEL_FLAGS,
                  "--slots", "4", "--prompt-buckets", "8,16", "--max-new-tokens", "16"]
    out = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.serving", "loadgen",
         "--spawn-server", " ".join(serve_args), "--requests", "24", "--rate", "40",
         "--prompt-len-max", "14", "--new-tokens-max", "10", "--seed", "3",
         "--report", str(report_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    report = json.loads(report_path.read_text())
    assert report["server_exit"] == 0
    assert (report["done"], report["errors"], report["shed"]) == (24, 0, 0)
    assert "server exit code: 0" in out.stdout


@pytest.mark.parametrize("argv,reason", [
    (["--model", "moe"], "A9"),
], ids=lambda v: v[0] if isinstance(v, list) else None)
def test_serve_rejects_unported_flags(argv, reason, tmp_path):
    with pytest.raises(SystemExit, match=reason):
        cli.serve_main(["--device", "cpu", "--checkpoint", str(tmp_path), *argv])


def test_router_is_rejected():
    """The usage check: no subcommand is a usage error (``router`` itself
    runs the fleet router, ``tests/test_torch_fleet.py``)."""
    assert serving_main([]) == 2


def test_cuda_without_a_card_names_device_cpu(trained_checkpoint):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the no-card failure cannot show")
    path, _ = trained_checkpoint
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.serve_main(["--checkpoint", str(path), *MODEL_FLAGS])


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the engine's CUDA graphs have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_cuda_engine_matches_generate(cuda_device, trained_checkpoint):
    """The engine's captured prefill and step graphs on the card: 12 mixed
    requests through 4 slots have the tokens of their single-request
    ``generate`` on the card, with four captures and none after warm-up."""
    _, trained = trained_checkpoint
    model = make_model()
    model.load_state_dict(trained.state_dict())
    model = model.to(cuda_device).eval()
    engine = ServingEngine(adapter_for(model), num_slots=4, bucket_spec=BucketSpec((8, 16)),
                           max_new_tokens=16)
    engine.warmup()
    snapshot = engine.retrace_snapshot()
    assert snapshot == {"prefill": 2, "step": 1, "join": 1}
    gen = torch.Generator().manual_seed(1)
    specs = [{"prompt": torch.randint(0, 256, (1 + i,), generator=gen).tolist(),
              "max_new_tokens": 4 + i, "temperature": [0.0, 0.7, 1.0][i % 3],
              "seed": 100 + i} for i in range(12)]
    requests = [ServeRequest(id=str(i), **spec) for i, spec in enumerate(specs)]
    for r in requests:
        assert engine.submit(r), r.error
    engine.drain()
    assert engine.retraces_since(snapshot) == {}
    for spec, r in zip(specs, requests):
        assert r.status == "done" and r.tokens == reference(model, spec), r.id


@pytest.mark.cuda
def test_cuda_engine_calls_a_step_and_a_join(cuda_device, trained_checkpoint):
    """On the card a decode step is one replay and one result copy, the
    draws inside the step graph (at most 4 Python->torch calls); a join is
    the staging row's copy and two replays.  Counted by ``TorchCalls``
    over 8 mixed requests through 4 slots, whose tokens equal
    ``generate``'s on the card."""
    from pytorch_distributed_rnn_tpu_torch.serving.engine import TorchCalls

    _, trained = trained_checkpoint
    model = make_model()
    model.load_state_dict(trained.state_dict())
    model = model.to(cuda_device).eval()
    engine = ServingEngine(adapter_for(model), num_slots=4, bucket_spec=BucketSpec((8, 16)),
                           max_new_tokens=16)
    engine.warmup()
    gen = torch.Generator().manual_seed(2)
    specs = [{"prompt": torch.randint(0, 256, (2 + i,), generator=gen).tolist(),
              "max_new_tokens": 6 + i, "temperature": [0.0, 0.7, 1.0][i % 3],
              "seed": 200 + i} for i in range(8)]
    requests = [ServeRequest(id=str(i), **spec) for i, spec in enumerate(specs)]
    for r in requests:
        assert engine.submit(r), r.error
    steps = 0
    with torch.no_grad(), TorchCalls(engine) as calls:
        while engine.batcher.has_work:
            steps += engine.run_step(wait_s=0.0)
    assert steps > 0
    assert dict(calls.counts) == {"join": 3 * len(requests), "step": steps, "result": steps}
    assert calls.counts["step"] + calls.counts["result"] <= 4 * steps
    for spec, r in zip(specs, requests):
        assert r.status == "done" and r.tokens == reference(model, spec), r.id
