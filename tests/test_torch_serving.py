"""The port's serving engine and adapters (``pytorch_distributed_rnn_tpu_
torch/serving/{adapters,engine}.py``) on the CPU, in process.

Against the JAX package (weights carried over by ``interop``): the
adapters' prefill and step, and ``masked_rnn_prefill``, within 1e-5 of
JAX's; the port engine's greedy tokens equal to the JAX engine's on the
same requests; a JAX-written checkpoint refused.  Within the port (the
JAX engine's cases, ``tests/test_serving.py``): every request served
through 4 slots has the tokens of its single-request ``generate``, greedy
and sampled, with its first-step logits within 1e-5 of ``generate``'s;
staggered joins; no program run for the first time after warm-up (the
CPU form of "no capture"); rejections; the context budget; a non-finite
logit failing only its request; ``close`` and ``_recover``; ``stats``
polled with no pause under a running loop, alone and beside a thread
spinning in Python; the Python->torch calls of a decode step and a join
(``TorchCalls``), pinned."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_rnn_tpu.models import AttentionLM as JaxAttentionLM
from pytorch_distributed_rnn_tpu.models import CharRNN as JaxCharRNN
from pytorch_distributed_rnn_tpu.serving import adapters as jax_adapters
from pytorch_distributed_rnn_tpu.serving.buckets import BucketSpec as JaxBucketSpec
from pytorch_distributed_rnn_tpu.serving.engine import ServingEngine as JaxServingEngine
from pytorch_distributed_rnn_tpu.serving.scheduler import ServeRequest as JaxServeRequest
from pytorch_distributed_rnn_tpu.training.checkpoint import save_checkpoint as jax_save
from pytorch_distributed_rnn_tpu_torch import interop
from pytorch_distributed_rnn_tpu_torch.models import AttentionLM, CharRNN
from pytorch_distributed_rnn_tpu_torch.serving.adapters import adapter_for, masked_rnn_prefill
from pytorch_distributed_rnn_tpu_torch.serving.buckets import BucketSpec
from pytorch_distributed_rnn_tpu_torch.serving.engine import ServingEngine, TorchCalls, _flat
from pytorch_distributed_rnn_tpu_torch.serving.scheduler import ServeRequest
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import (
    CheckpointCorruptError,
    load_model_params,
)

F32_FWD = 1e-5
VOCAB = 48
FAMILIES = ["char-lstm", "char-gru", "attention"]


def _pair(family: str, seed: int = 1):
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


def mixed_requests(n, rng, max_prompt=15, max_new=12, vocab=VOCAB, cls=ServeRequest):
    requests = []
    for i in range(n):
        plen = int(rng.randint(1, max_prompt + 1))
        requests.append(cls(
            prompt=rng.randint(0, vocab, size=plen).tolist(),
            max_new_tokens=int(rng.randint(1, max_new + 1)),
            temperature=[0.0, 0.7, 1.0][i % 3],
            seed=1000 + i, id=str(i),
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
        assert r.tokens == reference_tokens(model, r), (
            f"request {r.id} (temp {r.temperature}) diverged from its single-request generate")


# ---------------------------------------------------------------------------
# the adapters against the JAX package's


@pytest.mark.parametrize("family", FAMILIES)
def test_adapters_prefill_and_step_match_jax(family):
    """Three bucket-padded prompts of lengths 5, 8, 1 through both
    packages' adapter prefill, then two batched steps at per-row
    positions: state and logits within 1e-5."""
    jax_model, params, model = _pair(family, seed=2)
    jax_adapter, adapter = jax_adapters.adapter_for(jax_model), adapter_for(model)
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, VOCAB, size=(3, 8)).astype(np.int32)
    length = np.array([5, 8, 1], np.int32)
    jax_prefill = jax.jit(jax_adapter.prefill)
    jax_step = jax.jit(jax_adapter.step)
    jax_state, jax_logits = jax_prefill(params, jnp.asarray(prompt), jnp.asarray(length))
    with torch.no_grad():
        state, logits = adapter.prefill(torch.from_numpy(prompt), torch.from_numpy(length))
        pos = length.copy()
        for step in range(3):
            np.testing.assert_allclose(logits.numpy(), np.asarray(jax_logits), rtol=F32_FWD,
                                       atol=F32_FWD, err_msg=f"logits, step {step}")
            got, want = _flat(state), jax.tree.leaves(jax_state)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_FWD, atol=F32_FWD)
            tok = rng.randint(0, VOCAB, size=3).astype(np.int32)
            state, logits = adapter.step(state, torch.from_numpy(tok), torch.from_numpy(pos))
            jax_state, jax_logits = jax_step(params, jax_state, jnp.asarray(tok),
                                             jnp.asarray(pos))
            pos = pos + 1


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_masked_rnn_prefill_matches_jax(cell):
    _, params, model = _pair(f"char-{cell}", seed=4)
    rng = np.random.RandomState(5)
    embeds = rng.randn(2, 8, 16).astype(np.float32)
    length = np.array([3, 8], np.int32)
    want_carries, want_h = jax_adapters.masked_rnn_prefill(
        params["rnn"], jnp.asarray(embeds), jnp.asarray(length), cell)
    with torch.no_grad():
        carries, last_h = masked_rnn_prefill(list(model.rnn), torch.from_numpy(embeds),
                                             torch.from_numpy(length), cell)
    np.testing.assert_allclose(last_h.numpy(), np.asarray(want_h), rtol=F32_FWD, atol=F32_FWD)
    got, want = _flat(carries), jax.tree.leaves(want_carries)
    assert len(got) == len(want) == (4 if cell == "lstm" else 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_FWD, atol=F32_FWD)


def test_adapter_for_rejects_other_models():
    with pytest.raises(TypeError, match="A9"):
        adapter_for(torch.nn.Linear(2, 2))


# ---------------------------------------------------------------------------
# the engine against the JAX engine


@pytest.mark.parametrize("family", ["char-lstm", "attention"])
def test_greedy_tokens_match_the_jax_engine(family):
    """The same greedy requests through both engines (4 slots, buckets 8
    and 16, the same weights): the same tokens."""
    jax_model, params, model = _pair(family, seed=6)
    specs = [(r.prompt, r.max_new_tokens) for r in
             mixed_requests(10, np.random.RandomState(7))]
    jax_engine = JaxServingEngine(jax_adapters.adapter_for(jax_model), params, num_slots=4,
                                  bucket_spec=JaxBucketSpec((8, 16)), max_new_tokens=12)
    engine = make_engine(model)
    served = []
    for eng, cls in ((jax_engine, JaxServeRequest), (engine, ServeRequest)):
        eng.warmup()
        requests = [cls(prompt=p, max_new_tokens=n, temperature=0.0, id=str(i))
                    for i, (p, n) in enumerate(specs)]
        for r in requests:
            assert eng.submit(r), r.error
        eng.drain()
        assert all(r.status == "done" for r in requests)
        served.append([r.tokens for r in requests])
    assert served[1] == served[0]


def test_jax_written_checkpoint_is_refused(tmp_path):
    jax_model, params, model = _pair("char-lstm")
    path = jax_save(tmp_path, 0, params, optax.adam(1e-3).init(params), 1.0)
    with pytest.raises(CheckpointCorruptError, match="A6"):
        load_model_params(path, model)


# ---------------------------------------------------------------------------
# a request in the batch against its single-request generate


@pytest.mark.parametrize("family", FAMILIES)
def test_mixed_stream_matches_reference_decodes(family):
    """9 mixed-length, mixed-temperature requests through 4 slots: every
    response has the tokens of its single-request ``generate`` (greedy and
    seeded sampling), and the logits it joined with are within 1e-5 of
    ``generate``'s first-step logits."""
    _, _, model = _pair(family)
    engine = make_engine(model)
    engine.warmup()
    first_logits = {}
    join = engine._join

    def spy(slot, seq_state, seq_logits, length, temperature, seed):
        first_logits[seed] = seq_logits[0].clone()
        join(slot, seq_state, seq_logits, length, temperature, seed)

    engine._join = spy
    requests = mixed_requests(9, np.random.RandomState(0))
    for r in requests:
        assert engine.submit(r), r.error
    engine.drain()
    assert_matches_reference(model, requests)
    with torch.no_grad():
        for r in requests:
            want = model(torch.tensor([r.prompt]))[0, -1]
            np.testing.assert_allclose(first_logits[r.seed].numpy(), want.numpy(),
                                       rtol=F32_FWD, atol=F32_FWD)


def test_staggered_joins_do_not_restart_decode():
    """Requests submitted while the batch decodes join at step boundaries;
    earlier slots' outputs are unaffected."""
    _, _, model = _pair("char-lstm")
    engine = make_engine(model, num_slots=2)
    engine.warmup()
    first = mixed_requests(2, np.random.RandomState(1))
    for r in first:
        engine.submit(r)
    for _ in range(3):
        engine.run_step(wait_s=0.0)
    late = mixed_requests(4, np.random.RandomState(2))
    for i, r in enumerate(late):
        r.id, r.seed = f"late-{i}", 2000 + i
        engine.submit(r)
    engine.drain()
    assert_matches_reference(model, first + late)


# ---------------------------------------------------------------------------
# programs: none made after warm-up


@pytest.mark.parametrize("family", FAMILIES)
def test_no_program_after_warmup_on_mixed_stream(family):
    _, _, model = _pair(family)
    engine = make_engine(model)
    engine.warmup()
    snapshot = engine.retrace_snapshot()
    assert snapshot == {"prefill": 2, "step": 1, "join": 1}
    for r in mixed_requests(16, np.random.RandomState(3)):
        engine.submit(r)
    engine.drain()
    assert engine.retraces_since(snapshot) == {}
    assert engine.stats()["trace_counts"] == snapshot


def test_without_warmup_each_program_is_made_at_first_use():
    _, _, model = _pair("char-gru")
    engine = make_engine(model)
    requests = [ServeRequest(prompt=[1, 2], max_new_tokens=3, seed=1),
                ServeRequest(prompt=[3] * 12, max_new_tokens=2, temperature=0.9, seed=2)]
    engine.submit(requests[0])
    engine.drain()
    assert engine.retrace_snapshot() == {"prefill": 1, "step": 1, "join": 1}
    engine.submit(requests[1])
    engine.drain()
    assert engine.retrace_snapshot() == {"prefill": 2, "step": 1, "join": 1}
    assert_matches_reference(model, requests)


def test_oversized_prompt_and_new_tokens_are_rejected_without_a_program():
    _, _, model = _pair("char-lstm")
    engine = make_engine(model)
    engine.warmup()
    snapshot = engine.retrace_snapshot()
    too_long = ServeRequest(prompt=list(range(17)), max_new_tokens=4)
    assert not engine.submit(too_long)
    assert too_long.status == "error" and "exceeds the largest bucket" in too_long.error
    too_many = ServeRequest(prompt=[1], max_new_tokens=99)
    assert not engine.submit(too_many)
    assert "max_new_tokens" in too_many.error
    cold = ServeRequest(prompt=[1], max_new_tokens=2, temperature=-0.5)
    assert not engine.submit(cold) and "temperature" in cold.error
    huge = ServeRequest(prompt=[1], max_new_tokens=2, seed=2 ** 64)
    assert not engine.submit(huge) and "seed" in huge.error
    assert engine.retraces_since(snapshot) == {}
    assert engine.batcher.queue_depth == 0


def test_attention_context_budget_is_validated_at_construction():
    model = AttentionLM(vocab_size=VOCAB, dim=16, depth=1, num_heads=2, max_len=32)
    with pytest.raises(ValueError, match="context bound"):
        ServingEngine(adapter_for(model), bucket_spec=BucketSpec((16,)), max_new_tokens=32)
    ServingEngine(adapter_for(model), bucket_spec=BucketSpec((16,)), max_new_tokens=16)


# ---------------------------------------------------------------------------
# failures stay with their request


@pytest.mark.parametrize("family", ["char-lstm", "attention"])
def test_non_finite_logits_fail_only_their_request(family):
    """A slot whose logits turn NaN (a poisoned checkpoint's symptom) fails
    its request with an explicit error; its neighbour completes with its
    reference tokens and the engine keeps serving."""
    _, _, model = _pair(family)
    engine = make_engine(model, num_slots=2)
    engine.warmup()
    poisoned = ServeRequest(prompt=[1, 2, 3], max_new_tokens=12, temperature=0.7, seed=9)
    healthy = ServeRequest(prompt=[4, 5], max_new_tokens=12, temperature=1.0, seed=10)
    for r in (poisoned, healthy):
        assert engine.submit(r)
    engine.run_step()  # both join and decode one token
    engine.logits[poisoned.slot, 3] = float("nan")
    engine.drain()
    assert poisoned.status == "error" and "non-finite" in poisoned.error
    assert len(poisoned.tokens) == 1
    assert_matches_reference(model, [healthy])
    assert engine.stats()["requests_failed"] == 1
    fresh = mixed_requests(3, np.random.RandomState(9))
    for r in fresh:
        engine.submit(r)
    engine.drain()
    assert_matches_reference(model, fresh)


def test_close_fails_in_flight_and_queued_requests():
    _, _, model = _pair("char-lstm")
    engine = make_engine(model, num_slots=2)
    engine.warmup()
    requests = mixed_requests(3, np.random.RandomState(13))
    for r in requests:
        r.max_new_tokens = 12
        assert engine.submit(r)
    engine.run_step()  # two join and start decoding, one waits
    done_events = []
    for r in requests:
        r.on_done = lambda req: done_events.append(req.id)
    engine.close()
    assert sorted(done_events) == sorted(r.id for r in requests)
    assert all(r.status == "error" for r in requests)
    assert sorted(r.error for r in requests) == ["server shut down mid-decode"] * 2 + [
        "server shutting down"]
    assert engine.stats()["requests_failed"] == 2
    engine.close()  # idempotent


def test_recover_fails_in_flight_requests_and_serves_on():
    _, _, model = _pair("attention")
    engine = make_engine(model, num_slots=2)
    engine.warmup()
    requests = mixed_requests(2, np.random.RandomState(14))
    for r in requests:
        r.max_new_tokens = 12
        assert engine.submit(r)
    engine.run_step()
    engine._recover()
    assert all(r.status == "error" and "internal decode error" in r.error for r in requests)
    assert engine.stats()["requests_failed"] == 2
    assert not engine.logits.any() and not engine.state["k"].any()
    fresh = mixed_requests(2, np.random.RandomState(15))
    for i, r in enumerate(fresh):
        r.id = f"fresh-{i}"
        assert engine.submit(r)
    engine.drain()
    assert_matches_reference(model, fresh)


# ---------------------------------------------------------------------------
# threads: submit and stats while the engine loop runs


def _serve_from_threads(spin: bool):
    """10 mixed requests submitted from a thread to an engine loop thread
    through 2 slots of the char GRU, ``stats()`` polled with no pause
    meanwhile (the reference test's loop, ``tests/test_serving.py``) and,
    with ``spin``, a thread beside them that never blocks and touches no
    engine lock: every request completes within 60 s with its reference
    tokens."""
    _, _, model = _pair("char-gru")
    engine = make_engine(model, num_slots=2, max_queue=64)
    engine.warmup()
    stop = threading.Event()
    spinner = None
    if spin:
        def spin_loop():
            n = 0
            while not stop.is_set():
                n += 1

        spinner = threading.Thread(target=spin_loop, daemon=True)
        spinner.start()
    loop = threading.Thread(target=engine.serve_forever, args=(stop,), daemon=True)
    loop.start()
    requests = mixed_requests(10, np.random.RandomState(12))
    submitter = threading.Thread(target=lambda: [engine.submit(r) for r in requests],
                                 daemon=True)
    submitter.start()
    deadline = time.perf_counter() + 60.0
    while engine.stats()["requests"] < len(requests) and time.perf_counter() < deadline:
        pass
    stop.set()
    loop.join(timeout=10.0)
    submitter.join(timeout=10.0)
    if spinner is not None:
        spinner.join(timeout=10.0)
    assert not loop.is_alive() and not submitter.is_alive()
    stats = engine.stats()
    assert stats["requests"] == len(requests) and stats["tokens_out"] == sum(
        r.max_new_tokens for r in requests)
    assert stats["latency_s_p95"] >= stats["latency_s_p50"] > 0
    assert_matches_reference(model, requests)


def test_stats_is_safe_while_the_engine_appends():
    """stats() from other threads while the engine thread appends: never
    raises, and every request submitted from another thread completes with
    its reference tokens, while the polling thread spins in Python."""
    _serve_from_threads(spin=False)


def test_engine_keeps_serving_beside_a_spinning_thread():
    """The same beside a second thread spinning in Python: the engine's
    few calls a step each wait out one switch interval at most."""
    _serve_from_threads(spin=True)


# ---------------------------------------------------------------------------
# Python->torch calls: a busy thread costs the engine one switch interval
# (5 ms) at each, so a step and a join make a fixed few

STEP_CALLS = {"draw": 1, "step": 1, "result": 1}  # draw only where a slot samples
JOIN_CALLS = 2  # the prefill and the join programs


@pytest.mark.parametrize("family", FAMILIES)
def test_python_torch_calls_a_step_and_a_join_are_pinned(family):
    """Counted by ``TorchCalls`` (the mode's calls plus the programs):
    each decode step makes one traced step call, one result copy and, when
    a slot samples, one scripted draw; each join makes two calls (the
    prefill and the join programs) whatever the bucket; nothing else."""
    _, _, model = _pair(family)
    engine = make_engine(model, num_slots=2)
    engine.warmup()
    requests = mixed_requests(6, np.random.RandomState(21))
    for r in requests:
        assert engine.submit(r)
    steps = 0
    with torch.no_grad(), TorchCalls(engine) as calls:
        while engine.batcher.has_work:
            before = dict(calls.counts)
            waiting = [r for r in requests if r.service_tm is None]
            tokens = [len(r.tokens) for r in requests]
            steps += engine.run_step(wait_s=0.0)
            joined = sum(r.service_tm is not None for r in waiting)
            decoded = [r for r, n in zip(requests, tokens) if len(r.tokens) > n]
            want = {"join": JOIN_CALLS * joined, "step": STEP_CALLS["step"],
                    "result": STEP_CALLS["result"],
                    "draw": STEP_CALLS["draw"] * any(r.temperature > 0 for r in decoded)}
            made = {k: v - before.get(k, 0) for k, v in calls.counts.items()}
            assert {k: v for k, v in made.items() if v} == {k: v for k, v in want.items() if v}
    assert steps > 0 and all(r.service_tm is not None for r in requests)
    assert_matches_reference(model, requests)
