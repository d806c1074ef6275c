"""The serving scheduler core and bucket policy of the port
(``pytorch_distributed_rnn_tpu_torch/serving/{buckets,scheduler}.py``):
the JAX package's cases (``tests/test_serving_scheduler.py``), each run on
both packages; then the wire protocol's bytes and the load generator's
seeded plan against the JAX package's.  Pure Python: no device."""

import importlib
import json
from types import SimpleNamespace

import pytest

from pytorch_distributed_rnn_tpu_torch.obs.tracectx import TraceContext
from pytorch_distributed_rnn_tpu_torch.serving import loadgen, protocol


@pytest.fixture(params=["pytorch_distributed_rnn_tpu", "pytorch_distributed_rnn_tpu_torch"],
                ids=["jax", "torch"])
def ns(request):
    """The package under test's BucketSpec, ContinuousBatcher and
    ServeRequest."""
    buckets = importlib.import_module(f"{request.param}.serving.buckets")
    scheduler = importlib.import_module(f"{request.param}.serving.scheduler")
    return SimpleNamespace(BucketSpec=buckets.BucketSpec,
                           ContinuousBatcher=scheduler.ContinuousBatcher,
                           ServeRequest=scheduler.ServeRequest)


def req(ns, n_tokens=4, prompt_len=3, **kwargs):
    return ns.ServeRequest(
        prompt=list(range(prompt_len)), max_new_tokens=n_tokens, **kwargs
    )


# ---------------------------------------------------------------------------
# buckets


class TestBuckets:
    def test_bucket_for_picks_smallest_holding_bucket(self, ns):
        spec = ns.BucketSpec((8, 16, 64))
        assert spec.bucket_for(1) == 8
        assert spec.bucket_for(8) == 8
        assert spec.bucket_for(9) == 16
        assert spec.bucket_for(64) == 64

    def test_bucket_overflow_and_empty_are_loud(self, ns):
        spec = ns.BucketSpec((8, 16))
        with pytest.raises(ValueError, match="exceeds the largest"):
            spec.bucket_for(17)
        with pytest.raises(ValueError, match="at least one token"):
            spec.bucket_for(0)

    def test_pad_shapes_and_content(self, ns):
        spec = ns.BucketSpec((4, 8))
        padded = spec.pad([5, 6, 7, 8, 9])
        assert padded.shape == (1, 8)
        assert padded[0, :5].tolist() == [5, 6, 7, 8, 9]

    def test_parse_and_validation(self, ns):
        assert ns.BucketSpec.parse("4,8,32").prompt_buckets == (4, 8, 32)
        with pytest.raises(ValueError):
            ns.BucketSpec.parse("8,4")  # not increasing
        with pytest.raises(ValueError):
            ns.BucketSpec.parse("")
        with pytest.raises(ValueError):
            ns.BucketSpec.parse("4,nope")
        with pytest.raises(ValueError):
            ns.BucketSpec((0, 4))


# ---------------------------------------------------------------------------
# admission / shedding


class TestAdmission:
    def test_fifo_admission_and_seq(self, ns):
        batcher = ns.ContinuousBatcher(num_slots=2, max_queue=10)
        requests = [req(ns, id=str(i)) for i in range(5)]
        for r in requests:
            assert batcher.admit(r)
        assert [r.seq for r in requests] == [0, 1, 2, 3, 4]
        assert batcher.queue_depth == 5
        assert batcher.admitted == 5

    def test_shed_past_max_queue_is_immediate_and_marked(self, ns):
        batcher = ns.ContinuousBatcher(num_slots=1, max_queue=2)
        # admission budget = max_queue + free slots (1 here)
        for _ in range(3):
            assert batcher.admit(req(ns))
        extra = req(ns)
        assert not batcher.admit(extra)
        assert extra.status == "shed"
        assert batcher.shed == 1
        assert batcher.queue_depth == 3  # the shed one never queued

    def test_max_queue_zero_means_direct_to_slot_not_shed_everything(self, ns):
        batcher = ns.ContinuousBatcher(num_slots=2, max_queue=0)
        assert batcher.admit(req(ns, id="a"))
        assert batcher.admit(req(ns, id="b"))
        # both free slots are spoken for; no waiting line allowed
        assert not batcher.admit(req(ns, id="c"))
        batcher.take_joins()
        assert not batcher.admit(req(ns, id="d"))  # batch full
        batcher.release(0)
        assert batcher.admit(req(ns, id="e"))  # a slot freed: direct admit

    def test_constructor_validation(self, ns):
        with pytest.raises(ValueError):
            ns.ContinuousBatcher(num_slots=0)
        with pytest.raises(ValueError):
            ns.ContinuousBatcher(num_slots=1, max_queue=-1)


# ---------------------------------------------------------------------------
# join / leave at step boundaries


class TestSlots:
    def test_joins_fill_free_slots_fifo_ascending(self, ns):
        batcher = ns.ContinuousBatcher(num_slots=3, max_queue=10)
        requests = [req(ns, id=str(i)) for i in range(5)]
        for r in requests:
            batcher.admit(r)
        joins = batcher.take_joins()
        assert [(slot, r.id) for slot, r in joins] == [
            (0, "0"), (1, "1"), (2, "2")
        ]
        assert all(r.status == "active" for _, r in joins)
        assert batcher.queue_depth == 2
        # batch full: no join happens until a release
        assert batcher.take_joins() == []

    def test_release_frees_slot_for_next_join(self, ns):
        batcher = ns.ContinuousBatcher(num_slots=2, max_queue=10)
        for i in range(4):
            batcher.admit(req(ns, id=str(i)))
        batcher.take_joins()
        released = batcher.release(1)
        assert released.id == "1"
        assert released.slot is None
        joins = batcher.take_joins()
        # slot 1 refills with the QUEUE HEAD (request 2), request 3 waits
        assert [(slot, r.id) for slot, r in joins] == [(1, "2")]
        assert batcher.queue_depth == 1

    def test_release_unoccupied_slot_is_loud(self, ns):
        batcher = ns.ContinuousBatcher(num_slots=2, max_queue=4)
        with pytest.raises(ValueError, match="not occupied"):
            batcher.release(0)

    def test_starvation_freedom_under_full_batch(self, ns):
        """With the batch saturated and a deep queue, every queued
        request is served in admission order within a bounded number of
        release cycles - no request can be bypassed by later arrivals."""
        batcher = ns.ContinuousBatcher(num_slots=2, max_queue=100)
        order = []
        for i in range(20):
            batcher.admit(req(ns, id=str(i)))
        batcher.take_joins()
        # release one slot per "step"; later arrivals keep landing
        next_id = 20
        for _ in range(18):
            batcher.admit(req(ns, id=str(next_id)))
            next_id += 1
            active = batcher.active()
            slot, oldest = min(active, key=lambda t: t[1].seq)
            order.append(batcher.release(slot).id)
            batcher.take_joins()
        # service order of completions follows admission order
        assert order == [str(i) for i in range(18)]
        # and the queue is exactly the not-yet-served tail, in order
        remaining = [r.id for r in batcher._pending]
        assert remaining == sorted(remaining, key=int)

    def test_has_work_and_abort_pending(self, ns):
        batcher = ns.ContinuousBatcher(num_slots=1, max_queue=10)
        assert not batcher.has_work
        a, b = req(ns, id="a"), req(ns, id="b")
        batcher.admit(a)
        batcher.admit(b)
        batcher.take_joins()
        assert batcher.has_work
        aborted = batcher.abort_pending("shutdown")
        assert [r.id for r in aborted] == ["b"]
        assert b.status == "error" and b.error == "shutdown"
        assert batcher.queue_depth == 0
        assert batcher.has_work  # 'a' still decoding
        batcher.release(0)
        assert not batcher.has_work


# ---------------------------------------------------------------------------
# request lifecycle accounting


class TestRequestTimings:
    def test_derived_timings(self, ns):
        r = req(ns, n_tokens=2)
        assert r.latency_s is None and r.ttft_s is None
        r.arrival_tm = 10.0
        r.service_tm = 10.5
        r.first_token_tm = 11.0
        r.done_tm = 12.0
        assert r.queue_wait_s == pytest.approx(0.5)
        assert r.ttft_s == pytest.approx(1.0)
        assert r.latency_s == pytest.approx(2.0)

    def test_finished_tracks_max_new_tokens(self, ns):
        r = req(ns, n_tokens=2)
        assert not r.finished
        r.tokens.extend([1, 2])
        assert r.finished


# ---------------------------------------------------------------------------
# the wire and the load plan against the JAX package's


def test_untraced_wire_bytes_match_jax():
    """An untraced request's encoded line is byte-identical to the JAX
    package's, and a traced one only adds the ``trace`` key."""
    from pytorch_distributed_rnn_tpu.serving import protocol as jax_protocol

    for kwargs in ({"prompt": [1, 2], "request_id": "w", "max_new_tokens": 2},
                   {"text": "hello", "request_id": "t", "temperature": 0.8, "seed": 7,
                    "stream": True},
                   {"prompt": [3], "priority": "low", "deadline_ms": 250.0}):
        prompt = kwargs.pop("prompt", None)
        ours = protocol.encode_line(protocol.build_generate_request(prompt, **kwargs))
        theirs = jax_protocol.encode_line(jax_protocol.build_generate_request(prompt, **kwargs))
        assert ours == theirs
        assert "trace" not in json.loads(ours)
    minted = TraceContext.minted
    protocol.build_generate_request([1], request_id="w")
    assert TraceContext.minted == minted  # untraced: no context constructed
    ctx = TraceContext.mint(qos="high")
    traced = protocol.build_generate_request([1, 2], request_id="w", max_new_tokens=2, trace=ctx)
    untraced = protocol.build_generate_request([1, 2], request_id="w", max_new_tokens=2)
    assert set(traced) - set(untraced) == {"trace"}
    assert TraceContext.from_wire(traced["trace"]).trace_id == ctx.trace_id
    assert TraceContext.from_wire({"id": 3}) is None


def test_load_plan_matches_jax():
    from pytorch_distributed_rnn_tpu.serving import loadgen as jax_loadgen

    kwargs = dict(requests=64, rate=20.0, prompt_len_min=2, prompt_len_max=64,
                  new_tokens_min=16, new_tokens_max=128, temperature=0.8, seed=0)
    ours = loadgen.plan_requests(loadgen.LoadConfig(**kwargs), 256, 128, 128)
    theirs = jax_loadgen.plan_requests(jax_loadgen.LoadConfig(**kwargs), 256, 128, 128)
    assert ours == theirs
    assert len(ours) == 64 and all(2 <= len(p["prompt"]) <= 64 for p in ours)


def test_report_of_outcomes():
    cfg = loadgen.LoadConfig(slo_p95_ms=100.0)
    outcomes = [loadgen.RequestOutcome(index=i, arrival_s=0.1 * i, status="done",
                                       latency_ms=10.0 * (i + 1), ttft_ms=1.0, tokens=4,
                                       done_at_s=0.5 * i) for i in range(4)]
    outcomes.append(loadgen.RequestOutcome(index=4, arrival_s=0.4, status="shed",
                                           done_at_s=0.6))
    report = loadgen.build_report(cfg, outcomes, wall_s=2.0)
    assert (report["done"], report["shed"], report["errors"]) == (4, 1, 0)
    assert report["tokens"] == 16 and report["tokens_per_s"] == 8.0
    assert report["latency_ms"]["p50"] == 20.0 and report["slo"]["p95_ok"]
    assert report["degraded_seconds"] == [0]  # the shed lands in second 0
    assert "requests 5: 4 done, 1 shed, 0 errors" in loadgen.format_report(report)
