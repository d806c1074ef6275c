"""The port's fleet router (``pytorch_distributed_rnn_tpu_torch/serving/
fleet/{pool,router}.py``) as a pure unit: the JAX package's 35 cases
(``tests/test_fleet_router.py``) against the port - breaker transitions,
least-loaded dispatch, retry budgets, hedging, QoS shedding, drain,
tracing - with in-memory fake replicas injected through the pool's
``dial`` factory; then one scripted scenario (ejections, half-open,
retries, a shed reply, the deadline, a hedge, QoS shedding, drain) driven
through the port's ``RouterCore`` and JAX's, whose ``stats()`` must be
equal.  No model, no device."""

import socket
import threading
import time

import pytest

from pytorch_distributed_rnn_tpu_torch.serving.fleet.pool import (
    DRAINING,
    HALF_OPEN,
    HEALTHY,
    OPEN,
    Replica,
    ReplicaPool,
)
from pytorch_distributed_rnn_tpu_torch.serving.fleet.router import (
    QOS_ADMIT_FRAC,
    QOS_CLASSES,
    RouterCore,
    RouterServer,
)
from pytorch_distributed_rnn_tpu_torch.serving.protocol import (
    ProtocolError,
    ServingClient,
    encode_line,
)

# ---------------------------------------------------------------------------
# fakes: the dial-factory seam the pool exposes for exactly this


def fake_tokens(seed: int, n: int = 4) -> list[int]:
    """Deterministic pseudo-decode: what a seeded replica would emit.
    Every fake replica computes the same function of the seed, so a
    retried dispatch being bit-identical is directly checkable."""
    tokens, state = [], int(seed)
    for _ in range(n):
        state = (state * 1103515245 + 12345) & 0x7FFFFFFF
        tokens.append(state % 251)
    return tokens


class FakeReplicaServer:
    """In-memory replica endpoint: answers pings and seeded generates,
    with togglable failure modes."""

    def __init__(self, replica_id: int):
        self.replica_id = replica_id
        self.dead = False  # dial refused
        self.fail_generates = 0  # next N generates die mid-reply
        self.stream_break_after = None  # tokens emitted before dying
        self.delay_s = 0.0  # final-reply latency
        self.requests: list[dict] = []
        self.lock = threading.Lock()
        self.protocol_error = ProtocolError  # the router's protocol module's

    def dial(self, connect_timeout_s=2.0, io_timeout_s=30.0):
        if self.dead:
            raise OSError("connection refused")
        return _FakeConn(self)

    def handle(self, msg: dict) -> list:
        op = msg.get("op")
        if op == "ping":
            return [{"event": "pong", "model": "fake",
                     "vocab_size": 256, "max_prompt_len": 64,
                     "max_new_tokens": 32, "slots": 4,
                     "replica": self.replica_id}]
        assert op == "generate"
        with self.lock:
            self.requests.append(dict(msg))
            if self.fail_generates > 0:
                self.fail_generates -= 1
                return [OSError("replica died mid-request")]
        rid = str(msg.get("id", ""))
        tokens = fake_tokens(int(msg["seed"]),
                             n=int(msg.get("max_new_tokens", 4)))
        replies: list = []
        if msg.get("stream"):
            replies = [
                {"id": rid, "event": "token", "index": i, "token": t}
                for i, t in enumerate(tokens)
            ]
            if self.stream_break_after is not None:
                replies = replies[: self.stream_break_after]
                replies.append(OSError("replica died mid-stream"))
                return replies
        replies.append({
            "id": rid, "event": "done", "status": "done",
            "tokens": tokens, "token_count": len(tokens),
            "latency_ms": 1.0, "seed": int(msg["seed"]),
            "served_by": self.replica_id,
        })
        return replies


class _FakeConn:
    def __init__(self, server: FakeReplicaServer):
        self.server = server
        self.queue: list = []
        self.closed = threading.Event()
        self.deadline_s: float | None = None

    def send(self, msg: dict) -> None:
        if self.closed.is_set():
            raise OSError("connection closed")
        self.queue.extend(self.server.handle(msg))

    def recv(self) -> dict:
        wait_s = self.server.delay_s
        if wait_s:
            if self.deadline_s is not None and wait_s > self.deadline_s:
                # honor set_deadline the way a real socket read would
                self.closed.wait(timeout=self.deadline_s)
                raise socket.timeout("timed out")
            # a slow replica: block, but die promptly when cancelled
            # (a closed socket interrupts a real read the same way)
            if self.closed.wait(timeout=wait_s):
                raise OSError("connection closed")
        if self.closed.is_set():
            raise OSError("connection closed")
        if not self.queue:
            raise self.server.protocol_error("replica closed the connection")
        item = self.queue.pop(0)
        if isinstance(item, Exception):
            raise item
        return item

    def set_deadline(self, seconds: float) -> None:
        self.deadline_s = float(seconds)

    def close(self) -> None:
        self.closed.set()


def make_pool(n=3, **kwargs):
    servers = [FakeReplicaServer(i + 1) for i in range(n)]
    replicas = [Replica(s.replica_id, dial=s.dial) for s in servers]
    kwargs.setdefault("health_every_s", 3600.0)  # tests drive check_once
    pool = ReplicaPool(replicas, **kwargs)
    return servers, pool


# ---------------------------------------------------------------------------
# pool: breaker state machine


class TestBreaker:
    def test_ping_failures_eject_after_threshold(self):
        servers, pool = make_pool(2, eject_after=3)
        servers[0].dead = True
        events = []
        pool._on_event = lambda kind, **f: events.append((kind, f))
        for _ in range(2):
            pool.check_once()
        assert pool.replicas[1].state == HEALTHY  # not yet
        pool.check_once()
        assert pool.replicas[1].state == OPEN
        assert pool.replicas[2].state == HEALTHY
        kinds = [k for k, _ in events]
        assert "replica_eject" in kinds

    def test_dispatch_failures_feed_the_same_breaker(self):
        servers, pool = make_pool(2, eject_after=2)
        replica = pool.replicas[1]
        for _ in range(2):
            assert pool.pick() is not None  # least-loaded: replica 1
            pool.release(replica, ok=False)
        assert replica.state == OPEN
        assert replica.ejections == 1

    def test_cooldown_half_open_then_ping_readmission(self):
        servers, pool = make_pool(
            1, eject_after=1, cooldown_s=0.05, half_open_probes=2)
        servers[0].dead = True
        pool.check_once()
        assert pool.replicas[1].state == OPEN
        time.sleep(0.06)
        servers[0].dead = False
        pool.check_once()  # advances to half_open, then pings (1/2)
        assert pool.replicas[1].probe_successes == 1
        assert pool.replicas[1].state == HALF_OPEN
        pool.check_once()  # 2/2 -> readmitted
        assert pool.replicas[1].state == HEALTHY
        assert pool.replicas[1].readmissions == 1

    def test_half_open_failure_reopens(self):
        servers, pool = make_pool(1, eject_after=1, cooldown_s=0.0)
        servers[0].dead = True
        pool.check_once()
        time.sleep(0.01)
        pool.check_once()  # half_open, ping fails again
        assert pool.replicas[1].state == OPEN

    def test_half_open_trial_request_readmits(self):
        servers, pool = make_pool(1, eject_after=1, cooldown_s=0.0)
        servers[0].dead = True
        pool.check_once()
        time.sleep(0.01)
        servers[0].dead = False
        picked = pool.pick()  # no healthy replica -> half-open trial
        assert picked is pool.replicas[1]
        assert picked.trial_inflight
        pool.release(picked, ok=True)
        assert picked.state == HEALTHY

    def test_drained_replica_never_picked(self):
        servers, pool = make_pool(2)
        pool.drain(1)
        assert pool.replicas[1].state == DRAINING
        for _ in range(4):
            picked = pool.pick()
            assert picked.replica_id == 2
            pool.release(picked, ok=True)


class TestDispatchFairness:
    def test_least_loaded_spreads_unreleased_picks(self):
        servers, pool = make_pool(3)
        picked = [pool.pick().replica_id for _ in range(3)]
        assert sorted(picked) == [1, 2, 3]

    def test_load_hint_biases_selection(self):
        servers, pool = make_pool(
            2, load_hint=lambda r: 5.0 if r.replica_id == 1 else 0.0)
        assert pool.pick().replica_id == 2

    def test_exclusion_falls_back_rather_than_failing(self):
        servers, pool = make_pool(1)
        picked = pool.pick(exclude=[1])  # only replica already tried
        assert picked is pool.replicas[1]


# ---------------------------------------------------------------------------
# router core: retry, hedging, shedding, accounting


def collect():
    sent = []
    return sent, sent.append


class TestRouterRetry:
    def test_routes_and_assigns_idempotency_seed(self):
        servers, pool = make_pool(2)
        core = RouterCore(pool, retries=1)
        sent, send = collect()
        final = core.handle_generate(
            {"op": "generate", "id": "r1", "max_new_tokens": 4}, send)
        assert final["event"] == "done"
        assert sent == [final]
        # the router pinned a seed so any re-dispatch is deterministic
        assert "seed" in servers[final["served_by"] - 1].requests[0]

    def test_retry_reroutes_bit_identically(self):
        servers, pool = make_pool(2, eject_after=1)
        servers[0].fail_generates = 1
        core = RouterCore(pool, retries=2, retry_base_delay_s=0.001)
        sent, send = collect()
        final = core.handle_generate(
            {"op": "generate", "id": "r1", "seed": 1234,
             "max_new_tokens": 4}, send)
        assert final["event"] == "done"
        assert final["attempts"] == 2
        assert final["served_by"] == 2
        # bit-identical re-dispatch: the sibling decoded the SAME seed
        # to the SAME tokens the failed replica would have produced
        assert final["tokens"] == fake_tokens(1234)
        seeds = [r["seed"] for s in servers for r in s.requests]
        assert set(seeds) == {1234}
        stats = core.stats()
        assert stats["rerouted"] == 1 and stats["retries"] == 1
        assert stats["done"] == 1 and stats["errors"] == 0

    def test_retry_budget_exhaustion_is_a_loud_error(self):
        servers, pool = make_pool(2)
        for s in servers:
            s.fail_generates = 99
        core = RouterCore(pool, retries=2, retry_base_delay_s=0.001)
        sent, send = collect()
        final = core.handle_generate(
            {"op": "generate", "id": "r1"}, send)
        assert final["event"] == "error"
        assert "retry budget exhausted" in final["error"]
        stats = core.stats()
        assert stats["errors"] == 1
        assert stats["submitted"] == stats["done"] + stats["errors"]

    def test_started_stream_is_never_replayed(self):
        servers, pool = make_pool(2)
        servers[0].stream_break_after = 2
        servers[1].stream_break_after = 2
        core = RouterCore(pool, retries=3, retry_base_delay_s=0.001)
        sent, send = collect()
        final = core.handle_generate(
            {"op": "generate", "id": "r1", "seed": 7, "stream": True,
             "max_new_tokens": 4}, send)
        assert final["event"] == "error"
        assert final["stream_aborted"]
        assert "never replayed" in final["error"]
        # 2 relayed tokens + the final error, and NO second dispatch
        assert len(sent) == 3
        assert sum(len(s.requests) for s in servers) == 1
        assert core.stats()["stream_aborts"] == 1

    def test_replica_shed_reply_retries_a_sibling(self):
        servers, pool = make_pool(2)
        original = servers[0].handle

        def shed_once(msg):
            if msg.get("op") == "generate" and not servers[0].requests:
                servers[0].requests.append(dict(msg))
                return [{"id": str(msg.get("id", "")), "event": "error",
                         "error": "queue full - request shed",
                         "shed": True}]
            return original(msg)

        servers[0].handle = shed_once
        core = RouterCore(pool, retries=1, retry_base_delay_s=0.001)
        sent, send = collect()
        final = core.handle_generate({"op": "generate", "id": "r"}, send)
        assert final["event"] == "done"
        assert final["served_by"] == 2

    def test_deadline_bounds_the_retry_tree(self):
        servers, pool = make_pool(1)
        servers[0].delay_s = 0.4
        core = RouterCore(pool, retries=5, retry_base_delay_s=0.001)
        sent, send = collect()
        t0 = time.perf_counter()
        final = core.handle_generate(
            {"op": "generate", "id": "r1", "deadline_ms": 150}, send)
        elapsed = time.perf_counter() - t0
        assert final["event"] == "error"
        assert "deadline" in final["error"]
        assert elapsed < 2.0


class TestHedging:
    def test_hedge_wins_and_loser_is_cancelled_neutrally(self):
        servers, pool = make_pool(2)
        servers[0].delay_s = 0.5  # primary (least-loaded pick) is slow
        core = RouterCore(pool, retries=0, hedge_after_ms=40)
        sent, send = collect()
        final = core.handle_generate(
            {"op": "generate", "id": "r1", "seed": 9,
             "max_new_tokens": 4}, send)
        assert final["event"] == "done"
        assert final["served_by"] == 2
        assert final["tokens"] == fake_tokens(9)
        stats = core.stats()
        assert stats["hedges"] == 1 and stats["hedge_wins"] == 1
        # the cancelled primary is NOT charged a breaker failure, and
        # both in-flight reservations drained back to zero
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            if all(r.inflight == 0 for r in pool.replicas.values()):
                break
            time.sleep(0.01)
        assert pool.replicas[1].consecutive_failures == 0
        assert all(r.inflight == 0 for r in pool.replicas.values())

    def test_fast_primary_never_hedges(self):
        servers, pool = make_pool(2)
        core = RouterCore(pool, retries=0, hedge_after_ms=500)
        sent, send = collect()
        final = core.handle_generate(
            {"op": "generate", "id": "r1"}, send)
        assert final["event"] == "done"
        assert core.stats()["hedges"] == 0

    def test_streams_never_hedge(self):
        servers, pool = make_pool(2)
        servers[0].delay_s = 0.0
        core = RouterCore(pool, retries=0, hedge_after_ms=1)
        sent, send = collect()
        final = core.handle_generate(
            {"op": "generate", "id": "r1", "stream": True,
             "max_new_tokens": 2}, send)
        assert final["event"] == "done"
        assert core.stats()["hedges"] == 0


class TestQosShedding:
    def test_admission_fractions_are_ordered(self):
        assert set(QOS_CLASSES) == set(QOS_ADMIT_FRAC)
        assert (QOS_ADMIT_FRAC["low"] < QOS_ADMIT_FRAC["normal"]
                < QOS_ADMIT_FRAC["high"])

    def test_low_sheds_first_then_normal_then_high(self):
        servers, pool = make_pool(1)
        core = RouterCore(pool, max_inflight=10)
        with core._lock:
            core._inflight = 6  # past low's budget (5), under normal's
        sent, send = collect()
        low = core.handle_generate(
            {"op": "generate", "id": "a", "priority": "low"}, send)
        assert low["event"] == "error" and low["shed"]
        assert "overloaded" in low["error"]
        normal = core.handle_generate(
            {"op": "generate", "id": "b"}, send)
        assert normal["event"] == "done"
        with core._lock:
            core._inflight = 9  # past normal's budget (8), under high's
        normal2 = core.handle_generate(
            {"op": "generate", "id": "c", "priority": "normal"}, send)
        assert normal2["event"] == "error" and normal2["shed"]
        high = core.handle_generate(
            {"op": "generate", "id": "d", "priority": "high"}, send)
        assert high["event"] == "done"
        assert core.stats()["shed"] == {"high": 0, "normal": 1, "low": 1}

    def test_unknown_priority_is_a_loud_error(self):
        servers, pool = make_pool(1)
        core = RouterCore(pool)
        sent, send = collect()
        final = core.handle_generate(
            {"op": "generate", "id": "a", "priority": "urgent"}, send)
        assert final["event"] == "error"
        assert "unknown priority" in final["error"]

    def test_accounting_identity_over_a_mixed_run(self):
        servers, pool = make_pool(2, eject_after=10)
        servers[0].fail_generates = 2
        core = RouterCore(pool, retries=0, max_inflight=10)
        sent, send = collect()
        for i in range(8):
            core.handle_generate({"op": "generate", "id": str(i)}, send)
        stats = core.stats()
        assert stats["submitted"] == stats["done"] + stats["errors"]
        assert stats["submitted"] == 8


class TestDrain:
    def test_drain_rejects_new_but_finishes_inflight(self):
        servers, pool = make_pool(1)
        servers[0].delay_s = 0.2
        core = RouterCore(pool, retries=0)
        sent, send = collect()
        results = {}

        def slow_request():
            results["final"] = core.handle_generate(
                {"op": "generate", "id": "inflight"}, send)

        worker = threading.Thread(target=slow_request)
        worker.start()
        deadline = time.monotonic() + 2.0
        while core.inflight_count() == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        core.begin_drain()
        rejected = core.handle_generate(
            {"op": "generate", "id": "late"}, send)
        assert rejected["event"] == "error"
        assert "draining" in rejected["error"]
        worker.join(timeout=5.0)
        assert results["final"]["event"] == "done"
        assert core.stats()["drain_rejected"] == 1

    def test_summary_fields_cover_the_summarize_contract(self):
        from pytorch_distributed_rnn_tpu_torch.obs.summary import (
            ROUTER_SUMMARY_KEYS,
        )

        servers, pool = make_pool(1)
        core = RouterCore(pool)
        fields = core.summary_fields()
        assert set(fields) == set(ROUTER_SUMMARY_KEYS)


# ---------------------------------------------------------------------------
# router server: the TCP front end over fakes


class TestRouterServer:
    def test_speaks_the_serving_protocol_end_to_end(self):
        servers, pool = make_pool(2, health_every_s=0.05)
        core = RouterCore(pool, retries=1)
        server = RouterServer(core)
        try:
            server.start()
            assert server.wait_ready(timeout_s=5.0)
            with ServingClient(server.host, server.port,
                               timeout_s=10.0) as client:
                pong = client.ping()
                assert pong["model"] == "fake"
                assert pong["fleet"]["replicas"] == 2
                reply = client.generate(prompt=[1, 2], seed=42,
                                        max_new_tokens=4)
                assert reply["event"] == "done"
                assert reply["tokens"] == fake_tokens(42)
                stats = client.stats()
                assert stats["done"] == 1
                assert stats["pool"]["states"]["healthy"] == 2
        finally:
            server.shutdown(drain_timeout_s=1.0)

    def test_shutdown_drains(self):
        servers, pool = make_pool(1, health_every_s=0.05)
        core = RouterCore(pool)
        server = RouterServer(core)
        server.start()
        assert server.wait_ready(timeout_s=5.0)
        server.shutdown(drain_timeout_s=1.0)
        with core._lock:
            assert core._draining
        # idempotent
        server.shutdown(drain_timeout_s=1.0)


# ---------------------------------------------------------------------------
# loadgen client hardening (the satellite regression): a wedged or
# dribbling server must not pin a client past its request deadline


class _DribblingServer:
    """Accepts one connection and emits a token event every 50 ms
    FOREVER - the pathological stream a per-read timeout never bounds."""

    def __init__(self):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.bind(("127.0.0.1", 0))
        self.listener.listen(1)
        self.port = self.listener.getsockname()[1]
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        try:
            conn, _ = self.listener.accept()
        except OSError:
            return
        conn.makefile("r").readline()  # consume the request
        i = 0
        while not self._stop.wait(timeout=0.05):
            try:
                conn.sendall(encode_line(
                    {"id": "0", "event": "token", "index": i,
                     "token": 1}))
            except OSError:
                return
            i += 1

    def close(self):
        self._stop.set()
        self.listener.close()


class TestLoadgenDeadline:
    def test_deadline_bounds_a_dribbling_stream(self):
        server = _DribblingServer()
        try:
            t0 = time.perf_counter()
            with ServingClient("127.0.0.1", server.port,
                               timeout_s=30.0) as client:
                with pytest.raises(ProtocolError,
                                   match="request deadline"):
                    client.generate(prompt=[1], stream=True,
                                    deadline_s=0.5)
            elapsed = time.perf_counter() - t0
            # the old per-read timeout would have run 30s+; the wall
            # deadline cuts the request off promptly
            assert elapsed < 5.0
        finally:
            server.close()

    def test_connect_timeout_is_separate_from_read_timeout(self):
        # a dead target fails the DIAL fast even with a long read
        # timeout armed for the request itself
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        dead_port = probe.getsockname()[1]
        probe.close()  # nothing listens here now
        t0 = time.perf_counter()
        with pytest.raises(OSError):
            ServingClient("127.0.0.1", dead_port, timeout_s=60.0,
                          connect_timeout_s=1.0)
        assert time.perf_counter() - t0 < 10.0

    def test_loadgen_plan_is_stable_under_qos_mix(self):
        from pytorch_distributed_rnn_tpu_torch.serving.loadgen import (
            LoadConfig,
            plan_requests,
        )

        base = LoadConfig(requests=20, seed=3)
        mixed = LoadConfig(requests=20, seed=3,
                           low_priority_fraction=0.5)
        plan_a = plan_requests(base, 256, 64, 32)
        plan_b = plan_requests(mixed, 256, 64, 32)
        # the QoS mix draws from its own RNG stream: the base plan
        # (arrivals, prompts, seeds) must not shift when it turns on
        for a, b in zip(plan_a, plan_b):
            assert a["arrival_s"] == b["arrival_s"]
            assert a["prompt"] == b["prompt"]
            assert a["seed"] == b["seed"]
        assert all(p["priority"] == "normal" for p in plan_a)
        lows = sum(p["priority"] == "low" for p in plan_b)
        assert 0 < lows < 20


# ---------------------------------------------------------------------------
# distributed tracing: the router as the fleet's trace edge


def _wait_dispatch_threads(timeout_s=3.0):
    """Hedge losers emit their attempt span from their own dispatch
    thread after the winner already returned - wait those threads out
    before closing the recorder."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if not any(t.name.startswith("pdrnn-router-dispatch-")
                   for t in threading.enumerate()):
            return
        time.sleep(0.01)


def _trace_spans(path):
    from pytorch_distributed_rnn_tpu_torch.obs.summary import load_events

    return [e for e in load_events(path)
            if e.get("kind") == "span" and e.get("cat") == "trace"]


class TestRouterTracing:
    def make_traced_core(self, tmp_path, n=2, trace_sample=1.0,
                         pool_kwargs=None, **kwargs):
        from pytorch_distributed_rnn_tpu_torch.obs import MetricsRecorder

        servers, pool = make_pool(n, **(pool_kwargs or {}))
        recorder = MetricsRecorder(
            tmp_path / "router.jsonl", sample_every=1,
            meta={"role": "router"},
        )
        core = RouterCore(pool, recorder=recorder,
                          trace_sample=trace_sample,
                          retry_base_delay_s=0.001, **kwargs)
        return servers, core, recorder

    def test_sampled_request_emits_route_and_attempt_spans(
            self, tmp_path):
        servers, core, recorder = self.make_traced_core(tmp_path)
        sent, send = collect()
        final = core.handle_generate(
            {"op": "generate", "id": "r1", "priority": "high"}, send)
        recorder.close()
        assert final["event"] == "done"
        spans = _trace_spans(recorder.path)
        route = next(s for s in spans if s["name"] == "route")
        assert route["request"] == "r1" and route["qos"] == "high"
        assert route["outcome"] == "done" and route["attempts"] == 1
        assert route.get("parent") is None  # router-minted root
        assert final["trace_id"] == route["trace"]
        attempt = next(s for s in spans if s["name"] == "attempt")
        assert attempt["trace"] == route["trace"]
        assert attempt["parent"] == route["span"]
        assert attempt["outcome"] == "done"
        # the dispatched message carried the ATTEMPT's context, one
        # causal hop below the route span
        wire = servers[final["served_by"] - 1].requests[0]["trace"]
        assert wire["id"] == route["trace"]
        assert wire["span"] == attempt["span"]

    def test_retry_attempts_are_distinct_sibling_spans(self, tmp_path):
        servers, core, recorder = self.make_traced_core(
            tmp_path, retries=2, pool_kwargs={"eject_after": 1})
        servers[0].fail_generates = 1
        sent, send = collect()
        final = core.handle_generate(
            {"op": "generate", "id": "r2", "seed": 11}, send)
        recorder.close()
        assert final["event"] == "done" and final["attempts"] == 2
        spans = _trace_spans(recorder.path)
        route = next(s for s in spans if s["name"] == "route")
        attempts = [s for s in spans if s["name"] == "attempt"]
        assert len(attempts) == 2
        assert len({s["span"] for s in attempts}) == 2
        assert all(s["parent"] == route["span"] for s in attempts)
        assert [s["attempt"] for s in attempts] == [1, 2]
        assert [s["outcome"] for s in attempts] == [
            "transport_error", "done"]
        # the sidecar alone re-assembles into a validator-clean tree
        from pytorch_distributed_rnn_tpu_torch.obs.trace import (
            assemble_traces,
            validate_trace_tree,
        )

        tree = assemble_traces([recorder.path])[0]
        assert tree.root.name == "route"
        assert [c.name for c in tree.root.children] == [
            "attempt", "attempt"]
        validate_trace_tree(tree)

    def test_incoming_wire_trace_is_continued_as_a_child(self, tmp_path):
        servers, core, recorder = self.make_traced_core(
            tmp_path, trace_sample=0.0)
        sent, send = collect()
        final = core.handle_generate(
            {"op": "generate", "id": "r3",
             # protocol: serve field trace
             "trace": {"id": "cafecafecafecafe", "span": "beef0001",
                       "qos": "high"}}, send)
        recorder.close()
        assert final["trace_id"] == "cafecafecafecafe"
        route = next(s for s in _trace_spans(recorder.path)
                     if s["name"] == "route")
        assert route["trace"] == "cafecafecafecafe"
        assert route["parent"] == "beef0001"  # the client's edge span

    def test_hedge_legs_carry_per_leg_contexts(self, tmp_path):
        servers, core, recorder = self.make_traced_core(
            tmp_path, retries=0, hedge_after_ms=40)
        servers[0].delay_s = 0.5  # primary silent past the hedge fuse
        sent, send = collect()
        final = core.handle_generate(
            {"op": "generate", "id": "r4", "seed": 9}, send)
        _wait_dispatch_threads()
        recorder.close()
        assert final["event"] == "done" and final["served_by"] == 2
        spans = _trace_spans(recorder.path)
        route = next(s for s in spans if s["name"] == "route")
        attempts = [s for s in spans if s["name"] == "attempt"]
        assert len(attempts) == 2
        assert len({s["span"] for s in attempts}) == 2
        assert all(s["parent"] == route["span"] for s in attempts)
        by_replica = {s["replica"]: s for s in attempts}
        assert by_replica[2]["outcome"] == "done"
        assert by_replica[2].get("hedge") is True
        assert by_replica[1]["outcome"] == "cancelled"

    def test_tracing_off_allocates_no_context_and_keeps_wire_identical(
            self, tmp_path):
        from pytorch_distributed_rnn_tpu_torch.obs.tracectx import TraceContext

        # recorder on but sampling off, and no incoming context: the
        # request must construct NO TraceContext and forward the exact
        # message it received (plus the idempotency seed)
        servers, core, recorder = self.make_traced_core(
            tmp_path, trace_sample=0.0)
        before = TraceContext.minted
        sent, send = collect()
        final = core.handle_generate(
            {"op": "generate", "id": "r5"}, send)
        recorder.close()
        assert final["event"] == "done"
        assert "trace_id" not in final
        assert TraceContext.minted == before
        assert "trace" not in servers[final["served_by"] - 1].requests[0]
        assert _trace_spans(recorder.path) == []

    def test_null_recorder_never_samples(self):
        from pytorch_distributed_rnn_tpu_torch.obs.tracectx import TraceContext

        servers, pool = make_pool(1)
        core = RouterCore(pool, trace_sample=1.0)  # NULL_RECORDER
        before = TraceContext.minted
        sent, send = collect()
        final = core.handle_generate({"op": "generate", "id": "r6"}, send)
        assert final["event"] == "done"
        assert "trace_id" not in final
        assert TraceContext.minted == before


# ---------------------------------------------------------------------------
# one scripted scenario through the port's router and JAX's


def _scripted_scenario(pool_mod, router_mod, protocol_error):
    """Ejections, half-open re-admission, retries, a shed reply from a
    replica, the deadline, a hedge, QoS shedding and a drain, in a fixed
    order on fake replicas; returns the router's ``stats()`` without its
    wall-clock fields and the finals' deterministic fields."""
    servers = [FakeReplicaServer(i + 1) for i in range(3)]
    for server in servers:
        server.protocol_error = protocol_error
    pool = pool_mod.ReplicaPool(
        [pool_mod.Replica(s.replica_id, dial=s.dial) for s in servers],
        eject_after=2, cooldown_s=0.05, half_open_probes=1, health_every_s=3600.0)
    core = router_mod.RouterCore(pool, retries=2, retry_base_delay_s=0.001, max_inflight=10,
                                 hedge_after_ms=None)
    finals = []

    def generate(**msg):
        final = core.handle_generate({"op": "generate", **msg}, lambda _event: None)
        finals.append({k: final.get(k) for k in ("id", "event", "tokens", "attempts",
                                                 "served_by", "shed", "stream_aborted")})
        return final

    generate(id="plain", seed=1, max_new_tokens=4)
    # a replica dies mid-request: the retry goes to a sibling with the seed
    servers[0].fail_generates = 1
    generate(id="retry", seed=2, max_new_tokens=4)
    # two ping failures eject replica 2; its cooldown, then a half-open
    # probe re-admits it
    servers[1].dead = True
    pool.check_once()
    pool.check_once()
    generate(id="while-ejected", seed=3)
    servers[1].dead = False
    time.sleep(0.06)
    pool.check_once()
    # a replica's shed reply retries a sibling
    original = servers[2].handle

    def shed_once(msg):
        if msg.get("op") == "generate" and not getattr(servers[2], "shed_sent", False):
            servers[2].shed_sent = True
            return [{"id": str(msg.get("id", "")), "event": "error",
                     "error": "queue full - request shed", "shed": True}]
        return original(msg)

    servers[2].handle = shed_once
    for i in range(3):
        generate(id=f"spread-{i}", seed=10 + i)
    # a stream that relayed tokens is never replayed
    for server in servers:
        server.stream_break_after = 1
    generate(id="stream", seed=20, stream=True, max_new_tokens=3)
    for server in servers:
        server.stream_break_after = None
    # the deadline bounds the retry tree
    for server in servers:
        server.delay_s = 0.3
    generate(id="deadline", seed=30, deadline_ms=100)
    for server in servers:
        server.delay_s = 0.0
    # a hedge: the least-loaded primary is slow, the sibling wins
    core.hedge_after_ms = 40
    servers[0].delay_s = servers[1].delay_s = 0.5
    generate(id="hedged", seed=40, max_new_tokens=4)
    servers[0].delay_s = servers[1].delay_s = 0.0
    core.hedge_after_ms = None
    deadline = time.monotonic() + 3.0
    while any(r.inflight for r in pool.replicas.values()) and time.monotonic() < deadline:
        time.sleep(0.01)
    # QoS shedding past graduated shares of the budget
    with core._lock:
        core._inflight = 6
    generate(id="low", priority="low")
    generate(id="normal", seed=50)
    with core._lock:
        core._inflight = 9
    generate(id="normal-2", priority="normal")
    generate(id="high", seed=51, priority="high")
    with core._lock:
        core._inflight = 0
    generate(id="bad-priority", priority="urgent")
    # drain: new work is rejected
    core.begin_drain()
    generate(id="late", seed=60)
    stats = core.stats()
    for key in ("latency_s_p50", "latency_s_p95", "req_per_s_60s"):
        stats.pop(key)
    return stats, finals


def test_scripted_scenario_stats_equal_jax():
    from pytorch_distributed_rnn_tpu.serving.fleet import pool as jax_pool
    from pytorch_distributed_rnn_tpu.serving.fleet import router as jax_router
    from pytorch_distributed_rnn_tpu.serving.protocol import ProtocolError as JaxProtocolError
    from pytorch_distributed_rnn_tpu_torch.serving.fleet import pool as port_pool
    from pytorch_distributed_rnn_tpu_torch.serving.fleet import router as port_router

    stats, finals = _scripted_scenario(port_pool, port_router, ProtocolError)
    jax_stats, jax_finals = _scripted_scenario(jax_pool, jax_router, JaxProtocolError)
    assert stats == jax_stats
    assert finals == jax_finals
    # the scenario reached every path it names
    assert stats["rerouted"] >= 1 and stats["retries"] >= 1
    assert stats["hedges"] == 1 and stats["hedge_wins"] == 1
    assert stats["stream_aborts"] == 1 and stats["drain_rejected"] == 1
    assert stats["shed"] == {"high": 0, "normal": 1, "low": 1}
    assert stats["pool"]["ejections"] >= 1 and stats["pool"]["readmissions"] >= 1
    assert stats["submitted"] == stats["done"] + stats["errors"]
    assert [f["event"] for f in finals if f["id"] == "deadline"] == ["error"]
