"""Poisson load generator + latency/SLO report for the serving endpoint
(a copy of the JAX package's ``serving/loadgen.py``).

Deterministic in ``seed``: arrival gaps draw from an exponential
distribution (Poisson process at ``rate`` req/s), prompt lengths and
decode lengths draw uniformly from configured ranges, prompts are
random in-vocab ids (or, against byte-vocab models, any ``--text``
corpus slice the CLI passes).  Each request runs on its own thread and
connection at its scheduled arrival offset - the server's continuous
batching, not the client, provides the concurrency.

The report aggregates per-request outcomes into SLO-facing numbers
(p50/p95/p99 latency, TTFT, throughput, shed/error counts) plus a
per-second timeline used by the chaos SLO drill: a second is DEGRADED
when requests were shed, failed, or finished above the latency SLO in
it, and the drill asserts the degradation window opens under the
injected fault and closes after it - graceful degradation, not an
outage.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from pytorch_distributed_rnn_tpu_torch.obs.summary import percentile
from pytorch_distributed_rnn_tpu_torch.obs.tracectx import (
    TraceContext,
    should_sample,
)
from pytorch_distributed_rnn_tpu_torch.serving.protocol import (
    ProtocolError,
    ServingClient,
)

# report caps: how many slowest / violating requests the report NAMES
# (ids + trace ids - the handles `pdrnn-metrics trace` pulls)
SLOWEST_NAMED = 5
VIOLATIONS_NAMED = 20


@dataclass(frozen=True)
class LoadConfig:
    host: str = "127.0.0.1"
    port: int = 0
    requests: int = 50
    rate: float = 25.0  # mean Poisson arrivals per second
    prompt_len_min: int = 2
    prompt_len_max: int = 24
    new_tokens_min: int = 4
    new_tokens_max: int = 24
    temperature: float = 0.0
    sampled_fraction: float = 0.5  # share of requests at `temperature`
    seed: int = 0
    stream: bool = False
    timeout_s: float = 120.0
    connect_timeout_s: float = 5.0
    low_priority_fraction: float = 0.0  # share tagged priority=low
    deadline_ms: float | None = None  # server-side QoS deadline field
    slo_p95_ms: float = 2000.0
    slo_ttft_p95_ms: float | None = None
    # head-sample this fraction of requests into distributed traces
    # (deterministic, RNG-free: sampling must not shift the seeded plan)
    trace_sample: float = 0.0


@dataclass
class RequestOutcome:
    index: int
    arrival_s: float  # offset from load start
    priority: str = "normal"
    status: str = "pending"  # done | shed | error
    latency_ms: float | None = None
    ttft_ms: float | None = None
    queue_ms: float | None = None
    tokens: int = 0
    error: str | None = None
    done_at_s: float | None = None
    request_id: str | None = None
    # loadgen-minted (--trace-sample) or router-assigned trace id - the
    # handle the report prints for pdrnn-metrics trace
    trace_id: str | None = None
    _reply: dict | None = field(default=None, repr=False)


def _percentile(sorted_values, q: float) -> float | None:
    """The shared nearest-rank convention (``obs/summary.py``), mapped
    to None-on-empty for clean JSON reports."""
    return percentile(sorted_values, q) if sorted_values else None


def plan_requests(cfg: LoadConfig, vocab_size: int,
                  max_prompt_len: int, max_new_tokens: int) -> list[dict]:
    """The deterministic request schedule: arrival offsets + payloads,
    clamped to the server's advertised limits."""
    rng = np.random.RandomState(cfg.seed)
    # priorities draw from their OWN stream: turning the QoS mix on or
    # off must not shift the base plan (arrivals/prompts/seeds), which
    # tests and cross-run comparisons pin by cfg.seed
    prio_rng = np.random.RandomState(cfg.seed + 104729)
    gaps = rng.exponential(1.0 / max(cfg.rate, 1e-9), size=cfg.requests)
    arrivals = np.cumsum(gaps)
    plen_hi = min(cfg.prompt_len_max, max_prompt_len)
    plen_lo = min(cfg.prompt_len_min, plen_hi)
    ntok_hi = min(cfg.new_tokens_max, max_new_tokens)
    ntok_lo = min(cfg.new_tokens_min, ntok_hi)
    plan = []
    for i in range(cfg.requests):
        plen = int(rng.randint(plen_lo, plen_hi + 1))
        plan.append({
            "arrival_s": float(arrivals[i]),
            "prompt": rng.randint(0, vocab_size, size=plen).tolist(),
            "max_new_tokens": int(rng.randint(ntok_lo, ntok_hi + 1)),
            "temperature": (
                cfg.temperature
                if rng.random_sample() < cfg.sampled_fraction else 0.0
            ),
            "seed": int(rng.randint(0, 2 ** 31 - 1)),
            "priority": (
                "low"
                if prio_rng.random_sample() < cfg.low_priority_fraction
                else "normal"
            ),
        })
    return plan


def run_load(cfg: LoadConfig, progress=None) -> dict:
    """Fire the configured request mix at the server; returns the
    report dict (see :func:`build_report`)."""
    with ServingClient(cfg.host, cfg.port, timeout_s=10.0) as probe:
        info = probe.ping()
    plan = plan_requests(
        cfg, int(info["vocab_size"]), int(info["max_prompt_len"]),
        int(info["max_new_tokens"]),
    )
    outcomes = [
        RequestOutcome(index=i, arrival_s=p["arrival_s"],
                       priority=p.get("priority", "normal"))
        for i, p in enumerate(plan)
    ]
    t0 = time.perf_counter()

    def fire(i: int):
        spec = plan[i]
        out = outcomes[i]
        out.request_id = str(i)
        # trace minting at the loadgen edge: deterministic head
        # sampling (no RNG - the seeded request plan must not shift
        # when tracing turns on)
        ctx = None
        if cfg.trace_sample > 0.0 \
                and should_sample(i + 1, cfg.trace_sample):
            ctx = TraceContext.mint(qos=spec.get("priority"))
            out.trace_id = ctx.trace_id
        try:
            # connect bounded separately from reads (a vanished target
            # fails the dial in seconds), and deadline_s caps the WHOLE
            # request - a stream dribbling tokens resets the per-read
            # timeout forever and would pin this worker without it
            with ServingClient(
                cfg.host, cfg.port, timeout_s=cfg.timeout_s,
                connect_timeout_s=cfg.connect_timeout_s,
            ) as client:
                reply = client.generate(
                    prompt=spec["prompt"],
                    max_new_tokens=spec["max_new_tokens"],
                    temperature=spec["temperature"], seed=spec["seed"],
                    stream=cfg.stream, request_id=str(i),
                    priority=(spec["priority"]
                              if cfg.low_priority_fraction > 0 else None),
                    deadline_ms=cfg.deadline_ms,
                    deadline_s=cfg.timeout_s,
                    trace=ctx,
                )
        except (OSError, ProtocolError) as exc:
            out.status = "error"
            out.error = str(exc)
            out.done_at_s = time.perf_counter() - t0
            return
        out.done_at_s = time.perf_counter() - t0
        out._reply = reply
        # a router tracing via --trace-sample echoes ITS minted trace
        # id on the final payload - adopt it so the report names a
        # pullable trace even when the loadgen sent none
        if reply.get("trace_id"):
            out.trace_id = str(reply["trace_id"])
        if reply.get("event") == "done":
            out.status = "done"
            out.latency_ms = reply.get("latency_ms")
            out.ttft_ms = reply.get("ttft_ms")
            out.queue_ms = reply.get("queue_ms")
            out.tokens = int(reply.get("token_count", 0))
        else:
            out.status = "shed" if reply.get("shed") else "error"
            out.error = reply.get("error")
        if progress is not None:
            progress(out)

    # dispatcher spawns each worker AT its arrival time, so live thread
    # count tracks in-flight requests - never the whole plan (a 10k-
    # request low-rate run must not reserve 10k thread stacks up front)
    threads: list[threading.Thread] = []
    for i in range(len(plan)):
        delay = t0 + plan[i]["arrival_s"] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        thread = threading.Thread(target=fire, args=(i,), daemon=True,
                                  name=f"pdrnn-loadgen-{i}")
        thread.start()
        threads.append(thread)
    for thread in threads:
        thread.join(timeout=cfg.timeout_s + 30.0)
    wall_s = time.perf_counter() - t0
    # a worker still running past its join timeout is a LOST request;
    # leaving it 'pending' would drop it from done/shed/errors and let
    # the report claim SLO-pass with requests unaccounted for
    for out in outcomes:
        if out.status == "pending":
            out.status = "error"
            out.error = f"no response within {cfg.timeout_s + 30.0:.0f}s"
            out.done_at_s = wall_s
    return build_report(cfg, outcomes, wall_s)


def build_report(cfg: LoadConfig, outcomes: list[RequestOutcome],
                 wall_s: float) -> dict:
    """Aggregate outcomes into the SLO report."""
    done = [o for o in outcomes if o.status == "done"]
    shed = [o for o in outcomes if o.status == "shed"]
    errored = [o for o in outcomes if o.status == "error"]
    lat = sorted(o.latency_ms for o in done if o.latency_ms is not None)
    ttft = sorted(o.ttft_ms for o in done if o.ttft_ms is not None)
    queue = sorted(o.queue_ms for o in done if o.queue_ms is not None)
    tokens = sum(o.tokens for o in done)

    # per-second timeline: what the chaos drill reads the degradation
    # window from (keyed by COMPLETION second)
    seconds: dict[int, dict] = {}
    for o in outcomes:
        if o.done_at_s is None:
            continue
        bucket = seconds.setdefault(
            int(o.done_at_s), {"done": 0, "shed": 0, "error": 0,
                               "latencies_ms": []},
        )
        bucket[o.status] = bucket.get(o.status, 0) + 1
        if o.status == "done" and o.latency_ms is not None:
            bucket["latencies_ms"].append(o.latency_ms)
    timeline = []
    for second in sorted(seconds):
        bucket = seconds[second]
        lats = sorted(bucket.pop("latencies_ms"))
        p95 = _percentile(lats, 0.95)
        degraded = bool(
            bucket["shed"] or bucket["error"]
            or (p95 is not None and p95 > cfg.slo_p95_ms)
        )
        timeline.append({
            "second": second, **bucket, "p95_ms": p95,
            "degraded": degraded,
        })
    degraded_seconds = [t["second"] for t in timeline if t["degraded"]]

    # per-QoS-class breakdown: the fleet drill's shed-ordering check
    # (low must shed first) reads these
    by_priority: dict[str, dict] = {}
    for o in outcomes:
        bucket = by_priority.setdefault(
            o.priority, {"requests": 0, "done": 0, "shed": 0,
                         "errors": 0},
        )
        bucket["requests"] += 1
        key = "errors" if o.status == "error" else o.status
        bucket[key] = bucket.get(key, 0) + 1

    # name the handles a failed drill needs: the slowest completions
    # and every SLO-violating request, each with the trace id (when
    # traced) that pdrnn-metrics trace pulls
    def _named(o: RequestOutcome, **extra) -> dict:
        return {
            "request_id": (o.request_id if o.request_id is not None
                           else str(o.index)),
            "trace_id": o.trace_id, **extra,
        }

    ranked = sorted((o for o in done if o.latency_ms is not None),
                    key=lambda o: -o.latency_ms)
    slowest = [_named(o, latency_ms=o.latency_ms)
               for o in ranked[:SLOWEST_NAMED]]
    violations = []
    for o in done:
        if o.latency_ms is not None and o.latency_ms > cfg.slo_p95_ms:
            violations.append(
                _named(o, reason="latency", latency_ms=o.latency_ms))
        elif cfg.slo_ttft_p95_ms is not None and o.ttft_ms is not None \
                and o.ttft_ms > cfg.slo_ttft_p95_ms:
            violations.append(
                _named(o, reason="ttft", ttft_ms=o.ttft_ms))

    p95 = _percentile(lat, 0.95)
    ttft_p95 = _percentile(ttft, 0.95)
    slo = {
        "p95_ms": cfg.slo_p95_ms,
        "p95_ok": p95 is not None and p95 <= cfg.slo_p95_ms,
    }
    if cfg.slo_ttft_p95_ms is not None:
        slo["ttft_p95_ms"] = cfg.slo_ttft_p95_ms
        slo["ttft_p95_ok"] = (
            ttft_p95 is not None and ttft_p95 <= cfg.slo_ttft_p95_ms
        )
    return {
        "requests": len(outcomes),
        "done": len(done),
        "shed": len(shed),
        "errors": len(errored),
        "error_samples": sorted({o.error for o in errored if o.error})[:5],
        "wall_s": wall_s,
        "tokens": tokens,
        "tokens_per_s": tokens / wall_s if wall_s > 0 else None,
        "requests_per_s": len(done) / wall_s if wall_s > 0 else None,
        "latency_ms": {
            "p50": _percentile(lat, 0.50), "p95": p95,
            "p99": _percentile(lat, 0.99),
            "max": lat[-1] if lat else None,
        },
        "ttft_ms": {
            "p50": _percentile(ttft, 0.50), "p95": ttft_p95,
        },
        "queue_ms": {
            "p50": _percentile(queue, 0.50),
            "p95": _percentile(queue, 0.95),
        },
        "slo": slo,
        "slowest": slowest,
        "slo_violations": violations,
        "by_priority": by_priority,
        "timeline": timeline,
        "degraded_seconds": degraded_seconds,
        "degradation_window_s": (
            [degraded_seconds[0], degraded_seconds[-1]]
            if degraded_seconds else None
        ),
    }


def format_report(report: dict) -> str:
    """Human-readable report (the CLI's default output)."""
    lines = [
        f"requests {report['requests']}: {report['done']} done, "
        f"{report['shed']} shed, {report['errors']} errors "
        f"in {report['wall_s']:.2f}s",
        f"throughput: {report['tokens']} tokens "
        f"({report['tokens_per_s']:.1f} tok/s, "
        f"{report['requests_per_s']:.2f} req/s)"
        if report["tokens_per_s"] is not None else "throughput: n/a",
    ]
    lat, ttft = report["latency_ms"], report["ttft_ms"]
    if lat["p50"] is not None:
        lines.append(
            f"latency ms: p50 {lat['p50']:.1f}  p95 {lat['p95']:.1f}  "
            f"p99 {lat['p99']:.1f}  max {lat['max']:.1f}"
        )
    if ttft["p50"] is not None:
        lines.append(
            f"ttft ms:    p50 {ttft['p50']:.1f}  p95 {ttft['p95']:.1f}"
        )
    slo = report["slo"]
    verdict = "PASS" if slo.get("p95_ok") else "FAIL"
    lines.append(f"SLO p95 <= {slo['p95_ms']:g}ms: {verdict}")
    if "ttft_p95_ok" in slo:
        verdict = "PASS" if slo["ttft_p95_ok"] else "FAIL"
        lines.append(f"SLO ttft p95 <= {slo['ttft_p95_ms']:g}ms: {verdict}")

    def _handle(entry: dict) -> str:
        trace = entry.get("trace_id")
        return (f"request {entry['request_id']}"
                + (f"  trace {trace}" if trace else ""))

    slowest = report.get("slowest") or []
    if slowest:
        lines.append("slowest (pull with pdrnn-metrics trace "
                     "--request ID):")
        for entry in slowest:
            lines.append(
                f"  {entry['latency_ms']:8.1f}ms  {_handle(entry)}")
    violations = report.get("slo_violations") or []
    if violations:
        lines.append(f"SLO violations ({len(violations)}):")
        for entry in violations[:VIOLATIONS_NAMED]:
            value = entry.get("latency_ms", entry.get("ttft_ms"))
            lines.append(
                f"  {value:8.1f}ms  {entry['reason']:<7s} "
                f"{_handle(entry)}")
        if len(violations) > VIOLATIONS_NAMED:
            lines.append(
                f"  ... and {len(violations) - VIOLATIONS_NAMED} more")
    window = report["degradation_window_s"]
    if window:
        lines.append(
            f"DEGRADED seconds {report['degraded_seconds']} "
            f"(window {window[0]}..{window[1]}s)"
        )
    else:
        lines.append("no degraded seconds")
    return "\n".join(lines)
