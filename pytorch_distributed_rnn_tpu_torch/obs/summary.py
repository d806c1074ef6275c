"""Metrics-sidecar loading, per-run summaries, diffs, stragglers.

Shared by the ``pdrnn-metrics`` CLI and the structured-first loader in
``evaluation/analysis.py`` so the two can never disagree on what a
sidecar means.  Loading is STRICT (:class:`MalformedMetricsError` on
any unparseable line, missing ``kind``, or an incompatible schema
declaration): the CI smoke step exists to catch schema drift, and a
loader that shrugs off bad lines would wave it through.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

from pytorch_distributed_rnn_tpu_torch.obs.recorder import SCHEMA_VERSION


class MalformedMetricsError(ValueError):
    """The sidecar is unreadable, unparseable, or schema-incompatible."""


def rank_files(path) -> list[Path]:
    """All per-rank sidecars belonging to one run: the rank-0 file plus
    any ``<stem>-r<k><suffix>`` siblings (``recorder.rank_suffixed``)."""
    path = Path(path)
    files = [path] if path.exists() else []
    pattern = f"{path.stem}-r*{path.suffix}"
    if path.parent.is_dir():
        siblings = [
            p for p in path.parent.glob(pattern)
            if p.stem[len(path.stem):].lstrip("-r").isdigit()
        ]
        files.extend(sorted(siblings))
    return files


def load_events(path) -> list[dict]:
    """One run's events off one JSONL sidecar, validated."""
    path = Path(path)
    try:
        text = path.read_text()
    except OSError as exc:
        raise MalformedMetricsError(f"{path}: unreadable ({exc})") from exc
    events = []
    lines = text.splitlines()
    # a file whose last line is cut off mid-write (no trailing newline)
    # is a process killed mid-append - SIGKILL chaos faults, launcher
    # timeouts - and losing ONE torn event must not forfeit the rest:
    # partial telemetry of crashed runs is what the sidecar exists for.
    # Anything else unparseable is schema drift and stays a hard error.
    truncated_tail = bool(lines) and not text.endswith("\n")
    for lineno, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            event = json.loads(line)
        except json.JSONDecodeError as exc:
            if truncated_tail and lineno == len(lines):
                break
            raise MalformedMetricsError(
                f"{path}:{lineno}: unparseable JSONL ({exc})"
            ) from exc
        if not isinstance(event, dict) or "kind" not in event:
            raise MalformedMetricsError(
                f"{path}:{lineno}: event without a 'kind' field"
            )
        events.append(event)
    if not events:
        raise MalformedMetricsError(f"{path}: empty metrics file")
    head = events[0]
    if head.get("kind") != "meta":
        raise MalformedMetricsError(
            f"{path}: first event must be 'meta', got {head.get('kind')!r}"
        )
    schema = head.get("schema")
    if not isinstance(schema, int) or schema > SCHEMA_VERSION:
        raise MalformedMetricsError(
            f"{path}: schema {schema!r} is newer than this reader's "
            f"{SCHEMA_VERSION}"
        )
    return events


def percentile(sorted_values: list[float], q: float) -> float:
    """Nearest-rank percentile over an ascending-sorted list (NaN when
    empty).  THE percentile convention - shared by the summaries here,
    the serving engine's request-latency stats and the load generator's
    SLO report, so the three can never disagree on what a p95 means."""
    if not sorted_values:
        return float("nan")
    idx = min(len(sorted_values) - 1, int(math.ceil(q * len(sorted_values))) - 1)
    return sorted_values[max(0, idx)]


_percentile = percentile


# serving-run metrics the engine folds into its run_summary event
# (serving/engine.py): request-latency/TTFT percentiles, queue-depth
# percentiles, throughput and shedding.  Passed through verbatim when
# present so `pdrnn-metrics summarize` reads inference sidecars with
# the training analysis unchanged; absent (None) on training runs.
SERVING_SUMMARY_KEYS = (
    "requests", "requests_shed", "requests_failed", "tokens_out",
    "tokens_per_s", "latency_s_p50", "latency_s_p95", "ttft_s_p50",
    "ttft_s_p95", "queue_s_p50", "queue_s_p95", "queue_depth_p50",
    "queue_depth_p95", "queue_depth_max",
)


# streaming actor/learner metrics the learner folds into its
# run_summary event (streaming/learner.py): experience ingest rate,
# applied-update rate, and the bounded-staleness / exactly-once /
# backpressure rejection counters.  Same verbatim-passthrough contract
# as the serving keys: present on a streaming learner's sidecar, absent
# (None, not 0) on every other run.
STREAMING_SUMMARY_KEYS = (
    "experience_batches", "experience_per_s", "updates_per_s",
    "stale_rejected", "queue_sheds", "duplicates", "poisoned",
    "staleness_p50", "staleness_p95", "final_version", "rejoins",
)


# serving-fleet router metrics the router folds into its run_summary
# event (serving/fleet/router.py): dispatch/retry/hedge accounting and
# the breaker transition counters.  Same verbatim-passthrough contract
# as the serving keys: present on a pdrnn-router sidecar, absent (None,
# not 0) on every other run.
ROUTER_SUMMARY_KEYS = (
    "routed", "rerouted", "retries", "hedges", "hedge_wins",
    "router_shed", "router_errors", "stream_aborts",
    "replica_ejections", "replica_readmissions", "drain_rejected",
)


def _phase_bytes(collectives, op_kinds):
    """Per-step bytes of the named traced collective op kinds, or None
    when the run has no per-op breakdown (host-loop steps record the
    collectives event with ``ops=None``)."""
    if not collectives or not collectives.get("ops"):
        return None
    ops = collectives["ops"]
    return int(sum(ops[k]["bytes"] for k in op_kinds if k in ops))


def summarize_events(events: list[dict], path=None) -> dict:
    """One rank's summary: the numbers ``pdrnn-metrics summarize`` prints
    and ``evaluation/analysis.py`` folds into the measurement dataframe."""
    meta = events[0]
    steps = [e for e in events if e["kind"] == "step"]
    epochs = [e for e in events if e["kind"] == "epoch"]
    run = next(
        (e for e in reversed(events) if e["kind"] == "run_summary"), None
    )
    collectives = next(
        (e for e in events if e["kind"] == "collectives"), None
    )

    # warm-up exclusion for TIMING stats: the run's first step carries
    # the compile (orders of magnitude above steady state on a jit
    # framework) and would dominate every mean/percentile
    if len(steps) > 1:
        first = min(int(e.get("step", 0)) for e in steps)
        timed = [e for e in steps if int(e.get("step", 0)) != first]
    else:
        timed = steps
    dispatch = [float(e["dispatch_s"]) for e in timed if "dispatch_s" in e]
    fenced = sorted(
        float(e["fenced_s"]) for e in timed if e.get("fenced_s") is not None
    )
    data_wait = [float(e.get("data_wait_s", 0.0)) for e in steps]
    # per-step host-collective telemetry (native ring): comm_wait_s is
    # the wall the host sat blocked in collectives, overlap_frac the
    # share of wire time hidden behind compute.  None-not-0: strategies
    # without host collectives never carry the fields.  Same warm-up
    # exclusion as the timing stats - the first step's waits include
    # compile-skewed scheduling.
    comm_wait = [
        float(e["comm_wait_s"]) for e in timed
        if e.get("comm_wait_s") is not None
    ]
    overlap = [
        float(e["overlap_frac"]) for e in timed
        if e.get("overlap_frac") is not None
    ]
    losses = [float(e["loss"]) for e in steps if e.get("loss") is not None]
    if not losses:
        losses = [float(e["loss"]) for e in epochs if e.get("loss") is not None]

    epoch_wall = sum(
        float(e["wall_s"]) for e in epochs if e.get("wall_s") is not None
    )
    # data-wait fraction: input-pipeline stall share of the epochs' wall
    # time; falls back to dispatch time when no epoch event carries wall
    denom = epoch_wall or sum(dispatch) or float("nan")
    wait_total = sum(data_wait)

    # step wall time: the fenced samples are honest wall clock (dispatch
    # alone understates an async step by the device time)
    step_basis = fenced or sorted(dispatch)

    summary = {
        "path": str(path) if path is not None else None,
        "rank": int(meta.get("rank", 0)),
        "schema": meta.get("schema"),
        "steps": len(steps),
        "epochs": len(epochs),
        "fenced_samples": len(fenced),
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "step_s_mean": (sum(step_basis) / len(step_basis))
        if step_basis else None,
        "step_s_p50": _percentile(step_basis, 0.50) if step_basis else None,
        "step_s_p95": _percentile(step_basis, 0.95) if step_basis else None,
        "data_wait_s": wait_total,
        "data_wait_frac": (wait_total / denom)
        if denom == denom and denom > 0 else None,
        "comm_wait_s": sum(comm_wait) if comm_wait else None,
        "comm_wait_s_mean": (sum(comm_wait) / len(comm_wait))
        if comm_wait else None,
        "overlap_frac": (sum(overlap) / len(overlap)) if overlap else None,
        "collective_bytes_per_step": (
            collectives.get("bytes_per_step") if collectives else None
        ),
        "collective_ops": collectives.get("ops") if collectives else None,
        # per-phase split of the traced collective traffic: gradient
        # phase = all-reduce; update phase = reduce-scatter + all-gather
        # (the sharded weight update's signature, 2004.13336) - so the
        # ~2x update-bytes drop is a diffable, gateable number
        "collective_grad_bytes_per_step": _phase_bytes(
            collectives, ("all-reduce",)
        ),
        "collective_update_bytes_per_step": _phase_bytes(
            collectives, ("reduce-scatter", "all-gather")
        ),
        # .get: a run_summary is not obliged to carry every field (the
        # serving engine has no memory_profiler wrap, for one); absent
        # optional metrics are None, never a loader error
        "duration_s": (
            float(run["duration_s"])
            if run and run.get("duration_s") is not None else None
        ),
        "memory_mb": (
            float(run["memory_mb"])
            if run and run.get("memory_mb") is not None else None
        ),
        "device_peak_mb": (
            max(run["device_peaks_mb"].values())
            if run and run.get("device_peaks_mb") else None
        ),
        "nan_skipped": (run or {}).get("nan_skipped", 0),
        "faults_fired": (run or {}).get("faults_fired", {}),
        "checkpoint_saves": sum(
            1 for e in events if e["kind"] == "checkpoint_save"
        ),
        # post-warm-up retraces (training/base.py emits a `compile`
        # event when a step function's trace-cache size bumps after its
        # first compile).  None-not-0: pre-ledger sidecars never carry
        # the event and must not read as "zero recompiles, verified".
        "recompiles": sum(
            1 for e in events if e["kind"] == "compile"
        ) or None,
        "ps_exchanges": sum(
            1 for e in events if e["kind"] == "ps_exchange"
        ),
        "ps_retries": sum(
            int(e.get("retries", 0)) for e in events
            if e["kind"] == "ps_exchange"
        ),
        "ps_degraded_rounds": sum(
            1 for e in events
            # schema 1 recorded degraded rounds as ps_round point
            # events; schema 2 emits a ps_round SPAN per round with a
            # degraded attribute
            if e.get("degraded") and (
                e["kind"] == "ps_round"
                or (e["kind"] == "span" and e.get("name") == "ps_round")
            )
        ),
    }
    # watchdog alerts (obs/watchdog.py): count + by-kind breakdown;
    # None (not 0) on alert-free runs so the text summary stays quiet
    alerts = [e for e in events if e["kind"] == "alert"]
    if alerts:
        by_kind: dict[str, int] = {}
        for e in alerts:
            kind = str(e.get("alert", "?"))
            by_kind[kind] = by_kind.get(kind, 0) + 1
        summary["alerts"] = len(alerts)
        summary["alerts_by_kind"] = by_kind
    else:
        summary["alerts"] = None
        summary["alerts_by_kind"] = None
    # elastic membership (resilience/membership.py): transition counts
    # off this rank's stream - the master's sidecar carries the whole
    # roster story, workers their own join/drain.  None (not 0) on
    # non-elastic runs so the text summary stays noise-free.
    member_counts = {
        "member_joins": sum(
            1 for e in events if e["kind"] == "member_join"
        ),
        "member_rejoins": sum(
            1 for e in events
            if e["kind"] == "member_join" and e.get("rejoin")
        ),
        "member_drains": sum(
            1 for e in events if e["kind"] == "member_drain"
        ),
        "member_deaths": sum(
            1 for e in events if e["kind"] == "member_dead"
        ),
    }
    if any(member_counts.values()):
        summary.update(member_counts)
    else:
        summary.update(dict.fromkeys(member_counts))
    # MPMD pipeline recovery (parallel/mpmd.py): restarts of this stage
    # plus microbatch frames its links replayed to restarted neighbors.
    # Same None-not-0 convention as the membership counts above.
    stage_counts = {
        "stage_restarts": sum(
            1 for e in events if e["kind"] == "stage_restart"
        ),
        "replayed_microbatches": sum(
            int(e.get("count", 0)) for e in events if e["kind"] == "replay"
        ),
    }
    if any(stage_counts.values()):
        summary.update(stage_counts)
    else:
        summary.update(dict.fromkeys(stage_counts))
    if run and run.get("roster") is not None:
        summary["roster"] = run["roster"]
    if run:
        for key in (SERVING_SUMMARY_KEYS + STREAMING_SUMMARY_KEYS
                    + ROUTER_SUMMARY_KEYS):
            if key in run:
                summary[key] = run[key]
    # efficiency-ledger ratios (obs/ledger.py): goodput, its inverse
    # badput_frac (the diffable direction - see REGRESSION_METRICS),
    # fault tax and the comm-wait share of wall.  None, never 0, on
    # schema-1 sidecars: the ledger needs the monotonic clock, and an
    # uninstrumented run must not read as "goodput zero".
    try:
        from pytorch_distributed_rnn_tpu_torch.obs.ledger import ledger_events

        led = ledger_events(events)
    except MalformedMetricsError:
        led = None
    summary["goodput"] = led["goodput"] if led else None
    summary["badput_frac"] = (1.0 - led["goodput"]) if led else None
    summary["fault_tax_s"] = led["fault_tax_s"] if led else None
    summary["comm_wait_frac"] = led["comm_wait_frac"] if led else None
    summary["mfu_est"] = led["mfu_est"] if led else None
    return summary


def summarize_file(path) -> dict:
    return summarize_events(load_events(path), path=path)


def summarize_run(path) -> list[dict]:
    """Per-rank summaries for one run's sidecar family (rank-0 path plus
    ``-r<k>`` siblings), sorted by rank."""
    files = rank_files(path)
    if not files:
        raise MalformedMetricsError(f"{path}: no metrics sidecar found")
    return sorted(
        (summarize_file(p) for p in files), key=lambda s: s["rank"]
    )


# metrics where "bigger" is a regression, diffed by pdrnn-metrics diff.
# The per-phase collective bytes gate the sharded-update win: a change
# that re-inflates update-phase traffic (or gradient-phase traffic)
# trips the diff exit contract.  Replicated baselines report update
# bytes of 0, which the <= 0 guard in diff_summaries skips - turning
# sharding ON can never read as a regression against them.
REGRESSION_METRICS = (
    "step_s_mean", "step_s_p95", "duration_s", "memory_mb",
    "device_peak_mb", "data_wait_frac",
    # host-collective blocked wall (native ring): overlap regressions -
    # a schedule change that re-serializes comm behind compute - show up
    # here before they dent step_s_mean.  overlap_frac is deliberately
    # NOT listed: bigger is better, the wait metric already covers it.
    "comm_wait_s", "comm_wait_s_mean",
    "collective_grad_bytes_per_step", "collective_update_bytes_per_step",
    # efficiency-ledger ratios (obs/ledger.py).  goodput itself is
    # bigger-is-better and therefore NOT listed (the overlap_frac
    # precedent): its inverse badput_frac is the gated direction.
    # fault_tax_s is 0 on clean baselines, which the <= 0 guard skips -
    # turning chaos ON can never read as a regression against them; on
    # schema-1 sidecars all three are None (skipped the same way).
    "badput_frac", "fault_tax_s", "comm_wait_frac",
)


def diff_summaries(baseline: dict, candidate: dict,
                   threshold_pct: float = 10.0) -> list[dict]:
    """Regressions of ``candidate`` vs ``baseline``: every
    :data:`REGRESSION_METRICS` entry present in both and worse by more
    than ``threshold_pct`` percent."""
    regressions = []
    for metric in REGRESSION_METRICS:
        base, cand = baseline.get(metric), candidate.get(metric)
        if base is None or cand is None or base <= 0:
            continue
        delta_pct = 100.0 * (cand - base) / base
        if delta_pct > threshold_pct:
            regressions.append({
                "metric": metric,
                "baseline": base,
                "candidate": cand,
                "delta_pct": delta_pct,
            })
    return regressions


# events that witness forward progress (vs mere liveness): everything a
# run emits except the writer thread's own heartbeats, the meta head,
# and watchdog alerts - a STALL alert is evidence of the opposite of
# progress, and counting it would flip the stalled rank back to ok
_NON_PROGRESS_KINDS = ("meta", "heartbeat", "alert")


def rank_health(events: list[dict], now: float | None = None,
                stale_after: float = 30.0) -> dict:
    """One rank's liveness verdict from its event stream.

    Three signals: the last event of ANY kind (the writer thread's
    heartbeats keep this fresh as long as the process lives), the last
    *progress* (any non-heartbeat event, or a heartbeat whose noted
    ``progress`` step advanced), and whether the run finished (a
    ``run_summary`` landed) or the rank left voluntarily (a
    ``member_drain`` landed - the DEREGISTER half of preemption-aware
    drain).  Status:

    - ``finished`` - run_summary present (age is irrelevant);
    - ``drained``  - the rank deregistered on purpose (SIGTERM drain):
      its stream going stale afterwards is the EXPECTED shape of a
      voluntary leave, not a death - healthy, exit 0;
    - ``dead``     - nothing at all for ``stale_after`` seconds: the
      process stopped flushing (killed, wedged below Python);
    - ``recovering`` - heartbeats fresh, no progress, but the last
      thing this rank did was a ``stage_restart`` with no ``step``
      landed since: a respawned MPMD stage still restoring its
      checkpoint and retracing its programs.  The same verdict covers a
      streaming actor (``role: actor`` in its meta head) that
      registered with the learner - a ``state_sync`` span or
      ``actor_reconnect`` landed - but has not pushed a batch since:
      it is compiling its rollout or riding out backpressure, not
      wedged.  Expected recovery work, not a stall - healthy, exit 0;
    - ``stalled``  - heartbeats fresh but no progress for
      ``stale_after`` seconds: alive and stuck (the chaos harness's
      ``stall`` fault, a hung collective, a starved loader);
    - ``ok``       - otherwise.
    """
    if now is None:
        import time

        now = time.time()
    rank = int(events[0].get("rank", 0))
    finished = any(e["kind"] == "run_summary" for e in events)
    # only a drain of THIS rank counts: the master's sidecar carries
    # member_drain events for its WORKERS (rank_slot != 0) and must not
    # classify the master itself as drained mid-run
    drained = any(
        e["kind"] == "member_drain"
        and int(e.get("rank_slot", e["rank"])) == rank
        for e in events
    )
    last_t = max(float(e["t"]) for e in events)
    progress_ts = [
        float(e["t"]) for e in events
        if e["kind"] not in _NON_PROGRESS_KINDS
    ]
    noted = None
    for e in events:
        if e["kind"] == "heartbeat" and e.get("progress") is not None \
                and e["progress"] != noted:
            noted = e["progress"]
            progress_ts.append(float(e["t"]))
    last_progress_t = max(progress_ts) if progress_ts else float(
        events[0]["t"]
    )
    if finished:
        status = "finished"
    elif drained:
        status = "drained"
    elif now - last_t > stale_after:
        status = "dead"
    elif now - last_progress_t > stale_after:
        # a respawned stage restoring + retracing is working, not stuck
        # - but only until its first post-restart step lands; after
        # that, silence is an ordinary stall again.  A stage whose
        # heartbeats also stopped stays DEAD (branch above): respawn
        # grace never masks a killed process.
        restart_ts = [
            float(e["t"]) for e in events if e["kind"] == "stage_restart"
        ]
        # a streaming actor's registration witnesses play the same role
        # as a stage_restart: joined/rejoined the learner, first push
        # still pending.  Gated on the actor role so a PS/streaming
        # MASTER's sidecar (which carries state_sync spans for its
        # members' joins) can never launder its own stall as recovery.
        if events[0].get("role") == "actor":
            restart_ts += [
                float(e["t"]) for e in events
                if e["kind"] == "actor_reconnect"
                or (e["kind"] == "span" and e.get("name") == "state_sync")
            ]
            restart_ts.sort()
        stepped_since = restart_ts and any(
            e["kind"] == "step" and float(e["t"]) >= restart_ts[-1]
            for e in events
        )
        if restart_ts and not stepped_since:
            status = "recovering"
        else:
            status = "stalled"
    else:
        status = "ok"
    return {
        "rank": rank,
        "status": status,
        "last_event_age_s": now - last_t,
        "last_progress_age_s": now - last_progress_t,
        "finished": finished,
        "drained": drained,
    }


def detect_stragglers(summaries: list[dict],
                      threshold: float = 0.25) -> list[dict]:
    """Cross-rank straggler detection: ranks whose mean step time sits
    more than ``threshold`` (fraction) above the cross-rank median.
    Needs >= 2 ranks with step-time data; returns ``[{rank, step_s_mean,
    median_s, excess_frac}, ...]``."""
    timed = [
        s for s in summaries if s.get("step_s_mean") is not None
    ]
    if len(timed) < 2:
        return []
    median = statistics.median(s["step_s_mean"] for s in timed)
    if median <= 0:
        return []
    flagged = []
    for s in timed:
        excess = s["step_s_mean"] / median - 1.0
        if excess > threshold:
            flagged.append({
                "rank": s["rank"],
                "path": s.get("path"),
                "step_s_mean": s["step_s_mean"],
                "median_s": median,
                "excess_frac": excess,
            })
    return sorted(flagged, key=lambda f: -f["excess_frac"])
