"""Efficiency ledger: every second of a run's wall-clock, accounted.

The fourth obs layer.  The recorder (layer 1) writes events, summaries
(layer 2) reduce them, the timeline (layer 3) draws them - this module
*prices* them: it classifies a run's wall-clock into an exhaustive phase
ledger and divides analytic FLOPs (``obs/flops.py``) by hardware peaks
(``utils/hw.py``) so chaos drills, schedulers and cross-PR diffs all
argue over the same four numbers:

- **goodput**  - fraction of wall-clock spent in steps that advanced
  the model (compute phase; nan-skipped step time excluded);
- **MFU/HFU** - analytic model FLOPs per step (counted off the traced
  jaxpr, recorded on the ``collectives`` event) against the claimed
  per-backend peak.  The two are equal when nothing rematerializes -
  true of every step program in this tree - and the CPU peak is an
  ESTIMATE, labeled as such wherever it is printed;
- **fault tax** - wall-clock attributable to injected/observed faults:
  chaos stall windows, nan-skipped step time, the tail a kill cut off,
  and restart/replay lag;
- **phase fractions** - compute / comm_wait / data_wait / compile /
  checkpoint / eval / restart / fault / idle, provably summing to 1:
  idle is the residual, and over-attribution (overlapping
  instrumentation) is scaled down proportionally before the residual
  is taken, so the invariant holds by construction.

Accounting notes, in decreasing order of certainty:

- step/epoch/span/checkpoint durations are measured wall-clock;
- per-step sums (data wait, comm wait, step time) are scaled from the
  SAMPLED step events to the full step span (``--metrics-sample-every``
  keeps hot-loop overhead down; the ledger multiplies the means back);
- a producer-side chaos stall surfaces as consumer data wait, so
  ``fault_stall`` span time is moved from the data_wait phase to the
  fault phase rather than double-counted;
- compile time is the first step's excess over the steady-state mean
  plus any ``compile`` events (retraces after warm-up);
- MPMD stage steps time the whole iteration including link waits, so a
  stage's compute phase upper-bounds its true compute and the derived
  bubble fraction is a lower bound.

Schema contract: like the timeline, the ledger needs the monotonic
``tm`` clock and therefore a schema >= 2 sidecar -
:class:`MalformedMetricsError` (CLI exit 2) on older recordings.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

from pytorch_distributed_rnn_tpu_torch.obs.summary import (
    MalformedMetricsError,
    load_events,
    rank_files,
)

LEDGER_PHASES = (
    "compute", "comm_wait", "data_wait", "compile", "checkpoint",
    "eval", "restart", "fault", "idle",
)

# phase fractions must sum to 1 within this tolerance (pinned by tests
# and the acceptance criteria; the residual construction guarantees it)
FRACTION_TOL = 1e-6

# fault actions that end the process: their sidecars get a lost-tail
# fault attribution (wall between the last step and the stream's end)
_FATAL_ACTIONS = ("kill", "respawn", "preempt")


def _step_time(e) -> float:
    d = e.get("fenced_s")
    if d is None:
        d = e.get("dispatch_s")
    return float(d or 0.0)


def _mono_end(e) -> float | None:
    """Monotonic end stamp of one event, or None when it carries no tm
    (the launcher's wall-clock-only root span)."""
    tm = e.get("tm")
    if tm is None:
        return None
    tm = float(tm)
    kind = e["kind"]
    # only kinds whose tm is a START stamp extend by their duration;
    # checkpoint events stamp at completion already
    if kind == "step":
        return tm + _step_time(e)
    if kind == "span":
        return tm + float(e.get("dur_s") or 0.0)
    if kind == "epoch":
        return tm + float(e.get("wall_s") or 0.0)
    return tm


def ledger_events(events: list[dict], path=None, peak: dict | None = None,
                  ) -> dict:
    """One rank's efficiency ledger off its event list.

    Raises :class:`MalformedMetricsError` on schema-1 sidecars (no
    monotonic clock - same contract as the timeline exporter).  Never
    raises on zero-step or torn runs: partial telemetry of crashed runs
    is exactly what the fault-tax column prices.
    """
    meta = events[0]
    if meta.get("tm") is None:
        raise MalformedMetricsError(
            f"{path or 'sidecar'}: the efficiency ledger needs a schema "
            ">= 2 recording (monotonic tm clock in the meta head); "
            "re-record with the current MetricsRecorder"
        )
    t0 = float(meta["tm"])
    end = t0
    for e in events:
        stamp = _mono_end(e)
        if stamp is not None:
            end = max(end, stamp)
    wall_s = max(0.0, end - t0)

    steps = sorted(
        (e for e in events if e["kind"] == "step"),
        key=lambda e: int(e.get("step", 0)),
    )
    run = next(
        (e for e in reversed(events) if e["kind"] == "run_summary"), None
    )
    collectives = next(
        (e for e in events if e["kind"] == "collectives"), None
    )
    n_sampled = len(steps)
    if steps:
        span_steps = (
            int(steps[-1].get("step", 0)) - int(steps[0].get("step", 0)) + 1
        )
    else:
        span_steps = 0

    first_time = _step_time(steps[0]) if steps else 0.0
    rest_times = [_step_time(e) for e in steps[1:]]
    mean_rest = (
        sum(rest_times) / len(rest_times) if rest_times else None
    )

    def per_step_total(field) -> float:
        """Sampled mean x full step span: the sampled-cadence rescale."""
        vals = [float(e[field]) for e in steps
                if e.get(field) is not None]
        if not vals:
            return 0.0
        return (sum(vals) / len(vals)) * span_steps

    data_wait_s = per_step_total("data_wait_s")
    comm_wait_s = per_step_total("comm_wait_s")

    compiles = [e for e in events if e["kind"] == "compile"]
    compile_warmup_s = (
        max(0.0, first_time - (mean_rest or 0.0)) if steps else 0.0
    )
    compile_s = compile_warmup_s + sum(
        float(e.get("seconds") or 0.0) for e in compiles
    )

    spans = [e for e in events if e["kind"] == "span"]
    fault_stall_s = sum(
        float(e.get("dur_s") or 0.0) for e in spans
        if e.get("name") == "fault_stall"
    )
    eval_s = sum(
        float(e.get("dur_s") or 0.0) for e in spans
        if e.get("cat") == "eval"
    )
    checkpoint_s = sum(
        float(e.get("seconds") or 0.0) for e in events
        if e["kind"] in ("checkpoint_save", "checkpoint_restore")
    )
    # a respawned MPMD stage's window from process start to its
    # stage_restart witness is restore+resync lag nothing else accounts
    restart_s = sum(
        max(0.0, float(e["tm"]) - t0)
        for e in events
        if e["kind"] == "stage_restart" and e.get("tm") is not None
    )
    replayed = sum(
        int(e.get("count", 0)) for e in events if e["kind"] == "replay"
    )

    nan_total = int((run or {}).get("nan_skipped") or 0)
    if not nan_total:
        nan_total = max(
            (int(e.get("total", 0)) for e in events
             if e["kind"] == "nan_skip"), default=0,
        )
    nan_tax_s = nan_total * (mean_rest or 0.0)

    fatal_fault = any(
        e["kind"] == "fault" and e.get("action") in _FATAL_ACTIONS
        for e in events
    )
    lost_tail_s = 0.0
    if fatal_fault and steps:
        last_step_end = max(
            float(e["tm"]) + _step_time(e) for e in steps
            if e.get("tm") is not None
        )
        lost_tail_s = max(0.0, end - last_step_end)
    fault_s = fault_stall_s + nan_tax_s + lost_tail_s

    # the injected stall blocks the producer; the consumer measures it
    # as data wait - attribute it to the fault phase, once
    data_wait_adj = max(0.0, data_wait_s - fault_stall_s)

    epoch_wall = sum(
        float(e["wall_s"]) for e in events
        if e["kind"] == "epoch" and e.get("wall_s") is not None
    )
    if epoch_wall > 0:
        # epoch windows cover the whole step loop (sampled or not);
        # carve the known non-compute residents out of them
        compute_s = (
            epoch_wall - data_wait_adj - comm_wait_s - compile_s
            - fault_stall_s - nan_tax_s
        )
    else:
        # no epoch walls (MPMD stages, fused runs, streaming): rebuild
        # from the per-step times themselves
        total_step_time = first_time + (
            (mean_rest or 0.0) * max(0, span_steps - 1)
        )
        compute_s = total_step_time - compile_s - comm_wait_s - nan_tax_s
    compute_s = max(0.0, compute_s)

    phase_s = {
        "compute": compute_s,
        "comm_wait": comm_wait_s,
        "data_wait": data_wait_adj,
        "compile": compile_s,
        "checkpoint": checkpoint_s,
        "eval": eval_s,
        "restart": restart_s,
        "fault": fault_s,
    }
    attributed = sum(phase_s.values())
    if wall_s <= 0.0:
        # degenerate (zero-duration) stream: nothing to apportion
        phase_s = dict.fromkeys(phase_s, 0.0)
        fractions = dict.fromkeys(LEDGER_PHASES, 0.0)
        fractions["idle"] = 1.0
        wall_s = 0.0
    else:
        if attributed > wall_s:
            # overlapping instrumentation over-attributed: scale down
            # proportionally so the residual construction stays valid
            factor = wall_s / attributed
            phase_s = {k: v * factor for k, v in phase_s.items()}
        fractions = {k: v / wall_s for k, v in phase_s.items()}
        fractions["idle"] = max(
            0.0, 1.0 - sum(fractions[p] for p in phase_s)
        )
    phase_s["idle"] = fractions["idle"] * wall_s

    goodput = fractions["compute"]
    fault_tax_s = phase_s["fault"] + phase_s["restart"]

    flops_per_step = None
    flops_exact = None
    if collectives is not None:
        flops_per_step = collectives.get("model_flops_per_step")
        flops_exact = collectives.get("model_flops_exact")
    run_ledger = (run or {}).get("ledger") or {}
    if flops_per_step is None:
        flops_per_step = run_ledger.get("model_flops_per_step")

    mfu_est = hfu_est = None
    peak_total = run_ledger.get("peak_flops_total")
    peak_estimated = run_ledger.get("peak_flops_estimated")
    peak_device = run_ledger.get("device_kind")
    if flops_per_step is not None and wall_s > 0 and span_steps:
        if peak_total is None:
            if peak is None:
                from pytorch_distributed_rnn_tpu_torch.utils.hw import (
                    local_peak_flops,
                )

                peak = local_peak_flops()
            peak_total = peak["peak_flops_total"]
            peak_estimated = peak["estimated"]
            peak_device = peak.get("device")
        steps_advanced = max(0, span_steps - nan_total)
        # the traced jaxpr counts EXECUTED flops (an HFU numerator);
        # with no rematerialization in the tree it is also the model
        # flop count, so the two utilizations coincide here
        hfu_est = (
            float(flops_per_step) * steps_advanced / (wall_s * peak_total)
        )
        mfu_est = hfu_est

    return {
        "path": str(path) if path is not None else None,
        "rank": int(meta.get("rank", 0)),
        "role": meta.get("role"),
        "stage": meta.get("stage"),
        "wall_s": wall_s,
        "steps_sampled": n_sampled,
        "steps_est": span_steps,
        "phase_s": phase_s,
        "fractions": fractions,
        "goodput": goodput,
        "fault_tax_s": fault_tax_s,
        "comm_wait_frac": fractions["comm_wait"],
        "recompiles": len(compiles),
        "replayed_microbatches": replayed or None,
        "nan_skipped": nan_total,
        "flops_per_step": flops_per_step,
        "flops_exact": flops_exact,
        "mfu_est": mfu_est,
        "hfu_est": hfu_est,
        "peak_flops_total": peak_total,
        "peak_estimated": peak_estimated,
        "peak_device": peak_device,
        # streaming learner bookkeeping (None elsewhere): time the
        # learner spent ingesting batches it then rejected
        "reject_tax_s": _reject_tax(run),
    }


def _reject_tax(run) -> float | None:
    """Stale/duplicate/shed ingest tax on a streaming learner: rejected
    batches still cost one ingest each at the observed ingest rate."""
    if not run or "stale_rejected" not in run:
        return None
    rate = run.get("experience_per_s")
    if not rate:
        return None
    rejected = (
        int(run.get("stale_rejected") or 0)
        + int(run.get("duplicates") or 0)
        + int(run.get("queue_sheds") or 0)
    )
    return rejected / float(rate)


def ledger_file(path, peak: dict | None = None) -> dict:
    return ledger_events(load_events(path), path=path, peak=peak)


def ledger_run(path, peak: dict | None = None) -> dict:
    """The whole run's ledger: per-rank ledgers (rank-0 sidecar plus
    ``-r<k>`` siblings), a wall-weighted aggregate, and - when the meta
    roles say so - an MPMD per-stage view with bubble fraction or a
    streaming actor/learner split."""
    files = rank_files(path)
    if not files:
        raise MalformedMetricsError(f"{path}: no metrics sidecar found")
    ranks = [ledger_file(p, peak=peak) for p in files]
    ranks.sort(key=lambda r: r["rank"])

    wall_total = sum(r["wall_s"] for r in ranks)
    wall_max = max(r["wall_s"] for r in ranks)
    phase_s = {
        p: sum(r["phase_s"][p] for r in ranks) for p in LEDGER_PHASES
    }
    if wall_total > 0:
        fractions = {p: phase_s[p] / wall_total for p in LEDGER_PHASES}
    else:
        fractions = dict.fromkeys(LEDGER_PHASES, 0.0)
        fractions["idle"] = 1.0

    flops = [r["flops_per_step"] for r in ranks
             if r["flops_per_step"] is not None]
    peaks = [r["peak_flops_total"] for r in ranks
             if r["peak_flops_total"] is not None]
    steps_est = max(r["steps_est"] for r in ranks)
    nan_total = sum(r["nan_skipped"] for r in ranks)
    mfu_est = None
    if flops and peaks and wall_max > 0 and steps_est:
        # SPMD ranks trace the same GLOBAL program: take the flops once,
        # sum the per-process peaks
        mfu_est = (
            max(flops) * max(0, steps_est - nan_total)
            / (wall_max * sum(peaks))
        )

    aggregate = {
        "wall_s": wall_max,
        "phase_s": phase_s,
        "fractions": fractions,
        "goodput": fractions["compute"],
        "fault_tax_s": sum(r["fault_tax_s"] for r in ranks),
        "comm_wait_frac": fractions["comm_wait"],
        "recompiles": sum(r["recompiles"] for r in ranks),
        "steps_est": steps_est,
        "mfu_est": mfu_est,
        "peak_estimated": any(r["peak_estimated"] for r in ranks) or None,
    }
    out = {"path": str(path), "ranks": ranks, "aggregate": aggregate}

    stages = [r for r in ranks if r.get("stage") is not None]
    if stages:
        compute = [r["phase_s"]["compute"] for r in stages]
        peak_stage = max(compute)
        out["mpmd"] = {
            "stages": {
                int(r["stage"]): {
                    "goodput": r["goodput"],
                    "compute_s": r["phase_s"]["compute"],
                    "fault_tax_s": r["fault_tax_s"],
                } for r in stages
            },
            # classic pipeline-bubble measure over per-stage busy time;
            # stage step timing includes link waits, so this is a LOWER
            # bound on the true bubble (see module docstring)
            "bubble_frac": (
                1.0 - sum(compute) / (len(compute) * peak_stage)
                if peak_stage > 0 else None
            ),
        }

    actors = [r for r in ranks if r.get("role") == "actor"]
    learners = [r for r in ranks if r.get("role") == "learner"]
    if actors or learners:
        out["streaming"] = {
            "learner": (
                {
                    "goodput": learners[0]["goodput"],
                    "reject_tax_s": learners[0]["reject_tax_s"],
                } if learners else None
            ),
            "actors": {
                "count": len(actors),
                "goodput_mean": (
                    sum(a["goodput"] for a in actors) / len(actors)
                    if actors else None
                ),
            },
        }
    return out


# -- cross-run regression contract --------------------------------------------

# metrics the regress gate checks per config key; direction "up" means
# a rise is the regression (fault/comm fractions), "down" a drop
# (goodput).  mfu is deliberately NOT gated: on shared CI hosts the CPU
# peak is an estimate and absolute utilization is noise - the goodput
# fraction already carries the same signal relative to the run itself.
REGRESS_METRICS = (
    ("goodput", "down"),
    ("fault_tax_frac", "up"),
    ("comm_wait_frac", "up"),
)


def history_record(run_ledger: dict, key: str) -> dict:
    """One ``ledger_history.jsonl`` line for a run's aggregate ledger."""
    agg = run_ledger["aggregate"]
    wall = agg["wall_s"]
    return {
        "key": str(key),
        "goodput": agg["goodput"],
        "mfu_est": agg["mfu_est"],
        "fault_tax_s": agg["fault_tax_s"],
        "fault_tax_frac": (agg["fault_tax_s"] / wall) if wall > 0 else 0.0,
        "comm_wait_frac": agg["comm_wait_frac"],
        "wall_s": wall,
        "steps": agg["steps_est"],
    }


def append_history(history_path, record: dict) -> None:
    path = Path(history_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("a") as f:
        f.write(json.dumps(record) + "\n")


def load_history(history_path) -> list[dict]:
    path = Path(history_path)
    try:
        text = path.read_text()
    except OSError as exc:
        raise MalformedMetricsError(
            f"{path}: unreadable history ({exc})"
        ) from exc
    records = []
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        try:
            record = json.loads(line)
        except json.JSONDecodeError as exc:
            raise MalformedMetricsError(
                f"{path}:{lineno}: unparseable history line ({exc})"
            ) from exc
        if not isinstance(record, dict) or "key" not in record:
            raise MalformedMetricsError(
                f"{path}:{lineno}: history record without a 'key'"
            )
        records.append(record)
    if not records:
        raise MalformedMetricsError(f"{path}: empty ledger history")
    return records


def check_history(records: list[dict], threshold: float = 0.2,
                  floor: float = 0.05) -> dict:
    """Latest run per key vs the median of its predecessors.

    A regression needs to clear BOTH the relative ``threshold`` and the
    absolute ``floor`` (in fraction points) - same-config reruns on
    noisy shared hosts must stay green, which is the whole point of
    gating on ratios instead of wall-clock.
    """
    by_key: dict[str, list[dict]] = {}
    for record in records:
        by_key.setdefault(record["key"], []).append(record)
    regressions = []
    compared = 0
    for key, group in sorted(by_key.items()):
        if len(group) < 2:
            continue
        compared += 1
        latest = group[-1]
        for metric, direction in REGRESS_METRICS:
            prior_vals = [
                float(r[metric]) for r in group[:-1]
                if r.get(metric) is not None
            ]
            value = latest.get(metric)
            if not prior_vals or value is None:
                continue
            prior = statistics.median(prior_vals)
            slack = max(floor, threshold * abs(prior))
            delta = float(value) - prior
            if (direction == "down" and -delta > slack) or (
                    direction == "up" and delta > slack):
                regressions.append({
                    "key": key,
                    "metric": metric,
                    "prior_median": prior,
                    "latest": value,
                    "delta": delta,
                })
    return {
        "keys": len(by_key),
        "compared": compared,
        "regressions": regressions,
    }
