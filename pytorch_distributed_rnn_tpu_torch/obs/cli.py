"""``python -m pytorch_distributed_rnn_tpu_torch.obs``: summarize / diff /
stragglers / timeline / trace / attribute / health / ledger / regress /
watch / top over metrics sidecars, the JAX package's ``pdrnn-metrics``.

Exit-code contract (pinned by tests and used as a CI gate):

- ``0`` clean (summary/trace/table printed; no regression; no
  straggler; every rank healthy)
- ``1`` signal found (``diff``/``regress``: a regression past the
  threshold; ``stragglers``/``attribute``: a rank past the spread
  threshold; ``health``: a stalled or dead rank)
- ``2`` malformed input (unreadable file, bad JSONL, schema drift,
  or a sidecar too old for the requested view)

Examples::

  pdrnn-metrics summarize metrics.jsonl
  pdrnn-metrics diff baseline.jsonl candidate.jsonl --threshold 10
  pdrnn-metrics stragglers metrics.jsonl   # picks up -r<k> siblings
  pdrnn-metrics timeline metrics.jsonl -o run.trace.json  # -> Perfetto
  pdrnn-metrics trace router.jsonl replica.jsonl --slowest 3
  pdrnn-metrics trace router.jsonl replica.jsonl --request 42
  pdrnn-metrics attribute metrics.jsonl    # phase fractions + blame
  pdrnn-metrics health metrics.jsonl --stale-after 30
  pdrnn-metrics watch 127.0.0.1:9100       # live fleet table (aggregator)
  pdrnn-metrics top 127.0.0.1:9100         # + sparklines, burn, capacity
  pdrnn-metrics ledger metrics.jsonl --history ledger_history.jsonl
  pdrnn-metrics regress ledger_history.jsonl --threshold 0.2
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from pytorch_distributed_rnn_tpu_torch.obs.summary import (
    MalformedMetricsError,
    detect_stragglers,
    diff_summaries,
    load_events,
    rank_files,
    rank_health,
    summarize_file,
)

_SUMMARY_FIELDS = (
    ("steps", "{:d}"),
    ("epochs", "{:d}"),
    ("loss_first", "{:.6f}"),
    ("loss_last", "{:.6f}"),
    ("step_s_mean", "{:.6f}"),
    ("step_s_p50", "{:.6f}"),
    ("step_s_p95", "{:.6f}"),
    ("data_wait_frac", "{:.4f}"),
    # overlapped gradient communication (None and skipped on runs whose
    # step fn publishes no comm telemetry)
    ("comm_wait_s", "{:.6f}"),
    ("comm_wait_s_mean", "{:.6f}"),
    ("overlap_frac", "{:.4f}"),
    ("collective_bytes_per_step", "{:,d}"),
    # phase split: gradient = all-reduce; update = reduce-scatter +
    # all-gather (the sharded weight update's ~2x drop shows up here)
    ("collective_grad_bytes_per_step", "{:,d}"),
    ("collective_update_bytes_per_step", "{:,d}"),
    ("duration_s", "{:.3f}"),
    ("memory_mb", "{:.1f}"),
    ("device_peak_mb", "{:.1f}"),
    ("nan_skipped", "{:d}"),
    ("alerts", "{:d}"),
    ("alerts_by_kind", "{}"),
    ("ps_exchanges", "{:d}"),
    ("ps_retries", "{:d}"),
    ("ps_degraded_rounds", "{:d}"),
    # elastic membership (None and skipped on non-elastic runs)
    ("member_joins", "{:d}"),
    ("member_rejoins", "{:d}"),
    ("member_drains", "{:d}"),
    ("member_deaths", "{:d}"),
    # MPMD pipelines (None and skipped on non-pipeline runs)
    ("stage_restarts", "{:d}"),
    ("replayed_microbatches", "{:d}"),
    ("roster", "{}"),
    ("checkpoint_saves", "{:d}"),
    # efficiency ledger (None and skipped on schema-1 sidecars; the
    # full phase table lives under `pdrnn-metrics ledger`)
    ("recompiles", "{:d}"),
    ("goodput", "{:.4f}"),
    ("badput_frac", "{:.4f}"),
    ("fault_tax_s", "{:.6f}"),
    ("comm_wait_frac", "{:.4f}"),
    ("mfu_est", "{:.3e}"),
    # serving runs (absent on training sidecars - skipped when None)
    ("requests", "{:d}"),
    ("requests_shed", "{:d}"),
    ("requests_failed", "{:d}"),
    ("tokens_out", "{:d}"),
    ("tokens_per_s", "{:.1f}"),
    ("latency_s_p50", "{:.6f}"),
    ("latency_s_p95", "{:.6f}"),
    ("ttft_s_p50", "{:.6f}"),
    ("ttft_s_p95", "{:.6f}"),
    ("queue_s_p50", "{:.6f}"),
    ("queue_s_p95", "{:.6f}"),
    ("queue_depth_p50", "{:.0f}"),
    ("queue_depth_p95", "{:.0f}"),
    ("queue_depth_max", "{:.0f}"),
    # streaming actor/learner runs (absent on everything else - the
    # summary only carries these keys off a streaming learner's
    # run_summary, so None-means-skip keeps other runs noise-free)
    ("experience_batches", "{:d}"),
    ("experience_per_s", "{:.1f}"),
    ("updates_per_s", "{:.1f}"),
    ("stale_rejected", "{:d}"),
    ("queue_sheds", "{:d}"),
    ("duplicates", "{:d}"),
    ("poisoned", "{:d}"),
    ("staleness_p50", "{:.0f}"),
    ("staleness_p95", "{:.0f}"),
    ("final_version", "{:d}"),
    ("rejoins", "{:d}"),
)


def _print_summary(summary: dict, out=print):
    out(f"{summary['path']} (rank {summary['rank']})")
    for field, fmt in _SUMMARY_FIELDS:
        value = summary.get(field)
        if value is None or value == {}:
            continue
        try:
            rendered = fmt.format(value)
        except (TypeError, ValueError):
            rendered = str(value)
        out(f"  {field:26s} {rendered}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pdrnn-metrics", description=(
        "Summarize, diff and straggler-scan pdrnn metrics JSONL sidecars"
    ))
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize", help="per-rank run summary")
    p.add_argument("files", nargs="+", help="metrics JSONL sidecar(s)")
    p.add_argument("--json", action="store_true", help="machine output")

    p = sub.add_parser("diff", help="regression check candidate vs baseline")
    p.add_argument("baseline")
    p.add_argument("candidate")
    p.add_argument("--threshold", type=float, default=10.0, metavar="PCT",
                   help="regression tolerance in percent (default 10)")
    p.add_argument("--json", action="store_true")

    p = sub.add_parser(
        "stragglers",
        help="cross-rank step-time spread (rank-suffixed siblings "
        "of each file are included automatically)",
    )
    p.add_argument("files", nargs="+")
    p.add_argument("--threshold", type=float, default=0.25, metavar="FRAC",
                   help="flag ranks this fraction above the median step "
                   "time (default 0.25)")
    p.add_argument("--json", action="store_true")

    p = sub.add_parser(
        "timeline",
        help="export the run (rank-0 sidecar + -r<k> siblings) as a "
        "clock-aligned Chrome trace-event JSON for Perfetto",
    )
    p.add_argument("file", help="the run's rank-0 metrics sidecar")
    p.add_argument("-o", "--output", default=None, metavar="PATH",
                   help="trace output path (default: <file>.trace.json)")
    p.add_argument("--json", action="store_true",
                   help="print a machine summary of the export")

    p = sub.add_parser(
        "trace",
        help="assemble distributed request traces (obs/tracectx.py "
        "span contexts recorded across router + replica sidecars) into "
        "span trees with critical-path attribution",
    )
    p.add_argument("files", nargs="+",
                   help="sidecar path(s) - pass the router's AND the "
                   "replicas' families; -r<k> siblings are picked up "
                   "automatically")
    p.add_argument("--request", default=None, metavar="ID",
                   help="only traces whose request id matches, or whose "
                   "trace id starts with ID")
    p.add_argument("--slowest", type=int, default=None, metavar="N",
                   help="only the N slowest traces (default: all, "
                   "slowest first)")
    p.add_argument("--json", action="store_true", help="machine output")

    p = sub.add_parser(
        "attribute",
        help="per-rank phase attribution: sampled step time decomposed "
        "into data-wait / dispatch / device / exchange fractions, plus "
        "phase-blamed straggler detection",
    )
    p.add_argument("files", nargs="+")
    p.add_argument("--threshold", type=float, default=0.25, metavar="FRAC",
                   help="flag ranks this fraction above the median step "
                   "time (default 0.25)")
    p.add_argument("--json", action="store_true")

    p = sub.add_parser(
        "health",
        help="liveness check: flag ranks whose telemetry went stale "
        "(dead) or whose heartbeats continue without progress (stalled); "
        "a rank that DEREGISTERed (member_drain - the SIGTERM drain "
        "path) is 'drained' and healthy, not dead, and a respawned MPMD "
        "stage still restoring/retracing after a stage_restart - or a "
        "streaming actor registered with the learner but not yet "
        "pushing - is 'recovering', not stalled",
    )
    p.add_argument("files", nargs="+")
    p.add_argument("--stale-after", type=float, default=30.0, metavar="S",
                   help="seconds without progress/events before a rank "
                   "is flagged (default 30)")
    p.add_argument("--now", type=float, default=None, metavar="EPOCH",
                   help="reference wall time (default: the current time; "
                   "pass a run-contemporary stamp for post-hoc checks)")
    p.add_argument("--json", action="store_true")

    p = sub.add_parser(
        "watch",
        help="poll a live aggregator (obs/aggregator.py - the --live "
        "flag / PDRNN_LIVE run-side) and render the fleet table: one "
        "row per source with status, step-time window, loss, queue "
        "depth and recent alerts",
    )
    p.add_argument("target", help="aggregator address (HOST:PORT or "
                   "http://HOST:PORT)")
    p.add_argument("--interval", type=float, default=2.0, metavar="S",
                   help="poll cadence in seconds (default 2)")
    p.add_argument("--once", action="store_true",
                   help="print one snapshot and exit (0 healthy, 1 if "
                   "any source is stalled/dead - the health exit "
                   "contract)")
    p.add_argument("--json", action="store_true",
                   help="print the raw fleet+events JSON instead of the "
                   "table (implies --once)")

    p = sub.add_parser(
        "top",
        help="live fleet view over an aggregator that hosts the "
        "time-series store (the --live anchor): one row per source "
        "with load gauges and 60s sparklines, the store's capacity "
        "signals (live vs recommended replicas), and the active SLO "
        "error-budget burn alerts (a slo_burn with no later "
        "slo_burn_cleared for that qos)",
    )
    p.add_argument("target", help="aggregator address (HOST:PORT or "
                   "http://HOST:PORT)")
    p.add_argument("--interval", type=float, default=2.0, metavar="S",
                   help="poll cadence in seconds (default 2)")
    p.add_argument("--window", type=float, default=60.0, metavar="S",
                   help="sparkline window in seconds (default 60)")
    p.add_argument("--once", action="store_true",
                   help="print one snapshot and exit (0 healthy, 1 if "
                   "any source is stalled/dead or a burn alert is "
                   "active)")
    p.add_argument("--json", action="store_true",
                   help="print the snapshot as JSON instead of the "
                   "table (implies --once)")

    p = sub.add_parser(
        "ledger",
        help="efficiency ledger: classify the run's wall-clock into "
        "phase fractions (summing to 1), goodput, MFU/HFU vs the "
        "per-backend peak table (CPU peak is an estimate), and fault "
        "tax; per-stage ledgers + bubble fraction on MPMD runs, "
        "actor/learner split on streaming runs",
    )
    p.add_argument("files", nargs="+", help="rank-0 sidecar(s); -r<k> "
                   "siblings are picked up automatically")
    p.add_argument("--json", action="store_true", help="machine output")
    p.add_argument("--history", default=None, metavar="PATH",
                   help="append each run's aggregate to this "
                   "ledger_history.jsonl (the `regress` gate's input)")
    p.add_argument("--key", default=None, metavar="KEY",
                   help="config key for the history record (default: "
                   "the sidecar's stem)")

    p = sub.add_parser(
        "regress",
        help="cross-run regression gate over a ledger_history.jsonl: "
        "latest run per key vs the median of its predecessors "
        "(goodput drop, fault-tax / comm-wait fraction rise)",
    )
    p.add_argument("history", help="ledger_history.jsonl path")
    p.add_argument("--threshold", type=float, default=0.2, metavar="FRAC",
                   help="relative tolerance (default 0.2)")
    p.add_argument("--floor", type=float, default=0.05, metavar="FRAC",
                   help="absolute tolerance in fraction points a "
                   "regression must also clear (default 0.05)")
    p.add_argument("--json", action="store_true")

    args = parser.parse_args(argv)
    try:
        return _dispatch(args)
    except MalformedMetricsError as exc:
        print(f"pdrnn-metrics: {exc}", file=sys.stderr)
        return 2
    except BrokenPipeError:  # `pdrnn-metrics ... | head` is fine
        return 0


def _dispatch(args) -> int:
    if args.cmd == "summarize":
        summaries = [summarize_file(path) for path in args.files]
        if args.json:
            print(json.dumps(summaries, indent=1))
        else:
            for summary in summaries:
                _print_summary(summary)
        return 0

    if args.cmd == "diff":
        base = summarize_file(args.baseline)
        cand = summarize_file(args.candidate)
        regressions = diff_summaries(base, cand, args.threshold)
        if args.json:
            print(json.dumps(regressions, indent=1))
        else:
            if not regressions:
                print(
                    f"no regression past {args.threshold:g}% "
                    f"({args.candidate} vs {args.baseline})"
                )
            for r in regressions:
                print(
                    f"REGRESSION {r['metric']}: {r['baseline']:.6g} -> "
                    f"{r['candidate']:.6g} (+{r['delta_pct']:.1f}%)"
                )
        return 1 if regressions else 0

    if args.cmd == "timeline":
        return _timeline(args)
    if args.cmd == "trace":
        return _trace(args)
    if args.cmd == "attribute":
        return _attribute(args)
    if args.cmd == "health":
        return _health(args)
    if args.cmd == "watch":
        return _watch(args)
    if args.cmd == "top":
        return _top(args)
    if args.cmd == "ledger":
        return _ledger(args)
    if args.cmd == "regress":
        return _regress(args)

    # stragglers
    summaries = [summarize_file(p) for p in _expand_families(args.files)]
    summaries.sort(key=lambda s: s["rank"])
    flagged = detect_stragglers(summaries, args.threshold)
    if args.json:
        print(json.dumps(flagged, indent=1))
    else:
        if not flagged:
            print(
                f"no straggler past {args.threshold:g}x-over-median "
                f"across {len(summaries)} rank(s)"
            )
        for f in flagged:
            print(
                f"STRAGGLER rank {f['rank']}: mean step "
                f"{f['step_s_mean']:.6f}s vs median {f['median_s']:.6f}s "
                f"(+{100 * f['excess_frac']:.0f}%)"
            )
    return 1 if flagged else 0


def _expand_families(paths) -> list[Path]:
    """Every given path expanded to its rank family so the common case
    (pass the rank-0 sidecar) sees the whole world.  Dedup by resolved
    path: a shell glob passes the -r<k> siblings explicitly TOO, and a
    double-counted rank shifts medians onto the outlier, masking it."""
    members, seen = [], set()
    for path in paths:
        family = rank_files(path)
        if not family:
            raise MalformedMetricsError(f"{path}: no metrics sidecar found")
        for member in family:
            resolved = Path(member).resolve()
            if resolved in seen:
                continue
            seen.add(resolved)
            members.append(member)
    return members


def _timeline(args) -> int:
    from pytorch_distributed_rnn_tpu_torch.obs.timeline import write_chrome_trace

    out = args.output or str(
        Path(args.file).with_suffix("")
    ) + ".trace.json"
    try:
        trace = write_chrome_trace(args.file, out)
    except ValueError as exc:
        # a validator rejection of our own export is still bad INPUT
        # from the caller's perspective (a sidecar the exporter cannot
        # render consistently) - same exit as malformed JSONL
        raise MalformedMetricsError(str(exc)) from exc
    summary = {
        "trace": str(out),
        "ranks": trace["otherData"]["ranks"],
        "events": len(trace["traceEvents"]),
        "clock_offsets_s": trace["otherData"]["clock_offsets_s"],
    }
    if args.json:
        print(json.dumps(summary, indent=1))
    else:
        print(
            f"wrote {out}: {summary['events']} trace events across "
            f"{len(summary['ranks'])} rank(s) - open in "
            "https://ui.perfetto.dev or chrome://tracing"
        )
    return 0


def _trace(args) -> int:
    from pytorch_distributed_rnn_tpu_torch.obs.trace import (
        assemble_traces,
        format_trace_tree,
        format_traces_json,
        validate_trace_tree,
    )

    trees = assemble_traces(args.files, request=args.request)
    if args.slowest is not None:
        trees = trees[:max(0, args.slowest)]
    for tree in trees:
        # self-check the assembly before presenting it: a tree that
        # fails its own invariants is malformed input, not a finding
        validate_trace_tree(tree)
    if args.json:
        print(format_traces_json(trees))
        return 0
    if not trees:
        what = f" matching {args.request!r}" if args.request else ""
        print(
            f"no request trace{what} in the given sidecars (record "
            "with tracing on: pdrnn-router --trace-sample / "
            "pdrnn-loadgen --trace-sample, plus --metrics everywhere)"
        )
        return 0
    for tree in trees:
        print(format_trace_tree(tree))
    return 0


def _attribute(args) -> int:
    from pytorch_distributed_rnn_tpu_torch.obs.timeline import (
        PHASES,
        attribute_rank,
        attribute_stragglers,
    )

    attributions = []
    for member in _expand_families(args.files):
        events = load_events(member)
        attr = attribute_rank(events)
        if attr is not None:
            attr["path"] = str(member)
            attributions.append(attr)
    attributions.sort(key=lambda a: a["rank"])
    flagged = attribute_stragglers(attributions, args.threshold)
    if args.json:
        print(json.dumps(
            {"ranks": attributions, "stragglers": flagged}, indent=1
        ))
        return 1 if flagged else 0
    if not attributions:
        print("no attributable rank (no fenced step samples - raise the "
              "--metrics-sample-every cadence)")
        return 0
    header = f"{'rank':>4} {'steps':>5} {'step_s':>10} " + " ".join(
        f"{p:>9}" for p in PHASES
    )
    print(header)
    for a in attributions:
        fr = a["fractions"]
        print(
            f"{a['rank']:>4} {a['steps_sampled']:>5} "
            f"{a['step_s_mean']:>10.6f} "
            + " ".join(f"{100 * fr[p]:>8.1f}%" for p in PHASES)
        )
    for f in flagged:
        print(
            f"STRAGGLER rank {f['rank']}: mean step "
            f"{f['step_s_mean']:.6f}s vs median {f['median_s']:.6f}s "
            f"(+{100 * f['excess_frac']:.0f}%), dominated by "
            f"{f['phase']} (+{f['phase_excess_s']:.6f}s/step vs median)"
        )
    return 1 if flagged else 0


def _watch_fetch(base: str, path: str):
    import urllib.request

    try:
        with urllib.request.urlopen(base + path, timeout=5.0) as resp:
            return json.loads(resp.read())
    except OSError as exc:
        # /health replies 503 when a source is stalled/dead - that is a
        # VALID payload for the watch table, not a fetch failure
        body = getattr(exc, "read", lambda: None)()
        if body:
            try:
                return json.loads(body)
            except ValueError:
                pass
        raise MalformedMetricsError(
            f"{base}{path}: aggregator unreachable ({exc})"
        ) from exc


def _watch_row(source_id: str, digest: dict) -> str:
    step = digest.get("step_s") or {}
    loss = digest.get("loss") or {}
    depth = digest.get("queue_depth") or {}
    serving = digest.get("serving") or {}

    def num(value, fmt="{:.4f}"):
        return fmt.format(value) if value is not None else "-"

    return (
        f"{source_id:>14} {str(digest.get('status', '?')):>9} "
        f"{num(digest.get('progress'), '{:d}'):>8} "
        f"{num(step.get('p50')):>10} {num(step.get('p95')):>10} "
        f"{num(loss.get('last')):>10} "
        f"{num(depth.get('last'), '{:.0f}'):>6} "
        f"{num(serving.get('req_per_s_60s'), '{:.1f}'):>7} "
        f"{num(digest.get('alerts_total'), '{:d}'):>7}"
    )


def _watch(args) -> int:
    base = args.target
    if "://" not in base:
        base = f"http://{base}"
    base = base.rstrip("/")
    header = (
        f"{'source':>14} {'status':>9} {'step':>8} {'p50_s':>10} "
        f"{'p95_s':>10} {'loss':>10} {'queue':>6} {'req/s':>7} "
        f"{'alerts':>7}"
    )
    while True:
        fleet = _watch_fetch(base, "/fleet")
        events = _watch_fetch(base, "/events")
        sources = fleet.get("sources") or {}
        flagged = any(
            d.get("status") in ("stalled", "dead")
            for d in sources.values()
        )
        if args.json:
            print(json.dumps({"fleet": fleet, "events": events}, indent=1))
            return 1 if flagged else 0
        print(f"== {base} @ {time.strftime('%H:%M:%S')} "
              f"({len(sources)} source(s))")
        print(header)
        for source_id in sorted(sources):
            line = _watch_row(source_id, sources[source_id])
            if sources[source_id].get("status") in ("stalled", "dead"):
                line = line.upper()
            print(line)
        for event in events[-5:]:
            print(
                f"  ALERT {event.get('source', '?')}: "
                f"{event.get('alert', '?')} "
                f"[{event.get('severity', '?')}] seq={event.get('seq')}"
            )
        if args.once:
            return 1 if flagged else 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:  # pragma: no cover - interactive
            return 0


_SPARK_GLYPHS = "▁▂▃▄▅▆▇█"


def _spark(values, width: int = 24) -> str:
    """Resample ``values`` into ``width`` buckets and render a unicode
    sparkline scaled to the window's own max (flat-zero stays flat)."""
    values = [v for v in values if v is not None]
    if not values:
        return "-"
    if len(values) > width:
        # bucket-mean resample so a 60s window fits the column
        step = len(values) / width
        values = [
            sum(chunk) / len(chunk)
            for chunk in (
                values[int(i * step):max(int(i * step) + 1,
                                         int((i + 1) * step))]
                for i in range(width)
            )
        ]
    top = max(values)
    if top <= 0:
        return _SPARK_GLYPHS[0] * len(values)
    return "".join(
        _SPARK_GLYPHS[min(len(_SPARK_GLYPHS) - 1,
                          int(max(0.0, v) / top * (len(_SPARK_GLYPHS) - 1)))]
        for v in values
    )


def _series_values(points, kind: str) -> list:
    """Plottable value per point: gauges use value/mean, counters use
    the per-bucket rate (raw cumulative points are differenced)."""
    if kind == "counter":
        vals, prev = [], None
        for p in points:
            if "rate" in p:
                vals.append(p["rate"])
                continue
            v = p.get("value")
            if prev is not None and v is not None:
                vals.append(max(0.0, v - prev))
            prev = v
        return vals
    return [
        p.get("mean", p.get("value"))
        for p in points
        if p.get("mean", p.get("value")) is not None
    ]


def _top_series(base: str, name: str, window: float, agg=None):
    """GET /series, or None when the anchor hosts no store (404 /
    pre-store aggregator)."""
    from urllib.parse import urlencode

    query = {"name": name, "window": f"{window:g}"}
    if agg:
        query["agg"] = agg
    try:
        payload = _watch_fetch(base, "/series?" + urlencode(query))
    except MalformedMetricsError:
        return None
    if not isinstance(payload, dict) or "series" not in payload:
        return None
    return payload


def _active_burns(events) -> list[dict]:
    """The slo_burn alerts with no later slo_burn_cleared for the same
    (source, qos) - the fleet's currently-burning error budgets."""
    active: dict = {}
    for event in events:
        kind = event.get("alert")
        key = (event.get("source"), event.get("qos"))
        if kind == "slo_burn":
            active[key] = event
        elif kind == "slo_burn_cleared":
            active.pop(key, None)
    return list(active.values())


def _top_row(source_id: str, digest: dict, queue_spark: str,
             rate_spark: str) -> str:
    serving = digest.get("serving") or {}
    router = digest.get("router") or {}
    depth = digest.get("queue_depth") or {}

    def num(value, fmt="{:.1f}"):
        return fmt.format(value) if value is not None else "-"

    active = serving.get("active")
    if active is None:
        active = router.get("inflight")
    rate = serving.get("req_per_s_60s")
    if rate is None:
        rate = router.get("req_per_s_60s")
    return (
        f"{source_id:>14} {str(digest.get('status', '?')):>9} "
        f"{num(active, '{:.0f}'):>6} "
        f"{num(depth.get('last'), '{:.0f}'):>6} "
        f"{num(rate):>7} "
        f"{queue_spark:<24} {rate_spark:<24}"
    )


def _top(args) -> int:
    base = args.target
    if "://" not in base:
        base = f"http://{base}"
    base = base.rstrip("/")
    window = args.window
    header = (
        f"{'source':>14} {'status':>9} {'active':>6} {'queue':>6} "
        f"{'req/s':>7} {'queue ' + format(window, 'g') + 's':<24} "
        f"{'req/s ' + format(window, 'g') + 's':<24}"
    )
    while True:
        fleet = _watch_fetch(base, "/fleet")
        events = _watch_fetch(base, "/events")
        sources = fleet.get("sources") or {}
        burns = _active_burns(events)
        flagged = any(
            d.get("status") in ("stalled", "dead")
            for d in sources.values()
        ) or bool(burns)

        sparks: dict = {}  # name -> {source -> values}
        fetched: dict = {}
        for name in ("pdrnn_queue_depth",
                     "pdrnn_serving_request_rate_per_s",
                     "pdrnn_router_request_rate_per_s"):
            resp = _top_series(base, name, window)
            fetched[name] = resp
            per_source: dict = {}
            for s in (resp or {}).get("series") or []:
                source = (s.get("labels") or {}).get("source")
                if source is not None:
                    per_source[source] = _series_values(
                        s["points"], s.get("kind", "gauge"))
            sparks[name] = per_source
        capacity = {}
        for name in ("pdrnn_replicas_live", "pdrnn_recommended_replicas"):
            resp = _top_series(base, name, window, agg="last")
            series = (resp or {}).get("series") or []
            capacity[name] = series[0].get("value") if series else None

        if args.json:
            print(json.dumps({
                "fleet": fleet, "events": events,
                "capacity": capacity, "active_burns": burns,
                "series": fetched,
            }, indent=1))
            return 1 if flagged else 0
        live = capacity.get("pdrnn_replicas_live")
        want = capacity.get("pdrnn_recommended_replicas")
        cap_txt = ""
        if live is not None or want is not None:
            cap_txt = (
                f"  replicas live "
                f"{'-' if live is None else format(live, '.0f')}"
                f" / recommended "
                f"{'-' if want is None else format(want, '.0f')}"
            )
        print(f"== {base} @ {time.strftime('%H:%M:%S')} "
              f"({len(sources)} source(s)){cap_txt}")
        print(header)
        rate_by_source = dict(
            sparks["pdrnn_serving_request_rate_per_s"])
        rate_by_source.update(sparks["pdrnn_router_request_rate_per_s"])
        for source_id in sorted(sources):
            line = _top_row(
                source_id, sources[source_id],
                _spark(sparks["pdrnn_queue_depth"].get(source_id, [])),
                _spark(rate_by_source.get(source_id, [])),
            )
            if sources[source_id].get("status") in ("stalled", "dead"):
                line = line.upper()
            print(line)
        for burn in burns:
            fast = burn.get("burn_rate_fast")
            slow = burn.get("burn_rate_slow")
            print(
                f"  BURN {burn.get('source', '?')} "
                f"qos={burn.get('qos', '?')}: fast "
                f"{'-' if fast is None else format(fast, '.1f')}x / slow "
                f"{'-' if slow is None else format(slow, '.1f')}x budget "
                f"({burn.get('objective', '?')})"
            )
        if not burns:
            print("  no active burn alert")
        if args.once:
            return 1 if flagged else 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:  # pragma: no cover - interactive
            return 0


def _ledger(args) -> int:
    from pytorch_distributed_rnn_tpu_torch.obs.ledger import (
        LEDGER_PHASES,
        append_history,
        history_record,
        ledger_run,
    )

    runs = [ledger_run(path) for path in args.files]
    if args.history:
        for path, run in zip(args.files, runs):
            key = args.key or Path(path).stem
            append_history(args.history, history_record(run, key))
    if args.json:
        print(json.dumps(runs, indent=1))
        return 0
    header = f"{'rank':>5} {'wall_s':>9} " + " ".join(
        f"{p:>9}" for p in LEDGER_PHASES
    )
    for run in runs:
        print(f"{run['path']}")
        print(header)
        for r in run["ranks"]:
            fr = r["fractions"]
            label = (f"s{r['stage']}" if r.get("stage") is not None
                     else str(r["rank"]))
            print(
                f"{label:>5} {r['wall_s']:>9.3f} "
                + " ".join(f"{100 * fr[p]:>8.1f}%" for p in LEDGER_PHASES)
            )
        agg = run["aggregate"]
        mfu = agg["mfu_est"]
        mfu_txt = "-" if mfu is None else "{:.2e}{}".format(
            mfu, " (peak estimated)" if agg.get("peak_estimated") else ""
        )
        print(
            f"  goodput {agg['goodput']:.4f}  mfu {mfu_txt}  "
            f"fault_tax_s {agg['fault_tax_s']:.3f}  "
            f"comm_wait_frac {agg['comm_wait_frac']:.4f}  "
            f"recompiles {agg['recompiles']}"
        )
        if "mpmd" in run:
            bubble = run["mpmd"]["bubble_frac"]
            print(
                "  pipeline bubble_frac "
                + ("-" if bubble is None else f"{bubble:.4f}")
                + " (lower bound; stage steps time link waits too)"
            )
        if "streaming" in run:
            learner = run["streaming"]["learner"] or {}
            actors = run["streaming"]["actors"]
            tax = learner.get("reject_tax_s")
            print(
                f"  streaming: {actors['count']} actor(s), learner "
                "reject_tax_s "
                + ("-" if tax is None else f"{tax:.3f}")
            )
    return 0


def _regress(args) -> int:
    from pytorch_distributed_rnn_tpu_torch.obs.ledger import (
        check_history,
        load_history,
    )

    verdict = check_history(
        load_history(args.history), threshold=args.threshold,
        floor=args.floor,
    )
    if args.json:
        print(json.dumps(verdict, indent=1))
    else:
        if not verdict["regressions"]:
            print(
                f"no ledger regression across {verdict['compared']} "
                f"comparable key(s) of {verdict['keys']} "
                f"(threshold {args.threshold:g}, floor {args.floor:g})"
            )
        for r in verdict["regressions"]:
            print(
                f"REGRESSION {r['key']}: {r['metric']} "
                f"{r['prior_median']:.4f} -> {r['latest']:.4f} "
                f"({r['delta']:+.4f})"
            )
    return 1 if verdict["regressions"] else 0


def _health(args) -> int:
    reports = [
        {**rank_health(load_events(m), now=args.now,
                       stale_after=args.stale_after), "path": str(m)}
        for m in _expand_families(args.files)
    ]
    reports.sort(key=lambda r: r["rank"])
    flagged = [r for r in reports if r["status"] in ("stalled", "dead")]
    if args.json:
        print(json.dumps(reports, indent=1))
        return 1 if flagged else 0
    for r in reports:
        line = (
            f"rank {r['rank']}: {r['status']} (last event "
            f"{r['last_event_age_s']:.1f}s ago, last progress "
            f"{r['last_progress_age_s']:.1f}s ago)"
        )
        if r["status"] in ("stalled", "dead"):
            line = line.upper()
        print(line)
    return 1 if flagged else 0


if __name__ == "__main__":
    sys.exit(main())
