"""Cross-rank trace timelines: merge, align, export, attribute.

The metrics sidecars (``obs/recorder.py``) are per-rank JSONL streams
whose events carry dual stamps - wall ``t`` and monotonic ``tm`` - but
each rank's monotonic clock has its own epoch and each rank's wall
clock its own NTP fate.  This module turns one run's sidecar family
into a single timeline:

1. :func:`load_run` - the rank-0 file plus its ``-r<k>`` siblings,
   loaded with the strict reader;
2. :func:`estimate_clock_offsets` - per-rank corrections onto the
   reference rank's wall timeline.  The base estimate is each rank's
   meta anchor (the (t, tm) pair stamped at recorder construction);
   known-synchronous events then refine away wall-clock skew:
   collective-traced step boundaries (ranks whose step program carries
   real collective traffic finish step k together) and parameter-server
   gather edges (a worker's push reply cannot land before the master
   closed the round that consumed it);
3. :func:`build_chrome_trace` - a Chrome trace-event JSON (one ``pid``
   per rank, one ``tid`` per subsystem, µs units) that Perfetto and
   ``chrome://tracing`` load directly.  Span events export verbatim;
   events that carry a duration (``step`` dispatch/fence/data-wait,
   ``checkpoint_*`` seconds, ``ps_exchange`` seconds, ``epoch`` wall_s,
   ``run_summary`` duration_s) are synthesized into spans; the rest
   become instants.  Request-trace spans (``cat="trace"``, carrying a
   ``trace`` id from ``obs/tracectx.py``) are the exception: concurrent
   requests overlap freely on one row, so they export as ASYNC begin/end
   pairs (``ph: b/e`` keyed by trace id) on the ``trace`` lane, and every
   trace that crosses a process boundary gets a flow arrow (``ph: s/f``)
   from the pid that started it to each pid it visited;
4. :func:`validate_chrome_trace` - the strict structural validator the
   tests and the CI smoke step run on every exported trace;
5. :func:`attribute_rank` / :func:`attribute_stragglers` - per-rank
   phase attribution: sampled (fenced) step time decomposed into
   data-wait / dispatch / device / exchange fractions that sum to ~1,
   and straggler attribution naming the PHASE a slow rank lost its
   time in (upgrading the mean-step-time check of ``pdrnn-metrics
   stragglers``).

Timeline export needs schema >= 2 sidecars (the ``tm`` field);
attribution works on schema 1 too (durations only, no clock math).
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

from pytorch_distributed_rnn_tpu_torch.obs.spans import SUBSYSTEM_TIDS
from pytorch_distributed_rnn_tpu_torch.obs.summary import (
    MalformedMetricsError,
    load_events,
    rank_files,
)

_US = 1_000_000.0

# event kinds rendered as instants (everything not a span / synthesized
# span / skipped meta); faults and member deaths are process-scoped so
# they flash across the whole rank row in Perfetto
_INSTANT_PROCESS_SCOPE = {"fault", "ps_worker_dead", "member_dead"}


def load_run(path) -> dict[int, list[dict]]:
    """One run's events, keyed by rank (rank-0 file + ``-r<k>``
    siblings; duplicate rank declarations are a malformed family)."""
    files = rank_files(path)
    if not files:
        raise MalformedMetricsError(f"{path}: no metrics sidecar found")
    by_rank: dict[int, list[dict]] = {}
    for p in files:
        events = load_events(p)
        rank = int(events[0].get("rank", 0))
        if rank in by_rank:
            raise MalformedMetricsError(
                f"{p}: rank {rank} declared by two sidecars of one family"
            )
        by_rank[rank] = events
    return by_rank


def _meta_anchor(events: list[dict], what: str) -> float:
    """The rank's wall<->monotonic anchor (meta ``t - tm``)."""
    meta = events[0]
    if "tm" not in meta:
        raise MalformedMetricsError(
            f"{what}: schema {meta.get('schema')} sidecar carries no "
            "monotonic timestamps - timeline export needs a schema >= 2 "
            "recording (re-run with the current build)"
        )
    return float(meta["t"]) - float(meta["tm"])


def _aligned(anchor: float, offset: float, tm: float) -> float:
    return anchor + offset + float(tm)


def _collective_sync_ranks(by_rank: dict[int, list[dict]]) -> set[int]:
    """Ranks whose live step program was traced to carry real
    collective traffic: their fenced step boundaries are synchronous
    across the world (the program cannot finish step k until every
    participant reached its collectives)."""
    ranks = set()
    for rank, events in by_rank.items():
        for e in events:
            if e["kind"] == "collectives" and e.get("ops") and (
                e.get("bytes_per_step") or 0
            ) > 0:
                ranks.add(rank)
                break
    return ranks


def _fenced_step_ends(events: list[dict]) -> dict[int, float]:
    """step index -> monotonic END of the fenced (honest wall) steps."""
    ends = {}
    for e in events:
        if e["kind"] == "step" and e.get("fenced_s") is not None \
                and "tm" in e:
            ends[int(e.get("step", -1))] = float(e["tm"]) + float(
                e["fenced_s"]
            )
    return ends


def _master_rank(by_rank: dict[int, list[dict]]) -> int | None:
    for rank, events in by_rank.items():
        if events[0].get("role") == "master":
            return rank
    return None


def _ps_round_closes(events: list[dict]) -> dict:
    """Master-side round-close edges, keyed two ways: by the consumed
    push id under ``by_seq[(worker, seq)]`` (exact pairing - survives
    degraded rounds and retried pushes, whose ordinals shift), and
    positionally under ``"sync"`` / ``per_worker`` for sidecars whose
    rounds carry no seq ids."""
    sync, per_worker, by_seq = [], {}, {}
    for e in events:
        if e["kind"] == "span" and e.get("name") == "ps_round" \
                and "tm" in e:
            close = float(e["tm"]) + float(e.get("dur_s", 0.0))
            if e.get("mode") == "async":
                worker = int(e.get("worker", -1))
                per_worker.setdefault(worker, []).append(close)
                if e.get("seq") is not None:
                    by_seq[(worker, int(e["seq"]))] = close
            else:
                sync.append(close)
                for worker, seq in (e.get("seqs") or {}).items():
                    by_seq[(int(worker), int(seq))] = close
    return {"sync": sync, "per_worker": per_worker, "by_seq": by_seq}


def _push_ends(events: list[dict]) -> list[tuple[int | None, float]]:
    """Worker-side push-exchange END edges (reply landed), in order:
    ``(seq, end_tm)`` pairs (seq None on pre-seq sidecars)."""
    return [
        (int(e["seq"]) if e.get("seq") is not None else None,
         float(e["tm"]))
        for e in events
        if e["kind"] == "ps_exchange" and e.get("what") == "gradient push"
        and not e.get("failed") and "tm" in e
    ]


def estimate_clock_offsets(by_rank: dict[int, list[dict]]) -> dict[int, float]:
    """Per-rank wall-clock corrections (seconds, ADDED to the meta
    anchor) landing every rank on the reference rank's timeline.

    The meta anchors alone align perfectly when wall clocks agree (the
    single-host spawn worlds); the sync-event refinements below remove
    residual skew when they do not.  Each refinement's per-pair delta is
    reduced by the median, so one straggling sample cannot drag the
    estimate.
    """
    ranks = sorted(by_rank)
    ref = ranks[0]
    anchors = {
        r: _meta_anchor(by_rank[r], f"rank {r}") for r in ranks
    }
    offsets = {r: 0.0 for r in ranks}

    # refinement 1: collective-traced step boundaries.  For every step
    # index fenced on both the reference and rank r, the two ends are
    # the same instant; the median difference is rank r's skew.
    sync_ranks = _collective_sync_ranks(by_rank)
    if ref in sync_ranks:
        ref_ends = _fenced_step_ends(by_rank[ref])
        for r in ranks:
            if r == ref or r not in sync_ranks:
                continue
            ends = _fenced_step_ends(by_rank[r])
            deltas = [
                (anchors[r] + ends[s]) - (anchors[ref] + ref_ends[s])
                for s in ends.keys() & ref_ends.keys()
            ]
            if deltas:
                offsets[r] = -statistics.median(deltas)

    # refinement 2: parameter-server gather edges.  A worker's k-th push
    # reply lands just after the master closed the k-th round (sync
    # mode) / the k-th update for that worker (async mode); the median
    # edge-to-edge delta is the worker's skew plus the typical reply
    # latency - absorbed into the estimate, which is why the tolerance
    # contract is "within transport latency", not zero.
    master = _master_rank(by_rank)
    if master is not None:
        closes = _ps_round_closes(by_rank[master])
        for r in ranks:
            if r == master or offsets[r] != 0.0:
                continue  # collective refinement already placed it
            pushes = _push_ends(by_rank[r])
            if not pushes:
                continue
            # pair by push id where the master recorded which seq each
            # round consumed - exact even when a degraded round or a
            # retried push shifts the ordinals; fall back to positional
            # pairing for sidecars without ids
            paired = [
                (end, closes["by_seq"][(r, seq)])
                for seq, end in pushes
                if seq is not None and (r, seq) in closes["by_seq"]
            ]
            if not paired:
                edges = closes["per_worker"].get(r) or closes["sync"]
                paired = [
                    (pushes[i][1], edges[i])
                    for i in range(min(len(pushes), len(edges)))
                ]
            if not paired:
                continue
            deltas = [
                (anchors[r] + end)
                - (anchors[master] + close + offsets[master])
                for end, close in paired
            ]
            offsets[r] = -statistics.median(deltas)
    return offsets


# -- Chrome trace export -----------------------------------------------------


def _tid(cat: str) -> int:
    return SUBSYSTEM_TIDS.get(cat, SUBSYSTEM_TIDS["train"])


class _TraceBuilder:
    def __init__(self, t0_wall: float):
        self.t0 = t0_wall
        self.events: list[dict] = []
        self.threads: dict[tuple[int, int], str] = {}

    def _us(self, wall: float) -> int:
        return max(0, int(round((wall - self.t0) * _US)))

    def _thread(self, pid: int, cat: str) -> tuple[int, str]:
        """Resolve a cat to its (tid, canonical name): unknown cats
        fall back to the "train" row WHOLE - tid and thread_name
        together - so the export always passes its own validator's
        thread_name<->tid mapping check."""
        canonical = cat if cat in SUBSYSTEM_TIDS else "train"
        tid = SUBSYSTEM_TIDS[canonical]
        self.threads[(pid, tid)] = canonical
        return tid, canonical

    def span(self, pid: int, cat: str, name: str, wall_start: float,
             dur_s: float, args: dict) -> dict:
        tid, cat = self._thread(pid, cat)
        ts = self._us(wall_start)
        # the child-end clamp happens in the caller where nesting is
        # known; here dur only needs non-negativity after rounding
        event = {
            "ph": "X", "pid": pid, "tid": tid, "name": name, "cat": cat,
            "ts": ts, "dur": max(0, int(round(dur_s * _US))),
            "args": args,
        }
        self.events.append(event)
        return event

    def instant(self, pid: int, cat: str, name: str, wall: float,
                args: dict, scope: str = "t") -> None:
        tid, cat = self._thread(pid, cat)
        self.events.append({
            "ph": "i", "pid": pid, "tid": tid, "name": name, "cat": cat,
            "ts": self._us(wall), "s": scope, "args": args,
        })

    def async_span(self, pid: int, cat: str, name: str, span_id: str,
                   wall_start: float, dur_s: float, args: dict) -> int:
        """One async begin/end pair (``ph: b``/``e``): the export shape
        for request-trace spans, whose concurrent instances overlap
        arbitrarily on one lane - complete events (``X``) would trip the
        validator's nesting check.  Returns the begin ts (µs)."""
        tid, cat = self._thread(pid, cat)
        ts = self._us(wall_start)
        end = ts + max(0, int(round(dur_s * _US)))
        common = {
            "pid": pid, "tid": tid, "name": name, "cat": cat,
            "id": span_id,
        }
        self.events.append({"ph": "b", "ts": ts, "args": args, **common})
        self.events.append({"ph": "e", "ts": end, "args": {}, **common})
        return ts

    def flow(self, cat: str, name: str, flow_id: str,
             src: tuple[int, int], dst: tuple[int, int]) -> None:
        """One flow arrow: ``ph: s`` at ``src=(pid, ts)`` binding to
        ``ph: f`` at ``dst=(pid, ts)``, both on ``cat``'s lane.  The
        finish is clamped to never precede its start (cross-host clock
        skew up to the alignment tolerance)."""
        src_pid, src_ts = src
        dst_pid, dst_ts = dst
        src_tid, cat = self._thread(src_pid, cat)
        dst_tid, _ = self._thread(dst_pid, cat)
        common = {"name": name, "cat": cat, "id": flow_id}
        self.events.append({
            "ph": "s", "pid": src_pid, "tid": src_tid, "ts": src_ts,
            **common,
        })
        self.events.append({
            "ph": "f", "bp": "e", "pid": dst_pid, "tid": dst_tid,
            "ts": max(dst_ts, src_ts), **common,
        })


def _args(event: dict, *skip: str) -> dict:
    drop = {"kind", "t", "tm", "rank", *skip}
    return {
        k: v for k, v in event.items()
        if k not in drop and v is not None
    }


def build_chrome_trace(by_rank: dict[int, list[dict]],
                       offsets: dict[int, float] | None = None) -> dict:
    """The run as a Chrome trace-event JSON object (µs units): one pid
    per rank, one tid per subsystem, clock-aligned via ``offsets``
    (estimated when not given)."""
    if offsets is None:
        offsets = estimate_clock_offsets(by_rank)
    anchors = {
        r: _meta_anchor(events, f"rank {r}")
        for r, events in by_rank.items()
    }

    def wall(rank: int, event: dict) -> float:
        if "tm" in event:
            return _aligned(anchors[rank], offsets[rank], event["tm"])
        # wall-only events (the launcher's appended root span) already
        # live on the launching host's wall clock = the common timeline
        return float(event["t"])

    t0 = min(
        wall(r, e) - float(e.get("data_wait_s") or 0.0)
        for r, events in by_rank.items() for e in events
    )
    tb = _TraceBuilder(t0)
    # trace id -> [(begin ts µs, pid)]: the visits each request trace
    # paid to each process, feeding the flow-arrow synthesis below
    trace_visits: dict[str, list[tuple[int, int]]] = {}

    for rank, events in by_rank.items():
        for e in events:
            kind = e["kind"]
            w = wall(rank, e)
            if kind == "meta":
                continue
            if kind == "span":
                if e.get("cat") == "trace" and e.get("trace"):
                    ts = tb.async_span(
                        rank, "trace", str(e.get("name", "span")),
                        str(e["trace"]), w, float(e.get("dur_s", 0.0)),
                        _args(e, "name", "cat", "dur_s"),
                    )
                    trace_visits.setdefault(str(e["trace"]), []).append(
                        (ts, rank)
                    )
                    continue
                tb.span(
                    rank, e.get("cat", "train"), str(e.get("name", "span")),
                    w, float(e.get("dur_s", 0.0)),
                    _args(e, "name", "cat", "dur_s"),
                )
            elif kind == "step":
                _step_spans(tb, rank, e, w)
            elif kind == "epoch" and e.get("wall_s") is not None:
                tb.span(rank, "train", "epoch", w, float(e["wall_s"]),
                        _args(e, "wall_s"))
            elif kind in ("checkpoint_save", "checkpoint_restore"):
                # recorded at completion: tm is the END of the write
                dur = float(e.get("seconds", 0.0))
                tb.span(rank, "ckpt", kind, w - dur, dur,
                        _args(e, "seconds"))
            elif kind == "ps_exchange":
                dur = float(e.get("seconds", 0.0))
                tb.span(
                    rank, "ps",
                    str(e.get("what", "exchange")).replace(" ", "_"),
                    w - dur, dur, _args(e, "seconds", "what"),
                )
            elif kind == "run_summary":
                dur = float(e.get("duration_s") or 0.0)
                tb.span(rank, "run", "train_run", w - dur, dur,
                        _args(e, "duration_s", "device_peaks_mb"))
            else:
                # fault / nan_skip / heartbeat / collectives / profile /
                # eval / legacy ps_round points / ps_summary ...
                scope = "p" if kind in _INSTANT_PROCESS_SCOPE else "t"
                cat = {
                    "fault": "resilience", "nan_skip": "resilience",
                    # watchdog findings land on the resilience row next
                    # to the faults they often correlate with
                    "alert": "resilience",
                    "checkpoint_fallback": "ckpt",
                    "heartbeat": "sys", "collectives": "sys",
                    "profile": "sys", "eval": "eval",
                    "ps_round": "ps", "ps_summary": "ps",
                    "ps_worker_dead": "ps",
                    # the membership lane: roster transitions as instants
                    # (state_sync rides in as a span with cat=member)
                    "member_join": "member", "member_drain": "member",
                    "member_dead": "member",
                    # the MPMD pipeline lane: a stage coming back plus
                    # the frames its neighbors replayed to it
                    "stage_restart": "stage", "replay": "stage",
                    "worker_respawn": "stage", "worker_lost": "stage",
                    # the streaming actor lane: ingest verdicts and
                    # param refreshes flash next to the experience_push
                    # / learner_update spans (cat=actor); a reconnect
                    # is a membership story and lands on that row
                    "experience_reject": "actor",
                    "params_refresh": "actor",
                    "actor_reconnect": "member",
                    "learner_summary": "run",
                    # the serving-fleet router lane: breaker transitions
                    # (eject on consecutive failures, half-open probes,
                    # readmission), QoS sheds and the drain marker, next
                    # to the route dispatch spans (cat=router)
                    "replica_eject": "router",
                    "replica_probe": "router",
                    "replica_readmit": "router",
                    "replica_drain": "router",
                    "route_shed": "router",
                    "hedge": "router",
                    "router_drain": "router",
                }.get(kind, "sys")
                tb.instant(rank, cat, kind, w, _args(e), scope)

    # flow arrows: one s->f pair from the pid where a trace BEGAN to
    # each other pid it visited, so Perfetto draws the request's hop
    # across process rows (router -> replica).  The flow id is scoped
    # per destination pid - Chrome flow semantics bind exactly one s to
    # one f per (cat, id)
    for trace_id, visits in sorted(trace_visits.items()):
        visits.sort()
        src_ts, src_pid = visits[0]
        linked = {src_pid}
        for ts, pid in visits:
            if pid in linked:
                continue
            linked.add(pid)
            tb.flow("trace", trace_id, f"{trace_id}/{pid}",
                    (src_pid, src_ts), (pid, ts))

    trace_events = []
    for rank, events in sorted(by_rank.items()):
        role = events[0].get("role")
        name = f"rank {rank}" + (f" ({role})" if role else "")
        trace_events.append({
            "ph": "M", "name": "process_name", "pid": rank, "tid": 0,
            "args": {"name": name},
        })
        trace_events.append({
            "ph": "M", "name": "process_sort_index", "pid": rank, "tid": 0,
            "args": {"sort_index": rank},
        })
    for (pid, tid), cat in sorted(tb.threads.items()):
        trace_events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": cat},
        })
        trace_events.append({
            "ph": "M", "name": "thread_sort_index", "pid": pid, "tid": tid,
            "args": {"sort_index": tid},
        })
    trace_events.extend(sorted(tb.events, key=lambda e: e["ts"]))
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "ranks": sorted(by_rank),
            "clock_offsets_s": {str(r): offsets[r] for r in sorted(offsets)},
        },
    }


def _step_spans(tb: _TraceBuilder, rank: int, e: dict, w: float) -> None:
    """Synthesize the per-step sub-spans from one ``step`` event whose
    ``tm`` is the dispatch start: ``data_wait`` (before dispatch, own
    tid), ``dispatch`` and - on fenced samples - the enclosing ``step``
    plus the ``device`` tail.  Child extents are clamped to the parent
    after µs rounding so the nesting the validator enforces is exact by
    construction."""
    if "tm" not in e:
        raise MalformedMetricsError(
            f"rank {rank}: schema-1 step events carry no tm; timeline "
            "export needs a schema >= 2 recording"
        )
    args = _args(e, "dispatch_s", "data_wait_s", "fenced_s")
    data_wait = float(e.get("data_wait_s") or 0.0)
    if data_wait > 0:
        tb.span(rank, "data", "data_wait", w - data_wait, data_wait, args)
    dispatch = float(e.get("dispatch_s") or 0.0)
    fenced = e.get("fenced_s")
    if fenced is None:
        tb.span(rank, "step", "dispatch", w, dispatch, args)
        return
    parent = tb.span(rank, "step", "step", w, float(fenced), args)
    end = parent["ts"] + parent["dur"]
    child = tb.span(rank, "step", "dispatch", w, dispatch, {})
    child["dur"] = min(child["dur"], end - child["ts"])
    dev_ts = child["ts"] + child["dur"]
    tb.events.append({
        "ph": "X", "pid": rank, "tid": _tid("step"), "name": "device",
        "cat": "step", "ts": dev_ts, "dur": max(0, end - dev_ts),
        "args": {},
    })


# -- validator ---------------------------------------------------------------


_REQUIRED_BY_PH = {
    "X": ("ts", "dur", "name", "pid", "tid"),
    "B": ("ts", "name", "pid", "tid"),
    "E": ("ts", "pid", "tid"),
    # async begin/end + flow start/finish (the request-trace export):
    # both are keyed by (cat, id), so those fields are required
    "b": ("ts", "name", "pid", "tid", "cat", "id"),
    "e": ("ts", "name", "pid", "tid", "cat", "id"),
    "s": ("ts", "name", "pid", "tid", "cat", "id"),
    "f": ("ts", "name", "pid", "tid", "cat", "id"),
    "i": ("ts", "name", "pid", "tid", "s"),
    "M": ("name", "pid"),
}


def validate_chrome_trace(trace) -> None:
    """Strict structural check of a Chrome trace-event JSON object;
    raises ``ValueError`` naming the first violation.  Enforced: the
    required fields per phase type, non-negative finite µs timestamps
    and durations, pid<->rank and tid<->subsystem metadata mapping, B/E
    balance per (pid, tid), proper nesting (no partial overlap) of the
    complete-event spans sharing one thread row, async b/e balance per
    (cat, id) with begun/ended name multisets agreeing, and flow-arrow
    pairing: exactly one ``s`` and one ``f`` per (cat, id), same name,
    finish never before start - a dangling arrow is a broken trace."""
    if not isinstance(trace, dict) or not isinstance(
        trace.get("traceEvents"), list
    ) or not trace["traceEvents"]:
        raise ValueError("trace must be a dict with a non-empty traceEvents")
    process_names: dict[int, str] = {}
    thread_names: dict[tuple[int, int], str] = {}
    used_pids: set[int] = set()
    used_tids: set[tuple[int, int]] = set()
    be_stacks: dict[tuple[int, int], list[str]] = {}
    x_by_tid: dict[tuple[int, int], list[tuple[int, int]]] = {}
    async_open: dict[tuple[str, str], dict] = {}
    flows: dict[tuple[str, str], dict] = {}

    for i, e in enumerate(trace["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            raise ValueError(f"{where}: not an object")
        ph = e.get("ph")
        if ph not in _REQUIRED_BY_PH:
            raise ValueError(f"{where}: unsupported ph {ph!r}")
        for field in _REQUIRED_BY_PH[ph]:
            if field not in e:
                raise ValueError(f"{where}: ph={ph} missing {field!r}")
        if "ts" in e:
            ts = e["ts"]
            if not isinstance(ts, int) or ts < 0:
                raise ValueError(
                    f"{where}: ts must be a non-negative integer µs, "
                    f"got {ts!r}"
                )
        if ph == "X":
            dur = e["dur"]
            if not isinstance(dur, int) or dur < 0:
                raise ValueError(
                    f"{where}: dur must be a non-negative integer µs, "
                    f"got {dur!r}"
                )
            x_by_tid.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], dur)
            )
        if ph == "i" and e.get("s") not in ("t", "p", "g"):
            raise ValueError(f"{where}: instant scope {e.get('s')!r}")
        if ph == "M":
            if e["name"] == "process_name":
                process_names[e["pid"]] = e.get("args", {}).get("name", "")
            elif e["name"] == "thread_name":
                thread_names[(e["pid"], e["tid"])] = e.get(
                    "args", {}
                ).get("name", "")
            continue
        used_pids.add(e["pid"])
        used_tids.add((e["pid"], e["tid"]))
        if ph == "B":
            be_stacks.setdefault((e["pid"], e["tid"]), []).append(e["name"])
        elif ph == "E":
            stack = be_stacks.get((e["pid"], e["tid"]), [])
            if not stack:
                raise ValueError(
                    f"{where}: E without matching B on pid={e['pid']} "
                    f"tid={e['tid']}"
                )
            stack.pop()
        elif ph == "b":
            st = async_open.setdefault(
                (e["cat"], str(e["id"])), {"open": 0, "names": {}}
            )
            st["open"] += 1
            st["names"][e["name"]] = st["names"].get(e["name"], 0) + 1
        elif ph == "e":
            st = async_open.get((e["cat"], str(e["id"])))
            if st is None or st["open"] == 0:
                raise ValueError(
                    f"{where}: async e without an open b for "
                    f"cat={e['cat']!r} id={e['id']!r}"
                )
            st["open"] -= 1
            if st["names"].get(e["name"], 0) == 0:
                raise ValueError(
                    f"{where}: async e name {e['name']!r} was never begun "
                    f"on cat={e['cat']!r} id={e['id']!r}"
                )
            st["names"][e["name"]] -= 1
        elif ph in ("s", "f"):
            fl = flows.setdefault((e["cat"], str(e["id"])), {})
            if ph in fl:
                raise ValueError(
                    f"{where}: duplicate flow {ph!r} for "
                    f"cat={e['cat']!r} id={e['id']!r}"
                )
            fl[ph] = (e["ts"], e["name"])

    for (cat, async_id), st in async_open.items():
        if st["open"]:
            raise ValueError(
                f"unbalanced async b/e on cat={cat!r} id={async_id!r}: "
                f"{st['open']} unclosed"
            )
    for (cat, flow_id), fl in flows.items():
        if "s" not in fl:
            raise ValueError(
                f"flow cat={cat!r} id={flow_id!r}: f without s"
            )
        if "f" not in fl:
            raise ValueError(
                f"flow cat={cat!r} id={flow_id!r}: s without f "
                "(dangling arrow)"
            )
        if fl["f"][0] < fl["s"][0]:
            raise ValueError(
                f"flow cat={cat!r} id={flow_id!r}: finish at "
                f"ts={fl['f'][0]} precedes start at ts={fl['s'][0]}"
            )
        if fl["f"][1] != fl["s"][1]:
            raise ValueError(
                f"flow cat={cat!r} id={flow_id!r}: start name "
                f"{fl['s'][1]!r} != finish name {fl['f'][1]!r}"
            )
    for key, stack in be_stacks.items():
        if stack:
            raise ValueError(
                f"unbalanced B/E on pid={key[0]} tid={key[1]}: "
                f"{len(stack)} unclosed ({stack[-1]!r} last)"
            )
    for pid in used_pids:
        name = process_names.get(pid)
        if name is None:
            raise ValueError(f"pid {pid} has events but no process_name")
        if not name.startswith(f"rank {pid}"):
            raise ValueError(
                f"pid {pid} process_name {name!r} does not map to its rank"
            )
    for key in used_tids:
        name = thread_names.get(key)
        if name is None:
            raise ValueError(
                f"pid={key[0]} tid={key[1]} has events but no thread_name"
            )
        if SUBSYSTEM_TIDS.get(name) != key[1]:
            raise ValueError(
                f"pid={key[0]} tid={key[1]} thread_name {name!r} does not "
                "map to its subsystem tid"
            )
    for (pid, tid), spans in x_by_tid.items():
        stack: list[int] = []  # open-span end times
        for ts, dur in sorted(spans, key=lambda s: (s[0], -s[1])):
            while stack and ts >= stack[-1]:
                stack.pop()
            if stack and ts + dur > stack[-1]:
                raise ValueError(
                    f"pid={pid} tid={tid}: span at ts={ts} dur={dur} "
                    f"partially overlaps an enclosing span ending at "
                    f"{stack[-1]} (timeline nesting broken)"
                )
            stack.append(ts + dur)


def write_chrome_trace(metrics_path, out_path) -> dict:
    """Build, validate and write one run's trace; returns the trace."""
    by_rank = load_run(metrics_path)
    trace = build_chrome_trace(by_rank)
    validate_chrome_trace(trace)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(trace, f, indent=1)
    return trace


# -- phase attribution -------------------------------------------------------


PHASES = ("data_wait", "dispatch", "device", "exchange")


def attribute_rank(events: list[dict]) -> dict | None:
    """One rank's step time decomposed into phase totals/fractions.

    Only the fenced (sampled) steps are attributable - on async steps
    the device tail is invisible by design - and the run's first step
    is excluded like every timing summary (it carries the compile).
    One sampled step's cycle is ``data_wait + fenced``; within it,
    ``exchange`` (the step's ps_exchange seconds, clamped into the
    dispatch window it rides) and ``device = fenced - dispatch`` leave
    ``dispatch`` as host-side dispatch work, so the four fractions sum
    to 1 exactly up to float error.  Returns ``None`` when no sampled
    steady-state step exists.
    """
    steps = [e for e in events if e["kind"] == "step"]
    if not steps:
        return None
    first = min(int(e.get("step", 0)) for e in steps)
    exchange_by_step: dict[int, float] = {}
    for e in events:
        if e["kind"] == "ps_exchange" and not e.get("failed") \
                and e.get("step") is not None:
            exchange_by_step[int(e["step"])] = (
                exchange_by_step.get(int(e["step"]), 0.0)
                + float(e.get("seconds", 0.0))
            )
    totals = dict.fromkeys(PHASES, 0.0)
    cycle_total = 0.0
    sampled = 0
    for e in steps:
        step = int(e.get("step", 0))
        fenced = e.get("fenced_s")
        if fenced is None or (step == first and len(steps) > 1):
            continue
        fenced = float(fenced)
        dispatch = min(float(e.get("dispatch_s") or 0.0), fenced)
        data_wait = float(e.get("data_wait_s") or 0.0)
        exchange = min(exchange_by_step.get(step, 0.0), dispatch)
        totals["data_wait"] += data_wait
        totals["exchange"] += exchange
        totals["dispatch"] += dispatch - exchange
        totals["device"] += fenced - dispatch
        cycle_total += data_wait + fenced
        sampled += 1
    if not sampled or cycle_total <= 0:
        return None
    return {
        "rank": int(events[0].get("rank", 0)),
        "steps_sampled": sampled,
        "step_s_mean": cycle_total / sampled,
        "seconds": {k: totals[k] / sampled for k in PHASES},
        "fractions": {k: totals[k] / cycle_total for k in PHASES},
    }


def attribute_run(path) -> list[dict]:
    """Per-rank attributions for one run's sidecar family, by rank."""
    by_rank = load_run(path)
    out = []
    for rank in sorted(by_rank):
        attr = attribute_rank(by_rank[rank])
        if attr is not None:
            attr["rank"] = rank
            out.append(attr)
    return out


def attribute_stragglers(attributions: list[dict],
                         threshold: float = 0.25) -> list[dict]:
    """Straggler attribution: ranks whose sampled step cycle sits more
    than ``threshold`` (fraction) above the cross-rank median, blamed
    on the phase with the largest per-step excess over the median
    rank's same phase."""
    timed = [a for a in attributions if a.get("step_s_mean")]
    if len(timed) < 2:
        return []
    median_cycle = statistics.median(a["step_s_mean"] for a in timed)
    if median_cycle <= 0:
        return []
    median_phase = {
        k: statistics.median(a["seconds"][k] for a in timed)
        for k in PHASES
    }
    flagged = []
    for a in timed:
        excess = a["step_s_mean"] / median_cycle - 1.0
        if excess <= threshold:
            continue
        phase_excess = {
            k: a["seconds"][k] - median_phase[k] for k in PHASES
        }
        phase = max(phase_excess, key=phase_excess.get)
        flagged.append({
            "rank": a["rank"],
            "step_s_mean": a["step_s_mean"],
            "median_s": median_cycle,
            "excess_frac": excess,
            "phase": phase,
            "phase_excess_s": phase_excess[phase],
        })
    return sorted(flagged, key=lambda f: -f["excess_frac"])
