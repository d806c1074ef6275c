"""Cross-process trace assembly: sidecar span events -> causal trees (a
copy of the JAX package's ``obs/trace.py``).

The read side of ``obs/tracectx.py``: every process on a traced
request's path (router, replicas) records ordinary ``span`` events
carrying ``trace``/``span``/``parent`` attributes on its own
:class:`~.recorder.MetricsRecorder` sidecar.  This module re-joins any
number of those sidecars (rank families expand automatically, so
``router-metrics.jsonl`` pulls in the replicas' ``-r<k>`` siblings)
into one :class:`TraceTree` per trace_id - the ``trace`` subcommand of
``python -m pytorch_distributed_rnn_tpu_torch.obs`` sits on top.

Span wall-clock stamps come from each process's own anchor
(``recorder.py``); same-host skew is millisecond-scale, so child spans
are clamped into their parent's window with :data:`SKEW_TOL_S` slack
rather than trusted blindly.

Critical-path attribution: every node's SELF time is its duration
minus its children's (clamped) durations, and the reported fractions
are self times normalized over their total - so they sum to 1 exactly,
the same contract as the ledger's phase fractions.
"""

from __future__ import annotations

import json

from pytorch_distributed_rnn_tpu_torch.obs.summary import (
    MalformedMetricsError,
    load_events,
    rank_files,
)

# tolerated cross-process clock skew when validating parent/child
# nesting (same-host wall clocks; the anchors are NTP-stepped wall
# time, not the monotonic clocks themselves)
SKEW_TOL_S = 0.05

# span attributes that are trace bookkeeping, not payload
_CTX_KEYS = ("trace", "span", "parent")


class MalformedTraceError(MalformedMetricsError):
    """The collected spans do not form a well-formed trace tree."""


class TraceNode:
    """One span of one process, linked into its causal tree."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t",
                 "dur_s", "rank", "role", "source", "attrs", "children",
                 "self_s")

    def __init__(self, event: dict, *, rank: int, role: str,
                 source: str):
        self.name = str(event.get("name", "?"))
        self.trace_id = str(event["trace"])
        self.span_id = str(event["span"])
        parent = event.get("parent")
        self.parent_id = None if parent is None else str(parent)
        self.t = float(event.get("t", 0.0))
        self.dur_s = max(0.0, float(event.get("dur_s") or 0.0))
        self.rank = rank
        self.role = role
        self.source = source
        self.attrs = {
            k: v for k, v in event.items()
            if k not in ("kind", "name", "t", "tm", "rank", "dur_s",
                         "cat", *_CTX_KEYS)
        }
        self.children: list[TraceNode] = []
        self.self_s = 0.0

    @property
    def end(self) -> float:
        return self.t + self.dur_s

    def walk(self):
        yield self
        for child in self.children:
            yield from child.walk()


class TraceTree:
    """One request's assembled tree: a root plus derived views."""

    def __init__(self, trace_id: str, root: TraceNode):
        self.trace_id = trace_id
        self.root = root

    @property
    def duration_s(self) -> float:
        return self.root.dur_s

    @property
    def processes(self) -> set:
        """Distinct (source, rank) pairs contributing spans - the
        cross-process gate counts these."""
        return {(n.source, n.rank) for n in self.root.walk()}

    @property
    def request(self):
        for node in self.root.walk():
            if node.attrs.get("request") is not None:
                return node.attrs["request"]
        return None

    def critical_path(self) -> dict:
        """``span name -> fraction of the root's wall time`` attributed
        to that name's SELF time, normalized to sum to 1 exactly."""
        for node in self.root.walk():
            child_s = sum(
                min(c.dur_s, max(0.0, self.root.end - c.t))
                for c in node.children
            )
            node.self_s = max(0.0, node.dur_s - child_s)
        total = sum(n.self_s for n in self.root.walk())
        if total <= 0.0:
            return {self.root.name: 1.0}
        fractions: dict[str, float] = {}
        for node in self.root.walk():
            if node.self_s > 0.0:
                fractions[node.name] = (
                    fractions.get(node.name, 0.0) + node.self_s / total
                )
        # float dust lands on the largest bin so the sum is EXACT
        largest = max(fractions, key=lambda k: fractions[k])
        fractions[largest] += 1.0 - sum(fractions.values())
        return fractions

    def to_json(self) -> dict:
        def node_json(node: TraceNode) -> dict:
            return {
                "name": node.name, "span": node.span_id,
                "parent": node.parent_id, "t": node.t,
                "dur_s": node.dur_s, "rank": node.rank,
                "role": node.role, "source": node.source,
                "attrs": node.attrs,
                "children": [node_json(c) for c in node.children],
            }

        return {
            "trace_id": self.trace_id,
            "request": self.request,
            "duration_s": self.duration_s,
            "processes": sorted(
                f"{src}:r{rank}" for src, rank in self.processes
            ),
            "critical_path": self.critical_path(),
            "root": node_json(self.root),
        }


def collect_trace_spans(paths) -> dict:
    """All trace-carrying ``span`` events off every sidecar family in
    ``paths``, grouped by trace_id.  Returns
    ``{trace_id: [TraceNode, ...]}`` (unlinked)."""
    by_trace: dict[str, list[TraceNode]] = {}
    seen_files = set()
    for path in paths:
        files = rank_files(path)
        if not files:
            raise MalformedTraceError(
                f"{path}: no metrics sidecar found"
            )
        for file in files:
            if file in seen_files:
                continue
            seen_files.add(file)
            events = load_events(file)
            meta = events[0]
            rank = int(meta.get("rank", 0))
            role = str(meta.get("role", "?"))
            for event in events:
                if event.get("kind") != "span" or "trace" not in event:
                    continue
                if "span" not in event:
                    raise MalformedTraceError(
                        f"{file}: span event carries 'trace' without "
                        f"'span'"
                    )
                node = TraceNode(event, rank=rank, role=role,
                                 source=str(file))
                by_trace.setdefault(node.trace_id, []).append(node)
    return by_trace


def build_trace_tree(trace_id: str, nodes) -> TraceTree:
    """Link one trace's spans into a tree.  A node whose parent was
    recorded nowhere (the edge lived in a process without a sidecar -
    a tracing load generator, say) roots the tree; several such
    orphans sharing ONE unrecorded parent are siblings under it, so a
    synthetic root named ``request`` is minted to hold them (the
    direct-server shape: every engine phase is a child of the client's
    root span).  Orphans under DIFFERENT unrecorded parents are
    disconnected fragments and malformed, as is any duplicate span id
    or nesting that violates wall-clock containment beyond
    :data:`SKEW_TOL_S`."""
    by_span: dict[str, TraceNode] = {}
    for node in nodes:
        if node.span_id in by_span:
            raise MalformedTraceError(
                f"trace {trace_id}: duplicate span id {node.span_id} "
                f"({by_span[node.span_id].name} vs {node.name})"
            )
        by_span[node.span_id] = node
    roots = []
    for node in by_span.values():
        parent = (
            None if node.parent_id is None
            else by_span.get(node.parent_id)
        )
        if parent is None:
            roots.append(node)
        else:
            parent.children.append(node)
    if not roots:
        raise MalformedTraceError(
            f"trace {trace_id}: no root (span/parent links form a "
            f"cycle)"
        )
    if len(roots) > 1:
        parents = {r.parent_id for r in roots}
        if len(parents) != 1 or None in parents:
            names = ", ".join(sorted(r.name for r in roots))
            raise MalformedTraceError(
                f"trace {trace_id}: {len(roots)} disconnected roots "
                f"({names})"
            )
        # every orphan hangs off the same unrecorded edge span: mint it
        t0 = min(r.t for r in roots)
        root = TraceNode(
            {
                "name": "request", "trace": trace_id,
                "span": parents.pop(), "t": t0,
                "dur_s": max(r.end for r in roots) - t0,
                "synthesized": True,
            },
            rank=-1, role="client", source="(unrecorded edge)",
        )
        root.children.extend(roots)
        roots = [root]
    root = roots[0]
    for node in root.walk():
        node.children.sort(key=lambda n: (n.t, n.span_id))
        for child in node.children:
            if child.t < node.t - SKEW_TOL_S \
                    or child.end > node.end + SKEW_TOL_S:
                raise MalformedTraceError(
                    f"trace {trace_id}: span {child.name} "
                    f"[{child.t:.6f}, {child.end:.6f}] outside its "
                    f"parent {node.name} [{node.t:.6f}, "
                    f"{node.end:.6f}] beyond {SKEW_TOL_S:g}s skew"
                )
    return TraceTree(trace_id, root)


def validate_trace_tree(tree: TraceTree) -> None:
    """The tree-shape contract the ``trace`` subcommand enforces before
    printing: one root, resolvable links, wall-clock containment
    (:func:`build_trace_tree` raises on those) plus critical-path
    fractions summing to 1."""
    fractions = tree.critical_path()
    total = sum(fractions.values())
    if abs(total - 1.0) > 1e-9:
        raise MalformedTraceError(
            f"trace {tree.trace_id}: critical-path fractions sum to "
            f"{total!r}, not 1"
        )
    for node in tree.root.walk():
        if node.trace_id != tree.trace_id:
            raise MalformedTraceError(
                f"trace {tree.trace_id}: span {node.span_id} belongs "
                f"to trace {node.trace_id}"
            )


def assemble_traces(paths, *, request=None) -> list[TraceTree]:
    """Every trace tree across the sidecar families in ``paths``,
    slowest (largest root duration) first.  ``request`` filters to
    trees whose request id matches, or whose trace_id starts with it."""
    by_trace = collect_trace_spans(paths)
    trees = [
        build_trace_tree(trace_id, nodes)
        for trace_id, nodes in by_trace.items()
    ]
    if request is not None:
        want = str(request)
        trees = [
            t for t in trees
            if str(t.request) == want or t.trace_id.startswith(want)
        ]
    trees.sort(key=lambda t: (-t.duration_s, t.trace_id))
    return trees


def format_trace_tree(tree: TraceTree) -> str:
    """Human-readable tree + critical-path attribution."""
    lines = [
        f"trace {tree.trace_id}"
        + (f"  request={tree.request}" if tree.request is not None
           else "")
        + f"  {tree.duration_s * 1e3:.1f}ms across "
        f"{len(tree.processes)} process(es)"
    ]

    def emit(node: TraceNode, depth: int):
        extras = []
        for key in ("request", "replica", "attempt", "qos", "slot",
                    "status", "outcome", "hedge", "tokens"):
            if node.attrs.get(key) is not None:
                extras.append(f"{key}={node.attrs[key]}")
        where = f"{node.role}:r{node.rank}"
        lines.append(
            "  " * (depth + 1)
            + f"{node.name}  {node.dur_s * 1e3:.1f}ms  [{where}]"
            + (f"  ({', '.join(extras)})" if extras else "")
        )
        for child in node.children:
            emit(child, depth + 1)

    emit(tree.root, 0)
    fractions = tree.critical_path()
    ordered = sorted(fractions.items(), key=lambda kv: -kv[1])
    lines.append(
        "  critical path: "
        + "  ".join(f"{name} {frac:.1%}" for name, frac in ordered)
    )
    return "\n".join(lines)


def format_traces_json(trees) -> str:
    return json.dumps([t.to_json() for t in trees], indent=2)
