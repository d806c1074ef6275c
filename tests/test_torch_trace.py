"""The port's trace assembly (``pytorch_distributed_rnn_tpu_torch/obs/
trace.py``) and its ``trace`` subcommand against the JAX package's on the
same hand-built schema-2 sidecars: a router's and its replicas' ``-r<k>``
siblings, orphans, a duplicate span id, disconnected fragments, a cycle,
a containment leak, a span without its id, an empty and a missing file.
For each, ``assemble_traces``, ``format_traces_json``, ``format_trace_tree``
and the subcommand's output and exit code are equal between the port and
JAX.  Then the JAX package's 17 cases (``tests/test_trace_assemble.py``)
against the port.  No sockets, no models."""

import json

import pytest

from pytorch_distributed_rnn_tpu.obs import trace as jax_trace
from pytorch_distributed_rnn_tpu.obs.cli import main as jax_metrics_main
from pytorch_distributed_rnn_tpu_torch.obs import trace as port_trace
from pytorch_distributed_rnn_tpu_torch.obs.cli import main as metrics_main
from pytorch_distributed_rnn_tpu_torch.obs.trace import (
    MalformedTraceError,
    assemble_traces,
    collect_trace_spans,
    format_trace_tree,
    validate_trace_tree,
)

T0 = 1_700_000_000.0


def write_sidecar(path, rank, role, spans):
    """One schema-2 sidecar: meta line + the given span events.  Span
    tuples are ``(name, trace, span, parent, t_off_s, dur_s, attrs)``."""
    lines = [{
        "kind": "meta", "t": T0, "tm": 100.0, "rank": rank, "schema": 2,
        "sample_every": 1, "meta": {"role": role}, "role": role,
    }]
    for name, trace, span, parent, t_off, dur_s, attrs in spans:
        event = {
            "kind": "span", "name": name, "cat": "trace", "rank": rank,
            "t": T0 + t_off, "tm": 100.0 + t_off, "dur_s": dur_s,
            "trace": trace, "span": span, **attrs,
        }
        if parent is not None:
            event["parent"] = parent
        lines.append(event)
    path.write_text("".join(json.dumps(e) + "\n" for e in lines))
    return path


def fleet_sidecars(tmp_path, trace="t1"):
    """A router's route span with two dispatch attempts (a retry), the
    second attempt's replica recording queue_wait + decode as its
    children."""
    router = write_sidecar(tmp_path / "router.jsonl", 0, "router", [
        ("route", trace, "r0", "edge", 0.0, 1.0, {"request": "42", "qos": "high"}),
        ("attempt", trace, "a1", "r0", 0.0, 0.3,
         {"replica": 1, "attempt": 1, "outcome": "error"}),
        ("attempt", trace, "a2", "r0", 0.35, 0.6,
         {"replica": 2, "attempt": 2, "outcome": "done"}),
    ])
    replica = write_sidecar(tmp_path / "replica.jsonl", 2, "serve", [
        ("queue_wait", trace, "q1", "a2", 0.36, 0.1, {"request": "42"}),
        ("decode", trace, "d1", "a2", 0.46, 0.45, {"request": "42", "tokens": 8,
                                                   "status": "done"}),
    ])
    return router, replica


def _family(tmp_path):
    """A router's family: the rank-0 sidecar and two ``-r<k>`` replicas,
    two traces (one retried across replicas, one direct)."""
    base = write_sidecar(tmp_path / "fleet.jsonl", 0, "router", [
        ("route", "aa", "r0", None, 0.0, 1.2, {"request": "7", "qos": "low"}),
        ("attempt", "aa", "a1", "r0", 0.0, 0.2, {"replica": 1, "attempt": 1,
                                                 "outcome": "transport_error"}),
        ("attempt", "aa", "a2", "r0", 0.3, 0.8, {"replica": 2, "attempt": 2,
                                                 "outcome": "done"}),
        ("route", "bb", "x0", None, 0.1, 0.4, {"request": "8"}),
        ("attempt", "bb", "x1", "x0", 0.1, 0.35, {"replica": 1, "attempt": 1}),
    ])
    write_sidecar(tmp_path / "fleet-r1.jsonl", 1, "serve", [
        ("queue_wait", "bb", "q1", "x1", 0.11, 0.05, {"request": "8"}),
        ("decode", "bb", "d1", "x1", 0.16, 0.25, {"request": "8"}),
    ])
    write_sidecar(tmp_path / "fleet-r2.jsonl", 2, "serve", [
        ("queue_wait", "aa", "q2", "a2", 0.31, 0.1, {"request": "7"}),
        ("prefill", "aa", "p2", "a2", 0.41, 0.05, {"request": "7", "slot": 0}),
        ("decode", "aa", "d2", "a2", 0.46, 0.6, {"request": "7"}),
        ("stream_emit", "aa", "e2", "d2", 0.5, 0.5, {"request": "7"}),
    ])
    return [base]


def _spans(name):
    """Sidecar sets by name -> a function writing them, returning their paths."""
    cases = {
        "fleet": lambda d: list(fleet_sidecars(d)),
        "family": _family,
        "orphans": lambda d: [write_sidecar(d / "solo.jsonl", 0, "serve", [
            ("queue_wait", "t9", "q1", "edge", 0.0, 0.1, {"request": "5"}),
            ("decode", "t9", "d1", "edge", 0.1, 0.5, {"request": "5"}),
        ])],
        "slowest": lambda d: [write_sidecar(d / "m.jsonl", 0, "router", [
            ("route", "aa11", "s1", None, 0.0, 0.2, {"request": "1"}),
            ("route", "bb22", "s2", None, 0.0, 0.9, {"request": "2"}),
        ])],
        "duplicate": lambda d: [write_sidecar(d / "dup.jsonl", 0, "router", [
            ("route", "t1", "s1", None, 0.0, 1.0, {}),
            ("attempt", "t1", "s1", None, 0.0, 0.5, {}),
        ])],
        "fragments": lambda d: [write_sidecar(d / "frag.jsonl", 0, "router", [
            ("route", "t1", "s1", "p1", 0.0, 1.0, {}),
            ("route", "t1", "s2", "p2", 0.0, 1.0, {}),
        ])],
        "cycle": lambda d: [write_sidecar(d / "cycle.jsonl", 0, "router", [
            ("a", "t1", "s1", "s2", 0.0, 1.0, {}),
            ("b", "t1", "s2", "s1", 0.0, 1.0, {}),
        ])],
        "containment": lambda d: [write_sidecar(d / "leak.jsonl", 0, "router", [
            ("route", "t1", "s1", None, 0.0, 0.1, {}),
            ("attempt", "t1", "s2", "s1", 0.0, 5.0, {}),
        ])],
        "nospan": lambda d: [_nospan(d)],
        "empty": lambda d: [write_sidecar(d / "empty.jsonl", 0, "serve", [])],
        "missing": lambda d: [d / "missing.jsonl"],
    }
    return cases[name]


def _nospan(d):
    path = d / "nospan.jsonl"
    meta = {"kind": "meta", "t": T0, "tm": 1.0, "rank": 0, "schema": 2, "sample_every": 1,
            "role": "router"}
    bad = {"kind": "span", "name": "route", "cat": "trace", "t": T0, "tm": 1.0, "dur_s": 0.1,
           "trace": "t1"}
    path.write_text(json.dumps(meta) + "\n" + json.dumps(bad) + "\n")
    return path


SETS = ["fleet", "family", "orphans", "slowest", "duplicate", "fragments", "cycle",
        "containment", "nospan", "empty", "missing"]


def _outcome(module, paths, **kwargs):
    """What ``module.assemble_traces`` gives: the JSON of the trees and
    each tree's text, or the error's class name and message."""
    try:
        trees = module.assemble_traces(paths, **kwargs)
        for tree in trees:
            module.validate_trace_tree(tree)
    except Exception as exc:  # the error itself is the outcome compared
        return ("error", type(exc).__name__, str(exc))
    return ("ok", module.format_traces_json(trees),
            [module.format_trace_tree(tree) for tree in trees])


# ---------------------------------------------------------------------------
# the port against JAX on the same sidecars


@pytest.mark.parametrize("name", SETS)
def test_assembly_equals_jax(name, tmp_path):
    paths = _spans(name)(tmp_path)
    port, ref = _outcome(port_trace, paths), _outcome(jax_trace, paths)
    assert port == ref
    expect_error = name in ("duplicate", "fragments", "cycle", "containment", "nospan",
                            "missing")
    assert (port[0] == "error") == expect_error
    if name in ("fleet", "family", "slowest"):
        for request in ("42", "7", "bb", "zz"):
            assert _outcome(port_trace, paths, request=request) == \
                _outcome(jax_trace, paths, request=request)


@pytest.mark.parametrize("argv", [[], ["--json"], ["--slowest", "1"],
                                  ["--request", "7", "--json"], ["--request", "zz"]],
                         ids=["text", "json", "slowest", "request-json", "no-match"])
@pytest.mark.parametrize("name", SETS)
def test_trace_subcommand_equals_jax(name, argv, tmp_path, capsys):
    paths = [str(p) for p in _spans(name)(tmp_path)]
    rc = metrics_main(["trace", *paths, *argv])
    port = capsys.readouterr()
    jax_rc = jax_metrics_main(["trace", *paths, *argv])
    ref = capsys.readouterr()
    assert (rc, port.out, port.err) == (jax_rc, ref.out, ref.err)
    assert rc in (0, 2)


# ---------------------------------------------------------------------------
# the JAX package's cases against the port


class TestAssembly:
    def test_cross_process_tree_links_router_and_replica(self, tmp_path):
        router, replica = fleet_sidecars(tmp_path)
        trees = assemble_traces([router, replica])
        assert len(trees) == 1
        tree = trees[0]
        assert tree.trace_id == "t1" and tree.request == "42"
        assert tree.root.name == "route"
        assert [c.name for c in tree.root.children] == ["attempt", "attempt"]
        retry = tree.root.children[1]
        assert retry.attrs["attempt"] == 2
        assert {c.name for c in retry.children} == {"queue_wait", "decode"}
        assert len(tree.processes) == 2
        validate_trace_tree(tree)

    def test_critical_path_fractions_sum_to_exactly_one(self, tmp_path):
        fractions = assemble_traces(list(fleet_sidecars(tmp_path)))[0].critical_path()
        assert sum(fractions.values()) == 1.0
        assert set(fractions) == {"route", "attempt", "queue_wait", "decode"}
        assert all(f > 0 for f in fractions.values())

    def test_rank_family_expansion_pulls_replica_siblings(self, tmp_path):
        base = tmp_path / "fleet.jsonl"
        write_sidecar(base, 0, "router", [("route", "t1", "r0", None, 0.0, 1.0,
                                           {"request": "7"})])
        write_sidecar(tmp_path / "fleet-r1.jsonl", 1, "serve",
                      [("queue_wait", "t1", "q1", "r0", 0.1, 0.2, {})])
        assert len(assemble_traces([base])[0].processes) == 2

    def test_sibling_orphans_synthesize_the_unrecorded_edge(self, tmp_path):
        tree = assemble_traces(_spans("orphans")(tmp_path))[0]
        assert tree.root.name == "request"
        assert tree.root.attrs.get("synthesized") is True
        assert [c.name for c in tree.root.children] == ["queue_wait", "decode"]
        validate_trace_tree(tree)

    def test_slowest_ordering_and_request_filter(self, tmp_path):
        side = _spans("slowest")(tmp_path)
        assert [t.trace_id for t in assemble_traces(side)] == ["bb22", "aa11"]
        assert [t.trace_id for t in assemble_traces(side, request="1")] == ["aa11"]
        assert [t.trace_id for t in assemble_traces(side, request="bb")] == ["bb22"]
        assert assemble_traces(side, request="zz") == []

    def test_format_names_processes_and_critical_path(self, tmp_path):
        text = format_trace_tree(assemble_traces(list(fleet_sidecars(tmp_path)))[0])
        assert "trace t1" in text and "request=42" in text
        assert "route" in text and "queue_wait" in text
        assert "router:r0" in text and "serve:r2" in text
        assert "critical path:" in text and "attempt=2" in text


class TestMalformed:
    def test_duplicate_span_id(self, tmp_path):
        with pytest.raises(MalformedTraceError, match="duplicate span"):
            assemble_traces(_spans("duplicate")(tmp_path))

    def test_disconnected_fragments(self, tmp_path):
        with pytest.raises(MalformedTraceError, match="disconnected roots"):
            assemble_traces(_spans("fragments")(tmp_path))

    def test_cycle_has_no_root(self, tmp_path):
        with pytest.raises(MalformedTraceError, match="no root"):
            assemble_traces(_spans("cycle")(tmp_path))

    def test_containment_violation_past_skew(self, tmp_path):
        with pytest.raises(MalformedTraceError, match="outside its"):
            assemble_traces(_spans("containment")(tmp_path))

    def test_trace_without_span_field(self, tmp_path):
        with pytest.raises(MalformedTraceError, match="without"):
            collect_trace_spans([_nospan(tmp_path)])

    def test_build_rejects_foreign_trace_id(self):
        from pytorch_distributed_rnn_tpu_torch.obs.trace import TraceNode, TraceTree

        root = TraceNode({"name": "route", "trace": "t1", "span": "s1", "t": T0, "dur_s": 1.0},
                         rank=0, role="router", source="x")
        alien = TraceNode({"name": "decode", "trace": "OTHER", "span": "s2", "parent": "s1",
                           "t": T0, "dur_s": 0.5}, rank=0, role="serve", source="x")
        root.children.append(alien)
        with pytest.raises(MalformedTraceError, match="belongs"):
            validate_trace_tree(TraceTree("t1", root))


class TestCli:
    def test_trace_subcommand_prints_trees(self, tmp_path, capsys):
        router, replica = fleet_sidecars(tmp_path)
        assert metrics_main(["trace", str(router), str(replica), "--slowest", "1"]) == 0
        out = capsys.readouterr().out
        assert "trace t1" in out and "critical path:" in out

    def test_trace_subcommand_request_filter_and_json(self, tmp_path, capsys):
        router, replica = fleet_sidecars(tmp_path)
        assert metrics_main(["trace", str(router), str(replica), "--request", "42",
                             "--json"]) == 0
        payload = json.loads(capsys.readouterr().out)
        assert len(payload) == 1 and payload[0]["request"] == "42"
        assert sum(payload[0]["critical_path"].values()) == 1.0

    def test_trace_subcommand_no_traces_is_clean(self, tmp_path, capsys):
        side = write_sidecar(tmp_path / "empty.jsonl", 0, "serve", [])
        assert metrics_main(["trace", str(side)]) == 0
        assert "no request trace" in capsys.readouterr().out

    def test_trace_subcommand_malformed_is_exit_2(self, tmp_path):
        assert metrics_main(["trace", str(_spans("duplicate")(tmp_path)[0])]) == 2

    def test_unreadable_file_is_exit_2(self, tmp_path):
        assert metrics_main(["trace", str(tmp_path / "missing.jsonl")]) == 2
