"""The A/B runner of the port (``utils/ab.py``) on the CPU: its command
line, and the copies of the package it measures (the substitutions each
A/B makes are still found in the package's sources)."""

from pathlib import Path

import pytest

from pytorch_distributed_rnn_tpu_torch.utils import ab


@pytest.mark.parametrize("argv, want", [
    (["rows"], ("rows", None, 1, None)),
    (["split"], ("split", None, 1, None)),
    (["tc"], ("tc", None, 1, None)),
    (["drift"], ("drift", None, 1, None)),
    (["step", "--other", "x"], ("step", Path("x").resolve(), 1, "d")),
    (["step", "--other", "x", "--rounds", "5"], ("step", Path("x").resolve(), 5, "d")),
    (["step", "--path", "f", "--other", "x"], ("step", Path("x").resolve(), 1, "f")),
    (["step", "--other", "x", "--rounds", "3", "--path", "a"],
     ("step", Path("x").resolve(), 3, "a")),
    (["step", "--other", "x", "--path", "b"], ("step", Path("x").resolve(), 1, "b")),
    (["step", "--other", "x", "--path", "e"], ("step", Path("x").resolve(), 1, "e")),
    (["step", "--other", "x", "--path", "c"], ("step", Path("x").resolve(), 1, "c")),
    (["step", "--graph"], ("graph", None, 1, "d")),
    (["step", "--graph", "--path", "a", "--rounds", "3"], ("graph", None, 3, "a")),
    (["step", "--rounds", "2", "--graph", "--path", "c"], ("graph", None, 2, "c")),
    (["fwd", "--other", "x"], ("fwd", Path("x").resolve(), 1, None)),
    (["fwd", "--rounds", "2", "--other", "x"], ("fwd", Path("x").resolve(), 2, None)),
    (["dp"], ("dp", None, 1, None)),
    (["dp", "--rounds", "3"], ("dp", None, 3, None)),
    (["step", "--other", "x", "--path", "g"], ("step", Path("x").resolve(), 1, "g")),
    (["step", "--other", "x", "--rounds", "2", "--path", "h0"],
     ("step", Path("x").resolve(), 2, "h0")),
])
def test_parse(argv, want):
    assert ab._parse(argv) == want


@pytest.mark.parametrize("argv", [
    [], ["rows", "x"], ["step"], ["step", "--other"], ["step", "--other", "x", "--rounds"],
    ["step", "--other", "x", "--rounds", "0"], ["step", "--other", "x", "--pairs", "5"],
    ["kernels"], ["tc", "--rounds", "2"], ["step", "--other", "x", "--path", "z"], ["gates"],
    ["rows", "--rounds", "2"], ["step", "--other", "x", "--other", "y"],
    ["fwd"], ["fwd", "--other", "x", "--path", "d"], ["fwd", "--rounds", "2"],
    ["dp", "--other", "x"], ["dp", "--path", "g"], ["step", "--other", "x", "--path", "g1"],
    ["step", "--graph", "--other", "x"], ["step", "--graph", "--path", "g"], ["fwd", "--graph"],
    ["dp", "--graph"], ["drift", "--rounds", "2"], ["drift", "--path", "a"],
])
def test_parse_rejects(argv):
    with pytest.raises(SystemExit):
        ab._parse(argv)


@pytest.mark.parametrize("substitutions", [ab.ROWS_8_TO_4, ab.MASK_TO_CVT, ab.TC_CHAINED,
                                           ab.TC_HOISTED, ab.FWD_WARPS_4],
                         ids=["rows", "split", "chained", "hoisted", "warps4"])
def test_patched_copy_makes_each_substitution(tmp_path, substitutions):
    root = ab.patched_copy(tmp_path / "copy", substitutions)
    for rel, old, new in substitutions:
        text = (root / ab.PACKAGE.name / rel).read_text()
        assert old not in text and new in text
        assert old in (ab.PACKAGE / rel).read_text()


def test_patched_copy_raises_on_a_missing_text(tmp_path):
    with pytest.raises(RuntimeError, match="not found"):
        ab.patched_copy(tmp_path / "copy", (("ops/fused_rnn.py", "no such text", "x"),))


def test_device_events_leave_out_user_annotations():
    """A ``record_function`` range (``Optimizer.step#Adam.step``, DDP's
    forward) has a device span over kernels the profile counts already: it
    is not a device entry of its own."""
    from types import SimpleNamespace

    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [SimpleNamespace(key="lstm_fwd_kernel", device_type=cuda, is_user_annotation=False),
              SimpleNamespace(key="Optimizer.step#Adam.step", device_type=cuda,
                              is_user_annotation=True),
              SimpleNamespace(key="aten::mm", device_type=cpu, is_user_annotation=False)]
    prof = SimpleNamespace(key_averages=lambda: events)
    assert [e.key for e in ab.device_events(prof)] == ["lstm_fwd_kernel"]


def test_device_profile_keeps_margins_around_the_body(monkeypatch):
    """The body runs inside the profile, after a host-only margin, and the
    window stays open a margin after it."""
    import time

    import torch
    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(ab, "PROFILE_MARGIN_S", 0.05)
    t0 = time.perf_counter()
    with ab.device_profile(activities=[ProfilerActivity.CPU]) as prof:
        entered = time.perf_counter()
        torch.ones(4).add_(1)
        left = time.perf_counter()
    assert entered - t0 >= 0.05 and time.perf_counter() - left >= 0.05
    assert any(e.key == "aten::add_" for e in prof.key_averages())
