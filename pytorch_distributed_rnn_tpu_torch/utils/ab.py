"""A/B runs of the port's kernels and of a training step on one card.

    python -m pytorch_distributed_rnn_tpu_torch.utils.ab rows
    python -m pytorch_distributed_rnn_tpu_torch.utils.ab split
    python -m pytorch_distributed_rnn_tpu_torch.utils.ab tc
    python -m pytorch_distributed_rnn_tpu_torch.utils.ab fwd --other DIR [--rounds N]
    python -m pytorch_distributed_rnn_tpu_torch.utils.ab step --other DIR [--rounds N] [--path P]
    python -m pytorch_distributed_rnn_tpu_torch.utils.ab step --other DIR [--rounds N] --path g|g0|h|h0
    python -m pytorch_distributed_rnn_tpu_torch.utils.ab step --graph [--rounds N] [--path P]
    python -m pytorch_distributed_rnn_tpu_torch.utils.ab dp [--rounds N]
    python -m pytorch_distributed_rnn_tpu_torch.utils.ab drift

Each run measures one tree (a copy of this package with a source
substitution, or another checkout) in its own process, with the measuring
code of this file, in turns (A, B, B, A for each round), and prints one
JSON line after the card's name and power limit.

``rows``: the GRU forward's cluster kernel at 8 batch rows a cluster (the
package's ``kFwdClusterRows``) against 4, ``gru_fwd`` at the char-LM shape
(T=128, B=256, H=512, float32): the whole call and one cluster's rows (the
serial floor), with the error against the plain version.

``split``: ``flash_dqkv``'s 3xTF32 split by a bit mask (the package's
``csrc/flash_mma.cuh:split_tf32``) against ``cvt.rna.tf32.f32`` rounding,
at the attention CLI's shapes (BH=1024 and 512, T=128, D=32, float32),
beside the split route on the same inputs (delta in torch, ``flash_dq``,
``flash_dkv``), with the scaled error against the plain version and whether
two launches give the same bits.

``tc``: the float32 LSTM forward's tensor-core kernel (``csrc/lstm_fwd.cu:
lstm_fwd_tc_kernel``) at the char-LM shape (T=128, B=256, H=512) and one
cluster of 40 rows, with the worst scaled error against the plain version
over its edge cases (H=512 at B=256, 104, 204; H=449 at 37; H=480 at 61;
two seeds each), and each instance's registers, stack and local memory
(``cuobjdump -res-usage``): this tree, a copy whose k-steps chain their
products straight into the accumulators (``chained``), and a copy that
keeps its thread index from the kernel's start (``hoisted``: the compiler
then holds the addresses it derives across the step).

``fwd``: the flash forward with the package under DIR, with this one,
and with this one at 4 warps (64 query rows) a float32 block in place
of 8 (``csrc/flash_fwd.cu:kF32FwdWarps``): ``flash_fwd`` in float32 at
the attention CLI's train shape (BH=1024, T=128, D=32) on (BH, T, D)
rows, with its scaled error against the plain version; the same as the
model calls it, ``flash_attention`` on the heads ``_split_heads`` makes
of (B, T, H*D) projections and the heads merged back (``call_ms``), with
the device copy kernels of that call (``copy_launches``, ``copy_ms``,
under ``torch.profiler``); and the bf16 forward at the long-context
shape (BH=64, T=1024, D=128).

``step``: a main path with the package under DIR (for example a ``git
archive`` of another commit) and with this one: 2 epochs on seeded
synthetic data at the CLI's sizes, then 4 more epochs a step on the host
clock and one under ``torch.profiler`` (device time a step, and that of
each of the port's kernels).  ``--path`` (default d): ``a``, the motion
LSTM with the CLI's defaults (batch 1440, 2 x 32) on HAR windows at the
UCI sizes; ``b``, the same with ``--cell gru``; ``d``, ``--model
attention --hidden-units 128 --num-heads 4 --stacked-layer 2
--batch-size 256 --dropout 0`` on the same windows;
``f``, ``--model char --hidden-units 512 --stacked-layer 2 --seq-length
128 --batch-size 256 --dropout 0`` (the default LSTM cell) on the
synthetic motif corpus; ``c``, the same with ``--cell gru``; ``e``, the
long-context classifier (dim 512, 4 heads, depth 2, bf16, T=1024)
through the local trainer, Adam at 1e-3, 10 steps of batch 16 an epoch
on 160 seeded random windows.  Each step's device copy kernels are
counted too.  A data-parallel path (``g``, ``g0``, ``h``, ``h0``, as
under ``dp``) runs in a ``torchrun`` world of its ranks for each tree and
times its per-batch loop, the strategies' only path before their graph
path, so that two trees compare on the same loop.

``step --graph``: a main path of this tree only, the local trainer's
per-batch loop (eager) and its per-epoch graph path (CUDA-graph replays of
the train step) in turns in one process: after 2 epochs (the graph path's
captures), N rounds of eager, graph, graph, eager epochs on the host clock,
then one epoch of each under ``torch.profiler``, so host and device ms a
step come from the same steps of both; the card's idle share of each
path's median step, and the graphs' capture ms.

``dp``: the data-parallel paths of this tree beside path a, in turns
(a, g, g0, h, h0, then back): ``g`` is ``distributed`` at world 1 on
NCCL with the CLI's default ``--sharded-update``, ``g0`` the same with
``--no-sharded-update``, ``h`` and ``h0`` the same at world 2, two ranks
sharing the card over gloo (not a scaling figure).  Each rank of a world
is a ``torchrun`` process that measures as ``step`` does, with path a's
flags, and reports besides: the collectives' device time a step (the NCCL kernels) and their
host time a step (the ``nccl:``/``gloo:`` events of the profile), the eight
largest device entries a step, and the device time of one Adam step alone (``adam_ms``: ``torch.optim.Adam`` on
path a, the port's ``ops/adam.py`` on each parameter on g0 and h0, and
on the rank's flat 1/world slice on g and h).

``drift``: how many device records ``torch.profiler`` keeps of a short
window (``DRIFT_LAUNCHES`` synced launches of one small kernel) as the
measuring process ages, a window every ``DRIFT_PAUSE_S`` seconds, each
opened plainly and through :func:`device_profile`.

Copies go to ``build/ab/``.  Kernel times are CUDA events over repeated
launches.  This file imports nothing of the package at module level, so a
tree that does not hold it can be measured with it.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
WORK = PACKAGE.parent / "build" / "ab"
ROWS_8_TO_4 = (
    ("csrc/gru_fwd.cu", "constexpr int kFwdClusterRows = 8;", "constexpr int kFwdClusterRows = 4;"),
    ("ops/fused_rnn.py", "GRU_FWD_CLUSTER_ROWS = 8", "GRU_FWD_CLUSTER_ROWS = 4"),
)
MASK_TO_CVT = ((
    "csrc/flash_mma.cuh",
    """  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));""",
    """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(rest));""",
),)
GRU_SHAPE = (128, 256, 512)  # T, B, H of the char LM
ATTN_BATCHES = (1024, 512)  # B*H of the CLI's train batches (256 and 128 windows, 4 heads)
ATTN_SEQ_LEN, ATTN_HEAD_DIM = 128, 32
TC_CHAINED = ((
    "csrc/lstm_fwd.cu",
    """      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      flash::mma_tf32(d, al, bh0, bh1);
      flash::mma_tf32(d, ah, bl0, bl1);
      flash::mma_tf32(d, ah, bh0, bh1);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += d[e];""",
    """      flash::mma_tf32(acc[n], al, bh0, bh1);
      flash::mma_tf32(acc[n], ah, bl0, bl1);
      flash::mma_tf32(acc[n], ah, bh0, bh1);""",
),)
TC_HOISTED = (("csrc/lstm_fwd.cu", "    const int tid = step_tid();", "    const int tid = threadIdx.x;"),)
TC_SHAPE = (128, 256, 512)  # T, B, H of the char LM
FWD_WARPS_4 = (("csrc/flash_fwd.cu", "constexpr int kF32FwdWarps = 8;",
                "constexpr int kF32FwdWarps = 4;"),)
LONG_SHAPE = (64, 1024, 128)  # B*H, T, D of the long-context classifier
TC_CASES = ((512, 256), (512, 104), (512, 204), (449, 37), (480, 61))  # (H, B)
# each main path's flags beyond the data and checkpoint paths, and its batch
PATHS = {
    "a": ([], 1440),
    "b": (["--cell", "gru"], 1440),
    "d": (["--model", "attention", "--hidden-units", "128", "--num-heads", "4",
           "--stacked-layer", "2", "--batch-size", "256", "--dropout", "0"], 256),
    "f": (["--model", "char", "--hidden-units", "512", "--stacked-layer", "2",
           "--seq-length", "128", "--batch-size", "256", "--dropout", "0"], 256),
    "c": (["--model", "char", "--cell", "gru", "--hidden-units", "512", "--stacked-layer", "2",
           "--seq-length", "128", "--batch-size", "256", "--dropout", "0"], 256),
    "e": (None, 16),  # the long-context classifier, no CLI path
}
# the data-parallel paths: path a's flags under ``distributed``, with the
# sharding flag and the ranks (all on one card)
DP_PATHS = {"g": ("--sharded-update", 1), "g0": ("--no-sharded-update", 1),
            "h": ("--sharded-update", 2), "h0": ("--no-sharded-update", 2)}
LONG_DIM, LONG_HEADS, LONG_STEPS = 512, 4, 10
PORT_KERNELS = ("lstm_", "gru_", "flash_")  # name prefixes of the port's kernels


def patched_copy(dest: Path, substitutions) -> Path:
    """A copy of the package under ``dest`` with each ``(file, old, new)``
    substitution made; ``dest`` goes on ``sys.path``.  Raises if an old
    text is not in its file."""
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(PACKAGE, dest / PACKAGE.name, ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in substitutions:
        path = dest / PACKAGE.name / rel
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"{rel}: {old!r} not found")
        path.write_text(text.replace(old, new))
    return dest


def _own(module: str):
    """``module`` of the package, checked to come from the tree on
    ``sys.path[0]`` (in a child process)."""
    mod = importlib.import_module(f"{PACKAGE.name}.{module}")
    if not Path(mod.__file__).resolve().is_relative_to(Path(sys.path[0]).resolve()):
        raise RuntimeError(f"imported {mod.__file__}, not the tree on {sys.path[0]}")
    return mod


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _time_rows() -> dict:
    """The tree's ``gru_fwd`` at the char-LM shape and at one cluster's rows."""
    import torch

    fr = _own("ops.fused_rnn")
    seq_len, batch, hidden = GRU_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"rows": fr.gru_tile(hidden)[0]}
    for rows, key in ((batch, "ms"), (out["rows"], "serial_ms")):
        x = torch.randn(seq_len, rows, 3 * hidden, generator=gen, device="cuda")
        h0 = 0.5 * torch.randn(rows, hidden, generator=gen, device="cuda")
        w = torch.randn(hidden, 3 * hidden, generator=gen, device="cuda") / hidden ** 0.5
        b = 0.1 * torch.randn(3 * hidden, generator=gen, device="cuda")
        out[key] = _time_ms(lambda: fr.gru_fwd(x, h0, w, b), 20)  # noqa: B023
        out[f"{key}_max_abs_err"] = (fr.gru_fwd(x, h0, w, b)[0]
                                     - fr.gru_fwd_plain(x, h0, w, b)[0]).abs().max().item()
    out.update(fr.cluster_shape("gru_fwd", hidden, batch))
    return out


def _time_split() -> dict:
    """The tree's ``flash_dqkv`` and the split route at the CLI's batches."""
    import torch

    fa = _own("ops.fused_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for bh in ATTN_BATCHES:
        gen = torch.Generator(device="cuda").manual_seed(bh)
        q, k, v, do = (torch.randn(bh, ATTN_SEQ_LEN, ATTN_HEAD_DIM, generator=gen, device="cuda")
                       for _ in range(4))
        o, lse = fa.flash_fwd_plain(q, k, v)
        args = (q, k, v, o, do, lse)
        got, again = fa.flash_dqkv(*args), fa.flash_dqkv(*args)
        want = fa.flash_dqkv_plain(*args)

        def split():
            delta = (do * o).sum(dim=-1)  # noqa: B023
            fa.flash_dq(q, k, v, do, lse, delta)  # noqa: B023
            fa.flash_dkv(q, k, v, do, lse, delta)  # noqa: B023

        out[f"BH={bh}"] = {
            "ms": _time_ms(lambda: fa.flash_dqkv(*args), 30),  # noqa: B023
            "split_ms": _time_ms(split, 30),
            "scaled_err": max(((a - b).abs() / (1 + b.abs())).max().item()
                              for a, b in zip(got, want)),
            "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(got, again)),
        }
    return out


def _time_tc() -> dict:
    """The tree's tensor-core LSTM forward: time, error and resources."""
    import torch

    fr = _own("ops.fused_rnn")
    build = _own("_build")
    torch.backends.cuda.matmul.allow_tf32 = False

    def inputs(hidden, batch, seed):
        gen = torch.Generator(device="cuda").manual_seed(batch + hidden + seed)
        x = torch.randn(TC_SHAPE[0], batch, 4 * hidden, generator=gen, device="cuda")
        h0, c0 = (0.5 * torch.randn(batch, hidden, generator=gen, device="cuda") for _ in "hc")
        w = 0.2 * (32 / hidden) ** 0.5 * torch.randn(hidden, 4 * hidden, generator=gen,
                                                     device="cuda")
        return x, h0, c0, w

    worst = 0.0
    for hidden, batch in TC_CASES:
        for seed in (0, 1):
            args = inputs(hidden, batch, seed)
            for got, want in zip(fr.lstm_fwd(*args), fr.lstm_fwd_plain(*args)):
                worst = max(worst, ((got - want).abs() / (1 + want.abs())).max().item())
    _, batch, hidden = TC_SHAPE
    args = inputs(hidden, batch, 0)
    rows = fr.lstm_fwd_tile(hidden, torch.float32, batch)[0]
    one = inputs(hidden, rows, 0)
    h_all = torch.empty(TC_SHAPE[0], rows, hidden, device="cuda")
    c_all, gates = torch.empty_like(h_all), torch.empty_like(one[0])
    fn = fr._library("lstm_fwd")

    def one_cluster():  # B = R rows on one cluster (the wrapper would split them)
        err = fn(*(t.data_ptr() for t in (*one, h_all, c_all, gates)), TC_SHAPE[0], rows, hidden,
                 rows, fr._VARIANTS["cluster"], 0, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"lstm_fwd at {rows} rows: CUDA error {err}")

    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    usage = subprocess.run([str(cuobjdump), "-res-usage", str(build.library_path("lstm_fwd"))],
                           capture_output=True, text=True, timeout=300, check=True).stdout
    resources, name = {}, None
    for line in usage.splitlines():
        if m := re.search(r"Function (\S*lstm_fwd_tc_kernelILi(\d+)\S*):", line):
            name = f"R={m.group(2)}"
        elif name and (m := re.search(r"REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", line)):
            resources[name] = {"registers": int(m.group(1)), "stack": int(m.group(2)),
                               "local": int(m.group(3))}
            name = None
    return {"ms": _time_ms(lambda: fr.lstm_fwd(*args), 20), "rows": rows,
            "one_cluster_ms": _time_ms(one_cluster, 20), "worst_scaled_err": worst,
            "resources": resources}


def device_events(prof) -> list:
    """The device entries of a ``torch.profiler`` run's ``key_averages()``:
    the kernels, copies and sets, without the device spans of user
    annotations (``record_function`` ranges such as
    ``Optimizer.step#Adam.step`` or ``DistributedDataParallel.forward``),
    which cover kernels counted already, as the profiler's own table
    leaves them out of its device total."""
    import torch

    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


# On an H100 a profile window loses device records as its process ages: of
# 5 launches a plain window kept 5, 4, 2 and 1 records at 0, 34, 54 and 74 s
# and none after, and a late window of the smoke lost one kernel in 3 of 3
# tries (``ab drift``, ``chip_smoke.py``).  A window opened this long before
# the body's first launch and closed this long after its last sync kept all
# 5 in 7 windows of 9 at 0.1 s.  Later whole smoke runs, longer, lost one
# LSTM forward record of a late window in 3 of 3 tries again at 0.1 s
# (phase p.1's epoch, then p.4's; a forward, whose first is the body's
# earliest port kernel, never a backward), and none with 0.5 s on both
# sides or with 0.3 s before and 0.1 s after: the margin before the body is
# three times the one that failed.
PROFILE_MARGIN_S = 0.3
PROFILE_TAIL_S = 0.1


@contextlib.contextmanager
def device_profile(activities=None):
    """``torch.profiler.profile`` over the host and the card (or
    ``activities``), with ``PROFILE_MARGIN_S`` of host-only time before the
    body and ``PROFILE_TAIL_S`` after it, so no device record of the body
    falls outside the window."""
    from torch.profiler import ProfilerActivity, profile

    if activities is None:
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        time.sleep(PROFILE_MARGIN_S)
        yield prof
        time.sleep(PROFILE_TAIL_S)


def _copy_kernels(prof, calls: int) -> tuple:
    """The device copy kernels of a ``torch.profiler`` run: launches and ms
    per call."""
    copies = [e for e in device_events(prof) if "copy" in e.key.lower()]
    return (sum(e.count for e in copies) / calls,
            sum(e.self_device_time_total for e in copies) / 1e3 / calls)


def _time_fwd() -> dict:
    """The tree's flash forward: f32 at the CLI shape, as the model calls
    it (with its copy kernels), and bf16 at the long-context shape."""
    import torch

    fa = _own("ops.fused_attention")
    tattn = _own("models.attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    bh, heads = ATTN_BATCHES[0], 4
    q, k, v = (torch.randn(bh, ATTN_SEQ_LEN, ATTN_HEAD_DIM, generator=gen, device="cuda")
               for _ in range(3))
    o, _ = fa.flash_fwd(q, k, v)
    want, _ = fa.flash_fwd_plain(q, k, v)
    out = {"ms": _time_ms(lambda: fa.flash_fwd(q, k, v), 50),
           "scaled_err": ((o - want).abs() / (1 + want.abs())).max().item()}
    proj = [torch.randn(bh // heads, ATTN_SEQ_LEN, heads * ATTN_HEAD_DIM, generator=gen,
                        device="cuda") for _ in range(3)]

    def call():
        views = [tattn._split_heads(x, heads) for x in proj]
        return tattn._merge_heads(fa.flash_attention(*views))

    with torch.no_grad():
        out["call_ms"] = _time_ms(call, 50)
        with device_profile() as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
    out["copy_launches"], out["copy_ms"] = _copy_kernels(prof, 10)
    bh, t, d = LONG_SHAPE
    ql, kl, vl = (torch.randn(bh, t, d, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(3))
    out["bf16_long_ms"] = _time_ms(lambda: fa.flash_fwd(ql, kl, vl), 20)
    return out


def _adam_ms(trainer) -> float:
    """The device time of one Adam step of ``trainer`` alone (the grads of
    its last step; the parameters move, so measure after training)."""
    import torch

    optimizer = trainer.optimizer
    if hasattr(optimizer, "shard"):  # the sharded update: Adam on the rank's slice
        adam = _own("ops.adam")
        group = optimizer.optimizer.param_groups[0]
        p = optimizer.shard_slice(optimizer.ravel(optimizer.params), optimizer.rank).clone()
        g, m, v = torch.randn_like(p), optimizer.exp_avg.clone(), optimizer.exp_avg_sq.clone()

        def step():
            adam.adam_update_([p], [g], [m], [v], optimizer.steps + 1, group["lr"],
                              *group["betas"], group["eps"])
    else:
        step = getattr(optimizer, "optimizer", optimizer).step  # Horovod's wrapper: its Adam
    return _device_ms(step, 20)


def _device_ms(fn, calls: int) -> float:
    """``fn``'s device time a call under ``torch.profiler``."""
    import torch

    fn()
    torch.cuda.synchronize()
    with device_profile() as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in device_events(prof)) / 1e3 / calls


def _time_step(path: str = "d") -> dict:
    """A main path with the tree's package: 2 epochs, then 4 on the host
    clock and one profiled.  A data-parallel path (``DP_PATHS``) runs on
    each rank of its ``torchrun`` world, and times its per-batch loop."""
    import torch

    formatter = _own("training.formatter").TrainingMessageFormatter(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    command, group = "local", None
    flags = PATHS["a" if path in DP_PATHS else path][0]
    if path in DP_PATHS:
        flags, command = [*flags, DP_PATHS[path][0]], "distributed"
        # the group outlives main(), which then leaves it to this process
        group = _own("parallel.collectives").init_process_group("cuda")
    with tempfile.TemporaryDirectory(prefix="ab_step_") as tmp:
        trainer = _trained(path, Path(tmp), flags, command)
        steps = len(trainer._epoch_index_batches())

        def epoch():
            trainer._train_epoch(formatter, True if path in DP_PATHS else None)

        host_ms = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epoch()
            host_ms.append((time.perf_counter() - t0) * 1e3 / steps)
        with device_profile() as prof:
            epoch()
    device_us = {e.key: e.self_device_time_total for e in device_events(prof)}
    kernels = {}
    for key, us in device_us.items():  # by kernel name and template arguments
        if m := re.search(r"(?:%s)\w*(<[^>]*>)?" % "|".join(PORT_KERNELS), key):
            kernels[m.group(0)] = kernels.get(m.group(0), 0.0) + us / 1e3 / steps
    copy_launches, copy_ms = _copy_kernels(prof, steps)
    out = {"path": path, "host_ms": host_ms,
           "device_ms": sum(device_us.values()) / 1e3 / steps, "kernel_device_ms": kernels,
           "copy_launches": copy_launches, "copy_ms": copy_ms}
    if path in ("a", *DP_PATHS):
        comm = [e for e in prof.key_averages() if e.key.lower().startswith(("nccl:", "gloo:"))]
        out.update(
            rank=group.rank if group is not None else 0,
            collective_device_ms=sum(us for key, us in device_us.items()
                                     if "nccl" in key.lower()) / 1e3 / steps,
            collective_host_ms=sum(e.cpu_time_total for e in comm) / 1e3 / steps,
            collective_calls=sorted({e.key for e in comm}),
            top_device_ms={key[:80]: us / 1e3 / steps for key, us in
                           sorted(device_us.items(), key=lambda kv: -kv[1])[:8]},
            adam_ms=_adam_ms(trainer))
    if group is not None:
        _own("parallel.collectives").destroy(group)
    return out


def _long_context_trainer():
    """Path e through the local trainer: the long-context classifier on
    ``LONG_STEPS`` batches of 16 seeded random windows an epoch."""
    import numpy as np
    import torch

    _, batch = PATHS["e"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch * LONG_STEPS, 1024, 9), dtype=np.float32)
    y = rng.integers(0, 6, batch * LONG_STEPS)
    model = _own("models").AttentionClassifier(
        input_dim=9, dim=LONG_DIM, depth=2, num_heads=LONG_HEADS, output_dim=6, max_len=1024,
        precision="bf16", generator=torch.Generator().manual_seed(0))
    return _own("training").Trainer(model, _own("data").MotionDataset(x, y), batch, 1e-3,
                                    seed=0, device="cuda")


def _trained(path: str, work: Path, flags: list, command: str):
    """A main path's trainer after 2 epochs (the epochs its timed ones run:
    the graph path's captures happen here): through the CLI (``command``
    with ``flags``) on seeded synthetic data in ``work``, or path e's."""
    if path == "e":
        trainer = _long_context_trainer()
        formatter = _own("training.formatter").TrainingMessageFormatter(2)
        for epoch in range(2):
            trainer.sampler.set_epoch(epoch)
            trainer._train_epoch(formatter)
        return trainer
    _own("data.synthetic").write_synthetic_har_cache(work / "data", num_train=7352,
                                                     num_test=2947, seed=0)
    os.chdir(work)  # main writes history.json into the working directory
    # the char paths make their synthetic corpus where the path holds none
    data = work / ("no-corpus" if path in ("c", "f") else "data")
    return _own("main").main([*flags, "--dataset-path", str(data), "--checkpoint-directory",
                              str(work / "models"), "--epochs", "2", "--seed", "0", command])


def _time_graph(path: str = "d", rounds: str = "1") -> dict:
    """A main path's local trainer with the tree's package: 2 epochs, then
    ``rounds`` rounds of eager, graph, graph, eager epochs on the host
    clock and one epoch of each profiled."""
    import torch

    formatter = _own("training.formatter").TrainingMessageFormatter(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="ab_graph_") as tmp:
        trainer = _trained(path, Path(tmp), PATHS[path][0], "local")
        steps = len(trainer._epoch_index_batches())
        epochs = {mode: (lambda eager=(mode == "eager"): trainer._train_epoch(formatter, eager))
                  for mode in ("eager", "graph")}
        host_ms = {"eager": [], "graph": []}
        for _ in range(int(rounds)):
            for mode in ("eager", "graph", "graph", "eager"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                epochs[mode]()
                torch.cuda.synchronize()
                host_ms[mode].append((time.perf_counter() - t0) * 1e3 / steps)
        device_ms = {mode: _device_ms(epochs[mode], 1) / steps for mode in epochs}
    idle = {mode: 1.0 - device_ms[mode] / sorted(host_ms[mode])[len(host_ms[mode]) // 2]
            for mode in epochs}
    return {"path": path, "steps": steps, "host_ms": host_ms, "device_ms": device_ms,
            "idle": idle, "capture_ms": {f"{kind} {rows}": g.capture_s * 1e3
                                         for (kind, rows), g in trainer.graphs.items()}}


DRIFT_LAUNCHES = 5  # synced launches in each drift window
DRIFT_WINDOWS = 9
DRIFT_PAUSE_S = 20.0


def _drift_window(margin: bool) -> int:
    """The device records a profile keeps of ``DRIFT_LAUNCHES`` synced
    launches of one small kernel, with :func:`device_profile`'s margins or
    without."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    window = (device_profile() if margin
              else profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
    with window as prof:
        for _ in range(DRIFT_LAUNCHES):
            x.add_(1)
            torch.cuda.synchronize()
    return sum(e.count for e in device_events(prof))


def _time_drift() -> dict:
    """``DRIFT_WINDOWS`` pairs of drift windows, ``DRIFT_PAUSE_S`` apart:
    the process's age and the records each kept."""
    t0 = time.perf_counter()
    windows = []
    for i in range(DRIFT_WINDOWS):
        if i:
            time.sleep(DRIFT_PAUSE_S)
        windows.append({"age_s": time.perf_counter() - t0, "kept": _drift_window(False),
                        "kept_with_margins": _drift_window(True)})
    return {"launches": DRIFT_LAUNCHES, "windows": windows}


def _run(root: Path, what: str, *args: str, ranks: int = 0):
    """``what(*args)`` of this file in a child process whose ``sys.path[0]``
    is ``root``; with ``ranks``, in each process of a ``torchrun`` world of
    that many ranks on this machine, and then a list, rank by rank."""
    code = ("import json, runpy, sys; sys.path.insert(0, sys.argv[1]); "
            "print(json.dumps(runpy.run_path(sys.argv[2])[sys.argv[3]](*sys.argv[4:])))")
    launcher = []
    if ranks:
        launcher = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
                    str(ranks), "--no-python", sys.executable]
    proc = subprocess.run([sys.executable, *launcher, "-c", code, str(root), str(Path(__file__)),
                           what, *args], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:  # a rank's traceback comes before the launcher's
        first = proc.stderr.find("Traceback")
        raise RuntimeError(f"{root}: {proc.stderr[max(first, 0):][:4000]}")
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    if not ranks:
        return lines[-1]
    return sorted(lines, key=lambda r: r["rank"])


def _parse(argv: list) -> tuple:
    """``(mode, other tree or None, rounds, path)``; raises SystemExit on
    misuse."""
    usage = ("usage: ab rows | ab split | ab tc | ab fwd --other DIR [--rounds N] | "
             "ab step --other DIR [--rounds N] [--path a|b|c|d|e|f|g|g0|h|h0] | "
             "ab step --graph [--rounds N] [--path a|b|c|d|e|f] | ab dp [--rounds N] | "
             "ab drift")
    if argv in (["rows"], ["split"], ["tc"], ["drift"]):
        return argv[0], None, 1, None
    mode, rest = (argv[0], argv[1:]) if argv else (None, [])
    if mode == "step" and "--graph" in rest:
        mode, rest = "graph", [arg for arg in rest if arg != "--graph"]
    options = dict(zip(rest[::2], rest[1::2]))
    if len(rest) % 2 or len(options) != len(rest) // 2:
        raise SystemExit(usage)
    rounds = options.pop("--rounds", "1")
    if not rounds.isdigit() or int(rounds) < 1:
        raise SystemExit(usage)
    if mode == "dp" and not options:
        return mode, None, int(rounds), None
    path = options.pop("--path", "d") if mode in ("step", "graph") else None
    if mode == "graph" and not options and path in PATHS:
        return mode, None, int(rounds), path
    if (mode in ("step", "fwd") and "--other" in options and len(options) == 1
            and (path is None or path in PATHS or mode == "step" and path in DP_PATHS)):
        return mode, Path(options["--other"]).resolve(), int(rounds), path
    raise SystemExit(usage)


def main(argv=None) -> int:
    mode, other, rounds, path = _parse(sys.argv[1:] if argv is None else argv)
    if mode == "rows":
        runs = [("8", PACKAGE.parent, "_time_rows"),
                ("4", patched_copy(WORK / "rows4", ROWS_8_TO_4), "_time_rows")]
    elif mode == "split":
        runs = [("mask", PACKAGE.parent, "_time_split"),
                ("cvt", patched_copy(WORK / "cvt", MASK_TO_CVT), "_time_split")]
    elif mode == "tc":
        runs = [("this", PACKAGE.parent, "_time_tc"),
                ("chained", patched_copy(WORK / "chained", TC_CHAINED), "_time_tc"),
                ("hoisted", patched_copy(WORK / "hoisted", TC_HOISTED), "_time_tc")]
    elif mode == "fwd":
        runs = [("other", other, "_time_fwd"), ("this", PACKAGE.parent, "_time_fwd"),
                ("warps4", patched_copy(WORK / "warps4", FWD_WARPS_4), "_time_fwd")]
    elif mode == "dp":
        runs = [(name, PACKAGE.parent, "_time_step") for name in ("a", *DP_PATHS)]
    else:
        runs = [("other", other, "_time_step"), ("this", PACKAGE.parent, "_time_step")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    if mode == "drift":
        print(json.dumps(_run(PACKAGE.parent, "_time_drift")), flush=True)
        return 0
    if mode == "graph":  # both paths in turns inside one process
        print(json.dumps(_run(PACKAGE.parent, "_time_graph", path, str(rounds))), flush=True)
        return 0
    for i in (*range(len(runs)), *reversed(range(len(runs)))) * rounds:
        label, root, what = runs[i]
        if mode == "dp":
            ranks = DP_PATHS[label][1] if label in DP_PATHS else 0
            result = _run(root, what, label, ranks=ranks)
            print(json.dumps({"run": label, "ranks": result if ranks else [result]}), flush=True)
            continue
        if path in DP_PATHS:
            result = {"ranks": _run(root, what, path, ranks=DP_PATHS[path][1])}
        else:
            result = _run(root, what, *([path] if path else []))
        if mode == "rows" and str(result["rows"]) != label:
            raise RuntimeError(f"the copy for {label} rows ran {result['rows']}")
        print(json.dumps({"run": label, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
