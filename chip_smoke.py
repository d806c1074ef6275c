"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. device: needs ``torch.cuda.is_available()``; prints the card's
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. build: compiles every kernel source of ``pytorch_distributed_rnn_tpu_torch/
   csrc/`` with nvcc, one process per source, all at once; prints each
   kernel's registers and spills (``-Xptxas -v``), checks that the GRU
   forward's cluster kernel, the LSTM forward kernel and both LSTM cluster
   kernels have no stack frame and no spills in any instance, and checks
   in the SASS (``cuobjdump``) that the bf16
   ``flash_fwd``/``flash_dq``/``flash_dkv`` kernels, and only they, run on
   the tensor cores (HMMA).
3. kernels: holds each kernel against its plain PyTorch version on the
   card, at the shapes the main paths give them (O(1) random cotangents,
   f32 and bf16, the tolerances of ``TOLERANCES``): the LSTM and GRU
   kernels at H=32 (T=128, x_proj from input widths 9 and 32) and at
   H=512 (input 512, the char LM's train and evaluation batches), the
   LSTM one-block kernels' edges (B=37, H=110), the LSTM cluster kernels'
   edges (H=111, 200, 300, both sides of the f32 slice's fit in shared
   memory: 448/449 forward, 464/465 backward, B=250 and 37 at 512), the
   GRU cluster kernels' edges (H=127, 200, 300, B=250 and 37 at 512); the
   flash kernels at the
   attention CLI's (B*H, T, D) shapes (train batches, and the evaluation
   batches forward only), the long-context shape (64, 1024, 128) in bf16
   and f32 (also causal, where the diagonal tiles mask), D=8, D=72,
   causal with offsets, a ragged T=300, cross lengths 96/160 and a chunk
   that sees no key (o = 0, lse = -inf).
4. main paths, each driven with the launch counts set to 0 just before it
   and read just after, on synthetic data at full size:
   a. ``main ... local`` for 2 epochs: the motion LSTM with the default
      flags (batch 1440, 2 x 32 LSTM, lr 0.0025, dropout 0.1) on 7352
      train and 2947 test HAR windows;
   b. the same with ``--cell gru``;
   c. the char LM ``--model char --cell gru --hidden-units 512
      --stacked-layer 2 --seq-length 128 --batch-size 256 --dropout 0`` on
      the synthetic motif corpus (1640 train, 204 validation, 204 test
      windows), then greedy ``generate`` of 32 tokens from 8 test prompts;
   f. the same with the CLI's default cell, the LSTM (run after c);
   d. the attention classifier ``--model attention --hidden-units 128
      --num-heads 4 --stacked-layer 2 --batch-size 256 --dropout 0`` on the
      HAR windows of (a);
   e. the long-context classifier (dim 512, 4 heads, depth 2, bf16,
      T=1024) trained 10 Adam steps at batch 16 on seeded random windows,
      through the model and a train-step loop.
   Each checks finite losses (a-d, f: and the perf line), that its kernels
   were launched and no others (c, f: one of each a layer a train step),
   and that the trained model's kernel path agrees with its plain path:
   fused vs scan logits (a-c, f; c and f also greedy tokens, or a near tie
   where they differ), flash vs dense logits (d, e).
   Each kernel's launches per train step come from the run's counts.
5. step profile: more epochs (or steps) of each trained model, timed on
   the host clock, and one under ``torch.profiler`` (device time by
   kernel); and one epoch of path f's model on its scan path (the Python
   loop over T), what its kernels replace.
6. timing: CUDA-event times of each kernel, its plain version and the
   library's call (cuDNN's LSTM or GRU, ``torch.nn.LSTM``/``torch.nn.GRU``;
   ``scaled_dot_product_attention`` forward for ``flash_fwd``, and for
   the backward kernels SDPA's whole backward, timed as the device time of
   its kernels under ``torch.profiler`` so that the host's pace does not
   count; timed here only, never called by the port) at each main shape
   (the RNN kernels at (1440, 32) and (256, 512)), beside each kernel's
   bound; each kernel at one block (or one cluster), its serial floor; the
   LSTM forward at 4, 8, 12 and 16 rows a block; the LSTM cluster kernels
   on both sides of their f32 slices' fit and in bf16; and the cluster
   kernels' shapes at H=512 (CTAs and rows a cluster, clusters resident at once,
   waves, the LSTM slices' rows in shared memory).

Prints a ``{"kernels": [...]}`` line and ends with
``{"ok": true, "device": {...}}`` as its last line.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SEQ_LEN = 128
HIDDEN = 32
MAIN_BATCH = 1440
# the batch sizes of the motion paths: full and final train batches, the
# validation and the test evaluation (forward only)
FWD_BATCHES = (1440, 768, 735, 2947)
BWD_BATCHES = (1440, 768)
# the char path: 512 wide, batch 256; 1640 train windows end in a batch of
# 104; validation and test hold 204 windows each
CHAR_HIDDEN = 512
CHAR_BATCH = 256
CHAR_FWD_BATCHES = (256, 104, 204)
CHAR_BWD_BATCHES = (256, 104)
GENERATE_PROMPTS, GENERATE_PROMPT_LEN, GENERATE_TOKENS = 8, 64, 32
# (H, B) of the GRU cluster kernels' edges: the narrowest width over a
# cluster, widths that split unevenly over the 16 CTAs, and ragged last
# tiles of the forward's 8 rows and the backward's 4
GRU_CLUSTER_EDGES = ((127, 37), (200, 64), (300, 37), (CHAR_HIDDEN, 250), (CHAR_HIDDEN, 37))
# (H, B) of the LSTM kernels' edges beside the motion shapes: a ragged
# last 4-row tile, and the widest width of the one-block kernels (W_hh^T in
# shared memory, a ragged warp), also with a ragged tile
LSTM_EDGES = ((HIDDEN, 37), (110, 64), (110, 37))
# (H, B) of the LSTM cluster kernels' edges: the narrowest width over a
# cluster, widths that split unevenly over the 16 CTAs, both sides of the
# width where the f32 slice stops fitting in shared memory (forward 448 /
# 449, where its rows a cluster go from 8 to 4; backward 464 / 465), and
# ragged last tiles at 512
LSTM_CLUSTER_EDGES = ((111, 37), (200, 64), (300, 37), (448, 37), (449, 37), (464, 37),
                      (465, 37), (CHAR_HIDDEN, 250), (CHAR_HIDDEN, 37))
# the LSTM forward's rows a block, timed at the motion shape to choose
# LSTM_FWD_BLOCK_B
LSTM_FWD_TILES = (4, 8, 12, 16)
# the kernels whose ptxas report must show no stack frame and no spills,
# every instance (dtype, variant)
NO_STACK_KERNELS = ("gru_fwd_cluster_kernel", "lstm_fwd_kernel", "lstm_fwd_cluster_kernel",
                    "lstm_bwd_cluster_kernel")
# the scan path's train steps profiled once beside path f (the char LSTM)
SCAN_PROFILE_EPOCHS = 1
LOGIT_TOL = 1e-4  # trained fused logits against the scan path, f32
TOLERANCES = {  # (forward, backward)
    # the JAX kernel tests' (test_pallas_rnn.py), elementwise:
    # |got - want| <= tol + tol * |want|
    torch.float32: (1e-5, 1e-4),
    # of each output's largest value: |got - want| <= tol * max|want|.  Both
    # sides carry float32 and round what they store to bf16, so they differ
    # by at most one bf16 ulp of the largest value (2^-7 of it)
    torch.bfloat16: (1e-2, 1e-2),
}
# the attention CLI path: dim 128, 4 heads (D=32), depth 2, batch 256 on
# the HAR windows (6528 train -> 25 batches of 256 and one of 128; 735
# validation and 2947 test windows, evaluated forward only)
ATTN_DIM, ATTN_HEADS, ATTN_DEPTH, ATTN_BATCH = 128, 4, 2, 256
ATTN_FWD_BATCHES = (256, 128, 735, 2947)
ATTN_BWD_BATCHES = (256, 128)
# the long-context path: bench.py's attention_seq1024_dim512_flash_bf16
LONG_DIM, LONG_HEADS, LONG_T, LONG_BATCH, LONG_STEPS = 512, 4, 1024, 16, 10
LOGIT_TOL_BF16 = 5e-2  # flash vs dense logits in bf16: the JAX model tests' bf16 tolerance
PROFILE_EPOCHS = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM, bf16 on the tensor cores, dense
# the bf16 flash kernels, one instance per padded head dim (16, 32, 64, 128):
# flash_fwd_tc_kernel, flash_dq_tc_kernel, flash_dkv_tc_kernel
N_TENSOR_CORE_KERNELS = 12
REPLACES = {
    "lstm_fwd": "pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:100",
    "lstm_bwd": "pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:166",
    "gru_fwd": "pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:375",
    "gru_bwd": "pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:422",
    "flash_fwd": "pytorch_distributed_rnn_tpu/ops/pallas_attention.py:108",
    "flash_dq": "pytorch_distributed_rnn_tpu/ops/pallas_attention.py:230",
    "flash_dkv": "pytorch_distributed_rnn_tpu/ops/pallas_attention.py:266",
}
SOURCES = {name: f"pytorch_distributed_rnn_tpu_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["flash_dq"] = SOURCES["flash_dkv"] = "pytorch_distributed_rnn_tpu_torch/csrc/flash_bwd.cu"


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false - needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    # the f32 path runs in full float32: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _demangle(names: list) -> list:
    """C++ symbol names as ``kernel<template args>``, through ``c++filt``
    where the machine has it."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return names
    return [line.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
            for line in out]


def _ptxas_report(log: str) -> list:
    """``(kernel, registers, stack frame bytes, spill store bytes, spill load
    bytes)`` of each kernel in nvcc's ``-Xptxas -v`` output."""
    rows, name, spills = [], None, (0, 0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name, spills = m.group(1), (0, 0, 0)
        elif m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)), int(m.group(3)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name is not None:
            rows.append((name, int(m.group(1)), *spills))
            name = None
    return [(label, *rest) for label, (_, *rest) in zip(_demangle([r[0] for r in rows]), rows)]


def _hmma_counts(lib: Path) -> dict:
    """HMMA (tensor-core) instructions in each kernel of a built library,
    from ``cuobjdump -sass``."""
    from pytorch_distributed_rnn_tpu_torch import _build

    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            name = m.group(1)
            counts[name] = 0
        elif name is not None and re.search(r"\bHMMA\b", line):
            counts[name] += 1
    return dict(zip(_demangle(list(counts)), counts.values()))


def phase_build():
    """Build every kernel source; print each kernel's registers and spills,
    and check in the SASS that the bf16 flash kernels run on the tensor
    cores (HMMA) and the others (the f32 flash and all RNN kernels) do not."""
    from pytorch_distributed_rnn_tpu_torch import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    checked = []
    for source, log in sorted(_build.BUILD_LOGS.items()):
        for kernel, regs, stack, spill_st, spill_ld in _ptxas_report(log):
            print(f"  ptxas {source}: {kernel}: {regs} registers, stack frame {stack} B, "
                  f"spill stores {spill_st} B, spill loads {spill_ld} B")
            names = [name for name in NO_STACK_KERNELS if name in kernel]
            if names:
                checked += names
                if stack or spill_st or spill_ld:
                    raise RuntimeError(f"{kernel}: a stack frame or spills in the ptxas report")
    if any(checked.count(name) < 2 for name in NO_STACK_KERNELS):  # f32 and bf16 at least
        raise RuntimeError(f"ptxas reported {checked}, not every instance of {NO_STACK_KERNELS}")
    hmma = {}
    for source in sorted(libs):
        counts = _hmma_counts(libs[source])
        print(f"  HMMA instructions in {source}: {counts}")
        hmma.update(counts)
    tc = {name: n for name, n in hmma.items() if "_tc_kernel" in name}
    if len(tc) != N_TENSOR_CORE_KERNELS or not all(tc.values()):
        raise RuntimeError(f"the bf16 flash kernels are not all on the tensor cores: {tc}")
    if others := {name: n for name, n in hmma.items() if name not in tc and n}:
        raise RuntimeError(f"kernels other than the bf16 flash kernels hold HMMA: {others}")


def _max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _scaled_err(got, want) -> float:
    """The error that ``TOLERANCES`` bounds: elementwise against
    ``1 + |want|`` in float32, against ``max|want|`` in bf16."""
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        return (diff / (1.0 + want.float().abs())).max().item()
    return diff.max().item() / max(want.float().abs().max().item(), 1e-30)


def _shape(batch: int, hidden: int) -> str:
    return f"T={SEQ_LEN} B={batch} H={hidden} float32"


def _layer_inputs(batch, in_width, dtype, seed, cell="lstm", hidden=HIDDEN):
    """A random layer's (T, B, G*H) ``x_proj`` from a random input, and a
    random initial state: LSTM ``(x_proj, h0, c0, w_hh_t, gen)``, GRU
    ``(x_proj, h0, w_hh_t, b_hh, gen)``."""
    from pytorch_distributed_rnn_tpu_torch.ops.rnn import (
        gru_input_proj,
        init_rnn_layer,
        lstm_input_proj,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_rnn_layer(gen, in_width, hidden, cell)
    params = {k: v.to(dtype) for k, v in params.items()}
    x = torch.randn((batch, SEQ_LEN, in_width), generator=gen, device="cuda").to(dtype)
    proj = lstm_input_proj if cell == "lstm" else gru_input_proj
    x_proj = proj(params, x).transpose(0, 1).contiguous()
    h0 = (0.5 * torch.randn((batch, hidden), generator=gen, device="cuda")).to(dtype)
    w_hh_t = params["w_hh"].T.contiguous()
    if cell == "gru":
        return x_proj, h0, w_hh_t, params["b_hh"], gen
    c0 = (0.5 * torch.randn((batch, hidden), generator=gen, device="cuda")).to(dtype)
    return x_proj, h0, c0, w_hh_t, gen


def _report(name, dtype, label, got, want, tol, failures) -> float:
    err = max(_max_err(a, b) for a, b in zip(got, want))
    scaled = max(_scaled_err(a, b) for a, b in zip(got, want))
    ok = scaled <= tol
    print(f"{name} {str(dtype)[6:]} {label}: max_abs_err={err:.3e} "
          f"scaled_err={scaled:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name} {dtype} {label}")
    return err


def _rnn_cases(cell: str) -> list:
    """(H, input widths, forward batches, backward batches, main batch) of
    a cell's kernels: the motion shapes, the char LM's (the main batch
    recorded for phase 6) and the edges."""
    edges = (*LSTM_EDGES, *LSTM_CLUSTER_EDGES) if cell == "lstm" else GRU_CLUSTER_EDGES
    return [
        (HIDDEN, (9, 32), FWD_BATCHES, BWD_BATCHES, MAIN_BATCH),
        (CHAR_HIDDEN, (CHAR_HIDDEN,), CHAR_FWD_BATCHES, CHAR_BWD_BATCHES, CHAR_BATCH),
        *((h, (h,), (b,), (b,), None) for h, b in edges),
    ]


def _check_layer(cell, hidden, in_width, batch, dtype, backward, failures) -> tuple:
    """A random layer's forward (and backward) kernel against its plain
    version; returns their max abs errors (the backward's None where it
    is not run)."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    tol_f, tol_b = TOLERANCES[dtype]
    label = f"B={batch} H={hidden} in={in_width}"
    *fwd_args, gen = _layer_inputs(batch, in_width, dtype, seed=batch + in_width, cell=cell,
                                   hidden=hidden)
    want = getattr(fr, f"{cell}_fwd_plain")(*fwd_args)
    got = getattr(fr, f"{cell}_fwd")(*fwd_args)
    want, got = (want, got) if cell == "lstm" else ((want,), (got,))
    saves_gates = cell == "lstm" and fr.lstm_saves_gates(hidden)
    if cell == "lstm" and (got[2] is not None) != saves_gates:
        failures.append(f"lstm_fwd {dtype} {label}: saved gates {got[2] is not None}")
    n_out = 3 if saves_gates else 1 if cell == "gru" else 2  # the activated gates where saved
    err = _report(f"{cell}_fwd", dtype, label, got[:n_out], want[:n_out], tol_f, failures)
    if not backward:
        return err, None
    dh_all = torch.randn(want[0].shape, generator=gen, device="cuda").to(dtype)
    dh_t = torch.randn(fwd_args[1].shape, generator=gen, device="cuda").to(dtype)
    if cell == "lstm":
        x_proj, h0, c0, w = fwd_args
        dc_t = torch.randn(h0.shape, generator=gen, device="cuda").to(dtype)
        args = (x_proj, *want[:2], h0, c0, w, dh_all, dh_t, dc_t,
                want[2] if saves_gates else None)
    else:
        x_proj, h0, w, b = fwd_args
        args = (x_proj, want[0], h0, w, b, dh_all, dh_t)
    errb = _report(f"{cell}_bwd", dtype, label, getattr(fr, f"{cell}_bwd")(*args),
                   getattr(fr, f"{cell}_bwd_plain")(*args), tol_b, failures)
    return err, errb


def phase_kernels() -> dict:
    """Each RNN kernel against its plain version; returns the max abs
    errors at each main shape (f32, input width = H), keyed ``(name,
    shape)``."""
    main_errs = {}
    failures = []
    for dtype in TOLERANCES:
        for cell in ("lstm", "gru"):
            for hidden, widths, fwd_batches, bwd_batches, main_batch in _rnn_cases(cell):
                for in_width in widths:
                    for batch in fwd_batches:
                        err, errb = _check_layer(cell, hidden, in_width, batch, dtype,
                                                 batch in bwd_batches, failures)
                        if dtype == torch.float32 and batch == main_batch and in_width == hidden:
                            main_errs[(f"{cell}_fwd", _shape(batch, hidden))] = err
                            main_errs[(f"{cell}_bwd", _shape(batch, hidden))] = errb
    torch.cuda.synchronize()
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return main_errs


def _flash_shape(bh: int, t: int, d: int, dtype) -> str:
    return f"BH={bh} T={t} D={d} {str(dtype)[6:]}"


def _flash_cases(dtype) -> list:
    """(label, BH, Tq, Tk, D, causal, q_offset, k_offset, backward too)."""
    d_cli, d_long = ATTN_DIM // ATTN_HEADS, LONG_DIM // LONG_HEADS
    cases = [] if dtype != torch.float32 else [
        (f"CLI B={b}", b * ATTN_HEADS, SEQ_LEN, SEQ_LEN, d_cli, False, 0, 0,
         b in ATTN_BWD_BATCHES) for b in ATTN_FWD_BATCHES
    ]
    return cases + [
        ("long context", LONG_BATCH * LONG_HEADS, LONG_T, LONG_T, d_long, False, 0, 0, True),
        ("D=8", 1024, SEQ_LEN, SEQ_LEN, 8, False, 0, 0, True),
        ("causal offsets 128/64", 16, SEQ_LEN, SEQ_LEN, d_cli, True, 128, 64, True),
        ("ragged causal", 16, 300, 300, 64, True, 0, 0, True),
        ("cross lengths", 16, 96, 160, d_cli, False, 0, 0, True),
        ("no visible key", 8, 32, 32, d_cli, True, 0, 512, True),
        # the diagonal tiles, where the masks come from each lane's position
        ("long context causal", LONG_BATCH * LONG_HEADS, LONG_T, LONG_T, d_long, True, 0, 0,
         True),
        # a head dim of whole 16-byte chunks but not of whole 16-column k-steps
        ("D=72", 16, SEQ_LEN, SEQ_LEN, 72, False, 0, 0, True),
    ]


def _flash_inputs(bh, t_q, t_k, d, dtype, seed):
    """O(1) random q, k, v and dO (B*H, T, D) on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(t):
        return torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype)

    return rand(t_q), rand(t_k), rand(t_k), rand(t_q)


def _check_lse(got, want, tol, label, failures):
    """lse is float32 in both dtypes: -inf in the same places, elementwise
    tolerance elsewhere."""
    finite = torch.isfinite(want)
    same = torch.equal(torch.isneginf(got), torch.isneginf(want))
    err = _scaled_err(got[finite], want[finite]) if finite.any() else 0.0
    ok = same and err <= tol and bool(torch.isfinite(got[finite]).all())
    print(f"flash_fwd lse {label}: scaled_err={err:.3e} -inf rows equal={same} tol={tol:g} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"flash_fwd lse {label}")


def phase_flash_kernels() -> dict:
    """The flash kernels against their plain versions; returns the max abs
    errors at the two main shapes (CLI f32, long context bf16)."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_attention as fa

    main_errs = {}
    failures = []
    main_shapes = {
        torch.float32: _flash_shape(ATTN_BATCH * ATTN_HEADS, SEQ_LEN, ATTN_DIM // ATTN_HEADS,
                                    torch.float32),
        torch.bfloat16: _flash_shape(LONG_BATCH * LONG_HEADS, LONG_T, LONG_DIM // LONG_HEADS,
                                     torch.bfloat16),
    }
    for dtype, (tol_f, tol_b) in TOLERANCES.items():
        for label, bh, t_q, t_k, d, causal, q_off, k_off, backward in _flash_cases(dtype):
            kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
            full = f"{label} BH={bh} Tq={t_q} Tk={t_k} D={d}"
            q, k, v, do = _flash_inputs(bh, t_q, t_k, d, dtype, seed=bh + t_q + d)
            o, lse = fa.flash_fwd(q, k, v, **kw)
            o_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
            errs = {"flash_fwd": _report("flash_fwd", dtype, full, (o,), (o_p,), tol_f, failures)}
            _check_lse(lse, lse_p, TOLERANCES[torch.float32][0], full, failures)
            if label == "no visible key" and not (torch.equal(o, torch.zeros_like(o))
                                                  and bool(torch.isneginf(lse).all())):
                failures.append(f"flash_fwd {dtype} {full}: o != 0 or lse != -inf")
            if backward:
                delta = (do.float() * o_p.float()).sum(dim=-1)
                args = (q, k, v, do, lse_p, delta)
                errs["flash_dq"] = _report("flash_dq", dtype, full, (fa.flash_dq(*args, **kw),),
                                           (fa.flash_dq_plain(*args, **kw),), tol_b, failures)
                errs["flash_dkv"] = _report("flash_dkv", dtype, full, fa.flash_dkv(*args, **kw),
                                            fa.flash_dkv_plain(*args, **kw), tol_b, failures)
            shape = _flash_shape(bh, t_q, d, dtype)
            if shape == main_shapes[dtype] and backward and not causal:
                main_errs.update({(name, shape): err for name, err in errs.items()})
    torch.cuda.synchronize()
    if failures:
        raise RuntimeError(f"flash kernels disagree with their plain versions: {failures}")
    return main_errs


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@dataclass
class PathRun:
    """One main path's run: its trainer, the kernels it must launch, the
    launch counts of the run and each kernel's launches per train step."""

    name: str
    trainer: object
    batch: int
    kernels: tuple
    launches: dict
    per_step: dict


def _reset_launch_counts():
    from pytorch_distributed_rnn_tpu_torch.ops import fused_attention as fa
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    fr.reset_launch_counts()
    fa.reset_launch_counts()


def _launch_counts() -> dict:
    """Every kernel's launches since the last reset."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_attention as fa
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    return {**fr.LAUNCHES, **fa.LAUNCHES}


def _drive(workdir: Path, argv: list, after=None) -> tuple:
    """``main ... local`` in-process with the launch counts set to 0 just
    before it; ``after(trainer)`` (part of the path, e.g. generation) runs
    before the counts are read.  Returns the trainer, ``history.json`` and
    the launch counts."""
    from pytorch_distributed_rnn_tpu_torch import main as port_main

    capture = _Capture()
    logging.getLogger().addHandler(capture)
    cwd = os.getcwd()
    os.chdir(workdir)  # main writes history.json into the working directory
    try:
        _reset_launch_counts()
        t0 = time.perf_counter()
        trainer = port_main.main(argv)
        extra = after(trainer) if after is not None else None
        torch.cuda.synchronize()
        launches = _launch_counts()
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        logging.getLogger().removeHandler(capture)
    history = json.loads((workdir / "history.json").read_text())
    losses = history["train_history"] + history["validation_history"]
    print(f"  {wall:.2f} s, train_history={history['train_history']}, "
          f"validation_history={history['validation_history']}, launches={launches}")
    if len(history["train_history"]) != 2 or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"main path losses not finite: {history}")
    perf = [m for m in capture.messages
            if re.fullmatch(r"0: Memory Usage: \S+, Training Duration: \S+", m)]
    if len(perf) != 1:
        raise RuntimeError("main path printed no perf line")
    print(f"  perf line: {perf[0]}")
    return trainer, history, launches, extra


def _check_path(name, trainer, history, launches, kernels, batch, extra_fwd_layers=0):
    """Its kernels launched, no others; launches per train step from the
    counts: every train step runs each layer forward and backward once,
    every evaluation (one per epoch, then the test set) and
    ``extra_fwd_layers`` more layer calls run forward only."""
    fwd, bwd = kernels
    for kernel, count in launches.items():
        if kernel in kernels and count <= 0:
            raise RuntimeError(f"{name}: main path never launched kernel {kernel}")
        if kernel not in kernels and count != 0:
            raise RuntimeError(f"{name}: main path launched {kernel} {count} times")
    steps = -(-len(trainer.training_set) // batch) * len(history["train_history"])
    layers = len(trainer.model.rnn)
    evaluations = len(history["validation_history"]) + 1
    train_fwd = launches[fwd] - evaluations * layers - extra_fwd_layers
    if train_fwd != launches[bwd]:
        raise RuntimeError(f"{name}: train-step forwards {train_fwd} != backwards {launches[bwd]}")
    per_step = {fwd: train_fwd / steps, bwd: launches[bwd] / steps}
    print(f"  train steps: {steps}, evaluations: {evaluations}, launches per train step: {per_step}")
    return PathRun(name, trainer, batch, kernels, launches, per_step)


def _fused_vs_scan(model, x, what: str):
    """The trained model's fused logits against its plain scan path."""
    model.eval()
    with torch.no_grad():
        fused = model(x)
        model.impl = "scan"
        plain = model(x)
        model.impl = "auto"
    err = _max_err(fused, plain)
    print(f"  trained logits fused vs scan ({what}): shape={tuple(fused.shape)} "
          f"max_abs_err={err:.3e} tol={LOGIT_TOL:g}")
    if not torch.isfinite(fused).all() or err > LOGIT_TOL:
        raise RuntimeError(f"{what}: trained model's fused logits disagree with the scan path")
    return fused


def phase_motion(workdir: Path, cell: str) -> PathRun:
    """``main [--cell gru] ... local`` at the reference width."""
    print(f"main path: motion {cell}")
    argv = ["--dataset-path", str(workdir / "data"),
            "--checkpoint-directory", str(workdir / f"models-{cell}"),
            "--epochs", "2", "--seed", "0", "--cell", cell, "local"]
    trainer, history, launches, _ = _drive(workdir, argv)
    if not (workdir / f"models-{cell}" / "best-model.ckpt").exists():
        raise RuntimeError("main path wrote no best-model checkpoint")
    kernels = (f"{cell}_fwd", f"{cell}_bwd")
    run = _check_path(f"motion {cell}", trainer, history, launches, kernels, MAIN_BATCH)
    x = torch.from_numpy(trainer.test_set.features[:64]).cuda()
    fused = _fused_vs_scan(trainer.model, x, f"motion {cell}")
    if fused.shape != (64, 6):
        raise RuntimeError(f"motion {cell}: logits of shape {tuple(fused.shape)}")
    return run


def _top2_gap(logits) -> torch.Tensor:
    top = logits.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def phase_char(workdir: Path, cell: str) -> PathRun:
    """The char LM at its chip width with ``cell`` (the CLI's default
    ``lstm`` is not passed), then greedy generation of the trained model
    through the kernels (counted) and the scan path."""
    name = f"char {cell}"
    print(f"main path: {name}")
    argv = ["--model", "char", *(["--cell", cell] if cell != "lstm" else []),
            "--hidden-units", str(CHAR_HIDDEN),
            "--stacked-layer", "2", "--seq-length", str(SEQ_LEN),
            "--batch-size", str(CHAR_BATCH), "--dropout", "0",
            "--dataset-path", str(workdir / "no-corpus"),
            "--checkpoint-directory", str(workdir / f"models-char-{cell}"),
            "--epochs", "2", "--seed", "0", "local"]

    def generate(trainer):
        prompt = torch.from_numpy(
            trainer.test_set.features[:GENERATE_PROMPTS, :GENERATE_PROMPT_LEN]).cuda()
        return prompt, trainer.model.eval().generate(prompt, GENERATE_TOKENS, temperature=0.0)

    trainer, history, launches, (prompt, fused_out) = _drive(workdir, argv, after=generate)
    model = trainer.model
    if model.cell != cell:
        raise RuntimeError(f"{name}: the CLI built a {model.cell} model")
    kernels = (f"{cell}_fwd", f"{cell}_bwd")
    run = _check_path(name, trainer, history, launches, kernels,
                      CHAR_BATCH, extra_fwd_layers=len(model.rnn))  # the generate prefill
    if run.per_step != {kernel: float(len(model.rnn)) for kernel in kernels}:
        raise RuntimeError(f"{name}: launches per train step {run.per_step}, not one of each "
                           f"kernel a layer")
    windows = torch.from_numpy(trainer.test_set.features[:GENERATE_PROMPTS]).cuda()
    fused = _fused_vs_scan(model, windows[:, :-1], name)
    if fused.shape != (GENERATE_PROMPTS, SEQ_LEN, 256):
        raise RuntimeError(f"{name}: logits of shape {tuple(fused.shape)}")

    model.impl = "scan"
    scan_out = model.generate(prompt, GENERATE_TOKENS, temperature=0.0)
    with torch.no_grad():  # the scan path's logits behind each generated token
        logits = model(scan_out[:, :-1])[:, GENERATE_PROMPT_LEN - 1:]
    model.impl = "auto"
    gaps = _top2_gap(logits)
    shape_ok = fused_out.shape == (GENERATE_PROMPTS, GENERATE_PROMPT_LEN + GENERATE_TOKENS)
    if not shape_ok or not torch.equal(fused_out[:, :GENERATE_PROMPT_LEN], prompt):
        raise RuntimeError(f"{name}: generate did not extend the prompts")
    differ = (fused_out != scan_out)[:, GENERATE_PROMPT_LEN:]
    if differ.any():
        step = int(differ.any(dim=0).nonzero()[0])
        row = int(differ[:, step].nonzero()[0])
        gap = gaps[row, step].item()
        print(f"  generate fused vs scan: first differing step {step} (prompt {row}), "
              f"its top-2 logit gap {gap:.3e} (must be below {LOGIT_TOL:g})")
        if gap >= LOGIT_TOL:
            raise RuntimeError(f"{name}: greedy tokens differ between fused and scan")
    else:
        print(f"  generate fused vs scan: {GENERATE_PROMPTS} x {GENERATE_TOKENS} tokens "
              f"identical; smallest top-2 logit gap {gaps.min().item():.3e}")
    return run


def _check_flash_path(name, trainer, launches, steps, eval_forwards, batch):
    """The flash kernels launched and no others; launches per train step
    from the counts: every train step runs each block's forward, dQ and
    dK/dV kernel once; ``eval_forwards`` block calls ran forward only."""
    kernels = ("flash_fwd", "flash_dq", "flash_dkv")
    for kernel, count in launches.items():
        if kernel in kernels and count <= 0:
            raise RuntimeError(f"{name}: main path never launched kernel {kernel}")
        if kernel not in kernels and count != 0:
            raise RuntimeError(f"{name}: main path launched {kernel} {count} times")
    train_fwd = launches["flash_fwd"] - eval_forwards
    if not train_fwd == launches["flash_dq"] == launches["flash_dkv"]:
        raise RuntimeError(f"{name}: train-step forwards {train_fwd}, dQ {launches['flash_dq']}, "
                           f"dK/dV {launches['flash_dkv']}")
    per_step = {"flash_fwd": train_fwd / steps, "flash_dq": launches["flash_dq"] / steps,
                "flash_dkv": launches["flash_dkv"] / steps}
    print(f"  train steps: {steps}, forward-only block calls: {eval_forwards}, "
          f"launches per train step: {per_step}")
    return PathRun(name, trainer, batch, kernels, launches, per_step)


def _flash_vs_dense(model, x, tol: float, what: str):
    """The trained model's flash logits against its dense path, eval mode."""
    model.eval()
    with torch.no_grad():
        flash = model(x)
        model.impl = "dense"
        dense = model(x)
        model.impl = "auto"
    err = _scaled_err(flash, dense)
    print(f"  trained logits flash vs dense ({what}): shape={tuple(flash.shape)} "
          f"max_abs_err={_max_err(flash, dense):.3e} scaled_err={err:.3e} tol={tol:g}")
    if not torch.isfinite(flash).all() or err > tol:
        raise RuntimeError(f"{what}: trained model's flash logits disagree with the dense path")
    return flash


def phase_attention(workdir: Path) -> PathRun:
    """``main --model attention ... local`` at the JAX package's chip width."""
    print("main path: attention")
    argv = ["--model", "attention", "--hidden-units", str(ATTN_DIM),
            "--num-heads", str(ATTN_HEADS), "--stacked-layer", str(ATTN_DEPTH),
            "--batch-size", str(ATTN_BATCH), "--dropout", "0",
            "--dataset-path", str(workdir / "data"),
            "--checkpoint-directory", str(workdir / "models-attention"),
            "--epochs", "2", "--seed", "0", "local"]
    trainer, history, launches, _ = _drive(workdir, argv)
    steps = -(-len(trainer.training_set) // ATTN_BATCH) * len(history["train_history"])
    evaluations = len(history["validation_history"]) + 1
    run = _check_flash_path("attention", trainer, launches, steps,
                            evaluations * len(trainer.model.blocks), ATTN_BATCH)
    x = torch.from_numpy(trainer.test_set.features[:64]).cuda()
    flash = _flash_vs_dense(trainer.model, x, LOGIT_TOL, "attention")
    if flash.shape != (64, 6):
        raise RuntimeError(f"attention: logits of shape {tuple(flash.shape)}")
    return run


def phase_long_context():
    """The long-context classifier (bench.py's attention_seq1024_dim512
    bf16 row): ``LONG_STEPS`` Adam steps through the model and a
    train-step loop.  Returns the run and a function that trains n more
    steps (for the profile)."""
    from pytorch_distributed_rnn_tpu_torch.models import AttentionClassifier
    from pytorch_distributed_rnn_tpu_torch.ops.losses import cross_entropy_loss

    print("main path: long-context attention")
    model = AttentionClassifier(input_dim=9, dim=LONG_DIM, depth=2, num_heads=LONG_HEADS,
                                output_dim=6, max_len=LONG_T, precision="bf16",
                                generator=torch.Generator().manual_seed(0)).cuda()
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((LONG_BATCH, LONG_T, 9), generator=gen, device="cuda")
    y = torch.randint(0, 6, (LONG_BATCH,), generator=gen, device="cuda")

    def train_steps(n: int) -> list:
        model.train()
        losses = []
        for _ in range(n):
            loss = cross_entropy_loss(model(x), y)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        return [float(v) for v in losses]

    _reset_launch_counts()
    t0 = time.perf_counter()
    losses = train_steps(LONG_STEPS)
    torch.cuda.synchronize()
    launches = _launch_counts()
    print(f"  {time.perf_counter() - t0:.2f} s, losses={losses}, launches={launches}")
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"long context: losses not finite: {losses}")
    run = _check_flash_path("long context", model, launches, LONG_STEPS, 0, LONG_BATCH)
    flash = _flash_vs_dense(model, x, LOGIT_TOL_BF16, "long context")
    if flash.shape != (LONG_BATCH, 6):
        raise RuntimeError(f"long context: logits of shape {tuple(flash.shape)}")
    return run, train_steps


def phase_step_profile(name: str, train, steps: int, repeats: int):
    """``train()`` runs ``steps`` more train steps of a trained model,
    ending on a host read of the loss: each of ``repeats`` runs timed on
    the host clock (the steady-state step time), then one under
    ``torch.profiler`` (where the device time goes, by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    host_ms = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train()
        host_ms.append((time.perf_counter() - t0) * 1e3 / steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    device_us = {e.key: e.self_device_time_total for e in events}
    total_us = sum(device_us.values())
    print(f"step profile ({name}): {steps} steps per run; host clock per step over "
          f"{repeats} runs: {', '.join(f'{ms:.3f}' for ms in host_ms)} ms; device time "
          f"{total_us / 1e3 / steps:.3f} ms per step (one profiled run)")
    for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3 / steps:8.3f} ms/step  {100 * us / max(total_us, 1):5.1f}%  {key[:90]}")


def phase_scan_profile(run: PathRun, formatter):
    """The same trained model's train steps on its scan path (the Python
    loop over T, its backward by autograd), profiled once: what the
    kernels replace on the card."""
    model = run.trainer.model
    model.impl = "scan"
    try:
        phase_step_profile(f"{run.name}, scan path", lambda: run.trainer._train_epoch(formatter),
                           -(-len(run.trainer.training_set) // run.batch), SCAN_PROFILE_EPOCHS)
    finally:
        model.impl = "auto"


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 20) -> tuple[float, list]:
    """``fn``'s device time per call, summed over the kernels it launches
    under ``torch.profiler`` (``iters`` calls after two warm-up calls), and
    those kernels' names: the host's pace between launches does not count."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total_us / iters / 1e3, sorted(e.key.split("(")[0].strip()[:100] for e in events)


def _bound_ms(nbytes: int, flops: int, flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _timing_args(cell: str, batch: int, hidden: int):
    """f32 arguments of a cell's two kernels at ``batch`` rows (input width
    = H, zero final-state cotangents): (fwd, bwd, dh_all, generator)."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    if cell == "lstm":
        x_proj, h0, c0, w, gen = _layer_inputs(batch, hidden, torch.float32, seed=7,
                                               hidden=hidden)
        h_all, c_all, gates = fr.lstm_fwd_plain(x_proj, h0, c0, w)
        dh_all = 0.1 * torch.randn(h_all.shape, generator=gen, device="cuda")
        bwd = (x_proj, h_all, c_all, h0, c0, w, dh_all, torch.zeros_like(h0),
               torch.zeros_like(c0), gates if fr.lstm_saves_gates(hidden) else None)
        return (x_proj, h0, c0, w), bwd, dh_all, gen
    x_proj, h0, w, b, gen = _layer_inputs(batch, hidden, torch.float32, seed=7, cell="gru",
                                          hidden=hidden)
    h_all = fr.gru_fwd_plain(x_proj, h0, w, b)
    dh_all = 0.1 * torch.randn(h_all.shape, generator=gen, device="cuda")
    bwd = (x_proj, h_all, h0, w, b, dh_all, torch.zeros_like(h0))
    return (x_proj, h0, w, b), bwd, dh_all, gen


def _kernel_bounds(cell: str, batch: int, hidden: int) -> tuple:
    """Each kernel's least time at f32: every input read once, every
    output written once, and the f32 FMAs of its recurrent products (the
    backward recomputes the forward's and adds the contraction, except the
    LSTM's cluster variant, which reads the gates its forward saved)."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    gates = (4 if cell == "lstm" else 3) * hidden
    item = 4
    seq = SEQ_LEN * batch * hidden * item
    state = batch * hidden * item
    gate_seq = SEQ_LEN * batch * gates * item
    weight = hidden * gates * item
    flops = 2 * SEQ_LEN * batch * hidden * gates
    if cell == "lstm" and fr.lstm_saves_gates(hidden):
        # x_proj, h0, c0, w in; h_all, c_all, the activated gates out
        fwd = _bound_ms(2 * gate_seq + 2 * state + weight + 2 * seq, flops)
        # the gates, c_all, dh_all, c0, dh_T, dc_T, w in; dx_proj, dh0, dc0 out
        bwd = _bound_ms(2 * gate_seq + 2 * seq + 5 * state + weight, flops)
    elif cell == "lstm":
        # x_proj, h0, c0, w in; h_all, c_all out
        fwd = _bound_ms(gate_seq + 2 * state + weight + 2 * seq, flops)
        # x_proj, h_all, c_all, dh_all, h0, c0, dh_T, dc_T, w in; dx_proj, dh0, dc0 out
        bwd = _bound_ms(2 * gate_seq + 3 * seq + 6 * state + weight, 2 * flops)
    else:
        bias = gates * item
        # x_proj, h0, w, b in; h_all out
        fwd = _bound_ms(gate_seq + state + weight + bias + seq, flops)
        # x_proj, h_all, dh_all, h0, dh_T, w, b in; dx_proj, dhgates, dh0 out
        bwd = _bound_ms(3 * gate_seq + 2 * seq + 3 * state + weight + bias, 2 * flops)
    return fwd, bwd


def _library_calls(cell: str, batch: int, hidden: int, dh_all, gen):
    """cuDNN's whole layer (``torch.nn.LSTM``/``torch.nn.GRU``, input
    projection included) forward and backward at the same shape."""
    module = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(hidden, hidden).cuda()
    x_seq = torch.randn((SEQ_LEN, batch, hidden), generator=gen, device="cuda",
                        requires_grad=True)
    h0 = 0.5 * torch.randn((1, batch, hidden), generator=gen, device="cuda")
    state = (h0, torch.zeros_like(h0)) if cell == "lstm" else h0

    def fwd():
        with torch.no_grad():
            module(x_seq, state)

    out, _ = module(x_seq, state)
    inputs = [x_seq, *module.parameters()]

    def bwd():
        torch.autograd.grad(out, inputs, dh_all, retain_graph=True)

    return fwd, bwd


def _lstm_fwd_tiles(args) -> dict:
    """``lstm_fwd`` at the motion shape with each of ``LSTM_FWD_TILES`` rows
    a block, through its C entry (uncounted: not a main-path launch)."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    x_proj, h0, c0, w = args
    seq_len, batch, gate_dim = x_proj.shape
    h_all = torch.empty((seq_len, batch, gate_dim // 4), device="cuda")
    c_all = torch.empty_like(h_all)
    fn = fr._library("lstm_fwd")
    stream = torch.cuda.current_stream().cuda_stream

    def call(rows):
        err = fn(x_proj.data_ptr(), h0.data_ptr(), c0.data_ptr(), w.data_ptr(), h_all.data_ptr(),
                 c_all.data_ptr(), None, seq_len, batch, gate_dim // 4, rows, fr._VARIANTS["smem"],
                 fr._DTYPE_CODES[torch.float32], stream)
        if err != 0:
            raise RuntimeError(f"lstm_fwd at {rows} rows a block: CUDA error {err}")

    return {rows: _time_ms(lambda r=rows: call(r), 20) for rows in LSTM_FWD_TILES}


def _lstm_cluster_variants() -> dict:
    """Both LSTM kernels at B=256 on both sides of the width where their
    f32 slice stops fitting in shared memory (the forward's rows a cluster
    go from 8 to 4 there), and in bf16 at 512, whose slice fits: CUDA
    events over 10 launches, by kernel, dtype and H."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    times = {}
    for name, dtype, hidden in (("lstm_fwd", torch.float32, 448), ("lstm_fwd", torch.float32, 449),
                                ("lstm_fwd", torch.bfloat16, CHAR_HIDDEN),
                                ("lstm_bwd", torch.float32, 464), ("lstm_bwd", torch.float32, 465),
                                ("lstm_bwd", torch.bfloat16, CHAR_HIDDEN)):
        x_proj, h0, c0, w, gen = _layer_inputs(CHAR_BATCH, hidden, dtype, seed=3, hidden=hidden)
        if name == "lstm_fwd":
            ms = _time_ms(lambda: fr.lstm_fwd(x_proj, h0, c0, w), 10)
        else:
            h_all, c_all, gates = fr.lstm_fwd(x_proj, h0, c0, w)
            dh_all = torch.randn(h_all.shape, generator=gen, device="cuda").to(dtype)
            zero = torch.zeros_like(h0)
            ms = _time_ms(lambda: fr.lstm_bwd(x_proj, h_all, c_all, h0, c0, w, dh_all, zero,
                                              zero, gates), 10)
        times[f"{name} {str(dtype)[6:]} H={hidden}"] = ms
    print("  lstm cluster variants at B=256 (ms): "
          + ", ".join(f"{key}: {ms:.4f}" for key, ms in times.items()))
    return times


def _print_cluster(name: str, hidden: int, batch: int) -> dict:
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    cluster = fr.cluster_shape(name, hidden, batch)
    slice_rows = (f", {cluster['smem_slice_rows']} of the {hidden} slice rows in shared memory"
                  if "smem_slice_rows" in cluster else "")
    print(f"  {name} cluster: C={cluster['ctas']} CTAs x R={cluster['rows']} rows, "
          f"{cluster['smem_bytes']} B of shared memory a CTA{slice_rows}, {cluster['clusters']} "
          f"clusters, {cluster['active_clusters']} resident at once: "
          f"{cluster['waves']} waves")
    return cluster


def phase_timing(runs: dict, errs: dict) -> list:
    """Each kernel at each main shape beside its bound, its plain version
    and cuDNN; ``serial_ms`` is the kernel at one batch tile (one block, or
    one cluster), where only its chain of T dependent steps is left."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    rows = []
    for cell, batch, hidden, run in (
        ("lstm", MAIN_BATCH, HIDDEN, runs["motion_lstm"]),
        ("gru", MAIN_BATCH, HIDDEN, runs["motion_gru"]),
        ("gru", CHAR_BATCH, CHAR_HIDDEN, runs["char_gru"]),
        ("lstm", CHAR_BATCH, CHAR_HIDDEN, runs["char_lstm"]),
    ):
        fwd_tile = fr.lstm_fwd_tile if cell == "lstm" else fr.gru_tile
        bwd_tile_of = fr.lstm_bwd_tile if cell == "lstm" else fr.gru_bwd_tile
        tile, bwd_tile = fwd_tile(hidden)[0], bwd_tile_of(hidden)[0]
        fwd_args, bwd_args, dh_all, gen = _timing_args(cell, batch, hidden)
        tile_fwd = _timing_args(cell, tile, hidden)[0]
        tile_bwd = _timing_args(cell, bwd_tile, hidden)[1]
        lib_fwd, lib_bwd = _library_calls(cell, batch, hidden, dh_all, gen)
        bounds = _kernel_bounds(cell, batch, hidden)
        shape = _shape(batch, hidden)
        for name, kernel, plain, library, bound, args, tile_args in (
            (f"{cell}_fwd", getattr(fr, f"{cell}_fwd"), getattr(fr, f"{cell}_fwd_plain"),
             lib_fwd, bounds[0], fwd_args, tile_fwd),
            (f"{cell}_bwd", getattr(fr, f"{cell}_bwd"), getattr(fr, f"{cell}_bwd_plain"),
             lib_bwd, bounds[1], bwd_args, tile_bwd),
        ):
            rows.append({
                "name": name,
                "route": "cuda",
                "source": SOURCES[name],
                "replaces": REPLACES[name],
                "shape": shape,
                "path": run.name,
                "launches": run.launches[name],
                "launches_per_step": run.per_step[name],
                "max_abs_err": errs[(name, shape)],
                "ms": _time_ms(lambda: kernel(*args), 20),
                "serial_ms": _time_ms(lambda: kernel(*tile_args), 20),
                "plain_ms": _time_ms(lambda: plain(*args), 3, warmup=1),
                "bound_ms": bound[0],
                "bound_by": bound[1],
                "library_ms": _time_ms(library, 20),
            })
        print(f"timing {cell} at {shape}; serial_ms at B={tile} / {bwd_tile} (one block, or one "
              f"cluster); library_ms is torch.nn.{cell.upper()} (cuDNN) forward / backward incl. "
              "its input projection")
        if cell == "lstm" and hidden == HIDDEN:
            tiles = _lstm_fwd_tiles(fwd_args)
            print("  lstm_fwd by rows a block (ms): "
                  + ", ".join(f"{r}: {ms:.4f}" for r, ms in tiles.items())
                  + f"; the wrapper takes {fr.lstm_fwd_tile(hidden)[0]}")
            rows[-2]["ms_by_rows_a_block"] = tiles
        if cell == "lstm" and fwd_tile(hidden)[1] == "cluster":
            rows[-2]["ms_by_variant"] = _lstm_cluster_variants()
        if fwd_tile(hidden)[1] == "cluster":
            rows[-2]["cluster"] = _print_cluster(f"{cell}_fwd", hidden, batch)
        if bwd_tile_of(hidden)[1] == "cluster":
            rows[-1]["cluster"] = _print_cluster(f"{cell}_bwd", hidden, batch)
    return rows


def _flash_bounds(bh: int, t: int, d: int, dtype) -> dict:
    """Each flash kernel's least time, non-causal (every score counts):
    every input read once, every output written once, and its products at
    the card's rate for the dtype (float32 on the CUDA cores, bf16 on the
    tensor cores).  The forward reads q, k, v and writes o and lse; dQ
    reads q, k, v, dO, lse and delta and writes dQ; dK/dV reads the same
    and writes dK and dV.  Each product is 2 BH T^2 D operations: the
    forward does 2 (q k^T, p v), dQ 3 (s, dp, ds k), dK/dV 4 (s, dp, p^T
    dO, ds^T q)."""
    seq = bh * t * d * (2 if dtype == torch.bfloat16 else 4)
    rows = bh * t * 4
    product = 2 * bh * t * t * d
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    return {
        "flash_fwd": _bound_ms(4 * seq + rows, 2 * product, rate),
        "flash_dq": _bound_ms(5 * seq + 2 * rows, 3 * product, rate),
        "flash_dkv": _bound_ms(6 * seq + 2 * rows, 4 * product, rate),
    }


def _flash_calls(bh: int, t: int, d: int, dtype, heads: int) -> dict:
    """Each flash kernel, its plain version, the same kernel at one block
    and ``scaled_dot_product_attention`` (forward, or its whole backward)
    on the same inputs, as ``(kernel, plain, one block, library)``."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_attention as fa

    q, k, v, do = _flash_inputs(bh, t, t, d, dtype, seed=11)
    o, lse = fa.flash_fwd_plain(q, k, v)
    delta = (do.float() * o.float()).sum(dim=-1)
    bwd = (q, k, v, do, lse, delta)
    rows = fa.BLOCK_ROWS  # one query tile (fwd, dQ) or one key tile (dK/dV): one block

    def first(x, n=None):
        return x[:1, :n].contiguous()

    one_q = (first(q, rows), first(k), first(v), first(do, rows), first(lse, rows),
             first(delta, rows))
    one_k = (first(q), first(k, rows), first(v, rows), first(do), first(lse), first(delta))
    q4, k4, v4 = (x.reshape(bh // heads, heads, t, d).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_fwd():
        with torch.no_grad():
            sdpa(q4, k4, v4)

    out = sdpa(q4, k4, v4)
    do4 = do.reshape(out.shape)

    def lib_bwd():
        torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)

    return {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_fwd_plain(q, k, v),
                      lambda: fa.flash_fwd(*one_q[:3]), lib_fwd),
        "flash_dq": (lambda: fa.flash_dq(*bwd), lambda: fa.flash_dq_plain(*bwd),
                     lambda: fa.flash_dq(*one_q), lib_bwd),
        "flash_dkv": (lambda: fa.flash_dkv(*bwd), lambda: fa.flash_dkv_plain(*bwd),
                      lambda: fa.flash_dkv(*one_k), lib_bwd),
    }


def _glue_ms(batch: int, heads: int, t: int, d: int, dtype) -> float:
    """The layout copies around one forward call of ``flash_attention`` in
    the model: q, k and v from the projections' (B, T, H*D) into contiguous
    (B*H, T, D), and o back to (B, T, H*D) (the backward copies the same
    bytes again, transposed)."""
    x = torch.randn((batch, t, heads * d), device="cuda").to(dtype)

    def glue():
        for _ in range(3):
            x.reshape(batch, t, heads, d).transpose(1, 2).reshape(batch * heads, t, d)
        x.reshape(batch, heads, t, d).transpose(1, 2).reshape(batch, t, heads * d)

    return _time_ms(glue, 20)


def phase_flash_timing(runs: dict, errs: dict) -> list:
    """Each flash kernel at the two main shapes beside its bound, its plain
    version and SDPA; ``serial_ms`` is the kernel at one block (one 64-row
    tile of one head)."""
    rows = []
    for run, batch, dim, heads, t, dtype in (
        (runs["attention"], ATTN_BATCH, ATTN_DIM, ATTN_HEADS, SEQ_LEN, torch.float32),
        (runs["long"], LONG_BATCH, LONG_DIM, LONG_HEADS, LONG_T, torch.bfloat16),
    ):
        bh, d = batch * heads, dim // heads
        shape = _flash_shape(bh, t, d, dtype)
        bounds = _flash_bounds(bh, t, d, dtype)
        calls = _flash_calls(bh, t, d, dtype, heads)
        sdpa_bwd_ms, sdpa_bwd_kernels = _device_ms(calls["flash_dq"][3])
        for name, (kernel, plain, one_block, library) in calls.items():
            rows.append({
                "name": name,
                "route": "cuda",
                "source": SOURCES[name],
                "replaces": REPLACES[name],
                "shape": shape,
                "path": run.name,
                "launches": run.launches[name],
                "launches_per_step": run.per_step[name],
                "max_abs_err": errs[(name, shape)],
                "ms": _time_ms(kernel, 20),
                "serial_ms": _time_ms(one_block, 20),
                "plain_ms": _time_ms(plain, 3, warmup=1),
                "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1],
                "library_ms": _time_ms(library, 20) if name == "flash_fwd" else sdpa_bwd_ms,
            })
        print(f"timing flash at {shape}; serial_ms at one block; library_ms is "
              "scaled_dot_product_attention forward (CUDA events) / whole backward (dQ, dK, dV: "
              "the device time of its kernels per call under torch.profiler, "
              f"{sdpa_bwd_kernels}); layout copies around one forward call "
              f"{_glue_ms(batch, heads, t, d, dtype):.4f} ms")
    return rows


def main() -> int:
    from pytorch_distributed_rnn_tpu_torch.data.synthetic import write_synthetic_har_cache

    from pytorch_distributed_rnn_tpu_torch.training.formatter import TrainingMessageFormatter

    t0 = time.perf_counter()
    phase_device()
    phase_build()
    errs = phase_kernels()
    errs.update(phase_flash_kernels())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        workdir = Path(tmp)
        write_synthetic_har_cache(workdir / "data", num_train=7352, num_test=2947, seed=0)
        runs = {
            "motion_lstm": phase_motion(workdir, "lstm"),
            "motion_gru": phase_motion(workdir, "gru"),
            "char_gru": phase_char(workdir, "gru"),
            "char_lstm": phase_char(workdir, "lstm"),
            "attention": phase_attention(workdir),
        }
    runs["long"], long_train = phase_long_context()
    formatter = TrainingMessageFormatter(1)
    for key, epochs in (("motion_lstm", PROFILE_EPOCHS), ("motion_gru", 2), ("char_gru", 2),
                        ("char_lstm", 2), ("attention", 2)):
        run = runs[key]
        phase_step_profile(run.name, lambda t=run.trainer: t._train_epoch(formatter),
                           -(-len(run.trainer.training_set) // run.batch), epochs)
    phase_scan_profile(runs["char_lstm"], formatter)
    phase_step_profile("long context", lambda: long_train(LONG_STEPS), LONG_STEPS, 2)
    rows = phase_timing(runs, errs) + phase_flash_timing(runs, errs)
    print(f"smoke: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
