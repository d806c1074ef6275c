"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. device: needs ``torch.cuda.is_available()``; prints the card's
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. build: compiles every kernel of ``pytorch_distributed_rnn_tpu_torch/
   csrc/`` with nvcc, one process per source, all at once.
3. kernels: holds each kernel against its plain PyTorch version on the
   card, forward and backward, at the batch sizes the main path gives
   them (T=128, H=32, x_proj from input widths 9 and 32, O(1) random
   cotangents), f32 and bf16, at the tolerances of ``TOLERANCES``.
4. main path: writes full-size synthetic HAR data (7352 train and 2947
   test windows of 128 x 9) and runs ``main ... local`` in-process for 2
   epochs with the default flags (batch 1440, 2 x 32 LSTM, lr 0.0025,
   dropout 0.1); checks finite losses, the perf line, that both kernels
   were launched, and that the trained model's fused logits agree with
   the plain scan path.  Each kernel's launches per train step come from
   this run's counts.
5. step profile: five more epochs of the trained model, each timed on
   the host clock, and one under ``torch.profiler`` (device time by
   kernel).
6. timing: CUDA-event times of each kernel, its plain version and
   cuDNN's LSTM (``torch.nn.LSTM``, timed here only, never called by the
   port) at the main shape, beside each kernel's bound; and each kernel
   at one batch tile (one block), its serial floor.

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
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SEQ_LEN = 128
HIDDEN = 32
MAIN_BATCH = 1440
# the batch sizes of the main path: full and final train batches, the
# validation and the test evaluation (forward only)
FWD_BATCHES = (1440, 768, 735, 2947)
BWD_BATCHES = (1440, 768)
TOLERANCES = {  # (forward, backward)
    # the JAX kernel tests' (test_pallas_rnn.py), elementwise:
    # |got - want| <= tol + tol * |want|
    torch.float32: (1e-5, 1e-4),
    # of each output's largest value: |got - want| <= tol * max|want|.  Both
    # sides carry float32 and round what they store to bf16, so they differ
    # by at most one bf16 ulp of the largest value (2^-7 of it)
    torch.bfloat16: (1e-2, 1e-2),
}
PROFILE_EPOCHS = 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
REPLACES = {
    "lstm_fwd": "pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:100",
    "lstm_bwd": "pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:166",
}
SOURCES = {
    "lstm_fwd": "pytorch_distributed_rnn_tpu_torch/csrc/lstm_fwd.cu",
    "lstm_bwd": "pytorch_distributed_rnn_tpu_torch/csrc/lstm_bwd.cu",
}


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


def phase_build():
    from pytorch_distributed_rnn_tpu_torch import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")


def _max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _scaled_err(got, want) -> float:
    """The error that ``TOLERANCES`` bounds: elementwise against
    ``1 + |want|`` in float32, against ``max|want|`` in bf16."""
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        return (diff / (1.0 + want.float().abs())).max().item()
    return diff.max().item() / max(want.float().abs().max().item(), 1e-30)


def _layer_inputs(batch, in_width, dtype, seed):
    """x_proj (T, B, 4H) from a random layer and input, plus h0, c0, w_hh_t."""
    from pytorch_distributed_rnn_tpu_torch.ops.rnn import init_rnn_layer, lstm_input_proj

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_rnn_layer(gen, in_width, HIDDEN)
    params = {k: v.to(dtype) for k, v in params.items()}
    x = torch.randn((batch, SEQ_LEN, in_width), generator=gen, device="cuda").to(dtype)
    x_proj = lstm_input_proj(params, x).transpose(0, 1).contiguous()
    h0 = (0.5 * torch.randn((batch, HIDDEN), generator=gen, device="cuda")).to(dtype)
    c0 = (0.5 * torch.randn((batch, HIDDEN), generator=gen, device="cuda")).to(dtype)
    return x_proj, h0, c0, params["w_hh"].T.contiguous(), gen


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns max abs errors at
    the main shape (f32, B=1440, input width 32) for the kernels line."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    main_errs = {}
    failures = []
    for dtype, (tol_f, tol_b) in TOLERANCES.items():
        for in_width in (9, 32):
            for batch in FWD_BATCHES:
                x_proj, h0, c0, w, gen = _layer_inputs(batch, in_width, dtype, seed=batch + in_width)
                h_k, c_k = fr.lstm_fwd(x_proj, h0, c0, w)
                h_p, c_p = fr.lstm_fwd_plain(x_proj, h0, c0, w)
                err = max(_max_err(h_k, h_p), _max_err(c_k, c_p))
                scaled = max(_scaled_err(h_k, h_p), _scaled_err(c_k, c_p))
                ok = scaled <= tol_f
                print(f"lstm_fwd {str(dtype)[6:]} B={batch} in={in_width}: "
                      f"max_abs_err={err:.3e} scaled_err={scaled:.3e} tol={tol_f:g} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"lstm_fwd {dtype} B={batch} in={in_width}")
                if batch not in BWD_BATCHES:
                    continue
                dh_all = torch.randn(h_p.shape, generator=gen, device="cuda").to(dtype)
                dh_t = torch.randn(h0.shape, generator=gen, device="cuda").to(dtype)
                dc_t = torch.randn(h0.shape, generator=gen, device="cuda").to(dtype)
                args = (x_proj, h_p, c_p, h0, c0, w, dh_all, dh_t, dc_t)
                got = fr.lstm_bwd(*args)
                want = fr.lstm_bwd_plain(*args)
                errb = max(_max_err(a, b) for a, b in zip(got, want))
                scaledb = max(_scaled_err(a, b) for a, b in zip(got, want))
                okb = scaledb <= tol_b
                print(f"lstm_bwd {str(dtype)[6:]} B={batch} in={in_width}: "
                      f"max_abs_err={errb:.3e} scaled_err={scaledb:.3e} tol={tol_b:g} "
                      f"{'ok' if okb else 'FAIL'}")
                if not okb:
                    failures.append(f"lstm_bwd {dtype} B={batch} in={in_width}")
                if dtype == torch.float32 and batch == MAIN_BATCH and in_width == HIDDEN:
                    main_errs = {"lstm_fwd": err, "lstm_bwd": errb}
    torch.cuda.synchronize()
    if failures:
        raise RuntimeError(f"kernels disagree with their plain versions: {failures}")
    return main_errs


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def phase_main_path(workdir: Path) -> tuple:
    """``main ... local`` at full width; returns the trainer, the kernel
    launch counts of the run and each kernel's launches per train step,
    worked out from those counts."""
    from pytorch_distributed_rnn_tpu_torch import main as port_main
    from pytorch_distributed_rnn_tpu_torch.data.synthetic import write_synthetic_har_cache
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    data = workdir / "data"
    write_synthetic_har_cache(data, num_train=7352, num_test=2947, seed=0)
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    cwd = os.getcwd()
    os.chdir(workdir)  # main writes history.json into the working directory
    try:
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = port_main.main([
            "--dataset-path", str(data),
            "--checkpoint-directory", str(workdir / "models"),
            "--epochs", "2", "--seed", "0", "local",
        ])
        torch.cuda.synchronize()
        launches = dict(fr.LAUNCHES)
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        logging.getLogger().removeHandler(capture)
    history = json.loads((workdir / "history.json").read_text())
    losses = history["train_history"] + history["validation_history"]
    print(f"main path: {wall:.2f} s, train_history={history['train_history']}, "
          f"validation_history={history['validation_history']}, launches={launches}")
    if len(history["train_history"]) != 2 or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"main path losses not finite: {history}")
    perf = [m for m in capture.messages
            if re.fullmatch(r"0: Memory Usage: \S+, Training Duration: \S+", m)]
    if len(perf) != 1:
        raise RuntimeError("main path printed no perf line")
    print(f"perf line: {perf[0]}")
    for name, count in launches.items():
        if count <= 0:
            raise RuntimeError(f"main path never launched kernel {name}")
    if not (workdir / "models" / "best-model.ckpt").exists():
        raise RuntimeError("main path wrote no best-model checkpoint")

    # the trained model's fused logits against the plain scan path
    model = trainer.model.eval()
    x = torch.from_numpy(trainer.test_set.features[:64]).cuda()
    with torch.no_grad():
        fused = model(x)
        model.impl = "scan"
        plain = model(x)
        model.impl = "auto"
    err = _max_err(fused, plain)
    print(f"trained logits fused vs scan: shape={tuple(fused.shape)} max_abs_err={err:.3e} tol=1e-4")
    if fused.shape != (64, 6) or not torch.isfinite(fused).all() or err > 1e-4:
        raise RuntimeError("trained model's fused logits disagree with the scan path")
    # every train step runs each layer forward and backward once; every
    # evaluation (one per epoch, then the test set) runs each layer forward
    steps = -(-len(trainer.training_set) // MAIN_BATCH) * len(history["train_history"])
    layers = len(model.rnn)
    evaluations = len(history["validation_history"]) + 1
    train_fwd = launches["lstm_fwd"] - evaluations * layers
    if train_fwd != launches["lstm_bwd"]:
        raise RuntimeError(f"train-step forwards {train_fwd} != backwards {launches['lstm_bwd']}")
    per_step = {"lstm_fwd": train_fwd / steps, "lstm_bwd": launches["lstm_bwd"] / steps}
    print(f"train steps: {steps}, evaluations: {evaluations}, launches per train step: {per_step}")
    return trainer, launches, per_step


def phase_step_profile(trainer):
    """More training epochs of the trained model: each timed on the host
    clock (the steady-state step time), then one under ``torch.profiler``
    (where the device time goes, by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_rnn_tpu_torch.training.formatter import TrainingMessageFormatter

    formatter = TrainingMessageFormatter(1)
    steps = -(-len(trainer.training_set) // MAIN_BATCH)
    host_ms = []
    for _ in range(PROFILE_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._train_epoch(formatter)  # ends on a host read of the loss
        host_ms.append((time.perf_counter() - t0) * 1e3 / steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer._train_epoch(formatter)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    device_us = {e.key: e.self_device_time_total for e in events}
    total_us = sum(device_us.values())
    print(f"step profile: {steps} steps per epoch; host clock per step over {PROFILE_EPOCHS} "
          f"epochs: {', '.join(f'{ms:.3f}' for ms in host_ms)} ms; device time "
          f"{total_us / 1e3 / steps:.3f} ms per step (one profiled epoch)")
    for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3 / steps:8.3f} ms/step  {100 * us / max(total_us, 1):5.1f}%  {key[:90]}")


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


def _bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _timing_args(batch: int):
    """f32 arguments of both kernels at ``batch`` rows: (fwd, bwd, generator)."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    x_proj, h0, c0, w, gen = _layer_inputs(batch, HIDDEN, torch.float32, seed=7)
    h_all, c_all = fr.lstm_fwd_plain(x_proj, h0, c0, w)
    dh_all = 0.1 * torch.randn(h_all.shape, generator=gen, device="cuda")
    bwd = (x_proj, h_all, c_all, h0, c0, w, dh_all, torch.zeros_like(h0), torch.zeros_like(c0))
    return (x_proj, h0, c0, w), bwd, gen


def phase_timing(launches: dict, per_step: dict, errs: dict) -> list:
    """Each kernel at the main shape beside its bound, its plain version
    and cuDNN; ``serial_ms`` is the kernel at one batch tile (one block),
    where only its chain of T dependent steps is left."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    fwd_args, bwd_args, gen = _timing_args(MAIN_BATCH)
    x_proj, h0, c0, _ = fwd_args
    dh_all = bwd_args[6]
    tile_fwd, tile_bwd, _ = _timing_args(fr.BLOCK_B)

    # cuDNN's LSTM at the same shapes (its input projection included)
    lstm = torch.nn.LSTM(HIDDEN, HIDDEN).cuda()
    x_seq = torch.randn((SEQ_LEN, MAIN_BATCH, HIDDEN), generator=gen, device="cuda",
                        requires_grad=True)
    state = (h0[None].clone(), c0[None].clone())

    def cudnn_fwd():
        with torch.no_grad():
            lstm(x_seq, state)

    out, _ = lstm(x_seq, state)
    inputs = [x_seq, *lstm.parameters()]

    def cudnn_bwd():
        torch.autograd.grad(out, inputs, dh_all, retain_graph=True)

    item = x_proj.element_size()
    t, b, g = x_proj.shape
    hid = g // 4
    seq_bytes = t * b * hid * item
    state_bytes = b * hid * item
    w_bytes = hid * g * item
    gates_bytes = t * b * g * item
    fwd_bound = _bound_ms(
        gates_bytes + 2 * state_bytes + w_bytes + 2 * seq_bytes,  # x_proj, h0, c0, w in; h_all, c_all out
        2 * t * b * hid * g,
    )
    bwd_bound = _bound_ms(
        # x_proj, h_all, c_all, dh_all, h0, c0, dh_T, dc_T, w in; dx_proj, dh0, dc0 out
        2 * gates_bytes + 3 * seq_bytes + 6 * state_bytes + w_bytes,
        4 * t * b * hid * g,
    )
    rows = []
    for name, kernel, plain, cudnn, bound, tile_args in (
        ("lstm_fwd", fr.lstm_fwd, fr.lstm_fwd_plain, cudnn_fwd, fwd_bound, tile_fwd),
        ("lstm_bwd", fr.lstm_bwd, fr.lstm_bwd_plain, cudnn_bwd, bwd_bound, tile_bwd),
    ):
        args = fwd_args if name == "lstm_fwd" else bwd_args
        rows.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches[name],
            "launches_per_step": per_step[name],
            "max_abs_err": errs[name],
            "ms": _time_ms(lambda: kernel(*args), 20),
            "serial_ms": _time_ms(lambda: kernel(*tile_args), 20),
            "plain_ms": _time_ms(lambda: plain(*args), 3, warmup=1),
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "library_ms": _time_ms(cudnn, 20),
        })
    print(f"timing at T={SEQ_LEN} B={MAIN_BATCH} H={HIDDEN} f32; serial_ms at "
          f"B={fr.BLOCK_B} (one block); library_ms is torch.nn.LSTM (cuDNN) "
          "forward / backward incl. its input projection")
    return rows


def main() -> int:
    phase_device()
    phase_build()
    errs = phase_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        trainer, launches, per_step = phase_main_path(Path(tmp))
    phase_step_profile(trainer)
    rows = phase_timing(launches, per_step, errs)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
