"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. device: needs ``torch.cuda.is_available()``; prints the card's
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. build: compiles every kernel source of ``pytorch_distributed_rnn_tpu_torch/
   csrc/`` with nvcc, one process per source, all at once; prints each
   kernel's registers and spills (``-Xptxas -v``), checks that the GRU
   forward's cluster kernel, both GRU kernels up to H=32
   (``gru_fwd_reg_kernel``, ``gru_bwd_reg_kernel``), the LSTM forward
   kernel, both LSTM cluster kernels, the LSTM forward's tensor-core
   cluster kernel (``lstm_fwd_tc_kernel``), the LSTM backward up to H=32
   (``lstm_bwd_reg_kernel``), the fused f32 flash backward
   (``flash_dqkv_tc_kernel``) and the f32 flash forward
   (``flash_fwd_f32_tc_kernel``) have no stack frame and no spills in any
   instance, and checks in the SASS (``cuobjdump``) that the bf16
   ``flash_fwd``/``flash_dq``/``flash_dkv`` kernels, the 3xTF32 f32
   ``flash_fwd`` and ``flash_dqkv`` and the 3xTF32 ``lstm_fwd_tc_kernel``,
   and only they, run on the tensor cores (HMMA).
3. kernels: holds each kernel against its plain PyTorch version on the
   card, at the shapes the main paths give them (O(1) random cotangents,
   f32 and bf16, the tolerances of ``TOLERANCES``): the LSTM and GRU
   kernels at H=32 (T=128, x_proj from input widths 9 and 32) and at
   H=512 (input 512, the char LM's train and evaluation batches), the
   LSTM one-block kernels' edges (B=37, H=110), the LSTM cluster kernels'
   edges (H=111, 200, 300, both sides of the f32 slice's fit in shared
   memory: 448/449 forward, where the tensor-core kernel starts, 464/465
   backward, B=250, 37 and generate's 8 prompts at 512), the GRU
   register kernels' edges (a ragged last quad at H=32, H=1, and H=13 and
   30, where no 4 divides H), the GRU cluster kernels' edges (H=127, 200,
   300, B=250 and 37 at 512), and the gates the forwards save (the LSTM
   up to H=32 and over a cluster, the GRU up to H=32); the
   flash kernels, each case on (B*H, T, D) rows and on the model's
   (B, T, H, D) layout (q, k, v views of (B, T, H*D) projections, dO of
   (B, H, T, D) storage, outputs in their inputs' layout), at the
   attention CLI's shapes (train batches, and the evaluation batches
   forward only), the long-context shape (64, 1024, 128) in bf16 and f32
   (also causal, where the diagonal tiles mask), D=8, D=72, causal with
   offsets, a ragged T=300, cross lengths 96/160 and a chunk that sees no
   key (o = 0, lse = -inf); ``flash_dqkv`` at every f32 case in its range
   (Tq, Tk <= 128, D <= 64: the CLI train batches, D=8, causal offsets,
   the no-key chunk, a ragged causal 77/100 at D=30 and D=64), and two of
   its launches bitwise equal; the f32 forward at its edges (T = 1, 63,
   64, 65, 128, 200, 1024 by D = 1, 8, 31, 32, 64, 100, 128, unmasked,
   causal with offsets, no visible key).
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
      HAR windows of (a): ``flash_fwd`` and one ``flash_dqkv`` a block a
      train step, no ``flash_dq``/``flash_dkv``;
   e. the long-context classifier (dim 512, 4 heads, depth 2, bf16,
      T=1024) trained one epoch of 10 Adam steps at batch 16 on seeded
      random windows through the trainer: ``flash_fwd``, ``flash_dq``
      and ``flash_dkv``, no ``flash_dqkv``;
   g. the data-parallel strategies through ``torchrun`` and the CLI
      (``parallel/launch.py`` running ``main ... distributed|horovod`` on
      every rank) at path a's width with ``--dropout 0``: world 1 on NCCL,
      under a deadline sized to its work (``G_DEADLINE_S``), on the graph
      path (each batch shape's step, its collectives included, captured
      once and replayed): ``distributed`` with and without
      ``--sharded-update`` and ``horovod``, each equal bit for bit to its
      per-batch-loop twin (``--log DEBUG``: history, parameters, the last
      Adam state, launches a step), ``--cell gru``, and ``--fuse-run``
      under both strategies within 1e-5 of their per-epoch runs with the
      same launches a step; then, in a child process on a world of 1 over
      NCCL, g's host and device ms a step on the graph path and the
      per-batch loop in turns (``phase_step_profile``) and the fused run's
      replay ms a step.  h. world 2, two ranks sharing the card over gloo,
      run beside g's world (``distributed`` and ``horovod``, each with and
      without ``--sharded-update``): the step body uncaptured, which every
      rank logs once.  Every rank must end with rank 0's parameters bit for
      bit, sharded with replicated bit for bit, ``distributed`` with
      ``horovod`` within 1e-5 and each world with a ``local`` run of the
      same flags within 1e-4; each rank's kernel launches are counted
      (reset before its run, read after) against the steps it took, and
      its step path read from its graphs' replays.
   i. ``distributed-native`` over the TCP ring (``runtime/native.py``)
      through ``torchrun`` and the CLI at path a's width with ``--dropout
      0 --no-validation``, at world 1 and at world 2 (two ranks sharing the
      card): bucketed at ``--bucket-mb 0.02`` (three buckets), monolithic
      (``--no-bucketed-comm``) and replicated (``--no-sharded-update``);
      the flavours equal bit for bit, every rank equal to rank 0, each
      within 1e-5 of ``distributed`` at the same world and flavour, world 1
      within 1e-4 of ``local``; j. the same strategy on path f's char LM at
      H=512 for one epoch at world 1, bucketed at ``--bucket-mb 4`` (five
      buckets of the 17.9 MB gradient) against monolithic bit for bit, the
      tensor-core forward and cluster backward counted in the profile.
      Each run is profiled: host ms and device ms a step, and each rank's
      ``comm_wait_s``/``comm_active_s`` a step are printed, with the ring
      library's g++ build time.  The same two ``torchrun`` worlds run the
      toy examples on the card: ``example_ddp`` and ``example_horovod`` at
      worlds 1 and 2, ``example_p2p`` at world 2, each printing
      ``PARITY-OK`` (p2p: every rank's 1.0).
   n. ``parameter-server`` (``phase_ps``, after phase 6, before
      ``phase_serving``; it compares against ``phase_native``'s finals)
      through the CLI, every rank on the one card: the motion LSTM at path a's
      width (``--dropout 0 --no-validation``, 2 epochs): sync at world 2
      (one worker) within 1e-4 of the ``local`` run of phase g, plain and
      profiled (the same bits); sync at world 3 bit for bit equal to path
      i's world-2 ``--no-sharded-update`` parameters; async at world 3 in
      spawn mode (the CLI without ``--rank``): it completes with finite
      losses and the master's updates equal the workers' steps; ``--cell
      gru`` sync at world 2 within 1e-4 of a ``local`` run.  o. the char
      LSTM at path f's flags for one epoch, sync at world 2, plain and
      profiled: worker 1's per-batch losses finite and falling, the
      profile's LSTM kernels ``lstm_fwd_tc_kernel`` and
      ``lstm_bwd_cluster_kernel`` and no other.  A world runs in rank mode: worker 1 in this process (its
      launch counts reset before and read after), the master and the other
      workers as CLI processes.  Every worker launches its cell's forward
      and backward once a layer a step and nothing else; in sync mode
      every rank ends on the master's parameters (the sha256 of their
      bytes).  Printed: worker host, exchange (push until the reply's
      copies are queued) and device ms a step, the master's update ms
      (H2D, Adam, D2H), the flat vector's bytes.  A failed rank fails the
      phase.
   p. the resilience and memory flags (``phase_resilience``, after
      ``phase_ps``, before ``phase_serving``) on the existing kernels: p.1
      path a with and without ``--max-bad-steps 2`` (3 epochs, the graph
      path): the same parameters and Adam state bit for bit, each run's
      device ms a step; p.2 ``--faults step:3:nan,step:4:nan`` skips 2 steps
      (the parameters after step 4 are those after step 2) and a third NaN
      in a row raises ``NonFiniteAbort``; p.3 path a at dropout 0.1 with
      validation and ``--checkpoint-every 1``, killed by ``--faults
      epoch:2:kill`` in a CLI process (exit -9), its newest checkpoint
      truncated, then ``--resume auto`` (falls back to epoch 1): parameters,
      Adam state and the last validation loss bit for bit the uninterrupted
      run's; p.4 path f plain, ``--remat``, ``--grad-accum 4`` and both, two
      epochs each (the second profiled): peak memory, device ms and RNN
      launches a step (remat: 2 forwards a layer; accum: 4 of each), remat
      == plain and both == accum bit for bit, accum's loss within 1e-5, and
      path d at dropout 0.1 with ``--remat`` bit for bit; p.5
      ``distributed-native`` at world 2 on the card (``native_ddp.
      launch_world(..., device="cuda")``, path i's bucketed sharded update)
      with ``--faults step:3:nan@1 --max-bad-steps 2``: both ranks skip,
      the same parity line, and with ``net:delay:5`` the same bits and the
      host and ring time a step beside 5 ms times the ring's sends;
      ``distributed`` at world 1 on NCCL against ``local`` with the same
      schedule.
   q. the training CLI's telemetry (``phase_telemetry``, after
      ``phase_resilience``, before ``phase_serving``): q.1 path a (graph
      path, 3 epochs) with and without ``--metrics --metrics-sample-every
      5`` in turns: parameters and Adam state bit for bit, host ms a step
      (epochs 2-3 on the host clock) and device ms a step (one more epoch
      profiled) of each and their difference; the sidecar's ``meta`` first,
      one ``step`` event a step, ``fenced_s`` on sampled steps only, epoch
      path ``step``, the ``run_summary`` ledger block on the H100's peak
      (``utils/hw.py``) and its MFU; the port's ``obs`` CLI ``summarize`` and
      ``ledger`` over it; q.2 ``--profile-steps 3:6`` on path a: the trace
      holds each LSTM kernel 3 x 2 times and the ``profile`` event says
      captured, and ``--profile`` over path d's epoch lists the flash
      kernels; q.3 ``distributed-native`` at world 2 sharing the card at
      dropout 0.1 with ``--metrics`` (rank-suffixed sidecars,
      ``comm_wait_s`` in every step event, the two ranks' timeline through
      its validator) and, at the same time, the same world killed by
      ``epoch:1:kill``, then ``--resume auto``: parameters and Adam state
      and each rank's parameter digest bit for bit the uninterrupted run's
      (ROADMAP C6); q.4 path f (one epoch) with ``--live 0
      --live-port-file`` and ``--faults step:4:stall:3,step:6:stall:0.8``
      at ``PDRNN_WATCHDOG_STALL=1``, in a thread, polled: ``/metrics``
      answers, ``/health`` goes stalled then ok, ``/events`` holds the stall
      alert and its clearing; the parameters equal the same run's without
      telemetry bit for bit.
   s. checkpoints that cross frameworks (``phase_interop``, after
      ``phase_telemetry``): s.1 the JAX-written fixture
      (``tests/data/jax_checkpoints``: the JAX trainer's ``local`` at path
      a's model, one epoch, on the seeded HAR cache its ``expected.json``
      names) resumed with ``--resume auto`` on the graph path for epochs
      2-3: the losses within 1e-4 of the JAX trainer's continuation, the
      LSTM kernels' launches counted as ``_check_path`` counts them; s.2
      the ``checkpoint-epoch-3.ckpt`` the port wrote: JAX's header fields,
      no trainer section, both sections decoded by the port's codec into
      the fixture's keys, order, shapes and dtypes; s.3 from that file at
      ``--max-bad-steps 3 --dropout 0.1``, killed by ``epoch:4:kill``
      (exit -9) and resumed: the uninterrupted run's parameters and Adam
      state bit for bit.
   t. the parameter server's checkpoints and elastic membership
      (``phase_ps_elastic``, after phase s), at n's flags: t.1 sync at
      world 2 with ``--ps-checkpoint-rounds 5``: each write's ms; t.2
      ``--elastic --min-workers 1 --faults step:6:respawn@1`` at world 3
      in spawn mode: exit 0, one respawn and one rejoin, the rejoiner's
      STATE_SYNC parameters equal to the master's at that update (the
      sha256 either side logs), every push in one round (the master's
      sidecar), the LSTM kernels on both workers, the respawn's process
      start to its first applied push; t.3 the world restarted on t.1's
      checkpoints with ``--resume auto``, elastic at world 3 with
      ``step:6:preempt@2``: the master's bootstrap ordinal and the sha256
      of its first flat vector equal to the last checkpoint's parameters,
      then worker 2 deregisters, the roster drains it, the run completes.
   k. serving (``phase_serving``, the smoke's last phase, after phase 6):
      path f's trained checkpoint through the serving CLI's loader, an engine of 8
      slots (prompt buckets 16-128, 128 new tokens at most) whose prefill
      and decode step are CUDA graphs captured at warm-up, 32 mixed
      requests (prompts of 1-128 tokens from the char test windows, 1-128
      new tokens, temperatures 0 / 0.7 / 1.0): every request's tokens equal
      its single-request ``generate`` on the card (a greedy near tie below
      ``LOGIT_TOL`` is reported and allowed), captures 4 + 1 + 1 and none
      added, no RNN or flash kernel launched; the largest first-step logit
      difference against ``generate``; the decode step's host ms, device ms
      and idle share over 200 replays, each bucket's prefill and capture
      ms; 16 greedy requests through 8 slots against 1 slot (tokens/s must
      exceed 1.3x); the 200 replays and the 16 requests again beside a
      thread spinning in Python, with the Python->torch calls a decode
      step counted (``serving/engine.py:TorchCalls``: at most 4, the
      replay and the result copy included) and every token held against
      ``generate``; the CLI server as a subprocess driven by the CLI load
      generator (64 Poisson requests at 20/s, 0 errors, exit 0 on SIGTERM),
      then one ``loadgen --spawn-server`` drill. l. the same steps but the
      timing, TCP and throughput on path c's char GRU (16 requests); m. an
      attention LM at path e's widths (dim 512, 4 heads, depth 2, max_len
      512) from a seed, written as a port checkpoint, 16 requests, and its
      decode step's timing.
   r. serving's telemetry and chaos, then the fleet (``phase_fleet_telemetry``,
      after ``phase_serving``, whose path k it serves; no RNN or flash
      kernel launched): r.1 the CLI server with ``--metrics --live 0
      --live-port-file --slo qos=normal:p95_ms=<2x k's TCP latency p95>
      --slo-windows 5,30`` under the CLI loadgen (64 Poisson requests at
      20/s, a quarter traced): 0 errors, exit 0 on SIGTERM, the sidecar's
      step, prefill and request events, ``obs summarize`` counting the
      loadgen's done requests, ``obs trace`` on a sampled trace (exit 0,
      a valid tree), ``/metrics`` serving the ``pdrnn_serving_*`` series;
      then ``run_step`` at 8 busy slots 200 times without and with the
      recorder and an armed fault schedule, in turns: host ms, device ms,
      Python->torch calls a step (at most 4).  r.2 ``loadgen
      --spawn-server "<k's flags> --faults step:40:stall:1.5 --metrics"``:
      the degradation window opens and closes, the server exits 0, the
      fault in its sidecar; then ``step:5:nan`` on an engine in this
      process: the in-flight requests fail cleanly, the next 16 have
      ``generate``'s tokens.  r.3 ``loadgen --spawn-fleet 3`` with k's flags
      behind the router, one replica SIGKILLed a third into 120 requests
      at 40/s: accounting OK, the window closed, a respawn, router exit 0;
      a trace across the router's and a replica's sidecars; every completed
      greedy request's tokens equal to ``generate``'s; each replica's card
      memory (``nvidia-smi``).  The three replicas share one card: no
      scaling figure.
   Paths a-f train on the device-resident step (CUDA-graph replays of the
   train step; INFO logging), so each kernel's launches count at each
   replay.  Each of a-f checks finite losses (a-d, f: and the perf line),
   that its kernels were launched and no others (c, f: one of each a
   layer a train step), and that the trained model's kernel path agrees
   with its plain path: fused vs scan logits (a-c, f; c and f also greedy
   tokens, or a near tie where they differ), flash vs dense logits (d, e).
   Each kernel's launches per train step come from the run's counts.
   Then the fast paths against the per-batch loop (``phase_graph``): on
   a-f two trainers from the same weights (``--no-validation``, 2
   epochs), the per-batch loop and the per-epoch graph path, end with the
   same loss history, parameters and Adam state bit for bit and the same
   launches (a and b at dropout 0 and 0.1, the others at 0); ``--fuse-run``
   on a-d and f through the CLI and on e through the trainer is within
   1e-5 of the per-epoch path's history with the same launches a step, and
   its graph's capture ms and replay ms a step are printed.
5. step profile: more epochs of each trained path (a-f), the per-batch
   loop and the graph path in turns (eager, graph, graph, eager, twice),
   timed on the host clock, and one epoch of each under ``torch.profiler``:
   device ms a step, the card's idle share of the step, the device copy
   kernels a step, the graphs' capture times, and the profiled epoch's
   launch counts held against the profile's count of each kernel; and
   one epoch of path f's model on its scan path in the per-batch loop
   (the Python loop over T), what its kernels replace.
6. timing: CUDA-event times of each kernel, its plain version and the
   library's call (cuDNN's LSTM or GRU, ``torch.nn.LSTM``/``torch.nn.GRU``;
   ``scaled_dot_product_attention`` forward for ``flash_fwd``, and for
   the backward kernels SDPA's whole backward, timed as the device time of
   its kernels under ``torch.profiler`` so that the host's pace does not
   count; timed here only, never called by the port) at each main shape
   (the RNN kernels at (1440, 32) and (256, 512); ``flash_dqkv`` beside
   the split route it replaced, on the same inputs), beside each kernel's
   bound; each kernel at one block (or one cluster), its serial floor; the
   LSTM and GRU forwards at 4, 8, 12 and 16 rows a block and storing no
   gates; the backwards that read saved gates beside the bound of that
   form; the LSTM cluster kernels
   on both sides of their f32 slices' fit and in bf16; and the cluster
   kernels' shapes at H=512 (CTAs and rows a cluster, clusters resident at once,
   waves, the LSTM slices' rows in shared memory); the LSTM forward's
   tensor-core kernel at one cluster of 8 .. 40 rows, and each bound by the
   pipe its products run on (TF32 tensor cores for the 3xTF32 kernels);
   the flash kernels on the model's (B, T, H, D) layout, each row naming
   the kernel its wrapper runs there, and the layout work left around one
   forward call.

Prints every phase's wall seconds on one line (``smoke phases (s)``), a
``{"kernels": [...]}`` line, and ends with ``{"ok": true, "device":
{...}}`` as its last line.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import re
import shlex
import signal
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
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
# (H, B) of the GRU register kernels' edges (H <= 32): a ragged last
# 4-row quad, the narrowest width, and widths that no 4 divides, where the
# backward's 3 x 32 padded contraction columns hold zero runs
GRU_EDGES = ((HIDDEN, 37), (1, 5), (13, 37), (30, 37))
# (H, B) of the LSTM kernels' edges beside the motion shapes: a ragged
# last 4-row tile, and the widest width of the one-block kernels (W_hh^T in
# shared memory, a ragged warp), also with a ragged tile
LSTM_EDGES = ((HIDDEN, 37), (110, 64), (110, 37))
# (H, B) of the LSTM cluster kernels' edges: the narrowest width over a
# cluster, widths that split unevenly over the 16 CTAs, both sides of the
# width where the f32 slice stops fitting in shared memory (forward 448 /
# 449, where the tensor-core kernel takes over; backward 464 / 465), ragged
# last tiles at 512 and the generate prefill's 8 prompts
LSTM_CLUSTER_EDGES = ((111, 37), (200, 64), (300, 37), (448, 37), (449, 37), (464, 37),
                      (465, 37), (CHAR_HIDDEN, 250), (CHAR_HIDDEN, 37),
                      (CHAR_HIDDEN, GENERATE_PROMPTS))
# the LSTM and GRU forwards' rows a block, timed at the motion shape to
# choose LSTM_FWD_BLOCK_B and GRU_FWD_BLOCK_B
FWD_TILES = (4, 8, 12, 16)
# the kernels whose ptxas report must show no stack frame and no spills,
# every instance (dtype, variant)
NO_STACK_KERNELS = ("gru_fwd_cluster_kernel", "gru_fwd_reg_kernel", "gru_bwd_reg_kernel",
                    "lstm_fwd_kernel", "lstm_fwd_cluster_kernel", "lstm_fwd_tc_kernel",
                    "lstm_bwd_reg_kernel", "lstm_bwd_cluster_kernel", "flash_dqkv_tc_kernel",
                    "flash_fwd_f32_tc_kernel")
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
PROFILE_ROUNDS = 2  # eager, graph, graph, eager epochs a round (phase 6)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM, bf16 on the tensor cores, dense
TF32_FLOPS_PER_S = 495e12  # H100 SXM, TF32 on the tensor cores, dense
# the tensor-core kernels: the bf16 flash_fwd_tc_kernel, flash_dq_tc_kernel,
# flash_dkv_tc_kernel and the float32 3xTF32 flash_fwd_f32_tc_kernel (one
# instance per padded head dim 16, 32, 64, 128), the 3xTF32
# flash_dqkv_tc_kernel (16, 32, 64) and lstm_fwd_tc_kernel (8, 16, 24, 32,
# 40 rows a cluster)
N_TENSOR_CORE_KERNELS = 24
REPLACES = {
    "lstm_fwd": "pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:100",
    "lstm_bwd": "pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:166",
    "gru_fwd": "pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:375",
    "gru_bwd": "pytorch_distributed_rnn_tpu/ops/pallas_rnn.py:422",
    "flash_fwd": "pytorch_distributed_rnn_tpu/ops/pallas_attention.py:108",
    "flash_dq": "pytorch_distributed_rnn_tpu/ops/pallas_attention.py:230",
    "flash_dkv": "pytorch_distributed_rnn_tpu/ops/pallas_attention.py:266",
    "flash_dqkv": "pytorch_distributed_rnn_tpu/ops/pallas_attention.py:230,266",
}
SOURCES = {name: f"pytorch_distributed_rnn_tpu_torch/csrc/{name}.cu" for name in REPLACES}
# the forward's rows a block (csrc/flash_fwd.cu: 16 kF32FwdWarps in float32,
# kBlockM in bf16), the serial floor's tile
FWD_BLOCK_ROWS = {torch.float32: 128, torch.bfloat16: 64}
# the flash kernel each (wrapper, dtype) of the main paths runs
FLASH_KERNELS = {
    ("flash_fwd", torch.float32): "flash_fwd_f32_tc_kernel",
    ("flash_fwd", torch.bfloat16): "flash_fwd_tc_kernel",
    ("flash_dq", torch.bfloat16): "flash_dq_tc_kernel",
    ("flash_dkv", torch.bfloat16): "flash_dkv_tc_kernel",
    ("flash_dqkv", torch.float32): "flash_dqkv_tc_kernel",
}
for _name in ("flash_dq", "flash_dkv", "flash_dqkv"):
    SOURCES[_name] = "pytorch_distributed_rnn_tpu_torch/csrc/flash_bwd.cu"


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
    and check in the SASS that the tensor-core kernels (``*_tc_kernel``: the
    bf16 flash kernels, the 3xTF32 ``flash_dqkv`` and LSTM forward) hold
    HMMA and the others (the split f32 flash and the other RNN kernels) do
    not."""
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
    if any(checked.count(name) < 2 for name in NO_STACK_KERNELS):  # two instances at least
        raise RuntimeError(f"ptxas reported {checked}, not every instance of {NO_STACK_KERNELS}")
    hmma = {}
    for source in sorted(libs):
        counts = _hmma_counts(libs[source])
        print(f"  HMMA instructions in {source}: {counts}")
        hmma.update(counts)
    tc = {name: n for name, n in hmma.items() if "_tc_kernel" in name}
    if len(tc) != N_TENSOR_CORE_KERNELS or not all(tc.values()):
        raise RuntimeError(f"the tensor-core kernels are not all on the tensor cores: {tc}")
    if others := {name: n for name, n in hmma.items() if name not in tc and n}:
        raise RuntimeError(f"kernels other than the tensor-core kernels hold HMMA: {others}")


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
    edges = (*LSTM_EDGES, *LSTM_CLUSTER_EDGES) if cell == "lstm" else (*GRU_EDGES,
                                                                      *GRU_CLUSTER_EDGES)
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
    saves_gates = getattr(fr, f"{cell}_saves_gates")(hidden)
    if (got[-1] is not None) != saves_gates:
        failures.append(f"{cell}_fwd {dtype} {label}: saved gates {got[-1] is not None}")
    # h_all (and the LSTM's c_all), and the gates where saved
    n_out = (2 if cell == "lstm" else 1) + saves_gates
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
        args = (x_proj, want[0], h0, w, b, dh_all, dh_t, want[1] if saves_gates else None)
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
        # flash_dqkv's edges: ragged chunks and keys, rows not 16-byte aligned
        # (element copies), causal with an offset; its widest head dim
        ("short ragged causal", 16, 77, 100, 30, True, 40, 0, True),
        ("D=64", 16, SEQ_LEN, SEQ_LEN, 64, False, 0, 0, True),
    ]


def _flash_inputs(bh, t_q, t_k, d, dtype, seed, layout="flat"):
    """O(1) random q, k, v and dO of BH heads on the card: (B*H, T, D)
    (``flat``), or in the kernels' (B, T, H, D) layout (``projection``, H =
    4 where it divides BH, else 1): q, k and v views of (B, T, H*D)
    projections as the model's ``_split_heads`` leaves them, dO the view of
    (B, H, T, D) storage (each tensor is read by its own strides)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    heads = 4 if bh % 4 == 0 else 1

    def rand(t, by_head=False):
        if layout == "flat":
            return torch.randn((bh, t, d), generator=gen, device="cuda").to(dtype)
        if by_head:
            x = torch.randn((bh // heads, heads, t, d), generator=gen, device="cuda")
            return x.to(dtype).transpose(1, 2)
        x = torch.randn((bh // heads, t, heads * d), generator=gen, device="cuda")
        return x.to(dtype).view(bh // heads, t, heads, d)

    return rand(t_q), rand(t_k), rand(t_k), rand(t_q, by_head=True)


def _check_lse(got, want, tol, label, failures, quiet=False):
    """lse is float32 in both dtypes: -inf in the same places, elementwise
    tolerance elsewhere."""
    finite = torch.isfinite(want)
    same = torch.equal(torch.isneginf(got), torch.isneginf(want))
    err = _scaled_err(got[finite], want[finite]) if finite.any() else 0.0
    ok = same and err <= tol and bool(torch.isfinite(got[finite]).all())
    if not quiet or not ok:
        print(f"flash_fwd lse {label}: scaled_err={err:.3e} -inf rows equal={same} tol={tol:g} "
              f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"flash_fwd lse {label}")


def _check_dqkv(args, kw, tol, label, failures) -> float:
    """``flash_dqkv`` against its plain version, and a second launch
    bitwise equal to the first; returns the max abs error."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_attention as fa

    got = fa.flash_dqkv(*args, **kw)
    again = fa.flash_dqkv(*args, **kw)
    err = _report("flash_dqkv", torch.float32, label, got, fa.flash_dqkv_plain(*args, **kw), tol,
                  failures)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"flash_dqkv float32 {label}: two launches bitwise equal={same}")
    if not same:
        failures.append(f"flash_dqkv {label}: two launches differ")
    return err


# the f32 forward's edges (forward only): T around the 64-key tile and the
# 128-row block, D padded to 16, 32, 64, 128 and rows not 16-byte aligned
# (D = 1, 31, 100), each unmasked, causal with offsets, and a chunk that
# sees no key
F32_FWD_EDGE_T = (1, 63, 64, 65, 128, 200, 1024)
F32_FWD_EDGE_D = (1, 8, 31, 32, 64, 100, 128)
F32_FWD_EDGE_MASKS = ((False, 0, 0), (True, 37, 5), (True, 0, None))  # None: k_off = T


def _f32_fwd_edges(failures):
    """The f32 forward against its plain version at its edges, on the
    (B, T, H, D) layout."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_attention as fa

    worst = 0.0
    for t in F32_FWD_EDGE_T:
        for d in F32_FWD_EDGE_D:
            for causal, q_off, k_off in F32_FWD_EDGE_MASKS:
                kw = dict(causal=causal, q_offset=q_off, k_offset=t if k_off is None else k_off)
                q, k, v, _ = _flash_inputs(8, t, t, d, torch.float32, seed=t + d,
                                           layout="projection")
                o, lse = fa.flash_fwd(q, k, v, **kw)
                o_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
                err = _scaled_err(o, o_p)
                worst = max(worst, err)
                label = f"f32 forward edge T={t} D={d} {kw}"
                if err > TOLERANCES[torch.float32][0] or o.stride() != q.stride():
                    failures.append(f"flash_fwd {label}: scaled_err={err:.3e}")
                _check_lse(lse, lse_p, TOLERANCES[torch.float32][0], label, failures, quiet=True)
    print(f"flash_fwd float32 edges: {len(F32_FWD_EDGE_T) * len(F32_FWD_EDGE_D)} (T, D) x "
          f"{len(F32_FWD_EDGE_MASKS)} masks on the (B, T, H, D) layout, worst scaled_err="
          f"{worst:.3e} tol={TOLERANCES[torch.float32][0]:g}")


def phase_flash_kernels() -> dict:
    """The flash kernels against their plain versions on (B*H, T, D) rows
    and on the (B, T, H, D) layout; returns the max abs errors at the two
    main shapes (CLI f32, long context bf16) on the model's layout."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_attention as fa

    main_errs = {}
    failures = []
    main_shapes = {
        torch.float32: _flash_shape(ATTN_BATCH * ATTN_HEADS, SEQ_LEN, ATTN_DIM // ATTN_HEADS,
                                    torch.float32),
        torch.bfloat16: _flash_shape(LONG_BATCH * LONG_HEADS, LONG_T, LONG_DIM // LONG_HEADS,
                                     torch.bfloat16),
    }
    for (dtype, (tol_f, tol_b)), layout in ((a, b) for a in TOLERANCES.items()
                                            for b in ("flat", "projection")):
        for label, bh, t_q, t_k, d, causal, q_off, k_off, backward in _flash_cases(dtype):
            kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
            full = f"{label} BH={bh} Tq={t_q} Tk={t_k} D={d} {layout}"
            q, k, v, do = _flash_inputs(bh, t_q, t_k, d, dtype, seed=bh + t_q + d, layout=layout)
            o, lse = fa.flash_fwd(q, k, v, **kw)
            o_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
            errs = {"flash_fwd": _report("flash_fwd", dtype, full, (o,), (o_p,), tol_f, failures)}
            _check_lse(lse, lse_p, TOLERANCES[torch.float32][0], full, failures)
            if label == "no visible key" and not (torch.equal(o, torch.zeros_like(o))
                                                  and bool(torch.isneginf(lse).all())):
                failures.append(f"flash_fwd {dtype} {full}: o != 0 or lse != -inf")
            if o.stride() != q.stride():
                failures.append(f"flash_fwd {dtype} {full}: o not in q's layout")
            if backward:
                delta = fa._delta(do, o_p)
                args = (q, k, v, do, lse_p, delta)
                errs["flash_dq"] = _report("flash_dq", dtype, full, (fa.flash_dq(*args, **kw),),
                                           (fa.flash_dq_plain(*args, **kw),), tol_b, failures)
                errs["flash_dkv"] = _report("flash_dkv", dtype, full, fa.flash_dkv(*args, **kw),
                                            fa.flash_dkv_plain(*args, **kw), tol_b, failures)
                if fa.flash_bwd_route(t_q, t_k, d, dtype) == "dqkv":
                    errs["flash_dqkv"] = _check_dqkv((q, k, v, o_p, do, lse_p), kw, tol_b, full,
                                                     failures)
            shape = _flash_shape(bh, t_q, d, dtype)
            if shape == main_shapes[dtype] and backward and not causal and layout != "flat":
                main_errs.update({(name, shape): err for name, err in errs.items()})
    _f32_fwd_edges(failures)
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
    from pytorch_distributed_rnn_tpu_torch.parallel import launch

    launch.reset_launch_counts()


def _launch_counts() -> dict:
    from pytorch_distributed_rnn_tpu_torch.parallel import launch

    return launch.launch_counts()


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


def _check_flash_path(name, trainer, launches, steps, eval_forwards, batch, backward):
    """``flash_fwd`` and the ``backward`` kernels launched and no others;
    launches per train step from the counts: every train step runs each
    block's forward and each backward kernel once; ``eval_forwards`` block
    calls ran forward only."""
    kernels = ("flash_fwd", *backward)
    for kernel, count in launches.items():
        if kernel in kernels and count <= 0:
            raise RuntimeError(f"{name}: main path never launched kernel {kernel}")
        if kernel not in kernels and count != 0:
            raise RuntimeError(f"{name}: main path launched {kernel} {count} times")
    train_fwd = launches["flash_fwd"] - eval_forwards
    if any(launches[kernel] != train_fwd for kernel in backward):
        raise RuntimeError(f"{name}: train-step forwards {train_fwd}, backward launches "
                           f"{ {kernel: launches[kernel] for kernel in backward} }")
    per_step = {kernel: launches[kernel] / steps for kernel in kernels}
    per_step["flash_fwd"] = train_fwd / steps
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
                            evaluations * len(trainer.model.blocks), ATTN_BATCH, ("flash_dqkv",))
    x = torch.from_numpy(trainer.test_set.features[:64]).cuda()
    flash = _flash_vs_dense(trainer.model, x, LOGIT_TOL, "attention")
    if flash.shape != (64, 6):
        raise RuntimeError(f"attention: logits of shape {tuple(flash.shape)}")
    return run


# ---------------------------------------------------------------------------
# serving (paths k, l, m)

SERVE_SLOTS = 8
SERVE_BUCKETS = "16,32,64,128"
SERVE_MAX_NEW = 128
SERVE_TIMING_REPLAYS = 200
SERVE_PREFILL_REPLAYS = 20
SERVE_BATCH_GAIN = 1.3  # batched tokens/s over serial (JAX tests/test_serving.py:165)
SERVE_STEP_CALLS = 4  # Python->torch calls a decode step on the card, the replay and copy included
SERVE_THROUGHPUT_REQUESTS, SERVE_THROUGHPUT_TOKENS = 16, 32
SERVE_TCP = ["--requests", "64", "--rate", "20", "--prompt-len-min", "2",
             "--prompt-len-max", "64", "--new-tokens-min", "16", "--new-tokens-max", "128",
             "--temperature", "0.8", "--sampled-fraction", "0.5", "--seed", "0"]
SERVE_DRILL = ["--requests", "32", "--rate", "20", "--prompt-len-max", "64",
               "--new-tokens-max", "64", "--seed", "1"]
SERVE_PROCESS_TIMEOUT = 300
ATTN_LM_ARGS = ["--model", "attention", "--hidden-units", "512", "--num-heads", "4",
                "--stacked-layer", "2", "--max-len", "512"]


def _serve_args(name: str, checkpoint: Path) -> list:
    """The serve CLI's model flags of path ``name``."""
    if name == "m":
        return ["--checkpoint", str(checkpoint), *ATTN_LM_ARGS]
    cell = "gru" if name == "l" else "lstm"
    return ["--checkpoint", str(checkpoint), "--model", "char", "--cell", cell,
            "--hidden-units", str(CHAR_HIDDEN), "--stacked-layer", "2"]


def _serve_engine(model, slots: int = SERVE_SLOTS, buckets: str = SERVE_BUCKETS):
    from pytorch_distributed_rnn_tpu_torch.serving.adapters import adapter_for
    from pytorch_distributed_rnn_tpu_torch.serving.buckets import BucketSpec
    from pytorch_distributed_rnn_tpu_torch.serving.engine import ServingEngine

    return ServingEngine(adapter_for(model), num_slots=slots,
                         bucket_spec=BucketSpec.parse(buckets), max_new_tokens=SERVE_MAX_NEW)


def _serve_requests(windows: np.ndarray, n: int, seed: int) -> list:
    """``n`` mixed requests: prompts of 1-128 tokens cut from ``windows``,
    1-128 new tokens, temperatures 0 / 0.7 / 1.0 in turn, distinct seeds."""
    from pytorch_distributed_rnn_tpu_torch.serving.scheduler import ServeRequest

    rng = np.random.RandomState(seed)
    requests = []
    for i in range(n):
        row = windows[i % len(windows)]
        length = int(rng.randint(1, 129))
        start = int(rng.randint(0, len(row) - length + 1))
        requests.append(ServeRequest(
            prompt=[int(t) for t in row[start:start + length]],
            max_new_tokens=int(rng.randint(1, SERVE_MAX_NEW + 1)),
            temperature=(0.0, 0.7, 1.0)[i % 3], seed=seed * 1000 + i, id=str(i)))
    return requests


def _generate_first_logits(model, prompt, length: int):
    """The logits ``generate`` draws its first token from (its prefill)."""
    from pytorch_distributed_rnn_tpu_torch.models.attention_lm import attention_prefill
    from pytorch_distributed_rnn_tpu_torch.ops.rnn import head_logits, stacked_rnn

    with torch.no_grad():
        if hasattr(model, "rnn"):
            outputs, _ = stacked_rnn(list(model.rnn), model.embed[prompt.long()], model.cell,
                                     impl=model.impl)
            return head_logits(model.head, outputs[:, -1, :])
        return attention_prefill(model, prompt, prompt.shape[1] + length)[2][:, -1]


def _check_served_tokens(name: str, model, requests: list, first_logits, device) -> dict:
    """Every request's tokens against its single-request ``generate`` on
    the same device: a differing token fails unless greedy at a near tie
    (top-2 logit gap below ``LOGIT_TOL`` at the first differing step).
    With ``first_logits`` (by seed), also the largest difference of the
    served first-step logits from ``generate``'s."""
    worst, ties, tokens = 0.0, [], 0
    for r in requests:
        prompt = torch.tensor([r.prompt], device=device)
        generator = torch.Generator(device=device).manual_seed(r.seed)
        out = model.generate(prompt, r.max_new_tokens, generator=generator,
                             temperature=r.temperature)
        want = out[0, len(r.prompt):].tolist()
        if r.status != "done" or len(r.tokens) != r.max_new_tokens:
            raise RuntimeError(f"{name}: request {r.id} ended {r.status}: {r.error}")
        if first_logits is not None:
            worst = max(worst, _max_err(
                first_logits[r.seed], _generate_first_logits(model, prompt, r.max_new_tokens)[0]))
        tokens += len(want)
        if r.tokens == want:
            continue
        step = next(i for i, (a, b) in enumerate(zip(r.tokens, want)) if a != b)
        with torch.no_grad():
            logits = model(out[:, :-1])[0, len(r.prompt) - 1 + step]
        gap = _top2_gap(logits).item()
        print(f"  {name}: request {r.id} (temperature {r.temperature}) differs from generate "
              f"at step {step}; top-2 logit gap there {gap:.3e}")
        if r.temperature != 0.0 or gap >= LOGIT_TOL:
            raise RuntimeError(f"{name}: request {r.id} diverged from its single-request "
                               "generate")
        ties.append((r.id, step, gap))
    logits = ("" if first_logits is None else "; largest first-step logit difference, batched "
              f"prefill vs generate: {worst:.3e}")
    print(f"  {name}: {len(requests)} requests, {tokens} tokens equal to generate's "
          f"(near greedy ties: {ties}){logits}")
    return {"first_logit_max_abs_diff": worst, "near_ties": ties, "tokens": tokens}


def _serve_timing(name: str, engine) -> dict:
    """The decode step (replay + the (tok, ok) copy) over
    ``SERVE_TIMING_REPLAYS`` replays: host ms after a sync, device ms
    under ``torch.profiler`` (kernels, copies and sets), idle share; each
    bucket's prefill ms (a full-bucket prompt through the engine's
    prefill: its copies and the replay) and capture ms."""

    from pytorch_distributed_rnn_tpu_torch.serving.engine import TorchCalls

    def step():
        engine._advance([])

    def host_ms_a_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_TIMING_REPLAYS):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / SERVE_TIMING_REPLAYS

    with torch.no_grad():
        step()
        host_ms = host_ms_a_step()
        with _Spinner():
            spin_host_ms = host_ms_a_step()
        with TorchCalls(engine) as calls:
            for _ in range(SERVE_TIMING_REPLAYS):
                step()
        calls_a_step = {k: v / SERVE_TIMING_REPLAYS for k, v in calls.counts.items()}
        with _device_profile() as prof:
            for _ in range(SERVE_TIMING_REPLAYS):
                step()
            torch.cuda.synchronize()
        events = _device_events(prof)
        device_ms = sum(e.self_device_time_total for e in events) / 1e3 / SERVE_TIMING_REPLAYS
        prefill = {}
        for bucket in engine.buckets.prompt_buckets:
            prompt = [1] * bucket
            engine._prefill(prompt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SERVE_PREFILL_REPLAYS):
                engine._prefill(prompt)
            torch.cuda.synchronize()
            prefill[bucket] = {
                "ms": (time.perf_counter() - t0) * 1e3 / SERVE_PREFILL_REPLAYS,
                "capture_ms": engine.graphs[("prefill", bucket)].capture_s * 1e3}
    step_capture_ms = engine.graphs[("step",)].capture_s * 1e3
    kernels = sum(e.count for e in events) / SERVE_TIMING_REPLAYS
    result = {"step_host_ms": host_ms, "step_host_ms_spinner": spin_host_ms,
              "step_calls": calls_a_step, "step_device_ms": device_ms,
              "idle": 1.0 - device_ms / host_ms, "step_capture_ms": step_capture_ms,
              "device_events_a_step": kernels, "prefill": prefill}
    print(f"  {name}: decode step at {engine.batcher.num_slots} slots over "
          f"{SERVE_TIMING_REPLAYS} replays: host {host_ms:.4f} ms, device {device_ms:.4f} ms "
          f"({kernels:g} device events), card idle {100 * result['idle']:.1f}%; capture "
          f"{step_capture_ms:.1f} ms")
    total = sum(calls_a_step.values())
    print(f"  {name}: decode step beside a thread spinning in Python: host {spin_host_ms:.4f} "
          f"ms (alone {host_ms:.4f}); Python->torch calls a step {calls_a_step} = {total:g} "
          f"(at most {SERVE_STEP_CALLS})")
    if total > SERVE_STEP_CALLS:
        raise RuntimeError(f"{name}: {total:g} Python->torch calls a decode step")
    for bucket, t in prefill.items():
        print(f"  {name}: prefill bucket {bucket}: {t['ms']:.4f} ms a call (host clock), "
              f"capture {t['capture_ms']:.1f} ms")
    _print_top(events, SERVE_TIMING_REPLAYS)
    return result


class _Spinner:
    """A thread that runs Python and never blocks, and touches nothing of
    the engine, while the block runs: it takes the interpreter lock from
    the engine thread at each Python->torch call for up to a switch
    interval."""

    def __enter__(self):
        self.stop = threading.Event()

        def spin():
            n = 0
            while not self.stop.is_set():
                n += 1

        self.thread = threading.Thread(target=spin, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=10)


def _throughput(model, windows: np.ndarray, slots: int, spin: bool = False) -> dict:
    """Tokens/s of 16 greedy requests (prompts of 2-15 tokens, 32 new
    tokens each) through ``slots`` slots, warm-up excluded; with ``spin``
    beside a spinning thread, the engine's Python->torch calls counted by
    phase and every request's tokens held against its ``generate``."""
    from pytorch_distributed_rnn_tpu_torch.serving.engine import TorchCalls
    from pytorch_distributed_rnn_tpu_torch.serving.scheduler import ServeRequest

    rng = np.random.RandomState(7)
    engine = _serve_engine(model, slots=slots, buckets="16")
    engine.warmup()
    requests = []
    for i in range(SERVE_THROUGHPUT_REQUESTS):
        length = int(rng.randint(2, 16))
        requests.append(ServeRequest(prompt=[int(t) for t in windows[i, :length]],
                                     max_new_tokens=SERVE_THROUGHPUT_TOKENS, id=str(i)))
    torch.cuda.synchronize()
    with _Spinner() if spin else contextlib.nullcontext(), torch.no_grad(), \
            TorchCalls(engine) as calls:
        t0 = time.perf_counter()
        for r in requests:
            engine.submit(r)
        engine.drain()
        elapsed = time.perf_counter() - t0
    if not all(r.status == "done" for r in requests):
        raise RuntimeError(f"throughput run at {slots} slots: requests failed")
    steps = engine.stats()["steps"]
    result = {"tokens_per_s": sum(len(r.tokens) for r in requests) / elapsed,
              "steps": steps, "calls": dict(calls.counts)}
    if spin:
        device = model.embed.device
        for r in requests:
            want = model.generate(torch.tensor([r.prompt], device=device),
                                  r.max_new_tokens, temperature=0.0)[0, len(r.prompt):].tolist()
            if r.tokens != want:
                raise RuntimeError(f"request {r.id} beside the spinner diverged from generate")
        per_step = sum(calls.counts[k] for k in ("draw", "step", "result")) / steps
        if per_step > SERVE_STEP_CALLS:
            raise RuntimeError(f"{per_step:g} Python->torch calls a decode step")
        result["calls_a_step"] = per_step
        result["calls_a_join"] = calls.counts["join"] / len(requests)
    return result


def _serve_subprocess(args: list, timeout: int = SERVE_PROCESS_TIMEOUT):
    return subprocess.run([sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.serving",
                           *args], cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def _serve_over_tcp(workdir: Path, serve_args: list) -> dict:
    """The CLI server as a subprocess, driven by the CLI load generator
    (``--connect``), stopped with SIGTERM; then one ``--spawn-server``
    drill.  Errors must be 0 and the server must exit 0 both times."""
    from pytorch_distributed_rnn_tpu_torch.serving.drill import spawn_server

    report_path = workdir / "serve-report.json"
    t0 = time.perf_counter()
    with spawn_server([*serve_args, "--slots", str(SERVE_SLOTS)],
                      ready_timeout_s=SERVE_PROCESS_TIMEOUT) as (host, port, proc):
        ready_s = time.perf_counter() - t0
        load = _serve_subprocess(["loadgen", "--connect", f"{host}:{port}", *SERVE_TCP,
                                  "--report", str(report_path)])
    print(load.stdout.strip())
    report = json.loads(report_path.read_text())
    print(f"  tcp: server ready in {ready_s:.1f} s; loadgen exit {load.returncode}; "
          f"{report['tokens_per_s']:.1f} tokens/s, ttft ms p50 {report['ttft_ms']['p50']} p95 "
          f"{report['ttft_ms']['p95']}, latency ms p50 {report['latency_ms']['p50']} p95 "
          f"{report['latency_ms']['p95']}, shed {report['shed']}, errors {report['errors']}; "
          f"server exit on SIGTERM {proc.returncode}")
    if report["errors"] != 0 or report["done"] + report["shed"] != report["requests"]:
        raise RuntimeError(f"tcp: {report['errors']} errors: {report['error_samples']}"
                           f"\n{load.stderr[-4000:]}")
    if proc.returncode != 0:
        raise RuntimeError(f"tcp: the server exited {proc.returncode} on SIGTERM")
    drill_path = workdir / "serve-drill.json"
    drill = _serve_subprocess(["loadgen", "--spawn-server", shlex.join(serve_args), *SERVE_DRILL,
                               "--report", str(drill_path)])
    drill_report = json.loads(drill_path.read_text()) if drill_path.exists() else None
    print(drill.stdout.strip())
    if drill_report is None or drill_report["errors"] != 0 or drill_report["server_exit"] != 0:
        raise RuntimeError(f"drill failed (exit {drill.returncode}):\n{drill.stderr[-4000:]}")
    return {"report": {k: report[k] for k in ("requests", "done", "shed", "errors", "wall_s",
                                              "tokens", "tokens_per_s", "latency_ms",
                                              "ttft_ms", "queue_ms")},
            "loadgen_exit": load.returncode, "ready_s": ready_s,
            "drill": {k: drill_report[k] for k in ("done", "shed", "errors", "tokens_per_s",
                                                   "server_exit")}}


def _spy_first_logits(engine) -> dict:
    """Keep each join's prefill logits (by the request's seed): the
    logits a served request draws its first token from."""
    first_logits = {}
    join = engine._join

    def spy(slot, seq_state, seq_logits, length, temperature, seed):
        first_logits[seed] = seq_logits[0].clone()
        join(slot, seq_state, seq_logits, length, temperature, seed)

    engine._join = spy
    return first_logits


def _serve_path(name: str, serve_args: list, windows: np.ndarray, n_requests: int,
                seed: int) -> tuple:
    """Steps 1-4 of a serving path: the CLI's loader, an engine of 8 slots
    warmed up, ``n_requests`` mixed requests, drained; tokens against
    ``generate``, captures 4 + 1 + 1 and none added, no kernel launched."""
    from pytorch_distributed_rnn_tpu_torch.serving import cli

    _reset_launch_counts()
    model, _ = cli.load_served_model(cli.build_serve_parser().parse_args(serve_args))
    engine = _serve_engine(model)
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    snapshot = engine.retrace_snapshot()
    want = {"prefill": len(SERVE_BUCKETS.split(",")), "step": 1, "join": 1}
    if snapshot != want:
        raise RuntimeError(f"{name}: captures after warm-up {snapshot}, not {want}")
    first_logits = _spy_first_logits(engine)
    requests = _serve_requests(windows, n_requests, seed)
    t0 = time.perf_counter()
    for r in requests:
        if not engine.submit(r):
            raise RuntimeError(f"{name}: request {r.id} refused: {r.error}")
    engine.drain()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    added = engine.retraces_since(snapshot)
    if added:
        raise RuntimeError(f"{name}: the request stream captured {added}")
    served = sum(len(r.tokens) for r in requests)
    print(f"  {name}: warm-up (captures {snapshot}) {warmup_s:.2f} s; {n_requests} requests, "
          f"{served} tokens in {serve_s:.3f} s ({served / serve_s:.1f} tokens/s); no capture "
          "after warm-up")
    check = _check_served_tokens(name, model, requests, first_logits, model.embed.device)
    launches = {k: v for k, v in _launch_counts().items() if v}
    if launches:
        raise RuntimeError(f"{name}: serving launched the port's kernels: {launches}")
    print(f"  {name}: no RNN or flash kernel launched (counts all 0)")
    return model, engine, {"warmup_s": warmup_s, "serve_s": serve_s, "tokens": served, **check}


def phase_serving(workdir: Path, runs: dict) -> dict:
    """Paths k, l, m: the port's serving on the card, from path f's and
    c's trained checkpoints and a seeded attention LM at path e's widths."""
    from pytorch_distributed_rnn_tpu_torch.models import AttentionLM
    from pytorch_distributed_rnn_tpu_torch.training.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    windows = runs["char_lstm"].trainer.test_set.features
    results = {}

    print("serving path k: char LSTM, H=512, 2 layers (path f's checkpoint)")
    k_args = _serve_args("k", workdir / "models-char-lstm")
    model, engine, results["k"] = _serve_path("k", k_args, windows, 32, seed=1)
    results["k"]["timing"] = _serve_timing("k", engine)
    del engine
    serial = _throughput(model, windows, 1)["tokens_per_s"]
    batched = _throughput(model, windows, SERVE_SLOTS)["tokens_per_s"]
    print(f"  k: {SERVE_THROUGHPUT_REQUESTS} greedy requests x {SERVE_THROUGHPUT_TOKENS} tokens: "
          f"{batched:.1f} tokens/s at {SERVE_SLOTS} slots, {serial:.1f} at 1 slot "
          f"({batched / serial:.2f}x; must exceed {SERVE_BATCH_GAIN}x)")
    if batched <= SERVE_BATCH_GAIN * serial:
        raise RuntimeError("k: continuous batching did not beat serial decode")
    spun = _throughput(model, windows, SERVE_SLOTS, spin=True)
    print(f"  k: the same {SERVE_THROUGHPUT_REQUESTS} requests at {SERVE_SLOTS} slots beside a "
          f"thread spinning in Python: {spun['tokens_per_s']:.1f} tokens/s (alone "
          f"{batched:.1f}), {spun['steps']} steps, Python->torch calls {spun['calls']}: "
          f"{spun['calls_a_step']:g} a decode step (at most {SERVE_STEP_CALLS}), "
          f"{spun['calls_a_join']:g} a join; every token equal to generate's")
    results["k"]["throughput"] = {"batched": batched, "serial": serial, "spinner": spun}
    del model
    results["k"]["tcp"] = _serve_over_tcp(workdir, k_args)

    print("serving path l: char GRU, H=512, 2 layers (path c's checkpoint)")
    _, _, results["l"] = _serve_path("l", _serve_args("l", workdir / "models-char-gru"),
                                     windows, 16, seed=2)

    print("serving path m: attention LM, dim 512, 4 heads, depth 2, max_len 512 (seeded)")
    lm = AttentionLM(vocab_size=256, dim=512, depth=2, num_heads=4, max_len=512,
                     generator=torch.Generator().manual_seed(0))
    save_checkpoint(workdir / "models-attention-lm", 0, lm.state_dict(), {}, 0.0)
    _, engine, results["m"] = _serve_path("m", _serve_args("m", workdir / "models-attention-lm"),
                                          windows, 16, seed=3)
    results["m"]["timing"] = _serve_timing("m", engine)
    results["seconds"] = time.perf_counter() - t0
    print(f"serving phase: {results['seconds']:.1f} s")
    print("serving: " + json.dumps(results))
    return results


# serving's telemetry and chaos, and the serving fleet (path r)

R_TRACE_SAMPLE = "0.25"
R_SLO_WINDOWS = "5,30"
R_SLO_OVER_K = 2.0  # r's SLO p95: this many times path k's measured TCP latency p95
R_COST_ROUNDS = 4  # rounds of (off, on, on, off) turns of the decode step's cost
R_STALL, R_STALL_S = "step:40:stall:1.5", 1.5
R_NAN_STEP = 5
R_FLEET = 3
R_FLEET_REQUESTS, R_FLEET_RATE = 120, 40.0
R_ROUTER = ["--retries", "2", "--eject-after", "2", "--cooldown-s", "0.5",
            "--health-every-s", "0.2", "--live", "127.0.0.1:0", "--trace-sample", "1.0"]
R_FLEET_LOAD = ["--prompt-len-min", "2", "--prompt-len-max", "64", "--new-tokens-min", "8",
                "--new-tokens-max", "64", "--temperature", "0.8", "--sampled-fraction", "0.5",
                "--seed", "2"]
R_SERVING_SERIES = ("pdrnn_serving_requests_total", "pdrnn_serving_tokens_total",
                    "pdrnn_serving_latency_seconds", "pdrnn_request_latency_seconds_bucket")


def _event_counts(path: Path) -> dict:
    """A sidecar family's events by kind (spans by ``span:<name>``)."""
    from pytorch_distributed_rnn_tpu_torch.obs.summary import load_events, rank_files

    counts = {}
    for member in rank_files(path):
        for event in load_events(member):
            kind = event.get("kind")
            key = f"span:{event.get('name')}" if kind == "span" else kind
            counts[key] = counts.get(key, 0) + 1
    return counts


def _scrape(url: str, want: tuple, timeout_s: float = 20.0) -> str:
    """GET ``url`` until its body names every series in ``want``."""
    import urllib.request

    deadline, body = time.monotonic() + timeout_s, ""
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=5.0) as resp:
                body = resp.read().decode()
            if all(name in body for name in want):
                return body
        except OSError:
            pass
        time.sleep(0.5)
    missing = [name for name in want if name not in body]
    raise RuntimeError(f"r: {url} never served {missing}")


def _trace_check(name: str, family: Path, trace_id: str | None = None,
                 cross: bool = False) -> dict:
    """The sidecar family's traces assembled and validated in process, and
    one of them (``trace_id``, or the first crossing processes) through the
    ``obs trace`` subcommand: exit 0 and the tree printed."""
    from pytorch_distributed_rnn_tpu_torch.obs.trace import assemble_traces, validate_trace_tree

    trees = assemble_traces([family])
    for tree in trees:
        validate_trace_tree(tree)
    crossing = [t for t in trees if len(t.processes) > 1]
    if trace_id is None:
        pool = [t for t in crossing if {"router", "serve"} <= {n.role for n in t.root.walk()}]
        if cross and not pool:
            raise RuntimeError(f"{name}: no trace crosses the router's and a replica's sidecars")
        trace_id = (pool or trees)[0].trace_id
    cli_run = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.obs", "trace", str(family),
         "--request", trace_id], cwd=ROOT, capture_output=True, text=True, timeout=120)
    if cli_run.returncode != 0 or f"trace {trace_id}" not in cli_run.stdout:
        raise RuntimeError(f"{name}: obs trace exit {cli_run.returncode}:\n"
                           f"{cli_run.stdout[-2000:]}{cli_run.stderr[-2000:]}")
    print(cli_run.stdout.rstrip())
    names = sorted({n.name for t in trees for n in t.root.walk()})
    print(f"  {name}: {len(trees)} traces assembled and valid ({len(crossing)} across "
          f"processes; spans {names}); obs trace --request {trace_id}: exit 0")
    return {"traces": len(trees), "crossing": len(crossing), "span_names": names,
            "trace_id": trace_id}


def _r_serve(workdir: Path, k_args: list, slo_ms: float) -> dict:
    """r.1: the CLI server with ``--metrics --live --slo`` under the CLI
    loadgen (64 Poisson requests at 20/s, a quarter traced)."""
    from pytorch_distributed_rnn_tpu_torch.obs.summary import load_events, summarize_file
    from pytorch_distributed_rnn_tpu_torch.serving.drill import spawn_server

    d = workdir / "r1"
    d.mkdir()
    sidecar, live_file, report_path = d / "serve.jsonl", d / "live.port", d / "report.json"
    serve_args = [*k_args, "--slots", str(SERVE_SLOTS), "--metrics", str(sidecar),
                  "--live", "0", "--live-port-file", str(live_file),
                  "--slo", f"qos=normal:p95_ms={slo_ms:g}", "--slo-windows", R_SLO_WINDOWS]
    t0 = time.perf_counter()
    with spawn_server(serve_args, ready_timeout_s=SERVE_PROCESS_TIMEOUT) as (host, port, proc):
        ready_s = time.perf_counter() - t0
        load = _serve_subprocess(["loadgen", "--connect", f"{host}:{port}", *SERVE_TCP,
                                  "--trace-sample", R_TRACE_SAMPLE, "--report",
                                  str(report_path)])
        lhost, lport = live_file.read_text().split()
        body = _scrape(f"http://{lhost}:{lport}/metrics", R_SERVING_SERIES)
    print(load.stdout.strip())
    report = json.loads(report_path.read_text())
    if report["errors"] != 0 or load.returncode != 0:
        raise RuntimeError(f"r.1: loadgen exit {load.returncode}, {report['errors']} errors: "
                           f"{report['error_samples']}\n{load.stderr[-4000:]}")
    if proc.returncode != 0:
        raise RuntimeError(f"r.1: the server exited {proc.returncode} on SIGTERM")
    counts = _event_counts(sidecar)
    done = report["done"]
    if not (counts.get("step", 0) > 0 and counts.get("span:prefill") == done
            and counts.get("request") == done and counts.get("run_summary") == 1):
        raise RuntimeError(f"r.1: sidecar events {counts} for {done} requests")
    summary = summarize_file(sidecar)
    if summary["requests"] != done:
        raise RuntimeError(f"r.1: obs summarize counts {summary['requests']} requests, the "
                           f"loadgen {done}")
    traced = next(e["trace"] for e in load_events(sidecar) if e.get("trace"))
    traces = _trace_check("r.1", sidecar, trace_id=traced)
    series = sorted({line.split("{")[0].split(" ")[0] for line in body.splitlines()
                     if line.startswith("pdrnn_serving_")})
    print(f"  r.1: server ready in {ready_s:.1f} s; {done} requests, 0 errors, exit 0 on "
          f"SIGTERM; sidecar {counts}; obs summarize requests {summary['requests']}; "
          f"latency ms p50 {report['latency_ms']['p50']} p95 {report['latency_ms']['p95']}, "
          f"ttft ms p95 {report['ttft_ms']['p95']}; /metrics series {series}")
    return {"ready_s": ready_s, "events": counts, "requests": done, "series": series,
            "latency_ms": report["latency_ms"], "ttft_ms": report["ttft_ms"],
            "tokens_per_s": report["tokens_per_s"], "trace": traces}


def _r_step_cost(workdir: Path, model) -> dict:
    """r.1: the decode step (``run_step`` at 8 busy slots: replay, result
    copy, token delivery) 200 times, without and with the recorder and an
    armed fault schedule that never fires, in turns (off, on, on, off),
    host ms on the host clock (each step ends in the result copy's sync),
    device ms under ``torch.profiler``; Python->torch calls a step with
    the recorder on."""
    from pytorch_distributed_rnn_tpu_torch.obs.recorder import NULL_RECORDER, MetricsRecorder
    from pytorch_distributed_rnn_tpu_torch.resilience.faults import FaultSchedule
    from pytorch_distributed_rnn_tpu_torch.serving.adapters import adapter_for
    from pytorch_distributed_rnn_tpu_torch.serving.buckets import BucketSpec
    from pytorch_distributed_rnn_tpu_torch.serving.engine import ServingEngine, TorchCalls
    from pytorch_distributed_rnn_tpu_torch.serving.scheduler import ServeRequest

    n = SERVE_TIMING_REPLAYS
    engine = ServingEngine(adapter_for(model), num_slots=SERVE_SLOTS,
                           bucket_spec=BucketSpec.parse("16"), max_new_tokens=n + 1)
    engine.warmup()
    recorder = MetricsRecorder(workdir / "r1" / "step-cost.jsonl", sample_every=5)
    faults = FaultSchedule.parse("step:1000000000:nan,step:1000000001:stall:1")

    def turn(on: bool, counted=None, profiled=False):
        engine.recorder, engine.faults = (recorder, faults) if on else (NULL_RECORDER, None)
        for i in range(SERVE_SLOTS):
            engine.submit(ServeRequest(prompt=[1 + i] * 8, max_new_tokens=n + 1, id=str(i)))
        engine.run_step(wait_s=0.0)  # the joins and the first token
        torch.cuda.synchronize()
        with counted if counted is not None else contextlib.nullcontext(), \
                _device_profile() if profiled else contextlib.nullcontext() as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                engine.run_step(wait_s=0.0)
            host_ms = (time.perf_counter() - t0) * 1e3 / n
        if engine.batcher.has_work:
            raise RuntimeError("r.1: the timed requests did not finish in their steps")
        if profiled:
            return sum(e.self_device_time_total for e in _device_events(prof)) / 1e3 / n
        return host_ms

    with torch.no_grad():
        host = {"off": [], "on": []}
        for on in (False, True, True, False) * R_COST_ROUNDS:
            host["on" if on else "off"].append(turn(on))
        calls = TorchCalls(engine)
        turn(True, counted=calls)
        device = {"off": turn(False, profiled=True), "on": turn(True, profiled=True)}
    recorder.close()
    per_step = (calls.counts["step"] + calls.counts["result"] + calls.counts["faults"]) / n
    if per_step > SERVE_STEP_CALLS or calls.counts["faults"]:
        raise RuntimeError(f"r.1: {per_step:g} Python->torch calls a decode step with the "
                           f"recorder on ({dict(calls.counts)})")
    med = {k: float(np.median(v)) for k, v in host.items()}
    print(f"  r.1: decode step at {SERVE_SLOTS} busy slots, {n} steps a turn, in turns: host ms "
          f"without the recorder {[round(v, 4) for v in host['off']]} (median "
          f"{med['off']:.4f}), with it and a fault schedule armed "
          f"{[round(v, 4) for v in host['on']]} (median {med['on']:.4f}): "
          f"{med['on'] - med['off']:+.4f} ms; device ms {device['off']:.4f} / "
          f"{device['on']:.4f}; Python->torch calls a step with the recorder on "
          f"{per_step:g} ({dict(calls.counts)}; at most {SERVE_STEP_CALLS})")
    return {"host_ms": host, "host_ms_median": med, "device_ms": device,
            "calls_a_step": per_step}


def _r_chaos(workdir: Path, k_args: list, slo_ms: float, model, windows) -> dict:
    """r.2: the chaos drill (a stalled server under the CLI loadgen), then
    ``step:N:nan`` on an engine in this process."""
    from pytorch_distributed_rnn_tpu_torch.resilience.faults import FaultSchedule

    d = workdir / "r2"
    d.mkdir()
    sidecar, report_path = d / "serve.jsonl", d / "report.json"
    serve_args = [*k_args, "--slots", str(SERVE_SLOTS), "--faults", R_STALL,
                  "--metrics", str(sidecar)]
    # the drill's SLO at most half the stall, so that the requests held
    # through it open the degradation window
    drill_slo = min(slo_ms, R_STALL_S * 1e3 / 2)
    drill = _serve_subprocess(["loadgen", "--spawn-server", shlex.join(serve_args), *SERVE_TCP,
                               "--slo-p95-ms", f"{drill_slo:g}", "--report", str(report_path)])
    print(drill.stdout.strip())
    report = json.loads(report_path.read_text()) if report_path.exists() else None
    if report is None:
        raise RuntimeError(f"r.2: no drill report (exit {drill.returncode}):\n"
                           f"{drill.stderr[-4000:]}")
    window = report["degradation_window_s"]
    closed = window is not None and report["timeline"][-1]["second"] > window[1]
    counts = _event_counts(sidecar)
    if (report["server_exit"] != 0 or report["errors"] != 0 or window is None or not closed
            or counts.get("fault") != 1 or counts.get("span:fault_stall") != 1):
        raise RuntimeError(f"r.2: drill: server exit {report['server_exit']}, errors "
                           f"{report['errors']}, window {window} (closed {closed}), sidecar "
                           f"{counts}\n{drill.stderr[-4000:]}")
    print(f"  r.2: {R_STALL}: degradation window {window} s of {report['wall_s']:.1f} s opened "
          f"and closed; {report['done']} done, {report['shed']} shed, 0 errors; server exit 0; "
          "the fault and its stall span in the sidecar")

    engine = _serve_engine(model)
    engine.faults = FaultSchedule.parse(f"step:{R_NAN_STEP}:nan")
    engine.warmup()
    poisoned = _serve_requests(windows, SERVE_SLOTS, seed=4)
    for r in poisoned:
        r.max_new_tokens = max(r.max_new_tokens, R_NAN_STEP + 2)
        engine.submit(r)
    engine.drain()
    bad = [r.id for r in poisoned
           if r.status != "error" or "non-finite logits" not in (r.error or "")]
    if bad or engine.stats()["requests_failed"] != len(poisoned):
        raise RuntimeError(f"r.2: step:{R_NAN_STEP}:nan left requests {bad} not failed cleanly")
    first_logits = _spy_first_logits(engine)
    fresh = _serve_requests(windows, 16, seed=5)
    for r in fresh:
        engine.submit(r)
    engine.drain()
    check = _check_served_tokens("r.2", model, fresh, first_logits, model.embed.device)
    print(f"  r.2: step:{R_NAN_STEP}:nan failed all {len(poisoned)} in-flight requests cleanly "
          f"(the poison written into the step graph's logits buffer); the next 16 requests' "
          "tokens equal generate's")
    return {"drill": {k: report[k] for k in ("done", "shed", "errors", "wall_s",
                                             "degraded_seconds", "degradation_window_s",
                                             "server_exit")},
            "nan_failed": len(poisoned), "after_nan": check}


def _card_memory() -> dict:
    """``nvidia-smi``'s card memory now (MiB): the card's used memory and
    each compute process's line (a container may show every process under
    one pid, so the lines are kept as a list)."""
    readings = {}
    for key, query in (("used", "--query-gpu=memory.used"),
                       ("processes", "--query-compute-apps=pid,used_memory")):
        try:
            out = subprocess.run(["nvidia-smi", query, "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=10).stdout
        except (OSError, subprocess.TimeoutExpired):
            continue
        values = [line.split(",")[-1].strip() for line in out.strip().splitlines()]
        values = [int(v) for v in values if v.isdigit()]
        readings[key] = values[0] if key == "used" and values else values
    return readings


def _r_fleet(workdir: Path, k_args: list, ready_s: float, model) -> dict:
    """r.3: the fleet drill through ``loadgen --spawn-fleet`` (in this
    process, so that each reply's tokens can be held against ``generate``):
    3 replicas of path k's server on the card behind the router, one
    SIGKILLed mid-burst; the loadgen's default SLO (p95 2 s), as the
    drill judges the kill, not the latency of three replicas sharing a
    card and its host."""
    from pytorch_distributed_rnn_tpu_torch.serving import cli
    from pytorch_distributed_rnn_tpu_torch.serving.fleet import drill as fleet_drill
    from pytorch_distributed_rnn_tpu_torch.serving.loadgen import plan_requests
    from pytorch_distributed_rnn_tpu_torch.serving.scheduler import ServeRequest

    d = workdir / "r3"
    d.mkdir()
    family, live_file, report_path = d / "fleet.jsonl", d / "live.port", d / "report.json"
    # sized from r.1's server start (a respawn pays the same context start,
    # load and warm-up captures): the router waits 4x that for its first
    # pong, and the kill lands a third into the burst, leaving the survivors
    # two thirds of it to show the window closed
    ready_timeout = max(60.0, 4 * ready_s)
    kill_after = R_FLEET_REQUESTS / R_FLEET_RATE / 3
    argv = ["--spawn-fleet", str(R_FLEET),
            "--replica-args", shlex.join([*k_args, "--slots", str(SERVE_SLOTS),
                                          "--metrics", str(family)]),
            "--router-args", shlex.join([*R_ROUTER, "--metrics", str(family),
                                         "--live-port-file", str(live_file),
                                         "--ready-timeout", f"{ready_timeout:g}"]),
            "--fleet-kill-after-s", f"{kill_after:g}", "--fleet-kill-index", "1",
            "--requests", str(R_FLEET_REQUESTS), "--rate", f"{R_FLEET_RATE:g}", *R_FLEET_LOAD,
            "--report", str(report_path)]
    seen = {}
    run_load = fleet_drill.run_load

    def keep_replies(cfg):
        # the fleet is up: every replica warmed up, the router ready
        seen["ready"] = _card_memory()
        seen["cfg"] = cfg
        seen["outcomes"] = []
        return run_load(cfg, progress=seen["outcomes"].append)

    fleet_drill.run_load = keep_replies
    before = _card_memory()
    t0 = time.perf_counter()
    try:
        rc = cli.loadgen_main(argv)
    finally:
        fleet_drill.run_load = run_load
    drill_s = time.perf_counter() - t0
    report = json.loads(report_path.read_text())
    fleet = report["fleet"]
    print(f"  r.3: loadgen --spawn-fleet {R_FLEET} exit {rc} in {drill_s:.1f} s: {report['done']} "
          f"done, {report['shed']} shed, {report['errors']} errors; {fleet['respawns']} "
          f"respawn(s); router {fleet['router']['rerouted']} rerouted, "
          f"{fleet['router']['retries']} retries; accounting "
          f"{'OK' if fleet['accounting_ok'] else 'BROKEN'}; window "
          f"{report['degradation_window_s']} {'closed' if fleet['window_closed'] else 'OPEN'}; "
          f"router exit {fleet['router_exit']}; live {fleet.get('live')}")
    if rc != 0 or not (fleet["accounting_ok"] and fleet["window_closed"]
                       and fleet["respawns"] >= 1 and fleet["router_exit"] == 0):
        raise RuntimeError(f"r.3: fleet drill verdict failed: {fleet}")
    traces = _trace_check("r.3", family, cross=True)
    # every completed greedy request against its single-request generate
    plan = plan_requests(seen["cfg"], model.vocab_size, 128, SERVE_MAX_NEW)
    greedy = []
    for out in seen["outcomes"]:
        spec = plan[out.index]
        if out.status != "done" or spec["temperature"] != 0.0:
            continue
        r = ServeRequest(prompt=spec["prompt"], max_new_tokens=spec["max_new_tokens"],
                         temperature=0.0, seed=spec["seed"], id=str(out.index))
        r.status, r.tokens = "done", list(out._reply["tokens"])
        greedy.append(r)
    check = _check_served_tokens("r.3", model, greedy, None, model.embed.device)
    ready = seen.get("ready", {})
    per_replica = ((ready["used"] - before["used"]) / R_FLEET
                   if "used" in ready and "used" in before else None)
    print(f"  r.3: card memory (nvidia-smi, MiB): used {before.get('used')} before the fleet "
          f"(this process), {ready.get('used')} with {R_FLEET} replicas warmed up: "
          f"{per_replica} a replica; compute processes then {ready.get('processes')}, before "
          f"{before.get('processes')}; all {R_FLEET} replicas share one card: no scaling figure")
    return {"seconds": drill_s, "ready_timeout_s": ready_timeout, "kill_after_s": kill_after,
            "report": {k: report[k] for k in ("done", "shed", "errors", "wall_s",
                                              "degradation_window_s", "latency_ms")},
            "fleet": {k: fleet[k] for k in ("respawns", "accounting_ok", "window_closed",
                                            "router_exit", "router", "live")
                      if k in fleet},
            "trace": traces, "greedy_checked": len(greedy), "tokens": check,
            "card_mib": {"before": before, "ready": ready, "per_replica": per_replica}}


def phase_fleet_telemetry(workdir: Path, runs: dict, serving: dict) -> dict:
    """Path r: serving's telemetry and chaos, then the fleet, on path k's
    checkpoint (``serve``, ``loadgen`` and ``obs`` through their CLIs)."""
    from pytorch_distributed_rnn_tpu_torch.serving import cli

    t0 = time.perf_counter()
    k_args = _serve_args("k", workdir / "models-char-lstm")
    k_p95 = serving["k"]["tcp"]["report"]["latency_ms"]["p95"]
    slo_ms = float(math.ceil(R_SLO_OVER_K * k_p95))
    print(f"serving path r: telemetry, chaos and the fleet on path k's server (SLO p95 "
          f"{slo_ms:g} ms = {R_SLO_OVER_K:g} x k's measured TCP latency p95 {k_p95} ms)")
    _reset_launch_counts()
    results = {"slo_p95_ms": slo_ms, "r1": _r_serve(workdir, k_args, slo_ms)}
    model, _ = cli.load_served_model(cli.build_serve_parser().parse_args(k_args))
    results["r1"]["step"] = _r_step_cost(workdir, model)
    windows = runs["char_lstm"].trainer.test_set.features
    results["r2"] = _r_chaos(workdir, k_args, slo_ms, model, windows)
    results["r3"] = _r_fleet(workdir, k_args, results["r1"]["ready_s"], model)
    launches = {k: v for k, v in _launch_counts().items() if v}
    if launches:
        raise RuntimeError(f"r: serving launched the port's kernels: {launches}")
    results["seconds"] = time.perf_counter() - t0
    print(f"path r: {results['seconds']:.1f} s (no RNN or flash kernel launched)")
    print("fleet_telemetry: " + json.dumps(results, default=str))
    return results


FUSE_RTOL = 1e-5  # a --fuse-run history against the per-epoch path's (tests/test_training.py)
# the graph phase's CLI paths: flags beyond the data and checkpoint paths
GRAPH_PATHS = {
    "a": [],
    "b": ["--cell", "gru"],
    "c": ["--model", "char", "--cell", "gru", "--hidden-units", str(CHAR_HIDDEN),
          "--stacked-layer", "2", "--seq-length", str(SEQ_LEN), "--batch-size", str(CHAR_BATCH),
          "--dropout", "0"],
    "d": ["--model", "attention", "--hidden-units", str(ATTN_DIM), "--num-heads",
          str(ATTN_HEADS), "--stacked-layer", str(ATTN_DEPTH), "--batch-size", str(ATTN_BATCH),
          "--dropout", "0"],
    "f": ["--model", "char", "--hidden-units", str(CHAR_HIDDEN), "--stacked-layer", "2",
          "--seq-length", str(SEQ_LEN), "--batch-size", str(CHAR_BATCH), "--dropout", "0"],
}


def _graph_argv(workdir: Path, path: str, extra: list) -> list:
    data = workdir / ("no-corpus" if path in ("c", "f") else "data")
    return [*GRAPH_PATHS[path], "--dataset-path", str(data), "--checkpoint-directory",
            str(workdir / f"models-graph-{path}"), "--seed", "0", "--no-validation", *extra,
            "local"]


def _cli_trainer(workdir: Path, argv: list, epochs: int = 0):
    """``main ... local`` in the working directory (history.json goes
    there): the trainer after ``epochs`` epochs."""
    from pytorch_distributed_rnn_tpu_torch import main as port_main

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        return port_main.main(["--epochs", str(epochs), *argv])
    finally:
        os.chdir(cwd)


def _same_bits(what: str, a, b):
    """Two trainers' parameters and Adam states equal bit for bit."""
    for key, value in a.model.state_dict().items():
        if not torch.equal(value, b.model.state_dict()[key]):
            raise RuntimeError(f"{what}: parameter {key} differs")
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for i, state in sa.items():
        for key, value in state.items():
            if not torch.equal(value, sb[i][key]):
                raise RuntimeError(f"{what}: Adam state {i} {key} differs")


def _graph_pair(what: str, make, formatter, epochs: int = 2) -> tuple:
    """Two trainers from ``make()`` (the same weights): ``epochs`` epochs
    of the per-batch loop and of the per-epoch graph path, each with the
    launch counts reset before and read after.  The loss histories,
    parameters and Adam states must agree bit for bit, and the launches
    too.  Returns the graph trainer, its history and launches a step."""
    trainers = {"eager": make(), "graph": make()}
    history, launches = {}, {}
    for mode, trainer in trainers.items():
        _reset_launch_counts()
        history[mode] = []
        for epoch in range(epochs):
            trainer.sampler.set_epoch(epoch)
            history[mode].append(trainer._train_epoch(formatter, eager=mode == "eager")[0])
        torch.cuda.synchronize()
        launches[mode] = _launch_counts()
    steps = epochs * len(trainers["graph"]._epoch_index_batches())
    per_step = {k: v / steps for k, v in launches["graph"].items() if v}
    capture = {f"{kind} {rows}": round(g.capture_s * 1e3, 3)
               for (kind, rows), g in trainers["graph"].graphs.items()}
    print(f"  {what}: eager {history['eager']}, graph {history['graph']}; launches a step "
          f"{per_step}; capture ms {capture}")
    if history["eager"] != history["graph"] or not all(map(math.isfinite, history["graph"])):
        raise RuntimeError(f"{what}: the graph path's history is not the eager loop's")
    if launches["eager"] != launches["graph"] or not per_step:
        raise RuntimeError(f"{what}: launches eager {launches['eager']}, graph "
                           f"{launches['graph']}")
    _same_bits(what, trainers["eager"], trainers["graph"])
    print(f"  {what}: histories, parameters and Adam states equal bit for bit")
    return trainers["graph"], history["graph"], per_step


def _fused_check(what: str, history: list, launches: dict, steps: int, reference: list,
                 per_step: dict):
    fused_step = {k: v / steps for k, v in launches.items() if v}
    err = max(abs(a - b) / abs(b) for a, b in zip(history, reference))
    print(f"  {what} --fuse-run: {history}, rtol against the per-epoch path {err:.3e} "
          f"(bar {FUSE_RTOL:g}); launches a step {fused_step}")
    if len(history) != len(reference) or err > FUSE_RTOL:
        raise RuntimeError(f"{what}: --fuse-run history {history} against {reference}")
    if fused_step != per_step:
        raise RuntimeError(f"{what}: --fuse-run launches a step {fused_step}, not {per_step}")


def phase_graph(workdir: Path, formatter) -> dict:
    """The device-resident fast paths against the per-batch loop.  On paths
    a-f, two trainers from the same weights (``--no-validation``) train 2
    epochs, one in the per-batch loop, one on the per-epoch graph path
    (CUDA-graph replays of the train step): the same loss history,
    parameters and Adam state bit for bit, and the same launches (a and b
    at ``--dropout`` 0 and at the CLI's 0.1, the others at 0).  Then
    ``--fuse-run`` through the CLI on a-d and f (a and b at dropout 0) and
    the trainer on e: each history within ``FUSE_RTOL`` of the per-epoch path's, the
    same launches a step; and 2 more epochs of each fused trainer, its
    graph replayed, on the host clock (replay ms a step)."""
    print("graph: the per-epoch graph path and --fuse-run against the per-batch loop")
    out = {}
    for path in ("a", "b", "c", "d", "e", "f"):
        for dropout in (("0", "0.1") if path in ("a", "b") else (None,)):
            what = f"path {path}" + (f", dropout {dropout}" if dropout else "")
            extra = ["--dropout", dropout] if dropout else []
            if path == "e":
                make = _long_context_trainer
            else:
                make = lambda p=path, x=extra: _cli_trainer(workdir, _graph_argv(workdir, p, x))
            trainer, history, per_step = _graph_pair(what, make, formatter)
            if dropout == "0.1":
                continue
            _reset_launch_counts()
            t0 = time.perf_counter()
            if path == "e":
                fused = _long_context_trainer(fuse_run=True)
                _, fused_history, _ = fused.train(epochs=2)
            else:
                fused = _cli_trainer(workdir, _graph_argv(workdir, path, [*extra, "--fuse-run"]),
                                     epochs=2)
                fused_history = json.loads((workdir / "history.json").read_text())[
                    "train_history"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps = 2 * len(fused._epoch_index_batches())
            _fused_check(what, fused_history, _launch_counts(), steps, history, per_step)
            (graph,) = fused.graphs.values()
            t0 = time.perf_counter()
            fused._train_run_fused(2)
            torch.cuda.synchronize()
            replay_ms = (time.perf_counter() - t0) * 1e3 / steps
            print(f"  {what} --fuse-run: one one-step graph replayed {steps - 1} times after its "
                  f"warm-up step; run {wall:.2f} s with capture {graph.capture_s * 1e3:.1f} ms; "
                  f"2 more epochs replayed: {replay_ms:.3f} ms a step on the host clock")
            out[path] = {"capture_ms": graph.capture_s * 1e3, "replay_ms": replay_ms}
            del trainer, fused
        torch.cuda.empty_cache()
    return out


DP_TOL_LOCAL = 1e-4  # a world's final parameters against local's, float32 on the card
DP_TOL_FLAVOURS = 1e-5  # distributed against horovod
TORCHRUN_TIMEOUT = 600  # a torchrun world's deadline, where none is sized to its work
G_DEADLINE_S = 120  # the g world's: about 3x its 28.4-42.4 s on an H100 80GB (PERF.md §6)
UNCAPTURED = "gloo collectives cannot be captured: the step body runs uncaptured"
# the g world's runs: each graph run's per-batch-loop twin adds --log DEBUG,
# and --checkpoint-every 2 keeps the last Adam state; the fused runs and
# their per-epoch twins take --no-validation
G_RUNS = {
    "sharded": ["--sharded-update", "--checkpoint-every", "2", "distributed"],
    "replicated": ["--no-sharded-update", "--checkpoint-every", "2", "distributed"],
    "horovod": ["--checkpoint-every", "2", "horovod"],
    "gru": ["--cell", "gru", "distributed"],
    "fused": ["--no-validation", "--fuse-run", "distributed"],
    "epochs": ["--no-validation", "distributed"],
    "horovod fused": ["--no-validation", "--fuse-run", "horovod"],
    "horovod epochs": ["--no-validation", "horovod"],
}
G_TWINS = ("sharded", "replicated", "horovod")  # each with a "<name> loop" run


def _torchrun(ranks: int, jobs: list, workdir: Path, name: str,
              timeout: float = TORCHRUN_TIMEOUT) -> tuple:
    """``jobs`` (``parallel/launch.py``) on a ``torchrun`` world of ``ranks``
    processes on the card; a failure in any rank fails the phase, and so
    does a world that outlives ``timeout`` seconds (its process group is
    killed: the launcher and every rank).  Returns the wall seconds and the
    launcher's standard error."""
    spec = workdir / f"{name}.json"
    spec.write_text(json.dumps({"device": "cuda", "jobs": jobs}))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc-per-node", str(ranks), "-m",
                             "pytorch_distributed_rnn_tpu_torch.parallel.launch", str(spec)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        print(stdout[-4000:])
        print(stderr[-8000:])
        raise RuntimeError(f"{name}: the torchrun world ran past its {timeout:g} s deadline "
                           "(a hung capture or collective)") from None
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(stdout[-4000:])
        print(stderr[-8000:])
        raise RuntimeError(f"{name}: torchrun exited {proc.returncode}")
    return wall, stderr


def _dp_job(workdir: Path, name: str, flags: list) -> dict:
    return {"dir": str(workdir / "dp" / name),
            "argv": ["--dataset-path", str(workdir / "data"), "--checkpoint-directory", "models",
                     "--epochs", "2", "--seed", "0", "--dropout", "0", *flags]}


def _dp_results(job: dict, ranks: int, epochs: int = 2) -> tuple:
    """Every rank's ``rank<r>.pt``, checked to hold rank 0's final
    parameters bit for bit, and rank 0's ``history.json``."""
    results = [torch.load(Path(job["dir"]) / f"rank{r}.pt", weights_only=True)
               for r in range(ranks)]
    history = json.loads((Path(job["dir"]) / "rank0" / "history.json").read_text())
    losses = history["train_history"] + history["validation_history"]
    if len(history["train_history"]) != epochs or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"{job['dir']}: losses not finite: {history}")
    for rank, result in enumerate(results[1:], start=1):
        if any(not torch.equal(result["state"][k], v) for k, v in results[0]["state"].items()):
            raise RuntimeError(f"{job['dir']}: rank {rank} ends with other parameters than rank 0")
    perf = [[m for m in r["log"] if "Memory Usage" in m] for r in results]
    if any(len(p) != 1 or not p[0].startswith(f"{rank}: ") for rank, p in enumerate(perf)):
        raise RuntimeError(f"{job['dir']}: perf lines {perf}")
    print(f"  {Path(job['dir']).name}: train_history={history['train_history']}, "
          f"validation_history={history['validation_history']}, perf lines "
          f"{[p[0] for p in perf]}, rank 0 launches {results[0]['launches']}, step path "
          f"{results[0]['buffers'] or 'per-batch loop'}, graph replays {results[0]['graphs']}")
    return results, history


def _check_dp_launches(name: str, results: list, cell: str, layers: int = 2,
                       evaluations: int = 3) -> dict:
    """Each rank launched its cell's kernels and no others: a forward and a
    backward a layer a train step, and rank 0 a forward a layer for each of
    its ``evaluations`` (one an epoch, then the test set).  Returns rank
    0's launches a train step."""
    fwd, bwd = f"{cell}_fwd", f"{cell}_bwd"
    for rank, result in enumerate(results):
        launches, steps = result["launches"], result["steps"]
        for kernel, count in launches.items():
            if (kernel in (fwd, bwd)) != (count > 0):
                raise RuntimeError(f"{name}: rank {rank} launched {kernel} {count} times")
        evals = evaluations if rank == 0 else 0
        if not launches[fwd] - evals * layers == launches[bwd] == steps * layers:
            raise RuntimeError(f"{name}: rank {rank} launches {launches} over {steps} steps")
    steps = results[0]["steps"]
    return {fwd: (results[0]["launches"][fwd] - evaluations * layers) / steps,
            bwd: results[0]["launches"][bwd] / steps}


def _check_step_path(name: str, results: list, path: str):
    """Each rank took ``path``: ``"graph"`` the per-epoch step captured and
    replayed (a graph a batch shape; each step after a shape's first is a
    replay), ``"fused"`` the fused run's one graph, ``"loop"`` the per-batch
    loop, ``"uncaptured"`` the step body uncaptured, said once in the log."""
    for rank, result in enumerate(results):
        replays = sum(result["graphs"].values())
        said = sum(UNCAPTURED in m for m in result["log"])
        ok = {"graph": result["buffers"] == ["epoch"] and result["graphs"]
              and replays == result["steps"] - len(result["graphs"]) and not said,
              "fused": result["buffers"] == ["run"] and len(result["graphs"]) == 1
              and replays == result["steps"] - 1 and not said,
              "loop": result["buffers"] == [] and not result["graphs"] and not said,
              "uncaptured": result["buffers"] == ["epoch"] and not result["graphs"]
              and said == 1}[path]
        if not ok:
            raise RuntimeError(f"{name}: rank {rank} did not take the {path} path: buffers "
                               f"{result['buffers']}, graphs {result['graphs']}, {said} "
                               "uncaptured lines")


def _final_adam_state(job: dict) -> dict:
    from pytorch_distributed_rnn_tpu_torch.training.checkpoint import load_checkpoint

    _, opt_state, _ = load_checkpoint(Path(job["dir"]) / "rank0" / "models" /
                                      "checkpoint-epoch-2.ckpt")
    return opt_state["state"]


def _state_err(a: dict, b: dict) -> float:
    return max((a[k].float() - b[k].float().cpu()).abs().max().item() for k in a)


def _dp_compare(what: str, a: tuple, b: tuple, tol: float):
    """Two runs' final parameters and histories: equal bit for bit where
    ``tol`` is 0, else within ``tol``."""
    (state_a, hist_a), (state_b, hist_b) = a, b
    err = _state_err(state_a, state_b)
    hist_err = max(abs(x - y) for key in ("train_history", "validation_history")
                   for x, y in zip(hist_a[key], hist_b[key]))
    print(f"  {what}: params max_abs_err={err:.3e}, history max_abs_err={hist_err:.3e}, "
          f"tol={'bitwise' if tol == 0 else f'{tol:g}'}")
    if err > tol or hist_err > tol or (tol == 0 and hist_a != hist_b):
        raise RuntimeError(f"{what}: disagree")


G_TIMING_TIMEOUT = 180  # the g timing's child process: about 30 s on an H100


def _g_timing_child(workdir: str) -> None:
    """g's step times, in a process of its own on a world of 1 over NCCL
    (the group made here outlives each CLI run, so that its trainer can
    train on after it): ``distributed`` (sharded, ``--no-validation``)
    trained 2 epochs through the CLI, then the per-batch loop and the
    graph path in turns with one profiled epoch of each
    (``phase_step_profile``); and the ``--fuse-run`` trainer's graph
    replayed over 2 more epochs on the host clock.  Prints its results as
    a JSON line, the last."""
    from pytorch_distributed_rnn_tpu_torch.parallel import collectives
    from pytorch_distributed_rnn_tpu_torch.training.formatter import TrainingMessageFormatter

    workdir = Path(workdir)
    argv = ["--dataset-path", str(workdir / "data"), "--checkpoint-directory",
            str(workdir / "models-g"), "--seed", "0", "--dropout", "0", "--no-validation"]
    group = collectives.init_process_group("cuda")
    try:
        trainer = _cli_trainer(workdir, [*argv, "distributed"], epochs=2)
        out = phase_step_profile(PathRun("g, distributed at world 1 on NCCL", trainer, MAIN_BATCH,
                                         ("lstm_fwd", "lstm_bwd"), {}, {}),
                                 TrainingMessageFormatter(1), PROFILE_ROUNDS)
        fused = _cli_trainer(workdir, [*argv, "--fuse-run", "distributed"], epochs=2)
        steps = 2 * len(fused._epoch_index_batches())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused._train_run_fused(2)
        torch.cuda.synchronize()
        out["fused_replay_ms"] = (time.perf_counter() - t0) * 1e3 / steps
        (graph,) = fused.graphs.values()
        print(f"  g --fuse-run: 2 more epochs replayed: {out['fused_replay_ms']:.3f} ms a step on "
              f"the host clock; capture {graph.capture_s * 1e3:.1f} ms")
    finally:
        collectives.destroy(group)
    print(json.dumps(out), flush=True)


def _g_timing(workdir: Path) -> dict:
    """``_g_timing_child`` in a child process, so that this process keeps
    no NCCL group and runs no profile for g: in a smoke that ran them here,
    phase p.1's profile later lost one kernel record in all three
    attempts."""
    proc = subprocess.run([sys.executable, "-c",
                           "import sys, chip_smoke; chip_smoke._g_timing_child(sys.argv[1])",
                           str(workdir)], cwd=ROOT, capture_output=True, text=True,
                          timeout=G_TIMING_TIMEOUT)
    lines = proc.stdout.strip().splitlines()
    print("\n".join(lines[:-1]))
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-8000:])
        raise RuntimeError(f"g timing: the child process exited {proc.returncode}")
    return json.loads(lines[-1])


def phase_distributed(workdir: Path) -> dict:
    """The data-parallel strategies through ``torchrun`` and the CLI at
    path a's width (2 x 32 LSTM, batch 1440, 2 epochs, ``--dropout 0`` so
    that worlds compare with local).  g, world 1 on NCCL (``G_RUNS``, under
    ``G_DEADLINE_S``): ``distributed`` with and without
    ``--sharded-update`` and ``horovod`` on the graph path, each equal bit
    for bit to its per-batch-loop twin (``--log DEBUG``: history,
    parameters, the last Adam state, launches), ``--cell gru``, and
    ``--fuse-run`` of both strategies within ``FUSE_RTOL`` of their
    per-epoch runs; then g's step times (``_g_timing``).  h, world 2
    sharing the card over gloo (``distributed`` and ``horovod``, each with
    and without ``--sharded-update``), at the same time as g: the step body
    uncaptured.  Each held
    against a ``local`` run from the same seed and against the others, and
    the kernels' launches counted on every rank."""
    from concurrent.futures import ThreadPoolExecutor

    print("main path: distributed (g: world 1 on NCCL; h: world 2 on one card over gloo)")
    trainer, local_history, _, _ = _drive(workdir, _dp_job(workdir, "local", ["local"])["argv"])
    local = ({k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}, local_history)

    runs = dict(G_RUNS)
    for name in G_TWINS:
        runs[f"{name} loop"] = [*G_RUNS[name][:-1], "--log", "DEBUG", G_RUNS[name][-1]]
    g_jobs = {name: _dp_job(workdir, "g-" + name.replace(" ", "-"), flags)
              for name, flags in runs.items()}
    h_jobs = {(flavour, sharding): _dp_job(workdir, f"h-{flavour}-{sharding}",
                                           [f"--{sharding}", flavour])
              for flavour in ("distributed", "horovod")
              for sharding in ("sharded-update", "no-sharded-update")}
    # the two worlds at once: neither is timed (g's step times come after)
    with ThreadPoolExecutor(2) as pool:
        g_world = pool.submit(_torchrun, 1, list(g_jobs.values()), workdir, "g", G_DEADLINE_S)
        h_world = pool.submit(_torchrun, 2, list(h_jobs.values()), workdir, "h")
        (g_wall, _), (h_wall, stderr) = g_world.result(), h_world.result()
    print(f"  world 1 on NCCL: {len(g_jobs)} runs in {g_wall:.2f} s (one torchrun, deadline "
          f"{G_DEADLINE_S} s); beside it, world 2 sharing the card over gloo: {len(h_jobs)} "
          f"runs in {h_wall:.2f} s (one torchrun)")
    g = {name: _dp_results(job, 1) for name, job in g_jobs.items()}
    per_step = {}
    for name, (results, _) in g.items():
        cell = "gru" if name == "gru" else "lstm"
        per_step[f"g {name}"] = _check_dp_launches(f"g {name}", results, cell,
                                                   evaluations=0 if "--no-validation" in
                                                   runs[name] else 3)
        _check_step_path(f"g {name}", results, "loop" if name.endswith("loop") else
                         "fused" if name.endswith("fused") else "graph")

    if "ranks share 1 card(s) over gloo" not in stderr:
        raise RuntimeError("h: rank 0 did not log the shared-card backend")
    h = {key: _dp_results(job, 2) for key, job in h_jobs.items()}
    for key, (results, _) in h.items():
        per_step[f"h {'/'.join(key)}"] = _check_dp_launches(f"h {key}", results, "lstm")
        _check_step_path(f"h {key}", results, "uncaptured")
    print(f"  launches a train step (rank 0): {per_step}")
    print(f"  h: every rank logged once that its gloo world runs the step body uncaptured")

    def final(run):
        results, history = run
        return results[0]["state"], history

    for name in G_TWINS:
        _dp_compare(f"g {name}: graph path vs per-batch loop", final(g[name]),
                    final(g[f"{name} loop"]), 0)
        want = _final_adam_state(g_jobs[f"{name} loop"])
        for i, state in _final_adam_state(g_jobs[name]).items():
            for key in ("step", "exp_avg", "exp_avg_sq"):
                if not torch.equal(state[key], want[i][key]):
                    raise RuntimeError(f"g {name}: Adam state {i} {key} differs from the "
                                       "per-batch loop's")
        if per_step[f"g {name}"] != per_step[f"g {name} loop"]:
            raise RuntimeError(f"g {name}: launches a step {per_step[f'g {name}']}, the loop's "
                               f"{per_step[f'g {name} loop']}")
    print("  g: the graph path's histories, parameters, Adam states and launches equal the "
          "per-batch loop's bit for bit (distributed sharded and replicated, horovod)")
    for prefix in ("", "horovod "):
        (fused,), history = g[f"{prefix}fused"]
        _fused_check(f"g {prefix or 'distributed '}".strip(), history["train_history"],
                     fused["launches"], fused["steps"], g[f"{prefix}epochs"][1]["train_history"],
                     per_step[f"g {prefix}epochs"])
    _dp_compare("g: sharded vs replicated", final(g["sharded"]), final(g["replicated"]), 0)
    _dp_compare("g: distributed vs horovod", final(g["sharded"]), final(g["horovod"]),
                DP_TOL_FLAVOURS)
    _dp_compare("g vs local", final(g["sharded"]), local, DP_TOL_LOCAL)
    for flavour in ("distributed", "horovod"):
        _dp_compare(f"h {flavour}: sharded vs replicated",
                    final(h[flavour, "sharded-update"]), final(h[flavour, "no-sharded-update"]), 0)
    _dp_compare("h: distributed vs horovod", final(h["distributed", "no-sharded-update"]),
                final(h["horovod", "no-sharded-update"]), DP_TOL_FLAVOURS)
    _dp_compare("h distributed vs local", final(h["distributed", "sharded-update"]), local,
                DP_TOL_LOCAL)
    timing = _g_timing(workdir)
    medians = {mode: sorted(timing["host_ms"][mode])[len(timing["host_ms"][mode]) // 2]
               for mode in ("graph", "eager")}
    print(f"  g step times: graph path host {medians['graph']:.3f} ms (median) / device "
          f"{timing['graph']['device_ms']:.3f} ms a step, idle {100 * timing['graph']['idle']:.1f}%; "
          f"per-batch loop host {medians['eager']:.3f} / device "
          f"{timing['eager']['device_ms']:.3f} ms, idle {100 * timing['eager']['idle']:.1f}%; "
          f"--fuse-run replay {timing['fused_replay_ms']:.3f} ms a step")
    return {"local": local, "g sharded": final(g["sharded"]),
            "g replicated": final(g["replicated"]),
            "h sharded": final(h["distributed", "sharded-update"]),
            "h replicated": final(h["distributed", "no-sharded-update"])}


NATIVE_BUCKET_MB = 0.02  # path i: three buckets of the motion model's 14,150 parameters
NATIVE_CHAR_BUCKET_MB = 4.0  # path j: five buckets of the char LM's 17.9 MB gradient
NATIVE_FLAVOURS = {"bucketed": ["--bucket-mb", str(NATIVE_BUCKET_MB)],
                   "monolithic": ["--no-bucketed-comm"], "replicated": ["--no-sharded-update"]}
NATIVE_CHAR_FLAVOURS = {"bucketed": ["--bucket-mb", str(NATIVE_CHAR_BUCKET_MB)],
                        "monolithic": ["--no-bucketed-comm"]}
NATIVE_CHAR_KERNELS = ("lstm_fwd_tc_kernel", "lstm_bwd_cluster_kernel")  # at H=512, float32
EXAMPLES = {1: ("ddp", "horovod"), 2: ("ddp", "horovod", "p2p")}


def _native_jobs(workdir: Path, world: int) -> dict:
    """A torchrun world's jobs for ``phase_native``, each run on a ring port
    of its own: path i's flavours (and path j's at world 1) once as they
    run, for the host clock, the comm times and the checks, then once under
    the profiler, for device time; each path after a one-epoch warm-up run
    (monolithic) that takes the first-use costs of the process and of the
    model's shapes out of the measured runs; then the examples."""
    from pytorch_distributed_rnn_tpu_torch.utils.worlds import free_ports

    jobs = {}
    paths = {"i": NATIVE_FLAVOURS, **({"j": NATIVE_CHAR_FLAVOURS} if world == 1 else {})}
    for path, flavours in paths.items():
        runs = [("warm", ""), *((name, profiled) for profiled in ("", " profiled")
                                for name in flavours)]
        for name, profiled in runs:
            flags = ["--no-bucketed-comm", "--epochs", "1"] if name == "warm" else flavours[name]
            key = f"{path} {name}{profiled}"
            if path == "i":
                jobs[key] = _dp_job(workdir, f"i{world}-{name}{profiled.strip()}",
                                    ["--no-validation", *flags, "distributed-native"])
            else:
                jobs[key] = {"dir": str(workdir / "dp" / f"j-{name}{profiled.strip()}"),
                             "argv": [*GRAPH_PATHS["f"], "--dataset-path",
                                      str(workdir / "no-corpus"), "--checkpoint-directory",
                                      "models", "--epochs", "1", "--seed", "0",
                                      "--no-validation", *flags, "distributed-native"]}
            jobs[key]["profile"] = bool(profiled)
    for job, port in zip(jobs.values(), free_ports(len(jobs))):
        job["env"] = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    for example in EXAMPLES[world]:
        jobs[f"example {example}"] = {
            "dir": str(workdir / "examples" / f"w{world}-{example}"),
            "module": f"pytorch_distributed_rnn_tpu_torch.examples.example_{example}",
            "argv": ["--device", "cuda"]}
    return jobs


def _native_line(name: str, run: tuple, profiled: tuple) -> dict:
    """A flavour's numbers: rank 0's host ms a step (the perf line's
    training duration over its steps) and every rank's ``comm_wait_s``/
    ``comm_active_s`` a step, from the run as it runs; rank 0's device ms a
    step (kernels, copies and sets) from its profiled twin, which must end
    with the same parameters bit for bit."""
    _dp_compare(f"{name}: profiled vs not", (profiled[0][0]["state"], profiled[1]),
                (run[0][0]["state"], run[1]), 0)
    results = run[0]
    steps = results[0]["steps"]
    (perf,) = [m for m in results[0]["log"] if "Training Duration" in m]
    host_ms = float(perf.rsplit(" ", 1)[1]) * 1e3 / steps
    device_ms = profiled[0][0]["device_ms"]
    comm = [np.asarray(r["comm"]).mean(axis=0) for r in results]
    print(f"  {name}: host {host_ms:.3f} ms a step, device {device_ms:.3f} ms a step, {steps} "
          f"steps (runs {results[0]['wall']:.2f} s, profiled {profiled[0][0]['wall']:.2f} s); "
          "comm_wait_s / comm_active_s a step: "
          + ", ".join(f"rank {r} {w:.6f} / {a:.6f}" for r, (w, a) in enumerate(comm)))
    return {"host_ms": host_ms, "device_ms": device_ms,
            "comm_wait_s": [float(w) for w, _ in comm],
            "comm_active_s": [float(a) for _, a in comm]}


def _check_examples(jobs: dict, world: int):
    for example in EXAMPLES[world]:
        job = jobs[f"example {example}"]
        outs = [torch.load(Path(job["dir"]) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
        want = "has data  1.0" if example == "p2p" else "PARITY-OK"
        if not all(want in out["stdout"] for out in outs):
            raise RuntimeError(f"example {example} at world {world} printed "
                               f"{[out['stdout'][-300:] for out in outs]}")
        last = [out["stdout"].strip().splitlines()[-1] for out in outs]
        print(f"  example_{example} at world {world}: {last}")


def phase_native(workdir: Path, dp_finals: dict) -> dict:
    """``distributed-native`` over the TCP ring through ``torchrun`` and the
    CLI.  Path i: path a's width (2 x 32 LSTM, batch 1440, 2 epochs,
    ``--dropout 0``, ``--no-validation``) at world 1 and at world 2 (two
    ranks sharing the card), bucketed (``--bucket-mb 0.02``: three
    buckets), monolithic and replicated; path j: the char LM at H=512
    (path f's flags) for one epoch at world 1, bucketed at ``--bucket-mb
    4`` and monolithic.  Checks: each rank's launches against its steps,
    every rank equal to rank 0 and the flavours equal to each other bit for
    bit, path i within 1e-5 of ``distributed`` (same world and flavour) and
    world 1 within 1e-4 of ``local``, path j's H=512 kernels in the
    profile.  Then the examples: ``example_ddp`` and ``example_horovod`` at
    worlds 1 and 2, ``example_p2p`` at world 2, in the same worlds."""
    from pytorch_distributed_rnn_tpu_torch.parallel.bucketing import plan_buckets
    from pytorch_distributed_rnn_tpu_torch.runtime import native

    print("main path: distributed-native (i: motion LSTM at worlds 1 and 2; j: char LM H=512)")
    t0 = time.perf_counter()
    native.build_native_library()
    build_s = native.BUILD_SECONDS[-1] if native.BUILD_SECONDS else None
    print(f"  ring library: {native.library_path().relative_to(ROOT)}, g++ build "
          f"{'(built already)' if build_s is None else f'{build_s:.2f} s'}")
    lines, finals = {}, {}
    for world in (1, 2):
        jobs = _native_jobs(workdir, world)
        wall, _ = _torchrun(world, list(jobs.values()), workdir, f"native{world}")
        print(f"  world {world}: {len(jobs)} jobs in {wall:.2f} s (one torchrun)")
        runs = {}
        for key in NATIVE_FLAVOURS:
            results, history = runs[key] = _dp_results(jobs[f"i {key}"], world)
            _check_dp_launches(f"i{world} {key}", results, "lstm", evaluations=0)
            lines[f"i{world} {key}"] = _native_line(
                f"i world {world} {key}", runs[key],
                _dp_results(jobs[f"i {key} profiled"], world))
        size = sum(v.numel() for v in runs["bucketed"][0][0]["state"].values())
        buckets = plan_buckets(size, world, 4, NATIVE_BUCKET_MB).num_buckets
        print(f"  i world {world}: {size} parameters, {buckets} buckets at --bucket-mb "
              f"{NATIVE_BUCKET_MB}")
        if buckets < 3:
            raise RuntimeError(f"i world {world}: {buckets} buckets, fewer than 3")

        def final(key):
            results, history = runs[key]
            return results[0]["state"], history

        finals.update({f"i{world} {key}": final(key) for key in NATIVE_FLAVOURS})

        for key in ("bucketed", "replicated"):
            _dp_compare(f"i{world}: {key} vs monolithic", final(key), final("monolithic"), 0)
        suffix = "g" if world == 1 else "h"
        for key in NATIVE_FLAVOURS:
            reference = dp_finals[f"{suffix} {'replicated' if key == 'replicated' else 'sharded'}"]
            state, history = final(key)
            err = _state_err(state, reference[0])
            print(f"  i{world} {key} vs distributed: params max_abs_err={err:.3e}, "
                  f"tol={DP_TOL_FLAVOURS:g}")
            if err > DP_TOL_FLAVOURS:
                raise RuntimeError(f"i{world} {key}: disagrees with distributed")
            if world == 1:  # the train loss is the rank's own mean: comparable at world 1
                _dp_compare(f"i1 {key} vs distributed (train history)",
                            (state, {"train_history": history["train_history"],
                                     "validation_history": []}),
                            (reference[0], {"train_history": reference[1]["train_history"],
                                            "validation_history": []}), DP_TOL_FLAVOURS)
        if world == 1:
            err = _state_err(final("bucketed")[0], dp_finals["local"][0])
            print(f"  i1 vs local: params max_abs_err={err:.3e}, tol={DP_TOL_LOCAL:g}")
            if err > DP_TOL_LOCAL:
                raise RuntimeError("i1: disagrees with local")
            j = {key: _dp_results(jobs[f"j {key}"], 1, epochs=1) for key in NATIVE_CHAR_FLAVOURS}
            for key, run in j.items():
                _check_dp_launches(f"j {key}", run[0], "lstm", evaluations=0)
                profiled = _dp_results(jobs[f"j {key} profiled"], 1, epochs=1)
                lines[f"j {key}"] = _native_line(f"j {key}", run, profiled)
                kernels, launches = profiled[0][0]["kernels"], profiled[0][0]["launches"]
                for kernel, wrapper in zip(NATIVE_CHAR_KERNELS, ("lstm_fwd", "lstm_bwd")):
                    seen = sum(n for k, n in kernels.items() if kernel in k)
                    if seen != launches[wrapper]:
                        raise RuntimeError(f"j {key}: {kernel} {seen} times in the profile, "
                                           f"{launches[wrapper]} launches")
            size = sum(v.numel() for v in j["bucketed"][0][0]["state"].values())
            print(f"  j: {size} parameters ({size * 4 / 1e6:.1f} MB of float32 gradient), "
                  f"{plan_buckets(size, 1, 4, NATIVE_CHAR_BUCKET_MB).num_buckets} buckets at "
                  f"--bucket-mb {NATIVE_CHAR_BUCKET_MB}; "
                  f"{NATIVE_CHAR_KERNELS} counted in the profile")
            _dp_compare("j: bucketed vs monolithic", (j["bucketed"][0][0]["state"], j["bucketed"][1]),
                        (j["monolithic"][0][0]["state"], j["monolithic"][1]), 0)
        _check_examples(jobs, world)
    print(f"  distributed-native phase: {time.perf_counter() - t0:.1f} s")
    return {"ring_build_s": build_s, "lines": lines, "finals": finals}


PS_FLAGS = ["--epochs", "2", "--seed", "0", "--dropout", "0", "--no-validation"]  # path a's width
PS_TOL_LOCAL = 1e-4  # a parameter-server run's final parameters against local's (PERF.md §2)
PS_TIMEOUT = 300
_MS = r"([\d.]+) / ([\d.]+)"  # mean / median after the first (param_server/runner.py)
PS_MASTER = re.compile(rf"ps master: (\d+) updates \((\w+)\); update ms a call, mean / median "
                       rf"after the first: h2d {_MS}, adam {_MS}, d2h {_MS}, total {_MS}; flat "
                       r"vector (\d+) bytes")
PS_WORKER = re.compile(rf"ps worker (\d+): (\d+) steps in \S+ s; ms a step, mean / median after "
                       rf"the first: host {_MS}, exchange {_MS}; launches (\{{.*\}})")
PS_DIGEST = re.compile(r"(\d+): parameters: (\S+) sha256 (\w+)")


def _ps_check_launches(name: str, launches: dict, steps: int, cell: str, layers: int = 2):
    """A worker launched its cell's forward and backward once a layer a
    step and nothing else."""
    want = {f"{cell}_fwd": steps * layers, f"{cell}_bwd": steps * layers}
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise RuntimeError(f"{name}: launches {got} over {steps} steps, not {want}")


def _ps_world(workdir: Path, name: str, flags: list, world: int, mode: str,
              profile: bool = False, cell: str = "lstm", ps_flags=()) -> dict:
    """One ``parameter-server`` world through the CLI in rank mode on the
    card: rank 1 in this process (its launch counts reset just before it
    and read just after, under ``torch.profiler`` with ``profile``), the
    master and the other workers as CLI processes with ``--rank`` set.  A
    failed rank fails the phase.  Checks every worker's launches against
    its steps and, in sync mode, that every rank ends on the master's
    parameters bit for bit (the sha256 of their bytes).  ``ps_flags`` are
    the subcommand's own."""
    from pytorch_distributed_rnn_tpu_torch import main as port_main
    from pytorch_distributed_rnn_tpu_torch.param_server.runner import (
        flat_parameters,
        parameters_line,
        step_times,
    )
    from pytorch_distributed_rnn_tpu_torch.parallel import launch
    from pytorch_distributed_rnn_tpu_torch.utils.worlds import free_ports

    (port,) = free_ports(1)
    cwd = workdir / "ps" / name
    cwd.mkdir(parents=True)
    argv = [*flags, "parameter-server", "--world-size", str(world), "--ps-mode", mode,
            "--master-port", str(port), *ps_flags]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    procs = {rank: subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.main", *argv, "--rank",
         str(rank)], cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world) if rank != 1}
    capture = _Capture()
    capture.setLevel(logging.DEBUG)
    logging.getLogger().addHandler(capture)
    sigterm = signal.getsignal(signal.SIGTERM)  # the worker installs its drain handler
    level = logging.getLogger().level  # the worker sets the CLI's --log
    here = os.getcwd()
    os.chdir(cwd)
    device_ms = kernels = None
    try:
        _reset_launch_counts()
        one = [*argv, "--rank", "1"]
        if profile:
            trainer, device_us, kernels = launch._profiled(lambda: port_main.main(one),
                                                           torch.device("cuda"))
        else:
            trainer = port_main.main(one)
        torch.cuda.synchronize()
        launches = _launch_counts()
        outs = {rank: proc.communicate(timeout=PS_TIMEOUT) for rank, proc in procs.items()}
    finally:
        os.chdir(here)
        signal.signal(signal.SIGTERM, sigterm)
        logging.getLogger().removeHandler(capture)
        logging.getLogger().setLevel(level)
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    failed = {rank: proc.returncode for rank, proc in procs.items() if proc.returncode != 0}
    if failed:
        for rank in failed:
            print(f"  {name} rank {rank} stderr:\n{outs[rank][1][-4000:]}")
        raise RuntimeError(f"{name}: parameter-server ranks failed: {failed}")
    steps = len(trainer.exchange_log)
    _ps_check_launches(f"{name} worker 1", launches, steps, cell)
    times = step_times(trainer)
    workers = {1: {"steps": steps}}
    for part in ("host", "exchange"):
        seconds = times[part]
        workers[1][f"{part}_ms"] = 1e3 * float(np.mean(seconds))
        workers[1][f"{part}_ms_median"] = 1e3 * float(np.median(seconds[1:] or seconds))
    digests = {1: parameters_line(1, flat_parameters(trainer.model)).rsplit(" ", 1)[1]}
    master = None
    for rank, (_, err) in outs.items():
        for m in PS_WORKER.finditer(err):
            workers[int(m[1])] = _ps_worker_line(m)
            _ps_check_launches(f"{name} worker {m[1]}", json.loads(m[7]), int(m[2]), cell)
        for m in PS_DIGEST.finditer(err):
            digests[int(m[1])] = m[3]
        for m in PS_MASTER.finditer(err):
            master = _ps_master_line(m)
    if master is None or sorted(workers) != list(range(1, world)) or len(digests) != world:
        raise RuntimeError(f"{name}: summary lines missing: master {master}, workers "
                           f"{sorted(workers)}, digests {sorted(digests)}")
    if mode == "sync" and len(set(digests.values())) != 1:
        raise RuntimeError(f"{name}: the ranks end on different parameters: {digests}")
    history = json.loads((cwd / "history.json").read_text())["train_history"]
    if not all(math.isfinite(v) for v in history):
        raise RuntimeError(f"{name}: losses not finite: {history}")
    if profile:
        device_ms = device_us / 1e3 / steps
    run = {"workers": workers, "master": master, "history": history, "device_ms": device_ms,
           "kernels": kernels, "launches": launches, "log": capture.messages,
           "master_log": outs[0][1].splitlines(),
           "state": {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}}
    print(f"  {name}: world {world} {mode}: {steps} steps a worker, history {history}; ms a "
          "step, mean / median after the first: "
          + "; ".join(f"worker {r} host {w['host_ms']:.3f} / {w['host_ms_median']:.3f}, exchange "
                      f"{w['exchange_ms']:.3f} / {w['exchange_ms_median']:.3f}"
                      for r, w in sorted(workers.items()))
          + (f"; worker 1 device {device_ms:.3f} ms a step (profiled)" if profile else "")
          + f"; master {master['updates']} updates, update ms a call "
          + ", ".join(f"{part} {master[f'{part}_ms']:.4f} / {master[f'{part}_ms_median']:.4f}"
                      for part in ("h2d", "adam", "d2h", "update"))
          + f"; flat vector {master['flat_bytes']} bytes; launches {launches}")
    return run


def _ps_worker_line(m) -> dict:
    return {"steps": int(m[2]), "host_ms": float(m[3]), "host_ms_median": float(m[4]),
            "exchange_ms": float(m[5]), "exchange_ms_median": float(m[6])}


def _ps_master_line(m) -> dict:
    line = {"updates": int(m[1]), "flat_bytes": int(m[11])}
    for i, part in enumerate(("h2d", "adam", "d2h", "update")):
        line[f"{part}_ms"], line[f"{part}_ms_median"] = float(m[3 + 2 * i]), float(m[4 + 2 * i])
    return line


def phase_ps(workdir: Path, dp_finals: dict, native_finals: dict) -> dict:
    """``parameter-server`` through the CLI on the card, every rank on the
    one card.  n: the motion LSTM at path a's width (batch 1440, 2 epochs,
    ``--dropout 0 --no-validation``): n.1 sync at world 2 (one worker)
    against ``local`` within 1e-4, plain and profiled (the same bits);
    n.2 sync at world 3 against phase i's world-2 ``distributed-native
    --no-sharded-update`` bit for bit; n.3 async at world 3 in spawn mode
    (the CLI without ``--rank``): it completes, finite losses, the master's
    updates equal the workers' steps; n.4 ``--cell gru`` sync at world 2
    against ``local`` within 1e-4.  o: the char LSTM at path f's flags,
    one epoch, sync at world 2, plain and profiled: finite falling
    per-batch losses, ``lstm_fwd_tc_kernel`` and
    ``lstm_bwd_cluster_kernel`` once a layer a step."""
    from pytorch_distributed_rnn_tpu_torch.utils.worlds import free_ports

    print("main path: parameter-server (n: motion LSTM/GRU at path a's width; o: char LM H=512)")
    t0 = time.perf_counter()
    data = ["--dataset-path", str(workdir / "data")]
    runs = {}

    runs["n1"] = _ps_world(workdir, "n1", [*data, *PS_FLAGS], 2, "sync")
    runs["n1 profiled"] = _ps_world(workdir, "n1-profiled", [*data, *PS_FLAGS], 2, "sync",
                                    profile=True)
    _dp_compare("n.1: profiled vs not", (runs["n1 profiled"]["state"], {
        "train_history": runs["n1 profiled"]["history"], "validation_history": []}),
        (runs["n1"]["state"], {"train_history": runs["n1"]["history"],
                               "validation_history": []}), 0)
    err = _state_err(runs["n1"]["state"], dp_finals["local"][0])
    print(f"  n.1 vs local: params max_abs_err={err:.3e}, tol={PS_TOL_LOCAL:g}")
    if err > PS_TOL_LOCAL:
        raise RuntimeError("n.1: disagrees with local")

    runs["n2"] = _ps_world(workdir, "n2", [*data, *PS_FLAGS], 3, "sync")
    ring_state, ring_history = native_finals["i2 replicated"]
    err = _state_err(runs["n2"]["state"], ring_state)
    same = all(torch.equal(runs["n2"]["state"][k], v.cpu()) for k, v in ring_state.items())
    print(f"  n.2 (sync, 2 workers) vs i world 2 --no-sharded-update: "
          f"{'bit for bit' if same else f'params max_abs_err={err:.3e}'}; train history "
          f"{runs['n2']['history']} vs {ring_history['train_history']}")
    if not same:
        raise RuntimeError("n.2: the parameter server's sync update differs from the ring's")

    print("  n.3: async at world 3 in spawn mode (the CLI without --rank)")
    spawn_dir = workdir / "ps" / "n3"
    spawn_dir.mkdir(parents=True)
    (port,) = free_ports(1)
    t_spawn = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.main",
                           *data, *PS_FLAGS, "parameter-server", "--world-size", "3",
                           "--ps-mode", "async", "--master-port", str(port)],
                          cwd=spawn_dir, capture_output=True, text=True, timeout=PS_TIMEOUT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    spawn_s = time.perf_counter() - t_spawn
    if proc.returncode != 0:
        print(proc.stderr[-6000:])
        raise RuntimeError(f"n.3: the spawn-mode world exited {proc.returncode}")
    master = PS_MASTER.search(proc.stderr)
    workers = {int(m[1]): _ps_worker_line(m) for m in PS_WORKER.finditer(proc.stderr)}
    history = json.loads((spawn_dir / "history.json").read_text())["train_history"]
    if master is None or sorted(workers) != [1, 2]:
        raise RuntimeError(f"n.3: summary lines missing:\n{proc.stderr[-4000:]}")
    master = _ps_master_line(master)
    for m in PS_WORKER.finditer(proc.stderr):
        _ps_check_launches(f"n.3 worker {m[1]}", json.loads(m[7]), int(m[2]), "lstm")
    if master["updates"] != sum(w["steps"] for w in workers.values()):
        raise RuntimeError(f"n.3: {master['updates']} updates for {workers}")
    if not all(math.isfinite(v) for v in history):
        raise RuntimeError(f"n.3: losses not finite: {history}")
    runs["n3"] = {"master": master, "history": history, "workers": workers, "wall_s": spawn_s}
    print(f"  n.3: exit 0 in {spawn_s:.1f} s; {master['updates']} updates = "
          f"{' + '.join(str(w['steps']) for w in workers.values())} worker steps; history "
          f"{history}; workers {workers}; master {master}")

    trainer, _, _, _ = _drive(workdir, _dp_job(workdir, "local-gru", ["--cell", "gru",
                                                                      "local"])["argv"])
    local_gru = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    runs["n4"] = _ps_world(workdir, "n4", [*data, *PS_FLAGS, "--cell", "gru"], 2, "sync",
                           cell="gru")
    err = _state_err(runs["n4"]["state"], local_gru)
    print(f"  n.4 (--cell gru) vs local: params max_abs_err={err:.3e}, tol={PS_TOL_LOCAL:g}")
    if err > PS_TOL_LOCAL:
        raise RuntimeError("n.4: disagrees with local")

    char = [*GRAPH_PATHS["f"], "--dataset-path", str(workdir / "no-corpus"), "--epochs", "1",
            "--seed", "0", "--no-validation"]
    runs["o"] = _ps_world(workdir, "o", [*char, "--log", "DEBUG"], 2, "sync")
    losses = [float(m[1]) for m in (re.search(r"Loss: (\S+)", line) for line in runs["o"]["log"]
                                    if "Train Batch" in line) if m]
    print(f"  o: per-batch losses of worker 1 {losses}")
    if not losses or not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        raise RuntimeError(f"o: the char LM's losses do not fall: {losses}")
    runs["o profiled"] = _ps_world(workdir, "o-profiled", char, 2, "sync", profile=True)
    # which kernels ran comes from the profile, how often from the counts
    # (checked once a layer a step): a profile may drop a record
    rnn = {m[1] for k in runs["o profiled"]["kernels"]
           if (m := re.search(r"\b(lstm_(?:fwd|bwd)\w*)", k))}
    if rnn != set(NATIVE_CHAR_KERNELS):
        raise RuntimeError(f"o: the profile's LSTM kernels {rnn}, not {NATIVE_CHAR_KERNELS}")
    print(f"  o: the profile's LSTM kernels {sorted(rnn)}, once a layer a step")
    summary = {name: {k: v for k, v in run.items() if k not in ("state", "log", "kernels")}
               for name, run in runs.items()}
    summary["seconds"] = time.perf_counter() - t0
    print(f"  parameter-server phase: {summary['seconds']:.1f} s")
    print("parameter-server: " + json.dumps(summary))
    return summary


# phase p: the resilience and memory flags on the existing kernels
RESILIENCE_ACCUM_RTOL = 1e-5  # --grad-accum 4 against the single shot (float reassociation)
NET_DELAY_MS = 5.0  # p.5's net:delay, a sleep before every send of the ring
# the ring's sends a step of path i's bucketed sharded update at world 2
# under the guard (runtime/csrc/collectives.cpp: a reduce-scatter sends
# world - 1 ring steps and one rotation hop, an all-gather world - 1 ring
# steps, an allreduce 2 (world - 1)): 3 buckets x (2 + 1), and the verdict's
# allreduce of one element, 2
RING_SENDS_A_STEP = 3 * (2 + 1) + 2
P_TIMEOUT = 600
_PARITY = re.compile(r"(\d+): parameters: (\S+)")
_PERF = re.compile(r"(\d+): Memory Usage: \S+, Training Duration: (\S+)")
_RING = re.compile(r"(\d+): ring: (\d+) updates, comm_wait_s (\S+), comm_active_s (\S+)")


def _flat(trainer) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in trainer.model.parameters()]).clone()


def _p_guard(workdir: Path, formatter) -> dict:
    """p.1: path a with and without ``--max-bad-steps 2``, the same bits and
    each run's device ms a step; p.2: NaN steps 3 and 4 skipped (the
    parameters after step 4 are those after step 2), a third in a row
    aborts."""
    from pytorch_distributed_rnn_tpu_torch.resilience import NonFiniteAbort

    out = {}
    trainers = {name: _cli_trainer(workdir, _graph_argv(workdir, "a", extra), epochs=2)
                for name, extra in (("plain", []), ("guarded", ["--max-bad-steps", "2"]))}
    _same_bits("p.1 guarded vs plain", trainers["plain"], trainers["guarded"])
    # a third epoch of graph replays, unprofiled: a profile that drops a
    # kernel record trains its epoch again, so no bits are read after one
    for trainer in trainers.values():
        trainer._train_epoch(formatter, eager=False)
    _same_bits("p.1 guarded vs plain, after the third epoch", trainers["plain"],
               trainers["guarded"])
    if trainers["guarded"].optimizer.nonfinite.read() != (0, 0):
        raise RuntimeError("p.1: the guard counted a skip on finite steps")
    steps = len(trainers["plain"]._epoch_index_batches())
    for name, trainer in trainers.items():
        ms, _, launches = _profile_steps(lambda t=trainer: t._train_epoch(formatter, eager=False),
                                         steps)
        out[f"{name}_device_ms"] = ms
    print(f"  p.1 path a, 3 epochs on the graph path: --max-bad-steps 2 gives the plain run's "
          f"parameters and Adam state bit for bit; device ms a step plain "
          f"{out['plain_device_ms']:.4f}, guarded {out['guarded_device_ms']:.4f} (+"
          f"{out['guarded_device_ms'] - out['plain_device_ms']:.4f}); launches of the guarded "
          f"epoch {launches}")
    del trainers

    trainer = _cli_trainer(workdir, _graph_argv(workdir, "a", [
        "--faults", "step:3:nan,step:4:nan", "--max-bad-steps", "2"]))
    snapshots = []
    step = trainer._optimizer_step

    def recorded():
        step()
        snapshots.append(_flat(trainer))

    trainer._optimizer_step = recorded
    trainer.train(epochs=2)
    consecutive, total = trainer.optimizer.nonfinite.read()
    if (trainer.guard.total_skipped, total) != (2, 2) or trainer._faults.fired != {"nan": 2}:
        raise RuntimeError(f"p.2: skipped {trainer.guard.total_skipped} / counted {total}, "
                           f"fired {trainer._faults.fired}")
    if not torch.equal(snapshots[4], snapshots[2]) or torch.equal(snapshots[2], snapshots[1]):
        raise RuntimeError("p.2: the parameters after step 4 are not those after step 2")
    if not torch.isfinite(snapshots[-1]).all():
        raise RuntimeError("p.2: parameters not finite")
    print(f"  p.2 --faults step:3:nan,step:4:nan --max-bad-steps 2: {total} skipped steps "
          f"(consecutive now {consecutive}), the parameters after step 4 equal those after "
          f"step 2 bit for bit, {len(snapshots)} steps, Adam's count "
          f"{float(trainer.optimizer.device_steps):g}")
    out["p2_skipped"] = total
    del trainer
    try:
        _cli_trainer(workdir, _graph_argv(workdir, "a", [
            "--faults", "step:3:nan,step:4:nan,step:5:nan", "--max-bad-steps", "2"]), epochs=2)
    except NonFiniteAbort as exc:
        print(f"  p.2 step:3:nan,step:4:nan,step:5:nan: NonFiniteAbort: {exc}")
        out["abort"] = str(exc)
    else:
        raise RuntimeError("p.2: three NaN steps in a row did not abort")
    return out


def _p_resume(workdir: Path) -> dict:
    """p.3: path a at the CLI's dropout 0.1, validation on, 3 epochs,
    ``--checkpoint-every 1``: killed by ``epoch:2:kill`` (exit -9), its
    newest checkpoint truncated, run again with ``--resume auto``: the
    uninterrupted run's parameters and last validation loss bit for bit."""
    from pytorch_distributed_rnn_tpu_torch import main as port_main
    from pytorch_distributed_rnn_tpu_torch.training.checkpoint import checkpoint_candidates

    root = workdir / "p3"
    base = ["--dataset-path", str(workdir / "data"), "--epochs", "3", "--seed", "0",
            "--checkpoint-every", "1"]
    runs = {}
    for name in ("reference", "killed", "resumed"):
        (root / name).mkdir(parents=True)
    reference = _cli_trainer(root / "reference", [
        *base, "--checkpoint-directory", str(root / "models-ref"), "local"], epochs=3)
    runs["reference"] = json.loads((root / "reference" / "history.json").read_text())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.main", *base,
                           "--checkpoint-directory", str(root / "models"), "--faults",
                           "epoch:2:kill", "local"], cwd=root / "killed", env=env,
                          capture_output=True, text=True, timeout=P_TIMEOUT)
    if proc.returncode != -9:
        print(proc.stderr[-4000:])
        raise RuntimeError(f"p.3: the killed run exited {proc.returncode}, not -9")
    newest, *older = checkpoint_candidates(root / "models")
    if newest.name != "checkpoint-epoch-2.ckpt":
        raise RuntimeError(f"p.3: checkpoints after the kill {[newest, *older]}")
    newest.write_bytes(newest.read_bytes()[:1000])
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    here = os.getcwd()
    os.chdir(root / "resumed")
    try:
        resumed = port_main.main([*base, "--checkpoint-directory", str(root / "models"),
                                  "--resume", "auto", "local"])
    finally:
        os.chdir(here)
        logging.getLogger().removeHandler(capture)
    runs["resumed"] = json.loads((root / "resumed" / "history.json").read_text())
    fallback = [m for m in capture.messages if "skipping corrupt checkpoint" in m]
    restored = [m for m in capture.messages if "auto-resume: restored" in m]
    if not fallback or not restored or "checkpoint-epoch-1.ckpt" not in restored[0]:
        raise RuntimeError(f"p.3: no fallback past the truncated checkpoint: {restored}")
    _same_bits("p.3 resumed vs uninterrupted", reference, resumed)
    ref_valid, valid = runs["reference"]["validation_history"], runs["resumed"]["validation_history"]
    if valid != ref_valid[1:]:
        raise RuntimeError(f"p.3: validation losses {valid} against {ref_valid}")
    print(f"  p.3 killed at epoch 2 (exit -9, {time.perf_counter() - t0:.1f} s with its start), "
          f"checkpoint-epoch-2 truncated: --resume auto logged '{fallback[0][:80]}...', "
          f"restored epoch 1, trained epochs 1-2; parameters and Adam state equal the "
          f"uninterrupted run's bit for bit, last validation loss {valid[-1]!r} == "
          f"{ref_valid[-1]!r}")
    return {"validation": valid[-1]}


def _p_memory(workdir: Path, formatter) -> dict:
    """p.4: path f (char LSTM, H=512, T=128, batch 256) plain, ``--remat``,
    ``--grad-accum 4`` and both, two epochs each on the graph path and
    then a profiled one: the peak memory of the first, device ms and
    kernel launches a step of the profiled one; after the second, remat ==
    plain and both == accum bit for bit, accum within
    ``RESILIENCE_ACCUM_RTOL`` of plain.  Then path d
    (attention, flash f32) at dropout 0.1 with and without ``--remat``, bit
    for bit."""
    import gc

    levers = {"plain": [], "remat": ["--remat"], "accum": ["--grad-accum", "4"],
              "both": ["--remat", "--grad-accum", "4"]}
    out, finals = {}, {}
    for name, extra in levers.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer = _cli_trainer(workdir, _graph_argv(workdir, "f", extra), epochs=1)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        # the second epoch, unprofiled, gives the bits compared: a profile
        # that drops a kernel record trains its epoch again
        trainer._train_epoch(formatter, eager=False)
        finals[name] = _flat(trainer).cpu()
        steps = len(trainer._epoch_index_batches())
        device_ms, _, launches = _profile_steps(
            lambda t=trainer: t._train_epoch(formatter, eager=False), steps)
        history = json.loads((workdir / "history.json").read_text())["train_history"]
        per_step = {k: v / steps for k, v in launches.items()}
        out[name] = {"peak_mib": peak / 2**20, "device_ms": device_ms, "launches": per_step,
                     "loss": history[0]}
        print(f"  p.4 path f {name}: peak {peak / 2**20:.1f} MiB over the first epoch (max "
              f"allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB); device "
              f"{device_ms:.3f} ms a step; launches a step {per_step}")
        del trainer
    layers = 2
    want = {"plain": (1, 1), "remat": (2, 1), "accum": (4, 4), "both": (8, 4)}
    for name, (fwd, bwd) in want.items():
        got = out[name]["launches"]
        if got.get("lstm_fwd") != fwd * layers or got.get("lstm_bwd") != bwd * layers:
            raise RuntimeError(f"p.4 {name}: launches a step {got}, not {fwd} forward and {bwd} "
                               "backward a layer")
    if not torch.equal(finals["remat"], finals["plain"]):
        raise RuntimeError("p.4: --remat does not give the plain run's bits")
    if not torch.equal(finals["both"], finals["accum"]):
        raise RuntimeError("p.4: --remat --grad-accum 4 does not give --grad-accum 4's bits")
    rel = abs(out["accum"]["loss"] - out["plain"]["loss"]) / abs(out["plain"]["loss"])
    err = float((finals["accum"] - finals["plain"]).abs().max())
    if rel > RESILIENCE_ACCUM_RTOL:
        raise RuntimeError(f"p.4: --grad-accum 4's loss {out['accum']['loss']} against "
                           f"{out['plain']['loss']}")
    print(f"  p.4 bits: remat == plain, both == accum; accum's first-epoch loss within "
          f"{rel:.2e} of plain's (bar {RESILIENCE_ACCUM_RTOL:g}), parameters within {err:.3e}")
    out["accum_rel"] = rel

    trainers = {name: _cli_trainer(workdir, _graph_argv(workdir, "d", ["--dropout", "0.1",
                                                                      *extra]), epochs=1)
                for name, extra in (("plain", []), ("remat", ["--remat"]))}
    _same_bits("p.4 path d --remat vs plain at dropout 0.1", trainers["plain"],
               trainers["remat"])
    print("  p.4 path d (attention, flash f32) at dropout 0.1: --remat gives the plain run's "
          "parameters and Adam state bit for bit")
    return out


def _native_p5(workdir: Path, name: str, faults: str) -> dict:
    """Path i's bucketed sharded update at world 2 on the card, each rank a
    CLI process (``native_ddp.launch_world``), with ``--faults FAULTS
    --max-bad-steps 2``: each rank's skip, parity line and host ms a step,
    and rank 0's final parameters (its checkpoint of epoch 2)."""
    from pytorch_distributed_rnn_tpu_torch.training import native_ddp
    from pytorch_distributed_rnn_tpu_torch.training.checkpoint import load_checkpoint

    cwd = workdir / "p5" / name
    cwd.mkdir(parents=True)
    argv = ["--dataset-path", str(workdir / "data"), "--epochs", "2", "--seed", "0",
            "--dropout", "0", "--no-validation", "--bucket-mb", str(NATIVE_BUCKET_MB),
            "--checkpoint-every", "2", "--checkpoint-directory", "models",
            "--faults", faults, "--max-bad-steps", "2"]
    t0 = time.perf_counter()
    results = native_ddp.launch_world(2, argv, device="cuda", cwd=cwd, timeout=P_TIMEOUT)
    wall = time.perf_counter() - t0
    ranks = {}
    for rank, (_, _, err) in enumerate(results):
        skipped = [line for line in err.splitlines() if "skipped 1 step(s)" in line]
        parity = {int(r): v for r, v in _PARITY.findall(err)}
        perf = {int(r): float(v) for r, v in _PERF.findall(err)}
        ring = {int(m[0]): (int(m[1]), float(m[2]), float(m[3])) for m in _RING.findall(err)}
        if len(skipped) != 1 or rank not in parity or rank not in perf or rank not in ring:
            print(err[-4000:])
            raise RuntimeError(f"p.5 {name} rank {rank}: skips {skipped}, parity {parity}")
        ranks[rank] = {"parity": parity[rank], "duration_s": perf[rank],
                       "comm_wait_ms": 1e3 * ring[rank][1], "comm_active_ms": 1e3 * ring[rank][2]}
    if ranks[0]["parity"] != ranks[1]["parity"]:
        raise RuntimeError(f"p.5 {name}: rank parity lines differ: {ranks}")
    steps = 2 * 5  # 3264 rows a rank: 4 batches of 720 and one of 384 an epoch
    state, _, _ = load_checkpoint(cwd / "models" / "checkpoint-epoch-2.ckpt")
    host_ms = [r["duration_s"] * 1e3 / steps for r in ranks.values()]
    wait_ms = [r["comm_wait_ms"] for r in ranks.values()]
    print(f"  p.5 {name} (--faults {faults}): both ranks skipped step 3, parity lines "
          f"{ranks[0]['parity']} on both; host ms a step (training duration / {steps}) rank 0 "
          f"{host_ms[0]:.3f}, rank 1 {host_ms[1]:.3f}; the ring's comm_wait ms an update "
          f"{wait_ms[0]:.3f} / {wait_ms[1]:.3f}, comm_active ms "
          f"{ranks[0]['comm_active_ms']:.3f} / {ranks[1]['comm_active_ms']:.3f}; world "
          f"{wall:.1f} s")
    return {"host_ms": host_ms, "comm_wait_ms": wait_ms, "state": state,
            "parity": ranks[0]["parity"]}


def _p_data_parallel(workdir: Path) -> dict:
    """p.5: NaN on rank 1's step 3 under ``distributed-native`` at world 2
    (bucketed, sharded), plain and with ``net:delay``; ``distributed`` at
    world 1 on NCCL (in this process) against ``local`` with the same
    NaN schedule."""
    out = {}
    runs = {name: _native_p5(workdir, name, faults) for name, faults in (
        ("nan", "step:3:nan@1"), ("delay", f"step:3:nan@1,net:delay:{NET_DELAY_MS:g}"))}
    for key, value in runs["nan"]["state"].items():
        if not torch.equal(value, runs["delay"]["state"][key]):
            raise RuntimeError(f"p.5: net:delay changed parameter {key}")
    rise = [d - n for d, n in zip(runs["delay"]["host_ms"], runs["nan"]["host_ms"])]
    wait_rise = [d - n for d, n in zip(runs["delay"]["comm_wait_ms"], runs["nan"]["comm_wait_ms"])]
    expected = NET_DELAY_MS * RING_SENDS_A_STEP
    print(f"  p.5 net:delay:{NET_DELAY_MS:g}: the same parameters bit for bit; host ms a step "
          f"rose by {rise[0]:.3f} (rank 0) and {rise[1]:.3f} (rank 1), the ring's comm_wait "
          f"ms an update by {wait_rise[0]:.3f} and {wait_rise[1]:.3f}, against "
          f"{NET_DELAY_MS:g} ms x {RING_SENDS_A_STEP} ring sends a step = {expected:g} ms")
    out["native"] = {name: {k: v for k, v in run.items() if k != "state"}
                     for name, run in runs.items()}
    out["delay_rise_ms"] = rise
    out["delay_wait_rise_ms"] = wait_rise

    flags = ["--no-validation", "--dropout", "0", "--faults", "step:3:nan",
             "--max-bad-steps", "2"]
    local = _cli_trainer(workdir, _graph_argv(workdir, "a", flags), epochs=2)
    world1 = _cli_trainer(workdir, [*_graph_argv(workdir, "a", flags)[:-1], "distributed"],
                          epochs=2)
    if world1.guard.total_skipped != 1 or local.guard.total_skipped != 1:
        raise RuntimeError(f"p.5: distributed skipped {world1.guard.total_skipped}, local "
                           f"{local.guard.total_skipped}")
    err = max(float((a - b).abs().max()) for a, b in zip(local.model.state_dict().values(),
                                                         world1.model.state_dict().values()))
    if err > DP_TOL_LOCAL:
        raise RuntimeError(f"p.5: distributed at world 1 against local: {err}")
    print(f"  p.5 distributed at world 1 on {world1.group.backend}: 1 skip; parameters against "
          f"local's same run max abs err {err:.3e} ({'bit for bit' if err == 0 else 'bar'} "
          f"{DP_TOL_LOCAL:g})")
    out["world1_err"] = err
    return out


def phase_resilience(workdir: Path, formatter) -> dict:
    """Phase p, the resilience and memory flags on the existing kernels:
    p.1 the guard on finite steps (path a), p.2 NaN steps skipped and the
    abort past K, p.3 a kill and ``--resume auto`` past a truncated
    checkpoint (path a at dropout 0.1), p.4 ``--remat`` and ``--grad-accum``
    at path f's width (and ``--remat`` on path d), p.5 the faults over data
    parallel."""
    print("phase p: --max-bad-steps, --faults, --resume auto, --grad-accum, --remat")
    t0 = time.perf_counter()
    out = {"guard": _p_guard(workdir, formatter), "resume": _p_resume(workdir),
           "memory": _p_memory(workdir, formatter), "dp": _p_data_parallel(workdir)}
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase p: {out['seconds']:.1f} s")
    print("resilience: " + json.dumps(out, default=str))
    return out


Q_EPOCHS = 3  # q.1: path a's runs
Q_SAMPLE_EVERY = 5  # q.1: --metrics-sample-every
Q_TURNS = ("plain", "metrics", "metrics", "plain")  # q.1: its runs, in turns
Q_PROFILE_STEPS = (3, 6)  # q.2: --profile-steps on path a
H100_F32_PEAK = 67e12  # utils/hw.py's H100 entry for --precision f32
# q.4: path f's stall (step, seconds), longer than the watchdog's threshold,
# then a shorter one that holds the run while the watchdog sees the
# progress move on.  A step's stall runs in the prefetch producer, whose
# queue holds 2 batches: batch k's stall starts as step k - 3 starts (at
# once for k < 3, overlapping the run's start, not a wait between steps)
Q_STALL = (4, 3.0)
Q_HOLD = (6, 0.8)
Q_WATCHDOG_STALL_S = 1.0
Q_TIMEOUT = 600
_DIGEST = re.compile(r"(\d+): parameters sha256 (\w+)")


@contextlib.contextmanager
def _epoch_clock(walls: list):
    """Each local ``_train_epoch`` timed on the host clock from a device
    sync to a device sync, appended to ``walls`` as (seconds, steps)."""
    from pytorch_distributed_rnn_tpu_torch.training.base import Trainer

    original = Trainer._train_epoch

    def timed(self, formatter, eager=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(self, formatter, eager)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0, len(self._epoch_index_batches())))
        return out

    Trainer._train_epoch = timed
    try:
        yield walls
    finally:
        Trainer._train_epoch = original


@contextlib.contextmanager
def _environ(**values):
    saved = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def _obs_cli(argv: list) -> str:
    """The port's ``python -m pytorch_distributed_rnn_tpu_torch.obs`` in
    this process; returns what it printed, and fails on a nonzero exit."""
    import io

    from pytorch_distributed_rnn_tpu_torch.obs.cli import main as obs_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = obs_main(argv)
    if rc != 0:
        raise RuntimeError(f"obs {' '.join(argv)} exited {rc}: {out.getvalue()[-2000:]}")
    return out.getvalue()


def _cli_process(cwd: Path, argv: list, epochs: int) -> str:
    """``main ... `` in a fresh process (its profile windows early in its
    life, where no device record goes missing: ``PERF.md`` §7); returns
    its log, and fails on a nonzero exit."""
    cwd.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.main",
                           "--epochs", str(epochs), *argv], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=Q_TIMEOUT)
    if proc.returncode != 0:
        print(proc.stderr[-4000:])
        raise RuntimeError(f"{' '.join(argv[-6:])}: exit {proc.returncode}")
    return proc.stderr


def _trace_device_ms(path: Path, steps: int) -> float:
    """Device ms a step of a Chrome trace: its kernels, copies and sets,
    not the device spans of user annotations (``utils/ab.py:
    device_events``)."""
    events = json.loads(path.read_text())["traceEvents"]
    us = sum(e.get("dur", 0) for e in events
             if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    return us / 1e3 / steps


def _q_sidecar(path: Path, steps: int) -> dict:
    """q.1's checks of path a's sidecar: the meta line first, one step
    event a step, ``fenced_s`` on the sampled steps only, epochs on the
    graph path, and the run summary's ledger block on the H100's entry;
    returns the ledger's MFU and the events' counts."""
    from pytorch_distributed_rnn_tpu_torch.obs import ledger as obs_ledger
    from pytorch_distributed_rnn_tpu_torch.obs.summary import load_events

    events = load_events(path)
    if events[0]["kind"] != "meta" or events[0]["schema"] != 2:
        raise RuntimeError(f"q.1: the sidecar's first line is {events[0]}")
    step_events = [e for e in events if e["kind"] == "step"]
    if [e["step"] for e in step_events] != list(range(steps)):
        raise RuntimeError(f"q.1: step events {[e['step'] for e in step_events]}, {steps} steps")
    sampled = [e["step"] for e in step_events if e["fenced_s"] is not None]
    want = [s for s in range(steps) if s == 1 or s % Q_SAMPLE_EVERY == 0]
    if sampled != want:
        raise RuntimeError(f"q.1: fenced_s on steps {sampled}, not {want}")
    paths = [e["path"] for e in events if e["kind"] == "epoch"]
    if paths != ["step"] * Q_EPOCHS:
        raise RuntimeError(f"q.1: epoch paths {paths}")
    run = [e for e in events if e["kind"] == "run_summary"][-1]["ledger"]
    if ("H100" not in str(run["device_kind"]) or run["peak_flops_total"] != H100_F32_PEAK
            or run["peak_flops_estimated"] or not run["model_flops_per_step"]):
        raise RuntimeError(f"q.1: the run summary's ledger block {run}")
    aggregate = obs_ledger.ledger_run(path)["aggregate"]
    if not aggregate["mfu_est"] or aggregate["mfu_est"] <= 0:
        raise RuntimeError(f"q.1: the ledger's MFU {aggregate}")
    counts = {}
    for e in events:
        counts[e["kind"]] = counts.get(e["kind"], 0) + 1
    compiles = [(e["step"], round(e["seconds"] * 1e3, 3)) for e in events if e["kind"] == "compile"]
    count_s = [e["count_s"] for e in events if e["kind"] == "collectives"][0]
    return {"mfu": aggregate["mfu_est"], "goodput": aggregate["goodput"], "counts": counts,
            "flops_per_step": run["model_flops_per_step"], "compiles": compiles,
            "flop_count_s": count_s}


def _q_metrics(workdir: Path, formatter) -> dict:
    """q.1: path a (graph path, 3 epochs) without and with ``--metrics
    --metrics-sample-every 5``, in turns (plain, metrics, metrics,
    plain): the same parameters and Adam state bit for bit, host ms a step
    over the epochs after the first (the captures' epoch; twice each in
    turns, compared by their medians), the sidecar's
    checks, and the port's CLI ``summarize`` and ``ledger`` over it; then
    each once more in a fresh process with ``--profile-steps`` over epochs
    2-3: device ms a step from its trace, which must hold each LSTM kernel
    once a layer a step (a late window in this process loses records)."""
    root = workdir / "q1"
    root.mkdir()
    host = {"plain": [], "metrics": []}
    trainers, sidecar = {}, None
    for i, mode in enumerate(Q_TURNS):
        extra = []
        if mode == "metrics":
            sidecar = root / f"m{i}.jsonl"
            extra = ["--metrics", str(sidecar), "--metrics-sample-every", str(Q_SAMPLE_EVERY)]
        walls = []
        with _epoch_clock(walls):
            trainer = _cli_trainer(root, _graph_argv(workdir, "a", extra), epochs=Q_EPOCHS)
        host[mode].append(sum(w for w, _ in walls[1:]) * 1e3 / sum(s for _, s in walls[1:]))
        trainers.setdefault(mode, trainer)
    _same_bits("q.1 --metrics vs plain", trainers["plain"], trainers["metrics"])
    steps = len(trainers["plain"]._epoch_index_batches())
    sidecar_out = _q_sidecar(sidecar, Q_EPOCHS * steps)
    device = {}
    window = (steps, Q_EPOCHS * steps)  # epochs 2-3: replays only
    for mode in ("plain", "metrics"):
        trace_dir = root / f"trace-{mode}"
        extra = ["--profile", str(trace_dir), "--profile-steps", f"{window[0]}:{window[1]}"]
        if mode == "metrics":
            extra += ["--metrics", str(root / "profiled.jsonl"), "--metrics-sample-every",
                      str(Q_SAMPLE_EVERY)]
        _cli_process(root / f"process-{mode}", _graph_argv(workdir, "a", extra), Q_EPOCHS)
        trace = trace_dir / f"steps-{window[0]}-{window[1]}.json"
        counts = _trace_kernels(trace)
        want = 2 * (window[1] - window[0])
        if counts != {"lstm_fwd": want, "lstm_bwd": want}:
            raise RuntimeError(f"q.1 {mode}: the trace of steps {window} holds {counts}")
        device[mode] = _trace_device_ms(trace, window[1] - window[0])
    median = {mode: sorted(v)[len(v) // 2] for mode, v in host.items()}
    summarize = _obs_cli(["summarize", str(sidecar)])
    ledger_text = _obs_cli(["ledger", str(sidecar)])
    print(f"  q.1 path a, {Q_EPOCHS} epochs of {steps} steps on the graph path: parameters and "
          f"Adam state with --metrics equal the plain run's bit for bit; host ms a step (epochs "
          f"2-{Q_EPOCHS}) plain {host['plain']}, metrics {host['metrics']} (medians: plain "
          f"{median['plain']:.4f}, metrics {median['metrics']:.4f}, difference "
          f"{median['metrics'] - median['plain']:+.4f} ms); device ms a "
          f"step (steps {window[0]}-{window[1] - 1} of a fresh process's --profile-steps trace, "
          f"its LSTM kernels once a layer a step) plain {device['plain']:.4f}, metrics "
          f"{device['metrics']:.4f} (difference {device['metrics'] - device['plain']:+.4f})")
    print(f"  q.1 sidecar: {sidecar_out['counts']}; compile events (step, capture ms) "
          f"{sidecar_out['compiles']}; model FLOPs a step {sidecar_out['flops_per_step']} "
          f"(counted in {sidecar_out['flop_count_s']:.3f} s before the first step); ledger MFU "
          f"{sidecar_out['mfu']:.6e} against the H100's {H100_F32_PEAK:g} f32 peak, "
          f"goodput {sidecar_out['goodput']:.4f}")
    print("  q.1 obs summarize:\n" + "\n".join("    " + line for line in summarize.splitlines()))
    print("  q.1 obs ledger:\n" + "\n".join("    " + line for line in ledger_text.splitlines()))
    return {"host_ms": host, "device_ms": device, "steps": steps, **sidecar_out}


def _trace_kernels(path: Path) -> dict:
    """The port's kernels among a Chrome trace's kernel events, counted by
    wrapper name."""
    counts = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "kernel" and (m := _KERNEL_EVENT.search(e.get("name", ""))):
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def _q_profile(workdir: Path) -> dict:
    """q.2, each run a fresh CLI process, both at once: ``--profile-steps
    3:6`` on path a: its trace holds each LSTM kernel 3 x 2 times (a
    forward and a backward a layer a step) and the ``profile`` event says
    captured; ``--profile DIR`` over path d's run (one epoch): its trace
    lists the flash kernels, a forward and a ``flash_dqkv`` a layer a step
    (the sidecar's steps)."""
    from concurrent.futures import ThreadPoolExecutor

    from pytorch_distributed_rnn_tpu_torch.obs.summary import load_events

    root = workdir / "q2"
    root.mkdir()
    start, stop = Q_PROFILE_STEPS
    trace_dir = root / "trace-a"
    runs = {"a": (_graph_argv(workdir, "a", [
                "--profile", str(trace_dir), "--profile-steps", f"{start}:{stop}",
                "--metrics", str(root / "m.jsonl")]), 2),
            "d": (_graph_argv(workdir, "d", ["--profile", str(root / "trace-d"), "--metrics",
                                             str(root / "d.jsonl")]), 1)}
    with ThreadPoolExecutor(2) as pool:
        for done in [pool.submit(_cli_process, root / f"process-{path}", argv, epochs)
                     for path, (argv, epochs) in runs.items()]:
            done.result()
    counts = _trace_kernels(trace_dir / f"steps-{start}-{stop}.json")
    want = {"lstm_fwd": 2 * (stop - start), "lstm_bwd": 2 * (stop - start)}
    profile = [e for e in load_events(root / "m.jsonl") if e["kind"] == "profile"]
    if counts != want:
        raise RuntimeError(f"q.2: the trace of steps {start}:{stop} holds {counts}, not {want}")
    if len(profile) != 1 or not profile[0]["captured"] or profile[0]["start"] != start:
        raise RuntimeError(f"q.2: profile events {profile}")
    print(f"  q.2 path a --profile-steps {start}:{stop}: the trace's kernels {counts} (one "
          f"forward and one backward a layer a step); profile event {profile[0]}")
    steps = sum(1 for e in load_events(root / "d.jsonl") if e["kind"] == "step")
    want = {"flash_fwd": ATTN_DEPTH * steps, "flash_dqkv": ATTN_DEPTH * steps}
    seen = _trace_kernels(root / "trace-d" / "trace.json")
    if seen != want:
        raise RuntimeError(f"q.2: path d's trace holds {seen}, its {steps} steps launch {want}")
    print(f"  q.2 path d --profile (1 epoch, {steps} steps): the trace's kernels "
          f"{seen}, a forward and a flash_dqkv a layer a step")
    return {"a": counts, "d": seen}


def _q_world(cwd: Path, argv: list, check: bool = True) -> list:
    from pytorch_distributed_rnn_tpu_torch.training import native_ddp

    cwd.mkdir(parents=True, exist_ok=True)
    return native_ddp.launch_world(2, argv, device="cuda", cwd=cwd, timeout=Q_TIMEOUT,
                                   check=check)


def _q_native(workdir: Path) -> dict:
    """q.3: ``distributed-native`` at world 2 sharing the card (path i's
    bucketed sharded update) at dropout 0.1, 3 epochs, a checkpoint an
    epoch: with ``--metrics`` (rank-suffixed sidecars, ``comm_wait_s`` in
    every step event, the two ranks' timeline passes its validator), and
    at the same time the same run killed by ``epoch:1:kill``; then the
    killed run with ``--resume auto``: parameters and Adam state (the
    final checkpoints) and each rank's parameter digest equal the
    uninterrupted run's bit for bit (ROADMAP C6)."""
    from concurrent.futures import ThreadPoolExecutor

    from pytorch_distributed_rnn_tpu_torch.obs import timeline
    from pytorch_distributed_rnn_tpu_torch.obs.summary import load_events
    from pytorch_distributed_rnn_tpu_torch.training.checkpoint import load_checkpoint

    root = workdir / "q3"
    base = ["--dataset-path", str(workdir / "data"), "--epochs", "3", "--seed", "0",
            "--no-validation", "--bucket-mb", str(NATIVE_BUCKET_MB), "--dropout", "0.1",
            "--checkpoint-every", "1", "--checkpoint-directory", "models"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_q_world, root / "ref", [*base, "--metrics", "m.jsonl",
                                                   "--metrics-sample-every", "5"])
        killed = pool.submit(_q_world, root / "killed", [*base, "--faults", "epoch:1:kill"],
                             False)
        ref, killed = ref.result(), killed.result()
    if [rc for rc, _, _ in killed] != [-9, -9]:
        print(killed[0][2][-4000:])
        raise RuntimeError(f"q.3: the killed world exited {[rc for rc, _, _ in killed]}")
    resumed = _q_world(root / "killed", [*base, "--resume", "auto"])
    wall = time.perf_counter() - t0
    logs = "".join(err for _, _, err in resumed)
    if "auto-resume: restored" not in logs or "holds no dropout stream" in logs:
        raise RuntimeError(f"q.3: the resumed world's logs: {logs[-3000:]}")
    digests = {name: {int(r): d for run in results for r, d in _DIGEST.findall(run[2])}
               for name, results in (("ref", ref), ("resumed", resumed))}
    if sorted(digests["ref"]) != [0, 1] or digests["ref"] != digests["resumed"]:
        raise RuntimeError(f"q.3: parameter digests {digests}")
    want, got = (load_checkpoint(root / name / "models" / "checkpoint-epoch-3.ckpt")
                 for name in ("ref", "killed"))
    for key, value in want[0].items():
        if not torch.equal(value, got[0][key]):
            raise RuntimeError(f"q.3: resumed parameter {key} differs")
    for i, state in want[1]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            if not torch.equal(state[key], got[1]["state"][i][key]):
                raise RuntimeError(f"q.3: resumed Adam state {i} {key} differs")
    sidecars = {rank: root / "ref" / name for rank, name in ((0, "m.jsonl"), (1, "m-r1.jsonl"))}
    comm = {}
    for rank, path in sidecars.items():
        steps = [e for e in load_events(path) if e["kind"] == "step"]
        if not steps or any(e.get("comm_wait_s") is None for e in steps):
            raise RuntimeError(f"q.3: rank {rank}'s step events lack comm_wait_s")
        comm[rank] = {"steps": len(steps), "comm_wait_ms": 1e3 * sum(
            e["comm_wait_s"] for e in steps) / len(steps), "overlap_frac": [
            round(e["overlap_frac"], 3) for e in steps if "overlap_frac" in e][:5]}
    trace = timeline.build_chrome_trace(timeline.load_run(sidecars[0]))
    timeline.validate_chrome_trace(trace)
    ranks = trace["otherData"]["ranks"]
    if sorted(ranks) != [0, 1]:
        raise RuntimeError(f"q.3: the timeline's ranks {ranks}")
    print(f"  q.3 distributed-native world 2 --metrics: sidecars m.jsonl and m-r1.jsonl, "
          f"comm_wait_s in every step event {comm}; the two ranks' timeline "
          f"({len(trace['traceEvents'])} events, clock offsets "
          f"{trace['otherData']['clock_offsets_s']}) passes its validator")
    print(f"  q.3 C6: killed at epoch 1 (exit -9 on both ranks), --resume auto: final "
          f"parameters and Adam state equal the uninterrupted run's bit for bit, rank digests "
          f"{digests['resumed']}; three worlds {wall:.1f} s")
    return {"comm": comm, "seconds": wall}


def _q_live(workdir: Path) -> dict:
    """q.4: path f (one epoch, the per-batch loop of a fault schedule) with
    ``--metrics --live 0 --live-port-file`` and a stall longer than
    ``PDRNN_WATCHDOG_STALL`` in a thread of this process, polled from
    this one: ``/metrics`` answers, ``/health`` reports the rank stalled
    and then ok, ``/events`` the stall alert and its clearing; then the
    same run without telemetry (and stalls of 10 ms): the same parameters
    and Adam state bit for bit."""
    import urllib.error
    import urllib.request

    root = workdir / "q4"
    (root / "live").mkdir(parents=True)
    (root / "plain").mkdir()
    port_file = root / "live" / "port.txt"
    (step, seconds), (hold_step, hold) = Q_STALL, Q_HOLD
    faults = f"step:{step}:stall:{seconds:g},step:{hold_step}:stall:{hold:g}"
    result = {}

    def live_run():
        try:
            result["trainer"] = _cli_trainer(root / "live", _graph_argv(workdir, "f", [
                "--metrics", str(root / "live" / "m.jsonl"), "--live", "0",
                "--live-port-file", str(port_file), "--faults", faults]), epochs=1)
        except BaseException as exc:  # re-raised below
            result["error"] = exc

    def get(url):
        try:
            with urllib.request.urlopen(url, timeout=2.0) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as err:
            return err.code, err.read().decode()

    seen = {"metrics": None, "health": [], "events": []}
    with _environ(PDRNN_WATCHDOG_STALL=f"{Q_WATCHDOG_STALL_S:g}", PDRNN_METRICS_HEARTBEAT="0.2",
                  PDRNN_LIVE_PUSH_EVERY="0.2"):
        thread = threading.Thread(target=live_run, name="q4-live-run")
        thread.start()
        deadline = time.perf_counter() + Q_TIMEOUT
        while not port_file.exists() and thread.is_alive() and time.perf_counter() < deadline:
            time.sleep(0.05)
        if port_file.exists():
            host, port = port_file.read_text().split()
            base = f"http://{host}:{port}"
            while thread.is_alive() and time.perf_counter() < deadline:
                try:
                    code, body = get(base + "/health")
                    status = [s["status"] for s in json.loads(body)["sources"]]
                    if not seen["health"] or seen["health"][-1] != status:
                        seen["health"].append(status)
                    if seen["metrics"] is None or "pdrnn_steps_total" not in seen["metrics"][1]:
                        seen["metrics"] = get(base + "/metrics")
                    code, body = get(base + "/events")
                    seen["events"] = [e.get("alert") for e in json.loads(body)]
                except OSError:
                    pass  # the server closes as the run ends
                time.sleep(0.1)
        thread.join()
    if "error" in result:
        raise result["error"]
    plain = _cli_trainer(root / "plain", _graph_argv(workdir, "f", [
        "--faults", f"step:{step}:stall:0.01,step:{hold_step}:stall:0.01"]), epochs=1)
    _same_bits("q.4 path f --live vs plain", result["trainer"], plain)
    statuses = [s[0] for s in seen["health"] if s]
    code, text = seen["metrics"] or (None, "")
    if code != 200 or "pdrnn_steps_total" not in text:
        raise RuntimeError(f"q.4: /metrics answered {code}: {text[:500]}")
    if "stalled" not in statuses or "ok" not in statuses[statuses.index("stalled"):]:
        raise RuntimeError(f"q.4: /health went {seen['health']}")
    if "stall" not in seen["events"] or "stall_cleared" not in seen["events"]:
        raise RuntimeError(f"q.4: /events {seen['events']}")
    print(f"  q.4 path f --live 0 --faults {faults} (PDRNN_WATCHDOG_STALL "
          f"{Q_WATCHDOG_STALL_S:g}): /metrics answered 200 "
          f"({len(text.splitlines())} lines), /health went {statuses}, /events "
          f"{seen['events']}; parameters and Adam state equal the run without telemetry's "
          f"bit for bit")
    return {"health": statuses, "events": seen["events"]}


def phase_telemetry(workdir: Path, formatter) -> dict:
    """Phase q, the training CLI's telemetry on the existing kernels: q.1
    ``--metrics`` on path a's graph path (bits, the recorder's cost a step,
    the sidecar and the ledger), q.2 ``--profile-steps`` and ``--profile``,
    q.3 ``distributed-native`` at world 2 with ``--metrics`` and the C6
    kill and resume, q.4 the live plane and the watchdog on path f."""
    print("phase q: --metrics, --metrics-sample-every, --profile, --profile-steps, --live, "
          "--live-port-file")
    t0 = time.perf_counter()
    out = {"metrics": _q_metrics(workdir, formatter), "profile": _q_profile(workdir),
           "native": _q_native(workdir), "live": _q_live(workdir)}
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase q: {out['seconds']:.1f} s")
    print("telemetry: " + json.dumps(out, default=str))
    return out


# phase s: checkpoints that cross frameworks; phase t: the parameter
# server's checkpoints and elastic membership
FIXTURE = ROOT / "tests" / "data" / "jax_checkpoints"
INTEROP_RTOL = 1e-4  # the port's continuation of the JAX fixture against JAX's (PERF.md §2)
JAX_HEADER = ["epoch", "loss", "model_len", "opt_len", "crcs", "extra"]
PS_BOOTSTRAP = re.compile(r"master bootstrap: restored (\S+) \(checkpoint ordinal (\d+)\); "
                          r"parameters sha256 (\w+)")
PS_CKPT = re.compile(r"master checkpoint: \S+ @ update (\d+) \(([\d.]+) ms\)")
PS_SYNC_SENT = re.compile(r"state sync: worker-id (\d+) \(rank \d+, incarnation (\d+)\) <- \d+ "
                          r"params @ update (\d+), push-seq watermark (\d+); parameters sha256 "
                          r"(\w+)")
PS_SYNC_ADOPTED = re.compile(r"ps worker (\d+): state sync at update (\d+), push seq (\d+), "
                             r"epoch (\d+); parameters sha256 (\w+); first push (\S+) s after")
PS_DONE = re.compile(r"parameter server done: (\d+) updates applied, roster (\{.*?\})"
                     r"(?:, \d+ degraded round\(s\))?(?:, (\d+) rejoin\(s\))?")
PS_VERDICT = re.compile(r"elastic supervisor verdict: (\{.*\})")


def _sections(path: Path) -> tuple:
    """A checkpoint's header and its two sections decoded by the port's
    codec."""
    from pytorch_distributed_rnn_tpu_torch.utils import flax_msgpack

    head, rest = path.read_bytes().split(b"\n", 1)
    header = json.loads(head)
    model_len = header["model_len"]
    return (header, flax_msgpack.restore(rest[:model_len]),
            flax_msgpack.restore(rest[model_len:model_len + header["opt_len"]]))


def _tree_layout(tree, prefix: str = "") -> list:
    """``(path, shape, dtype)`` of every leaf, in the tree's order."""
    out = []
    for key, value in tree.items():
        if isinstance(value, dict):
            out.extend(_tree_layout(value, f"{prefix}{key}."))
        else:
            out.append((f"{prefix}{key}", tuple(value.shape), str(value.dtype)))
    return out


def _s_argv(workdir: Path, expected: dict, name: str, epochs: int, *extra) -> list:
    return ["--dataset-path", str(workdir / "s" / "data"), "--checkpoint-directory",
            str(workdir / "s" / name), "--epochs", str(epochs), *expected["flags"], *extra,
            "--resume", "auto", "local"]


def _fixture_maker():
    """The fixture's ``make.py`` (its signature helpers; it imports JAX only
    when run)."""
    sys.path.insert(0, str(FIXTURE))
    try:
        import make
    finally:
        sys.path.remove(str(FIXTURE))
    return make


def phase_interop(workdir: Path) -> dict:
    """Phase s: s.1 the JAX-written fixture (path a's model, one epoch)
    resumed with ``--resume auto`` on the card for epochs 2-3 on the graph
    path: its losses and its final parameters' signature against the JAX
    trainer's (``expected.json``), the LSTM kernels' launches as
    ``_check_path`` counts them; s.2 the
    ``checkpoint-epoch-3.ckpt`` the port wrote: JAX's header fields and no
    trainer section, its sections decoded by the port's codec into the
    fixture's keys, key order, shapes and dtypes; s.3 from that file at
    ``--max-bad-steps 3 --dropout 0.1``, a run killed by ``epoch:4:kill``
    (exit -9) and resumed with ``--resume auto`` against the uninterrupted
    run bit for bit (the guard's ``apply_if_finite`` tree and the dropout
    streams through the file)."""
    import shutil

    from pytorch_distributed_rnn_tpu_torch.data.synthetic import write_synthetic_har_cache

    print("phase s: checkpoints that cross frameworks (a JAX-written checkpoint resumed on the "
          "card; the port's file in JAX's format)")
    t0 = time.perf_counter()
    expected = json.loads((FIXTURE / "expected.json").read_text())
    root = workdir / "s"
    write_synthetic_har_cache(root / "data", **expected["data"])
    (root / "models").mkdir()
    shutil.copy(FIXTURE / expected["checkpoint"], root / "models")
    (root / "run").mkdir()
    trainer, history, launches, _ = _drive(root / "run", _s_argv(
        workdir, expected, "models", expected["epochs"]))
    _check_path("s.1", trainer, history, launches, ("lstm_fwd", "lstm_bwd"), MAIN_BATCH)
    for key in ("train_history", "validation_history"):
        got, want = np.asarray(history[key]), np.asarray(expected[key])
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        print(f"  s.1 {key} {history[key]} vs JAX {expected[key]}: max rel err {rel:.3e}, "
              f"rtol {INTEROP_RTOL:g}")
        if not rel <= INTEROP_RTOL:
            raise RuntimeError(f"s.1: {key} disagrees with the JAX trainer's continuation")
    # the losses barely move on this fixture (a resume with fresh Adam state
    # stays within 1e-4 of them); the final parameters' signature does not
    make = _fixture_maker()
    errors = make.signature_errors({k: v.detach().cpu() for k, v in
                                    trainer.model.state_dict().items()},
                                   expected["final_parameters"])
    worst = max(errors, key=errors.get)
    print(f"  s.1 final parameters' signature vs JAX's: max error {errors[worst]:.3e} of the L1 "
          f"norm ({worst}), rtol {make.SIGNATURE_RTOL:g}")
    if not errors[worst] <= make.SIGNATURE_RTOL:
        raise RuntimeError(f"s.1: the final parameters differ from the JAX trainer's: {errors}")

    header, model, opt = _sections(root / "models" / "checkpoint-epoch-3.ckpt")
    jax_header, jax_model, jax_opt = _sections(FIXTURE / expected["checkpoint"])
    if list(header) != JAX_HEADER or "trainer_len" in header or header["epoch"] != 3:
        raise RuntimeError(f"s.2: header {sorted(header)} is not JAX's")
    for what, ours, theirs in (("model", model, jax_model), ("opt", opt, jax_opt)):
        if _tree_layout(ours) != _tree_layout(theirs):
            raise RuntimeError(f"s.2: the {what} section's layout differs from the fixture's:\n"
                               f"{_tree_layout(ours)}\n{_tree_layout(theirs)}")
    print(f"  s.2 checkpoint-epoch-3.ckpt: header {list(header)}, extra "
          f"{sorted(header['extra'])}; model {len(_tree_layout(model))} leaves and opt "
          f"{len(_tree_layout(opt))} leaves in the fixture's keys, order, shapes and dtypes")

    for name in ("s3-ref", "s3"):
        (root / name).mkdir()
        shutil.copy(root / "models" / "checkpoint-epoch-3.ckpt", root / name)
    s3 = ["--max-bad-steps", "3", "--dropout", "0.1"]
    reference = _cli_trainer(root / "run", _s_argv(workdir, expected, "s3-ref", 5, *s3), epochs=5)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.main",
                           *_s_argv(workdir, expected, "s3", 5, *s3, "--faults", "epoch:4:kill")],
                          cwd=root / "run", env=env, capture_output=True, text=True,
                          timeout=P_TIMEOUT)
    if proc.returncode != -9 or not (root / "s3" / "checkpoint-epoch-4.ckpt").exists():
        print(proc.stderr[-4000:])
        raise RuntimeError(f"s.3: the killed run exited {proc.returncode}")
    guard_header, _, guard_opt = _sections(root / "s3" / "checkpoint-epoch-4.ckpt")
    if list(guard_opt) != ["notfinite_count", "last_finite", "total_notfinite", "inner_state"]:
        raise RuntimeError(f"s.3: the guarded optimizer tree is {list(guard_opt)}")
    resumed = _cli_trainer(root / "run", _s_argv(workdir, expected, "s3", 5, *s3), epochs=5)
    _same_bits("s.3 killed and resumed vs uninterrupted", reference, resumed)
    print(f"  s.3 killed at epoch 4 (exit -9), its checkpoint's optimizer tree "
          f"{list(guard_opt)}, {len(guard_header['extra']['trainer']['dropout_generators'])} "
          "dropout stream(s) in extra; resumed: parameters and Adam state equal the "
          "uninterrupted run's bit for bit")
    seconds = time.perf_counter() - t0
    print(f"  phase s: {seconds:.1f} s")
    return {"history": history, "seconds": seconds}


def _t_spawn(workdir: Path, name: str, flags: list, world: int) -> tuple:
    """A spawn-mode ``parameter-server`` world through the CLI (a process
    a rank, every rank on the card): ``(returncode, stderr, seconds)``."""
    from pytorch_distributed_rnn_tpu_torch.utils.worlds import free_ports

    cwd = workdir / "t" / name
    cwd.mkdir(parents=True)
    (port,) = free_ports(1)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pytorch_distributed_rnn_tpu_torch.main",
                           *flags, "parameter-server", "--world-size", str(world),
                           "--ps-mode", "sync", "--master-port", str(port), "--elastic",
                           "--min-workers", "1", "--ps-join-timeout", "60"],
                          cwd=cwd, capture_output=True, text=True, timeout=PS_TIMEOUT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stderr[-6000:])
        raise RuntimeError(f"{name}: the elastic world exited {proc.returncode}")
    return proc.stderr, seconds, cwd


def _t_rounds(path: Path) -> tuple:
    """The master's sidecar: its ``ps_round`` spans and ``run_summary``."""
    rows = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    rounds = [r for r in rows if r.get("kind") == "span" and r.get("name") == "ps_round"]
    summary = next(r for r in reversed(rows) if r.get("kind") == "run_summary")
    return rounds, summary


def phase_ps_elastic(workdir: Path) -> dict:
    """Phase t, at phase n's flags (path a's width, 2 epochs, ``--dropout 0
    --no-validation``): t.1 sync at world 2 with ``--ps-checkpoint-rounds
    5``: each write's ms; t.2 ``--elastic --min-workers 1 --faults
    step:6:respawn@1`` at world 3 in spawn mode: exit 0, one respawn, one
    rejoin on the roster, the rejoiner's STATE_SYNC parameters equal to the
    master's at that update (the sha256 either side logs), every push in
    exactly one round (the master's sidecar: each worker's push seqs 1..n
    once, one update a round), the pushes and updates JAX's rule gives
    (the rejoiner resumes at its watermark's epoch), the LSTM kernels on
    both workers, and the
    respawn's process start to its first push; t.3 the world restarted on
    t.1's checkpoints with ``--resume auto``, elastic at world 3 with
    ``step:6:preempt@2``: the master's bootstrap ordinal and the sha256 of
    its first flat vector against the last checkpoint's parameters in the
    wire order, then a DEREGISTER, a drained member, the rest completing."""
    from pytorch_distributed_rnn_tpu_torch import interop
    from pytorch_distributed_rnn_tpu_torch.models import MotionModel
    from pytorch_distributed_rnn_tpu_torch.param_server.runner import parameters_digest
    from pytorch_distributed_rnn_tpu_torch.training.checkpoint import (
        find_latest_checkpoint,
        load_checkpoint,
    )

    print("phase t: parameter-server checkpoints (--ps-checkpoint-rounds, --resume auto) and "
          "elastic membership (--elastic, respawn, preempt)")
    t0 = time.perf_counter()
    data = ["--dataset-path", str(workdir / "data")]
    ckpt_dir = workdir / "t" / "models"
    first = _ps_world(workdir, "t1", [*data, *PS_FLAGS, "--checkpoint-directory", str(ckpt_dir)],
                      2, "sync", ps_flags=["--ps-checkpoint-rounds", "5"])
    writes = [(int(m[1]), float(m[2])) for m in PS_CKPT.finditer("\n".join(first["master_log"]))]
    if not writes:
        raise RuntimeError("t.1: the master wrote no checkpoint")
    write_ms = [ms for _, ms in writes]
    print(f"  t.1 {len(writes)} master checkpoints at updates {[u for u, _ in writes]}, write ms "
          f"{write_ms} (mean {np.mean(write_ms):.3f}; off the round lock, the last one after "
          "the run)")

    err, spawn_s, cwd = _t_spawn(workdir, "t2", [
        *data, *PS_FLAGS, "--checkpoint-directory", str(workdir / "t" / "models-t2"),
        "--faults", "step:6:respawn@1", "--metrics", "m.jsonl"], 3)
    verdict = json.loads(PS_VERDICT.search(err)[1].replace("'", '"'))
    done = PS_DONE.search(err)
    sent = {(int(m[1]), int(m[3])): m[5] for m in PS_SYNC_SENT.finditer(err)}
    adopted = {(int(m[1]), int(m[2])): (m[5], m[6], int(m[3]), int(m[4]))
               for m in PS_SYNC_ADOPTED.finditer(err)}
    rounds, summary = _t_rounds(cwd / "m.jsonl")
    contributions = [(w, s) for r in rounds for w, s in r["seqs"].items()]
    seqs = {w: sorted(s for v, s in contributions if v == w) for w in ("1", "2")}
    workers = {int(m[1]): m for m in PS_WORKER.finditer(err)}
    if (verdict.get("respawns") != 1 or verdict.get("failed") != 0 or done is None
            or int(done[3] or 0) != 1 or summary["rejoins"] != 1):
        raise RuntimeError(f"t.2: verdict {verdict}, master {done and done.groups()}, "
                           f"summary {summary}")
    if len(sent) != 1 or set(sent) != set(adopted) or any(
            sent[k] != adopted[k][0] for k in sent):
        raise RuntimeError(f"t.2: state sync sent {sent}, adopted {adopted}")
    if (len(contributions) != len(set(contributions)) or summary["steps"] != len(rounds)
            or any(s != list(range(1, len(s) + 1)) for s in seqs.values())):
        raise RuntimeError(f"t.2: a push applied twice or lost: {len(rounds)} rounds for "
                           f"{summary['steps']} updates, seqs {seqs}")
    if sorted(workers) != [1, 2]:
        raise RuntimeError(f"t.2: worker summaries {sorted(workers)}")
    for rank, m in workers.items():
        _ps_check_launches(f"t.2 worker {rank}", json.loads(m[7]), int(m[2]), "lstm")
    (key, (digest, first_push, watermark, start_epoch)), = adopted.items()
    # JAX's rule (its worker's _state_sync): the rejoiner resumes at epoch
    # watermark // steps a epoch and pushes on from its watermark; the
    # survivor's rounds close alone while the respawn starts (seconds
    # against its milliseconds a step), then the rejoiner's; one update a round
    epochs = int(PS_FLAGS[PS_FLAGS.index("--epochs") + 1])
    per_epoch = int(workers[2][2]) // epochs
    rule_pushes = {"1": watermark + (epochs - watermark // per_epoch) * per_epoch,
                   "2": epochs * per_epoch}
    rule_updates = rule_pushes["2"] + (epochs - watermark // per_epoch) * per_epoch
    if (start_epoch != watermark // per_epoch or summary["steps"] != rule_updates
            or {w: len(s) for w, s in seqs.items()} != rule_pushes):
        raise RuntimeError(f"t.2: {summary['steps']} updates and pushes "
                           f"{ {w: len(s) for w, s in seqs.items()} } against JAX's rule: "
                           f"{rule_updates} and {rule_pushes} (watermark {watermark}, resumed "
                           f"at epoch {start_epoch}, {per_epoch} steps an epoch)")
    print(f"  t.2 exit 0 in {spawn_s:.1f} s; supervisor {verdict}; master {done[1]} updates, "
          f"roster {done[2]}, {summary['rejoins']} rejoin; worker-id {key[0]} state-synced at "
          f"update {key[1]}: sha256 {digest[:16]}... sent == adopted; {len(rounds)} rounds take "
          f"pushes {len(seqs['1'])} (worker 1, its two incarnations) + {len(seqs['2'])} "
          f"(worker 2), each once, as JAX's rule gives (watermark {watermark}, resumed at "
          f"epoch {start_epoch}); LSTM launches on both workers "
          f"{[json.loads(m[7]) for m in workers.values()]}; respawn to first push "
          f"{float(first_push):.3f} s (the new process's start to its first applied push)")

    latest = find_latest_checkpoint(ckpt_dir)
    names = [n for n, _ in MotionModel().named_parameters()]
    last_params, _, meta = load_checkpoint(latest, names=names)
    want = parameters_digest(interop.state_dict_to_flat(last_params, names))
    err3, preempt_s, _ = _t_spawn(workdir, "t3", [
        *data, *PS_FLAGS, "--checkpoint-directory", str(ckpt_dir), "--resume", "auto",
        "--faults", "step:6:preempt@2"], 3)
    boot = PS_BOOTSTRAP.search(err3)
    done3 = PS_DONE.search(err3)
    roster = json.loads(done3[2].replace("'", '"')) if done3 else {}
    if boot is None or int(boot[2]) != meta["epoch"] or boot[3] != want:
        raise RuntimeError(f"t.3: bootstrap {boot and boot.groups()}, last checkpoint {latest} "
                           f"(epoch {meta['epoch']}, sha256 {want})")
    if roster != {"joined": 0, "drained": 1, "dead": 0, "done": 1} or \
            "worker-id 2 (rank 2) deregistered" not in err3:
        raise RuntimeError(f"t.3: roster {roster}:\n{err3[-4000:]}")
    print(f"  t.3 exit 0 in {preempt_s:.1f} s: the restarted master bootstrapped from "
          f"{Path(boot[1]).name} (ordinal {boot[2]}), its first flat vector's sha256 "
          f"{boot[3][:16]}... equal to the last checkpoint's; worker 2 deregistered after its "
          f"push, roster {roster}, master {done3[1]} updates")
    seconds = time.perf_counter() - t0
    print(f"  phase t: {seconds:.1f} s")
    return {"write_ms": write_ms, "respawn_to_first_push_s": float(first_push),
            "t2_seconds": spawn_s, "seconds": seconds}

def _long_context_trainer(fuse_run: bool = False):
    """Path e's trainer: the long-context classifier (bench.py's
    attention_seq1024_dim512 bf16 row) on ``LONG_STEPS`` batches of
    ``LONG_BATCH`` seeded random windows an epoch, Adam at 1e-3."""
    from pytorch_distributed_rnn_tpu_torch.data import MotionDataset
    from pytorch_distributed_rnn_tpu_torch.models import AttentionClassifier
    from pytorch_distributed_rnn_tpu_torch.training import Trainer

    rng = np.random.default_rng(0)
    x = rng.standard_normal((LONG_BATCH * LONG_STEPS, LONG_T, 9), dtype=np.float32)
    y = rng.integers(0, 6, LONG_BATCH * LONG_STEPS)
    model = AttentionClassifier(input_dim=9, dim=LONG_DIM, depth=2, num_heads=LONG_HEADS,
                                output_dim=6, max_len=LONG_T, precision="bf16",
                                generator=torch.Generator().manual_seed(0))
    return Trainer(model, MotionDataset(x, y), LONG_BATCH, 1e-3, seed=0, fuse_run=fuse_run,
                   device="cuda")


def phase_long_context() -> PathRun:
    """The long-context classifier: one epoch of ``LONG_STEPS`` Adam steps
    through the trainer (no evaluation)."""
    print("main path: long-context attention")
    trainer = _long_context_trainer()
    _reset_launch_counts()
    t0 = time.perf_counter()
    _, losses, _ = trainer.train(epochs=1)
    torch.cuda.synchronize()
    launches = _launch_counts()
    print(f"  {time.perf_counter() - t0:.2f} s, train_history={losses}, launches={launches}")
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"long context: losses not finite: {losses}")
    run = _check_flash_path("long context", trainer, launches, LONG_STEPS, 0, LONG_BATCH,
                            ("flash_dq", "flash_dkv"))
    x = torch.from_numpy(trainer.training_set.features[:LONG_BATCH]).cuda()
    flash = _flash_vs_dense(trainer.model, x, LOGIT_TOL_BF16, "long context")
    if flash.shape != (LONG_BATCH, 6):
        raise RuntimeError(f"long context: logits of shape {tuple(flash.shape)}")
    return run


def _device_profile():
    """``torch.profiler`` over the card's activity alone (every reader here
    takes the device records only, and a window without the host's
    operator events has far fewer events to process), with
    host-only margins around the body (``utils/ab.py:device_profile``: late
    in a process a plain window loses device records)."""
    from torch.profiler import ProfilerActivity

    from pytorch_distributed_rnn_tpu_torch.utils.ab import device_profile

    return device_profile([ProfilerActivity.CUDA])


def _device_events(prof) -> list:
    """The kernels, copies and sets of a profiled run, without the device
    spans of user annotations (``Optimizer.step``, DDP's forward), which
    cover kernels counted already (``utils/ab.py:device_events``)."""
    from pytorch_distributed_rnn_tpu_torch.utils.ab import device_events

    return device_events(prof)


# the port's kernels by their wrapper's name in LAUNCHES, from a device
# event's (demangled) name; flash_dqkv before flash_dq
_KERNEL_EVENT = re.compile(r"(lstm_fwd|lstm_bwd|gru_fwd|gru_bwd|flash_fwd|flash_dqkv|flash_dq"
                           r"|flash_dkv)_\w*kernel")


def _kernel_event_counts(events) -> dict:
    """The port's kernels among a profile's device events, counted by
    wrapper name."""
    counts = {}
    for e in events:
        if m := _KERNEL_EVENT.search(e.key):
            counts[m.group(1)] = counts.get(m.group(1), 0) + e.count
    return counts


PROFILE_ATTEMPTS = 3


def _profile_steps(train, steps: int) -> tuple:
    """One run of ``train()`` (``steps`` train steps) under
    ``torch.profiler``: device ms a step (kernels, copies and sets), the
    device events, and the launch counts of that run, which must equal the
    profile's count of each of the port's kernels.  The profiler has been
    seen to drop a kernel's records now and then (2 of 20 of one graph
    epoch once on an H100, none in 16 profiles of the same epochs after
    it): a run whose counts disagree is profiled again, up to
    ``PROFILE_ATTEMPTS`` runs, and the phase fails if none agrees.  Each
    attempt runs ``train()`` again, so a caller compares no trainer's
    state after this."""

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        _reset_launch_counts()
        with _device_profile() as prof:
            train()
            torch.cuda.synchronize()
        launches = {k: v for k, v in _launch_counts().items() if v}
        events = _device_events(prof)
        seen = _kernel_event_counts(events)
        if seen == launches:
            total_us = sum(e.self_device_time_total for e in events)
            return total_us / 1e3 / steps, events, launches
        print(f"  profile {attempt} of {PROFILE_ATTEMPTS}: launch counts {launches}, the "
              f"profile's kernels {seen}")
    raise RuntimeError(f"launch counts {launches} differ from the profile's kernels {seen} "
                       f"in {PROFILE_ATTEMPTS} profiled runs")


def _print_top(events, steps: int):
    total_us = sum(e.self_device_time_total for e in events)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        us = e.self_device_time_total
        print(f"  {us / 1e3 / steps:8.3f} ms/step  {100 * us / max(total_us, 1):5.1f}%  "
              f"{e.key[:90]}")


def _copies(events, steps: int) -> str:
    copies = [e for e in events if "copy" in e.key.lower()]
    return (f"device copy kernels {sum(e.count for e in copies) / steps:g} a step, "
            f"{sum(e.self_device_time_total for e in copies) / 1e3 / steps:.4f} ms a step")


def phase_step_profile(run: PathRun, formatter, repeats: int) -> dict:
    """More epochs of a trained path's trainer, the per-batch (eager) loop
    and the per-epoch graph path in turns (eager, graph, graph, eager,
    ``repeats`` times), each timed on the host clock to a device sync,
    then one epoch of each under ``torch.profiler``: device ms a step, the
    card's idle share of the host's step (1 - device / host, from each
    path's median), the launches of the profiled epoch held against the
    profile's kernel count, and the graphs' capture times."""
    trainer = run.trainer
    steps = len(trainer._epoch_index_batches())
    train = {mode: (lambda eager=(mode == "eager"): trainer._train_epoch(formatter, eager))
             for mode in ("eager", "graph")}
    host_ms = {"eager": [], "graph": []}
    for _ in range(repeats):
        for mode in ("eager", "graph", "graph", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train[mode]()
            torch.cuda.synchronize()
            host_ms[mode].append((time.perf_counter() - t0) * 1e3 / steps)
    result = {"host_ms": host_ms, "capture_ms": {
        f"{kind} {rows}": graph.capture_s * 1e3 for (kind, rows), graph in trainer.graphs.items()}}
    print(f"step profile ({run.name}): {steps} steps an epoch; capture ms {result['capture_ms']}")
    for mode in ("eager", "graph"):
        device_ms, events, launches = _profile_steps(train[mode], steps)
        median = sorted(host_ms[mode])[len(host_ms[mode]) // 2]
        idle = 1.0 - device_ms / median
        result[mode] = {"device_ms": device_ms, "idle": idle}
        print(f"  {mode}: host clock per step over {2 * repeats} epochs: "
              f"{', '.join(f'{ms:.3f}' for ms in host_ms[mode])} ms; device time "
              f"{device_ms:.3f} ms per step (one profiled epoch); card idle {100 * idle:.1f}% of "
              f"the median step; launches of that epoch {launches} (the profile's kernels "
              f"agree); {_copies(events, steps)}")
        _print_top(events, steps)
    return result


def phase_scan_profile(run: PathRun, formatter):
    """The same trained model's train steps on its scan path (the Python
    loop over T, its backward by autograd) in the per-batch loop,
    profiled once: what the kernels replace on the card.  (The graph
    path would replay the kernel path it captured.)"""

    model = run.trainer.model
    steps = len(run.trainer._epoch_index_batches())
    model.impl = "scan"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.trainer._train_epoch(formatter, eager=True)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        with _device_profile() as prof:
            run.trainer._train_epoch(formatter, eager=True)
            torch.cuda.synchronize()
    finally:
        model.impl = "auto"
    events = _device_events(prof)
    total_us = sum(e.self_device_time_total for e in events)
    print(f"step profile ({run.name}, scan path, per-batch loop): {steps} steps; host clock "
          f"{host_ms:.3f} ms per step; device time {total_us / 1e3 / steps:.3f} ms per step; "
          f"{_copies(events, steps)}")
    _print_top(events, steps)


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

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with _device_profile() as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
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
    h_all, gates = fr.gru_fwd_plain(x_proj, h0, w, b)
    dh_all = 0.1 * torch.randn(h_all.shape, generator=gen, device="cuda")
    bwd = (x_proj, h_all, h0, w, b, dh_all, torch.zeros_like(h0),
           gates if fr.gru_saves_gates(hidden) else None)
    return (x_proj, h0, w, b), bwd, dh_all, gen


def _lstm_fwd_on_tensor_cores(hidden: int) -> bool:
    """Whether the f32 LSTM forward runs its tensor-core cluster kernel at
    this width (where the slice does not fit in shared memory)."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    return (fr.lstm_fwd_tile(hidden)[1] == "cluster"
            and not fr._lstm_fwd_slice_fits(hidden, torch.float32.itemsize))


def _kernel_bounds(cell: str, batch: int, hidden: int) -> tuple:
    """Each kernel's least time at f32: every input read once, every
    output written once, and its recurrent products at the rate of the
    pipe they run on (f32 FMAs on the CUDA cores; the LSTM forward's
    tensor-core kernel three TF32 products each).  Each is the bound of
    the function it replaces: the forward writes h_all (and the LSTM's
    c_all) only, the backward recomputes the forward's products from
    x_proj and adds the contraction.  Where the backward reads the gates
    its forward saved (the LSTM up to H=32 and over a cluster, the GRU up
    to H=32), its bound is the lesser of that and the saved-gate form's.
    The gate store and, where it reads more, the gate read are costs of
    the design (``ms_saving_no_gates`` beside the forward's time).
    Returns (fwd, bwd, bwd reading the saved gates or None)."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    item = 4
    seq = SEQ_LEN * batch * hidden * item
    state = batch * hidden * item
    if cell == "lstm":
        gate_seq = 4 * seq
        weight = hidden * 4 * hidden * item
        flops = 2 * SEQ_LEN * batch * hidden * 4 * hidden
        # x_proj, h0, c0, w in; h_all, c_all out; the tensor-core kernel's
        # products as 3 TF32 products each
        by_pipe = ((3 * flops, TF32_FLOPS_PER_S) if _lstm_fwd_on_tensor_cores(hidden)
                   else (flops, F32_FLOPS_PER_S))
        fwd = _bound_ms(gate_seq + 2 * state + weight + 2 * seq, *by_pipe)
        # x_proj, h_all, c_all, dh_all, h0, c0, dh_T, dc_T, w in; dx_proj, dh0, dc0 out
        bwd = _bound_ms(2 * gate_seq + 3 * seq + 6 * state + weight, 2 * flops)
        # the gates, c_all, dh_all, c0, dh_T, dc_T, w in; dx_proj, dh0, dc0
        # out; the contraction alone
        saved = (_bound_ms(2 * gate_seq + 2 * seq + 5 * state + weight, flops)
                 if fr.lstm_saves_gates(hidden) else None)
    else:
        gate_seq = 3 * seq
        weight = hidden * 3 * hidden * item
        bias = 3 * hidden * item
        flops = 2 * SEQ_LEN * batch * hidden * 3 * hidden
        # x_proj, h0, w, b in; h_all out
        fwd = _bound_ms(gate_seq + state + weight + bias + seq, flops)
        # x_proj, h_all, dh_all, h0, dh_T, w, b in; dx_proj, dhgates, dh0 out
        bwd = _bound_ms(3 * gate_seq + 2 * seq + 3 * state + weight + bias, 2 * flops)
        # r, z, n, h_n (4H), h_all, dh_all, h0, dh_T, w in; dx_proj,
        # dhgates, dh0 out; the contraction alone
        saved = (_bound_ms(4 * seq + 2 * seq + 2 * gate_seq + 3 * state + weight, flops)
                 if fr.gru_saves_gates(hidden) else None)
    return fwd, min(bwd, saved or bwd), saved


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


def _fwd_at_rows(cell: str, args, all_rows, variant: str, gates: bool) -> dict:
    """``lstm_fwd`` or ``gru_fwd`` on ``args`` (the f32 forward's) at each
    of ``all_rows`` rows a block (or a cluster), through its C entry
    (uncounted: not a main-path launch)."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    x_proj = args[0]
    seq_len, batch, gate_dim = x_proj.shape
    hidden = gate_dim // (4 if cell == "lstm" else 3)
    h_all = torch.empty((seq_len, batch, hidden), device="cuda")
    outs = (h_all, torch.empty_like(h_all)) if cell == "lstm" else (h_all,)  # + c_all
    saved = torch.empty((seq_len, batch, 4 * hidden), device="cuda") if gates else None
    fn = fr._library(f"{cell}_fwd")
    stream = torch.cuda.current_stream().cuda_stream

    def call(rows):
        err = fn(*(t.data_ptr() for t in (*args, *outs)),
                 None if saved is None else saved.data_ptr(), seq_len, batch, hidden, rows,
                 fr._VARIANTS[variant], fr._DTYPE_CODES[torch.float32], stream)
        if err != 0:
            raise RuntimeError(f"{cell}_fwd at {rows} rows: CUDA error {err}")

    return {rows: _time_ms(lambda r=rows: call(r), 20) for rows in all_rows}


def _lstm_fwd_tc_serial(hidden: int) -> dict:
    """The tensor-core forward at one cluster of each of its row counts
    (B = R, its serial floor at that R)."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_rnn as fr

    times = {}
    for rows in range(8, fr.LSTM_FWD_TC_MAX_ROWS + 1, 8):
        args = _layer_inputs(rows, hidden, torch.float32, seed=5, hidden=hidden)[:4]
        times[rows] = _fwd_at_rows("lstm", args, (rows,), "cluster", True)[rows]
    print("  lstm_fwd tensor-core kernel at one cluster of R rows (ms): "
          + ", ".join(f"R={r}: {ms:.4f}" for r, ms in times.items()))
    return times


def _lstm_cluster_variants() -> dict:
    """Both LSTM kernels at B=256 on both sides of the width where their
    f32 slice stops fitting in shared memory (the forward goes from the
    CUDA-core kernel on 8 rows a cluster to the tensor-core kernel on 40
    there), and in bf16 at 512, whose slice fits: CUDA events over 10
    launches, by kernel, dtype and H."""
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
        tc = cell == "lstm" and _lstm_fwd_on_tensor_cores(hidden)
        if tc:  # one cluster on the rows the wrapper takes at the main batch
            tile = fr.lstm_fwd_tile(hidden, torch.float32, batch)[0]
            tile_fwd = _timing_args(cell, tile, hidden)[0]
        lib_fwd, lib_bwd = _library_calls(cell, batch, hidden, dh_all, gen)
        bounds = _kernel_bounds(cell, batch, hidden)
        shape = _shape(batch, hidden)
        for name, kernel, plain, library, bound, args, tile_args in (
            (f"{cell}_fwd", getattr(fr, f"{cell}_fwd"), getattr(fr, f"{cell}_fwd_plain"),
             lib_fwd, bounds[0], fwd_args, tile_fwd),
            (f"{cell}_bwd", getattr(fr, f"{cell}_bwd"), getattr(fr, f"{cell}_bwd_plain"),
             lib_bwd, bounds[1], bwd_args, tile_bwd),
        ):
            # at B = R the wrapper would split the tensor-core kernel's rows
            # over several clusters: one cluster through the C entry
            serial = (_fwd_at_rows("lstm", tile_args, (tile,), "cluster", True)[tile]
                      if tc and name == "lstm_fwd" else _time_ms(lambda: kernel(*tile_args), 20))
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
                "serial_ms": serial,
                "plain_ms": _time_ms(lambda: plain(*args), 3, warmup=1),
                "bound_ms": bound[0],
                "bound_by": bound[1],
                "library_ms": _time_ms(library, 20),
            })
        print(f"timing {cell} at {shape}; serial_ms at B={tile} / {bwd_tile} (one block, or one "
              f"cluster); library_ms is torch.nn.{cell.upper()} (cuDNN) forward / backward incl. "
              "its input projection")
        if hidden == HIDDEN:
            tiles = _fwd_at_rows(cell, fwd_args, FWD_TILES, fwd_tile(hidden)[1], False)
            print(f"  {cell}_fwd by rows a block, storing no gates (ms): "
                  + ", ".join(f"{r}: {ms:.4f}" for r, ms in tiles.items())
                  + f"; the wrapper takes {fwd_tile(hidden)[0]}")
            rows[-2]["ms_by_rows_a_block"] = tiles
        if getattr(fr, f"{cell}_saves_gates")(hidden):
            # the forward storing no gates, on the same inputs: the gate
            # store's cost, which its bound leaves out
            rows[-2]["ms_saving_no_gates"] = _time_ms(
                lambda: getattr(fr, f"{cell}_fwd")(*fwd_args, save_gates=False), 20)
            print(f"  {cell}_fwd storing no gates {rows[-2]['ms_saving_no_gates']:.4f} ms "
                  f"(storing them {rows[-2]['ms']:.4f} ms)")
            # the backward's bound in the form that reads the saved gates
            rows[-1]["bound_reading_saved_gates_ms"] = bounds[2][0]
            print(f"  {cell}_bwd bound {bounds[1][0]:.4f} ms; reading the saved gates "
                  f"{bounds[2][0]:.4f} ms")
        if tc:
            rows[-2]["ms_by_rows_a_cluster"] = _lstm_fwd_tc_serial(hidden)
            rows[-2]["bound_pipe"] = "TF32 tensor cores, 3 products each"
            print(f"  lstm_fwd bound by the pipe its products run on: {bounds[0][0]:.4f} ms "
                  f"({bounds[0][1]}; 3xTF32 at {TF32_FLOPS_PER_S / 1e12:g} TFLOP/s)")
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
    the rate of the pipe they run on.  The forward reads q, k, v and writes
    o and lse; dQ reads q, k, v, dO, lse and delta and writes dQ; dK/dV
    reads the same and writes dK and dV; the fused backward reads q, k, v,
    o, dO and lse and writes dQ, dK and dV.  Each product is 2 BH T^2 D
    operations: the forward does 2 (q k^T, p v), dQ 3 (s, dp, ds k), dK/dV
    4 (s, dp, p^T dO, ds^T q), the fused backward 5 (s, dp, ds k, p^T dO,
    ds^T q).  bf16 runs every product on the tensor cores at the bf16 rate;
    float32 runs the forward and the fused backward on the tensor cores in
    3xTF32 (three TF32 products a product, at the TF32 rate) and the split
    backward on the CUDA cores."""
    seq = bh * t * d * (2 if dtype == torch.bfloat16 else 4)
    rows = bh * t * 4
    product = 2 * bh * t * t * d
    if dtype == torch.bfloat16:
        split_rate, tc, tc_rate = BF16_FLOPS_PER_S, product, BF16_FLOPS_PER_S
    else:
        split_rate, tc, tc_rate = F32_FLOPS_PER_S, 3 * product, TF32_FLOPS_PER_S
    return {
        "flash_fwd": _bound_ms(4 * seq + rows, 2 * tc, tc_rate),
        "flash_dq": _bound_ms(5 * seq + 2 * rows, 3 * product, split_rate),
        "flash_dkv": _bound_ms(6 * seq + 2 * rows, 4 * product, split_rate),
        "flash_dqkv": _bound_ms(8 * seq + rows, 5 * tc, tc_rate),
    }


def _flash_calls(bh: int, t: int, d: int, dtype, heads: int) -> dict:
    """Each flash kernel, its plain version, the same kernel at one block
    (``flash_dqkv``: one head) and ``scaled_dot_product_attention``
    (forward, or its whole backward) on the same inputs, as ``(kernel,
    plain, one block, library)``; under ``"split"`` the backward as the
    split route runs it (delta in torch, ``flash_dq``, ``flash_dkv``).  The
    kernels' inputs are in the model's layout: q, k, v and dO (B, T, H, D)
    views of (B, T, H*D) tensors; SDPA's are contiguous (B, H, T, D)."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_attention as fa

    q, k, v, _ = _flash_inputs(bh, t, t, d, dtype, seed=11, layout="projection")
    do = torch.randn_like(q)  # the model's dO: q's layout
    o, lse = fa.flash_fwd_plain(q, k, v)
    delta = fa._delta(do, o)
    bwd = (q, k, v, do, lse, delta)
    rows = fa.BLOCK_ROWS  # one query tile (dQ) or one key tile (dK/dV): one block

    def first(x, n=None):  # the first head's first n rows
        return x[:1, :n].contiguous() if x.ndim == 2 else x[:1, :n, :1].contiguous()

    fwd_rows = FWD_BLOCK_ROWS[dtype]
    one_q = (first(q, rows), first(k), first(v), first(do, rows), first(lse, rows),
             first(delta, rows))
    one_k = (first(q), first(k, rows), first(v, rows), first(do), first(lse), first(delta))
    q4, k4, v4 = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_fwd():
        with torch.no_grad():
            sdpa(q4, k4, v4)

    out = sdpa(q4, k4, v4)
    do4 = do.transpose(1, 2).contiguous()

    def lib_bwd():
        torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)

    fused = (q, k, v, o, do, lse)
    one_head = tuple(first(x) for x in fused)

    def split():
        delta = fa._delta(do, o)
        fa.flash_dq(q, k, v, do, lse, delta)
        fa.flash_dkv(q, k, v, do, lse, delta)

    return {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_fwd_plain(q, k, v),
                      lambda: fa.flash_fwd(first(q, fwd_rows), *one_q[1:3]), lib_fwd),
        "flash_dq": (lambda: fa.flash_dq(*bwd), lambda: fa.flash_dq_plain(*bwd),
                     lambda: fa.flash_dq(*one_q), lib_bwd),
        "flash_dkv": (lambda: fa.flash_dkv(*bwd), lambda: fa.flash_dkv_plain(*bwd),
                      lambda: fa.flash_dkv(*one_k), lib_bwd),
        "flash_dqkv": (lambda: fa.flash_dqkv(*fused), lambda: fa.flash_dqkv_plain(*fused),
                       lambda: fa.flash_dqkv(*one_head), lib_bwd),
        "split": split,
    }


def _glue(batch: int, heads: int, t: int, d: int, dtype) -> tuple:
    """The device work of what the model's path does to the layout around
    one forward call of ``flash_attention``: q, k and v split into heads
    off the projections' (B, T, H*D) (``_split_heads``, then
    ``flash_attention``'s (B, T, H, D) views) and o's heads merged back
    (``_merge_heads``).  Returns (kernels launched, their device ms) a call
    under ``torch.profiler``: none since the kernels read the (B, T, H, D)
    layout (the copies this replaced took as long as the f32 forward)."""

    from pytorch_distributed_rnn_tpu_torch.models.attention import _merge_heads, _split_heads

    x = torch.randn((batch, t, heads * d), device="cuda").to(dtype)
    o = torch.empty((batch, t, heads, d), device="cuda", dtype=dtype)
    torch.cuda.synchronize()
    with _device_profile() as prof:
        for _ in range(20):
            for _ in range(3):
                if _split_heads(x, heads).transpose(1, 2).stride(-1) != 1:
                    raise RuntimeError("the split heads are not the kernels' layout")
            if _merge_heads(o.transpose(1, 2)).data_ptr() != o.data_ptr():
                raise RuntimeError("merging the heads copied o")
        torch.cuda.synchronize()
    events = _device_events(prof)
    return (sum(e.count for e in events) / 20,
            sum(e.self_device_time_total for e in events) / 1e3 / 20)


def phase_flash_timing(runs: dict, errs: dict) -> list:
    """The flash kernels of each main path at its shape, on the model's
    (B, T, H, D) layout, beside their bounds, plain versions and SDPA;
    ``serial_ms`` is the kernel at one block (one tile of one head:
    ``FWD_BLOCK_ROWS`` query rows forward, 64 rows backward;
    ``flash_dqkv``: one head).  At the CLI shape
    ``flash_dqkv`` also carries the split route's times on the same inputs
    (``split_dq_ms``, ``split_dkv_ms``, and ``split_ms``: delta, dQ and
    dK/dV as the backward ran them before)."""
    from pytorch_distributed_rnn_tpu_torch.ops import fused_attention as fa

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
        fused = fa.flash_bwd_route(t, t, d, dtype) == "dqkv"
        for name in ("flash_fwd", *(("flash_dqkv",) if fused else ("flash_dq", "flash_dkv"))):
            kernel, plain, one_block, library = calls[name]
            rows.append({
                "name": name,
                "route": "cuda",
                "source": SOURCES[name],
                "replaces": REPLACES[name],
                "kernel": FLASH_KERNELS[(name, dtype)],
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
        if fused:
            rows[-1].update({
                "split_dq_ms": _time_ms(calls["flash_dq"][0], 20),
                "split_dkv_ms": _time_ms(calls["flash_dkv"][0], 20),
                "split_ms": _time_ms(calls["split"], 20),
            })
        glue_kernels, glue_ms = _glue(batch, heads, t, d, dtype)
        print(f"timing flash at {shape}; serial_ms at one block; library_ms is "
              "scaled_dot_product_attention forward (CUDA events) / whole backward (dQ, dK, dV: "
              "the device time of its kernels per call under torch.profiler, "
              f"{sdpa_bwd_kernels}); layout work around one forward call: {glue_kernels:g} "
              f"kernels, {glue_ms:.4f} ms of device time")
    return rows


PHASE_SECONDS: dict = {}  # each phase's wall seconds, in order


def _timed(name: str, fn, *args):
    """``fn(*args)``, its wall seconds kept under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)
    print(f"phase {name}: {PHASE_SECONDS[name]} s", flush=True)
    return out


def main() -> int:
    from pytorch_distributed_rnn_tpu_torch.data.synthetic import write_synthetic_har_cache

    from pytorch_distributed_rnn_tpu_torch.training.formatter import TrainingMessageFormatter

    t0 = time.perf_counter()
    _timed("device", phase_device)
    _timed("build", phase_build)
    errs = _timed("kernels", phase_kernels)
    errs.update(_timed("flash kernels", phase_flash_kernels))
    formatter = TrainingMessageFormatter(1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        workdir = Path(tmp)
        write_synthetic_har_cache(workdir / "data", num_train=7352, num_test=2947, seed=0)
        runs = {
            "motion_lstm": _timed("a", phase_motion, workdir, "lstm"),
            "motion_gru": _timed("b", phase_motion, workdir, "gru"),
            "char_gru": _timed("c", phase_char, workdir, "gru"),
            "char_lstm": _timed("f", phase_char, workdir, "lstm"),
            "attention": _timed("d", phase_attention, workdir),
        }
        dp_finals = _timed("g, h", phase_distributed, workdir)
        native = _timed("i, j", phase_native, workdir, dp_finals)
        _timed("graph", phase_graph, workdir, formatter)
        runs["long"] = _timed("e", phase_long_context)
        for key in ("motion_lstm", "motion_gru", "char_gru", "char_lstm", "attention", "long"):
            _timed(f"5 {key}", phase_step_profile, runs[key], formatter, PROFILE_ROUNDS)
        _timed("5 scan", phase_scan_profile, runs["char_lstm"], formatter)
        rows = (_timed("6 timing", phase_timing, runs, errs)
                + _timed("6 flash timing", phase_flash_timing, runs, errs))
        # after the step profiles, as serving: with a phase that profiled in
        # this process before them, a step profile missed one kernel record in
        # all three attempts (serving once, this phase once)
        _timed("n, o", phase_ps, workdir, dp_finals, native["finals"])
        _timed("p", phase_resilience, workdir, formatter)
        _timed("q", phase_telemetry, workdir, formatter)
        _timed("s", phase_interop, workdir)
        _timed("t", phase_ps_elastic, workdir)
        serving = _timed("k, l, m", phase_serving, workdir, runs)
        _timed("r", phase_fleet_telemetry, workdir, runs, serving)
    print(f"smoke phases (s): {json.dumps(PHASE_SECONDS)}")
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
