"""The local trainer: epoch loop, evaluation, checkpoints, the perf line.

The counterpart of the JAX package's ``training/base.py`` ``Trainer`` on
its ``local`` path:

- The training arrays go to the device once; each batch is gathered on
  the device from an index vector (the JAX ``DEVICE_DATA`` design), in the
  order of a ``DistributedSampler`` reseeded by ``set_epoch``.
- Per batch: forward, cross entropy, backward, Adam
  (``ops/adam.py:DeviceStepAdam``, the ``optax.adam`` update at the same
  defaults, its step count on the device).
- The device-resident fast paths, the JAX trainer's one-program epoch
  (``lax.scan``) and ``--fuse-run`` (the whole run as one program): one
  train-step body over static buffers (:class:`StepBuffers`: the rows of
  every step of the epoch or run on the device, a device counter that
  picks each step's rows, per-step losses and ``correct`` written there),
  captured as a CUDA graph once per batch shape and replayed
  (:meth:`Trainer._run_step`); on the CPU the same body runs directly.
  The first step of each shape runs eagerly as the capture's warm-up, so
  the run takes no extra optimizer step or dropout draw.  The per-epoch
  path runs when per-batch progress logging (DEBUG) is off; the per-batch
  loop stays for DEBUG.  The fused run pads every batch to full size with
  zero-weight rows (:meth:`Trainer._weighted_loss_and_metrics`) and reads
  the per-step losses once, at the end.
- Loss normalisation keeps the reference's quirks: train loss is the sum
  of batch-mean losses divided by the dataset size; evaluation is one
  batch holding the whole dataset.
- ``grad_accum`` (``--grad-accum``) splits each optimizer batch into k
  equal microbatches whose gradients and batch-mean losses are summed,
  then divided by k (an epoch's final partial batch takes the largest
  divisor of its size that is at most k), on both paths: a captured step
  holds all k.
- The guard (``max_bad_steps``, ``--max-bad-steps``): the optimizer's
  step is the guarded update (``ops/adam.py``), and
  ``resilience/guard.py:NonFiniteGuard`` reads its counters at each epoch
  end, at the end of the fused run, and each step of the per-batch loop
  a fault schedule forces.
- Faults (``faults``, ``--faults``, ``resilience/faults.py``): epoch
  events at each epoch's start; a schedule with step events runs the
  per-batch loop, whose batches come through ``data/prefetch.py``'s
  producer thread (the data faults fire there) and whose consumer runs
  the kills and the NaN batches.  Step addresses are run-relative.
- Validation every epoch writes ``best-model.ckpt`` on a new best;
  ``checkpoint_every`` adds ``checkpoint-epoch-N.ckpt``, in the JAX
  package's format (``training/checkpoint.py``); ``resume_from``
  restores model and optimizer (and, from the header's
  ``extra["trainer"]``, the dropout generator's state, and from the
  optimizer tree the guard's counters; ``advance_epoch`` continues at the
  checkpoint's epoch), from a file the port or the JAX package wrote;
  the test set is evaluated at the end.
- The loop runs under :func:`measure_memory_and_time`, logging the perf
  line and, on the card, a "Device HBM peaks (MiB)" line.
- Telemetry (``recorder``, ``--metrics``; ``obs/recorder.py``), the JAX
  trainer's events: one ``step`` event a step with ``dispatch_s`` (on the
  graph path the ``replay()`` call), ``data_wait_s`` (the per-batch
  loop's wait for its producer) and, on sampled steps only, ``fenced_s``
  after a stream synchronize; ``tm`` is the dispatch start, and the
  losses are read once an epoch, as the uninstrumented run reads them.
  ``epoch`` events carry the path (``step``: the graph path, ``host``:
  the per-batch loop, ``fused``: ``--fuse-run``, epoch events only); a
  capture after the first (a new batch shape) is a ``compile`` event;
  one ``collectives`` event a run holds the strategy's collectives of a
  step and the step's analytic FLOPs (``obs/flops.py``); ``eval``,
  ``checkpoint_save``/``checkpoint_restore``, ``profile`` and
  ``run_summary`` (with the efficiency ledger's block) complete the run,
  and the guard and the fault schedule record through the same recorder.
  No recorder call runs inside :meth:`Trainer._step_body` or a capture,
  and ``--metrics`` keeps the graph path.  ``profile_steps``
  (``--profile-steps``, ``obs/profile.py``) traces a step range.

Loss and accuracy sums stay on the device until the epoch ends, so the
host does not wait for the card between steps.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from pytorch_distributed_rnn_tpu_torch.data.prefetch import prefetch
from pytorch_distributed_rnn_tpu_torch.data.sampler import DistributedSampler
from pytorch_distributed_rnn_tpu_torch.obs.recorder import NULL_RECORDER
from pytorch_distributed_rnn_tpu_torch.ops.adam import DeviceStepAdam
from pytorch_distributed_rnn_tpu_torch.ops.losses import cross_entropy_loss
from pytorch_distributed_rnn_tpu_torch.resilience.guard import NonFiniteGuard
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import (
    load_checkpoint,
    rotate_checkpoints,
    save_checkpoint,
)
from pytorch_distributed_rnn_tpu_torch.training.formatter import TrainingMessageFormatter
from pytorch_distributed_rnn_tpu_torch.utils.graphs import CountedGraph
from pytorch_distributed_rnn_tpu_torch.utils.profiling import measure_memory_and_time

# the JAX trainer's message (training/base.py) for a --fuse-run it cannot fuse
FUSE_RUN_UNFUSABLE = (
    "--fuse-run needs a run with no host work between epochs: "
    "device-resident data, --no-validation, no "
    "--checkpoint-every, --grad-accum 1, no --faults schedule "
    "or epoch-offset resume, and (with dropout) a batch size "
    "dividing the training set"
)

log = logging.getLogger(__name__)


def _correct_count(value) -> int:
    """Display form of the ``correct`` metric: classification counts are
    exact integers; the LM's fractional per-sequence accuracy sums
    (``training/lm.py``) round."""
    return int(round(float(value)))


def _loss_sum(losses: np.ndarray) -> float:
    """Batch-mean losses summed one after another in float32, as the
    per-batch loop adds them on the device: both paths give the same
    bits."""
    return float(np.add.accumulate(losses.astype(np.float32))[-1])


class StepBuffers:
    """The static buffers of the device-resident train step over ``steps``
    steps (an epoch, or the fused run): ``order`` holds the training rows
    of every step one after another (``rows`` in all), ``weights`` their
    0/1 weights (the fused run's padding), ``position`` the rows the steps
    so far took and ``step`` their count, both on the device, and
    ``losses``/``corrects`` each step's batch-mean loss and ``correct``.
    A captured step reads and writes these by address: they are made once
    and refilled by :meth:`load`."""

    def __init__(self, kind: str, rows: int, steps: int, weighted: bool, device):
        self.kind = kind
        self.order = torch.zeros(rows, dtype=torch.int64, device=device)
        self.weights = torch.zeros(rows, dtype=torch.float32, device=device) if weighted else None
        self.losses = torch.zeros(steps, dtype=torch.float32, device=device)
        self.corrects = torch.zeros(steps, dtype=torch.float32, device=device)
        self.position = torch.zeros((), dtype=torch.int64, device=device)
        self.step = torch.zeros((), dtype=torch.int64, device=device)

    def fits(self, rows: int, steps: int, weighted: bool) -> bool:
        return (len(self.order) == rows and len(self.losses) == steps
                and (self.weights is not None) == weighted)

    def load(self, order: np.ndarray, weights: np.ndarray | None = None) -> None:
        """The run's rows (and weights), with both counters at 0."""
        self.order.copy_(torch.from_numpy(order.astype(np.int64)))
        if weights is not None:
            self.weights.copy_(torch.from_numpy(weights.astype(np.float32)))
        self.position.zero_()
        self.step.zero_()

    def read(self) -> tuple[np.ndarray, np.ndarray]:
        """Every step's loss and ``correct``: the run's one host read."""
        return self.losses.cpu().numpy(), self.corrects.cpu().numpy()


class Trainer:
    """Single-device ("local") trainer.  ``model`` is an ``nn.Module``
    returning logits (e.g. ``MotionModel``); the datasets are array
    datasets (``MotionDataset``).  :meth:`_loss_and_metrics` (and its
    weighted form for the fused run) is the one place that turns a batch
    into a loss; families with another objective override both
    (``training/lm.py``).  ``fuse_run`` asks for the whole run as one
    device program (``--fuse-run``), and raises where the run cannot be.

    ``GRAPH_STEP``: whether the trainer has the device-resident fast
    paths (the JAX trainer's ``DEVICE_DATA`` switch); the data-parallel
    strategies keep the per-batch loop.  ``SUPPORTS_GRAD_ACCUM``: whether
    it takes ``grad_accum`` above 1 (the JAX trainers' flag).
    ``UPDATES_LOCALLY``: whether the Adam update runs in this process (a
    parameter-server worker's runs on the master)."""

    GRAPH_STEP = True
    SUPPORTS_GRAD_ACCUM = True
    # whether a step's update runs here (the FLOP count of a step holds it)
    UPDATES_LOCALLY = True
    # the prepared batches the per-batch loop's producer thread runs ahead
    PREFETCH_DEPTH = 2

    def __init__(self, model, training_set, batch_size: int,
                 learning_rate: float, validation_set=None, test_set=None,
                 checkpoint_dir=None, seed: int | None = None,
                 checkpoint_every: int = 0, keep_checkpoints: int = 0,
                 fuse_run: bool = False, device="cuda", grad_accum: int = 1,
                 faults=None, max_bad_steps: int = 0, recorder=None, profile_steps=None):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.training_set = training_set
        self.validation_set = validation_set
        self.test_set = test_set
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        self.checkpoint_every = int(checkpoint_every or 0)
        self.keep_checkpoints = int(keep_checkpoints or 0)
        self._fuse_run = bool(fuse_run)
        seed = seed if seed is not None else 0
        self.rank = 0  # the rank that evaluates and writes files
        self.world_size = 1
        self.grad_accum = 1 if grad_accum is None else int(grad_accum)
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        if self.grad_accum > 1 and not self.SUPPORTS_GRAD_ACCUM:
            raise NotImplementedError(
                f"{type(self).__name__} builds its train step outside "
                "_make_grad_step and does not support grad_accum > 1"
            )
        if self.grad_accum > 1 and batch_size % self.grad_accum:
            # the user sized memory for k microbatches of every full batch
            raise ValueError(
                f"batch_size {batch_size} is not divisible by "
                f"grad_accum {self.grad_accum}"
            )
        # the chaos schedule (resilience/faults.py); step events force the
        # per-batch loop
        self._faults = faults
        # the non-finite guard: the optimizer's step is the guarded update
        self.guard = NonFiniteGuard(max_bad_steps) if max_bad_steps else None
        # structured telemetry (obs/recorder.py): NULL_RECORDER when off, and
        # then each instrumented site costs one attribute check; the guard
        # and the fault schedule record through it too
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        if self.guard is not None:
            self.guard.recorder = self.recorder
        if faults is not None:
            faults.recorder = self.recorder
        # --profile-steps (obs/profile.py): a step range traced
        self._profile = profile_steps
        # the collectives event (and the step's FLOPs) is recorded once
        self._collectives_recorded = False
        self._model_flops_per_step = None
        self._model_flops_exact = None
        # the batch kinds whose first capture (the warm-up) happened
        self._captured_kinds = set()
        self._epoch = 0
        # a strategy with host collectives publishes each step's
        # (comm_wait_s, comm_active_s) here
        self._last_step_comm = None
        self.sampler = DistributedSampler(len(training_set), num_replicas=1, rank=0, seed=seed)
        self.optimizer = DeviceStepAdam(
            self.model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            guarded=self.guard is not None,
        )
        # train-mode dropout masks come from this generator only
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(seed ^ 0x5EED)
        self._buffers = {}  # StepBuffers by kind: "epoch", "run"
        self.graphs = {}  # the captured steps, by (kind, batch rows)
        self._capture_stream = None
        self._device_data = None
        self._eval_data = {}
        self._resume_best_loss = None
        # --resume auto: epochs [0, _start_epoch) are in the restored
        # checkpoint; train() continues from there
        self._start_epoch = 0
        # run-relative optimizer steps: the fault schedule's step addresses
        self._steps_done = 0

    # -- data ----------------------------------------------------------------

    def _device_train_data(self):
        """Training arrays resident on the device (uploaded once)."""
        if self._device_data is None:
            self._device_data = (
                torch.from_numpy(np.asarray(self.training_set.features)).to(self.device),
                torch.from_numpy(np.asarray(self.training_set.labels).reshape(-1)).to(self.device),
            )
        return self._device_data

    def _epoch_index_batches(self):
        """The epoch's batches as index arrays, the final partial batch
        included (the reference loader's semantics)."""
        indices = np.asarray(self.sampler.indices())
        return [indices[s:s + self.batch_size] for s in range(0, len(indices), self.batch_size)]

    def _has_partial_batch(self) -> bool:
        """Whether epochs end in a smaller final batch (batch sizes are
        epoch-invariant; only the order shuffles)."""
        batches = self._epoch_index_batches()
        return len(batches) > 1 and len(batches[-1]) != len(batches[0])

    @staticmethod
    def _pad_batch(batch, full_size):
        """An index batch padded to ``full_size`` with zero-weight rows
        (index 0, weight 0), and its weights, for the fused run."""
        pad = full_size - len(batch)
        weights = np.ones(full_size, np.float32)
        if pad:
            batch = np.concatenate([batch, np.zeros(pad, dtype=batch.dtype)])
            weights[len(weights) - pad:] = 0.0
        return batch, weights

    # -- loss ----------------------------------------------------------------

    def _net(self):
        """The module a batch goes through: ``model`` itself here; a
        data-parallel wrapper of it in train mode where a strategy has one."""
        return self.model

    def _loss_and_metrics(self, x, y, generator=None):
        """A batch's mean loss and its ``correct`` count (classification:
        argmax of the logits equals the label).  ``generator`` drives
        train-mode dropout; evaluation passes None."""
        logits = self._net()(x, generator)
        return cross_entropy_loss(logits, y), (logits.argmax(dim=1) == y).sum()

    def _weighted_loss_and_metrics(self, x, y, w, generator=None):
        """The fused run's loss: ``w`` is a 0/1 weight a row.  With all-ones
        weights it is the plain loss up to rounding; with a zero-padded
        tail it is the mean over the reference's smaller final batch."""
        logits = self._net()(x, generator)
        nll = cross_entropy_loss(logits, y, reduction="none")
        loss = (nll * w).sum() / w.sum()
        return loss, ((logits.argmax(dim=1) == y) * (w > 0)).sum()

    def _microbatches(self, rows: int) -> int:
        """The microbatches of a batch of ``rows``: the largest divisor of
        ``rows`` that is at most ``grad_accum`` (1: the batch in one shot)."""
        return next(d for d in range(self.grad_accum, 0, -1) if rows % d == 0)

    def _gradients(self, x, y, w=None):
        """One optimizer batch's forward and backward, its gradients left
        in the parameters' ``.grad``; returns its batch-mean loss and its
        ``correct``, detached.  ``w`` (the fused run's weights) takes the
        weighted loss.  With ``grad_accum`` > 1 the batch runs as k equal
        microbatches in order, each drawing its dropout masks from the
        generator in turn; their gradients and losses are summed, then
        divided by k, and their ``correct`` summed (the JAX trainer's
        ``accum_step``)."""
        self.optimizer.zero_grad(set_to_none=True)
        k = self._microbatches(len(y))
        if k == 1:
            if w is None:
                loss, correct = self._loss_and_metrics(x, y, self.dropout_generator)
            else:
                loss, correct = self._weighted_loss_and_metrics(x, y, w, self.dropout_generator)
            loss.backward()
            return loss.detach(), correct.detach()
        rows = len(y) // k
        loss_sum = correct_sum = None
        for i in range(k):
            part = slice(i * rows, (i + 1) * rows)
            loss, correct = self._loss_and_metrics(x[part], y[part], self.dropout_generator)
            loss.backward()  # the gradients add up in .grad
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            correct_sum = correct.detach() if correct_sum is None else correct_sum + correct.detach()
        with torch.no_grad():
            torch._foreach_div_([p.grad for p in self.model.parameters() if p.grad is not None],
                                float(k))
        return loss_sum / k, correct_sum

    def _guard_check(self) -> None:
        """The guard's host check of the optimizer's counters, where the
        run has a guard."""
        if self.guard is not None:
            self.guard.check(self.optimizer.nonfinite)

    def _chaos_host_loop(self) -> bool:
        """Whether the fault schedule forces the per-batch loop: its step
        events address single optimizer steps."""
        return self._faults is not None and self._faults.has_step_events

    # -- loop ----------------------------------------------------------------

    def train(self, epochs: int):
        """Train ``epochs`` epochs; returns ``(model, train_history,
        validation_history)``."""
        training_history: list[float] = []
        validation_history: list[float] = []
        formatter = TrainingMessageFormatter(epochs, self.rank)
        if self._profile is not None:
            self._profile.bind(self.device, self.rank)
        fusable = self._fusable(epochs)
        if self._fuse_run and not fusable:
            # asked for one program: running epoch by epoch instead would
            # bring back the host work between epochs it is meant to remove
            raise ValueError(FUSE_RUN_UNFUSABLE)
        fused_run = fusable and (
            self._fuse_run or not logging.getLogger().isEnabledFor(logging.INFO)
        )

        def train_inner():
            if fused_run:
                training_history.extend(self._train_run_fused(epochs))
                return
            best_loss = self._resume_best_loss
            for epoch in range(self._start_epoch, epochs):
                if self._faults is not None:
                    self._faults.on_epoch_start(epoch)
                self.sampler.set_epoch(epoch)
                self._epoch = epoch
                logging.info(formatter.epoch_start_message(epoch))
                train_loss, _ = self._train_epoch(formatter)
                training_history.append(train_loss)
                if self.checkpoint_every and (epoch + 1) % self.checkpoint_every == 0:
                    self._save_checkpoint(epoch, train_loss, best=False)
                if self.validation_set is not None:
                    validation_loss, _ = self._evaluate(self.validation_set, formatter, epoch)
                    validation_history.append(validation_loss)
                    if best_loss is None or best_loss > validation_loss:
                        logging.info(f"New best model in epoch {epoch + 1}")
                        best_loss = validation_loss
                        self._save_checkpoint(epoch, validation_loss, best=True)

        # the captures run inside the timed region, as the JAX trainer's
        # compiles do
        _, memory, duration, device_peaks = measure_memory_and_time(
            train_inner, device=self.device
        )
        logging.info(formatter.performance_message(memory, duration))
        if device_peaks:
            # a separate line: the perf line above stays byte-compatible
            rendered = ", ".join(f"{d}={mb:.1f}" for d, mb in sorted(device_peaks.items()))
            logging.info(f"Device HBM peaks (MiB): {rendered}")
        if self._profile is not None:
            self.recorder.record("profile", **self._profile.close())
        if self.recorder.enabled:
            self.recorder.record(
                "run_summary", memory_mb=memory, duration_s=duration,
                device_peaks_mb=device_peaks or {}, steps=self._steps_done, epochs=epochs,
                nan_skipped=self.guard.total_skipped if self.guard is not None else 0,
                faults_fired=dict(self._faults.fired) if self._faults is not None else {},
                ledger=self._ledger_block(),
            )
            self.recorder.flush()
        if self.test_set is not None:
            self._evaluate(self.test_set, formatter)
        return self.model, training_history, validation_history

    # -- telemetry -----------------------------------------------------------

    def _fence(self) -> None:
        """The work queued on the device is done (a stream synchronize on
        the card; nothing on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _collective_ops(self) -> dict:
        """The strategy's collectives of one step, ``{op: {"count",
        "bytes"}}`` (the bytes a rank puts on the wire); ``local`` has none."""
        return {}

    def _maybe_record_collectives(self, rows: int) -> None:
        """Once a run, before the first step: the ``collectives`` event
        with the strategy's collectives of a step and the analytic FLOPs
        and boundary bytes of a step of ``rows`` rows (``obs/flops.py``,
        counted on a ``meta`` copy of the model: nothing runs on the
        device).  A count that fails records its error, not the run's."""
        if self._collectives_recorded or not self.recorder.enabled:
            return
        self._collectives_recorded = True
        from pytorch_distributed_rnn_tpu_torch.obs.flops import step_flop_stats

        t0 = time.perf_counter()
        try:
            stats = step_flop_stats(self, rows)
            ops = self._collective_ops()
        except Exception as exc:  # telemetry must never kill the run
            self.recorder.record("collectives", ops=None, bytes_per_step=None,
                                 error=f"{type(exc).__name__}: {str(exc)[:200]}")
            return
        self._model_flops_per_step = stats["flops"]
        self._model_flops_exact = stats["exact"]
        self.recorder.record(
            "collectives", ops=ops, bytes_per_step=sum(op["bytes"] for op in ops.values()),
            model_flops_per_step=stats["flops"], model_flops_exact=stats["exact"],
            matmul_flops_per_step=stats["matmul_flops"], arg_bytes=stats["arg_bytes"],
            out_bytes=stats["out_bytes"], count_s=time.perf_counter() - t0,
        )

    def _ledger_block(self) -> dict:
        """run_summary's efficiency-ledger block: the step's FLOPs and the
        peak the ledger divides by (``utils/hw.py``, for the device and the
        compute dtype of the run), recorded here so that readers need no
        card."""
        from pytorch_distributed_rnn_tpu_torch.utils.hw import local_peak_flops

        precision = "bf16" if getattr(self.model, "precision", "f32") == "bf16" else "f32"
        peak = local_peak_flops(self.device, precision)
        return {
            "model_flops_per_step": self._model_flops_per_step,
            "model_flops_exact": self._model_flops_exact,
            "backend": peak["backend"],
            "device_kind": peak["device"],
            "device_count": peak["device_count"],
            "precision": precision,
            "peak_flops_total": peak["peak_flops_total"],
            "peak_flops_estimated": peak["estimated"],
        }

    def _note_capture(self, run: StepBuffers, size: int, step: int, tm: float) -> None:
        """A capture of ``run``'s step at ``size`` rows just happened: the
        first of its kind is the warm-up; a later one (a new batch shape)
        is a ``compile`` event with the capture's wall time."""
        if run.kind not in self._captured_kinds:
            self._captured_kinds.add(run.kind)
            return
        graph = self.graphs[(run.kind, size)]
        cache_size = sum(1 for key in self.graphs if key[0] == run.kind)
        self.recorder.record("compile", step=step, seconds=graph.capture_s,
                             cache_size=cache_size, tm=tm)

    def _fusable(self, epochs: int) -> bool:
        """The JAX trainer's gate of the one-program run: nothing needs the
        host between epochs."""
        dropout = getattr(self.model, "dropout", 0.0) or 0.0
        return (
            self.GRAPH_STEP
            and self.validation_set is None
            and epochs > 0
            # with dropout, a padded final batch would draw its mask over
            # the full batch's shape and leave the per-epoch path's draws
            and not (dropout > 0.0 and self._has_partial_batch())
            # periodic checkpoints need the host at epoch boundaries
            and not (self.checkpoint_every and self.checkpoint_dir)
            # the fused run's weighted loss is not equal-microbatch
            # accumulation
            and self.grad_accum == 1
            # chaos injection and epoch-offset resume both need the host
            # at epoch (or step) boundaries
            and self._faults is None
            and self._start_epoch == 0
            # step-bounded profiling addresses single steps
            and self._profile is None
            # step telemetry needs the host at epochs at least; an explicit
            # --fuse-run still wins (epoch events only)
            and (self._fuse_run or not self.recorder.enabled)
        )

    def _train_epoch(self, formatter, eager: bool | None = None):
        """One epoch over the sampler's order; returns ``(loss, accuracy)``.
        ``eager`` picks the path: the per-batch loop (needed by progress
        logging at DEBUG, and the data-parallel strategies' only path) or
        the device-resident step; None picks the second where it can."""
        if eager is None:
            eager = (not self.GRAPH_STEP or self._chaos_host_loop()
                     or logging.getLogger().isEnabledFor(logging.DEBUG))
        if eager:
            return self._train_epoch_eager(formatter)
        batches = self._epoch_index_batches()
        rows = sum(len(idx) for idx in batches)
        run = self._step_buffers("epoch", rows, len(batches), weighted=False)
        run.load(np.concatenate(batches))
        self.model.train()
        recording = self.recorder.enabled
        t_epoch = time.perf_counter()
        step_base = self._steps_done
        raw = []
        for i, idx in enumerate(batches):
            step = step_base + i
            if recording:
                self._maybe_record_collectives(len(idx))
            if self._profile is not None:
                self._profile.on_step_start(step)
            t0 = time.perf_counter()
            captured = self._run_step(run, len(idx))
            dispatch_s = time.perf_counter() - t0
            fenced_s = None
            if recording and self.recorder.is_sample_step(step):
                self._fence()
                fenced_s = time.perf_counter() - t0
            if recording and captured:
                self._note_capture(run, len(idx), step, t0)
            if self._profile is not None:
                self._profile.on_step_end(step)
            self._steps_done = step + 1
            self.recorder.note_progress(step)
            if recording:
                raw.append((step, t0, dispatch_s, fenced_s))
        losses, corrects = run.read()
        # step events after the loop, from the epoch's one read of the
        # losses; tm is each step's dispatch start
        for (step, t0, dispatch_s, fenced_s), loss in zip(raw, losses):
            self.recorder.record("step", step=step, epoch=self._epoch, loss=float(loss),
                                 dispatch_s=dispatch_s, data_wait_s=0.0, fenced_s=fenced_s,
                                 tm=t0)
        # the graph path visits the host once an epoch: the guard decides
        # here (the device already skipped the bad updates)
        self._guard_check()
        # parity quirk kept: sum of batch-mean losses / dataset size
        n = len(self.training_set)
        loss_sum, correct_sum = self._epoch_sums(_loss_sum(losses), float(corrects.sum()))
        self.recorder.record("epoch", epoch=self._epoch, steps=len(batches), loss=loss_sum / n,
                             acc=correct_sum / n, wall_s=time.perf_counter() - t_epoch,
                             path="step", tm=t_epoch)
        return loss_sum / n, correct_sum / n

    def _train_run_fused(self, epochs: int) -> list[float]:
        """``epochs`` epochs as one run of the weighted step over every
        epoch's batches, padded to full size; returns the per-epoch train
        losses (sum of batch-mean losses / dataset size)."""
        order, weights = [], []
        for epoch in range(epochs):
            self.sampler.set_epoch(epoch)
            batches = self._epoch_index_batches()
            full_size = len(batches[0])
            for idx in batches:
                idx, w = self._pad_batch(idx, full_size)
                order.append(idx)
                weights.append(w)
        steps = len(order) // epochs
        run = self._step_buffers("run", full_size * len(order), len(order), weighted=True)
        run.load(np.concatenate(order), np.concatenate(weights))
        self.model.train()
        for _ in range(len(order)):
            self._run_step(run, full_size)
        losses, _ = run.read()
        self._steps_done += len(order)
        self._guard_check()  # the fused run's one host visit
        n = len(self.training_set)
        history = [_loss_sum(losses[e * steps:(e + 1) * steps]) / n for e in range(epochs)]
        # the fused run visits the host once: its telemetry is per epoch,
        # after the fact
        for epoch, loss in enumerate(history):
            self.recorder.record("epoch", epoch=epoch, steps=steps, loss=loss, acc=None,
                                 wall_s=None, path="fused")
        return history

    def _step_buffers(self, kind: str, rows: int, steps: int, weighted: bool) -> StepBuffers:
        """The ``kind`` run's buffers at this size, made anew (and that
        kind's captured steps dropped) where the size changed."""
        run = self._buffers.get(kind)
        if run is None or not run.fits(rows, steps, weighted):
            run = StepBuffers(kind, rows, steps, weighted, self.device)
            self._buffers[kind] = run
            self.graphs = {key: g for key, g in self.graphs.items() if key[0] != kind}
        return run

    def _step_body(self, run: StepBuffers, size: int) -> None:
        """One train step of ``size`` rows at ``run``'s counters: gather,
        forward, loss (weighted where ``run`` has weights), backward, Adam,
        the loss and ``correct`` into ``run``, the counters on.  Reads
        nothing on the host, so a CUDA graph can capture it."""
        features, labels = self._device_train_data()
        rows = run.position + torch.arange(size, device=self.device)
        idx = run.order[rows]
        x, y = features[idx], labels[idx]
        loss, correct = self._gradients(x, y, None if run.weights is None else run.weights[rows])
        self.optimizer.step()
        at = run.step.view(1)
        run.losses.index_copy_(0, at, loss.float().view(1))
        run.corrects.index_copy_(0, at, correct.float().view(1))
        run.position.add_(size)
        run.step.add_(1)

    def _run_step(self, run: StepBuffers, size: int) -> bool:
        """The next step of ``run``: on the CPU the body itself; on the
        card the replay of its graph for this shape.  The first step of a
        shape runs the body eagerly on the capture stream (the capture's
        warm-up, and this step of the run), then captures it (which runs
        nothing); a capture that fails raises.  Returns whether it
        captured."""
        if self.device.type != "cuda":
            self._step_body(run, size)
            return False
        key = (run.kind, size)
        graph = self.graphs.get(key)
        if graph is not None:
            graph.replay()
            return False
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self._step_body(run, size)
        torch.cuda.current_stream().wait_stream(stream)
        # the captured backward makes the gradients in the graph's pool
        self.optimizer.zero_grad(set_to_none=True)
        graph = CountedGraph([self.dropout_generator])
        graph.capture(lambda: self._step_body(run, size), stream)
        self.graphs[key] = graph
        return True

    def _train_epoch_eager(self, formatter):
        """The per-batch loop: the epoch's index batches come through a
        prefetch producer thread (where a fault schedule's data faults
        fire), a host index vector a batch, the batch's values read at once
        where progress is logged.  The consumer runs the schedule's kills
        and NaN batches; with a schedule and a guard, the guard checks
        each step."""
        log_progress = logging.getLogger().isEnabledFor(logging.DEBUG)
        features, labels = self._device_train_data()
        batches = self._epoch_index_batches()
        faults = self._faults
        epoch_base = self._steps_done  # run-relative fault addresses

        def source():
            for i, idx in enumerate(batches):
                if faults is not None:
                    # loader-side faults start in the producer, where a
                    # real loader's failure would
                    faults.on_producer_item(epoch_base + i)
                yield idx

        self.model.train()
        recording = self.recorder.enabled
        t_epoch = time.perf_counter()
        total_loss = torch.zeros((), device=self.device)
        total_correct = 0  # a device tensor of the metric's dtype after the first batch
        raw, losses = [], []  # the recorded steps, and their device losses
        stream = prefetch(source(), depth=self.PREFETCH_DEPTH)
        try:
            batch_iter = iter(stream)
            batch_idx = 0
            while True:
                # the wait for the producer: ~0 while the pipeline keeps up
                t_wait = time.perf_counter()
                try:
                    idx = next(batch_iter)
                except StopIteration:
                    break
                data_wait_s = time.perf_counter() - t_wait
                step = epoch_base + batch_idx
                if recording:
                    self._maybe_record_collectives(len(idx))
                if self._profile is not None:
                    self._profile.on_step_start(step)
                t0 = time.perf_counter()
                idx_t = torch.from_numpy(idx).to(self.device)
                x, y = features[idx_t], labels[idx_t]
                if faults is not None:
                    faults.maybe_kill(step=step)
                    x, y = faults.corrupt_batch(step, (x, y))
                self._last_step_comm = None
                loss, correct = self._gradients(x, y)
                self._optimizer_step()
                dispatch_s = time.perf_counter() - t0
                fenced_s = None
                if recording and self.recorder.is_sample_step(step):
                    self._fence()
                    fenced_s = time.perf_counter() - t0
                if self._profile is not None:
                    self._profile.on_step_end(step)
                self._steps_done = step + 1
                self.recorder.note_progress(step)
                if faults is not None:
                    # a chaos run is per-batch already: deciding each step
                    # aborts K+1 steps after divergence starts
                    self._guard_check()
                total_loss += loss
                total_correct = total_correct + correct
                if log_progress:
                    # needs the values now: one device round trip per batch
                    logging.debug(formatter.train_progress_message(
                        batch_idx=batch_idx, batches=len(batches),
                        training_examples=len(idx), correct=_correct_count(correct),
                        loss=float(loss),
                    ))
                if recording:
                    raw.append((step, t0, dispatch_s, fenced_s, data_wait_s,
                                self._last_step_comm))
                    losses.append(loss)
                batch_idx += 1
        finally:
            # an early exit (injected exception, guard abort) leaves no
            # producer thread behind
            stream.close()
        if recording:
            self._record_host_steps(raw, losses)
        # parity quirk kept: sum of batch-mean losses / dataset size
        n = len(self.training_set)
        loss_sum, correct_sum = self._epoch_sums(total_loss, total_correct)
        self._guard_check()
        self.recorder.record("epoch", epoch=self._epoch, steps=batch_idx, loss=loss_sum / n,
                             acc=correct_sum / n, wall_s=time.perf_counter() - t_epoch,
                             path="host", tm=t_epoch)
        return loss_sum / n, correct_sum / n

    def _record_host_steps(self, raw, losses) -> None:
        """The per-batch loop's step events, after the loop: the losses
        in one read, and a strategy's host-collective times where it
        published them (``comm_wait_s``, and ``overlap_frac`` = 1 -
        wait/active, the share of the collectives' time the host did not
        sit blocked)."""
        values = torch.stack(losses).float().tolist() if losses else []
        for (step, t0, dispatch_s, fenced_s, data_wait_s, comm), loss in zip(raw, values):
            extra = {}
            if comm is not None:
                wait_s, active_s = comm
                extra["comm_wait_s"] = wait_s
                if active_s > 0:
                    extra["overlap_frac"] = max(0.0, 1.0 - wait_s / active_s)
            self.recorder.record("step", step=step, epoch=self._epoch, loss=loss,
                                 dispatch_s=dispatch_s, data_wait_s=data_wait_s,
                                 fenced_s=fenced_s, tm=t0, **extra)

    def _optimizer_step(self) -> None:
        """The update of the per-batch loop, after the backward: the
        optimizer's step here; a strategy that moves the gradients itself
        (``distributed-native``) runs its schedule."""
        self.optimizer.step()

    def _epoch_sums(self, total_loss, total_correct) -> tuple[float, float]:
        """The epoch's sum of batch-mean losses and its ``correct`` sum."""
        return float(total_loss), float(total_correct)

    def _evaluate(self, dataset, formatter, epoch=None):
        """Whole-dataset evaluation as one batch, eval mode, no grad."""
        key = id(dataset)
        cached = self._eval_data.get(key)
        if cached is None or cached[0] is not dataset:
            x = torch.from_numpy(np.asarray(dataset.features)).to(self.device)
            y = torch.from_numpy(np.asarray(dataset.labels).reshape(-1)).to(self.device)
            cached = (dataset, x, y)
            self._eval_data[key] = cached
        _, x, y = cached
        self.model.eval()
        # the float() reads end the evaluation: the span is its wall time
        with self.recorder.span("eval", cat="eval", epoch=epoch), torch.no_grad():
            loss, correct = self._loss_and_metrics(x, y)
            eval_loss = float(loss)
            total_correct = float(correct)
        accuracy = total_correct / len(dataset)
        self.recorder.record("eval", epoch=epoch, loss=eval_loss, acc=accuracy)
        logging.info(formatter.evaluation_message(
            accuracy, len(dataset), epoch, eval_loss, _correct_count(total_correct)
        ))
        return eval_loss, accuracy

    # -- checkpointing -------------------------------------------------------

    def _save_checkpoint(self, epoch, loss, best=False):
        if self.checkpoint_dir is None:
            return
        t0 = time.perf_counter()
        # every rank takes the optimizer state and the dropout streams
        # (collectives in a world); rank 0 writes
        opt_state = self._checkpoint_opt_state()
        trainer_state = self._trainer_state()
        if self.rank == 0:
            save_checkpoint(
                self.checkpoint_dir, epoch, self.model.state_dict(), opt_state, loss, best=best,
                trainer_state=trainer_state,
            )
            if not best and self.keep_checkpoints:
                rotate_checkpoints(self.checkpoint_dir, self.keep_checkpoints)
        self.recorder.record("checkpoint_save", epoch=epoch, best=bool(best),
                             seconds=time.perf_counter() - t0, format="gathered",
                             asynchronous=False)

    def _checkpoint_opt_state(self) -> dict:
        """The optimizer state a checkpoint holds, ``torch.optim.Adam``'s
        unsharded layout."""
        return self.optimizer.state_dict()

    def _dropout_states(self) -> list:
        """Every rank's dropout generator state in rank order, read
        between steps, outside any capture: this process's alone here; a
        world gathers them (a collective on every rank)."""
        return [self.dropout_generator.get_state()]

    def _trainer_state(self) -> dict:
        """The checkpoint's trainer state: every rank's dropout generator
        state (``dropout_generators``, in rank order) with the world and
        the kind of device they belong to (the header's
        ``extra["trainer"]``), and the guard's counters where the run has a
        guard (the optimizer tree's ``apply_if_finite`` state)."""
        state = {"world": self.world_size, "device": self.device.type,
                 "dropout_generators": self._dropout_states()}
        if self.guard is not None:
            state["nonfinite"] = self.optimizer.nonfinite.state_dict()
        return state

    def _restore_trainer_state(self, path, state) -> None:
        """Adopt a checkpoint's trainer state: this rank's dropout stream,
        where the checkpoint's world has this one's size and kind of
        device (a CPU generator's state is not a card's), and the guard's
        counters, so that a resumed run draws the masks and counts the
        skips of an uninterrupted one.  A checkpoint from another world or
        device, or one the JAX package wrote, starts the masks fresh from
        the seed, and says so."""
        streams = None if state is None else state.get("dropout_generators")
        if (streams is None or state.get("world") != self.world_size
                or len(streams) != self.world_size or state.get("device") != self.device.type):
            log.info(f"{path} holds no dropout stream for this run: its dropout masks "
                     "start fresh from the seed")
        else:
            self.dropout_generator.set_state(streams[self.rank])
        if self.guard is not None and state is not None and "nonfinite" in state:
            self.optimizer.nonfinite.load_state_dict(state["nonfinite"])
            self.guard.total_skipped = state["nonfinite"]["total_notfinite"]

    def _with_hyperparameters(self, opt_state: dict) -> dict:
        """``opt_state`` with this optimizer's hyperparameters in its group
        where the checkpoint has none (JAX's format keeps them out of the
        state; an older port file's own win, as they did)."""
        adam = getattr(self.optimizer, "optimizer", self.optimizer)
        live = {k: v for k, v in adam.param_groups[0].items() if k != "params"}
        return {"state": opt_state["state"],
                "param_groups": [{**live, **group} for group in opt_state["param_groups"]]}

    def resume_from(self, checkpoint_path, advance_epoch: bool = False):
        """Restore model and optimizer state from a checkpoint file.  Returns
        the checkpoint's ``{"epoch", "loss", "trainer"}``.  The run then
        trains its full epoch count on top of it, or with ``advance_epoch``
        (``--resume auto``) only the epochs after the checkpoint's, so a
        run killed after epoch E and restarted covers exactly the rest."""
        if Path(checkpoint_path).is_dir():
            raise ValueError(f"{checkpoint_path} is a directory - pass the .ckpt file")
        t0 = time.perf_counter()
        model_state, opt_state, meta = load_checkpoint(
            checkpoint_path, names=[name for name, _ in self.model.named_parameters()])
        self.model.load_state_dict(model_state)
        self.optimizer.load_state_dict(self._with_hyperparameters(opt_state))
        self._restore_trainer_state(checkpoint_path, meta["trainer"])
        self.graphs = {}  # the loaded optimizer state lives in new tensors
        self._resume_best_loss = meta["loss"]
        if advance_epoch:
            self._start_epoch = int(meta["epoch"])
        self.recorder.record("checkpoint_restore", path=str(checkpoint_path),
                             epoch=int(meta["epoch"]), seconds=time.perf_counter() - t0)
        return meta
