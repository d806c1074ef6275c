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
- Validation every epoch writes ``best-model.ckpt`` on a new best;
  ``checkpoint_every`` adds ``checkpoint-epoch-N.ckpt``; ``resume_from``
  restores model and optimizer; the test set is evaluated at the end.
- The loop runs under :func:`measure_memory_and_time`, logging the perf
  line and, on the card, a "Device HBM peaks (MiB)" line.

Loss and accuracy sums stay on the device until the epoch ends, so the
host does not wait for the card between steps.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from pytorch_distributed_rnn_tpu_torch.data.sampler import DistributedSampler
from pytorch_distributed_rnn_tpu_torch.ops.adam import DeviceStepAdam
from pytorch_distributed_rnn_tpu_torch.ops.losses import cross_entropy_loss
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
    strategies keep the per-batch loop."""

    GRAPH_STEP = True

    def __init__(self, model, training_set, batch_size: int,
                 learning_rate: float, validation_set=None, test_set=None,
                 checkpoint_dir=None, seed: int | None = None,
                 checkpoint_every: int = 0, keep_checkpoints: int = 0,
                 fuse_run: bool = False, device="cuda"):
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
        self.sampler = DistributedSampler(len(training_set), num_replicas=1, rank=0, seed=seed)
        self.optimizer = DeviceStepAdam(
            self.model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8
        )
        # train-mode dropout masks come from this generator only
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(seed ^ 0x5EED)
        self._buffers = {}  # StepBuffers by kind: "epoch", "run"
        self.graphs = {}  # the captured steps, by (kind, batch rows)
        self._capture_stream = None
        self._device_data = None
        self._eval_data = {}
        self._resume_best_loss = None

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

    # -- loop ----------------------------------------------------------------

    def train(self, epochs: int):
        """Train ``epochs`` epochs; returns ``(model, train_history,
        validation_history)``."""
        training_history: list[float] = []
        validation_history: list[float] = []
        formatter = TrainingMessageFormatter(epochs, self.rank)
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
            for epoch in range(epochs):
                self.sampler.set_epoch(epoch)
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
        if self.test_set is not None:
            self._evaluate(self.test_set, formatter)
        return self.model, training_history, validation_history

    def _fusable(self, epochs: int) -> bool:
        """The JAX trainer's gate of the one-program run: nothing needs the
        host between epochs.  The port has no gradient accumulation
        (``main.py`` rejects ``--grad-accum`` above 1), no fault schedule
        and no epoch-offset resume."""
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
        )

    def _train_epoch(self, formatter, eager: bool | None = None):
        """One epoch over the sampler's order; returns ``(loss, accuracy)``.
        ``eager`` picks the path: the per-batch loop (needed by progress
        logging at DEBUG, and the data-parallel strategies' only path) or
        the device-resident step; None picks the second where it can."""
        if eager is None:
            eager = not self.GRAPH_STEP or logging.getLogger().isEnabledFor(logging.DEBUG)
        if eager:
            return self._train_epoch_eager(formatter)
        batches = self._epoch_index_batches()
        rows = sum(len(idx) for idx in batches)
        run = self._step_buffers("epoch", rows, len(batches), weighted=False)
        run.load(np.concatenate(batches))
        self.model.train()
        for idx in batches:
            self._run_step(run, len(idx))
        losses, corrects = run.read()
        # parity quirk kept: sum of batch-mean losses / dataset size
        n = len(self.training_set)
        loss_sum, correct_sum = self._epoch_sums(_loss_sum(losses), float(corrects.sum()))
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
        n = len(self.training_set)
        return [_loss_sum(losses[e * steps:(e + 1) * steps]) / n for e in range(epochs)]

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
        if run.weights is None:
            loss, correct = self._loss_and_metrics(x, y, self.dropout_generator)
        else:
            loss, correct = self._weighted_loss_and_metrics(
                x, y, run.weights[rows], self.dropout_generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        at = run.step.view(1)
        run.losses.index_copy_(0, at, loss.detach().float().view(1))
        run.corrects.index_copy_(0, at, correct.detach().float().view(1))
        run.position.add_(size)
        run.step.add_(1)

    def _run_step(self, run: StepBuffers, size: int) -> None:
        """The next step of ``run``: on the CPU the body itself; on the
        card the replay of its graph for this shape.  The first step of a
        shape runs the body eagerly on the capture stream (the capture's
        warm-up, and this step of the run), then captures it (which runs
        nothing); a capture that fails raises."""
        if self.device.type != "cuda":
            self._step_body(run, size)
            return
        key = (run.kind, size)
        graph = self.graphs.get(key)
        if graph is not None:
            graph.replay()
            return
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

    def _train_epoch_eager(self, formatter):
        """The per-batch loop: a host index vector a batch, the batch's
        values read at once where progress is logged."""
        log_progress = logging.getLogger().isEnabledFor(logging.DEBUG)
        features, labels = self._device_train_data()
        batches = self._epoch_index_batches()
        self.model.train()
        total_loss = torch.zeros((), device=self.device)
        total_correct = 0  # a device tensor of the metric's dtype after the first batch
        for batch_idx, idx in enumerate(batches):
            idx_t = torch.from_numpy(idx).to(self.device)
            x, y = features[idx_t], labels[idx_t]
            loss, correct = self._loss_and_metrics(x, y, self.dropout_generator)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self._optimizer_step()
            total_loss += loss.detach()
            total_correct = total_correct + correct.detach()
            if log_progress:
                # needs the values now: one device round trip per batch
                logging.debug(formatter.train_progress_message(
                    batch_idx=batch_idx, batches=len(batches),
                    training_examples=len(idx), correct=_correct_count(correct),
                    loss=float(loss),
                ))
        # parity quirk kept: sum of batch-mean losses / dataset size
        n = len(self.training_set)
        loss_sum, correct_sum = self._epoch_sums(total_loss, total_correct)
        return loss_sum / n, correct_sum / n

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
        with torch.no_grad():
            loss, correct = self._loss_and_metrics(x, y)
            eval_loss = float(loss)
            total_correct = float(correct)
        accuracy = total_correct / len(dataset)
        logging.info(formatter.evaluation_message(
            accuracy, len(dataset), epoch, eval_loss, _correct_count(total_correct)
        ))
        return eval_loss, accuracy

    # -- checkpointing -------------------------------------------------------

    def _save_checkpoint(self, epoch, loss, best=False):
        if self.checkpoint_dir is None:
            return
        # every rank takes the optimizer state (a collective where it is
        # sharded); rank 0 writes
        opt_state = self._checkpoint_opt_state()
        if self.rank != 0:
            return
        save_checkpoint(
            self.checkpoint_dir, epoch, self.model.state_dict(), opt_state, loss, best=best,
        )
        if not best and self.keep_checkpoints:
            rotate_checkpoints(self.checkpoint_dir, self.keep_checkpoints)

    def _checkpoint_opt_state(self) -> dict:
        """The optimizer state a checkpoint holds, ``torch.optim.Adam``'s
        unsharded layout."""
        return self.optimizer.state_dict()

    def resume_from(self, checkpoint_path):
        """Restore model and optimizer state from a checkpoint file; the
        run then trains its full epoch count on top of it.  Returns the
        checkpoint's ``{"epoch", "loss"}``."""
        if Path(checkpoint_path).is_dir():
            raise ValueError(f"{checkpoint_path} is a directory - pass the .ckpt file")
        model_state, opt_state, meta = load_checkpoint(checkpoint_path)
        self.model.load_state_dict(model_state)
        self.optimizer.load_state_dict(opt_state)
        self.graphs = {}  # the loaded optimizer state lives in new tensors
        self._resume_best_loss = meta["loss"]
        return meta
