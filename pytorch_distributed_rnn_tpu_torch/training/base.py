"""The local trainer: epoch loop, evaluation, checkpoints, the perf line.

The counterpart of the JAX package's ``training/base.py`` ``Trainer`` on
its ``local`` path:

- The training arrays go to the device once; each batch is gathered on
  the device from an index vector (the JAX ``DEVICE_DATA`` design), in the
  order of a ``DistributedSampler`` reseeded by ``set_epoch``.
- Per batch: forward, cross entropy, backward, ``torch.optim.Adam`` (its
  update is the ``optax.adam`` formula at the same defaults).
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
from pytorch_distributed_rnn_tpu_torch.ops.losses import cross_entropy_loss
from pytorch_distributed_rnn_tpu_torch.training.checkpoint import (
    load_checkpoint,
    rotate_checkpoints,
    save_checkpoint,
)
from pytorch_distributed_rnn_tpu_torch.training.formatter import TrainingMessageFormatter
from pytorch_distributed_rnn_tpu_torch.utils.profiling import measure_memory_and_time


def _correct_count(value) -> int:
    """Display form of the ``correct`` metric: classification counts are
    exact integers; the LM's fractional per-sequence accuracy sums
    (``training/lm.py``) round."""
    return int(round(float(value)))


class Trainer:
    """Single-device ("local") trainer.  ``model`` is an ``nn.Module``
    returning logits (e.g. ``MotionModel``); the datasets are array
    datasets (``MotionDataset``).  :meth:`_loss_and_metrics` is the one
    place that turns a batch into a loss; families with another objective
    override it (``training/lm.py``)."""

    def __init__(self, model, training_set, batch_size: int,
                 learning_rate: float, validation_set=None, test_set=None,
                 checkpoint_dir=None, seed: int | None = None,
                 checkpoint_every: int = 0, keep_checkpoints: int = 0,
                 device="cuda"):
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
        seed = seed if seed is not None else 0
        self.rank = 0  # the rank that evaluates and writes files
        self.sampler = DistributedSampler(len(training_set), num_replicas=1, rank=0, seed=seed)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8
        )
        # train-mode dropout masks come from this generator only
        self.dropout_generator = torch.Generator(device=self.device).manual_seed(seed ^ 0x5EED)
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

    # -- loop ----------------------------------------------------------------

    def train(self, epochs: int):
        """Train ``epochs`` epochs; returns ``(model, train_history,
        validation_history)``."""
        training_history: list[float] = []
        validation_history: list[float] = []
        formatter = TrainingMessageFormatter(epochs, self.rank)

        def train_inner():
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

    def _train_epoch(self, formatter):
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
            self.optimizer.step()
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
        opt_state = self.optimizer.state_dict()
        if self.rank != 0:
            return
        save_checkpoint(
            self.checkpoint_dir, epoch, self.model.state_dict(), opt_state, loss, best=best,
        )
        if not best and self.keep_checkpoints:
            rotate_checkpoints(self.checkpoint_dir, self.keep_checkpoints)

    def resume_from(self, checkpoint_path):
        """Restore model and optimizer state from a checkpoint file; the
        run then trains its full epoch count on top of it.  Returns the
        checkpoint's ``{"epoch", "loss"}``."""
        if Path(checkpoint_path).is_dir():
            raise ValueError(f"{checkpoint_path} is a directory - pass the .ckpt file")
        model_state, opt_state, meta = load_checkpoint(checkpoint_path)
        self.model.load_state_dict(model_state)
        self.optimizer.load_state_dict(opt_state)
        self._resume_best_loss = meta["loss"]
        return meta
