"""Data-parallel trainers, one process a rank: the ``distributed`` (DDP)
and ``horovod`` strategies.

The counterpart of the JAX package's ``training/distributed.py``.  The
JAX ``SpmdTrainer`` is one controller whose "ranks" are positions on a
``dp`` mesh axis; the port runs one process a rank over
``torch.distributed``, as the reference does under ``mpirun``
(``trainer/distributed.py``, ``ddp.py``, ``horovod.py``).  Each rank:

- takes ``batch_size // world`` rows a step, walking row ``rank`` of the
  sampler's ``global_indices()``, so step s of the world covers the rows
  of ``local``'s step s (global-batch semantics);
- draws dropout masks from its own generator, the rank folded into the
  seed (rank 0 draws ``local``'s masks);
- reports the train loss as the mean over ranks of the local means and
  ``correct`` summed over ranks, with one allreduce an epoch;
- leaves evaluation, checkpoints and ``history.json`` to rank 0, which
  broadcasts each evaluation's loss so every rank takes the same
  best-model decisions (and joins the optimizer-state gather of a
  sharded checkpoint);
- tags its log lines with its rank (``0: Memory Usage: ...``).

Each epoch runs the device-resident step of ``training/base.py`` (the
per-batch loop stays for ``--log DEBUG`` and step-addressed faults), and
``--fuse-run`` the whole run, each rank over its own sampler shard.  On
NCCL, one rank a card, each batch shape's step, its collectives included,
is captured as a CUDA graph once and replayed, as ``local``'s is.
Gloo's collectives (on the CPU, or through pinned host buffers where
ranks share a card) cannot be captured: there the same body runs
uncaptured, and the first step says so.  Both paths run the bare model:
under ``distributed`` with the replicated update the trainer averages
the gradients after the backward with the one ``pmean_`` that
``dp.flat_mean_hook`` makes inside DDP (the same bits), so that no
reducer, bucket rebuild or DDP warm-up rule meets a capture.

Checkpoints hold the unwrapped module's ``state_dict`` and
``torch.optim.Adam``'s unsharded per-parameter state, so a checkpoint of
any strategy resumes in any other, and every rank's dropout generator
state, gathered to rank 0 (a world of the same size and device resumes
each rank's stream).  The update is the optax formula
(``ops/adam.py``) on every path here, replicated or sharded, its count
on the device (``DeviceStepAdam``, ``ShardedUpdate.steps``).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from pytorch_distributed_rnn_tpu_torch.data.sampler import DistributedSampler
from pytorch_distributed_rnn_tpu_torch.ops.adam import DeviceStepAdam
from pytorch_distributed_rnn_tpu_torch.parallel import dp
from pytorch_distributed_rnn_tpu_torch.parallel.collectives import padded_size
from pytorch_distributed_rnn_tpu_torch.parallel.sharded_update import ShardedUpdate
from pytorch_distributed_rnn_tpu_torch.training.base import Trainer

log = logging.getLogger(__name__)

# the generator seeds of the ranks: rank r adds r times this odd constant
_RANK_SEED_STRIDE = 0x9E3779B1


def _adam(params, learning_rate: float, guarded: bool = False):
    """The strategies' Adam: ``DeviceStepAdam`` (its count on the device,
    so that a captured step sees each replay's count), guarded or not."""
    return DeviceStepAdam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                          guarded=guarded)


class SpmdTrainer(Trainer):
    """Shared machinery of the data-parallel strategies.  ``group`` is the
    ``parallel.collectives.World`` of this process; the model runs on its
    device.  ``sharded_update`` (the default, as in the JAX package)
    replaces the gradient allreduce and the replicated Adam step with
    ``parallel.sharded_update.ShardedUpdate``.  Under the non-finite
    guard the sharded update takes one verdict for the world (its flag
    summed over the ranks); the replicated update needs none, since the
    averaged gradient is the same on every rank, and steps the guarded
    ``DeviceStepAdam``."""

    SYNC = "backward"
    # as the JAX trainer (training/distributed.py): the step is built
    # around the strategy's collectives
    SUPPORTS_GRAD_ACCUM = False

    def __init__(self, model, training_set, batch_size: int, learning_rate: float,
                 validation_set=None, test_set=None, checkpoint_dir=None,
                 seed: int | None = None, checkpoint_every: int = 0,
                 keep_checkpoints: int = 0, fuse_run: bool = False, device=None, group=None,
                 sharded_update: bool = True, grad_accum: int = 1, faults=None,
                 max_bad_steps: int = 0, recorder=None, profile_steps=None):
        if group is None:
            raise ValueError(f"{type(self).__name__} needs the process group (group=)")
        if device is not None and torch.device(device).type != group.device.type:
            raise ValueError(f"device {device} is not the process group's {group.device}")
        super().__init__(model, training_set, batch_size, learning_rate,
                         validation_set=validation_set, test_set=test_set,
                         checkpoint_dir=checkpoint_dir, seed=seed,
                         checkpoint_every=checkpoint_every,
                         keep_checkpoints=keep_checkpoints, fuse_run=fuse_run,
                         device=group.device, grad_accum=grad_accum, faults=faults,
                         max_bad_steps=max_bad_steps, recorder=recorder,
                         profile_steps=profile_steps)
        seed = seed if seed is not None else 0
        self.group = group
        self.rank = group.rank
        self.world_size = group.size
        self.sampler = DistributedSampler(len(training_set), num_replicas=group.size,
                                          rank=group.rank, seed=seed)
        self.dropout_generator.manual_seed((seed ^ 0x5EED) + group.rank * _RANK_SEED_STRIDE)
        guarded = self.guard is not None
        self.sharded_update = bool(sharded_update)
        adam = _adam(self.model.parameters(), learning_rate,
                     guarded=guarded and not self.sharded_update)
        # distributed, replicated: the gradients averaged after the backward
        self._pmean_grads = self.SYNC == "backward" and not self.sharded_update
        self._said_uncaptured = False
        if self.SYNC == "backward":
            # what DDP's construction does: rank 0's weights everywhere
            dp.broadcast_params(self.model.parameters(), group)
        if self.sharded_update:
            self.optimizer = ShardedUpdate(adam, group.size, group.rank, group, guarded=guarded)
        elif self.SYNC == "backward":
            self.optimizer = adam
        else:
            self.optimizer = dp.DistributedOptimizer(adam, group)

    def _optimizer_step(self) -> None:
        """The update after the backward, in the per-batch loop and the
        step body alike.  Under ``distributed`` with the replicated update,
        first the average that ``dp.flat_mean_hook`` makes at DDP's last
        bucket: the gradients in ``parameters()`` order, one ``pmean_``."""
        if self._pmean_grads:
            self.group.pmean_([p.grad for p in self.model.parameters()])
        self.optimizer.step()

    def _captures(self) -> bool:
        """NCCL's collectives are captured with the step; gloo's cannot be
        (host tensors, or pinned host buffers on a shared card), so its
        world runs the body uncaptured, and says so once."""
        if self.group.backend == "nccl":
            return True
        if not self._said_uncaptured:
            self._said_uncaptured = True
            log.info(f"{self.rank}: {self.group.backend} collectives cannot be captured: "
                     f"the step body runs uncaptured on {self.device}")
        return False

    def _dropout_states(self) -> list:
        """Every rank's generator state, all-gathered (the ranks' states
        have one size: one kind of device)."""
        state = self.dropout_generator.get_state()
        gathered = self.group.all_gather(state.to(self.device))
        # each rank's state its own tensor: a view into the gathered one
        # would carry a storage offset into the checkpoint
        return [row.clone() for row in gathered.cpu().view(self.world_size, -1)]

    def _collective_ops(self) -> dict:
        """A step's collectives: the sharded update's reduce-scatter and
        all-gather of the padded flat vector (and the guard's one-flag
        sum), or one coalesced allreduce of the gradients (the replicated
        ``distributed`` update and Horovod's optimizer alike)."""
        params = list(self.model.parameters())
        itemsize = params[0].element_size()
        flat = padded_size(sum(p.numel() for p in params), self.world_size) * itemsize
        if not self.sharded_update:
            return {"all_reduce": {"count": 1, "bytes": flat}}
        ops = {"reduce_scatter": {"count": 1, "bytes": flat},
               "all_gather": {"count": 1, "bytes": flat}}
        if self.guard is not None:
            ops["all_reduce"] = {"count": 1, "bytes": padded_size(1, self.world_size) * 4}
        return ops

    def _epoch_index_batches(self):
        """This rank's rows of each global batch: ``batch_size // world`` of
        its sampler shard a step (every rank takes the same number)."""
        per_rank = max(1, self.batch_size // self.world_size)
        indices = np.asarray(self.sampler.indices())
        return [indices[s:s + per_rank] for s in range(0, len(indices), per_rank)]

    def _epoch_sums(self, total_loss, total_correct) -> tuple[float, float]:
        sums = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=self.device)
                            for v in (total_loss, total_correct)])
        self.group.psum_([sums])
        loss_sum, correct_sum = sums.tolist()
        return loss_sum / self.world_size, correct_sum

    def _evaluate(self, dataset, formatter, epoch=None):
        """Rank 0 evaluates; every rank gets its loss and accuracy."""
        result = torch.full((2,), float("nan"), dtype=torch.float64)
        if self.rank == 0:
            result = torch.tensor(super()._evaluate(dataset, formatter, epoch),
                                  dtype=torch.float64)
        result = result.to(self.device)
        self.group.broadcast_(result)
        eval_loss, accuracy = result.tolist()
        return eval_loss, accuracy


class DDPTrainer(SpmdTrainer):
    """``distributed``: gradients averaged as ``DistributedDataParallel``
    (reference ``trainer/ddp.py:19``) with ``dp.flat_mean_hook`` averages
    them, in one allreduce after ``backward()``, and rank 0's parameters
    broadcast at construction, as DDP's construction does."""

    SYNC = "backward"


class HorovodTrainer(SpmdTrainer):
    """``horovod``: local gradients handed to a ``DistributedOptimizer``
    that averages them inside ``step()``, and rank 0's parameters broadcast
    at ``train()`` entry (reference ``trainer/horovod.py:33-42``)."""

    SYNC = "step"

    def train(self, epochs: int):
        dp.broadcast_params(self.model.parameters(), self.group)
        return super().train(epochs)
