"""Parameter-server worker: local data and gradients, remote parameters.
The non-elastic part of the JAX package's ``param_server/worker.py``.

The worker keeps the data pipeline and the loss; the parameters and the
optimizer live on the master.  Each step runs forward and backward on the
worker's device through the port's models (and their kernels), pushes the
flat gradient with a sequence number, and adopts the parameters the
master sends back.  Evaluation, the test set and checkpointing are off on
workers, as in the reference.

- The shard is ``DistributedSampler(num_replicas=workers, rank=worker_id
  - 1, seed)`` and the batch ``batch_size // workers`` (the global batch
  split over the workers).
- Dropout draws from a generator seeded as ``training/distributed.py``
  seeds rank ``worker_id - 1``'s, so worker 1 draws ``local``'s masks.
- The flat order on the wire is ``torch.cat([p.reshape(-1) for p in
  model.parameters()])``, the order ``native_ddp._broadcast_params``
  uses; the master shares it.
- On the card the gradient is staged through a reused pinned host
  buffer and the reply received into another, as
  ``training/native_ddp.py`` stages its ring's buffers.
- An exchange is retried WHOLE (``resilience/retry.py``) within the
  ``--ps-sync-timeout`` deadline; the push's sequence number lets the
  master drop a duplicate.
- A SIGTERM (``resilience/membership.py:DrainSignal``) is a drain,
  honoured after the step's exchange: the gradient was applied exactly
  once, then the worker deregisters and exits 0.
- A ``--faults`` schedule bound to the worker's rank runs in its
  per-batch loop as in ``local``'s (``training/base.py``): the data faults
  (nan, stall, slow, exc) and ``kill``.  A NaN batch pushes a non-finite
  gradient, which the master refuses (its integrity check), as JAX's
  master does.

Telemetry (``recorder``, the worker's ``-r<rank>`` sidecar): the
trainer's step and epoch events, a ``ps_exchange`` event an exchange
(what, step, push seq, seconds, retries; ``failed`` before a failure
propagates) and ``member_drain`` on a drain, as the JAX worker records
them.

``exchange_log`` keeps each step's exchange as two ``perf_counter``
stamps: the push's first byte, and the copies that adopt the reply
queued on the device; ``train_started`` is the stamp training started
at.
"""

from __future__ import annotations

import logging
import time

import torch

from pytorch_distributed_rnn_tpu_torch.data.sampler import DistributedSampler
from pytorch_distributed_rnn_tpu_torch.param_server import protocol
from pytorch_distributed_rnn_tpu_torch.resilience.membership import DrainSignal
from pytorch_distributed_rnn_tpu_torch.resilience.retry import retry_transport
from pytorch_distributed_rnn_tpu_torch.training.base import Trainer
from pytorch_distributed_rnn_tpu_torch.training.distributed import _RANK_SEED_STRIDE

log = logging.getLogger(__name__)


class ParameterServerWorkerTrainer(Trainer):
    """Trainer whose optimizer step happens on the master."""

    # every step pushes gradients and pulls params over TCP: the host acts
    # per batch, so the per-batch loop only
    GRAPH_STEP = False
    # as the JAX worker (param_server/worker.py)
    SUPPORTS_GRAD_ACCUM = False
    # the master applies the update: a step here is forward and backward
    UPDATES_LOCALLY = False

    def __init__(self, model, training_set, batch_size: int, learning_rate: float,
                 comm=None, worker_rank: int = 1, num_workers: int = 1,
                 seed: int | None = None, device="cuda", transport_retries: int = 3,
                 transport_deadline_s: float | None = None,
                 drain_signal: DrainSignal | None = None, grad_accum: int = 1, faults=None,
                 recorder=None, profile_steps=None):
        if comm is None:
            raise ValueError("ParameterServerWorkerTrainer needs the transport (comm=)")
        # no guard here: the optimizer that applies updates is the master's,
        # whose finite-gradient check is the integrity guard
        super().__init__(model, training_set, max(1, batch_size // num_workers), learning_rate,
                         validation_set=None, test_set=None, checkpoint_dir=None, seed=seed,
                         device=device, grad_accum=grad_accum, faults=faults,
                         recorder=recorder, profile_steps=profile_steps)
        seed = seed if seed is not None else 0
        self.comm = comm
        self.rank = self.worker_rank = int(worker_rank)
        self.num_workers = int(num_workers)
        self.worker_id = self.worker_rank  # a fixed world: the id is the rank
        self.sampler = DistributedSampler(len(training_set), num_replicas=self.num_workers,
                                          rank=self.worker_id - 1, seed=seed)
        self.dropout_generator.manual_seed(
            (seed ^ 0x5EED) + (self.worker_id - 1) * _RANK_SEED_STRIDE)
        self._drain = drain_signal
        self._transport_retries = int(transport_retries)
        self._transport_deadline = transport_deadline_s
        # a RETRY re-sends the same seq, so the master can detect a
        # duplicate (reply leg failed after the update applied)
        self._push_seq = 0
        self._params = list(self.model.parameters())
        self.num_params = sum(p.numel() for p in self._params)
        self.exchange_log: list[tuple[float, float]] = []
        self.train_started = None
        self._pinned = {}
        # the initial pull: adopt the master's authoritative parameters
        self._adopt(self._exchange(self._pull_params, what="initial pull"))

    def _collective_ops(self) -> dict:
        """A step's exchange with the master: the flat gradient pushed,
        the flat parameters pulled (float32)."""
        flat = 4 * self.num_params
        return {"ps_push": {"count": 1, "bytes": flat}, "ps_pull": {"count": 1, "bytes": flat}}

    def train(self, epochs: int):
        self.train_started = time.perf_counter()
        return super().train(epochs)

    # -- host buffers ---------------------------------------------------------------

    def _host(self, slot: str) -> torch.Tensor | None:
        """A reused pinned flat host buffer on the card; None on the CPU
        (the transport then reads the tensor and fills a fresh one)."""
        if self.device.type != "cuda":
            return None
        buf = self._pinned.get(slot)
        if buf is None:
            buf = torch.empty(self.num_params, dtype=torch.float32, pin_memory=True)
            self._pinned[slot] = buf
        return buf

    # -- the exchange ---------------------------------------------------------------

    def _pull_params(self) -> torch.Tensor:
        protocol.send_request(self.comm, protocol.OP_PULL)
        return protocol.recv_params(self.comm, self.num_params, out=self._host("reply"))

    def _exchange(self, fn, what: str, seq: int | None = None):
        """One protocol exchange under the retry policy, retried WHOLE
        (request and reply); with a recorder, its latency and retries as a
        ``ps_exchange`` event (``seq``, the push's, pairs it with the
        master's round)."""
        recording = self.recorder.enabled
        retries = [0]

        def on_retry(attempt, exc):
            retries[0] = attempt

        t0 = time.perf_counter()
        try:
            result = retry_transport(fn, retries=self._transport_retries, seed=self.worker_rank,
                                     what=f"{what} (worker {self.worker_rank})",
                                     on_retry=on_retry if recording else None,
                                     deadline_s=self._transport_deadline)
        except Exception:
            if recording:
                self.recorder.record("ps_exchange", what=what, step=self._steps_done, seq=seq,
                                     seconds=time.perf_counter() - t0, retries=retries[0],
                                     failed=True)
                self.recorder.flush()  # the run is about to die with this
            raise
        if recording:
            self.recorder.record("ps_exchange", what=what, step=self._steps_done, seq=seq,
                                 seconds=time.perf_counter() - t0, retries=retries[0])
        return result

    @torch.no_grad()
    def _adopt(self, flat: torch.Tensor) -> None:
        """The master's flat params into the model (on the card queued on
        the current stream from the pinned reply buffer, which is
        rewritten only after the next step's fence)."""
        if flat.numel() != self.num_params:
            raise RuntimeError(f"parameter size mismatch: {flat.numel()} from the master, "
                               f"{self.num_params} here")
        fresh = flat.to(self.device, non_blocking=True)
        offset = 0
        for p in self._params:
            p.copy_(fresh[offset: offset + p.numel()].view_as(p))
            offset += p.numel()

    @torch.no_grad()
    def _optimizer_step(self) -> None:
        """The update of a step, remote: the flat gradient to the master
        with this step's seq, the fresh parameters back into the model."""
        flat = torch.cat([p.grad.reshape(-1) for p in self._params])
        staged = self._host("grad")
        if staged is None:
            grads = flat
        else:
            grads = staged.copy_(flat, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        self._push_seq += 1  # once per STEP; retries re-send the same
        seq = self._push_seq

        def push_pull():
            protocol.send_request(self.comm, protocol.OP_PUSH, grads=grads, seq=seq)
            return protocol.recv_params(self.comm, self.num_params, out=self._host("reply"))

        t0 = time.perf_counter()
        self._adopt(self._exchange(push_pull, what="gradient push", seq=seq))
        self.exchange_log.append((t0, time.perf_counter()))
        if self._drain is not None:
            # the step's exchange is complete (gradient applied, params
            # adopted): a pending SIGTERM drain is honoured HERE, so the
            # last push is applied exactly once
            self._drain.check()

    def finish(self):
        protocol.send_request(self.comm, protocol.OP_DONE)

    def deregister(self):
        """Voluntary leave (the drain path): the master shrinks the roster
        without burning the quorum budget."""
        protocol.send_request(self.comm, protocol.OP_DEREGISTER, seq=self._push_seq)
        log.info(f"worker-id {self.worker_id} (rank {self.worker_rank}) deregistered after "
                 f"push seq {self._push_seq}")
        if self.recorder.enabled:
            # health reads this rank as drained, not dead
            self.recorder.record("member_drain", worker_id=self.worker_id,
                                 rank_slot=self.worker_rank, seq=self._push_seq)
            self.recorder.flush()
