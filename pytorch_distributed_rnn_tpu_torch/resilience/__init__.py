"""Resilience, the counterpart of the JAX package's ``resilience/``:

- ``faults``: the deterministic ``--faults`` / ``PDRNN_CHAOS`` schedule
  (data-pipeline stalls, slow producers, exceptions, NaN batches, kills,
  and the ``net:*`` bridge onto the transport's ``PDRNN_FAULT_*``
  environment);
- ``guard``: the host half of ``--max-bad-steps`` (:class:`NonFiniteGuard`
  reads the guarded Adam's device counters, ``ops/adam.py``) and
  ``--resume auto`` (:func:`resume_latest`, past corrupt checkpoints);
- ``retry``: exponential backoff with deterministic jitter and an optional
  wall-clock deadline for a transport exchange (the parameter-server
  worker's push and pull);
- ``membership``: the master's :class:`Roster` of workers (stable
  worker-ids, the joined/drained/dead/done lifecycle, push-seq watermarks
  that make a retried push idempotent) and the worker's
  :class:`DrainSignal` (SIGTERM as a preemption notice: flush the
  in-flight exchange, deregister, exit 0).

The roster's elastic entries (``join`` of a respawn,
``restore_watermarks``) come with the elastic half of ROADMAP A7.
"""

from pytorch_distributed_rnn_tpu_torch.resilience.faults import (
    ChaosError,
    FaultEvent,
    FaultSchedule,
    fault_env,
)
from pytorch_distributed_rnn_tpu_torch.resilience.guard import (
    NonFiniteAbort,
    NonFiniteGuard,
    resume_latest,
)
from pytorch_distributed_rnn_tpu_torch.resilience.membership import (
    DrainRequested,
    DrainSignal,
    Member,
    Roster,
)
from pytorch_distributed_rnn_tpu_torch.resilience.retry import backoff_delays, retry_transport

__all__ = ["ChaosError", "DrainRequested", "DrainSignal", "FaultEvent", "FaultSchedule",
           "Member", "NonFiniteAbort", "NonFiniteGuard", "Roster", "backoff_delays",
           "fault_env", "resume_latest", "retry_transport"]
