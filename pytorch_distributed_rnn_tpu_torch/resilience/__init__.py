"""Resilience for the parameter server, the counterpart of part of the JAX
package's ``resilience/``:

- ``retry``: exponential backoff with deterministic jitter and an optional
  wall-clock deadline for a transport exchange (the parameter-server
  worker's push and pull);
- ``membership``: the master's :class:`Roster` of workers (stable
  worker-ids, the joined/drained/dead/done lifecycle, push-seq watermarks
  that make a retried push idempotent) and the worker's
  :class:`DrainSignal` (SIGTERM as a preemption notice: flush the
  in-flight exchange, deregister, exit 0).

The fault schedule (``faults``) and the non-finite guard (``guard``) come
with ``--faults`` and ``--max-bad-steps`` (ROADMAP A5); the roster's
elastic entries (``join`` of a respawn, ``restore_watermarks``) with the
elastic half of A7.
"""

from pytorch_distributed_rnn_tpu_torch.resilience.membership import (
    DrainRequested,
    DrainSignal,
    Member,
    Roster,
)
from pytorch_distributed_rnn_tpu_torch.resilience.retry import backoff_delays, retry_transport

__all__ = ["DrainRequested", "DrainSignal", "Member", "Roster", "backoff_delays",
           "retry_transport"]
