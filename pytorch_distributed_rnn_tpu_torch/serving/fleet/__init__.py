"""Serving fleet: a fault-tolerant router over ``serve`` replicas, the
counterpart of the JAX package's ``serving/fleet/``.

The scale-out layer of the serving stack: a front-end
TCP router (``router``) speaking the same JSON-lines protocol as
a single ``serve``, dispatching over N engine replicas with

- a health-checked replica pool (``pool.py``): periodic pings plus the
  live plane's digests as the load signal, least-loaded dispatch, and a
  per-replica circuit breaker (eject after consecutive failures,
  half-open probing for re-admission);
- per-request robustness (``router.py``): deadline propagation,
  retry-budgeted re-dispatch of idempotent seeded requests to sibling
  replicas (the seed pins the decode, so a sibling gives the tokens
  the first replica would have),
  tail-latency hedging behind ``--hedge-after-ms``, and QoS classes
  with priority shedding past the admission budget;
- degradation drills (``drill.py``): ``loadgen --spawn-fleet N``
  runs replicas under a
  :class:`~pytorch_distributed_rnn_tpu_torch.launcher.supervisor.ReplicaSupervisor`,
  kills one mid-burst, and asserts rerouting + exactly-once accounting
  (done + shed + errors == submitted) + SLO recovery.

A client that speaks to ``serve`` speaks to ``router``
unchanged; the fleet is invisible until something fails.
"""

from pytorch_distributed_rnn_tpu_torch.serving.fleet.pool import (  # noqa: F401
    Replica,
    ReplicaPool,
    TcpReplicaConnection,
)
from pytorch_distributed_rnn_tpu_torch.serving.fleet.router import (  # noqa: F401
    QOS_ADMIT_FRAC,
    QOS_CLASSES,
    RouterCore,
    RouterServer,
)
