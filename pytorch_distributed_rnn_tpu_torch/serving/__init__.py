"""Continuous-batching inference serving, the counterpart of the JAX
package's ``serving/``.

Load a port checkpoint (``training/checkpoint.py``), accept generation
requests over a JSON-lines TCP protocol, and decode them in continuously
batched steps: new requests join the in-flight batch at step boundaries,
finished sequences leave, and freed slots refill without restarting
decode.  Padded bucket shapes (batch slots + prompt-length buckets) let
the engine capture its prefill and decode programs as CUDA graphs once,
at warm-up, and only replay them while serving.

Layering (each importable without the ones above it):

- :mod:`.buckets`   - prompt-length bucket policy (pure, no torch)
- :mod:`.scheduler` - the continuous-batching core (pure): admission,
  shedding, FIFO slot assignment at step boundaries
- :mod:`.adapters`  - per-family prefill / decode-step functions built
  from the functions the models' ``generate`` uses
- :mod:`.engine`    - device buffers, CUDA-graph programs, sampling,
  telemetry and chaos
- :mod:`.server`    - the TCP JSON-lines server (``serve``)
- :mod:`.loadgen`   - Poisson load generator + SLO report (``loadgen``),
  the chaos SLO drill via ``--spawn-server`` (:mod:`.drill`)
- :mod:`.fleet`     - the router over N replicas, its pool and the
  kill-mid-burst drill (``router``, ``loadgen --spawn-fleet``)
"""

from pytorch_distributed_rnn_tpu_torch.serving.buckets import BucketSpec
from pytorch_distributed_rnn_tpu_torch.serving.scheduler import ContinuousBatcher, ServeRequest

__all__ = ["BucketSpec", "ContinuousBatcher", "ServeRequest"]
