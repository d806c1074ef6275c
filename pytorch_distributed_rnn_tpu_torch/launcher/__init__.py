"""Process supervision for the port's multi-process runs: the serving
fleet's replica supervisor (:mod:`.supervisor`).  The JAX package's
benchmark harness and command synthesis (``launcher/bench.py``,
``commands.py``, ``__main__.py``) wait for ROADMAP.md A11."""

from pytorch_distributed_rnn_tpu_torch.launcher.supervisor import (
    ReplicaSupervisor,
    RespawnSupervisor,
    supervision_alert_hook,
)

__all__ = ["ReplicaSupervisor", "RespawnSupervisor", "supervision_alert_hook"]
