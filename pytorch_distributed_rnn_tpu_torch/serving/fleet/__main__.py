"""``python -m pytorch_distributed_rnn_tpu_torch.serving.fleet ...`` - the
same router as ``python -m pytorch_distributed_rnn_tpu_torch.serving
router`` (the drill spawns the router through this form)."""

from __future__ import annotations

import sys

from pytorch_distributed_rnn_tpu_torch.serving.fleet.cli import router_main

if __name__ == "__main__":
    sys.exit(router_main())
