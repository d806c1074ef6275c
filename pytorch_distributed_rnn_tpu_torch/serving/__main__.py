"""``python -m pytorch_distributed_rnn_tpu_torch.serving
{serve,loadgen,router} ...``: the port's serving entry points (the drills
spawn servers and the router through this form)."""

from __future__ import annotations

import sys

from pytorch_distributed_rnn_tpu_torch.serving.cli import loadgen_main, serve_main


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("serve", "loadgen", "router"):
        print(
            "usage: python -m pytorch_distributed_rnn_tpu_torch.serving "
            "{serve,loadgen,router} [options]",
            file=sys.stderr,
        )
        return 2
    if argv[0] == "serve":
        return serve_main(argv[1:])
    if argv[0] == "router":
        from pytorch_distributed_rnn_tpu_torch.serving.fleet.cli import router_main

        return router_main(argv[1:])
    return loadgen_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
