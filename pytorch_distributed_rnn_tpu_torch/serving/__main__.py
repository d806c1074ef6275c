"""``python -m pytorch_distributed_rnn_tpu_torch.serving {serve,loadgen}
...``: the port's serving entry points (the drill spawns servers through
this form).  ``router`` is parsed and rejected until the fleet is
ported."""

from __future__ import annotations

import sys

from pytorch_distributed_rnn_tpu_torch.serving.cli import (
    NOT_PORTED_FLEET,
    loadgen_main,
    serve_main,
)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in ("serve", "loadgen", "router"):
        print(
            "usage: python -m pytorch_distributed_rnn_tpu_torch.serving "
            "{serve,loadgen} [options]",
            file=sys.stderr,
        )
        return 2
    if argv[0] == "router":
        raise SystemExit(f"router: {NOT_PORTED_FLEET}")
    if argv[0] == "serve":
        return serve_main(argv[1:])
    return loadgen_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
