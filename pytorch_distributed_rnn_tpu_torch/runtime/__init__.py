"""The host-side TCP ring (``native.py`` over ``csrc/collectives.cpp``),
the transport of the ``distributed-native`` strategy."""

from pytorch_distributed_rnn_tpu_torch.runtime.native import (
    Communicator,
    build_native_library,
    init_from_env,
)

__all__ = ["Communicator", "build_native_library", "init_from_env"]
