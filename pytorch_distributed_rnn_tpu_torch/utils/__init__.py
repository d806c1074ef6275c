"""Device policy and measurement helpers."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` (the default of every
    entry point) or ``"cpu"``, never silently the other one.  On CUDA the
    float32 path stays full float32: TF32 is turned off for matmuls and
    cuDNN alike."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; pass --device cpu "
                "to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use cuda or cpu")
    return device
