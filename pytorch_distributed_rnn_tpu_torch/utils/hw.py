"""Peak-FLOPs table for the efficiency ledger's MFU denominators.

The port's own table (the JAX package's ``utils/hw.py`` lists TPUs
only).  The ledger (``obs/ledger.py``) divides the analytic model FLOPs
of a train step (``obs/flops.py``) by the claimed peak of the card for
the dtype the run computes in:

- ``h100``: NVIDIA's data sheet for the H100 SXM, dense rates without
  sparsity at the full 700 W: 67 TFLOP/s in float32 outside the tensor
  cores (``--precision f32``), 989 TFLOP/s in bf16 on the tensor cores
  (``--precision bf16``).  A card run below 700 W (``nvidia-smi``'s
  ``power.limit``) reaches less; the ledger states the peak as claimed.
- Any other device falls back to an order-of-magnitude CPU estimate (a
  few AVX2 cores at f32), flagged ``estimated=True`` and labelled as
  such wherever it is printed: a relative signal between runs on one
  host, never an absolute utilization.

``peak_flops()`` never raises: unknown hardware takes the CPU estimate,
so the ledger is always filled (with the label).
"""

from __future__ import annotations

from typing import Optional

# peak FLOP/s a device by compute dtype; keys are lowercase substrings of
# the device name (torch.cuda.get_device_name)
PEAK_FLOPS_TABLE: dict[str, dict[str, float]] = {
    "h100": {"f32": 67e12, "bf16": 989e12},
}

# ~8 cores x ~3 GHz x 2 FMA ports x 8 f32 lanes, labelled as an estimate
CPU_PEAK_FLOPS_ESTIMATE = 4e11


def peak_flops(backend: Optional[str] = None, device_kind: Optional[str] = None,
               dtype: str = "f32") -> dict:
    """Claimed peak FLOP/s of one device of ``device_kind`` computing in
    ``dtype`` (``"f32"`` or ``"bf16"``): ``{"peak_flops_per_device",
    "device", "estimated"}``, ``estimated`` True where the number is not
    the data sheet's."""
    kind = (device_kind or "").lower()
    for key, peaks in PEAK_FLOPS_TABLE.items():
        if key in kind and dtype in peaks:
            return {"peak_flops_per_device": peaks[dtype], "device": device_kind,
                    "estimated": False}
    return {"peak_flops_per_device": CPU_PEAK_FLOPS_ESTIMATE,
            "device": device_kind or backend or "cpu", "estimated": True}


def local_peak_flops(device=None, dtype: str = "f32") -> dict:
    """:func:`peak_flops` for ``device`` (a ``torch.device`` or its
    string; None: the card where there is one, else the CPU), with the
    total over the process's devices of that kind (one: a process drives
    one card).  Adds ``device_count``, ``peak_flops_total`` and
    ``backend`` (``"gpu"`` or ``"cpu"``)."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    backend, device_kind = "cpu", None
    if device.type == "cuda":
        backend = "gpu"
        device_kind = torch.cuda.get_device_name(device)
    info = peak_flops(backend, device_kind, dtype)
    info["device_count"] = 1
    info["peak_flops_total"] = info["peak_flops_per_device"]
    info["backend"] = backend
    return info
