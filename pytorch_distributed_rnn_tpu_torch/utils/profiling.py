"""Peak memory and wall clock around the training loop.

The counterpart of the JAX package's ``utils/profiling.py``: run a
callable while a thread samples peak RSS from ``/proc/self/status``, and
return ``(result, peak_rss_mb, seconds)``; on a CUDA device also the
device's peak allocated memory (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``).  The clock stops after a device
synchronize, so queued kernels count.
"""

from __future__ import annotations

import threading
import time

import torch


def _rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0  # kB -> MiB
    except OSError:
        pass
    return 0.0


def measure_memory_and_time(fn, device=None, interval: float = 0.1):
    """Run ``fn()``; return ``(result, peak_rss_mb, duration_seconds,
    device_peaks_mb)``, the last a ``{device: MiB}`` dict that is empty
    unless ``device`` is a CUDA device."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    on_cuda = device.type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    peak = [_rss_mb()]
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], _rss_mb())
            stop.wait(interval)

    sampler = threading.Thread(target=sample, daemon=True)
    start = time.perf_counter()
    sampler.start()
    try:
        result = fn()
        if on_cuda:
            torch.cuda.synchronize(device)
    finally:
        stop.set()
        sampler.join(timeout=2.0)
    duration = time.perf_counter() - start
    peak[0] = max(peak[0], _rss_mb())
    device_peaks = {}
    if on_cuda:
        device_peaks[str(device)] = torch.cuda.max_memory_allocated(device) / 2**20
    return result, peak[0], duration, device_peaks
