"""The percentile convention of the JAX package's ``obs/summary.py``,
shared by the serving engine's request statistics and the load
generator's SLO report."""

from __future__ import annotations

import math


def percentile(sorted_values: list[float], q: float) -> float:
    """Nearest-rank percentile over an ascending-sorted list (NaN when
    empty)."""
    if not sorted_values:
        return float("nan")
    idx = min(len(sorted_values) - 1, int(math.ceil(q * len(sorted_values))) - 1)
    return sorted_values[max(0, idx)]
