"""Nearest-rank percentiles (a frozen copy of the port's
``runtime.scheduler.percentile``)."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    """The smallest sample whose empirical CDF reaches q/100
    (``sorted(values)[ceil(q/100 * n) - 1]``); None for no samples."""
    s = sorted(values)
    if not s:
        return None
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[min(k, len(s)) - 1])
