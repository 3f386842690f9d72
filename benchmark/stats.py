"""The statistics the benchmark reports and the spreads its bounds come
from."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of values, interpolated linearly between
    the two nearest order statistics (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(window_s: float, count: int) -> float:
    """Seconds a solve over a window: the window over the solves in it."""
    if count <= 0:
        raise ValueError("no solve completed in the window")
    return window_s / count


def spread(values) -> float:
    """The distance between the first and third quartile
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
