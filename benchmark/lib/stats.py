"""Percentile, rate and arrival arithmetic of the benchmark."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank ``p``-th percentile (0 < p <= 100): the smallest
    value with at least p % of the sample at or below it."""
    if not values:
        raise ValueError("percentile of an empty sample")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(p / 100.0 * len(ordered))) - 1]


def rate(count: float, seconds: float) -> float:
    """Work done per second over a window."""
    if seconds <= 0:
        raise ValueError("a window of no length")
    return count / seconds


def exponential_gaps(n: int, rate_per_s: float, order) -> list:
    """``n`` gaps of a Poisson process at ``rate_per_s``: the quantiles of
    the exponential distribution at (i + 1/2) / n, in the order of the
    permutation ``order``. Every seed gets the same set of gaps, and so the
    same number of requests and the same total span, in another order."""
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate_per_s for i in range(n)]
    return [gaps[i] for i in order]
