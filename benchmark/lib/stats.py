"""Percentiles and spreads as the benchmark states them."""

from __future__ import annotations

import math
import statistics


def percentile(values, q):
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    with at least q% of the values at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("percentile of no values")
    return ordered[max(math.ceil(q / 100 * len(ordered)), 1) - 1]


def median(values):
    return statistics.median(values)


def spread(values):
    """Interquartile range over the median, by statistics.quantiles."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
