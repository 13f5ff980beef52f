"""Exact order statistics over every sample (no histogram buckets)."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest sample with at
    least q % of the samples at or below it."""
    if not values:
        raise ValueError("no samples")
    if not 0 < q <= 100:
        raise ValueError(f"q={q} outside (0, 100]")
    ordered = sorted(values)
    return ordered[max(math.ceil(q / 100.0 * len(ordered)), 1) - 1]

