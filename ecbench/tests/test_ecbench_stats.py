"""Exact percentiles: nearest rank over every sample."""

import random

import pytest

from ecbench.stats import percentile


def test_nearest_rank():
    vals = list(range(1, 101))
    random.Random(0).shuffle(vals)
    assert percentile(vals, 50) == 50
    assert percentile(vals, 99) == 99
    assert percentile(vals, 100) == 100
    assert percentile([7.5], 99) == 7.5


def test_exact_not_bucketed():
    vals = [1.0] * 98 + [1.3, 1.9]
    assert percentile(vals, 99) == 1.3


def test_rejects_nothing_to_read():
    with pytest.raises(ValueError):
        percentile([], 50)
