"""Median latency, issue to completion callback, of every op completed
in the window (nearest rank)."""

from ecbench.stats import percentile


def read(r):
    if not r.ops:
        return None
    return percentile([rec.t_done - rec.t_issue for rec in r.ops], 50) * 1e3
