"""User bytes of every op completed in the window (written and
acknowledged, or read and returned) over the window's seconds;
1 GB = 10^9 bytes."""


def read(r):
    if not r.ops or r.window_s <= 0:
        return None
    return sum(rec.op.length for rec in r.ops) / r.window_s / 1e9
