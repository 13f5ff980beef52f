"""Log2-bucketed latency histogram — the HDR-histogram role.

The reference records op latencies into ``PerfCounters`` power-of-2
histograms (``l_osd_op_lat`` and friends) and teuthology's radosbench
wrapper reports percentile latencies per op class. Here one compact
structure serves both: log2 major buckets with linear sub-buckets
(HDR-style — constant relative error everywhere on the range), exact
min/max tracking, merge for per-worker aggregation, and interpolated
percentiles.

Values are SECONDS. The default range spans 1 us .. 128 s; anything
below clamps into the first bucket, anything above into the last
(and ``max`` still reports the true extreme).
"""

from __future__ import annotations

import math

#: linear sub-buckets per power of two: 16 gives <= 6.25% relative
#: quantile error, plenty under scheduler jitter
SUBS = 16
_LO = 1e-6        # 1 us: below any real op
_DECADES = 27     # 2**27 us ~= 134 s: above any sane op timeout


class Log2Histogram:
    """Fixed-size log2/linear histogram of seconds."""

    def __init__(self) -> None:
        self.counts = [0] * (_DECADES * SUBS)
        self.n = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def _index(self, v: float) -> int:
        if v <= _LO:
            return 0
        major = int(math.log2(v / _LO))
        if major >= _DECADES:
            return len(self.counts) - 1
        lo = _LO * (1 << major)
        sub = int((v - lo) / lo * SUBS)
        return min(major * SUBS + min(sub, SUBS - 1),
                   len(self.counts) - 1)

    def _bounds(self, idx: int) -> tuple[float, float]:
        major, sub = divmod(idx, SUBS)
        lo = _LO * (1 << major)
        return lo + sub * lo / SUBS, lo + (sub + 1) * lo / SUBS

    def record(self, seconds: float) -> None:
        self.counts[self._index(seconds)] += 1
        self.n += 1
        self.sum += seconds
        if seconds < self.min:
            self.min = seconds
        if seconds > self.max:
            self.max = seconds

    def merge(self, other: "Log2Histogram") -> None:
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def percentile(self, p: float) -> float:
        """Interpolated p-th percentile (0 < p <= 100) in seconds.
        The true min/max pin the extremes so a single-sample histogram
        answers exactly."""
        if self.n == 0:
            return 0.0
        rank = p / 100.0 * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo, hi = self._bounds(i)
                frac = (rank - seen) / c
                v = lo + (hi - lo) * frac
                return min(max(v, self.min), self.max)
            seen += c
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    def snapshot(self) -> dict:
        """JSON-able summary (ms, the human unit for op latency)."""
        if self.n == 0:
            return {"n": 0}
        return {
            "n": self.n,
            "mean_ms": round(self.mean * 1e3, 3),
            "p50_ms": round(self.percentile(50) * 1e3, 3),
            "p95_ms": round(self.percentile(95) * 1e3, 3),
            "p99_ms": round(self.percentile(99) * 1e3, 3),
            "max_ms": round(self.max * 1e3, 3),
        }

    def perf_buckets(self) -> tuple[list[float], list[int]]:
        """(bounds_seconds, counts) collapsed to whole powers of two —
        the shape ``PerfCountersBuilder.add_histogram`` wants (the
        full sub-bucket grid would bloat every perf dump)."""
        bounds = [_LO * (1 << d) for d in range(1, _DECADES)]
        coarse = [0] * _DECADES
        for i, c in enumerate(self.counts):
            coarse[i // SUBS] += c
        # counts layout for PerfCounters: one slot per bound + overflow
        return bounds, coarse
