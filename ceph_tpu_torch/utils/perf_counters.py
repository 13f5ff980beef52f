"""Typed performance counters — the ``PerfCounters`` analog.

Mirrors common/perf_counters.{h,cc}: a builder declares typed metrics
(u64 counters, gauges, time totals, averages with count+sum, histogram
buckets), instances update them cheaply at runtime, and a process
collection serves ``perf dump``-style JSON through the admin socket
(common/admin_socket.cc) — the same schema shape the reference's
``ceph daemon ... perf dump`` emits: averages as {avgcount, sum},
histograms as bucket arrays.

Thread-safe via one lock per counter set (the reference uses atomics;
Python increments are cheap enough under a lock here).
"""

from __future__ import annotations

import bisect
import enum
import threading


class CounterType(enum.Enum):
    U64 = "u64"            # monotonically increasing counter
    GAUGE = "gauge"        # settable value
    TIME = "time"          # accumulated seconds
    AVG = "avg"            # count + sum (time or value averages)
    HISTOGRAM = "histogram"


class PerfCounters:
    """One subsystem's counter set; create via PerfCountersBuilder."""

    def __init__(self, name: str, schema: dict[str, dict]) -> None:
        self.name = name
        self._schema = schema
        self._lock = threading.Lock()
        self._values: dict[str, object] = {}
        #: histogram value totals (Prometheus histograms carry a
        #: ``_sum`` so rate(sum)/rate(count) gives a live mean)
        self._hist_sums: dict[str, float] = {}
        for key, spec in schema.items():
            if spec["type"] is CounterType.AVG:
                self._values[key] = [0, 0.0]  # avgcount, sum
            elif spec["type"] is CounterType.HISTOGRAM:
                self._values[key] = [0] * (len(spec["buckets"]) + 1)
                self._hist_sums[key] = 0.0
            else:
                self._values[key] = 0 if spec["type"] in (
                    CounterType.U64, CounterType.GAUGE
                ) else 0.0

    def _check(self, key: str, *types: CounterType) -> dict:
        spec = self._schema.get(key)
        if spec is None:
            raise KeyError(f"{self.name}: no counter {key!r}")
        if types and spec["type"] not in types:
            raise TypeError(
                f"{self.name}.{key} is {spec['type'].value}, not "
                f"{'/'.join(t.value for t in types)}"
            )
        return spec

    def inc(self, key: str, by: int = 1) -> None:
        self._check(key, CounterType.U64)
        with self._lock:
            self._values[key] += by

    def set(self, key: str, value) -> None:
        self._check(key, CounterType.GAUGE)
        with self._lock:
            self._values[key] = value

    def tinc(self, key: str, seconds: float) -> None:
        self._check(key, CounterType.TIME)
        with self._lock:
            self._values[key] += seconds

    def add_many(self, deltas) -> None:
        """Add each ``(key, delta)`` to its U64 counter or TIME total
        under ONE lock acquisition: the hot paths (a span's close, a
        staging copy) update several keys at once. Keys are the
        caller's fixed set, so no per-key type check runs here."""
        values = self._values
        with self._lock:
            for key, delta in deltas:
                values[key] += delta

    def ainc(self, key: str, value: float) -> None:
        """Add one sample to an average (count += 1, sum += value)."""
        self._check(key, CounterType.AVG)
        with self._lock:
            pair = self._values[key]
            pair[0] += 1
            pair[1] += value

    def hinc(self, key: str, value: float) -> None:
        spec = self._check(key, CounterType.HISTOGRAM)
        with self._lock:
            self._values[key][bisect.bisect_right(spec["buckets"], value)] += 1
            self._hist_sums[key] += value

    def get(self, key: str):
        with self._lock:
            v = self._values[key]
            return list(v) if isinstance(v, list) else v

    def reset(self) -> None:
        """Zero every counter, gauge, time accumulator, average pair
        and histogram bucket (the ``perf reset`` admin command): bench
        A/B legs and soak iterations start from clean counters instead
        of differencing against a snapshot."""
        with self._lock:
            for key, spec in self._schema.items():
                if spec["type"] is CounterType.AVG:
                    self._values[key] = [0, 0.0]
                elif spec["type"] is CounterType.HISTOGRAM:
                    self._values[key] = [0] * (len(spec["buckets"]) + 1)
                    self._hist_sums[key] = 0.0
                elif spec["type"] in (CounterType.U64, CounterType.GAUGE):
                    self._values[key] = 0
                else:
                    self._values[key] = 0.0

    def dump(self) -> dict:
        out: dict[str, object] = {}
        with self._lock:
            for key, spec in self._schema.items():
                v = self._values[key]
                if spec["type"] is CounterType.AVG:
                    out[key] = {"avgcount": v[0], "sum": v[1]}
                elif spec["type"] is CounterType.HISTOGRAM:
                    out[key] = {
                        "buckets": list(spec["buckets"]),
                        "counts": list(v),
                        "sum": self._hist_sums[key],
                    }
                else:
                    out[key] = v
        return out


class PerfCountersBuilder:
    """Declare a counter set, then ``create_perf_counters()``
    (PerfCountersBuilder, common/perf_counters.h)."""

    def __init__(self, collection: "PerfCountersCollection", name: str) -> None:
        self._collection = collection
        self._name = name
        self._schema: dict[str, dict] = {}

    def _add(self, key: str, type: CounterType, desc: str, **extra):
        if key in self._schema:
            raise ValueError(f"duplicate counter {key!r}")
        self._schema[key] = {"type": type, "desc": desc, **extra}
        return self

    def add_u64_counter(self, key: str, desc: str = ""):
        return self._add(key, CounterType.U64, desc)

    def add_u64_gauge(self, key: str, desc: str = ""):
        return self._add(key, CounterType.GAUGE, desc)

    def add_time(self, key: str, desc: str = ""):
        return self._add(key, CounterType.TIME, desc)

    def add_avg(self, key: str, desc: str = ""):
        return self._add(key, CounterType.AVG, desc)

    def add_histogram(self, key: str, buckets: list[float], desc: str = ""):
        if sorted(buckets) != list(buckets):
            raise ValueError("histogram buckets must be sorted")
        return self._add(key, CounterType.HISTOGRAM, desc, buckets=buckets)

    def create_perf_counters(self) -> PerfCounters:
        pc = PerfCounters(self._name, dict(self._schema))
        self._collection.register(pc)
        return pc


class PerfCountersCollection:
    """All counter sets in the process (PerfCountersCollectionImpl)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sets: dict[str, PerfCounters] = {}

    def register(self, pc: PerfCounters) -> None:
        with self._lock:
            # Same-name re-registration replaces (a rebuilt pipeline
            # supersedes its predecessor's counters).
            self._sets[pc.name] = pc

    def deregister(self, name: str) -> None:
        with self._lock:
            self._sets.pop(name, None)

    def reset(self, name: str | None = None) -> int:
        """Zero one named set, or every registered set (``perf
        reset`` over the admin socket). Returns how many sets were
        reset; an unknown name raises KeyError like the other admin
        lookups."""
        with self._lock:
            if name is None:
                targets = list(self._sets.values())
            else:
                pc = self._sets.get(name)
                if pc is None:
                    raise KeyError(f"no counter set {name!r}")
                targets = [pc]
        for pc in targets:
            pc.reset()
        return len(targets)

    def dump(self) -> dict:
        with self._lock:
            return {name: pc.dump() for name, pc in sorted(self._sets.items())}

    def snapshot(self) -> dict[str, tuple[dict, dict]]:
        """name -> (schema, dumped values), sorted — the exporter
        surface (schema carries each counter's type and histogram
        bucket bounds)."""
        with self._lock:
            sets = sorted(self._sets.items())
        return {name: (dict(pc._schema), pc.dump()) for name, pc in sets}


# Process-global collection, served by the admin socket's "perf dump".
perf_collection = PerfCountersCollection()
