"""Host CPU inside the object stores (the ``trace`` set's ``cpu_s`` of
``store_commit``, ``MemStore.queue_transactions``, and ``store_read``,
``MemStore.read``), in ms per op completed in the window."""

_KEYS = ("store_commit.cpu_s", "store_read.cpu_s")


def read(r):
    trace = r.counters.get("trace")
    if not trace or _KEYS[0] not in trace or not r.ops:
        return None
    return sum(trace.get(k, 0.0) for k in _KEYS) * 1e3 / len(r.ops)
