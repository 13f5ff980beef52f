"""Host-to-device bytes over host-to-device memcpy device time, from
the profiler's memcpy records in the traced window (``utils/device.py``
staging)."""


def read(r):
    if r.trace is None:
        return None
    moved = secs = 0.0
    for e in r.trace.events:
        if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"] and e["bytes"]:
            moved += float(e["bytes"])
            secs += e["dur"] / 1e6
    if secs <= 0:
        return None
    return moved / secs / 1e9
