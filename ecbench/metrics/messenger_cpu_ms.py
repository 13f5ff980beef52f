"""Host CPU of the messenger (the ``trace`` set's ``cpu_s`` of
``msg_encode``, ``msg_send`` and ``msg_decode``: frame encode, socket
send, frame body read and decode, every connection of the process),
in ms per op completed in the window."""

_KEYS = ("msg_encode.cpu_s", "msg_send.cpu_s", "msg_decode.cpu_s")


def read(r):
    trace = r.counters.get("trace")
    if not trace or _KEYS[0] not in trace or not r.ops:
        return None
    return sum(trace.get(k, 0.0) for k in _KEYS) * 1e3 / len(r.ops)
