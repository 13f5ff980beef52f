"""Host wall time inside the codec calls (the ``trace`` set's
``ec_encode.self_s`` + ``ec_decode.self_s``: ``ShardExtentMap.encode``
and ``encode_parity_delta``, ``decode`` in ``reconstruct_shards``), in
ms per op completed in the window. Wall, not CPU: the call blocks on
pageable copies and the kernel."""


def read(r):
    trace = r.counters.get("trace")
    if not trace or "ec_encode.self_s" not in trace or not r.ops:
        return None
    secs = trace["ec_encode.self_s"] + trace.get("ec_decode.self_s", 0.0)
    return secs * 1e3 / len(r.ops)
