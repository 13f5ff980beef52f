"""Mean wait of an OSD's queued work, from ``_schedule`` to the moment
it starts on a worker: Σ ``op_queue.wait_s`` over Σ
``op_queue.dequeued`` of every ``osd.*.op_queue`` set, in ms."""


def read(r):
    sets = [v for name, v in r.counters.items()
            if name.startswith("osd.") and name.endswith(".op_queue")]
    started = sum(v.get("op_queue.dequeued", 0) for v in sets)
    if not started:
        return None
    return sum(v.get("op_queue.wait_s", 0.0) for v in sets) * 1e3 / started
