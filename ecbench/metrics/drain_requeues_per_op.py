"""Sub-op replies the OSDs' drain loops put back because another
thread held the callback lock, each followed by a 1 ms sleep (Σ
``drain.requeues`` of every ``osd.*.net`` set), per op completed in
the window."""


def read(r):
    sets = [v for name, v in r.counters.items()
            if name.startswith("osd.") and name.endswith(".net")
            and "drain.requeues" in v]
    if not sets or not r.ops:
        return None
    return sum(v["drain.requeues"] for v in sets) / len(r.ops)
