"""The host CPU the EC pipeline spent building shard maps (the
``trace`` set's ``ec_stage.cpu_s``: the write's insert loop and
old-data merge, the sub-write ``get``s, a read's sub-read inserts and
``gather_ro_range``), in ms per op completed in the window."""


def read(r):
    trace = r.counters.get("trace")
    if not trace or "ec_stage.cpu_s" not in trace or not r.ops:
        return None
    return trace["ec_stage.cpu_s"] * 1e3 / len(r.ops)
