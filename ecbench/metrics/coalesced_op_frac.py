"""The window's delta of the OSDs' ``osd.N.coalesce.op_coalesced`` (client
ops executed in a multi-op batch) over the client ops completed in the
window."""


def read(r):
    if not r.ops:
        return None
    return r.counter_sum("osd.", ".coalesce", "op_coalesced") / len(r.ops)
