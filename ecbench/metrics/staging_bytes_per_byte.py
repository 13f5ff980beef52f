"""Bytes the EC pipeline's staging copied and zero-filled over the
client bytes it staged, from the program's ``ec_staging`` set:
(``copy_bytes`` + ``zero_bytes``, every ``ShardExtentMap.insert`` and
``.get``) / ``user_bytes`` (a write's payload as the RMW pipeline
scatters it, a read's as it is gathered). Both counts are taken where
the staging happens, so an op queued at the window's edge counts on
both sides or on neither."""


def read(r):
    staged = r.counters.get("ec_staging")
    if not staged or not staged.get("user_bytes"):
        return None
    return (staged["copy_bytes"] + staged["zero_bytes"]) / staged["user_bytes"]
