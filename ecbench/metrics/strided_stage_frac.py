"""The share of the client bytes the EC pipeline staged that moved as
whole stripes, one strided copy a data shard, from the program's
``ec_staging`` set: ``strided_bytes`` / ``user_bytes``. Both are counted
in the same update, where the scatter or gather ends. A program without
the ``strided_bytes`` key reads nothing."""


def read(r):
    staged = r.counters.get("ec_staging")
    if not staged or not staged.get("user_bytes") or \
            "strided_bytes" not in staged:
        return None
    return staged["strided_bytes"] / staged["user_bytes"]
