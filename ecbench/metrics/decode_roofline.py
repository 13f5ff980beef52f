"""Kernels A (``gf_apply_kernel``) and D (``xor_schedule_*_kernel``):
the bytes the window's decodes need over their summed device time, as a
share of the card's HBM bandwidth, in %. Which chunks a read had to
rebuild comes from the shards the killed OSDs held."""

from ecbench.metrics.bytes import decode_bytes
from ecbench.peaks import hbm_bytes_per_s


def _decoder(name: str) -> bool:
    return ("gf_apply_kernel" in name and "csum" not in name) \
        or "xor_schedule" in name


def read(r):
    peak = hbm_bytes_per_s(r.device_kind)
    if r.trace is None or peak is None:
        return None
    dev_s = r.trace.device_s(_decoder)
    need = 0
    for rec in r.ops:
        if rec.op.kind != "read" or rec.op.length < int(r.mix["object_bytes"]):
            continue
        lost = sum(1 for s in r.lost.get(rec.op.obj, ()) if s < r.k)
        need += decode_bytes(rec.op.length, r.k, lost)
    if dev_s <= 0 or not need:
        return None
    return 100.0 * need / peak / dev_s
