"""Kernel B (``csrc/gf_apply.cu``, ``gf_apply_csum_kernel``, the fused
encode+csum): the bytes the window's encodes need over B's summed
device time, as a share of the card's HBM bandwidth, in %. The encodes
are counted from the write_full ops completed in the window."""

from ecbench.metrics.bytes import encode_bytes
from ecbench.peaks import hbm_bytes_per_s


def read(r):
    peak = hbm_bytes_per_s(r.device_kind)
    if r.trace is None or peak is None:
        return None
    dev_s = r.trace.device_s(lambda n: "gf_apply_csum_kernel" in n)
    need = sum(encode_bytes(rec.op.length, r.k, r.m) for rec in r.ops
               if rec.op.kind == "write_full")
    if dev_s <= 0 or not need:
        return None
    return 100.0 * need / peak / dev_s
