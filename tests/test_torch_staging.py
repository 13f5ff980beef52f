"""The EC pipeline's stripe layout transform (``pipeline/read.py``'s
``scatter_ro_range`` and ``gather_ro_range``) against the per-chunk
loops it replaced, kept here as the reference: the same shard maps,
run for run and byte for byte, and the same read buffers, for aligned
and unaligned ranges with and without whole stripes, k of 2, 4 and 8, a
remapped shard order, a hole inside the gathered range and a map that
already holds runs the scatter overwrites or touches.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from ceph_tpu_torch.pipeline.read import gather_ro_range, scatter_ro_range  # noqa: E402
from ceph_tpu_torch.pipeline.shard_map import ShardExtentMap  # noqa: E402
from ceph_tpu_torch.pipeline.stripe import StripeInfo  # noqa: E402

CS = 4096
MiB = 1 << 20


def _pieces(sinfo, ro_offset, length):
    pos, taken = ro_offset, 0
    while taken < length:
        chunk_index = pos // sinfo.chunk_size
        raw = chunk_index % sinfo.k
        in_chunk = pos % sinfo.chunk_size
        take = min(sinfo.chunk_size - in_chunk, length - taken)
        shard_off = (chunk_index // sinfo.k) * sinfo.chunk_size + in_chunk
        yield sinfo.get_shard(raw), shard_off, taken, take
        pos += take
        taken += take


def ref_scatter(sinfo, smap, ro_offset, data):
    """The RMW pipeline's loop before the strided scatter: one insert a
    chunk piece."""
    arr = np.frombuffer(data, dtype=np.uint8)
    for shard, shard_off, at, take in _pieces(sinfo, ro_offset, arr.size):
        smap.insert(shard, shard_off, arr[at : at + take])


def ref_gather(sinfo, smap, ro_offset, length):
    """The read pipeline's loop before the strided gather: one get a
    chunk piece."""
    out = np.zeros(length, dtype=np.uint8)
    for shard, shard_off, at, take in _pieces(sinfo, ro_offset, length):
        out[at : at + take] = smap.get(shard, shard_off, take)
    return out.tobytes()


def _runs(smap):
    return {s: [(off, buf.tobytes()) for off, buf in smap._bufs[s]]
            for s in smap.shards()}


GEOMETRIES = {
    "k2": (2, 1, None),
    "k4": (4, 2, None),
    "k8": (8, 4, None),
    "k4-remapped": (4, 2, [2, 0, 5, 1, 3, 4]),
}


def _cases():
    out = []
    for geo, (k, _m, _map) in GEOMETRIES.items():
        sw = k * CS
        for off_name, off in (("aligned0", 0), ("aligned1", sw),
                              ("in_chunk", 100), ("next_chunk", CS + 7)):
            for len_name, n in (("1B", 1), ("chunk", CS),
                                ("stripe+1", sw + 1), ("4MiB", 4 * MiB)):
                out.append((geo, off_name, off, len_name, n, "plain"))
        # a hole inside the gathered range; runs already in the map
        out.append((geo, "in_chunk", 100, "3stripes", 3 * sw, "hole"))
        out.append((geo, "aligned0", 0, "3stripes", 3 * sw, "hole"))
        out.append((geo, "in_chunk", 100, "3stripes", 3 * sw, "prior"))
        out.append((geo, "aligned1", sw, "2stripes", 2 * sw, "prior"))
    return out


@pytest.mark.parametrize(
    "case", _cases(), ids=lambda c: f"{c[0]}-{c[1]}-{c[3]}-{c[5]}")
def test_staging_matches_the_per_chunk_loops(case):
    geo, _off_name, ro_offset, _len_name, length, variant = case
    k, m, mapping = GEOMETRIES[geo]
    sinfo = StripeInfo(k, m, k * CS, mapping)
    rng = np.random.default_rng(length * 31 + ro_offset)
    data = rng.integers(0, 256, length, dtype=np.uint8).tobytes()

    ref, new = ShardExtentMap(sinfo), ShardExtentMap(sinfo)
    if variant == "prior":
        # old bytes that the write overwrites, touches at either end,
        # or leaves alone past a gap
        for shard in range(k + m):
            for off, n in ((0, CS // 2), (CS * 2 + 5, CS * 3),
                           (CS * 8, 17)):
                old = rng.integers(0, 256, n, dtype=np.uint8)
                ref.insert(shard, off, old)
                new.insert(shard, off, old)
    ref_scatter(sinfo, ref, ro_offset, data)
    scatter_ro_range(sinfo, new, ro_offset, data)
    assert _runs(new) == _runs(ref)

    want = np.frombuffer(data, dtype=np.uint8).copy()
    if variant == "hole":
        # cut 100 bytes out of the middle stripe of raw shard 1: they
        # read as zero
        shard = sinfo.get_shard(1)
        hole = sinfo.ro_offset_to_shard_offset(ro_offset, 1) + CS + 10
        for smap in (ref, new):
            smap.erase(shard, hole, 100)
        for s, off, at, take in _pieces(sinfo, ro_offset, length):
            if s == shard:
                lo, hi = max(off, hole), min(off + take, hole + 100)
                if lo < hi:
                    want[at + lo - off : at + hi - off] = 0
        assert want.tobytes() != data
    # the whole range, and a window inside it that is unaligned at both
    # ends
    windows = [(ro_offset, length)]
    if length > 2:
        windows.append((ro_offset + 1, length - 2))
    for off, n in windows:
        got = gather_ro_range(sinfo, new, off, n)
        assert got == ref_gather(sinfo, ref, off, n)
        if variant != "prior":
            at = off - ro_offset
            assert got == want[at : at + n].tobytes()
