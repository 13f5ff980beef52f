"""Read pipeline, the reconstruct half — the ``ECCommon::ReadPipeline``
planning and reconstruction analog.

Behavioral mirror of the reference's degraded-read path
(osd/ECCommon.cc: ``get_min_avail_to_read_shards`` :198, reconstruction
in ``complete_read_op`` :90):

1. Plan: if every wanted shard is available, read exactly the wanted
   extents (fast path, no decode). Otherwise apply the codec's
   ``minimum_to_decode`` (with sub-chunk selectors — the CLAY fractional
   repair plan rides the same ``shard_read_t`` seam, ECCommon.h:83-133)
   over the chunk-aligned window.
2. Reconstruct the wanted shards from the survivors' bytes: CLAY
   fractional repair when the plan carried sub-chunk selectors and
   exactly one shard is lost, windowed decode otherwise. This is also
   how shard recovery reaches ``codec.repair``.

The reconstruction is one batched codec call over the whole window. The
repair's helper bytes go to the codec's device as tensors, so on the
card a fractional repair runs on the repair kernels.

Not ported yet: ``ReadPipeline`` and ``ClientReadOp`` (sub-read
fan-out, EIO retry from the remaining survivors, in-order client
completion) need rmw's ``ShardBackend`` and an object store, ROADMAP.md
queue 1 items 7 and 8.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ceph_tpu_torch.utils.device import to_numpy, to_tensor

from .extents import ExtentSet
from .shard_map import ShardExtentMap
from .stripe import StripeInfo


class ShardReadError(Exception):
    """A shard store failed a sub-read. ``kind`` distinguishes an IO
    error ("eio") from an absent object ("missing", the ENOENT analog
    of ECInject read type 1) — both retry identically."""

    def __init__(self, shard: int, oid: str = "", kind: str = "eio") -> None:
        super().__init__(f"shard {shard} {kind} on {oid!r}")
        self.shard = shard
        self.kind = kind


@dataclass
class ShardRead:
    """One shard's sub-read: extents plus optional sub-chunk selectors
    (the ``shard_read_t`` analog, ECCommon.h:83-133)."""

    shard: int
    extents: ExtentSet
    subchunks: list[tuple[int, int]] | None = None  # (index, count) runs


def subchunk_byte_extents(
    window: ExtentSet,
    chunk_size: int,
    sub_chunk_count: int,
    subchunks: list[tuple[int, int]],
) -> ExtentSet:
    """Restrict chunk-granular extents to selected sub-chunk byte ranges.

    Each chunk_size-aligned chunk inside ``window`` contributes only the
    (index, count) sub-chunk runs — how ECSubRead's subchunk selectors
    shrink the wire/disk IO for CLAY repair.
    """
    sub = chunk_size // sub_chunk_count
    out = ExtentSet()
    for start, end in window:
        c = (start // chunk_size) * chunk_size
        while c < end:
            for index, count in subchunks:
                lo = max(c + index * sub, start)
                hi = min(c + (index + count) * sub, end)
                if lo < hi:
                    out.insert(lo, hi - lo)
            c += chunk_size
    return out


def get_min_avail_to_read_shards(
    sinfo: StripeInfo,
    codec,
    want: dict[int, ExtentSet],
    avail: set[int],
    costs: dict[int, int] | None = None,
) -> tuple[dict[int, ShardRead], bool]:
    """Choose the shard sub-reads satisfying ``want`` given ``avail``
    (ECCommon.cc:198). Returns (shard_reads, need_decode).

    Fast path: all wanted shards available — read them directly. Slow
    path: available wanted shards still read their own extents, and
    ``minimum_to_decode`` over the MISSING wanted shards picks the
    decode survivors (cost-aware when per-shard ``costs`` are
    supplied); every survivor reads the chunk-aligned window covering
    the wanted extents, narrowed to sub-chunk ranges when the plan
    selects them (the CLAY single-shard repair plan).
    """
    if set(want) <= avail:
        return (
            {s: ShardRead(s, es.copy()) for s, es in want.items() if es},
            False,
        )

    missing = {s for s in want if s not in avail}
    want_raw = {sinfo.get_raw_shard(s) for s in missing}
    avail_raw = {sinfo.get_raw_shard(s) for s in avail}
    if costs is not None:
        chosen = codec.minimum_to_decode_with_cost(
            want_raw, {sinfo.get_raw_shard(s): c for s, c in costs.items()}
        )
        # Re-plan over the cost-chosen survivors so sub-chunk
        # selectors survive cost awareness: a CLAY single-shard
        # repair restricted to the chosen helpers still reads only
        # its repair planes.
        try:
            plan = codec.minimum_to_decode(want_raw, set(chosen))
        except ValueError:
            plan = {
                raw: [(0, codec.get_sub_chunk_count())]
                for raw in chosen
            }
    else:
        plan = codec.minimum_to_decode(want_raw, avail_raw)

    # Chunk-aligned hull of everything wanted, in shard-offset space.
    cs = sinfo.chunk_size
    hull = sinfo.chunk_aligned_hull(want.values())
    if hull is None:
        return {}, False
    window = ExtentSet([hull])

    sub_count = codec.get_sub_chunk_count()
    reads: dict[int, ShardRead] = {}
    for raw, subchunks in plan.items():
        shard = sinfo.get_shard(raw)
        full = [(0, sub_count)]
        if sub_count > 1 and subchunks and list(subchunks) != full:
            extents = subchunk_byte_extents(window, cs, sub_count, subchunks)
            reads[shard] = ShardRead(shard, extents, list(subchunks))
        else:
            reads[shard] = ShardRead(shard, window.copy())
    # Available wanted shards read their own extents on top of any
    # helper role (the client still needs their bytes verbatim).
    for s, es in want.items():
        if s not in avail or not es:
            continue
        if s in reads:
            reads[s].extents.union(es)
        else:
            reads[s] = ShardRead(s, es.copy())
    return reads, True


def gather_ro_range(
    sinfo: StripeInfo, smap: ShardExtentMap, ro_offset: int, length: int
) -> bytes:
    """Assemble the rados byte range from per-shard buffers (the inverse
    of the write path's shard scatter; absent bytes read as zero)."""
    out = np.zeros(length, dtype=np.uint8)
    pos, taken = ro_offset, 0
    while taken < length:
        chunk_index = pos // sinfo.chunk_size
        raw = chunk_index % sinfo.k
        in_chunk = pos % sinfo.chunk_size
        take = min(sinfo.chunk_size - in_chunk, length - taken)
        shard_off = (chunk_index // sinfo.k) * sinfo.chunk_size + in_chunk
        out[taken : taken + take] = smap.get(
            sinfo.get_shard(raw), shard_off, take
        )
        pos += take
        taken += take
    return out.tobytes()


def reconstruct_shards(
    sinfo: StripeInfo,
    codec,
    result: ShardExtentMap,
    want: dict[int, ExtentSet],
    shard_reads: dict[int, ShardRead],
    object_size: int,
    error_shards: frozenset[int] | set[int] = frozenset(),
) -> None:
    """Fill wanted-but-unread shards of ``result`` from its survivors.

    Shared by the client read path and shard recovery: CLAY fractional
    repair when the plan carried sub-chunk selectors and exactly one
    shard is lost, plain windowed decode otherwise.
    """
    lost = set()
    for s, es in want.items():
        got = result.get_extent_set(s)
        if any(not got.contains(a, b - a) for a, b in es):
            lost.add(s)
    if not lost:
        return
    fractional = any(sr.subchunks is not None for sr in shard_reads.values())
    if fractional and len(lost) == 1 and hasattr(codec, "repair"):
        _repair_fractional(
            sinfo, codec, result, want, shard_reads, object_size,
            error_shards, lost,
        )
        return
    result.decode(codec, lost, object_size)


def _repair_fractional(
    sinfo: StripeInfo,
    codec,
    result: ShardExtentMap,
    want: dict[int, ExtentSet],
    shard_reads: dict[int, ShardRead],
    object_size: int,
    error_shards,
    lost: set[int],
) -> None:
    """CLAY fractional repair: per chunk in the window, feed each
    helper's concatenated repair sub-chunks to ``codec.repair``, as
    [n_chunks, helper bytes] tensors on the codec's device. Each helper's
    window is read once and its repair planes gathered with one index,
    not one ``get`` per sub-chunk run."""
    cs = sinfo.chunk_size
    want_raw = {sinfo.get_raw_shard(s) for s in lost}
    helpers = {
        s: sr for s, sr in shard_reads.items()
        if s not in error_shards and s not in lost
        and sr.subchunks is not None
    }
    # Window = chunk hull of the wanted extents.
    lo, hi = sinfo.chunk_aligned_hull(want.values())
    n_chunks = (hi - lo) // cs
    sub_count = codec.get_sub_chunk_count()
    chunks_in = {}
    for shard, sr in helpers.items():
        planes = np.array([
            z for index, count in (sr.subchunks or [(0, sub_count)])
            for z in range(index, index + count)
        ], dtype=np.int64)
        window = result.get(shard, lo, hi - lo).reshape(
            n_chunks, sub_count, cs // sub_count)
        chunks_in[sinfo.get_raw_shard(shard)] = to_tensor(
            np.ascontiguousarray(window[:, planes].reshape(n_chunks, -1)),
            codec.device,
        )
    out = codec.repair(want_raw, chunks_in)
    for raw in want_raw:
        shard = sinfo.get_shard(raw)
        buf = to_numpy(out[raw]).reshape(n_chunks * cs)
        shard_size = sinfo.object_size_to_shard_size(object_size, shard)
        end = min(hi, shard_size)
        if end > lo:
            result.insert(shard, lo, buf[: end - lo])
