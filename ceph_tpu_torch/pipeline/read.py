"""Read pipeline — the ``ECCommon::ReadPipeline`` analog.

Behavioral mirror of the reference's degraded-read path
(osd/ECCommon.cc: ``get_min_avail_to_read_shards`` :198, ``do_read_op``
:387, ``get_remaining_shards`` retry :312, ``complete_read_op`` :90;
client entry osd/ECBackend.cc ``objects_read_and_reconstruct`` :1725):

1. Plan: if every wanted shard is available, read exactly the wanted
   extents (fast path, no decode). Otherwise apply the codec's
   ``minimum_to_decode`` (with sub-chunk selectors — the CLAY fractional
   repair plan rides the same ``shard_read_t`` seam, ECCommon.h:83-133)
   over the chunk-aligned window.
2. Dispatch per-shard sub-reads (the ECSubRead fan-out seam).
3. On a shard EIO, retry from the remaining survivors: re-plan with the
   failed shard excluded and issue only the still-missing reads
   (``get_remaining_shards``); if no plan exists, the client gets EIO.
4. Reconstruct the wanted shards from the survivors' bytes: CLAY
   fractional repair when the plan carried sub-chunk selectors and
   exactly one shard is lost, windowed decode otherwise. This is also
   how shard recovery reaches ``codec.repair``.
5. Client reads complete strictly in submission order regardless of
   backend completion order (``in_progress_client_reads``,
   ECBackend.h:131-148).

The reconstruction is one batched codec call over the whole window. The
repair's helper bytes go to the codec's device as tensors, so on the
card a fractional repair runs on the repair kernels.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np

from ceph_tpu_torch.utils import tracer
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
    with tracer.timer("ec_stage"), smap.tally(length):
        return _gather(sinfo, smap, ro_offset, length)


def _gather(sinfo, smap, ro_offset: int, length: int) -> bytes:
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
    with tracer.timer("ec_decode"):
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


class ClientReadOp:
    """One in-flight client read (ECCommon::ClientAsyncReadStatus +
    read_request_t rolled together)."""

    def __init__(
        self,
        rid: int,
        oid: str,
        ro_offset: int,
        length: int,
        on_complete: Callable[["ClientReadOp"], None] | None,
    ) -> None:
        self.rid = rid
        self.oid = oid
        self.ro_offset = ro_offset
        self.length = length
        self.on_complete = on_complete
        self.want: dict[int, ExtentSet] = {}
        self.shard_reads: dict[int, ShardRead] = {}
        self.need_decode = False
        self.result: ShardExtentMap | None = None
        self.error_shards: set[int] = set()
        # shard -> outstanding sub-read count (a retry can widen a
        # shard's window while its first sub-read is still in flight).
        self.pending: dict[int, int] = {}
        self.done = False
        self.data: bytes | None = None
        self.error: Exception | None = None
        self.t_submit: float | None = None


class ReadPipeline:
    """plan → sub-reads → (decode) → in-order client completion."""

    def __init__(
        self,
        sinfo: StripeInfo,
        codec,
        backend,
        size_fn: Callable[[str], int],
        perf_name: str = "ec_read",
    ) -> None:
        self.sinfo = sinfo
        self.codec = codec
        self.backend = backend
        self.size_fn = size_fn
        self._next_rid = 1
        self._inflight: "OrderedDict[int, ClientReadOp]" = OrderedDict()
        from ceph_tpu_torch.utils import PerfCountersBuilder, perf_collection

        # The io_counters read_cnt/read_bytes analog (ECBackend.cc:
        # 1797-1823) plus reconstruct/retry visibility.
        self.perf = (
            PerfCountersBuilder(perf_collection, perf_name)
            .add_u64_counter("read_ops", "client reads submitted")
            .add_u64_counter("read_bytes", "client bytes returned")
            .add_u64_counter("reconstruct_ops", "reads that decoded")
            .add_u64_counter(
                "helper_read_bytes",
                "bytes requested from shard stores by sub-reads (the "
                "MSR observable: CLAY fractional repair keeps this "
                "below the k-full-chunk bytes a naive decode reads)",
            )
            .add_u64_counter("retries", "sub-read retries after errors")
            .add_u64_counter("errors", "reads failed after retry")
            .add_avg("read_lat", "submit-to-complete seconds")
            .create_perf_counters()
        )

    # -- client entry (objects_read_and_reconstruct analog) ------------
    def submit(
        self,
        oid: str,
        ro_offset: int,
        length: int,
        on_complete: Callable[[ClientReadOp], None] | None = None,
    ) -> int:
        op = ClientReadOp(self._next_rid, oid, ro_offset, length, on_complete)
        op.t_submit = time.perf_counter()
        self._next_rid += 1
        self._inflight[op.rid] = op
        self.perf.inc("read_ops")

        # Reads past EOF are trimmed (objects_read_sync semantics).
        size = self.size_fn(oid)
        if ro_offset >= size:
            op.length = 0
        else:
            op.length = min(length, size - ro_offset)
        if op.length <= 0:
            op.data = b""
            self._finish(op)
            return op.rid

        op.want = self.sinfo.ro_range_to_shard_extent_set(
            op.ro_offset, op.length
        )
        op.result = ShardExtentMap(self.sinfo)
        try:
            op.shard_reads, op.need_decode = get_min_avail_to_read_shards(
                self.sinfo, self.codec, op.want, self._avail()
            )
        except ValueError as e:
            op.error = e
            self._finish(op)
            return op.rid
        self._issue(op, op.shard_reads)
        return op.rid

    def read_sync(self, oid: str, ro_offset: int, length: int) -> bytes:
        """Synchronous wrapper (ECBackend::objects_read_sync analog).
        Backends with a ``drain_until`` event loop (the networked one)
        are drained on this thread until the read completes."""
        out: dict[str, ClientReadOp] = {}
        self.submit(oid, ro_offset, length, lambda op: out.update(op=op))
        drain = getattr(self.backend, "drain_until", None)
        if drain is not None and "op" not in out:
            drain(lambda: "op" in out)
        op = out["op"]
        if op.error is not None:
            raise op.error
        return op.data

    # -- internals ------------------------------------------------------
    def _avail(self) -> set[int]:
        return self.backend.avail_shards()

    def _issue(self, op: ClientReadOp, reads: dict[int, ShardRead]) -> None:
        for shard in reads:
            op.pending[shard] = op.pending.get(shard, 0) + 1
        self.perf.inc(
            "helper_read_bytes",
            sum(
                end - start
                for sr in reads.values()
                for start, end in sr.extents
            ),
        )
        for sr in list(reads.values()):
            self.backend.read_shard_async(
                sr.shard,
                op.oid,
                sr.extents,
                lambda shard, result, _op=op: self._sub_read_done(
                    _op, shard, result
                ),
            )

    def _sub_read_done(self, op: ClientReadOp, shard: int, result) -> None:
        left = op.pending.get(shard, 0) - 1
        if left > 0:
            op.pending[shard] = left
        else:
            op.pending.pop(shard, None)
        if isinstance(result, Exception):
            op.error_shards.add(shard)
            self._retry(op)
        else:
            with tracer.timer("ec_stage"):
                for start, buf in result.items():
                    op.result.insert(shard, start, buf)
            if not op.pending:
                self._complete(op)

    def _retry(self, op: ClientReadOp) -> None:
        """Re-plan from the remaining survivors (get_remaining_shards,
        ECCommon.cc:312): issue only byte ranges not already read or
        requested. A still-pending shard can be widened — the extra
        sub-read just bumps its pending count."""
        self.perf.inc("retries")
        avail = self._avail() - op.error_shards
        try:
            reads, need_decode = get_min_avail_to_read_shards(
                self.sinfo, self.codec, op.want, avail
            )
        except ValueError as e:
            op.error = e
            if not op.pending:
                self._complete(op)
            return
        op.need_decode = op.need_decode or need_decode
        fresh: dict[int, ShardRead] = {}
        for shard, sr in reads.items():
            if shard in op.error_shards:
                continue
            already = op.result.get_extent_set(shard)
            prior = op.shard_reads.get(shard)
            if prior is not None:
                already = already.copy()
                already.union(prior.extents)
            missing = sr.extents.difference(already)
            if missing:
                fresh[shard] = ShardRead(shard, missing, sr.subchunks)
        # Refresh the sub-chunk selectors to the CURRENT plan: a retry
        # that fell back from fractional repair to full decode must not
        # leave stale selectors steering _reconstruct into codec.repair
        # with too few helpers.
        for shard, sr in op.shard_reads.items():
            new = reads.get(shard)
            sr.subchunks = new.subchunks if new is not None else None
        for shard, sr in fresh.items():
            if shard in op.shard_reads:
                op.shard_reads[shard].extents.union(sr.extents)
            else:
                op.shard_reads[shard] = ShardRead(
                    shard, sr.extents.copy(), sr.subchunks
                )
        if fresh:
            self._issue(op, fresh)
        elif not op.pending:
            self._complete(op)

    def _complete(self, op: ClientReadOp) -> None:
        if op.error is None and op.need_decode:
            self.perf.inc("reconstruct_ops")
            try:
                with tracer.span("ec_reconstruct", oid=op.oid, rid=op.rid):
                    self._reconstruct(op)
            except ValueError as e:
                op.error = e
        if op.error is None:
            op.data = gather_ro_range(
                self.sinfo, op.result, op.ro_offset, op.length
            )
            self.perf.inc("read_bytes", len(op.data))
        else:
            self.perf.inc("errors")
        self._finish(op)

    def _reconstruct(self, op: ClientReadOp) -> None:
        """Decode missing wanted shards from the survivors in
        ``op.result`` (complete_read_op → shard_extent_map_t::decode)."""
        reconstruct_shards(
            self.sinfo,
            self.codec,
            op.result,
            op.want,
            op.shard_reads,
            self.size_fn(op.oid),
            op.error_shards,
        )

    def _finish(self, op: ClientReadOp) -> None:
        """In-order completion (in_progress_client_reads semantics)."""
        op.done = True
        while self._inflight:
            rid, front = next(iter(self._inflight.items()))
            if not front.done:
                return
            self._inflight.pop(rid)
            if front.t_submit is not None:
                self.perf.ainc(
                    "read_lat", time.perf_counter() - front.t_submit
                )
            if front.on_complete is not None:
                front.on_complete(front)
