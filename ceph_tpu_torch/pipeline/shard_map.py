"""Per-shard extent maps of buffers — the ``shard_extent_map_t`` analog.

Mirrors osd/ECUtil.h:782+ / ECUtil.cc:487-729 semantics: a map
shard -> {extent -> bytes} plus the drivers that feed the codec —
``encode`` (parity over page-aligned slices), ``encode_parity_delta``
(delta = old XOR new, applied onto parity via generator columns), and
``decode`` (decode-of-data + re-encode-of-parity split).

Delta from the reference: the window's chunks go to the codec as one
[n_chunks, chunk] batch per shard — one kernel launch — instead of a
per-4K-slice virtual call.

Buffers are host numpy here (this layer is the staging side of the
pipeline); codec calls move them to the codec's device and back.
Encodes take the per-op path (one codec call per map) unless
``ec_streaming_dispatch`` is on or the thread is inside
``dispatcher.coalescing_scope()``: then they stage in the native ring
(``pipeline/dispatcher.py``) and share one batched launch with the
concurrent ops of other threads.

The process-wide ``ec_staging`` perf set counts the bytes ``insert``
and ``get`` copy (``copy_bytes``) and zero-fill (``zero_bytes``), once
per call or once per ``tally`` block, and the client bytes the
pipelines stage (``user_bytes``: a write's payload as the RMW pipeline
scatters it, a read's as it is gathered); ``encode`` and
``encode_parity_delta`` run under the ``ec_encode`` timer
(``utils/trace.py``).
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np

from ceph_tpu_torch.utils import PerfCountersBuilder, perf_collection, tracer
from ceph_tpu_torch.utils.device import to_numpy

from .extents import ExtentSet
from .hashinfo import HashInfo
from .stripe import PAGE_SIZE, StripeInfo, align_page_next, align_page_prev


_STAGING = (
    PerfCountersBuilder(perf_collection, "ec_staging")
    .add_u64_counter(
        "copy_bytes", "bytes ShardExtentMap.insert/get copied"
    )
    .add_u64_counter(
        "zero_bytes", "bytes ShardExtentMap.insert/get zero-filled"
    )
    .add_u64_counter(
        "user_bytes", "client bytes scattered into or gathered from "
        "shard maps"
    )
    .create_perf_counters()
)


def _staged(copied: int, zeroed: int) -> None:
    _STAGING.add_many((("copy_bytes", copied), ("zero_bytes", zeroed)))


class ShardExtentMap:
    """shard -> sorted disjoint (offset, buffer) runs, plus codec drivers."""

    def __init__(self, sinfo: StripeInfo) -> None:
        self.sinfo = sinfo
        self._bufs: dict[int, list[tuple[int, np.ndarray]]] = {}
        #: fused encode+csum output, set by ``encode`` when the kernel
        #: served it: {"block": cb, "shards": {shard: (window_lo,
        #: uint32[nblocks] ZERO-INIT per-block crc32c)}} — the blocks
        #: cover each shard's encode window contiguously
        self.csums: "dict | None" = None
        #: [copied, zeroed] while ``tally`` holds this map's staging
        #: counts back
        self._tally: "list[int] | None" = None

    def _staged(self, copied: int, zeroed: int) -> None:
        if self._tally is None:
            _staged(copied, zeroed)
        else:
            self._tally[0] += copied
            self._tally[1] += zeroed

    @contextmanager
    def tally(self, user_bytes: int = 0):
        """Count this map's inserts and gets inside the block, with the
        ``user_bytes`` of client data they stage, as one ``ec_staging``
        update at its end: the per-4 KiB scatter and gather loops take
        the counter lock once, not ~1,000 times, and a window that
        closes mid-loop counts neither the bytes nor their base."""
        self._tally = [0, 0]
        try:
            yield
        finally:
            copied, zeroed = self._tally
            self._tally = None
            _STAGING.add_many((
                ("copy_bytes", copied), ("zero_bytes", zeroed),
                ("user_bytes", user_bytes),
            ))

    # -- buffer management --------------------------------------------
    def insert(self, shard: int, offset: int, data) -> None:
        """Insert bytes at a shard offset, coalescing adjacent/overlapping
        runs (later inserts win on overlap, matching extent_map assign)."""
        if isinstance(data, (bytes, bytearray, memoryview)):
            arr = np.frombuffer(bytes(data), dtype=np.uint8).copy()
            # bytes(...) copies all but a bytes object
            copied = arr.size * (1 if type(data) is bytes else 2)
        else:
            arr = np.asarray(data, dtype=np.uint8).reshape(-1).copy()
            copied = arr.size
        if arr.size == 0:
            return
        runs = self._bufs.setdefault(shard, [])
        if not runs or runs[-1][0] + runs[-1][1].size < offset:
            runs.append((offset, arr))  # past every run: nothing merges
            self._staged(copied, 0)
            return
        new_start, new_end = offset, offset + arr.size
        merged_start, merged_end = new_start, new_end
        keep: list[tuple[int, np.ndarray]] = []
        overlapping: list[tuple[int, np.ndarray]] = []
        for off, buf in runs:
            if off + buf.size < merged_start or off > merged_end:
                keep.append((off, buf))
            else:
                overlapping.append((off, buf))
                merged_start = min(merged_start, off)
                merged_end = max(merged_end, off + buf.size)
        out = np.zeros(merged_end - merged_start, dtype=np.uint8)
        for off, buf in overlapping:
            out[off - merged_start : off - merged_start + buf.size] = buf
            copied += buf.size
        out[new_start - merged_start : new_end - merged_start] = arr
        keep.append((merged_start, out))
        keep.sort(key=lambda t: t[0])
        self._bufs[shard] = keep
        self._staged(copied + arr.size, out.size)

    def shards(self) -> list[int]:
        return sorted(self._bufs)

    def get_extent_set(self, shard: int) -> ExtentSet:
        return ExtentSet(
            (off, off + buf.size) for off, buf in self._bufs.get(shard, [])
        )

    def get(self, shard: int, offset: int, length: int) -> np.ndarray:
        """Read a range; absent bytes read as zero (the shared
        zero-buffer convention)."""
        out = np.zeros(length, dtype=np.uint8)
        copied = 0
        for off, buf in self._bufs.get(shard, []):
            s = max(offset, off)
            e = min(offset + length, off + buf.size)
            if s < e:
                out[s - offset : e - offset] = buf[s - off : e - off]
                copied += e - s
        self._staged(copied, length)
        return out

    def contains(self, shard: int, offset: int, length: int) -> bool:
        return self.get_extent_set(shard).contains(offset, length)

    def erase_shard(self, shard: int) -> None:
        self._bufs.pop(shard, None)

    def erase(self, shard: int, offset: int, length: int) -> None:
        runs = self._bufs.get(shard)
        if not runs:
            return
        out = []
        for off, buf in runs:
            lo, hi = offset, offset + length
            if off + buf.size <= lo or off >= hi:
                out.append((off, buf))
                continue
            if off < lo:
                out.append((off, buf[: lo - off]))
            if off + buf.size > hi:
                out.append((hi, buf[hi - off :]))
        if out:
            self._bufs[shard] = out
        else:
            del self._bufs[shard]

    # -- geometry helpers ---------------------------------------------
    def ro_range(self) -> tuple[int, int]:
        """(ro_start, ro_end) hull across data shards, stripe-aligned —
        the ro_start/ro_end members of shard_extent_map_t."""
        lo, hi = None, None
        for shard in self._bufs:
            raw = self.sinfo.get_raw_shard(shard)
            if raw >= self.sinfo.k:
                continue
            es = self.get_extent_set(shard)
            if not es:
                continue
            lo = es.range_start() if lo is None else min(lo, es.range_start())
            hi = es.range_end() if hi is None else max(hi, es.range_end())
        if lo is None:
            return 0, 0
        return align_page_prev(lo), align_page_next(hi)

    def pad_and_rebuild_to_page_align(self) -> None:
        """Round every run outward to page boundaries, zero-filling —
        pad_and_rebuild_to_page_align (ECUtil.cc:731): device DMA and
        store writes both want whole pages."""
        for shard in list(self._bufs):
            runs = self._bufs.pop(shard)
            for off, buf in runs:
                start = align_page_prev(off)
                end = align_page_next(off + buf.size)
                padded = np.zeros(end - start, dtype=np.uint8)
                padded[off - start : off - start + buf.size] = buf
                self.insert(shard, start, padded)

    def csums_for(
        self, shard: int, offset: int, length: int
    ) -> "np.ndarray | None":
        """Kernel-produced ZERO-INIT per-block csums covering exactly
        ``[offset, offset+length)`` of ``shard``, or None when the
        fused encode didn't run / the range isn't block-aligned within
        the csum window. What the sub-write generator attaches to each
        store write so BlueStore-analog blob csums come from the
        kernel, not a host re-hash."""
        if self.csums is None:
            return None
        from .stripe import csum_block_range

        entry = self.csums["shards"].get(shard)
        if entry is None:
            return None
        wlo, vals = entry
        rng = csum_block_range(
            offset, length, wlo, int(vals.size), self.csums["block"]
        )
        if rng is None:
            return None
        return vals[rng[0] : rng[1]]

    # -- codec drivers -------------------------------------------------
    def _slice_window(self) -> tuple[int, int]:
        lo, hi = self.ro_range()
        return lo, hi

    def encode(self, codec, hashinfo: HashInfo | None = None,
               old_size: int | None = None,
               csum_block: int | None = None) -> None:
        """Compute parity for every page-aligned slice covered by the
        data shards and insert it into this map (ECUtil.cc:487-511).

        One batched launch for the whole window, not one per slice.
        Updates ``hashinfo`` with the newly written shard tails when
        given (the encode-time HashInfo append, ECUtil.cc:521-534).

        With ``csum_block`` set and the codec's fused encode+csum
        kernel able to serve the geometry, the SAME launch also
        emits per-csum-block crc32c for all k+m shards (recorded in
        ``self.csums`` for the sub-write path to carry to the stores)
        and the HashInfo append is seeded from those kernel csums via
        crc chaining — the bytes are hashed exactly once, on device.
        """
        with tracer.timer("ec_encode"):
            self._encode(codec, hashinfo, old_size, csum_block)

    def _encode(self, codec, hashinfo, old_size, csum_block) -> None:
        k, m = self.sinfo.k, self.sinfo.m
        self.csums = None
        lo0, hi0 = self._slice_window()
        if hi0 <= lo0:
            return
        # Chunk-align the dispatch window and batch per chunk: codecs
        # with intra-chunk structure (CLAY sub-chunks) need real chunk
        # boundaries, and the chunk axis is a free batch axis. The
        # HASH window below stays page-aligned (lo0/hi0): hashed size
        # must track what the client wrote so contiguous appends keep
        # extending the cumulative CRCs when chunk_size > PAGE_SIZE.
        cs = self.sinfo.chunk_size
        lo = (lo0 // cs) * cs
        hi = -(-hi0 // cs) * cs
        n_chunks = (hi - lo) // cs
        data = np.stack(
            [
                self.get(self.sinfo.get_shard(r), lo, hi - lo).reshape(
                    n_chunks, cs
                )
                for r in range(k)
            ]
        )
        parity = csums = None
        cb = csum_block
        if (
            cb
            and cs % cb == 0
            and lo % cb == 0
            and hasattr(codec, "encode_chunks_with_csums")
        ):
            # Coalesced/streaming route first: the fused op stages in
            # the ring and shares ONE encode+csum launch with every
            # other op of the window (the same batching win the plain
            # encode gets below). (None, None) = the fused kernel
            # can't serve the geometry; fall through per-op.
            staged = self._ring_encode_csum(codec, data, cs, cb)
            if staged is not None:
                parity2d, csums = staged
                if parity2d is not None:
                    parity = parity2d.reshape(m, n_chunks, cs)
            if csums is None:
                parity_map, csums = codec.encode_chunks_with_csums(
                    {i: data[i] for i in range(k)}, cb
                )
                if parity_map is not None:
                    parity = np.stack(
                        [to_numpy(parity_map[k + j]) for j in range(m)]
                    )
        if parity is None:
            parity = self._dispatch_encode(codec, data)
        for j in range(m):
            self.insert(
                self.sinfo.get_shard(k + j), lo, parity[j].reshape(-1)
            )
        if csums is not None:
            # [n_chunks, k+m, cs/cb] -> per shard the window's linear
            # block sequence (chunk-major, matching the shard's byte
            # stream at offsets lo + i*cb)
            arr = np.asarray(csums)
            self.csums = {
                "block": cb,
                "shards": {
                    self.sinfo.get_shard(raw): (
                        lo, np.ascontiguousarray(arr[:, raw, :]).reshape(-1)
                    )
                    for raw in range(k + m)
                },
            }
        if hashinfo is not None:
            # Appends must be contiguous and equal-length across shards
            # (the HashInfo contract): hash every shard's zero-padded
            # tail up to the common PAGE window end (not the chunk-
            # aligned dispatch window — see comment above).
            base = lo0 if old_size is None else old_size
            if hi0 > base:
                if (
                    self.csums is not None
                    and base >= lo
                    and (base - lo) % cb == 0
                    and (hi0 - base) % cb == 0
                    and hi0 <= hi
                ):
                    # device-seeded: chain the kernel's zero-init
                    # block csums into the cumulative shard hashes
                    first, last = (base - lo) // cb, (hi0 - lo) // cb
                    hashinfo.append_block_csums(
                        base,
                        {
                            shard: vals[first:last]
                            for shard, (_wlo, vals) in
                            self.csums["shards"].items()
                        },
                        cb,
                    )
                else:
                    hashinfo.append(
                        base,
                        {
                            self.sinfo.get_shard(raw): self.get(
                                self.sinfo.get_shard(raw), base,
                                hi0 - base,
                            )
                            for raw in range(k + m)
                        },
                    )

    @staticmethod
    def _ring_routable(codec, nbytes: int) -> bool:
        """One gate for both ring routes: streaming config on, OR this
        thread is inside a coalescing scope (dispatcher.
        coalescing_scope) — concurrent groups stage into the same
        ring window either way. Sub-chunk codecs (CLAY) give chunk
        geometry meaning beyond byte count, and ops beyond a ring slot
        can't stage — both keep the per-op path."""
        from .dispatcher import (
            coalescing_active,
            dispatcher_for,
            streaming_enabled,
        )

        if codec.get_sub_chunk_count() != 1:
            return False
        if not (streaming_enabled() or coalescing_active()):
            return False
        return nbytes <= dispatcher_for(codec).max_op_bytes

    @staticmethod
    def _ring_encode_csum(codec, data, cs: int, cb: int):
        """Stage one fused encode+csum op in the ring, or None when
        the ring isn't routable for it. ``data`` is [k, n_chunks, cs];
        returns ``(parity [m, L] | None, csums | None)``."""
        from .dispatcher import dispatcher_for

        if not ShardExtentMap._ring_routable(codec, data.nbytes):
            return None
        k, n_chunks, _cs = data.shape
        return dispatcher_for(codec).encode_csum_sync(
            np.ascontiguousarray(data).reshape(k, n_chunks * cs),
            cb, n_chunks,
        )

    @staticmethod
    def _dispatch_encode(codec, data: np.ndarray) -> np.ndarray:
        """[k, L] host -> [m, L] host through the codec's dispatch.
        With ``ec_streaming_dispatch`` on — or inside a coalescing
        scope — the op rides the native staging ring and shares a
        batched launch with other concurrent ops
        (pipeline/dispatcher.py)."""
        from .dispatcher import dispatcher_for

        k = data.shape[0]
        flat = data.reshape(k, -1)
        if ShardExtentMap._ring_routable(codec, flat.nbytes):
            return dispatcher_for(codec).encode_sync(flat).reshape(
                (-1,) + data.shape[1:]
            )
        parity = codec.encode_chunks(
            {i: np.asarray(data[i]) for i in range(k)}
        )
        return np.stack(
            [to_numpy(parity[k + j]) for j in range(len(parity))]
        )

    def encode_parity_delta(self, codec, old_map: "ShardExtentMap") -> None:
        """Parity-delta RMW (ECUtil.cc:542-588): for each data shard
        present here, delta = old XOR new; parity' = parity XOR
        sum_i G[:,i] * delta_i. ``old_map`` must hold the old data AND
        old parity over this map's window."""
        with tracer.timer("ec_encode"):
            self._encode_parity_delta(codec, old_map)

    def _encode_parity_delta(self, codec, old_map: "ShardExtentMap") -> None:
        from ceph_tpu_torch.codecs.interface import Flag

        k, m = self.sinfo.k, self.sinfo.m
        lo, hi = self._slice_window()
        if hi <= lo:
            return
        # Packet-layout codes need chunk-shaped delta windows: the
        # packet decomposition is per-chunk, so the window is widened
        # to chunk boundaries and every buffer reshaped [n_chunks, cs]
        # (delta outside the written extents is zero by construction,
        # and the planner chunk-aligned the parity reads/writes).
        chunk_gran = bool(
            codec.get_flags() & Flag.PARITY_DELTA_CHUNK_GRANULARITY
        )
        if chunk_gran:
            cs = self.sinfo.chunk_size
            lo = (lo // cs) * cs
            hi = -(-hi // cs) * cs
            shape = ((hi - lo) // cs, cs)
        deltas = {}
        for raw in range(k):
            shard = self.sinfo.get_shard(raw)
            if shard not in self._bufs:
                continue
            # Only bytes this map actually wrote may differ: fill the
            # rest of the window from old so delta is zero there (a
            # zero-filled gap would otherwise XOR the old data OUT of
            # the parity — silent corruption).
            old = old_map.get(shard, lo, hi - lo)
            new = old.copy()
            for off, end in self.get_extent_set(shard):
                s = max(off, lo)
                e = min(end, hi)
                if s < e:
                    new[s - lo : e - lo] = self.get(shard, s, e - s)
            # delta is plain GF addition: XOR on the host (a copy to
            # the card per shard would cost more than the XOR)
            d = np.bitwise_xor(np.asarray(old), np.asarray(new))
            deltas[raw] = d.reshape(shape) if chunk_gran else d
        if not deltas:
            return
        parity_in = {}
        for j in range(m):
            p = np.asarray(
                old_map.get(self.sinfo.get_shard(k + j), lo, hi - lo)
            )
            parity_in[k + j] = p.reshape(shape) if chunk_gran else p
        parity_out = codec.apply_delta(deltas, parity_in)
        for j in range(m):
            self.insert(
                self.sinfo.get_shard(k + j), lo,
                to_numpy(parity_out[k + j]).reshape(-1),
            )

    def decode(self, codec, want: set[int], object_size: int) -> None:
        """Reconstruct the wanted shards from whatever this map holds
        (ECUtil.cc:648-729): wanted data shards decode from any k
        survivors; wanted parity shards re-encode from (possibly just-
        decoded) data. Buffers are zero-padded to the common window and
        trimmed back to each shard's size within ``object_size``."""
        sinfo = self.sinfo
        missing_raw = sorted(
            sinfo.get_raw_shard(s) for s in want if s not in self._bufs
        )
        if not missing_raw:
            return
        cs = sinfo.chunk_size
        hull = sinfo.chunk_aligned_hull(
            self.get_extent_set(shard) for shard in self._bufs
        )
        if hull is None or hull[1] <= hull[0]:
            return
        lo, hi = hull
        # a wanted shard that STORES nothing in the window (short
        # object / post-truncate tail) needs no reconstruction — its
        # bytes are zeros by convention; demanding k survivors for it
        # would fail exactly when the object is small. It must still
        # MATERIALIZE as zeros here: callers (the RMW extent cache)
        # check that requested extents became present, and an absent
        # shard would re-issue the backend read forever.
        zero_raw = [
            raw for raw in missing_raw
            if sinfo.object_size_to_exact_shard_size(
                object_size, sinfo.get_shard(raw)
            ) <= lo
        ]
        for raw in zero_raw:
            shard = sinfo.get_shard(raw)
            end = min(
                hi, sinfo.object_size_to_shard_size(object_size, shard)
            )
            if end > lo:
                self.insert(
                    shard, lo, np.zeros(end - lo, dtype=np.uint8)
                )
        missing_raw = [r for r in missing_raw if r not in zero_raw]
        if not missing_raw:
            return
        # Survivors must cover the stored part of the window: a shard
        # holding only a sub-range would decode zero-filled gaps into
        # the output (absent bytes are zero ONLY beyond shard size).
        # EXACT size, not the page-rounded one: codecs whose chunk is
        # not a page multiple (liberation family, chunk = w * align)
        # store data shards to the exact tail — the page-rounding gap
        # is zeros by convention, not missing bytes.
        present_raw = []
        for shard in self._bufs:
            ssize = sinfo.object_size_to_exact_shard_size(object_size, shard)
            end = min(hi, ssize)
            if end <= lo or self.get_extent_set(shard).contains(lo, end - lo):
                present_raw.append(sinfo.get_raw_shard(shard))
        # a shard NOT in the map whose stored size ends at/before the
        # window is a KNOWN-ZERO survivor (short object / truncated
        # tail): its window content is zeros by convention, and
        # counting it can be the difference between decodable and not
        # (e.g. two lost shards + one empty shard in a k=4 stripe)
        for raw in range(sinfo.k + sinfo.m):
            shard = sinfo.get_shard(raw)
            if shard in self._bufs or raw in missing_raw:
                continue
            if sinfo.object_size_to_exact_shard_size(
                object_size, shard
            ) <= lo:
                present_raw.append(raw)
        present_raw.sort()
        n_chunks = (hi - lo) // cs
        chunks = {
            raw: np.asarray(
                self.get(sinfo.get_shard(raw), lo, hi - lo).reshape(
                    n_chunks, cs
                )
            )
            for raw in present_raw
        }
        out = codec.decode_chunks(set(missing_raw), chunks)
        for raw in missing_raw:
            shard = sinfo.get_shard(raw)
            buf = to_numpy(out[raw]).reshape(-1)
            shard_size = sinfo.object_size_to_shard_size(object_size, shard)
            end = min(hi, shard_size)
            if end > lo:
                self.insert(shard, lo, buf[: end - lo])

    # -- debug ---------------------------------------------------------
    def __repr__(self) -> str:
        parts = ", ".join(
            f"{s}:{self.get_extent_set(s)!r}" for s in self.shards()
        )
        return f"ShardExtentMap({parts})"
