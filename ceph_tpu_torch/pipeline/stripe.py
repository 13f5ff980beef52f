"""Stripe geometry — the ``stripe_info_t`` analog.

Behavioral mirror of osd/ECUtil.h:346-729: rados-object offsets
("ro offsets") map onto k data shards round-robin by chunk; parity
shards trail; an optional ``chunk_mapping`` permutes logical ("raw")
shard positions to stored shard ids. All of this is host-side integer
shape math — on the card the stripe axis becomes the batch dimension of
one kernel launch, so getting this arithmetic right IS the data layout.

Vocabulary (matches the reference):
- ``raw_shard``: logical position 0..k-1 data, k..k+m-1 parity.
- ``shard``: stored position, ``chunk_mapping[raw_shard]``.
- ``ro_offset``: byte offset in the rados object.
- ``shard_offset``: byte offset within one shard's store.
"""

from __future__ import annotations

from .extents import ExtentSet

# BlueStore writes whole pages; the reference aligns shard IO to 4K
# (ECUtil.h align_page_next). Device tiling wants the same.
PAGE_SIZE = 4096


def align_page_next(x: int) -> int:
    return -(-x // PAGE_SIZE) * PAGE_SIZE


def align_page_prev(x: int) -> int:
    return (x // PAGE_SIZE) * PAGE_SIZE


def csum_block_range(
    offset: int,
    length: int,
    window_lo: int,
    nblocks: int,
    csum_block: int,
) -> "tuple[int, int] | None":
    """Block-index [first, last) of ``[offset, offset+length)`` within
    a csum window starting at ``window_lo`` that holds ``nblocks``
    blocks of ``csum_block`` bytes — or None unless the range is
    exactly block-aligned and fully covered. The shared shape math
    that lets fused-kernel csums travel with sub-writes: a store may
    only adopt kernel csums for ranges they describe bit-for-bit."""
    if length <= 0 or csum_block <= 0 or offset < window_lo:
        return None
    rel = offset - window_lo
    if rel % csum_block or length % csum_block:
        return None
    first = rel // csum_block
    last = first + length // csum_block
    if last > nblocks:
        return None
    return first, last


class StripeInfo:
    """Geometry of one EC pool: (k, m, stripe_width, chunk_mapping).

    ``stripe_width`` must be a multiple of k; ``chunk_size`` =
    stripe_width / k (ECUtil.h:418).
    """

    def __init__(
        self,
        k: int,
        m: int,
        stripe_width: int,
        chunk_mapping: list[int] | None = None,
    ) -> None:
        if stripe_width <= 0 or stripe_width % k != 0:
            raise ValueError(
                f"stripe_width {stripe_width} must be a positive multiple of k={k}"
            )
        self.k = k
        self.m = m
        self.stripe_width = stripe_width
        self.chunk_size = stripe_width // k
        mapping = list(chunk_mapping or [])
        # complete_chunk_mapping semantics (ECUtil.h:370-382): identity
        # beyond the provided prefix.
        for i in range(len(mapping), k + m):
            mapping.append(i)
        mapping = mapping[: k + m]
        rev: list[int] = [-1] * (k + m)
        for raw, shard in enumerate(mapping):
            if rev[shard] != -1:
                raise ValueError(f"chunk_mapping not a permutation: {mapping}")
            rev[shard] = raw
        self.chunk_mapping = mapping
        self.chunk_mapping_reverse = rev
        self.data_shards = frozenset(mapping[:k])
        self.parity_shards = frozenset(mapping[k:])

    # -- shard id translation -----------------------------------------
    def get_shard(self, raw_shard: int) -> int:
        return self.chunk_mapping[raw_shard]

    def get_raw_shard(self, shard: int) -> int:
        return self.chunk_mapping_reverse[shard]

    def is_data_shard(self, shard: int) -> bool:
        return shard in self.data_shards

    def is_parity_shard(self, shard: int) -> bool:
        return shard in self.parity_shards

    # -- offset arithmetic (ECUtil.h:499-663) -------------------------
    def ro_offset_to_shard_offset(self, ro_offset: int, raw_shard: int) -> int:
        """Shard-local offset of ``ro_offset`` as seen by ``raw_shard``
        (ECUtil.h:517-529): full stripes contribute chunk_size each;
        within the current stripe, shards before the offset's chunk are
        full, later ones empty."""
        full = (ro_offset // self.stripe_width) * self.chunk_size
        offset_shard = (ro_offset // self.chunk_size) % self.k
        if raw_shard == offset_shard:
            return full + ro_offset % self.chunk_size
        if raw_shard < offset_shard:
            return full + self.chunk_size
        return full

    def object_size_to_shard_size(self, size: int, shard: int) -> int:
        """Stored bytes on ``shard`` for an object of ``size`` bytes,
        page-aligned (ECUtil.h:499-515). Parity shards match data
        shard 0 (they exist for every written stripe)."""
        remainder = size % self.stripe_width
        shard_size = (size - remainder) // self.k
        raw = self.get_raw_shard(shard)
        if raw >= self.k:
            raw = 0
        skip = raw * self.chunk_size
        if remainder > skip:
            shard_size += min(remainder - skip, self.chunk_size)
        return align_page_next(shard_size)

    def ro_offset_to_prev_stripe_ro_offset(self, ro_offset: int) -> int:
        return (ro_offset // self.stripe_width) * self.stripe_width

    def ro_offset_to_next_stripe_ro_offset(self, ro_offset: int) -> int:
        return -(-ro_offset // self.stripe_width) * self.stripe_width

    def ro_offset_to_prev_chunk_offset(self, ro_offset: int) -> int:
        return (ro_offset // self.stripe_width) * self.chunk_size

    def ro_offset_to_next_chunk_offset(self, ro_offset: int) -> int:
        return -(-ro_offset // self.stripe_width) * self.chunk_size

    def chunk_aligned_ro_range_to_shard_ro_range(
        self, ro_offset: int, ro_length: int
    ) -> tuple[int, int]:
        """Stripe-align an ro range, then express it per shard: every
        shard sees [off/k, len/k) of the aligned range (ECUtil.h:644)."""
        start = self.ro_offset_to_prev_stripe_ro_offset(ro_offset)
        end = self.ro_offset_to_next_stripe_ro_offset(ro_offset + ro_length)
        return start // self.k, (end - start) // self.k

    # -- range fan-out -------------------------------------------------
    def ro_range_to_shard_extent_set(
        self, ro_offset: int, ro_length: int, parity: bool = False
    ) -> dict[int, ExtentSet]:
        """Per-shard extents touched by the ro byte range
        (ECUtil.h:665-695). With ``parity=True`` parity shards get the
        chunk-aligned hull (every touched stripe writes all parity)."""
        out: dict[int, ExtentSet] = {}
        if ro_length <= 0:
            return out
        end = ro_offset + ro_length
        pos = ro_offset
        while pos < end:
            chunk_index = pos // self.chunk_size
            raw_shard = chunk_index % self.k
            in_chunk = pos % self.chunk_size
            take = min(self.chunk_size - in_chunk, end - pos)
            shard = self.get_shard(raw_shard)
            shard_off = (chunk_index // self.k) * self.chunk_size + in_chunk
            out.setdefault(shard, ExtentSet()).insert(shard_off, take)
            pos += take
        if parity:
            first = self.ro_offset_to_prev_chunk_offset(ro_offset)
            last = self.ro_offset_to_next_chunk_offset(end)
            for raw in range(self.k, self.k + self.m):
                out.setdefault(self.get_shard(raw), ExtentSet()).insert(
                    first, last - first
                )
        return out

    def object_size_to_exact_shard_size(self, size: int, shard: int) -> int:
        """Bytes the write path actually stores on ``shard``: data
        shards keep the exact (unpadded) tail; parity shards are
        written for every touched page, so they stay page-aligned."""
        raw = self.get_raw_shard(shard)
        if raw >= self.k:
            return self.object_size_to_shard_size(size, shard)
        remainder = size % self.stripe_width
        shard_size = (size - remainder) // self.k
        skip = raw * self.chunk_size
        if remainder > skip:
            shard_size += min(remainder - skip, self.chunk_size)
        return shard_size

    def chunk_aligned_hull(self, extent_sets) -> tuple[int, int] | None:
        """Chunk-aligned [lo, hi) hull over shard-offset extent sets —
        the window every decode/encode dispatch covers. None if empty."""
        cs = self.chunk_size
        lo = hi = None
        for es in extent_sets:
            if not es:
                continue
            s0 = (es.range_start() // cs) * cs
            e0 = -(-es.range_end() // cs) * cs
            lo = s0 if lo is None else min(lo, s0)
            hi = e0 if hi is None else max(hi, e0)
        if lo is None:
            return None
        return lo, hi

    def __repr__(self) -> str:
        return (
            f"StripeInfo(k={self.k}, m={self.m}, "
            f"stripe_width={self.stripe_width}, "
            f"chunk_size={self.chunk_size})"
        )
