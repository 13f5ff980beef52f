"""Block allocators — the BlueStore allocator family analog
(src/os/bluestore/{Bitmap,Btree,Hybrid}Allocator + FreelistManager).

BlueStore manages a raw block device: every blob write asks an
allocator for extents and every deletion releases them. The reference
ships six implementations with different fragmentation/memory
trade-offs; the two structural archetypes (plus the hybrid that
combines them) are here:

- ``BtreeAllocator`` — sorted free-extent map (offset-keyed),
  best-fit allocation, coalescing release. The Avl/Btree/Btree2
  shape.
- ``BitmapAllocator`` — one bit per alloc-unit, first-fit scan with a
  rolling cursor. Constant memory, worst-case linear scan; the shape
  the reference uses when btree metadata would blow up.
- ``HybridAllocator`` — btree until its extent count exceeds a cap,
  then spills the most fragmented runs to a bitmap child (the
  reference's Hybrid avl+bitmap split, bluestore Hybrid*).

All speak one contract: ``init_add_free``/``allocate``/``release``/
``get_free``; allocations never overlap, releases coalesce, and every
byte is conserved (model-checked in tests/test_blockstore.py).
"""

from __future__ import annotations

import bisect


class AllocError(Exception):
    """Not enough free space for the request (ENOSPC)."""


class BtreeAllocator:
    """Offset-sorted free extents + best-fit by size."""

    def __init__(self, alloc_unit: int = 4096) -> None:
        self.alloc_unit = alloc_unit
        self._offs: list[int] = []   # sorted extent start offsets
        self._lens: dict[int, int] = {}  # start -> length
        self.free_bytes = 0

    # -- free-space bookkeeping ----------------------------------------
    def init_add_free(self, offset: int, length: int) -> None:
        self.release([(offset, length)])

    def get_free(self) -> int:
        return self.free_bytes

    def free_extents(self) -> list[tuple[int, int]]:
        return [(o, self._lens[o]) for o in self._offs]

    # -- allocate -------------------------------------------------------
    def allocate(self, want: int, unit: int | None = None) -> list[tuple[int, int]]:
        """Up to ``want`` bytes (rounded up to alloc units) as one or
        more extents, best-fit first (smallest extent that satisfies
        the whole request; falls back to gathering largest-first)."""
        unit = unit or self.alloc_unit
        want = -(-want // unit) * unit
        if want > self.free_bytes:
            raise AllocError(f"want {want}, free {self.free_bytes}")
        # best fit: smallest single extent >= want
        best = None
        for off in self._offs:
            ln = self._lens[off]
            if ln >= want and (best is None or ln < self._lens[best]):
                best = off
        if best is not None:
            self._carve(best, want)
            return [(best, want)]
        # fragmented: gather largest-first until satisfied
        out: list[tuple[int, int]] = []
        remaining = want
        for off in sorted(self._offs, key=lambda o: -self._lens[o]):
            if remaining <= 0:
                break
            take = min(self._lens[off], remaining)
            take = (take // unit) * unit or min(self._lens[off], remaining)
            self._carve(off, take)
            out.append((off, take))
            remaining -= take
        if remaining > 0:  # conservation says this cannot happen
            self.release(out)
            raise AllocError(f"fragmentation shortfall: {remaining}")
        return out

    def _carve(self, off: int, take: int) -> None:
        ln = self._lens.pop(off)
        i = bisect.bisect_left(self._offs, off)
        self._offs.pop(i)
        if ln > take:
            rest = off + take
            bisect.insort(self._offs, rest)
            self._lens[rest] = ln - take
        self.free_bytes -= take

    # -- release --------------------------------------------------------
    def release(self, extents: list[tuple[int, int]]) -> None:
        for off, ln in extents:
            if ln <= 0:
                continue
            i = bisect.bisect_left(self._offs, off)
            # coalesce with predecessor
            if i > 0:
                p = self._offs[i - 1]
                pl = self._lens[p]
                if p + pl == off:
                    off, ln = p, pl + ln
                    self._offs.pop(i - 1)
                    del self._lens[p]
                    i -= 1
                elif p + pl > off:
                    raise ValueError(f"double free at {off:#x}")
            # coalesce with successor
            if i < len(self._offs):
                s = self._offs[i]
                if off + ln == s:
                    ln += self._lens.pop(s)
                    self._offs.pop(i)
                elif off + ln > s:
                    raise ValueError(f"double free at {off:#x}")
            bisect.insort(self._offs, off)
            self._lens[off] = ln
        # coalescing moved bytes between extents without changing the
        # total; the sum is the one invariant worth recomputing
        self.free_bytes = sum(self._lens.values())


class BitmapAllocator:
    """One bit per alloc unit; first-fit with a rolling cursor."""

    def __init__(self, alloc_unit: int = 4096) -> None:
        self.alloc_unit = alloc_unit
        self._free: bytearray = bytearray()  # 1 byte per unit (simple)
        self._base = 0
        self._cursor = 0
        self.free_bytes = 0

    def init_add_free(self, offset: int, length: int) -> None:
        unit = self.alloc_unit
        end_unit = (offset + length) // unit
        if len(self._free) < end_unit:
            self._free.extend(b"\0" * (end_unit - len(self._free)))
        self.release([(offset, length)])

    def get_free(self) -> int:
        return self.free_bytes

    def allocate(self, want: int, unit: int | None = None) -> list[tuple[int, int]]:
        u = self.alloc_unit
        want_units = -(-want // u)
        if want_units * u > self.free_bytes:
            raise AllocError(f"want {want}, free {self.free_bytes}")
        out: list[tuple[int, int]] = []
        remaining = want_units
        n = len(self._free)
        scanned = 0
        i = self._cursor
        run_start = -1
        while remaining > 0 and scanned <= n:
            if i >= n:
                if run_start >= 0:
                    take = min(i - run_start, remaining)
                    self._take(run_start, take, out)
                    remaining -= take
                    run_start = -1
                i = 0
                continue
            if self._free[i]:
                if run_start < 0:
                    run_start = i
                if i - run_start + 1 >= remaining:
                    # run already satisfies the request: stop scanning
                    self._take(run_start, remaining, out)
                    remaining = 0
                    i += 1
                    break
            else:
                if run_start >= 0:
                    take = min(i - run_start, remaining)
                    self._take(run_start, take, out)
                    remaining -= take
                    run_start = -1
            i += 1
            scanned += 1
        if run_start >= 0 and remaining > 0:
            take = min(i - run_start, remaining)
            self._take(run_start, take, out)
            remaining -= take
        if remaining > 0:
            self.release(out)
            raise AllocError("bitmap scan shortfall")
        self._cursor = i % max(n, 1)
        return out

    def _take(self, unit_off: int, units: int, out: list) -> None:
        u = self.alloc_unit
        for j in range(unit_off, unit_off + units):
            self._free[j] = 0
        self.free_bytes -= units * u
        off = unit_off * u
        if out and out[-1][0] + out[-1][1] == off:
            out[-1] = (out[-1][0], out[-1][1] + units * u)
        else:
            out.append((off, units * u))

    def release(self, extents: list[tuple[int, int]]) -> None:
        u = self.alloc_unit
        for off, ln in extents:
            if ln <= 0:
                continue
            assert off % u == 0 and ln % u == 0, (off, ln)
            for j in range(off // u, (off + ln) // u):
                if self._free[j]:
                    raise ValueError(f"double free at unit {j}")
                self._free[j] = 1
            self.free_bytes += ln

    def free_extents(self) -> list[tuple[int, int]]:
        out = []
        u = self.alloc_unit
        start = None
        for j, b in enumerate(self._free):
            if b and start is None:
                start = j
            elif not b and start is not None:
                out.append((start * u, (j - start) * u))
                start = None
        if start is not None:
            out.append((start * u, (len(self._free) - start) * u))
        return out


class HybridAllocator:
    """Btree until fragmentation explodes, bitmap spill after
    (HybridAvlAllocator: bounded btree memory, bitmap overflow)."""

    def __init__(self, alloc_unit: int = 4096, max_extents: int = 1024) -> None:
        self.alloc_unit = alloc_unit
        self.max_extents = max_extents
        self.btree = BtreeAllocator(alloc_unit)
        self.bitmap: BitmapAllocator | None = None
        self._device_end = 0

    def init_add_free(self, offset: int, length: int) -> None:
        self._device_end = max(self._device_end, offset + length)
        self.btree.init_add_free(offset, length)
        self._maybe_spill()

    def get_free(self) -> int:
        free = self.btree.get_free()
        if self.bitmap is not None:
            free += self.bitmap.get_free()
        return free

    def allocate(self, want: int, unit: int | None = None) -> list[tuple[int, int]]:
        u = unit or self.alloc_unit
        want = -(-want // u) * u
        if want > self.get_free():
            raise AllocError(f"want {want}, free {self.get_free()}")
        try:
            return self.btree.allocate(want, u)
        except AllocError:
            pass
        # gather across BOTH pools: total free covers the request even
        # when neither side alone does
        out: list[tuple[int, int]] = []
        remaining = want
        for pool in (self.btree, self.bitmap):
            if pool is None or remaining <= 0:
                continue
            take = min(remaining, (pool.get_free() // u) * u)
            if take <= 0:
                continue
            try:
                got = pool.allocate(take, u)
            except AllocError:
                continue
            out.extend(got)
            remaining -= sum(ln for _, ln in got)
        if remaining > 0:
            # return partial grabs to their pools via the btree (frees
            # flow to the btree; ownership transfers on release)
            self.btree.release(out)
            raise AllocError(f"hybrid shortfall: {remaining}")
        return out

    def release(self, extents: list[tuple[int, int]]) -> None:
        self.btree.release(extents)
        self._maybe_spill()

    def _maybe_spill(self) -> None:
        """Move the SMALLEST free extents into the bitmap child when
        the btree carries too many (bounded btree memory — the hybrid
        trade-off)."""
        if len(self.btree._offs) <= self.max_extents:
            return
        if self.bitmap is None:
            self.bitmap = BitmapAllocator(self.alloc_unit)
        # (re)size the child to the CURRENT device end: init_add_free
        # arrives incrementally and later spills may sit beyond the
        # end seen at first-spill time
        units = -(-self._device_end // self.alloc_unit)
        if len(self.bitmap._free) < units:
            self.bitmap._free.extend(
                b"\0" * (units - len(self.bitmap._free))
            )
        spill = sorted(
            self.btree.free_extents(), key=lambda e: e[1]
        )[: len(self.btree._offs) - self.max_extents // 2]
        for off, ln in spill:
            self.btree._carve(off, ln)
            self.bitmap.release([(off, ln)])

    def free_extents(self) -> list[tuple[int, int]]:
        out = self.btree.free_extents()
        if self.bitmap is not None:
            out += self.bitmap.free_extents()
        return sorted(out)


ALLOCATORS = {
    "btree": BtreeAllocator,
    "bitmap": BitmapAllocator,
    "hybrid": HybridAllocator,
}
