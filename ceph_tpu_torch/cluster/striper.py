"""Client-side striping — the libradosstriper analog
(src/libradosstriper/RadosStriperImpl.cc).

A striped object spreads a logical byte range RAID-0-style over many
RADOS objects so huge objects parallelize across PGs/primaries (the
reference's file-layout trio, also used by CephFS and RBD):

- ``stripe_unit``  bytes per contiguous cell,
- ``stripe_count`` objects striped across at a time (one *object set*),
- ``object_size``  bytes each underlying object grows to before the
  next object set begins.

Logical block ``b = off // stripe_unit`` lands in object set
``b // (stripe_count * K)`` (``K = object_size // stripe_unit`` rows
per set), column ``b % stripe_count``, row ``(b // stripe_count) % K``
— underlying object ``set * stripe_count + column`` at offset
``row * stripe_unit`` (RadosStriperImpl::extract_extents geometry).
Pieces are named ``<oid>.<index:016x>`` as the reference names them.

Sparse semantics match rados: reads of never-written ranges return
zeros, and a write may skip whole object sets. The logical size lives
in a ``<oid>.meta`` piece (the role of the size xattr the reference
keeps on the first object, RadosStriperImpl::getattr on .000...0):
piece probing cannot bound a sparse object's scan, metadata can.
"""

from __future__ import annotations

from .objecter import IoCtx


class StripedIoCtx:
    """Striping wrapper over an ``IoCtx`` (RadosStriper facade)."""

    def __init__(
        self,
        ioctx: IoCtx,
        stripe_unit: int = 65536,
        stripe_count: int = 4,
        object_size: int = 1 << 22,
    ) -> None:
        if object_size % stripe_unit:
            raise ValueError("object_size must be a stripe_unit multiple")
        if stripe_count < 1 or stripe_unit < 1:
            raise ValueError("stripe_count/stripe_unit must be positive")
        self.io = ioctx
        self.su = stripe_unit
        self.sc = stripe_count
        self.rows = object_size // stripe_unit  # K rows per object set
        self.object_size = object_size

    # -- geometry -------------------------------------------------------
    def _piece(self, oid: str, index: int) -> str:
        return f"{oid}.{index:016x}"

    def _to_object(self, off: int) -> tuple[int, int]:
        """logical offset -> (object index, offset inside object)."""
        block, rem = divmod(off, self.su)
        oset, in_set = divmod(block, self.sc * self.rows)
        row, col = divmod(in_set, self.sc)
        return oset * self.sc + col, row * self.su + rem

    def _to_logical(self, index: int, obj_off: int) -> int:
        """(object index, offset inside object) -> logical offset."""
        oset, col = divmod(index, self.sc)
        row, rem = divmod(obj_off, self.su)
        block = (oset * self.rows + row) * self.sc + col
        return block * self.su + rem

    def _extents(self, off: int, length: int):
        """Split a logical range into per-piece (index, obj_off, len)
        runs, cell by cell, merging adjacent runs in the same piece."""
        out: list[list[int]] = []  # [index, obj_off, len]
        pos = off
        end = off + length
        while pos < end:
            idx, obj_off = self._to_object(pos)
            take = min(self.su - (pos % self.su), end - pos)
            if out and out[-1][0] == idx and (
                out[-1][1] + out[-1][2] == obj_off
            ):
                out[-1][2] += take
            else:
                out.append([idx, obj_off, take])
            pos += take
        return [tuple(e) for e in out]

    # -- IO surface (rados_striper_{write,read,stat,remove}) -----------
    def write(self, oid: str, data: bytes, offset: int = 0) -> None:
        """Pieces land on different PGs/primaries: fan the per-piece
        writes out via aio and wait for all (the striper's point is
        exactly this parallelism)."""
        comps = []
        pos = 0
        for idx, obj_off, length in self._extents(offset, len(data)):
            comps.append(
                self.io.aio_write(
                    self._piece(oid, idx),
                    data[pos:pos + length],
                    offset=obj_off,
                )
            )
            pos += length
        # wait for EVERY completion even after a failure (abandoned
        # aio writes still land), then record the size covering all
        # submitted extents so the landed pieces stay reachable by
        # read (as zeros-for-failed sparse ranges) and reclaimable by
        # remove — THEN surface the first error.
        first_err = None
        for c in comps:
            try:
                c.wait_for_complete()
            except Exception as e:
                first_err = first_err or e
        self._bump_size(oid, offset + len(data))
        if first_err is not None:
            raise first_err

    def read(self, oid: str, offset: int = 0, length: int | None = None) -> bytes:
        # clamp to the logical size (raises for absent objects): reads
        # past EOF short-read like rados, never fabricate zeros, and
        # absence is an error, not a hole
        size = self.stat(oid)
        if offset >= size:
            return b""
        length = size - offset if length is None else min(
            length, size - offset
        )
        out = bytearray(length)
        runs = self._extents(offset, length)
        comps = [
            self.io.aio_read(self._piece(oid, idx), obj_off, run)
            for idx, obj_off, run in runs
        ]
        pos = 0
        for (idx, obj_off, run), c in zip(runs, comps):
            try:
                buf = c.wait_for_complete().data
            except FileNotFoundError:
                buf = b""
            out[pos:pos + len(buf)] = buf  # holes stay zero
            pos += run
        return bytes(out)

    def stat(self, oid: str) -> int:
        """Logical size from the metadata piece (the reference stores
        striper size as an xattr on the first object — same role: a
        sparse write can skip whole object sets, so piece probing
        cannot bound the scan)."""
        try:
            return int(self.io.read(self._meta(oid)).decode())
        except FileNotFoundError:
            raise FileNotFoundError(oid) from None

    def _meta(self, oid: str) -> str:
        return f"{oid}.meta"

    def _bump_size(self, oid: str, end: int) -> None:
        try:
            cur = int(self.io.read(self._meta(oid)).decode())
        except FileNotFoundError:
            cur = -1
        if end > cur:
            self.io.write_full(self._meta(oid), str(end).encode())

    def remove(self, oid: str) -> None:
        size = self.stat(oid)  # FileNotFoundError if absent
        last_idx, _ = self._to_object(max(size - 1, 0))
        last_set = last_idx // self.sc
        for idx in range((last_set + 1) * self.sc):
            try:
                self.io.remove(self._piece(oid, idx))
            except FileNotFoundError:
                pass  # sparse: this piece was never written
        self.io.remove(self._meta(oid))
