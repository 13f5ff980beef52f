"""DeviceFS — the BlueFS analog: the KV store's WAL and snapshot
hosted INSIDE the BlockStore raw device.

The reference's BlueStore is single-device self-contained because
BlueFS (os/bluestore/BlueFS.h:253) carves RocksDB's WAL and SSTs out
of the same block device the data lives on, sharing space with the
data allocator. Round 4 shipped a BlockStore whose KV metadata WAL
and snapshot were separate host files — this module closes that gap
(VERDICT r4 item 6).

Layout:

- **Superblock pair** at device blocks 0 and 1 (A/B): a crc-framed
  JSON table {seq, wal_epoch, wal extents, snap extents, snap_len}.
  Updates write the OLDER copy then fsync — the valid superblock is
  the highest-seq copy whose crc checks (atomic by alternation, the
  classic double-superblock commit).
- **WAL**: frames (framed_log format, so torn tails self-detect)
  written sequentially into extents allocated from the SAME allocator
  as object data. Each frame's payload is prefixed with the current
  ``wal_epoch``; logical truncation is just ``wal_epoch += 1`` in the
  superblock — stale frames are filtered at replay, so compaction
  never rewrites the log region.
- **Snapshot**: written to freshly allocated extents, then the
  superblock swaps to them (and bumps wal_epoch) in one update; the
  old snapshot extents are freed after the swap. Crash before the
  swap: old snapshot + old epoch -> old WAL replays. Crash after:
  new snapshot + new epoch -> old frames filtered. No torn state.

Allocation goes through the owning BlockStore's allocator with a
large minimum grant (256 KiB) so the extent tables stay tiny and the
superblock fits one block forever.
"""

from __future__ import annotations

import json
import struct
import zlib

SUPER_MAGIC = b"CTFS"
SUPER_VERSION = 1
_SUPER_HDR2 = struct.Struct("<4sIQII")  # magic, version, seq, len, crc
_FRAME_HDR = struct.Struct("<II")     # payload len, crc32 of payload
_EPOCH = struct.Struct("<Q")

#: allocation granule for WAL/snapshot extents: big grants keep the
#: extent tables O(1) and the superblock single-block
GRANT = 256 * 1024


class DeviceFSError(IOError):
    pass


class DeviceFS:
    """WAL + snapshot files hosted in reserved extents of one device.

    The owner provides raw read/write callables and an allocate/free
    pair (the shared data allocator). Two fixed blocks at the device
    head hold the superblock pair; everything else is extents."""

    def __init__(
        self,
        dev_read,
        dev_write,
        dev_sync,
        block_size: int,
        allocate,
        free,
    ) -> None:
        self._read = dev_read
        self._write = dev_write
        self._sync = dev_sync
        self.block_size = block_size
        self._allocate = allocate   # (length) -> list[(off, len)]
        self._free = free           # (off, len) -> None
        self.seq = 0
        self.wal_epoch = 0
        self.wal_extents: list[tuple[int, int]] = []
        self.snap_extents: list[tuple[int, int]] = []
        self.snap_len = 0
        self._wal_pos = 0  # logical append offset within wal extents
        self._active_slot = 0  # which superblock copy holds `seq`

    # -- superblock -----------------------------------------------------
    def _sb_offset(self, slot: int) -> int:
        return slot * self.block_size

    def reserved_extents(self) -> list[tuple[int, int]]:
        """Every device range this filesystem owns (for freelist
        rebuilds): the superblock pair + all file extents."""
        out = [(0, 2 * self.block_size)]
        out.extend(self.wal_extents)
        out.extend(self.snap_extents)
        return out

    def _encode_super(self, seq: int, staged: dict) -> bytes:
        payload = json.dumps({
            "wal_epoch": staged["wal_epoch"],
            "wal": [list(e) for e in staged["wal_extents"]],
            "snap": [list(e) for e in staged["snap_extents"]],
            "snap_len": staged["snap_len"],
        }).encode()
        hdr = _SUPER_HDR2.pack(
            SUPER_MAGIC, SUPER_VERSION, seq, len(payload),
            zlib.crc32(payload),
        )
        blob = hdr + payload
        if len(blob) > self.block_size:
            raise DeviceFSError(
                f"superblock {len(blob)}B exceeds one block — extent "
                "tables should never fragment this far (GRANT sizing)"
            )
        return blob.ljust(self.block_size, b"\x00")

    @staticmethod
    def _decode_super(raw: bytes):
        if len(raw) < _SUPER_HDR2.size:
            return None
        magic, ver, seq, plen, crc = _SUPER_HDR2.unpack_from(raw, 0)
        if magic != SUPER_MAGIC or ver != SUPER_VERSION:
            return None
        payload = raw[_SUPER_HDR2.size : _SUPER_HDR2.size + plen]
        if len(payload) != plen or zlib.crc32(payload) != crc:
            return None
        try:
            obj = json.loads(payload.decode())
        except ValueError:
            return None
        return seq, obj

    def _write_super(self, **changes) -> None:
        """Commit the table with ``changes`` applied: encode FIRST
        (any overflow raises with nothing mutated), write the
        INACTIVE copy, sync, and only then adopt the staged state
        in memory. The higher-seq valid copy wins at load, so a torn
        write of this copy leaves the other one authoritative — and
        a raised write leaves the in-memory view matching the durable
        one (a memory-ahead-of-disk epoch once silently discarded
        acked post-failure WAL frames on replay)."""
        staged = {
            f: getattr(self, f)
            for f in ("wal_epoch", "wal_extents", "snap_extents",
                      "snap_len")
        }
        staged.update(changes)
        seq = self.seq + 1
        blob = self._encode_super(seq, staged)
        slot = 1 - self._active_slot
        self._write(self._sb_offset(slot), blob)
        self._sync()
        self.seq = seq
        self._active_slot = slot
        for f, v in staged.items():
            setattr(self, f, v)

    def format(self) -> None:
        """Fresh filesystem: both superblock copies zeroed, then copy
        0 written with the empty table."""
        self._write(0, b"\x00" * (2 * self.block_size))
        self.seq = 0
        self.wal_epoch = 0
        self.wal_extents = []
        self.snap_extents = []
        self.snap_len = 0
        self._wal_pos = 0
        self._active_slot = 1  # so _write_super lands in slot 0
        self._write_super()

    @classmethod
    def probe(cls, dev_read, block_size: int) -> bool:
        """Does the device carry a DeviceFS superblock?"""
        for slot in (0, 1):
            raw = dev_read(slot * block_size, block_size)
            if cls._decode_super(raw) is not None:
                return True
        return False

    def load(self) -> None:
        best = None
        for slot in (0, 1):
            raw = self._read(self._sb_offset(slot), self.block_size)
            dec = self._decode_super(raw)
            if dec is not None and (best is None or dec[0] > best[0][0]):
                best = (dec, slot)
        if best is None:
            raise DeviceFSError("no valid DeviceFS superblock")
        (seq, obj), slot = best
        self.seq = seq
        self._active_slot = slot
        self.wal_epoch = obj["wal_epoch"]
        self.wal_extents = [tuple(e) for e in obj["wal"]]
        self.snap_extents = [tuple(e) for e in obj["snap"]]
        self.snap_len = obj["snap_len"]
        self._wal_pos = 0  # recomputed by replay()

    # -- extent-mapped IO ----------------------------------------------
    @staticmethod
    def _map(extents, pos: int, length: int):
        """(device offset, run length) pieces for a logical range."""
        out = []
        logical = 0
        for off, ln in extents:
            if length <= 0:
                break
            if pos < logical + ln:
                inner = max(0, pos - logical)
                take = min(ln - inner, length)
                out.append((off + inner, take))
                pos += take
                length -= take
            logical += ln
        if length > 0:
            raise DeviceFSError("range beyond file extents")
        return out

    def _file_write(self, extents, pos: int, data: bytes) -> None:
        for off, ln in self._map(extents, pos, len(data)):
            self._write(off, data[:ln])
            data = data[ln:]

    def _file_read(self, extents, pos: int, length: int) -> bytes:
        return b"".join(
            self._read(off, ln)
            for off, ln in self._map(extents, pos, length)
        )

    @staticmethod
    def _cap(extents) -> int:
        return sum(ln for _, ln in extents)

    # -- WAL ------------------------------------------------------------
    def wal_append(self, payload: bytes) -> None:
        """One framed record, epoch-prefixed, extents grown on demand
        (superblock updates ONLY when extents are added — the steady-
        state append path writes just the frame)."""
        body = _EPOCH.pack(self.wal_epoch) + payload
        frame = _FRAME_HDR.pack(len(body), zlib.crc32(body)) + body
        need = self._wal_pos + len(frame) - self._cap(self.wal_extents)
        if need > 0:
            grants = [tuple(g) for g in self._allocate(max(need, GRANT))]
            try:
                self._write_super(
                    wal_extents=self.wal_extents + grants
                )
            except Exception:
                for off, ln in grants:
                    self._free(off, ln)
                raise
        self._file_write(self.wal_extents, self._wal_pos, frame)
        self._sync()
        self._wal_pos += len(frame)

    def wal_replay(self) -> list[bytes]:
        """Valid current-epoch frames, in order; stops at the first
        torn/stale frame (the framed_log torn-tail rule). Also leaves
        ``_wal_pos`` at the append position."""
        out = []
        cap = self._cap(self.wal_extents)
        pos = 0
        while pos + _FRAME_HDR.size <= cap:
            hdr = self._file_read(self.wal_extents, pos, _FRAME_HDR.size)
            ln, crc = _FRAME_HDR.unpack(hdr)
            if ln == 0 or pos + _FRAME_HDR.size + ln > cap:
                break
            body = self._file_read(
                self.wal_extents, pos + _FRAME_HDR.size, ln
            )
            if zlib.crc32(body) != crc or len(body) < _EPOCH.size:
                break
            (epoch,) = _EPOCH.unpack_from(body, 0)
            if epoch != self.wal_epoch:
                break  # pre-compaction leftovers
            out.append(body[_EPOCH.size :])
            pos += _FRAME_HDR.size + ln
        self._wal_pos = pos
        return out

    # -- snapshot -------------------------------------------------------
    def snap_read(self) -> bytes | None:
        if not self.snap_extents or self.snap_len == 0:
            return None
        return self._file_read(self.snap_extents, 0, self.snap_len)

    def snap_commit(self, snapshot: bytes) -> None:
        """Durable snapshot + logical WAL truncation in ONE superblock
        swap: write the new snapshot into fresh extents, sync, then
        flip the table (new snap extents, wal_epoch+1). Old snapshot
        extents are freed after the flip; a crash OR a raised write at
        any point leaves either the complete old state or the
        complete new one (in memory too — _write_super adopts its
        staged fields only after the sync returns).

        The GRANT floor on the allocation keeps the extent table
        short even on a fragmented freelist — the superblock must fit
        one block forever, and _encode_super refuses (harmlessly,
        pre-mutation: the WAL just keeps growing until the next
        attempt) rather than overflow."""
        new_extents = [
            tuple(g)
            for g in self._allocate(max(len(snapshot), GRANT))
        ]
        try:
            self._file_write(new_extents, 0, snapshot)
            self._sync()
            old = self.snap_extents
            self._write_super(
                snap_extents=new_extents,
                snap_len=len(snapshot),
                wal_epoch=self.wal_epoch + 1,
            )
        except Exception:
            for off, ln in new_extents:
                self._free(off, ln)
            raise
        for off, ln in old:
            self._free(off, ln)
        self._wal_pos = 0
