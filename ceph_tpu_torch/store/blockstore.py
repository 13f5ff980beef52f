"""BlockStore — the BlueStore analog: objects on a raw block device.

Mirrors BlueStore's structural shape (src/os/bluestore/BlueStore.cc):

- **one flat device** (a preallocated file standing in for the raw
  block device) holds all object data as allocator-granted extents;
- **metadata lives in the embedded KV store, not in a filesystem**:
  onodes (oid → blob list + attrs) are rows in ``store.kvstore``
  under the "O" prefix — the BlueStore-onodes-in-RocksDB architecture
  (BlueStore.cc keeps onodes/omap in RocksDB column families). Each
  transaction batch commits ONE KV batch containing only the onodes
  it touched (delta commits, not a full-table dump); the KV store's
  own WAL + snapshot compaction provide recovery;
- **allocator-managed free space** (Btree/Bitmap/Hybrid — the
  reference's allocator family) rebuilt on open from the object table
  (the FreelistManager inversion: used = union of live blobs);
- **every blob carries a checksum**: crc32c per csum-block stored in
  the blob metadata and verified on every read (BlueStore::_verify_csum,
  BlueStore.cc:12878) — a flipped bit on the device surfaces as EIO,
  never as silently corrupt data. Blob csums come from TWO sources:
  a WRITE op carrying fused encode+csum kernel output (Op.csums —
  per-block crc32c that Kernel B computed on the card in the same
  launch as the EC encode) is adopted directly after a seed-shift
  XOR, so the hot write path hashes nothing on the host; every other
  write (unaligned ranges, partial tail blocks, non-EC callers)
  falls back to the host scalar path behind the Checksummer facade
  (checksum.crc32c_scalar, the native crc when it loads). Read-side
  verification always recomputes on the host facade — the store
  never trusts bytes it returns;
- transactions follow the same validated-atomic contract as
  MemStore/FileStore: the SAME store test suite runs over all three
  backends (the store_test.cc pattern).

Write path (BlueStore::queue_transactions shape, simplified to the
COW case): allocate fresh extents for the written range's blocks, write
+ fsync data, then commit the metadata record to the WAL — data blocks
are never overwritten in place, so a torn data write cannot damage
committed state (the deferred-write/COW discipline collapsed to
always-COW).
"""

from __future__ import annotations

import json
import os
import threading

from ceph_tpu_torch.checksum import crc32c_scalar as _crc
from ceph_tpu_torch.checksum import crc32c_seed_shift

from . import framed_log
from .allocator import ALLOCATORS, AllocError
from .devicefs import DeviceFS
from .kvstore import DeviceKVBackend, KeyValueDB
from .transaction import Op, OpKind, Transaction
from ceph_tpu_torch.utils.lockdep import DebugLock

#: KV prefixes (the column-family layout, BlueStore PREFIX_* style):
#: O = onodes, S = store-wide state (committed seq)
PREFIX_ONODE = "O"
PREFIX_STATE = "S"

CSUM_SEED = 0xFFFFFFFF


class _Blob:
    """One contiguous stored run: device extent + per-block csums."""

    __slots__ = ("offset", "length", "csums")

    def __init__(self, offset: int, length: int, csums: list[int]) -> None:
        self.offset = offset  # device offset
        self.length = length
        self.csums = csums    # crc32c per csum block

    def to_obj(self):
        return [self.offset, self.length, self.csums]

    @classmethod
    def from_obj(cls, o):
        return cls(o[0], o[1], list(o[2]))


class _Onode:
    """Object metadata (the BlueStore Onode): logical block map."""

    __slots__ = ("size", "blobs", "attrs")

    def __init__(self) -> None:
        self.size = 0
        self.blobs: dict[int, _Blob] = {}  # logical block off -> blob
        self.attrs: dict[str, bytes] = {}

    def to_obj(self):
        return {
            "size": self.size,
            "blobs": {str(k): b.to_obj() for k, b in self.blobs.items()},
            "attrs": {k: v.hex() for k, v in self.attrs.items()},
        }

    @classmethod
    def from_obj(cls, o):
        n = cls()
        n.size = o["size"]
        n.blobs = {int(k): _Blob.from_obj(b) for k, b in o["blobs"].items()}
        n.attrs = {k: bytes.fromhex(v) for k, v in o["attrs"].items()}
        return n


class CsumError(IOError):
    """Stored data failed checksum verification (the EIO surface of
    BlueStore::_verify_csum)."""


class BlockStore:
    """ObjectStore over one raw device file."""

    def __init__(
        self,
        root: str,
        size: int = 1 << 28,
        block_size: int = 4096,
        csum_block: int = 4096,
        allocator: str = "hybrid",
        name: str = "blockstore",
        checkpoint_every: int = 256,
    ) -> None:
        self.name = name
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.block_size = block_size
        self.csum_block = csum_block
        self.checkpoint_every = checkpoint_every
        self.device_path = os.path.join(root, "block")
        self.wal_path = os.path.join(root, "meta.wal")      # legacy
        self.ckpt_path = os.path.join(root, "meta.ckpt")    # legacy
        self._lock = DebugLock("store.block", rank=60)
        self.committed_seq = 0
        if not os.path.exists(self.device_path):
            with open(self.device_path, "wb") as f:
                f.truncate(size)
        # r+b, NOT a+b: append mode would ignore seeks on write
        self._dev = open(self.device_path, "r+b")
        self.device_size = os.path.getsize(self.device_path)
        self._objects: dict[str, _Onode] = {}
        # -- metadata home: DeviceFS (the BlueFS analog) hosts the KV
        # WAL/snapshot in reserved extents of THIS device, so the
        # store is single-device self-contained (BlueFS.h:253). A
        # store that already has host-file KV data keeps that legacy
        # layout (its device blocks 0-1 may hold object data).
        self._fs = None
        legacy_kv = any(
            os.path.exists(p)
            for p in (
                os.path.join(root, "kv.wal"),
                os.path.join(root, "kv.snap"),
                self.wal_path,
                self.ckpt_path,
            )
        )
        fs = DeviceFS(
            self._dev_read, self._dev_write, self._dev_sync,
            block_size,
            lambda n: self.allocator.allocate(n),
            lambda off, ln: self.allocator.release([(off, ln)]),
        )
        if DeviceFS.probe(self._dev_read, block_size):
            fs.load()
            self._fs = fs
        elif not legacy_kv:
            fs.format()
            self._fs = fs
        backend = DeviceKVBackend(self._fs) if self._fs else None
        # distinct "kv" namespace: the legacy format owned meta.wal
        self._kvdb = KeyValueDB(
            root, name="kv", compact_every=checkpoint_every,
            backend=backend,
        )
        self._load_metadata()
        self.allocator = ALLOCATORS[allocator](block_size)
        self._rebuild_freelist()

    # -- metadata persistence (onodes as KV rows) ----------------------
    def _load_metadata(self) -> None:
        self._import_legacy_metadata()
        raw_seq = self._kvdb.get(PREFIX_STATE, "seq")
        self.committed_seq = int(raw_seq) if raw_seq else 0
        self._objects = {
            oid: _Onode.from_obj(json.loads(raw))
            for oid, raw in self._kvdb.iterate(PREFIX_ONODE)
        }

    def _import_legacy_metadata(self) -> None:
        """One-shot upgrade from the pre-KV format (full-table JSON
        checkpoint + WAL records) into KV rows — the format-migration
        discipline BlueStore applies between its own metadata
        revisions. Legacy files are removed once their content is
        durable in the KV store."""
        if not (
            os.path.exists(self.ckpt_path) or os.path.exists(self.wal_path)
        ):
            return
        raw_kv_seq = self._kvdb.get(PREFIX_STATE, "seq")
        kv_seq = int(raw_kv_seq) if raw_kv_seq else -1
        seq, objects = 0, {}
        if os.path.exists(self.ckpt_path):
            with open(self.ckpt_path) as f:
                snap = json.load(f)
            seq, objects = snap["seq"], dict(snap["objects"])
        for payload in framed_log.replay(self.wal_path):
            rec = json.loads(payload.decode())
            if rec["seq"] > seq:
                seq, objects = rec["seq"], dict(rec["objects"])
        if kv_seq >= seq:
            # An earlier migration already absorbed this content (we
            # crashed between the two removes below): importing again
            # from a STALE checkpoint would rewind the KV rows past
            # acked transactions. Just finish the cleanup.
            for path in (self.wal_path, self.ckpt_path):
                if os.path.exists(path):
                    os.remove(path)
            return
        txn = self._kvdb.transaction()
        txn.rmkeys_by_prefix(PREFIX_ONODE)
        for oid, obj in objects.items():
            txn.set(PREFIX_ONODE, oid, json.dumps(obj).encode())
        txn.set(PREFIX_STATE, "seq", str(seq).encode())
        self._kvdb.submit_transaction(txn)
        self._kvdb.compact()  # durable snapshot before dropping legacy
        # WAL first: if we crash between the removes, a surviving ckpt
        # re-imports the same content (idempotent); a surviving EMPTY
        # wal alone would re-import nothing and wipe the rows.
        for path in (self.wal_path, self.ckpt_path):
            if os.path.exists(path):
                os.remove(path)

    def _commit_metadata(self, staged: "dict[str, _Onode | None]") -> None:
        """One KV batch per transaction batch, containing ONLY the
        onodes this batch touched (delta commits — the reason the
        metadata tier is a KV store and not a journaled table dump)."""
        self.committed_seq += 1
        txn = self._kvdb.transaction()
        for oid, onode in staged.items():
            if onode is None:
                txn.rmkey(PREFIX_ONODE, oid)
            else:
                txn.set(
                    PREFIX_ONODE, oid, json.dumps(onode.to_obj()).encode()
                )
        txn.set(PREFIX_STATE, "seq", str(self.committed_seq).encode())
        self._kvdb.submit_transaction(txn)

    def _rebuild_freelist(self) -> None:
        """FreelistManager inversion: free = device minus live blobs
        minus the DeviceFS's own extents (superblocks + KV WAL/snap —
        the BlueFS space-sharing arrangement)."""
        used: list[tuple[int, int]] = []
        for onode in self._objects.values():
            for blob in onode.blobs.values():
                n_blocks = -(-blob.length // self.block_size)
                used.append((blob.offset, n_blocks * self.block_size))
        if self._fs is not None:
            for off, ln in self._fs.reserved_extents():
                n_blocks = -(-ln // self.block_size)
                used.append((off, n_blocks * self.block_size))
        used.sort()
        pos = 0
        for off, ln in used:
            if off > pos:
                self.allocator.init_add_free(pos, off - pos)
            pos = max(pos, off + ln)
        if pos < self.device_size:
            self.allocator.init_add_free(pos, self.device_size - pos)

    # -- device IO ------------------------------------------------------
    def _dev_write(self, offset: int, data: bytes) -> None:
        self._dev.seek(offset)
        self._dev.write(data)

    def _dev_read(self, offset: int, length: int) -> bytes:
        self._dev.seek(offset)
        return self._dev.read(length)

    def _dev_sync(self) -> None:
        self._dev.flush()
        os.fsync(self._dev.fileno())

    def _csum(self, data: bytes) -> list[int]:
        out = []
        for i in range(0, len(data), self.csum_block):
            out.append(_crc(CSUM_SEED, data[i : i + self.csum_block]))
        return out

    # -- transaction application ---------------------------------------
    def queue_transactions(
        self, txns: "list[Transaction] | Transaction"
    ) -> int:
        if isinstance(txns, Transaction):
            txns = [txns]
        with self._lock:
            staged = {
                oid: self._clone_onode(oid)
                for txn in txns
                for oid in {op.oid for op in txn.ops}
            }
            freed: list[tuple[int, int]] = []
            allocated: list[tuple[int, int]] = []
            try:
                for txn in txns:
                    for op in txn.ops:
                        self._apply_op(op, staged, freed, allocated)
            except Exception:
                self.allocator.release(allocated)
                raise
            self._dev.flush()
            os.fsync(self._dev.fileno())
            for oid, onode in staged.items():
                if onode is None:
                    self._objects.pop(oid, None)
                else:
                    self._objects[oid] = onode
            self._commit_metadata(staged)
            # old blocks join the freelist only AFTER the metadata that
            # stops referencing them is durable (COW discipline)
            self.allocator.release(freed)
            return self.committed_seq

    def _clone_onode(self, oid: str) -> "_Onode | None":
        cur = self._objects.get(oid)
        if cur is None:
            return None
        n = _Onode()
        n.size = cur.size
        n.blobs = dict(cur.blobs)  # blobs are immutable (COW)
        n.attrs = dict(cur.attrs)
        return n

    def _get(self, staged, oid: str, create: bool) -> "_Onode | None":
        onode = staged.get(oid)
        if onode is None and create:
            onode = _Onode()
            staged[oid] = onode
        return onode

    def _apply_op(self, op: Op, staged, freed, allocated) -> None:
        bs = self.block_size
        if op.kind is OpKind.TOUCH:
            self._get(staged, op.oid, create=True)
        elif op.kind is OpKind.WRITE:
            onode = self._get(staged, op.oid, create=True)
            self._write_range(
                onode, op.offset, op.data, freed, allocated,
                csums=op.csums, csum_block=op.csum_block,
            )
            onode.size = max(onode.size, op.offset + len(op.data))
        elif op.kind is OpKind.ZERO:
            onode = self._get(staged, op.oid, create=True)
            self._write_range(
                onode, op.offset, b"\0" * op.length, freed, allocated
            )
            onode.size = max(onode.size, op.offset + op.length)
        elif op.kind is OpKind.TRUNCATE:
            onode = self._get(staged, op.oid, create=True)
            if op.offset < onode.size:
                for boff in sorted(onode.blobs):
                    blob = onode.blobs.get(boff)
                    if blob is None:
                        continue
                    if boff >= op.offset:
                        onode.blobs.pop(boff)
                        n = -(-blob.length // bs)
                        freed.append((blob.offset, n * bs))
                    elif boff + blob.length > op.offset:
                        # straddling blob: trim it, or its stale tail
                        # bytes would resurface when the object is
                        # later zero-extended past the cut
                        head = self._blob_bytes(blob)[: op.offset - boff]
                        onode.blobs.pop(boff)
                        n = -(-blob.length // bs)
                        freed.append((blob.offset, n * bs))
                        self._store_run(onode, boff, head, allocated)
            onode.size = op.offset
        elif op.kind is OpKind.REMOVE:
            onode = staged.get(op.oid)
            if onode is None:
                raise FileNotFoundError(op.oid)
            for blob in onode.blobs.values():
                n = -(-blob.length // bs)
                freed.append((blob.offset, n * bs))
            staged[op.oid] = None
        elif op.kind is OpKind.SETATTR:
            onode = self._get(staged, op.oid, create=True)
            onode.attrs[op.name] = op.data
        elif op.kind in (OpKind.RMATTR, OpKind.RMATTR_TOLERANT):
            onode = staged.get(op.oid)
            if onode is None or op.name not in onode.attrs:
                if op.kind is OpKind.RMATTR_TOLERANT:
                    self._get(staged, op.oid, create=True)
                    return
                raise KeyError(f"{op.oid}:{op.name}")
            del onode.attrs[op.name]

    def _write_range(
        self, onode: _Onode, offset: int, data: bytes, freed, allocated,
        csums=None, csum_block: int = 0,
    ) -> None:
        """COW block write: the touched blocks are rewritten to fresh
        extents; partial head/tail blocks merge old content first.

        ``csums``: optional kernel-produced ZERO-INIT per-block crc32c
        of ``data`` (fused encode+csum). Adopted only when they
        describe the stored blocks exactly — block-aligned offset and
        length at this store's csum granularity, no boundary merge —
        else the host facade re-hashes (partial tail blocks always
        fall back: crc(partial) != crc(zero-padded block))."""
        if not data:
            return
        bs = self.block_size
        lo = (offset // bs) * bs
        hi = -(-(offset + len(data)) // bs) * bs
        provided = None
        if (
            csums is not None
            and csum_block == self.csum_block
            and bs % self.csum_block == 0
            and offset == lo
            and offset + len(data) == hi
            and len(csums) * self.csum_block == len(data)
        ):
            shift = self._csum_seed_shift()
            provided = [int(v) ^ shift for v in csums]
        buf = bytearray(hi - lo)
        # Preserve surrounding bytes of PARTIALLY covered boundary
        # blocks only. A fully covered block is never read — so a
        # full-block overwrite can REPLACE a corrupt blob (scrub
        # repair) instead of tripping on its checksum.
        if offset > lo:
            buf[:bs] = self._read_onode(onode, lo, bs).ljust(bs, b"\0")
        if offset + len(data) < hi:
            buf[-bs:] = self._read_onode(onode, hi - bs, bs).ljust(bs, b"\0")
        buf[offset - lo : offset - lo + len(data)] = data
        extents = self.allocator.allocate(hi - lo)
        allocated.extend(extents)
        # drop the old blobs covering [lo, hi)
        for boff in sorted(onode.blobs):
            blob = onode.blobs[boff]
            bend = boff + blob.length
            if bend <= lo or boff >= hi:
                continue
            del onode.blobs[boff]
            n = -(-blob.length // bs)
            freed.append((blob.offset, n * bs))
            # resurrect the parts outside [lo, hi) by re-writing them
            # into the new buffer's window... they are already there
            # via _read_onode for boundary blocks; interior fully
            # overwritten. Blobs never span the window boundary beyond
            # one block because writes are block-granular COW.
            if boff < lo:
                head = self._blob_bytes(blob)[: lo - boff]
                self._store_run(onode, boff, head, allocated)
            if bend > hi:
                tail = self._blob_bytes(blob)[hi - boff :]
                self._store_run(onode, hi, tail, allocated)
        pos = 0
        cb = self.csum_block
        for dev_off, ln in extents:
            chunk = bytes(buf[pos : pos + ln])
            self._dev_write(dev_off, chunk)
            self._store_blob(
                onode, lo + pos, dev_off, chunk,
                provided[pos // cb : (pos + ln) // cb]
                if provided is not None else None,
            )
            pos += ln

    def _store_run(self, onode, logical_off, data, allocated) -> None:
        if not data:
            return
        extents = self.allocator.allocate(len(data))
        allocated.extend(extents)
        pos = 0
        for dev_off, ln in extents:
            chunk = bytes(data[pos : pos + ln])
            self._dev_write(dev_off, chunk)
            self._store_blob(onode, logical_off + pos, dev_off, chunk)
            pos += ln

    def _store_blob(
        self, onode, logical_off, dev_off, data, csums=None
    ) -> None:
        onode.blobs[logical_off] = _Blob(
            dev_off, len(data),
            list(csums) if csums is not None else self._csum(data),
        )

    def _csum_seed_shift(self) -> int:
        """crc(CSUM_SEED, B) = crc(0, B) ^ this, for any csum block —
        converts the fused kernel's zero-init csums to this store's
        seed with one XOR per block (no bytes re-hashed)."""
        if not hasattr(self, "_seed_shift"):
            self._seed_shift = crc32c_seed_shift(
                self.csum_block, CSUM_SEED
            )
        return self._seed_shift

    def _blob_read_verified(
        self, blob: _Blob, rel_off: int, rel_len: int
    ) -> bytes:
        """Read a range WITHIN a blob, verifying only the touched csum
        blocks (BlueStore::_verify_csum checks the read's blocks, not
        the whole blob). EVERY path that consumes stored bytes goes
        through here — including internal ones like truncate's trim —
        so corruption can never be re-checksummed into a fresh blob."""
        cb = self.csum_block
        blk_lo = rel_off // cb
        blk_hi = -(-(rel_off + rel_len) // cb)
        win_lo = blk_lo * cb
        win_len = min(blk_hi * cb, blob.length) - win_lo
        raw = self._dev_read(blob.offset + win_lo, win_len)
        for i in range(blk_lo, blk_hi):
            got = _crc(
                CSUM_SEED,
                raw[(i - blk_lo) * cb : (i - blk_lo + 1) * cb],
            )
            if got != blob.csums[i]:
                raise CsumError(
                    f"csum mismatch at blob +{i * cb} (dev "
                    f"{blob.offset:#x}): got {got:#x} want "
                    f"{blob.csums[i]:#x}"
                )
        return raw[rel_off - win_lo : rel_off - win_lo + rel_len]

    def _blob_bytes(self, blob: _Blob) -> bytes:
        return self._blob_read_verified(blob, 0, blob.length)

    def _read_onode(self, onode: _Onode, offset: int, length: int) -> bytes:
        """Assemble + VERIFY a logical range from the blob map; holes
        read as zeros; only the touched csum blocks are checked."""
        out = bytearray(length)
        for boff in sorted(onode.blobs):
            blob = onode.blobs[boff]
            bend = boff + blob.length
            s = max(boff, offset)
            e = min(bend, offset + length)
            if s >= e:
                continue
            out[s - offset : e - offset] = self._blob_read_verified(
                blob, s - boff, e - s
            )
        return bytes(out)

    # -- read path (MemStore-identical contract) ------------------------
    def exists(self, oid: str) -> bool:
        with self._lock:
            return oid in self._objects

    def stat(self, oid: str) -> int:
        with self._lock:
            onode = self._objects.get(oid)
            if onode is None:
                raise FileNotFoundError(oid)
            return onode.size

    def read(self, oid: str, offset: int = 0, length: int | None = None) -> bytes:
        with self._lock:
            onode = self._objects.get(oid)
            if onode is None:
                raise FileNotFoundError(oid)
            if length is None:
                length = max(onode.size - offset, 0)
            length = max(min(length, onode.size - offset), 0)
            return self._read_onode(onode, offset, length)

    def getattr(self, oid: str, name: str) -> bytes:
        with self._lock:
            onode = self._objects.get(oid)
            if onode is None:
                raise FileNotFoundError(oid)
            if name not in onode.attrs:
                raise KeyError(f"{oid}:{name}")
            return onode.attrs[name]

    def getattrs(self, oid: str) -> dict[str, bytes]:
        with self._lock:
            onode = self._objects.get(oid)
            if onode is None:
                raise FileNotFoundError(oid)
            return dict(onode.attrs)

    def list_objects(self) -> list[str]:
        with self._lock:
            return sorted(self._objects)

    def close(self) -> None:
        with self._lock:
            self._kvdb.compact()
            self._dev.close()

    def __repr__(self) -> str:
        return (
            f"BlockStore({self.root!r}, objects={len(self._objects)}, "
            f"free={self.allocator.get_free()})"
        )
