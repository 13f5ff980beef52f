"""General key/value store — the RocksDBStore / KeyValueDB analog.

The reference funnels ALL metadata through one embedded KV database
(src/kv/KeyValueDB.h, RocksDBStore.{h,cc}): BlueStore keeps onodes,
omap, and its freelist in RocksDB column families; the monitor store
is a RocksDB too. The load-bearing API surface is small and mirrored
here:

- **prefixes** (the column-family role): every key lives under a short
  string prefix; iteration and bulk deletion are prefix-scoped.
- **batched transactions**: ``transaction()`` collects set/rmkey/
  rmkeys_by_prefix ops; ``submit_transaction`` applies them atomically
  and durably (one WAL record per batch).
- **sorted iterators**: ``iterate(prefix, start)`` yields (key, value)
  in key order — the lower_bound/next contract omap listing needs.

The storage engine is an LSM collapsed to its essentials: an in-memory
sorted table + a crc-framed WAL (store/framed_log — the same framing
the FileStore journal uses), compacted into a snapshot file when the
WAL grows past ``compact_every`` batches. Crash recovery = snapshot +
WAL replay with torn-tail truncation. Records are binary (length-
prefixed op tuples), not JSON: values are arbitrary bytes.

Wire format of one batch payload:
    <u32 nops> then per op:
    <u8 kind><u16 plen><u32 klen><u32 vlen><prefix><key><value>
    kind: 0=set, 1=rmkey, 2=rmkeys_by_prefix (key/value empty)
"""

from __future__ import annotations

import os
import struct
import threading

from . import framed_log
from ceph_tpu_torch.utils.lockdep import DebugLock

_BATCH_HDR = struct.Struct("<I")
_OP_HDR = struct.Struct("<BHII")

_SET, _RMKEY, _RMPREFIX = 0, 1, 2


class KVTransaction:
    """One atomic batch (KeyValueDB::Transaction)."""

    def __init__(self) -> None:
        self.ops: list[tuple[int, str, str, bytes]] = []

    def set(self, prefix: str, key: str, value: bytes) -> "KVTransaction":
        self.ops.append((_SET, prefix, key, bytes(value)))
        return self

    def rmkey(self, prefix: str, key: str) -> "KVTransaction":
        self.ops.append((_RMKEY, prefix, key, b""))
        return self

    def rmkeys_by_prefix(self, prefix: str) -> "KVTransaction":
        self.ops.append((_RMPREFIX, prefix, "", b""))
        return self

    def encode(self) -> bytes:
        out = bytearray(_BATCH_HDR.pack(len(self.ops)))
        for kind, prefix, key, value in self.ops:
            p, k = prefix.encode(), key.encode()
            out += _OP_HDR.pack(kind, len(p), len(k), len(value))
            out += p
            out += k
            out += value
        return bytes(out)

    @classmethod
    def decode(cls, payload: bytes) -> "KVTransaction":
        txn = cls()
        (nops,) = _BATCH_HDR.unpack_from(payload, 0)
        pos = _BATCH_HDR.size
        for _ in range(nops):
            kind, plen, klen, vlen = _OP_HDR.unpack_from(payload, pos)
            pos += _OP_HDR.size
            prefix = payload[pos : pos + plen].decode()
            pos += plen
            key = payload[pos : pos + klen].decode()
            pos += klen
            value = payload[pos : pos + vlen]
            pos += vlen
            txn.ops.append((kind, prefix, key, bytes(value)))
        if pos != len(payload):
            raise ValueError("trailing bytes in KV batch")
        return txn


class FileKVBackend:
    """Host-file durability tier: crc-framed WAL + snapshot file —
    the standalone KeyValueDB's storage (a monitor store, say). The
    BlockStore passes a DeviceFS-hosted backend instead, so ITS
    metadata lives on the raw device (the BlueFS arrangement)."""

    def __init__(self, root: str, name: str, sync: bool) -> None:
        os.makedirs(root, exist_ok=True)
        self.wal_path = os.path.join(root, f"{name}.wal")
        self.snap_path = os.path.join(root, f"{name}.snap")
        self.sync = sync

    def snap_read(self) -> "bytes | None":
        if not os.path.exists(self.snap_path):
            return None
        with open(self.snap_path, "rb") as f:
            return f.read()

    def wal_replay(self) -> list[bytes]:
        return framed_log.replay(self.wal_path)

    def wal_append(self, payload: bytes) -> None:
        framed_log.append(self.wal_path, payload, sync=self.sync)

    def snap_commit(self, snapshot: bytes) -> None:
        """Snapshot durable, THEN truncate the WAL (rename-before-
        truncate fsync ordering, as BlockStore._checkpoint)."""
        tmp = self.snap_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(snapshot)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snap_path)
        dirfd = os.open(
            os.path.dirname(self.snap_path) or ".", os.O_RDONLY
        )
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
        with open(self.wal_path, "wb") as wal:
            wal.flush()
            os.fsync(wal.fileno())


class DeviceKVBackend:
    """DeviceFS-hosted durability tier: WAL frames and snapshots live
    in reserved extents of the owning BlockStore's device (the BlueFS
    role, os/bluestore/BlueFS.h:253)."""

    def __init__(self, fs) -> None:
        self.fs = fs

    def snap_read(self) -> "bytes | None":
        return self.fs.snap_read()

    def wal_replay(self) -> list[bytes]:
        return self.fs.wal_replay()

    def wal_append(self, payload: bytes) -> None:
        self.fs.wal_append(payload)

    def snap_commit(self, snapshot: bytes) -> None:
        self.fs.snap_commit(snapshot)


class KeyValueDB:
    """Durable prefix-scoped KV store (RocksDBStore role)."""

    def __init__(
        self,
        root: str,
        name: str = "kv",
        compact_every: int = 512,
        sync: bool = True,
        backend=None,
    ) -> None:
        self.backend = backend or FileKVBackend(root, name, sync)
        self.compact_every = compact_every
        self.sync = sync
        self._lock = DebugLock("store.kv", rank=62)
        self._table: dict[tuple[str, str], bytes] = {}
        self._wal_batches = 0
        self._load()

    # -- recovery / compaction -----------------------------------------
    def _load(self) -> None:
        snap = self.backend.snap_read()
        if snap is not None:
            self._apply(KVTransaction.decode(snap))
        for payload in self.backend.wal_replay():
            self._apply(KVTransaction.decode(payload))
            self._wal_batches += 1
        # NO compaction here: the device backend's compaction
        # allocates extents through the owning store's allocator,
        # which is rebuilt only after this load returns (freelist
        # needs the onodes). An over-threshold WAL compacts on the
        # next submit instead.

    def _apply(self, txn: KVTransaction) -> None:
        for kind, prefix, key, value in txn.ops:
            if kind == _SET:
                self._table[(prefix, key)] = value
            elif kind == _RMKEY:
                self._table.pop((prefix, key), None)
            else:
                for pk in [
                    pk for pk in self._table if pk[0] == prefix
                ]:
                    del self._table[pk]

    def _compact(self) -> None:
        """Snapshot the table, then (logically) truncate the WAL —
        the backend makes the pair atomic its own way."""
        snap = KVTransaction()
        for (prefix, key), value in sorted(self._table.items()):
            snap.set(prefix, key, value)
        self.backend.snap_commit(snap.encode())
        self._wal_batches = 0

    # -- write side -----------------------------------------------------
    def transaction(self) -> KVTransaction:
        return KVTransaction()

    def submit_transaction(self, txn: KVTransaction) -> None:
        """Apply one batch atomically + durably (the WAL record hits
        disk before the in-memory table changes are visible)."""
        if not txn.ops:
            return
        with self._lock:
            self.backend.wal_append(txn.encode())
            self._apply(txn)
            self._wal_batches += 1
            if self._wal_batches >= self.compact_every:
                self._compact()

    # -- read side ------------------------------------------------------
    def get(self, prefix: str, key: str) -> bytes | None:
        with self._lock:
            return self._table.get((prefix, key))

    def get_multi(
        self, prefix: str, keys: list[str]
    ) -> dict[str, bytes]:
        with self._lock:
            out = {}
            for k in keys:
                v = self._table.get((prefix, k))
                if v is not None:
                    out[k] = v
            return out

    def iterate(
        self,
        prefix: str,
        start: str | None = None,
        end: str | None = None,
    ):
        """Sorted (key, value) pairs under ``prefix``; ``start`` is a
        lower bound (inclusive), ``end`` an upper bound (exclusive) —
        the iterator surface omap paging needs."""
        with self._lock:
            items = sorted(
                (k, v) for (p, k), v in self._table.items() if p == prefix
            )
        for k, v in items:
            if start is not None and k < start:
                continue
            if end is not None and k >= end:
                break
            yield k, v

    def compact(self) -> None:
        with self._lock:
            self._compact()

    def close(self) -> None:
        pass  # all state is durable at every return from submit
