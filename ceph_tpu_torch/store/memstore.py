"""In-memory object store — the ``MemStore`` analog (src/os/memstore/).

One ``MemStore`` instance plays the role of one OSD shard's local
store in pipeline tests (the reference boots MemStore-backed OSDs for
exactly this, src/test/objectstore/store_test.cc). Objects are dense
byte buffers plus an attr map; transactions apply atomically —
validated first, then applied, so a failing op leaves no partial
state (stricter than the reference's assert-on-error, deliberately:
a functional-style store suits a replayable pipeline).
"""

from __future__ import annotations

import threading

from .transaction import Op, OpKind, Transaction
from ceph_tpu_torch.utils import tracer
from ceph_tpu_torch.utils.lockdep import DebugLock


class _Object:
    __slots__ = ("data", "attrs")

    def __init__(self) -> None:
        self.data = bytearray()
        self.attrs: dict[str, bytes] = {}

    def clone(self) -> "_Object":
        o = _Object()
        o.data = bytearray(self.data)
        o.attrs = dict(self.attrs)
        return o


class MemStore:
    """oid -> object map with atomic transaction application."""

    def __init__(self, name: str = "memstore") -> None:
        self.name = name
        self._objects: dict[str, _Object] = {}
        self._lock = DebugLock("store.mem", rank=60)
        self.committed_seq = 0  # count of applied transactions

    @classmethod
    def from_snapshot(
        cls, name: str, objects: "dict[str, tuple[bytes, dict[str, bytes]]]"
    ) -> "MemStore":
        """A store holding ``objects`` ({oid: (bytes, {attr: bytes})}):
        state read out of another store (``list_objects``, ``read``,
        ``getattrs``), so two stores start from the same content."""
        store = cls(name)
        for oid, (data, attrs) in objects.items():
            obj = _Object()
            obj.data = bytearray(data)
            obj.attrs = dict(attrs)
            store._objects[oid] = obj
        return store

    # -- write path ----------------------------------------------------
    def queue_transactions(self, txns: list[Transaction] | Transaction) -> int:
        """Apply transactions atomically, in order; returns the commit
        sequence (the on_commit callback's context in the reference).
        Runs under the ``store_commit`` timer."""
        if isinstance(txns, Transaction):
            txns = [txns]
        with tracer.timer("store_commit"), self._lock:
            staged: dict[str, _Object | None] = {}

            def get(oid: str, create: bool) -> _Object | None:
                if oid not in staged:
                    cur = self._objects.get(oid)
                    staged[oid] = cur.clone() if cur is not None else None
                if staged[oid] is None and create:
                    staged[oid] = _Object()
                return staged[oid]

            for t in txns:
                for op in t.ops:
                    self._apply(op, get, staged)
            for oid, obj in staged.items():
                if obj is None:
                    self._objects.pop(oid, None)
                else:
                    self._objects[oid] = obj
            self.committed_seq += 1
            return self.committed_seq

    @staticmethod
    def _apply(op: Op, get, staged: dict) -> None:
        if op.kind is OpKind.TOUCH:
            get(op.oid, create=True)
            return
        if op.kind is OpKind.REMOVE:
            obj = get(op.oid, create=False)
            if obj is None:
                raise FileNotFoundError(op.oid)
            staged[op.oid] = None
            return
        if op.kind is OpKind.WRITE:
            obj = get(op.oid, create=True)
            end = op.offset + len(op.data)
            if len(obj.data) < end:
                obj.data.extend(b"\0" * (end - len(obj.data)))
            obj.data[op.offset:end] = op.data
            return
        if op.kind is OpKind.ZERO:
            obj = get(op.oid, create=True)
            end = op.offset + op.length
            if len(obj.data) < end:
                obj.data.extend(b"\0" * (end - len(obj.data)))
            obj.data[op.offset:end] = b"\0" * op.length
            return
        if op.kind is OpKind.TRUNCATE:
            obj = get(op.oid, create=True)
            size = op.offset
            if len(obj.data) > size:
                del obj.data[size:]
            else:
                obj.data.extend(b"\0" * (size - len(obj.data)))
            return
        if op.kind is OpKind.SETATTR:
            obj = get(op.oid, create=True)
            obj.attrs[op.name] = op.data
            return
        if op.kind in (OpKind.RMATTR, OpKind.RMATTR_TOLERANT):
            obj = get(op.oid, create=False)
            if obj is None or op.name not in obj.attrs:
                if op.kind is OpKind.RMATTR_TOLERANT:
                    get(op.oid, create=True)
                    return
                raise KeyError(f"{op.oid}:{op.name}")
            del obj.attrs[op.name]
            return

    # -- read path -----------------------------------------------------
    def exists(self, oid: str) -> bool:
        with self._lock:
            return oid in self._objects

    def stat(self, oid: str) -> int:
        """Object size in bytes; FileNotFoundError if absent."""
        with self._lock:
            obj = self._objects.get(oid)
            if obj is None:
                raise FileNotFoundError(oid)
            return len(obj.data)

    def read(self, oid: str, offset: int = 0, length: int | None = None) -> bytes:
        """Read a range; short if it extends past EOF (POSIX-style, as
        MemStore::read). FileNotFoundError if the object is absent.
        Runs under the ``store_read`` timer."""
        with tracer.timer("store_read"), self._lock:
            obj = self._objects.get(oid)
            if obj is None:
                raise FileNotFoundError(oid)
            if length is None:
                length = len(obj.data) - offset
            return bytes(obj.data[offset:offset + length])

    def getattr(self, oid: str, name: str) -> bytes:
        with self._lock:
            obj = self._objects.get(oid)
            if obj is None:
                raise FileNotFoundError(oid)
            if name not in obj.attrs:
                raise KeyError(f"{oid}:{name}")
            return obj.attrs[name]

    def getattrs(self, oid: str) -> dict[str, bytes]:
        with self._lock:
            obj = self._objects.get(oid)
            if obj is None:
                raise FileNotFoundError(oid)
            return dict(obj.attrs)

    def list_objects(self) -> list[str]:
        with self._lock:
            return sorted(self._objects)

    def __repr__(self) -> str:
        return f"MemStore({self.name!r}, objects={len(self._objects)})"
