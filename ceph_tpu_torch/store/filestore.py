"""File-backed object store with a write-ahead journal — the
persistent ObjectStore tier (the BlueStore role, simplified).

Mirrors the contract the pipelines consume (the ObjectStore subset of
os/ObjectStore.h: ``queue_transactions`` applying an atomic op list;
POSIX-short reads; attr maps) with BlueStore's durability shape
(SURVEY.md §5.4b): every transaction is serialized into an on-disk
journal (length + crc32c framed), fsync'd, THEN applied to the object
files, then retired. A crash between journal and apply replays the
journal on open — transactions are idempotent (write/zero/truncate/
setattr/rmattr/remove/touch), so at-least-once replay converges.

Layout under the root directory:

    journal.wal                  pending transactions (usually empty)
    objects/<hex(oid)>.bin       object data
    objects/<hex(oid)>.attrs     attr map (json, atomic tmp+rename)

The same test suite runs over MemStore and FileStore, the
store_test.cc pattern of the reference (one suite, every backend).
"""

from __future__ import annotations

import json
import os
import threading

from . import framed_log
from .transaction import Op, OpKind, Transaction
from ceph_tpu_torch.utils.lockdep import DebugLock


def _enc_name(oid: str) -> str:
    return oid.encode().hex()


class FileStore:
    def __init__(self, root: str, name: str = "filestore") -> None:
        self.name = name
        self.root = root
        self.objdir = os.path.join(root, "objects")
        os.makedirs(self.objdir, exist_ok=True)
        self.journal_path = os.path.join(root, "journal.wal")
        self._lock = DebugLock("store.file", rank=60)
        self.committed_seq = 0
        self._replay()

    # -- journal -------------------------------------------------------
    def _replay(self) -> None:
        """Apply any transactions that were journaled but not retired
        (crash recovery — the BlueStore WAL replay role). Replay is
        at-least-once: ops tolerate already-applied state (a REMOVE of
        a gone object is a no-op here, unlike the strict live path)."""
        if not os.path.exists(self.journal_path):
            return
        touched: set[str] = set()
        for payload in framed_log.replay(self.journal_path):
            txn = Transaction.from_bytes(payload)
            self._apply(txn, strict=False)
            touched.update(op.oid for op in txn.ops)
        # replayed state must be durable before the journal goes away
        self._fsync_objects(touched)
        os.unlink(self.journal_path)

    def queue_transactions(
        self, txns: "list[Transaction] | Transaction"
    ) -> int:
        if isinstance(txns, Transaction):
            txns = [txns]
        with self._lock:
            if not txns:  # MemStore parity: an empty batch commits
                self.committed_seq += 1
                return self.committed_seq
            # A journal left over from a FAILED apply (exception midway
            # through step 2) holds committed intent: converge it first
            # exactly like crash recovery would — otherwise this call's
            # retire step would unlink it unreplayed.
            if os.path.exists(self.journal_path):
                self._replay()
            # 0. validate — same atomicity contract as MemStore: a
            #    failing op leaves no partial state, so check every op
            #    against simulated existence/attr state up front.
            self._validate(txns)
            # 1. journal (durable intent) — the journal FILE and its
            #    directory entry must both be durable, or a crash
            #    mid-apply could lose the journal itself and leave a
            #    half-applied transaction with nothing to replay
            for txn in txns:
                framed_log.append(self.journal_path, txn.to_bytes(),
                                  sync=False)
            jf = os.open(self.journal_path, os.O_RDONLY)
            try:
                os.fsync(jf)
            finally:
                os.close(jf)
            rd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(rd)
            finally:
                os.close(rd)
            # 2. apply — on failure the journal is LEFT IN PLACE: the
            #    next commit (or the next open) replays it to converge
            for txn in txns:
                self._apply(txn)
            # 3. make the applied state durable BEFORE retiring the
            #    journal — otherwise a power cut after the unlink but
            #    before the page cache drains loses an acked commit.
            self._fsync_objects({op.oid for txn in txns for op in txn.ops})
            # 4. retire
            os.unlink(self.journal_path)
            self.committed_seq += 1
            return self.committed_seq

    def _fsync_objects(self, oids: "set[str]") -> None:
        for oid in oids:
            for p in self._paths(oid):
                if os.path.exists(p):
                    fd = os.open(p, os.O_RDONLY)
                    try:
                        os.fsync(fd)
                    finally:
                        os.close(fd)
        dfd = os.open(self.objdir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def _validate(self, txns: "list[Transaction]") -> None:
        """Dry-run the op list against simulated state so the journal
        only ever records transactions that fully apply."""
        exists: dict[str, bool] = {}
        attrs: dict[str, set] = {}

        def obj_exists(oid: str) -> bool:
            if oid not in exists:
                exists[oid] = os.path.exists(self._paths(oid)[0])
            return exists[oid]

        def attr_names(oid: str) -> set:
            if oid not in attrs:
                attrs[oid] = (
                    set(self._load_attrs(oid)) if obj_exists(oid) else set()
                )
            return attrs[oid]

        for txn in txns:
            for op in txn.ops:
                if op.kind is OpKind.REMOVE:
                    if not obj_exists(op.oid):
                        raise FileNotFoundError(op.oid)
                    exists[op.oid] = False
                    attrs[op.oid] = set()
                elif op.kind in (OpKind.RMATTR, OpKind.RMATTR_TOLERANT):
                    if op.name not in attr_names(op.oid):
                        if op.kind is OpKind.RMATTR_TOLERANT:
                            exists[op.oid] = True
                            continue
                        raise KeyError(f"{op.oid}:{op.name}")
                    attrs[op.oid].discard(op.name)
                elif op.kind is OpKind.SETATTR:
                    attr_names(op.oid).add(op.name)
                    exists[op.oid] = True
                else:  # TOUCH / WRITE / ZERO / TRUNCATE create
                    attr_names(op.oid)
                    exists[op.oid] = True

    # -- apply ---------------------------------------------------------
    def _paths(self, oid: str) -> tuple[str, str]:
        base = os.path.join(self.objdir, _enc_name(oid))
        return base + ".bin", base + ".attrs"

    def _apply(self, txn: Transaction, strict: bool = True) -> None:
        for op in txn.ops:
            self._apply_op(op, strict)

    def _apply_op(self, op: Op, strict: bool = True) -> None:
        data_path, attr_path = self._paths(op.oid)
        if op.kind is OpKind.TOUCH:
            if not os.path.exists(data_path):
                open(data_path, "wb").close()
        elif op.kind is OpKind.WRITE:
            self._ensure(data_path)
            with open(data_path, "r+b") as f:
                # seek past EOF + write zero-fills the gap (POSIX)
                f.seek(op.offset)
                f.write(op.data)
        elif op.kind is OpKind.ZERO:
            self._ensure(data_path)
            with open(data_path, "r+b") as f:
                end = op.offset + op.length
                if os.fstat(f.fileno()).st_size < end:
                    f.truncate(end)  # extends, as MemStore's zero does
                f.seek(op.offset)
                f.write(b"\0" * op.length)
        elif op.kind is OpKind.TRUNCATE:
            self._ensure(data_path)
            with open(data_path, "r+b") as f:
                # truncate both shrinks and zero-extends (POSIX)
                f.truncate(op.offset)
        elif op.kind is OpKind.REMOVE:
            if strict and not os.path.exists(data_path):
                raise FileNotFoundError(op.oid)
            for p in (data_path, attr_path):
                if os.path.exists(p):
                    os.unlink(p)
        elif op.kind is OpKind.SETATTR:
            self._ensure(data_path)
            attrs = self._load_attrs(op.oid)
            attrs[op.name] = op.data
            self._store_attrs(op.oid, attrs)
        elif op.kind in (OpKind.RMATTR, OpKind.RMATTR_TOLERANT):
            attrs = self._load_attrs(op.oid)
            if op.name not in attrs:
                if not strict or op.kind is OpKind.RMATTR_TOLERANT:
                    self._ensure(data_path)
                    return
                raise KeyError(f"{op.oid}:{op.name}")
            del attrs[op.name]
            self._store_attrs(op.oid, attrs)

    @staticmethod
    def _ensure(path: str) -> None:
        if not os.path.exists(path):
            open(path, "wb").close()

    def _load_attrs(self, oid: str) -> dict[str, bytes]:
        _, attr_path = self._paths(oid)
        if not os.path.exists(attr_path):
            return {}
        with open(attr_path) as f:
            return {k: bytes.fromhex(v) for k, v in json.load(f).items()}

    def _store_attrs(self, oid: str, attrs: dict[str, bytes]) -> None:
        _, attr_path = self._paths(oid)
        tmp = attr_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({k: v.hex() for k, v in attrs.items()}, f)
        os.replace(tmp, attr_path)  # atomic on POSIX

    # -- read path (MemStore-identical contract; same lock discipline,
    #    so readers never see a partially-applied transaction) ---------
    def exists(self, oid: str) -> bool:
        with self._lock:
            return os.path.exists(self._paths(oid)[0])

    def stat(self, oid: str) -> int:
        data_path, _ = self._paths(oid)
        with self._lock:
            try:
                return os.path.getsize(data_path)
            except OSError:
                raise FileNotFoundError(oid) from None

    def read(
        self, oid: str, offset: int = 0, length: int | None = None
    ) -> bytes:
        data_path, _ = self._paths(oid)
        with self._lock:
            try:
                with open(data_path, "rb") as f:
                    f.seek(offset)
                    return f.read() if length is None else f.read(length)
            except OSError:
                raise FileNotFoundError(oid) from None

    def getattr(self, oid: str, name: str) -> bytes:
        with self._lock:
            if not os.path.exists(self._paths(oid)[0]):
                raise FileNotFoundError(oid)
            attrs = self._load_attrs(oid)
        if name not in attrs:
            raise KeyError(f"{oid}:{name}")
        return attrs[name]

    def getattrs(self, oid: str) -> dict[str, bytes]:
        with self._lock:
            if not os.path.exists(self._paths(oid)[0]):
                raise FileNotFoundError(oid)
            return self._load_attrs(oid)

    def list_objects(self) -> list[str]:
        with self._lock:
            out = []
            for fn in os.listdir(self.objdir):
                if fn.endswith(".bin"):
                    out.append(bytes.fromhex(fn[:-4]).decode())
            return sorted(out)

    def __repr__(self) -> str:
        return f"FileStore({self.root!r})"
