"""The port's persistent object stores (``store/filestore.py``,
``blockstore.py``, ``kvstore.py``, ``devicefs.py``, ``allocator.py``,
``framed_log.py``) against ``ceph_tpu``'s, byte for byte (tolerance 0),
on the CPU.

- The store suite of ``tests/test_store.py`` runs as one parametrised
  suite over MemStore, FileStore and BlockStore: each case runs in both
  packages, on stores in their own directories, and the reads, attrs,
  sequence numbers and errors must agree (and meet the reference
  test's assertions).
- The ``tests/test_blockstore.py``, ``test_kvstore.py`` and
  ``test_devicefs.py`` cases, and the KV-batch, framed-log and
  transaction legs of ``test_format_freeze.py`` against the same golden
  bytes; the allocator cases run each step in both packages' allocators
  and compare the extents granted.
- Twin: the same RMW transactions (``test_torch_rmw``'s ``Stack``) into
  port and ``ceph_tpu`` BlockStores: object bytes, attrs, blob csums and
  the device files equal.
- Cross-open: a store written by one package opens and reads back in
  the other.
- Adoption: the port's BlockStore adopts Kernel B's csums (on the CPU
  from its plain form): no blob is hashed on the host, and the csums
  equal the host crc of the stored blobs.
- A flipped byte under a BlockStore: the read raises ``CsumError``, the
  deep scrub raises it as ``ceph_tpu``'s does, the degraded read is
  exact, and the rebuilt object reads back and scrubs clean, in both.
"""

import json
import os
import shutil
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ceph_tpu.store as ref_store  # noqa: E402
import ceph_tpu_torch.store as port_store  # noqa: E402
from ceph_tpu.store import allocator as ref_alloc  # noqa: E402
from ceph_tpu.store import devicefs as ref_devicefs  # noqa: E402
from ceph_tpu.store import framed_log as ref_framed_log  # noqa: E402
from ceph_tpu.store import kvstore as ref_kvstore  # noqa: E402
from ceph_tpu_torch.checksum.reference import crc32c_ref  # noqa: E402
from ceph_tpu_torch.store import allocator, devicefs, framed_log  # noqa: E402
from ceph_tpu_torch.store import kvstore  # noqa: E402
from test_torch_rmw import (  # noqa: E402,F401
    _clean_inject, PAGE, PORT, REF, Stack, payload, store_snapshot,
)

PACKAGES = {"ref": ref_store, "port": port_store}


def make_store(pkg, backend, root):
    if backend == "memstore":
        return pkg.MemStore()
    if backend == "filestore":
        return pkg.FileStore(str(root / "fs"))
    return pkg.BlockStore(str(root / "bs"), size=1 << 22)


@pytest.fixture(params=["memstore", "filestore", "blockstore"])
def pair(request, tmp_path):
    """{"ref": store, "port": store} of one backend, each in its own
    directory."""
    out = {}
    for name, pkg in PACKAGES.items():
        (tmp_path / name).mkdir()
        out[name] = make_store(pkg, request.param, tmp_path / name)
    return out


def both(pair, body):
    """``body(pkg, store)`` in each package; the results must agree.
    Returns the port's."""
    got = {name: body(PACKAGES[name], st) for name, st in pair.items()}
    assert got["port"] == got["ref"]
    return got["port"]


def outcome(fn):
    """(result, None) or (None, error class name): errors compare across
    the packages by class name."""
    try:
        return fn(), None
    except (FileNotFoundError, KeyError, ValueError) as e:
        return None, type(e).__name__


# -- the store suite (tests/test_store.py), both packages ------------------
def test_write_read_roundtrip(pair):
    def body(pkg, st):
        st.queue_transactions(pkg.Transaction().write("o", 0, b"hello"))
        return st.read("o"), st.stat("o")

    assert both(pair, body) == (b"hello", 5)


def test_write_extends_with_zero_fill(pair):
    def body(pkg, st):
        st.queue_transactions(pkg.Transaction().write("o", 8, b"xy"))
        return st.read("o")

    assert both(pair, body) == b"\0" * 8 + b"xy"


def test_overwrite_middle(pair):
    def body(pkg, st):
        st.queue_transactions(pkg.Transaction().write("o", 0, b"aaaaaaaa"))
        st.queue_transactions(pkg.Transaction().write("o", 2, b"BB"))
        return st.read("o")

    assert both(pair, body) == b"aaBBaaaa"


def test_zero_and_truncate(pair):
    def body(pkg, st):
        T = pkg.Transaction
        st.queue_transactions(T().write("o", 0, b"abcdefgh"))
        st.queue_transactions(T().zero("o", 2, 3))
        a = st.read("o")
        st.queue_transactions(T().truncate("o", 4))
        b = st.stat("o")
        st.queue_transactions(T().truncate("o", 6))
        return a, b, st.read("o")

    assert both(pair, body) == (b"ab\0\0\0fgh", 4, b"ab\0\0\0\0")


def test_zero_extends(pair):
    def body(pkg, st):
        st.queue_transactions(pkg.Transaction().write("o", 0, b"ab"))
        st.queue_transactions(pkg.Transaction().zero("o", 4, 4))
        return st.read("o")

    assert both(pair, body) == b"ab\0\0\0\0\0\0"


def test_short_read_past_eof(pair):
    def body(pkg, st):
        st.queue_transactions(pkg.Transaction().write("o", 0, b"abc"))
        return st.read("o", 2, 100)

    assert both(pair, body) == b"c"


def test_touch_creates_empty(pair):
    def body(pkg, st):
        st.queue_transactions(pkg.Transaction().touch("o"))
        return st.exists("o"), st.stat("o")

    assert both(pair, body) == (True, 0)


def test_remove(pair):
    def body(pkg, st):
        st.queue_transactions(pkg.Transaction().write("o", 0, b"x"))
        st.queue_transactions(pkg.Transaction().remove("o"))
        return st.exists("o"), outcome(lambda: st.read("o"))

    assert both(pair, body) == (False, (None, "FileNotFoundError"))


def test_remove_then_recreate_in_one_txn(pair):
    def body(pkg, st):
        st.queue_transactions(pkg.Transaction().write("o", 0, b"old"))
        st.queue_transactions(
            pkg.Transaction().remove("o").write("o", 0, b"new"))
        return st.read("o")

    assert both(pair, body) == b"new"


def test_attrs_roundtrip_hashinfo(pair):
    def body(pkg, st):
        HashInfo = (PORT if pkg is port_store else REF).HashInfo
        kw = {"device": "cpu"} if pkg is port_store else {}
        hi = HashInfo(6, **kw)
        hi.append(0, {i: b"\x01" * 8 for i in range(6)})
        st.queue_transactions(
            pkg.Transaction().touch("o").setattr("o", "hinfo", hi.to_bytes()))
        raw = st.getattr("o", "hinfo")
        assert HashInfo.from_bytes(raw, **kw) == hi
        st.queue_transactions(pkg.Transaction().rmattr("o", "hinfo"))
        return raw, outcome(lambda: st.getattr("o", "hinfo"))

    assert both(pair, body)[1] == (None, "KeyError")


def test_atomicity_failed_txn_leaves_no_state(pair):
    def body(pkg, st):
        st.queue_transactions(pkg.Transaction().write("o", 0, b"keep"))
        bad = pkg.Transaction().write("o", 0, b"clobber").remove("missing")
        return outcome(lambda: st.queue_transactions(bad)), st.read("o")

    assert both(pair, body) == ((None, "FileNotFoundError"), b"keep")


def test_ordered_multi_txn_batch(pair):
    def body(pkg, st):
        T = pkg.Transaction
        seq = st.queue_transactions([T().write("o", 0, b"v1"),
                                     T().write("o", 0, b"v2")])
        return st.read("o"), seq, st.queue_transactions(T().touch("p"))

    assert both(pair, body) == (b"v2", 1, 2)


def test_missing_object_errors(pair):
    def body(pkg, st):
        return (outcome(lambda: st.stat("nope")),
                outcome(lambda: st.getattr("nope", "a")),
                outcome(lambda: st.queue_transactions(
                    pkg.Transaction().remove("nope"))))

    assert both(pair, body) == ((None, "FileNotFoundError"),) * 3


def test_list_objects(pair):
    def body(pkg, st):
        st.queue_transactions(pkg.Transaction().touch("b").touch("a"))
        return st.list_objects()

    assert both(pair, body) == ["a", "b"]


def test_empty_batch_commits(pair):
    def body(pkg, st):
        return (st.queue_transactions([]),
                st.queue_transactions(pkg.Transaction().touch("o")))

    assert both(pair, body) == (1, 2)


# -- FileStore durability (tests/test_store.py), both packages -------------
def journal_append(path, payload, crc=None):
    if crc is None:
        crc = crc32c_ref(0xFFFFFFFF, payload)
    with open(path, "ab") as jf:
        jf.write(struct.pack("<II", len(payload), crc))
        jf.write(payload)


@pytest.fixture
def fs_roots(tmp_path):
    return {name: str(tmp_path / name / "fs") for name in PACKAGES}


def both_roots(roots, body):
    got = {name: body(PACKAGES[name], roots[name]) for name in PACKAGES}
    assert got["port"] == got["ref"]
    return got["port"]


def test_filestore_persists_across_reopen(fs_roots):
    def body(pkg, root):
        pkg.FileStore(root).queue_transactions(
            pkg.Transaction().write("obj/1", 0, b"durable")
            .setattr("obj/1", "a", b"v"))
        st2 = pkg.FileStore(root)
        return st2.read("obj/1"), st2.getattr("obj/1", "a"), st2.list_objects()

    assert both_roots(fs_roots, body) == (b"durable", b"v", ["obj/1"])


def test_filestore_replays_journal_on_crash(fs_roots):
    def body(pkg, root):
        st = pkg.FileStore(root)
        st.queue_transactions(pkg.Transaction().write("o", 0, b"v1"))
        journal_append(st.journal_path,
                       pkg.Transaction().write("o", 0, b"v2").to_bytes())
        st2 = pkg.FileStore(root)
        return st2.read("o"), os.path.exists(st2.journal_path)

    assert both_roots(fs_roots, body) == (b"v2", False)


def test_filestore_discards_torn_journal_tail(fs_roots):
    def body(pkg, root):
        st = pkg.FileStore(root)
        journal_append(st.journal_path,
                       pkg.Transaction().write("o", 0, b"good").to_bytes())
        journal_append(st.journal_path,
                       pkg.Transaction().write("o", 0, b"evil").to_bytes(),
                       crc=0xDEADBEEF)
        return pkg.FileStore(root).read("o")

    assert both_roots(fs_roots, body) == b"good"


def test_filestore_replay_is_idempotent(fs_roots):
    def body(pkg, root):
        st = pkg.FileStore(root)
        st.queue_transactions(pkg.Transaction().write("o", 0, b"x"))
        txn = pkg.Transaction().remove("o")
        journal_append(st.journal_path, txn.to_bytes())
        st._apply(txn)  # applied, then "crash" before retire
        return pkg.FileStore(root).exists("o")

    assert both_roots(fs_roots, body) is False


def test_filestore_failed_apply_converges_on_next_commit(fs_roots):
    def body(pkg, root):
        st = pkg.FileStore(root)
        st.queue_transactions(pkg.Transaction().write("o", 0, b"base"))
        txn = pkg.Transaction().write("o", 0, b"GOOD").write("p", 0, b"NEW")
        orig = st._apply_op
        calls = {"n": 0}

        def exploding(op, strict=True):
            calls["n"] += 1
            if calls["n"] == 2:
                raise OSError("injected device error")
            return orig(op, strict)

        st._apply_op = exploding
        with pytest.raises(OSError):
            st.queue_transactions(txn)
        st._apply_op = orig
        kept = os.path.exists(st.journal_path)
        st.queue_transactions(pkg.Transaction().touch("q"))
        return kept, st.read("o"), st.read("p"), os.path.exists(
            st.journal_path)

    assert both_roots(fs_roots, body) == (True, b"GOOD", b"NEW", False)


# -- allocators (tests/test_blockstore.py), step by step against ceph_tpu --
class AllocPair:
    """The same allocator in both packages; every call runs on both and
    must grant the same extents (or fail the same way)."""

    def __init__(self, kind, unit=4096, size=1 << 22, **kw):
        self.a = allocator.ALLOCATORS[kind](unit, **kw)
        self.r = ref_alloc.ALLOCATORS[kind](unit, **kw)
        if size:
            self.init_add_free(0, size)

    def __getattr__(self, name):
        def call(*args):
            got = outcome2(lambda: getattr(self.a, name)(*args),
                           allocator.AllocError)
            want = outcome2(lambda: getattr(self.r, name)(*args),
                            ref_alloc.AllocError)
            assert got == want, name
            if got[1] is not None:
                raise {"AllocError": allocator.AllocError,
                       "ValueError": ValueError}[got[1]]()
            return got[0]
        return call


def outcome2(fn, alloc_error):
    try:
        return fn(), None
    except alloc_error:
        return None, "AllocError"
    except ValueError:
        return None, "ValueError"


@pytest.fixture(params=sorted(allocator.ALLOCATORS))
def alloc(request):
    assert sorted(allocator.ALLOCATORS) == sorted(ref_alloc.ALLOCATORS)
    return AllocPair(request.param)


def test_alloc_free_roundtrip(alloc):
    total = alloc.get_free()
    got = alloc.allocate(10_000)
    assert sum(ln for _, ln in got) >= 10_000
    assert alloc.get_free() == total - sum(ln for _, ln in got)
    alloc.release(got)
    assert alloc.get_free() == total


def test_allocations_never_overlap(alloc):
    held = []
    for _ in range(50):
        held.extend(alloc.allocate(8192))
    spans = sorted(held)
    for (o1, l1), (o2, _l2) in zip(spans, spans[1:]):
        assert o1 + l1 <= o2


def test_enospc(alloc):
    with pytest.raises(allocator.AllocError):
        alloc.allocate((1 << 22) + 4096)
    alloc.allocate(1 << 22)
    with pytest.raises(allocator.AllocError):
        alloc.allocate(4096)


def test_double_free_detected(alloc):
    got = alloc.allocate(4096)
    alloc.release(got)
    with pytest.raises(ValueError):
        alloc.release(got)


def test_btree_coalesces_frees():
    a = AllocPair("btree", size=1 << 20)
    chunks = [a.allocate(4096)[0] for _ in range(256)]
    assert a.get_free() == 0
    for c in chunks:
        a.release([c])
    assert a.free_extents() == [(0, 1 << 20)]


def test_fragmented_allocation_gathers(alloc):
    held = [alloc.allocate(4096)[0] for _ in range(512)]
    for c in held[::2]:
        alloc.release([c])
    got = alloc.allocate(3 * 4096)
    assert sum(ln for _, ln in got) >= 3 * 4096


def test_model_checked_random_alloc(alloc):
    rng = np.random.default_rng(7)
    total = alloc.get_free()
    held: list[tuple[int, int]] = []
    for _ in range(300):
        if held and rng.random() < 0.45:
            alloc.release([held.pop(int(rng.integers(0, len(held))))])
        else:
            try:
                held.extend(alloc.allocate(int(rng.integers(1, 10)) * 4096))
            except allocator.AllocError:
                continue
        assert alloc.get_free() + sum(ln for _, ln in held) == total
        spans = sorted(held)
        for (o1, l1), (o2, _), in zip(spans, spans[1:]):
            assert o1 + l1 <= o2


def test_hybrid_spills_to_bitmap():
    a = AllocPair("hybrid", size=1 << 20, max_extents=16)
    held = [a.allocate(4096)[0] for _ in range(200)]
    for c in held[::2]:
        a.release([c])
    assert a.a.bitmap is not None and a.r.bitmap is not None
    assert a.allocate(4096)


def test_hybrid_grows_bitmap_and_gathers_across_pools():
    a = AllocPair("hybrid", size=0, max_extents=8)
    for i in range(40):
        a.init_add_free(i * 3 * 4096, 4096)
    a.init_add_free(40 * 3 * 4096, 64 * 4096)
    assert a.a.bitmap is not None
    total = a.get_free()
    got = a.allocate(total)
    assert sum(ln for _, ln in got) == total
    assert a.get_free() == 0


# -- BlockStore (tests/test_blockstore.py) -----------------------------------
def test_blockstore_persists_across_reopen(tmp_path):
    root = str(tmp_path / "bs")
    st = port_store.BlockStore(root, size=1 << 22)
    blob = np.random.default_rng(0).integers(0, 256, 20_000,
                                             dtype=np.uint8).tobytes()
    st.queue_transactions(
        port_store.Transaction().write("o", 0, blob).setattr("o", "a", b"v"))
    st.close()
    st2 = port_store.BlockStore(root, size=1 << 22)
    assert st2.read("o") == blob
    assert st2.getattr("o", "a") == b"v"


def test_blockstore_wal_recovery_without_checkpoint(tmp_path):
    root = str(tmp_path / "bs")
    st = port_store.BlockStore(root, size=1 << 22)
    st.queue_transactions(port_store.Transaction().write("o", 0, b"v1"))
    st.queue_transactions(port_store.Transaction().write("o", 0, b"v2"))
    st2 = port_store.BlockStore(root, size=1 << 22)
    assert st2.read("o") == b"v2"
    assert st2.committed_seq == st.committed_seq


def _flip(root, dev_off):
    with open(os.path.join(root, "block"), "r+b") as f:
        f.seek(dev_off)
        f.write(b"\xff")


def test_blockstore_detects_bit_rot(tmp_path):
    root = str(tmp_path / "bs")
    st = port_store.BlockStore(root, size=1 << 22)
    st.queue_transactions(port_store.Transaction().write("o", 0, b"A" * 10_000))
    _flip(root, next(iter(st._objects["o"].blobs.values())).offset + 100)
    with pytest.raises(port_store.CsumError):
        st.read("o")
    assert issubclass(port_store.CsumError, IOError)


def test_blockstore_reclaims_space(tmp_path):
    st = port_store.BlockStore(str(tmp_path / "bs"), size=1 << 20)
    for _ in range(20):
        st.queue_transactions(port_store.Transaction().write("o", 0,
                                                             b"x" * 200_000))
        st.queue_transactions(port_store.Transaction().remove("o"))
    fs_owned = sum(-(-ln // st.block_size) * st.block_size
                   for _off, ln in st._fs.reserved_extents())
    assert st.allocator.get_free() == st.device_size - fs_owned


def test_blockstore_cow_overwrite_keeps_old_until_commit(tmp_path):
    st = port_store.BlockStore(str(tmp_path / "bs"), size=1 << 22)
    st.queue_transactions(port_store.Transaction().write("o", 0, b"a" * 8192))
    before = {b.offset for b in st._objects["o"].blobs.values()}
    st.queue_transactions(port_store.Transaction().write("o", 0, b"b" * 8192))
    after = {b.offset for b in st._objects["o"].blobs.values()}
    assert before.isdisjoint(after)
    assert st.read("o") == b"b" * 8192


def test_blockstore_checkpoint_absorbs_wal(tmp_path):
    root = str(tmp_path / "bs")
    st = port_store.BlockStore(root, size=1 << 22, checkpoint_every=4)
    for i in range(6):
        st.queue_transactions(port_store.Transaction().write(f"o{i}", 0,
                                                             b"z" * 100))
    assert not os.path.exists(os.path.join(root, "kv.snap"))
    assert st._fs.snap_len > 0
    st2 = port_store.BlockStore(root, size=1 << 22)
    assert st2.list_objects() == [f"o{i}" for i in range(6)]
    for i in range(6):
        assert st2.read(f"o{i}") == b"z" * 100


def test_truncate_never_launders_corruption(tmp_path):
    root = str(tmp_path / "bs")
    st = port_store.BlockStore(root, size=1 << 22)
    st.queue_transactions(port_store.Transaction().write("o", 0, b"A" * 8192))
    _flip(root, next(iter(st._objects["o"].blobs.values())).offset + 100)
    with pytest.raises(port_store.CsumError):
        st.queue_transactions(port_store.Transaction().truncate("o", 5000))


def test_blockstore_runs_pipeline(tmp_path, rng):
    """BlockStore drops in as an OSD shard store: the EC write and the
    degraded read run over it, in both packages, with equal stores."""
    data = payload(rng, 30_000)
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        stores = {s: PACKAGES[name].BlockStore(
            str(tmp_path / name / f"osd{s}"), size=1 << 22) for s in range(5)}
        st = Stack(pkg, k=3, m=2, stores=stores)
        done = []
        st.rmw.submit("obj", 0, data, done.append)
        assert done and done[0].error is None
        st.backend.down_shards = {0, 4}
        out[name] = (st.reads.read_sync("obj", 0, len(data)), st.snapshot())
    assert out["port"][0] == data
    assert out["port"] == out["ref"]


# -- KeyValueDB (tests/test_kvstore.py) -----------------------------------
@pytest.fixture
def db(tmp_path):
    return kvstore.KeyValueDB(str(tmp_path / "kv"))


class TestKVBasics:
    def test_set_get_rm(self, db):
        db.submit_transaction(db.transaction().set("P", "a", b"1")
                              .set("P", "b", b"2"))
        assert db.get("P", "a") == b"1"
        assert db.get("Q", "a") is None
        db.submit_transaction(db.transaction().rmkey("P", "a"))
        assert db.get("P", "a") is None
        assert db.get("P", "b") == b"2"

    def test_batch_is_atomic_in_order(self, db):
        db.submit_transaction(db.transaction().set("P", "k", b"first")
                              .rmkey("P", "k").set("P", "k", b"last"))
        assert db.get("P", "k") == b"last"

    def test_rmkeys_by_prefix(self, db):
        txn = db.transaction()
        for i in range(5):
            txn.set("A", f"k{i}", b"x")
        txn.set("B", "keep", b"y")
        db.submit_transaction(txn)
        db.submit_transaction(db.transaction().rmkeys_by_prefix("A"))
        assert list(db.iterate("A")) == []
        assert db.get("B", "keep") == b"y"

    def test_iterate_sorted_with_bounds(self, db):
        txn = db.transaction()
        for k in ("m", "a", "z", "q"):
            txn.set("P", k, k.encode())
        db.submit_transaction(txn)
        assert [k for k, _ in db.iterate("P")] == ["a", "m", "q", "z"]
        assert [k for k, _ in db.iterate("P", start="m")] == ["m", "q", "z"]
        assert [k for k, _ in db.iterate("P", start="m", end="z")] == [
            "m", "q"]

    def test_get_multi(self, db):
        db.submit_transaction(db.transaction().set("P", "a", b"1")
                              .set("P", "c", b"3"))
        assert db.get_multi("P", ["a", "b", "c"]) == {"a": b"1", "c": b"3"}

    def test_binary_values_round_trip(self, db):
        blob = bytes(range(256)) * 3
        db.submit_transaction(db.transaction().set("P", "bin", blob))
        assert db.get("P", "bin") == blob


class TestKVDurability:
    def test_reopen_replays_wal(self, tmp_path):
        root = str(tmp_path / "kv")
        db = kvstore.KeyValueDB(root)
        db.submit_transaction(db.transaction().set("P", "k", b"v1"))
        db.submit_transaction(db.transaction().set("P", "k", b"v2"))
        assert kvstore.KeyValueDB(root).get("P", "k") == b"v2"

    def test_torn_tail_discarded(self, tmp_path):
        root = str(tmp_path / "kv")
        db = kvstore.KeyValueDB(root)
        db.submit_transaction(db.transaction().set("P", "good", b"1"))
        db.submit_transaction(db.transaction().set("P", "torn", b"2"))
        wal = os.path.join(root, "kv.wal")
        with open(wal, "r+b") as f:
            f.truncate(os.path.getsize(wal) - 3)
        db2 = kvstore.KeyValueDB(root)
        assert db2.get("P", "good") == b"1"
        assert db2.get("P", "torn") is None
        db2.submit_transaction(db2.transaction().set("P", "next", b"3"))
        assert kvstore.KeyValueDB(root).get("P", "next") == b"3"

    def test_compaction_absorbs_wal_and_survives(self, tmp_path):
        root = str(tmp_path / "kv")
        db = kvstore.KeyValueDB(root, compact_every=4)
        for i in range(6):
            db.submit_transaction(db.transaction().set("P", f"k{i}",
                                                       str(i).encode()))
        assert os.path.exists(os.path.join(root, "kv.snap"))
        assert os.path.getsize(os.path.join(root, "kv.wal")) > 0
        db2 = kvstore.KeyValueDB(root)
        assert [k for k, _ in db2.iterate("P")] == [f"k{i}" for i in range(6)]

    def test_deletes_survive_compaction(self, tmp_path):
        root = str(tmp_path / "kv")
        db = kvstore.KeyValueDB(root)
        db.submit_transaction(db.transaction().set("P", "k", b"v"))
        db.submit_transaction(db.transaction().rmkey("P", "k"))
        db.compact()
        assert kvstore.KeyValueDB(root).get("P", "k") is None

    def test_files_equal_the_reference(self, tmp_path):
        """The same batches leave the same WAL and snapshot bytes in both
        packages, and each package opens the other's files."""
        roots = {}
        for name, mod in (("ref", ref_kvstore), ("port", kvstore)):
            roots[name] = str(tmp_path / name)
            db = mod.KeyValueDB(roots[name], compact_every=3)
            for i in range(5):
                db.submit_transaction(db.transaction().set(
                    "P", f"k{i}", bytes([i]) * 7).rmkey("P", f"k{i - 2}"))
        for fname in ("kv.wal", "kv.snap"):
            with open(os.path.join(roots["ref"], fname), "rb") as f:
                want = f.read()
            with open(os.path.join(roots["port"], fname), "rb") as f:
                assert f.read() == want, fname
        for mine, theirs in ((kvstore, roots["ref"]),
                             (ref_kvstore, roots["port"])):
            assert list(mine.KeyValueDB(theirs).iterate("P")) == [
                ("k3", b"\x03" * 7), ("k4", b"\x04" * 7)]


class TestKVCodec:
    def test_round_trip(self):
        txn = (kvstore.KVTransaction().set("O", "oid1", b"\x00\xffbytes")
               .rmkey("O", "oid2").rmkeys_by_prefix("X"))
        assert kvstore.KVTransaction.decode(txn.encode()).ops == txn.ops
        assert ref_kvstore.KVTransaction.decode(txn.encode()).ops == txn.ops

    def test_trailing_garbage_rejected(self):
        bad = kvstore.KVTransaction().set("P", "k", b"v").encode() + b"JUNK"
        with pytest.raises(ValueError):
            kvstore.KVTransaction.decode(bad)


class TestBlockStoreMigration:
    def test_legacy_metadata_imported_once(self, tmp_path):
        root = str(tmp_path / "bs")
        st = port_store.BlockStore(root, size=1 << 22)
        st.queue_transactions(port_store.Transaction()
                              .write("obj", 0, b"D" * 5000)
                              .setattr("obj", "a", b"v"))
        seq = st.committed_seq
        st.close()
        snap = {"seq": seq, "objects": {
            oid: json.loads(raw) for oid, raw in st._kvdb.iterate("O")}}
        with open(os.path.join(root, "meta.ckpt"), "w") as f:
            json.dump(snap, f)
        framed_log.append(os.path.join(root, "meta.wal"),
                          json.dumps(snap).encode())
        st2 = port_store.BlockStore(root, size=1 << 22)
        assert st2.read("obj") == b"D" * 5000
        assert st2.getattr("obj", "a") == b"v"
        assert st2.committed_seq == seq
        assert not os.path.exists(os.path.join(root, "meta.ckpt"))
        assert not os.path.exists(os.path.join(root, "meta.wal"))
        st2.close()
        assert port_store.BlockStore(root, size=1 << 22).read("obj") == (
            b"D" * 5000)

    def test_stale_legacy_checkpoint_cannot_rewind(self, tmp_path):
        root = str(tmp_path / "bs")
        st = port_store.BlockStore(root, size=1 << 22)
        st.queue_transactions(port_store.Transaction().write("old", 0,
                                                             b"O" * 100))
        stale = {"seq": st.committed_seq, "objects": {
            oid: json.loads(raw) for oid, raw in st._kvdb.iterate("O")}}
        st.queue_transactions(port_store.Transaction().write("new", 0,
                                                             b"N" * 100))
        st.close()
        with open(os.path.join(root, "meta.ckpt"), "w") as f:
            json.dump(stale, f)
        st2 = port_store.BlockStore(root, size=1 << 22)
        assert st2.read("new") == b"N" * 100
        assert st2.read("old") == b"O" * 100
        assert not os.path.exists(os.path.join(root, "meta.ckpt"))


# -- DeviceFS (tests/test_devicefs.py), the device bytes against ceph_tpu --
class _Dev:
    """In-memory device + allocator for DeviceFS unit tests."""

    def __init__(self, mod_alloc, mod_fs, size=1 << 22, bs=4096):
        self.buf = bytearray(size)
        self.bs = bs
        self.mod_fs = mod_fs
        self.alloc = mod_alloc.ALLOCATORS["btree"](bs)
        self.alloc.init_add_free(2 * bs, size - 2 * bs)

    def read(self, off, ln):
        return bytes(self.buf[off:off + ln])

    def write(self, off, data):
        self.buf[off:off + len(data)] = data

    def fs(self):
        return self.mod_fs.DeviceFS(
            self.read, self.write, lambda: None, self.bs,
            lambda n: self.alloc.allocate(n),
            lambda off, ln: self.alloc.release([(off, ln)]),
        )


def _devs():
    return (_Dev(allocator, devicefs), _Dev(ref_alloc, ref_devicefs))


def test_format_load_roundtrip():
    dev, ref = _devs()
    for d in (dev, ref):
        d.fs().format()
    assert dev.buf == ref.buf
    assert devicefs.DeviceFS.probe(dev.read, dev.bs)
    fs2 = dev.fs()
    fs2.load()
    assert fs2.wal_epoch == 0
    assert fs2.wal_replay() == []
    assert fs2.snap_read() is None


def test_wal_append_replay_and_torn_tail():
    dev, ref = _devs()
    payloads = [f"rec{i}".encode() * (i + 1) for i in range(5)]
    for d in (dev, ref):
        fs = d.fs()
        fs.format()
        for p in payloads:
            fs.wal_append(p)
    assert dev.buf == ref.buf
    fs2 = dev.fs()
    fs2.load()
    assert fs2.wal_replay() == payloads
    off, _ln = fs.wal_extents[0]
    dev.buf[off + fs._wal_pos - 1] ^= 0xFF
    fs3 = dev.fs()
    fs3.load()
    assert fs3.wal_replay() == payloads[:-1]


def test_snapshot_swap_filters_stale_wal():
    dev, ref = _devs()
    for d in (dev, ref):
        fs = d.fs()
        fs.format()
        fs.wal_append(b"old-1")
        fs.wal_append(b"old-2")
        fs.snap_commit(b"SNAPSHOT-STATE")
        fs.wal_append(b"new-1")
    assert dev.buf == ref.buf
    fs2 = dev.fs()
    fs2.load()
    assert fs2.snap_read() == b"SNAPSHOT-STATE"
    assert fs2.wal_replay() == [b"new-1"]


def test_superblock_ab_alternation_survives_torn_write():
    dev, _ = _devs()
    fs = dev.fs()
    fs.format()
    fs.wal_append(b"x")
    fs.snap_commit(b"S1")
    seq_before, other = fs.seq, 1 - fs._active_slot
    dev.buf[other * dev.bs:other * dev.bs + 16] = b"\xff" * 16
    fs2 = dev.fs()
    fs2.load()
    assert fs2.seq == seq_before
    assert fs2.snap_read() == b"S1"


def test_wal_grows_extents_on_demand():
    dev, ref = _devs()
    big = np.random.default_rng(3).integers(
        0, 256, devicefs.GRANT // 2, dtype=np.uint8).tobytes()
    for d in (dev, ref):
        fs = d.fs()
        fs.format()
        for _ in range(4):
            fs.wal_append(big)
    assert dev.buf == ref.buf
    assert sum(ln for _, ln in fs.wal_extents) >= 2 * devicefs.GRANT
    fs2 = dev.fs()
    fs2.load()
    got = fs2.wal_replay()
    assert len(got) == 4 and all(g == big for g in got)


def test_reserved_extents_cover_everything():
    dev, _ = _devs()
    fs = dev.fs()
    fs.format()
    fs.wal_append(b"a" * 1000)
    fs.snap_commit(b"s" * 5000)
    res = fs.reserved_extents()
    assert (0, 2 * dev.bs) in res
    assert sum(ln for _, ln in res) >= 2 * dev.bs + devicefs.GRANT


def _write_some(store, n=6, seed=0):
    r = np.random.default_rng(seed)
    blobs = {}
    for i in range(n):
        data = r.integers(0, 256, 3000 + 517 * i, dtype=np.uint8).tobytes()
        txn = port_store.Transaction().touch(f"o{i}").write(f"o{i}", 0, data)
        txn.setattr(f"o{i}", "a", f"v{i}".encode())
        store.queue_transactions(txn)
        blobs[f"o{i}"] = data
    return blobs


def test_fresh_blockstore_is_single_device(tmp_path):
    root = str(tmp_path / "bs")
    store = port_store.BlockStore(root, size=1 << 22, block_size=4096)
    blobs = _write_some(store)
    store.close()
    assert set(os.listdir(root)) == {"block"}
    root2 = str(tmp_path / "bs2")
    os.makedirs(root2)
    shutil.copy(os.path.join(root, "block"), os.path.join(root2, "block"))
    store2 = port_store.BlockStore(root2, size=1 << 22, block_size=4096)
    for oid, data in blobs.items():
        assert store2.read(oid) == data
        assert store2.getattr(oid, "a") == f"v{oid[1:]}".encode()
    store2.close()


def test_blockstore_crash_replay_from_device(tmp_path):
    root = str(tmp_path / "bs")
    store = port_store.BlockStore(root, size=1 << 22, block_size=4096,
                                  checkpoint_every=4)
    blobs = _write_some(store, n=11)
    store2 = port_store.BlockStore(root, size=1 << 22, block_size=4096)
    for oid, data in blobs.items():
        assert store2.read(oid) == data
    store2.close()


def test_legacy_host_kv_store_keeps_working(tmp_path):
    root = str(tmp_path / "bs")
    os.makedirs(root)
    framed_log.append(os.path.join(root, "kv.wal"),
                      kvstore.KVTransaction().set("S", "seq", b"0").encode())
    store = port_store.BlockStore(root, size=1 << 22, block_size=4096)
    assert store._fs is None
    blobs = _write_some(store, n=3)
    store.close()
    store2 = port_store.BlockStore(root, size=1 << 22, block_size=4096)
    assert store2._fs is None
    for oid, data in blobs.items():
        assert store2.read(oid) == data
    store2.close()


def test_device_hosted_survives_compaction_cycles(tmp_path):
    root = str(tmp_path / "bs")
    store = port_store.BlockStore(root, size=1 << 23, block_size=4096,
                                  checkpoint_every=3)
    r = np.random.default_rng(1)
    data = {}
    for round_ in range(5):
        for i in range(4):
            blob = r.integers(0, 256, 2000 + round_ * 100 + i,
                              dtype=np.uint8).tobytes()
            store.queue_transactions(port_store.Transaction().touch(
                f"r{round_}o{i}").write(f"r{round_}o{i}", 0, blob))
            data[f"r{round_}o{i}"] = blob
    store.close()
    store2 = port_store.BlockStore(root, size=1 << 23, block_size=4096)
    for oid, blob in data.items():
        assert store2.read(oid) == blob
    store2.close()


# -- format freeze (tests/test_format_freeze.py), the same golden bytes ----
KV_GOLDEN = bytes.fromhex(
    "0300000000010004000000060000004f6f69643100ff646174610101"
    "0001000000000000004f7802010000000000000000005a"
)
LOG_GOLDEN = bytes.fromhex("0e0000006e7952587265636f72642d7061796c6f6164")
TXN_GOLDEN = bytes.fromhex(
    "010400000001030000006f626a40000000000000000500000000000000"
    "0000000005000000627974657305030000006f626a0000000000000000"
    "00000000000000000100000061010000007603030000006f626a640000"
    "0000000000000000000000000000000000000000000404000000676f6e"
    "65000000000000000000000000000000000000000000000000"
)


def test_kv_batch_bytes_frozen():
    txn = (kvstore.KVTransaction().set("O", "oid1", b"\x00\xffdata")
           .rmkey("O", "x").rmkeys_by_prefix("Z"))
    assert txn.encode() == KV_GOLDEN
    assert kvstore.KVTransaction.decode(KV_GOLDEN).ops == [
        (0, "O", "oid1", b"\x00\xffdata"), (1, "O", "x", b""),
        (2, "Z", "", b"")]


def test_framed_log_record_bytes_frozen(tmp_path):
    p = str(tmp_path / "log")
    framed_log.append(p, b"record-payload", sync=False)
    with open(p, "rb") as f:
        assert f.read() == LOG_GOLDEN
    q = str(tmp_path / "golden")
    with open(q, "wb") as f:
        f.write(LOG_GOLDEN + b"\x05\x00")  # a torn tail after the record
    assert framed_log.replay(q) == [b"record-payload"]
    assert os.path.getsize(q) == len(LOG_GOLDEN)  # truncated away
    assert framed_log.scan(LOG_GOLDEN) == ref_framed_log.scan(LOG_GOLDEN)


def test_transaction_payload_frozen():
    txn = (port_store.Transaction().write("obj", 64, b"bytes")
           .setattr("obj", "a", b"v").truncate("obj", 100).remove("gone"))
    assert txn.to_bytes() == TXN_GOLDEN
    ops = port_store.Transaction.from_bytes(TXN_GOLDEN).ops
    assert [op.kind for op in ops] == [
        port_store.OpKind.WRITE, port_store.OpKind.SETATTR,
        port_store.OpKind.TRUNCATE, port_store.OpKind.REMOVE]
    assert ops[0].data == b"bytes"


# -- the twin, cross-open, adoption and the flipped byte --------------------
def _block_stacks(tmp_path, k=4, m=2, **kw):
    """A Stack over BlockStores in each package."""
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        stores = {s: PACKAGES[name].BlockStore(
            str(tmp_path / name / f"osd.{s}"), size=1 << 22)
            for s in range(k + m)}
        out[name] = Stack(pkg, plugin="isa", k=k, m=m, stores=stores, **kw)
    return out


def _blob_csums(store, oid):
    return {boff + i * store.csum_block: val
            for boff, blob in store._objects[oid].blobs.items()
            for i, val in enumerate(blob.csums)}


def _rmw_script(stacks, rng, k=4):
    """Appends, a full-stripe overwrite, a small parity-delta overwrite
    and an unaligned one, on both stacks."""
    stripe = k * PAGE
    ops = [("a", 0, payload(rng, 2 * stripe)),
           ("a", 2 * stripe, payload(rng, 3 * stripe)),
           ("b", 0, payload(rng, stripe + 100)),
           ("a", stripe, payload(rng, stripe)),
           ("a", 37, payload(rng, 300)),
           ("b", 5000, payload(rng, 9000))]
    for oid, off, data in ops:
        for st in stacks.values():
            done = []
            st.rmw.submit(oid, off, data, done.append)
            assert done and done[0].error is None
    return ops


def test_twin_blockstores_equal(tmp_path, rng):
    """The same RMW transactions into port and ceph_tpu BlockStores:
    object bytes, attrs, blob csums and the device files are equal (the
    port's appends carry the fused csums of Kernel B's plain form, which
    the store adopts; ceph_tpu's hash on its host: the values agree)."""
    stacks = _block_stacks(tmp_path)
    _rmw_script(stacks, rng)
    assert stacks["port"].snapshot() == stacks["ref"].snapshot()
    for s, st in stacks["port"].backend.stores.items():
        ref = stacks["ref"].backend.stores[s]
        for oid in st.list_objects():
            assert _blob_csums(st, oid) == _blob_csums(ref, oid)
        st.close()
        ref.close()
        with open(st.device_path, "rb") as f, open(ref.device_path, "rb") as g:
            assert f.read() == g.read(), f"device file of shard {s}"


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("backend", ["filestore", "blockstore"])
def test_cross_open(tmp_path, rng, writer, backend):
    """A store written by one package opens and reads back, attrs and
    all, in the other."""
    reader = "port" if writer == "ref" else "ref"
    root = tmp_path / "store"
    root.mkdir()
    st = make_store(PACKAGES[writer], backend, root)
    T = PACKAGES[writer].Transaction
    blobs = {f"o{i}": payload(rng, 5000 + 999 * i) for i in range(4)}
    for oid, data in blobs.items():
        st.queue_transactions(T().write(oid, 0, data).setattr(oid, "a",
                                                               oid.encode()))
    st.queue_transactions(T().truncate("o3", 777).zero("o2", 100, 50))
    want = {oid: (st.read(oid), st.getattrs(oid)) for oid in st.list_objects()}
    if backend == "blockstore":
        st.close()
    other = make_store(PACKAGES[reader], backend, root)
    assert {oid: (other.read(oid), other.getattrs(oid))
            for oid in other.list_objects()} == want
    # and the reader writes on, readable again by the writer
    other.queue_transactions(PACKAGES[reader].Transaction().write(
        "o0", 10, b"more"))
    if backend == "blockstore":
        other.close()
    again = make_store(PACKAGES[writer], backend, root)
    assert again.read("o0") == want["o0"][0][:10] + b"more" + \
        want["o0"][0][14:]


def test_blockstore_adopts_the_fused_csums(tmp_path, rng, monkeypatch):
    """Full-stripe appends carry Kernel B's csums (its plain form on the
    CPU); the BlockStore adopts them after the seed shift: no blob is
    hashed on the host, and every csum equals the host crc of its
    stored block."""
    k, m = 4, 2
    stores = {s: port_store.BlockStore(str(tmp_path / f"osd.{s}"),
                                       size=1 << 22) for s in range(k + m)}
    hashed = []
    real = port_store.BlockStore._csum
    monkeypatch.setattr(port_store.BlockStore, "_csum",
                        lambda self, data: hashed.append(1) or real(self, data))
    st = Stack(PORT, plugin="isa", k=k, m=m, stores=stores)
    for off in range(0, 8 * k * PAGE, 2 * k * PAGE):
        done = []
        st.rmw.submit("obj", off, payload(rng, 2 * k * PAGE), done.append)
        assert done and done[0].error is None
    assert hashed == []
    for store in stores.values():
        data = store.read("obj")
        csums = _blob_csums(store, "obj")
        assert sorted(csums) == list(range(0, len(data), store.csum_block))
        for off, val in csums.items():
            assert val == crc32c_ref(0xFFFFFFFF,
                                     data[off:off + store.csum_block])


def test_flipped_byte_under_a_blockstore(tmp_path, rng):
    """One byte flipped in shard 3's device file, under the store: a
    read raises CsumError (an IOError) and never returns wrong bytes;
    ceph_tpu's deep scrub catches only FileNotFoundError, so the scrub
    raises the same error in both packages; a degraded read with shard
    3 down is exact; after the object is taken off shard 3 and rebuilt,
    the read-back is exact and the scrub clean."""
    k, m, flip_shard = 4, 2, 3
    stacks = _block_stacks(tmp_path, k=k, m=m)
    data = payload(rng, 4 * k * PAGE)
    results = {}
    for name, st in stacks.items():
        done = []
        st.rmw.submit("obj", 0, data, done.append)
        assert done and done[0].error is None
        store = st.backend.stores[flip_shard]
        blob = store._objects["obj"].blobs[0]
        store.close()
        _flip(store.root, blob.offset + 5000)
        store = st.backend.stores[flip_shard] = PACKAGES[name].BlockStore(
            store.root, size=1 << 22)
        got = {}
        try:
            store.read("obj")
            got["read"] = None
        except IOError as e:
            got["read"] = type(e).__name__
        try:
            st.scrub("obj")
            got["scrub"] = None
        except IOError as e:
            got["scrub"] = (type(e).__name__, str(e))
        st.backend.down_shards = {flip_shard}
        got["degraded"] = st.reads.read_sync("obj", 0, len(data))
        st.backend.down_shards = set()
        store.queue_transactions(PACKAGES[name].Transaction().remove("obj"))
        st.rec.recover_object("obj", {flip_shard})
        got["healed"] = st.reads.read_sync("obj", 0, len(data))
        got["scrub_after"] = st.scrub("obj")
        got["stores"] = st.snapshot()
        results[name] = got
    port = results["port"]
    assert port["read"] == "CsumError"
    assert port["scrub"][0] == "CsumError"
    assert port["degraded"] == data and port["healed"] == data
    assert port["scrub_after"] == []
    assert port == results["ref"]
