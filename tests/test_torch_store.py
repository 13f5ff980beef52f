"""The port's Transaction and MemStore (``store/``) against ceph_tpu's,
byte for byte (tolerance 0), on the CPU, and a store carried across the
two packages with ``MemStore.from_snapshot``.

The transaction cases mirror the MemStore leg of ``tests/test_store.py``:
each script of transactions runs on a ceph_tpu MemStore and a port
MemStore, and the objects, attrs, commit sequence numbers and errors
must agree, as must ``Transaction.to_bytes``. Then a store written by
one package is read, recovered and scrubbed clean by the other.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_rmw import (  # noqa: E402,F401
    _clean_inject, PAGE, PORT, REF, Stack, payload, store_snapshot,
)

K, M = 4, 2


def txn(pkg, ops):
    t = pkg.store.Transaction()
    for name, *args in ops:
        getattr(t, name)(*args)
    return t


# Each script: a list of transactions, each a list of (method, *args).
SCRIPTS = {
    "roundtrip": [[("write", "o", 0, b"hello")]],
    "zero_fill": [[("write", "o", 8, b"xy")]],
    "overwrite": [[("write", "o", 0, b"aaaaaaaa")], [("write", "o", 2, b"BB")]],
    "zero_truncate": [[("write", "o", 0, b"abcdefgh")], [("zero", "o", 2, 3)],
                      [("truncate", "o", 4)], [("truncate", "o", 6)]],
    "zero_extends": [[("write", "o", 0, b"ab")], [("zero", "o", 4, 4)]],
    "touch": [[("touch", "o")]],
    "remove": [[("write", "o", 0, b"x")], [("remove", "o")]],
    "recreate": [[("write", "o", 0, b"old")],
                 [("remove", "o"), ("write", "o", 0, b"new")]],
    "attrs": [[("touch", "o"), ("setattr", "o", "a", b"1"),
               ("setattr", "o", "b", b"2")], [("rmattr", "o", "a")],
              [("rmattr", "o", "zz", True)]],
    "atomic_fail": [[("write", "o", 0, b"keep")],
                    [("write", "o", 0, b"clobber"), ("remove", "missing")]],
    "rmattr_missing": [[("touch", "o")], [("rmattr", "o", "nope")]],
    "remove_missing": [[("remove", "nope")]],
    "list": [[("touch", "b"), ("touch", "a")]],
}


def run_script(pkg, script):
    st = pkg.store.MemStore()
    trace = []
    for ops in script:
        t = txn(pkg, ops)
        try:
            trace.append(("seq", st.queue_transactions(t)))
        except (FileNotFoundError, KeyError) as e:
            trace.append((type(e).__name__, str(e)))
    return trace, store_snapshot(st), st


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_memstore_scripts_match(name):
    a_trace, a_snap, _ = run_script(REF, SCRIPTS[name])
    b_trace, b_snap, b = run_script(PORT, SCRIPTS[name])
    assert a_trace == b_trace
    assert a_snap == b_snap
    for oid in b.list_objects():
        assert b.stat(oid) == len(b_snap[oid][0])


def test_short_read_and_missing_errors():
    for pkg in (REF, PORT):
        st = pkg.store.MemStore()
        st.queue_transactions(txn(pkg, [("write", "o", 0, b"abc")]))
        assert st.read("o", 2, 100) == b"c"
        with pytest.raises(FileNotFoundError):
            st.stat("nope")
        with pytest.raises(FileNotFoundError):
            st.getattr("nope", "a")
        assert st.queue_transactions([txn(pkg, [("write", "p", 0, b"v1")]),
                                      txn(pkg, [("write", "p", 0, b"v2")])]) == 2
        assert st.read("p") == b"v2"


@pytest.mark.parametrize("with_csums", [False, True])
def test_transaction_wire_bytes_match(with_csums):
    kw = {"csums": (1, 2, 0xFFFFFFFF), "csum_block": 4096} if with_csums else {}
    raws = []
    for pkg in (REF, PORT):
        t = pkg.store.Transaction().touch("o")
        t.write("o", 4096, b"\x07" * 12288, **kw)
        t.zero("o", 0, 10).truncate("o", 20000).setattr("o", "k", b"v")
        t.rmattr("o", "k").rmattr("o", "gone", ignore_missing=True)
        t.remove("o")
        raws.append(t.to_bytes())
    assert raws[0] == raws[1]
    back = PORT.store.Transaction.from_bytes(raws[0])
    assert back.to_bytes() == raws[0] and back.oids() == ["o"]
    assert REF.store.Transaction.from_bytes(raws[1]).to_bytes() == raws[1]


def test_from_snapshot_round_trip():
    ref = REF.store.MemStore("a")
    ref.queue_transactions(txn(REF, [
        ("write", "x", 0, b"abc"), ("setattr", "x", "k", b"v"), ("touch", "y")]))
    snap = store_snapshot(ref)
    port = PORT.store.MemStore.from_snapshot("b", snap)
    assert store_snapshot(port) == snap
    port.queue_transactions(txn(PORT, [("write", "x", 1, b"Z")]))
    assert snap["x"][0] == b"abc"  # the snapshot is a copy


def _ref_store_from(snapshot, name):
    """ceph_tpu MemStore holding ``snapshot``, built with transactions
    (its MemStore has no from_snapshot)."""
    st = REF.store.MemStore(name)
    for oid, (data, attrs) in snapshot.items():
        ops = [("touch", oid), ("write", oid, 0, data)]
        ops += [("setattr", oid, k, v) for k, v in sorted(attrs.items())]
        st.queue_transactions(txn(REF, ops))
    return st


def _prime(st):
    """A fresh pipeline learns sizes, HashInfo and eversions from the
    stored attrs (the new-primary takeover path)."""
    pkg = st.pkg
    store0 = st.backend.stores[0]
    for oid in store0.list_objects():
        size, ev = pkg.rmw.parse_oi(store0.getattr(oid, pkg.rmw.OI_KEY))
        hinfo = pkg.HashInfo.from_bytes(
            store0.getattr(oid, pkg.rmw.HINFO_KEY), **pkg.kw)
        st.rmw.prime_object(oid, size, hinfo, ev)


def _write_objects(st, rng):
    contents = {}
    for i in range(3):
        data = payload(rng, (i + 1) * K * PAGE + 101 * i)
        st.rmw.submit(f"obj{i}", 0, data)
        contents[f"obj{i}"] = data
    patch = payload(rng, 700)
    st.rmw.submit("obj2", 5000, patch)
    c = bytearray(contents["obj2"])
    c[5000:5700] = patch
    contents["obj2"] = bytes(c)
    return contents


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_store_carried_across_reads_recovers_scrubs(rng, direction):
    src_pkg, dst_pkg = (REF, PORT) if direction == "ref_to_port" else (PORT, REF)
    src = Stack(src_pkg)
    contents = _write_objects(src, rng)
    snaps = src.snapshot()
    if dst_pkg is PORT:
        stores = {s: PORT.store.MemStore.from_snapshot(f"osd.{s}", snap)
                  for s, snap in snaps.items()}
    else:
        stores = {s: _ref_store_from(snap, f"osd.{s}")
                  for s, snap in snaps.items()}
    dst = Stack(dst_pkg, stores=stores)
    _prime(dst)
    assert dst.snapshot() == snaps
    for oid, data in contents.items():
        assert dst.reads.read_sync(oid, 0, len(data)) == data
        assert dst.scrub(oid) == []
    dst.backend.down_shards.update({0, 5})
    for oid, data in contents.items():
        assert dst.reads.read_sync(oid, 0, len(data)) == data
    dst.backend.down_shards.clear()
    dst.wipe(1)
    for oid in contents:
        dst.rec.recover_object(oid, {1})
    assert dst.snapshot() == snaps
    # the carried store keeps taking writes, equal to the source's; the
    # takeover continues the source's op sequence (the tid is the OI
    # eversion's version): prime_object leaves the tid alone in both
    # packages, so the caller sets it
    dst.rmw._next_tid = src.rmw._next_tid
    more = payload(rng, 3000)
    for st in (src, dst):
        st.rmw.submit("obj0", len(contents["obj0"]), more)
    assert dst.snapshot() == src.snapshot()
    assert dst.scrub("obj0") == src.scrub("obj0") == []
