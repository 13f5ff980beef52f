"""The port's RADOS striper against ceph_tpu's, on the CPU.

Mirrors ``tests/test_striper.py`` on ``ceph_tpu_torch.cluster.striper``
over a port cluster (``device="cpu"``): RAID-0 geometry, sparse reads,
size recovery and model-checked random IO. The twins run the same
seeded striped writes, overwrites, sparse writes and removes through a
``StripedIoCtx`` over each package's cluster: the underlying RADOS
objects' names and bytes are equal, and so is every OSD's store (data
bytes and attrs but the reqid window ``rq``). The default layout (64 KiB
stripe unit, 4 stripes, 4 MiB objects) maps offsets as the reference's
does.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

from ceph_tpu_torch.cluster import Monitor, OSDDaemon, RadosClient  # noqa: E402
from ceph_tpu_torch.cluster.striper import StripedIoCtx  # noqa: E402
from test_torch_cluster_e2e import _object_stores, twins  # noqa: E402,F401
from test_torch_dcn import time_limit  # noqa: E402


@pytest.fixture(scope="module")
def cluster():
    mon = Monitor(device="cpu")
    daemons = []
    for i in range(5):
        mon.osd_crush_add(i)
    for i in range(5):
        d = OSDDaemon(i, mon, chunk_size=1024, tick_period=0, device="cpu")
        d.start()
        daemons.append(d)
    mon.osd_erasure_code_profile_set(
        "rs32", {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "3", "m": "2"}
    )
    mon.osd_pool_create("ecpool", 8, "rs32")
    client = RadosClient(mon, backoff=0.02)
    yield mon, daemons, client
    client.shutdown()
    for d in daemons:
        d.stop()


def make_striper(cluster, su=1024, sc=3, osz=4096):
    _, _, client = cluster
    return StripedIoCtx(
        client.open_ioctx("ecpool"),
        stripe_unit=su, stripe_count=sc, object_size=osz,
    )


# -- mirror of tests/test_striper.py -----------------------------------

def test_geometry_roundtrip():
    s = StripedIoCtx.__new__(StripedIoCtx)
    s.su, s.sc, s.rows, s.object_size = 8, 3, 4, 32
    for off in range(8 * 3 * 4 * 2 + 17):
        idx, obj_off = s._to_object(off)
        assert s._to_logical(idx, obj_off) == off
        assert 0 <= obj_off < s.object_size


def test_small_write_single_piece(cluster):
    with time_limit(60):
        st = make_striper(cluster)
        st.write("s1", b"hello")
        assert st.read("s1") == b"hello"
        assert st.stat("s1") == 5
        _, _, client = cluster
        io = client.open_ioctx("ecpool")
        assert io.read(f"s1.{0:016x}") == b"hello"


def test_large_write_spreads_pieces(cluster):
    with time_limit(60):
        st = make_striper(cluster, su=1024, sc=3, osz=2048)
        data = np.random.default_rng(0).integers(
            0, 256, 3 * 4096 + 777, dtype=np.uint8
        ).tobytes()
        st.write("big", data)
        assert st.read("big") == data
        assert st.stat("big") == len(data)
        _, _, client = cluster
        io = client.open_ioctx("ecpool")
        assert io.stat(f"big.{3:016x}") > 0


def test_sparse_read_returns_zeros(cluster):
    with time_limit(60):
        st = make_striper(cluster)
        st.write("sparse", b"tail", offset=10_000)
        got = st.read("sparse")
        assert len(got) == 10_004
        assert got[:10_000] == b"\0" * 10_000
        assert got[10_000:] == b"tail"
        assert st.read("sparse", offset=500, length=100) == b"\0" * 100


def test_overwrite_across_pieces(cluster):
    with time_limit(60):
        st = make_striper(cluster, su=512, sc=2, osz=1024)
        base = np.random.default_rng(1).integers(
            0, 256, 6_000, dtype=np.uint8
        ).tobytes()
        st.write("ow", base)
        patch = np.random.default_rng(2).integers(
            0, 256, 1_500, dtype=np.uint8
        ).tobytes()
        st.write("ow", patch, offset=700)
        expect = bytearray(base)
        expect[700:2_200] = patch
        assert st.read("ow") == bytes(expect)


def test_remove_drops_every_piece(cluster):
    with time_limit(60):
        st = make_striper(cluster, su=512, sc=2, osz=1024)
        st.write("rm", b"x" * 5_000)
        st.remove("rm")
        with pytest.raises(FileNotFoundError):
            st.stat("rm")
        with pytest.raises(FileNotFoundError):
            st.remove("rm")
        _, _, client = cluster
        io = client.open_ioctx("ecpool")
        with pytest.raises(FileNotFoundError):
            io.stat(f"rm.{0:016x}")


def test_sparse_write_skipping_whole_object_sets(cluster):
    with time_limit(60):
        st = make_striper(cluster, su=1024, sc=3, osz=4096)
        st.write("gap", b"a")
        st.write("gap", b"b", offset=30_000)
        assert st.stat("gap") == 30_001
        got = st.read("gap")
        assert got[0:1] == b"a" and got[30_000:] == b"b"
        assert got[1:30_000] == b"\0" * 29_999
        st.remove("gap")
        with pytest.raises(FileNotFoundError):
            st.stat("gap")
        st.write("high", b"z", offset=50_000)
        assert st.stat("high") == 50_001
        assert st.read("high", 50_000, 1) == b"z"
        st.remove("high")


def test_model_checked_random_io(cluster):
    with time_limit(60):
        st = make_striper(cluster, su=256, sc=3, osz=1024)
        rng = np.random.default_rng(42)
        model = bytearray()
        for _ in range(25):
            off = int(rng.integers(0, 8_000))
            ln = int(rng.integers(1, 2_000))
            blob = rng.integers(0, 256, ln, dtype=np.uint8).tobytes()
            st.write("mc", blob, offset=off)
            if len(model) < off + ln:
                model.extend(b"\0" * (off + ln - len(model)))
            model[off:off + ln] = blob
            r_off = int(rng.integers(0, len(model)))
            r_ln = int(rng.integers(1, len(model) - r_off + 1))
            assert st.read("mc", r_off, r_ln) == \
                bytes(model[r_off:r_off + r_ln])
        assert st.stat("mc") == len(model)
        assert st.read("mc") == bytes(model)


# -- twins ---------------------------------------------------------------

def test_default_layout_maps_offsets_as_the_reference():
    """The default layout (su 64 KiB, sc 4, 4 MiB objects): every
    offset's piece and in-piece offset, and the extent split of ranges
    across object sets, equal ceph_tpu's."""
    ref_cls = importlib.import_module("ceph_tpu.cluster.striper").StripedIoCtx
    port, ref = StripedIoCtx(None), ref_cls(None)
    assert (port.su, port.sc, port.rows, port.object_size) == \
        (ref.su, ref.sc, ref.rows, ref.object_size) == (65536, 4, 64, 1 << 22)
    rng = np.random.default_rng(5)
    for off in rng.integers(0, 64 << 20, 2000):
        assert port._to_object(int(off)) == ref._to_object(int(off))
    for off, ln in rng.integers(0, 40 << 20, (200, 2)):
        assert port._extents(int(off), int(ln)) == ref._extents(int(off), int(ln))


def _striped_ops(seed):
    """Seeded striped IO: writes, overwrites across pieces, a sparse
    write past an absent object set, and a remove."""
    rng = np.random.default_rng(seed)
    blob = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()  # noqa: E731
    return [
        ("write", "a", 0, blob(3 * 4096 + 777)),
        ("write", "a", 700, blob(1500)),
        ("write", "b", 30_000, blob(5)),
        ("write", "b", 0, blob(9)),
        ("write", "c", 0, blob(5000)),
        ("remove", "c"),
        ("write", "d", int(rng.integers(0, 8000)), blob(2000)),
    ]


@pytest.mark.parametrize("seed", [1, 2])
def test_striped_objects_equal_the_reference(twins, seed):
    """The same striped ops through both packages: the same underlying
    RADOS object names with the same bytes, the same striped reads and
    sizes, and equal stores on every OSD."""
    ops = _striped_ops(seed)
    out = []
    with time_limit(90):
        for root in ("ceph_tpu", "ceph_tpu_torch"):
            c = twins(root)
            cls = importlib.import_module(f"{root}.cluster.striper").StripedIoCtx
            st = cls(c.io, stripe_unit=1024, stripe_count=3, object_size=4096)
            for name, oid, *args in ops:
                if name == "write":
                    st.write(oid, args[1], offset=args[0])
                else:
                    st.remove(oid)
            names = sorted(c.io.list_objects())
            out.append({
                "names": names,
                "pieces": {n: c.io.read(n) for n in names},
                "reads": {o: (st.read(o), st.stat(o)) for o in "abd"},
                "stores": _object_stores(c),
            })
    assert out[1]["names"] == out[0]["names"]
    assert not any(n.startswith("c.") for n in out[1]["names"])
    assert out[1]["pieces"] == out[0]["pieces"]
    assert out[1]["reads"] == out[0]["reads"]
    assert out[1]["stores"] == out[0]["stores"]
