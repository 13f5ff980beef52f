"""The port's pool snapshots and watch/notify against ceph_tpu's, on the
CPU.

Mirrors ``tests/test_snap_watch.py`` on ``ceph_tpu_torch.cluster`` with
``device="cpu"``: clone-on-first-write, snap reads, rollback (bytes,
size and xattrs), snap trim of the clone shards (``SNAP_SEP`` keys) and
watch/notify through ``IoCtx.watch`` / ``notify``. The twins run the same
seeded snapshot history through both packages' clusters: every head and
snap read, the snap list, and every OSD's store (the clones' shards
included; attrs but the reqid window ``rq``) are equal; the same
watchers see the same notifies.
"""

import threading
import time

import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

from ceph_tpu_torch.cluster import Monitor, OSDDaemon, RadosClient  # noqa: E402
from test_torch_cluster_e2e import _object_stores, twins  # noqa: E402,F401
from test_torch_dcn import time_limit  # noqa: E402


@pytest.fixture
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
    mon.osd_pool_create("snappool", 4, "rs32")
    client = RadosClient(mon, backoff=0.02)
    yield mon, daemons, client
    client.shutdown()
    for d in daemons:
        d.stop()


def payload(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8
    ).tobytes()


# -- snapshots ----------------------------------------------------------
def test_snap_read_sees_pre_snap_content(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    v1 = payload(9_000, seed=1)
    io.write("obj", v1)
    io.snap_create("s1")
    v2 = payload(7_000, seed=2)
    io.write_full("obj", v2)
    assert io.read("obj") == v2          # head moved on
    assert io.read("obj", snap="s1") == v1  # snap frozen
    assert [n for _i, n in io.snap_list()] == ["s1"]


def test_unmodified_object_serves_head_at_snap(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    v1 = payload(5_000, seed=3)
    io.write("obj", v1)
    io.snap_create("s1")
    # never written after the snap: snap read serves the head
    assert io.read("obj", snap="s1") == v1


def test_object_created_after_snap_is_absent_in_snap(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    io.snap_create("s1")
    io.write("obj", payload(3_000, seed=4))
    with pytest.raises(FileNotFoundError):
        io.read("obj", snap="s1")


def test_multiple_snaps_layered(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    v1, v2, v3 = (payload(4_000, seed=s) for s in (5, 6, 7))
    io.write("obj", v1)
    io.snap_create("s1")
    io.write_full("obj", v2)
    io.snap_create("s2")
    io.write_full("obj", v3)
    assert io.read("obj") == v3
    assert io.read("obj", snap="s2") == v2
    assert io.read("obj", snap="s1") == v1


def test_partial_overwrite_clones_whole_head(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    v1 = bytearray(payload(8_000, seed=8))
    io.write("obj", bytes(v1))
    io.snap_create("s1")
    patch = payload(512, seed=9)
    io.write("obj", patch, offset=1_000)
    assert io.read("obj", snap="s1") == bytes(v1)
    v1[1_000:1_512] = patch
    assert io.read("obj") == bytes(v1)


def test_remove_preserves_snap_content(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    v1 = payload(6_000, seed=10)
    io.write("obj", v1)
    io.snap_create("s1")
    io.remove("obj")
    with pytest.raises(FileNotFoundError):
        io.read("obj")
    assert io.read("obj", snap="s1") == v1


def test_rollback_restores_snap_state(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    v1 = payload(5_000, seed=11)
    io.write("obj", v1)
    io.snap_create("s1")
    io.write_full("obj", payload(2_000, seed=12))
    io.snap_rollback("obj", "s1")
    assert io.read("obj") == v1
    assert io.stat("obj") == len(v1)


def test_snap_remove_gcs_clones(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    io.write("obj", payload(4_000, seed=13))
    io.snap_create("s1")
    io.write_full("obj", payload(3_000, seed=14))
    assert io.read("obj", snap="s1")  # clone exists
    io.snap_remove("s1")
    with pytest.raises(FileNotFoundError):
        io.read("obj", snap="s1")
    # members trim the clone shards on tick
    for d in daemons:
        d.tick()
    from ceph_tpu_torch.cluster.osd_daemon import SNAP_SEP

    leftovers = [
        key
        for d in daemons
        for key in d.store.list_objects()
        if SNAP_SEP in key
    ]
    assert leftovers == [], leftovers


def test_snap_survives_map_wire_roundtrip(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    io.write("obj", payload(1_000, seed=15))
    io.snap_create("s1")
    from ceph_tpu_torch.cluster.osdmap import OSDMap

    m2 = OSDMap.from_bytes(mon.osdmap.to_bytes())
    assert m2.pools["snappool"].snaps == mon.osdmap.pools[
        "snappool"
    ].snaps


# -- watch / notify -----------------------------------------------------
def test_watch_notify_roundtrip(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    io.write("obj", payload(1_000, seed=20))

    events: list = []
    watcher = RadosClient(mon, backoff=0.02)
    try:
        wio = watcher.open_ioctx("snappool")
        cookie = wio.watch(
            "obj", lambda oid, data: events.append((oid, bytes(data)))
        )
        result = io.notify("obj", b"hello-watchers")
        assert result["acked"] == [cookie]
        assert result["missed"] == []
        assert events == [("obj", b"hello-watchers")]

        # unwatch: later notifies no longer reach the callback
        wio.unwatch("obj", cookie)
        result = io.notify("obj", b"again")
        assert result == {"acked": [], "missed": []}
        assert len(events) == 1
    finally:
        watcher.shutdown()


def test_notify_multiple_watchers_and_dead_watcher(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    io.write("obj", payload(1_000, seed=21))

    ev1, ev2 = [], []
    w1 = RadosClient(mon, backoff=0.02)
    w2 = RadosClient(mon, backoff=0.02)
    try:
        c1 = w1.open_ioctx("snappool").watch(
            "obj", lambda o, d: ev1.append(bytes(d))
        )
        c2 = w2.open_ioctx("snappool").watch(
            "obj", lambda o, d: ev2.append(bytes(d))
        )
        result = io.notify("obj", b"both")
        assert sorted(result["acked"]) == sorted([c1, c2])
        assert ev1 == [b"both"] and ev2 == [b"both"]

        # a watcher whose client died is reported missed (or dropped)
        w2.shutdown()
        time.sleep(0.1)
        result = io.notify("obj", b"after-death", timeout_ms=500)
        assert c1 in result["acked"]
        assert c2 not in result["acked"]
    finally:
        w1.shutdown()
        try:
            w2.shutdown()
        except Exception:
            pass


def test_notify_no_watchers_returns_empty(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    io.write("obj", payload(500, seed=22))
    assert io.notify("obj", b"x") == {"acked": [], "missed": []}


def test_object_born_between_snaps_absent_in_older_snap(cluster):
    """A later clone must not resurrect an object at a snap that
    predates its birth (the clone origin-epoch discriminator)."""
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    io.snap_create("s1")
    io.write("obj", payload(2_000, seed=30))  # born after s1
    io.snap_create("s2")
    io.write_full("obj", payload(1_000, seed=31))  # COW -> clone@s2
    assert io.read("obj", snap="s2") == payload(2_000, seed=30)
    with pytest.raises(FileNotFoundError):
        io.read("obj", snap="s1")


def test_rollback_restores_xattrs(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    io.write("obj", payload(3_000, seed=32))
    io.setxattr("obj", "color", b"blue")
    io.snap_create("s1")
    io.setxattr("obj", "color", b"red")
    io.write_full("obj", payload(500, seed=33))
    io.snap_rollback("obj", "s1")
    assert io.read("obj") == payload(3_000, seed=32)
    assert io.getxattr("obj", "color") == b"blue"


def test_pgls_hides_clones(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    io.write("obj", payload(2_000, seed=34))
    io.snap_create("s1")
    io.write_full("obj", payload(1_000, seed=35))  # creates a clone
    assert set(io.list_objects()) == {"obj"}


def test_rollback_across_truncate(cluster):
    """Snapshot COW fires for truncate like any mutation: rollback
    restores the pre-truncate bytes, size included."""
    mon, daemons, client = cluster
    io = client.open_ioctx("snappool")
    v1 = payload(6_000, seed=21)
    io.write("tr", v1)
    io.snap_create("strunc")
    io.truncate("tr", 1_000)
    io.append("tr", payload(200, seed=22))
    assert io.stat("tr") == 1_200
    # the snap still serves the original
    assert io.read("tr", snap="strunc") == v1
    io.snap_rollback("tr", "strunc")
    assert io.stat("tr") == 6_000
    assert io.read("tr") == v1


# -- twins ---------------------------------------------------------------

def _snap_history(io, seed):
    """Seeded snapshot history over four objects: overwrites, a
    truncate, a remove, a birth between snaps, a rollback and a snap
    removal. Returns the snap names still listed."""
    rng = np.random.default_rng(seed)
    blob = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()  # noqa: E731
    for i in range(4):
        io.write(f"o{i}", blob(int(rng.integers(1000, 9000))))
    io.setxattr("o0", "color", b"blue")
    io.snap_create("s1")
    io.write_full("o0", blob(2000))
    io.setxattr("o0", "color", b"red")
    io.write("o1", blob(700), offset=int(rng.integers(0, 900)))
    io.truncate("o2", 500)
    io.remove("o3")
    io.write("o4", blob(3000))  # born after s1
    io.snap_create("s2")
    io.append("o4", blob(900))
    io.write_full("o1", blob(1500))
    io.snap_create("s3")
    io.write("o2", blob(100), offset=200)
    io.snap_rollback("o0", "s1")
    io.snap_remove("s2")
    return [n for _i, n in io.snap_list()]


def _snap_reads(io, snaps):
    out = {}
    for oid in [f"o{i}" for i in range(5)]:
        for snap in [None, *snaps]:
            try:
                out[(oid, snap)] = io.read(oid, snap=snap)
            except FileNotFoundError:
                out[(oid, snap)] = None
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_snap_history_equals_the_reference(twins, seed):
    from ceph_tpu_torch.cluster.osd_daemon import SNAP_SEP

    out = []
    with time_limit(90):
        for root in ("ceph_tpu", "ceph_tpu_torch"):
            c = twins(root)
            snaps = _snap_history(c.io, seed)
            for d in c.daemons:
                d.tick()  # members trim the removed snap's clones
            out.append({
                "snaps": snaps, "reads": _snap_reads(c.io, snaps),
                "xattr": c.io.getxattr("o0", "color"),
                "listed": sorted(c.io.list_objects()),
                "stores": _object_stores(c),
            })
    assert out[1]["snaps"] == out[0]["snaps"] == ["s1", "s3"]
    assert out[1]["reads"] == out[0]["reads"]
    assert out[1]["xattr"] == out[0]["xattr"] == b"blue"
    assert out[1]["listed"] == out[0]["listed"]
    assert out[1]["stores"] == out[0]["stores"]
    clones = {key for st in out[1]["stores"].values() for key in st
              if SNAP_SEP in key}
    assert clones and not any(key.endswith(f"{SNAP_SEP}2") for key in clones)


def test_watchers_see_the_reference_notifies(twins):
    """Two watchers on one object, then one of them unwatched: both
    packages deliver the same payloads to the same watchers and ack
    the same number of them."""
    out = []
    with time_limit(60):
        for root in ("ceph_tpu", "ceph_tpu_torch"):
            c = twins(root)
            cl = importlib.import_module(f"{root}.cluster")
            c.io.write("obj", b"w" * 1000)
            events = ([], [])
            watchers = [cl.RadosClient(c.mon, backoff=0.02) for _ in events]
            try:
                ios = [w.open_ioctx("pool") for w in watchers]
                cookies = [
                    wio.watch("obj", lambda o, d, ev=ev: ev.append((o, bytes(d))))
                    for wio, ev in zip(ios, events)
                ]
                first = c.io.notify("obj", b"both")
                ios[1].unwatch("obj", cookies[1])
                second = c.io.notify("obj", b"one")
                out.append((
                    sorted(first["acked"]) == sorted(cookies),
                    second["acked"] == cookies[:1],
                    first["missed"], second["missed"], events,
                ))
            finally:
                for w in watchers:
                    w.shutdown()
    assert out[1] == out[0]
    assert out[1][:2] == (True, True)
