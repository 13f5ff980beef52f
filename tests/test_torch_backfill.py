"""The port's rebalance backfill, pg_temp reads and garbage collection
against ceph_tpu's, on the CPU.

Mirrors ``tests/test_backfill.py`` on ``ceph_tpu_torch.cluster`` with
``device="cpu"``: an OSD marked out moves its PGs' shards to
substitutes under ``pg_temp`` (``Monitor`` pg_temp install / clear,
``OSDDaemon`` backfill), reads and writes serve from the old layout
meanwhile, the new holders carry the right shard index, stale copies are
collected, and xattrs and omap travel with the pushes. The twins run
the same seeded objects (with xattrs and omap) and the same out through
both packages' clusters, wait until ``pg_temp`` clears and every live
OSD holds exactly the shards of the new layout, then compare every
read, xattr and omap and every OSD's store (data bytes and attrs, the
``m:`` omap and ``u:`` xattr entries among them; the reqid window
``rq`` aside, and the map epoch that a write made mid-backfill stamps).
"""

import time

import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

from ceph_tpu_torch.cluster import Monitor, OSDDaemon, RadosClient  # noqa: E402
from ceph_tpu_torch.cluster.osd_daemon import make_loc, shard_key  # noqa: E402
from ceph_tpu_torch.pipeline.rmw import SI_KEY  # noqa: E402
from test_torch_cluster_e2e import _object_stores, twins  # noqa: E402,F401
from test_torch_dcn import time_limit  # noqa: E402


def payload(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8
    ).tobytes()


def wait_no_pg_temp(mon, timeout=30.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if not mon.osdmap.pg_temp:
            return
        time.sleep(0.05)
    raise TimeoutError(f"pg_temp never cleared: {mon.osdmap.pg_temp}")


@pytest.fixture
def cluster():
    mon = Monitor(device="cpu")
    daemons = []
    for i in range(7):
        mon.osd_crush_add(i)
    for i in range(7):
        d = OSDDaemon(i, mon, chunk_size=1024, device="cpu")
        d.start()
        daemons.append(d)
    mon.osd_erasure_code_profile_set(
        "rs32", {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "3", "m": "2"}
    )
    mon.osd_pool_create("ecpool", 4, "rs32")
    client = RadosClient(mon, backoff=0.02)
    yield mon, daemons, client
    client.shutdown()
    for d in daemons:
        d.stop()


def test_out_triggers_backfill_and_service_continues(cluster):
    """Mark a data-holding OSD out: its PGs backfill to substitutes,
    pg_temp clears, and every object reads back from the NEW layout."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    blobs = {f"o{i}": payload(4_000 + 311 * i, seed=i) for i in range(10)}
    for oid, b in blobs.items():
        io.write(oid, b)
    victim = mon.osdmap.object_to_acting("ecpool", "o0")[1]
    mon.osd_down(victim)
    mon.osd_out(victim)  # triggers pg_temp + backfill on primaries
    wait_no_pg_temp(mon)
    # every object readable; acting sets exclude the victim, no holes
    for oid, b in blobs.items():
        acting = mon.osdmap.object_to_acting("ecpool", oid)
        assert victim not in acting
        assert -1 not in acting
        assert io.read(oid) == b
    # and writable through the new layout
    io.write("o0", payload(500, seed=99), offset=100)


def test_backfill_populates_substitutes_with_right_shards(cluster):
    """After backfill, each new holder's store carries the shard index
    its position demands (SI attr matches), so nothing routes through
    the misplacement guard."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("obj", payload(8_000))
    before = mon.osdmap.object_to_acting("ecpool", "obj")
    victim = before[0]  # the primary itself moves out
    mon.osd_down(victim)
    mon.osd_out(victim)
    wait_no_pg_temp(mon)
    after = mon.osdmap.object_to_acting("ecpool", "obj")
    assert victim not in after
    loc = make_loc(mon.osdmap.pools["ecpool"].pool_id, "obj")
    for i, osd in enumerate(after):
        key = shard_key(loc, i)
        si = int(daemons[osd].store.getattr(key, SI_KEY).decode())
        assert si == i
    assert io.read("obj") == payload(8_000)


def test_reads_serve_during_backfill_via_pg_temp(cluster):
    """While pg_temp is installed the PG serves from the OLD layout —
    verified by reading mid-window (before the temp clears)."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    blobs = {f"b{i}": payload(6_000, seed=i) for i in range(6)}
    for oid, b in blobs.items():
        io.write(oid, b)
    victim = mon.osdmap.object_to_acting("ecpool", "b0")[2]
    mon.osd_down(victim)
    mon.osd_out(victim)
    # read immediately — pg_temp may still be up for some PGs
    for oid, b in blobs.items():
        assert io.read(oid) == b
    wait_no_pg_temp(mon)
    for oid, b in blobs.items():
        assert io.read(oid) == b


def test_added_osd_receives_data(cluster):
    """Grow the cluster: a new device joins, CRUSH remaps some PGs
    onto it, backfill populates it, and it serves reads."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    blobs = {f"g{i}": payload(5_000, seed=i) for i in range(12)}
    for oid, b in blobs.items():
        io.write(oid, b)
    new_id = 7
    mon.osd_crush_add(new_id)
    d = OSDDaemon(new_id, mon, chunk_size=1024, device="cpu")
    d.start()
    try:
        wait_no_pg_temp(mon)
        acting_sets = [
            mon.osdmap.object_to_acting("ecpool", oid) for oid in blobs
        ]
        moved = [a for a in acting_sets if new_id in a]
        if moved:  # straw2 usually remaps something out of 4 PGs
            assert d.store.list_objects()  # it actually received shards
        for oid, b in blobs.items():
            assert io.read(oid) == b
    finally:
        d.stop()


def test_backfill_gc_removes_stale_copies(cluster):
    """Members that left the layout drop their copies after backfill
    (the reference deletes backfilled-away objects)."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("obj", payload(3_000))
    acting0 = mon.osdmap.object_to_acting("ecpool", "obj")
    victim = acting0[3]
    loc = make_loc(mon.osdmap.pools["ecpool"].pool_id, "obj")
    assert daemons[victim].store.exists(shard_key(loc, 3))
    mon.osd_down(victim)
    mon.osd_out(victim)
    wait_no_pg_temp(mon)
    assert io.read("obj") == payload(3_000)
    # gc runs AFTER the temp clears — poll for it: stale shard copies
    # dropped from every live OSD no longer a holder for its key
    target = mon.osdmap.object_to_acting("ecpool", "obj")

    def leftover():
        out = []
        for i, osd in enumerate(acting0):
            if osd == victim:
                continue  # down: unreachable for gc, stale copy inert
            if i < len(target) and target[i] == osd:
                continue  # still the holder of position i
            if daemons[osd].store.exists(shard_key(loc, i)):
                out.append((i, osd))
        return out

    end = time.monotonic() + 15
    while leftover() and time.monotonic() < end:
        time.sleep(0.05)
    assert not leftover()


def test_write_during_pg_temp_window_not_lost(cluster):
    """A write that lands while the PG serves under pg_temp must
    survive the cutover to the new layout (dirty re-push)."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    for i in range(8):
        io.write(f"w{i}", payload(4_000, seed=i))
    victim = mon.osdmap.object_to_acting("ecpool", "w0")[1]
    mon.osd_down(victim)
    mon.osd_out(victim)
    # immediately overwrite while backfill may be mid-flight
    new_data = payload(4_000, seed=77)
    io.write("w0", new_data)
    wait_no_pg_temp(mon)
    assert io.read("w0") == new_data


def test_xattrs_survive_backfill(cluster):
    """User xattrs travel with backfill pushes: after a rebalance the
    new layout serves them."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("obj", payload(3_000))
    io.setxattr("obj", "owner", b"alice")
    victim = mon.osdmap.object_to_acting("ecpool", "obj")[0]
    mon.osd_down(victim)
    mon.osd_out(victim)
    wait_no_pg_temp(mon)
    assert io.getxattr("obj", "owner") == b"alice"
    assert io.getxattrs("obj") == {"owner": b"alice"}


def test_omap_survives_backfill(cluster):
    """Omap entries (m: attrs) travel with backfill pushes like user
    xattrs do."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("idx", payload(2_000))
    io.omap_set("idx", {"a": b"1", "b": b"2"})
    victim = mon.osdmap.object_to_acting("ecpool", "idx")[0]
    mon.osd_down(victim)
    mon.osd_out(victim)
    wait_no_pg_temp(mon)
    assert io.omap_get("idx") == {"a": b"1", "b": b"2"}
    assert io.omap_list("idx") == [("a", b"1"), ("b", b"2")]


# -- twins ---------------------------------------------------------------

def _misplaced(c, victim):
    """Shard keys a live OSD holds that the current layout does not
    give it (GC not done yet), and whether pg_temp is still up."""
    m = c.mon.osdmap
    out = []
    for d in c.daemons:
        if d.osd_id == victim:
            continue
        for key in d.store.list_objects():
            if "#s" not in key:
                continue
            loc, _, pos = key.rpartition("#s")
            oid = loc.split(":", 1)[1]
            if m.object_to_acting("pool", oid)[int(pos)] != d.osd_id:
                out.append((d.osd_id, key))
    return bool(m.pg_temp) or out


def _stores_but_epoch_of(c, oid, victim):
    """Every live OSD but the victim's store; the OI attr of ``oid``
    (written while backfill runs) without its epoch field: the map
    epoch such a write stamps depends on how far backfill has moved,
    which is timing in either package (its size and tid stay in)."""
    out = {osd: st for osd, st in _object_stores(c).items() if osd != victim}
    for st in out.values():
        for key, (data, attrs) in st.items():
            if key.startswith(f"1:{oid}#s") and "oi" in attrs:
                size, _epoch, tid = attrs["oi"].split(b":")
                attrs["oi"] = size + b":" + tid
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_backfill_stores_equal_the_reference(twins, seed):
    rng = np.random.default_rng(seed)
    objs = {f"b{i}": rng.integers(0, 256, int(rng.integers(2000, 12000)),
                                  dtype=np.uint8).tobytes() for i in range(8)}
    out = []
    with time_limit(120):
        for root in ("ceph_tpu", "ceph_tpu_torch"):
            c = twins(root, n=7)
            for oid, data in objs.items():
                c.io.write(oid, data)
            c.io.setxattr("b0", "owner", b"alice")
            c.io.omap_set("b1", {"a": b"1", "b": b"2"})
            victim = c.mon.osdmap.object_to_acting("pool", "b0")[0]
            c.mon.osd_down(victim)
            c.mon.osd_out(victim)
            during = {oid: c.io.read(oid) for oid in objs}
            c.io.write("b2", b"during-backfill", offset=100)
            deadline = time.monotonic() + 60
            while _misplaced(c, victim):
                assert time.monotonic() < deadline, _misplaced(c, victim)
                time.sleep(0.05)
            out.append({
                "victim": victim, "during": during,
                "reads": {oid: c.io.read(oid) for oid in objs},
                "xattrs": c.io.getxattrs("b0"),
                "omap": c.io.omap_list("b1"),
                "acting": {oid: c.mon.osdmap.object_to_acting("pool", oid)
                           for oid in objs},
                "stores": _stores_but_epoch_of(c, "b2", victim),
            })
    assert out[1]["victim"] == out[0]["victim"]
    assert out[1]["during"] == out[0]["during"] == objs
    assert out[1]["reads"] == out[0]["reads"]
    assert out[1]["xattrs"] == out[0]["xattrs"] == {"owner": b"alice"}
    assert out[1]["omap"] == out[0]["omap"] == [("a", b"1"), ("b", b"2")]
    assert out[1]["acting"] == out[0]["acting"]
    assert not any(out[1]["victim"] in a for a in out[1]["acting"].values())
    assert out[1]["stores"] == out[0]["stores"]
