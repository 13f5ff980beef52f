"""The port's cluster tier end to end (monitor, OSD daemons, RADOS
client over sockets) against ceph_tpu's, on the CPU.

The mirrors run the deterministic cases of the reference's
``tests/test_cluster_e2e.py``, ``tests/test_op_shards.py`` (booted with
the port's own daemons: its load generator is not ported),
``tests/test_qos.py`` (the cases without the load generator) and
``tests/test_cluster_plugins.py`` against ``ceph_tpu_torch`` with
``device="cpu"``. The reference's device-route case reads the
reference's counter names (``einsum_*``); its mirror reads the port's
(``kernel_*`` / ``sched_*`` on a card, ``plain_*`` here).

The twin cases run the same seeded ops serially through a ceph_tpu
cluster and a port cluster: the client reads are equal, and so is every
OSD's store in data bytes and HINFO (the OI attr carries the eversion,
whose tid follows the daemons' own op counters, and the reqid attr a
client nonce: both are left out and named). A cluster state written by
ceph_tpu (its ``OSDMap`` bytes and every OSD's store) serves from the
port: ``Monitor(initial=OSDMap.from_bytes(...))`` and
``OSDDaemon(..., store=MemStore.from_snapshot(...))``, and every object
reads back through the port's ``RadosClient``.

Every daemon binds ``127.0.0.1:0``, every wait has a deadline, and every
client and daemon is shut down in the fixtures' teardown.
"""

import numpy as np
import pytest
import threading
import time
import zlib
from types import SimpleNamespace

torch = pytest.importorskip("torch")

from ceph_tpu_torch.cluster import Monitor, OSDDaemon, RadosClient  # noqa: E402
from ceph_tpu_torch.utils.config import config  # noqa: E402
from ceph_tpu_torch.cluster.qos import (  # noqa: E402
    COST_QUANTUM_BYTES,
    MCLOCK_PROFILES,
    QoSSpec,
    class_label,
    client_class,
    derive_profiles,
)
from ceph_tpu_torch.msg.messages import OSDOp  # noqa: E402


# -- mirror of tests/test_cluster_e2e.py -----------------------------

@pytest.fixture
def cluster():
    """mon + 6 OSDs + EC(3,2) pool + connected client."""
    mon = Monitor(device="cpu")
    daemons = []
    for i in range(6):
        mon.osd_crush_add(i, zone=f"z{i % 3}")
    for i in range(6):
        d = OSDDaemon(i, mon, chunk_size=1024, device="cpu")
        d.start()
        daemons.append(d)
    mon.osd_erasure_code_profile_set(
        "rs32", {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "3", "m": "2"}
    )
    mon.osd_pool_create("ecpool", 8, "rs32")
    client = RadosClient(mon, backoff=0.01)
    yield mon, daemons, client
    client.shutdown()
    for d in daemons:
        d.stop()


def payload(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8
    ).tobytes()


def execute_retry(d, make_op, tries=80, delay=0.05):
    """Drive a daemon-direct op through the ASYNC durability fan-out
    the way the objecter's backoff would: the first attempt spawns
    the poll on its own thread and answers eagain; a later attempt
    consumes the cached verdict. ``make_op`` must build a FRESH OSDOp
    per attempt (the daemon rewrites msg.oid/msg.op in place)."""
    import time as _time

    for _ in range(tries):
        r = d._execute_client_op(make_op())
        if r.error != "eagain":
            return r
        _time.sleep(delay)
    return r


def test_write_read_roundtrip_over_wire(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    data = payload(10_000)
    size = io.write("obj", data)
    assert size == 10_000
    assert io.read("obj") == data
    assert io.stat("obj") == 10_000


def test_partial_read_and_overwrite(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    data = bytearray(payload(8_000))
    io.write("obj", bytes(data))
    patch = payload(500, seed=1)
    io.write("obj", patch, offset=2_000)
    data[2_000:2_500] = patch
    assert io.read("obj", offset=1_900, length=800) == bytes(
        data[1_900:2_700]
    )
    assert io.read("obj") == bytes(data)


def test_many_objects_spread_over_primaries(cluster):
    """Different objects hash to different PGs/primaries; every one
    round-trips (multi-primary routing, not a single-server accident)."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    blobs = {}
    for i in range(12):
        blobs[f"o{i}"] = payload(1_500 + 37 * i, seed=i)
        io.write(f"o{i}", blobs[f"o{i}"])
    primaries = {
        mon.osdmap.primary("ecpool", oid) for oid in blobs
    }
    assert len(primaries) > 1
    for oid, blob in blobs.items():
        assert io.read(oid) == blob


def test_missing_object_and_pool_errors(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    with pytest.raises(FileNotFoundError):
        io.read("ghost")
    with pytest.raises(FileNotFoundError):
        io.stat("ghost")
    with pytest.raises(FileNotFoundError):
        io.remove("ghost")
    with pytest.raises(FileNotFoundError):
        client.open_ioctx("nopool")


def test_remove_roundtrip(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("obj", payload(3_000))
    io.remove("obj")
    with pytest.raises(FileNotFoundError):
        io.read("obj")
    # recreate after remove
    io.write("obj", b"fresh")
    assert io.read("obj") == b"fresh"


def test_wrong_primary_resends_after_map_change(cluster):
    """Kill an object's primary: the monitor marks it down, the next
    live shard-holder serves, and the client's retry loop lands there
    (Objecter resend-on-map-change)."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    data = payload(6_000)
    io.write("obj", data)
    primary = mon.osdmap.primary("ecpool", "obj")
    daemons[primary].stop()
    mon.osd_down(primary)  # failure detection, collapsed to a command
    new_primary = mon.osdmap.primary("ecpool", "obj")
    assert new_primary != primary
    before = client.objecter.resends
    got = io.read("obj")  # degraded read through the new primary
    assert got == data
    assert client.objecter.resends >= before


def test_degraded_write_then_heal_read(cluster):
    """Writes succeed with one OSD down (k+m-1 live shards); reads see
    the full object."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    victim = mon.osdmap.object_to_acting("ecpool", "obj")[-1]  # a non-primary
    daemons[victim].stop()
    mon.osd_down(victim)
    data = payload(5_000)
    io.write("obj", data)
    assert io.read("obj") == data


def test_failover_primary_recovers_object_state(cluster):
    """After primary failover, the NEW primary recovers object size +
    crc state from stored attrs (OI/hinfo) and serves overwrites
    correctly — the object_info_t takeover path."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    data = bytearray(payload(7_000))
    io.write("obj", bytes(data))
    primary = mon.osdmap.primary("ecpool", "obj")
    daemons[primary].stop()
    mon.osd_down(primary)
    # overwrite through the new primary: needs the recovered size
    patch = payload(400, seed=2)
    io.write("obj", patch, offset=6_800)  # extends to 7_200
    data[6_800:7_000] = patch[:200]
    data.extend(patch[200:])
    assert io.stat("obj") == 7_200
    assert io.read("obj") == bytes(data)


def test_zero_length_write_is_ordered_noop(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("obj", b"")
    io.write("obj", b"abc")
    io.write("obj", b"", offset=100)
    assert io.read("obj") == b"abc"


def test_returning_member_catches_up_from_log(cluster):
    """Write while a member is down, bring it back: the primary replays
    the op log onto it (delta recovery) and a read served FROM that
    member's shard returns the new bytes — not its stale ones."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    data = payload(9_000)
    io.write("obj", data)
    acting = mon.osdmap.object_to_acting("ecpool", "obj")
    victim = acting[1]  # a non-primary data shard
    mon.osd_down(victim)  # down, NOT stopped: store survives, stale
    data2 = payload(9_000, seed=3)
    io.write("obj", data2)  # victim misses this entirely
    mon.osd_boot(victim, daemons[victim].addr)  # returns; log recovery
    # force reads to use the returned member: take down a different
    # data shard so decode MUST include victim's shard
    other = next(
        o for o in mon.osdmap.object_to_acting("ecpool", "obj")
        if o not in (victim, acting[0]) and o != -1
    )
    daemons[other].stop()
    mon.osd_down(other)
    assert io.read("obj") == data2


def test_remove_succeeds_with_write_time_hole(cluster):
    """An object written while one member was down can still be
    removed after that member returns (no ENOENT from the shard that
    never got it)."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    victim = mon.osdmap.object_to_acting("ecpool", "obj")[2]
    mon.osd_down(victim)
    io.write("obj", payload(2_000))
    mon.osd_boot(victim, daemons[victim].addr)
    io.remove("obj")
    with pytest.raises(FileNotFoundError):
        io.stat("obj")


def test_peer_failure_reports_reach_monitor(cluster):
    """OSDs that observe a dead peer report it; the monitor marks it
    down once two distinct reporters agree."""
    mon, daemons, client = cluster
    victim = 5
    daemons[victim].stop()
    # two daemons observe the death (heartbeat seam, forced here)
    for reporter in (0, 1):
        daemons[reporter].peers.down_shards.add(victim)
        daemons[reporter].report_down_peers()
    assert not mon.osdmap.is_up(victim)


def test_aio_surface(cluster):
    """librados aio contract: parallel completions, callbacks, errors
    surfaced through wait_for_complete."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    blobs = {f"a{i}": payload(3_000, seed=i) for i in range(6)}
    comps = [io.aio_write(oid, b) for oid, b in blobs.items()]
    for c in comps:
        c.wait_for_complete(timeout=30)
    fired = []
    reads = [
        io.aio_read(oid, on_complete=lambda c, o=oid: fired.append(o))
        for oid in blobs
    ]
    for oid, c in zip(blobs, reads):
        assert c.wait_for_complete(timeout=30).data == blobs[oid]
    assert sorted(fired) == sorted(blobs)
    bad = io.aio_read("ghost")
    with pytest.raises(FileNotFoundError):
        bad.wait_for_complete(timeout=30)
    assert bad.is_complete()


def test_log_blind_return_gets_full_refresh(cluster):
    """A member that returns to a PG whose instance was REBUILT while
    it was gone (primary failover) missed writes the new log never
    saw: it must be fully refreshed from survivors before serving —
    otherwise decode would mix its stale shard into reads."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    data = payload(9_000)
    io.write("obj", data)
    acting = mon.osdmap.object_to_acting("ecpool", "obj")
    primary, member = acting[0], acting[2]
    mon.osd_down(member)      # member gone (store keeps stale bytes)
    daemons[primary].stop()   # primary dies: PG rebuilt elsewhere,
    mon.osd_down(primary)     # born with member's slot a hole
    data2 = payload(9_000, seed=9)
    io.write("obj", data2)    # the new log never saw member's gap
    mon.osd_boot(member, daemons[member].addr)  # full refresh path
    # wait for the refresh to LAND (the member admitted back into
    # the serving set) — killing survivors while the refresh is
    # mid-flight makes the rebuild impossible (fewer than k sources)
    # and turns the test into a coin flip on thread scheduling (the
    # round-8 "log_blind_return" flake, reproduced on the seed)
    import time

    pgid = mon.osdmap.object_to_pg("ecpool", "obj")

    def _refreshed() -> bool:
        acting = mon.osdmap.object_to_acting("ecpool", "obj")
        prim = next((o for o in acting if o != -1), None)
        if prim is None:
            return False
        pg = daemons[prim]._pgs.get(("ecpool", pgid))
        return (
            pg is not None
            and member in pg.acting
            and not pg.backend.recovering
            and pg.peered.is_set()
        )

    end = time.monotonic() + 20
    while not _refreshed() and time.monotonic() < end:
        time.sleep(0.05)
    assert _refreshed(), "returned member never re-admitted"
    # force reads through the refreshed member: down enough others
    # that decode MUST use its shard
    others = [
        o for o in mon.osdmap.object_to_acting("ecpool", "obj")
        if o not in (member, -1)
    ]
    # leave exactly k=3 live members INCLUDING the refreshed one
    for o in others[2:]:
        daemons[o].stop()
        mon.osd_down(o)
    end = time.monotonic() + 20
    while True:
        try:
            assert io.read("obj") == data2
            break
        except (IOError, Exception) as e:
            if isinstance(e, AssertionError) or time.monotonic() > end:
                raise
            time.sleep(0.1)


def test_object_deleted_during_gap_not_resurrected(cluster):
    """An object removed while a log-blind member was away must not be
    resurrected by its stale copy when the member returns."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("obj", payload(4_000))
    acting = mon.osdmap.object_to_acting("ecpool", "obj")
    primary, member = acting[0], acting[1]
    mon.osd_down(member)
    daemons[primary].stop()
    mon.osd_down(primary)
    io.remove("obj")                      # removed during the gap
    mon.osd_boot(member, daemons[member].addr)
    import time

    end = time.monotonic() + 10
    loc_keys = lambda: [
        k for k in daemons[member].store.list_objects() if "obj" in k
    ]
    while loc_keys() and time.monotonic() < end:
        time.sleep(0.05)
    assert not loc_keys()                 # stale copy purged
    with pytest.raises(FileNotFoundError):
        io.stat("obj")


def test_pool_deletion_gcs_shard_data(cluster):
    """osd_pool_rm sweeps the pool's shard keys off every OSD (the
    async pool-deletion GC); other pools' data is untouched."""
    import time

    mon, daemons, client = cluster
    mon.osd_erasure_code_profile_set(
        "rs21", {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "2", "m": "1"}
    )
    mon.osd_pool_create("doomed", 4, "rs21")
    io_keep = client.open_ioctx("ecpool")
    io_doom = client.open_ioctx("doomed")
    io_keep.write("keep", payload(2_000))
    io_doom.write("bye", payload(2_000))
    doomed_id = mon.osdmap.pools["doomed"].pool_id
    mon.osd_pool_rm("doomed")
    end = time.monotonic() + 15

    def leftovers():
        return [
            k for d in daemons for k in d.store.list_objects()
            if k.startswith(f"{doomed_id}:")
        ]

    while leftovers() and time.monotonic() < end:
        time.sleep(0.05)
    assert not leftovers()
    assert io_keep.read("keep") == payload(2_000)


def test_rados_ls_lists_through_primaries(cluster):
    """IoCtx.list_objects is the PGLS surface: complete across PGs and
    primaries, excludes removed objects, and still works degraded."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    names = sorted(f"ls/{i}" for i in range(10))
    for n in names:
        io.write(n, payload(700, seed=len(n)))
    assert io.list_objects() == names
    io.remove(names[3])
    expect = names[:3] + names[4:]
    assert io.list_objects() == expect
    victim = mon.osdmap.object_to_acting("ecpool", names[0])[0]
    daemons[victim].stop()
    mon.osd_down(victim)
    assert io.list_objects() == expect  # new primaries serve the list


def test_xattr_surface(cluster):
    """librados xattr contract over the wire: set/get/rm/getxattrs,
    enodata for absent names, enoent for absent objects."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("obj", payload(2_000))
    io.setxattr("obj", "owner", b"alice")
    io.setxattr("obj", "tag", b"blue")
    assert io.getxattr("obj", "owner") == b"alice"
    assert io.getxattrs("obj") == {"owner": b"alice", "tag": b"blue"}
    io.setxattr("obj", "owner", b"bob")  # overwrite
    assert io.getxattr("obj", "owner") == b"bob"
    io.rmxattr("obj", "tag")
    with pytest.raises(KeyError):
        io.getxattr("obj", "tag")
    assert io.getxattrs("obj") == {"owner": b"bob"}
    with pytest.raises(FileNotFoundError):
        io.getxattr("ghost", "x")
    with pytest.raises(FileNotFoundError):
        io.setxattr("ghost", "x", b"v")


def test_xattrs_replay_to_returning_member(cluster):
    """xattr mutations made while a member was down replay onto it
    (set AND tombstone) so a failover onto that member serves the
    current attrs."""
    import time

    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("obj", payload(2_000))
    io.setxattr("obj", "keep", b"v1")
    io.setxattr("obj", "doomed", b"x")
    acting = mon.osdmap.object_to_acting("ecpool", "obj")
    victim = acting[1]
    mon.osd_down(victim)
    io.setxattr("obj", "keep", b"v2")    # missed by victim
    io.rmxattr("obj", "doomed")          # tombstone missed too
    mon.osd_boot(victim, daemons[victim].addr)
    # replay is async: poll the victim's stored attrs directly
    from ceph_tpu_torch.cluster.osd_daemon import make_loc, shard_key

    key = shard_key(
        make_loc(mon.osdmap.pools["ecpool"].pool_id, "obj"), 1
    )
    end = time.monotonic() + 15
    while time.monotonic() < end:
        try:
            attrs = daemons[victim].store.getattrs(key)
            if attrs.get("u:keep") == b"v2" and "u:doomed" not in attrs:
                break
        except FileNotFoundError:
            pass
        time.sleep(0.05)
    attrs = daemons[victim].store.getattrs(key)
    assert attrs.get("u:keep") == b"v2"
    assert "u:doomed" not in attrs


def test_omap_surface(cluster):
    """rados omap contract: batched set/rm, keyed get, sorted paged
    listing — and replication to returning members via the same
    logged-attr replay as xattrs."""
    import time

    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("idx", payload(1_000))
    io.omap_set("idx", {f"k{i:03d}": f"v{i}".encode() for i in range(10)})
    assert io.omap_get("idx", ["k003", "k007"]) == {
        "k003": b"v3", "k007": b"v7"
    }
    assert len(io.omap_get("idx")) == 10
    # sorted pagination
    page1 = io.omap_list("idx", max_return=4)
    assert [k for k, _ in page1] == ["k000", "k001", "k002", "k003"]
    page2 = io.omap_list("idx", after=page1[-1][0], max_return=4)
    assert [k for k, _ in page2] == ["k004", "k005", "k006", "k007"]
    io.omap_rm("idx", ["k000", "k001"])
    assert [k for k, _ in io.omap_list("idx", max_return=2)] == [
        "k002", "k003"
    ]
    # replication: a member down during mutations replays them
    acting = mon.osdmap.object_to_acting("ecpool", "idx")
    victim = acting[1]
    mon.osd_down(victim)
    io.omap_set("idx", {"k999": b"late"})
    io.omap_rm("idx", ["k002"])
    mon.osd_boot(victim, daemons[victim].addr)
    from ceph_tpu_torch.cluster.osd_daemon import make_loc, shard_key

    key = shard_key(make_loc(mon.osdmap.pools["ecpool"].pool_id, "idx"), 1)
    end = time.monotonic() + 15
    while time.monotonic() < end:
        attrs = daemons[victim].store.getattrs(key)
        if attrs.get("m:k999") == b"late" and "m:k002" not in attrs:
            break
        time.sleep(0.05)
    attrs = daemons[victim].store.getattrs(key)
    assert attrs.get("m:k999") == b"late"
    assert "m:k002" not in attrs
    with pytest.raises(FileNotFoundError):
        io.omap_get("ghost")


def test_resent_remove_replays_cached_result(cluster):
    """Lost-reply resend semantics (pg-log reqid dedup analog): a
    remove whose first attempt applied but whose reply was lost must
    NOT surface enoent when retried under the same reqid — and a
    resent write must not re-apply."""
    from ceph_tpu_torch.msg.messages import OSDOp

    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("victim", payload(3_000))

    # Find the primary and replay the same logical op twice, as the
    # objecter's resend path would after a reply loss.
    primary = mon.osdmap.primary("ecpool", "victim")
    d = next(dd for dd in daemons if dd.osd_id == primary)
    op1 = OSDOp(901, mon.osdmap.epoch, "ecpool", "victim", "remove",
                reqid="clientX.1")
    r1 = d._execute_client_op(op1)
    assert r1.error == ""
    op2 = OSDOp(902, mon.osdmap.epoch, "ecpool", "victim", "remove",
                reqid="clientX.1")
    r2 = d._execute_client_op(op2)
    assert r2.error == "", "resent remove must replay success, not enoent"

    # A NEW logical remove (fresh reqid) now correctly sees enoent.
    op3 = OSDOp(903, mon.osdmap.epoch, "ecpool", "victim", "remove",
                reqid="clientX.2")
    assert d._execute_client_op(op3).error == "enoent"

    # Write resend: the replay returns the recorded result and does
    # NOT re-apply. Sequence: write A (reqid W1), then write B (fresh
    # reqid) over it, then resend W1 — content must stay B.
    a, b = payload(2_000, seed=10), payload(2_000, seed=11)
    primary_w = mon.osdmap.primary("ecpool", "wobj")
    dw = next(dd for dd in daemons if dd.osd_id == primary_w)
    w1 = OSDOp(910, mon.osdmap.epoch, "ecpool", "wobj", "write",
               data=a, reqid="clientX.w1")
    r_w1 = dw._execute_client_op(w1)
    assert r_w1.error == "" and r_w1.size == 2_000
    w2 = OSDOp(911, mon.osdmap.epoch, "ecpool", "wobj", "write",
               data=b, reqid="clientX.w2")
    assert dw._execute_client_op(w2).error == ""
    w1_again = OSDOp(912, mon.osdmap.epoch, "ecpool", "wobj", "write",
                     data=a, reqid="clientX.w1")
    r_replay = dw._execute_client_op(w1_again)
    assert r_replay.error == "" and r_replay.size == r_w1.size
    assert io.read("wobj") == b, "resent write must not re-apply"


def test_divergent_member_rolled_back_on_return(cluster):
    """Eversion divergence (the rewind_divergent_log role): a member
    that applied writes the cluster never committed — the partitioned
    ex-primary case — returns through the log-vouch path. Its stamp
    disagrees with authoritative history, so the shard's bytes are
    rebuilt from survivors, and a phantom object only it holds is
    removed. Without eversions this was indistinguishable from a
    clean catch-up (the CAPABILITIES gap paragraph this test closes)."""
    import time

    from ceph_tpu_torch.pipeline.rmw import OI_KEY, pack_oi, parse_oi
    from ceph_tpu_torch.store import Transaction

    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("obj", payload(5_000, seed=1))
    acting = mon.osdmap.object_to_acting("ecpool", "obj")
    member = acting[1]
    # Pick the phantom's identity while the member is still up: it
    # must sit where the member actually serves a shard (divergence
    # scans judge per-PG, per-position).
    # ... at a NON-primary position: a returning member is judged by
    # its PG's primary; a returning ex-primary judging itself needs
    # the full peering log election (documented limitation).
    phantom_oid = next(
        f"phantom{i}" for i in range(100)
        if member in mon.osdmap.object_to_acting("ecpool", f"phantom{i}")[1:]
    )
    ppos = mon.osdmap.object_to_acting("ecpool", phantom_oid).index(member)
    mon.osd_down(member)
    # The in-absence committed write covers only the object's HEAD:
    # log replay will push (and re-stamp) just those extents, so only
    # the pre-replay stamp comparison can catch garbage elsewhere in
    # the shard (replay-overwrites-the-stamp masking case).
    head = payload(700, seed=2)
    io.write("obj", head, offset=0)
    authoritative = head + payload(5_000, seed=1)[700:]

    # Simulate divergence on the downed member's store: it "applied"
    # a write nobody committed (garbage bytes + a stamp that is not
    # in authoritative history), and created an object only it has.
    store = daemons[member].store
    pool_id = mon.osdmap.pools["ecpool"].pool_id
    keys = [
        k for k in store.list_objects()
        if k.startswith(f"{pool_id}:obj#s")
    ]
    assert keys, "member should hold a shard of obj"
    key = keys[0]
    _size, ev = parse_oi(store.getattr(key, OI_KEY))
    good_shard = store.read(key)
    store.queue_transactions(
        Transaction()
        .write(key, 0, b"\xde\xad" * 64)
        .setattr(key, OI_KEY, pack_oi(_size, (ev[0], ev[1] + 1000)))
    )
    phantom = f"{pool_id}:{phantom_oid}#s{ppos}"
    store.queue_transactions(
        Transaction()
        .touch(phantom)
        .write(phantom, 0, b"ghost-bytes")
        .setattr(phantom, OI_KEY, pack_oi(11, (ev[0], ev[1] + 2000)))
        .setattr(phantom, "si", str(ppos).encode())
    )

    mon.osd_boot(member, daemons[member].addr)  # log-vouch return

    end = time.monotonic() + 15
    while time.monotonic() < end:
        diverged = store.exists(key) and store.read(key)[:4] == b"\xde\xad\xde\xad"
        if not diverged and not store.exists(phantom):
            break
        time.sleep(0.05)
    assert store.exists(key)
    assert store.read(key)[:4] != b"\xde\xad\xde\xad", (
        "divergent shard bytes survived catch-up"
    )
    assert not store.exists(phantom), "phantom object survived catch-up"
    # and the client still reads authoritative content
    assert io.read("obj") == authoritative


def test_secure_mode_cluster_end_to_end():
    # secure mode needs the AES-GCM backend; without the lib the
    # cluster (correctly) refuses to boot sealed — skip, not fail
    pytest.importorskip(
        "cryptography",
        reason="secure messenger mode requires the cryptography lib",
    )
    """A whole cluster on AES-GCM secure mode: every link (client->
    primary OSDOp, primary->replica ECSubWrite/Read fan-out) is
    sealed; IO, degraded reads, and a wrong-key outsider all behave."""
    from ceph_tpu_torch.cluster import Monitor, OSDDaemon, RadosClient

    PSK = b"cluster-keyring"
    mon = Monitor(device="cpu")
    daemons = []
    for i in range(5):
        mon.osd_crush_add(i, zone=f"z{i % 3}")
    for i in range(5):
        d = OSDDaemon(i, mon, chunk_size=1024, secret=PSK, device="cpu")
        d.start()
        daemons.append(d)
    mon.osd_erasure_code_profile_set(
        "rs32s", {"plugin": "isa", "k": "3", "m": "2"}
    )
    mon.osd_pool_create("sp", 8, "rs32s")
    client = RadosClient(mon, backoff=0.01, secret=PSK)
    try:
        io = client.open_ioctx("sp")
        data = payload(6_000, seed=7)
        io.write("obj", data)
        assert io.read("obj") == data
        # degraded read over sealed links
        victim = mon.osdmap.object_to_acting("sp", "obj")[1]
        mon.osd_down(victim)
        assert io.read("obj") == data
        # an outsider with the wrong key cannot execute ops
        intruder = RadosClient(
            mon, backoff=0.01, max_attempts=2, op_timeout=1.0,
            secret=b"wrong",
        )
        try:
            with pytest.raises(Exception):
                intruder.open_ioctx("sp").read("obj")
        finally:
            intruder.shutdown()
    finally:
        client.shutdown()
        for d in daemons:
            d.stop()


def test_append_truncate_write_full_surface(cluster):
    """rados_append / rados_trunc / rados_write_full over the wire:
    atomic append offsets, shrink-then-extend hole semantics, and
    whole-object replacement — all degraded-read safe."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    a, b = payload(3000, seed=1), payload(1500, seed=2)
    assert io.append("obj", a) == 3000
    assert io.append("obj", b) == 4500
    assert io.read("obj") == a + b
    # shrink cuts; read clips
    assert io.truncate("obj", 2000) == 2000
    assert io.stat("obj") == 2000
    assert io.read("obj") == a[:2000]
    # grow is a hole of zeros
    assert io.truncate("obj", 6000) == 6000
    assert io.read("obj") == a[:2000] + b"\0" * 4000
    # append lands at the grown size
    c = payload(700, seed=3)
    assert io.append("obj", c) == 6700
    assert io.read("obj") == a[:2000] + b"\0" * 4000 + c
    # write_full replaces a longer object with a shorter one
    d = payload(1200, seed=4)
    assert io.write_full("obj", d) == 1200
    assert io.stat("obj") == 1200
    assert io.read("obj") == d
    # all of it survives a degraded read
    victim = mon.osdmap.object_to_acting("ecpool", "obj")[1]
    daemons[victim].stop()
    mon.osd_down(victim)
    assert io.read("obj") == d


def test_concurrent_appends_do_not_overlap(cluster):
    """rados_append atomicity: concurrent appenders each land a
    distinct region; total size is the sum and every record is
    intact."""
    import threading

    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    records = {
        i: bytes([i]) * (100 + i) for i in range(8)
    }
    errors = []

    def worker(i):
        try:
            io.append("logobj", records[i])
        except Exception as e:
            errors.append(e)

    threads = [
        threading.Thread(target=worker, args=(i,)) for i in records
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors[0]
    total = sum(len(r) for r in records.values())
    assert io.stat("logobj") == total
    blob = io.read("logobj")
    # every record appears contiguously exactly once
    pos = 0
    seen = set()
    while pos < total:
        marker = blob[pos]
        rec = records[marker]
        assert blob[pos : pos + len(rec)] == rec, f"torn append at {pos}"
        assert marker not in seen, f"record {marker} duplicated"
        seen.add(marker)
        pos += len(rec)
    assert seen == set(records)


def test_resent_append_survives_primary_failover(cluster):
    """The replicated reqid window (the pg-log reqid role): an append
    whose reply was lost and whose PRIMARY then died must not
    re-apply on the new primary — the window travels on the object's
    shard txns, so the successor replays the recorded result."""
    from ceph_tpu_torch.msg.messages import OSDOp

    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    base = payload(2_000, seed=30)
    io.write("log", base)

    primary = mon.osdmap.primary("ecpool", "log")
    d = next(dd for dd in daemons if dd.osd_id == primary)
    rec = payload(300, seed=31)
    op1 = OSDOp(950, mon.osdmap.epoch, "ecpool", "log", "append",
                data=rec, reqid="clientA.9")
    r1 = d._execute_client_op(op1)
    assert r1.error == "" and r1.size == 2_300

    # the primary dies; its in-memory dedup cache dies with it
    d.stop()
    mon.osd_down(primary)
    new_primary = mon.osdmap.primary("ecpool", "log")
    assert new_primary != primary
    d2 = next(dd for dd in daemons if dd.osd_id == new_primary)
    # the client's resend of the SAME logical op (retrying through
    # the async durability fan-out like the objecter's backoff)
    r2 = execute_retry(d2, lambda: OSDOp(
        951, mon.osdmap.epoch, "ecpool", "log", "append",
        data=rec, reqid="clientA.9",
    ))
    assert r2.error == "", r2.error
    assert r2.size == 2_300, "resent append re-applied after failover"
    assert io.stat("log") == 2_300
    assert io.read("log") == base + rec
    # a genuinely NEW append still lands (retry through the
    # durability-poll cooldown the way the objecter's backoff would)
    import time as _t

    for _ in range(40):
        op3 = OSDOp(952, mon.osdmap.epoch, "ecpool", "log", "append",
                    data=rec, reqid="clientA.10")
        r3 = d2._execute_client_op(op3)
        if r3.error != "eagain":
            break
        _t.sleep(0.1)
    assert r3.error == "" and r3.size == 2_600, (r3.error, r3.size)


def test_nondurable_seeded_resend_reapplies(cluster):
    """Round-4 advisor finding: the old primary stamped the reqid
    window into the successor's shard txn but died before the op
    reached k shards — the op was never acked and is NOT
    reconstructible. The successor's seeded window must not replay it
    as a success; a quorum poll of the replicated REQ attrs proves it
    non-durable and the resend RE-APPLIES (at the append's original
    offset, not the inflated size the partial apply left behind)."""
    from ceph_tpu_torch.cluster.osd_daemon import (
        REQ_KEY, pack_reqs, shard_key,
    )
    from ceph_tpu_torch.msg.messages import OSDOp
    from ceph_tpu_torch.pipeline.rmw import OI_KEY, pack_oi, parse_oi
    from ceph_tpu_torch.store import Transaction

    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    base = payload(2_000, seed=40)
    io.write("log", base)
    spec = mon.osdmap.pools["ecpool"]

    primary = mon.osdmap.primary("ecpool", "log")
    d = next(dd for dd in daemons if dd.osd_id == primary)
    d.stop()
    mon.osd_down(primary)
    new_primary = mon.osdmap.primary("ecpool", "log")
    assert new_primary != primary
    d2 = next(dd for dd in daemons if dd.osd_id == new_primary)

    # fabricate the partial apply ON THE SUCCESSOR ONLY: the dead
    # primary's sub-write stamped the reqid window + a bumped OI
    # (size 2300) into this one shard; no other member ever saw it
    acting = mon.osdmap.object_to_acting("ecpool", "log")
    pos = acting.index(new_primary)
    loc = f"{spec.pool_id}:log"
    key = shard_key(loc, pos)
    rec = payload(300, seed=41)
    store = d2.store
    _size, ev = parse_oi(store.getattr(key, OI_KEY))
    win = store.getattr(key, REQ_KEY) if REQ_KEY in store.getattrs(
        key
    ) else b""
    from ceph_tpu_torch.cluster.osd_daemon import parse_reqs

    seeded = parse_reqs(win) if win else []
    seeded.append(("clientA.9", 2_300))
    store.queue_transactions(
        Transaction()
        .setattr(key, REQ_KEY, pack_reqs(seeded))
        .setattr(key, OI_KEY, pack_oi(2_300, (ev[0], ev[1] + 5)))
    )

    # the client's resend: without verification this replays size
    # 2300 while every other shard holds a 2000-byte object
    r = execute_retry(d2, lambda: OSDOp(
        960, mon.osdmap.epoch, "ecpool", "log", "append",
        data=rec, reqid="clientA.9",
    ))
    assert r.error == "", r.error
    assert r.size == 2_300
    # the re-apply healed the stripe everywhere: content is exact
    assert io.stat("log") == 2_300
    assert io.read("log") == base + rec


def test_nondurable_resend_with_later_writes_fails(cluster):
    """Same seeding, but the window records a LATER mutation after
    the suspect entry — re-applying would clobber the newer write, so
    the resend must fail loudly (the reference blocks such objects as
    unfound) instead of acking a lost write."""
    from ceph_tpu_torch.cluster.osd_daemon import (
        REQ_KEY, pack_reqs, shard_key,
    )
    from ceph_tpu_torch.msg.messages import OSDOp
    from ceph_tpu_torch.pipeline.rmw import OI_KEY, pack_oi, parse_oi
    from ceph_tpu_torch.store import Transaction

    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("log2", payload(2_000, seed=42))
    spec = mon.osdmap.pools["ecpool"]

    primary = mon.osdmap.primary("ecpool", "log2")
    d = next(dd for dd in daemons if dd.osd_id == primary)
    d.stop()
    mon.osd_down(primary)
    new_primary = mon.osdmap.primary("ecpool", "log2")
    d2 = next(dd for dd in daemons if dd.osd_id == new_primary)

    acting = mon.osdmap.object_to_acting("ecpool", "log2")
    pos = acting.index(new_primary)
    key = shard_key(f"{spec.pool_id}:log2", pos)
    store = d2.store
    _size, ev = parse_oi(store.getattr(key, OI_KEY))
    store.queue_transactions(
        Transaction()
        .setattr(key, REQ_KEY, pack_reqs(
            [("clientB.1", 2_300), ("clientB.2", 2_600)]
        ))
        .setattr(key, OI_KEY, pack_oi(2_600, (ev[0], ev[1] + 9)))
    )

    r = execute_retry(d2, lambda: OSDOp(
        961, mon.osdmap.epoch, "ecpool", "log2", "append",
        data=payload(300, seed=43), reqid="clientB.1",
    ))
    assert r.error == "eio", (r.error, r.size)


def test_nondurable_entry_not_laundered_by_later_op(cluster):
    """Round-5 review finding: a committed op's attr stamp used to
    replicate the whole in-memory window — INCLUDING unverified
    seeded entries — to every shard, laundering a torn never-acked
    write into a 'durable' one. Seeded entries must be settled before
    any new op stamps the window onward: the torn entry is erased,
    the object rolls back to its committed state, the new op builds
    on clean bytes, and the eventual resend executes as a fresh op
    instead of replaying a lie."""
    from ceph_tpu_torch.cluster.osd_daemon import (
        REQ_KEY, pack_reqs, shard_key,
    )
    from ceph_tpu_torch.msg.messages import OSDOp
    from ceph_tpu_torch.pipeline.rmw import OI_KEY, pack_oi, parse_oi
    from ceph_tpu_torch.store import Transaction

    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    base = payload(2_000, seed=50)
    io.write("log3", base)
    spec = mon.osdmap.pools["ecpool"]

    primary = mon.osdmap.primary("ecpool", "log3")
    d = next(dd for dd in daemons if dd.osd_id == primary)
    d.stop()
    mon.osd_down(primary)
    new_primary = mon.osdmap.primary("ecpool", "log3")
    d2 = next(dd for dd in daemons if dd.osd_id == new_primary)

    acting = mon.osdmap.object_to_acting("ecpool", "log3")
    pos = acting.index(new_primary)
    key = shard_key(f"{spec.pool_id}:log3", pos)
    store = d2.store
    _size, ev = parse_oi(store.getattr(key, OI_KEY))
    store.queue_transactions(
        Transaction()
        .setattr(key, REQ_KEY, pack_reqs([("clientC.1", 2_300)]))
        .setattr(key, OI_KEY, pack_oi(2_300, (ev[0], ev[1] + 5)))
    )

    # ANOTHER client commits an append before the resend arrives —
    # its attr stamp must NOT carry the unverified clientC.1 entry
    mid = payload(100, seed=51)
    rB = execute_retry(d2, lambda: OSDOp(
        970, mon.osdmap.epoch, "ecpool", "log3", "append",
        data=mid, reqid="clientD.1",
    ))
    assert rB.error == "", rB.error
    # the torn 2300-size state was rolled back to the committed 2000
    # before B applied, so B landed at offset 2000
    assert rB.size == 2_100, rB.size
    assert io.read("log3") == base + mid

    # the suspect resend now finds no window entry (erased as
    # non-durable) and executes as a FRESH append — never a replay
    rec = payload(300, seed=52)
    rA = execute_retry(d2, lambda: OSDOp(
        971, mon.osdmap.epoch, "ecpool", "log3", "append",
        data=rec, reqid="clientC.1",
    ))
    assert rA.error == "", rA.error
    assert rA.size == 2_400, (
        "resend must re-execute after its entry was erased, "
        f"got size {rA.size}"
    )
    assert io.read("log3") == base + mid + rec


def test_nondurable_verdict_needs_quorum_of_answers(cluster):
    """Round-5 review finding: absence of an answer is not evidence
    of non-durability. With most acting members unreachable, a
    seeded resend must get EAGAIN (back off until members answer),
    never an erase-and-reapply that could double-apply a committed
    op."""
    from ceph_tpu_torch.cluster.osd_daemon import (
        REQ_KEY, pack_reqs, shard_key,
    )
    from ceph_tpu_torch.msg.messages import OSDOp
    from ceph_tpu_torch.pipeline.rmw import OI_KEY, pack_oi, parse_oi
    from ceph_tpu_torch.store import Transaction

    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("log4", payload(2_000, seed=60))
    spec = mon.osdmap.pools["ecpool"]

    primary = mon.osdmap.primary("ecpool", "log4")
    d = next(dd for dd in daemons if dd.osd_id == primary)
    d.stop()
    mon.osd_down(primary)
    new_primary = mon.osdmap.primary("ecpool", "log4")
    d2 = next(dd for dd in daemons if dd.osd_id == new_primary)

    acting = mon.osdmap.object_to_acting("ecpool", "log4")
    pos = acting.index(new_primary)
    key = shard_key(f"{spec.pool_id}:log4", pos)
    _size, ev = parse_oi(d2.store.getattr(key, OI_KEY))
    d2.store.queue_transactions(
        Transaction()
        .setattr(key, REQ_KEY, pack_reqs([("clientE.1", 2_300)]))
        .setattr(key, OI_KEY, pack_oi(2_300, (ev[0], ev[1] + 5)))
    )
    # silence two more acting members WITHOUT marking them down in
    # the map: they remain voters the poll cannot reach
    live = {dd.osd_id for dd in daemons} - {primary, new_primary}
    silenced = [o for o in acting if o in live][:2]
    assert len(silenced) == 2, (acting, live)
    for o in silenced:
        next(dd for dd in daemons if dd.osd_id == o).stop()

    op = OSDOp(980, mon.osdmap.epoch, "ecpool", "log4", "append",
               data=payload(300, seed=61), reqid="clientE.1")
    r = d2._execute_client_op(op)
    assert r.error == "eagain", (r.error, r.size)
    # a NEW mutating op on the same object must also back off — it
    # cannot stamp its window over an unsettled entry
    op2 = OSDOp(981, mon.osdmap.epoch, "ecpool", "log4", "append",
                data=payload(100, seed=62), reqid="clientF.1")
    r2 = d2._execute_client_op(op2)
    assert r2.error == "eagain", (r2.error, r2.size)


# -- mirror of tests/test_op_shards.py -------------------------------


class MiniCluster:
    """The boot of the reference's load-generator cluster, which is not
    ported: a monitor, ``n_osds`` daemons on the CPU over MemStores, an
    EC pool and one connected client (``mon``, ``daemons``, ``pool``,
    ``io``, ``shutdown()``)."""

    def __init__(self, n_osds=6, k=3, m=2, pg_num=8, chunk_size=1024,
                 pool="loadpool", tick_period=0.2) -> None:
        self.pool = pool
        self.mon = Monitor(device="cpu")
        self.daemons = {}
        for i in range(n_osds):
            self.mon.osd_crush_add(i, zone=f"z{i % max(m + 1, 3)}")
        try:
            for i in range(n_osds):
                d = OSDDaemon(i, self.mon, chunk_size=chunk_size,
                              tick_period=tick_period, device="cpu")
                self.daemons[i] = d
                d.start()
            self.mon.osd_erasure_code_profile_set(
                "loadprof", {"plugin": "jerasure",
                             "technique": "reed_sol_van",
                             "k": str(k), "m": str(m)})
            self.mon.osd_pool_create(pool, pg_num, "loadprof")
            self.client = RadosClient(self.mon, backoff=0.02,
                                      op_timeout=3.0, max_attempts=10)
        except Exception:
            for d in self.daemons.values():
                d.stop()
            raise
        self.io = self.client.open_ioctx(pool)

    def shutdown(self) -> None:
        self.client.shutdown()
        for d in self.daemons.values():
            d.stop()


def _boot(nshards, **kw):
    kw.setdefault("n_osds", 5)
    kw.setdefault("k", 2)
    kw.setdefault("m", 1)
    kw.setdefault("pg_num", 8)
    kw.setdefault("chunk_size", 512)
    return MiniCluster(**kw)


# ---------------------------------------------------------------------------
# default: the legacy single-worker daemon, byte-compatible
# ---------------------------------------------------------------------------
class TestDefaultSingleShard:
    def test_one_shard_no_extra_workers(self):
        cluster = _boot(1)
        try:
            d = cluster.daemons[0]
            assert d._op_nshards == 1
            assert d._op_shards == [d._op_lock]
            assert d._op_shard_workers == []
            cluster.io.write_full("obj", b"x" * 900)
            assert cluster.io.read("obj") == b"x" * 900
        finally:
            cluster.shutdown()

    def test_shard0_lock_is_op_lock(self):
        """Tests and tooling that grab d._op_lock directly keep
        serializing against client ops at any shard count."""
        with config.override(osd_op_num_shards=4):
            cluster = _boot(4)
            try:
                d = cluster.daemons[0]
                assert d._op_lock is d._op_shards[0]
                assert len({id(s) for s in d._op_shards}) == 4
            finally:
                cluster.shutdown()


# ---------------------------------------------------------------------------
# routing: deterministic, map-stable, consistent across entry points
# ---------------------------------------------------------------------------
class TestRouting:
    def test_index_stable_and_bounded(self):
        with config.override(osd_op_num_shards=4):
            cluster = _boot(4)
            try:
                d = cluster.daemons[0]
                seen = set()
                for pgid in range(32):
                    i = d._op_shard_index("poolX", pgid)
                    assert i == d._op_shard_index("poolX", pgid)
                    assert 0 <= i < 4
                    seen.add(i)
                # 32 pgids over 4 shards: the hash must actually
                # spread (any single-shard collapse defeats the pool)
                assert len(seen) > 1
                assert (
                    d._op_lock_for("poolX", 3)
                    is d._op_shards[d._op_shard_index("poolX", 3)]
                )
            finally:
                cluster.shutdown()

    def test_dispatch_marks_item_shard(self):
        """Every executed client op ran under the shard lock its PG
        hashes to — dispatch and execution cannot disagree."""
        with config.override(osd_op_num_shards=4):
            cluster = _boot(4)
            try:
                for i in range(12):
                    cluster.io.write_full(f"r{i}", bytes([i]) * 600)
                for i in range(12):
                    assert cluster.io.read(f"r{i}") == bytes([i]) * 600
            finally:
                cluster.shutdown()


# ---------------------------------------------------------------------------
# the head-of-line regression itself
# ---------------------------------------------------------------------------
class TestHeadOfLine:
    def _objects_on_distinct_shards(self, cluster, nshards):
        """Two objects with the SAME primary daemon whose PGs hash to
        DIFFERENT shards, plus that daemon."""
        mon = cluster.mon
        pool = cluster.pool
        by_primary = {}
        for i in range(200):
            oid = f"hol-{i}"
            pgid = mon.osdmap.object_to_pg(pool, oid)
            primary = mon.osdmap.pg_primary(pool, pgid)
            d = cluster.daemons[primary]
            shard = d._op_shard_index(pool, pgid)
            slots = by_primary.setdefault(primary, {})
            slots.setdefault(shard, oid)
            if len(slots) >= 2:
                shards = sorted(slots)[:2]
                return d, slots[shards[0]], slots[shards[1]]
        pytest.fail("no two objects on distinct shards found")

    def test_blocked_shard_does_not_wedge_siblings(self):
        """Hold one shard's lock (the parked-EC-write stand-in): an
        op on ANOTHER shard of the same daemon completes while the
        first shard's op stays queued — the single-worker cliff is
        gone. Then release: the queued op drains."""
        with config.override(osd_op_num_shards=4):
            cluster = _boot(4)
            try:
                d, oid_a, oid_b = self._objects_on_distinct_shards(
                    cluster, 4
                )
                pool = cluster.pool
                shard_a = d._op_shard_index(
                    pool, cluster.mon.osdmap.object_to_pg(pool, oid_a)
                )
                lock_a = d._op_shards[shard_a]
                done_a = cluster.io.aio_write_full(oid_a, b"A" * 700)
                done_a.wait_for_complete(30)  # window seeded, pg peered
                with lock_a:
                    comp_a = cluster.io.aio_write_full(oid_a, b"a" * 700)
                    comp_b = cluster.io.aio_write_full(oid_b, b"b" * 700)
                    comp_b.wait_for_complete(15)
                    assert comp_b.is_complete()
                    # oid_a's shard is parked: its write must still be
                    # pending (queued behind the held lock)
                    assert not comp_a.is_complete()
                comp_a.wait_for_complete(15)
                assert cluster.io.read(oid_a) == b"a" * 700
                assert cluster.io.read(oid_b) == b"b" * 700
            finally:
                cluster.shutdown()

    def test_single_shard_still_wedges(self):
        """The control leg: at nshards=1 the same hold blocks BOTH
        objects — documenting exactly what the shard pool removes."""
        cluster = _boot(1)
        try:
            mon, pool = cluster.mon, cluster.pool
            prim = {}
            for i in range(100):
                oid = f"hol-{i}"
                p = mon.osdmap.primary(pool, oid)
                if p in prim and prim[p] != oid:
                    oid_a, oid_b = prim[p], oid
                    d = cluster.daemons[p]
                    break
                prim.setdefault(p, oid)
            else:
                pytest.fail("no two objects sharing a primary")
            cluster.io.write_full(oid_a, b"A" * 700)
            with d._op_lock:
                comp_b = cluster.io.aio_write_full(oid_b, b"b" * 700)
                time.sleep(1.0)
                assert not comp_b.is_complete()
            comp_b.wait_for_complete(15)
            assert cluster.io.read(oid_b) == b"b" * 700
        finally:
            cluster.shutdown()


# ---------------------------------------------------------------------------
# ordering + dedup invariants under shards
# ---------------------------------------------------------------------------
class TestInvariants:
    def test_same_object_appends_stay_ordered(self):
        """Same object -> same shard -> dispatch order preserved:
        interleaved appends land in submission order."""
        with config.override(osd_op_num_shards=4):
            cluster = _boot(4)
            try:
                cluster.io.write_full("seq", b"")
                comps = [
                    cluster.io._submit_async(
                        cluster.pool, "seq", "append",
                        data=bytes([65 + i]) * 4,
                    )
                    for i in range(8)
                ]
                for c in comps:
                    c.wait_for_complete(30)
                got = cluster.io.read("seq")
                want = b"".join(bytes([65 + i]) * 4 for i in range(8))
                assert got == want
            finally:
                cluster.shutdown()

    def test_reqid_dedup_across_shards(self):
        """The reqid window survives sharding: a replayed mutation
        (same reqid) must not re-apply. Exercised through many
        objects so windows live on several shards concurrently."""
        with config.override(osd_op_num_shards=4):
            cluster = _boot(4)
            try:
                for i in range(10):
                    cluster.io.write_full(f"d{i}", bytes([i]) * 300)
                    cluster.io.append(f"d{i}", b"+one")
                for i in range(10):
                    got = cluster.io.read(f"d{i}")
                    assert got == bytes([i]) * 300 + b"+one"
                # removes + re-reads: the completed-op cache is shared
                # across shards under the reqcache leaf lock
                for i in range(10):
                    cluster.io.remove(f"d{i}")
                for i in range(10):
                    with pytest.raises(FileNotFoundError):
                        cluster.io.read(f"d{i}")
            finally:
                cluster.shutdown()

    def test_concurrent_writes_many_shards(self):
        """A burst of concurrent writes across all shards settles
        with every payload intact (the basic no-corruption sweep)."""
        with config.override(osd_op_num_shards=4):
            cluster = _boot(4)
            try:
                comps = [
                    cluster.io.aio_write_full(f"c{i}", bytes([i]) * 800)
                    for i in range(24)
                ]
                for c in comps:
                    c.wait_for_complete(30)
                for i in range(24):
                    assert cluster.io.read(f"c{i}") == bytes([i]) * 800
            finally:
                cluster.shutdown()

    def test_stop_joins_shard_workers(self):
        with config.override(osd_op_num_shards=3):
            cluster = _boot(3)
            try:
                cluster.io.write_full("bye", b"x" * 500)
                workers = list(cluster.daemons[0]._op_shard_workers)
                assert len(workers) == 3
            finally:
                cluster.shutdown()
            deadline = time.monotonic() + 5
            while any(w.is_alive() for w in workers):
                if time.monotonic() > deadline:
                    pytest.fail("shard workers failed to stop")
                time.sleep(0.05)


# -- mirror of tests/test_qos.py, the cases without the load generator --

def test_client_class_resolution():
    assert client_class("gold", "mypool") == "client.gold"
    assert client_class("", "mypool") == "client.mypool"


def test_class_label_is_dot_free():
    assert class_label("client.gold") == "gold"
    assert class_label("recovery") == "recovery"
    assert class_label("client.a.b") == "a_b"  # never re-splits


def test_qos_spec_roundtrip_and_fold():
    spec = QoSSpec(res_ops=10.0, res_bytes=4 * COST_QUANTUM_BYTES,
                   weight=3.0, lim_ops=50.0)
    assert QoSSpec.from_obj(spec.to_obj()) == spec
    prof = spec.to_profile()
    # both axes fold into one cost-unit clock
    assert prof.reservation == pytest.approx(10.0 + 4.0)
    assert prof.weight == 3.0
    assert prof.limit == pytest.approx(50.0)


def test_tenant_rides_the_osd_op_wire():
    msg = OSDOp(tid=7, epoch=3, pool="p", oid="o", op="write",
                data=b"x", length=1, tenant="gold")
    back = OSDOp.decode(msg.encode())
    assert back.tenant == "gold"
    # untagged ops stay untagged (and the field is version-tolerant)
    legacy = OSDOp(tid=8, epoch=3, pool="p", oid="o", op="read")
    assert OSDOp.decode(legacy.encode()).tenant == ""


# -- slosh-knob derivation ---------------------------------------------

def test_derive_profiles_monotone_across_knob():
    """recovery reservation climbs and client reservation falls as the
    knob turns high_client -> balanced -> high_recovery."""
    tables = {
        name: derive_profiles(name, 1000.0, client_demand=1000.0)
        for name in MCLOCK_PROFILES
    }
    rec = [tables[n]["recovery"].reservation
           for n in ("high_client", "balanced", "high_recovery")]
    cli = [tables[n]["client"].reservation
           for n in ("high_client", "balanced", "high_recovery")]
    assert rec[0] < rec[1] < rec[2]
    assert cli[0] > cli[1] > cli[2]


def test_derive_profiles_regrants_idle_client_reservation():
    """Client reservation the clients measurably aren't using sloshes
    to recovery/backfill; full demand gives them only their floor."""
    idle = derive_profiles("balanced", 1000.0, client_demand=0.0)
    busy = derive_profiles("balanced", 1000.0, client_demand=1000.0)
    assert idle["recovery"].reservation > busy["recovery"].reservation
    assert idle["backfill"].reservation > busy["backfill"].reservation
    # the grant never exceeds the client floor
    spare = idle["recovery"].reservation - busy["recovery"].reservation
    spare += idle["backfill"].reservation - busy["backfill"].reservation
    assert spare == pytest.approx(
        busy["client"].reservation, rel=1e-6)


def test_derive_profiles_rejects_unknown_knob():
    with pytest.raises(ValueError):
        derive_profiles("turbo", 1000.0)


def test_normalize_reservations_admission_guard():
    """Oversubscribed reservations scale pro rata to frac*capacity;
    weights and limits pass through untouched."""
    from ceph_tpu_torch.cluster.qos import (
        RESERVATION_FRAC, normalize_reservations,
    )
    from ceph_tpu_torch.utils.mclock import ClientProfile

    table = {
        "client.a": ClientProfile(reservation=600.0, weight=4.0),
        "recovery": ClientProfile(reservation=600.0, weight=1.0,
                                  limit=700.0),
        "client.b": ClientProfile(reservation=0.0, weight=1.0),
    }
    out = normalize_reservations(table, capacity=100.0)
    total = sum(p.reservation for p in out.values())
    assert total == pytest.approx(RESERVATION_FRAC * 100.0)
    # pro rata: equal inputs stay equal; zero stays zero
    assert out["client.a"].reservation == pytest.approx(
        out["recovery"].reservation)
    assert out["client.b"].reservation == 0.0
    assert out["client.a"].weight == 4.0
    assert out["recovery"].limit == 700.0
    # under budget: identity
    small = {"c": ClientProfile(reservation=10.0, weight=1.0)}
    assert normalize_reservations(small, 100.0) is small


# -- monitor spec push -> live scheduler profiles ----------------------

def _wait(pred, timeout=10.0, period=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(period)
    return pred()


class TestSpecPush:
    @pytest.fixture(scope="class")
    def cluster(self):
        c = MiniCluster(n_osds=3, k=2, m=1, pg_num=2, chunk_size=1024,
                        tick_period=0.1)
        try:
            yield c
        finally:
            c.shutdown()

    def test_qos_set_reaches_every_scheduler(self, cluster):
        cluster.mon.osd_pool_qos_set(
            cluster.pool, tenant="gold", res_ops=10.0, weight=2.0,
            lim_ops=50.0,
        )

        def landed():
            return all(
                d.scheduler.profiles.get("client.gold") is not None
                for d in cluster.daemons.values()
            )

        assert _wait(landed), "spec never reached the OSD schedulers"
        profiles = next(iter(cluster.daemons.values())).scheduler.profiles
        prof = profiles["client.gold"]
        # weight and limit land verbatim; the reservation clock may be
        # admission-scaled (sum <= frac * capacity), preserving ratios
        assert prof.weight == pytest.approx(2.0)
        assert prof.limit == pytest.approx(50.0)
        assert 0.0 < prof.reservation <= 10.0 + 1e-9

    def test_qos_rm_retracts_the_class(self, cluster):
        cluster.mon.osd_pool_qos_rm(cluster.pool, tenant="gold")

        def gone():
            return all(
                "client.gold" not in d.scheduler.profiles
                for d in cluster.daemons.values()
            )

        assert _wait(gone), "retracted spec still in scheduler profiles"

    def test_dump_mclock_admin_surface(self, cluster):
        from ceph_tpu_torch.utils.admin_socket import admin_socket

        dump = admin_socket.execute("dump_mclock")
        names = [n for n in dump if n.startswith("osd.")]
        assert len(names) >= 3
        one = admin_socket.execute("dump_mclock", daemon=names[0])
        assert isinstance(one, dict)
        for cls_state in one.values():
            assert {"profile", "depth", "tag_lag_s"} <= set(cls_state)


# -- mirror of tests/test_cluster_plugins.py -------------------------

PROFILES = {
    "jerasure_rs": {"plugin": "jerasure", "technique": "reed_sol_van",
                    "k": "3", "m": "2"},
    "jerasure_cauchy": {"plugin": "jerasure", "technique": "cauchy_good",
                        "k": "3", "m": "2"},
    "isa": {"plugin": "isa", "k": "3", "m": "2"},
    "lrc": {"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
    "shec": {"plugin": "shec", "k": "3", "m": "2", "c": "1"},
    "clay": {"plugin": "clay", "k": "3", "m": "2"},
}


@pytest.fixture(scope="module")
def plugin_cluster():
    mon = Monitor(device="cpu")
    daemons = []
    n = 9  # lrc k=4,m=2,l=3 expands to more chunks
    for i in range(n):
        mon.osd_crush_add(i)
    for i in range(n):
        d = OSDDaemon(i, mon, chunk_size=1024, tick_period=0, device="cpu")
        d.start()
        daemons.append(d)
    client = RadosClient(mon, backoff=0.02)
    yield mon, daemons, client
    client.shutdown()
    for d in daemons:
        d.stop()


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_plugin_through_cluster(plugin_cluster, name):
    mon, daemons, client = plugin_cluster
    profile = PROFILES[name]
    mon.osd_erasure_code_profile_set(name, profile)
    pool = f"pool_{name}"
    mon.osd_pool_create(pool, 4, name)
    spec = mon.osdmap.pools[pool]
    assert spec.plugin == profile["plugin"]
    io = client.open_ioctx(pool)
    data = np.random.default_rng(zlib.crc32(name.encode())).integers(
        0, 256, 9_000, dtype=np.uint8
    ).tobytes()
    io.write("obj", data)
    assert io.read("obj") == data
    # degraded: hole one non-primary member for THIS pool's object
    acting = mon.osdmap.object_to_acting(pool, "obj")
    victim = acting[-1]
    mon.osd_down(victim)
    try:
        assert io.read("obj") == data
    finally:
        mon.osd_boot(victim, daemons[victim].addr)


# -- the device-route case, with the port's counter names ---------------

def test_device_dispatch_route_end_to_end():
    """The reference's case reads its own counters (``einsum_encode`` /
    ``einsum_decode``); the port counts the route that served: on a card
    ``kernel_*`` (or ``sched_*`` for an XOR decode), here, on the CPU,
    the plain forms ``plain_*``. With the host small-op shortcut off, a
    cluster write and a degraded read must move them, and no host
    encode may serve."""
    from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters

    def snap():
        pc = dispatch_counters()
        return {k: pc.get(k) for k in pc.dump()}

    mon = Monitor(device="cpu")
    daemons = []
    for i in range(5):
        mon.osd_crush_add(i, zone=f"z{i % 3}")
    client = None
    try:
        for i in range(5):
            d = OSDDaemon(i, mon, chunk_size=4096, device="cpu")
            daemons.append(d)
            d.start()
        mon.osd_erasure_code_profile_set(
            "rsdev", {"plugin": "isa", "k": "3", "m": "2"})
        mon.osd_pool_create("devpool", 4, "rsdev")
        client = RadosClient(mon, backoff=0.01)
        with config.override(ec_host_dispatch_bytes=0):
            before = snap()
            io = client.open_ioctx("devpool")
            data = payload(3 * 4096 * 2)  # two full stripes
            io.write("obj", data)
            victim = mon.osdmap.object_to_acting("devpool", "obj")[1]
            daemons[victim].stop()
            mon.osd_down(victim)
            assert io.read("obj") == data  # reconstruct read
            after = snap()
        assert after["plain_encode"] > before["plain_encode"], (
            "cluster write never reached the codec's device route")
        assert after["plain_decode"] > before["plain_decode"], (
            "degraded cluster read never reached the codec's device route")
        assert after["host_encode"] == before["host_encode"]
    finally:
        if client is not None:
            client.shutdown()
        for d in daemons:
            d.stop()


# -- twins: the same ops through a ceph_tpu cluster and a port cluster ---

#: attrs that differ between two clusters by design: the reqid window
#: (``REQ_KEY``, "rq") carries each client's random nonce
TWIN_SKIP_ATTRS = ("rq",)


def _twin_boot(root, n=6, k=4, m=2, chunk=1024, stores=None, initial=None):
    import importlib

    cl = importlib.import_module(f"{root}.cluster")
    kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    mon = cl.Monitor(initial=initial, **kw)
    if initial is None:
        for i in range(n):
            mon.osd_crush_add(i, zone=f"z{i % 3}")
    daemons = []
    try:
        for i in range(n):
            d = cl.OSDDaemon(i, mon, chunk_size=chunk, tick_period=0.2,
                             store=None if stores is None else stores[i],
                             **kw)
            daemons.append(d)
            d.start()
        if initial is None:
            mon.osd_erasure_code_profile_set(
                "rs", {"plugin": "isa", "k": str(k), "m": str(m)})
            mon.osd_pool_create("pool", 8, "rs")
        client = cl.RadosClient(mon, backoff=0.01)
    except Exception:
        for d in daemons:
            d.stop()
        raise
    return SimpleNamespace(mon=mon, daemons=daemons, client=client,
                           io=client.open_ioctx("pool"))


def _twin_stop(c):
    c.client.shutdown()
    for d in c.daemons:
        if not d._stopped:
            d.stop()


def _twin_ops(seed):
    """A seeded op list: whole writes, partial overwrites, appends,
    truncates, removes and xattrs over a few objects."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(6):
        ops.append(("write_full", f"o{i}", rng.integers(
            0, 256, int(rng.integers(1, 5)) * 4096 + int(rng.integers(0, 3))
            * 1000, dtype=np.uint8).tobytes()))
    for _ in range(10):
        oid = f"o{int(rng.integers(0, 6))}"
        kind = ("write", "append", "truncate", "setxattr")[
            int(rng.integers(0, 4))]
        if kind == "write":
            ops.append((kind, oid, int(rng.integers(0, 12000)), rng.integers(
                0, 256, int(rng.integers(1, 3000)), dtype=np.uint8).tobytes()))
        elif kind == "append":
            ops.append((kind, oid, rng.integers(
                0, 256, int(rng.integers(1, 5000)), dtype=np.uint8).tobytes()))
        elif kind == "truncate":
            ops.append((kind, oid, int(rng.integers(0, 9000))))
        else:
            ops.append((kind, oid, "user.tag", bytes([int(rng.integers(0, 256))]) * 3))
    ops.append(("remove", "o5"))
    return ops


def _twin_apply(io, ops):
    for name, *args in ops:
        if name == "write":
            oid, off, data = args
            io.write(oid, data, offset=off)
        else:
            getattr(io, name)(*args)


def _stores(c):
    out = {}
    for d in c.daemons:
        st = d.store
        out[d.osd_id] = {
            key: (st.read(key), {a: v for a, v in st.getattrs(key).items()
                                 if a not in TWIN_SKIP_ATTRS})
            for key in st.list_objects()
        }
    return out


def _object_stores(c):
    """``_stores`` without the per-PG ``pgmeta`` objects: their peering
    stamps (``les``, ``acting``) are written by peering passes whose
    timing against map changes varies from run to run in either
    package; every object shard stays in."""
    return {osd: {key: v for key, v in st.items()
                  if not key.startswith("pgmeta")}
            for osd, st in _stores(c).items()}


def _reads(c, oids):
    out = {}
    for oid in oids:
        try:
            out[oid] = (c.io.read(oid), c.io.stat(oid))
        except FileNotFoundError:
            out[oid] = None
    return out


@pytest.fixture
def twins():
    made = []

    def boot(root, **kw):
        c = _twin_boot(root, **kw)
        made.append(c)
        return c

    yield boot
    for c in made:
        _twin_stop(c)


@pytest.mark.parametrize("seed", [1, 2])
def test_twin_clusters_store_equal_bytes(twins, seed):
    """The same ops, serially, through both packages' clusters: equal
    client reads, and every OSD's store equal in keys, data bytes and
    attrs (HINFO and OI included; only the reqid window's nonce is
    left out)."""
    from ceph_tpu_torch.pipeline.rmw import HINFO_KEY

    ops = _twin_ops(seed)
    oids = [f"o{i}" for i in range(6)]
    ref, port = twins("ceph_tpu"), twins("ceph_tpu_torch")
    for c in (ref, port):
        _twin_apply(c.io, ops)
    assert _reads(port, oids) == _reads(ref, oids)
    stores = [_stores(ref), _stores(port)]
    assert stores[0] == stores[1]
    assert any(HINFO_KEY in attrs for st in stores[1].values()
               for _data, attrs in st.values())
    # the same degraded read from both: one data shard's OSD down
    for c in (ref, port):
        victim = c.mon.osdmap.object_to_acting("pool", "o0")[1]
        c.daemons[victim].stop()
        c.mon.osd_down(victim)
    assert _reads(port, oids) == _reads(ref, oids)


def test_carried_state_serves_from_the_port(twins):
    """A cluster written by ceph_tpu (its OSDMap bytes and every OSD's
    MemStore) boots as a port cluster, and every object reads back
    through the port's client, degraded too."""
    import importlib

    from ceph_tpu_torch.cluster import OSDMap
    from ceph_tpu_torch.store import MemStore

    ops = _twin_ops(3)
    oids = [f"o{i}" for i in range(6)]
    ref = twins("ceph_tpu")
    _twin_apply(ref.io, ops)
    want = _reads(ref, oids)
    snap = {d.osd_id: {key: (d.store.read(key), d.store.getattrs(key))
                       for key in d.store.list_objects()}
            for d in ref.daemons}
    raw = ref.mon.osdmap.to_bytes()
    _twin_stop(ref)
    ref_map = importlib.import_module("ceph_tpu.cluster").OSDMap
    assert OSDMap.from_bytes(raw).to_bytes() == \
        ref_map.from_bytes(raw).to_bytes()
    stores = [MemStore.from_snapshot(f"osd.{i}", snap[i])
              for i in sorted(snap)]
    port = twins("ceph_tpu_torch", stores=stores,
                 initial=OSDMap.from_bytes(raw))
    assert _reads(port, oids) == want
    victim = port.mon.osdmap.object_to_acting("pool", "o1")[0]
    port.daemons[victim].stop()
    port.mon.osd_down(victim)
    assert _reads(port, oids) == want
