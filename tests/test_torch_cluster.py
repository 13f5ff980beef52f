"""The port's cluster control plane (``cluster/osdmap.py``,
``monitor.py``, ``peering.py``) against ceph_tpu's, on the CPU.

The mirrors run the reference's ``tests/test_cluster.py`` and
``tests/test_peering_fsm.py`` against ``ceph_tpu_torch`` with
``device="cpu"``; its victim pickers run on both packages' load
generator clusters, which must pick the same OSDs from the same census
(the pickers' schedule cases are ``test_torch_loadgen.py``'s fault
schedule twins). The twin cases drive one command sequence through a
monitor of each package and hold ``OSDMap.to_bytes`` equal at every
epoch, and hold profile validation to the same errors.
"""

import pytest
import threading
import time
import types
import numpy as np

torch = pytest.importorskip("torch")

from ceph_tpu_torch.cluster import (  # noqa: E402
    CommandError,
    Incremental,
    Monitor,
    OSDInfo,
    OSDMap,
    SHARD_NONE,
)
from ceph_tpu_torch.utils import config  # noqa: E402
from ceph_tpu_torch.cluster import Monitor, OSDDaemon, RadosClient  # noqa: E402
from ceph_tpu_torch.cluster.peering import (  # noqa: E402
    ACTIVE,
    CrashPointAbort,
    GETINFO,
    GETLOG,
    INCOMPLETE,
    REPLICA,
    crash_points,
)


# -- mirror of tests/test_cluster.py --------------------------------------

def mk_monitor(n_osds=8, clock=None):
    mon = Monitor(**({"clock": clock} if clock else {}), device="cpu")
    for i in range(n_osds):
        mon.osd_crush_add(i, weight=1.0, zone=f"z{i % 4}")
        mon.osd_boot(i, ("127.0.0.1", 7000 + i))
    return mon


def mk_pool(mon, name="ecpool", k=4, m=2, pg_num=16):
    mon.osd_erasure_code_profile_set(
        "rs62", {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": str(k), "m": str(m)}
    )
    mon.osd_pool_create(name, pg_num, "rs62")
    return mon.osdmap


# -- OSDMap value semantics ---------------------------------------------


def test_incremental_must_follow_epoch():
    m = OSDMap()
    with pytest.raises(ValueError):
        m.apply(Incremental(epoch=5))


def test_map_roundtrips_through_bytes():
    mon = mk_monitor(6)
    m = mk_pool(mon)
    m2 = OSDMap.from_bytes(m.to_bytes())
    assert m2.epoch == m.epoch
    assert m2.pools.keys() == m.pools.keys()
    assert m2.profiles == m.profiles
    for oid in ("a", "b", "c"):
        assert m2.object_to_acting("ecpool", oid) == m.object_to_acting(
            "ecpool", oid
        )


def test_incremental_roundtrips_through_bytes():
    incr = Incremental(
        epoch=3,
        new_osds=(OSDInfo(1, 2.0, "z1", True, True, ("h", 1)),),
        down=(2,),
        new_profiles=(("p", (("k", "4"), ("m", "2"))),),
    )
    assert Incremental.from_bytes(incr.to_bytes()) == incr


def test_acting_set_positions_are_stable_shards():
    mon = mk_monitor(8)
    m = mk_pool(mon)
    acting = m.object_to_acting("ecpool", "obj")
    assert len(acting) == 6
    assert len(set(acting)) == 6  # distinct devices
    # deterministic
    assert m.object_to_acting("ecpool", "obj") == acting


def test_down_makes_holes_not_movement():
    """Down-but-in: the shard position becomes SHARD_NONE; every other
    position keeps its device (degraded, no rebalance)."""
    mon = mk_monitor(8)
    m = mk_pool(mon)
    acting = m.object_to_acting("ecpool", "obj")
    victim = acting[2]
    m2 = mon.osd_down(victim)
    after = m2.object_to_acting("ecpool", "obj")
    assert after[2] == SHARD_NONE
    assert [a for i, a in enumerate(after) if i != 2] == [
        a for i, a in enumerate(acting) if i != 2
    ]
    assert m2.primary("ecpool", "obj") == after[0]


def test_out_remaps_the_hole():
    """Marking out removes the device from crush input: the CRUSH
    target refills the hole with a substitute, while an auto-installed
    pg_temp keeps the PG SERVING from the old layout (hole included)
    until backfill moves the data and clears it."""
    mon = mk_monitor(8)
    m = mk_pool(mon)
    acting = m.object_to_acting("ecpool", "obj")
    victim = acting[0]
    mon.osd_down(victim)
    m2 = mon.osd_out(victim)
    pgid = m2.object_to_pg("ecpool", "obj")
    # serving layout: still the old membership, victim's slot a hole
    served = m2.object_to_acting("ecpool", "obj")
    assert served[0] == SHARD_NONE
    assert served[1:] == acting[1:]
    assert (("ecpool", pgid)) in m2.pg_temp
    # CRUSH target: victim gone, hole refilled by a substitute
    target = m2.pg_to_raw("ecpool", pgid, ignore_temp=True)
    assert victim not in target
    assert SHARD_NONE not in target
    assert len(set(target)) == 6
    # backfill completion clears the override: acting = target
    m3 = mon.pg_temp_clear("ecpool", pgid)
    assert m3.object_to_acting("ecpool", "obj") == target


def test_minimal_movement_on_out():
    """CRUSH property: removing one device only remaps PGs that used
    it — every other PG's acting set is untouched."""
    mon = mk_monitor(10)
    m = mk_pool(mon, pg_num=64)
    before = {pg: m.pg_to_up_acting("ecpool", pg) for pg in range(64)}
    victim = before[0][0]
    mon.osd_down(victim)
    m2 = mon.osd_out(victim)
    moved = unmoved = 0
    for pg in range(64):
        after = m2.pg_to_up_acting("ecpool", pg)
        if victim in before[pg]:
            assert victim not in after
            moved += 1
        else:
            assert after == before[pg]
            unmoved += 1
    assert moved > 0 and unmoved > 0


def test_reboot_heals_holes():
    mon = mk_monitor(8)
    m = mk_pool(mon)
    acting = m.object_to_acting("ecpool", "obj")
    victim = acting[1]
    mon.osd_down(victim)
    m2 = mon.osd_boot(victim, ("127.0.0.1", 7999))
    assert m2.object_to_acting("ecpool", "obj") == acting
    assert m2.get_addr(victim) == ("127.0.0.1", 7999)


def test_distinct_zones_pool():
    mon = mk_monitor(8)  # 4 zones x 2 osds
    mon.osd_erasure_code_profile_set(
        "rs22", {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "2", "m": "2"}
    )
    mon.osd_pool_create("zpool", 8, "rs22", distinct_zones=True)
    m = mon.osdmap
    for pg in range(8):
        acting = m.pg_to_up_acting("zpool", pg)
        zones = [m.osds[o].zone for o in acting]
        assert len(set(zones)) == 4


# -- Monitor commands ----------------------------------------------------


def test_profile_validation_rejects_garbage():
    mon = mk_monitor(4)
    with pytest.raises(CommandError):
        mon.osd_erasure_code_profile_set("bad", {"plugin": "nope"})
    with pytest.raises(CommandError):
        mon.osd_erasure_code_profile_set(
            "bad2", {"plugin": "jerasure", "technique": "reed_sol_van",
                     "k": "0", "m": "2"}
        )
    assert "bad" not in mon.osdmap.profiles


def test_profile_overwrite_requires_force():
    mon = mk_monitor(4)
    prof = {"plugin": "jerasure", "technique": "reed_sol_van",
            "k": "2", "m": "1"}
    mon.osd_erasure_code_profile_set("p", prof)
    # identical re-set is a no-op
    mon.osd_erasure_code_profile_set("p", dict(prof))
    changed = dict(prof, m="2")
    with pytest.raises(CommandError):
        mon.osd_erasure_code_profile_set("p", changed)
    mon.osd_erasure_code_profile_set("p", changed, force=True)
    assert mon.osdmap.profiles["p"]["m"] == "2"


def test_pool_create_derives_km_from_codec():
    mon = mk_monitor(8)
    m = mk_pool(mon, k=4, m=2)
    spec = m.pools["ecpool"]
    assert (spec.k, spec.m, spec.size) == (4, 2, 6)
    assert spec.plugin == "jerasure"


def test_pool_create_default_profile():
    mon = mk_monitor(6)
    mon.osd_pool_create("dflt", 8)  # erasure_code_default_profile k=2 m=2
    spec = mon.osdmap.pools["dflt"]
    assert (spec.k, spec.m) == (2, 2)


def test_pool_duplicate_and_rm():
    mon = mk_monitor(6)
    mk_pool(mon)
    with pytest.raises(CommandError):
        mon.osd_pool_create("ecpool", 8, "rs62")
    mon.osd_pool_rm("ecpool")
    assert "ecpool" not in mon.osdmap.pools
    with pytest.raises(CommandError):
        mon.osd_pool_rm("ecpool")


# -- failure reports & auto-out ------------------------------------------


def test_failure_requires_distinct_reporters():
    mon = mk_monitor(6)
    assert config.get("mon_osd_min_down_reporters") == 2
    assert mon.report_failure(1, 0) is None  # one reporter: not enough
    assert mon.report_failure(1, 0) is None  # same reporter again
    assert mon.osdmap.is_up(0)
    m = mon.report_failure(2, 0)  # second distinct reporter
    assert m is not None and not m.is_up(0)
    # further reports about a down osd are ignored
    assert mon.report_failure(3, 0) is None
    # self-reports never count
    assert mon.report_failure(5, 5) is None


def test_boot_clears_pending_reports():
    mon = mk_monitor(6)
    mon.report_failure(1, 0)
    mon.osd_boot(0, ("127.0.0.1", 7000))
    assert mon.report_failure(2, 0) is None  # evidence was reset
    assert mon.osdmap.is_up(0)


def test_auto_out_after_interval():
    t = [0.0]
    mon = mk_monitor(8, clock=lambda: t[0])
    mk_pool(mon)
    mon.osd_down(3)
    assert mon.tick() is None  # too soon
    t[0] += config.get("mon_osd_down_out_interval") + 1
    m = mon.tick()
    assert m is not None and not m.osds[3].in_
    assert mon.tick() is None  # idempotent


# -- subscriptions & catch-up --------------------------------------------


def test_subscribe_sees_every_epoch():
    mon = mk_monitor(4)
    seen = []
    mon.subscribe(lambda m: seen.append(m.epoch))
    e0 = mon.osdmap.epoch
    mk_pool(mon)
    assert seen[0] == e0
    assert seen[-1] == mon.osdmap.epoch
    assert seen[1:] == list(range(e0 + 1, mon.osdmap.epoch + 1))


def test_incremental_catch_up_replays_to_current():
    mon = mk_monitor(6)
    snapshot = mon.osdmap
    mk_pool(mon)
    mon.osd_down(2)
    incrs = mon.get_incrementals(snapshot.epoch)
    m = snapshot
    for incr in incrs:
        m = m.apply(incr)
    assert m.epoch == mon.osdmap.epoch
    assert m.to_bytes() == mon.osdmap.to_bytes()


def test_trimmed_history_forces_full_map():
    mon = mk_monitor(6)
    mk_pool(mon)
    mon.trim_history(keep=1)
    assert mon.get_incrementals(0) is None
    assert mon.get_incrementals(mon.osdmap.epoch - 1) is not None


# -- reqid-cache invalidation scoping (round-6 _kick_peering fix) -------

def _bare_daemon():
    """An OSDDaemon shell with just the reqid-cache state — the drain
    logic is pure dict surgery and must be testable without sockets."""
    import threading

    from ceph_tpu_torch.cluster.osd_daemon import OSDDaemon

    d = object.__new__(OSDDaemon)
    d._req_windows = {}
    d._req_unverified = {}
    d._req_poll_at = {}
    d._req_poll_results = {}
    d._req_polls_inflight = set()
    d._req_poll_lock = threading.Lock()
    d._req_flush = set()
    d._req_flush_lock = threading.Lock()
    d._reqcache_lock = threading.Lock()
    return d


def test_req_flush_scoped_to_kicked_pg():
    """A queued PG-scoped flush drops exactly that PG's locs — other
    pools and sibling PGs keep their windows (re-peering one PG must
    not make every object on the daemon re-pay the durability poll)."""
    from ceph_tpu_torch.cluster.osd_daemon import make_loc
    from ceph_tpu_torch.placement import stable_hash

    d = _bare_daemon()
    pg_num = 8
    # split pool-1 objects by the PG they hash to
    locs = [make_loc(1, f"obj{i}") for i in range(32)]
    kicked = stable_hash("1", "obj0") % pg_num
    in_pg = [
        l for l in locs
        if stable_hash("1", l.split(":", 1)[1]) % pg_num == kicked
    ]
    other_pool = make_loc(2, "obj0")
    for l in locs + [other_pool]:
        d._req_windows[l] = [("rq", 1)]
        d._req_unverified[l] = {"rq"}
        d._req_poll_at[l] = 1.0
    d._req_flush.add(("pg", 1, pg_num, kicked))
    d._drain_req_flushes()
    assert in_pg and all(l not in d._req_windows for l in in_pg)
    assert all(l not in d._req_unverified for l in in_pg)
    assert all(l not in d._req_poll_at for l in in_pg)
    survivors = [l for l in locs if l not in in_pg] + [other_pool]
    assert all(l in d._req_windows for l in survivors)
    assert all(l in d._req_poll_at for l in survivors)


def test_req_flush_pool_and_full_variants():
    """Pool-scoped flushes (deletion sweep) drop every loc of that
    pool; the None sentinel drops everything; unparseable locs are
    never kept (nothing may judge from them)."""
    from ceph_tpu_torch.cluster.osd_daemon import make_loc

    d = _bare_daemon()
    keep = make_loc(7, "x")
    for l in (make_loc(3, "a"), make_loc(3, "b"), keep, "garbage-loc"):
        d._req_windows[l] = [("rq", 1)]
        d._req_poll_at[l] = 2.0
    d._req_flush.add(("pool", 3))
    d._drain_req_flushes()
    assert set(d._req_windows) == {keep}
    assert set(d._req_poll_at) == {keep}
    d._req_flush.add(None)
    d._drain_req_flushes()
    assert not d._req_windows and not d._req_poll_at


def test_pool_deletion_prunes_fence_epochs():
    """_on_map's deletion sweep drops _fence_epochs for dead pool ids
    and queues the pool's reqid-cache flush (unbounded-state fix)."""
    from ceph_tpu_torch.cluster.osd_daemon import OSDDaemon, make_loc
    from ceph_tpu_torch.store import MemStore

    mon = mk_monitor(6)
    mk_pool(mon, name="doomed", k=4, m=2)
    osd = OSDDaemon(0, mon, store=MemStore("t"), device="cpu")
    try:
        pool_id = mon.osdmap.pools["doomed"].pool_id
        osd._fence_epochs[(pool_id, 3)] = 5
        osd._fence_epochs[(pool_id + 99, 0)] = 7  # unrelated survives
        osd._req_windows[make_loc(pool_id, "o")] = [("rq", 1)]
        osd._req_poll_at[make_loc(pool_id, "o")] = 1.0
        mon.osd_pool_rm("doomed")
        osd._on_map(mon.osdmap)  # map delivery (subscribe needs start())
        assert (pool_id, 3) not in osd._fence_epochs
        assert (pool_id + 99, 0) in osd._fence_epochs
        with osd._op_lock:
            osd._drain_req_flushes()
        assert make_loc(pool_id, "o") not in osd._req_windows
        assert make_loc(pool_id, "o") not in osd._req_poll_at
    finally:
        osd.stop()


# -- mirror of tests/test_peering_fsm.py ----------------------------------

def payload(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8
    ).tobytes()


def _wait(pred, timeout=15.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


@pytest.fixture
def cluster():
    mon = Monitor(device="cpu")
    daemons = []
    for i in range(5):
        mon.osd_crush_add(i, zone=f"z{i % 3}")
    for i in range(5):
        d = OSDDaemon(i, mon, chunk_size=1024, tick_period=0.3, device="cpu")
        d.start()
        daemons.append(d)
    mon.osd_erasure_code_profile_set(
        "rs21", {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "2", "m": "1"}
    )
    mon.osd_pool_create("fsmpool", 4, "rs21")
    client = RadosClient(mon, backoff=0.01)
    yield mon, daemons, client
    crash_points.clear()
    client.shutdown()
    for d in daemons:
        d.stop()


def _primary_pg(mon, daemons, oid="obj"):
    pgid = mon.osdmap.object_to_pg("fsmpool", oid)
    primary = mon.osdmap.object_to_acting("fsmpool", oid)[0]
    d = next(dd for dd in daemons if dd.osd_id == primary)
    return d, pgid


class TestStates:
    def test_progression_to_active(self, cluster):
        """A served PG's FSM sits in ``active`` having walked the
        canonical ladder — getinfo and getlog appear in the trail."""
        mon, daemons, client = cluster
        io = client.open_ioctx("fsmpool")
        io.write("obj", payload(3000))
        d, pgid = _primary_pg(mon, daemons)
        pg = d._pgs[("fsmpool", pgid)]
        assert pg.fsm is not None
        assert _wait(lambda: pg.fsm.state == ACTIVE)
        visited = {s for _frm, s in pg.fsm.history}
        assert GETINFO in visited and GETLOG in visited

    def test_replica_instances_trivially_peered(self, cluster):
        """A non-primary member's instance parks in ``replica`` with
        the gate open (sub-ops are the peered primary's problem)."""
        mon, daemons, client = cluster
        io = client.open_ioctx("fsmpool")
        io.write("obj", payload(1000))
        acting = mon.osdmap.object_to_acting("fsmpool", "obj")
        member = acting[1]
        dm = next(dd for dd in daemons if dd.osd_id == member)
        pgid = mon.osdmap.object_to_pg("fsmpool", "obj")
        # replicas instantiate lazily; poke one into existence
        pg = dm._get_pg("fsmpool", pgid)
        assert _wait(lambda: pg.fsm.state == REPLICA)
        assert pg.peered.is_set()

    def test_counters_on_perf_dump(self, cluster):
        """elections_run / peering_ms land on the admin-socket perf
        dump under ``osd.<id>.peering``."""
        from ceph_tpu_torch.utils.admin_socket import admin_socket

        mon, daemons, client = cluster
        io = client.open_ioctx("fsmpool")
        io.write("obj", payload(1000))
        d, pgid = _primary_pg(mon, daemons)
        pg = d._pgs[("fsmpool", pgid)]
        assert _wait(lambda: pg.fsm.state == ACTIVE)
        dump = admin_socket.execute("perf dump")
        peering = dump[f"osd.{d.osd_id}.peering"]
        assert peering["elections_run"] >= 1
        assert peering["peering_ms"]["avgcount"] >= 1
        assert sum(peering["state_dwell_ms"]["counts"]) > 0

    def test_fence_rejection_counted(self, cluster):
        """A sub-write stamped with a superseded interval epoch is
        rejected AND counted (interval_fences_rejected)."""
        mon, daemons, client = cluster
        io = client.open_ioctx("fsmpool")
        io.write("obj", payload(1000))
        d, pgid = _primary_pg(mon, daemons)
        spec = mon.osdmap.pools["fsmpool"]
        before = d.peering_pc.get("interval_fences_rejected")
        d._fence_epochs[(spec.pool_id, pgid)] = 10_000
        stale = types.SimpleNamespace(from_osd=1, epoch=1)
        loc = f"{spec.pool_id}:obj"
        assert d._sub_write_interval_ok(stale, loc) is False
        assert d.peering_pc.get(
            "interval_fences_rejected"
        ) == before + 1


class TestCrashPoints:
    def test_pause_holds_the_gate(self, cluster):
        """An armed pause inside Activating provably holds the gate
        closed; release opens it — deterministic interleaving
        control, the whole point of the crash points."""
        mon, daemons, client = cluster
        io = client.open_ioctx("fsmpool")
        io.write("obj", payload(2000))
        d, pgid = _primary_pg(mon, daemons)
        pg = d._pgs[("fsmpool", pgid)]
        assert _wait(lambda: pg.fsm.state == ACTIVE)
        cp = crash_points.arm(
            "peering.activating.pre_les", "pause",
            osd=d.osd_id, pool="fsmpool", pgid=pgid, pause_cap=15.0,
        )
        # force a new interval: down/up a non-primary member
        victim = next(
            o for o in mon.osdmap.object_to_acting("fsmpool", "obj")[1:]
            if o is not None
        )
        dv = next(dd for dd in daemons if dd.osd_id == victim)
        mon.osd_down(victim)
        mon.osd_boot(victim, dv.addr)
        assert cp.wait_hit(10.0), "activating crash point never hit"
        assert not pg.peered.is_set(), (
            "gate open while activation is parked at the crash point"
        )
        cp.release()
        assert _wait(lambda: pg.peered.is_set())
        assert io.read("obj") == payload(2000)

    def test_fail_parks_incomplete_and_tick_retries(self, cluster):
        """A ``fail`` action aborts the transition (state
        ``incomplete``, gate closed); the tick re-kicks and the next
        pass completes — the retry seam is real."""
        mon, daemons, client = cluster
        io = client.open_ioctx("fsmpool")
        io.write("obj", payload(2000))
        d, pgid = _primary_pg(mon, daemons)
        pg = d._pgs[("fsmpool", pgid)]
        assert _wait(lambda: pg.fsm.state == ACTIVE)
        crash_points.arm(
            "peering.getinfo.pre_fence", "fail",
            osd=d.osd_id, pool="fsmpool", pgid=pgid, count=1,
        )
        pg.fsm.post_interval()
        assert _wait(lambda: pg.fsm.state == INCOMPLETE, 5.0)
        # the armed point is consumed (count=1): the tick retry runs
        # a clean pass and re-opens the gate
        assert _wait(lambda: pg.fsm.state == ACTIVE)
        assert pg.peered.is_set()

    def test_kill_stops_the_daemon(self, cluster):
        """A ``kill`` action hard-stops the daemon mid-transition
        (the ceph_abort analog) — the cluster's failure detection
        takes it from there."""
        mon, daemons, client = cluster
        io = client.open_ioctx("fsmpool")
        io.write("obj", payload(2000))
        d, pgid = _primary_pg(mon, daemons)
        crash_points.arm(
            "peering.getinfo.pre_fence", "kill",
            osd=d.osd_id, pool="fsmpool", pgid=pgid, count=1,
        )
        pg = d._pgs[("fsmpool", pgid)]
        pg.fsm.post_interval()
        assert _wait(lambda: d._stopped, 10.0), (
            "kill crash point did not stop the daemon"
        )

    def test_unarmed_fire_is_free_and_filters_hold(self):
        """fire() with nothing armed is a no-op; filters (osd, pool,
        pgid) must match for a point to consume."""
        crash_points.fire("peering.reset")  # nothing armed: no-op
        hits = []
        cp = crash_points.arm(
            "x.point", lambda **kw: hits.append(kw), osd=3, count=None,
        )
        try:
            fake3 = types.SimpleNamespace(osd_id=3)
            fake4 = types.SimpleNamespace(osd_id=4)
            crash_points.fire("x.point", daemon=fake4)  # filtered out
            assert hits == []
            crash_points.fire("x.point", daemon=fake3)
            assert len(hits) == 1
            crash_points.fire("other.point", daemon=fake3)
            assert len(hits) == 1
        finally:
            crash_points.clear()
        assert cp.hits == 1

    def test_bad_action_rejected(self):
        with pytest.raises(ValueError):
            crash_points.arm("x", "explode")

    def test_abort_is_an_exception(self):
        with pytest.raises(CrashPointAbort):
            cp = crash_points.arm("y.point", "fail")
            try:
                crash_points.fire("y.point")
            finally:
                crash_points.clear()
        assert cp.hits == 1


class TestAdmission:
    def test_admission_rejected_for_holed_position(self, cluster):
        """catchup_admit for a position that is no longer a live
        member answers False — the caller reverts to a hole and the
        tick re-heals it under the current interval."""
        from ceph_tpu_torch.cluster.osdmap import SHARD_NONE

        mon, daemons, client = cluster
        io = client.open_ioctx("fsmpool")
        io.write("obj", payload(1000))
        d, pgid = _primary_pg(mon, daemons)
        pg = d._pgs[("fsmpool", pgid)]
        assert _wait(lambda: pg.fsm.state == ACTIVE)
        pos = next(
            i for i, o in enumerate(pg.acting) if o != d.osd_id
        )
        saved = pg.acting[pos]
        pg.acting[pos] = SHARD_NONE
        try:
            assert pg.fsm.admit_caught_up(pos, timeout=5.0) is False
        finally:
            pg.acting[pos] = saved

    def test_event_burst_serializes_to_active(self, cluster):
        """A burst of concurrent interval/retry events from many
        threads drains to a single consistent Active — no torn gate,
        no deadlock (the serialization property, stress-shaped)."""
        mon, daemons, client = cluster
        io = client.open_ioctx("fsmpool")
        io.write("obj", payload(1000))
        d, pgid = _primary_pg(mon, daemons)
        pg = d._pgs[("fsmpool", pgid)]
        assert _wait(lambda: pg.fsm.state == ACTIVE)
        threads = [
            threading.Thread(target=pg.fsm.post_interval)
            for _ in range(8)
        ] + [
            threading.Thread(target=pg.fsm.post, args=("retry",))
            for _ in range(8)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(5.0)
        assert _wait(lambda: pg.fsm.state == ACTIVE, 20.0)
        assert pg.peered.is_set()
        assert io.read("obj") == payload(1000)



class TestVictimPickers:
    def test_most_and_least_primary_pickers(self):
        """The most- and least-primary pickers over a live cluster's
        primary census, ties to the lowest id; both packages' clusters
        count the same census and pick the same OSDs."""
        import importlib

        from test_torch_dcn import time_limit

        got = []
        with time_limit(60):
            for root in ("ceph_tpu", "ceph_tpu_torch"):
                lg = importlib.import_module(f"{root}.loadgen")
                kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
                cluster = lg.LoadCluster(
                    n_osds=5, k=2, m=1, pg_num=8, chunk_size=1024, **kw,
                )
                try:
                    counts = cluster._primary_counts()
                    most = cluster.most_primary_osd()
                    least = cluster.least_primary_osd()
                    assert counts[most] == max(counts.values())
                    assert counts[least] == min(counts.values())
                    assert most == min(
                        o for o, c in counts.items() if c == counts[most]
                    )
                    got.append((counts, most, least))
                finally:
                    cluster.shutdown()
        assert got[1] == got[0]

# -- twins: one command sequence through a monitor of each package -----

def _monitors():
    import importlib

    ref = importlib.import_module("ceph_tpu.cluster")
    port = importlib.import_module("ceph_tpu_torch.cluster")
    clock = [0.0]
    mons = [ref.Monitor(clock=lambda: clock[0]),
            port.Monitor(clock=lambda: clock[0], device="cpu")]
    return ref, port, mons, clock


def _commands(clock):
    """A command sequence touching every map field the monitor owns."""
    yield lambda m: [m.osd_crush_add(i, weight=1.0 + (i % 3) / 2,
                                     zone=f"z{i % 3}") for i in range(8)]
    yield lambda m: [m.osd_boot(i, ("127.0.0.1", 6800 + i))
                     for i in range(8)]
    yield lambda m: m.osd_crush_add(8, host="h8", rack="rack2")
    yield lambda m: m.osd_erasure_code_profile_set(
        "rs42", {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "4", "m": "2"})
    yield lambda m: m.osd_erasure_code_profile_set(
        "isa32", {"plugin": "isa", "k": "3", "m": "2"})
    yield lambda m: m.osd_pool_create("ecpool", 16, "rs42")
    yield lambda m: m.osd_pool_create("zoned", 8, "isa32",
                                      distinct_zones=True)
    yield lambda m: m.osd_pool_create("fd", 8, "isa32",
                                      failure_domain="host")
    yield lambda m: m.osd_down(3)
    yield lambda m: m.report_failure(1, 5)
    yield lambda m: m.report_failure(2, 5)
    yield lambda m: m.osd_out(3)
    yield lambda m: m.osd_reweight(6, 0.5)
    yield lambda m: m.config_set("osd_max_backfills", 2, who="osd")
    yield lambda m: m.osd_pool_qos_set("ecpool", tenant="gold",
                                       res_ops=8.0, weight=3.0)
    yield lambda m: m.pg_temp_set("ecpool", 3, [0, 1, 2, 4, 6, 7])
    yield lambda m: m.pg_temp_clear("ecpool", 3)
    yield lambda m: m.osd_pool_snap_create("ecpool", "snap1")
    yield lambda m: m.osd_in(3)
    yield lambda m: m.osd_boot(3, ("127.0.0.1", 6803))

    def auto_out(m):
        clock[0] += 10_000.0  # past mon_osd_down_out_interval
        return m.tick()

    yield auto_out
    yield lambda m: m.osd_pool_qos_rm("ecpool", tenant="gold")
    yield lambda m: m.osd_pool_rm("zoned")


def test_twin_osdmap_bytes_equal_at_every_epoch():
    _ref, _port, mons, clock = _monitors()
    assert mons[0].osdmap.to_bytes() == mons[1].osdmap.to_bytes()
    epochs = 0
    for cmd in _commands(clock):
        for mon in mons:
            cmd(mon)
        assert mons[0].osdmap.epoch == mons[1].osdmap.epoch
        assert mons[0].osdmap.to_bytes() == mons[1].osdmap.to_bytes(), (
            f"maps differ at epoch {mons[0].osdmap.epoch}")
        epochs = mons[0].osdmap.epoch
    assert epochs >= 25
    # every incremental of the history is equal, and replays to the map
    incs = [m.get_incrementals(0) for m in mons]
    assert [i.to_bytes() for i in incs[0]] == [i.to_bytes() for i in incs[1]]
    replay = _port.OSDMap()
    for inc in incs[1]:
        replay = replay.apply(_port.Incremental.from_bytes(inc.to_bytes()))
    assert replay.to_bytes() == mons[0].osdmap.to_bytes()
    # a ceph_tpu map decodes in the port to the same bytes and placement
    carried = _port.OSDMap.from_bytes(mons[0].osdmap.to_bytes())
    assert carried.to_bytes() == mons[0].osdmap.to_bytes()
    for pg in range(16):
        assert carried.pg_to_up_acting("ecpool", pg) == \
            mons[0].osdmap.pg_to_up_acting("ecpool", pg)


BAD_PROFILES = [
    {"plugin": "nope"},
    {"plugin": "jerasure", "technique": "reed_sol_van", "k": "0", "m": "2"},
    {"plugin": "jerasure", "technique": "no_such_technique"},
    {"plugin": "isa", "k": "3", "m": "x"},
    {"plugin": "isa", "technique": "cauchy", "k": "40", "m": "30"},
    {"plugin": "lrc", "k": "4", "m": "2", "l": "4"},
    {"plugin": "clay", "k": "4", "m": "2", "d": "9"},
    {"plugin": "shec", "k": "4", "m": "3", "c": "4"},
]


@pytest.mark.parametrize("profile", BAD_PROFILES,
                         ids=[str(i) for i in range(len(BAD_PROFILES))])
def test_twin_profile_validation_raises_the_same(profile):
    ref, port, mons, _clock = _monitors()
    errors = []
    for mod, mon in zip((ref, port), mons):
        with pytest.raises(mod.CommandError) as exc:
            mon.osd_erasure_code_profile_set("bad", dict(profile))
        errors.append(str(exc.value))
        assert "bad" not in mon.osdmap.profiles
    # the plugin loader names its own package's module
    assert errors[0] == errors[1].replace("ceph_tpu_torch.", "ceph_tpu.")


def test_twin_profile_overwrite_and_pool_errors_equal():
    ref, port, mons, _clock = _monitors()
    outcomes = []
    for mod, mon in zip((ref, port), mons):
        got = []
        for i in range(4):
            mon.osd_crush_add(i)
        mon.osd_erasure_code_profile_set(
            "p", {"plugin": "isa", "k": "2", "m": "1"})
        for call in (
            lambda: mon.osd_erasure_code_profile_set(
                "p", {"plugin": "isa", "k": "2", "m": "2"}),
            lambda: mon.osd_pool_create("pool", 8, "missing"),
            lambda: mon.osd_pool_create("pool", 8, "p"),
            lambda: mon.osd_pool_create("pool", 8, "p"),
            lambda: mon.osd_pool_rm("nope"),
        ):
            try:
                call()
                got.append("ok")
            except mod.CommandError as e:
                got.append(f"CommandError: {e}")
            except (KeyError, ValueError) as e:
                got.append(f"{type(e).__name__}: {e}")
        outcomes.append((got, mon.osdmap.to_bytes()))
    assert outcomes[0] == outcomes[1]
