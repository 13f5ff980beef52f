"""The port's crash-consistent RMW commit against ceph_tpu's, on the CPU.

Mirrors ``tests/test_rmw_crash_points.py`` on ``ceph_tpu_torch`` with
``device="cpu"``: the kill-at-point -> restart -> replay drill at each
RMW commit point (``rmw.prepare_done``,
``rmw.subwrite_applied_before_ack``, ``rmw.primary_before_commit``,
``rmw.primary_committed_before_reply``), the committed append that must
land once, the registry's pause and osd filter, and the committed kill
under the seeded lossy links.

Each kill-at-point drill is a twin: both packages' ``LoadCluster`` (4
OSDs, jerasure EC(2,1), 4 PGs) run the same drill, and the committed
object's shards are equal on every OSD in bytes, HINFO and OI (its size
and tid; the map epoch in its eversion follows the daemons' timing), as
are the clients' reads and each OSD's ``osd.N.rmw_crash`` rollback and
rollforward counts. Every cluster-booting case runs under a time limit
of its own.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

from test_torch_dcn import limited, time_limit  # noqa: E402

from ceph_tpu_torch.utils.crash_points import crash_points  # noqa: E402

ROOTS = ("ceph_tpu", "ceph_tpu_torch")
OLD = b"committed-old-" + bytes(range(200)) * 12
NEW = b"committed-new-" + bytes(reversed(range(256))) * 9
POINTS = [
    ("rmw.prepare_done", "primary"),
    ("rmw.subwrite_applied_before_ack", "replica"),
    ("rmw.primary_before_commit", "primary"),
    ("rmw.primary_committed_before_reply", "primary"),
]


def _points(root):
    return importlib.import_module(f"{root}.utils.crash_points").crash_points


@pytest.fixture(autouse=True)
def clean_points():
    for root in ROOTS:
        _points(root).clear()
    yield
    for root in ROOTS:
        _points(root).clear()


def _boot(root):
    lg = importlib.import_module(f"{root}.loadgen")
    kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    return lg.LoadCluster(
        n_osds=4, k=2, m=1, pg_num=4, chunk_size=1024,
        tick_period=0.1, client_op_timeout=2.0,
        client_max_attempts=12, client_backoff=0.05, **kw,
    )


@pytest.fixture
def cluster():
    c = _boot("ceph_tpu_torch")
    yield c
    c.shutdown()


def _acting(cluster, oid):
    return cluster.mon.osdmap.object_to_acting(cluster.pool, oid)


def _kill_at_point_and_converge(
    cluster, point, victim_role, oid="crash-obj", points=crash_points,
):
    """The shared kill->restart->replay drill. ``victim_role`` is
    "primary" or "replica" (which daemon the point is armed on)."""
    io = cluster.io
    assert io.write_full(oid, OLD) == len(OLD)
    acting = _acting(cluster, oid)
    primary = acting[0]
    victim = primary if victim_role == "primary" else acting[1]
    pt = points.arm(point, "kill", osd=victim)

    comp = io.aio_write_full(oid, NEW)
    assert pt.wait_hit(15), f"{point} never fired on osd.{victim}"
    cluster.kill(victim)
    reply = comp.wait_for_complete(45)
    assert reply.size == len(NEW)
    cluster.revive(victim)
    assert cluster.wait_recovered(45), "revive never converged"
    got = io.read(oid)
    assert got == NEW, (
        f"committed read after {point} kill returned "
        f"{len(got)}B != committed {len(NEW)}B"
    )
    assert cluster.scrub_clean(), "post-replay cluster not scrub-clean"
    return victim


def _drill_state(root, point, role):
    """The drill on ``root``'s cluster; returns what the twin compares:
    the victim, the read, the committed object's shards on every OSD
    (bytes, HINFO, OI size and tid) and every OSD's rollback and
    rollforward counts."""
    rmw = importlib.import_module(f"{root}.pipeline.rmw")
    c = _boot(root)
    try:
        victim = _kill_at_point_and_converge(
            c, point, role, points=_points(root))
        shards = {}
        for osd, store in sorted(c.stores.items()):
            for key in store.list_objects():
                if ":crash-obj#s" not in key:
                    continue
                attrs = store.getattrs(key)
                size, (_epoch, tid) = rmw.parse_oi(attrs[rmw.OI_KEY])
                shards[(osd, key)] = (store.read(key),
                                      attrs.get(rmw.HINFO_KEY), size, tid)
        crash = {osd: (d.rmw_crash_pc.get("rollforwards"),
                       d.rmw_crash_pc.get("rollbacks"))
                 for osd, d in sorted(c.daemons.items())}
        return victim, c.io.read("crash-obj"), shards, crash
    finally:
        c.shutdown()


@pytest.mark.parametrize("point,role", POINTS,
                         ids=[p.split(".", 1)[1] for p, _r in POINTS])
@limited(90)
def test_twin_kill_at_every_point(point, role):
    """TestKillAtEveryPoint in both packages: the committed bytes read
    back and scrub clean in each (the drill's asserts), and the two
    runs leave equal shards, HINFO, OI and replay counts. A replica
    killed after applying its sub-write is replayed (the reference's
    rollback/rollforward count above 0)."""
    ref = _drill_state("ceph_tpu", point, role)
    port = _drill_state("ceph_tpu_torch", point, role)
    assert port[0] == ref[0]
    assert port[1] == ref[1] == NEW
    assert sorted(port[2]) == sorted(ref[2]) and port[2], "shard keys"
    for key in ref[2]:
        assert port[2][key] == ref[2][key], key
    assert port[3] == ref[3]
    if point == "rmw.subwrite_applied_before_ack":
        assert sum(sum(v) for v in port[3].values()) > 0, (
            f"revival of osd.{port[0]} must have replayed the log")


class TestCommittedBytesNeverDouble:
    @limited(60)
    def test_append_resend_after_committed_kill_appends_once(
        self, cluster
    ):
        """An APPEND whose primary dies between commit and reply: the
        resend replays the recorded result, never re-applies."""
        io = cluster.io
        oid = "crash-append"
        io.write_full(oid, b"base|")
        primary = _acting(cluster, oid)[0]
        pt = crash_points.arm(
            "rmw.primary_committed_before_reply", "kill", osd=primary
        )
        comp = io.objecter.submit_async(
            cluster.pool, oid, "append", data=b"once|"
        )
        assert pt.wait_hit(15)
        cluster.kill(primary)
        reply = comp.wait_for_complete(45)
        assert reply.size == len(b"base|once|")
        cluster.revive(primary)
        assert cluster.wait_recovered(45)
        assert io.read(oid) == b"base|once|", "append must land once"
        assert cluster.scrub_clean()


class TestRegistryAndPoints:
    def test_registry_lives_in_utils_and_peering_reexports(self):
        from ceph_tpu_torch.cluster.peering import (
            crash_points as via_peering,
        )
        from ceph_tpu_torch.utils.crash_points import (
            crash_points as via_utils,
        )

        assert via_peering is via_utils
        assert via_utils is not _points("ceph_tpu"), (
            "each package keeps its own registry")

    @limited(60)
    def test_pause_point_holds_commit_until_release(self, cluster):
        """A pause at primary_before_commit holds the commit edge (the
        op is not committed while paused), then completes on release."""
        io = cluster.io
        oid = "pause-obj"
        io.write_full(oid, OLD)
        primary = _acting(cluster, oid)[0]
        pt = crash_points.arm(
            "rmw.primary_before_commit", "pause", osd=primary,
            pause_cap=20.0,
        )
        comp = io.aio_write_full(oid, NEW)
        assert pt.wait_hit(15)
        assert not comp.is_complete(), (
            "op must not commit while paused at the pre-commit edge"
        )
        pt.release()
        reply = comp.wait_for_complete(30)
        assert reply.size == len(NEW)
        assert io.read(oid) == NEW

    @limited(60)
    def test_osd_filter_scopes_the_point(self, cluster):
        """A point armed for one osd must not fire on another."""
        io = cluster.io
        oid = "scope-obj"
        acting = _acting(cluster, oid)
        not_involved = next(
            i for i in cluster.daemons if i not in acting
        )
        pt = crash_points.arm(
            "rmw.prepare_done", "kill", osd=not_involved
        )
        assert io.write_full(oid, OLD) == len(OLD)
        assert pt.hits == 0
        assert io.read(oid) == OLD


@pytest.mark.net_chaos
class TestCrashUnderLossyLinks:
    def test_committed_kill_with_flaky_links_still_exact(self):
        """A mid-commit primary kill under the seeded lossy profile:
        resends ride duplicated and delayed frames and the committed
        read still returns exactly the committed bytes."""
        from ceph_tpu_torch.loadgen import LoadCluster
        from ceph_tpu_torch.msg.messenger import net_faults
        from ceph_tpu_torch.utils import config

        with time_limit(120), config.override(
            osd_peer_rpc_timeout=1.0, osd_subop_resend_interval=0.2,
        ):
            cluster = LoadCluster(
                n_osds=4, k=2, m=1, pg_num=4, chunk_size=1024,
                tick_period=0.1, client_op_timeout=2.0,
                client_max_attempts=12, client_backoff=0.05,
                device="cpu",
            )
            try:
                cluster.net_flaky(seed=0x5EED)
                _kill_at_point_and_converge(
                    cluster, "rmw.primary_committed_before_reply",
                    "primary", oid="chaos-crash",
                )
            finally:
                net_faults.clear()
                cluster.shutdown()
