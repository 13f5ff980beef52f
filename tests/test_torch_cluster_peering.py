"""The port's authoritative-log election against ceph_tpu's, on the CPU.

Mirrors ``tests/test_cluster_peering.py`` on ``ceph_tpu_torch`` with
``device="cpu"``: the les ledger written on activation, the returning
ex-primary rewound at admission, an interval without client IO still
activated, the pinned takeover interleaving, and the election's order.

Twins (the same commands through a ``ceph_tpu`` cluster and a port
cluster):

- the pinned takeover interleaving: the returning ex-primary's peering
  transitions and every acting member's (les, last_update) ledger are
  equal, as are the object's shards on every OSD;
- a returning primary peers a PG it leads only at the PG's first op
  (``OSDDaemon._get_pg`` is lazy, and the eager interval pass skips a
  PG whose acting set is the one it last activated): until then its
  shard holds the bytes it had when it left; the first op peers it and
  rewinds the shard. Both packages do this: reference behaviour;
- a returning member's catch-up rebuilds its shard of every snapshot
  clone in the PGs it is a member of (the clones' stamps predate the
  interval it missed), byte for byte the shard it had: both packages
  count the same rollbacks. Reference behaviour, not a fault.

Every cluster-booting case runs under a time limit of its own.
"""

import importlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_dcn import limited  # noqa: E402

from ceph_tpu_torch.pipeline.rmw import OI_KEY, pack_oi, parse_oi  # noqa: E402
from ceph_tpu_torch.store import Transaction  # noqa: E402


def _boot_cluster(tick_period: float = 2.0, root: str = "ceph_tpu_torch"):
    cl = importlib.import_module(f"{root}.cluster")
    kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    mon = cl.Monitor(**kw)
    daemons = []
    for i in range(6):
        mon.osd_crush_add(i, zone=f"z{i % 3}")
    for i in range(6):
        d = cl.OSDDaemon(i, mon, chunk_size=1024, tick_period=tick_period,
                         **kw)
        d.start()
        daemons.append(d)
    mon.osd_erasure_code_profile_set(
        "rs32", {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "3", "m": "2"}
    )
    mon.osd_pool_create("ecpool", 8, "rs32")
    client = cl.RadosClient(mon, backoff=0.01)
    return mon, daemons, client


def _stop(daemons, client):
    client.shutdown()
    for d in daemons:
        if not d._stopped:
            d.stop()


@pytest.fixture
def cluster():
    mon, daemons, client = _boot_cluster()
    yield mon, daemons, client
    _stop(daemons, client)


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


@limited(60)
def test_les_ledger_written_on_activation(cluster):
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("obj", payload(4_000))
    spec = mon.osdmap.pools["ecpool"]
    pgid = mon.osdmap.object_to_pg("ecpool", "obj")
    acting = mon.osdmap.object_to_acting("ecpool", "obj")
    primary = acting[0]
    d = next(dd for dd in daemons if dd.osd_id == primary)
    assert _wait(
        lambda: d._pgmeta_read(spec.pool_id, pgid) > 0
    ), "primary never recorded les"
    member = acting[1]
    dm = next(dd for dd in daemons if dd.osd_id == member)
    assert _wait(
        lambda: dm._pgmeta_read(spec.pool_id, pgid) > 0
    ), "member never recorded les"
    les, lu = d.peers.get_pg_info(member, spec.pool_id, spec.pg_num, pgid)
    assert les == dm._pgmeta_read(spec.pool_id, pgid)


@limited(60)
def test_returning_ex_primary_rewound_at_admission(cluster):
    """The ex-primary partitions away holding self-consistent divergent
    writes and a divergent create; on return it is the map-order
    primary again, loses the election, rewinds its shard and removes
    the create before serving a read (no scrub runs)."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("obj", payload(5_000, seed=1))
    acting = mon.osdmap.object_to_acting("ecpool", "obj")
    ex_primary = acting[0]
    spec = mon.osdmap.pools["ecpool"]
    dxp = next(dd for dd in daemons if dd.osd_id == ex_primary)
    pgid = mon.osdmap.object_to_pg("ecpool", "obj")
    phantom_oid = next(
        f"ph{i}" for i in range(200)
        if mon.osdmap.object_to_pg("ecpool", f"ph{i}") == pgid
    )

    mon.osd_down(ex_primary)
    head = payload(900, seed=2)
    io.write("obj", head, offset=0)
    authoritative = head + payload(5_000, seed=1)[900:]

    store = dxp.store
    keys = [
        k for k in store.list_objects()
        if k.startswith(f"{spec.pool_id}:obj#s")
    ]
    assert keys, "ex-primary should hold a shard of obj"
    key = keys[0]
    _size, ev = parse_oi(store.getattr(key, OI_KEY))
    store.queue_transactions(
        Transaction()
        .write(key, 0, b"\xde\xad" * 64)
        .setattr(key, OI_KEY, pack_oi(_size, (ev[0], ev[1] + 7)))
    )
    phantom = f"{spec.pool_id}:{phantom_oid}#s0"
    store.queue_transactions(
        Transaction()
        .touch(phantom)
        .write(phantom, 0, b"ghost-bytes")
        .setattr(phantom, OI_KEY, pack_oi(11, (ev[0], ev[1] + 8)))
        .setattr(phantom, "si", b"0")
    )

    mon.osd_boot(ex_primary, dxp.addr)
    assert mon.osdmap.object_to_acting("ecpool", "obj")[0] == ex_primary
    got = io.read("obj")
    assert got == authoritative, (
        "returning ex-primary served divergent bytes"
    )
    assert _wait(
        lambda: store.read(key)[:4] != b"\xde\xad\xde\xad"
    ), "divergent shard bytes survived peering"
    assert _wait(lambda: not store.exists(phantom)), (
        "divergent create survived peering"
    )


@limited(60)
def test_interval_without_client_io_still_activates(cluster):
    """No writes while the ex-primary is away: the interim primary
    still activates the new interval, so the ledger ranks the returning
    ex-primary down though last_update ties."""
    mon, daemons, client = cluster
    io = client.open_ioctx("ecpool")
    io.write("obj", payload(3_000, seed=3))
    original = payload(3_000, seed=3)
    acting = mon.osdmap.object_to_acting("ecpool", "obj")
    ex_primary = acting[0]
    interim = acting[1]
    spec = mon.osdmap.pools["ecpool"]
    pgid = mon.osdmap.object_to_pg("ecpool", "obj")
    dxp = next(dd for dd in daemons if dd.osd_id == ex_primary)
    dint = next(dd for dd in daemons if dd.osd_id == interim)

    les_before = dint._pgmeta_read(spec.pool_id, pgid)
    mon.osd_down(ex_primary)
    assert _wait(
        lambda: dint._pgmeta_read(spec.pool_id, pgid) > les_before
    ), "interim primary never activated the no-IO interval"

    store = dxp.store
    key = next(
        k for k in store.list_objects()
        if k.startswith(f"{spec.pool_id}:obj#s")
    )
    _size, ev = parse_oi(store.getattr(key, OI_KEY))
    store.queue_transactions(
        Transaction()
        .write(key, 0, b"\xbe\xef" * 32)
        .setattr(key, OI_KEY, pack_oi(_size, (ev[0], ev[1] + 5)))
    )

    mon.osd_boot(ex_primary, dxp.addr)
    assert io.read("obj") == original
    assert _wait(
        lambda: store.read(key)[:4] != b"\xbe\xef\xbe\xef"
    ), "divergent bytes survived a no-IO interval return"


# -- the pinned takeover interleaving ----------------------------------

def _takeover_sequence(mon, daemons, io):
    """write v1 -> primary marked down (daemon keeps running) ->
    write_full v2 through the interim -> ex-primary booted back."""
    v1 = payload(5_000, seed=21)
    io.write("obj", v1)
    acting = mon.osdmap.object_to_acting("ecpool", "obj")
    ex_primary = acting[0]
    dxp = next(dd for dd in daemons if dd.osd_id == ex_primary)
    pgid = mon.osdmap.object_to_pg("ecpool", "obj")
    mon.osd_down(ex_primary)
    v2 = payload(900, seed=22)
    io.write_full("obj", v2)
    mon.osd_boot(ex_primary, dxp.addr)
    assert mon.osdmap.object_to_acting("ecpool", "obj")[0] == ex_primary
    return dxp, pgid, v2


def _obj_route(mon):
    return (
        mon.osdmap.object_to_acting("ecpool", "obj")[0],
        mon.osdmap.object_to_pg("ecpool", "obj"),
    )


def _pinned_takeover(root):
    """The reference's pinned interleaving on ``root``'s cluster with
    the GetMissing crash point held; returns the returning primary's
    peering transitions, every acting member's (les, last_update) and
    the object's shards."""
    peering = importlib.import_module(f"{root}.cluster.peering")
    crash_points = peering.crash_points
    mon, daemons, client = _boot_cluster(tick_period=0.0, root=root)
    io = client.open_ioctx("ecpool")
    try:
        ex, pgid0 = _obj_route(mon)
        cp = crash_points.arm(
            "peering.getmissing.pre_rewind", "pause",
            osd=ex, pool="ecpool", pgid=pgid0, pause_cap=20.0,
        )
        dxp, pgid, v2 = _takeover_sequence(mon, daemons, io)
        assert pgid == pgid0
        assert cp.wait_hit(10.0), "getmissing crash point never hit"
        pg = dxp._pgs.get(("ecpool", pgid))
        assert pg is not None and not pg.peered.is_set(), (
            "gate open while the ex-primary is mid-reconciliation"
        )
        cp.release()
        assert io.read("obj") == v2, (
            "returned ex-primary served torn/stale bytes"
        )
        assert pg.acting[0] == dxp.osd_id
        assert _wait(lambda: pg.peered.is_set())
        assert pg.fsm.state == "active"
        spec = mon.osdmap.pools["ecpool"]
        ledger = {d.osd_id: d._own_pg_info(spec.pool_id, spec.pg_num, pgid)
                  for d in daemons if d.osd_id in pg.acting}
        shards = {(d.osd_id, key): d.store.read(key) for d in daemons
                  for key in d.store.list_objects() if ":obj#s" in key}
        return list(pg.fsm.history), ledger, shards
    finally:
        crash_points.clear()
        _stop(daemons, client)


@limited(90)
def test_fsm_pins_takeover_interleaving():
    """The returning ex-primary reconciles before serving: the
    GetMissing crash point holds the pass mid-reconciliation with the
    gate closed; on release the read returns exactly v2 and the primary
    position never holes (tick_period 0: no re-heal tick as a crutch).
    Twinned: both packages take the same peering transitions and leave
    the same (les, last_update) ledger on every acting member and the
    same shards."""
    ref = _pinned_takeover("ceph_tpu")
    port = _pinned_takeover("ceph_tpu_torch")
    assert port[0] == ref[0] and port[0], "peering transitions"
    assert port[1] == ref[1]
    assert port[2] == ref[2]


def test_election_prefers_highest_les_then_lu(cluster):
    """Unit-level: the ordering is (les, last_update), ties prefer self
    then lowest osd id."""
    infos = {
        1: (5, (3, 10)),
        2: (6, (3, 2)),
        3: (6, (3, 1)),
    }
    best = max(infos, key=lambda o: (infos[o], o == 1, -o))
    assert best == 2
    infos = {1: (6, (3, 2)), 2: (6, (3, 2))}
    best = max(infos, key=lambda o: (infos[o], o == 1, -o))
    assert best == 1


# -- twins of two behaviours path 14 met --------------------------------

def _returning_primary(root):
    """A primary stopped, its PG's object rewritten through the
    interim, a fresh daemon revived over its store; returns the PG's
    instance on the revived primary and its shard's bytes after two
    ticks (before any op), then after the first op, and the read."""
    cl = importlib.import_module(f"{root}.cluster")
    kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    mon, daemons, client = _boot_cluster(tick_period=0.2, root=root)
    io = client.open_ioctx("ecpool")
    try:
        io.write_full("obj", payload(6_000, seed=31))
        ex, pgid = _obj_route(mon)
        spec = mon.osdmap.pools["ecpool"]
        key = f"{spec.pool_id}:obj#s0"
        before = daemons[ex].store.read(key)
        daemons[ex].stop()
        mon.osd_down(ex)
        v2 = payload(6_000, seed=32)
        io.write_full("obj", v2)
        d = cl.OSDDaemon(ex, mon, store=daemons[ex].store,
                         chunk_size=1024, tick_period=0.2, **kw)
        d.start()
        daemons[ex] = d
        assert mon.osdmap.object_to_acting("ecpool", "obj")[0] == ex
        time.sleep(0.6)  # ticks pass with no op on the PG
        lazy = ("ecpool", pgid) not in d._pgs
        stale = d.store.read(key) == before
        assert io.stat("obj") == len(v2)  # the PG's first op
        assert _wait(lambda: d.store.read(key) != before)
        pg = d._pgs[("ecpool", pgid)]
        assert _wait(lambda: pg.peered.is_set())
        return lazy, stale, d.store.read(key), io.read("obj") == v2
    finally:
        _stop(daemons, client)


@limited(90)
def test_twin_returning_primary_peers_at_first_op():
    """Both packages leave a returning primary's PG uninstantiated
    until its first op (its shard still the one it left with), then
    peer it at that op and rewind the shard to the same bytes."""
    ref = _returning_primary("ceph_tpu")
    port = _returning_primary("ceph_tpu_torch")
    assert port == ref
    assert port[:2] == (True, True) and port[3]


def _clone_catch_up(root):
    """A pool snapshot, every object overwritten (each head cloned
    first), a non-primary member stopped, one object rewritten, the
    member revived over its store; returns each OSD's rollback count,
    the revived member's clone shards before and after, and the reads
    at the head and the snapshot."""
    cl = importlib.import_module(f"{root}.cluster")
    osdd = importlib.import_module(f"{root}.cluster.osd_daemon")
    kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    mon, daemons, client = _boot_cluster(tick_period=0.2, root=root)
    io = client.open_ioctx("ecpool")
    oids = [f"o{i}" for i in range(6)]
    try:
        for i, oid in enumerate(oids):
            io.write_full(oid, payload(3_000 + 100 * i, seed=40 + i))
        io.snap_create("s1")
        for i, oid in enumerate(oids):
            io.write_full(oid, payload(2_000 + 100 * i, seed=50 + i))
        pgid = mon.osdmap.object_to_pg("ecpool", oids[0])
        member = mon.osdmap.pg_to_up_acting("ecpool", pgid)[1]
        store = daemons[member].store

        def clones():
            return {key: store.read(key) for key in store.list_objects()
                    if osdd.SNAP_SEP in key}

        before = clones()
        assert before, "the member holds no clone shard"
        daemons[member].stop()
        mon.osd_down(member)
        io.write_full(oids[0], payload(2_500, seed=60))
        rolled0 = {d.osd_id: d.rmw_crash_pc.get("rollbacks")
                   for d in daemons if d.osd_id != member}
        d = cl.OSDDaemon(member, mon, store=store, chunk_size=1024,
                         tick_period=0.2, **kw)
        d.start()
        daemons[member] = d

        def recovered():
            for p in range(8):
                acting = mon.osdmap.pg_to_up_acting("ecpool", p)
                pg = daemons[acting[0]]._pgs.get(("ecpool", p))
                if pg is not None and (not pg.peered.is_set()
                                       or pg.backend.recovering):
                    return False
            return True

        assert _wait(recovered, 30)
        reads = [(io.read(oid), io.read(oid, snap="s1")) for oid in oids]
        rolled = {d.osd_id: d.rmw_crash_pc.get("rollbacks")
                  - rolled0.get(d.osd_id, 0)
                  for d in daemons if d.osd_id != member}
        return rolled, before, clones(), reads
    finally:
        _stop(daemons, client)


@limited(90)
def test_twin_catch_up_rebuilds_clone_shards():
    """A member's catch-up rebuilds its clone shards in both packages:
    the same rollback counts on every primary, the clone shards the
    same bytes after as before, and every head and snapshot read
    equal."""
    ref = _clone_catch_up("ceph_tpu")
    port = _clone_catch_up("ceph_tpu_torch")
    assert port[0] == ref[0]
    assert sum(port[0].values()) > 0, "no clone shard was rebuilt"
    assert port[2] == port[1] and ref[2] == ref[1]
    assert port[1] == ref[1]
    assert port[3] == ref[3]
