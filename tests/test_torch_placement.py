"""The port's placement (``placement.py``, flat straw2) and CRUSH
hierarchy (``crush.py``) against ceph_tpu's, on the CPU.

The mirrors run the reference's ``tests/test_placement.py`` and
``tests/test_crush.py`` against ``ceph_tpu_torch`` (the cluster cases
on ``device="cpu"``). The twin cases hold placement equal across the
packages: the same devices, weights, zones and rules give the same
acting sets for 2,000 seeded object names under a flat map, a zoned
map and a rack rule, and the same ``stable_hash``.
"""

from collections import Counter
import pytest
import numpy as np

torch = pytest.importorskip("torch")

from ceph_tpu_torch.placement import CrushMap, Device, PGMap, stable_hash  # noqa: E402
from ceph_tpu_torch.crush import CrushHierarchy, ec_rule, lrc_rule  # noqa: E402
from ceph_tpu_torch.placement import Device  # noqa: E402


# -- mirror of tests/test_placement.py ------------------------------------

def flat_map(n=10, weight=1.0):
    return CrushMap([Device(i, weight) for i in range(n)])


class TestDeterminism:
    def test_stable_hash_pinned(self):
        # Frozen forever: placement must never move across releases.
        assert stable_hash("pin") == stable_hash("pin")
        assert stable_hash("pin") != stable_hash("pin2")
        assert stable_hash(1, 2) != stable_hash(2, 1)

    def test_select_deterministic(self):
        m = flat_map()
        for pg in range(50):
            assert m.select(pg, 3) == m.select(pg, 3)

    def test_distinct(self):
        m = flat_map(6)
        for pg in range(200):
            acting = m.select(pg, 6)
            assert len(set(acting)) == 6


class TestDistribution:
    def test_uniform_weights(self):
        m = flat_map(8)
        counts = Counter()
        for pg in range(4000):
            counts[m.select(pg, 1)[0]] += 1
        expect = 4000 / 8
        for dev, c in counts.items():
            assert abs(c - expect) < expect * 0.25, (dev, c)

    def test_weight_proportional(self):
        m = CrushMap(
            [Device(0, 1.0), Device(1, 1.0), Device(2, 2.0)]
        )
        counts = Counter()
        for pg in range(8000):
            counts[m.select(pg, 1)[0]] += 1
        # device 2 has half the total weight
        assert abs(counts[2] - 4000) < 500, counts
        assert abs(counts[0] - 2000) < 400, counts

    def test_zero_weight_excluded(self):
        m = CrushMap([Device(0, 1.0), Device(1, 0.0), Device(2, 1.0)])
        for pg in range(100):
            assert 1 not in m.select(pg, 2)


class TestMinimalMovement:
    def test_add_device_moves_fraction(self):
        before = flat_map(9)
        after = flat_map(10)  # adds device 9
        moved = sum(
            before.select(pg, 1) != after.select(pg, 1)
            for pg in range(4000)
        )
        # straw2: only PGs now drawing highest for the new device move
        # (~1/10); well under any rehash-everything scheme (~9/10).
        assert moved < 4000 * 0.2, moved
        assert moved > 0

    def test_reweight_only_affects_that_device(self):
        a = CrushMap([Device(i, 1.0) for i in range(10)])
        b = CrushMap(
            [Device(i, 1.0 if i != 3 else 0.5) for i in range(10)]
        )
        for pg in range(2000):
            sa, sb = a.select(pg, 1)[0], b.select(pg, 1)[0]
            if sa != sb:
                assert sa == 3  # movement only AWAY from the downweighted


class TestFailureDomains:
    def test_distinct_zones(self):
        m = CrushMap(
            [Device(i, 1.0, zone=f"rack{i // 3}") for i in range(9)]
        )
        for pg in range(200):
            acting = m.select(pg, 3, distinct_zones=True)
            zones = {m.devices[d].zone for d in acting}
            assert len(zones) == 3, (pg, acting, zones)

    def test_zone_exhaustion_falls_back(self):
        m = CrushMap(
            [Device(i, 1.0, zone=f"z{i % 2}") for i in range(6)]
        )
        acting = m.select(7, 4, distinct_zones=True)
        assert len(acting) == 4 and len(set(acting)) == 4


class TestPGMap:
    def test_object_routing(self):
        pgmap = PGMap(flat_map(6), pg_num=64)
        acting = pgmap.object_to_acting("obj.42", 6)
        assert len(set(acting)) == 6
        assert acting == pgmap.object_to_acting("obj.42", 6)
        assert 0 <= pgmap.object_to_pg("anything") < 64

    def test_pool_isolation(self):
        crush = flat_map(6)
        a = PGMap(crush, 64, pool="a")
        b = PGMap(crush, 64, pool="b")
        diffs = sum(
            a.object_to_acting(f"o{i}", 3) != b.object_to_acting(f"o{i}", 3)
            for i in range(100)
        )
        assert diffs > 50  # pools shouldn't co-place

    def test_bad_pg_num(self):
        with pytest.raises(ValueError):
            PGMap(flat_map(), 0)


# -- mirror of tests/test_crush.py ----------------------------------------

def racks_hosts(racks=3, hosts=2, per_host=2):
    """racks x hosts x per_host devices, ids dense."""
    h = CrushHierarchy()
    oid = 0
    for r in range(racks):
        for hh in range(hosts):
            for _ in range(per_host):
                h.add_device(
                    Device(oid),
                    {"host": f"h{r}{hh}", "rack": f"rack{r}"},
                )
                oid += 1
    return h


def test_tree_weights_sum():
    h = racks_hosts()
    assert h.item_weight("default") == 12
    assert h.item_weight("rack0") == 4
    assert h.item_weight("h00") == 2
    h.reweight(0, 0.25)
    assert h.item_weight("h00") == 1.25
    assert h.item_weight("rack0") == 3.25
    assert h.item_weight("default") == 11.25


def test_golden_placement_frozen():
    """Placement must never change for a fixed topology — golden
    acting sets, the cross-version stability contract."""
    h = racks_hosts()
    got = [h.run_rule(ec_rule("rack"), (pg,), 3) for pg in range(6)]
    assert got == [
        [2, 7, 10],
        [8, 0, 5],
        [4, 2, 10],
        [2, 4, 8],
        [0, 5, 11],
        [6, 10, 3],
    ], f"golden placement drifted: {got}"


def test_rack_and_host_distinct():
    h = racks_hosts()
    rack_of = {i: i // 4 for i in range(12)}
    host_of = {i: i // 2 for i in range(12)}
    for pg in range(128):
        s = h.run_rule(ec_rule("rack"), (pg,), 3)
        assert len(s) == 3 and len({rack_of[o] for o in s}) == 3
        s = h.run_rule(ec_rule("host"), (pg,), 6)
        assert len(s) == 6 and len({host_of[o] for o in s}) == 6


def test_multi_step_rule_two_per_rack():
    """take -> choose 3 racks -> chooseleaf 2 hosts -> emit: six
    shards, exactly two per rack, distinct hosts."""
    h = racks_hosts()
    rule = (
        ("take", "default"),
        ("choose_firstn", 3, "rack"),
        ("chooseleaf_firstn", 2, "host"),
        ("emit",),
    )
    rack_of = {i: i // 4 for i in range(12)}
    host_of = {i: i // 2 for i in range(12)}
    for pg in range(64):
        s = h.run_rule(rule, (pg,), 6)
        assert len(s) == 6
        per_rack: dict[int, int] = {}
        for o in s:
            per_rack[rack_of[o]] = per_rack.get(rack_of[o], 0) + 1
        assert set(per_rack.values()) == {2}, (pg, s)
        assert len({host_of[o] for o in s}) == 6


def test_weight_proportional_balance():
    h = racks_hosts()
    from collections import Counter

    c = Counter(
        o
        for pg in range(2048)
        for o in h.run_rule(ec_rule("host"), (pg,), 6)
    )
    share = 2048 * 6 / 12
    for dev, cnt in c.items():
        assert abs(cnt - share) / share < 0.12, (dev, cnt)


def test_reweight_minimal_movement():
    """Halving one device's weight moves a bounded fraction of
    MEMBERSHIP slots — the straw2 property, per level."""
    h = racks_hosts()
    rule = ec_rule("host")
    before = {pg: set(h.run_rule(rule, (pg,), 6)) for pg in range(512)}
    h.reweight(0, 0.5)
    after = {pg: set(h.run_rule(rule, (pg,), 6)) for pg in range(512)}
    moved = sum(len(before[pg] - after[pg]) for pg in before)
    # ideal movement ~ the share osd0 sheds (~4% of slots); allow the
    # cross-level overhead but far below a reshuffle
    assert moved < 0.10 * 512 * 6, moved
    # devices in other racks should barely move
    cross = sum(
        1
        for pg in before
        for o in before[pg] - after[pg]
        if o >= 4
    )
    assert cross <= moved


def test_zero_weight_rack_avoided():
    h = racks_hosts()
    for dev in range(4):  # all of rack0
        h.reweight(dev, 0)
    for pg in range(64):
        s = h.run_rule(ec_rule("rack"), (pg,), 3)
        # only two racks remain -> undersized (2), never rack0 devices
        assert all(o >= 4 for o in s)
        assert len(s) == 2


def test_undersized_when_domains_exhausted():
    h = racks_hosts(racks=2)
    s = h.run_rule(ec_rule("rack"), (1,), 3)
    assert len(s) == 2  # only 2 racks exist; no silent dup


def test_lrc_locality_groups():
    h = racks_hosts(racks=3, hosts=3, per_host=1)
    rule = lrc_rule(2, 3, "rack", "host")
    rack_of = {i: i // 3 for i in range(9)}
    for pg in range(64):
        s = h.run_rule(rule, (pg,), 6)
        assert len(s) == 6
        g1 = {rack_of[o] for o in s[:3]}
        g2 = {rack_of[o] for o in s[3:]}
        assert len(g1) == 1 and len(g2) == 1 and g1 != g2, (pg, s)


# -- cluster map integration -------------------------------------------
def test_osdmap_rule_pool_roundtrip():
    """Rules + locations survive the map's wire encoding and drive
    pg_to_raw; an incremental carrying them replays identically."""
    from ceph_tpu_torch.cluster.osdmap import OSDMap
    from ceph_tpu_torch.cluster.monitor import Monitor

    mon = Monitor(device="cpu")
    for i in range(6):
        mon.osd_crush_add(i, host=f"h{i}", rack=f"rack{i // 2}")
        mon.osd_in(i)
    mon.osd_crush_rule_create("spread", ec_rule("host"))
    mon.osd_erasure_code_profile_set(
        "p42", {"plugin": "isa", "k": "4", "m": "2"}
    )
    mon.osd_pool_create("hier", 8, "p42", crush_rule="spread")
    m = mon.osdmap
    acting = m.pg_to_raw("hier", 3, True)
    assert len(set(acting)) == 6  # all six hosts distinct
    # wire round trip preserves placement exactly
    m2 = OSDMap.from_bytes(m.to_bytes())
    for pg in range(8):
        assert m2.pg_to_raw("hier", pg, True) == m.pg_to_raw(
            "hier", pg, True
        )
    # incremental replay from epoch 0 reaches the same map — and the
    # incrementals survive their own wire encoding
    from ceph_tpu_torch.cluster.osdmap import Incremental

    incrs = mon.get_incrementals(0)
    replay = OSDMap()
    for incr in incrs:
        replay = replay.apply(Incremental.from_bytes(incr.to_bytes()))
    for pg in range(8):
        assert replay.pg_to_raw("hier", pg, True) == m.pg_to_raw(
            "hier", pg, True
        )


def test_monitor_failure_domain_shortcut():
    from ceph_tpu_torch.cluster.monitor import Monitor

    mon = Monitor(device="cpu")
    for i in range(6):
        mon.osd_crush_add(i, host=f"h{i}", rack=f"rack{i % 3}")
        mon.osd_in(i)
    mon.osd_erasure_code_profile_set(
        "p42", {"plugin": "isa", "k": "4", "m": "2"}
    )
    mon.osd_pool_create("fd", 8, "p42", failure_domain="host")
    spec = mon.osdmap.pools["fd"]
    assert spec.crush_rule == "ec_host"
    assert mon.osdmap.crush_rules["ec_host"] == ec_rule("host")
    host_of = {i: i for i in range(6)}
    for pg in range(8):
        s = mon.osdmap.pg_to_raw("fd", pg, True)
        assert len({host_of[o] for o in s}) == 6


def test_monitor_lrc_locality_rule():
    from ceph_tpu_torch.cluster.monitor import Monitor

    mon = Monitor(device="cpu")
    # kml k=4 m=2 l=3: 8 chunks in 2 locality groups of 4 (3 + the
    # group's local parity) -> need racks with >= 4 hosts each
    for i in range(12):
        mon.osd_crush_add(i, host=f"h{i}", rack=f"rack{i // 4}")
        mon.osd_in(i)
    mon.osd_erasure_code_profile_set(
        "lrcp",
        {
            "plugin": "lrc", "k": "4", "m": "2", "l": "3",
            "crush-locality": "rack",
        },
    )
    mon.osd_pool_create("lrc", 8, "lrcp", failure_domain="host")
    spec = mon.osdmap.pools["lrc"]
    assert spec.crush_rule == "lrc_rack_host_2x4"
    assert spec.size == 8  # k + m + (k+m)/l local parities
    rack_of = {i: i // 4 for i in range(12)}
    for pg in range(8):
        s = mon.osdmap.pg_to_raw("lrc", pg, True)
        assert len(s) == 8
        assert len({rack_of[o] for o in s[:4]}) == 1
        assert len({rack_of[o] for o in s[4:]}) == 1
        assert rack_of[s[0]] != rack_of[s[4]]


def test_cluster_survives_whole_rack_kill(rng):
    """Chaos: EC(4,2) spread two-per-rack over 3 racks; killing ALL
    of rack0 loses exactly m shards — every object stays readable
    (degraded reconstruct), the VERDICT r2 'done' criterion."""
    from ceph_tpu_torch.cluster import Monitor, OSDDaemon, RadosClient

    mon = Monitor(device="cpu")
    for i in range(6):
        mon.osd_crush_add(
            i, host=f"h{i}", rack=f"rack{i // 2}"
        )
    rule = (
        ("take", "default"),
        ("choose_firstn", 3, "rack"),
        ("chooseleaf_firstn", 2, "host"),
        ("emit",),
    )
    mon.osd_crush_rule_create("two_per_rack", rule)
    daemons = []
    for i in range(6):
        d = OSDDaemon(i, mon, chunk_size=1024, device="cpu")
        d.start()
        daemons.append(d)
    mon.osd_erasure_code_profile_set(
        "p42", {"plugin": "isa", "k": "4", "m": "2"}
    )
    mon.osd_pool_create(
        "rackpool", 8, "p42", crush_rule="two_per_rack"
    )
    client = RadosClient(mon, backoff=0.01)
    try:
        io = client.open_ioctx("rackpool")
        payloads = {}
        for i in range(6):
            data = rng.integers(
                0, 256, 4 * 1024 * 2, dtype=np.uint8
            ).tobytes()
            io.write(f"obj{i}", data)
            payloads[f"obj{i}"] = data
        # placement sanity: every PG has exactly 2 shards in rack0
        rack_of = {i: i // 2 for i in range(6)}
        for pg in range(8):
            s = mon.osdmap.pg_to_raw("rackpool", pg, True)
            assert sum(1 for o in s if rack_of[o] == 0) == 2
        # kill the whole rack
        daemons[0].stop()
        daemons[1].stop()
        mon.osd_down(0)
        mon.osd_down(1)
        for name, data in payloads.items():
            assert io.read(name) == data, f"{name} unreadable"
    finally:
        client.shutdown()
        for d in daemons:
            try:
                d.stop()
            except Exception:
                pass


# -- twins: the same map in both packages places alike -----------------

NAMES = [f"rbd_data.{i:016x}" for i in
         np.random.default_rng(0x9A7E).integers(0, 1 << 62, 2000)]


def _pkgs():
    import importlib

    return [importlib.import_module(f"{root}.cluster")
            for root in ("ceph_tpu", "ceph_tpu_torch")]


def _layout(cluster_mod, layout, device):
    """One package's monitor with 12 weighted devices under ``layout``
    and an EC(4,2) pool placed by it."""
    kw = {"device": device} if device else {}
    mon = cluster_mod.Monitor(**kw)
    weights = [1.0, 0.5, 2.0, 1.0, 1.5, 1.0, 0.75, 1.0, 1.0, 3.0, 1.0, 0.5]
    for i, w in enumerate(weights):
        if layout == "rack":
            mon.osd_crush_add(i, weight=w, host=f"h{i}", rack=f"rack{i % 3}")
        else:
            mon.osd_crush_add(i, weight=w, zone=f"z{i % 4}")
        mon.osd_in(i)
    mon.osd_erasure_code_profile_set(
        "p42", {"plugin": "isa", "k": "4", "m": "2"})
    if layout == "flat":
        mon.osd_pool_create("pool", 64, "p42")
    elif layout == "zoned":
        mon.osd_pool_create("pool", 64, "p42", distinct_zones=True)
    else:
        mon.osd_crush_rule_create("spread", ec_rule("rack"))
        mon.osd_pool_create("pool", 64, "p42", crush_rule="spread")
    return mon


@pytest.mark.parametrize("layout", ["flat", "zoned", "rack"])
def test_twin_acting_sets_equal(layout):
    ref, port = _pkgs()
    mons = [_layout(ref, layout, None), _layout(port, layout, "cpu")]
    assert mons[0].osdmap.to_bytes() == mons[1].osdmap.to_bytes()
    for name in NAMES:
        got = [(m.osdmap.object_to_pg("pool", name),
                m.osdmap.object_to_acting("pool", name)) for m in mons]
        assert got[0] == got[1], name
    # a device marked out moves the same PGs the same way
    for m in mons:
        m.osd_out(9)
    for name in NAMES[:500]:
        assert (mons[0].osdmap.object_to_acting("pool", name)
                == mons[1].osdmap.object_to_acting("pool", name)), name


def test_twin_flat_map_and_hash_equal():
    import importlib

    ref = importlib.import_module("ceph_tpu.placement")
    port = importlib.import_module("ceph_tpu_torch.placement")
    devs = [(i, 0.25 + (i * 7 % 5) / 2, f"z{i % 3}") for i in range(10)]
    maps = [mod.PGMap(mod.CrushMap([mod.Device(*d) for d in devs]), 128,
                      pool="p") for mod in (ref, port)]
    for name in NAMES:
        assert ref.stable_hash(name) == port.stable_hash(name)
        assert (maps[0].object_to_acting(name, 5, distinct_zones=True)
                == maps[1].object_to_acting(name, 5, distinct_zones=True))
