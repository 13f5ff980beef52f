"""The port's manager (balancer, pg_autoscaler, health) against
ceph_tpu's, on the CPU.

Mirrors ``tests/test_mgr.py`` on ``ceph_tpu_torch.cluster.Manager`` over
a ``Monitor(device="cpu")``, and twins it: the same map commands through
both packages' monitors give equal structured ``health()`` reports,
equal ``autoscale_status()`` rows, equal PG-shard counts and, pass by
pass, equal balancer reweights and the same ``OSDMap`` bytes after them.
"""

import importlib

import pytest

pytest.importorskip("torch")

from ceph_tpu_torch.cluster import Manager  # noqa: E402


def mkcluster(n=6, pools=(("p1", 8, 2, 1),), root="ceph_tpu_torch"):
    cl = importlib.import_module(f"{root}.cluster")
    kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    mon = cl.Monitor(**kw)
    for i in range(n):
        mon.osd_crush_add(i, zone=f"z{i % 3}")
        mon.osd_boot(i, ("127.0.0.1", 7000 + i))
    for name, pgs, k, m in pools:
        prof = f"prof_{name}"
        mon.osd_erasure_code_profile_set(
            prof, {"plugin": "isa", "k": str(k), "m": str(m)}
        )
        mon.osd_pool_create(name, pgs, prof)
    return mon


# -- mirror of tests/test_mgr.py ---------------------------------------

class TestBalancer:
    def test_balanced_cluster_is_left_alone(self):
        mon = mkcluster()
        mgr = Manager(mon)
        counts = mgr.pg_shard_counts()
        mean = sum(counts.values()) / len(counts)
        if all(
            abs(c - mean) / mean <= mgr.balance_threshold
            for c in counts.values()
        ):
            assert mgr.balance_once() == {}

    def test_skewed_weights_get_balanced(self):
        mon = mkcluster(n=6, pools=[("p1", 32, 2, 1)])
        mon.osd_reweight(0, 4.0)
        mgr = Manager(mon)
        before = mgr.pg_shard_counts()
        rounds = mgr.balance(max_rounds=30)
        after = mgr.pg_shard_counts()
        assert rounds > 0
        assert after[0] < before[0]
        spread = max(after.values()) - min(after.values())
        assert spread <= max(before.values()) - min(before.values())
        assert mon.osdmap.osds[0].weight < 4.0

    def test_weights_never_fall_below_floor(self):
        mon = mkcluster(n=3, pools=[("p1", 16, 2, 1)])
        mgr = Manager(mon, min_weight=0.25)
        for _ in range(50):
            mgr.balance_once()
        assert all(
            info.weight >= 0.25 for info in mon.osdmap.osds.values()
        )


class TestAutoscaler:
    def test_rows_shape_and_ideal_power_of_two(self):
        mon = mkcluster(n=6, pools=[("p1", 8, 2, 1), ("p2", 8, 4, 2)])
        rows = Manager(mon).autoscale_status()
        assert [r["pool"] for r in rows] == ["p1", "p2"]
        for r in rows:
            assert r["ideal_pg_num"] & (r["ideal_pg_num"] - 1) == 0

    def test_tiny_pg_num_warns(self):
        mon = mkcluster(n=6, pools=[("p1", 1, 2, 1)])
        (row,) = Manager(mon).autoscale_status()
        assert row["warn"]

    def test_sane_pg_num_quiet(self):
        mon = mkcluster(n=6, pools=[("p1", 64, 2, 1)])
        (row,) = Manager(mon).autoscale_status()
        assert not row["warn"]


class TestHealth:
    def test_healthy(self):
        mon = mkcluster(n=6, pools=[("p1", 64, 2, 1)])
        h = Manager(mon).health()
        assert h["status"] == "HEALTH_OK"
        assert h["checks"] == {}

    def test_down_osd_degrades(self):
        mon = mkcluster(n=6, pools=[("p1", 64, 2, 1)])
        mon.osd_down(5)
        h = Manager(mon).health()
        assert h["status"] == "HEALTH_WARN"
        assert "OSD_DOWN" in h["checks"]
        assert "PG_DEGRADED" in h["checks"]

    def test_below_k_is_error(self):
        mon = mkcluster(n=3, pools=[("p1", 8, 2, 1)])
        mon.osd_down(1)
        mon.osd_down(2)
        h = Manager(mon).health()
        assert h["status"] == "HEALTH_ERR"
        assert "PG_UNAVAILABLE" in h["checks"]

    def test_autoscaler_feeds_health(self):
        mon = mkcluster(n=6, pools=[("p1", 1, 2, 1)])
        h = Manager(mon).health()
        assert "POOL_PG_NUM" in h["checks"]


# -- twins: the same map commands through both packages -----------------

#: (osds, pools, map commands) — each command a Monitor method + args
TWIN_CASES = {
    "healthy": (6, [("p1", 64, 2, 1)], []),
    "down": (6, [("p1", 64, 2, 1)], [("osd_down", 5)]),
    "below_k": (3, [("p1", 8, 2, 1)], [("osd_down", 1), ("osd_down", 2)]),
    "tiny_pg_num": (6, [("p1", 1, 2, 1), ("p2", 8, 4, 2)], []),
    "out_and_down": (6, [("p1", 32, 2, 1)],
                     [("osd_out", 2), ("osd_down", 4)]),
}


@pytest.mark.parametrize("case", sorted(TWIN_CASES))
def test_health_and_autoscale_equal_the_reference(case):
    n, pools, cmds = TWIN_CASES[case]
    out = []
    for root in ("ceph_tpu", "ceph_tpu_torch"):
        mon = mkcluster(n=n, pools=pools, root=root)
        for name, *args in cmds:
            getattr(mon, name)(*args)
        mgr = importlib.import_module(f"{root}.cluster").Manager(mon)
        out.append((mgr.health(), mgr.autoscale_status(),
                    mgr.pg_shard_counts()))
    assert out[1] == out[0]


@pytest.mark.parametrize("skew", [(0, 4.0), (3, 0.25), (5, 2.5)])
def test_balancer_reweights_equal_the_reference(skew):
    """Pass by pass, the same reweights from the same skewed map, and
    equal map bytes after every pass."""
    osd, weight = skew
    passes = []
    for root in ("ceph_tpu", "ceph_tpu_torch"):
        mon = mkcluster(n=6, pools=[("p1", 32, 2, 1), ("p2", 16, 4, 2)],
                        root=root)
        mon.osd_reweight(osd, weight)
        mgr = importlib.import_module(f"{root}.cluster").Manager(mon)
        run = []
        for _ in range(30):
            changed = mgr.balance_once()
            run.append((changed, mgr.pg_shard_counts(),
                        mon.osdmap.to_bytes()))
            if not changed:
                break
        passes.append(run)
    assert passes[1] == passes[0]
    assert len(passes[1]) > 1  # the skew gave the balancer work

