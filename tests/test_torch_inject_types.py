"""The port's ECInject write types 2/3 and read type 2 against
ceph_tpu's, on the CPU (tolerance 0).

Mirrors ``tests/test_inject_types.py``. The registry cases run one
script through both packages' ``ECInject`` and compare every answer.
The pipeline cases run on ``test_torch_rmw``'s twin stacks (jerasure
EC(4,2), one 4 KiB page a chunk, a ``PGLog``): a type-3 abort parks the
op until the shard is recovered, type 2 fires the primary's down hook on
the final commit, a type-1 drop arms type 2, and read type 2 flips a
sub-read's payload silently; every commit, hook call, down shard, read
and store is compared between the packages. The daemon-tier cases run
the reference's cluster cases on the port with ``device="cpu"`` (a
replica that aborts, a primary that marks itself down) and compare the
outcome with the reference's; the live integrity loop (BlockStore bit
rot, EIO re-plan, deep-scrub repair; a lying shard caught by deep
scrub) runs on the port's ``LoadCluster``. The silent read-path case is
a case of ``test_torch_inject.py::test_read_inject``.
"""

import importlib
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_dcn import time_limit  # noqa: E402
from test_torch_rmw import (  # noqa: E402,F401
    _clean_inject, PAGE, PORT, REF, Twin, outcome, payload,
)

K, M = 4, 2


# -- the registry ----------------------------------------------------------

def _type3_duration(inj):
    return [inj.write_error("o", 3, duration=2),
            inj.write_error("o", 3, duration=1)[:2]]


def _unknown_types(inj):
    return [inj.write_error("o", 4), inj.read_error("o", 3)]


def _object_wide(inj):
    inj.write_error("o", 3, shard=5)
    return [inj.test_write_error3("o")]


def _normalized_keys(inj):
    inj.write_error("0:obj", 2)
    out = [inj.test_write_error2("0:obj#s3")]
    inj.write_error("0:obj#s1", 3)
    return out + [inj.test_write_error3("0:obj")]


def _type1_arms_base(inj):
    inj.write_error("0:obj#s2", 1, shard=2)
    return [inj.test_write_error1("0:obj#s2", 2), inj.test_write_error2("0:obj")]


REGISTRY_CASES = {
    "type3_requires_duration_one": (
        _type3_duration, ["duration must be 1", "ok"]),
    "unknown_type_rejected": (
        _unknown_types, ["unrecognized error inject type"] * 2),
    "types_2_3_are_object_wide": (_object_wide, [True]),
    "types_2_3_normalize_shard_keys": (_normalized_keys, [True, True]),
    "type1_arm_normalizes_to_base_object": (_type1_arms_base, [True, True]),
}


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_answers_equal_the_reference(case):
    script, want = REGISTRY_CASES[case]
    got = [script(pkg.inject.ECInject()) for pkg in (REF, PORT)]
    assert got[1] == got[0] == want


# -- the pipeline tier -------------------------------------------------------

def _hooked(tw):
    """Each stack's type-2 hook calls, as a list per stack."""
    fired = ([], [])
    for st, f in zip(tw.stacks, fired):
        st.rmw.on_osd_down_inject = lambda f=f: f.append(True)
    return fired


def test_type3_aborts_receiving_shard(rng):
    tw = Twin(pglog=True)
    data = payload(rng, K * PAGE)
    tw.submit("obj", 0, data)
    tw.do(lambda st: st.pkg.inject.ec_inject.write_error("obj", 3))
    logs = tw.submit("obj", 0, data)
    assert logs == ([], [])
    down = tw.same(lambda st: sorted(st.backend.down_shards))
    assert len(down) == 1
    assert tw.same(lambda st: st.pkg.inject.ec_inject.injected_count) == 1
    tw.do(lambda st: st.backend.down_shards.clear())
    tw.same(lambda st: sorted(st.rec.recover_from_log(st.pglog, down[0])))
    tw.do(lambda st: st.rmw.on_shard_recovered(down[0]))
    assert logs[0] == logs[1] and [e[0] for e in logs[1]] == [2]
    tw.assert_stores_equal()


def test_type2_fires_on_final_commit(rng):
    tw = Twin()
    fired = _hooked(tw)
    tw.do(lambda st: st.pkg.inject.ec_inject.write_error("obj", 2))
    data = payload(rng, K * PAGE)
    logs = tw.submit("obj", 0, data)
    assert logs[0] == logs[1] and [e[0] for e in logs[1]] == [1]
    assert fired == ([True], [True])
    tw.submit("obj", 0, data)
    assert fired == ([True], [True])  # one-shot
    tw.assert_stores_equal()


def test_type1_fire_arms_type2(rng):
    tw = Twin(pglog=True)
    fired = _hooked(tw)
    data = payload(rng, K * PAGE)
    tw.submit("obj", 0, data)
    tw.do(lambda st: st.pkg.inject.ec_inject.write_error(
        "obj", 1, duration=1, shard=2))
    logs = tw.submit("obj", 0, data)
    assert logs == ([], []) and fired == ([], [])
    tw.same(lambda st: sorted(st.rec.recover_from_log(st.pglog, 2)))
    tw.do(lambda st: st.rmw.on_shard_recovered(2))
    assert logs[0] == logs[1] and [e[0] for e in logs[1]] == [2]
    assert fired == ([True], [True])
    tw.assert_stores_equal()


def test_read_type2_flips_returned_payload_silently(rng):
    tw = Twin()
    data = payload(rng, 2 * K * PAGE)
    logs = tw.submit("obj", 0, data)
    assert logs[0] == logs[1] and logs[1][0][1] is None

    def shard0(st):
        return st.backend.read_shard(0, "obj", st.pkg.ExtentSet([(0, PAGE)]))

    clean = tw.same(shard0)
    tw.do(lambda st: st.pkg.inject.ec_inject.read_error("obj", 2, shard=0))
    bad = tw.same(shard0)
    assert bad[0] != clean[0] and bad[0][0] == clean[0][0] ^ 0xFF
    assert tw.same(shard0) == clean  # duration 1: consumed


# -- the daemon tier ---------------------------------------------------------

def _daemon_cluster(root):
    cl = importlib.import_module(f"{root}.cluster")
    kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    mon = cl.Monitor(**kw)
    daemons = []
    for i in range(6):
        mon.osd_crush_add(i, zone=f"z{i % 3}")
    for i in range(6):
        d = cl.OSDDaemon(i, mon, chunk_size=1024, **kw)
        d.start()
        daemons.append(d)
    mon.osd_erasure_code_profile_set(
        "rs32", {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "3", "m": "2"})
    mon.osd_pool_create("ecpool", 8, "rs32")
    # a 5 s client op timeout (30 s by default): the write whose reply
    # died with the aborted replica is resent sooner, in both packages
    return mon, daemons, cl.RadosClient(mon, backoff=0.01, op_timeout=5.0)


def _data(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _type3_case(root):
    """A replica aborts on a sub-write; once marked down, the write
    lands degraded and reads back."""
    inject = importlib.import_module(f"{root}.pipeline.inject").ec_inject
    make_loc = importlib.import_module(f"{root}.cluster.osd_daemon").make_loc
    mon, daemons, client = _daemon_cluster(root)
    try:
        io = client.open_ioctx("ecpool")
        inject.write_error(make_loc(mon.osdmap.pools["ecpool"].pool_id,
                                    "obj"), 3)
        data = _data(5_000)
        comp = io.aio_write("obj", data)
        end = time.monotonic() + 10
        victim = None
        while victim is None and time.monotonic() < end:
            victim = next((d.osd_id for d in daemons if d._stopped), None)
            time.sleep(0.01)
        assert victim is not None, "no daemon aborted"
        mon.osd_down(victim)
        try:
            comp.wait_for_complete(timeout=30)
        except IOError:
            io.write("obj", data)
        acting = mon.osdmap.object_to_acting("ecpool", "obj")
        return {"read": io.read("obj") == data,
                "injected": inject.injected_count >= 1,
                "victim_is_replica": victim in acting[1:] or victim not in acting}
    finally:
        client.shutdown()
        for d in daemons:
            d.stop()
        inject.clear_all()


def _type2_case(root):
    """The primary commits the write, then marks itself down; reads go
    through the failover primary."""
    inject = importlib.import_module(f"{root}.pipeline.inject").ec_inject
    make_loc = importlib.import_module(f"{root}.cluster.osd_daemon").make_loc
    mon, daemons, client = _daemon_cluster(root)
    try:
        io = client.open_ioctx("ecpool")
        primary = mon.osdmap.primary("ecpool", "obj")
        inject.write_error(make_loc(mon.osdmap.pools["ecpool"].pool_id,
                                    "obj"), 2)
        data = _data(4_000)
        io.write("obj", data)
        end = time.monotonic() + 10
        while mon.osdmap.is_up(primary) and time.monotonic() < end:
            time.sleep(0.02)
        return {"primary": primary, "down": not mon.osdmap.is_up(primary),
                "alive": not daemons[primary]._stopped,
                "read": io.read("obj") == data}
    finally:
        client.shutdown()
        for d in daemons:
            d.stop()
        inject.clear_all()


@pytest.mark.parametrize("case", [_type3_case, _type2_case],
                         ids=["type3_kills_replica", "type2_primary_down"])
def test_daemon_tier_outcome_equals_the_reference(case):
    with time_limit(120):
        ref, port = case("ceph_tpu"), case("ceph_tpu_torch")
    assert port == ref
    assert all(v for k, v in port.items() if k != "primary")


# -- the live integrity loop -------------------------------------------------

def test_bit_rot_to_repair_loop(tmp_path):
    from ceph_tpu_torch.cluster.osd_daemon import make_loc, shard_key
    from ceph_tpu_torch.loadgen import LoadCluster
    from ceph_tpu_torch.store import BlockStore
    from ceph_tpu_torch.utils import config

    with time_limit(90):
        cluster = LoadCluster(
            n_osds=5, k=2, m=1, pg_num=4, chunk_size=4096,
            tick_period=0.1, device="cpu",
            store_factory=lambda i: BlockStore(
                str(tmp_path / f"osd{i}"), size=1 << 22),
        )
        try:
            io = cluster.io
            data = _data(3 * 2 * 4096, seed=9)
            assert io.write_full("rot", data) == len(data)
            assert io.read("rot") == data
            acting = cluster.mon.osdmap.object_to_acting(cluster.pool, "rot")
            store = cluster.stores[acting[0]]
            key = shard_key(make_loc(
                cluster.mon.osdmap.pools[cluster.pool].pool_id, "rot"), 0)
            blob = next(iter(store._objects[key].blobs.values()))
            with open(os.path.join(store.root, "block"), "r+b") as f:
                f.seek(blob.offset + 17)
                byte = f.read(1)
                f.seek(blob.offset + 17)
                f.write(bytes([byte[0] ^ 0xFF]))
            assert io.read("rot") == data
            pgid = cluster.mon.osdmap.object_to_pg(cluster.pool, "rot")
            d = cluster.daemons[cluster.mon.osdmap.pg_primary(cluster.pool, pgid)]
            with config.override(osd_scrub_auto_repair=True):
                d._run_scheduled_scrub(cluster.pool, pgid, "deep")
            _stamp, kind, n_err, repaired = d.scrub_history[(cluster.pool, pgid)]
            assert kind == "deep" and n_err > 0 and repaired
            assert io.read("rot") == data
            (res,) = [r for r in d.scrub_pg(cluster.pool, pgid)
                      if r.oid == key.rsplit("#s", 1)[0]]
            assert res.ok
        finally:
            cluster.shutdown()


def test_type2_read_corruption_caught_by_deep_scrub():
    from ceph_tpu_torch.cluster.osd_daemon import make_loc, shard_key
    from ceph_tpu_torch.loadgen import LoadCluster
    from ceph_tpu_torch.pipeline.inject import ec_inject

    with time_limit(90):
        cluster = LoadCluster(n_osds=5, k=2, m=1, pg_num=4, chunk_size=4096,
                              tick_period=0.1, device="cpu")
        try:
            io = cluster.io
            data = _data(2 * 2 * 4096, seed=11)
            assert io.write_full("liar", data) == len(data)
            loc = make_loc(cluster.mon.osdmap.pools[cluster.pool].pool_id,
                           "liar")
            ec_inject.read_error(shard_key(loc, 1), 2, duration=1_000_000)
            assert io.read("liar") != data
            pgid = cluster.mon.osdmap.object_to_pg(cluster.pool, "liar")
            d = cluster.daemons[cluster.mon.osdmap.pg_primary(cluster.pool, pgid)]
            results = [r for r in d.scrub_pg(cluster.pool, pgid) if r.oid == loc]
            assert results and not results[0].ok
            assert {e.shard for e in results[0].errors} == {1}
            ec_inject.clear_read_error(shard_key(loc, 1), 2)
            d.scrub_pg(cluster.pool, pgid, repair=True)
            assert io.read("liar") == data
            (res2,) = [r for r in d.scrub_pg(cluster.pool, pgid) if r.oid == loc]
            assert res2.ok
        finally:
            cluster.shutdown()
