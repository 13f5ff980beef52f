"""A shard that misses RMW writes while it is down, then is recovered
from the log and deep-scrubbed: the port's HashInfo attrs and scrub
result against ceph_tpu's, on the CPU (tolerance 0).

Both packages run the same seeded ops on ``test_torch_rmw``'s twin
stacks (``pglog=True``). Shard 2 goes down, misses a partial overwrite,
an append, or both, comes back, and ``recover_from_log`` rebuilds it.
Every shard's attrs — the ``hinfo_key`` HashInfo among them — and the
deep-scrub errors (with the recorded HashInfo and with the one each
shard holds) must agree between the packages.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_rmw import (  # noqa: E402,F401
    _clean_inject, PAGE, Twin, override, payload,
)

K = 4
DOWN = 2


def _hinfo_attrs(st, oid):
    """{shard: parsed hinfo_key attr or None} of one stack."""
    key = st.pkg.rmw.HINFO_KEY
    out = {}
    for shard, store in sorted(st.backend.stores.items()):
        raw = store.getattrs(oid).get(key) if store.exists(oid) else None
        out[shard] = None if raw is None else json.loads(raw)
    return out


def _scrub_with_each_shards_hinfo(st, oid):
    """be_deep_scrub once per distinct hinfo attr the shards hold."""
    HashInfo = st.pkg.HashInfo
    seen, res = set(), []
    key = st.pkg.rmw.HINFO_KEY
    for shard, store in sorted(st.backend.stores.items()):
        raw = store.getattrs(oid).get(key)
        if raw is None or raw in seen:
            continue
        seen.add(raw)
        res.append((shard, st.scrub(oid, HashInfo.from_bytes(raw, **st.pkg.kw))))
    return res


@pytest.mark.parametrize("missed", ["overwrite", "append", "both"])
def test_shard_down_for_writes_then_recovered(rng, missed):
    tw = Twin(pglog=True)
    base = payload(rng, 3 * K * PAGE)
    tw.submit("obj", 0, base)
    for st in tw.stacks:
        st.backend.down_shards.add(DOWN)
    if missed in ("overwrite", "both"):
        tw.submit("obj", PAGE + 100, payload(rng, PAGE))
    if missed in ("append", "both"):
        tw.submit("obj", len(base), payload(rng, 2 * K * PAGE))
    down_attrs = tw.same(lambda st: _hinfo_attrs(st, "obj"))
    for st in tw.stacks:
        st.backend.down_shards.clear()
    res = tw.do(lambda st: {
        oid: (op.recovered_bytes, op.read_bytes)
        for oid, op in st.rec.recover_from_log(st.pglog, DOWN).items()})
    assert res[0] == res[1]
    tw.do(lambda st: st.rmw.on_shard_recovered(DOWN))
    after = tw.same(lambda st: _hinfo_attrs(st, "obj"))
    tw.assert_stores_equal()
    # the recorded scrub (the pipeline's HashInfo) and one scrub per
    # distinct attr the shards hold agree between the packages
    assert tw.same(lambda st: st.scrub("obj")) == []
    tw.same(lambda st: _scrub_with_each_shards_hinfo(st, "obj"))
    # what the recovered shard's attr is, in both packages: the attr the
    # other shards hold after the missed writes (the rebuilt shard takes
    # its attrs from a survivor)
    others = {after[s] and json.dumps(after[s], sort_keys=True)
              for s in after if s != DOWN}
    assert len(others) == 1
    assert json.dumps(after[DOWN], sort_keys=True) in others
    assert down_attrs[DOWN] != after[DOWN] or missed == "overwrite"


def _cluster_case(root: str, overwrite: bool) -> dict:
    """One package's cluster (mon + 6 OSDs, EC(3,2) over MemStores): a
    member misses a write while marked down, returns and catches up
    from the primary's log; then every member's hinfo attr of the
    object and a deep scrub of every PG."""
    import importlib
    import time

    cl = importlib.import_module(f"{root}.cluster")
    kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    hinfo_key = importlib.import_module(f"{root}.pipeline.rmw").HINFO_KEY
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
    client = cl.RadosClient(mon, backoff=0.01)
    try:
        io = client.open_ioctx("ecpool")
        rng = np.random.default_rng(11)
        data = rng.integers(0, 256, 9000, np.uint8).tobytes()
        io.write("obj", data)
        acting = mon.osdmap.object_to_acting("ecpool", "obj")
        victim = acting[1]
        mon.osd_down(victim)  # down, not stopped: its store stays stale
        patch = rng.integers(0, 256, 700, np.uint8).tobytes()
        if overwrite:
            io.write("obj", patch, 1500)
            data = data[:1500] + patch + data[2200:]
        else:
            io.append("obj", patch)
            data = data + patch
        mon.osd_boot(victim, daemons[victim].addr)

        def attrs():
            out = {}
            for osd in acting:
                st = daemons[osd].store
                names = [o for o in st.list_objects() if "obj" in o]
                out[osd] = [st.getattrs(o).get(hinfo_key) for o in names]
            return out

        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            got = attrs()
            if len({tuple(v) for v in got.values()}) == 1:
                break
            time.sleep(0.05)
        assert io.read("obj") == data
        scrub = sorted(
            (r.oid, r.ok, [(e.shard, e.kind) for e in r.errors])
            for d in daemons for res in d.scrub_all().values() for r in res
        )
        return {"victim_pos": acting.index(victim), "attrs": {
            acting.index(osd): v for osd, v in attrs().items()},
            "scrub": scrub}
    finally:
        client.shutdown()
        for d in daemons:
            d.stop()


@pytest.mark.parametrize("overwrite", [True, False],
                         ids=["overwrite", "append"])
def test_cluster_member_catch_up_hinfo_equals_the_reference(overwrite):
    """The same through the cluster tier's log catch-up: the returned
    member's hinfo attr, every other member's, and the deep-scrub
    results are equal between the packages, and the returned member
    holds the attr its peers hold."""
    from test_torch_dcn import time_limit

    with time_limit(150):
        ref = _cluster_case("ceph_tpu", overwrite)
        port = _cluster_case("ceph_tpu_torch", overwrite)
    assert port == ref
    assert len({tuple(v) for v in port["attrs"].values()}) == 1
    assert all(ok for _oid, ok, _e in port["scrub"])
