"""A primary change in the port's cluster against ceph_tpu's, on the CPU
(tolerance 0).

Both packages boot the same ``LoadCluster`` (mon + 6 OSDs over
MemStores, ISA EC(4,2), 8 PGs; the port on ``device="cpu"``) and run the
same seeded ops serially. The primary of the PG that holds the most
objects is stopped and marked down; once the new primary serves, every
object of that PG is overwritten, appended to and truncated through it.
The old primary is revived over its store and the cluster recovers.

Then, per OSD: every shard's bytes and attrs (OI and HINFO included;
only the reqid window ``rq``, which carries a client nonce, is left
out) and every PG's log entries (tid, oid, epoch, extents, delete,
xattrs) are equal, and so are every read and a deep scrub of every PG.
Every read, while the old primary is down and after it recovered, also
equals a byte model of the ops applied, so a write lost in both packages
alike fails the test.
The OI attr's eversion and the log's tids are where the takeover's tids
show: a new primary starts its op counter afresh in both packages.
"""

import importlib
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_cluster_e2e import (  # noqa: E402
    TWIN_SKIP_ATTRS, _object_stores, _twin_ops,
)
from test_torch_dcn import time_limit  # noqa: E402

OIDS = [f"o{i}" for i in range(6)]


def _boot(root):
    lg = importlib.import_module(f"{root}.loadgen")
    kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    return lg.LoadCluster(n_osds=6, k=4, m=2, pg_num=8, chunk_size=1024,
                          plugin="isa", pool="pool", **kw)


def _apply(io, ops):
    for name, *args in ops:
        if name == "write":
            oid, off, data = args
            io.write(oid, data, offset=off)
        else:
            getattr(io, name)(*args)


def _takeover_ops(seed, oids):
    """Overwrite, append to and truncate every object of the PG."""
    rng = np.random.default_rng(seed + 100)
    ops = []
    for oid in oids:
        ops.append(("write", oid, int(rng.integers(0, 6000)), rng.integers(
            0, 256, int(rng.integers(1, 3000)), dtype=np.uint8).tobytes()))
        ops.append(("append", oid, rng.integers(
            0, 256, int(rng.integers(1, 4000)), dtype=np.uint8).tobytes()))
        ops.append(("truncate", oid, int(rng.integers(1000, 9000))))
    return ops


def _model_reads(ops):
    """The (bytes, size) a read of each object returns after ``ops``,
    from a byte model of them (None for an absent object)."""
    objs: dict[str, bytearray | None] = {}
    for name, oid, *args in ops:
        cur = objs.get(oid)
        if name == "write_full":
            objs[oid] = bytearray(args[0])
        elif name == "remove":
            objs[oid] = None
        elif name in ("write", "append", "truncate"):
            cur = bytearray() if cur is None else cur
            if name == "truncate":
                size = args[0]
                cur = cur[:size] + bytes(max(size - len(cur), 0))
            else:
                off, data = (len(cur), args[0]) if name == "append" else args
                cur = cur + bytes(max(off - len(cur), 0))
                cur[off:off + len(data)] = data
            objs[oid] = cur
    return {oid: None if objs.get(oid) is None
            else (bytes(objs[oid]), len(objs[oid])) for oid in OIDS}


def _pg_logs(c):
    """Every daemon's PG logs, entry by entry."""
    out = {}
    for osd, d in sorted(c.daemons.items()):
        for (pool, pgid), pg in sorted(d._pgs.items()):
            out[(osd, pool, pgid)] = [
                (e.tid, e.oid, e.epoch, e.delete,
                 {s: list(es) for s, es in sorted(e.shard_extents.items())},
                 e.xattrs and {a: v for a, v in e.xattrs.items()
                               if a not in TWIN_SKIP_ATTRS})
                for e in pg.pglog.entries
            ]
    return out


def _reads(c):
    out = {}
    for oid in OIDS:
        try:
            out[oid] = (c.io.read(oid), c.io.stat(oid))
        except FileNotFoundError:
            out[oid] = None
    return out


def _scrub(c):
    return sorted(
        (osd, r.oid, r.ok, [(e.shard, e.kind) for e in r.errors])
        for osd, d in sorted(c.daemons.items())
        for res in d.scrub_all().values() for r in res
    )


def _takeover_case(root, seed):
    c = _boot(root)
    try:
        ops = _twin_ops(seed)
        _apply(c.io, ops)
        osdmap = c.mon.osdmap
        by_pg = {}
        for oid in OIDS:
            by_pg.setdefault(osdmap.object_to_pg("pool", oid), []).append(oid)
        pgid, oids = max(sorted(by_pg.items()), key=lambda kv: len(kv[1]))
        victim = osdmap.pg_primary("pool", pgid)
        c.kill(victim)
        deadline = time.monotonic() + 30
        while True:
            primary = c.mon.osdmap.pg_primary("pool", pgid)
            pg = c.daemons[primary]._pgs.get(("pool", pgid))
            if primary != victim and pg is not None and pg.peered.is_set():
                break
            assert time.monotonic() < deadline, "no new primary"
            time.sleep(0.05)
        more = _takeover_ops(seed, oids)
        _apply(c.io, more)
        during = _reads(c)
        c.revive(victim)
        assert c.wait_recovered(60), "revive never converged"
        live = SimpleNamespace(daemons=[c.daemons[i] for i in sorted(c.daemons)])
        return {
            "victim": victim, "new_primary": primary, "pg": pgid,
            "oids": oids, "model": _model_reads(ops + more), "during": during,
            "reads": _reads(c),
            "stores": _object_stores(live), "logs": _pg_logs(c),
            "scrub": _scrub(c),
        }
    finally:
        c.shutdown()


@pytest.mark.parametrize("seed", [1, 2])
def test_takeover_twin_equal_bytes_attrs_logs_reads_scrub(seed):
    with time_limit(150):
        ref = _takeover_case("ceph_tpu", seed)
        port = _takeover_case("ceph_tpu_torch", seed)
    for key in ("victim", "new_primary", "pg", "oids"):
        assert port[key] == ref[key], key
    # no write lost and no wrong read, in either package: through the
    # new primary, and after the old one came back and recovered
    for case in (ref, port):
        assert case["during"] == case["model"]
        assert case["reads"] == case["during"]
    assert port["during"] == ref["during"]
    assert port["reads"] == ref["reads"]
    assert port["stores"] == ref["stores"]
    assert port["logs"] == ref["logs"]
    assert port["scrub"] == ref["scrub"]
    assert all(ok for _osd, _oid, ok, _e in port["scrub"])
    # the new primary's log of the PG holds the takeover's writes, its
    # tids counted from 1 (the op counter of a fresh primary)
    new_log = port["logs"][(port["new_primary"], "pool", port["pg"])]
    assert new_log and new_log[0][0] == 1
    assert {e[1].split(":", 1)[1] for e in new_log} == set(port["oids"])
