"""The port's cluster thrashing against ceph_tpu's, on the CPU.

Mirrors ``tests/test_cluster_chaos.py`` (the thrash-erasure-code tier
over a live mini-cluster) on ``ceph_tpu_torch`` with ``device="cpu"``:
random OSD deaths and revivals under client IO with a byte model of
every object; the same with divergent residue tampered into a down
member's store (garbage under bumped eversions) that its catch-up must
roll back; and append logs under primary kills that must hold every
record exactly once.

Each case runs its seeded harness over both packages, each against its
own model. Where the ops end in a settled, scrubbed cluster (every
case), the two runs' final stores are equal: every object's shard at
each acting position, in bytes, HINFO and the object size in its OI
(the eversion's epoch and tid follow which daemon served each op;
shards a layout change left at other positions are collected on their
own schedule, so they stay out). The tampering run also counts the same
tampered shards in both. Every case runs under a time limit of its own.

Every daemon's scrub clocks are stamped at boot, as Ceph stamps a PG
when its pool is created: an unstamped PG is deep-scrubbed by the
daemon's scheduler one tick after boot, and such a scrub of a PG whose
member is killed under it waits out the daemon's 15 s op timeout for
that member's HINFO vote, in either package. The cases scrub
explicitly, as the reference's do. A scrub right after a revive can
still send a vote over a peer's link to the revived OSD's old socket
and wait out the op timeout (in either package, about one run in two
for seed 20260730), so the daemons here time out after ``OP_TIMEOUT``
(3 s) instead: a vote that does not come abstains, as after 15 s.
"""

import importlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_dcn import time_limit  # noqa: E402

K, M = 3, 2
N_OSD = 6


def _cl(root):
    return importlib.import_module(f"{root}.cluster")


def _kw(root):
    return {"device": "cpu"} if root == "ceph_tpu_torch" else {}


PG_NUM = 4


#: the daemons' op timeout (15 s by default): how long a primary waits
#: on a peer that never answers before it goes on without it
OP_TIMEOUT = 3.0


def _daemon(root, osd, mon, store=None):
    """An OSD daemon, its scrub clocks stamped, started."""
    d = _cl(root).OSDDaemon(osd, mon, store=store, chunk_size=1024,
                            tick_period=0.2, op_timeout=OP_TIMEOUT,
                            **_kw(root))
    now = time.monotonic()
    d._scrub_stamps.update({("ecpool", p): [now, now]
                            for p in range(PG_NUM)})
    d.start()
    return d


def _boot(root, profile, plugin_kw, backoff=0.02, **client_kw):
    cl = _cl(root)
    mon = cl.Monitor(**_kw(root))
    daemons, stores = {}, {}
    for i in range(N_OSD):
        mon.osd_crush_add(i)
    for i in range(N_OSD):
        d = _daemon(root, i, mon)
        daemons[i] = d
        stores[i] = d.store
    mon.osd_erasure_code_profile_set(profile, plugin_kw)
    mon.osd_pool_create("ecpool", PG_NUM, profile)
    client = cl.RadosClient(mon, backoff=backoff, **client_kw)
    return mon, daemons, stores, client


def _shutdown(daemons, client):
    client.shutdown()
    for d in daemons.values():
        if not d._stopped:
            d.stop()


def _final_stores(root, mon, daemons, oids):
    """Each object's shard at each acting position: its OSD, bytes,
    HINFO and OI size."""
    rmw = importlib.import_module(f"{root}.pipeline.rmw")
    pool_id = mon.osdmap.pools["ecpool"].pool_id
    out = {}
    for oid in sorted(oids):
        for pos, osd in enumerate(mon.osdmap.object_to_acting("ecpool", oid)):
            st = daemons[osd].store
            key = f"{pool_id}:{oid}#s{pos}"
            attrs = st.getattrs(key)
            out[(oid, pos)] = (osd, st.read(key), attrs.get(rmw.HINFO_KEY),
                               rmw.parse_oi(attrs[rmw.OI_KEY])[0])
    return out


def _assert_scrub_clean(daemons):
    for d in daemons.values():
        for (pool, pgid), results in d.scrub_all().items():
            for r in results:
                assert r.ok, f"{r.oid}: {r.errors}"


JERASURE = {"plugin": "jerasure", "technique": "reed_sol_van",
            "k": str(K), "m": str(M)}


def _thrash(root, seed):
    """``test_thrash_kill_revive_under_io`` over ``root``'s cluster;
    returns the model and the final stores."""
    rng = np.random.default_rng(seed)
    mon, daemons, stores, client = _boot(root, "rs32", JERASURE)
    io = client.open_ioctx("ecpool")
    model: dict[str, bytes] = {}
    dead: list[int] = []
    obj_seq = 0

    def do_io(n_ops: int) -> None:
        nonlocal obj_seq
        for _ in range(n_ops):
            op = rng.choice(["write", "overwrite", "read", "remove"])
            if op == "write" or not model:
                oid = f"obj{obj_seq}"
                obj_seq += 1
                blob = rng.integers(
                    0, 256, int(rng.integers(500, 8_000)), dtype=np.uint8
                ).tobytes()
                io.write(oid, blob)
                model[oid] = blob
            elif op == "overwrite":
                oid = sorted(model)[int(rng.integers(0, len(model)))]
                cur = bytearray(model[oid])
                off = int(rng.integers(0, len(cur)))
                ln = int(rng.integers(1, 2_000))
                patch = rng.integers(0, 256, ln, dtype=np.uint8).tobytes()
                io.write(oid, patch, offset=off)
                if len(cur) < off + ln:
                    cur.extend(b"\0" * (off + ln - len(cur)))
                cur[off:off + ln] = patch
                model[oid] = bytes(cur)
            elif op == "read":
                oid = sorted(model)[int(rng.integers(0, len(model)))]
                assert io.read(oid) == model[oid], f"stale read of {oid}"
            else:
                oid = sorted(model)[int(rng.integers(0, len(model)))]
                io.remove(oid)
                del model[oid]

    def kill(osd: int) -> None:
        daemons[osd].stop()
        mon.osd_down(osd)
        dead.append(osd)

    def revive(osd: int) -> None:
        daemons[osd] = _daemon(root, osd, mon, stores[osd])
        dead.remove(osd)

    def scrub_repair_everywhere() -> None:
        for _ in range(2):
            for d in list(daemons.values()):
                if d.osd_id not in dead:
                    d.scrub_all(repair=True)

    try:
        do_io(10)
        for _round in range(4):
            kills = int(rng.integers(1, M + 1))
            for _ in range(kills):
                if N_OSD - len(dead) - 1 < K:
                    break
                candidates = [i for i in range(N_OSD) if i not in dead]
                kill(int(rng.choice(candidates)))
            do_io(8)
            while dead:
                revive(dead[0])
            scrub_repair_everywhere()
            do_io(5)
        for oid, blob in sorted(model.items()):
            assert io.read(oid) == blob
        _assert_scrub_clean(daemons)
        return model, _final_stores(root, mon, daemons, model)
    finally:
        _shutdown(daemons, client)


@pytest.mark.parametrize("seed", [1234, 20260730])
def test_thrash_kill_revive_under_io(seed):
    """Kill 1-2 OSDs a round under IO, revive over their stores, scrub
    with repair; every object bit-exact and scrub clean at the end, in
    both packages, with equal final stores."""
    with time_limit(150):
        ref = _thrash("ceph_tpu", seed)
        port = _thrash("ceph_tpu_torch", seed)
    assert port[0] == ref[0]
    assert port[1] == ref[1]


def _tamper_run(root, seed):
    """``test_thrash_with_divergent_tampering`` over ``root``'s
    cluster; returns the model, the tampered shard count and the final
    stores."""
    rng = np.random.default_rng(seed)
    rmw = importlib.import_module(f"{root}.pipeline.rmw")
    store_mod = importlib.import_module(f"{root}.store")
    mon, daemons, stores, client = _boot(
        root, "rs32d", {"plugin": "isa", "k": str(K), "m": str(M)})
    io = client.open_ioctx("ecpool")
    model: dict[str, bytes] = {}

    def tamper(store) -> int:
        n = 0
        for key in store.list_objects():
            if "#s" not in key or rng.random() > 0.6:
                continue
            size = store.stat(key)
            if not size:
                continue
            try:
                osize, ev = rmw.parse_oi(store.getattr(key, rmw.OI_KEY))
            except (FileNotFoundError, KeyError, ValueError):
                continue
            store.queue_transactions(
                store_mod.Transaction()
                .write(key, 0, bytes([0x99]) * min(size, 512))
                .setattr(key, rmw.OI_KEY,
                         rmw.pack_oi(osize, (ev[0], ev[1] + 500)))
            )
            n += 1
        return n

    try:
        for i in range(8):
            blob = rng.integers(0, 256, 4_000 + 137 * i, np.uint8).tobytes()
            io.write(f"o{i}", blob)
            model[f"o{i}"] = blob
        total_tampered = 0
        for round_no in range(3):
            live = [i for i in daemons if daemons[i] is not None]
            victim = int(rng.choice(live))
            mon.osd_down(victim)
            total_tampered += tamper(stores[victim])
            for i in range(4):
                oid = f"r{round_no}_{i}"
                blob = rng.integers(0, 256, 3_000, np.uint8).tobytes()
                io.write(oid, blob)
                model[oid] = blob
            mon.osd_boot(victim, daemons[victim].addr)
            deadline = time.monotonic() + 20
            while True:
                try:
                    for oid, blob in sorted(model.items()):
                        assert io.read(oid) == blob
                    break
                except AssertionError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.1)
        assert total_tampered > 0, (
            "tampering never happened: the test degraded to plain thrash"
        )
        for d in daemons.values():
            d.scrub_all(repair=True)
        for oid, blob in sorted(model.items()):
            assert io.read(oid) == blob
        _assert_scrub_clean(daemons)
        return model, total_tampered, _final_stores(root, mon, daemons,
                                                    model)
    finally:
        _shutdown(daemons, client)


@pytest.mark.parametrize("seed", [7702])
def test_thrash_with_divergent_tampering(seed):
    """A member marked down (its daemon running) gets garbage under
    bumped eversion stamps; IO continues degraded; on its return the
    catch-up rolls the residue back. The model stays bit-exact and the
    final scrub is clean in both packages, which tamper the same shards
    and end with equal stores."""
    with time_limit(120):
        ref = _tamper_run("ceph_tpu", seed)
        port = _tamper_run("ceph_tpu_torch", seed)
    assert port[0] == ref[0]
    assert port[1] == ref[1] > 0
    assert port[2] == ref[2]


def _append_logs(root, seed):
    """``test_append_log_thrash_exactly_once`` over ``root``'s cluster;
    returns every log's records and the final stores."""
    rng = np.random.default_rng(seed)
    mon, daemons, _stores, client = _boot(
        root, "rs32", JERASURE, backoff=0.05, max_attempts=24)
    io = client.open_ioctx("ecpool")
    logs = [f"log{i}" for i in range(4)]
    records: dict[str, list[bytes]] = {o: [] for o in logs}
    dead: list[int] = []

    def append_burst(n: int) -> None:
        for _ in range(n):
            oid = logs[int(rng.integers(0, len(logs)))]
            marker = len(records[oid]) & 0xFF
            body = rng.integers(
                0, 256, int(rng.integers(100, 1200)), np.uint8
            ).tobytes()
            rec = bytes([marker]) + body
            size = io.append(oid, rec)
            records[oid].append(rec)
            assert size == sum(len(r) for r in records[oid]), oid

    try:
        append_burst(8)
        for _round in range(6):
            victim_log = logs[int(rng.integers(0, len(logs)))]
            primary = mon.osdmap.primary("ecpool", victim_log)
            live = [i for i in daemons if i not in dead]
            if primary in live and len(live) - 1 >= K + 1:
                daemons[primary].stop()
                mon.osd_down(primary)
                dead.append(primary)
            append_burst(6)
            if dead and rng.integers(0, 2):
                osd = dead.pop(0)
                d = _daemon(root, osd, mon, daemons[osd].store)
                daemons[osd] = d
                mon.osd_boot(osd, d.addr)
            append_burst(4)
        for oid in logs:
            want = b"".join(records[oid])
            got = io.read(oid) if records[oid] else b""
            assert io.stat(oid) == len(want), oid
            assert got == want, f"{oid}: log diverged"
        # settle: every corpse back, every PG recovered, scrub clean
        for osd in list(dead):
            d = _daemon(root, osd, mon, daemons[osd].store)
            daemons[osd] = d
            mon.osd_boot(osd, d.addr)
        dead.clear()
        for d in daemons.values():
            d.scrub_all(repair=True)
        _assert_scrub_clean(daemons)
        return records, _final_stores(root, mon, daemons, logs)
    finally:
        _shutdown(daemons, client)


@pytest.mark.parametrize("seed", [4242])
def test_append_log_thrash_exactly_once(seed):
    """Append-record logs under primary kill/revive: each log exactly
    its records, in order, none torn, doubled or lost, in both
    packages; settled and scrubbed, the stores are equal."""
    with time_limit(120):
        ref = _append_logs("ceph_tpu", seed)
        port = _append_logs("ceph_tpu_torch", seed)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
