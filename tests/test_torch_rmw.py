"""The port's RMW pipeline (``pipeline/rmw.py``, ``extent_cache.py``)
against ceph_tpu's, byte for byte (tolerance 0), on the CPU.

Each test runs one seeded op sequence through two stacks built the same
way, ``ceph_tpu`` (CPU JAX, as its own tests run) and the port
(``device="cpu"``): ``ShardBackend`` over k+m ``MemStore``s, an
``RMWPipeline``, a ``ReadPipeline`` and a ``RecoveryBackend``. It then
compares every shard store (bytes and attrs), the commit order and
errors, the planner's choices and the perf counters. The cases mirror
``tests/test_rmw.py`` at chunk 4 KiB and a few objects. The ``Twin``
harness here is shared by the other pipeline parity files.
"""

import contextlib
import importlib
from itertools import combinations
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

PAGE = 4096
K, M = 4, 2


def _pkg(root: str) -> SimpleNamespace:
    """One package's pipeline surface under common names."""
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    ns = SimpleNamespace(root=root, port=root == "ceph_tpu_torch")
    ns.registry = mod("codecs").registry
    ns.Flag = mod("codecs").Flag
    ns.StripeInfo = mod("pipeline.stripe").StripeInfo
    ns.ExtentSet = mod("pipeline.extents").ExtentSet
    ns.ShardExtentMap = mod("pipeline.shard_map").ShardExtentMap
    ns.HashInfo = mod("pipeline.hashinfo").HashInfo
    ns.rmw = mod("pipeline.rmw")
    ns.read = mod("pipeline.read")
    ns.recovery = mod("pipeline.recovery")
    ns.pglog = mod("pipeline.pglog")
    ns.inject = mod("pipeline.inject")
    ns.extent_cache = mod("pipeline.extent_cache")
    ns.store = mod("store")
    ns.config = mod("utils").config
    ns.kw = {"device": "cpu"} if ns.port else {}
    return ns


REF, PORT = _pkg("ceph_tpu"), _pkg("ceph_tpu_torch")


class Stack:
    """ShardBackend({s: MemStore}) + RMWPipeline(+PGLog) + ReadPipeline
    + RecoveryBackend of one package, wired as tests/test_recovery.py
    wires them; recovery also stamps the pipeline's eversions, so a
    rebuilt shard's attrs equal the lost ones."""

    def __init__(self, pkg, plugin="jerasure", k=K, m=M, chunk=PAGE,
                 profile=None, pglog=False, stores=None):
        self.pkg = pkg
        prof = {"k": str(k), "m": str(m)}
        if plugin == "jerasure":
            prof["technique"] = "reed_sol_van"
        prof.update(profile or {})
        self.codec = pkg.registry.factory(plugin, prof, **pkg.kw)
        self.k, self.m = k, m
        self.chunk = self.codec.get_chunk_size(k * chunk)
        self.sinfo = pkg.StripeInfo(k, m, k * self.chunk)
        if stores is None:
            stores = {s: pkg.store.MemStore(f"osd.{s}") for s in range(k + m)}
        self.backend = pkg.rmw.ShardBackend(stores)
        self.pglog = pkg.pglog.PGLog(k + m) if pglog else None
        self.rmw = pkg.rmw.RMWPipeline(
            self.sinfo, self.codec, self.backend, pglog=self.pglog
        )
        self.reads = pkg.read.ReadPipeline(
            self.sinfo, self.codec, self.backend, self.rmw.object_size
        )
        self.rec = pkg.recovery.RecoveryBackend(
            self.sinfo, self.codec, self.backend, self.rmw.object_size,
            self.rmw.hinfo, eversion_fn=self.rmw.object_eversion,
        )

    def scrub(self, oid, hinfo=None):
        res = self.pkg.recovery.be_deep_scrub(
            self.sinfo, self.backend, oid, hinfo, **self.pkg.kw
        )
        return [(e.shard, e.kind, e.detail) for e in res.errors]

    def wipe(self, shard):
        """Replace a shard's store with an empty one (OSD replaced)."""
        old = self.backend.stores[shard]
        self.backend.stores[shard] = self.pkg.store.MemStore(f"osd.{shard}.new")
        return old

    def snapshot(self):
        """{shard: {oid: (bytes, attrs)}} of every store."""
        return {s: store_snapshot(st) for s, st in self.backend.stores.items()}

    def counters(self):
        return {n: self.rmw.perf.get(n) for n in (
            "write_ops", "write_bytes", "parity_delta_ops",
            "full_stripe_ops", "aborts")}


def store_snapshot(store):
    """Plain data of one store through the read API both packages share."""
    return {
        oid: (store.read(oid), store.getattrs(oid))
        for oid in store.list_objects()
    }


def outcome(op):
    """(id, error class name, error text) of a finished op."""
    err = op.error
    return (getattr(op, "tid", getattr(op, "rid", None)),
            None if err is None else type(err).__name__,
            None if err is None else str(err))


class Twin:
    """The same stack in ceph_tpu and in the port."""

    def __init__(self, **kw):
        self.ref = Stack(REF, **kw)
        self.port = Stack(PORT, **kw)
        self.stacks = (self.ref, self.port)

    def do(self, fn):
        """``fn(stack)`` on both; returns (ref result, port result)."""
        return fn(self.ref), fn(self.port)

    def same(self, fn):
        a, b = self.do(fn)
        assert a == b
        return a

    def assert_stores_equal(self):
        a, b = self.ref.snapshot(), self.port.snapshot()
        assert a.keys() == b.keys()
        for shard in a:
            assert a[shard] == b[shard], f"shard {shard}"

    def submit(self, oid, off, data):
        """Submit on both; returns the two commit logs."""
        logs = ([], [])
        for st, log in zip(self.stacks, logs):
            st.rmw.submit(oid, off, data, lambda op, lg=log: lg.append(outcome(op)))
        return logs


@contextlib.contextmanager
def override(**kv):
    """The same config override on both packages."""
    with REF.config.override(**kv), PORT.config.override(**kv):
        yield


@pytest.fixture(autouse=True)
def _clean_inject():
    for pkg in (REF, PORT):
        pkg.inject.ec_inject.clear_all()
    yield
    for pkg in (REF, PORT):
        pkg.inject.ec_inject.clear_all()


def payload(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def reconstruct(st, oid, size, lost=()):
    """Every shard store minus ``lost``, decoded to the ro bytes (the
    test_rmw full degraded-read check, through the port's or the
    reference's own ShardExtentMap)."""
    pkg, sinfo = st.pkg, st.sinfo
    smap = pkg.ShardExtentMap(sinfo)
    for shard, store in st.backend.stores.items():
        if shard in lost or not store.exists(oid):
            continue
        buf = store.read(oid)
        exact = sinfo.object_size_to_exact_shard_size(size, shard)
        buf = buf + b"\0" * max(0, exact - len(buf))
        smap.insert(shard, 0, np.frombuffer(buf, np.uint8))
    smap.decode(st.codec, {sinfo.get_shard(r) for r in range(sinfo.k)}, size)
    out = np.zeros(size, dtype=np.uint8)
    pos = 0
    while pos < size:
        ci = pos // sinfo.chunk_size
        in_chunk = pos % sinfo.chunk_size
        take = min(sinfo.chunk_size - in_chunk, size - pos)
        shard_off = (ci // sinfo.k) * sinfo.chunk_size + in_chunk
        out[pos:pos + take] = smap.get(
            sinfo.get_shard(ci % sinfo.k), shard_off, take)
        pos += take
    return bytes(out)


# -- WritePlan ----------------------------------------------------------
@pytest.mark.parametrize("flags", ["delta", "none"])
@pytest.mark.parametrize("off,length,size", [
    (0, K * PAGE, 0), (0, PAGE, 8 * K * PAGE), (K * PAGE, K * PAGE, 4 * K * PAGE),
    (37, 100, K * PAGE), (PAGE + 100, 3 * PAGE, 2 * K * PAGE),
    (5 * PAGE - 7, 9000, 3 * K * PAGE + 11),
])
def test_plan_write_matches(flags, off, length, size):
    plans = []
    for pkg in (REF, PORT):
        f = pkg.Flag.PARITY_DELTA_OPTIMIZATION if flags == "delta" else pkg.Flag.NONE
        p = pkg.rmw.plan_write(pkg.StripeInfo(K, M, K * PAGE), f, off, length, size)
        plans.append((p.do_parity_delta, p.read_bytes(),
                      {s: list(e) for s, e in p.to_read.items()},
                      {s: list(e) for s, e in p.to_write.items()}))
    assert plans[0] == plans[1]


def test_attr_formats_match():
    for size, ev in ((0, (0, 0)), (123456, (3, 17))):
        assert REF.rmw.pack_oi(size, ev) == PORT.rmw.pack_oi(size, ev)
        raw = PORT.rmw.pack_oi(size, ev)
        assert REF.rmw.parse_oi(raw) == PORT.rmw.parse_oi(raw)
    assert PORT.rmw.parse_oi(b"77") == REF.rmw.parse_oi(b"77")
    assert (REF.rmw.HINFO_KEY, REF.rmw.OI_KEY, REF.rmw.SI_KEY) == (
        PORT.rmw.HINFO_KEY, PORT.rmw.OI_KEY, PORT.rmw.SI_KEY)


# -- end-to-end writes --------------------------------------------------
def test_full_stripe_write_and_degraded_read(rng):
    tw = Twin()
    data = payload(rng, K * PAGE)
    logs = tw.submit("obj", 0, data)
    assert logs[0] == logs[1] == [(1, None, None)]
    tw.assert_stores_equal()
    for lost in combinations(range(K + M), M):
        assert reconstruct(tw.port, "obj", len(data), lost) == data


def test_append_then_overwrite_rmw(rng):
    tw = Twin()
    base = payload(rng, 2 * K * PAGE)
    patch = payload(rng, PAGE)
    tw.submit("obj", 0, base)
    tw.submit("obj", PAGE, patch)
    tw.assert_stores_equal()
    assert tw.same(lambda st: st.counters())["parity_delta_ops"] == 1
    expect = bytearray(base)
    expect[PAGE:2 * PAGE] = patch
    for lost in combinations(range(K + M), M):
        assert reconstruct(tw.port, "obj", len(base), lost) == bytes(expect)


def test_unaligned_sub_page_write(rng):
    tw = Twin()
    base = payload(rng, K * PAGE)
    tw.submit("obj", 0, base)
    tw.submit("obj", 37, b"\xAB" * 100)
    tw.assert_stores_equal()
    expect = bytearray(base)
    expect[37:137] = b"\xAB" * 100
    assert reconstruct(tw.port, "obj", len(base), (0, 4)) == bytes(expect)


def test_multi_stripe_append_grows_object(rng):
    tw = Twin()
    a, b = payload(rng, K * PAGE), payload(rng, 3 * K * PAGE + 123)
    tw.submit("obj", 0, a)
    tw.submit("obj", len(a), b)
    assert tw.same(lambda st: st.rmw.object_size("obj")) == len(a) + len(b)
    tw.assert_stores_equal()
    assert reconstruct(tw.port, "obj", len(a) + len(b), (1, 5)) == a + b


def test_hinfo_maintained_on_append_cleared_on_overwrite(rng):
    tw = Twin()
    a = payload(rng, K * PAGE)
    tw.submit("obj", 0, a)
    hinfo = lambda st: st.rmw.hinfo("obj").to_bytes()  # noqa: E731
    assert tw.same(lambda st: st.rmw.hinfo("obj").get_total_chunk_size()) == PAGE
    tw.same(hinfo)
    tw.submit("obj", len(a), a)
    assert tw.same(lambda st: st.rmw.hinfo("obj").get_total_chunk_size()) == 2 * PAGE
    tw.same(hinfo)
    tw.submit("obj", 0, b"\x01" * 64)
    assert tw.same(lambda st: st.rmw.hinfo("obj").get_total_chunk_size()) == 0
    tw.assert_stores_equal()


@pytest.mark.parametrize("fused", [True, False])
def test_fused_and_separate_csums_store_the_same_bytes(rng, fused):
    """Appends with csum blocks ride the fused encode+csum (or A then C
    with ``ec_fused_csum`` off in the port); either way HashInfo and the
    stores equal ceph_tpu's."""
    tw = Twin()
    first, second = payload(rng, 2 * K * PAGE), payload(rng, 2 * K * PAGE)
    with PORT.config.override(ec_fused_csum=fused):
        tw.submit("obj", 0, first)
        tw.submit("obj", len(first), second)
    tw.assert_stores_equal()
    tw.same(lambda st: st.rmw.hinfo("obj").to_bytes())


def test_host_and_device_routes_store_the_same_bytes(rng):
    """Small overwrites take the host GF tables under the default
    ``ec_host_dispatch_bytes``; at 0 the port sends them to the apply
    kernel's route. The stores that result are equal."""
    data = payload(rng, 4 * K * PAGE)
    patches = [(int(rng.integers(0, 4 * K * PAGE - 300)), payload(rng, 300))
               for _ in range(6)]
    snaps = []
    for limit in (None, 0):
        st = Stack(PORT)
        opts = {} if limit is None else {"ec_host_dispatch_bytes": limit}
        with PORT.config.override(**opts):
            st.rmw.submit("obj", 0, data)
            for off, p in patches:
                st.rmw.submit("obj", off, p)
        snaps.append(st.snapshot())
    assert snaps[0] == snaps[1]
    tw = Twin()
    tw.submit("obj", 0, data)
    for off, p in patches:
        tw.submit("obj", off, p)
    assert tw.ref.snapshot() == snaps[1]


def test_in_order_commit_with_out_of_order_acks(rng):
    tw = Twin()
    data = payload(rng, K * PAGE)
    logs = []
    for st in tw.stacks:
        st.backend.defer_acks = True
        log = []
        t1 = st.rmw.submit("a", 0, data, lambda op, lg=log: lg.append(op.tid))
        t2 = st.rmw.submit("b", 0, data, lambda op, lg=log: lg.append(op.tid))
        acks, st.backend.deferred = st.backend.deferred, []
        for _, ack in acks[K + M:]:
            ack()
        assert log == []
        for _, ack in acks[:K + M]:
            ack()
        logs.append((log, [t1, t2]))
    assert logs[0] == logs[1] and logs[1][0] == logs[1][1]
    tw.assert_stores_equal()


def test_release_deferred_in_shard_order(rng):
    tw = Twin()
    data = payload(rng, 2 * K * PAGE)
    for st in tw.stacks:
        st.backend.defer_acks = True
    logs = tw.submit("obj", 0, data)
    for off in (PAGE, 3 * PAGE + 5):
        logs2 = tw.submit("obj", off, payload(rng, 2000))
        logs[0].extend(logs2[0])
        logs[1].extend(logs2[1])
    for st in tw.stacks:
        st.backend.release_deferred(order=[5, 4, 3, 2, 1, 0])
    assert logs[0] == logs[1] and [t for t, *_ in logs[1]] == [1]
    for st in tw.stacks:
        st.backend.release_deferred()
    tw.assert_stores_equal()


# -- extent cache -------------------------------------------------------
def test_cache_hits_match(rng):
    tw = Twin()
    tw.submit("obj", 0, payload(rng, K * PAGE))
    tw.submit("obj", 0, b"\x55" * 256)
    tw.same(lambda st: (st.rmw.cache.stat_hits, st.rmw.cache.stat_misses,
                        st.rmw.cache.lru_size()))
    tw.assert_stores_equal()


def test_cache_single_outstanding_read_and_fifo():
    runs = []
    for pkg in (REF, PORT):
        sinfo = pkg.StripeInfo(K, M, K * PAGE)
        issued, ready = [], []
        cache = pkg.extent_cache.ECExtentCache(
            sinfo, lambda oid, want, iss=issued: iss.append(oid))
        ops = [cache.prepare(n, {0: pkg.ExtentSet([(0, 512)])},
                             {0: pkg.ExtentSet([(0, 512)])}, 512,
                             lambda op, rd=ready: rd.append(op.oid))
               for n in ("x", "y")]
        cache.execute(ops)
        trace = [list(issued)]
        smap = pkg.ShardExtentMap(sinfo)
        smap.insert(0, 0, np.zeros(512, np.uint8))
        cache.read_done("x", smap)
        trace += [list(ready), list(issued)]
        cache.read_done("y", smap)
        trace.append(list(ready))
        runs.append(trace)
    assert runs[0] == runs[1] == [["x"], ["x"], ["x", "y"], ["x", "y"]]


def test_cache_lru_eviction_unpinned_only():
    sizes = []
    for pkg in (REF, PORT):
        line = pkg.extent_cache.LINE_SIZE
        sinfo = pkg.StripeInfo(K, M, K * PAGE)
        cache = pkg.extent_cache.ECExtentCache(
            sinfo, lambda oid, want: None, capacity_lines=2)
        ops = [cache.prepare(f"o{i}", None,
                             {0: pkg.ExtentSet([(i * line, i * line + 128)])},
                             line * 4, lambda op: None) for i in range(4)]
        cache.execute(ops)
        for i, op in enumerate(ops):
            smap = pkg.ShardExtentMap(sinfo)
            smap.insert(0, i * line, np.full(128, i, np.uint8))
            cache.write_done(op, smap)
        sizes.append(cache.lru_size())
        cache.on_change()
        sizes.append(cache.lru_size())
    assert REF.extent_cache.LINE_SIZE == PORT.extent_cache.LINE_SIZE
    assert sizes[:2] == sizes[2:] and sizes[0] <= 2 and sizes[1] == 0


# -- shard down mid-flight ----------------------------------------------
@pytest.mark.parametrize("down_at_dispatch", [set(), {0, 1}])
def test_shard_down_mid_flight(rng, down_at_dispatch):
    tw = Twin()
    data = payload(rng, K * PAGE)
    res = []
    for st in tw.stacks:
        st.backend.down_shards.update(down_at_dispatch)
        st.backend.defer_acks = True
        done = []
        st.rmw.submit("obj", 0, data, lambda op, d=done: d.append(outcome(op)))
        for shard, ack in list(st.backend.deferred):
            if shard != 5:
                ack()
        st.backend.down_shards.add(5)
        st.rmw.on_shard_down(5)
        res.append(done)
    assert res[0] == res[1] and len(res[1]) == 1
    assert (res[1][0][1] is None) == (not down_at_dispatch)
    tw.assert_stores_equal()


# -- packet codes ride parity delta -------------------------------------
@pytest.mark.parametrize("technique,w", [
    ("liberation", 7), ("blaum_roth", 6), ("liber8tion", 8),
])
def test_bitmatrix_partial_overwrite_uses_parity_delta(rng, technique, w):
    tw = Twin(profile={"technique": technique, "w": str(w)})
    chunk = tw.port.chunk
    base = payload(rng, 2 * K * chunk)
    tw.submit("obj", 0, base)
    tw.submit("obj", chunk, payload(rng, PAGE))
    c = tw.same(lambda st: st.counters())
    assert c["parity_delta_ops"] >= 1
    tw.assert_stores_equal()


def test_subpage_chunk_delta(rng):
    tw = Twin(profile={"technique": "liberation", "w": "7"}, chunk=1024)
    chunk = tw.port.chunk
    assert chunk % PAGE
    base = payload(rng, 6 * K * chunk)
    tw.submit("obj", 0, base)
    off = 2 * K * chunk + chunk + 400
    patch = payload(rng, 100)
    tw.submit("obj", off, patch)
    tw.assert_stores_equal()
    expect = bytearray(base)
    expect[off:off + 100] = patch
    for lost in ((0, 1), (2, 3), (1, 4), (4, 5)):
        assert reconstruct(tw.port, "obj", len(base), lost) == bytes(expect)


# -- truncate, remove, xattrs -------------------------------------------
def test_shrink_then_extend(rng):
    tw = Twin()
    data = payload(rng, 2 * K * PAGE)
    tw.submit("obj", 0, data)
    tw.do(lambda st: st.rmw.submit_truncate("obj", 3000))
    assert tw.same(lambda st: st.rmw.object_size("obj")) == 3000
    tw.assert_stores_equal()
    tail = payload(rng, 500)
    tw.submit("obj", 8000, tail)
    tw.assert_stores_equal()
    expect = data[:3000] + b"\0" * 5000 + tail
    assert reconstruct(tw.port, "obj", 8500, (0, 1)) == expect


def test_grow_is_a_hole(rng):
    tw = Twin()
    tw.submit("obj", 0, payload(rng, 1000))
    tw.do(lambda st: st.rmw.submit_truncate("obj", 5000))
    assert tw.same(lambda st: st.rmw.object_size("obj")) == 5000
    tw.assert_stores_equal()


@pytest.mark.parametrize("new_size,down", [(2000, 2), (9000, 3)])
def test_truncate_journals_for_down_shard(rng, new_size, down):
    tw = Twin(pglog=True)
    tw.submit("obj", 0, payload(rng, 2 * K * PAGE))
    for st in tw.stacks:
        st.backend.down_shards.add(down)
        st.rmw.submit_truncate("obj", new_size)
        st.backend.down_shards.clear()
    tw.same(lambda st: {s: st.pglog.dirty_extents(s) for s in range(K + M)}
            .__repr__())
    tw.do(lambda st: st.rec.recover_from_log(st.pglog, down))
    tw.do(lambda st: st.rmw.on_shard_recovered(down))
    tw.assert_stores_equal()


def test_truncate_racing_inflight_write(rng):
    tw = Twin()
    data = payload(rng, 2 * K * PAGE)
    for st in tw.stacks:
        st.backend.defer_acks = True
        st.rmw.submit("obj", 0, data)
        st.rmw.submit_truncate("obj", 3000)
        st.backend.defer_acks = False
        st.backend.release_deferred()
    assert tw.same(lambda st: st.rmw.object_size("obj")) == 3000
    tw.assert_stores_equal()
    assert reconstruct(tw.port, "obj", 3000, (0, 1)) == data[:3000]


def test_remove_and_xattrs(rng):
    tw = Twin(pglog=True)
    tw.submit("a", 0, payload(rng, K * PAGE))
    tw.submit("b", 0, payload(rng, 3000))
    logs = ([], [])
    for st, log in zip(tw.stacks, logs):
        cb = lambda op, lg=log: lg.append(outcome(op))  # noqa: E731
        st.rmw.submit_setxattr("a", "color", b"blue", cb)
        st.rmw.submit_attr_updates("b", {"u:x": b"1", "m:key": b"v"}, cb)
        st.rmw.submit_setxattr("a", "color", None, cb)
        st.rmw.submit_remove("b", cb)
    assert logs[0] == logs[1] and all(e[1] is None for e in logs[1])
    tw.assert_stores_equal()
    tw.same(lambda st: (st.rmw.object_size("b"), len(st.pglog)))


def test_interval_change_and_prime(rng):
    tw = Twin()
    data = payload(rng, K * PAGE + 99)
    tw.submit("obj", 0, data)
    tw.do(lambda st: st.rmw.on_interval_change())
    assert tw.same(lambda st: st.rmw.object_size("obj")) == 0
    for st in tw.stacks:
        raw = st.backend.stores[0].getattr("obj", st.pkg.rmw.OI_KEY)
        size, ev = st.pkg.rmw.parse_oi(raw)
        st.rmw.prime_object("obj", size, eversion=ev)
    tw.submit("obj", len(data), payload(rng, 500))
    tw.assert_stores_equal()
    tw.same(lambda st: (st.rmw.object_eversion("obj"),
                        st.rmw.live_eversion("obj")))
