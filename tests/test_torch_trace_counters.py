"""The port's host accounting (``utils/trace.py`` span and timer
counters, ``pipeline/shard_map.py``'s ``ec_staging`` set, the OSD's
``op_queue`` set), on the CPU.

- Spans and timers give each name of ``SPAN_NAMES`` its ``count``,
  ``wall_s`` (inclusive), ``self_s`` (minus the children closed on the
  same thread) and ``cpu_s`` (thread CPU minus the children's).
- Timers never enter the ring; ``<remote>`` markers count nothing; a
  disabled tracer counts nothing; a name outside ``SPAN_NAMES`` raises.
- ``ShardExtentMap.insert`` and ``.get`` count exactly the bytes they
  copy and zero-fill (the client bytes staged are counted by the
  pipelines, in the live test of ``test_torch_observability.py``).
- Through the port's RMW and read pipelines, a whole-stripe 4 MiB write
  stages at most 14 bytes a user byte and a whole-object read at most
  2.5, all of their bytes as whole stripes (``strided_bytes``); a small
  unaligned op moves none that way.
- An OSD's queued work balances: every scheduled item is counted once
  as started, with its wait.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu_torch.utils.trace import SPAN_NAMES, SPAN_STATS, Tracer  # noqa: E402


def _spin(seconds: float) -> None:
    end = time.thread_time() + seconds
    x = 0
    while time.thread_time() < end:
        x += 1


def _stats(t: Tracer, name: str) -> dict:
    dump = t.counters.dump()
    return {stat: dump[f"{name}.{stat}"] for stat in SPAN_STATS}


def test_every_name_has_four_keys():
    keys = set(Tracer().counters.dump())
    assert keys == {f"{n}.{s}" for n in SPAN_NAMES for s in SPAN_STATS}


def test_nested_spans_and_timers():
    t = Tracer()
    with t.span("osd_op"):
        _spin(0.02)
        with t.timer("ec_stage"):
            _spin(0.03)
        with t.span("ec_write"):
            with t.timer("store_commit"):
                _spin(0.01)
        with t.timer("ec_stage"):
            _spin(0.01)
    op, stage = _stats(t, "osd_op"), _stats(t, "ec_stage")
    write, store = _stats(t, "ec_write"), _stats(t, "store_commit")
    assert (op["count"], stage["count"], write["count"],
            store["count"]) == (1, 2, 1, 1)
    # self time is the wall time left after the direct children
    assert op["self_s"] == pytest.approx(
        op["wall_s"] - stage["wall_s"] - write["wall_s"])
    assert write["self_s"] == pytest.approx(
        write["wall_s"] - store["wall_s"])
    assert stage["self_s"] == stage["wall_s"]
    # cpu_s is the thread's own CPU, children's taken out
    assert op["cpu_s"] == pytest.approx(0.02, abs=0.01)
    assert stage["cpu_s"] == pytest.approx(0.04, abs=0.01)
    assert store["cpu_s"] == pytest.approx(0.01, abs=0.005)
    assert write["cpu_s"] < 0.005
    assert op["wall_s"] >= stage["wall_s"] + write["wall_s"]
    for name in ("osd_op", "ec_stage", "ec_write", "store_commit"):
        s = _stats(t, name)
        assert 0 <= s["cpu_s"] <= s["self_s"] + 1e-3


def test_child_on_another_thread_is_not_subtracted():
    t = Tracer()
    with t.span("osd_op"):
        worker = threading.Thread(target=lambda: t.timer("ec_stage")
                                  .__enter__().close())
        worker.start()
        worker.join()
        time.sleep(0.01)
    op = _stats(t, "osd_op")
    assert _stats(t, "ec_stage")["count"] == 1
    assert op["self_s"] == op["wall_s"]


def test_sleeping_span_has_near_zero_cpu():
    t = Tracer()
    with t.span("sub_write"):
        time.sleep(0.05)
    s = _stats(t, "sub_write")
    assert s["wall_s"] >= 0.05
    assert s["cpu_s"] < 0.01


def test_timers_never_enter_the_ring():
    t = Tracer()
    with t.span("client_op"):
        for _ in range(50):
            with t.timer("msg_encode"):
                pass
    ring = t.dump_historic()
    assert [s["name"] for s in ring] == ["client_op"]
    assert _stats(t, "msg_encode")["count"] == 50


def test_remote_markers_count_nothing():
    t = Tracer()
    with t.span("osd_op"):
        with t.continue_trace("T", "parent"):
            with t.span("sub_write") as sp:
                _spin(0.01)
    assert sp.trace_id == "T" and sp.parent_id == "parent"
    dump = t.counters.dump()
    assert not any(k.startswith("<remote>") for k in dump)
    assert sum(v for k, v in dump.items() if k.endswith(".count")) == 2
    op, sub = _stats(t, "osd_op"), _stats(t, "sub_write")
    assert op["self_s"] == pytest.approx(op["wall_s"] - sub["wall_s"])


def test_disabled_tracer_counts_nothing():
    t = Tracer(enabled=False)
    with t.span("osd_op") as sp:
        with t.timer("ec_stage"):
            _spin(0.001)
    assert sp is None
    assert not any(t.counters.dump().values())
    assert t.dump_historic() == []


@pytest.mark.parametrize("enabled", [True, False])
def test_unlisted_name_raises(enabled):
    t = Tracer(enabled=enabled)
    with pytest.raises(ValueError):
        t.timer("not_a_span")
    with pytest.raises(ValueError):
        with t.span("not_a_span"):
            pass


def test_concurrent_closes_lose_no_update():
    """Threads closing spans and timers of one tracer at a shortened
    switch interval: every close is counted, and each thread's self
    times stay its own."""
    import sys

    t = Tracer()
    threads, closes = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(closes):
            with t.span("sub_write"):
                with t.timer("store_commit"):
                    pass

    try:
        workers = [threading.Thread(target=work) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(w.is_alive() for w in workers)
    sub, store = _stats(t, "sub_write"), _stats(t, "store_commit")
    assert sub["count"] == store["count"] == threads * closes
    assert sub["self_s"] == pytest.approx(sub["wall_s"] - store["wall_s"])
    assert len(t.dump_historic()) == 512


def test_process_tracer_counts_into_perf_dump():
    from ceph_tpu_torch.utils import perf_collection, tracer

    before = perf_collection.dump()["trace"]["ec_decode.count"]
    with tracer.timer("ec_decode"):
        pass
    assert perf_collection.dump()["trace"]["ec_decode.count"] == before + 1


# -- ec_staging: the bytes insert and get copy and zero-fill ----------

def _sinfo():
    from ceph_tpu_torch.pipeline.stripe import StripeInfo

    return StripeInfo(2, 1, 2 * 4096)


def _staged(fn):
    from ceph_tpu_torch.utils import perf_collection

    before = perf_collection.dump()["ec_staging"]
    out = fn()
    after = perf_collection.dump()["ec_staging"]
    return out, {k: after[k] - before[k] for k in after}


def _u8(n, fill=1):
    return np.full(n, fill, dtype=np.uint8)


@pytest.mark.parametrize("case", [
    # (runs already in the map, insert (offset, data), copy, zero)
    ("empty", [], (100, _u8(50)), 50, 0),
    ("past_the_end", [(0, 10)], (20, _u8(5)), 5, 0),
    ("adjacent", [(0, 10)], (10, _u8(5)), 5 + 10 + 5, 15),
    ("overlapping", [(0, 10), (20, 10)], (5, _u8(20)), 20 + 20 + 20, 30),
    ("bytes", [], (0, bytes(7)), 7, 0),
    ("bytearray", [], (0, bytearray(7)), 14, 0),
], ids=lambda c: c[0])
def test_insert_counts_its_copies(case):
    from ceph_tpu_torch.pipeline.shard_map import ShardExtentMap

    _name, runs, (offset, data), copy, zero = case
    smap = ShardExtentMap(_sinfo())
    for off, n in runs:
        smap.insert(0, off, _u8(n, 2))
    _, d = _staged(lambda: smap.insert(0, offset, data))
    assert d == {"copy_bytes": copy, "zero_bytes": zero, "user_bytes": 0,
                 "strided_bytes": 0}


@pytest.mark.parametrize("case", [
    # (runs in the map, get (offset, length), copy, zero)
    ("absent", [(0, 10)], (100, 30), 0, 30),
    ("inside", [(0, 100)], (10, 30), 30, 30),
    ("straddling", [(0, 10), (20, 10)], (5, 20), 5 + 5, 20),
    ("no_shard", [], (0, 16), 0, 16),
], ids=lambda c: c[0])
def test_get_counts_its_copies(case):
    from ceph_tpu_torch.pipeline.shard_map import ShardExtentMap

    _name, runs, (offset, length), copy, zero = case
    smap = ShardExtentMap(_sinfo())
    for off, n in runs:
        smap.insert(0, off, _u8(n, 2))
    out, d = _staged(lambda: smap.get(0, offset, length))
    assert out.size == length
    assert d == {"copy_bytes": copy, "zero_bytes": zero, "user_bytes": 0,
                 "strided_bytes": 0}


def test_tally_defers_the_same_counts():
    """Inside ``tally`` a map's inserts and gets leave the set alone,
    and its end adds exactly what they would have added one by one."""
    from ceph_tpu_torch.pipeline.shard_map import ShardExtentMap

    def work(smap):
        for i in range(8):
            smap.insert(0, i * 10, _u8(10))
        smap.get(0, 5, 100)

    _, one_by_one = _staged(lambda: work(ShardExtentMap(_sinfo())))
    smap = ShardExtentMap(_sinfo())

    def tallied():
        with smap.tally():
            _, inside = _staged(lambda: work(smap))
            assert not any(inside.values())

    _, at_end = _staged(tallied)
    assert at_end == one_by_one
    assert one_by_one["copy_bytes"] > 0 and one_by_one["zero_bytes"] > 0

    def base_only():
        with smap.tally(user_bytes=80):
            pass

    _, base = _staged(base_only)
    assert base == {"copy_bytes": 0, "zero_bytes": 0, "user_bytes": 80,
                    "strided_bytes": 0}

    def strided_base():
        with smap.tally(user_bytes=80, strided_bytes=64):
            pass

    _, base = _staged(strided_base)
    assert base == {"copy_bytes": 0, "zero_bytes": 0, "user_bytes": 80,
                    "strided_bytes": 64}


def _pipeline(k=8, m=4):
    """The port's RMW and read pipelines over k+m MemStores on the CPU,
    with the benchmark's geometry: ISA, 4 KiB chunks."""
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.pipeline.read import ReadPipeline
    from ceph_tpu_torch.pipeline.rmw import RMWPipeline, ShardBackend
    from ceph_tpu_torch.pipeline.stripe import StripeInfo
    from ceph_tpu_torch.store import MemStore

    codec = registry.factory(
        "isa", {"k": str(k), "m": str(m), "technique": "reed_sol_van"},
        device="cpu")
    sinfo = StripeInfo(k, m, k * codec.get_chunk_size(k * 4096))
    backend = ShardBackend({s: MemStore(f"osd.{s}") for s in range(k + m)})
    rmw = RMWPipeline(sinfo, codec, backend)
    return rmw, ReadPipeline(sinfo, codec, backend, rmw.object_size)


MiB = 1 << 20


@pytest.mark.parametrize("case", [
    # (op after a 4 MiB write of "obj" at 0, its bytes, largest staged
    # bytes a user byte, strided bytes)
    ("write_full_4m", ("write", "new", 0, 4 * MiB), 14, 4 * MiB),
    ("write_4k_unaligned", ("write", "obj", 4096 * 5 + 100, 4096), None, 0),
    ("read_full_4m", ("read", "obj", 0, 4 * MiB), 2.5, 4 * MiB),
    ("read_4k_unaligned", ("read", "obj", 100, 4096), None, 0),
], ids=lambda c: c[0])
def test_pipeline_staging_counts(case):
    """A whole-stripe 4 MiB write stages 12.5 bytes a user byte, not the
    141.5 of one insert a 4 KiB chunk, and every byte of it and of a
    whole-object read moves as whole stripes; a small unaligned op moves
    none that way."""
    _name, (kind, oid, offset, n), most, strided = case
    rmw, reads = _pipeline()
    rng = np.random.default_rng(7)
    image = rng.integers(0, 256, 4 * MiB, dtype=np.uint8).tobytes()
    rmw.submit("obj", 0, image)
    if kind == "write":
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        _, d = _staged(lambda: rmw.submit(oid, offset, data))
        if oid == "obj":
            image = image[:offset] + data + image[offset + n:]
        assert reads.read_sync(oid, offset, n) == data
    else:
        got, d = _staged(lambda: reads.read_sync(oid, offset, n))
        assert got == image[offset:offset + n]
    assert d["user_bytes"] == n
    assert d["strided_bytes"] == strided
    if most is not None:
        assert (d["copy_bytes"] + d["zero_bytes"]) / n <= most
    assert reads.read_sync("obj", 0, 4 * MiB) == image


# -- the OSD's op queue ------------------------------------------------

@pytest.mark.parametrize("nshards", [1, 2])
def test_op_queue_counters_balance(nshards):
    from ceph_tpu_torch.cluster.monitor import Monitor
    from ceph_tpu_torch.cluster.osd_daemon import OSDDaemon
    from ceph_tpu_torch.store import MemStore
    from ceph_tpu_torch.utils import config

    mon = Monitor(device="cpu")
    mon.osd_crush_add(0, weight=1.0, zone="z0")
    with config.override(osd_op_num_shards=nshards):
        d = OSDDaemon(0, mon, store=MemStore("q"), tick_period=0,
                      device="cpu")
    n = 40
    ran = threading.Semaphore(0)
    try:
        d.start()
        before = d.op_queue_pc.dump()
        for _ in range(n):
            d._schedule("client", ran.release)
        for _ in range(n):
            assert ran.acquire(timeout=10)
        # an item counts as started before it runs
        after = d.op_queue_pc.dump()
    finally:
        d.stop()
    assert after["op_queue.dequeued"] - before["op_queue.dequeued"] == n
    assert after["op_queue.wait_s"] > before["op_queue.wait_s"]
    assert not d._queued_at


# -- the sub-op drain loop ---------------------------------------------

class _BusyOnce:
    """A callback lock another thread holds at the first non-blocking
    try, free after."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.refusals = 1

    def acquire(self, blocking: bool = True) -> bool:
        if not blocking and self.refusals:
            self.refusals -= 1
            return False
        return self._lock.acquire(blocking)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()

    def __exit__(self, *exc) -> None:
        self._lock.release()


def test_drain_counts_its_requeues():
    """A reply drained while another thread holds the callback lock is
    put back, counted on the owning daemon's ``drain.requeues``."""
    from ceph_tpu_torch.cluster.osd_daemon import make_net_perf
    from ceph_tpu_torch.msg.shard_server import NetShardBackend
    from ceph_tpu_torch.utils import perf_collection

    backend = NetShardBackend({}, name="osd.drain-test")
    pc = backend.messenger.net_pc = make_net_perf("osd.drain-test.net")
    backend._cb_lock = _BusyOnce()
    ran = []
    try:
        backend._inbox.put(lambda: ran.append(1))
        backend.drain_until(lambda: bool(ran), timeout=5)
    finally:
        backend.messenger.shutdown()
        perf_collection.deregister(pc.name)
    assert ran == [1]
    assert pc.get("drain.requeues") == 1


@pytest.mark.parametrize("staged, want", [
    ({"copy_bytes": 9, "zero_bytes": 0, "user_bytes": 8,
      "strided_bytes": 6}, 0.75),
    ({"copy_bytes": 9, "zero_bytes": 0, "user_bytes": 0,
      "strided_bytes": 0}, None),
    # a program that counts no strided bytes, as before the counter
    ({"copy_bytes": 9, "zero_bytes": 0, "user_bytes": 8}, None),
], ids=["counted", "no_user_bytes", "no_key"])
def test_strided_stage_frac_reader(staged, want):
    import types

    from ecbench.metrics import strided_stage_frac

    r = types.SimpleNamespace(counters={"ec_staging": staged})
    assert strided_stage_frac.read(r) == want
