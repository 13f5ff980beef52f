"""The port's concurrency stress tier against ceph_tpu's, on the CPU.

Mirrors ``tests/test_cluster_stress.py`` on ``ceph_tpu_torch`` with
``device="cpu"``: shared codecs hammered from threads (the SHEC decode
tables and the ISA decode-table cache, where the port keeps its
per-device matrices), the RMW pipeline's in-order, exactly-once commit
under adversarial ack order, a live cluster hammered by six writers
while an OSD is downed and revived, concurrent dispatch through one DCN
cluster (tids must not cross-deliver), and concurrent commands through
a monitor quorum. Each codec's output for a fixed input is also held to
``ceph_tpu``'s codec, byte for byte, before its threads start. Every
case runs under a time limit of its own.
"""

import threading
import time
from itertools import combinations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_dcn import limited  # noqa: E402

from ceph_tpu.codecs.registry import registry as ref_registry  # noqa: E402
from ceph_tpu_torch.codecs.registry import registry  # noqa: E402


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _roundtrip(codec, rng, nbytes, lose):
    k = codec.get_data_chunk_count()
    data = {
        i: rng.integers(0, 256, (nbytes,), np.uint8) for i in range(k)
    }
    parity = codec.encode_chunks(data)
    originals = {**data, **{i: _host(p) for i, p in parity.items()}}
    chunks = dict(originals)
    for i in lose:
        del chunks[i]
    out = codec.decode_chunks(set(lose), chunks)
    for i in lose:
        np.testing.assert_array_equal(_host(out[i]), originals[i])


def _same_parity_as_reference(plugin, profile, nbytes):
    codec = registry.factory(plugin, dict(profile), device="cpu")
    ref = ref_registry.factory(plugin, dict(profile))
    rng = np.random.default_rng(7)
    data = {i: rng.integers(0, 256, (nbytes,), np.uint8)
            for i in range(codec.get_data_chunk_count())}
    got = codec.encode_chunks(dict(data))
    want = ref.encode_chunks(dict(data))
    assert sorted(got) == sorted(want)
    for i in want:
        np.testing.assert_array_equal(_host(got[i]), np.asarray(want[i]))
    return codec


def _hammer(worker, n=8):
    errors: list = []

    def run(seed):
        try:
            worker(seed)
        except Exception as e:  # reported below
            errors.append((seed, e))

    threads = [threading.Thread(target=run, args=(s,)) for s in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a worker hung"
    assert not errors, errors


@limited(90)
def test_shec_codec_hammered_from_threads():
    """One shared SHEC codec (determinant-search decode tables) under
    8 threads x random erasures."""
    codec = _same_parity_as_reference(
        "shec", {"k": "4", "m": "3", "c": "2"}, 512)

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(25):
            nlose = int(rng.integers(1, 3))
            lose = list(rng.choice(7, size=nlose, replace=False))
            _roundtrip(codec, rng, 512, [int(x) for x in lose])

    _hammer(worker)


@limited(90)
def test_isa_decode_table_cache_threads():
    """Shared ISA codec: 8 threads cycling different erasure patterns
    contend on the decode-table cache; results stay bit-exact."""
    codec = _same_parity_as_reference("isa", {"k": "6", "m": "3"}, 1024)
    patterns = list(combinations(range(9), 2))

    def worker(seed):
        rng = np.random.default_rng(1000 + seed)
        for it in range(20):
            lose = list(patterns[(seed * 31 + it * 7) % len(patterns)])
            _roundtrip(codec, rng, 1024, lose)

    _hammer(worker)


@limited(60)
def test_rmw_commit_order_no_double_fire_under_racing_acks():
    """In-order commit and exactly-once callbacks survive adversarial
    ack order: one releaser thread fires deferred sub-write acks in a
    different shuffled order every round while ops are in flight."""
    from ceph_tpu_torch.pipeline.rmw import RMWPipeline, ShardBackend
    from ceph_tpu_torch.pipeline.stripe import PAGE_SIZE, StripeInfo
    from ceph_tpu_torch.store import MemStore

    k, m, chunk = 4, 2, PAGE_SIZE
    sinfo = StripeInfo(k, m, k * chunk)
    codec = registry.factory(
        "jerasure",
        {"technique": "reed_sol_van", "k": str(k), "m": str(m)},
        device="cpu",
    )
    backend = ShardBackend(
        {s: MemStore(f"osd.{s}") for s in range(k + m)}
    )
    backend.defer_acks = True
    pipe = RMWPipeline(sinfo, codec, backend)

    committed: list[int] = []
    commit_lock = threading.Lock()

    def on_commit(op):
        with commit_lock:
            committed.append(op.tid)

    rng = np.random.default_rng(0)
    n_ops = 10
    for i in range(n_ops):
        pipe.submit(
            "obj",
            (i % 2) * chunk,
            rng.integers(0, 256, chunk, dtype=np.uint8).tobytes(),
            on_commit=on_commit,
        )

    stop = threading.Event()

    def releaser():
        import random

        shard_ids = list(range(k + m))
        while not stop.is_set():
            random.shuffle(shard_ids)
            backend.release_deferred(order=list(shard_ids))
            time.sleep(0.001)

    t_rel = threading.Thread(target=releaser)
    t_rel.start()
    deadline = time.time() + 20
    while time.time() < deadline:
        with commit_lock:
            if len(committed) >= n_ops:
                break
        time.sleep(0.01)
    stop.set()
    t_rel.join(timeout=10)
    assert committed == list(range(1, n_ops + 1)), committed


@limited(120)
def test_cluster_hammer_under_membership_thrash():
    """6 writer threads hammer one pool through their own clients while
    a thrasher downs and revives an OSD; every object reads back as its
    last write."""
    from ceph_tpu_torch.cluster import Monitor, OSDDaemon, RadosClient

    mon = Monitor(device="cpu")
    for i in range(5):
        mon.osd_crush_add(i)
    daemons = []
    for i in range(5):
        d = OSDDaemon(i, mon, chunk_size=1024, tick_period=0, device="cpu")
        d.start()
        daemons.append(d)
    mon.osd_erasure_code_profile_set(
        "rs32",
        {"plugin": "jerasure", "technique": "reed_sol_van",
         "k": "3", "m": "2"},
    )
    mon.osd_pool_create("stress", 8, "rs32")

    finals: dict[str, bytes] = {}
    finals_lock = threading.Lock()
    errors: list = []
    stop_thrash = threading.Event()

    def writer(wid):
        client = RadosClient(mon, backoff=0.02)
        try:
            io = client.open_ioctx("stress")
            r = np.random.default_rng(wid)
            for it in range(8):
                oid = f"w{wid}-o{it % 3}"
                data = r.integers(
                    0, 256, 3 * 1024 + it * 517, dtype=np.uint8
                ).tobytes()
                io.write(oid, data)
                with finals_lock:
                    finals[oid] = data
                assert io.read(oid) == data
        except Exception as e:  # reported by the main thread
            errors.append((wid, e))
        finally:
            client.shutdown()

    def thrasher():
        victim = 4
        for _ in range(2):
            if stop_thrash.wait(0.3):
                return
            daemons[victim].stop()
            mon.osd_down(victim)
            if stop_thrash.wait(0.4):
                return
            d = OSDDaemon(
                victim, mon, store=daemons[victim].store,
                chunk_size=1024, tick_period=0, device="cpu",
            )
            d.start()
            daemons[victim] = d

    th = threading.Thread(target=thrasher)
    th.start()
    writers = [
        threading.Thread(target=writer, args=(w,)) for w in range(6)
    ]
    for t in writers:
        t.start()
    for t in writers:
        t.join(timeout=100)
    stop_thrash.set()
    th.join(timeout=10)
    try:
        assert not errors, errors
        client = RadosClient(mon, backoff=0.02)
        try:
            io = client.open_ioctx("stress")
            for oid, data in finals.items():
                assert io.read(oid) == data, f"{oid} diverged"
        finally:
            client.shutdown()
    finally:
        for d in daemons:
            try:
                d.stop()
            except Exception:
                pass


class TestDcnConcurrentDispatch:
    @limited(120)
    def test_parallel_apply_bitmatrix_no_cross_delivery(self):
        """Threads dispatching through one DcnCluster: tids must not
        race (a raced tid cross-delivers payloads); every output equals
        ceph_tpu's host GF apply of its own input."""
        from ceph_tpu.gf import gf_apply_bytes_host as ref_apply
        from ceph_tpu_torch.gf import (
            gf_matrix_to_bitmatrix,
            vandermonde_rs_matrix,
        )
        from ceph_tpu_torch.parallel.dcn import DcnCluster

        k, m = 4, 2
        g = vandermonde_rs_matrix(k, m)
        bm = gf_matrix_to_bitmatrix(g[k:, :])
        rng = np.random.default_rng(17)
        inputs = [
            rng.integers(0, 256, (2, k, 2048), np.uint8)
            for _ in range(12)
        ]
        expects = [np.asarray(ref_apply(g[k:, :], d)) for d in inputs]
        results: dict[int, np.ndarray] = {}
        errors: list[Exception] = []
        with DcnCluster(n_hosts=2, devices_per_host=2, device="cpu",
                        backend="gloo") as dcn:
            def worker(i):
                try:
                    results[i] = dcn.apply_bitmatrix(bm, inputs[i])
                except Exception as e:
                    errors.append(e)

            threads = [
                threading.Thread(target=worker, args=(i,))
                for i in range(len(inputs))
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not errors, errors[0]
        for i, exp in enumerate(expects):
            np.testing.assert_array_equal(
                _host(results[i]), exp,
                err_msg=f"op {i} got another op's output (tid race)",
            )


class TestQuorumConcurrentCommands:
    @limited(60)
    def test_parallel_commands_serialize_without_forking(self):
        """Concurrent proxied commands serialize through the leader
        without forking the epoch sequence or losing a command."""
        from ceph_tpu_torch.cluster.mon_quorum import (
            MonQuorumService,
            QuorumMonitor,
        )

        svc = MonQuorumService(3, device="cpu")
        mon = QuorumMonitor(svc)
        errors: list[Exception] = []

        def worker(base):
            try:
                for i in range(5):
                    mon.osd_crush_add(base * 10 + i, zone=f"z{base}")
            except Exception as e:
                errors.append(e)

        threads = [
            threading.Thread(target=worker, args=(b,)) for b in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors, errors[0]
        head = mon.osdmap
        assert head.epoch == 20, head.epoch
        for r in range(3):
            assert (
                svc.monitors[r].osdmap.to_bytes() == head.to_bytes()
            ), f"rank {r} diverged under concurrency"
