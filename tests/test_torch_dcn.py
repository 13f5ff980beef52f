"""The port's multi-process DCN tier against ceph_tpu, on the CPU.

Mirrors ``tests/test_dcn.py`` and the multi-device live-cluster cases
of ``tests/test_coalesce.py``: two (or three) worker processes started
as ``python -m ceph_tpu_torch.parallel.dcn``, joined by a gloo process
group, the socket messenger as the control plane. Every output is
compared byte for byte with ``ceph_tpu``'s codec on the same numpy
inputs; the hosts' counters show the mesh route served each op. A dead
host fails over to the single-host route and counts ``dcn_fallback``.

Every test here runs under a time limit of its own (``time_limit``), and
waits on completions, never on sleeps.
"""

import contextlib
import functools
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu.codecs.registry import registry as ref_registry  # noqa: E402
from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters  # noqa: E402
from ceph_tpu_torch.codecs.registry import registry  # noqa: E402
from ceph_tpu_torch.parallel import dispatch as mesh_dispatch  # noqa: E402
from ceph_tpu_torch.parallel.dcn import DcnCluster  # noqa: E402

K, M = 8, 4
CHUNK = 4096
BATCH = 4  # divisible by devices_per_host (dp)
PROFILE = {"technique": "reed_sol_van", "k": str(K), "m": str(M)}


@contextlib.contextmanager
def time_limit(seconds: float):
    """Fail the enclosed block with TimeoutError after ``seconds`` (a
    wait that never ends fails the test instead of hanging the run).
    Main thread only, as pytest runs tests."""
    def fire(signum, frame):
        raise TimeoutError(f"over its {seconds} s time limit")

    old = signal.signal(signal.SIGALRM, fire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def limited(seconds: float):
    """``time_limit`` as a test decorator."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            with time_limit(seconds):
                return fn(*args, **kw)
        return run
    return wrap


def _snap():
    pc = dispatch_counters()
    return {k: pc.get(k) for k in pc.dump()}


def _delta(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ref_encode(plugin, profile, data):
    codec = ref_registry.factory(plugin, dict(profile))
    k = data.shape[1]
    out = codec.encode_chunks({i: data[:, i, :] for i in range(k)})
    return np.stack([np.asarray(out[k + j]) for j in range(len(out))],
                    axis=1)


@pytest.fixture(scope="module")
def cluster():
    # 2 hosts x 2 logical CPU devices: sp (= hosts) spans processes, so
    # the parity ring's hops cross the host boundary over gloo
    with time_limit(120):
        c = DcnCluster(n_hosts=2, devices_per_host=2, device="cpu",
                       backend="gloo").start()
    try:
        yield c
    finally:
        with time_limit(60):
            c.stop()


@limited(60)
def test_hosts_joined_one_mesh(cluster):
    assert cluster.backend == "gloo"
    assert len(cluster.hellos) == 2
    for hello in cluster.hellos.values():
        assert hello.n_processes == 2
        assert hello.local_devices == 2
        assert hello.global_devices == 4


@limited(60)
@pytest.mark.parametrize("lanes", [CHUNK, CHUNK + 1])
def test_encode_across_hosts_equals_the_reference(cluster, rng, lanes):
    data = rng.integers(0, 256, (BATCH, K, lanes), np.uint8)
    parity, counters = cluster.encode("jerasure", PROFILE, data)
    np.testing.assert_array_equal(
        parity, _ref_encode("jerasure", PROFILE, data))
    for rank in (0, 1):
        assert counters[rank].get("mesh_encode") == 1, counters


@limited(60)
def test_reconstruct_across_hosts(cluster, rng):
    data = rng.integers(0, 256, (BATCH, K, CHUNK), np.uint8)
    parity, _ = cluster.encode("jerasure", PROFILE, data)
    present = [1, 2, 3, 4, 6, 7, 8, 9, 10, 11]  # 5 shards a host
    chunks = np.concatenate([data, parity], axis=1)
    out, counters = cluster.decode(
        "jerasure", PROFILE, present, [0, 5], chunks[:, present, :])
    np.testing.assert_array_equal(out[:, 0, :], data[:, 0, :])
    np.testing.assert_array_equal(out[:, 1, :], data[:, 5, :])
    for rank in (0, 1):
        assert counters[rank].get("mesh_decode") == 1


@limited(60)
def test_packet_code_family_across_hosts(cluster, rng):
    k, m, w = 4, 2, 7
    profile = {"technique": "liberation", "k": str(k), "m": str(m),
               "w": str(w)}
    data = rng.integers(0, 256, (BATCH, k, w * 512), np.uint8)
    parity, counters = cluster.encode("jerasure", profile, data)
    np.testing.assert_array_equal(parity,
                                  _ref_encode("jerasure", profile, data))
    for rank in (0, 1):
        assert counters[rank].get("mesh_encode") == 1
    chunks = np.concatenate([data, parity], axis=1)
    present = [0, 2, 3, 4]
    out, _ = cluster.decode(
        "jerasure", profile, present, [1, 5], chunks[:, present, :])
    np.testing.assert_array_equal(out[:, 0, :], data[:, 1, :])
    np.testing.assert_array_equal(out[:, 1, :], parity[:, 1, :])


@limited(60)
@pytest.mark.parametrize("batch", [BATCH, 1])
def test_generic_apply_folds_lanes(cluster, rng, batch):
    """The codec route's op: a raw bitmatrix over [B, C, N] host bytes;
    a batch that does not divide dp folds the lane axis."""
    from ceph_tpu_torch.gf import gf_apply_bytes_host, gf_matrix_to_bitmatrix
    from ceph_tpu_torch.gf import vandermonde_rs_matrix

    g = vandermonde_rs_matrix(K, M)
    data = rng.integers(0, 256, (batch, K, 2048), np.uint8)
    assert cluster.supported((32, 64), data.shape)
    out = cluster.apply_bitmatrix(gf_matrix_to_bitmatrix(g[K:]), data)
    np.testing.assert_array_equal(out, gf_apply_bytes_host(g[K:], data))


@limited(90)
def test_rmw_pipeline_routes_over_dcn(cluster):
    """With a cluster installed, the codec dispatch engine fans the RMW
    pipeline's encode / parity-delta / reconstruct work across hosts,
    and the stores hold what ceph_tpu's pipeline writes."""
    from ceph_tpu_torch.pipeline.rmw import RMWPipeline, ShardBackend
    from ceph_tpu_torch.pipeline.shard_map import ShardExtentMap
    from ceph_tpu_torch.pipeline.stripe import StripeInfo
    from ceph_tpu_torch.store import MemStore
    from ceph_tpu_torch.utils import config

    k, m, chunk = 6, 2, 4096
    sinfo = StripeInfo(k, m, k * chunk)
    codec = registry.factory("isa", {"k": str(k), "m": str(m)},
                             device="cpu")
    backend = ShardBackend({s: MemStore(f"osd.{s}") for s in range(k + m)})
    pipe = RMWPipeline(sinfo, codec, backend)
    rng = np.random.default_rng(21)
    payload = rng.integers(0, 256, 2 * k * chunk, np.uint8).tobytes()
    patch = rng.integers(0, 256, 200, np.uint8).tobytes()
    off = chunk - 100  # spans two data chunks: an even column count
    before = _snap()
    with config.override(ec_host_dispatch_bytes=0), \
            mesh_dispatch.use_dcn(cluster):
        pipe.submit("obj", 0, payload)
        pipe.submit("obj", off, patch)
        smap = ShardExtentMap(sinfo)
        for shard, store in backend.stores.items():
            if shard in (0, 7) or not store.exists("obj"):
                continue
            smap.insert(shard, 0,
                        np.frombuffer(store.read("obj"), np.uint8))
        smap.decode(codec, {sinfo.get_shard(r) for r in range(k)},
                    len(payload))
    moved = _delta(before, _snap())
    assert moved.get("dcn_encode", 0) >= 1, moved
    assert moved.get("dcn_delta", 0) >= 1, moved
    assert moved.get("dcn_decode", 0) >= 1, moved
    expect = bytearray(payload)
    expect[off:off + len(patch)] = patch
    got = bytearray(len(payload))
    for pos in range(0, len(payload), chunk):
        ci = pos // chunk
        got[pos:pos + chunk] = smap.get(
            sinfo.get_shard(ci % k), (ci // k) * chunk, chunk).tobytes()
    assert bytes(got) == bytes(expect)
    # the parity on the stores equals ceph_tpu's encode of the result
    ref = ref_registry.factory("isa", {"k": str(k), "m": str(m)})
    stripes = np.frombuffer(bytes(expect), np.uint8).reshape(2, k, chunk)
    want = ref.encode_chunks({i: stripes[:, i] for i in range(k)})
    for j in range(m):
        stored = np.frombuffer(
            backend.stores[sinfo.get_shard(k + j)].read("obj"), np.uint8)
        np.testing.assert_array_equal(
            stored.reshape(2, chunk), np.asarray(want[k + j]))


@limited(90)
def test_dead_cluster_fails_fast_into_fallback():
    """A dead DCN host must not wedge the data path: the dispatch engine
    serves the op on the single-host route, uninstalls the cluster, and
    counts dcn_fallback; the op's bytes are right."""
    from ceph_tpu_torch.utils import config

    codec = registry.factory("isa", {"k": "4", "m": "2"}, device="cpu")
    rng = np.random.default_rng(33)
    data = {i: rng.integers(0, 256, (4096,), np.uint8) for i in range(4)}
    expect = codec.encode_chunks(dict(data))
    dcn = DcnCluster(n_hosts=2, devices_per_host=2, device="cpu",
                     backend="gloo").start()
    dcn.apply_bitmatrix = functools.partial(
        DcnCluster.apply_bitmatrix, dcn, timeout=5.0)
    for p in dcn.procs:
        p.kill()          # hosts die without goodbye
    for p in dcn.procs:
        p.wait(timeout=30)
    pc = dispatch_counters()
    before = pc.get("dcn_fallback")
    try:
        with config.override(ec_host_dispatch_bytes=0), \
                mesh_dispatch.use_dcn(dcn):
            got = codec.encode_chunks(dict(data))
            assert mesh_dispatch.get_dcn() is None
    finally:
        dcn.stop()
    assert pc.get("dcn_fallback") == before + 1
    for j in expect:
        np.testing.assert_array_equal(_host(got[j]), _host(expect[j]))


def test_backend_is_explicit_and_checked():
    with pytest.raises(ValueError, match="backend"):
        DcnCluster(2, 2, device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="nccl"):
        DcnCluster(2, 2, device="cpu", backend="nccl")


# -- live clusters over the multi-device routes (test_coalesce mirrors) --
def _payload(i: int, n: int) -> bytes:
    return np.random.default_rng(i).integers(0, 256, n, np.uint8).tobytes()


@limited(120)
def test_mesh_serves_live_cluster_ops():
    """A live socket cluster with the logical 8-device mesh installed
    serves client writes through the collective fan-out, and reads
    verify. Completions are awaited with a deadline each."""
    from ceph_tpu_torch.loadgen import LoadCluster

    pc = dispatch_counters()
    before = pc.get("mesh_encode")
    cluster = LoadCluster(
        n_osds=6, k=4, m=2, pg_num=2, chunk_size=2048, pool="meshpool",
        use_mesh=True, mesh_devices=8, mesh_device_list=["cpu"] * 8,
        device="cpu",
    )
    try:
        assert mesh_dispatch.get_mesh() is cluster.mesh
        assert cluster.mesh.shape == {"dp": 2, "sp": 4}
        comps = [cluster.io.aio_write_full(f"m{i}", _payload(i, 16384))
                 for i in range(6)]
        for c in comps:
            c.wait_for_complete(30)
            assert c.is_complete()
        for i in range(6):
            assert cluster.io.read(f"m{i}") == _payload(i, 16384)
    finally:
        cluster.shutdown()
    assert mesh_dispatch.get_mesh() is None
    assert pc.get("mesh_encode") > before


@limited(150)
def test_dcn_hosts3_mid_op_host_kill_retried_to_completion():
    """DCN at 3 hosts serving live cluster ops, one host hard-killed
    mid-run: the codec dispatcher fails over to the single-host route,
    every op completes, no verify failure, exactly-once accounting."""
    from ceph_tpu_torch.loadgen import LoadCluster, WorkloadSpec, run_spec
    from ceph_tpu_torch.loadgen.faults import FaultEvent, FaultSchedule

    pc = dispatch_counters()
    before_enc, before_fb = pc.get("dcn_encode"), pc.get("dcn_fallback")
    cluster = LoadCluster(
        n_osds=6, k=3, m=2, pg_num=4, chunk_size=2048, pool="dcnpool",
        dcn_hosts=3, dcn_data_timeout=4.0, device="cpu",
    )
    try:
        assert cluster.dcn.backend == "gloo"
        spec = WorkloadSpec(
            mix={"seq_write": 2, "read": 1}, object_size=12288,
            max_objects=8, queue_depth=6, total_ops=24, seed=0xDC4,
        )
        faults = FaultSchedule([FaultEvent(at_op=8, action="dcn_kill")])
        report = run_spec(cluster, spec, faults)
        assert not cluster.dcn_live()
    finally:
        cluster.shutdown()
    assert report["errors"] == 0, report.get("error_samples")
    assert report["verify_failures"] == 0
    assert report["exactly_once"]
    assert pc.get("dcn_encode") > before_enc
    assert pc.get("dcn_fallback") > before_fb
