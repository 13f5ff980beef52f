"""The port's streaming dispatcher (``pipeline/dispatcher.py``) and its
ring routes in ``ShardExtentMap``, the bit-plane leftovers
(``ops/bitplane.py``) and the ``example`` plugin, against ``ceph_tpu``,
byte for byte (tolerance 0), on the CPU (``device="cpu"``: the codec's
plain forms serve each batch).

The dispatcher cases mirror ``tests/test_stream_dispatch.py`` and the
ring-level legs of ``tests/test_coalesce.py``: solo equivalence,
concurrent batching, shape grouping, oversized ops, batch error
isolation (a codec that refuses multi-op batches, in the manner of
``_FlakyBatchCodec``), the solo fallback's error delivery, and a fused
csum batch equal to the per-op fused call. Every parity and csum is also
held to ``ceph_tpu``'s codec on the same inputs. The cluster legs of
``tests/test_coalesce.py`` run on a port ``LoadCluster`` (5 OSDs, EC(3,2),
one PG): coalesced writes equal to the solo path's and to ``ceph_tpu``'s
coalesced stores, a failed op isolated in its tick batch, and the async
objecter's window, counters, callbacks and errors. Every test shuts the
dispatchers down in a fixture, and every thread join and wait has a
timeout.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu.codecs import registry as ref_registry  # noqa: E402
from ceph_tpu_torch import native  # noqa: E402
from ceph_tpu_torch.codecs import registry  # noqa: E402
from ceph_tpu_torch.pipeline import dispatcher  # noqa: E402
from ceph_tpu_torch.pipeline.dispatcher import (  # noqa: E402
    _HDR,
    StreamingDispatcher,
    _stream_counters,
)
from ceph_tpu_torch.utils import config  # noqa: E402

WAIT = 30  # seconds: every join and wait of these tests


@pytest.fixture(autouse=True)
def _dispatchers():
    if not native.available():
        pytest.skip("no C++ toolchain: the ring is native")
    yield
    dispatcher.shutdown_all()


@pytest.fixture
def codec():
    return registry.factory("isa", {"k": "4", "m": "2"}, device="cpu")


def _ref_parity(data, k=4, m=2):
    """ceph_tpu's parity of one [k, L] op (its host route)."""
    ref = ref_registry.factory("isa", {"k": str(k), "m": str(m)})
    parity = ref.encode_chunks({i: np.asarray(data[i]) for i in range(k)})
    return np.stack([np.asarray(parity[k + j]) for j in range(m)])


def _run_threads(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads), "a producer hung"


def _bounded(fn, *args):
    """``fn(*args)`` on a thread of its own, joined with WAIT: a wait
    that never ends fails the test instead of hanging it. Returns what
    ``fn`` returned, or raises what it raised."""
    out: list = []

    def run():
        try:
            out.append((True, fn(*args)))
        except BaseException as e:  # re-raised on the test's thread
            out.append((False, e))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=WAIT)
    assert not t.is_alive(), "a wait hung"
    ok, val = out[0]
    if not ok:
        raise val
    return val


def _stage(disp, ops, base):
    """Slots for ``ops`` [(k, nc, cs, cb, payload)] registered as pending
    on ``disp``; their results land in the returned dict by index."""
    results: dict[int, object] = {}
    slots = []
    with disp._lock:
        for idx, (k, nc, cs, cb, payload) in enumerate(ops):
            disp._pending[base + idx] = (
                lambda r, i=idx: results.__setitem__(i, r), k, nc * cs,
            )
            slots.append(_HDR.pack(base + idx, k, nc, cs, cb)
                         + np.ascontiguousarray(payload).tobytes())
    return results, slots


def test_single_op_roundtrip(rng, codec):
    d = StreamingDispatcher(codec)
    try:
        data = rng.integers(0, 256, (4, 8192), np.uint8)
        np.testing.assert_array_equal(_bounded(d.encode_sync, data),
                                      _ref_parity(data))
    finally:
        d.stop()


def test_concurrent_ops_batch_and_match(rng, codec):
    """Many threads submit concurrently; every result is bit-exact and
    at least some ops shared a launch (the whole point)."""
    d = StreamingDispatcher(codec, window_s=0.002)
    pc = _stream_counters()
    before = pc.get("batched_ops")
    try:
        datas = [rng.integers(0, 256, (4, 4096), np.uint8) for _ in range(48)]
        outs: list = [None] * 48

        def worker(i):
            outs[i] = d.encode_sync(datas[i])

        _run_threads(worker, 48)
        for i in range(48):
            np.testing.assert_array_equal(outs[i], _ref_parity(datas[i]))
        assert pc.get("batched_ops") > before, "nothing batched"
    finally:
        d.stop()


def test_mixed_shapes_group_separately(rng, codec):
    d = StreamingDispatcher(codec, window_s=0.002)
    try:
        datas = [rng.integers(0, 256, (4, n), np.uint8) for n in (4096, 8192)]
        results: list = [None, None]

        def worker(i):
            results[i] = d.encode_sync(datas[i])

        _run_threads(worker, 2)
        for i in range(2):
            np.testing.assert_array_equal(results[i], _ref_parity(datas[i]))
    finally:
        d.stop()


def test_oversized_op_rejected(codec):
    d = StreamingDispatcher(codec, slot_bytes=4096)
    try:
        with pytest.raises(ValueError):
            d.submit(np.zeros((4, 4096), np.uint8), lambda p: None)
    finally:
        d.stop()


def test_stopped_dispatcher_refuses(codec):
    d = StreamingDispatcher(codec)
    d.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        d.submit(np.zeros((4, 64), np.uint8), lambda p: None)


class _FlakyBatchCodec:
    """Delegates to a real codec but refuses multi-op batches — the
    dispatcher must retry each member solo through this same codec."""

    def __init__(self, codec) -> None:
        self._codec = codec
        self.k = codec.k
        self.m = codec.m
        self.device = codec.device
        self._encode_bmat_np = codec._encode_bmat_np
        self.calls: list[int] = []

    def get_sub_chunk_count(self) -> int:
        return 1

    def encode_chunks(self, data):
        rows = next(iter(data.values())).shape[0]
        self.calls.append(rows)
        if rows > 1:
            raise RuntimeError("injected batch fault")
        return self._codec.encode_chunks(data)

    def encode_chunks_with_csums(self, data, cb):
        rows = next(iter(data.values())).shape[0]
        self.calls.append(rows)
        if rows > 1:
            raise RuntimeError("injected batch fault")
        return self._codec.encode_chunks_with_csums(data, cb)


def test_ring_solo_fallback_isolates_batch_fault(rng):
    """A failed multi-op launch retries each member SOLO through the same
    codec: every op still gets correct parity, and the batch_faults /
    solo_retries counters tick. Driven through _fire directly so the
    batch composition is deterministic."""
    codec = registry.factory("isa", {"k": "3", "m": "2"}, device="cpu")
    flaky = _FlakyBatchCodec(codec)
    disp = StreamingDispatcher(flaky)
    try:
        pc = _stream_counters()
        before = (pc.get("batch_faults"), pc.get("solo_retries"))
        payloads = [rng.integers(0, 256, (3, 4096), np.uint8)
                    for _ in range(3)]
        results, slots = _stage(
            disp, [(3, 1, 4096, 0, p) for p in payloads], 1000)
        disp._fire(slots)
        assert set(results) == {0, 1, 2}
        for idx, p in enumerate(payloads):
            got = results[idx]
            assert not isinstance(got, Exception), got
            np.testing.assert_array_equal(got, _ref_parity(p, 3, 2))
        assert flaky.calls == [3, 1, 1, 1]
        after = (pc.get("batch_faults"), pc.get("solo_retries"))
        assert after == (before[0] + 1, before[1] + 3)
    finally:
        disp.stop()


def test_solo_failure_reaches_its_waiter(rng):
    """An op that fails alone delivers its error to its own waiter: the
    encode_sync caller re-raises it, nobody hangs."""

    class _Broken(_FlakyBatchCodec):
        def encode_chunks(self, data):
            raise RuntimeError("kernel launch failed")

    codec = registry.factory("isa", {"k": "3", "m": "2"}, device="cpu")
    disp = StreamingDispatcher(_Broken(codec))
    try:
        errors: list = []

        def worker(_):
            try:
                disp.encode_sync(np.zeros((3, 4096), np.uint8))
            except RuntimeError as e:
                errors.append(str(e))

        _run_threads(worker, 4)
        assert errors == ["kernel launch failed"] * 4
    finally:
        disp.stop()


def test_drain_failure_reaches_its_waiter(monkeypatch, codec):
    """A fault in the drain loop's own bookkeeping fails the ops of that
    iteration to their waiters; the loop keeps serving."""
    disp = StreamingDispatcher(codec)
    try:
        real = disp._fire
        monkeypatch.setattr(disp, "_fire", lambda slots: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            _bounded(disp.encode_sync, np.zeros((4, 64), np.uint8))
        monkeypatch.setattr(disp, "_fire", real)
        data = np.arange(4 * 64, dtype=np.uint8).reshape(4, 64)
        np.testing.assert_array_equal(_bounded(disp.encode_sync, data),
                                      _ref_parity(data))
    finally:
        disp.stop()


@pytest.mark.parametrize("counts", [(1, 2), (3, 1, 2)])
def test_ring_fused_csum_batch_matches_per_op(rng, counts):
    """Fused encode+csum ops stacked into one ring batch produce the same
    parity AND per-block csums as the per-op fused call, and as
    ceph_tpu's fused call (its Pallas kernel in interpret mode)."""
    from ceph_tpu.utils import config as ref_config

    codec = registry.factory("isa", {"k": "2", "m": "1"}, device="cpu")
    ref = ref_registry.factory("isa", {"k": "2", "m": "1"})
    disp = StreamingDispatcher(codec)
    try:
        cs, cb = 2048, 512
        ops = [rng.integers(0, 256, (2, nc, cs), np.uint8) for nc in counts]
        results, slots = _stage(
            disp, [(2, nc, cs, cb, chunks.reshape(2, nc * cs))
                   for nc, chunks in zip(counts, ops)], 2000)
        disp._fire(slots)
        with ref_config.override(ec_fused_csum=True, ec_use_pallas=True,
                                 ec_fused_csum_interpret=True):
            for idx, chunks in enumerate(ops):
                parity2d, csums = results[idx]
                pm, want_csums = codec.encode_chunks_with_csums(
                    {i: chunks[i] for i in range(2)}, cb)
                nc = chunks.shape[1]
                want = pm[2].numpy().reshape(1, nc * cs)
                np.testing.assert_array_equal(parity2d, want)
                np.testing.assert_array_equal(csums, want_csums)
                rpm, rcsums = ref.encode_chunks_with_csums(
                    {i: chunks[i] for i in range(2)}, cb)
                np.testing.assert_array_equal(
                    parity2d, np.asarray(rpm[2]).reshape(1, nc * cs))
                np.testing.assert_array_equal(csums, np.asarray(rcsums))
    finally:
        disp.stop()


def test_fused_geometry_outside_the_contract_is_a_clean_refusal(rng):
    codec = registry.factory("isa", {"k": "2", "m": "1"}, device="cpu")
    disp = StreamingDispatcher(codec)
    try:
        data = rng.integers(0, 256, (2, 2 * 1000), np.uint8)
        assert _bounded(disp.encode_csum_sync, data, 300, 2) == (None, None)
    finally:
        disp.stop()


def test_dispatcher_for_shares_one_ring_per_signature():
    a = registry.factory("isa", {"k": "4", "m": "2"}, device="cpu")
    b = registry.factory("isa", {"k": "4", "m": "2"}, device="cpu")
    c = registry.factory("isa", {"k": "5", "m": "2"}, device="cpu")
    assert dispatcher.dispatcher_for(a) is dispatcher.dispatcher_for(b)
    assert dispatcher.dispatcher_for(a) is not dispatcher.dispatcher_for(c)


_LIB = {"technique": "liberation", "k": "4", "m": "2"}
_LRC = {"mapping": "__DD__DD",
        "layers": '[["_cDD_cDD",""],["cDDD____",""],["____cDDD",""]]'}


@pytest.mark.parametrize("plugin,a,b", [
    ("jerasure", {**_LIB, "w": "7"}, {**_LIB, "w": "11"}),
    ("jerasure", _LIB, {**_LIB, "construction": "v0"}),
    ("jerasure", {**_LIB, "technique": "blaum_roth", "w": "4"},
     {**_LIB, "technique": "blaum_roth", "w": "6"}),
    ("lrc", _LRC, {**_LRC, "layers": _LRC["layers"].replace(
        '""]', '"technique=cauchy_good"]', 1)}),
], ids=["liberation-w", "liberation-construction", "blaum_roth-w",
        "lrc-layers"])
def test_dispatcher_for_keys_on_the_applied_matrix(rng, plugin, a, b):
    """Two pools of one class and one k, m whose codecs apply different
    matrices (a bit-matrix w or construction, an LRC layer) get rings
    of their own, and a ring encode of each equals ceph_tpu's parity
    under the same profile; a shared ring would serve the second pool
    with the first pool's codec."""
    codecs = [registry.factory(plugin, p, device="cpu") for p in (a, b)]
    assert codecs[0].k == codecs[1].k and codecs[0].m == codecs[1].m
    assert (dispatcher.dispatcher_for(codecs[0])
            is not dispatcher.dispatcher_for(codecs[1]))
    k, m = codecs[0].k, codecs[0].m
    # one length every w here divides (4, 6, 7, 11), so either codec
    # could take the op
    data = rng.integers(0, 256, (k, 4 * 3 * 7 * 11 * 32), np.uint8)
    for prof, codec in zip((a, b), codecs):
        got = _bounded(dispatcher.dispatcher_for(codec).encode_sync, data)
        ref = ref_registry.factory(plugin, dict(prof))
        want = ref.encode_chunks({i: data[i] for i in range(k)})
        np.testing.assert_array_equal(
            got, np.stack([np.asarray(want[k + j]) for j in range(m)]))


def test_coalescing_scope_and_streaming_gate():
    assert not dispatcher.coalescing_active()
    with dispatcher.coalescing_scope():
        with dispatcher.coalescing_scope():
            assert dispatcher.coalescing_active()
        assert dispatcher.coalescing_active()
    assert not dispatcher.coalescing_active()
    assert not dispatcher.streaming_enabled()  # the default: off
    with config.override(ec_streaming_dispatch=True):
        assert dispatcher.streaming_enabled()


def _smap(pkg, sinfo, codec, cb=None, **kw):
    smap = pkg.ShardExtentMap(sinfo)
    r = np.random.default_rng(11)
    for raw in range(4):
        smap.insert(sinfo.get_shard(raw), 0,
                    r.integers(0, 256, 8192, dtype=np.uint8))
    smap.encode(codec, csum_block=cb)
    return smap


@pytest.mark.parametrize("route", ["streaming", "scope"])
@pytest.mark.parametrize("cb", [None, 4096])
def test_pipeline_routes_through_dispatcher(route, cb):
    """ec_streaming_dispatch on, or a coalescing scope: ShardExtentMap.
    encode rides the ring (the ops counter moves) and its parity and
    csums equal ceph_tpu's per-op encode of the same map."""
    from ceph_tpu.utils import config as ref_config
    from test_torch_rmw import PORT, REF

    ref_codec = REF.registry.factory("isa", {"k": "4", "m": "2"})
    sinfo_ref = REF.StripeInfo(4, 2, 4 * 4096)
    with ref_config.override(ec_fused_csum=True, ec_use_pallas=True,
                             ec_fused_csum_interpret=True):
        ref = _smap(REF, sinfo_ref, ref_codec, cb)
    codec = registry.factory("isa", {"k": "4", "m": "2"}, device="cpu")
    sinfo = PORT.StripeInfo(4, 2, 4 * 4096)
    pc = _stream_counters()
    before = pc.get("ops")

    def encode():
        # the scope is per thread: entered on the thread that encodes
        if route == "streaming":
            with config.override(ec_streaming_dispatch=True):
                return _smap(PORT, sinfo, codec, cb)
        with dispatcher.coalescing_scope():
            return _smap(PORT, sinfo, codec, cb)

    got = _bounded(encode)
    assert pc.get("ops") == before + 1
    for j in range(2):
        s = sinfo.get_shard(4 + j)
        np.testing.assert_array_equal(got.get(s, 0, 8192),
                                      ref.get(s, 0, 8192))
    if cb is None:
        assert got.csums is None
    else:
        assert got.csums["block"] == ref.csums["block"] == cb
        assert got.csums["shards"].keys() == ref.csums["shards"].keys()
        for s, (lo, vals) in got.csums["shards"].items():
            rlo, rvals = ref.csums["shards"][s]
            assert lo == rlo
            np.testing.assert_array_equal(vals, np.asarray(rvals))


def test_ring_skips_ops_beyond_a_slot_and_subchunk_codecs():
    from ceph_tpu_torch.pipeline.shard_map import ShardExtentMap

    codec = registry.factory("isa", {"k": "4", "m": "2"}, device="cpu")
    clay = registry.factory("clay", {"k": "4", "m": "2", "d": "5"},
                            device="cpu")
    with config.override(ec_streaming_dispatch=True):
        slot = dispatcher.dispatcher_for(codec).max_op_bytes
        assert ShardExtentMap._ring_routable(codec, slot)
        assert not ShardExtentMap._ring_routable(codec, slot + 1)
        assert not ShardExtentMap._ring_routable(clay, 1024)
    assert not ShardExtentMap._ring_routable(codec, 1024)


# -- the bit-plane leftovers ----------------------------------------------
@pytest.mark.parametrize("shape", [(3, 17), (2, 4, 33), (1, 1)])
def test_lane_bits_match_reference(rng, shape):
    import jax.numpy as jnp
    from ceph_tpu.ops import bitplane as ref_bp
    from ceph_tpu_torch.ops import bitplane

    x = rng.integers(0, 256, shape, dtype=np.uint8)
    bits = bitplane.unpack_bits_lanes(torch.from_numpy(x))
    assert np.array_equal(
        bits.numpy(), np.asarray(ref_bp.unpack_bits_lanes(jnp.asarray(x))))
    assert np.array_equal(bitplane.pack_bits_lanes(bits).numpy(), x)


@pytest.mark.parametrize("w,p", [(7, 16), (8, 33)])
def test_packet_mod2_apply_matches_reference(rng, w, p):
    import jax.numpy as jnp
    from ceph_tpu.ops import bitplane as ref_bp
    from ceph_tpu_torch.ops import bitplane

    k, m = 3, 2
    bm = rng.integers(0, 2, (m * w, k * w), dtype=np.uint8)
    packets = rng.integers(0, 256, (2, k * w, p), dtype=np.uint8)
    got = bitplane.packet_mod2_apply(bm, torch.from_numpy(packets)).numpy()
    want = np.asarray(ref_bp.packet_mod2_apply(jnp.asarray(bm),
                                               jnp.asarray(packets)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("c", [0, 1, 2, 0x53, 0xFF])
@pytest.mark.parametrize("shape", [(4095,), (3, 2, 17)])
def test_gf_mul_const_bytes_matches_reference(rng, c, shape):
    import jax.numpy as jnp
    from ceph_tpu.ops import bitplane as ref_bp
    from ceph_tpu_torch.gf.tables import gf_mul_bytes
    from ceph_tpu_torch.ops import bitplane

    x = rng.integers(0, 256, shape, dtype=np.uint8)
    got = bitplane.gf_mul_const_bytes(c, torch.from_numpy(x)).numpy()
    assert np.array_equal(
        got, np.asarray(ref_bp.gf_mul_const_bytes(c, jnp.asarray(x))))
    assert np.array_equal(got, gf_mul_bytes(c, x))


def test_gf_mul_const_bytes_is_kernel_a_on_a_device_tensor():
    """On a device tensor it goes to Kernel A's wrapper, never to a
    library product (a meta tensor reaches the wrapper's device check)."""
    from ceph_tpu_torch.ops import bitplane

    meta = torch.empty((2, 4096), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bitplane.gf_mul_const_bytes(3, meta)


# -- the example plugin ----------------------------------------------------
def test_example_plugin_matches_reference(rng):
    port = registry.factory("example", {"k": "4"}, device="cpu")
    ref = ref_registry.factory("example", {"k": "4"})
    assert "example" in registry.names()
    data = rng.integers(0, 256, (4, 256), np.uint8)
    payload = rng.integers(0, 256, 1000, np.uint8).tobytes()
    assert port.encode(payload) == ref.encode(payload)
    for form in (lambda a: a, torch.from_numpy):
        parity = port.encode_chunks({i: form(data[i]) for i in range(4)})
        ref_parity = ref.encode_chunks({i: data[i] for i in range(4)})
        assert np.array_equal(np.asarray(parity[4]),
                              np.asarray(ref_parity[4]))
        chunks = {i: form(data[i]) for i in range(4)}
        chunks[4] = parity[4]
        for lost in range(5):
            have = {i: c for i, c in chunks.items() if i != lost}
            out = port.decode_chunks({lost}, have)
            assert np.array_equal(np.asarray(out[lost]),
                                  np.asarray(chunks[lost])), lost
    with pytest.raises(ValueError):
        port.decode_chunks({0, 1}, {2: data[2], 3: data[3]})
    old, new = data[1], data[2]
    delta = port.encode_delta(old, new)
    assert np.array_equal(delta, np.asarray(ref.encode_delta(old, new)))
    applied = port.apply_delta({1: delta}, {4: np.asarray(parity[4])})
    ref_applied = ref.apply_delta({1: delta}, {4: ref_parity[4]})
    assert np.array_equal(np.asarray(applied[4]), np.asarray(ref_applied[4]))
    with pytest.raises(ValueError):
        registry.factory("example", {"k": "1"}, device="cpu")


# -- the cluster legs of tests/test_coalesce.py ----------------------------
# (per-tick op coalescing on a live cluster and the async objecter; the
# sub-write batch frames are twinned in test_torch_msg.py)

def _coal_payload(i: int, size: int = 8192) -> bytes:
    return np.random.default_rng(0xC0A1 + i).integers(
        0, 256, size, np.uint8
    ).tobytes()


def _coal_boot(root="ceph_tpu_torch"):
    import importlib

    lg = importlib.import_module(f"{root}.loadgen")
    kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    return lg.LoadCluster(
        n_osds=5, k=3, m=2, pg_num=1, chunk_size=2048,
        pool="coalpool", **kw,
    )


def _coal_snapshot(cluster) -> dict:
    """(osd, oid) -> (bytes, HINFO and shard-identity attrs)."""
    out = {}
    for osd, store in cluster.stores.items():
        for oid in store.list_objects():
            attrs = {
                k: v for k, v in store.getattrs(oid).items()
                if k in ("hinfo_key", "si")
            }
            out[(osd, oid)] = (store.read(oid), attrs)
    return out


def _coal_round(coalesce: bool, root="ceph_tpu_torch"):
    """A warmup create, then 8 concurrent full-object writes queued
    behind the primary's op lock (so the coalescer sees them together),
    then 4 concurrent sub-stripe overwrites the same way."""
    import importlib

    cfg = importlib.import_module(f"{root}.utils.config").config
    n_obj, size = 8, 8192
    with cfg.override(osd_op_coalescing=coalesce):
        cluster = _coal_boot(root)
        try:
            cluster.io.write_full("warm", _coal_payload(99, 2048))
            primary = cluster.mon.osdmap.pg_primary("coalpool", 0)
            pd = cluster.daemons[primary]
            with pd._op_lock:
                comps = [
                    cluster.io.aio_write_full(f"o{i}",
                                              _coal_payload(i, size))
                    for i in range(n_obj)
                ]
            for c in comps:
                c.wait_for_complete(WAIT)
            with pd._op_lock:
                comps = [
                    cluster.io.aio_write(
                        f"o{i}", _coal_payload(100 + i, 500), offset=1000
                    )
                    for i in range(0, n_obj, 2)
                ]
            for c in comps:
                c.wait_for_complete(WAIT)
            reads = {
                f"o{i}": cluster.io.read(f"o{i}") for i in range(n_obj)
            }
            stores = _coal_snapshot(cluster)
            coalesced = sum(
                d.coalesce_pc.get("op_coalesced")
                for d in cluster.daemons.values()
            )
            subwrite_batches = sum(
                d.coalesce_pc.get("subwrite_batches")
                for d in cluster.daemons.values()
            )
            scrub_ok = cluster.scrub_clean(repair=False)
        finally:
            cluster.shutdown()
    expected = {}
    for i in range(n_obj):
        img = bytearray(_coal_payload(i, size))
        if i % 2 == 0:
            img[1000:1500] = _coal_payload(100 + i, 500)
        expected[f"o{i}"] = bytes(img)
    return reads, expected, stores, coalesced, subwrite_batches, scrub_ok


def test_coalesced_equivalence_with_solo_path():
    """Coalesced tick execution is byte-identical to one op at a time
    (objects, shard bytes, shard identity and HashInfo), deep scrub is
    clean on both, and the coalesced stores equal ceph_tpu's."""
    from test_torch_dcn import time_limit

    with time_limit(120):
        r_on = _coal_round(coalesce=True)
        r_off = _coal_round(coalesce=False)
        r_ref = _coal_round(coalesce=True, root="ceph_tpu")
    reads_on, exp_on, stores_on, coal_on, swb_on, scrub_on = r_on
    reads_off, exp_off, stores_off, coal_off, _swb, scrub_off = r_off
    assert reads_on == exp_on, "coalesced path returned wrong bytes"
    assert reads_off == exp_off, "solo path returned wrong bytes"
    assert coal_on > 0, "coalesced run never actually coalesced"
    assert swb_on > 0, "no sub-write frames were batch-packed"
    assert coal_off == 0, "coalesce=off still batched ops"
    assert scrub_on and scrub_off, "deep scrub found csum damage"
    assert set(stores_on) == set(stores_off)
    for key in stores_on:
        assert stores_on[key] == stores_off[key], key
    assert r_ref[0] == reads_on
    assert r_ref[2] == stores_on


def test_coalesced_batch_error_isolation():
    """One injected bad op inside a tick batch fails alone: its
    batch-mates commit and verify, the failed op surfaces EIO."""
    from test_torch_dcn import time_limit

    from ceph_tpu_torch.pipeline.inject import ec_inject

    ec_inject.clear_all()
    with time_limit(90), config.override(osd_op_coalescing=True):
        cluster = _coal_boot()
        try:
            cluster.io.write_full("warm", _coal_payload(99, 2048))
            pool_id = cluster.mon.osdmap.pools["coalpool"].pool_id
            ec_inject.write_error(f"{pool_id}:bad", 0, duration=1)
            primary = cluster.mon.osdmap.pg_primary("coalpool", 0)
            pd = cluster.daemons[primary]
            with pd._op_lock:
                bad = cluster.io.aio_write_full("bad", _coal_payload(7))
                goods = [
                    cluster.io.aio_write_full(f"g{i}", _coal_payload(i))
                    for i in range(5)
                ]
            with pytest.raises(IOError):
                bad.wait_for_complete(WAIT)
            for c in goods:
                c.wait_for_complete(WAIT)
            for i in range(5):
                assert cluster.io.read(f"g{i}") == _coal_payload(i), (
                    "a batch-mate of the failed op lost its write"
                )
            assert sum(
                d.coalesce_pc.get("op_coalesced")
                for d in cluster.daemons.values()
            ) > 0, "the round never rode the coalesced path"
        finally:
            cluster.shutdown()
            ec_inject.clear_all()


def test_async_objecter_window_and_counters():
    """submit_async never blocks the caller, honours the per-OSD
    in-flight window, completes everything it accepted, and exports the
    op_coalesced/batch_size pair."""
    from test_torch_dcn import time_limit

    with time_limit(90):
        cluster = _coal_boot()
        try:
            obj = cluster.client.objecter
            obj.max_inflight_per_osd = 2
            comps = [
                cluster.io.aio_write_full(f"w{i}", _coal_payload(i, 4096))
                for i in range(12)
            ]
            for c in comps:
                c.wait_for_complete(WAIT)
            for i in range(12):
                assert cluster.io.read(f"w{i}") == _coal_payload(i, 4096)
            dump = obj.perf.dump()
            assert "op_coalesced" in dump and "batch_size" in dump
            assert dump["op_completed"] >= 24
            assert dump["op_inflight"] == 0, "inflight gauge leaked"
            assert dump["op_coalesced"] > 0
            assert dump["batch_size"]["sum"] >= dump["op_coalesced"]
        finally:
            cluster.shutdown()


def test_async_objecter_callback_and_error():
    """Completions run their callbacks before waiters wake, and terminal
    errors surface on the completion, not the caller."""
    from test_torch_dcn import time_limit

    with time_limit(60):
        cluster = _coal_boot()
        try:
            fired = threading.Event()
            seen: list = []

            def cb(c) -> None:
                seen.append(c.error)
                fired.set()

            c = cluster.io.aio_write_full("cb-obj", b"x" * 512,
                                          on_complete=cb)
            c.wait_for_complete(WAIT)
            assert fired.is_set() and seen == [None]
            bad = cluster.io.aio_read("never-written")
            with pytest.raises(FileNotFoundError):
                bad.wait_for_complete(WAIT)
            assert isinstance(bad.error, FileNotFoundError)
        finally:
            cluster.shutdown()
