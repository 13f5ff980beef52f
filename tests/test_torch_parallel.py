"""The port's multi-device tier against ceph_tpu's, on the CPU.

Mirrors ``tests/test_parallel.py`` and ``tests/test_mesh_pipeline.py``.
The reference runs on its 8 forced CPU devices (``tests/conftest.py``);
the port runs on ``["cpu"] * n`` named explicitly, the same (dp, sp)
geometry, and every mesh op's output — ``sharded_encode``,
``sharded_decode``, ``ring_parity``, ``sharded_pipeline_step``,
``sharded_crc32c`` (odd sp axes and ragged lengths included) — is
compared byte for byte with the reference's on the same numpy inputs.
The codec's mesh route (``mesh_encode`` / ``mesh_decode`` /
``mesh_delta`` / ``mesh_fallback``, ``ec_use_mesh``) is held to the
single-device route, through ``ShardExtentMap`` and a live socket
cluster.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ceph_tpu import parallel as ref_par  # noqa: E402
from ceph_tpu_torch import parallel as par  # noqa: E402
from ceph_tpu_torch.checksum.reference import crc32c_ref  # noqa: E402
from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters  # noqa: E402
from ceph_tpu_torch.codecs.registry import registry  # noqa: E402
from ceph_tpu_torch.gf import (  # noqa: E402
    decode_matrix,
    gf_apply_bytes_host,
    gf_matrix_to_bitmatrix,
    vandermonde_rs_matrix,
)
from ceph_tpu_torch.pipeline.shard_map import ShardExtentMap  # noqa: E402
from ceph_tpu_torch.pipeline.stripe import StripeInfo  # noqa: E402
from test_torch_dcn import time_limit  # noqa: E402


def _mesh(n, k):
    return par.make_ec_mesh(n, k=k, devices=["cpu"] * n)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _snap():
    pc = dispatch_counters()
    return {k: pc.get(k) for k in pc.dump()}


def _delta(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


class TestMakeEcMesh:
    @pytest.mark.parametrize("n,k", [(8, 8), (8, 4), (5, 8), (6, 8),
                                     (6, 6), (4, 8), (2, 2), (1, 8)])
    def test_geometry_equals_the_reference(self, n, k):
        mesh = _mesh(n, k)
        ref = ref_par.make_ec_mesh(n, k=k)
        assert mesh.shape == dict(ref.shape)
        assert mesh.logical == (n > 1)

    def test_requesting_too_many_physical_devices_raises(self):
        with pytest.raises(ValueError, match="requested"):
            par.make_ec_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="requested"):
            par.make_ec_mesh(9, devices=["cpu"] * 8)

    def test_default_takes_the_physical_devices(self):
        mesh = par.make_ec_mesh(device="cpu")
        assert mesh.shape == {"dp": 1, "sp": 1} and not mesh.logical

    def test_default_device_needs_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            par.make_ec_mesh()
        with pytest.raises(ValueError, match="requested"):
            par.make_ec_mesh(8)


class TestShardedEncode:
    @pytest.mark.parametrize("n_dev,k,m", [(8, 8, 4), (8, 4, 2), (4, 8, 3),
                                           (2, 2, 2), (5, 8, 4)])
    def test_parity_equals_the_reference(self, rng, n_dev, k, m):
        g = vandermonde_rs_matrix(k, m)
        bm = gf_matrix_to_bitmatrix(g[k:, :])
        mesh = _mesh(n_dev, k)
        batch = 2 * mesh.shape["dp"]
        data = rng.integers(0, 256, (batch, k, 512), np.uint8)
        got = _host(par.sharded_encode(mesh, bm, data))
        ref = np.asarray(ref_par.sharded_encode(
            ref_par.make_ec_mesh(n_dev, k=k), jnp.asarray(bm),
            jnp.asarray(data)))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, gf_apply_bytes_host(g[k:], data))

    def test_tensor_input_and_output_device(self, rng):
        g = vandermonde_rs_matrix(8, 4)
        mesh = _mesh(8, 8)
        data = torch.from_numpy(rng.integers(0, 256, (4, 8, 256), np.uint8))
        out = par.sharded_encode(mesh, gf_matrix_to_bitmatrix(g[8:]), data)
        assert out.device == mesh.out_device
        np.testing.assert_array_equal(
            out.numpy(), gf_apply_bytes_host(g[8:], data.numpy()))


class TestShardedDecode:
    @pytest.mark.parametrize("lost", [[0], [0, 1], [3, 9], [10, 11]])
    def test_reconstruct_equals_the_reference(self, rng, lost):
        k, m = 8, 4
        g = vandermonde_rs_matrix(k, m)
        mesh = _mesh(8, k)
        data = rng.integers(0, 256, (2 * mesh.shape["dp"], k, 512), np.uint8)
        chunks = np.concatenate(
            [data, gf_apply_bytes_host(g[k:], data)], axis=1)
        present = [i for i in range(k + m) if i not in lost][:k]
        d = decode_matrix(g, k, present)
        want = [i for i in lost if i < k] or list(range(k))
        dec = gf_matrix_to_bitmatrix(d[want, :])
        got = _host(par.sharded_decode(mesh, dec, chunks[:, present, :]))
        ref = np.asarray(ref_par.sharded_decode(
            ref_par.make_ec_mesh(8, k=k), jnp.asarray(dec),
            jnp.asarray(chunks[:, present, :])))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, chunks[:, want, :])


def test_pipeline_step_parity_and_csum(rng):
    k, m = 8, 4
    g = vandermonde_rs_matrix(k, m)
    bm = gf_matrix_to_bitmatrix(g[k:, :])
    mesh = _mesh(8, k)
    data = rng.integers(0, 256, (2 * mesh.shape["dp"], k, 256), np.uint8)
    out = par.sharded_pipeline_step(mesh, bm, data)
    ref = ref_par.sharded_pipeline_step(
        ref_par.make_ec_mesh(8, k=k), jnp.asarray(bm), jnp.asarray(data))
    np.testing.assert_array_equal(_host(out["parity"]),
                                  np.asarray(ref["parity"]))
    np.testing.assert_array_equal(_host(out["csum"]).astype(np.uint32),
                                  np.asarray(ref["csum"]))


class TestRingParity:
    def test_equals_allreduce_and_the_reference(self, rng):
        k, m = 8, 4
        mesh = _mesh(8, k)
        g = vandermonde_rs_matrix(k, m)
        bm = gf_matrix_to_bitmatrix(g[k:, :])
        data = rng.integers(0, 256, (4, k, 512), np.uint8)
        ring = _host(par.ring_parity(mesh, bm, data))
        np.testing.assert_array_equal(
            ring, _host(par.sharded_encode(mesh, bm, data)))
        np.testing.assert_array_equal(ring, np.asarray(ref_par.ring_parity(
            ref_par.make_ec_mesh(8, k=k), jnp.asarray(bm),
            jnp.asarray(data))))

    @pytest.mark.parametrize("n_dev,k,m,lanes", [
        (6, 6, 2, 256),   # odd sp axis: 2 x 3
        (6, 6, 2, 257),   # lanes not splitting into sp slices
        (8, 8, 4, 1000),  # 1000 % 4 == 0, uneven against 512
    ])
    def test_odd_axes_and_lanes(self, rng, n_dev, k, m, lanes):
        mesh = _mesh(n_dev, k)
        assert mesh.shape["sp"] > 1
        g = vandermonde_rs_matrix(k, m)
        bm = gf_matrix_to_bitmatrix(g[k:, :])
        data = rng.integers(0, 256, (mesh.shape["dp"], k, lanes), np.uint8)
        got = _host(par.ring_parity(mesh, bm, data))
        ref = np.asarray(ref_par.ring_parity(
            ref_par.make_ec_mesh(n_dev, k=k), jnp.asarray(bm),
            jnp.asarray(data)))
        np.testing.assert_array_equal(got, ref)

    def test_every_hop_is_a_copy(self, rng, monkeypatch):
        """The ring runs its 2(sp-1) hops per dp row even when every
        logical device is the one CPU."""
        from ceph_tpu_torch.parallel import collectives, mesh as mesh_mod

        hops = []
        orig = mesh_mod.copy_to

        def counted(x, dev):
            hops.append(tuple(x.shape))
            return orig(x, dev)

        monkeypatch.setattr(collectives, "copy_to", counted)
        mesh = _mesh(8, 8)  # dp 2 x sp 4
        g = vandermonde_rs_matrix(8, 4)
        data = rng.integers(0, 256, (2, 8, 512), np.uint8)
        par.ring_parity(mesh, gf_matrix_to_bitmatrix(g[8:]), data)
        # 2 dp rows x 2 phases x 3 steps x 4 devices, one 128-lane slice
        assert hops == [(1, 4, 128)] * (2 * 2 * 3 * 4)


class TestShardedCrc:
    def _ref(self, data, init, n_dev=8, k=8):
        return np.asarray(ref_par.sharded_crc32c(
            ref_par.make_ec_mesh(n_dev, k=k), jnp.asarray(data), init=init))

    def test_equals_the_reference(self, rng):
        mesh = _mesh(8, 8)
        data = rng.integers(0, 256, (6, 8 * 2048), np.uint8)
        got = _host(par.sharded_crc32c(mesh, data)).astype(np.uint32)
        np.testing.assert_array_equal(got, self._ref(data, 0xFFFFFFFF))
        assert list(got) == [crc32c_ref(0xFFFFFFFF, r.tobytes())
                             for r in data]

    @pytest.mark.parametrize("init", [0xDEADBEEF, 0, 1])
    def test_nonstandard_init(self, rng, init):
        mesh = _mesh(8, 8)
        data = rng.integers(0, 256, (3, 4 * 1024), np.uint8)
        got = _host(par.sharded_crc32c(mesh, data, init=init))
        np.testing.assert_array_equal(got.astype(np.uint32),
                                      self._ref(data, init))

    @pytest.mark.parametrize("total", [4097, 1000, 8 * 64 + 1, 1, 200_003])
    def test_ragged_lengths(self, rng, total):
        mesh = _mesh(8, 8)
        data = rng.integers(0, 256, (2, total), np.uint8)
        got = _host(par.sharded_crc32c(mesh, data)).astype(np.uint32)
        np.testing.assert_array_equal(got, self._ref(data, 0xFFFFFFFF))

    def test_one_axis_and_odd_mesh(self, rng):
        data = rng.integers(0, 256, (2, 9999), np.uint8)
        want = [crc32c_ref(7, r.tobytes()) for r in data]
        for mesh, axes in ((_mesh(8, 8), ("sp",)), (_mesh(6, 6), ("dp",)),
                           (_mesh(5, 8), ("dp", "sp"))):
            got = _host(par.sharded_crc32c(mesh, data, init=7, axes=axes))
            assert list(got) == want, (mesh, axes)


# -- the codec's mesh route (test_mesh_pipeline mirrors) -----------------
@pytest.fixture
def mesh8():
    return _mesh(8, 8)


def test_mesh_encode_decode_delta_bit_exact(rng, mesh8):
    codec = registry.factory("isa", {"k": "8", "m": "4"}, device="cpu")
    data = {i: rng.integers(0, 256, (4, 4096), np.uint8) for i in range(8)}
    parity_ref = codec.encode_chunks(data)
    before = _snap()
    with par.use_mesh(mesh8):
        parity = codec.encode_chunks(data)
        chunks = {**data, **{k: _host(v) for k, v in parity.items()}}
        del chunks[1], chunks[6]
        out = codec.decode_chunks({1, 6}, chunks)
        deltas = {0: rng.integers(0, 256, (4, 4096), np.uint8)}
        new_parity = codec.apply_delta(
            deltas, {8 + j: _host(parity[8 + j]) for j in range(4)})
    moved = _delta(before, _snap())
    assert moved.get("mesh_encode") == 1, moved
    assert moved.get("mesh_decode") == 1, moved
    assert moved.get("mesh_delta") == 1, moved
    for j in range(4):
        np.testing.assert_array_equal(_host(parity[8 + j]),
                                      _host(parity_ref[8 + j]))
    np.testing.assert_array_equal(_host(out[1]), data[1])
    np.testing.assert_array_equal(_host(out[6]), data[6])
    patched = dict(data)
    patched[0] = np.bitwise_xor(data[0], deltas[0])
    reref = codec.encode_chunks(patched)
    for j in range(4):
        np.testing.assert_array_equal(_host(new_parity[8 + j]),
                                      _host(reref[8 + j]))


def test_mesh_outranks_the_host_shortcut_and_schedule(rng, mesh8):
    """Small host ops (under ec_host_dispatch_bytes) and 0/1 matrices
    (the schedule kernel's) ride the mesh once one is installed; the
    packet family applies its 0/1 matrix as a byte matrix per cell."""
    for plugin, profile in (
        ("isa", {"k": "4", "m": "2"}),
        ("jerasure", {"technique": "liberation", "k": "6", "m": "2",
                      "w": "7"}),
        ("xor", {"k": "3"}),
    ):
        codec = registry.factory(plugin, profile, device="cpu")
        k = codec.get_data_chunk_count()
        n = codec.get_chunk_size(k * 1024)
        data = {i: rng.integers(0, 256, (2, n), np.uint8) for i in range(k)}
        want = codec.encode_chunks(dict(data))
        before = _snap()
        with par.use_mesh(mesh8):
            got = codec.encode_chunks(dict(data))
        moved = _delta(before, _snap())
        assert moved == {"mesh_encode": 1}, (plugin, moved)
        for j in want:
            np.testing.assert_array_equal(_host(got[j]), _host(want[j]))


def test_mesh_fallback_when_nothing_splits_over_dp(rng):
    """A shape the mesh cannot take counts mesh_fallback and is served
    on the single-device route (here the plain kernel form: the host
    shortcut is off); under the host threshold it keeps the shortcut."""
    from ceph_tpu_torch.utils import config

    mesh = _mesh(6, 2)  # dp 3 x sp 2
    codec = registry.factory("isa", {"k": "4", "m": "2"}, device="cpu")
    data = {i: rng.integers(0, 256, (2, 4096), np.uint8) for i in range(4)}
    want = codec.encode_chunks(dict(data))
    before = _snap()
    with par.use_mesh(mesh), config.override(ec_host_dispatch_bytes=0):
        got = codec.encode_chunks(dict(data))  # 2 stripes, 4096 lanes % 3
    moved = _delta(before, _snap())
    assert moved == {"mesh_fallback": 1, "plain_encode": 1}, moved
    before = _snap()
    with par.use_mesh(mesh):
        codec.encode_chunks(dict(data))
    assert _delta(before, _snap()) == {"host_encode": 1}
    for j in want:
        np.testing.assert_array_equal(_host(got[j]), _host(want[j]))


def test_mesh_disable_via_config(rng, mesh8):
    from ceph_tpu_torch.utils import config

    codec = registry.factory("isa", {"k": "4", "m": "2"}, device="cpu")
    data = {i: rng.integers(0, 256, (2, 4096), np.uint8) for i in range(4)}
    with config.override(ec_use_mesh=False):
        before = _snap()
        with par.use_mesh(mesh8):
            codec.encode_chunks(data)
    assert _delta(before, _snap()).get("mesh_encode", 0) == 0


def test_mesh_shard_extent_map_rmw(mesh8):
    codec = registry.factory("isa", {"k": "8", "m": "4"}, device="cpu")
    sinfo = StripeInfo(8, 4, 8 * 4096)

    def build(with_mesh: bool):
        smap = ShardExtentMap(sinfo)
        r = np.random.default_rng(7)
        for raw in range(8):
            smap.insert(sinfo.get_shard(raw), 0,
                        r.integers(0, 256, 2 * 4096, dtype=np.uint8))
        if with_mesh:
            with par.use_mesh(mesh8):
                smap.encode(codec)
        else:
            smap.encode(codec)
        return smap

    ref = build(False)
    before = _snap()
    got = build(True)
    assert _delta(before, _snap()).get("mesh_encode", 0) >= 1
    for j in range(4):
        s = sinfo.get_shard(8 + j)
        np.testing.assert_array_equal(got.get(s, 0, 2 * 4096),
                                      ref.get(s, 0, 2 * 4096))
    lost = {sinfo.get_shard(2), sinfo.get_shard(5)}
    dec = ShardExtentMap(sinfo)
    for raw in range(12):
        s = sinfo.get_shard(raw)
        if s not in lost:
            dec.insert(s, 0, ref.get(s, 0, 2 * 4096))
    before = _snap()
    with par.use_mesh(mesh8):
        dec.decode(codec, lost, 8 * 2 * 4096)
    assert _delta(before, _snap()).get("mesh_decode", 0) >= 1
    for s in lost:
        np.testing.assert_array_equal(dec.get(s, 0, 2 * 4096),
                                      ref.get(s, 0, 2 * 4096))


def test_mesh_cluster_roundtrip(rng):
    from ceph_tpu_torch.cluster import Monitor, OSDDaemon, RadosClient

    mesh = _mesh(8, 4)
    mon = Monitor(device="cpu")
    daemons = []
    for i in range(6):
        mon.osd_crush_add(i, zone=f"z{i % 3}")
    for i in range(6):
        d = OSDDaemon(i, mon, chunk_size=1024, device="cpu")
        d.start()
        daemons.append(d)
    mon.osd_erasure_code_profile_set(
        "rs42", {"plugin": "isa", "k": "4", "m": "2"})
    mon.osd_pool_create("meshpool", 8, "rs42")
    client = RadosClient(mon, backoff=0.01)
    par.set_mesh(mesh)
    try:
        with time_limit(120):
            _cluster_roundtrip(rng, client, daemons)
    finally:
        par.set_mesh(None)
        client.shutdown()
        for d in daemons[1:]:
            d.stop()


def _cluster_roundtrip(rng, client, daemons):
    """Write and read back, then a degraded read with osd.0 stopped."""
    io = client.open_ioctx("meshpool")
    payload = rng.integers(0, 256, 2 * 4 * 1024, dtype=np.uint8).tobytes()
    before = _snap()
    io.write("obj", payload)
    assert io.read("obj") == payload
    assert _delta(before, _snap()).get("mesh_encode", 0) >= 1
    daemons[0].stop()
    before = _snap()
    assert io.read("obj") == payload
    assert _delta(before, _snap()).get("mesh_decode", 0) >= 1
