"""The port's clay plugin against ceph_tpu's, byte for byte (tolerance
0), on the CPU — the mirror of tests/test_clay.py: parameter validation,
sub-chunk geometry, encode/decode round trips up to m erasures and the
MSR fractional repair (bandwidth and content).

"Traced" in ceph_tpu means a jitted device program; here it means CPU
tensors, which take the tensor routes (the layered engine in torch ops,
the repair kernels' plain versions). Every tensor result is held
against the port's host path (numpy, host GF tables) and against
ceph_tpu's host and jitted results. Inputs are made with numpy from the
``rng`` fixture's seed."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu.codecs import registry as ref_registry  # noqa: E402
from ceph_tpu_torch.codecs import registry  # noqa: E402
from ceph_tpu_torch.utils import config  # noqa: E402
from ceph_tpu_torch.utils.device import to_numpy  # noqa: E402


def make(**kv):
    return registry.factory(
        "clay", {k: str(v) for k, v in kv.items()}, device="cpu")


def make_ref(**kv):
    return ref_registry.factory("clay", {k: str(v) for k, v in kv.items()})


def tensors(chunks):
    return {i: torch.from_numpy(np.ascontiguousarray(v))
            for i, v in chunks.items()}


def encode_all(codec, ref, rng, chunk_bytes, lead=()):
    """Data + parity chunks; the port's host path and ceph_tpu's agree."""
    k = codec.get_data_chunk_count()
    data = {i: rng.integers(0, 256, lead + (chunk_bytes,), dtype=np.uint8)
            for i in range(k)}
    parity = codec.encode_chunks(dict(data))
    want = ref.encode_chunks(dict(data))
    assert parity.keys() == want.keys()
    for j in want:
        assert isinstance(parity[j], np.ndarray)
        assert np.array_equal(parity[j], np.asarray(want[j]))
    return {**data, **parity}


def helpers_for(codec, chunks, lost, available):
    plan = codec.minimum_to_decode({lost}, set(available))
    sc = chunks[lost].shape[-1] // codec.get_sub_chunk_count()
    return {
        node: np.concatenate(
            [chunks[node][..., idx * sc:(idx + cnt) * sc]
             for idx, cnt in ranges], axis=-1)
        for node, ranges in plan.items()
    }


def repair_helpers(codec, chunks, lost):
    """The reference tests' helper choice: the first d survivors, or the
    last d when those miss a member of the lost chunk's group."""
    n = codec.get_chunk_count()
    available = sorted(set(range(n)) - {lost})[:codec.d]
    if not codec.is_repair({lost}, set(available)):
        available = sorted(set(range(n)) - {lost})[-codec.d:]
    return helpers_for(codec, chunks, lost, available)


class TestParse:
    def test_defaults(self):
        c = make()
        assert (c.k, c.m) == (4, 2)
        assert c.d == 5
        assert c.q == 2 and c.nu == 0 and c.t == 3
        assert c.get_sub_chunk_count() == 8

    def test_d_range(self):
        with pytest.raises(ValueError, match="value of d"):
            make(k=4, m=2, d=7)
        with pytest.raises(ValueError, match="value of d"):
            make(k=4, m=2, d=4)

    def test_bad_scalar_mds(self):
        with pytest.raises(ValueError, match="scalar_mds"):
            make(k=4, m=2, scalar_mds="bogus")

    def test_shec_inner_code_matches_reference(self, rng):
        # CLAY over SHEC(k+nu, m, c=2): same geometry and inner code as
        # ceph_tpu, and the same encode (test_torch_shec covers decode
        # and repair)
        port, ref = make(k=4, m=2, scalar_mds="shec"), make_ref(
            k=4, m=2, scalar_mds="shec")
        assert (port.q, port.t, port.nu) == (ref.q, ref.t, ref.nu)
        assert (port.mds.k, port.mds.m, port.mds.c, port.mds.technique) == (
            ref.mds.k, ref.mds.m, ref.mds.c, ref.mds.technique)
        cs = port.get_chunk_size(4 * 512)
        data = {i: rng.integers(0, 256, cs, np.uint8) for i in range(4)}
        got, want = port.encode_chunks(data), ref.encode_chunks(data)
        for j in want:
            assert np.array_equal(to_numpy(got[j]), np.asarray(want[j]))

    def test_shortening(self):
        # k=5, m=2, d=6: q=2, (k+m)%2=1 -> nu=1, t=4.
        c = make(k=5, m=2, d=6)
        assert c.nu == 1
        assert c.t == 4
        assert c.get_sub_chunk_count() == 16

    def test_flagship_geometry(self):
        # BASELINE config 4: CLAY (8,4,d=11) -> q=4, nu=0, t=3, 64 planes.
        c = make(k=8, m=4, d=11)
        assert c.q == 4 and c.nu == 0 and c.t == 3
        assert c.get_sub_chunk_count() == 64

    @pytest.mark.parametrize("k,m,d", [
        (4, 2, 5), (8, 4, 11), (8, 4, 10), (6, 3, 7), (5, 3, 7),
        (6, 4, 8), (8, 4, 9)])
    def test_geometry_matches_reference(self, k, m, d):
        port, ref = make(k=k, m=m, d=d), make_ref(k=k, m=m, d=d)
        assert (port.q, port.nu, port.t, port.sub_chunk_no) == \
            (ref.q, ref.nu, ref.t, ref.sub_chunk_no)
        assert int(port.get_flags().value) == int(ref.get_flags().value)
        for width in (1, 4096, 4 << 20, 12345):
            assert port.get_chunk_size(width) == ref.get_chunk_size(width)
        # the inner code: same generator, same pair algebra
        assert np.array_equal(port.mds.generator, ref.mds.generator)
        for known in itertools.permutations(range(4), 2):
            for want in range(4):
                if want not in known:
                    assert port._pair_coeffs(known, want) == \
                        ref._pair_coeffs(known, want)
        n = k + m
        for lost in range(n):
            for extra in [None] + list(range(n)):
                avail = set(range(n)) - {lost} - {extra}
                assert port.is_repair({lost}, avail) == \
                    ref.is_repair({lost}, avail)
                try:
                    want_plan = ref.minimum_to_decode({lost}, avail)
                except ValueError:
                    with pytest.raises(ValueError):
                        port.minimum_to_decode({lost}, avail)
                    continue
                assert port.minimum_to_decode({lost}, avail) == want_plan
        for wanted in ({0}, {0, 1}, {0, k}):
            assert port.get_repair_sub_chunk_count(wanted) == \
                ref.get_repair_sub_chunk_count(wanted)

    def test_inner_codec_takes_the_clay_device(self):
        c = make(k=8, m=4, d=11)
        assert c.device == torch.device("cpu")
        assert c.mds.device == torch.device("cpu")


class TestRoundTrip:
    @pytest.fixture
    def pair(self):
        return make(k=4, m=2, d=5), make_ref(k=4, m=2, d=5)

    @pytest.mark.parametrize("host", [True, False], ids=["numpy", "tensor"])
    def test_single_erasures(self, pair, rng, host):
        codec, ref = pair
        chunks = encode_all(codec, ref, rng, codec.get_sub_chunk_count() * 16)
        for lost in range(6):
            have = {i: v for i, v in chunks.items() if i != lost}
            out = codec.decode_chunks({lost}, have if host else tensors(have))
            assert isinstance(out[lost], np.ndarray) == host
            assert np.array_equal(to_numpy(out[lost]), chunks[lost]), lost

    @pytest.mark.parametrize("host", [True, False], ids=["numpy", "tensor"])
    def test_double_erasures(self, pair, rng, host):
        codec, ref = pair
        chunks = encode_all(codec, ref, rng, codec.get_sub_chunk_count() * 16)
        for lost in itertools.combinations(range(6), 2):
            have = {i: v for i, v in chunks.items() if i not in lost}
            out = codec.decode_chunks(
                set(lost), have if host else tensors(have))
            want = ref.decode_chunks(set(lost), dict(have))
            for s in lost:
                assert np.array_equal(to_numpy(out[s]), chunks[s]), lost
                assert np.array_equal(np.asarray(want[s]), chunks[s])

    @pytest.mark.parametrize("host", [True, False], ids=["numpy", "tensor"])
    def test_shortened_roundtrip(self, rng, host):
        codec, ref = make(k=5, m=2, d=6), make_ref(k=5, m=2, d=6)
        chunks = encode_all(codec, ref, rng, codec.get_sub_chunk_count() * 8)
        for lost in itertools.combinations(range(7), 2):
            have = {i: v for i, v in chunks.items() if i not in lost}
            out = codec.decode_chunks(
                set(lost), have if host else tensors(have))
            for s in lost:
                assert np.array_equal(to_numpy(out[s]), chunks[s]), lost

    def test_decode_leaves_the_callers_buffers(self, pair, rng):
        codec, ref = pair
        chunks = encode_all(codec, ref, rng, codec.get_sub_chunk_count() * 8)
        have = tensors({i: v for i, v in chunks.items() if i != 0})
        before = {i: v.clone() for i, v in have.items()}
        codec.decode_chunks({0}, have)
        assert all(torch.equal(have[i], before[i]) for i in have)

    def test_numpy_above_the_host_threshold_takes_tensors(self, pair, rng):
        codec, ref = pair
        chunks = encode_all(codec, ref, rng, codec.get_sub_chunk_count() * 8)
        have = {i: v for i, v in chunks.items() if i != 2}
        with config.override(ec_host_dispatch_bytes=0):
            out = codec.decode_chunks({2}, have)
        assert isinstance(out[2], torch.Tensor)
        assert np.array_equal(out[2].numpy(), chunks[2])


class TestRepair:
    @pytest.mark.parametrize("host", [True, False], ids=["numpy", "tensor"])
    @pytest.mark.parametrize("k,m,d", [(4, 2, 5), (8, 4, 11)])
    def test_repair_every_chunk(self, k, m, d, rng, host):
        codec, ref = make(k=k, m=m, d=d), make_ref(k=k, m=m, d=d)
        Z = codec.get_sub_chunk_count()
        chunks = encode_all(codec, ref, rng, Z * 8)
        n = k + m
        for lost in range(n):
            available = set(range(n)) - {lost}
            assert codec.is_repair({lost}, available)
            plan = codec.minimum_to_decode({lost}, available)
            assert len(plan) == d
            # Each helper contributes sub_chunk_no/q sub-chunks.
            per_helper = sum(c for _, c in next(iter(plan.values())))
            assert per_helper == Z // codec.q
            helper = helpers_for(codec, chunks, lost, available)
            out = codec.repair({lost}, helper if host else tensors(helper))
            assert isinstance(out[lost], np.ndarray) == host
            assert np.array_equal(to_numpy(out[lost]), chunks[lost]), lost

    def test_repair_reads_fraction(self):
        codec = make(k=8, m=4, d=11)
        Z = codec.get_sub_chunk_count()
        # MSR repair bandwidth: d helpers x Z/q sub-chunks vs k x Z for
        # naive decode — a (d/q)/k = 11/32 fraction for (8,4,11).
        repair_subchunks = codec.d * (Z // codec.q)
        naive = codec.k * Z
        assert repair_subchunks / naive == pytest.approx(11 / 32)
        plan = codec.minimum_to_decode({9}, set(range(12)) - {9})
        read = sum(c for ranges in plan.values() for _, c in ranges)
        assert read * 32 == naive * 11

    @pytest.mark.parametrize("host", [True, False], ids=["numpy", "tensor"])
    def test_repair_shortened_virtual_group(self, rng, host):
        """A lost chunk whose x-group contains shortened (virtual) nodes
        still takes the repair path — virtual nodes are always
        'available'."""
        codec, ref = make(k=6, m=4, d=8), make_ref(k=6, m=4, d=8)
        assert codec.nu == 2
        n = codec.k + codec.m
        chunks = encode_all(codec, ref, rng, codec.get_sub_chunk_count() * 4)
        for lost in range(n):
            available = set(range(n)) - {lost}
            assert codec.is_repair({lost}, available), lost
            helper = helpers_for(codec, chunks, lost, available)
            out = codec.repair({lost}, helper if host else tensors(helper))
            assert np.array_equal(to_numpy(out[lost]), chunks[lost]), lost

    def test_not_repair_when_group_missing(self):
        codec = make(k=4, m=2, d=5)
        lost = 0
        group = {
            (codec._to_node(lost) // codec.q) * codec.q + j
            for j in range(codec.q)
        }
        group_chunks = {codec._from_node(g) for g in group} - {lost}
        available = set(range(6)) - {lost} - {next(iter(group_chunks))}
        assert not codec.is_repair({lost}, available)
        # Plain decode still works through minimum_to_decode.
        plan = codec.minimum_to_decode({lost}, available)
        assert len(plan) >= codec.k

    def test_repair_wants_exactly_d_helpers(self, rng):
        codec = make(k=4, m=2, d=5)
        with pytest.raises(ValueError, match="exactly d=5"):
            codec.repair({0}, {i: np.zeros(8, np.uint8) for i in range(4)})


class TestRepairTraced:
    """Tensor repair (the kernel route on CPU tensors, and the
    whole-tensor / itemized routes with ``ec_clay_kernels`` off) is
    bit-identical to the port's host path and to ceph_tpu's host and
    jitted repair."""

    @pytest.mark.parametrize("k,m,d", [
        (4, 2, 5),    # aloof-free
        (8, 4, 11),   # aloof-free, bench geometry
        (8, 4, 10),   # one aloof node: two score groups
        (6, 3, 8),    # q=3 geometry
        (5, 3, 7),    # nu = 1: shortened virtual nodes
    ])
    def test_traced_matches_host(self, k, m, d, rng):
        import jax
        import jax.numpy as jnp

        codec, ref = make(k=k, m=m, d=d), make_ref(k=k, m=m, d=d)
        Z = codec.get_sub_chunk_count()
        chunks = encode_all(codec, ref, rng, Z * 8)
        n = k + m
        for lost in (0, k - 1, k, n - 1):
            helper = repair_helpers(codec, chunks, lost)
            host = codec.repair({lost}, dict(helper))[lost]
            assert isinstance(host, np.ndarray)
            assert np.array_equal(host, chunks[lost])
            for kernels in (True, False):
                with config.override(ec_clay_kernels=kernels):
                    out = codec.repair({lost}, tensors(helper))[lost]
                assert isinstance(out, torch.Tensor)
                assert np.array_equal(out.numpy(), host), (lost, kernels)
            ref_host = ref.repair({lost}, dict(helper))[lost]
            assert np.array_equal(np.asarray(ref_host), host)
            keys = sorted(helper)

            @jax.jit
            def traced(arrs, lost=lost, keys=keys):
                return ref.repair({lost}, dict(zip(keys, arrs)))[lost]

            dev = traced(tuple(jnp.asarray(helper[kk]) for kk in keys))
            assert np.array_equal(np.asarray(dev), host), lost


class TestTracedCodec:
    """encode_chunks/decode_chunks on tensors run the same in-place
    layered engine as the host path, to the same bytes as ceph_tpu's
    host and jitted programs."""

    @pytest.mark.parametrize("k,m,d", [(4, 2, 5), (8, 4, 11), (5, 3, 7)])
    def test_traced_encode_decode_match_host(self, k, m, d, rng):
        import jax
        import jax.numpy as jnp

        codec, ref = make(k=k, m=m, d=d), make_ref(k=k, m=m, d=d)
        Z = codec.get_sub_chunk_count()
        chunk = Z * 8
        n = k + m
        data = {
            i: rng.integers(0, 256, (3, chunk), np.uint8)
            for i in range(k)
        }
        host_par = codec.encode_chunks({i: v.copy() for i, v in data.items()})
        dev_par = codec.encode_chunks(tensors(data))
        ref_par = ref.encode_chunks({i: v.copy() for i, v in data.items()})

        @jax.jit
        def enc(arrs):
            return ref.encode_chunks({i: arrs[i] for i in range(k)})

        jit_par = enc(tuple(jnp.asarray(data[i]) for i in range(k)))
        for j in host_par:
            assert isinstance(dev_par[j], torch.Tensor)
            assert np.array_equal(dev_par[j].numpy(), host_par[j])
            assert np.array_equal(np.asarray(ref_par[j]), host_par[j])
            assert np.array_equal(np.asarray(jit_par[j]), host_par[j])

        chunks = {**data, **host_par}
        lost = [0, k]  # one data + one parity
        have_ids = sorted(i for i in range(n) if i not in lost)
        have = {i: chunks[i] for i in have_ids}
        host_out = codec.decode_chunks(set(lost), dict(have))
        dev_out = codec.decode_chunks(set(lost), tensors(have))

        @jax.jit
        def dec(arrs):
            return ref.decode_chunks(set(lost), dict(zip(have_ids, arrs)))

        jit_out = dec(tuple(jnp.asarray(chunks[i]) for i in have_ids))
        for s in lost:
            assert np.array_equal(host_out[s], chunks[s])
            assert np.array_equal(dev_out[s].numpy(), chunks[s])
            assert np.array_equal(np.asarray(jit_out[s]), chunks[s])
