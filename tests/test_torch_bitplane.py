"""The port's plain bit-plane apply and the Kernel A wrappers (which take
the plain version for CPU tensors) against ceph_tpu's einsum engine and
its Pallas kernels in interpret mode — the K1/K2 contract, byte for
byte."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ceph_tpu.ops import bitplane as ref_bp  # noqa: E402
from ceph_tpu.ops import pallas_encode as pe  # noqa: E402
from ceph_tpu_torch.gf import (  # noqa: E402
    MUL_BITMATRIX,
    gf_matrix_to_bitmatrix,
    isa_cauchy_matrix,
)
from ceph_tpu_torch.ops import bitplane, cuda_encode  # noqa: E402

B, N = 8, pe.LANE_TILE


def _case(rng, c, r):
    gen = isa_cauchy_matrix(c, r)
    bm = gf_matrix_to_bitmatrix(gen[c:])
    data = rng.integers(0, 256, (B, c, N), dtype=np.uint8)
    return gen[c:], bm, data


@pytest.mark.parametrize("c", [5, 8, 10])
@pytest.mark.parametrize("r", [1, 3, 4])
def test_plain_apply_matches_reference_and_pallas(rng, c, r):
    coef, bm, data = _case(rng, c, r)
    got = bitplane.gf_encode_bitplane(bm, torch.from_numpy(data)).numpy()
    want = np.asarray(ref_bp.gf_encode_bitplane(jnp.asarray(bm),
                                                jnp.asarray(data)))
    assert np.array_equal(got, want)
    stacked = np.asarray(pe.gf_encode_bitplane_pallas(
        bm, jnp.asarray(data), interpret=True))
    assert np.array_equal(got, stacked)
    shards = pe.gf_encode_bitplane_pallas_shards(
        bm, [jnp.asarray(data[:, i]) for i in range(c)], interpret=True)
    for j in range(r):
        assert np.array_equal(got[:, j], np.asarray(shards[j]))
    # the Kernel A wrappers, both forms, on CPU tensors
    assert np.array_equal(
        cuda_encode.gf_apply(bm, torch.from_numpy(data)).numpy(), got)
    outs = cuda_encode.gf_apply_shards(
        bm, [torch.from_numpy(data[:, i].copy()) for i in range(c)])
    for j in range(r):
        assert np.array_equal(outs[j].numpy(), got[:, j])
    assert np.array_equal(cuda_encode.bitmatrix_coefficients(bm), coef)


@pytest.mark.parametrize("shape", [(3, 17), (2, 4, 33), (1, 1)])
def test_unpack_pack_match_reference(rng, shape):
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    got = bitplane.unpack_bits(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(ref_bp.unpack_bits(jnp.asarray(x))))
    assert np.array_equal(
        bitplane.pack_bits(torch.from_numpy(got)).numpy(), x)


def test_ragged_lengths_and_xor(rng):
    _coef, bm, _ = _case(rng, 8, 4)
    for n in (1, 37, 4096 + 5):
        data = rng.integers(0, 256, (2, 8, n), dtype=np.uint8)
        got = cuda_encode.gf_apply(bm, torch.from_numpy(data)).numpy()
        want = np.asarray(ref_bp.gf_encode_bitplane(
            jnp.asarray(bm), jnp.asarray(data)))
        assert np.array_equal(got, want)
    a, b = (rng.integers(0, 256, 99, dtype=np.uint8) for _ in range(2))
    assert np.array_equal(
        bitplane.xor_bytes(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(ref_bp.xor_bytes(jnp.asarray(a), jnp.asarray(b))))


def test_coefficients_refuse_packet_bitmatrix():
    bm = np.zeros((8, 16), np.uint8)
    bm[0, 3] = 1  # bit 3 of shard 0 into bit 0: no GF constant does that
    with pytest.raises(ValueError, match="not a GF"):
        cuda_encode.bitmatrix_coefficients(bm)
    assert np.array_equal(
        cuda_encode.bitmatrix_coefficients(
            np.concatenate([MUL_BITMATRIX[7], MUL_BITMATRIX[200]], 1)),
        np.array([[7, 200]], np.uint8))


def test_wrappers_refuse_other_devices_and_mixes(rng):
    _coef, bm, data = _case(rng, 5, 3)
    meta = torch.empty((B, 5, N), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_encode.gf_apply(bm, meta)
    with pytest.raises(ValueError, match="does not match C"):
        cuda_encode.gf_apply(bm, torch.from_numpy(data[:, :4]))
    with pytest.raises(ValueError, match="shards for C"):
        cuda_encode.gf_apply_shards(bm, [torch.from_numpy(data[:, 0])])
