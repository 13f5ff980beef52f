"""The port's plain fused encode+checksum and the Kernel B wrappers
(plain on CPU tensors) against ceph_tpu's fused Pallas kernels in
interpret mode — the K3/K4 contract: parity plus zero-init CRC32C of
every csum block of every shard, byte for byte."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ceph_tpu.ops import pallas_encode as pe  # noqa: E402
from ceph_tpu_torch.checksum.reference import crc32c_ref  # noqa: E402
from ceph_tpu_torch.gf import (  # noqa: E402
    gf_matrix_to_bitmatrix,
    isa_cauchy_matrix,
    isa_rs_matrix,
)
from ceph_tpu_torch.ops import cuda_encode  # noqa: E402

B, N = 8, pe.LANE_TILE

GEOMETRIES = [
    ("isa_rs", isa_rs_matrix, 8, 4),
    ("cauchy", isa_cauchy_matrix, 5, 3),
]


@pytest.mark.parametrize("cb", [256, 1024])
@pytest.mark.parametrize(
    "name,build,k,m", GEOMETRIES, ids=[g[0] for g in GEOMETRIES]
)
def test_plain_fused_matches_pallas(rng, name, build, k, m, cb):
    bm = gf_matrix_to_bitmatrix(build(k, m)[k:])
    data = rng.integers(0, 256, (B, k, N), dtype=np.uint8)
    parity, csums = cuda_encode.gf_apply_csum_plain(
        bm, torch.from_numpy(data), cb)
    parity, csums = parity.numpy(), csums.numpy().astype(np.uint32)

    rp, rc = pe.gf_encode_csum_bitplane_pallas(
        bm, jnp.asarray(data), cb, interpret=True)
    assert np.array_equal(parity, np.asarray(rp))
    assert np.array_equal(csums, np.asarray(rc))
    sp, sc = pe.gf_encode_csum_bitplane_pallas_shards(
        bm, [jnp.asarray(data[:, i]) for i in range(k)], cb, interpret=True)
    for j in range(m):
        assert np.array_equal(parity[:, j], np.asarray(sp[j]))
    assert np.array_equal(csums, np.asarray(sc))

    # the Kernel B wrappers, both forms, on CPU tensors
    wp, wc = cuda_encode.gf_apply_csum(bm, torch.from_numpy(data), cb)
    assert np.array_equal(wp.numpy(), parity)
    assert np.array_equal(wc.numpy().astype(np.uint32), csums)
    shp, shc = cuda_encode.gf_apply_csum_shards(
        bm, [torch.from_numpy(data[:, i].copy()) for i in range(k)], cb)
    for j in range(m):
        assert np.array_equal(shp[j].numpy(), parity[:, j])
    assert np.array_equal(shc.numpy().astype(np.uint32), csums)

    # and one block per shard against the bitwise oracle
    full = np.concatenate([data, parity], axis=1)
    for s in (0, k - 1, k + m - 1):
        q = N // cb - 1
        blk = full[3, s, q * cb : (q + 1) * cb].tobytes()
        assert int(csums[3, s, q]) == crc32c_ref(0, blk)


@pytest.mark.parametrize("cb", [128, 384, 3072])
def test_csum_contract_refuses_bad_blocks(rng, cb):
    bm = gf_matrix_to_bitmatrix(isa_rs_matrix(4, 2)[4:])
    data = torch.from_numpy(rng.integers(0, 256, (2, 4, N), dtype=np.uint8))
    assert not cuda_encode.csum_supported(N, cb)
    with pytest.raises(ValueError, match="outside the contract"):
        cuda_encode.gf_apply_csum(bm, data, cb)


@pytest.mark.parametrize("c,r,cb,tile", [
    (8, 4, 256, 256), (8, 4, 4096, 4096), (8, 4, 65536, 4096),
    (32, 32, 65536, 512), (10, 4, 1024, 1024),
])
def test_csum_tile_fits_budget(c, r, cb, tile):
    got = cuda_encode.csum_tile(c, r, cb)
    assert got == tile and cb % got == 0
    assert got == 256 or (c + r) * (got + 512) <= cuda_encode.CSUM_TILE_BUDGET


def test_subtile_chain_emulation(rng):
    """Kernel B's per-window CRC as the kernel computes it — 32 lane
    segments per sub-tile joined by the shift tree, sub-tiles chained by
    the tile shift — equals the window's zero-init CRC."""
    cb, tile = 8192, 2048
    mats = cuda_encode.csum_shift_matrices(tile)
    window = rng.integers(0, 256, cb, dtype=np.uint8).tobytes()
    seg = tile // 32

    def apply(cols, v):
        out = 0
        for j in range(32):
            if v >> j & 1:
                out ^= int(cols[j])
        return out

    carry = 0
    for s0 in range(0, cb, tile):
        lanes = [crc32c_ref(0, window[s0 + i * seg : s0 + (i + 1) * seg])
                 for i in range(32)]
        for lvl in range(5):
            step = 1 << lvl
            for lane in range(0, 32, 2 * step):
                lanes[lane] = (apply(mats[lvl], lanes[lane])
                               ^ lanes[lane + step])
        carry = apply(mats[5], carry) ^ lanes[0]
    assert carry == crc32c_ref(0, window)
