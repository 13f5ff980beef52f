"""The port's plain fused encode+checksum and the Kernel B wrappers
(plain on CPU tensors) against ceph_tpu's fused Pallas kernels in
interpret mode — the K3/K4 contract: parity plus zero-init CRC32C of
every csum block of every shard, byte for byte."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ceph_tpu.ops import pallas_encode as pe  # noqa: E402
from ceph_tpu_torch.checksum.cuda_crc import lane_shift_matrices  # noqa: E402
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
    (8, 4, 256, 4096), (8, 4, 4096, 4096), (8, 4, 65536, 4096),
    (32, 32, 65536, 1024), (10, 4, 1024, 4096),
])
def test_csum_tile_fits_budget(c, r, cb, tile):
    """Kernel B's step over 1 MiB rows: the widest power of two up to
    CSUM_TILE_MAX whose block fits shared memory, a multiple or a divisor
    of the window."""
    plan = cuda_encode.csum_plan(c, r, 1 << 20, cb)
    assert plan.tile == tile and (cb % tile == 0 or tile % cb == 0)
    assert plan.smem <= cuda_encode.SMEM_MAX
    assert plan.smem == cuda_encode.csum_smem(c, r, plan.tile, plan.piece)
    if tile < cuda_encode.CSUM_TILE_MAX:
        wider = cuda_encode.csum_smem(c, r, 2 * tile, plan.piece)
        assert wider > cuda_encode.SMEM_MAX


def test_subtile_chain_emulation(rng):
    """Kernel B's per-window CRC as the kernel computes it — each piece
    as 32 lane segments joined in one level (lane i's CRC moved to the
    piece's end by its shift matrix, the lanes XOR-summed), pieces
    chained by the piece shift — equals the window's zero-init CRC."""
    cb, piece = 8192, 2048
    seg = piece // 32
    lanes_mats = lane_shift_matrices(seg)
    piece_mat = cuda_encode.csum_piece_matrix(piece)
    window = rng.integers(0, 256, cb, dtype=np.uint8).tobytes()

    def apply(cols, v):
        out = 0
        for j in range(32):
            if v >> j & 1:
                out ^= int(cols[j])
        return out

    carry = 0
    for p0 in range(0, cb, piece):
        moved = 0
        for i in range(32):
            lane = crc32c_ref(0, window[p0 + i * seg:p0 + (i + 1) * seg])
            moved ^= apply(lanes_mats[i], lane)
        carry = moved if p0 == 0 else apply(piece_mat, carry) ^ moved
    assert carry == crc32c_ref(0, window)
