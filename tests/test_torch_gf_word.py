"""A numpy model of Kernel A (``csrc/gf_apply.cu``: the packed-word xtime
ladder and the per-bit accumulate, with the kernel's thread tiling and
row groups) against the GF(2^8) tables, the port's plain bit-plane apply
and ceph_tpu's. The CUDA kernel runs only on the card; this is the CPU's
view of its arithmetic and addressing. The tile constants are read from
the source, so the model follows the kernel."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ceph_tpu.ops import bitplane as ref_bp  # noqa: E402
from ceph_tpu_torch.gf import gf_matrix_to_bitmatrix  # noqa: E402
from ceph_tpu_torch.gf.tables import gf_mul  # noqa: E402
from ceph_tpu_torch.ops import bitplane, cuda_encode  # noqa: E402

SRC = (Path(__file__).resolve().parents[1] / "ceph_tpu_torch" / "csrc"
       / "gf_apply.cu").read_text()


def _const(pattern: str) -> int:
    return int(re.search(pattern, SRC).group(1))


THREADS = _const(r"constexpr int kThreads = (\d+);")
VEC = _const(r"#define GF_APPLY_VEC (\d+)")
ROW_GROUP = _const(r"constexpr int kRowGroup = (\d+);")
TILE = THREADS * 16 * VEC


def mul2w(x: np.ndarray) -> np.ndarray:
    """gf_word.cuh's mul2w on uint32 words."""
    x = x.astype(np.uint32)
    return (((x & np.uint32(0x7F7F7F7F)) << np.uint32(1))
            ^ (((x >> np.uint32(7)) & np.uint32(0x01010101)) * np.uint32(0x1D)))


def kernel_a_model(coef: np.ndarray, data: np.ndarray) -> np.ndarray:
    """[R, C] byte coefficients, [B, C, N] uint8 -> [B, R, N], the way
    gf_apply_kernel computes it: block (b, column run) of TILE columns,
    thread t owning the 16-byte vectors at run + (v * THREADS + t) * 16,
    v < VEC, zero-filled past N; for each input row the ladder x, 2x, ...
    128x on packed words, rung i accumulated into output j where bit i
    of G[r0 + j][c] is set; outputs in groups of ROW_GROUP; stores
    masked at N."""
    r_count, c_count = coef.shape
    b, _, n = data.shape
    runs = -(-n // TILE)
    padded = np.zeros((b, c_count, runs * TILE), np.uint8)
    padded[..., :n] = data
    # words [B, C, run, v, thread, 4] -> per thread x[4 v + k]: [B, C, run, thread, W]
    words = padded.view("<u4").reshape(b, c_count, runs, VEC, THREADS, 4)
    words = words.transpose(0, 1, 2, 4, 3, 5).reshape(
        b, c_count, runs, THREADS, 4 * VEC)
    out = np.zeros((b, r_count, runs, THREADS, 4 * VEC), np.uint32)
    for r0 in range(0, r_count, ROW_GROUP):
        nr = min(ROW_GROUP, r_count - r0)
        acc = np.zeros((nr,) + words[:, 0].shape, np.uint32)
        for c in range(c_count):
            x = words[:, c].astype(np.uint32)
            g = [int(coef[r0 + j, c]) for j in range(nr)]
            for i in range(8):
                for j in range(nr):
                    if (g[j] >> i) & 1:
                        acc[j] ^= x
                if i < 7:
                    x = mul2w(x)
        out[:, r0:r0 + nr] = acc.transpose(1, 0, 2, 3, 4)
    # back to columns: [B, R, run, thread, v, 4] -> [B, R, run, v, thread, 4]
    cols = out.reshape(b, r_count, runs, THREADS, VEC, 4).transpose(
        0, 1, 2, 4, 3, 5)
    flat = np.ascontiguousarray(cols).view(np.uint8).reshape(b, r_count, -1)
    return flat[..., :n]


def test_ladder_matches_tables_for_every_pair():
    """Every (byte, coefficient) pair: 256 coefficients as output rows
    (eight launches of 32 rows, one input row of all 256 bytes)."""
    data = np.arange(256, dtype=np.uint8)[None, None, :]
    for lo in range(0, 256, 32):
        coef = np.arange(lo, lo + 32, dtype=np.uint8)[:, None]
        got = kernel_a_model(coef, data)[0]
        want = np.array([[gf_mul(int(g), x) for x in range(256)]
                         for g in coef[:, 0]], np.uint8)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 15, 17, 4096 + 37])
@pytest.mark.parametrize("r", [1, 3, 4, 32])
@pytest.mark.parametrize("c", [1, 5, 8, 10, 32])
def test_model_matches_bitplane_and_reference(rng, c, r, n):
    coef = rng.integers(0, 256, (r, c), dtype=np.uint8)
    bm = gf_matrix_to_bitmatrix(coef)
    data = rng.integers(0, 256, (2, c, n), dtype=np.uint8)
    got = kernel_a_model(cuda_encode.bitmatrix_coefficients(bm), data)
    plain = bitplane.gf_encode_bitplane(bm, torch.from_numpy(data)).numpy()
    assert np.array_equal(got, plain)
    want = np.asarray(ref_bp.gf_encode_bitplane(jnp.asarray(bm),
                                                jnp.asarray(data)))
    assert np.array_equal(got, want)
