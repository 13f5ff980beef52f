"""The port's xxhash32/64 (``checksum/xxhash.py``, ``u64.py``) against
ceph_tpu's, bit for bit (tolerance 0), on the CPU: the canonical vectors
of ``tests/test_checksum.py`` through ``xxh32_ref``/``xxh64_ref``, every
block length class (stripes, 8/4-byte tails, byte tails) and seed
against the references and ceph_tpu's ``xxh32_device``/``xxh64_device``
(XLA on CPU), the u64 helpers against Python integers, and the
Checksummer's calculate/verify contract for both algorithms.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu.checksum import Checksummer as RefChecksummer  # noqa: E402
from ceph_tpu.checksum.xxhash import (  # noqa: E402
    xxh32_device as ref_xxh32,
    xxh64_device as ref_xxh64,
)
from ceph_tpu_torch.checksum import (  # noqa: E402
    Checksummer,
    backends,
    u64,
    xxh32_device,
    xxh32_ref,
    xxh64_device,
    xxh64_ref,
)

M64 = (1 << 64) - 1


def test_canonical_vectors():
    assert xxh32_ref(b"") == 0x02CC5D05
    assert xxh32_ref(b"abc") == 0x32D153FF
    assert xxh32_ref(b"abc", seed=1) != xxh32_ref(b"abc")
    assert xxh64_ref(b"") == 0xEF46DB3751D8E999
    assert xxh64_ref(b"abc") == 0x44BC2CF5AD770999
    got = xxh32_device(np.frombuffer(b"abc", np.uint8)[None], 0, "cpu")
    assert int(got[0]) == 0x32D153FF
    hi, lo = xxh64_device(np.frombuffer(b"abc", np.uint8)[None], 0, "cpu")
    assert (int(hi[0]) << 32 | int(lo[0])) == 0x44BC2CF5AD770999


# 272 = 17 stripes; 4099 ends in a 3-byte tail; 60 = one 32-byte stripe
# + 8 + 4 + ... tails of xxh64
@pytest.mark.parametrize("block", [1, 3, 4, 7, 8, 12, 15, 16, 31, 32, 33,
                                   48, 60, 272, 4096, 4099])
@pytest.mark.parametrize("seed", [0, 1, 0xFFFFFFFF, M64, 0x123456789ABCDEF])
def test_blocks_match_refs(rng, block, seed):
    data = rng.integers(0, 256, (3, block)).astype(np.uint8)
    g32 = xxh32_device(data, seed & 0xFFFFFFFF, "cpu")
    hi, lo = xxh64_device(torch.from_numpy(data), seed)
    for i in range(3):
        assert int(g32[i]) == xxh32_ref(data[i].tobytes(), seed & 0xFFFFFFFF)
        assert (int(hi[i]) << 32 | int(lo[i])) == xxh64_ref(
            data[i].tobytes(), seed)


# ceph_tpu compiles a program per block size: three cover a stripe-only
# block, a short one and a 17-stripe one (the 4 KiB blocks are held to
# the references above)
@pytest.mark.parametrize("block", [16, 48, 272])
def test_matches_ceph_tpu_device(rng, block):
    data = rng.integers(0, 256, (4, block)).astype(np.uint8)
    assert np.array_equal(xxh32_device(data, 7, "cpu"),
                          np.asarray(ref_xxh32(data, 7)))
    a = xxh64_device(data, 2**40 + 3, "cpu")
    b = ref_xxh64(data, 2**40 + 3)
    assert np.array_equal(a[0], np.asarray(b[0]))
    assert np.array_equal(a[1], np.asarray(b[1]))


def test_lead_dims_and_tensors_stay_put(rng):
    data = rng.integers(0, 256, (2, 3, 64)).astype(np.uint8)
    out = xxh32_device(torch.from_numpy(data), 0)  # a CPU tensor: no card
    assert out.shape == (2, 3) and out.dtype == np.uint32
    assert int(out[1, 2]) == xxh32_ref(data[1, 2].tobytes())


def test_u64_helpers_match_python_ints(rng):
    vals = [int(v) for v in rng.integers(0, 2**63, 16, dtype=np.uint64)]
    vals = vals + [v | (1 << 63) for v in vals[:8]] + [0, M64, 1 << 63]
    t = torch.tensor([u64.from_const(v) for v in vals], dtype=torch.int64)
    back = lambda x: [int(v) for v in u64.to_numpy_u64(x)]  # noqa: E731
    assert back(t) == vals
    c = 11400714785074694791
    assert back(u64.mul_const(t, c)) == [(v * c) & M64 for v in vals]
    assert back(t + t) == [(2 * v) & M64 for v in vals]
    assert back(t * t) == [(v * v) & M64 for v in vals]
    for r in (1, 11, 31, 32, 33, 63):
        assert back(u64.rotl(t, r)) == [
            ((v << r) | (v >> (64 - r))) & M64 for v in vals]
        assert back(u64.shr(t, r)) == [v >> r for v in vals]


@pytest.mark.parametrize("alg", ["xxhash32", "xxhash64"])
def test_checksummer_contract(rng, alg):
    blk = 64
    buf = rng.integers(0, 256, blk * 8, dtype=np.uint8)
    port = Checksummer(alg, blk, device="cpu")
    ref = RefChecksummer(alg, blk)
    vals = port.calculate(buf)
    assert vals.dtype == ref.calculate(buf).dtype
    assert np.array_equal(vals, ref.calculate(buf))
    assert port.last_backend == backends.last_backend() == "device"
    assert np.array_equal(port.calculate(buf, init_value=5),
                          ref.calculate(buf, init_value=5))
    assert port.verify(buf, vals) == (-1, 0)
    bad = buf.copy()
    bad[blk * 5 + 7] ^= 1
    got = port.verify(bad, vals)
    assert got == ref.verify(bad, vals) and got[0] == blk * 5
    assert np.array_equal(port.calculate(torch.from_numpy(buf)), vals)
