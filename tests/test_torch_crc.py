"""The port's CRC32C — plain fold, Kernel C wrapper (plain on CPU
tensors), host helpers and the Checksummer — against ceph_tpu's Pallas
fold in interpret mode, its einsum device path and the bitwise
oracle."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import ceph_tpu.checksum as ref  # noqa: E402
import ceph_tpu_torch.checksum as port  # noqa: E402
from ceph_tpu.checksum.pallas_crc import crc32c_fold_pallas  # noqa: E402
from ceph_tpu_torch.checksum import crc32c as pcrc  # noqa: E402
from ceph_tpu_torch.checksum.cuda_crc import (  # noqa: E402
    crc32c_blocks,
    lane_shift_matrices,
)
from ceph_tpu_torch.utils import config  # noqa: E402

INITS = [0, 0xFFFFFFFF, 0x1234ABCD]


@pytest.mark.parametrize("block", [256, 4096])
@pytest.mark.parametrize("init", INITS)
def test_plain_fold_matches_pallas_and_oracle(rng, block, init):
    data = rng.integers(0, 256, (8, block), dtype=np.uint8)
    got = pcrc.crc32c_fold_plain(torch.from_numpy(data), init).numpy()
    pallas = np.asarray(crc32c_fold_pallas(
        jnp.asarray(data), init, interpret=True))
    assert np.array_equal(got.astype(np.uint32), pallas)
    assert list(got) == [port.crc32c_ref(init, r.tobytes()) for r in data]
    wrapped = crc32c_blocks(torch.from_numpy(data), init).numpy()
    assert np.array_equal(wrapped, got)


@pytest.mark.parametrize("block", [1, 17, 64, 1000, 16384])
@pytest.mark.parametrize("init", INITS)
def test_device_entry_matches_reference(rng, block, init):
    data = rng.integers(0, 256, (3, 2, block), dtype=np.uint8)
    got = port.crc32c_device(data, init, device="cpu")
    assert got.dtype == np.uint32 and got.shape == (3, 2)
    want = np.asarray(ref.crc32c_device(jnp.asarray(data), init))
    assert np.array_equal(got, want)
    tensor = port.crc32c_device(torch.from_numpy(data), init)  # own device
    assert np.array_equal(tensor, want)


@pytest.mark.parametrize("block", [32, 100, 4096, 65536 + 7])
@pytest.mark.parametrize("init", INITS)
def test_lane_join_emulation(rng, block, init):
    """Kernel C's join in numpy: 32 lane segments hashed zero-init, each
    moved to the end of the run by its lane's shift matrix and the lanes
    XOR-summed, the tail continued by lane 0, the seed XORed in — equals
    ceph_crc32c(init, block)."""
    buf = rng.integers(0, 256, block, dtype=np.uint8).tobytes()
    seg = block // 32
    mats = lane_shift_matrices(seg)

    def apply(cols, v):
        return int(np.bitwise_xor.reduce(
            [int(cols[j]) for j in range(32) if v >> j & 1] or [0]))

    crc = 0
    for i in range(32):
        crc ^= apply(mats[i], port.crc32c_ref(0, buf[i * seg : (i + 1) * seg]))
    crc = port.crc32c_ref(crc, buf[32 * seg :])
    crc ^= pcrc.crc32c_seed_shift(block, init)
    assert crc == port.crc32c_ref(init, buf)


def test_host_helpers_match_reference(rng):
    blocks = rng.integers(0, 256, (6, 512), dtype=np.uint8)
    zero = [port.crc32c_ref(0, b.tobytes()) for b in blocks]
    for init in INITS:
        assert pcrc.crc32c_seed_shift(512, init) == \
            ref.crc32c_seed_shift(512, init)
        assert port.crc32c_chain(init, zero, 512) == \
            ref.crc32c_chain(init, zero, 512)
        assert port.crc32c_chain(init, zero, 512) == \
            port.crc32c_ref(init, blocks.tobytes())
    a, b = blocks[0].tobytes(), blocks[1].tobytes()
    assert pcrc.crc32c_concat(port.crc32c_ref(7, a),
                              port.crc32c_ref(0, b), len(b)) == \
        port.crc32c_ref(7, a + b)
    assert port.crc32c_host(5, bytes(300)) == port.crc32c_ref(5, bytes(300))
    assert np.array_equal(pcrc.mat32(pcrc.zero_gap_matrix(999)),
                          ref.crc32c.mat32(ref.crc32c.zero_gap_matrix(999)))


@pytest.mark.parametrize("limit", [0, 1 << 30])
def test_stream_matches_reference_on_both_routes(rng, limit):
    buf = rng.integers(0, 256, 3 * 4096 + 77, dtype=np.uint8)
    port.backends.reset()
    with config.override(csum_device_min_bytes=limit):
        got = port.crc32c_stream(buf, 0xFFFFFFFF, device="cpu")
    assert got == port.crc32c_ref(0xFFFFFFFF, buf.tobytes())
    assert set(port.backends.counts()) == {"plain" if limit == 0 else "host"}


@pytest.mark.parametrize("alg", ["crc32c", "crc32c_16", "crc32c_8"])
def test_checksummer_matches_reference(rng, alg):
    data = rng.integers(0, 256, 8 * 1024, dtype=np.uint8)
    want = ref.Checksummer(alg, 1024).calculate(data.tobytes())
    for limit in (0, 1 << 30):
        with config.override(csum_device_min_bytes=limit):
            summer = port.Checksummer(alg, 1024, device="cpu")
            got = summer.calculate(data.tobytes())
            assert got.dtype == want.dtype and np.array_equal(got, want)
            assert summer.verify(data, want) == (-1, 0)
            bad = data.copy()
            bad[5000] ^= 1
            off, val = summer.verify(bad, want)
            assert off == 4096
            assert val == ref.Checksummer(alg, 1024).calculate(
                bad[4096:5120].tobytes())[0]
    on_cpu = port.Checksummer(alg, 1024, device="cpu")
    assert np.array_equal(on_cpu.calculate(torch.from_numpy(data)), want)
    assert on_cpu.last_backend == "plain"


def test_xxhash_names_its_roadmap_item():
    # the ROADMAP item (queue 1, xxhash) is done: the Checksummer's
    # xxhash64 now equals the reference vectors (test_torch_xxhash.py
    # holds the rest)
    summer = port.Checksummer("xxhash64", 1024, device="cpu")
    got = summer.calculate(bytes(1024))
    assert int(got[0]) == port.xxh64_ref(bytes(1024), (1 << 64) - 1)
    assert summer.last_backend == "device"
