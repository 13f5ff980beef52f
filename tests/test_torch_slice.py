"""The whole ported slice on ``device="cpu"`` against ceph_tpu's flow:
ShardExtentMap.encode with fused csums and HashInfo, the degraded
decode, and the Checksummer verify — with ceph_tpu's fused Pallas
kernel in interpret mode and the host route off on both sides. HashInfo
persists across the two packages in both directions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ceph_tpu.checksum as ref_ck  # noqa: E402
import ceph_tpu.pipeline as ref_pl  # noqa: E402
import ceph_tpu_torch.checksum as port_ck  # noqa: E402
import ceph_tpu_torch.pipeline as port_pl  # noqa: E402
from ceph_tpu.codecs import registry as ref_registry  # noqa: E402
from ceph_tpu.utils import config as ref_config  # noqa: E402
from ceph_tpu_torch.codecs import registry  # noqa: E402
from ceph_tpu_torch.codecs.matrix_codec import (  # noqa: E402
    dispatch_counters,
)
from ceph_tpu_torch.utils import config  # noqa: E402

K, M, CHUNK, STRIPES, CB = 4, 2, 8192, 3, 1024
LOST = (0, 5)  # m erasures: one data shard, one parity shard


def _build(pl, data):
    sinfo = pl.StripeInfo(K, M, K * CHUNK)
    smap = pl.ShardExtentMap(sinfo)
    streams = data.reshape(STRIPES, K, CHUNK).transpose(1, 0, 2)
    for r in range(K):
        smap.insert(r, 0, np.ascontiguousarray(streams[r]).reshape(-1))
    return sinfo, smap


def _survivors(pl, sinfo, stored):
    smap = pl.ShardExtentMap(sinfo)
    for s, buf in stored.items():
        if s not in LOST:
            smap.insert(s, 0, buf)
    return smap


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy"])
def test_slice_matches_reference(rng, technique):
    profile = {"k": str(K), "m": str(M), "technique": technique}
    data = rng.integers(0, 256, K * CHUNK * STRIPES, dtype=np.uint8)
    shard_bytes = CHUNK * STRIPES
    dispatch_counters().reset()

    # the port, on the CPU, host route off so the plain path runs
    with config.override(ec_host_dispatch_bytes=0, csum_device_min_bytes=0):
        codec = registry.factory("isa", profile, device="cpu")
        sinfo, smap = _build(port_pl, data)
        hinfo = port_pl.HashInfo(K + M, device="cpu")
        smap.encode(codec, hinfo, csum_block=CB)
        stored = {s: smap.get(s, 0, shard_bytes) for s in range(K + M)}
        deg = _survivors(port_pl, sinfo, stored)
        deg.decode(codec, set(LOST), K * shard_bytes)
        rebuilt = {s: deg.get(s, 0, shard_bytes) for s in LOST}
        summer = port_ck.Checksummer("crc32c", CB, device="cpu")
        blob = summer.calculate(np.concatenate(list(stored.values())))

    # ceph_tpu, fused kernel in interpret mode, host route off
    with ref_config.override(
        ec_fused_csum_interpret=True, ec_host_dispatch_bytes=0
    ):
        rcodec = ref_registry.factory("isa", profile)
        _, rmap = _build(ref_pl, data)
        rhinfo = ref_pl.HashInfo(K + M)
        rmap.encode(rcodec, rhinfo, csum_block=CB)
        rstored = {s: rmap.get(s, 0, shard_bytes) for s in range(K + M)}
        rdeg = _survivors(ref_pl, sinfo, rstored)
        rdeg.decode(rcodec, set(LOST), K * shard_bytes)
        rblob = ref_ck.Checksummer("crc32c", CB).calculate(
            np.concatenate(list(rstored.values())))

    assert rmap.csums is not None and smap.csums is not None
    for s in range(K + M):
        assert np.array_equal(stored[s], rstored[s])
        lo, vals = smap.csums["shards"][s]
        rlo, rvals = rmap.csums["shards"][s]
        assert lo == rlo and np.array_equal(vals, rvals)
    for s in LOST:
        assert np.array_equal(rebuilt[s], stored[s])
        assert np.array_equal(rdeg.get(s, 0, shard_bytes), stored[s])
    assert hinfo.cumulative_shard_hashes == rhinfo.cumulative_shard_hashes
    assert hinfo.get_total_chunk_size() == rhinfo.get_total_chunk_size()
    assert np.array_equal(blob, rblob)

    # blob csums are the fused zero-init csums plus one seed XOR
    seed = port_ck.crc32c_seed_shift(CB, 0xFFFFFFFF)
    fused = np.concatenate([smap.csums["shards"][s][1]
                            for s in range(K + M)]) ^ np.uint32(seed)
    assert np.array_equal(fused, blob)
    everything = np.concatenate(list(stored.values()))
    assert summer.verify(everything, fused) == (-1, 0)
    everything[3 * shard_bytes + 5000] ^= 0x80
    assert summer.verify(everything, fused)[0] == \
        3 * shard_bytes + (5000 // CB) * CB

    got = dispatch_counters().dump()
    assert got["fused_encode"] == 1 and got["plain_decode"] == 1
    assert got["host_encode"] == got["host_decode"] == 0
    assert got["kernel_encode"] == got["fused_fallback"] == 0


def test_hashinfo_bytes_cross_compatible(rng):
    bufs = {s: rng.integers(0, 256, 4096, dtype=np.uint8) for s in range(6)}
    port = port_pl.HashInfo(6, device="cpu")
    port.append(0, bufs)
    ref = ref_pl.HashInfo(6)
    ref.append(0, bufs)
    assert port.to_bytes() == ref.to_bytes()
    back = port_pl.HashInfo.from_bytes(ref.to_bytes(), device="cpu")
    assert back == port
    assert ref_pl.HashInfo.from_bytes(port.to_bytes()) == ref
    # device-seeded == byte-appended, on the port alone
    zero = {s: np.array([port_ck.crc32c_ref(0, b.tobytes())], np.uint32)
            for s, b in bufs.items()}
    seeded = port_pl.HashInfo(6, device="cpu")
    seeded.append_block_csums(0, zero, 4096)
    assert seeded == port
