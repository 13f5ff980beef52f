"""The port's read plan and reconstruction (``pipeline/read.py``) against
ceph_tpu's, byte for byte (tolerance 0), on the CPU: sub-chunk extents,
``get_min_avail_to_read_shards`` (the CLAY fractional plans read 5/8 of
naive bytes at (4,2,d=5) and 11/32 at (8,4,d=11)), and
``reconstruct_shards`` through CLAY repair and through plain decode on
the same shard maps. Inputs are made with numpy from fixed seeds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu.codecs import registry as ref_registry  # noqa: E402
from ceph_tpu.pipeline import read as ref_read  # noqa: E402
from ceph_tpu.pipeline.extents import ExtentSet as RefExtentSet  # noqa: E402
from ceph_tpu.pipeline.shard_map import (  # noqa: E402
    ShardExtentMap as RefShardExtentMap,
)
from ceph_tpu.pipeline.stripe import StripeInfo as RefStripeInfo  # noqa: E402
from ceph_tpu_torch.codecs import registry  # noqa: E402
from ceph_tpu_torch.pipeline import (  # noqa: E402
    ExtentSet,
    ShardExtentMap,
    StripeInfo,
)
from ceph_tpu_torch.pipeline import read  # noqa: E402

PAGE = 4096
CLAY = [(4, 2, 5), (8, 4, 11)]


def clay_pair(k, m, d):
    prof = {"k": str(k), "m": str(m), "d": str(d)}
    return (registry.factory("clay", prof, device="cpu"),
            ref_registry.factory("clay", prof))


def shard_reads(reads):
    return {s: (sr.shard, list(sr.extents), sr.subchunks)
            for s, sr in reads.items()}


def stored_object(codec, rng, k, m, n_stripes):
    """Shard byte streams of an n_stripes object, one chunk per stripe
    and shard, encoded by ``codec``."""
    chunk = codec.get_chunk_size(k * PAGE)
    data = rng.integers(0, 256, (n_stripes, k, chunk), dtype=np.uint8)
    parity = codec.encode_chunks(
        {i: np.ascontiguousarray(data[:, i]) for i in range(k)})
    streams = {i: data[:, i].reshape(-1) for i in range(k)}
    streams.update({j: np.asarray(v).reshape(-1) for j, v in parity.items()})
    return chunk, streams


class TestSubchunkExtents:
    def test_restrict(self):
        es = read.subchunk_byte_extents(
            ExtentSet([(0, 8192)]), 4096, 8, [(0, 2), (4, 2)]
        )
        # Per 4K chunk with 512B sub-chunks: [0,1024) and [2048,3072).
        assert list(es) == [
            (0, 1024), (2048, 3072), (4096, 5120), (6144, 7168),
        ]
        assert es.size() == 4096

    @pytest.mark.parametrize("window", [(0, 8192), (1000, 7000),
                                        (4096, 12288)])
    def test_matches_reference(self, window):
        runs = [(1, 1), (3, 2), (6, 1)]
        got = read.subchunk_byte_extents(ExtentSet([window]), 4096, 8, runs)
        want = ref_read.subchunk_byte_extents(
            RefExtentSet([window]), 4096, 8, runs)
        assert list(got) == list(want)


class TestPlan:
    @pytest.mark.parametrize("k,m,d", CLAY)
    def test_fractional_plans_match_reference(self, k, m, d):
        port, ref = clay_pair(k, m, d)
        chunk = port.get_chunk_size(k * PAGE)
        n_stripes = 3
        sinfo = StripeInfo(k, m, k * chunk)
        rsinfo = RefStripeInfo(k, m, k * chunk)
        shard_bytes = n_stripes * chunk
        for lost in range(k + m):
            avail = set(range(k + m)) - {lost}
            for lo, hi in ((0, shard_bytes), (chunk, 2 * chunk),
                           (100, chunk + 5)):
                got, need = read.get_min_avail_to_read_shards(
                    sinfo, port, {lost: ExtentSet([(lo, hi)])}, avail)
                want, rneed = ref_read.get_min_avail_to_read_shards(
                    rsinfo, ref, {lost: RefExtentSet([(lo, hi)])}, avail)
                assert need and rneed
                assert shard_reads(got) == shard_reads(want)
            # the MSR read fraction over the whole object: d helpers x
            # sub_chunk_no/q sub-chunks against k whole chunks
            got, _ = read.get_min_avail_to_read_shards(
                sinfo, port, {lost: ExtentSet([(0, shard_bytes)])}, avail)
            assert len(got) == d
            helper_bytes = sum(sr.extents.size() for sr in got.values())
            assert helper_bytes * port.q * k == k * shard_bytes * d
        frac = {(4, 2, 5): 5 / 8, (8, 4, 11): 11 / 32}[(k, m, d)]
        assert helper_bytes / (k * shard_bytes) == pytest.approx(frac)

    @pytest.mark.parametrize("k,m,d", CLAY)
    def test_cost_aware_plans_match_reference(self, k, m, d):
        port, ref = clay_pair(k, m, d)
        chunk = port.get_chunk_size(k * PAGE)
        sinfo = StripeInfo(k, m, k * chunk)
        rsinfo = RefStripeInfo(k, m, k * chunk)
        costs = {s: (s * 7) % 5 + 1 for s in range(1, k + m)}
        got, _ = read.get_min_avail_to_read_shards(
            sinfo, port, {0: ExtentSet([(0, chunk)])}, set(costs), costs)
        want, _ = ref_read.get_min_avail_to_read_shards(
            rsinfo, ref, {0: RefExtentSet([(0, chunk)])}, set(costs), costs)
        assert shard_reads(got) == shard_reads(want)

    def test_plan_fast_path_unaffected(self):
        port, _ = clay_pair(4, 2, 5)
        chunk = port.get_chunk_size(4 * PAGE)
        sinfo = StripeInfo(4, 2, 4 * chunk)
        want = {0: ExtentSet([(0, chunk)])}
        reads, need_decode = read.get_min_avail_to_read_shards(
            sinfo, port, want, {0, 1, 2, 3, 4, 5}
        )
        assert not need_decode
        assert set(reads) == {0}


def _maps(sinfo, rsinfo, streams, reads):
    """The port's and ceph_tpu's shard maps holding exactly the planned
    sub-reads' bytes."""
    result, rresult = ShardExtentMap(sinfo), RefShardExtentMap(rsinfo)
    for s, sr in reads.items():
        for lo, hi in sr.extents:
            result.insert(s, lo, streams[s][lo:hi])
            rresult.insert(s, lo, streams[s][lo:hi])
    return result, rresult


class TestReconstruct:
    @pytest.mark.parametrize("window", ["whole", "middle"])
    @pytest.mark.parametrize("k,m,d", CLAY)
    def test_fractional_repair_matches_reference(self, k, m, d, window, rng):
        """The whole shard, or a range inside its middle chunk (the
        repair then covers that chunk only)."""
        port, ref = clay_pair(k, m, d)
        n_stripes = 3
        chunk, streams = stored_object(port, rng, k, m, n_stripes)
        sinfo = StripeInfo(k, m, k * chunk)
        rsinfo = RefStripeInfo(k, m, k * chunk)
        size = n_stripes * k * chunk
        lo, hi = ((0, n_stripes * chunk) if window == "whole"
                  else (chunk + 100, 2 * chunk - 7))
        for lost in (0, k - 1, k, k + m - 1):
            want = {lost: ExtentSet([(lo, hi)])}
            reads, _ = read.get_min_avail_to_read_shards(
                sinfo, port, want, set(range(k + m)) - {lost})
            assert all(sr.subchunks is not None for sr in reads.values())
            result, rresult = _maps(sinfo, rsinfo, streams, reads)
            read.reconstruct_shards(sinfo, port, result, want, reads, size)
            rwant = {lost: RefExtentSet([(lo, hi)])}
            rreads, _ = ref_read.get_min_avail_to_read_shards(
                rsinfo, ref, rwant, set(range(k + m)) - {lost})
            ref_read.reconstruct_shards(rsinfo, ref, rresult, rwant, rreads,
                                        size)
            got = result.get(lost, lo, hi - lo)
            assert np.array_equal(got, streams[lost][lo:hi]), lost
            assert np.array_equal(got, rresult.get(lost, lo, hi - lo))
            assert list(result.get_extent_set(lost)) == \
                list(rresult.get_extent_set(lost))

    def test_repair_gets_tensors_on_the_codec_device(self, rng, monkeypatch):
        port, _ = clay_pair(4, 2, 5)
        chunk, streams = stored_object(port, rng, 4, 2, 2)
        sinfo = StripeInfo(4, 2, 4 * chunk)
        want = {1: ExtentSet([(0, 2 * chunk)])}
        reads, _ = read.get_min_avail_to_read_shards(
            sinfo, port, want, {0, 2, 3, 4, 5})
        result = ShardExtentMap(sinfo)
        for s, sr in reads.items():
            for lo, hi in sr.extents:
                result.insert(s, lo, streams[s][lo:hi])
        seen = []
        real = port.repair

        def spy(want_to_read, chunks):
            seen.extend(chunks.values())
            return real(want_to_read, chunks)

        monkeypatch.setattr(port, "repair", spy)
        read.reconstruct_shards(sinfo, port, result, want, reads,
                                8 * chunk)
        assert len(seen) == 5
        assert all(isinstance(v, torch.Tensor) and v.device == port.device
                   for v in seen)
        assert np.array_equal(result.get(1, 0, 2 * chunk), streams[1])

    def test_two_lost_shards_take_plain_decode(self, rng):
        """Two lost shards: no fractional repair; the windowed decode of
        ShardExtentMap, the same bytes as ceph_tpu's."""
        port, ref = clay_pair(4, 2, 5)
        chunk, streams = stored_object(port, rng, 4, 2, 2)
        sinfo = StripeInfo(4, 2, 4 * chunk)
        rsinfo = RefStripeInfo(4, 2, 4 * chunk)
        size = 8 * chunk
        lost = (1, 4)
        want = {s: ExtentSet([(0, 2 * chunk)]) for s in lost}
        reads, need = read.get_min_avail_to_read_shards(
            sinfo, port, want, {0, 2, 3, 5})
        assert need and all(sr.subchunks is None for sr in reads.values())
        result, rresult = _maps(sinfo, rsinfo, streams, reads)
        read.reconstruct_shards(sinfo, port, result, want, reads, size)
        rwant = {s: RefExtentSet([(0, 2 * chunk)]) for s in lost}
        rreads, _ = ref_read.get_min_avail_to_read_shards(
            rsinfo, ref, rwant, {0, 2, 3, 5})
        ref_read.reconstruct_shards(rsinfo, ref, rresult, rwant, rreads, size)
        for s in lost:
            got = result.get(s, 0, 2 * chunk)
            assert np.array_equal(got, streams[s])
            assert np.array_equal(got, rresult.get(s, 0, 2 * chunk))

    def test_nothing_lost_is_a_no_op(self):
        port, _ = clay_pair(4, 2, 5)
        sinfo = StripeInfo(4, 2, 4 * port.get_chunk_size(4 * PAGE))
        result = ShardExtentMap(sinfo)
        result.insert(0, 0, np.ones(PAGE, np.uint8))
        read.reconstruct_shards(sinfo, port, result,
                                {0: ExtentSet([(0, PAGE)])}, {}, PAGE)
        assert result.shards() == [0]


def test_gather_ro_range_matches_reference(rng):
    port, _ = clay_pair(4, 2, 5)
    chunk, streams = stored_object(port, rng, 4, 2, 2)
    sinfo = StripeInfo(4, 2, 4 * chunk)
    rsinfo = RefStripeInfo(4, 2, 4 * chunk)
    smap, rmap = ShardExtentMap(sinfo), RefShardExtentMap(rsinfo)
    for s in range(4):
        smap.insert(s, 0, streams[s])
        rmap.insert(s, 0, streams[s])
    for off, length in ((0, 8 * chunk), (chunk - 7, 3 * chunk + 11),
                        (5 * chunk, 100)):
        got = read.gather_ro_range(sinfo, smap, off, length)
        assert got == ref_read.gather_ro_range(rsinfo, rmap, off, length)


def test_shard_read_error_names_shard_and_kind():
    err = read.ShardReadError(3, "obj", "missing")
    assert (err.shard, err.kind) == (3, "missing")
    assert str(err) == str(ref_read.ShardReadError(3, "obj", "missing"))
