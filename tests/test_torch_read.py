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


# -- ReadPipeline: fan-out, retry, in-order completion -------------------
# The same seeded writes and reads through ceph_tpu's ReadPipeline and
# the port's (test_torch_rmw's twin stacks); every read's bytes, error,
# error shards, decode flag and shard plan must agree.
from test_torch_rmw import (  # noqa: E402,F401
    _clean_inject, Twin, payload,
)

K, M = 4, 2


def read_both(tw, oid, off, length):
    outs = []
    for st in tw.stacks:
        got = {}
        st.reads.submit(oid, off, length, lambda op, g=got: g.update(op=op))
        op = got["op"]
        outs.append((
            op.data, None if op.error is None else str(op.error),
            sorted(op.error_shards), op.need_decode,
            {s: list(sr.extents) for s, sr in op.shard_reads.items()},
        ))
    assert outs[0] == outs[1]
    return outs[1]


class TestReadPipeline:
    def test_fast_path_and_eof(self, rng):
        tw = Twin()
        data = payload(rng, 3 * K * PAGE + 517)
        tw.submit("obj", 0, data)
        assert read_both(tw, "obj", 0, len(data))[0] == data
        lo, ln = PAGE + 100, 2 * PAGE + 57
        assert read_both(tw, "obj", lo, ln)[0] == data[lo:lo + ln]
        got = read_both(tw, "obj", 0, 100)
        assert not got[3] and set(got[4]) == {0}
        assert read_both(tw, "obj", 5 * K * PAGE, 100)[0] == b""
        assert read_both(tw, "missing", 0, 100)[0] == b""

    @pytest.mark.parametrize("down", [{0}, {1}, {3}, {0, 2}, {4, 5}])
    def test_degraded(self, rng, down):
        tw = Twin()
        data = payload(rng, 2 * K * PAGE + 999)
        tw.submit("obj", 0, data)
        for st in tw.stacks:
            st.backend.down_shards.update(down)
        assert read_both(tw, "obj", 0, len(data))[0] == data
        got = read_both(tw, "obj", PAGE, PAGE // 2)
        assert got[0] == data[PAGE:PAGE + PAGE // 2]

    def test_too_many_down(self, rng):
        tw = Twin()
        tw.submit("obj", 0, payload(rng, K * PAGE))
        for st in tw.stacks:
            st.backend.down_shards.update({0, 1, 2})
        assert read_both(tw, "obj", 0, 100)[1] is not None

    def test_eio_retry(self, rng):
        tw = Twin()
        data = payload(rng, K * PAGE)
        tw.submit("obj", 0, data)
        for st in tw.stacks:
            st.backend.fail_read_shards.add(2)
        got = read_both(tw, "obj", 0, len(data))
        assert got[0] == data and got[2] == [2] and got[3]
        for st in tw.stacks:
            st.backend.down_shards.update({4, 5})
            st.backend.fail_read_shards.add(1)
        assert read_both(tw, "obj", 0, len(data))[1] is not None

    def test_retry_widens_pending_shard(self, rng):
        tw = Twin()
        data = payload(rng, K * PAGE)
        tw.submit("obj", 0, data)
        outs = []
        for st in tw.stacks:
            be = st.backend
            be.fail_read_shards.add(0)
            be.defer_reads = True
            got = {}
            st.reads.submit("obj", 100, PAGE + 100,
                            lambda op, g=got: g.update(op=op))
            pending = sorted(be.deferred_reads, key=lambda t: t[0])
            be.deferred_reads = []
            for _, run in pending:
                run()
            while be.deferred_reads:
                be.release_deferred_reads()
            op = got["op"]
            outs.append((op.data, op.error, sorted(op.error_shards)))
        assert outs[0] == outs[1] == (data[100:PAGE + 200], None, [0])

    def test_in_order_completion(self, rng):
        tw = Twin()
        a, b = payload(rng, PAGE), payload(rng, PAGE)
        tw.submit("a", 0, a)
        tw.submit("b", 0, b)
        orders = []
        for st in tw.stacks:
            st.backend.defer_reads = True
            done = []
            r1 = st.reads.submit("a", 0, PAGE, lambda op, d=done: d.append(op.rid))
            r2 = st.reads.submit("b", 0, PAGE, lambda op, d=done: d.append(op.rid))
            pending, st.backend.deferred_reads = st.backend.deferred_reads, []
            for _, run in reversed(pending):
                run()
            orders.append((done, [r1, r2]))
        assert orders[0] == orders[1] and orders[1][0] == orders[1][1]

    def test_subpage_boundary_overwrite_then_degraded(self, rng):
        tw = Twin(plugin="isa", k=8, m=4)
        data = payload(rng, 5 * 8 * PAGE + 12345)
        tw.submit("obj", 0, data)
        patch = payload(rng, 3 * PAGE)
        tw.submit("obj", 2 * PAGE + 17, patch)
        expect = bytearray(data)
        expect[2 * PAGE + 17:2 * PAGE + 17 + len(patch)] = patch
        for st in tw.stacks:
            st.backend.down_shards.update({1, 6, 9, 11})
        assert read_both(tw, "obj", 0, len(data))[0] == bytes(expect)
        tw.assert_stores_equal()

    def test_read_counters_match(self, rng):
        tw = Twin()
        data = payload(rng, 2 * K * PAGE)
        tw.submit("obj", 0, data)
        for st in tw.stacks:
            st.backend.down_shards.add(1)
        read_both(tw, "obj", 0, len(data))
        tw.same(lambda st: {n: st.reads.perf.get(n) for n in (
            "read_ops", "read_bytes", "reconstruct_ops",
            "helper_read_bytes", "retries", "errors")})


class TestClayThroughPipeline:
    """CLAY fractional repair through the read pipeline: the helpers
    read their repair planes only, and the port decodes the lost shard
    from them as ceph_tpu does."""

    @staticmethod
    def _stores(tw, rng, n_stripes):
        st = tw.port
        k, m, chunk = st.k, st.m, st.chunk
        data = rng.integers(0, 256, (n_stripes, k, chunk), np.uint8)
        parity = st.codec.encode_chunks(
            {i: np.ascontiguousarray(data[:, i, :]) for i in range(k)})
        for s in range(k + m):
            buf = (data[:, s, :] if s < k
                   else np.asarray(parity[s])).reshape(-1).tobytes()
            for stack in tw.stacks:
                stack.backend.stores[s].queue_transactions(
                    stack.pkg.store.Transaction().write("obj", 0, buf))
        return data.reshape(-1).tobytes()

    @pytest.mark.parametrize("fail", [set(), {5}])
    def test_repair_through_pipeline(self, rng, fail):
        tw = Twin(plugin="clay", profile={"d": "5"})
        data = self._stores(tw, rng, 2)
        size = len(data)
        outs = []
        for st in tw.stacks:
            reads = st.pkg.read.ReadPipeline(
                st.sinfo, st.codec, st.backend, lambda oid: size)
            st.backend.down_shards.add(1)
            st.backend.fail_read_shards.update(fail)
            got = {}
            reads.submit("obj", 0, size, lambda op, g=got: g.update(op=op))
            op = got["op"]
            outs.append((op.data, op.error, sorted(op.error_shards),
                         {s: (list(sr.extents), sr.subchunks)
                          for s, sr in op.shard_reads.items()}))
        assert outs[0] == outs[1]
        assert outs[1][0] == data and outs[1][1] is None
