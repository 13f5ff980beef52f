"""The port's recovery and deep scrub (``pipeline/recovery.py``) against
ceph_tpu's, byte for byte (tolerance 0), on the CPU.

Mirrors ``tests/test_recovery.py``: ``recover_object`` of one and two
shards, the FSM states, survivor EIO, too many losses, CLAY's
fractional recovery reads, ``recover_from_log``, and ``be_deep_scrub``
clean, corrupted, with cleared HashInfo and with no attr. Both packages
run the same seeded ops on test_torch_rmw's twin stacks; the rebuilt
stores, the recovery states and counts, and the scrub errors must
agree. ``csum_device_min_bytes`` 0 sends the verify and scrub CRCs down
the port's device fold (Kernel C's plain form on the CPU).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_rmw import (  # noqa: E402,F401
    _clean_inject, PAGE, Twin, override, payload,
)

K, M = 4, 2


def recover(tw, oid, missing, **kw):
    """recover_object on both; (state, read, recovered bytes, error
    shards) must agree."""
    res = []
    for st in tw.stacks:
        op = st.rec.recover_object(oid, missing, **kw)
        res.append((op.state.value, op.read_bytes, op.recovered_bytes,
                    sorted(op.error_shards)))
    assert res[0] == res[1]
    return res[1]


class TestRecovery:
    @pytest.mark.parametrize("lost", [0, 2, 4, 5])
    def test_recover_single_shard(self, rng, lost):
        tw = Twin()
        tw.submit("obj", 0, payload(rng, 3 * K * PAGE + 777))
        before = tw.port.snapshot()
        tw.do(lambda st: st.wipe(lost))
        assert recover(tw, "obj", {lost})[0] == "COMPLETE"
        tw.assert_stores_equal()
        assert tw.port.snapshot() == before

    def test_recover_two_shards(self, rng):
        tw = Twin()
        tw.submit("obj", 0, payload(rng, 2 * K * PAGE))
        before = tw.port.snapshot()
        for s in (1, 4):
            tw.do(lambda st: st.wipe(s))
        recover(tw, "obj", {1, 4})
        assert tw.port.snapshot() == before
        tw.assert_stores_equal()

    def test_fsm_states(self, rng):
        tw = Twin()
        tw.submit("obj", 0, payload(rng, K * PAGE))
        tw.do(lambda st: st.wipe(0))
        states = []
        for st in tw.stacks:
            op = st.rec.open_recovery_op("obj", {0})
            seq = [op.state.value]
            while op.state.value != "COMPLETE":
                seq.append(st.rec.continue_recovery_op(op).value)
            states.append(seq)
        assert states[0] == states[1] == ["IDLE", "READING", "COMPLETE"]

    def test_too_many_missing(self, rng):
        tw = Twin()
        tw.submit("obj", 0, payload(rng, K * PAGE))
        errs = []
        for st in tw.stacks:
            for s in (0, 1, 2):
                st.wipe(s)
            st.backend.down_shards.update({0, 1, 2})
            with pytest.raises(ValueError) as ei:
                st.rec.recover_object("obj", {0, 1, 2})
            errs.append(str(ei.value))
        assert errs[0] == errs[1]

    def test_survivor_eio_retry(self, rng):
        tw = Twin()
        tw.submit("obj", 0, payload(rng, K * PAGE))
        before = tw.port.snapshot()
        for st in tw.stacks:
            st.wipe(0)
            st.backend.fail_read_shards.add(3)
        assert recover(tw, "obj", {0})[3] == [3]
        for st in tw.stacks:
            st.backend.fail_read_shards.clear()
        assert tw.port.snapshot() == before
        tw.assert_stores_equal()

    def test_verify_on_device_fold(self, rng):
        """Recovery verify and read-back after it, with every CRC on
        the device fold route."""
        tw = Twin()
        data = payload(rng, 5 * K * PAGE + 31)
        tw.submit("obj", 0, data)
        tw.do(lambda st: st.wipe(2))
        with override(csum_device_min_bytes=0):
            recover(tw, "obj", {2})
        tw.assert_stores_equal()
        assert tw.same(lambda st: st.reads.read_sync("obj", 0, len(data))) == data

    def test_verify_rejects_a_bad_rebuild(self, rng):
        """A HashInfo that disagrees with the bytes stops the push."""
        tw = Twin()
        tw.submit("obj", 0, payload(rng, 2 * K * PAGE))
        errs = []
        for st in tw.stacks:
            st.wipe(1)
            st.rmw.hinfo("obj").cumulative_shard_hashes[1] ^= 1
            with pytest.raises(IOError) as ei:
                st.rec.recover_object("obj", {1})
            errs.append(str(ei.value))
        assert errs[0] == errs[1]

    def test_clay_fractional_read_bytes(self, rng):
        tw = Twin(plugin="clay", profile={"d": "5"})
        st = tw.port
        k, m, chunk = st.k, st.m, st.chunk
        n_stripes = 2
        data = rng.integers(0, 256, (n_stripes, k, chunk), np.uint8)
        parity = st.codec.encode_chunks(
            {i: np.ascontiguousarray(data[:, i, :]) for i in range(k)})
        size = n_stripes * k * chunk
        for stack in tw.stacks:
            for s in range(k + m):
                buf = (data[:, s, :] if s < k
                       else np.asarray(parity[s])).reshape(-1).tobytes()
                stack.backend.stores[s].queue_transactions(
                    stack.pkg.store.Transaction().write("obj", 0, buf))
        before = tw.port.snapshot()
        res = []
        for stack in tw.stacks:
            stack.wipe(2)
            rec = stack.pkg.recovery.RecoveryBackend(
                stack.sinfo, stack.codec, stack.backend, lambda oid: size,
                lambda oid: None)
            op = rec.recover_object("obj", {2})
            res.append(op.read_bytes)
        assert res[0] == res[1] < k * n_stripes * chunk
        rebuilt = tw.port.backend.stores[2].read("obj")
        assert rebuilt == before[2]["obj"][0]
        tw.assert_stores_equal()


class TestLogRecovery:
    def test_recover_from_log(self, rng):
        tw = Twin(pglog=True)
        base = payload(rng, 3 * K * PAGE)
        tw.submit("obj", 0, base)
        for st in tw.stacks:
            st.backend.down_shards.add(2)
        tw.submit("obj", 2 * PAGE, payload(rng, PAGE))
        tw.submit("obj2", 0, payload(rng, 5000))
        tw.do(lambda st: st.rmw.submit_setxattr("obj", "k", b"v"))
        tw.do(lambda st: st.rmw.submit_remove("obj2"))
        tw.same(lambda st: repr(st.pglog.dirty_extents(2)))
        for st in tw.stacks:
            st.backend.down_shards.clear()
        res = tw.do(lambda st: {
            oid: (op.recovered_bytes, op.read_bytes)
            for oid, op in st.rec.recover_from_log(st.pglog, 2).items()})
        assert res[0] == res[1]
        tw.do(lambda st: st.rmw.on_shard_recovered(2))
        tw.same(lambda st: (st.pglog.completed_to(2), st.pglog.dirty_extents(2)))
        tw.assert_stores_equal()
        assert tw.same(lambda st: st.scrub("obj")) == []


class TestDeepScrub:
    @pytest.mark.parametrize("limit", [None, 0])
    def test_clean(self, rng, limit):
        tw = Twin()
        tw.submit("obj", 0, payload(rng, 3 * K * PAGE + 123))
        opts = {} if limit is None else {"csum_device_min_bytes": limit}
        with override(**opts):
            assert tw.same(lambda st: st.scrub("obj")) == []

    def test_stride_chains_across_pieces(self, rng):
        tw = Twin()
        tw.submit("obj", 0, payload(rng, 12 * K * PAGE))
        with override(osd_deep_scrub_stride=4096, csum_device_min_bytes=0):
            assert tw.same(lambda st: st.scrub("obj")) == []

    def test_detects_corruption_and_recovers(self, rng):
        tw = Twin()
        tw.submit("obj", 0, payload(rng, 2 * K * PAGE))
        for st in tw.stacks:
            good = st.backend.stores[3].read("obj", 100, 1)
            st.backend.stores[3].queue_transactions(
                st.pkg.store.Transaction().write(
                    "obj", 100, bytes([good[0] ^ 0xFF])))
        errs = tw.same(lambda st: st.scrub("obj"))
        assert [(s, kind) for s, kind, _ in errs] == [(3, "crc_mismatch")]
        recover(tw, "obj", {3})
        assert tw.same(lambda st: st.scrub("obj")) == []
        tw.assert_stores_equal()

    def test_cleared_hinfo_skips(self, rng):
        tw = Twin()
        tw.submit("obj", 0, payload(rng, 2 * K * PAGE))
        tw.submit("obj", 17, b"xyz" * 100)
        assert tw.same(lambda st: st.scrub("obj")) == []

    def test_missing_attr(self):
        tw = Twin()
        errs = tw.same(lambda st: st.scrub("ghost"))
        assert [kind for _, kind, _ in errs] == ["missing_attr"]

    def test_missing_shard_object(self, rng):
        tw = Twin()
        tw.submit("obj", 0, payload(rng, K * PAGE))
        for st in tw.stacks:
            st.backend.stores[4].queue_transactions(
                st.pkg.store.Transaction().remove("obj"))
        errs = tw.same(lambda st: st.scrub("obj"))
        assert [(s, kind) for s, kind, _ in errs] == [(4, "read_error")]
