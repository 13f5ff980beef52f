"""The port's PGLog (``pipeline/pglog.py``) against ceph_tpu's, on the
CPU: the log mechanics of ``tests/test_pglog.py`` on both packages'
logs (frontiers, dirty extents, trim, recovery marks), and the pipeline
legs (acked writes leave no dirt, an aborted write does not wedge, a
dropped sub-write caught up from the log, scrub clean after it) on
test_torch_rmw's twin stacks, compared byte for byte (tolerance 0).
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_rmw import (  # noqa: E402,F401
    _clean_inject, PAGE, PORT, REF, Twin, payload,
)

K, M = 4, 2


def both_logs(n, script):
    """Run ``script(log, ExtentSet)`` on a ceph_tpu PGLog and a port
    PGLog; returns both results."""
    return [script(pkg.pglog.PGLog(n), pkg.ExtentSet) for pkg in (REF, PORT)]


def dump(log, n):
    return {s: (log.completed_to(s), {o: list(e) for o, e in
                                      log.dirty_extents(s).items()})
            for s in range(n)}


def test_append_monotonic():
    def script(log, ES):
        log.append(1, "a", {0: ES([(0, 10)])})
        with pytest.raises(ValueError) as ei:
            log.append(1, "b", {})
        return str(ei.value)
    a, b = both_logs(3, script)
    assert a == b


def test_frontier_and_gaps():
    def script(log, ES):
        log.append(1, "a", {0: ES([(0, 10)])})
        log.append(3, "a", {0: ES([(10, 20)])})
        log.ack(0, 1)
        out = [dump(log, 2)]
        log.ack(0, 3)
        return out + [dump(log, 2)]
    a, b = both_logs(2, script)
    assert a == b and a[0][0][0] == 2 and a[1][0] == (3, {})


def test_dirty_union_trim_and_recovered():
    def script(log, ES):
        log.append(1, "a", {0: ES([(0, 100)])})
        log.append(2, "a", {0: ES([(50, 200)]), 1: ES([(0, 1)])})
        log.append(3, "b", {0: ES([(0, 10)]), 1: ES([(5, 9)])})
        log.ack(0, 1)
        out = [dump(log, 2)]
        for s in (0, 1):
            log.ack(s, 2)
        out.append((log.trim(), len(log), log.tail, log.head()))
        log.mark_recovered(1)
        out.append(dump(log, 2))
        log.append_delete(4, "a")
        log.append_xattrs(5, "b", {"u:k": b"v", "u:gone": None})
        out.append((sorted(log.dirty_deletes(0)), log.dirty_xattrs(0)))
        return out
    a, b = both_logs(2, script)
    assert a == b


def test_acked_writes_leave_no_dirt(rng):
    tw = Twin(pglog=True)
    tw.submit("obj", 0, payload(rng, 2 * K * PAGE))
    tw.submit("obj", PAGE, b"x" * 100)
    assert tw.same(lambda st: dump(st.pglog, K + M)) == {
        s: (2, {}) for s in range(K + M)}
    assert tw.same(lambda st: (st.pglog.trim(), len(st.pglog))) == (2, 0)


def test_aborted_write_does_not_wedge(rng):
    tw = Twin(pglog=True)
    tw.submit("obj", 0, b"a" * PAGE)
    tw.do(lambda st: st.pkg.inject.ec_inject.write_error("obj", 0, duration=1))
    logs = tw.submit("obj", 0, b"b" * PAGE)
    assert logs[0] == logs[1] and logs[1][0][1] == "OSError"
    tw.submit("obj", 0, b"c" * PAGE)
    tw.same(lambda st: dump(st.pglog, K + M))
    tw.assert_stores_equal()


def test_dropped_subwrite_caught_up_from_log(rng):
    tw = Twin(pglog=True)
    base = payload(rng, 3 * K * PAGE)
    tw.submit("obj", 0, base)
    tw.do(lambda st: st.pkg.inject.ec_inject.write_error(
        "obj", 1, duration=1, shard=2))
    patch = payload(rng, PAGE)
    logs = tw.submit("obj", 2 * PAGE, patch)
    assert logs == ([], [])
    tw.same(lambda st: dump(st.pglog, K + M))
    res = tw.do(lambda st: {
        o: op.recovered_bytes
        for o, op in st.rec.recover_from_log(st.pglog, 2).items()})
    assert res[0] == res[1] and 0 < res[1]["obj"] < 3 * PAGE
    tw.do(lambda st: st.rmw.on_shard_recovered(2))
    assert logs[0] == logs[1] and [t for t, *_ in logs[1]] == [2]
    tw.assert_stores_equal()
    expect = bytearray(base)
    expect[2 * PAGE:3 * PAGE] = patch
    for st in tw.stacks:
        st.backend.down_shards.update({0, 1})
    assert tw.same(lambda st: st.reads.read_sync("obj", 0, len(base))) == \
        bytes(expect)


def test_scrub_clean_after_log_recovery(rng):
    tw = Twin(pglog=True)
    data = payload(rng, K * PAGE)
    tw.submit("obj", 0, data)
    tw.do(lambda st: st.pkg.inject.ec_inject.write_error(
        "obj2", 1, duration=1, shard=4))
    tw.submit("obj2", 0, data)
    tw.do(lambda st: st.rec.recover_from_log(st.pglog, 4))
    assert tw.same(lambda st: st.scrub("obj2")) == []
    tw.assert_stores_equal()
