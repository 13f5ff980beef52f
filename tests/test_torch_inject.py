"""The port's ECInject (``pipeline/inject.py``) against ceph_tpu's, on
the CPU: the registry's when/duration windows, per-shard rules, clears
and messages, and each inject type through the pipelines of
test_torch_rmw's twin stacks (read types 0/1 retried, type 2 silent
corruption, write type 0 abort in order, type 1 dropped sub-write, type
3 aborted OSD), compared byte for byte (tolerance 0). Mirrors
``tests/test_inject.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_rmw import (  # noqa: E402,F401
    _clean_inject, PAGE, PORT, REF, Twin, outcome, payload,
)

K, M = 4, 2


def both(script):
    return [script(pkg.inject.ECInject()) for pkg in (REF, PORT)]


def test_when_duration_window():
    a, b = both(lambda inj: (inj.read_error("o", 0, when=2, duration=2),
                             [inj.test_read_error0("o", 0) for _ in range(7)]))
    assert a == b and a[1] == [False, False, True, True, False, False, False]


def test_per_shard_rules_and_clear():
    def script(inj):
        out = [inj.read_error("o", 0, duration=10, shard=3),
               inj.test_read_error0("o", 1), inj.test_read_error0("o", 3)]
        out += [inj.write_error("o", 1, duration=10),
                inj.clear_write_error("o", 1), inj.test_write_error1("o", 0)]
        out += [inj.read_error("o", 9), inj.write_error("o#s2", 2),
                inj.test_write_error2("o"), inj.injected_count]
        out += [inj.clear_read_error("o", 0, 3), inj.clear_read_error("o", 0)]
        return out
    a, b = both(script)
    assert a == b


def test_corrupt_matches():
    buf = bytes(range(256)) * 3
    assert REF.inject.ECInject.corrupt(buf) == PORT.inject.ECInject.corrupt(buf)


def read_op(st, oid, length):
    got = {}
    st.reads.submit(oid, 0, length, lambda op: got.update(op=op))
    op = got["op"]
    return op.data, outcome(op)[1:], sorted(op.error_shards)


@pytest.mark.parametrize("type,stripes", [(0, 1), (1, 1), (2, 1), (2, 2)],
                         ids=["0", "1", "2", "2-two_stripes"])
def test_read_inject(rng, type, stripes):
    """(2, 2) is ``tests/test_inject_types.py``'s silent read-path case:
    a two-stripe object read whole."""
    tw = Twin()
    data = payload(rng, stripes * K * PAGE)
    tw.submit("obj", 0, data)
    count = lambda st: st.pkg.inject.ec_inject.injected_count  # noqa: E731
    before = tw.do(count)
    tw.do(lambda st: st.pkg.inject.ec_inject.read_error(
        "obj", type, duration=1, shard=0))
    res = tw.same(lambda st: read_op(st, "obj", len(data)))
    if type < 2:
        assert res == (data, (None, None), [0])
    else:
        assert res[0] != data and res[2] == []  # silent: nothing errors
    after = tw.do(count)
    assert after[0] - before[0] == after[1] - before[1] == 1
    assert tw.same(lambda st: st.reads.read_sync("obj", 0, len(data))) == data


def test_write_abort_in_order(rng):
    tw = Twin()
    a = payload(rng, PAGE)
    logs = tw.submit("obj", 0, a)
    tw.do(lambda st: st.pkg.inject.ec_inject.write_error("obj", 0, duration=1))
    for oid, data in (("obj", b"Z" * PAGE), ("obj2", a)):
        more = tw.submit(oid, 0, data)
        for lg, m in zip(logs, more):
            lg.extend(m)
    assert logs[0] == logs[1]
    assert [e[1] for e in logs[1]] == [None, "OSError", None]
    assert tw.same(lambda st: st.reads.read_sync("obj", 0, PAGE)) == a
    tw.assert_stores_equal()


def test_dropped_sub_write_parks_op(rng):
    tw = Twin()
    data = payload(rng, PAGE)
    tw.do(lambda st: st.pkg.inject.ec_inject.write_error(
        "obj", 1, duration=1, shard=2))
    logs = tw.submit("obj", 0, data)
    more = tw.submit("obj", PAGE, data)
    assert logs == more == ([], [])
    tw.same(lambda st: st.pkg.inject.ec_inject.test_write_error2("obj"))
    tw.assert_stores_equal()


def test_write_abort_osd_marks_shard_down(rng):
    tw = Twin()
    tw.do(lambda st: st.pkg.inject.ec_inject.write_error(
        "obj", 3, duration=1))
    logs = tw.submit("obj", 0, payload(rng, K * PAGE))
    assert logs[0] == logs[1]
    assert tw.same(lambda st: sorted(st.backend.down_shards))
    tw.assert_stores_equal()
