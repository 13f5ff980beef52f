"""The port's dmClock scheduler (``utils/mclock.py``) and async reserver
(``utils/reserver.py``) against ceph_tpu's, on the CPU.

The mirrors run the reference's ``tests/test_mclock.py`` and the
reserver cases of ``tests/test_backfill_reserve.py`` against
``ceph_tpu_torch``; a twin feeds one seeded request stream with an
injected clock to both schedulers and holds the dequeue order and the
per-class counters equal.
"""

import pytest

torch = pytest.importorskip("torch")

from ceph_tpu_torch.utils.mclock import ClientProfile, MClockScheduler  # noqa: E402
from ceph_tpu_torch.utils.reserver import AsyncReserver  # noqa: E402


# -- mirror of tests/test_mclock.py ---------------------------------------

class Clock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def drain(sched, clock, rate, seconds):
    """Run the server at ``rate`` ops/sec for ``seconds``; returns
    per-class dispatch counts."""
    counts: dict[str, int] = {}
    dt = 1.0 / rate
    for _ in range(int(seconds * rate)):
        clock.t += dt
        got = sched.dequeue()
        if got is not None:
            counts[got[0]] = counts.get(got[0], 0) + 1
    return counts


def test_fifo_within_class():
    c = Clock()
    s = MClockScheduler({"a": ClientProfile(weight=1.0)}, clock=c)
    for i in range(5):
        s.enqueue("a", i)
    c.t = 1.0
    assert [s.dequeue()[1] for _ in range(5)] == [0, 1, 2, 3, 4]
    assert s.dequeue() is None


def test_reservations_met_under_contention():
    """A class with a reservation gets at least its guaranteed rate
    even against a heavyweight competitor."""
    c = Clock()
    s = MClockScheduler(
        {
            "guaranteed": ClientProfile(reservation=30.0, weight=0.01),
            "heavy": ClientProfile(reservation=0.0, weight=10.0),
        },
        clock=c,
    )
    for i in range(1000):
        s.enqueue("guaranteed", i)
        s.enqueue("heavy", i)
    counts = drain(s, c, rate=100, seconds=5)
    # guaranteed ~30/s of the 100/s server despite 1000x weight ratio
    assert counts["guaranteed"] >= 0.9 * 30 * 5
    assert counts["heavy"] >= 300  # the rest flows to the heavy class


def test_spare_capacity_splits_by_weight():
    c = Clock()
    s = MClockScheduler(
        {
            "w3": ClientProfile(weight=3.0),
            "w1": ClientProfile(weight=1.0),
        },
        clock=c,
    )
    for i in range(2000):
        s.enqueue("w3", i)
        s.enqueue("w1", i)
    counts = drain(s, c, rate=100, seconds=8)
    ratio = counts["w3"] / counts["w1"]
    assert 2.5 < ratio < 3.5


def test_limit_caps_throughput():
    c = Clock()
    s = MClockScheduler(
        {"capped": ClientProfile(weight=5.0, limit=20.0)}, clock=c
    )
    for i in range(1000):
        s.enqueue("capped", i)
    counts = drain(s, c, rate=200, seconds=4)
    # 20 ops/s cap on a 200 ops/s server
    assert counts["capped"] <= 20 * 4 + 2
    assert counts["capped"] >= 0.8 * 20 * 4


def test_limited_class_leaves_capacity_to_others():
    c = Clock()
    s = MClockScheduler(
        {
            "capped": ClientProfile(weight=10.0, limit=10.0),
            "open": ClientProfile(weight=0.1),
        },
        clock=c,
    )
    for i in range(2000):
        s.enqueue("capped", i)
        s.enqueue("open", i)
    counts = drain(s, c, rate=100, seconds=5)
    assert counts["capped"] <= 10 * 5 + 2
    assert counts["open"] >= 100 * 5 - counts["capped"] - 10


def test_idle_class_gets_no_banked_credit():
    """A class idle for a long stretch must not burst past its limit
    when it returns (tags re-anchor at now)."""
    c = Clock()
    s = MClockScheduler(
        {"capped": ClientProfile(weight=1.0, limit=10.0)},
        clock=c,
        idle_age=1.0,
    )
    s.enqueue("capped", "x")
    c.t = 0.5
    assert s.dequeue() is not None
    c.t = 100.0  # long idle: naive tags would allow ~1000 ops at once
    for i in range(200):
        s.enqueue("capped", i)
    counts = drain(s, c, rate=100, seconds=2)
    assert counts.get("capped", 0) <= 10 * 2 + 2


def test_cost_scales_consumption():
    """A 10-cost op consumes ten 1-cost quanta of a limited class."""
    c = Clock()
    s = MClockScheduler(
        {"capped": ClientProfile(weight=1.0, limit=10.0)}, clock=c
    )
    for i in range(40):
        s.enqueue("capped", i, cost=10.0)
    counts = drain(s, c, rate=100, seconds=4)
    # 10 ops/s limit at cost 10 => ~1 dispatch/sec
    assert counts.get("capped", 0) <= 6


def test_unknown_class_gets_default_profile():
    c = Clock()
    s = MClockScheduler({}, clock=c)
    s.enqueue("mystery", "op")
    c.t = 1.0
    assert s.dequeue() == ("mystery", "op")


def test_next_ready_reports_limit_gate():
    c = Clock()
    s = MClockScheduler(
        {"capped": ClientProfile(weight=1.0, limit=1.0)}, clock=c
    )
    s.enqueue("capped", "a")
    c.t = 0.1
    assert s.dequeue() == ("capped", "a")
    s.enqueue("capped", "b")
    assert s.dequeue() is None  # gated: 1 op/s
    nr = s.next_ready()
    assert nr is not None and nr > c.t
    c.t = nr + 0.01
    assert s.dequeue() == ("capped", "b")


# ---------------------------------------------------------------------------
# QoS-plane additions: byte-scaled costs, bursty-limit property tests,
# idle re-anchor after cost-weighted service, injected-clock determinism.
# ---------------------------------------------------------------------------

import random

from ceph_tpu_torch.cluster.qos import COST_QUANTUM_BYTES, op_cost


def test_byte_cost_scales_tags():
    """A class pushing large ops via op_cost() is served proportionally
    fewer *dispatches* than a small-op class of equal weight, but equal
    cost-units."""
    c = Clock()
    s = MClockScheduler(
        {
            "big": ClientProfile(weight=1.0),
            "small": ClientProfile(weight=1.0),
        },
        clock=c,
    )
    big_cost = op_cost(4 * COST_QUANTUM_BYTES)  # 5.0 cost units
    for i in range(2000):
        s.enqueue("big", i, cost=big_cost)
        s.enqueue("small", i, cost=op_cost(0))  # 1.0 cost unit
    counts = drain(s, c, rate=200, seconds=5)
    ratio = counts["small"] / counts["big"]
    assert 4.0 < ratio < 6.5  # ~5x more small dispatches per cost unit


def test_op_cost_monotone_and_floored():
    assert op_cost(0) == 1.0
    assert op_cost(-5) == 1.0
    assert op_cost(COST_QUANTUM_BYTES) == 2.0
    prev = 0.0
    for nbytes in (0, 1, 4096, 65536, 1 << 20, 1 << 28):
        cur = op_cost(nbytes)
        assert cur >= prev >= 0.0
        prev = cur


def test_limit_enforced_under_bursty_enqueue():
    """Limit holds even when arrivals come in bursts with idle gaps
    shorter than idle_age (no credit accumulation mid-burst)."""
    c = Clock()
    s = MClockScheduler(
        {"capped": ClientProfile(weight=5.0, limit=25.0)},
        clock=c,
        idle_age=10.0,
    )
    rng = random.Random(0x19)
    dispatched = 0
    horizon = 8.0
    while c.t < horizon:
        # bursty arrivals: 0-40 ops at once, then a short gap
        for i in range(rng.randrange(0, 41)):
            s.enqueue("capped", (c.t, i))
        gap = rng.uniform(0.01, 0.3)
        steps = max(1, int(gap / 0.005))
        for _ in range(steps):
            c.t += gap / steps
            if s.dequeue() is not None:
                dispatched += 1
    assert dispatched <= 25.0 * horizon * 1.1 + 2


def test_idle_reanchor_after_cost_weighted_service():
    """Serving a huge-cost op advances tags far into the future; after
    an idle window, the class must re-anchor and serve again promptly
    instead of being starved by its own stale tags."""
    c = Clock()
    s = MClockScheduler(
        {"t": ClientProfile(reservation=10.0, weight=1.0, limit=50.0)},
        clock=c,
        idle_age=1.0,
    )
    s.enqueue("t", "whale", cost=500.0)  # 10s worth of limit in one op
    c.t = 0.1
    assert s.dequeue() is not None
    c.t = 5.0  # > idle_age since service
    s.enqueue("t", "minnow")
    got = None
    for _ in range(10):
        c.t += 0.05
        got = s.dequeue()
        if got is not None:
            break
    assert got == ("t", "minnow")  # re-anchored, not gated until t=10+


def test_injected_clock_determinism():
    """Identical op/clock sequences produce identical dispatch orders
    and identical dump() counters — no wall-clock leakage."""

    def run(seed):
        c = Clock()
        s = MClockScheduler(
            {
                "client.a": ClientProfile(reservation=20.0, weight=3.0),
                "client.b": ClientProfile(weight=1.0, limit=40.0),
                "recovery": ClientProfile(reservation=5.0, weight=0.5),
            },
            clock=c,
        )
        rng = random.Random(seed)
        order = []
        for step in range(3000):
            c.t += rng.uniform(0.001, 0.02)
            cls = rng.choice(["client.a", "client.b", "recovery"])
            if rng.random() < 0.6:
                s.enqueue(cls, step, cost=op_cost(rng.randrange(0, 1 << 18)))
            got = s.dequeue()
            if got is not None:
                order.append(got)
        snap = {
            k: (
                v["enqueued"],
                v["dequeued_r"],
                v["dequeued_p"],
                v["throttled"],
                round(v["served_cost"], 9),
            )
            for k, v in s.dump().items()
        }
        return order, snap

    o1, d1 = run(0x1905)
    o2, d2 = run(0x1905)
    assert o1 == o2
    assert d1 == d2
    o3, _ = run(0x1906)
    assert o3 != o1  # the fuzz actually exercises different paths


def test_dump_counters_track_service():
    c = Clock()
    s = MClockScheduler(
        {"r": ClientProfile(reservation=50.0, weight=0.001, limit=60.0)},
        clock=c,
    )
    for i in range(100):
        s.enqueue("r", i, cost=2.0)
    drain(s, c, rate=100, seconds=1)
    d = s.dump()["r"]
    assert d["enqueued"] == 100
    served = d["dequeued_r"] + d["dequeued_p"]
    assert 20 <= served <= 62
    assert d["dequeued_r"] > 0  # reservation phase did the lifting
    assert abs(d["served_cost"] - 2.0 * served) < 1e-6
    assert d["depth"] == 100 - served


def test_set_profiles_live_update_applies():
    """set_profiles() re-gates a previously uncapped class: already
    issued tags stand, but ops enqueued after the swap pace at the new
    limit."""
    c = Clock()
    s = MClockScheduler({"t": ClientProfile(weight=1.0)}, clock=c)
    for i in range(100):
        s.enqueue("t", i)
    first = drain(s, c, rate=200, seconds=1)
    assert first["t"] == 100  # uncapped: the whole burst drains
    s.set_profiles({"t": ClientProfile(weight=1.0, limit=10.0)})
    for i in range(400):
        s.enqueue("t", i)
    second = drain(s, c, rate=100, seconds=2)
    assert second["t"] <= 10 * 2 + 2


# -- mirror of the reserver cases of tests/test_backfill_reserve.py --

def test_reserver_grants_up_to_max():
    r = AsyncReserver(lambda: 2)
    got = []
    r.request("a", 0, lambda: got.append("a"))
    r.request("b", 0, lambda: got.append("b"))
    r.request("c", 0, lambda: got.append("c"))
    assert got == ["a", "b"]
    assert r.queued() == 1
    r.release("a")
    assert got == ["a", "b", "c"]
    assert r.held() == 2


def test_reserver_priority_order():
    r = AsyncReserver(lambda: 1)
    got = []
    r.request("low1", 1, lambda: got.append("low1"))   # granted
    r.request("low2", 1, lambda: got.append("low2"))
    r.request("high", 9, lambda: got.append("high"))
    r.release("low1")
    assert got == ["low1", "high"]
    r.release("high")
    assert got == ["low1", "high", "low2"]


def test_reserver_cancel_queued_and_idempotent_request():
    r = AsyncReserver(lambda: 1)
    got = []
    r.request("a", 0, lambda: got.append("a"))
    r.request("b", 0, lambda: got.append("b"))
    r.request("b", 0, lambda: got.append("b-dup"))  # no-op
    r.cancel("b")
    r.release("a")
    assert got == ["a"]
    assert r.held() == 0 and r.queued() == 0


def test_reserver_max_shrink_respected_on_release():
    limit = [2]
    r = AsyncReserver(lambda: limit[0])
    got = []
    for k in "abcd":
        r.request(k, 0, lambda k=k: got.append(k))
    assert got == ["a", "b"]
    limit[0] = 1
    r.release("a")       # held 1 == new max: nothing granted
    assert got == ["a", "b"]
    r.release("b")       # now a slot opens
    assert got == ["a", "b", "c"]


# -- twins: one seeded stream through both packages --------------------

def _twin_run(mod, seed):
    """A seeded enqueue/dequeue stream with an injected clock through
    one package's scheduler: the dequeue order, then the dump."""
    import numpy as np

    rng = np.random.default_rng(seed)
    clock = Clock()
    sched = mod.MClockScheduler({
        "client": mod.ClientProfile(reservation=20.0, weight=2.0,
                                    limit=80.0),
        "recovery": mod.ClientProfile(reservation=5.0, weight=1.0),
        "scrub": mod.ClientProfile(weight=0.5, limit=10.0),
    }, clock=clock)
    order = []
    for step in range(600):
        clock.t += float(rng.uniform(0.0, 0.02))
        if rng.random() < 0.6:
            cls = ("client", "recovery", "scrub")[int(rng.integers(0, 3))]
            sched.enqueue(cls, step)
        else:
            got = sched.dequeue()
            order.append(None if got is None else (got[0], got[1]))
    return order, sched.dump()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_scheduler_orders_equal(seed):
    import importlib

    ref = importlib.import_module("ceph_tpu.utils.mclock")
    port = importlib.import_module("ceph_tpu_torch.utils.mclock")
    assert _twin_run(port, seed) == _twin_run(ref, seed)


def test_twin_reserver_grants_equal():
    import importlib

    def run(mod):
        limit = [2]
        r = mod.AsyncReserver(lambda: limit[0])
        got = []
        for i, key in enumerate("abcdefgh"):
            r.request(key, i % 3, lambda k=key: got.append(k))
        r.cancel("f")
        limit[0] = 1
        for key in "abcdegh":
            r.release(key)
        return got, r.held(), r.queued()

    assert run(importlib.import_module("ceph_tpu_torch.utils.reserver")) == \
        run(importlib.import_module("ceph_tpu.utils.reserver"))
