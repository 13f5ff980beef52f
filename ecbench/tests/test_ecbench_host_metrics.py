"""The readers of the program's host accounting, on synthetic
readings: each computes its definition from the window's counter
deltas, and returns None where the program has no such counter (a
tree without the accounting) or the denominator is 0."""

from __future__ import annotations

import importlib
import types

import pytest

from ecbench.reading import Reading

MiB = 1 << 20


def reading(counters: dict, ops: int = 4, length: int = 4 * MiB) -> Reading:
    records = [types.SimpleNamespace(op=types.SimpleNamespace(length=length))
               for _ in range(ops)]
    return Reading(config={"k": 8, "m": 4}, mix={}, window_s=10.0,
                   ops=records, setup_s=1.0, counters=counters, trace=None,
                   lost={}, device_kind="cpu")


def trace(**stats) -> dict:
    return {"trace": {k.replace("__", "."): v for k, v in stats.items()}}


CASES = {
    # metric: (counters, expected over 4 ops of 4 MiB, counters of a
    # reading with a zero denominator)
    "staging_bytes_per_byte": (
        {"ec_staging": {"copy_bytes": 300 * MiB, "zero_bytes": 100 * MiB,
                        "user_bytes": 8 * MiB}},
        50.0,
        {"ec_staging": {"copy_bytes": 7, "zero_bytes": 1, "user_bytes": 0}},
    ),
    "staging_cpu_ms": (
        trace(ec_stage__cpu_s=2.0), 500.0, None),
    "codec_host_ms": (
        trace(ec_encode__self_s=0.3, ec_decode__self_s=0.1), 100.0, None),
    "messenger_cpu_ms": (
        trace(msg_encode__cpu_s=0.1, msg_send__cpu_s=0.2,
              msg_decode__cpu_s=0.5), 200.0, None),
    "op_queue_wait_ms": (
        {"osd.0.op_queue": {"op_queue.dequeued": 3, "op_queue.wait_s": 0.5},
         "osd.1.op_queue": {"op_queue.dequeued": 1, "op_queue.wait_s": 0.3}},
        200.0,
        {"osd.0.op_queue": {"op_queue.dequeued": 0, "op_queue.wait_s": 0.0}},
    ),
    "subop_wait_ms": (
        {"osd.0.p.1.rmw": {"committed": 2, "subop_wait_s": 0.2},
         "osd.3.p.7.rmw": {"committed": 2, "subop_wait_s": 0.6}},
        200.0,
        {"osd.0.p.1.rmw": {"committed": 0, "subop_wait_s": 0.0}},
    ),
    "store_cpu_ms": (
        trace(store_commit__cpu_s=0.3, store_read__cpu_s=0.1), 100.0, None),
    "drain_requeues_per_op": (
        {"osd.0.net": {"drain.requeues": 6, "dedup_hits": 1},
         "osd.1.net": {"drain.requeues": 2}},
        2.0,
        None,
    ),
}


def _read(metric: str, r: Reading):
    return importlib.import_module(f"ecbench.metrics.{metric}").read(r)


@pytest.mark.parametrize("metric", sorted(CASES))
def test_reader(metric):
    counters, want, zero = CASES[metric]
    assert _read(metric, reading(counters)) == pytest.approx(want)
    # a tree without the accounting: other sets only, nothing to read
    parent = {"osd.0.net": {"dedup_hits": 3},
              "osd.0.p.1.rmw": {"write_ops": 4, "write_bytes": 16 * MiB}}
    assert _read(metric, reading(parent)) is None
    if zero is not None:
        assert _read(metric, reading(zero)) is None
    else:
        assert _read(metric, reading(counters, ops=0)) is None
