"""The generator: the same stream and bytes from the same seed, the
mixes' composition, and the closed loop's rule that no two outstanding
ops touch one block where either writes."""

from __future__ import annotations

import itertools
import json
import random
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from ecbench.loop import ClosedLoop
from ecbench.traffic import Traffic

MIXES = Path(__file__).resolve().parents[1] / "mixes"
BIG_SEED = 2**31 + 12345
#: a mix of reads and overwrites that no cell runs yet, for the
#: generator's and the loop's rules on mixed traffic: 4 KiB ops, 70 %
#: reads, at 4 KiB-aligned uniform offsets of a prefilled image
RW_4K = {
    "name": "rw-4k", "objects": 64, "object_bytes": 4194304,
    "prefill": True, "pick": "uniform",
    "ops": [{"kind": "read", "weight": 7, "bytes": 4096, "align": 4096},
            {"kind": "write", "weight": 3, "bytes": 4096, "align": 4096}],
    "depth": 16, "warmup_ops": 512, "kill_osds": [],
    "pool_bytes": 16777216,
}


def _mix(name: str, **changes) -> dict:
    if name == RW_4K["name"]:
        mix = json.loads(json.dumps(RW_4K))
    else:
        mix = json.loads((MIXES / f"{name}.json").read_text())
    mix.update(changes)
    return mix


def _small(name: str) -> dict:
    """The mix at 64 KiB objects (pool and image small enough for a
    test), its op shapes cut to fit."""
    mix = _mix(name, object_bytes=1 << 16,
               pool_bytes=(1 << 20) if _mix(name)["pool_bytes"] else 0)
    for op in mix["ops"]:
        op["bytes"] = min(op["bytes"], 1 << 16)
        op["align"] = min(op.get("align", op["bytes"]), 1 << 16)
    return mix


@pytest.mark.parametrize("name", ["write-4m", "rw-4k",
                                  "degraded-read-4m"])
def test_same_seed_same_stream_and_bytes(name):
    a, b, c = (Traffic(_small(name), s) for s in (BIG_SEED, BIG_SEED, 7))
    for t in (a, b, c):
        t.make_data("cpu")
    ops_a = list(itertools.islice(a.stream(), 600))
    assert ops_a == list(itertools.islice(b.stream(), 600))
    assert ops_a != list(itertools.islice(c.stream(), 600))
    if a.pool is not None:
        assert np.array_equal(a.pool, b.pool)
        assert not np.array_equal(a.pool, c.pool)
        w = next(op for op in ops_a if op.writes)
        assert np.array_equal(a.payload(w), b.payload(w))
    if a.image is not None:
        assert np.array_equal(a.image, b.image)


def test_rounds_hold_exact_shares():
    t = Traffic(_mix("rw-4k"), BIG_SEED)
    ops = list(itertools.islice(t.stream(), 10 * 40))
    for r in range(40):
        part = ops[r * 10:(r + 1) * 10]
        assert sum(op.kind == "read" for op in part) == 7
        assert sum(op.kind == "write" and op.length == 4096
                   for op in part) == 3
    assert len({tuple(op.kind for op in ops[r * 10:(r + 1) * 10])
                for r in range(40)}) > 1
    for op in ops:
        assert op.offset % op.length == 0
        assert op.offset + op.length <= t.object_bytes


def test_shuffle_reads_every_object_once_a_round():
    t = Traffic(_mix("degraded-read-4m"), BIG_SEED)
    ops = list(itertools.islice(t.stream(), 128))
    assert sorted(op.obj for op in ops[:64]) == list(range(64))
    assert sorted(op.obj for op in ops[64:]) == list(range(64))


def test_write_full_names_new_objects_then_wraps():
    t = Traffic(_mix("write-4m", objects=8), BIG_SEED)
    ops = list(itertools.islice(t.stream(), 12))
    assert [op.obj for op in ops] == [0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 2, 3]


def test_stamps_make_every_block_differ():
    t = Traffic(_small("rw-4k"), BIG_SEED)
    t.make_data("cpu")
    w1, w2 = [op for op in itertools.islice(t.stream(), 200)
              if op.writes][:2]
    a, b = t.payload(w1), t.payload(w2)
    assert a[:16].tobytes() != b[:16].tobytes()


class _FakeIo:
    """Completes every op on another thread after a random delay and
    records the ops outstanding at each issue."""

    def __init__(self) -> None:
        self.outstanding: dict[int, tuple] = {}
        self.lock = threading.Lock()
        self.violations: list = []
        self.rng = random.Random(1)
        self.seq = itertools.count()

    def _go(self, kind, oid, offset, length, cb):
        key = next(self.seq)
        me = (kind != "read", oid, offset, offset + length)
        with self.lock:
            for w, o, lo, hi in self.outstanding.values():
                if o == oid and lo < me[3] and me[2] < hi and (w or me[0]):
                    self.violations.append((me, (w, o, lo, hi)))
            self.outstanding[key] = me
            delay = self.rng.random() * 0.002

        def done():
            time.sleep(delay)
            with self.lock:
                del self.outstanding[key]

            class C:
                error = None

                class reply:
                    data = b"\0" * length
            cb(C)
        threading.Thread(target=done, daemon=True).start()

    def aio_write_full(self, oid, data, on_complete):
        self._go("write_full", oid, 0, len(data), on_complete)

    def aio_write(self, oid, data, offset, on_complete):
        self._go("write", oid, offset, len(data), on_complete)

    def aio_read(self, oid, offset, length, on_complete):
        self._go("read", oid, offset, length, on_complete)


def test_closed_loop_never_overlaps_a_write():
    mix = _small("rw-4k")
    mix["objects"] = 2  # crowd two objects so that overlaps are tried
    t = Traffic(mix, BIG_SEED)
    t.make_data("cpu")
    io = _FakeIo()
    loop = ClosedLoop(io, t)
    loop.run_ops(3000)
    assert loop.drain(10.0)
    assert not io.violations
    assert len(loop.records) == 3000
    assert all(r.t_done >= r.t_issue > 0 for r in loop.records)
