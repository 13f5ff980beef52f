"""The closed loop: ``depth`` ops outstanding through the objecter's
asynchronous ``IoCtx`` calls, the next issued as one completes.

Latency runs from just before the ``aio_*`` call to the completion
callback, on the client's clock. No two outstanding ops touch one 4 KiB
block where either writes: an op that would is held (the stream keeps
its order) until the op it overlaps completes, so every read returns
the bytes of the writes issued before it and every final image is
determined by the issue order alone.

Inside the window the loop only stamps a premade payload, issues and
records: nothing is hashed or verified until the window has closed.
"""

from __future__ import annotations

import threading
import time

from .traffic import Op, Traffic, object_name


class Record:
    __slots__ = ("op", "t_issue", "t_done", "error", "data")

    def __init__(self, op: Op, t_issue: float) -> None:
        self.op = op
        self.t_issue = t_issue
        self.t_done = 0.0
        self.error: str | None = None
        #: a read's returned bytes (kept for the check after the window)
        self.data: bytes | None = None


class ClosedLoop:
    def __init__(self, io, traffic: Traffic) -> None:
        self.io = io
        self.traffic = traffic
        self.depth = traffic.depth
        self.records: list[Record] = []
        self._stream = traffic.stream()
        self._held: Op | None = None
        self._inflight: dict[int, Op] = {}
        self._cv = threading.Condition()

    # -- completion (the messenger's reader thread) ---------------------
    def _done(self, rec: Record, comp) -> None:
        t = time.perf_counter()
        if comp.error is not None:
            rec.error = f"{type(comp.error).__name__}: {comp.error}"
        elif rec.op.kind == "read":
            rec.data = comp.reply.data
        with self._cv:
            rec.t_done = t
            self._inflight.pop(rec.op.seq, None)
            self._cv.notify_all()

    # -- issue (the caller's thread) ------------------------------------
    def _blocked(self, op: Op) -> bool:
        return any(op.overlaps(o) and (op.writes or o.writes)
                   for o in self._inflight.values())

    def _issue(self, op: Op) -> None:
        data = self.traffic.payload(op) if op.writes else None
        rec = Record(op, 0.0)
        self.records.append(rec)
        oid = object_name(op.obj)

        def cb(comp, _rec=rec):
            self._done(_rec, comp)

        with self._cv:
            self._inflight[op.seq] = op
        rec.t_issue = time.perf_counter()
        if op.kind == "write_full":
            self.io.aio_write_full(oid, data, on_complete=cb)
        elif op.kind == "write":
            self.io.aio_write(oid, data, op.offset, on_complete=cb)
        else:
            self.io.aio_read(oid, op.offset, op.length, on_complete=cb)

    def run(self, until) -> None:
        """Issue until ``until()`` is true (checked before every issue).
        Ops already outstanding stay so: ``drain`` waits for them."""
        while not until():
            op = self._held if self._held is not None else next(self._stream)
            self._held = None
            with self._cv:
                while len(self._inflight) >= self.depth or self._blocked(op):
                    self._cv.wait(0.05)
                    if until():
                        self._held = op
                        return
            self._issue(op)

    def run_ops(self, n: int) -> None:
        start = len(self.records)
        self.run(lambda: len(self.records) - start >= n)

    def drain(self, timeout: float) -> bool:
        """Wait for every outstanding op; False if some never came."""
        end = time.perf_counter() + timeout
        with self._cv:
            while self._inflight:
                left = end - time.perf_counter()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.1))
        return True


def write_image(io, traffic: Traffic) -> list[str]:
    """Prefill: every object of the image written whole, the mix's
    depth at a time, through the same asynchronous calls. Returns the
    errors."""
    errors: list[str] = []
    cv = threading.Condition()
    outstanding = [0]

    def done(comp, name):
        with cv:
            if comp.error is not None:
                errors.append(f"{name}: {comp.error}")
            outstanding[0] -= 1
            cv.notify_all()

    for i in range(traffic.objects):
        with cv:
            while outstanding[0] >= traffic.depth:
                cv.wait(0.1)
            outstanding[0] += 1
        name = object_name(i)
        io.aio_write_full(name, traffic.image[i].tobytes(),
                          on_complete=lambda c, n=name: done(c, n))
    with cv:
        while outstanding[0]:
            cv.wait(0.1)
    return errors
