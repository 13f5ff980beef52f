"""Shared-memory ring transport — the co-located fast lane.

When every daemon of a cluster lives in one process (the loadgen /
bench topology), routing EC sub-write fan-out through loopback TCP
pays kernel socket round-trips for bytes that never leave the
process. This module provides the alternative lane: a pair of
bounded byte rings (native ``ctpu_ring`` slots when the C++ tier
loads, a pure-Python deque ring otherwise) wrapped in a socket
duck-type, so :class:`~ceph_tpu_torch.msg.messenger.Connection` runs over
it UNCHANGED — same framing, same per-segment CRC, same secure
handshake, same reader thread, and crucially the same
``NetFaultPlane`` hooks, which act on logical frames in
``Connection.send`` / ``_read_loop`` *above* the transport (the
acceptance contract: chaos rules apply identically on shm links and
TCP links).

Negotiation happens at connect time, not per frame: when
``msgr_transport = shm_ring`` and the dialed address resolves to an
in-process listener (the bind registry below), ``Messenger.connect``
builds a ring pair and hands the server end to the listener's normal
``_finish_accept`` path. Remote or unresolved addresses fall back to
TCP transparently — the lane is an upgrade, never a requirement.

Teardown mirrors TCP semantics: closing an endpoint closes both
rings; a closed ring still drains buffered chunks before the reader
sees EOF (the FIN-then-drain contract ``_read_loop`` already
handles), and a writer hitting a closed ring gets ``OSError`` like a
send on a reset socket.
"""

from __future__ import annotations

import threading

from ceph_tpu_torch.utils import config as _config
from ceph_tpu_torch.utils.lockdep import DebugLock, DebugRLock

#: ring geometry per direction: chunks of at most SLOT_BYTES travel
#: through a CAPACITY-slot ring (native) or deque (fallback). 32 x
#: 32 KiB = 1 MiB of in-flight bytes per direction per link — enough
#: to stream a full EC sub-write batch without writer stalls, small
#: enough that a fully-meshed loadgen cluster stays tens of MiB.
SLOT_BYTES = 32768
CAPACITY = 32

#: transport stats (the `ss -i` analog for the shm lane); read via
#: snapshot() by the bench A/B legs
_stats_lock = DebugLock("msgr.shm_stats")
_stats = {"connections": 0, "chunks": 0, "bytes": 0}

#: in-process listener registry: bind address -> Messenger. Populated
#: unconditionally at bind() (registration is cheap); consulted by
#: connect() only when the msgr_transport gate selects this lane.
_listeners: dict[tuple, object] = {}
_reg_lock = DebugLock("msgr.shm_registry")


def register(addr, messenger) -> None:
    with _reg_lock:
        _listeners[tuple(addr)] = messenger


def unregister(addr, messenger) -> None:
    with _reg_lock:
        if _listeners.get(tuple(addr)) is messenger:
            del _listeners[tuple(addr)]


def lookup(addr):
    """The connect-time negotiation: the target Messenger when the
    shm lane is configured AND the address resolves in-process (and
    the listener is still accepting), else None -> caller dials TCP."""
    if _config.get("msgr_transport") != "shm_ring":
        return None
    with _reg_lock:
        target = _listeners.get(tuple(addr))
    if target is None or target._stopping:
        return None
    return target


def snapshot() -> dict:
    with _stats_lock:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_lock:
        for k in _stats:
            _stats[k] = 0


class _PyRing:
    """Pure-Python fallback ring: bounded deque of chunks with the
    same timed push/pop/close contract as native.RingBuffer. Return
    codes match: 1 ok, 0 closed (push) / closed-and-drained (pop),
    -2 timeout."""

    def __init__(self, capacity: int) -> None:
        from collections import deque

        self._q = deque()
        self._capacity = capacity
        self._closed = False
        self._cv = threading.Condition(DebugRLock("msgr.shm_pyring"))

    def push_timed(self, data, timeout=None) -> int:
        with self._cv:
            if not self._cv.wait_for(
                lambda: len(self._q) < self._capacity or self._closed,
                timeout,
            ):
                return -2
            if self._closed:
                return 0
            self._q.append(bytes(data))
            self._cv.notify_all()
            return 1

    def pop_timed(self, timeout=None):
        with self._cv:
            if not self._cv.wait_for(
                lambda: self._q or self._closed, timeout
            ):
                return -2, None
            if not self._q:
                return 0, None
            chunk = self._q.popleft()
            self._cv.notify_all()
            return 1, chunk

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


def _make_ring():
    try:
        from ceph_tpu_torch import native

        if native.available():
            return native.RingBuffer(CAPACITY, SLOT_BYTES)
    except Exception:
        pass
    return _PyRing(CAPACITY)


class RingSock:
    """Socket duck-type over a (tx, rx) ring pair — implements the
    exact surface :class:`Connection` touches: ``sendall``, ``recv``,
    ``settimeout``, ``shutdown``, ``close``. Byte-stream semantics:
    ``recv(n)`` may return fewer bytes (one buffered chunk at a
    time); ``b""`` means EOF; a closed tx ring raises ``OSError``."""

    def __init__(self, tx, rx) -> None:
        self._tx = tx
        self._rx = rx
        self._timeout = None
        # leftover bytes from a popped chunk larger than the last recv
        self._rbuf = b""
        self._rpos = 0

    def settimeout(self, t) -> None:
        self._timeout = t

    def sendall(self, data) -> None:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            data = bytes(data)
        view = memoryview(data)
        total = len(view)
        sent = 0
        while sent < total:
            chunk = bytes(view[sent : sent + SLOT_BYTES])
            rc = self._tx.push_timed(chunk, self._timeout)
            if rc == 0:
                raise OSError("shm ring closed by peer")
            if rc == -2:
                import socket as _socket

                raise _socket.timeout("shm ring send timed out")
            sent += len(chunk)
        with _stats_lock:
            _stats["bytes"] += total
            _stats["chunks"] += (total + SLOT_BYTES - 1) // SLOT_BYTES

    def recv(self, n: int) -> bytes:
        if self._rpos < len(self._rbuf):
            out = self._rbuf[self._rpos : self._rpos + n]
            self._rpos += len(out)
            return out
        rc, chunk = self._rx.pop_timed(self._timeout)
        if rc == -2:
            import socket as _socket

            raise _socket.timeout("shm ring recv timed out")
        if rc != 1 or not chunk:
            return b""  # closed and drained: EOF
        if len(chunk) <= n:
            return chunk
        self._rbuf = chunk
        self._rpos = n
        return chunk[:n]

    def shutdown(self, how=None) -> None:
        self._tx.close()
        self._rx.close()

    def close(self) -> None:
        self._tx.close()
        self._rx.close()


def socketpair() -> tuple[RingSock, RingSock]:
    """Build a connected pair of ring sockets (one ring per
    direction), client end first."""
    c2s = _make_ring()
    s2c = _make_ring()
    with _stats_lock:
        _stats["connections"] += 1
    return RingSock(tx=c2s, rx=s2c), RingSock(tx=s2c, rx=c2s)
