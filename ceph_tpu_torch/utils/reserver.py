"""AsyncReserver — bounded background-work slots with priority
queueing (the reference's common/AsyncReserver.h, used by the OSD as
``local_reserver``/``remote_reserver`` to gate backfill concurrency
per the backfill_reservation.rst protocol).

Each OSD grants at most ``max_allowed()`` concurrent reservations;
further requests queue by (priority desc, arrival order) and are
granted as slots free up. Grants fire the request's callback on the
releasing thread (callbacks must be cheap/queue-flipping — the
reference schedules a Context the same way)."""

from __future__ import annotations

import itertools
import threading
from collections.abc import Callable


class AsyncReserver:
    def __init__(self, max_allowed: Callable[[], int]) -> None:
        self._max = max_allowed
        self._lock = threading.Lock()
        self._held: set = set()
        #: queued: key -> (prio, seq, grant_cb)
        self._queued: dict = {}
        self._seq = itertools.count()

    def request(self, key, prio: int, grant_cb: Callable[[], None]) -> None:
        """Queue a reservation; ``grant_cb`` fires (possibly
        immediately, on this thread) when a slot is granted.

        Re-requesting is IDEMPOTENT-WITH-REGRANT, not a no-op: a key
        already held fires the new callback immediately, and a queued
        key's callback is REPLACED (keeping its arrival order). Over
        RPC this matters: a requester that timed out and retries
        sends a fresh tid — its old callback would answer a dead
        request, wedging the slot forever (round-5 review finding)."""
        grant = False
        with self._lock:
            if key in self._held:
                grant = True
            elif key in self._queued:
                prio0, seq0, _stale = self._queued[key]
                self._queued[key] = (prio0, seq0, grant_cb)
            elif len(self._held) < max(1, self._max()):
                self._held.add(key)
                grant = True
            else:
                self._queued[key] = (prio, next(self._seq), grant_cb)
        if grant:
            grant_cb()

    def cancel(self, key) -> None:
        """Withdraw a queued OR held reservation (release semantics
        for held keys: the next queued request gets the slot)."""
        self.release(key)

    def release(self, key) -> None:
        grants: list[Callable[[], None]] = []
        with self._lock:
            self._queued.pop(key, None)
            self._held.discard(key)
            while self._queued and len(self._held) < max(1, self._max()):
                next_key = min(
                    self._queued,
                    key=lambda k: (-self._queued[k][0], self._queued[k][1]),
                )
                _prio, _seq, cb = self._queued.pop(next_key)
                self._held.add(next_key)
                grants.append(cb)
        for cb in grants:
            cb()

    def held(self) -> int:
        with self._lock:
            return len(self._held)

    def queued(self) -> int:
        with self._lock:
            return len(self._queued)

    def has(self, key) -> bool:
        with self._lock:
            return key in self._held
