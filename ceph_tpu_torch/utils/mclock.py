"""mClock QoS scheduler — the dmclock analog (osd/scheduler/
mClockScheduler.{h,cc} + the vendored src/dmclock library).

The reference arbitrates OSD work between client IO, recovery,
backfill and scrub with the mClock algorithm (Gulati et al., OSDI'10):
each class gets a **reservation** (minimum service rate it is
guaranteed), a **weight** (share of spare capacity) and a **limit**
(service-rate cap), all in COST UNITS per second — cost is
byte-proportional at the call sites (cluster/qos.py), so a 4 MB push
advances a clock ~65x further than a 4 KB stat.  Every request is
tagged on arrival relative to its class's previous request (mClock
paper, Algorithm 1):

    R_i = max(now, R_{i-1} + cost/reservation)   (guarantee clock)
    P_i = max(now, P_{i-1} + cost/weight)        (proportional clock)
    L_i = max(now, L_{i-1} + cost/limit)         (cap clock)

and dequeue runs two phases:

1. **constraint-based**: any head whose R tag has matured runs first
   (smallest R) — reservations are met before everything else;
2. **weight-based**: otherwise the smallest P tag among heads whose L
   tag has matured — spare capacity splits by weight, capped by
   limits. The chosen class's queued R tags shift back by one
   reservation quantum (the paper's adjustment so weight-phase service
   doesn't also consume the reservation).

Classes are DYNAMIC (the dmclock client-registry role): tenant-tagged
client ops enqueue as ``client.<tenant>`` and untagged ops as
``client.<pool>``; a dotted class with no profile of its own inherits
its prefix's profile (``client.gold`` -> the ``client`` row) until a
per-tenant QoS spec (stored in pool metadata, pushed with the osdmap)
registers one.  ``set_profiles`` swaps the whole profile table LIVE:
existing queues re-bind to the new rates immediately — already-issued
tags stand, the next enqueue advances from them at the new rate (how
the reference applies ``osd_mclock_profile`` changes without a
scheduler rebuild).

A class that goes idle and returns gets its clocks re-anchored at
``now`` (the idle-client adjustment): no banked credit, no penalty.

Observability: every class counts reservation-phase and weight-phase
dequeues, limit-throttle stalls and served cost; ``dump()`` returns
the live per-class tags, depths and tag-lag (the admin-socket
``dump_mclock`` surface).

Pure and clock-injected: deterministic under test, wall-clock in the
daemon.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass


@dataclass(frozen=True)
class ClientProfile:
    """QoS knobs for one class (osd_mclock_scheduler_*_{res,wgt,lim})."""

    reservation: float = 0.0  # cost units/sec guaranteed (0 = none)
    weight: float = 1.0       # share of spare capacity
    limit: float = 0.0        # cost units/sec cap (0 = unlimited)


#: the reference's balanced-profile shape (osd_mclock_profile=balanced:
#: client vs background recovery/backfill/scrub allocations)
BALANCED_PROFILE = {
    "client": ClientProfile(reservation=50.0, weight=2.0, limit=0.0),
    "recovery": ClientProfile(reservation=25.0, weight=1.0, limit=100.0),
    "backfill": ClientProfile(reservation=10.0, weight=0.5, limit=100.0),
    "scrub": ClientProfile(reservation=0.0, weight=0.2, limit=50.0),
    "gc": ClientProfile(reservation=0.0, weight=0.2, limit=50.0),
}


class _Entry:
    __slots__ = ("item", "cost", "r", "p", "l")

    def __init__(self, item, cost, r, p, l) -> None:
        self.item = item
        self.cost = cost
        self.r = r
        self.p = p
        self.l = l


class _ClassQueue:
    __slots__ = (
        "profile", "q", "prev_r", "prev_p", "prev_l", "last_seen",
        "enqueued", "dequeued_r", "dequeued_p", "throttled",
        "served_cost",
    )

    def __init__(self, profile: ClientProfile) -> None:
        self.profile = profile
        self.q: deque[_Entry] = deque()
        self.prev_r = 0.0
        self.prev_p = 0.0
        self.prev_l = 0.0
        self.last_seen = -math.inf
        # lifetime service accounting (the qos perf set reads these)
        self.enqueued = 0
        self.dequeued_r = 0
        self.dequeued_p = 0
        self.throttled = 0
        self.served_cost = 0.0


class MClockScheduler:
    """Single-server mClock over named, dynamically created classes."""

    def __init__(
        self,
        profiles: dict[str, ClientProfile] | None = None,
        clock=time.monotonic,
        idle_age: float = 1.0,
    ) -> None:
        self.profiles = dict(profiles or BALANCED_PROFILE)
        self.clock = clock
        self.idle_age = idle_age
        self._classes: dict[str, _ClassQueue] = {}

    def _profile_for(self, name: str) -> ClientProfile:
        """Resolve a class name to its profile: exact row, else the
        dotted prefix's row (``client.gold`` -> ``client``) — how an
        unregistered tenant inherits the pool-wide client QoS."""
        prof = self.profiles.get(name)
        if prof is not None:
            return prof
        if "." in name:
            prof = self.profiles.get(name.split(".", 1)[0])
            if prof is not None:
                return prof
        return ClientProfile()

    def _class(self, name: str) -> _ClassQueue:
        cq = self._classes.get(name)
        if cq is None:
            cq = _ClassQueue(self._profile_for(name))
            self._classes[name] = cq
        return cq

    def set_profiles(
        self, profiles: dict[str, ClientProfile]
    ) -> None:
        """Swap the profile table live (QoS spec push / slosh-knob
        turn): every existing class re-resolves against the new table.
        Issued tags stand; the next enqueue advances at the new rate."""
        self.profiles = dict(profiles)
        for name, cq in self._classes.items():
            cq.profile = self._profile_for(name)

    def set_profile(self, name: str, profile: ClientProfile) -> None:
        """Register/replace one class's profile live (a per-tenant QoS
        spec landing from the map push)."""
        self.profiles[name] = profile
        for cls, cq in self._classes.items():
            cq.profile = self._profile_for(cls)

    def __len__(self) -> int:
        return sum(len(c.q) for c in self._classes.values())

    # -- enqueue: per-request tags (Algorithm 1) ------------------------
    def enqueue(self, class_name: str, item, cost: float = 1.0) -> None:
        now = self.clock()
        cq = self._class(class_name)
        p = cq.profile
        if not cq.q and now - cq.last_seen > self.idle_age:
            # idle-client adjustment: re-anchor, no banked credit
            cq.prev_r = cq.prev_p = cq.prev_l = now
            # first request after idle is immediately eligible
            r = now if p.reservation > 0 else math.inf
            pt = now
            lt = now
        else:
            r = (
                max(now, cq.prev_r + cost / p.reservation)
                if p.reservation > 0 else math.inf
            )
            pt = max(now, cq.prev_p + cost / max(p.weight, 1e-9))
            lt = (
                max(now, cq.prev_l + cost / p.limit)
                if p.limit > 0 else now
            )
        cq.prev_r = r if r != math.inf else cq.prev_r
        cq.prev_p = pt
        cq.prev_l = lt
        cq.last_seen = now
        cq.enqueued += 1
        cq.q.append(_Entry(item, cost, r, pt, lt))

    # -- dequeue: two-phase pick ---------------------------------------
    def dequeue(self) -> tuple[str, object] | None:
        """Pop the next runnable (class, item); None when the queue is
        empty or every class is limit-gated right now."""
        now = self.clock()
        heads = [
            (name, cq) for name, cq in self._classes.items() if cq.q
        ]
        if not heads:
            return None
        # phase 1: constraint-based (matured reservations, smallest R)
        ready = [
            (cq.q[0].r, name, cq) for name, cq in heads
            if cq.q[0].r <= now
        ]
        if ready:
            _, name, cq = min(ready)
            entry = cq.q.popleft()
            cq.last_seen = now
            cq.dequeued_r += 1
            cq.served_cost += entry.cost
            return (name, entry.item)
        # phase 2: weight-based among classes under their limit
        eligible = [
            (cq.q[0].p, name, cq) for name, cq in heads
            if cq.q[0].l <= now
        ]
        if eligible:
            _, name, cq = min(eligible)
            entry = cq.q.popleft()
            # weight-phase service must not also consume reservation
            # credit: shift the class's queued R tags one quantum back
            if cq.profile.reservation > 0:
                delta = entry.cost / cq.profile.reservation
                for e in cq.q:
                    e.r -= delta
                cq.prev_r -= delta
            cq.last_seen = now
            cq.dequeued_p += 1
            cq.served_cost += entry.cost
            return (name, entry.item)
        # every queued class is limit-gated: a throttle stall
        for _name, cq in heads:
            cq.throttled += 1
        return None

    def next_ready(self) -> float | None:
        """Earliest time a dequeue could succeed (for worker sleeps)."""
        times = []
        for cq in self._classes.values():
            if cq.q:
                times.append(min(cq.q[0].r, cq.q[0].l))
        return min(times) if times else None

    # -- introspection (the dump_mclock surface) ------------------------
    def dump(self) -> dict:
        """Live per-class state: profile rates, queue depth, head
        tags, tag-lag (head R or L tag minus now — how far behind or
        ahead of its clocks the class is), and the lifetime service
        counters.  Classes with no queue and no history are elided."""
        now = self.clock()
        out: dict[str, dict] = {}
        for name, cq in sorted(self._classes.items()):
            head = cq.q[0] if cq.q else None
            tag_lag = 0.0
            if head is not None:
                gate = head.r if head.r != math.inf else head.l
                tag_lag = max(gate - now, 0.0)
            out[name] = {
                "profile": {
                    "reservation": cq.profile.reservation,
                    "weight": cq.profile.weight,
                    "limit": cq.profile.limit,
                },
                "depth": len(cq.q),
                "head_tags": None if head is None else {
                    "r": None if head.r == math.inf else head.r,
                    "p": head.p,
                    "l": head.l,
                    "cost": head.cost,
                },
                "tag_lag_s": tag_lag,
                "enqueued": cq.enqueued,
                "dequeued_r": cq.dequeued_r,
                "dequeued_p": cq.dequeued_p,
                "throttled": cq.throttled,
                "served_cost": cq.served_cost,
            }
        return out
