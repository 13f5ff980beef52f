"""Deterministic placement — the CRUSH analog (straw2 selection).

Mirrors the behavioral contract of src/crush (mapper.c
``crush_do_rule``, straw2 buckets; OSDMap::pg_to_up_acting_osds):
object -> PG by stable hash; PG -> N distinct devices by straw2
draws — every device computes ``ln(hash01(pg, device, trial)) /
weight`` and the max wins, which gives weight-proportional placement
and CRUSH's key property: adding/removing/reweighting a device only
moves the PGs that now draw higher for it (minimal data movement).
The hash is a fixed 64-bit mixer, NOT bit-compatible with rjenkins on
purpose — the contract is determinism-forever within THIS framework,
frozen by tests.

Failure domains: devices carry a ``zone``; selection can require
distinct zones first (the chooseleaf host/rack rule analog), falling
back to distinct devices when zones run out.

Deployment wiring: a pool maps each PG's acting set to k+m shard
daemons, then orders the messenger tier's address map by it — shard i
of a stripe lives on acting[i] (the ECSwitch ctor wiring role,
osd/ECSwitch.h:36-48).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

_MASK = 0xFFFFFFFFFFFFFFFF


def _mix(x: int) -> int:
    """splitmix64 finalizer — frozen forever (placement stability)."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def stable_hash(*parts: int | str) -> int:
    h = 0x5EED0FCE
    for p in parts:
        if isinstance(p, str):
            for ch in p.encode():
                h = _mix(h ^ ch)
        else:
            h = _mix(h ^ (p & _MASK))
    return h


def _hash01(*parts) -> float:
    """(0, 1] uniform from the stable hash."""
    return (stable_hash(*parts) + 1) / 2.0**64


@dataclass(frozen=True)
class Device:
    id: int
    weight: float = 1.0
    zone: str = ""


class CrushMap:
    """Weighted device set + straw2 selection."""

    def __init__(self, devices: list[Device]) -> None:
        if len({d.id for d in devices}) != len(devices):
            raise ValueError("duplicate device ids")
        self.devices = {d.id: d for d in devices}

    def _draw(self, key: tuple, dev: Device) -> float:
        """straw2: ln(u)/w — max over devices is weight-proportional."""
        if dev.weight <= 0:
            return -math.inf
        u = _hash01(*key, dev.id)
        return math.log(u) / dev.weight

    def select(
        self, pg: int, n: int, distinct_zones: bool = False
    ) -> list[int]:
        """N distinct devices for a PG, ordered by draw rank (the
        acting set). With ``distinct_zones``, no two picks share a
        zone until zones are exhausted (chooseleaf semantics)."""
        live = [d for d in self.devices.values() if d.weight > 0]
        if n > len(live):
            raise ValueError(f"want {n} devices, have {len(live)}")
        ranked = sorted(
            live, key=lambda d: self._draw((pg,), d), reverse=True
        )
        if not distinct_zones:
            return [d.id for d in ranked[:n]]
        out: list[int] = []
        used_zones: set[str] = set()
        skipped: list[Device] = []
        for d in ranked:
            if len(out) >= n:
                break
            if d.zone and d.zone in used_zones:
                skipped.append(d)
                continue
            out.append(d.id)
            used_zones.add(d.zone)
        for d in skipped:  # zones exhausted: fill with best remaining
            if len(out) >= n:
                break
            out.append(d.id)
        return out


class PGMap:
    """Object -> PG -> acting set (the OSDMap/pg_to_up_acting path)."""

    def __init__(
        self,
        crush: CrushMap,
        pg_num: int,
        pool: str = "default",
    ) -> None:
        if pg_num <= 0:
            raise ValueError("pg_num must be positive")
        self.crush = crush
        self.pg_num = pg_num
        self.pool = pool

    def object_to_pg(self, oid: str) -> int:
        return stable_hash(self.pool, oid) % self.pg_num

    def pg_to_acting(self, pg: int, n: int, **kw) -> list[int]:
        return self.crush.select(stable_hash(self.pool, pg), n, **kw)

    def object_to_acting(self, oid: str, n: int, **kw) -> list[int]:
        return self.pg_to_acting(self.object_to_pg(oid), n, **kw)
