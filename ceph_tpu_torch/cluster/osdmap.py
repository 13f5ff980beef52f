"""OSDMap — the epoch-versioned cluster map (src/osd/OSDMap.h).

Behavioral mirror of the reference's map contract:

- The map is an immutable value at an epoch; changes arrive as
  ``Incremental`` deltas (OSDMap::Incremental, src/osd/OSDMap.h:150)
  applied functionally: ``new_map = old_map.apply(incr)``.
- Devices carry the four orthogonal reference states: **up/down**
  (liveness — flips on failure, does NOT move data) and **in/out**
  (placement membership — flips rebalance data). A down-but-in OSD
  leaves a *hole* in an EC acting set (the CRUSH_ITEM_NONE shard,
  ``SHARD_NONE`` here), which is exactly what makes a PG degraded
  rather than remapped (OSDMap::pg_to_up_acting_osds,
  src/osd/OSDMap.h:1307).
- Pools bind a name/id to pg_num + an EC profile; profiles are
  key→value maps validated by the codec plugin at creation
  (ErasureCodeProfile, erasure-code/ErasureCodeInterface.h:167).
- Placement: object → PG by stable hash, PG → ordered device list by
  straw2 over in-devices (``placement.CrushMap``) — position i of the
  acting set is EC shard i (osd/ECSwitch.h:36-48 wiring).

Maps serialize to framed json (control-plane sizes are tiny) so the
monitor can publish them over the messenger tier.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace

from ceph_tpu_torch.placement import CrushMap, Device, stable_hash

#: Acting-set hole: the shard's OSD is down (CRUSH_ITEM_NONE analog).
SHARD_NONE = -1


@dataclass(frozen=True)
class OSDInfo:
    """One device's map entry (osd_info_t + addrs + weights).
    ``new`` distinguishes a never-booted device (auto-marked in on
    first boot, mon_osd_auto_mark_new_in) from one an operator marked
    out — an OUT osd that reboots STAYS out until `osd in`."""

    id: int
    weight: float = 1.0
    zone: str = ""
    up: bool = False
    in_: bool = False
    addr: tuple[str, int] | None = None
    new: bool = True
    #: crush location, sorted (type, bucket) pairs — e.g.
    #: (("host", "h1"), ("rack", "r2")). Empty = flat placement.
    location: tuple[tuple[str, str], ...] = ()

    def to_obj(self) -> dict:
        return {
            "id": self.id,
            "weight": self.weight,
            "zone": self.zone,
            "up": self.up,
            "in": self.in_,
            "addr": list(self.addr) if self.addr else None,
            "new": self.new,
            "location": [list(kv) for kv in self.location],
        }

    @classmethod
    def from_obj(cls, o: dict) -> "OSDInfo":
        return cls(
            o["id"], o["weight"], o["zone"], o["up"], o["in"],
            tuple(o["addr"]) if o["addr"] else None,
            o.get("new", False),
            tuple(tuple(kv) for kv in o.get("location", ())),
        )


@dataclass(frozen=True)
class PoolSpec:
    """One pool (pg_pool_t): placement params + EC profile binding."""

    name: str
    pool_id: int
    pg_num: int
    profile_name: str
    k: int
    m: int
    plugin: str
    distinct_zones: bool = False
    #: named crush rule (OSDMap.crush_rules); empty = flat straw2
    crush_rule: str = ""
    #: pool snapshots: ((snapid, name, created_epoch), ...) ascending
    #: (pg_pool_t snaps); snap_seq is the next id to issue
    snaps: tuple[tuple[int, str, int], ...] = ()
    snap_seq: int = 0
    #: per-tenant QoS declarations riding the map to every OSD
    #: (cluster/qos.py QoSSpec rows): ((tenant, res_ops, res_bytes,
    #: weight, lim_ops, lim_bytes), ...) ascending by tenant; the
    #: ``""`` tenant is the pool-wide default (the class
    #: ``client.<pool>`` untagged ops fall back to)
    qos: tuple[tuple[str, float, float, float, float, float], ...] = ()

    @property
    def size(self) -> int:
        return self.k + self.m

    @property
    def min_size(self) -> int:
        """Fewest live shards that still allow serving IO (k, as the
        reference defaults EC min_size to k... + 1 is advisory)."""
        return self.k

    def to_obj(self) -> dict:
        return {
            "name": self.name,
            "pool_id": self.pool_id,
            "pg_num": self.pg_num,
            "profile_name": self.profile_name,
            "k": self.k,
            "m": self.m,
            "plugin": self.plugin,
            "distinct_zones": self.distinct_zones,
            "crush_rule": self.crush_rule,
            "snaps": [list(s) for s in self.snaps],
            "snap_seq": self.snap_seq,
            "qos": [list(q) for q in self.qos],
        }

    @classmethod
    def from_obj(cls, o: dict) -> "PoolSpec":
        return cls(
            o["name"], o["pool_id"], o["pg_num"], o["profile_name"],
            o["k"], o["m"], o["plugin"], o["distinct_zones"],
            o.get("crush_rule", ""),
            tuple(tuple(s) for s in o.get("snaps", ())),
            o.get("snap_seq", 0),
            tuple(tuple(q) for q in o.get("qos", ())),
        )


@dataclass(frozen=True)
class Incremental:
    """Epoch delta (OSDMap::Incremental). Field semantics:

    - ``new_osds``: add/replace device entries (boot, crush add,
      reweight — the full entry travels; maps are small).
    - ``down`` / ``up`` / ``out`` / ``in_``: state flips by id.
    - ``new_pools`` / ``removed_pools``, ``new_profiles``.
    """

    epoch: int  # the epoch this incremental PRODUCES
    new_osds: tuple[OSDInfo, ...] = ()
    up: tuple[int, ...] = ()
    down: tuple[int, ...] = ()
    in_: tuple[int, ...] = ()
    out: tuple[int, ...] = ()
    new_pools: tuple[PoolSpec, ...] = ()
    removed_pools: tuple[str, ...] = ()
    new_profiles: tuple[tuple[str, tuple[tuple[str, str], ...]], ...] = ()
    #: pg_temp installs: ((pool, pgid, (osd, ...)), ...) — the PG
    #: serves from this membership until backfill completes
    new_pg_temp: tuple[tuple[str, int, tuple[int, ...]], ...] = ()
    del_pg_temp: tuple[tuple[str, int], ...] = ()
    #: crush rule installs: ((name, ((step, ...), ...)), ...)
    new_rules: tuple[tuple[str, tuple[tuple, ...]], ...] = ()
    #: central config db edits: ((who, name, value-or-None), ...) —
    #: the ConfigMonitor analog (mon/ConfigMonitor.h:15). ``who`` is
    #: "" (global), "osd" (class), or "osd.N"; None value removes.
    #: Riding the map incremental gives the config db the same
    #: Paxos replication, epoch ordering, and subscription push the
    #: map itself has (the reference pairs MConfig with MOSDMap on
    #: the same monitor).
    new_config: tuple[tuple[str, str, "str | None"], ...] = ()

    def to_bytes(self) -> bytes:
        return json.dumps({
            "epoch": self.epoch,
            "new_osds": [o.to_obj() for o in self.new_osds],
            "up": list(self.up),
            "down": list(self.down),
            "in": list(self.in_),
            "out": list(self.out),
            "new_pools": [p.to_obj() for p in self.new_pools],
            "removed_pools": list(self.removed_pools),
            "new_profiles": [
                [n, [list(kv) for kv in prof]] for n, prof in self.new_profiles
            ],
            "new_pg_temp": [
                [pool, pgid, list(acting)]
                for pool, pgid, acting in self.new_pg_temp
            ],
            "del_pg_temp": [list(k) for k in self.del_pg_temp],
            "new_rules": [
                [n, [list(s) for s in steps]]
                for n, steps in self.new_rules
            ],
            "new_config": [list(c) for c in self.new_config],
        }).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Incremental":
        o = json.loads(raw.decode())
        return cls(
            o["epoch"],
            tuple(OSDInfo.from_obj(x) for x in o["new_osds"]),
            tuple(o["up"]),
            tuple(o["down"]),
            tuple(o["in"]),
            tuple(o["out"]),
            tuple(PoolSpec.from_obj(x) for x in o["new_pools"]),
            tuple(o["removed_pools"]),
            tuple(
                (n, tuple(tuple(kv) for kv in prof))
                for n, prof in o["new_profiles"]
            ),
            tuple(
                (pool, pgid, tuple(acting))
                for pool, pgid, acting in o.get("new_pg_temp", ())
            ),
            tuple(tuple(k) for k in o.get("del_pg_temp", ())),
            tuple(
                (n, tuple(tuple(s) for s in steps))
                for n, steps in o.get("new_rules", ())
            ),
            tuple(
                (who, name, val)
                for who, name, val in o.get("new_config", ())
            ),
        )


class OSDMap:
    """Immutable cluster map at one epoch."""

    def __init__(
        self,
        epoch: int = 0,
        osds: dict[int, OSDInfo] | None = None,
        pools: dict[str, PoolSpec] | None = None,
        profiles: dict[str, dict[str, str]] | None = None,
        pg_temp: dict[tuple[str, int], tuple[int, ...]] | None = None,
        crush_rules: dict[str, tuple] | None = None,
        config: dict[tuple[str, str], str] | None = None,
    ) -> None:
        self.epoch = epoch
        self.osds: dict[int, OSDInfo] = dict(osds or {})
        self.pools: dict[str, PoolSpec] = dict(pools or {})
        self.profiles: dict[str, dict[str, str]] = {
            k: dict(v) for k, v in (profiles or {}).items()
        }
        #: (pool, pgid) -> temporary membership serving the PG while
        #: backfill moves data to the CRUSH mapping (OSDMap pg_temp)
        self.pg_temp: dict[tuple[str, int], tuple[int, ...]] = dict(
            pg_temp or {}
        )
        #: named multi-step crush rules (crush_do_rule programs)
        self.crush_rules: dict[str, tuple] = {
            n: tuple(tuple(s) for s in steps)
            for n, steps in (crush_rules or {}).items()
        }
        #: central config db: (who, name) -> value — the mon-
        #: replicated option store (ConfigMonitor analog); daemons
        #: apply their slice into the process config's "mon" layer on
        #: every map they learn
        self.config: dict[tuple[str, str], str] = dict(config or {})
        # straw2 input: in-devices with positive weight. Down-but-in
        # devices STAY (holes, not movement).
        self._crush = CrushMap([
            Device(o.id, o.weight, o.zone)
            for o in self.osds.values()
            if o.in_ and o.weight > 0
        ])
        # Bucket hierarchy for rule-based pools: built from device
        # locations (out devices excluded — they contribute no
        # weight anywhere, so whole subtrees can empty out).
        # Non-strict: a historical map must always LOAD; the monitor
        # rejects conflicting locations at command time.
        from ceph_tpu_torch.crush import CrushHierarchy

        self._hierarchy = CrushHierarchy(strict=False)
        for o in self.osds.values():
            if o.in_ and o.weight > 0:
                self._hierarchy.add_device(
                    Device(o.id, o.weight, o.zone), dict(o.location)
                )

    # -- placement arithmetic ------------------------------------------
    def object_to_pg(self, pool: str, oid: str) -> int:
        spec = self._pool(pool)
        return stable_hash(str(spec.pool_id), oid) % spec.pg_num

    def pg_to_raw(
        self, pool: str, pg: int, ignore_temp: bool = False
    ) -> list[int]:
        """Membership for a PG, ignoring up/down: position i is EC
        shard i. A pg_temp override wins (the PG serves from its OLD
        layout while backfill runs); ``ignore_temp`` asks for the pure
        CRUSH mapping — the backfill TARGET. This is the REBALANCE
        identity — it changes only when devices are added/removed/
        reweighted/outed (or pg_temp flips), never on a liveness flip,
        so callers can tell 'same members, one down' (heal + log
        recovery) from 'different members' (backfill). Short when the
        cluster has fewer in-devices than k+m."""
        spec = self._pool(pool)
        if not ignore_temp:
            temp = self.pg_temp.get((pool, pg))
            if temp is not None:
                return list(temp)
        if spec.crush_rule and spec.crush_rule in self.crush_rules:
            raw = self._hierarchy.run_rule(
                self.crush_rules[spec.crush_rule],
                (stable_hash(str(spec.pool_id), pg),),
                spec.size,
            )
        else:
            n = min(spec.size, len(self._crush.devices))
            raw = self._crush.select(
                stable_hash(str(spec.pool_id), pg),
                n,
                distinct_zones=spec.distinct_zones,
            ) if n else []
        return raw + [SHARD_NONE] * (spec.size - len(raw))

    def pg_to_up_acting(self, pool: str, pg: int) -> list[int]:
        """Ordered acting set for a PG; position i is EC shard i. Down
        OSDs appear as ``SHARD_NONE`` holes (degraded, not remapped).
        When fewer in-devices exist than k+m, the tail positions are
        holes too (the undersized-PG state — CRUSH simply runs out)."""
        return [
            o if o != SHARD_NONE and self.osds[o].up else SHARD_NONE
            for o in self.pg_to_raw(pool, pg)
        ]

    def object_to_acting(self, pool: str, oid: str) -> list[int]:
        return self.pg_to_up_acting(pool, self.object_to_pg(pool, oid))

    def pg_primary(self, pool: str, pg: int) -> int:
        """First live shard-holder of a PG (the EC primary rule);
        SHARD_NONE if every acting shard is down. THE primary
        selection — client targeting and OSD self-identification must
        agree for the eagain retry contract to converge."""
        for o in self.pg_to_up_acting(pool, pg):
            if o != SHARD_NONE:
                return o
        return SHARD_NONE

    def primary(self, pool: str, oid: str) -> int:
        return self.pg_primary(pool, self.object_to_pg(pool, oid))

    def _pool(self, pool: str) -> PoolSpec:
        spec = self.pools.get(pool)
        if spec is None:
            raise KeyError(f"no such pool: {pool!r}")
        return spec

    # -- state queries --------------------------------------------------
    def is_up(self, osd: int) -> bool:
        return osd in self.osds and self.osds[osd].up

    def get_addr(self, osd: int) -> tuple[str, int] | None:
        info = self.osds.get(osd)
        return info.addr if info else None

    def up_osds(self) -> set[int]:
        return {o.id for o in self.osds.values() if o.up}

    # -- evolution ------------------------------------------------------
    def apply(self, incr: Incremental) -> "OSDMap":
        if incr.epoch != self.epoch + 1:
            raise ValueError(
                f"incremental {incr.epoch} does not follow epoch {self.epoch}"
            )
        osds = dict(self.osds)
        for o in incr.new_osds:
            osds[o.id] = o
        for i in incr.up:
            osds[i] = replace(osds[i], up=True)
        for i in incr.down:
            osds[i] = replace(osds[i], up=False)
        for i in incr.in_:
            osds[i] = replace(osds[i], in_=True)
        for i in incr.out:
            osds[i] = replace(osds[i], in_=False)
        pools = dict(self.pools)
        for p in incr.new_pools:
            pools[p.name] = p
        for name in incr.removed_pools:
            pools.pop(name, None)
        profiles = {k: dict(v) for k, v in self.profiles.items()}
        for name, prof in incr.new_profiles:
            profiles[name] = dict(prof)
        pg_temp = dict(self.pg_temp)
        for pool, pgid, acting in incr.new_pg_temp:
            pg_temp[(pool, pgid)] = tuple(acting)
        for key in incr.del_pg_temp:
            pg_temp.pop(tuple(key), None)
        for name in incr.removed_pools:
            pg_temp = {
                k: v for k, v in pg_temp.items() if k[0] != name
            }
        rules = dict(self.crush_rules)
        for name, steps in incr.new_rules:
            rules[name] = tuple(tuple(s) for s in steps)
        cfg = dict(self.config)
        for who, name, val in incr.new_config:
            if val is None:
                cfg.pop((who, name), None)
            else:
                cfg[(who, name)] = val
        return OSDMap(
            self.epoch + 1, osds, pools, profiles, pg_temp, rules, cfg
        )

    # -- serialization --------------------------------------------------
    def to_bytes(self) -> bytes:
        return json.dumps({
            "epoch": self.epoch,
            "osds": [o.to_obj() for o in self.osds.values()],
            "pools": [p.to_obj() for p in self.pools.values()],
            "profiles": self.profiles,
            "pg_temp": [
                [pool, pgid, list(acting)]
                for (pool, pgid), acting in self.pg_temp.items()
            ],
            "crush_rules": [
                [n, [list(s) for s in steps]]
                for n, steps in self.crush_rules.items()
            ],
            "config": [
                [who, name, val]
                for (who, name), val in self.config.items()
            ],
        }).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "OSDMap":
        o = json.loads(raw.decode())
        return cls(
            o["epoch"],
            {x["id"]: OSDInfo.from_obj(x) for x in o["osds"]},
            {x["name"]: PoolSpec.from_obj(x) for x in o["pools"]},
            o["profiles"],
            {
                (pool, pgid): tuple(acting)
                for pool, pgid, acting in o.get("pg_temp", ())
            },
            {
                n: tuple(tuple(s) for s in steps)
                for n, steps in o.get("crush_rules", ())
            },
            {
                (who, name): val
                for who, name, val in o.get("config", ())
            },
        )

    def __repr__(self) -> str:
        up = sum(1 for o in self.osds.values() if o.up)
        return (
            f"OSDMap(e{self.epoch}, {len(self.osds)} osds ({up} up), "
            f"{len(self.pools)} pools)"
        )
