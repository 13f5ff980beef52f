"""PG-stats aggregation — the PGMap / MgrStatMonitor analog.

The reference's stats plane is a reporting pipeline: every primary
periodically ships one ``pg_stats_t`` record per PG it leads inside an
``MPGStats`` message (osd/osd_types.h, mon/MgrStatMonitor.cc); the mgr
folds those into the ``PGMap`` — per-pool and cluster object/byte
totals, degraded/misplaced tallies, a PG state histogram, windowed
client-IO and recovery rates — and every operator surface (``ceph
-s``, ``ceph pg dump``, ``ceph df``, the prometheus module) reads the
aggregate instead of poking daemons.

This module is that fold. :class:`PGStats` is the in-process
``pg_stats_t``/``MPGStats`` payload (versioned per reporter, stamped
with the reporting epoch); :class:`PGMap` is the monitor/mgr-side
aggregate:

- **stale-report rejection**: a record is rejected when its reported
  epoch is older than the stored one, or when it ties the stored
  epoch but comes from a different OSD (a takeover always moves the
  map forward, so a demoted primary can never outrank the member that
  superseded it — the ``pg_stats_t::reported`` discard rule);
- **rate windows**: each accepted report appends a per-pool sample of
  the cumulative client/recovery counters to a small time-series
  ring; windowed rates are the clamped delta over the ring span (a
  primary takeover resets the per-PG counters, so negative deltas
  clamp to zero instead of poisoning the window);
- **stuck-PG ages**: the stamp of each PG's last clean report feeds
  the mgr's ``PG_STUCK`` check (``mon_pg_stuck_threshold``);
- **observability**: a ``pgmap`` gauge set plus per-pool
  ``pgmap.pool.<name>`` sets ride perf dump and the Prometheus
  exporter (the exporter renders ``.pool.`` set names with a ``pool``
  label), and PG state transitions into/out of degraded land in the
  cluster log;
- **surfaces**: :func:`status_dict`/:func:`format_status` (the
  ``ceph -s`` shape), :meth:`PGMap.pg_dump`/:func:`format_pg_dump`
  (``ceph pg dump``), :meth:`PGMap.df`/:func:`format_df` (``ceph
  df``), and the admin-socket ``pgmap`` command (latest instance).
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from ceph_tpu_torch.utils.lockdep import DebugLock

#: the state vocabulary reports may carry (pg_state_t bit names)
PG_STATES = (
    "active", "clean", "peering", "down", "undersized", "degraded",
    "recovering", "backfilling",
)

#: seconds of cumulative-counter history kept per pool (rate window)
RATE_WINDOW_S = 10.0
#: ring slots per pool (samples arrive once per report interval)
RATE_RING = 64

#: the most recently constructed PGMap (admin-socket ``pgmap`` dump
#: target — one live cluster per process in every in-tree harness)
_current_pgmap: "weakref.ref[PGMap] | None" = None


def current_pgmap() -> "PGMap | None":
    return _current_pgmap() if _current_pgmap is not None else None


def _register_admin() -> None:
    """Hang the ``pgmap`` command on the process admin socket.  The
    registration lives HERE (not in utils/admin_socket.py's builtins)
    so the utils tier never imports up into the cluster tier — ECLint
    EC101 pins that layering."""
    from ceph_tpu_torch.utils.admin_socket import admin_socket

    def _dump():
        pgmap = current_pgmap()
        return pgmap.dump() if pgmap is not None else {}

    try:
        admin_socket.register(
            "pgmap", _dump,
            "the PGMap aggregate (per-PG stats, pool/cluster totals, "
            "state histogram, windowed IO/recovery rates)",
        )
    except ValueError:
        pass  # already registered (module reloaded)


_register_admin()


@dataclass
class PGStats:
    """One primary's per-PG report record (pg_stats_t analog)."""

    pool: str
    pool_id: int
    pgid: int
    #: state bits, sorted (subset of PG_STATES)
    state: tuple[str, ...]
    up: tuple[int, ...] = ()
    acting: tuple[int, ...] = ()
    num_objects: int = 0
    #: logical bytes (pre-EC object sizes summed)
    num_bytes: int = 0
    #: missing object shard-copies (objects x degraded positions)
    degraded: int = 0
    #: shard-copies served off their CRUSH target (pg_temp/backfill)
    misplaced: int = 0
    log_size: int = 0
    #: cumulative client IO through this primary's pipelines
    client_write_ops: int = 0
    client_write_bytes: int = 0
    client_read_ops: int = 0
    client_read_bytes: int = 0
    #: cumulative recovery work (pushes rebuilt + bytes written)
    recovery_ops: int = 0
    recovery_bytes: int = 0
    #: map epoch the reporter held when it built the record
    reported_epoch: int = 0
    #: reporter-local monotonic sequence (versioned reports)
    reported_seq: int = 0
    #: the reporting (primary) OSD
    primary: int = -1

    def state_str(self) -> str:
        return "+".join(self.state) if self.state else "unknown"

    def as_dict(self) -> dict:
        return {
            "pgid": f"{self.pool}/{self.pgid}",
            "state": self.state_str(),
            "up": list(self.up),
            "acting": list(self.acting),
            "objects": self.num_objects,
            "bytes": self.num_bytes,
            "degraded": self.degraded,
            "misplaced": self.misplaced,
            "log_size": self.log_size,
            "client_write_ops": self.client_write_ops,
            "client_write_bytes": self.client_write_bytes,
            "client_read_ops": self.client_read_ops,
            "client_read_bytes": self.client_read_bytes,
            "recovery_ops": self.recovery_ops,
            "recovery_bytes": self.recovery_bytes,
            "reported": f"{self.reported_epoch}:{self.reported_seq}",
            "primary": self.primary,
        }


@dataclass
class OSDStat:
    """One daemon's store usage (osd_stat_t analog)."""

    osd: int
    used_bytes: int = 0
    capacity_bytes: int = 0
    num_objects: int = 0
    reported_epoch: int = 0

    def fill_frac(self) -> float:
        if self.capacity_bytes <= 0:
            return 0.0
        return self.used_bytes / self.capacity_bytes


@dataclass
class _PoolRates:
    """Per-pool cumulative-counter ring feeding windowed rates."""

    ring: deque = field(default_factory=lambda: deque(maxlen=RATE_RING))


_SUM_KEYS = (
    "client_write_bytes", "client_write_ops",
    "client_read_bytes", "client_read_ops",
    "recovery_bytes", "recovery_ops",
)


class PGMap:
    """The mgr-side aggregate of every primary's PG-stats reports."""

    def __init__(self, clock=time.monotonic) -> None:
        global _current_pgmap
        self._lock = DebugLock("mon.pgmap")
        self._clock = clock
        #: (pool_id, pgid) -> latest accepted PGStats
        self.pg: dict[tuple[int, int], PGStats] = {}
        #: osd id -> latest OSDStat
        self.osd: dict[int, OSDStat] = {}
        #: (pool_id, pgid) -> monotonic stamp of the last CLEAN report
        #: (first-seen stamp until one arrives) — stuck-PG ages
        self._last_clean: dict[tuple[int, int], float] = {}
        self._rates: dict[int, _PoolRates] = {}
        #: pool_id -> name (latest report wins; pool renames don't
        #: exist, deletions prune via prune_pools)
        self._pool_names: dict[int, str] = {}
        self.version = 0
        self._perf = None
        self._pool_perf: dict[str, object] = {}
        _current_pgmap = weakref.ref(self)

    # -- ingress (the MPGStats fold) ------------------------------------
    def apply_report(
        self,
        osd: int,
        epoch: int,
        pg_stats: "list[PGStats]" = (),
        osd_stat: "OSDStat | None" = None,
    ) -> int:
        """Fold one daemon's report; returns how many per-PG records
        were accepted (rejected = stale interval, see module doc)."""
        accepted = 0
        transitions: list[tuple[PGStats, bool]] = []
        now = self._clock()
        with self._lock:
            pools_touched: set[int] = set()
            for s in pg_stats:
                key = (s.pool_id, s.pgid)
                cur = self.pg.get(key)
                if cur is not None:
                    if s.reported_epoch < cur.reported_epoch:
                        self._count("reports_rejected")
                        continue
                    if (
                        s.reported_epoch == cur.reported_epoch
                        and s.primary != cur.primary
                    ):
                        # two claimants in one epoch: a real takeover
                        # always advances the map, so the later claim
                        # is the stale one
                        self._count("reports_rejected")
                        continue
                    if (
                        s.primary == cur.primary
                        and s.reported_epoch == cur.reported_epoch
                        and s.reported_seq < cur.reported_seq
                    ):
                        self._count("reports_rejected")
                        continue
                was_degraded = (
                    cur is not None and "degraded" in cur.state
                )
                self.pg[key] = s
                self._pool_names[s.pool_id] = s.pool
                pools_touched.add(s.pool_id)
                if "clean" in s.state or key not in self._last_clean:
                    self._last_clean[key] = now
                accepted += 1
                is_degraded = "degraded" in s.state
                if is_degraded != was_degraded:
                    transitions.append((s, is_degraded))
            if osd_stat is not None:
                osd_stat.reported_epoch = epoch
                self.osd[osd_stat.osd] = osd_stat
            if accepted or osd_stat is not None:
                self.version += 1
                self._count("reports")
            for pool_id in pools_touched:
                self._sample_pool_locked(pool_id, now)
        for s, entered in transitions:
            self._log_transition(s, entered)
        if accepted or osd_stat is not None:
            self._refresh_perf()
        return accepted

    def prune_pools(self, live_pool_ids: "set[int]") -> None:
        """Drop state for deleted pools (mon map-change hook)."""
        with self._lock:
            for key in [k for k in self.pg if k[0] not in live_pool_ids]:
                del self.pg[key]
                self._last_clean.pop(key, None)
            for pid in [
                p for p in self._pool_names if p not in live_pool_ids
            ]:
                self._pool_names.pop(pid, None)
                self._rates.pop(pid, None)

    def _count(self, key: str) -> None:
        # caller may hold the lock; perf sets have their own
        pc = self._ensure_perf()
        pc.inc(key)

    def _log_transition(self, s: PGStats, entered: bool) -> None:
        from ceph_tpu_torch.utils.cluster_log import cluster_log

        if entered:
            cluster_log.log(
                "mgr", "pg_degraded",
                f"pg {s.pool}/{s.pgid} is {s.state_str()} "
                f"({s.degraded} degraded object copies)",
                severity="WRN", epoch=s.reported_epoch,
            )
        else:
            cluster_log.log(
                "mgr", "pg_clean",
                f"pg {s.pool}/{s.pgid} is {s.state_str()}",
                epoch=s.reported_epoch,
            )

    # -- rate rings -----------------------------------------------------
    def _sample_pool_locked(self, pool_id: int, now: float) -> None:
        sums = {k: 0 for k in _SUM_KEYS}
        for (pid, _pgid), s in self.pg.items():
            if pid != pool_id:
                continue
            for k in _SUM_KEYS:
                sums[k] += getattr(s, k)
        ring = self._rates.setdefault(pool_id, _PoolRates()).ring
        if ring and now - ring[-1][0] < 0.02:
            ring[-1] = (now, sums)  # coalesce near-simultaneous
        else:
            ring.append((now, sums))

    def rates(
        self, pool_id: "int | None" = None, window: float = RATE_WINDOW_S
    ) -> dict:
        """Windowed per-pool (or cluster-total) rates from successive
        report deltas: bytes/s and ops/s for client reads, client
        writes and recovery. Negative deltas (primary takeover reset
        the cumulative counters) clamp to zero."""
        out = {
            "client_read_bps": 0.0, "client_write_bps": 0.0,
            "client_read_iops": 0.0, "client_write_iops": 0.0,
            "recovery_bps": 0.0, "recovery_ops_per_s": 0.0,
        }
        name_of = {
            "client_read_bytes": "client_read_bps",
            "client_write_bytes": "client_write_bps",
            "client_read_ops": "client_read_iops",
            "client_write_ops": "client_write_iops",
            "recovery_bytes": "recovery_bps",
            "recovery_ops": "recovery_ops_per_s",
        }
        now = self._clock()
        with self._lock:
            pools = (
                [pool_id] if pool_id is not None else list(self._rates)
            )
            for pid in pools:
                pr = self._rates.get(pid)
                if pr is None or len(pr.ring) < 2:
                    continue
                newest_t, newest = pr.ring[-1]
                # oldest sample still inside the window
                base_t, base = None, None
                for t, sums in pr.ring:
                    if now - t <= window:
                        base_t, base = t, sums
                        break
                if base is None or newest_t - base_t <= 0:
                    continue
                span = newest_t - base_t
                for k in _SUM_KEYS:
                    d = max(newest[k] - base[k], 0)
                    out[name_of[k]] += d / span
        return {k: round(v, 3) for k, v in out.items()}

    # -- aggregation ----------------------------------------------------
    def state_histogram(self) -> dict[str, int]:
        with self._lock:
            hist: dict[str, int] = {}
            for s in self.pg.values():
                key = s.state_str()
                hist[key] = hist.get(key, 0) + 1
        return hist

    def totals(self) -> dict:
        with self._lock:
            t = {
                "pgs": len(self.pg),
                "objects": 0, "bytes": 0,
                "degraded_objects": 0, "misplaced_objects": 0,
                "pgs_degraded": 0, "pgs_active": 0, "pgs_clean": 0,
            }
            for s in self.pg.values():
                t["objects"] += s.num_objects
                t["bytes"] += s.num_bytes
                t["degraded_objects"] += s.degraded
                t["misplaced_objects"] += s.misplaced
                if "degraded" in s.state:
                    t["pgs_degraded"] += 1
                if "active" in s.state:
                    t["pgs_active"] += 1
                if "clean" in s.state:
                    t["pgs_clean"] += 1
            t["osd_used_bytes"] = sum(
                o.used_bytes for o in self.osd.values()
            )
            t["osd_capacity_bytes"] = sum(
                o.capacity_bytes for o in self.osd.values()
            )
        return t

    def pool_totals(self) -> dict[str, dict]:
        with self._lock:
            pools: dict[str, dict] = {}
            for (pid, _pgid), s in self.pg.items():
                p = pools.setdefault(s.pool, {
                    "pool_id": pid, "pgs": 0, "objects": 0,
                    "bytes": 0, "degraded_objects": 0,
                    "misplaced_objects": 0,
                })
                p["pgs"] += 1
                p["objects"] += s.num_objects
                p["bytes"] += s.num_bytes
                p["degraded_objects"] += s.degraded
                p["misplaced_objects"] += s.misplaced
        for name, p in pools.items():
            p["rates"] = self.rates(p["pool_id"])
        return pools

    def get(self, pool_id: int, pgid: int) -> "PGStats | None":
        with self._lock:
            return self.pg.get((pool_id, pgid))

    def entries(
        self, pool_ids: "set[int] | None" = None
    ) -> list[tuple[tuple[int, int], PGStats]]:
        """Snapshot of (key, stats) pairs, optionally filtered to a
        pool-id set (the mgr health model's read)."""
        with self._lock:
            return [
                (key, s) for key, s in self.pg.items()
                if pool_ids is None or key[0] in pool_ids
            ]

    def degraded_objects(self) -> int:
        with self._lock:
            return sum(s.degraded for s in self.pg.values())

    def stuck_pgs(self, threshold_s: float) -> list[dict]:
        """PGs whose last clean report is older than the threshold
        and which are currently not clean — the PG_STUCK feed."""
        now = self._clock()
        out = []
        with self._lock:
            for key, s in self.pg.items():
                if "clean" in s.state:
                    continue
                age = now - self._last_clean.get(key, now)
                if age >= threshold_s:
                    out.append({
                        "pgid": f"{s.pool}/{s.pgid}",
                        "state": s.state_str(),
                        "stuck_for_s": round(age, 3),
                    })
        out.sort(key=lambda r: -r["stuck_for_s"])
        return out

    def nearfull_osds(self, ratio: float) -> list[dict]:
        with self._lock:
            return [
                {
                    "osd": o.osd,
                    "fill_frac": round(o.fill_frac(), 4),
                    "used_bytes": o.used_bytes,
                    "capacity_bytes": o.capacity_bytes,
                }
                for o in sorted(self.osd.values(), key=lambda x: x.osd)
                if o.capacity_bytes > 0 and o.fill_frac() >= ratio
            ]

    # -- dump surfaces --------------------------------------------------
    def pg_dump(self) -> dict:
        """The ``ceph pg dump`` shape: every PG row + osd stats."""
        now = self._clock()
        with self._lock:
            rows = []
            for key in sorted(self.pg):
                s = self.pg[key]
                row = s.as_dict()
                row["since_clean_s"] = round(
                    now - self._last_clean.get(key, now), 3
                )
                rows.append(row)
            osds = [
                {
                    "osd": o.osd,
                    "used_bytes": o.used_bytes,
                    "capacity_bytes": o.capacity_bytes,
                    "objects": o.num_objects,
                    "fill_frac": round(o.fill_frac(), 4),
                }
                for o in sorted(self.osd.values(), key=lambda x: x.osd)
            ]
        return {
            "version": self.version,
            "pg_stats": rows,
            "osd_stats": osds,
        }

    def df(self, osdmap=None) -> dict:
        """The ``ceph df`` shape: cluster capacity + per-pool usage.
        Raw usage estimates stored x (k+m)/k when the map is given
        (EC overhead), else reports logical bytes only."""
        totals = self.totals()
        cap = totals["osd_capacity_bytes"]
        used = totals["osd_used_bytes"]
        out = {
            "cluster": {
                "capacity_bytes": cap,
                "used_bytes": used,
                "avail_bytes": max(cap - used, 0),
                "used_frac": round(used / cap, 6) if cap else 0.0,
            },
            "pools": {},
        }
        pools = self.pool_totals()
        for name, p in pools.items():
            row = {
                "pool_id": p["pool_id"],
                "objects": p["objects"],
                "stored_bytes": p["bytes"],
                "degraded_objects": p["degraded_objects"],
            }
            if osdmap is not None and name in osdmap.pools:
                spec = osdmap.pools[name]
                row["raw_bytes_est"] = (
                    p["bytes"] * (spec.k + spec.m) // max(spec.k, 1)
                )
                row["ec_profile"] = f"{spec.k}+{spec.m}"
            out["pools"][name] = row
        return out

    def dump(self) -> dict:
        """Admin-socket ``pgmap``: the whole aggregate."""
        return {
            "version": self.version,
            "totals": self.totals(),
            "state_histogram": self.state_histogram(),
            "pools": self.pool_totals(),
            "rates": self.rates(),
            "pg_dump": self.pg_dump(),
        }

    # -- perf/exporter gauges -------------------------------------------
    def _ensure_perf(self):
        if self._perf is not None:
            return self._perf
        from ceph_tpu_torch.utils import PerfCountersBuilder, perf_collection

        self._perf = (
            PerfCountersBuilder(perf_collection, "pgmap")
            .add_u64_counter("reports", "stats reports folded in")
            .add_u64_counter(
                "reports_rejected",
                "per-PG records rejected as stale (old reported epoch "
                "or superseded primary)",
            )
            .add_u64_gauge("pgs", "PGs with a report")
            .add_u64_gauge("pgs_degraded", "PGs currently degraded")
            .add_u64_gauge("pgs_clean", "PGs currently clean")
            .add_u64_gauge("objects", "objects across all pools")
            .add_u64_gauge("bytes", "logical bytes across all pools")
            .add_u64_gauge("degraded_objects",
                           "missing object shard-copies")
            .add_u64_gauge("misplaced_objects",
                           "object shard-copies off CRUSH target")
            .add_u64_gauge("client_read_bps", "windowed client read B/s")
            .add_u64_gauge("client_write_bps",
                           "windowed client write B/s")
            .add_u64_gauge("recovery_bps", "windowed recovery B/s")
            .create_perf_counters()
        )
        return self._perf

    def _pool_perf_for(self, name: str):
        pc = self._pool_perf.get(name)
        if pc is not None:
            return pc
        from ceph_tpu_torch.utils import PerfCountersBuilder, perf_collection

        pc = (
            PerfCountersBuilder(perf_collection, f"pgmap.pool.{name}")
            .add_u64_gauge("pool_objects", "objects in the pool")
            .add_u64_gauge("pool_bytes", "logical bytes in the pool")
            .add_u64_gauge("pool_degraded_objects",
                           "missing shard-copies in the pool")
            .add_u64_gauge("pool_client_read_bps",
                           "windowed client read B/s")
            .add_u64_gauge("pool_client_write_bps",
                           "windowed client write B/s")
            .add_u64_gauge("pool_recovery_bps", "windowed recovery B/s")
            .create_perf_counters()
        )
        self._pool_perf[name] = pc
        return pc

    def _refresh_perf(self) -> None:
        pc = self._ensure_perf()
        t = self.totals()
        rates = self.rates()
        pc.set("pgs", t["pgs"])
        pc.set("pgs_degraded", t["pgs_degraded"])
        pc.set("pgs_clean", t["pgs_clean"])
        pc.set("objects", t["objects"])
        pc.set("bytes", t["bytes"])
        pc.set("degraded_objects", t["degraded_objects"])
        pc.set("misplaced_objects", t["misplaced_objects"])
        pc.set("client_read_bps", int(rates["client_read_bps"]))
        pc.set("client_write_bps", int(rates["client_write_bps"]))
        pc.set("recovery_bps", int(rates["recovery_bps"]))
        for name, p in self.pool_totals().items():
            ppc = self._pool_perf_for(name)
            ppc.set("pool_objects", p["objects"])
            ppc.set("pool_bytes", p["bytes"])
            ppc.set("pool_degraded_objects", p["degraded_objects"])
            ppc.set(
                "pool_client_read_bps",
                int(p["rates"]["client_read_bps"]),
            )
            ppc.set(
                "pool_client_write_bps",
                int(p["rates"]["client_write_bps"]),
            )
            ppc.set(
                "pool_recovery_bps", int(p["rates"]["recovery_bps"])
            )


# -- the `ceph -s` shape ------------------------------------------------
def status_dict(monitor, health: "dict | None" = None) -> dict:
    """Build the ``ceph -s`` status from a monitor + its pgmap.
    ``health`` is an optional pre-computed mgr health report (avoids
    re-running checks when the caller already has one)."""
    m = monitor.osdmap
    pgmap: "PGMap | None" = getattr(monitor, "pgmap", None)
    if health is None:
        from .mgr import Manager

        health = Manager(monitor).health()
    up = sum(1 for i in m.osds.values() if i.up)
    in_ = sum(1 for i in m.osds.values() if i.in_)
    pg_total = sum(s.pg_num for s in m.pools.values())
    out = {
        "health": health,
        "epoch": m.epoch,
        "osds": {"total": len(m.osds), "up": up, "in": in_},
        "pools": len(m.pools),
        "pgs": {"total": pg_total, "histogram": {}, "unreported": pg_total},
        "objects": 0,
        "bytes": 0,
        "degraded_objects": 0,
        "misplaced_objects": 0,
        "usage": {"used_bytes": 0, "capacity_bytes": 0},
        "io": {},
        "pgmap_version": 0,
    }
    if pgmap is not None:
        t = pgmap.totals()
        hist = pgmap.state_histogram()
        out["pgs"]["histogram"] = hist
        out["pgs"]["unreported"] = max(pg_total - t["pgs"], 0)
        out["objects"] = t["objects"]
        out["bytes"] = t["bytes"]
        out["degraded_objects"] = t["degraded_objects"]
        out["misplaced_objects"] = t["misplaced_objects"]
        out["usage"] = {
            "used_bytes": t["osd_used_bytes"],
            "capacity_bytes": t["osd_capacity_bytes"],
        }
        out["io"] = pgmap.rates()
        out["pgmap_version"] = pgmap.version
    return out


def _human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return (
                f"{n:.0f} {unit}" if unit == "B" else f"{n:.1f} {unit}"
            )
        n /= 1024
    return f"{n:.1f} TiB"


def format_status(st: dict) -> str:
    """Render the ``ceph -s`` look from :func:`status_dict`."""
    h = st["health"]
    checks = ", ".join(sorted(h.get("checks", {}))) or ""
    lines = [
        "  cluster:",
        f"    health: {h['status']}"
        + (f" ({checks})" if checks else ""),
        "",
        "  services:",
        f"    mon: epoch {st['epoch']}",
        f"    osd: {st['osds']['total']} total, "
        f"{st['osds']['up']} up, {st['osds']['in']} in",
        "",
        "  data:",
        f"    pools:   {st['pools']} pools, "
        f"{st['pgs']['total']} pgs",
        f"    objects: {st['objects']} objects, "
        f"{_human_bytes(st['bytes'])}",
        f"    usage:   {_human_bytes(st['usage']['used_bytes'])} used "
        f"of {_human_bytes(st['usage']['capacity_bytes'])}",
    ]
    hist = st["pgs"]["histogram"]
    parts = [
        f"{n} {state}" for state, n in sorted(
            hist.items(), key=lambda kv: (-kv[1], kv[0])
        )
    ]
    if st["pgs"]["unreported"]:
        parts.append(f"{st['pgs']['unreported']} unreported")
    lines.append("    pgs:     " + (", ".join(parts) or "(none)"))
    if st["degraded_objects"] or st["misplaced_objects"]:
        lines.append(
            f"    degraded: {st['degraded_objects']} object copies; "
            f"misplaced: {st['misplaced_objects']}"
        )
    io = st.get("io") or {}
    if io:
        lines += [
            "",
            "  io:",
            f"    client:   {_human_bytes(io['client_read_bps'])}/s rd, "
            f"{_human_bytes(io['client_write_bps'])}/s wr, "
            f"{io['client_read_iops'] + io['client_write_iops']:.0f} op/s",
            f"    recovery: {_human_bytes(io['recovery_bps'])}/s, "
            f"{io['recovery_ops_per_s']:.1f} obj/s",
        ]
    return "\n".join(lines)


def status_digest(st: dict) -> str:
    """One-line digest (the soak-lap log line)."""
    hist = st["pgs"]["histogram"]
    parts = [
        f"{n} {state}" for state, n in sorted(
            hist.items(), key=lambda kv: (-kv[1], kv[0])
        )
    ]
    io = st.get("io") or {}
    rd = io.get("client_read_bps", 0.0)
    wr = io.get("client_write_bps", 0.0)
    return (
        f"{st['health']['status']} {st['pgs']['total']} pgs: "
        + ("; ".join(parts) or "no reports")
        + f"; {st['objects']} objects"
        + f"; degraded {st['degraded_objects']}"
        + f"; io {_human_bytes(rd)}/s rd {_human_bytes(wr)}/s wr"
    )


def format_pg_dump(dump: dict) -> str:
    cols = (
        "pgid", "state", "objects", "bytes", "degraded", "misplaced",
        "log_size", "reported", "primary", "since_clean_s",
    )
    lines = ["\t".join(cols)]
    for row in dump["pg_stats"]:
        lines.append("\t".join(str(row[c]) for c in cols))
    lines.append("")
    lines.append("OSD\tUSED\tCAPACITY\tFILL\tOBJECTS")
    for o in dump["osd_stats"]:
        lines.append(
            f"osd.{o['osd']}\t{_human_bytes(o['used_bytes'])}\t"
            f"{_human_bytes(o['capacity_bytes'])}\t"
            f"{o['fill_frac']:.2%}\t{o['objects']}"
        )
    lines.append(f"version {dump['version']}")
    return "\n".join(lines)


def format_df(df: dict) -> str:
    c = df["cluster"]
    lines = [
        "CLUSTER:",
        f"  capacity {_human_bytes(c['capacity_bytes'])}, used "
        f"{_human_bytes(c['used_bytes'])} ({c['used_frac']:.2%}), "
        f"avail {_human_bytes(c['avail_bytes'])}",
        "",
        "POOLS:",
    ]
    for name, p in sorted(df["pools"].items()):
        raw = (
            f", raw ~{_human_bytes(p['raw_bytes_est'])}"
            f" (EC {p['ec_profile']})"
            if "raw_bytes_est" in p else ""
        )
        lines.append(
            f"  {name} (id {p['pool_id']}): {p['objects']} objects, "
            f"stored {_human_bytes(p['stored_bytes'])}{raw}, "
            f"degraded {p['degraded_objects']}"
        )
    return "\n".join(lines)
