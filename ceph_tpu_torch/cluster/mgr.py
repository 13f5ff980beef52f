"""Manager daemon — the ceph-mgr analog (src/mgr + pybind/mgr modules).

The reference's mgr hosts python modules beside the data path; the
three that shape cluster behavior are mirrored here as one daemon:

- **balancer** (pybind/mgr/balancer): flatten the PG-per-OSD
  distribution. The reference's default mode is upmap exceptions; the
  crush-compat fallback adjusts weights — that is the mode here:
  periodic reweights nudge over-full OSDs down and under-full ones up
  (bounded step, deadband threshold), committed through the monitor so
  every map consumer sees the same placement.
- **pg_autoscaler** (pybind/mgr/pg_autoscaler): recommend pg_num per
  pool from the PG-shards-per-OSD target. Recommendations surface as
  health warnings (warn mode); actually splitting PGs is a data-move
  operation this framework does not perform, exactly like the
  autoscaler's ``warn`` mode leaves pg_num alone.
- **health** (mon/mgr health model): one structured report merging
  down/out OSDs, degraded PGs, and autoscaler findings — the ``ceph
  health detail`` shape. PG checks are STATS-FED (monitor.pgmap, the
  PGMap fold of primaries' reports): PG_DEGRADED carries degraded
  object counts, PG_UNAVAILABLE reads reported ``down`` bits, and
  PG_STUCK / OSD_NEARFULL / SLOW_OPS derive from last-clean ages,
  osd_stat fill fractions and the optracker. The CRUSH rescan the
  pre-stats model ran per health() call survives only as the
  no-reports fallback for bare-monitor harnesses.

The prometheus-module role is ``utils/exporter``; the mgr exposes its
own state through the same perf-counter collection.
"""

from __future__ import annotations

import math
import threading

from .osdmap import SHARD_NONE, OSDMap
from ceph_tpu_torch.utils.lockdep import DebugLock

#: the reference's mon_target_pg_per_osd default is 100 PG *shards*
TARGET_PG_SHARDS_PER_OSD = 100
#: autoscaler warns outside [target/4, target*4] (threshold 3.0 in the
#: reference; 4x here keeps small dev clusters quiet)
AUTOSCALE_SLACK = 4.0


class Manager:
    """Active mgr: balancer + autoscaler + health, driven by tick()."""

    def __init__(
        self,
        monitor,
        balance_threshold: float = 0.10,
        balance_step: float = 0.15,
        min_weight: float = 0.1,
        max_weight: float = 8.0,
    ) -> None:
        self.monitor = monitor
        #: deadband: |pgs - mean| / mean below this is "balanced"
        self.balance_threshold = balance_threshold
        #: max relative weight change per tick (small steps converge
        #: without thrashing data movement)
        self.balance_step = balance_step
        self.min_weight = min_weight
        #: ceiling: a structurally under-full OSD (e.g. the lone member
        #: of its failure domain) can never be fixed by weight — an
        #: unbounded raise would grow geometrically under tick() and
        #: churn a reweight epoch + backfill every pass
        self.max_weight = max_weight
        self._lock = DebugLock("mgr.health")
        self.last_health: dict = {"status": "HEALTH_OK", "checks": {}}

    # -- distribution math ---------------------------------------------
    def pg_shard_counts(self, osdmap: OSDMap | None = None) -> dict[int, int]:
        """PG shards hosted per OSD across every pool (each EC PG
        consumes k+m shard slots — the unit the balancer evens out).

        Counted on the CRUSH TARGET layout (``ignore_temp``): a
        reweight immediately pg_temps affected PGs to their old
        placement while backfill moves data, so the serving layout
        lags by design — balancing on it would see no effect from the
        balancer's own reweights and wind the weights forever."""
        m = osdmap or self.monitor.osdmap
        counts: dict[int, int] = {
            osd: 0 for osd, info in m.osds.items() if info.in_
        }
        for name, spec in m.pools.items():
            for pg in range(spec.pg_num):
                for osd in m.pg_to_raw(name, pg, ignore_temp=True):
                    if osd != SHARD_NONE and osd in counts:
                        counts[osd] += 1
        return counts

    # -- balancer -------------------------------------------------------
    def balance_once(self) -> dict[int, float]:
        """One balancer pass: reweight OSDs whose PG-shard count
        deviates from the mean beyond the deadband. Returns the
        weights actually changed (empty = balanced)."""
        m = self.monitor.osdmap
        counts = self.pg_shard_counts(m)
        if not counts:
            return {}
        mean = sum(counts.values()) / len(counts)
        if mean == 0:
            return {}
        changed: dict[int, float] = {}
        for osd, pgs in sorted(counts.items()):
            dev = (pgs - mean) / mean
            if abs(dev) <= self.balance_threshold:
                continue
            cur = m.osds[osd].weight
            # move weight against the deviation, bounded per tick
            factor = max(
                1.0 - self.balance_step,
                min(1.0 + self.balance_step, mean / max(pgs, 1)),
            )
            new = min(
                self.max_weight,
                max(self.min_weight, round(cur * factor, 4)),
            )
            if new != cur:
                changed[osd] = new
        for osd, w in changed.items():
            self.monitor.osd_reweight(osd, w)
        return changed

    def balance(self, max_rounds: int = 20) -> int:
        """Iterate balance_once until the distribution settles; returns
        rounds used (the balancer's eval/execute loop collapsed)."""
        for i in range(max_rounds):
            if not self.balance_once():
                return i
        return max_rounds

    # -- pg_autoscaler --------------------------------------------------
    def autoscale_status(self) -> list[dict]:
        """Per-pool recommendation rows (``ceph osd pool autoscale-status``
        shape): current pg_num, ideal pg_num, and whether it warrants
        a health warning."""
        m = self.monitor.osdmap
        n_in = sum(1 for info in m.osds.values() if info.in_) or 1
        budget = n_in * TARGET_PG_SHARDS_PER_OSD
        pools = list(m.pools.values())
        if not pools:
            return []
        share = budget / len(pools)  # equal-share capacity model
        rows = []
        for spec in sorted(pools, key=lambda s: s.pool_id):
            width = spec.k + spec.m
            ideal = max(1, 2 ** round(math.log2(max(share / width, 1))))
            ratio = spec.pg_num / ideal
            rows.append(
                {
                    "pool": spec.name,
                    "pg_num": spec.pg_num,
                    "ideal_pg_num": ideal,
                    "warn": (
                        ratio > AUTOSCALE_SLACK or ratio < 1 / AUTOSCALE_SLACK
                    ),
                }
            )
        return rows

    # -- health ---------------------------------------------------------
    def _pg_checks_from_stats(self, pgmap, checks: dict) -> None:
        """Stats-fed PG checks: the PGMap fold already carries state
        bits and object tallies per PG, so PG_DEGRADED gains object
        counts and PG_UNAVAILABLE reads reported ``down`` states —
        no O(pools x pg_num x CRUSH) rescan."""
        from ceph_tpu_torch.utils import config as _cfg

        live_pools = {
            s.pool_id for s in self.monitor.osdmap.pools.values()
        }
        degraded = degraded_objects = 0
        unavailable = []
        for (_pid, pgid), s in pgmap.entries(live_pools):
            if "degraded" in s.state:
                degraded += 1
                degraded_objects += s.degraded
            if "down" in s.state:
                unavailable.append((s.pool, pgid))
        if degraded:
            checks["PG_DEGRADED"] = {
                "severity": "warn",
                "detail": (
                    f"{degraded} pgs degraded "
                    f"({degraded_objects} object copies)"
                ),
            }
        if unavailable:
            checks["PG_UNAVAILABLE"] = {
                "severity": "error",
                "detail": (
                    f"{len(unavailable)} pgs below k: "
                    f"{sorted(unavailable)[:8]}"
                ),
            }
        stuck = pgmap.stuck_pgs(_cfg.get("mon_pg_stuck_threshold"))
        if stuck:
            oldest = stuck[0]
            checks["PG_STUCK"] = {
                "severity": "warn",
                "detail": (
                    f"{len(stuck)} pgs stuck non-clean; oldest "
                    f"{oldest['pgid']} ({oldest['state']}) for "
                    f"{oldest['stuck_for_s']:.0f}s"
                ),
            }
        nearfull = pgmap.nearfull_osds(
            _cfg.get("mon_osd_nearfull_ratio")
        )
        if nearfull:
            checks["OSD_NEARFULL"] = {
                "severity": "warn",
                "detail": "; ".join(
                    f"osd.{o['osd']} at {o['fill_frac']:.0%}"
                    for o in nearfull
                ),
            }

    def _pg_checks_from_map(self, checks: dict) -> None:
        """Map-rescan fallback (the pre-stats-plane model) for
        clusters with no stats reports yet: recompute CRUSH mappings
        and flag holes. Kept for bare-monitor harnesses — any live
        cluster reports within one tick and takes the stats path."""
        m = self.monitor.osdmap
        degraded = []
        unavailable = []
        for name, spec in m.pools.items():
            for pg in range(spec.pg_num):
                acting = m.pg_to_up_acting(name, pg)
                holes = sum(1 for o in acting if o == SHARD_NONE)
                if holes == 0:
                    continue
                if len(acting) - holes < spec.k:
                    unavailable.append((name, pg))
                else:
                    degraded.append((name, pg))
        if degraded:
            checks["PG_DEGRADED"] = {
                "severity": "warn",
                "detail": f"{len(degraded)} pgs degraded",
            }
        if unavailable:
            checks["PG_UNAVAILABLE"] = {
                "severity": "error",
                "detail": (
                    f"{len(unavailable)} pgs below k: {unavailable[:8]}"
                ),
            }

    def _slow_ops_check(self, checks: dict) -> None:
        """SLOW_OPS from the optracker: wedged ops surface on `cli
        health`/`cli status` without grepping the cluster log (the
        complaint itself is already there). Scoped to THIS cluster's
        daemons (the map's OSDs + mon/mgr) — the reference's SLOW_OPS
        aggregates daemon-reported ops the same way, and the process
        tracker may carry ops of unrelated pipelines."""
        from ceph_tpu_torch.utils.optracker import op_tracker

        daemons = {
            f"osd.{i}" for i in self.monitor.osdmap.osds
        } | {"mon", "mgr"}
        live = op_tracker.dump_ops_in_flight()
        slow = [
            op for op in live["ops"]
            if op["slow"] and op["daemon"] in daemons
        ]
        if slow:
            oldest = max(op["age"] for op in slow)
            checks["SLOW_OPS"] = {
                "severity": "warn",
                "detail": (
                    f"{len(slow)} slow ops in flight; oldest "
                    f"{oldest:.1f}s (dump_ops_in_flight for "
                    "timelines)"
                ),
            }

    def health(self) -> dict:
        """Structured health report (the mon health-check model):
        HEALTH_OK / HEALTH_WARN / HEALTH_ERR + per-check detail.
        PG checks read the stats plane (monitor.pgmap) when it has
        reports; the CRUSH rescan survives only as the no-reports
        fallback."""
        m = self.monitor.osdmap
        checks: dict[str, dict] = {}
        # in+down only: a permanently lost OSD the monitor already
        # outed (and whose data re-homed) must not warn forever
        down = sorted(
            osd for osd, info in m.osds.items()
            if info.in_ and not info.up
        )
        if down:
            checks["OSD_DOWN"] = {
                "severity": "warn",
                "detail": f"{len(down)} osds down: {down}",
            }
        pgmap = getattr(self.monitor, "pgmap", None)
        if pgmap is not None and pgmap.pg:
            self._pg_checks_from_stats(pgmap, checks)
        else:
            self._pg_checks_from_map(checks)
        self._slow_ops_check(checks)
        for row in self.autoscale_status():
            if row["warn"]:
                checks.setdefault(
                    "POOL_PG_NUM", {"severity": "warn", "detail": ""}
                )
                checks["POOL_PG_NUM"]["detail"] += (
                    f"pool {row['pool']!r} pg_num {row['pg_num']} "
                    f"(ideal ~{row['ideal_pg_num']}); "
                )
        if any(c["severity"] == "error" for c in checks.values()):
            status = "HEALTH_ERR"
        elif checks:
            status = "HEALTH_WARN"
        else:
            status = "HEALTH_OK"
        report = {"status": status, "checks": checks}
        with self._lock:
            self.last_health = report
        return report

    def tick(self) -> None:
        """Periodic mgr work: refresh health, run one balancer pass."""
        self.health()
        self.balance_once()
