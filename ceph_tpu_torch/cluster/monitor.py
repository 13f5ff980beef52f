"""Monitor — the cluster-map authority (src/mon/OSDMonitor.cc).

Mirrors the control-plane contract of the reference monitor:

- **Commands** mutate the map through validated proposals:
  ``osd_erasure_code_profile_set`` validates a profile by actually
  instantiating the codec plugin (OSDMonitor::parse_erasure_code_profile,
  mon/OSDMonitor.cc:7714 → ErasureCodePluginRegistry::factory);
  ``osd_pool_create`` binds a pool to a validated profile and derives
  k/m from the live codec (prepare_pool_crush_rule, :7885).
- **Failure detection**: OSDs report peers dead
  (``report_failure``); the monitor marks an OSD down only after
  reports from ``mon_osd_min_down_reporters`` *distinct* reporters
  (OSDMonitor::check_failure semantics), and auto-outs it after
  ``mon_osd_down_out_interval`` seconds down (tick-driven, injected
  clock for tests).
- **Publication**: every committed change produces one
  ``Incremental``; subscribers are notified with the new map, and
  laggards catch up via ``get_incrementals(since)`` — full-map
  fallback when history has been trimmed (the monc subscription
  protocol shape).

Commits go through a pluggable ``commit_fn`` so a Paxos quorum
(``cluster.paxos``) can replicate the incremental stream; standalone,
commits apply locally (a quorum of one).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from collections.abc import Callable

from ceph_tpu_torch.codecs import registry
from ceph_tpu_torch.utils import config

from .osdmap import Incremental, OSDInfo, OSDMap, PoolSpec
from ceph_tpu_torch.utils.lockdep import DebugRLock


class CommandError(Exception):
    """A monitor command was rejected (EINVAL-style)."""


class Monitor:
    """Single map authority (quorum-of-one unless ``commit_fn``)."""

    def __init__(
        self,
        initial: OSDMap | None = None,
        commit_fn: Callable[[Incremental], None] | None = None,
        clock: Callable[[], float] = time.monotonic,
        history: "list[Incremental] | None" = None,
        pool_id_floor: int = 0,
        device="cuda",
    ) -> None:
        from ceph_tpu_torch.utils.device import resolve_device

        #: where profile validation builds its trial codecs (``"cuda"``
        #: unless the caller asks for the CPU; without a card that raises)
        self.device = resolve_device(device)
        self.osdmap = initial or OSDMap()
        # the stats-plane aggregate (PGMap / MgrStatMonitor role):
        # primaries ship per-PG stats via pg_stats_report; the mgr
        # health model, `cli status`/`pg dump`/`df` and the exporter
        # read the fold instead of rescanning CRUSH
        from .pgmap import PGMap

        self.pgmap = PGMap()
        self._commit_fn = commit_fn
        self._clock = clock
        self._lock = DebugRLock("mon.cmd", rank=10)
        self._subscribers: list[Callable[[OSDMap], None]] = []
        #: incremental history for catch-up, keyed by produced epoch
        self._incrementals: dict[int, Incremental] = {}
        #: target -> set of reporter ids (pending failure evidence)
        self._failure_reports: dict[int, set[int]] = {}
        #: osd id -> monotonic time it went down (for auto-out)
        self._down_since: dict[int, float] = {}
        # resuming from a persisted map: pool ids must keep ascending
        # past every id EVER issued (a removed pool's id must not be
        # reused — stale shard keys on disk encode only the pool id,
        # and a reused id would adopt them into the new pool), so the
        # high-water mark comes from the full history when available
        # pool_id_floor covers history trimmed out of the store: a
        # pool created and deleted before the window must still never
        # have its id reused
        ever = [pool_id_floor]
        ever.extend(p.pool_id for p in self.osdmap.pools.values())
        for incr in history or ():
            ever.extend(p.pool_id for p in incr.new_pools)
        self._next_pool_id = 1 + max(ever, default=0)
        for incr in history or ():
            self._incrementals[incr.epoch] = incr
        #: committed maps awaiting subscriber delivery. Delivery
        #: happens OUTSIDE the monitor lock (``_flush``): subscribers
        #: do real work (an OSD daemon may drive recovery IO on a map
        #: change) and must not stall the control plane or deadlock
        #: by re-entering it.
        self._pending_notify: list[OSDMap] = []
        self._cmd_depth = 0

    @contextmanager
    def _command(self):
        """Lock scope for one public command. On exit of the OUTERMOST
        command (osd_pool_create calls osd_erasure_code_profile_set
        internally), queued map notifications are delivered with the
        lock released."""
        self._lock.acquire()
        self._cmd_depth += 1
        try:
            yield
        finally:
            self._cmd_depth -= 1
            depth = self._cmd_depth
            self._lock.release()
            if depth == 0:
                self._flush()

    # -- commit path ----------------------------------------------------
    def _propose(self, **fields) -> OSDMap:
        """Build + commit one incremental; returns the new map. Caller
        must hold the lock and call ``_flush`` after releasing it.

        Any change that moves CRUSH membership gets pg_temp overrides
        for the affected PGs IN THE SAME EPOCH (old layout keeps
        serving, zero unserved window); primaries backfill and then
        clear them. The reference reaches the same steady state via
        primary-requested pg_temp — committing both atomically removes
        the race where a client reads the new layout before any
        pg_temp lands."""
        incr = Incremental(epoch=self.osdmap.epoch + 1, **fields)
        # only these fields alter CRUSH input (up/down flips and
        # pg_temp edits cannot move membership) — skip the trial map
        # and the O(pools x pg_num) straw2 rescan on every other commit
        crush_moving = any(
            fields.get(f) for f in ("new_osds", "in_", "out")
        )
        if crush_moving:
            trial = self.osdmap.apply(incr)
            temps = []
            for pool, spec in trial.pools.items():
                if pool not in self.osdmap.pools:
                    continue  # new pool: nothing to protect
                for pgid in range(spec.pg_num):
                    if (pool, pgid) in trial.pg_temp:
                        continue
                    old_raw = self.osdmap.pg_to_raw(pool, pgid, True)
                    if old_raw != trial.pg_to_raw(pool, pgid, True):
                        temps.append((pool, pgid, tuple(old_raw)))
            if temps:
                incr = Incremental(
                    epoch=incr.epoch,
                    **{**fields, "new_pg_temp": tuple(
                        list(fields.get("new_pg_temp", ())) + temps
                    )},
                )
        if self._commit_fn is not None:
            self._commit_fn(incr)  # quorum may raise; nothing applied
        self.osdmap = self.osdmap.apply(incr)
        self._incrementals[incr.epoch] = incr
        self._pending_notify.append(self.osdmap)
        return self.osdmap

    def _flush(self) -> None:
        """Deliver queued map notifications without holding the lock.
        Epoch order is preserved by popping under the lock; consumers
        racing on separate threads must tolerate an old epoch arriving
        late (the daemon guards on epoch)."""
        while True:
            with self._lock:
                if not self._pending_notify:
                    return
                m = self._pending_notify.pop(0)
                subs = list(self._subscribers)
            for fn in subs:
                fn(m)

    def apply_committed(self, incr: Incremental) -> None:
        """Learn one externally committed incremental — the replica/
        learner path of a monitor quorum: apply WITHOUT proposing
        (the leader already drove it through Paxos), keep history and
        the pool-id floor, notify local subscribers. Idempotent for
        already-applied epochs; refuses gaps (callers replay the log
        in order)."""
        with self._command():
            if incr.epoch <= self.osdmap.epoch:
                return
            if incr.epoch != self.osdmap.epoch + 1:
                raise ValueError(
                    f"learn gap: at epoch {self.osdmap.epoch}, "
                    f"got {incr.epoch}"
                )
            self.osdmap = self.osdmap.apply(incr)
            self._incrementals[incr.epoch] = incr
            for p in incr.new_pools:
                self._next_pool_id = max(
                    self._next_pool_id, p.pool_id + 1
                )
            self._pending_notify.append(self.osdmap)

    # -- subscriptions (monc analog) ------------------------------------
    def subscribe(self, fn: Callable[[OSDMap], None]) -> None:
        with self._lock:
            self._subscribers.append(fn)
            current = self.osdmap
        fn(current)

    def get_incrementals(self, since: int) -> list[Incremental] | None:
        """Deltas from epoch ``since`` (exclusive) to current; None if
        history no longer reaches back that far (send the full map)."""
        with self._lock:
            out = []
            for e in range(since + 1, self.osdmap.epoch + 1):
                incr = self._incrementals.get(e)
                if incr is None:
                    return None
                out.append(incr)
            return out

    def trim_history(self, keep: int = 500) -> None:
        with self._lock:
            floor = self.osdmap.epoch - keep
            for e in [e for e in self._incrementals if e <= floor]:
                del self._incrementals[e]

    # -- device lifecycle -----------------------------------------------
    def osd_crush_add(
        self,
        osd: int,
        weight: float = 1.0,
        zone: str = "",
        location: dict[str, str] | None = None,
        **loc_kw: str,
    ) -> OSDMap:
        """Register a device in the crush tree (ceph osd crush add).

        ``location`` (or keyword shorthand ``host=.., rack=..``) places
        the device in the bucket hierarchy; rule-based pools
        (osd_pool_create failure_domain/crush_rule) select through it.
        Without a location the device lands directly under the root
        (and the legacy flat ``zone`` placement still applies for
        pools without a rule)."""
        with self._command():
            loc = dict(location or {})
            loc.update({k: v for k, v in loc_kw.items() if v})
            if loc:
                # Reject conflicting topology NOW (a bucket cannot sit
                # under two parents): build a strict trial hierarchy
                # over every REGISTERED device (not just in ones — a
                # conflict must not hide until osd_in).
                from ceph_tpu_torch.crush import CrushHierarchy
                from ceph_tpu_torch.placement import Device as _Dev

                trial = CrushHierarchy(strict=True)
                try:
                    for o in self.osdmap.osds.values():
                        if o.id != osd:
                            trial.add_device(
                                _Dev(o.id, o.weight, o.zone),
                                dict(o.location),
                            )
                    trial.add_device(_Dev(osd, weight, zone), loc)
                except ValueError as e:
                    raise CommandError(str(e)) from e
            prev = self.osdmap.osds.get(osd)
            info = OSDInfo(
                osd, weight, zone,
                up=prev.up if prev else False,
                in_=prev.in_ if prev else False,
                addr=prev.addr if prev else None,
                new=prev.new if prev else True,
                location=tuple(sorted(loc.items()))
                if loc
                else (prev.location if prev else ()),
            )
            return self._propose(new_osds=(info,))

    def osd_crush_rule_create(
        self, name: str, steps: tuple
    ) -> OSDMap:
        """Install a multi-step crush rule (ceph osd crush rule
        create-*; steps per crush.CrushHierarchy.run_rule)."""
        with self._command():
            from ceph_tpu_torch.crush import validate_rule

            try:
                norm = validate_rule(steps)
            except ValueError as e:
                raise CommandError(str(e)) from e
            existing = self.osdmap.crush_rules.get(name)
            if existing is not None:
                if existing != norm:
                    raise CommandError(
                        f"crush rule {name!r} exists with different steps"
                    )
                return self.osdmap
            return self._propose(new_rules=((name, norm),))

    @staticmethod
    def _cluster_event(
        type: str, msg: str, m: OSDMap, severity: str = "INF"
    ) -> None:
        """Health-relevant map changes land in the cluster log (the
        `ceph.log` "osd.N down" lines the reference mon writes)."""
        from ceph_tpu_torch.utils.cluster_log import cluster_log

        cluster_log.log("mon", type, msg, severity=severity,
                        epoch=m.epoch)

    def osd_boot(self, osd: int, addr: tuple[str, int]) -> OSDMap:
        """An OSD came up and announced its address (MOSDBoot). A NEW
        device is auto-marked in (mon_osd_auto_mark_new_in); a device
        an operator marked out stays out until `osd in`."""
        with self._command():
            prev = self.osdmap.osds.get(osd)
            if prev is None:
                raise CommandError(f"osd.{osd} not in crush map")
            info = OSDInfo(
                osd, prev.weight, prev.zone, up=True,
                in_=prev.in_ or prev.new, addr=addr, new=False,
                location=prev.location,
            )
            self._failure_reports.pop(osd, None)
            self._down_since.pop(osd, None)
            m = self._propose(new_osds=(info,))
        self._cluster_event("osd_boot", f"osd.{osd} boot ({addr[0]}:"
                            f"{addr[1]})", m)
        return m

    def osd_down(self, osd: int) -> OSDMap:
        with self._command():
            self._check_osd(osd)
            self._down_since.setdefault(osd, self._clock())
            self._failure_reports.pop(osd, None)
            m = self._propose(down=(osd,))
        self._cluster_event(
            "osd_down", f"osd.{osd} marked down", m, severity="WRN"
        )
        return m

    def osd_out(self, osd: int) -> OSDMap:
        with self._command():
            self._check_osd(osd)
            m = self._propose(out=(osd,))
        self._cluster_event(
            "osd_out", f"osd.{osd} marked out", m, severity="WRN"
        )
        return m

    def osd_in(self, osd: int) -> OSDMap:
        with self._command():
            self._check_osd(osd)
            m = self._propose(in_=(osd,))
        self._cluster_event("osd_in", f"osd.{osd} marked in", m)
        return m

    def osd_reweight(self, osd: int, weight: float) -> OSDMap:
        with self._command():
            prev = self._check_osd(osd)
            if weight < 0:
                raise CommandError("weight must be >= 0")
            from dataclasses import replace

            return self._propose(new_osds=(replace(prev, weight=weight),))

    def _check_osd(self, osd: int) -> OSDInfo:
        info = self.osdmap.osds.get(osd)
        if info is None:
            raise CommandError(f"osd.{osd} does not exist")
        return info

    # -- failure detection (OSDMonitor::check_failure) -------------------
    def report_failure(self, reporter: int, target: int) -> OSDMap | None:
        """Peer-failure evidence. Marks the target down once
        ``mon_osd_min_down_reporters`` distinct reporters agree; a
        report about an already-down or unknown OSD is ignored."""
        with self._command():
            info = self.osdmap.osds.get(target)
            if info is None or not info.up or reporter == target:
                return None
            reporters = self._failure_reports.setdefault(target, set())
            reporters.add(reporter)
            if len(reporters) < config.get("mon_osd_min_down_reporters"):
                return None
            del self._failure_reports[target]
            self._down_since[target] = self._clock()
            return self._propose(down=(target,))

    def tick(self) -> OSDMap | None:
        """Periodic maintenance: auto-out OSDs down longer than
        ``mon_osd_down_out_interval`` (data starts rebalancing)."""
        with self._command():
            horizon = self._clock() - config.get("mon_osd_down_out_interval")
            expired = [
                osd for osd, t in self._down_since.items()
                if t <= horizon and self.osdmap.osds[osd].in_
            ]
            if not expired:
                return None
            for osd in expired:
                del self._down_since[osd]
            from ceph_tpu_torch.utils.log import get_logger

            get_logger("mon").info(
                "auto-out after down-out interval: osds", expired
            )
            return self._propose(out=tuple(expired))

    # -- EC profiles & pools (OSDMonitor::parse_erasure_code_profile) ----
    # -- central config db (ConfigMonitor analog) -----------------------
    # mon/ConfigMonitor.h:15: a Paxos-replicated option store the
    # monitors push to every daemon; daemons overlay it under their
    # local file/env/runtime layers and observers fire on change.
    _CONFIG_WHO_CLASSES = ("", "osd", "mon", "client")

    def _check_config_who(self, who: str) -> None:
        if who in self._CONFIG_WHO_CLASSES:
            return
        cls, _, ident = who.partition(".")
        if cls in self._CONFIG_WHO_CLASSES[1:] and ident.isdigit():
            return
        raise CommandError(
            f"bad config target {who!r}: use '' (global), a daemon "
            f"class {self._CONFIG_WHO_CLASSES[1:]}, or class.id"
        )

    def config_set(self, name: str, value, who: str = "") -> OSDMap:
        """``ceph config set <who> <name> <value>``: validate against
        the option schema, commit through the quorum, push to every
        subscribed daemon via the map channel."""
        from ceph_tpu_torch.utils import config

        self._check_config_who(who)
        opt = config.schema.get(name)
        if opt is None:
            raise CommandError(f"unknown option {name!r}")
        stored = str(value)
        try:
            # validate the STRING that will be stored — daemons parse
            # exactly this form out of the replicated db, so e.g. 8.5
            # for an int option must be rejected here, not silently
            # dropped by every daemon
            opt.parse(stored)
        except Exception as e:
            raise CommandError(
                f"invalid value for {name!r}: {e}"
            ) from None
        with self._command():
            return self._propose(
                new_config=((who, name, stored),)
            )

    def config_rm(self, name: str, who: str = "") -> OSDMap:
        self._check_config_who(who)
        with self._command():
            return self._propose(new_config=((who, name, None),))

    def config_db(self) -> dict:
        """``ceph config dump``: the full replicated db."""
        with self._lock:
            return {
                f"{who or 'global'}/{name}": val
                for (who, name), val in sorted(self.osdmap.config.items())
            }

    def osd_erasure_code_profile_set(
        self, name: str, profile: dict[str, str], force: bool = False
    ) -> OSDMap:
        """Validate by instantiating the plugin, then commit. Changing
        an existing profile requires ``force`` (it would silently
        change placement math for existing pools — same guard as the
        reference)."""
        with self._command():
            if name in self.osdmap.profiles and not force:
                if self.osdmap.profiles[name] != profile:
                    raise CommandError(
                        f"profile {name!r} exists; --force to overwrite"
                    )
                return self.osdmap
            self._validate_profile(profile)
            return self._propose(
                new_profiles=((name, tuple(sorted(profile.items()))),)
            )

    def _validate_profile(self, profile: dict[str, str]):
        plugin = profile.get("plugin", config.get("erasure_code_default_plugin"))
        try:
            codec = registry.factory(plugin, dict(profile), self.device)
        except Exception as e:
            raise CommandError(f"invalid erasure-code profile: {e}") from e
        return plugin, codec

    def osd_pool_create(
        self,
        name: str,
        pg_num: int,
        profile_name: str = "",
        distinct_zones: bool = False,
        crush_rule: str = "",
        failure_domain: str = "",
    ) -> OSDMap:
        """Create a pool. ``crush_rule`` binds an installed rule;
        ``failure_domain`` ("host"/"rack"/...) is the shortcut that
        auto-creates the standard EC spread rule for that bucket type
        (ErasureCode::create_rule). An LRC profile with
        ``crush-locality`` gets the two-level locality rule instead
        (ErasureCodeLrc.h): layer groups stay inside one locality
        bucket each."""
        with self._command():
            if name in self.osdmap.pools:
                raise CommandError(f"pool {name!r} already exists")
            if pg_num <= 0:
                raise CommandError("pg_num must be positive")
            if crush_rule and failure_domain:
                raise CommandError(
                    "give crush_rule or failure_domain, not both"
                )
            if not profile_name:
                profile_name = "default"
                if profile_name not in self.osdmap.profiles:
                    prof = dict(
                        kv.split("=")
                        for kv in config.get(
                            "erasure_code_default_profile"
                        ).split()
                    )
                    self.osd_erasure_code_profile_set(profile_name, prof)
            profile = self.osdmap.profiles.get(profile_name)
            if profile is None:
                raise CommandError(f"no such profile: {profile_name!r}")
            plugin, codec = self._validate_profile(profile)
            k = codec.get_data_chunk_count()
            size = codec.get_chunk_count()
            if failure_domain:
                from ceph_tpu_torch.crush import ec_rule, lrc_rule

                locality = dict(profile).get("crush-locality", "")
                if plugin == "lrc" and locality:
                    # kml form: k+m chunks split into groups of l,
                    # one LOCAL parity added per group — total chunks
                    # = k + m + (k+m)/l, each locality group holding
                    # l + 1 chunks (ErasureCodeLrc.cc parse_kml).
                    prof = dict(profile)
                    l = int(prof.get("l", "0") or 0)
                    km = int(prof.get("k", "0") or 0) + int(
                        prof.get("m", "0") or 0
                    )
                    if l <= 0 or km % l or size % (km // l):
                        raise CommandError(
                            "crush-locality needs the kml form with "
                            "l dividing k+m"
                        )
                    groups = km // l
                    per_group = size // groups
                    steps = lrc_rule(
                        groups, per_group, locality, failure_domain
                    )
                    # geometry-keyed name: same layout shares the
                    # rule; a different layout never collides (rules
                    # are not deletable, so a pool-keyed name would
                    # pin the geometry forever)
                    crush_rule = (
                        f"lrc_{locality}_{failure_domain}_"
                        f"{groups}x{per_group}"
                    )
                else:
                    steps = ec_rule(failure_domain)
                    crush_rule = f"ec_{failure_domain}"
                self.osd_crush_rule_create(crush_rule, steps)
            elif crush_rule and crush_rule not in self.osdmap.crush_rules:
                raise CommandError(f"no such crush rule {crush_rule!r}")
            spec = PoolSpec(
                name=name,
                pool_id=self._next_pool_id,
                pg_num=pg_num,
                profile_name=profile_name,
                k=k,
                m=size - k,
                plugin=plugin,
                distinct_zones=distinct_zones,
                crush_rule=crush_rule,
            )
            self._next_pool_id += 1
            return self._propose(new_pools=(spec,))

    def osd_pool_snap_create(self, pool: str, snap: str) -> OSDMap:
        """Pool snapshot (rados_ioctx_snap_create,
        librados/librados_c.cc:1749): commit a new (snapid, name,
        epoch) entry; primaries clone objects copy-on-first-write
        against the newest snap."""
        from dataclasses import replace

        with self._command():
            spec = self.osdmap.pools.get(pool)
            if spec is None:
                raise CommandError(f"no such pool: {pool!r}")
            if any(n == snap for _, n, _ in spec.snaps):
                raise CommandError(f"snap {snap!r} already exists")
            snapid = spec.snap_seq + 1
            new = replace(
                spec,
                snaps=spec.snaps + ((snapid, snap, self.osdmap.epoch + 1),),
                snap_seq=snapid,
            )
            return self._propose(new_pools=(new,))

    def osd_pool_snap_rm(self, pool: str, snap: str) -> OSDMap:
        """Drop a pool snapshot; members garbage-collect its clone
        shards on their next tick."""
        from dataclasses import replace

        with self._command():
            spec = self.osdmap.pools.get(pool)
            if spec is None:
                raise CommandError(f"no such pool: {pool!r}")
            keep = tuple(s for s in spec.snaps if s[1] != snap)
            if len(keep) == len(spec.snaps):
                raise CommandError(f"no such snap: {snap!r}")
            return self._propose(
                new_pools=(replace(spec, snaps=keep),)
            )

    def osd_pool_qos_set(
        self,
        pool: str,
        tenant: str = "",
        res_ops: float = 0.0,
        res_bytes: float = 0.0,
        weight: float = 1.0,
        lim_ops: float = 0.0,
        lim_bytes: float = 0.0,
    ) -> OSDMap:
        """Declare (or replace) one pool/tenant QoS spec — the
        ``osd pool set <pool> qos`` surface of the multi-tenant plane
        (cluster/qos.py).  ``tenant=""`` sets the pool-wide default
        the untagged ``client.<pool>`` class schedules under.  The
        spec rides the map incremental to every OSD, which re-arms
        its mClock class live on the push."""
        from dataclasses import replace

        with self._command():
            spec = self.osdmap.pools.get(pool)
            if spec is None:
                raise CommandError(f"no such pool: {pool!r}")
            if weight <= 0.0:
                raise CommandError("qos weight must be > 0")
            row = (
                str(tenant), float(res_ops), float(res_bytes),
                float(weight), float(lim_ops), float(lim_bytes),
            )
            keep = tuple(q for q in spec.qos if q[0] != row[0])
            new = replace(
                spec, qos=tuple(sorted(keep + (row,))),
            )
            return self._propose(new_pools=(new,))

    def osd_pool_qos_rm(self, pool: str, tenant: str = "") -> OSDMap:
        """Drop one pool/tenant QoS spec: the tenant's class falls
        back to the base ``client`` profile on the next map push."""
        from dataclasses import replace

        with self._command():
            spec = self.osdmap.pools.get(pool)
            if spec is None:
                raise CommandError(f"no such pool: {pool!r}")
            keep = tuple(q for q in spec.qos if q[0] != str(tenant))
            if len(keep) == len(spec.qos):
                raise CommandError(
                    f"no qos spec for tenant {tenant!r}"
                )
            return self._propose(new_pools=(replace(spec, qos=keep),))

    def osd_pool_rm(self, name: str) -> OSDMap:
        with self._command():
            if name not in self.osdmap.pools:
                raise CommandError(f"no such pool: {name!r}")
            m = self._propose(removed_pools=(name,))
        self.pgmap.prune_pools(
            {s.pool_id for s in m.pools.values()}
        )
        return m

    # -- stats ingress (the MPGStats receive path) ----------------------
    def pg_stats_report(
        self, osd: int, epoch: int, pg_stats=(), osd_stat=None
    ) -> int:
        """One daemon's tick-driven stats report. Data-plane traffic:
        folds under the PGMap's own lock, never the command lock (a
        stats flood must not stall map commits). Returns accepted
        per-PG records (stale reports from demoted primaries are
        rejected inside the fold)."""
        return self.pgmap.apply_report(osd, epoch, pg_stats, osd_stat)

    # -- pg_temp (the backfill serving-layout override) -----------------
    def pg_temp_set(
        self, pool: str, pgid: int, acting: list[int]
    ) -> OSDMap:
        """A primary requests serving its PG from ``acting`` while it
        backfills data to the CRUSH layout (OSDMonitor pg_temp)."""
        with self._command():
            if pool not in self.osdmap.pools:
                raise CommandError(f"no such pool: {pool!r}")
            spec = self.osdmap.pools[pool]
            if len(acting) != spec.size:
                raise CommandError(
                    f"pg_temp wants {spec.size} positions, got {len(acting)}"
                )
            for o in acting:
                if o != -1 and o not in self.osdmap.osds:
                    raise CommandError(f"osd.{o} does not exist")
            return self._propose(
                new_pg_temp=((pool, pgid, tuple(acting)),)
            )

    def pg_temp_clear(self, pool: str, pgid: int) -> OSDMap | None:
        """Backfill done: the PG serves from CRUSH again."""
        with self._command():
            if (pool, pgid) not in self.osdmap.pg_temp:
                return None
            return self._propose(del_pg_temp=((pool, pgid),))
