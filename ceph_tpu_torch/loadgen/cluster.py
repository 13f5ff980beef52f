"""vstart-analog cluster harness for load generation.

Boots the REAL tier: monitor + N OSD daemons over sockets (``msg/``
framed messenger), an EC pool through the profile/pool machinery,
and a ``RadosClient`` — the same stack the e2e/chaos tests drive,
packaged with the kill/revive/wait-recovered controls the fault
schedule needs (qa/tasks/ceph_manager.py kill_osd/revive_osd role).
MemStore by default: loadgen measures the service path, not the
backing-store medium, unless a store factory says otherwise.

The monitor and every daemon run on ``device`` (``"cuda"`` unless the
caller asks for the CPU). ``use_mesh`` installs the dispatch mesh and
``dcn_hosts`` the DCN cluster (``parallel/``) before the daemons boot,
so every encode, decode and delta they run rides the multi-device
route. The mesh takes ``mesh_devices`` physical devices of ``device``'s
type (asking for more than the box has raises ``ValueError``), or the
devices named in ``mesh_device_list`` (logical devices, one card named
several times). The DCN hosts join over gloo; a caller that needs NCCL
builds a ``DcnCluster`` itself and installs it with ``set_dcn``."""

from __future__ import annotations

import time

from ceph_tpu_torch.cluster import Monitor, OSDDaemon, RadosClient
from ceph_tpu_torch.cluster.osdmap import SHARD_NONE


class LoadCluster:
    """mon + OSDs + EC pool + client, with thrasher controls."""

    def __init__(
        self,
        n_osds: int = 6,
        k: int = 3,
        m: int = 2,
        pg_num: int = 8,
        chunk_size: int = 1024,
        pool: str = "loadpool",
        plugin: str = "jerasure",
        technique: str = "reed_sol_van",
        d: int | None = None,
        store_factory=None,
        tick_period: float = 0.2,
        client_backoff: float = 0.02,
        client_op_timeout: float = 3.0,
        client_max_attempts: int = 10,
        use_mesh: bool = False,
        mesh_devices: int | None = None,
        dcn_hosts: int = 0,
        dcn_devices_per_host: int = 1,
        dcn_data_timeout: float = 60.0,
        device="cuda",
        mesh_device_list: list | None = None,
    ) -> None:
        if n_osds < k + m:
            raise ValueError(f"need >= k+m={k + m} OSDs, got {n_osds}")
        clay_d = d  # the daemon boot loop below reuses the name ``d``
        self.pool = pool
        self.k, self.m = k, m
        self.chunk_size = chunk_size
        self._tick_period = tick_period
        # -- the multi-device tier wired into the live path: the
        # daemons run in-process, so the process-wide dispatch mesh /
        # DCN cluster (parallel/dispatch.py) is the live data path.
        # Installed before the daemons boot so even the first op routes
        # over it; shutdown() restores what was there.
        self.mesh = None
        self.dcn = None
        self._prev_mesh = self._prev_dcn = None
        if use_mesh or dcn_hosts:
            from ceph_tpu_torch.parallel import dispatch as mesh_dispatch

            if use_mesh:
                from ceph_tpu_torch.parallel import make_ec_mesh

                # built first: a mesh the box cannot hold raises before
                # anything boots
                mesh = make_ec_mesh(
                    mesh_devices, k=k, devices=mesh_device_list,
                    device=device,
                )
            self._prev_mesh = mesh_dispatch.get_mesh()
            self._prev_dcn = mesh_dispatch.get_dcn()
            if dcn_hosts:
                from ceph_tpu_torch.parallel.dcn import DcnCluster

                self.dcn = DcnCluster(
                    n_hosts=dcn_hosts,
                    devices_per_host=dcn_devices_per_host,
                    device=device, backend="gloo",
                ).start()
                # the data path must fail fast into the single-host
                # fallback when a host dies mid-op (the client's retry
                # ladder is seconds, not the raw op timeout)
                self.dcn.apply_bitmatrix = (
                    lambda bm, data, timeout=dcn_data_timeout,
                    _orig=self.dcn.apply_bitmatrix:
                    _orig(bm, data, timeout=timeout)
                )
                mesh_dispatch.set_dcn(self.dcn)
            if use_mesh:
                self.mesh = mesh
                mesh_dispatch.set_mesh(self.mesh)
        from ceph_tpu_torch.utils.device import resolve_device

        #: where every daemon runs its codecs, HashInfo and scrub
        #: hashes (``"cuda"`` unless the caller asks for the CPU)
        self.device = resolve_device(device)
        self.mon = Monitor(device=self.device)
        self.daemons: dict[int, OSDDaemon] = {}
        self.stores: dict[int, object] = {}
        for i in range(n_osds):
            self.mon.osd_crush_add(i, zone=f"z{i % max(m + 1, 3)}")
        for i in range(n_osds):
            store = store_factory(i) if store_factory else None
            d = OSDDaemon(
                i, self.mon, store=store, chunk_size=chunk_size,
                tick_period=tick_period, device=self.device,
            )
            d.start()
            self.daemons[i] = d
            self.stores[i] = d.store
        profile = {
            "plugin": plugin, "k": str(k), "m": str(m),
        }
        if plugin == "jerasure":
            profile["technique"] = technique
        if plugin == "clay":
            # CLAY pools at the cluster tier: d steers the MSR repair
            # bandwidth (default k+m-1); chunks must split into q^t
            # lane-aligned sub-chunks for the fractional sub-reads
            if clay_d is not None:
                profile["d"] = str(clay_d)
            from ceph_tpu_torch.codecs import registry as _reg

            sub = _reg.factory(
                "clay", dict(profile), self.device
            ).get_sub_chunk_count()
            if chunk_size % sub:
                raise ValueError(
                    f"chunk_size {chunk_size} must divide into the "
                    f"pool's {sub} CLAY sub-chunks"
                )
        self.mon.osd_erasure_code_profile_set("loadprof", profile)
        self.mon.osd_pool_create(pool, pg_num, "loadprof")
        # short op timeout: a kill can eat an in-flight op's reply
        # mid-run, and the default 30 s wait would freeze the whole
        # closed loop for the duration (the reqid dedup makes the
        # fast resend safe)
        # generous retry budget: a kill + peering + durability-poll
        # cooldowns can stack several seconds of eagain before an op
        # lands; the default 8-attempt ladder at this backoff gives
        # up mid-recovery and turns a healable wait into an op error
        self.client = RadosClient(
            self.mon, backoff=client_backoff,
            op_timeout=client_op_timeout,
            max_attempts=client_max_attempts,
            perf_name="loadgen_client",
        )
        self.io = self.client.open_ioctx(pool)
        self.dead: list[int] = []
        #: OSDs currently cut off by a net partition (alive but
        #: unreachable on the data plane; map-down once evidence lands)
        self.partitioned: list[int] = []

    # -- thrasher controls ---------------------------------------------
    def live_osds(self) -> list[int]:
        return [i for i in self.daemons if i not in self.dead]

    def _primary_counts(self) -> dict[int, int]:
        spec = self.mon.osdmap.pools[self.pool]
        counts = {o: 0 for o in self.live_osds()}
        for pgid in range(spec.pg_num):
            p = self.mon.osdmap.pg_primary(self.pool, pgid)
            if p in counts:
                counts[p] += 1
        return counts

    def least_primary_osd(self) -> int:
        """The live OSD leading the FEWEST PGs of the pool (ties ->
        lowest id). Killing this one exercises degraded/reconstruct
        reads, revive catch-up and the recovery clock while forcing
        the fewest primary failovers — the gentlest victim."""
        counts = self._primary_counts()
        return min(counts, key=lambda o: (counts[o], o))

    def most_primary_osd(self) -> int:
        """The live OSD leading the MOST PGs of the pool (ties ->
        lowest id). Killing this one forces the maximum number of
        primary takeovers at once — the peering-FSM torture victim,
        and the default soak target now that the takeover race
        (ROADMAP #1) is closed by construction."""
        counts = self._primary_counts()
        return min(counts, key=lambda o: (-counts[o], o))

    def kill(self, osd: int) -> None:
        """Hard-stop the daemon and mark it down (failure detection
        collapsed to a command, as the e2e tier does)."""
        if osd in self.dead:
            return
        self.daemons[osd].stop()
        self.mon.osd_down(osd)
        self.dead.append(osd)

    def revive(self, osd: int) -> None:
        """Fresh daemon over the corpse's store: boot + log catch-up
        brings the shard back (the revive_osd path)."""
        if osd not in self.dead:
            return
        d = OSDDaemon(
            osd, self.mon, store=self.stores[osd],
            chunk_size=self.chunk_size, tick_period=self._tick_period,
            device=self.device,
        )
        d.start()
        self.daemons[osd] = d
        self.dead.remove(osd)

    # -- network-fault controls (the tc/netem analog) ------------------
    def net_flaky(
        self,
        seed: int = 0xEC,
        drop: float = 0.02,
        dup: float = 0.02,
        delay_ms: float = 5.0,
        delay_jitter_ms: float = 47.0,
        reorder: float = 0.01,
        scope: str = "osd",
    ) -> None:
        """Arm a seeded flaky profile on every link: inter-OSD only
        (``scope="osd"``, the acceptance profile) or the client legs
        too (``scope="all"``). Deterministic per link from ``seed``."""
        from ceph_tpu_torch.msg.messenger import LinkRule, net_faults

        rule = LinkRule(
            drop=drop, dup=dup, delay_ms=delay_ms,
            delay_jitter_ms=delay_jitter_ms, reorder=reorder,
        )
        net_faults.configure(seed)
        if scope == "all":
            net_faults.add_rule("*", "*", rule)
        else:
            net_faults.add_rule("osd.*", "osd.*", rule)

    def net_partition(
        self, osd: int, asymmetric: bool = False, seed: int = 0xEC,
    ) -> None:
        """Cut osd.<id> off the data plane (frames dropped; TCP stays
        up, exactly a switch eating packets). ``asymmetric`` cuts only
        the inbound half — the victim keeps sending into the void, the
        re-election torture case. Failure detection is collapsed to a
        command like ``kill()``'s: the mon marks the victim down (its
        peers' evidence), so peering re-elects deterministically."""
        from ceph_tpu_torch.msg.messenger import net_faults

        if not net_faults.active:
            net_faults.configure(seed)
        net_faults.partition(f"osd.{osd}", asymmetric=asymmetric)
        if osd not in self.partitioned:
            self.partitioned.append(osd)
        self.mon.osd_down(osd)

    def net_heal(self) -> None:
        """Merge: clear every armed link rule (held/delayed frames
        flush) and re-announce surviving partitioned daemons to the
        mon (the MOSDBoot a real OSD sends when its links return).
        Peering then re-admits them; scrub_clean is the caller's
        convergence gate."""
        from ceph_tpu_torch.msg.messenger import net_faults

        net_faults.clear()
        for osd in list(self.partitioned):
            self.partitioned.remove(osd)
            if osd in self.dead:
                continue  # killed while partitioned: revive's problem
            d = self.daemons[osd]
            if d.addr is not None:
                self.mon.osd_boot(osd, d.addr)

    # -- recovery observation ------------------------------------------
    def is_recovered(self) -> bool:
        """Every member up, and for every PG: a full up_acting set in
        the map, the PRIMARY's instance peered with no hole in acting
        and no shard catch-up in flight, and no backfill running
        anywhere. Non-primary instances may cache a stale acting view
        from an old interval — only the primary's view (which serves
        ops) counts."""
        if self.dead:
            return False
        osdmap = self.mon.osdmap
        spec = osdmap.pools[self.pool]
        for pgid in range(spec.pg_num):
            acting = osdmap.pg_to_up_acting(self.pool, pgid)
            if any(o == SHARD_NONE for o in acting):
                return False
            primary = next(o for o in acting if o != SHARD_NONE)
            pg = self.daemons[primary]._pgs.get((self.pool, pgid))
            if pg is None:
                continue  # never instantiated: no state to heal
            if not pg.peered.is_set():
                return False
            if any(o == SHARD_NONE for o in pg.acting):
                return False
            if pg.backend.recovering:
                return False
        for d in self.daemons.values():
            if any(t.is_alive() for t in d._backfills.values()):
                return False
        return True

    def wait_recovered(self, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.is_recovered():
                return True
            time.sleep(0.05)
        return self.is_recovered()

    # -- stats-plane recovery observation (round 15) --------------------
    @property
    def pgmap(self):
        """The monitor-side PGMap aggregate the stats plane folds
        primaries' reports into (cluster/pgmap.py)."""
        return self.mon.pgmap

    def is_recovered_stats(self, min_epoch: int = 0) -> bool:
        """Recovery as the STATS PLANE sees it: every reported PG of
        the pool is clean with zero degraded object copies, reported
        at/after ``min_epoch`` (pass the post-revive map epoch so a
        dead primary's stale clean report cannot fake convergence).
        PGs with no report yet (never instantiated — no data) don't
        block; any degraded data forces a report via peering."""
        if self.dead:
            return False
        spec = self.mon.osdmap.pools[self.pool]
        pgmap = self.pgmap
        seen = 0
        for pgid in range(spec.pg_num):
            s = pgmap.get(spec.pool_id, pgid)
            if s is None:
                continue
            if s.reported_epoch < min_epoch:
                return False
            if s.degraded or "clean" not in s.state:
                return False
            seen += 1
        return seen > 0

    def wait_recovered_stats(
        self, timeout: float = 60.0, min_epoch: int = 0
    ) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.is_recovered_stats(min_epoch):
                return True
            time.sleep(0.05)
        return self.is_recovered_stats(min_epoch)

    def scrub_clean(self, repair: bool = True) -> bool:
        """Primary-driven scrub sweep; True iff no object reported
        errors (after optional repair — the post-thrash convergence
        check of the chaos tier)."""
        if repair:
            for d in self.daemons.values():
                if d.osd_id not in self.dead:
                    d.scrub_all(repair=True)
        ok = True
        for d in self.daemons.values():
            if d.osd_id in self.dead:
                continue
            for _pg, results in d.scrub_all().items():
                for r in results:
                    ok = ok and r.ok
        return ok

    def codec(self):
        """The pool's codec instance (device-clock probe input)."""
        from ceph_tpu_torch.codecs import registry

        spec = self.mon.osdmap.pools[self.pool]
        profile = dict(self.mon.osdmap.profiles[spec.profile_name])
        return registry.factory(spec.plugin, profile, self.device)

    # -- multi-device controls ------------------------------------------
    def kill_dcn_host(self, rank: int = 1) -> None:
        """Hard-kill one DCN host process mid-run: the next op's
        cross-host hop faults, the codec dispatcher uninstalls the
        cluster and serves the op on a single-host route (counted in
        ``dcn_fallback``), and the client's retry ladder carries any op
        parked behind the fault to completion."""
        if self.dcn is None:
            raise RuntimeError("no DCN cluster installed")
        self.dcn.procs[rank].kill()

    def dcn_live(self) -> bool:
        """True while the DCN cluster is still the installed dispatch
        route (a mid-run host fault uninstalls it)."""
        from ceph_tpu_torch.parallel import dispatch as mesh_dispatch

        return mesh_dispatch.get_dcn() is self.dcn and self.dcn is not None

    def shutdown(self) -> None:
        from ceph_tpu_torch.msg.messenger import net_faults

        if self.partitioned or net_faults.active:
            net_faults.clear()
            self.partitioned.clear()
        self.client.shutdown()
        for d in self.daemons.values():
            d.stop()
        if self.mesh is not None or self.dcn is not None:
            from ceph_tpu_torch.parallel import dispatch as mesh_dispatch

            mesh_dispatch.set_mesh(self._prev_mesh)
            mesh_dispatch.set_dcn(self._prev_dcn)
            if self.dcn is not None:
                self.dcn.stop()
