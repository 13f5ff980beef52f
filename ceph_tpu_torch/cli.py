"""``ceph``/``rados``-style CLI over a persistent dev cluster — the
vstart.sh + src/tools/rados analog (SURVEY.md §4 tier 3: the
standalone-cluster ops surface).

State lives in a directory: ``mon/store.log`` (the persistent monitor
DB — every committed map epoch) and ``osd.N/`` FileStore trees. Each
invocation boots the cluster from that state, executes one command,
and shuts down — like driving a vstart cluster with the ceph CLI:

    python -m ceph_tpu_torch.cli -d /tmp/c vstart --osds 6
    python -m ceph_tpu_torch.cli -d /tmp/c profile-set rs62 plugin=jerasure \\
        technique=reed_sol_van k=4 m=2
    python -m ceph_tpu_torch.cli -d /tmp/c pool-create mypool 16 rs62
    python -m ceph_tpu_torch.cli -d /tmp/c put mypool obj ./file
    python -m ceph_tpu_torch.cli -d /tmp/c get mypool obj ./out
    python -m ceph_tpu_torch.cli -d /tmp/c ls mypool
    python -m ceph_tpu_torch.cli -d /tmp/c status
    python -m ceph_tpu_torch.cli -d /tmp/c osd-down 3
    python -m ceph_tpu_torch.cli -d /tmp/c scrub --repair
    python -m ceph_tpu_torch.cli -d /tmp/c bench mypool --size 65536 --count 32

``--device`` (before the command; ``cuda`` unless the caller asks for
the CPU) is where the monitor validates profiles and every OSD daemon
runs its codecs, HashInfo and scrub hashes. The state directory's
formats are ``ceph_tpu``'s: a directory made by either package's CLI
boots under the other.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ceph_tpu_torch.cluster import Monitor, OSDDaemon, RadosClient
from ceph_tpu_torch.cluster.mon_store import MonStore
from ceph_tpu_torch.store import BlockStore, FileStore


def _open_store(osd_dir: str):
    from ceph_tpu_torch.store import open_store

    return open_store(osd_dir)


def _cluster_backend(root: str) -> str | None:
    """The backend existing OSDs use (None if no OSDs yet) — a
    scale-up without --store follows the cluster, not the default."""
    for name in sorted(os.listdir(root)) if os.path.isdir(root) else []:
        if name.startswith("osd."):
            marker = os.path.join(root, name, "backend")
            if os.path.exists(marker):
                return open(marker).read().strip()
            return (
                "block"
                if os.path.exists(os.path.join(root, name, "block"))
                else "file"
            )
    return None


class Cluster:
    """Boot the persistent dev cluster from a state dir."""

    def __init__(self, root: str, quiet: bool = True, device="cuda") -> None:
        from ceph_tpu_torch.utils.device import resolve_device

        self.root = root
        #: where the monitor and every OSD daemon run
        self.device = resolve_device(device)
        # keyring (cluster PSK): presence turns on AES-GCM secure mode
        # for every daemon and client link of this cluster
        keyring = os.path.join(root, "keyring")
        self.secret: bytes | None = None
        if os.path.exists(keyring):
            self.secret = open(keyring, "rb").read().strip() or None
        # mon tier: a single authority by default; ``vstart --mons N``
        # records N in root/mons and every later boot runs a real
        # quorum (MonQuorumService: Paxos-committed epochs, leader
        # routing, per-rank durable stores)
        mons_file = os.path.join(root, "mons")
        self.n_mons = 1
        if os.path.exists(mons_file):
            raw = open(mons_file).read().strip()
            try:
                self.n_mons = max(1, int(raw or 1))
            except ValueError:
                # a garbled mons file must not brick every command —
                # infer the quorum size from the rank-store dirs
                ranks = [
                    d for d in os.listdir(root)
                    if d.startswith("mon.") and d[4:].isdigit()
                ]
                self.n_mons = max(1, len(ranks))
                print(
                    f"warning: unreadable {mons_file} ({raw!r}); "
                    f"assuming {self.n_mons} mons from rank stores",
                    file=sys.stderr,
                )
        if self.n_mons > 1:
            self._boot_mon_quorum(root)
        else:
            self.mon_store = MonStore(os.path.join(root, "mon", "store.log"))
            initial, history = self.mon_store.replay()
            # a cluster DOWNGRADED from a quorum: the rank stores may
            # be ahead of the legacy store — abandoning them would
            # silently lose every epoch committed in quorum mode (and
            # regress the pool-id floor into reuse hazards). Seed from
            # the newest store, and take the pool-id floor across ALL
            # stores (a rank store's trimmed history may remember ids
            # the survivor's window no longer does).
            floor = self.mon_store.pool_id_floor()
            for name in sorted(os.listdir(root)) if os.path.isdir(root) else []:
                if not (name.startswith("mon.") and name[4:].isdigit()):
                    continue
                rs = MonStore(os.path.join(root, name, "store.log"))
                floor = max(floor, rs.pool_id_floor())
                rm, rh = rs.replay()
                if rm.epoch > initial.epoch:
                    by_epoch = {i.epoch: i for i in rh}
                    if all(
                        e in by_epoch
                        for e in range(initial.epoch + 1, rm.epoch + 1)
                    ):
                        for e in range(initial.epoch + 1, rm.epoch + 1):
                            self.mon_store.append(by_epoch[e])
                    else:
                        self.mon_store.trim(rm)
                    initial, history = self.mon_store.replay()
            self.mon = Monitor(
                initial=initial, commit_fn=self.mon_store.append,
                history=history,
                pool_id_floor=floor,
                device=self.device,
            )
            if len(history) > self.mon_store.keep:
                self.mon_store.trim(initial)
        self.daemons: dict[int, OSDDaemon] = {}
        for name in sorted(os.listdir(root)) if os.path.isdir(root) else []:
            if not name.startswith("osd."):
                continue
            osd = int(name.split(".", 1)[1])
            if os.path.exists(os.path.join(root, name, "stopped")):
                continue  # operator stopped it (osd-down marker)
            store = _open_store(os.path.join(root, name))
            d = OSDDaemon(osd, self.mon, store=store, secret=self.secret,
                          device=self.device)
            d.start()
            self.daemons[osd] = d
        # anything in the map but not on disk is gone: mark it down
        for osd in sorted(self.mon.osdmap.up_osds() - set(self.daemons)):
            self.mon.osd_down(osd)
        self.client = RadosClient(self.mon, backoff=0.02, secret=self.secret)

    def _boot_mon_quorum(self, root: str) -> None:
        """N monitor ranks, each with its own durable store; the map
        service is the quorum handle (leader-routed, Paxos-committed).
        Resume takes the highest-epoch rank store as canonical and
        heals laggards (the mon store sync phase)."""
        from ceph_tpu_torch.cluster.mon_quorum import (
            MonQuorumService,
            QuorumMonitor,
        )

        self.mon_stores = [
            MonStore(os.path.join(root, f"mon.{r}", "store.log"))
            for r in range(self.n_mons)
        ]
        replays = [s.replay() for s in self.mon_stores]
        initial, history = max(replays, key=lambda t: t[0].epoch)
        # the canonical seed may live OUTSIDE ranks 0..n-1: the legacy
        # single-mon store (1 -> N growth) or a higher rank's store
        # (shrinking the quorum after its leader sat above the new n).
        # The store DIR is the identity (the KV store lives beside the
        # legacy log-file path, which MonStore removes after import).
        legacy_dir = os.path.join(root, "mon")
        legacy_store = None
        extra_floor = 0
        if os.path.isdir(legacy_dir):
            legacy_store = MonStore(os.path.join(legacy_dir, "store.log"))
            lm, lh = legacy_store.replay()
            if lm.epoch > initial.epoch:
                initial, history = lm, lh
        for name in sorted(os.listdir(root)):
            if not (name.startswith("mon.") and name[4:].isdigit()):
                continue
            if int(name[4:]) < self.n_mons:
                continue  # in-quorum rank, already replayed above
            ds = MonStore(os.path.join(root, name, "store.log"))
            extra_floor = max(extra_floor, ds.pool_id_floor())
            dm, dh = ds.replay()
            if dm.epoch > initial.epoch:
                initial, history = dm, dh
        by_epoch = {i.epoch: i for i in history}
        for r, (m, _h) in enumerate(replays):
            if m.epoch >= initial.epoch:
                continue
            # heal a lagging store: contiguous tail append when the
            # window reaches back far enough, else full-map snapshot
            if all(
                e in by_epoch for e in range(m.epoch + 1, initial.epoch + 1)
            ):
                for e in range(m.epoch + 1, initial.epoch + 1):
                    self.mon_stores[r].append(by_epoch[e])
            else:
                self.mon_stores[r].trim(initial)
        floor = max(s.pool_id_floor() for s in self.mon_stores)
        floor = max(floor, extra_floor)
        if legacy_store is not None:
            floor = max(floor, legacy_store.pool_id_floor())
        self.mon_quorum = MonQuorumService(
            self.n_mons,
            on_commit=lambda r, incr: self.mon_stores[r].append(incr),
            initial=initial,
            history=history,
            pool_id_floor=floor,
            device=self.device,
        )
        # operator-stopped ranks stay down across invocations (the
        # osd "stopped" marker convention, mon tier). Boot-time clamp:
        # markers that would leave a minority are IGNORED — a wedged
        # quorum cannot serve the commands needed to unwedge it, so
        # the directory would be unrecoverable from the CLI.
        stopped = [
            r for r in range(self.n_mons)
            if os.path.exists(os.path.join(root, f"mon.{r}", "stopped"))
        ]
        if (self.n_mons - len(stopped)) * 2 <= self.n_mons:
            print(
                f"warning: stopped markers for mons {stopped} would "
                "lose quorum; ignoring them (reviving all ranks)",
                file=sys.stderr,
            )
        else:
            for r in stopped:
                self.mon_quorum.kill(r)
        self.mon = QuorumMonitor(self.mon_quorum)

    def add_osd(self, osd: int, zone: str = "", backend: str | None = None) -> None:
        self.mon.osd_crush_add(osd, zone=zone)
        backend = backend or _cluster_backend(self.root) or "file"
        path = os.path.join(self.root, f"osd.{osd}")
        store = BlockStore(path) if backend == "block" else FileStore(path)
        with open(os.path.join(path, "backend"), "w") as f:
            f.write(backend)
        d = OSDDaemon(osd, self.mon, store=store, secret=self.secret,
                      device=self.device)
        d.start()
        self.daemons[osd] = d

    def settle(self, timeout: float = 60.0) -> None:
        """Wait for pending backfills (pg_temp) to clear."""
        end = time.monotonic() + timeout
        while self.mon.osdmap.pg_temp and time.monotonic() < end:
            time.sleep(0.05)

    def shutdown(self) -> None:
        self.settle(timeout=5.0)
        self.client.shutdown()
        for d in self.daemons.values():
            d.stop()
            if hasattr(d.store, "close"):
                d.store.close()


def cmd_vstart(cl: Cluster, args) -> int:
    if getattr(args, "secure", False) and cl.secret is None:
        # generate the keyring; takes effect from the NEXT invocation
        # (this one already booted plaintext)
        import secrets as _secrets

        # hex, not raw bytes: the file is read with a whitespace
        # strip, which must never change the effective key.  0o600:
        # the PSK must not be world-readable on multi-user hosts
        # (ceph treats keyring files the same way).
        fd = os.open(
            os.path.join(cl.root, "keyring"),
            os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
            0o600,
        )
        # O_CREAT's mode only applies to fresh inodes; a pre-existing
        # (e.g. empty) keyring keeps its old perms without this.
        os.fchmod(fd, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(_secrets.token_hex(32) + "\n")
        print("keyring written: cluster runs AES-GCM secure mode from "
              "the next invocation")
    if getattr(args, "mons", None):
        with open(os.path.join(cl.root, "mons"), "w") as f:
            f.write(str(max(1, args.mons)))
        if args.mons != cl.n_mons:
            print(f"mon quorum size set to {args.mons}: takes effect "
                  "from the next invocation")
    existing = set(cl.daemons)
    for i in range(args.osds):
        if i not in existing:
            cl.add_osd(
                i, zone=f"z{i % max(args.zones, 1)}", backend=args.store
            )
    mons = (f"{cl.n_mons} mons (leader mon."
            f"{cl.mon_quorum.leader_rank()})" if cl.n_mons > 1
            else "1 mon")
    print(f"cluster up: {len(cl.daemons)} osds, {mons}, epoch "
          f"{cl.mon.osdmap.epoch}, dir {cl.root}")
    if getattr(args, "exporter", None) is not None:
        import time as _time

        from ceph_tpu_torch.utils.exporter import Exporter

        exp = Exporter()
        host, port = exp.start(port=args.exporter)
        print(f"metrics: http://{host}:{port}/metrics (ctrl-c to stop)")
        # The CLI is one-command-and-exit; an exporter only makes
        # sense while the cluster process lives, so this invocation
        # blocks and serves until interrupted.
        try:
            while True:
                _time.sleep(1)
        except KeyboardInterrupt:
            pass
        finally:
            exp.stop()
    return 0


def _flush_stats(cl: Cluster) -> None:
    """Force a stats report from every live daemon so the status/pg
    dump/df surfaces read fresh numbers instead of waiting a tick
    (the CLI is one-command-and-exit)."""
    for d in cl.daemons.values():
        try:
            d.report_pg_stats(force=True)
        except Exception:
            pass


def cmd_status(cl: Cluster, args) -> int:
    """The `ceph -s` role: health digest + mon/osd census + PG state
    histogram + client/recovery IO rates, all from the stats plane
    (cluster/pgmap.py)."""
    from ceph_tpu_torch.cluster.pgmap import format_status, status_dict

    _flush_stats(cl)
    st = status_dict(cl.mon)
    if cl.n_mons > 1:
        svc = cl.mon_quorum
        live = sorted(set(range(svc.n)) - svc.dead)
        st["mons"] = (
            f"{svc.n} total, quorum {live} "
            f"(leader mon.{svc.leader_rank()})"
        )
    text = format_status(st)
    if "mons" in st:
        text = text.replace(
            f"    mon: epoch {st['epoch']}",
            f"    mon: {st['mons']}, epoch {st['epoch']}",
        )
    print(text)
    m = cl.mon.osdmap
    for name, spec in sorted(m.pools.items()):
        print(
            f"    pool {name!r}: id {spec.pool_id}, {spec.pg_num} "
            f"pgs, EC {spec.k}+{spec.m} ({spec.plugin}/"
            f"{spec.profile_name})"
        )
    if m.pg_temp:
        print(f"    backfilling: {sorted(m.pg_temp)}")
    return 0


def cmd_pg_dump(cl: Cluster, args) -> int:
    """The `ceph pg dump` role: every PG's stats row + osd stats."""
    from ceph_tpu_torch.cluster.pgmap import format_pg_dump

    _flush_stats(cl)
    dump = cl.mon.pgmap.pg_dump()
    if getattr(args, "json", False):
        print(json.dumps(dump, sort_keys=True, default=str))
    else:
        print(format_pg_dump(dump))
    return 0


def cmd_df(cl: Cluster, args) -> int:
    """The `ceph df` role: cluster capacity + per-pool usage from
    the stats plane's store census."""
    from ceph_tpu_torch.cluster.pgmap import format_df

    _flush_stats(cl)
    df = cl.mon.pgmap.df(cl.mon.osdmap)
    if getattr(args, "json", False):
        print(json.dumps(df, sort_keys=True))
    else:
        print(format_df(df))
    return 0


def cmd_osd_tree(cl: Cluster, args) -> int:
    m = cl.mon.osdmap
    for osd, info in sorted(m.osds.items()):
        state = ("up" if info.up else "down") + "/" + (
            "in" if info.in_ else "out"
        )
        addr = f"{info.addr[0]}:{info.addr[1]}" if info.addr else "-"
        where = (
            " ".join(f"{t}={b}" for t, b in info.location)
            or (f"zone {info.zone}" if info.zone else "-")
        )
        print(
            f"osd.{osd}\tweight {info.weight:.2f}\t{where}\t"
            f"{state}\t{addr}"
        )
    for name, steps in sorted(m.crush_rules.items()):
        rendered = "; ".join(" ".join(str(x) for x in s) for s in steps)
        print(f"rule {name}: {rendered}")
    return 0


def cmd_profile_set(cl: Cluster, args) -> int:
    profile = dict(kv.split("=", 1) for kv in args.kv)
    cl.mon.osd_erasure_code_profile_set(args.name, profile, force=args.force)
    print(f"profile {args.name!r} = {profile}")
    return 0


def cmd_pool_create(cl: Cluster, args) -> int:
    cl.mon.osd_pool_create(
        args.name, args.pg_num, args.profile,
        distinct_zones=args.distinct_zones,
        failure_domain=args.failure_domain,
    )
    spec = cl.mon.osdmap.pools[args.name]
    rule = f", rule {spec.crush_rule!r}" if spec.crush_rule else ""
    print(f"pool {args.name!r} created: EC {spec.k}+{spec.m}, "
          f"{spec.pg_num} pgs{rule}")
    return 0


def cmd_snap(cl: Cluster, args) -> int:
    """pool snapshots: create / rm / ls (rados mksnap/rmsnap/lssnap)."""
    if args.action in ("create", "rm") and not args.snap:
        print(f"snap {args.action} needs a snap name")
        return 1
    if args.action == "create":
        cl.mon.osd_pool_snap_create(args.pool, args.snap)
        print(f"created pool snap {args.snap!r} on {args.pool!r}")
    elif args.action == "rm":
        cl.mon.osd_pool_snap_rm(args.pool, args.snap)
        print(f"removed pool snap {args.snap!r} from {args.pool!r}")
    else:  # ls
        spec = cl.mon.osdmap.pools.get(args.pool)
        if spec is None:
            print(f"no such pool: {args.pool!r}")
            return 1
        for sid, name, epoch in spec.snaps:
            print(f"{sid}\t{name}\t(epoch {epoch})")
    return 0


def cmd_put(cl: Cluster, args) -> int:
    data = (
        sys.stdin.buffer.read() if args.file == "-"
        else open(args.file, "rb").read()
    )
    io = cl.client.open_ioctx(args.pool)
    io.write_full(args.oid, data)
    print(f"wrote {len(data)} bytes to {args.pool}/{args.oid}")
    return 0


def cmd_get(cl: Cluster, args) -> int:
    io = cl.client.open_ioctx(args.pool)
    data = io.read(args.oid)
    if args.file == "-":
        sys.stdout.buffer.write(data)
    else:
        with open(args.file, "wb") as f:
            f.write(data)
        print(f"read {len(data)} bytes from {args.pool}/{args.oid}")
    return 0


def cmd_rm(cl: Cluster, args) -> int:
    cl.client.open_ioctx(args.pool).remove(args.oid)
    print(f"removed {args.pool}/{args.oid}")
    return 0


def cmd_ls(cl: Cluster, args) -> int:
    # the client-visible listing (PGLS through primaries), not a
    # direct store peek
    for oid in cl.client.open_ioctx(args.pool).list_objects():
        print(oid)
    return 0


def cmd_stat(cl: Cluster, args) -> int:
    size = cl.client.open_ioctx(args.pool).stat(args.oid)
    print(f"{args.pool}/{args.oid}: {size} bytes")
    return 0


def cmd_mon_kill(cl: Cluster, args) -> int:
    """Take a monitor rank down durably (the mon-chaos surface).
    Refuses to kill into a lost quorum — a majority-dead quorum
    cannot serve the commands needed to revive it."""
    if cl.n_mons < 2:
        print("single-mon cluster: nothing to kill", file=sys.stderr)
        return 1
    svc = cl.mon_quorum
    r = args.rank
    if r < 0 or r >= svc.n:
        print(f"no such mon rank {r}", file=sys.stderr)
        return 1
    live_after = svc.n - len(svc.dead | {r})
    if live_after * 2 <= svc.n:
        # strictly-more-than-half must survive — for ANY n, odd or
        # even (an earlier >= n+1 pre-check skipped the guard at n=2
        # and wedged the cluster directory)
        print(
            f"refusing: killing mon.{r} would leave {live_after}/"
            f"{svc.n} — quorum lost and unrecoverable from the "
            "CLI", file=sys.stderr,
        )
        return 1
    svc.kill(r)
    open(os.path.join(cl.root, f"mon.{r}", "stopped"), "w").close()
    print(f"mon.{r} killed (leader now mon.{svc.leader_rank()})")
    return 0


def cmd_mon_revive(cl: Cluster, args) -> int:
    if cl.n_mons < 2:
        print("single-mon cluster", file=sys.stderr)
        return 1
    svc = cl.mon_quorum
    if args.rank < 0 or args.rank >= svc.n:
        print(f"no such mon rank {args.rank}", file=sys.stderr)
        return 1
    marker = os.path.join(cl.root, f"mon.{args.rank}", "stopped")
    if os.path.exists(marker):
        os.remove(marker)
    svc.revive(args.rank)
    print(f"mon.{args.rank} revived (caught up from the quorum log)")
    return 0


def cmd_osd_down(cl: Cluster, args) -> int:
    d = cl.daemons.pop(args.osd, None)
    if d is not None:
        d.stop()
        if hasattr(d.store, "close"):
            d.store.close()  # final checkpoint for BlockStore
    open(os.path.join(cl.root, f"osd.{args.osd}", "stopped"), "w").close()
    cl.mon.osd_down(args.osd)
    print(f"osd.{args.osd} stopped + marked down")
    return 0


def cmd_osd_up(cl: Cluster, args) -> int:
    marker = os.path.join(cl.root, f"osd.{args.osd}", "stopped")
    if os.path.exists(marker):
        os.unlink(marker)
    if args.osd not in cl.daemons:
        store = _open_store(os.path.join(cl.root, f"osd.{args.osd}"))
        d = OSDDaemon(args.osd, cl.mon, store=store, device=cl.device)
        d.start()
        cl.daemons[args.osd] = d
    cl.settle()
    print(f"osd.{args.osd} restarted")
    return 0


def cmd_osd_out(cl: Cluster, args) -> int:
    cl.mon.osd_out(args.osd)
    cl.settle()
    print(f"osd.{args.osd} marked out; rebalance settled")
    return 0


def cmd_osd_in(cl: Cluster, args) -> int:
    cl.mon.osd_in(args.osd)
    cl.settle()
    print(f"osd.{args.osd} marked in; rebalance settled")
    return 0


def cmd_scrub(cl: Cluster, args) -> int:
    total = bad = repaired = 0
    for d in list(cl.daemons.values()):
        for (pool, pgid), results in d.scrub_all(repair=args.repair).items():
            for r in results:
                total += 1
                if not r.ok:
                    bad += 1
                    print(f"{pool}/{pgid} {r.oid}: "
                          + "; ".join(
                              f"shard {e.shard} {e.kind} {e.detail}"
                              for e in r.errors))
                if r.repaired:
                    repaired += 1
    print(f"scrubbed {total} objects: {bad} inconsistent, "
          f"{repaired} repaired")
    return 1 if (bad and not args.repair) else 0


def cmd_perf(cl: Cluster, args) -> int:
    """The `ceph daemon ... perf dump` role: every pipeline's counters
    (all daemons share this process's collection)."""
    from ceph_tpu_torch.utils import perf_collection

    def active(v) -> bool:
        if isinstance(v, (int, float)):
            return bool(v)
        if isinstance(v, dict):
            if "counts" in v:  # histogram: samples, not bucket edges
                return any(v["counts"])
            return any(active(x) for x in v.values())
        return False

    snap = perf_collection.dump()
    for logger in sorted(snap):
        if args.grep and args.grep not in logger:
            continue
        counters = {k: v for k, v in snap[logger].items() if active(v)}
        if counters:
            print(json.dumps({logger: counters}))
    return 0


def cmd_health(cl: Cluster, args) -> int:
    """The `ceph health detail` role (mgr health model), plus the
    cluster-log digest the reference appends as `ceph -s` recent
    events (slow ops, down-marks, scrub errors, peering stalls)."""
    from ceph_tpu_torch.cluster import Manager
    from ceph_tpu_torch.utils.cluster_log import cluster_log

    _flush_stats(cl)
    report = Manager(cl.mon).health()
    print(report["status"])
    for name, check in sorted(report["checks"].items()):
        print(f"  [{check['severity'].upper()}] {name}: {check['detail']}")
    summary = cluster_log.summary()
    print(
        f"cluster log: {summary['events']} recent events, "
        f"{summary['warnings']} warnings"
    )
    for e in summary["recent_warnings"]:
        print(
            f"  {e['severity']} [{e['daemon']}] {e['type']}: "
            f"{e['message']}"
        )
    return 0 if report["status"] == "HEALTH_OK" else 1


def cmd_autoscale_status(cl: Cluster, args) -> int:
    """The `ceph osd pool autoscale-status` role."""
    from ceph_tpu_torch.cluster import Manager

    for row in Manager(cl.mon).autoscale_status():
        flag = " (warn)" if row["warn"] else ""
        print(
            f"pool {row['pool']!r}: pg_num {row['pg_num']}, "
            f"ideal ~{row['ideal_pg_num']}{flag}"
        )
    return 0


def cmd_balance(cl: Cluster, args) -> int:
    """One balancer run (the `ceph balancer execute` role): reweight
    until the target PG-shard distribution settles, then wait for the
    resulting backfills to finish."""
    from ceph_tpu_torch.cluster import Manager

    mgr = Manager(cl.mon)
    before = mgr.pg_shard_counts()
    rounds = mgr.balance()
    after = mgr.pg_shard_counts()
    cl.settle(timeout=args.timeout)
    print(f"balanced in {rounds} rounds: {before} -> {after}")
    return 0


def cmd_bench(cl: Cluster, args) -> int:
    """The `rados bench` role: parallel writes then reads via aio
    (objects spread over primaries; concurrency is the point)."""
    import numpy as np

    io = cl.client.open_ioctx(args.pool)
    blob = np.random.default_rng(0).integers(
        0, 256, args.size, dtype=np.uint8
    ).tobytes()
    # the shared objecter aio pool bounds real in-flight ops at 16:
    # clamp so the reported depth is the actual one
    depth = min(max(args.concurrency, 1), 16)

    def run_phase(fn) -> float:
        t0 = time.perf_counter()
        pending = []
        for i in range(args.count):
            pending.append(fn(i))
            if len(pending) >= depth:
                pending.pop(0).wait_for_complete()
        for c in pending:
            c.wait_for_complete()
        return time.perf_counter() - t0

    try:
        t_w = run_phase(lambda i: io.aio_write(f"bench_{i}", blob))
        reads: list = []
        t_r = run_phase(
            lambda i: io.aio_read(f"bench_{i}", on_complete=reads.append)
        )
        bad = [c for c in reads if c.reply is not None
               and c.reply.data != blob]
        if bad:
            raise IOError(f"{len(bad)} reads returned wrong bytes")
    finally:
        # bench objects must not survive a failed run
        for i in range(args.count):
            try:
                io.remove(f"bench_{i}")
            except FileNotFoundError:
                pass
    mb = args.size * args.count / 1e6
    print(json.dumps({
        "write_MBps": round(mb / t_w, 2),
        "read_MBps": round(mb / t_r, 2),
        "ops": args.count,
        "object_size": args.size,
        "concurrency": depth,
    }))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ceph_tpu_torch.cli", description=__doc__.splitlines()[0]
    )
    p.add_argument("-d", "--dir", required=True, help="cluster state dir")
    p.add_argument(
        "--device", default="cuda",
        help="device of the monitor and every OSD daemon (cuda, or cpu)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("vstart", help="create/boot a dev cluster")
    s.add_argument("--osds", type=int, default=6)
    s.add_argument("--zones", type=int, default=3)
    s.add_argument(
        "--mons", type=int, default=None,
        help="monitor quorum size (>1 boots a Paxos quorum with "
             "leader routing from the next invocation)",
    )
    s.add_argument(
        "--store", choices=("file", "block"), default=None,
        help="OSD backend for NEW osds: FileStore tree or BlockStore "
             "raw device (default: whatever the cluster already uses, "
             "else file)",
    )
    s.add_argument(
        "--secure", action="store_true",
        help="generate a cluster keyring (AES-GCM secure mode for all "
             "links from the next invocation on)",
    )
    s.add_argument(
        "--exporter", type=int, nargs="?", const=0, default=None,
        metavar="PORT",
        help="serve Prometheus /metrics (0 or no value = ephemeral "
             "port; the src/exporter + mgr/prometheus analog)",
    )
    s.set_defaults(fn=cmd_vstart)

    sub.add_parser(
        "status", help="the `ceph -s` shape: health + census + PG "
        "state histogram + IO rates from the stats plane"
    ).set_defaults(fn=cmd_status)
    sub.add_parser("osd-tree").set_defaults(fn=cmd_osd_tree)

    s = sub.add_parser(
        "pg", help="PG-stats surfaces (`pg dump`)"
    )
    s.add_argument("action", choices=["dump"])
    s.add_argument("--json", action="store_true",
                   help="machine-readable dump")
    s.set_defaults(fn=cmd_pg_dump)

    s = sub.add_parser(
        "df", help="cluster + per-pool capacity/usage (`ceph df`)"
    )
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_df)

    s = sub.add_parser("profile-set")
    s.add_argument("name")
    s.add_argument("kv", nargs="+", help="key=value pairs")
    s.add_argument("--force", action="store_true")
    s.set_defaults(fn=cmd_profile_set)

    s = sub.add_parser("pool-create")
    s.add_argument("name")
    s.add_argument("pg_num", type=int)
    s.add_argument("profile", nargs="?", default="")
    s.add_argument("--distinct-zones", action="store_true")
    s.add_argument(
        "--failure-domain", default="",
        help="spread shards across this bucket type (host/rack/...) "
             "via an auto-created crush rule",
    )
    s.set_defaults(fn=cmd_pool_create)

    s = sub.add_parser(
        "snap", help="pool snapshots (rados mksnap/rmsnap/lssnap)"
    )
    s.add_argument("action", choices=["create", "rm", "ls"])
    s.add_argument("pool")
    s.add_argument("snap", nargs="?", default="")
    s.set_defaults(fn=cmd_snap)

    for name, fn, extra in (
        ("put", cmd_put, ["pool", "oid", "file"]),
        ("get", cmd_get, ["pool", "oid", "file"]),
        ("rm", cmd_rm, ["pool", "oid"]),
        ("ls", cmd_ls, ["pool"]),
        ("stat", cmd_stat, ["pool", "oid"]),
    ):
        s = sub.add_parser(name)
        for a in extra:
            s.add_argument(a)
        s.set_defaults(fn=fn)

    for name, fn in (
        ("osd-down", cmd_osd_down),
        ("osd-up", cmd_osd_up),
        ("osd-out", cmd_osd_out),
        ("osd-in", cmd_osd_in),
    ):
        s = sub.add_parser(name)
        s.add_argument("osd", type=int)
        s.set_defaults(fn=fn)

    for name, fn in (
        ("mon-kill", cmd_mon_kill),
        ("mon-revive", cmd_mon_revive),
    ):
        s = sub.add_parser(
            name, help=f"{name.split('-')[1]} a monitor rank "
            "(quorum chaos surface; --mons > 1 clusters)"
        )
        s.add_argument("rank", type=int)
        s.set_defaults(fn=fn)

    s = sub.add_parser("scrub")
    s.add_argument("--repair", action="store_true")
    s.set_defaults(fn=cmd_scrub)

    sub.add_parser(
        "health", help="structured health report (mgr health model)"
    ).set_defaults(fn=cmd_health)
    sub.add_parser(
        "autoscale-status", help="pg_autoscaler recommendations"
    ).set_defaults(fn=cmd_autoscale_status)
    s = sub.add_parser("balance", help="run the balancer (mgr module)")
    s.add_argument("--timeout", type=float, default=60.0)
    s.set_defaults(fn=cmd_balance)

    s = sub.add_parser("perf", help="dump perf counters (perf dump)")
    s.add_argument("--grep", default="", help="substring filter")
    s.set_defaults(fn=cmd_perf)

    s = sub.add_parser("bench")
    s.add_argument("pool")
    s.add_argument("--size", type=int, default=65536)
    s.add_argument("--count", type=int, default=16)
    s.add_argument("--concurrency", type=int, default=8,
                   help="in-flight aio ops (rados bench -t)")
    s.set_defaults(fn=cmd_bench)

    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cl = Cluster(args.dir, device=args.device)
    try:
        return args.fn(cl, args)
    finally:
        cl.shutdown()


if __name__ == "__main__":
    sys.exit(main())
