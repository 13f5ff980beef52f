"""OSD daemon — the data-plane node (src/osd/OSD.cc + PrimaryLogPG).

One ``OSDDaemon`` is one storage node: a local object store, a
messenger endpoint, and the current OSDMap. It plays both reference
roles:

- **replica**: serves ECSubWrite/ECSubRead from peer primaries against
  its local store (handle_sub_write/read, osd/ECBackend.cc:912,998).
- **primary**: serves client ``OSDOp``s for objects it leads. Per-PG
  state mirrors the reference's PG objects: each (pool, pg) gets an
  ``RMWPipeline`` + ``ReadPipeline`` bound to a ``_PGBackend`` that
  routes shard i of the acting set to the right peer (itself included)
  — the ECSwitch-ctor wiring (osd/ECSwitch.h:36-48) resolved through
  the osdmap instead of static config.

Map flow: daemons subscribe to the monitor in-process (the MOSDMap
push channel collapsed to a callback — the wire format exists in
``cluster.osdmap`` serialization; transporting it is deployment
plumbing, not protocol). On a map change, PGs whose acting set changed
are dropped and lazily rebuilt; a NEW primary recovers per-object
state (size, cumulative crcs) from the OI_KEY/HINFO_KEY attrs its
local shard stores carry (the object_info_t takeover path).

Wrong-primary requests answer ``eagain`` + the daemon's epoch, and the
client re-targets (Objecter resend contract, osdc/Objecter.cc:2127).

Peering — the authoritative-log election, the self-rewind, interval
fencing and returning-member admission — is driven by the per-PG
state machine in ``cluster/peering.py`` (the PeeringState.cc analog;
the pre-FSM thread-and-flags path was folded out in round 16 after
four rounds of green soaks — ROADMAP closeout 1b). This module keeps
the peering PRIMITIVES the FSM composes: ``_own_pg_info``,
``_bump_fence``, ``_pgmeta_write_les``, ``_sub_write_interval_ok``,
the PGInfo/PGActivate services, and ``_catch_up_shard``.

Client ops are serialized by a daemon op lock (the reference serializes
per-PG via op queues; the mClock scheduler seam slots in here).
Peer-failure evidence flows to the monitor via ``report_failure``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from ceph_tpu_torch.msg.messages import (
    BackfillReserve,
    BackfillReserveReply,
    ECSubRead,
    ECSubReadReply,
    ECSubWrite,
    ECSubWriteBatch,
    ECSubWriteBatchReply,
    ECSubWriteReply,
    GetAttrs,
    NotifyAck,
    OSDOp,
    OSDOpReply,
    PGActivate,
    PGActivateAck,
    PGInfo,
    PGInfoReply,
    PGList,
    PGListReply,
    Ping,
    Pong,
    WatchNotify,
)
from ceph_tpu_torch.msg.messages import serve_get_attrs
from ceph_tpu_torch.msg.messenger import Connection, Messenger
from ceph_tpu_torch.msg.shard_server import NetShardBackend
from ceph_tpu_torch.codecs import registry
from ceph_tpu_torch.pipeline.extents import ExtentSet
from ceph_tpu_torch.pipeline.hashinfo import HashInfo
from ceph_tpu_torch.pipeline.pglog import PGLog
from ceph_tpu_torch.pipeline.read import ReadPipeline, ShardReadError
from ceph_tpu_torch.pipeline.recovery import RecoveryBackend
from ceph_tpu_torch.pipeline.rmw import (
    HINFO_KEY,
    OI_KEY,
    SI_KEY,
    RMWPipeline,
    ShardBackend,
    pack_oi,
    parse_oi,
)
from ceph_tpu_torch.pipeline.stripe import StripeInfo
from ceph_tpu_torch.store import MemStore, Transaction
from ceph_tpu_torch.utils import tracer
from ceph_tpu_torch.utils.lockdep import DebugLock
from ceph_tpu_torch.utils.mclock import MClockScheduler

from . import qos as _qos
from .osdmap import OSDMap, SHARD_NONE
from .peering import PgPeeringFsm, crash_points, make_peering_perf

#: ops whose re-application a lost-reply resend must not repeat
_MUTATING_OPS = frozenset(
    {"write", "remove", "setxattr", "rmxattr", "omapset", "rollback",
     "append", "truncate", "writefull"}
)

#: client ops the per-tick coalescer may batch: plain EC writes.
#: Appends stay solo (their offset resolves against the PREVIOUS
#: op's committed size, which a batch-mate could move); reads and
#: metadata ops gain nothing from encode batching.
_COALESCE_OPS = frozenset({"write", "writefull"})


class _ClientOpItem:
    """One queued client op as the mClock scheduler carries it:
    callable (the classic serial path) but introspectable, so the
    worker can recognize a RUN of coalescable writes and execute
    them as one tick batch."""

    __slots__ = ("daemon", "conn", "msg", "shard")

    def __init__(self, daemon: "OSDDaemon", conn, msg) -> None:
        self.daemon = daemon
        self.conn = conn
        self.msg = msg
        #: op-shard this item was routed to at dispatch; execution
        #: serializes under that shard's lock (shard 0 == the classic
        #: single _op_lock path)
        self.shard = 0

    def __call__(self) -> None:
        self.daemon._run_client_op(self.conn, self.msg, self.shard)

    def coalescable(self) -> bool:
        return self.msg.op in _COALESCE_OPS


class _CoalCtx:
    """Per-op state threaded through the coalesced batch's three
    phases (serial prelude under the op lock -> concurrent per-PG
    execution -> serial epilogue)."""

    __slots__ = (
        "conn", "msg", "spec", "pgid", "epoch", "pg", "w_offset",
        "result_size", "attrs", "trunc_attrs", "done", "outcome",
        "size", "trace_ctx",
    )

    def __init__(self, conn, msg, spec, pgid, epoch) -> None:
        self.conn = conn
        self.msg = msg
        self.spec = spec
        self.pgid = pgid
        self.epoch = epoch
        self.pg = None
        self.w_offset = 0
        self.result_size = 0
        self.attrs = None
        self.trunc_attrs = None
        #: (trace_id, osd_op span id) captured at submit: later batch
        #: phases (the writefull truncate half) re-enter this context
        #: so their sub-op spans stay under the op's primary subtree
        self.trace_ctx = (None, None)
        self.done: list = []
        #: ("ok", None) | ("eio", detail: recorded under the reqid)
        #: | ("exc", detail: NOT recorded — mirrors the serial path,
        #: where an exception bypasses _record_completed)
        self.outcome = None
        self.size = 0


#: coalesced tick-batch sizes, log2 (1, 2, 4, ... 1024 ops)
_COAL_BUCKETS = [float(1 << i) for i in range(11)]


def _coalesce_perf(name: str):
    """The daemon's coalescing observability (`perf dump` section
    ``osd.<id>.coalesce``): how many ops rode a multi-op tick batch,
    the batch-size histogram, and the sub-write frames the per-peer
    fan-out packing saved."""
    from ceph_tpu_torch.utils import PerfCountersBuilder, perf_collection

    return (
        PerfCountersBuilder(perf_collection, name)
        .add_u64_counter(
            "op_coalesced", "client ops executed in a multi-op batch"
        )
        .add_histogram(
            "batch_size", _COAL_BUCKETS,
            "coalesced tick-batch size in ops (log2 buckets)",
        )
        .add_u64_counter(
            "subwrite_batches", "multi-sub-write frames sent to peers"
        )
        .add_u64_counter(
            "subwrite_batched_ops",
            "sub-writes that shared a frame with at least one other",
        )
        .create_perf_counters()
    )


def make_net_perf(name: str):
    """The per-daemon ``net`` counter set (``perf dump`` section
    ``osd.<id>.net``, Prometheus via the exporter): what the seeded
    fault plane did to this daemon's links, and what the dedup tiers
    absorbed — the observability half of the chaos contract (injected
    faults MUST show up here, absorbed duplicates MUST show up there,
    and the ledger still balances exactly-once) — plus the replies its
    sub-op drain loop re-queued (``NetShardBackend._drain_until``)."""
    from ceph_tpu_torch.utils import PerfCountersBuilder, perf_collection

    return (
        PerfCountersBuilder(perf_collection, name)
        .add_u64_counter(
            "frames_dropped", "frames dropped by fault injection"
        )
        .add_u64_counter(
            "frames_delayed", "frames delayed by fault injection"
        )
        .add_u64_counter(
            "frames_duped", "frames duplicated by fault injection"
        )
        .add_u64_counter(
            "frames_reordered", "frames reordered by fault injection"
        )
        .add_u64_counter(
            "resends_absorbed",
            "duplicate/straggler sub-write acks with no pending op",
        )
        .add_u64_counter(
            "dedup_hits",
            "resent client mutations replayed from the reqid cache",
        )
        .add_u64_counter(
            "drain.requeues",
            "sub-op replies a drainer put back (another thread held "
            "the callback lock), each followed by a 1 ms sleep",
        )
        .create_perf_counters()
    )


def make_op_queue_perf(name: str):
    """The per-daemon ``op_queue`` counter set (``perf dump`` section
    ``osd.<id>.op_queue``): work items taken off the mClock queue and
    their summed wait, from ``_schedule`` to the moment each starts on
    whichever thread runs it (a coalesced batch's items start
    together)."""
    from ceph_tpu_torch.utils import PerfCountersBuilder, perf_collection

    return (
        PerfCountersBuilder(perf_collection, name)
        .add_u64_counter(
            "op_queue.dequeued", "queued work items started"
        )
        .add_time(
            "op_queue.wait_s",
            "seconds the started items waited in the queue",
        )
        .create_perf_counters()
    )


def make_rmw_crash_perf(name: str):
    """The per-daemon ``rmw_crash`` counter set (``perf dump`` section
    ``osd.<id>.rmw_crash``): how replay converged state after a
    mid-commit crash — log entries rolled FORWARD onto returning
    members, divergent objects rolled BACK to the elected authority,
    and divergent creates removed."""
    from ceph_tpu_torch.utils import PerfCountersBuilder, perf_collection

    return (
        PerfCountersBuilder(perf_collection, name)
        .add_u64_counter(
            "rollforwards",
            "objects replayed forward from the pg log onto a "
            "returning member",
        )
        .add_u64_counter(
            "rollbacks",
            "divergent objects rebuilt from survivors on replay",
        )
        .add_u64_counter(
            "divergent_removes",
            "divergent creates removed on replay",
        )
        .create_perf_counters()
    )


def make_loc(pool_id: int, oid: str) -> str:
    """Pool-scoped store key: two pools writing the same client oid
    must not collide in an OSD's flat object namespace (the hobject's
    pool field, src/include/object.h)."""
    return f"{pool_id}:{oid}"


def split_loc(loc: str) -> tuple[int, str]:
    pool_id, _, oid = loc.partition(":")
    return int(pool_id), oid


#: separator between a head loc and its snapshot-clone suffix. Clones
#: are full objects living in the HEAD's PG (the hobject snap field
#: role, src/common/hobject.h — placement hashes the head name only).
SNAP_SEP = "\x1fsnap\x1f"


def clone_loc(loc: str, snapid: int) -> str:
    return f"{loc}{SNAP_SEP}{snapid}"


def head_of_loc(loc: str) -> str:
    """The head object's loc (identity for non-clones)."""
    return loc.split(SNAP_SEP, 1)[0]


def snap_of_loc(loc: str) -> int:
    """Clone's snapid, 0 for a head object."""
    parts = loc.split(SNAP_SEP, 1)
    return int(parts[1]) if len(parts) == 2 else 0




#: replicated reqid-dedup window attr (the pg-log reqid role,
#: osd_types.h osd_reqid_t + PGLog dedup): the last few mutating
#: reqids and their result sizes travel on every shard txn, so a NEW
#: primary after failover can replay a resent op's result instead of
#: re-applying it (appends would otherwise duplicate)
REQ_KEY = "rq"
REQ_WINDOW = 8


def pack_reqs(window: "list[tuple[str, int]]") -> bytes:
    return ";".join(f"{r},{s}" for r, s in window[-REQ_WINDOW:]).encode()


def parse_reqs(raw: bytes) -> "list[tuple[str, int]]":
    out = []
    for part in raw.decode().split(";"):
        if not part:
            continue
        r, _, s = part.rpartition(",")
        out.append((r, int(s)))
    return out


def shard_key(loc: str, shard: int) -> str:
    """On-disk object name for ONE logical shard (the ghobject_t
    shard_id field, src/common/hobject.h): an OSD can hold shard j of
    an object under the old layout AND shard i under the new one while
    backfill runs — distinct keys, so data movement never clobbers the
    still-serving copy."""
    return f"{loc}#s{shard}"


def split_shard_key(key: str) -> tuple[str, int]:
    loc, _, s = key.rpartition("#s")
    return loc, int(s)


def first_live(acting: "list[int]") -> int:
    """First non-hole member — THE primary-selection rule (matches
    OSDMap.pg_primary; one definition, used everywhere the daemon
    derives primacy from an acting list it already holds)."""
    return next((o for o in acting if o != SHARD_NONE), SHARD_NONE)


class _AnyShardStores(dict):
    """shard-id → store mapping that answers EVERY key with the
    daemon's one store: an OSD holds whichever logical shard the
    acting set assigns it, keyed on disk by oid alone."""

    def __init__(self, store) -> None:
        super().__init__()
        self._store = store

    def __missing__(self, key):
        return self._store


class _PGBackend:
    """ShardBackend surface bound to one PG's acting set: shard i
    routes to acting[i] — local store or peer sub-op (the per-PG
    ECBackend dispatch seam)."""

    def __init__(self, daemon: "OSDDaemon", acting: list[int]) -> None:
        self.daemon = daemon
        self.acting = list(acting)
        #: positions being caught up from the log: routable for
        #: recovery PUSHES but excluded from avail (reads/writes must
        #: not trust them until the replay completes)
        self.recovering: set[int] = set()

    def avail_shards(self) -> set[int]:
        net_up = self.daemon.peers.avail_shards() | {self.daemon.osd_id}
        out = set()
        for i, osd in enumerate(self.acting):
            if osd == SHARD_NONE or i in self.recovering:
                continue
            if osd in net_up:
                out.add(i)
            elif self.daemon.osdmap.is_up(osd):
                # LOCALLY down-marked but the map says up: a lossy-link
                # transient, not a death. Quarantine the position —
                # writes hole-journal around it NOW, and once the
                # recheck probe clears the mark the tick's catch-up
                # replays what it missed and re-admits it. Without
                # this, the mark clearing silently returned a member
                # whose store missed every write of the mark window to
                # the READ set: one stale chunk, torn decodes (the
                # kill x net_flaky composition found it).
                self.recovering.add(i)
        return out

    def read_shard_async(self, shard, oid, extents, cb) -> None:
        osd = self.acting[shard]
        key = shard_key(oid, shard)
        if osd == SHARD_NONE or (
            osd == self.daemon.osd_id
            and not self.daemon.store.exists(key)
        ):
            # a live shard-holder ALWAYS has the object (every write
            # touches it): absent means this store never got it —
            # error, never zero-fill (that would decode garbage)
            self.daemon.peers._inbox.put(
                lambda: cb(shard, ShardReadError(shard, oid, kind="missing"))
            )
        elif osd == self.daemon.osd_id:
            with tracer.span(
                "sub_read", osd=self.daemon.osd_id, shard=shard,
                local=True,
            ):
                self.daemon.local.read_shard_async(
                    self.daemon.osd_id, key, extents,
                    lambda _s, res: cb(shard, res),
                )
        else:
            self.daemon.peers.read_shard_async(
                osd, key, extents, lambda _s, res: cb(shard, res),
                logical=shard,
            )

    def read_shard(self, shard, oid, extents):
        osd = self.acting[shard]
        key = shard_key(oid, shard)
        if osd == self.daemon.osd_id:
            if not self.daemon.store.exists(key):
                raise ShardReadError(shard, oid, kind="missing")
            return self.daemon.local.read_shard(
                self.daemon.osd_id, key, extents
            )
        return self.daemon.peers.read_shard(
            osd, key, extents, logical=shard
        )

    def submit_shard_txn(self, shard, txn, ack) -> None:
        from dataclasses import replace as _dc_replace

        osd = self.acting[shard]
        if osd == SHARD_NONE:
            return  # parked: recovery's problem once the shard returns
        loc = txn.oids()[0] if txn.oids() else ""
        txn = Transaction(
            ops=[
                _dc_replace(op, oid=shard_key(op.oid, shard))
                for op in txn.ops
            ]
        )
        if osd == self.daemon.osd_id:
            # the primary's own shard goes through handle_sub_write
            # too: ECInject write type 3 aborts it like any receiver
            # (ECBackend.cc:922-926 fires on every OSD, primary
            # included), and the sub-op is traced like any receiver's
            # (a trace missing exactly the primary's shard would
            # misread as a skipped member). Remote shards consult and
            # trace in _dispatch instead.
            from ceph_tpu_torch.pipeline.inject import ec_inject

            if ec_inject.test_write_error3(loc):
                threading.Thread(
                    target=self.daemon.stop, daemon=True
                ).start()
                return
            with tracer.span(
                "sub_write", osd=self.daemon.osd_id, shard=shard,
                local=True,
            ):
                self.daemon.local.submit_shard_txn(
                    self.daemon.osd_id, txn, ack
                )
        else:
            self.daemon.peers.submit_shard_txn(osd, txn, ack)

    def drain_until(self, pred, timeout: float = 30.0) -> None:
        self.daemon.peers.drain_until(pred, timeout)


class _ScrubStore:
    """One shard's store as ``be_deep_scrub`` expects it, backed by
    the PG's (possibly remote) shard reads."""

    def __init__(self, pg: "_PG", shard: int) -> None:
        self.pg = pg
        self.shard = shard

    def read(self, oid: str, offset: int, length: int) -> bytes:
        try:
            bufs = self.pg.backend.read_shard(
                self.shard, oid, ExtentSet([(offset, offset + length)])
            )
        except Exception:
            raise FileNotFoundError(oid) from None
        return b"".join(bufs[o] for o in sorted(bufs))


class _ScrubBackendView:
    """Adapter giving ``be_deep_scrub`` its backend surface
    (avail_shards + stores[shard].read) over a cluster PG."""

    def __init__(self, pg: "_PG") -> None:
        self.pg = pg
        self.stores = {
            s: _ScrubStore(pg, s) for s in range(len(pg.acting))
        }

    def avail_shards(self) -> set[int]:
        return self.pg.backend.avail_shards()


class _PG:
    """Primary-side state for one placement group. Holds the full
    per-PG pipeline stack the reference's PG object holds: RMW, reads,
    the op log (PGLog — the recovery journal), and a RecoveryBackend
    for log-driven catch-up of returning members."""

    def __init__(self, daemon: "OSDDaemon", pool: str, pg: int,
                 raw: list[int], acting: list[int]) -> None:
        spec = daemon.osdmap.pools[pool]
        profile = dict(daemon.osdmap.profiles[spec.profile_name])
        self.pool = pool
        self.pgid = pg
        self.raw = list(raw)        # CRUSH membership (rebalance id)
        self.acting = list(acting)  # raw with down members as holes
        #: positions that were ALREADY holes when this instance was
        #: created: the op log cannot vouch for their gap — a member
        #: returning to one needs a full-shard refresh, not log replay
        self.born_holes: set[int] = {
            i for i, o in enumerate(acting) if o == SHARD_NONE
        }
        self.backfilling = False    # pg_temp installed, data moving
        self.backfill_dirty: set[str] = set()  # written mid-backfill
        self.backfill_done = False  # moved; drop on next map change
        #: positions with a _catch_up_shard thread in flight (guarded
        #: by daemon._pg_lock) — spawn sites dedup through this so a
        #: shard is never caught up by two racing threads
        self._catchup_inflight: set[int] = set()
        #: peering gate (the PG active state): client ops eagain until
        #: the serving primary has run the authoritative-log election
        #: for this interval. Non-primaries are trivially peered —
        #: they only serve sub-ops, which the (peered) primary drives.
        self.peered = threading.Event()
        if first_live(acting) != daemon.osd_id:
            self.peered.set()
        # explicit peering FSM (cluster/peering.py) — the only driver
        # of the peered gate since the legacy thread-and-flags path
        # folded out (round 16)
        self.fsm = PgPeeringFsm(daemon, self)
        self.codec = registry.factory(spec.plugin, profile, daemon.device)
        chunk = daemon.chunk_size
        self.sinfo = StripeInfo(spec.k, spec.m, spec.k * chunk)
        self.backend = _PGBackend(daemon, acting)
        self.pglog = PGLog(spec.k + spec.m)
        self.rmw = RMWPipeline(
            self.sinfo, self.codec, self.backend,
            perf_name=f"osd.{daemon.osd_id}.{pool}.{pg}.rmw",
            pglog=self.pglog,
        )
        # writes stamp (epoch, tid) eversions into OI attrs
        self.rmw.epoch = daemon.osdmap.epoch
        # RMW crash points (rmw.prepare_done / primary_before_commit)
        # fire with the owning daemon so osd= filters and kill resolve
        self.rmw.owner = daemon
        # ECInject write type 2: the primary marks ITSELF down via the
        # mon command when the final sub-write commit arrives
        # (ECBackend.cc:1158-1167). Async: osd_down propagates the map
        # to every daemon synchronously, which must not run under the
        # ack path's locks.
        self.rmw.on_osd_down_inject = lambda: threading.Thread(
            target=lambda: daemon.monitor.osd_down(daemon.osd_id),
            daemon=True,
        ).start()
        self.reads = ReadPipeline(
            self.sinfo, self.codec, self.backend,
            lambda oid: daemon._object_size(self, oid),
            perf_name=f"osd.{daemon.osd_id}.{pool}.{pg}.read",
        )
        self.recovery = RecoveryBackend(
            self.sinfo, self.codec, self.backend,
            lambda oid: daemon._object_size(self, oid),
            self.rmw.hinfo,
            perf_name=f"osd.{daemon.osd_id}.{pool}.{pg}.recovery",
            user_attrs_fn=lambda oid: daemon._recovery_attrs(self, oid),
            eversion_fn=lambda oid: daemon._authoritative_eversion(self, oid),
        )


class OSDDaemon:
    """One storage daemon: store + messenger + per-PG pipelines."""

    def __init__(
        self,
        osd_id: int,
        monitor,
        store=None,
        chunk_size: int = 4096,
        op_timeout: float = 15.0,
        tick_period: float = 2.0,
        scheduler_profiles=None,
        secret: bytes | None = None,
        device="cuda",
    ) -> None:
        from ceph_tpu_torch.utils.device import resolve_device
        from ceph_tpu_torch.utils.log import get_logger

        #: where every PG's codec, HashInfo and scrub hash run
        #: (``"cuda"`` unless the caller asks for the CPU; without a
        #: card that raises — there is no CPU fallback)
        self.device = resolve_device(device)
        self.osd_id = osd_id
        self.log = get_logger(f"osd.{osd_id}")
        self.monitor = monitor
        self.store = store if store is not None else MemStore(f"osd.{osd_id}")
        self.chunk_size = chunk_size
        self.op_timeout = op_timeout
        from ceph_tpu_torch.utils import config as _netcfg

        self.local = ShardBackend(_AnyShardStores(self.store))
        self.peers = NetShardBackend(
            {}, secret=secret, name=f"osd.{osd_id}",
            timeout=_netcfg.get("osd_peer_rpc_timeout"),
        )
        #: coalescing observability + the sub-write frame-packing hook
        self.coalesce_pc = _coalesce_perf(f"osd.{osd_id}.coalesce")
        #: peering observability (elections, rewinds, fence rejects,
        #: state dwell times) — shared by the FSM and legacy paths
        self.peering_pc = make_peering_perf(f"osd.{osd_id}.peering")
        #: net-fault observability: both of this daemon's messengers
        #: (serving + peer-client) report into the ONE osd.<id>.net
        #: set, so a link's faults land on the daemon that owns the
        #: faulted endpoint
        self.net_pc = make_net_perf(f"osd.{osd_id}.net")
        self.peers.messenger.net_pc = self.net_pc
        #: crash-replay observability (rollbacks/rollforwards)
        self.rmw_crash_pc = make_rmw_crash_perf(f"osd.{osd_id}.rmw_crash")
        self.peers.on_subwrite_batch = self._on_subwrite_batch
        # stamp my map interval into every sub-write (replica fence)
        self.peers.interval_fn = lambda: (
            self.osdmap.epoch, self.osd_id
        )
        #: (pool_id, pgid) -> newest interval epoch whose ELECTION has
        #: queried me (or that I activated): answering a peering query
        #: fences this member against sub-writes from older intervals
        #: of that PG — the same_interval_since discard rule
        #: (osd/PeeringState.h; OSD::require_same_or_newer_map)
        self._fence_epochs: dict[tuple[int, int], int] = {}
        self.osdmap: OSDMap = monitor.osdmap
        self.messenger = Messenger(f"osd.{osd_id}", secret=secret)
        self.messenger.net_pc = self.net_pc
        self.messenger.set_dispatcher(self._dispatch)
        self.addr: tuple[str, int] | None = None
        self._pgs: dict[tuple[str, int], _PG] = {}
        self._backfills: dict[tuple[str, int], threading.Thread] = {}
        self.tick_period = tick_period
        self._doomed_pool_ids: set[int] = set()
        self._gc_clean_streak = 2  # nothing doomed yet
        self._tick_stop: threading.Event | None = None
        self._tick_thread: threading.Thread | None = None
        #: mClock QoS arbitration between client IO and background
        #: work (the osd/scheduler/mClockScheduler seam): client ops
        #: run ON the worker in tag order; recovery/backfill admit
        #: through it (their IO still runs on their own threads)
        self.scheduler = MClockScheduler(scheduler_profiles)
        self._sched_cv = threading.Condition()
        #: id(queued item) -> perf_counter stamp of its ``_schedule``
        #: (the scheduler holds the item until it starts, so its id
        #: stays unique while stamped)
        self._queued_at: dict[int, float] = {}
        self.op_queue_pc = make_op_queue_perf(f"osd.{osd_id}.op_queue")
        #: QoS observability: the osd.N.qos aggregate set plus lazily
        #: created per-class osd.N.qos.pool.<label> sets. The scheduler
        #: keeps the lifetime counts; the tick syncs them into perf by
        #: delta so the exporter and perf dump see them.
        self.qos_pc = _qos.make_qos_perf(f"osd.{osd_id}.qos")
        self._qos_class_pcs: dict = {}
        self._qos_prev: dict[str, tuple] = {}
        self._qos_timeout_warned: set[str] = set()
        self._tick_warn_at = float("-inf")
        #: (stamp, cumulative client served_cost, cumulative total
        #: served_cost, total queue depth) at the last slosh
        #: re-derivation — the demand/capacity measurement window
        self._qos_demand_mark: "tuple[float, float, float, int] | None" = None
        #: measured service capacity (cost units/s): the max sustained
        #: rate observed over BACKLOGGED tick windows, decayed so
        #: transients fade — the osd bench auto-capacity analog.
        #: osd_mclock_capacity is clamped to it before profiles are
        #: derived, so notional capacities far above what the host can
        #: actually serve cannot oversubscribe the reservation phase.
        self._qos_cap_est: float | None = None
        #: explicit ctor profiles pin the table: the slosh knob only
        #: re-derives when the daemon runs on config-driven defaults
        self._qos_static_profiles = scheduler_profiles is not None
        #: class -> spec row last applied from pool metadata
        self._qos_specs_applied: dict[str, tuple] = {}
        _qos.register_scheduler(f"osd.{osd_id}", self.scheduler)
        self._worker: threading.Thread | None = None
        # op-serializing + structural locks, lockdep-tracked when the
        # `lockdep` config arms the detector (utils/lockdep.py; the
        # rank map documents the intended order: op -> pg -> stores)
        # -- sharded op execution (osd_op_num_shards analog): ops
        # route to a shard by (pool, pg) hash; each shard owns an
        # op-serializing lock and — at nshards > 1 — its own worker
        # thread and FIFO, so one EC write parked in a replicated
        # drain cannot wedge other PGs' queue heads (the round-19
        # flood-kill p99 head-of-line cliff). Shard 0's lock IS
        # self._op_lock: at the default nshards=1 the daemon runs
        # the classic single-worker path byte-for-byte (and tests
        # that grab d._op_lock directly keep meaning what they did).
        from ceph_tpu_torch.utils import config as _shcfg

        self._op_nshards = max(1, int(_shcfg.get("osd_op_num_shards")))
        self._op_shards = [
            DebugLock("osd.op", rank=20, op_serializing=True)
            for _ in range(self._op_nshards)
        ]
        self._op_lock = self._op_shards[0]
        #: per-shard FIFO + its wakeup (nshards > 1 only): the
        #: dispatcher (the classic worker thread) drains the mClock
        #: queue in tag order and appends here; shard workers run
        #: their own queue in dispatch order
        self._op_shard_queues = [deque() for _ in range(self._op_nshards)]
        self._op_shard_cvs = [
            threading.Condition() for _ in range(self._op_nshards)
        ]
        self._op_shard_workers: list[threading.Thread] = []
        self._op_rr = 0  # round-robin cursor for unroutable thunks
        #: leaf lock for the reqid-cache dicts' STRUCTURAL mutations
        #: (new-key inserts, trims, clears, key-union iteration).
        #: Under one worker these were _op_lock-serialized; shards
        #: mutate them concurrently. Per-loc read-modify-write stays
        #: safe without it (same loc -> same PG -> same shard lock);
        #: existing-key setitems are GIL-atomic and stay bare. Rank
        #: sits above op(20)/pg(30) and below the store tier (60+):
        #: _req_window seeds from store.getattr while holding it.
        self._reqcache_lock = DebugLock("osd.reqcache", rank=35)
        self._pg_lock = DebugLock("osd.pg", rank=30)
        self._pgmeta_lock = DebugLock("osd.pgmeta")  # serializes les updates
        #: mon config db entries this daemon has applied to the
        #: process config's "mon" layer (name -> value)
        self._mon_cfg_applied: dict[str, str] = {}
        # -- backfill reservations (backfill_reservation.rst): the
        # OSD's two AsyncReservers (common/AsyncReserver.h) bound
        # concurrent backfills to osd_max_backfills, as the driving
        # primary (local) and as a data-receiving target (remote)
        from ceph_tpu_torch.utils import config as _cfg
        from ceph_tpu_torch.utils.reserver import AsyncReserver

        self.local_reserver = AsyncReserver(
            lambda: _cfg.get("osd_max_backfills")
        )
        self.remote_reserver = AsyncReserver(
            lambda: _cfg.get("osd_max_backfills")
        )
        # Completed-mutation results by client reqid (pg-log reqid
        # dedup analog): a resend whose first attempt applied but whose
        # reply was lost replays the recorded outcome instead of
        # re-applying (remove would otherwise surface enoent for a
        # successful op). Bounded FIFO; guarded by _op_lock.
        self._completed_ops: "OrderedDict[str, OSDOpReply]" = OrderedDict()
        #: loc -> [(reqid, size)] rolling window mirroring the
        #: replicated REQ_KEY attr (seeded from storage on takeover)
        self._req_windows: dict[str, list] = {}
        #: loc -> reqids seeded from a stored attr and not yet proven
        #: durable. A dead primary may have stamped the attr on fewer
        #: than k shards — such an op was never acked and is not
        #: reconstructible, so replaying it as a success would lie to
        #: the client (round-4 advisor finding). Entries leave the set
        #: once a quorum poll proves >= k shards recorded them.
        self._req_unverified: dict[str, set] = {}
        #: loc -> monotonic time of its last durability fan-out
        self._req_poll_at: dict[str, float] = {}
        #: async durability fan-outs (_take_or_spawn_poll): results
        #: awaiting consumption, locs with a poller running, and the
        #: daemon-wide budget bounding concurrent poller threads
        self._req_poll_results: dict[str, tuple] = {}
        self._req_polls_inflight: set[str] = set()
        self._req_poll_lock = DebugLock("osd.req_poll")
        self._req_poll_sem = threading.Semaphore(self.REQ_POLL_BUDGET)
        #: queued reqid-cache invalidations from _kick_peering /
        #: pool deletion, applied under _op_lock by the next client
        #: op (_drain_req_flushes). _kick_peering cannot take
        #: _op_lock itself: it runs under _pg_lock, and the op path
        #: nests _op_lock -> _pg_lock (via _get_pg), so the reverse
        #: order would deadlock — the round-5 unlocked clear() raced
        #: in-flight ops instead, letting a mid-op window re-insert
        #: survive the rewind. Entries: ("pg", pool_id, pg_num, pgid)
        #: | ("pool", pool_id) | None (= flush everything). Guarded
        #: by _req_flush_lock, a leaf lock never held across another
        #: acquire.
        self._req_flush: set = set()
        self._req_flush_lock = DebugLock("osd.req_flush", rank=90)
        self._completed_cap = 1024
        self._stopped = False
        # -- background scrub scheduling (osd/scrubber/osd_scrub.cc):
        # per-PG stamps drive randomized shallow/deep due times; the
        # tick kicks due scrubs onto their own thread, capped at
        # osd_max_scrubs concurrent, each object admitting through the
        # mClock "scrub" class (client > recovery > scrub).
        self._scrub_stamps: dict[tuple[str, int], list[float]] = {}
        self._scrub_jitter: dict[tuple[str, int], float] = {}
        self._scrubs_running = 0
        #: PGs with a scrub in flight (stamps only move on completion,
        #: so without this a slow scrub would be re-scheduled — the
        #: per-PG reservation role)
        self._scrubs_inflight: set[tuple[str, int]] = set()
        self._scrub_lock = DebugLock("osd.scrub")
        #: (pool, pgid) -> (monotonic stamp, kind, n_errors, repaired)
        self.scrub_history: dict[tuple[str, int], tuple] = {}
        # -- PG-stats reporting (the MPGStats sender): the tick ships
        # one pg_stats record per led PG + an osd_stat to the monitor
        # every osd_stats_report_interval seconds (0 = off)
        self._last_stats_report = 0.0
        self._stats_seq = 0
        #: (map epoch, {(pool, pgid) I lead per CRUSH}) — the primary
        #: sweep is O(pools x pg_num x CRUSH), so it recomputes only
        #: when the epoch moves, never per report
        self._led_cache: tuple[int, set] = (-1, set())
        # -- watch/notify soft state (osd/Watch.cc role)
        self._watch_lock = DebugLock("osd.watch")
        #: (pool, loc) -> {cookie: Connection}
        self._watchers: dict[tuple[str, str], dict] = {}
        self._pending_notifies: dict[int, tuple] = {}
        self._next_notify_id = 1

    # -- lifecycle ------------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        self.addr = self.messenger.bind(host, port)
        self.monitor.osd_boot(self.osd_id, self.addr)
        self.monitor.subscribe(self._on_map)
        # QoS specs already in the boot map apply now; later changes
        # ride the map push (_on_map)
        self._apply_qos_specs(self.osdmap)
        if self.tick_period > 0:
            self._tick_stop = threading.Event()
            self._tick_thread = threading.Thread(
                target=self._tick_loop, daemon=True
            )
            self._tick_thread.start()
        self._worker = threading.Thread(target=self._worker_loop, daemon=True)
        self._worker.start()
        if self._op_nshards > 1:
            for i in range(self._op_nshards):
                t = threading.Thread(
                    target=self._shard_loop, args=(i,),
                    name=f"osd.{self.osd_id}-shard{i}", daemon=True,
                )
                t.start()
                self._op_shard_workers.append(t)
        return self.addr

    def _worker_loop(self) -> None:
        """The op-queue worker (the OSD shard thread role): pulls
        work in mClock tag order and runs it. With osd_op_num_shards
        > 1 this thread becomes the DISPATCHER: mClock tag order is
        still honored here (dequeue() withholds work until its tag
        time), but execution hands off to per-shard workers so one
        op parked in a replicated drain no longer blocks the queue
        head for every other PG."""
        import time as _time

        while not self._stopped:
            with self._sched_cv:
                got = self.scheduler.dequeue()
                if got is None:
                    nr = self.scheduler.next_ready()
                    wait = 0.2
                    if nr is not None:
                        wait = max(0.001, min(nr - _time.monotonic(), 0.2))
                    self._sched_cv.wait(wait)
                    continue
            _cls, fn = got
            if self._op_nshards > 1:
                self._dispatch_to_shard(fn)
                continue
            batch, leftover = self._collect_coalesce(fn)
            if batch is not None:
                self._run_thunk(
                    lambda: self._run_coalesced_batch(batch), batch
                )
            else:
                self._run_thunk(fn)
            if leftover is not None:
                self._run_thunk(leftover)

    # -- shard routing (nshards > 1) -----------------------------------
    def _op_shard_index(self, pool: str, pgid: int) -> int:
        """(pool, pg) -> shard. Stable across map epochs (the pg hash
        moves only on pg-split), so every path that serializes against
        a PG's client ops — scrub, catch-up push, backfill final pass,
        peering rewind — lands on the same lock the dispatcher routes
        that PG's ops to."""
        import zlib as _zlib

        return _zlib.crc32(f"{pool}.{pgid}".encode()) % self._op_nshards

    def _op_lock_for(self, pool: str, pgid: int):
        return self._op_shards[self._op_shard_index(pool, pgid)]

    def _dispatch_to_shard(self, fn) -> None:
        """Route one dequeued work item. Client ops hash by their
        object's PG (same object -> same shard -> dispatch order
        preserved); admit() grant thunks (ev.set) and other bare
        callables run INLINE — they are instant, and running them on
        the dispatcher keeps QoS grant timing exactly where the
        scheduler decided it."""
        if not isinstance(fn, _ClientOpItem):
            self._run_thunk(fn)
            return
        msg = fn.msg
        try:
            pgid = (
                int(msg.offset) if msg.op == "pgls"
                else self.osdmap.object_to_pg(msg.pool, msg.oid)
            )
            idx = self._op_shard_index(msg.pool, pgid)
        except Exception:
            idx = 0  # unroutable (pool gone mid-flight): any shard
        fn.shard = idx
        cv = self._op_shard_cvs[idx]
        with cv:
            self._op_shard_queues[idx].append(fn)
            cv.notify()

    def _shard_loop(self, idx: int) -> None:
        """One op shard's worker: drains its own FIFO in dispatch
        order. Coalescable write runs collect from THIS shard's queue
        only — batch-mates already share the shard lock the batch
        executes under."""
        q = self._op_shard_queues[idx]
        cv = self._op_shard_cvs[idx]
        while True:
            with cv:
                if not q:
                    if self._stopped:
                        return
                    cv.wait(0.2)
                    continue
                fn = q.popleft()
            batch = self._collect_shard_coalesce(idx, fn)
            if batch is not None:
                self._run_thunk(
                    lambda: self._run_coalesced_batch(batch, idx), batch
                )
            else:
                self._run_thunk(fn)

    def _collect_shard_coalesce(self, idx: int, fn):
        """Shard-local analog of _collect_coalesce: pull the RUN of
        coalescable writes at the head of this shard's queue. No
        leftover handling — a non-coalescable head item simply stays
        queued in position."""
        from ceph_tpu_torch.utils import config as _cfg

        if not (
            isinstance(fn, _ClientOpItem)
            and fn.coalescable()
            and _cfg.get("osd_op_coalescing")
        ):
            return None
        items = [fn]
        cap = _cfg.get("osd_coalesce_max")
        q, cv = self._op_shard_queues[idx], self._op_shard_cvs[idx]
        with cv:
            while (
                len(items) < cap
                and q
                and isinstance(q[0], _ClientOpItem)
                and q[0].coalescable()
            ):
                items.append(q.popleft())
        if len(items) == 1:
            return None
        return items

    def _run_thunk(self, fn, items=None) -> None:
        """Run one work item (or a coalesced batch, whose queued
        ``items`` start together) on this thread."""
        self._note_started((fn,) if items is None else items)
        try:
            fn()
        except Exception as e:
            # Op errors reply themselves deeper down; anything
            # surfacing here is an unexpected pipeline fault —
            # keep the worker alive but dump the gather ring so
            # the verbose context survives (Log::dump_recent).
            self.log.error(
                "unexpected worker exception:", type(e).__name__, e
            )
            from ceph_tpu_torch.utils.log import root_log

            root_log.dump_recent("osd worker exception")

    def _collect_coalesce(self, fn):
        """When the dequeued work is a coalescable client write and
        op coalescing is on, drain the RUN of coalescable writes
        queued behind it (the per-OSD-tick window: whatever an async
        client put on the wire together executes together). Returns
        (batch, leftover): batch None means run ``fn`` the classic
        way; leftover is the first non-coalescable item pulled while
        collecting, run after the batch in its dequeue position."""
        from ceph_tpu_torch.utils import config as _cfg

        if not (
            isinstance(fn, _ClientOpItem)
            and fn.coalescable()
            and _cfg.get("osd_op_coalescing")
        ):
            return None, None
        items = [fn]
        cap = _cfg.get("osd_coalesce_max")
        leftover = None
        while len(items) < cap:
            with self._sched_cv:
                got = self.scheduler.dequeue()
            if got is None:
                break
            _c, nfn = got
            if isinstance(nfn, _ClientOpItem) and nfn.coalescable():
                items.append(nfn)
            else:
                leftover = nfn  # queue order: runs after the batch
                break
        if len(items) == 1:
            return None, leftover
        return items, leftover

    def _on_subwrite_batch(self, n: int) -> None:
        self.coalesce_pc.inc("subwrite_batches")
        self.coalesce_pc.inc("subwrite_batched_ops", n)

    def _schedule(self, class_name: str, fn, cost: float = 1.0) -> None:
        with self._sched_cv:
            self._queued_at[id(fn)] = time.perf_counter()
            self.scheduler.enqueue(class_name, fn, cost)
            self._sched_cv.notify()

    def _note_started(self, items) -> None:
        now = time.perf_counter()
        waited, started = 0.0, 0
        for item in items:
            t = self._queued_at.pop(id(item), None)
            if t is not None:
                waited += now - t
                started += 1
        if started:
            self.op_queue_pc.add_many((
                ("op_queue.dequeued", started), ("op_queue.wait_s", waited),
            ))

    def admit(self, class_name: str, cost: float = 1.0) -> None:
        """QoS admission gate for background work: blocks until the
        scheduler grants a slot. Times out permissively (work proceeds
        unthrottled rather than deadlocking when the worker is stuck
        behind a lock the caller holds). A STOPPED daemon grants
        immediately — its worker is gone, and a lingering background
        sweep (scheduled scrub over a corpse) must not crawl at one
        object per timeout."""
        if self._stopped:
            return
        ev = threading.Event()
        self._schedule(class_name, ev.set, cost)
        deadline = time.monotonic() + self.op_timeout
        while not ev.wait(timeout=0.5):
            if self._stopped:
                return
            if time.monotonic() >= deadline:
                self._note_admit_timeout(class_name)
                return

    def _note_admit_timeout(self, class_name: str) -> None:
        """An admit() wait expired and the caller proceeds
        unthrottled. That fallback is deliberate (it beats a deadlock
        when the worker is parked behind a lock the caller holds) but
        it must not be silent: QoS guarantees quietly stop holding.
        Count it per class and WRN the cluster log once per class per
        daemon, with the locks this thread holds — the usual culprit."""
        self.qos_pc.inc("admit_timeout")
        self._qos_class_pc(class_name).inc("admit_timeout")
        if class_name in self._qos_timeout_warned:
            return
        self._qos_timeout_warned.add(class_name)
        from ceph_tpu_torch.utils import lockdep
        from ceph_tpu_torch.utils.cluster_log import cluster_log

        held = [h.lock.name for h in lockdep._held()]
        cluster_log.log(
            f"osd.{self.osd_id}", "qos_admit_timeout",
            f"mclock admit for class {class_name!r} timed out after "
            f"{self.op_timeout:.1f}s; work proceeds unthrottled "
            f"(held locks: {held or 'none'})",
            severity="WRN", epoch=self.osdmap.epoch,
            qos_class=class_name,
        )

    def _tick_loop(self) -> None:
        while not self._tick_stop.wait(self.tick_period):
            try:
                self.tick()
            except Exception as e:
                # a failed tick must not kill the retry loop — but a
                # PERSISTENTLY failing tick silently stalls scrub
                # scheduling, pool GC, re-heal and stats reporting, so
                # it surfaces as a rate-limited cluster-log WRN
                self._note_tick_error(e)

    def _note_tick_error(self, e: BaseException) -> None:
        import traceback

        now = time.monotonic()
        if now - self._tick_warn_at < 30.0:
            return
        self._tick_warn_at = now
        tb = traceback.extract_tb(e.__traceback__)
        where = "?"
        if tb:
            f = tb[-1]
            where = f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} in {f.name}"
        from ceph_tpu_torch.utils.cluster_log import cluster_log

        cluster_log.log(
            f"osd.{self.osd_id}", "tick_error",
            f"tick failed: {type(e).__name__}: {e} (at {where})",
            severity="WRN", epoch=self.osdmap.epoch,
        )

    # -- QoS plane upkeep ----------------------------------------------
    def _qos_class_pc(self, class_name: str):
        """Lazily build one class's osd.N.qos.pool.<label> perf set
        (the exporter renders the label as a Prometheus dimension)."""
        pc = self._qos_class_pcs.get(class_name)
        if pc is None:
            pc = _qos.make_qos_class_perf(
                f"osd.{self.osd_id}.qos", class_name
            )
            self._qos_class_pcs[class_name] = pc
        return pc

    def _apply_qos_specs(self, osdmap: OSDMap) -> None:
        """Install per-pool / per-tenant QoS specs carried in pool
        metadata into the live scheduler (the map push applying an
        ``osd pool qos set`` without a daemon restart). A tenant row
        lands on ``client.<tenant>``; a pool-wide row (tenant "") on
        ``client.<pool>``. Rows that left the map drop back to prefix
        inheritance from the base ``client`` profile."""
        want: dict[str, tuple] = {}
        for pool, spec in osdmap.pools.items():
            for row in getattr(spec, "qos", ()):
                want[_qos.client_class(row[0], pool)] = tuple(row[1:])
        if want == self._qos_specs_applied:
            return
        with self._sched_cv:
            table = dict(self.scheduler.profiles)
            for cls in set(self._qos_specs_applied) - set(want):
                table.pop(cls, None)
            for cls, row in want.items():
                table[cls] = _qos.QoSSpec(*row).to_profile()
            self.scheduler.set_profiles(table)
        self._qos_specs_applied = want

    def _qos_tick(self) -> None:
        """Per-tick QoS upkeep: sync the scheduler's per-class service
        counts into the osd.N.qos perf sets (delta-based — the
        scheduler counts, perf exposes) and turn the slosh knob:
        re-derive the base profile table from osd_mclock_profile /
        osd_mclock_capacity with client demand measured over the tick
        window, so reservation capacity idle clients aren't using
        flows to recovery and backfill."""
        from ceph_tpu_torch.utils import config as _cfg

        with self._sched_cv:
            snap = self.scheduler.dump()
        total_depth, worst_lag = 0, 0.0
        client_cost = total_cost = 0.0
        for cls, st in snap.items():
            total_depth += st["depth"]
            worst_lag = max(worst_lag, st["tag_lag_s"])
            total_cost += st["served_cost"]
            if cls == "client" or cls.startswith("client."):
                client_cost += st["served_cost"]
            prev = self._qos_prev.get(cls, (0, 0, 0))
            d_r = st["dequeued_r"] - prev[0]
            d_p = st["dequeued_p"] - prev[1]
            d_t = st["throttled"] - prev[2]
            self._qos_prev[cls] = (
                st["dequeued_r"], st["dequeued_p"], st["throttled"]
            )
            if d_r:
                self.qos_pc.inc("dequeue_r", d_r)
            if d_p:
                self.qos_pc.inc("dequeue_p", d_p)
            if d_t:
                self.qos_pc.inc("throttle", d_t)
            cpc = self._qos_class_pc(cls)
            if d_r or d_p:
                cpc.inc("dequeue", d_r + d_p)
            if d_t:
                cpc.inc("throttle", d_t)
            cpc.set("queue_depth", st["depth"])
        self.qos_pc.set("queue_depth", total_depth)
        self.qos_pc.set("tag_lag_ms", int(worst_lag * 1000))
        self.qos_pc.set("qos_classes", len(snap))
        if self._qos_static_profiles:
            return  # explicit ctor profiles: the caller owns the table
        now = time.monotonic()
        mark = self._qos_demand_mark
        self._qos_demand_mark = (now, client_cost, total_cost,
                                 total_depth)
        demand = 0.0
        if mark is not None and now > mark[0]:
            dt = now - mark[0]
            demand = max(client_cost - mark[1], 0.0) / dt
            # capacity estimate: only windows that STARTED backlogged
            # measure the server (an idle window's low rate is demand,
            # not capacity); decay so a one-off fast window fades
            if mark[3] > 0:
                rate = max(total_cost - mark[2], 0.0) / dt
                est = self._qos_cap_est
                self._qos_cap_est = (
                    rate if est is None else max(rate, 0.9 * est)
                )
        capacity = _cfg.get("osd_mclock_capacity")
        # The measured estimate bounds ONLY the reservation clock (the
        # admission guard below): oversubscribed floors starve the
        # weight phase. Limits keep the configured capacity — a
        # cratered estimate throttling the limit-fraction classes
        # would depress the measured rate and lock itself low, since
        # a weak floor slows nothing but a tight ceiling does.
        admit_cap = capacity
        if self._qos_cap_est is not None:
            admit_cap = min(capacity, max(self._qos_cap_est, 1.0))
        self.qos_pc.set("capacity", int(admit_cap))
        try:
            table = _qos.derive_profiles(
                _cfg.get("osd_mclock_profile"),
                capacity,
                client_demand=demand,
            )
        except ValueError:
            return  # a bad profile name must not kill the tick
        # spec rows pushed from pool metadata ride on top of the
        # derived base table (from the pristine rows, NOT the live
        # profiles — those may already be normalization-scaled), then
        # the sum(reservations) <= frac * admit_cap admission guard
        # rescales the reservation clocks against what the host is
        # measured to actually serve
        for cls, row in self._qos_specs_applied.items():
            table[cls] = _qos.QoSSpec(*row).to_profile()
        table = _qos.normalize_reservations(table, admit_cap)
        with self._sched_cv:
            self.scheduler.set_profiles(table)

    def stop(self) -> None:
        self._stopped = True
        with self._sched_cv:
            self._sched_cv.notify_all()
        for cv in self._op_shard_cvs:
            with cv:
                cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=2.0)
        for t in self._op_shard_workers:
            t.join(timeout=2.0)
        # backfill threads write to the store: they must land before a
        # caller closes it
        for t in list(self._backfills.values()):
            if t.is_alive():
                t.join(timeout=5.0)
        if self._tick_stop is not None:
            self._tick_stop.set()
            self._tick_thread.join(timeout=2.0)
        self.peers.shutdown()
        self.messenger.shutdown()
        # live ops this daemon owned died with it: finish them so the
        # tracker (and the slow-op watchdog) never carries corpses
        from ceph_tpu_torch.utils.optracker import op_tracker

        op_tracker.finish_all(
            f"osd.{self.osd_id}", event="daemon_stopped"
        )

    # -- map handling ---------------------------------------------------
    def _apply_mon_config(self, osdmap: OSDMap) -> None:
        """Overlay my slice of the mon-replicated config db into the
        process config's "mon" layer (the MConfig push a daemon gets
        on subscription; mon/ConfigMonitor.h:15). Scopes apply in
        ascending specificity: global < "osd" < "osd.<id>". Observers
        registered on the process config fire on any change. NOTE:
        the process config is global, so in a many-daemons-per-
        process test the last daemon to apply an id-scoped value
        wins — class/global scopes are the meaningful ones there."""
        from ceph_tpu_torch.utils import config

        eff: dict[str, str] = {}
        for scope in ("", "osd", f"osd.{self.osd_id}"):
            for (who, name), val in osdmap.config.items():
                if who == scope:
                    eff[name] = val
        applied: dict[str, str] = {}
        for name, val in eff.items():
            if self._mon_cfg_applied.get(name) == val:
                applied[name] = val
                continue
            try:
                config.set(name, val, layer="mon")
                applied[name] = val
            except Exception as e:
                # NOT recorded at the new value: the next map carrying
                # it retries instead of silently diverging. A
                # previously applied value stays recorded, so a later
                # monitor-side rm still clears the stale layer entry.
                if name in self._mon_cfg_applied:
                    applied[name] = self._mon_cfg_applied[name]
                self.log.error(
                    "mon config", name, "rejected:",
                    type(e).__name__, str(e),
                )
        for name in set(self._mon_cfg_applied) - set(eff):
            try:
                config.rm(name, layer="mon")
            except Exception:
                pass
        self._mon_cfg_applied = applied

    def _on_map(self, osdmap: OSDMap) -> None:
        if self._stopped:
            return
        to_recover: list[tuple[_PG, list[int]]] = []
        to_release: list[tuple[_PG, list[int]]] = []
        with self._pg_lock:
            if osdmap.epoch < self.osdmap.epoch:
                return  # late delivery from a racing notifier thread
            # config applies AFTER the stale-epoch guard (a late old
            # map must not revert newer values) and under _pg_lock so
            # concurrent deliveries can't interleave apply/rm
            self._apply_mon_config(osdmap)
            self._apply_qos_specs(osdmap)
            # pool identity is the ID (names are reusable, ids never
            # are) — and deletions accumulate so a skipped epoch or a
            # straggler write can't leak keys forever
            live_ids = {s.pool_id for s in osdmap.pools.values()}
            dead_ids = set()
            for spec in self.osdmap.pools.values():
                if spec.pool_id not in live_ids:
                    self._doomed_pool_ids.add(spec.pool_id)
                    self._gc_clean_streak = 0
                    dead_ids.add(spec.pool_id)
            if dead_ids:
                # a deleted pool's soft state is garbage its id will
                # never reclaim: prune the interval fences and queue a
                # reqid-cache flush for its objects, or a long-lived
                # daemon grows per-(pool, pg) / per-object entries
                # without bound across create/delete churn. Prune by
                # the DOOMED set, not by absence from live_ids: a
                # fence can legitimately precede this member's
                # knowledge of its pool (peering messages from a
                # newer map), and must survive until that pool is
                # provably deleted.
                doomed_now = dead_ids | self._doomed_pool_ids
                for key in [
                    k for k in self._fence_epochs if k[0] in doomed_now
                ]:
                    del self._fence_epochs[key]
                with self._req_flush_lock:
                    for pid in dead_ids:
                        self._req_flush.add(("pool", pid))
            self.osdmap = osdmap
            for osd, info in osdmap.osds.items():
                if osd == self.osd_id:
                    continue
                if info.up and info.addr:
                    if self.peers.addrs.get(osd) != info.addr:
                        self.peers.set_addr(osd, info.addr)
                    else:
                        # the map says it's up: a locally observed
                        # transient failure must not exclude it forever
                        self.peers.down_shards.discard(osd)
                else:
                    self.peers.down_shards.add(osd)
            maybe_backfill: list[tuple[str, int, "_PG"]] = []
            for key, pg in list(self._pgs.items()):
                pool, pgid = key
                spec = osdmap.pools.get(pool)
                if spec is None:
                    del self._pgs[key]
                    continue
                # new epoch reaches surviving PGs' eversion stamps
                pg.rmw.epoch = osdmap.epoch
                if osdmap.pg_to_raw(pool, pgid) != pg.raw:
                    if pg.backfill_done:
                        # this PG's data already moved to the CRUSH
                        # layout; retire the old-layout instance
                        del self._pgs[key]
                        continue
                    # membership changed: data must MOVE. If I'm the
                    # serving primary, install pg_temp (keep serving
                    # from the old layout) and backfill to the CRUSH
                    # target; otherwise drop — reads fail cleanly via
                    # the misplaced-shard guard until someone
                    # backfills. The pg_temp request commits a map
                    # change (recursive _on_map), so it runs after
                    # this lock is released.
                    primary = first_live(pg.acting)
                    if (
                        primary == self.osd_id
                        and (pool, pgid) not in osdmap.pg_temp
                    ):
                        maybe_backfill.append((pool, pgid, pg))
                        continue
                    if (pool, pgid) in osdmap.pg_temp:
                        continue  # serving via pg_temp; backfilling
                    del self._pgs[key]
                    continue
                new_acting = osdmap.pg_to_up_acting(pool, pgid)
                if new_acting == pg.acting:
                    continue
                # same members, liveness flipped: heal in place. A
                # member that RETURNED is behind — it joins in
                # ``recovering`` state (pushes route to it, but reads
                # and writes don't trust it) until the log replay
                # completes; only then does it become available.
                healed = [
                    i for i, osd in enumerate(new_acting)
                    if osd != SHARD_NONE and pg.acting[i] == SHARD_NONE
                ]
                downed = [
                    i for i, osd in enumerate(new_acting)
                    if osd == SHARD_NONE and pg.acting[i] != SHARD_NONE
                ]
                pg.acting[:] = new_acting
                pg.backend.acting[:] = new_acting
                pg.backend.recovering.update(healed)
                pg.backend.recovering.difference_update(downed)
                # interval change: whoever serves as primary now must
                # re-run the authoritative-log election before serving
                # this interval (and re-activate les). Non-primaries
                # open their gate — the primary's peering judges them.
                if first_live(new_acting) == self.osd_id:
                    self._kick_peering(pg)
                else:
                    pg.fsm.post_interval()  # -> replica, gate open
                if downed:
                    to_release.append((pg, downed))
                if healed:
                    to_recover.append((pg, healed))
        # drive recovery OUTSIDE the pg lock on worker threads: a
        # born-hole refresh is O(objects in PG) of network IO, and this
        # callback runs on the monitor's notify path
        # a member that died with sub-write acks outstanding must not
        # wedge in-flight ops behind the op timeout: release its acks
        # (extents stay dirty in the pg log). OUTSIDE _pg_lock — the
        # release may dispatch the next queued op, whose RMW backend
        # read blocks on the messenger.
        for pg, downed in to_release:
            for i in downed:
                pg.rmw.on_shard_down(i)
        for pg, healed in to_recover:
            if first_live(pg.acting) != self.osd_id:
                # only the SERVING PRIMARY drives catch-up (the
                # reference's recovery model). A demoted instance
                # replaying ITS pglog onto a member of a PG someone
                # else now leads raced the new primary's live writes
                # — rebuild-at-T, push-at-T+δ lost updates clobbered
                # freshly committed extents on one shard (the
                # torn-RMW leg of ROADMAP #1, found by the
                # primary-victim smoke). The new primary's election
                # judges every member by its gathered infos and
                # drains EVERY stale recovering mark itself (see
                # _peer_pass), so marks left here are not leaked.
                continue
            for shard in healed:
                if pg.acting[shard] == self.osd_id:
                    # my OWN position healed: the FSM's election pass
                    # (already kicked above) judges and repairs my
                    # store and re-admits the position at Active —
                    # a replica catch-up against oneself would be an
                    # RPC to nobody that fails and holes the primary
                    # position (THE round-8 peering flake / ROADMAP
                    # #1 ENOENT)
                    continue
                self._spawn_catch_up(pg, shard)
        for pool, pgid, pg in maybe_backfill:
            if self._request_pg_temp(pool, pgid, pg):
                self._start_backfill(pool, pgid, pg)
            else:
                with self._pg_lock:
                    self._pgs.pop((pool, pgid), None)
        self._maybe_gc_pools()
        # temp-head adoption: whoever serves as primary under a
        # pg_temp mapping drives its backfill (covers temps installed
        # by OTHER daemons and primaries without a PG instance)
        self._adopt_pg_temps()
        # eager interval peering for PGs with no live instance
        self._peer_new_intervals()

    def _maybe_gc_pools(self) -> None:
        if self._doomed_pool_ids and self._gc_clean_streak < 2:
            threading.Thread(target=self._gc_pools, daemon=True).start()

    def _gc_pools(self) -> None:
        """A deleted pool's shard data is garbage (its id is never
        reused): drop every key it owned (the reference's async pool
        deletion sweep). Re-runs on later map changes/ticks until TWO
        consecutive sweeps find nothing — stragglers from ops in
        flight at deletion time get caught by the second pass."""
        doomed = set(self._doomed_pool_ids)
        batch: list[str] = []
        removed = 0

        def flush() -> None:
            nonlocal removed
            if not batch:
                return
            self.admit("gc")
            txn = Transaction()
            for key in batch:
                txn.touch(key).remove(key)
            try:
                self.store.queue_transactions(txn)
                removed += len(batch)
            except Exception:
                pass  # retried by the next sweep
            batch.clear()

        for key in self.store.list_objects():
            if key.startswith("pgmeta\x02"):
                try:
                    meta_pool = int(key.split("\x02")[1])
                except (IndexError, ValueError):
                    continue
                if meta_pool in doomed:
                    batch.append(key)
                    if len(batch) >= 64:
                        flush()
                continue
            try:
                loc, _si = split_shard_key(key)
                pool_id, _oid = split_loc(loc)
            except ValueError:
                continue
            if pool_id in doomed:
                batch.append(key)
                if len(batch) >= 64:
                    flush()
        flush()
        self._gc_clean_streak = 0 if removed else (
            self._gc_clean_streak + 1
        )

    def _adopt_pg_temps(self) -> None:
        osdmap = self.osdmap
        for (pool, pgid) in list(osdmap.pg_temp):
            if pool not in osdmap.pools:
                continue
            acting = osdmap.pg_to_up_acting(pool, pgid)
            if first_live(acting) != self.osd_id:
                continue
            pg = self._get_pg(pool, pgid)
            self._start_backfill(pool, pgid, pg)

    def _spawn_catch_up(self, pg: _PG, shard: int) -> None:
        """Start a catch-up thread for one position, at most one in
        flight per (pg, shard) — every spawn site (map healed
        transition, tick re-heal, the FSM's behind-member and
        stale-recovering drains) routes through here."""
        with self._pg_lock:
            if shard in pg._catchup_inflight:
                return
            pg._catchup_inflight.add(shard)

        def run() -> None:
            try:
                self._catch_up_shard(pg, shard)
            finally:
                with self._pg_lock:
                    pg._catchup_inflight.discard(shard)

        threading.Thread(target=run, daemon=True).start()

    def _catch_up_shard(self, pg: _PG, shard: int) -> None:
        """Replay the op log onto a returned member until it is clean
        (writes racing the replay append new dirty entries — loop),
        then admit it to the acting set. A member whose absence
        PREDATES this PG instance gets a full-shard refresh first —
        the log holds no record of what it missed, so every object's
        shard is rebuilt from the survivors (the authoritative-log
        peering decision collapsed to 'refresh when the log cannot
        vouch'). On failure the position reverts to a hole; the next
        map change retries."""
        try:
            # the interval election first: catch-up judges the
            # returning member against authoritative state, which is
            # only established once the primary has peered
            if not pg.peered.wait(timeout=60):
                raise RuntimeError("peering never completed")
            if pg.acting[shard] == self.osd_id:
                # my own position is the election's to admit, never a
                # peer transfer (see _admit_self_positions); a stray
                # spawn must not RPC to itself and hole the position
                pg.fsm.post("retry")
                return
            crash_points.fire(
                "catchup.pre_listing", daemon=self, pg=pg, shard=shard
            )
            # every rebuild-and-push below holds _op_lock,
            # serializing with the live write path — a push computed
            # from survivors read at T must not land at T+δ over an
            # extent a client write committed in between (the
            # lost-update shard tear the primary-victim soak caught)
            push_lock = self._op_lock_for(pg.pool, pg.pgid)
            # Pristine member stamps, captured before any replay or
            # refresh can overwrite them (see _member_listing).
            member_listing = self._member_listing(pg, shard)
            refreshed: set[str] = set()
            if shard in pg.born_holes:
                spec = self.osdmap.pools[pg.pool]
                target_osd = pg.acting[shard]
                # the returning member's own (stale) reports must not
                # vouch for objects: only OTHER survivors count
                hints = self._backfill_scan(
                    pg.pool, pg.pgid, spec, pg, exclude=target_osd
                )
                for loc in sorted(hints):
                    # byte-proportional: a 4 MB refresh consumes ~65x
                    # the recovery budget of a 4 KB one
                    self.admit(
                        "recovery", cost=_qos.op_cost(max(hints[loc], 0))
                    )
                    size = self._object_size(pg, loc)
                    known = bool(size) or self._have_object(pg, loc)
                    size_hint = None
                    if not known and hints[loc] > 0:
                        # a PEER holds it even though my store doesn't
                        # (my own copy is incomplete): recover, never
                        # delete a surviving good shard. The hint goes
                        # to recovery directly — priming the live
                        # pipeline with it could resurrect a size for
                        # an object a racing remove just dropped.
                        size_hint = hints[loc]
                        known = True
                    if not known:
                        # gone while the member was away: propagate
                        # the delete (its stale copy fed the scan)
                        with push_lock:
                            self._push_delete(target_osd, loc, shard)
                        continue
                    with push_lock:
                        pg.recovery.recover_object(
                            loc, {shard}, size=size_hint
                        )
                    refreshed.add(loc)
                pg.born_holes.discard(shard)
            def _dirty() -> bool:
                return bool(
                    pg.pglog.dirty_extents(shard)
                    or pg.pglog.dirty_deletes(shard)
                    or pg.pglog.dirty_xattrs(shard)
                )

            for _ in range(8):
                self.admit("recovery")
                with push_lock:
                    replayed = pg.recovery.recover_from_log(
                        pg.pglog, shard
                    )
                if replayed:
                    self.rmw_crash_pc.inc(
                        "rollforwards", len(replayed)
                    )
                if not _dirty():
                    break
            # Eversion divergence pass: log replay brings the member
            # up to the authoritative history it MISSED; this catches
            # what it should never have had — writes it applied that
            # the cluster did not commit (divergent ex-primary). Any
            # object whose stored stamp disagrees with authoritative
            # history is rebuilt from survivors; objects unknown to
            # authoritative state are removed.
            target_osd = pg.acting[shard]
            rollback, divergent_deletes = self._divergent_objects(
                pg, shard, member_listing
            )
            # the born-hole refresh already rebuilt these (their
            # pre-refresh stamps are stale by construction)
            rollback -= refreshed
            for loc in sorted(rollback):
                self.admit(
                    "recovery",
                    cost=_qos.op_cost(self._object_size(pg, loc)),
                )
                self.log.info(
                    "pg", f"{pg.pool}/{pg.pgid}:", "divergent object",
                    loc, "on shard", shard, "- rolling back"
                )
                with push_lock:
                    pg.recovery.recover_object(loc, {shard})
                self.rmw_crash_pc.inc("rollbacks")
            for loc in sorted(divergent_deletes):
                self.log.info(
                    "pg", f"{pg.pool}/{pg.pgid}:", "divergent create",
                    loc, "on shard", shard, "- removing"
                )
                with push_lock:
                    self._push_delete(target_osd, loc, shard)
                self.rmw_crash_pc.inc("divergent_removes")
            # Admission is an EVENT on the PG's peering queue — it
            # cannot interleave an election, so a mid-judgment member
            # can never vote. The final clean check runs under the op
            # lock on the drainer: client writes (which also take
            # _op_lock) cannot append dirty entries between the check
            # and the admit, so a still-behind shard can never enter
            # the read set and serve stale bytes into EC decode.
            crash_points.fire(
                "catchup.pre_admit", daemon=self, pg=pg, shard=shard
            )
            if not pg.fsm.admit_caught_up(shard):
                raise RuntimeError(
                    f"shard {shard} admission rejected "
                    "(interval moved or still dirty)"
                )
            self.log.info(
                "pg", f"{pg.pool}/{pg.pgid}:", "shard", shard,
                "caught up, admitted"
            )
        except Exception as e:
            self.log.error(
                "pg", f"{pg.pool}/{pg.pgid}:", "shard", shard,
                "catch-up failed", f"({type(e).__name__}: {e});",
                "reverting to hole"
            )
            with self._pg_lock:
                pg.acting[shard] = SHARD_NONE
                pg.backend.acting[shard] = SHARD_NONE
                pg.backend.recovering.discard(shard)

    def _get_pg(self, pool: str, pgid: int) -> _PG:
        with self._pg_lock:
            pg = self._pgs.get((pool, pgid))
            if pg is None:
                raw = self.osdmap.pg_to_raw(pool, pgid)
                acting = self.osdmap.pg_to_up_acting(pool, pgid)
                pg = _PG(self, pool, pgid, raw, acting)
                self._pgs[(pool, pgid)] = pg
                if not pg.peered.is_set():
                    # fresh instance with me as serving primary: the
                    # interval must be peered before ops are served —
                    # a restarted ex-primary's own store is not
                    # authority (PeeringState.cc:1565 find_best_info)
                    self._kick_peering(pg)
            return pg

    # -- object-info recovery (new-primary takeover) --------------------
    def _scan_pg_keys(
        self, pool_id: int, pg_num: int, pgid: int
    ) -> list[tuple[str, int]]:
        """Own-store scan: (loc, shard_index) pairs of this PG's keys
        (shared by the PGList service, backfill scan, and GC)."""
        from ceph_tpu_torch.placement import stable_hash

        out = []
        for key in self.store.list_objects():
            try:
                loc, si = split_shard_key(key)
                pool_id2, oid = split_loc(loc)
            except ValueError:
                continue
            if (
                pool_id2 == pool_id
                and stable_hash(str(pool_id), head_of_loc(oid))
                % pg_num == pgid
            ):
                # clones hash by their HEAD name: they live (and
                # backfill, recover, scrub) in the head's PG
                out.append((loc, si))
        return out

    def _sub_write_interval_ok(self, msg, loc: str) -> bool:
        """Replica-side interval fence for sub-writes: once a NEWER
        interval's election has queried (or activated) this member for
        the object's PG, sub-writes stamped with an older map epoch
        are rejected — they come from a superseded primary whose
        commit would be invisible to the authority the election chose
        (same_interval_since discard; OSD::require_same_or_newer_map).
        Unfenced messages (standalone pipeline tiers) pass."""
        if msg.from_osd < 0 or not msg.epoch:
            return True
        try:
            from ceph_tpu_torch.placement import stable_hash

            pool_id, oid = split_loc(loc)
            for spec in self.osdmap.pools.values():
                if spec.pool_id == pool_id:
                    pgid = stable_hash(
                        str(pool_id), head_of_loc(oid)
                    ) % spec.pg_num
                    fence = self._fence_epochs.get((pool_id, pgid), 0)
                    if msg.epoch < fence:
                        self.peering_pc.inc("interval_fences_rejected")
                        self.log.info(
                            "fence: sub-write from osd.", msg.from_osd,
                            f"e{msg.epoch} rejected:", loc,
                            f"interval e{fence} already peered here",
                        )
                        return False
                    return True
        except Exception:
            pass  # unparseable loc etc.: do not wedge the data path
        return True

    def _my_key(self, pg: _PG, oid: str) -> str | None:
        """My shard key for this object, from my acting position."""
        try:
            pos = pg.acting.index(self.osd_id)
        except ValueError:
            return None
        return shard_key(oid, pos)

    def _have_object(self, pg: _PG, oid: str) -> bool:
        key = self._my_key(pg, oid)
        return key is not None and self.store.exists(key)

    def _replicated_attrs(
        self, pg: _PG, oid: str, prefixes: tuple = ("u:", "m:")
    ) -> dict[str, bytes]:
        """The primary's replicated-attr map for an object (user
        xattrs ``u:``, omap entries ``m:``), restored onto recovered
        shards alongside the identity attrs."""
        key = self._my_key(pg, oid)
        if key is None:
            return {}
        try:
            return {
                k: v for k, v in self.store.getattrs(key).items()
                if k.startswith(prefixes)
            }
        except FileNotFoundError:
            return {}

    def _user_attrs(self, pg: _PG, oid: str) -> dict[str, bytes]:
        return self._replicated_attrs(pg, oid, ("u:",))

    def _recovery_attrs(self, pg: _PG, oid: str) -> dict[str, bytes]:
        """Attrs restored onto recovered shards: the replicated user/
        omap attrs PLUS the reqid-dedup window. Without the window, a
        member rebuilt after an absence keeps its ANCIENT ``rq`` attr
        — and when it later becomes the primary it seeds suspect
        reqids so old they have left every other member's window,
        which classify ambiguous forever and wedge the object in
        eagain (chaos-tier find; the legacy self-catch-up bug masked
        this by accidentally seeding an empty window)."""
        attrs = self._replicated_attrs(pg, oid)
        key = self._my_key(pg, oid)
        if key is not None:
            try:
                attrs[REQ_KEY] = self.store.getattr(key, REQ_KEY)
            except (FileNotFoundError, KeyError):
                pass
        return attrs

    def _object_exists(self, pg: _PG, oid: str) -> bool:
        """The client-visible existence test the op handlers share."""
        return bool(self._object_size(pg, oid)) or self._have_object(
            pg, oid
        )

    def _authoritative_record(
        self, pg: _PG, oid: str
    ) -> "tuple[str, tuple[int, int] | None]":
        """Three-way authority lookup: ``("ev", (epoch, tid))`` when
        the latest committed write's stamp is known, ``("absent",
        None)`` when the primary AFFIRMATIVELY has no record of the
        object (its shard store is readable and the object is not
        there), ``("unknown", None)`` when the authority could not be
        judged — primary holds no shard of the object, the OI attr is
        missing/corrupt, or only a pre-eversion stamp exists.  The
        distinction matters for divergence handling: "absent" licenses
        deleting a returning member's copy; "unknown" must not (the
        primary's own incomplete local state would otherwise destroy a
        committed shard)."""
        ev = pg.rmw.object_eversion(oid)
        if ev is not None:
            return ("ev", ev)
        ev = pg.pglog.last_eversion(oid)
        if ev is not None and ev != (0, 0):
            return ("ev", ev)
        key = self._my_key(pg, oid)
        if key is None:
            return ("unknown", None)
        try:
            _size, ev = parse_oi(self.store.getattr(key, OI_KEY))
        except FileNotFoundError:
            return ("absent", None)
        except (KeyError, ValueError):
            return ("unknown", None)
        return ("unknown", None) if ev == (0, 0) else ("ev", ev)

    def _authoritative_eversion(
        self, pg: _PG, oid: str
    ) -> "tuple[int, int] | None":
        """The (epoch, tid) the object's latest committed write
        stamped, from the live pipeline or my own shard's OI attr —
        the eversion_t comparison source (osd_types.h)."""
        return self._authoritative_record(pg, oid)[1]

    def _member_listing(self, pg: _PG, shard: int) -> list:
        """The returning member's PG listing WITH its pristine
        eversion stamps. Must be fetched BEFORE any log replay:
        recovery pushes overwrite the member's OI stamps with the
        authoritative eversion, which would mask divergence on any
        object also written during the absence. Failures propagate —
        the catch-up's except path reverts the position to a hole
        rather than admitting an unjudged shard."""
        target_osd = pg.acting[shard]
        spec = self.osdmap.pools[pg.pool]
        return self.peers.list_pg(
            target_osd, spec.pool_id, spec.pg_num, pg.pgid
        )

    def _divergent_objects(
        self, pg: _PG, shard: int, listing: list
    ) -> tuple[set[str], set[str]]:
        """(rollback, delete) for a returning member's shard: objects
        whose stored (pre-replay) eversion does not match
        authoritative history.

        The PGLog::rewind_divergent_log role: a partitioned ex-primary
        may hold locally-applied writes the cluster never committed —
        its stamp differs from the authoritative one, so the shard's
        bytes must be rebuilt from survivors (rollback), and objects
        the authoritative state never heard of must be removed, or EC
        decode would mix divergent bytes into every read."""
        rollback: set[str] = set()
        delete: set[str] = set()
        for loc, si, _size, *ev in listing:
            if si != shard:
                continue  # old-layout leftovers: backfill/GC territory
            member_ev = tuple(ev) if len(ev) == 2 else (0, 0)
            if member_ev == (0, 0):
                continue  # pre-eversion stamp: nothing to judge
            kind, auth = self._authoritative_record(pg, loc)
            if kind == "absent":
                # Primary affirmatively never heard of it: a divergent
                # create — remove before it can pollute EC decodes.
                delete.add(loc)
            elif kind == "unknown" or member_ev != auth:
                # Unjudgeable authority (primary's own attr unreadable
                # or pre-eversion) degrades to rollback — rebuilding
                # from survivors is safe either way; deletion is not.
                rollback.add(loc)
        return rollback, delete

    # -- peering: authoritative-log election ---------------------------
    # The find_best_info / choose_acting analog
    # (osd/PeeringState.cc:1565, :2413): on taking the primary role
    # for a changed interval, gather (last_epoch_started, last_update)
    # from every up member, elect the authoritative log, rewind SELF
    # against the winner when self is not it, and only then activate
    # the interval (les := epoch, pushed durably to members). A
    # returning ex-primary is thereby corrected at ADMISSION time —
    # its divergent writes carry the old interval's les/epoch, so it
    # loses the election to any member that served the newer interval.

    def _pgmeta_key(self, pool_id: int, pgid: int) -> str:
        # deliberately not shard_key-parseable: object scans skip it
        return f"pgmeta\x02{pool_id}\x02{pgid}"

    def _pgmeta_read(self, pool_id: int, pgid: int) -> int:
        """Stored last_epoch_started, 0 when never activated."""
        try:
            return int(
                self.store.getattr(self._pgmeta_key(pool_id, pgid), "les")
            )
        except (FileNotFoundError, KeyError, ValueError):
            return 0

    def _pgmeta_acting(self, pool_id: int, pgid: int) -> "list | None":
        """The acting set I last activated this PG with (primaries
        only), or None — the interval-change detector for PGs with no
        live instance."""
        try:
            raw = self.store.getattr(
                self._pgmeta_key(pool_id, pgid), "acting"
            )
            return [int(x) for x in raw.decode().split(",") if x != ""]
        except (FileNotFoundError, KeyError, ValueError):
            return None

    def _pgmeta_write_les(
        self, pool_id: int, pgid: int, epoch: int,
        acting: "list | None" = None,
    ) -> None:
        # one lock for the read-check-write: a local activation
        # (peering thread) and a remote PGActivate (messenger thread)
        # interleaving here could write epochs out of order and
        # REGRESS the ledger — which a later election would read as a
        # stale interval and rank the member down
        with self._pgmeta_lock:
            key = self._pgmeta_key(pool_id, pgid)
            les = self._pgmeta_read(pool_id, pgid)
            if epoch <= les:
                return  # activation epochs are monotone
            txn = Transaction().touch(key).setattr(
                key, "les", str(epoch).encode()
            )
            if acting is not None:
                txn.setattr(
                    key, "acting",
                    ",".join(str(o) for o in acting).encode(),
                )
            self.store.queue_transactions(txn)

    def _peer_new_intervals(self) -> None:
        """Eager interval peering (the reference instantiates PGs on
        every member and peers each interval change; PGs here are
        otherwise lazy): after a map change, every PG I now serve as
        primary whose acting set differs from the one I last
        ACTIVATED gets instantiated and peered. Without this, an
        interval with no client IO would leave no durable les trace —
        and a returning ex-primary could then win the election with
        its divergent (higher-tid) stamps."""
        osdmap = self.osdmap
        for pool, spec in osdmap.pools.items():
            for pgid in range(spec.pg_num):
                if (pool, pgid) in osdmap.pg_temp:
                    continue  # backfill owns pg_temp intervals
                acting = osdmap.pg_to_up_acting(pool, pgid)
                if first_live(acting) != self.osd_id:
                    continue
                if self._pgmeta_acting(spec.pool_id, pgid) == acting:
                    continue  # interval unchanged since my activation
                existed = (pool, pgid) in self._pgs
                pg = self._get_pg(pool, pgid)
                if existed:
                    # a freshly instantiated PG was already kicked by
                    # _get_pg — kicking again would run the whole
                    # PGInfo/activation round twice
                    self._kick_peering(pg)

    def _own_pg_info(
        self, pool_id: int, pg_num: int, pgid: int
    ) -> tuple[int, tuple[int, int]]:
        """My pg_info_t analog, from durable state only: les from the
        pgmeta ledger, last_update = max committed OI eversion over
        the shard copies AT MY CURRENT ACTING POSITION (divergent
        local applies can inflate the tid but never the les — only
        post-peering activation writes that).

        The si scoping matters (round-5 chaos seed 7702): stale keys
        at OTHER positions — old-layout leftovers the divergence scan
        deliberately leaves to backfill/GC — must not inflate the
        vote, or a rewound member's lingering tampered leftovers
        out-rank clean logs at les ties."""
        my_pos = None
        for pool, spec in self.osdmap.pools.items():
            if spec.pool_id == pool_id:
                acting = self.osdmap.pg_to_up_acting(pool, pgid)
                if self.osd_id in acting:
                    my_pos = acting.index(self.osd_id)
                break
        lu = (0, 0)
        for loc, si in self._scan_pg_keys(pool_id, pg_num, pgid):
            if my_pos is not None and si != my_pos:
                continue
            try:
                _size, ev = parse_oi(
                    self.store.getattr(shard_key(loc, si), OI_KEY)
                )
            except (FileNotFoundError, KeyError, ValueError):
                continue
            if tuple(ev) > lu:
                lu = tuple(ev)
        return self._pgmeta_read(pool_id, pgid), lu

    def _bump_fence(self, pool_id: int, pgid: int, epoch: int) -> None:
        key = (pool_id, pgid)
        if epoch > self._fence_epochs.get(key, 0):
            self._fence_epochs[key] = epoch

    def _handle_pg_info(self, conn: Connection, msg: PGInfo) -> None:
        # FENCE FIRST: once this member answers an interval-E
        # election, a superseded primary's older-interval sub-writes
        # must not commit through it — otherwise a write can land
        # AFTER the election read this member's log and be invisible
        # to the new authority (the round-5 kill/revive thrash lost a
        # committed append to exactly that interleaving).
        if msg.epoch:
            self._bump_fence(msg.pool_id, msg.pgid, msg.epoch)
        les, lu = self._own_pg_info(msg.pool_id, msg.pg_num, msg.pgid)
        conn.send(PGInfoReply(msg.tid, msg.shard, les, lu[0], lu[1]))

    def _handle_pg_activate(self, conn: Connection, msg: PGActivate) -> None:
        self._bump_fence(msg.pool_id, msg.pgid, msg.epoch)
        self._pgmeta_write_les(msg.pool_id, msg.pgid, msg.epoch)
        conn.send(PGActivateAck(msg.tid, msg.shard))

    def _kick_peering(self, pg: _PG) -> None:
        """Clear the peered gate and run the election on its own
        thread (peering does network RPC + possibly O(PG) recovery;
        callers hold locks). A kick landing while a run is already in
        flight closes the gate and flags a RE-RUN: the in-flight
        election saw the OLD interval, and letting it open the gate
        for the new one would serve exactly the unpeered window this
        machinery exists to prevent (round-5 review finding)."""
        # The election may rewind/recover objects underneath the
        # in-memory reqid-window cache: a revived ex-primary that
        # seeded windows from its STALE store before losing the
        # election kept judging (and replaying!) from them after
        # recovery rewrote the attrs — the round-5 kill/revive thrash
        # lost a committed append to exactly that. Ops are gated until
        # peering completes, so invalidating here makes the first
        # post-peering op re-seed from the post-rewind store. The
        # invalidation is QUEUED (drained under _op_lock — see
        # _req_flush) and scoped to THIS PG: re-peering one PG must
        # not make every object in every pool re-pay the quorum
        # durability poll, and _req_poll_at goes with the windows so
        # a re-seeded object never eats a stale-cooldown eagain.
        spec = self.osdmap.pools.get(pg.pool)
        with self._req_flush_lock:
            if spec is None:
                # pool spec gone mid-kick: can't map locs to this PG
                # any more — flush everything rather than leak stale
                # windows past the rewind
                self._req_flush.add(None)
            else:
                self._req_flush.add(
                    ("pg", spec.pool_id, spec.pg_num, pg.pgid)
                )
        # the interval event serializes with every other peering
        # event of this PG; the gate flips synchronously inside
        # post_interval (ops eagain the moment the interval moves)
        pg.fsm.post_interval()

    def _object_size(self, pg: _PG, oid: str) -> int:
        size = pg.rmw.object_size(oid)
        if size:
            return size
        key = self._my_key(pg, oid)
        if key is None:
            return 0
        try:
            size, ev = parse_oi(self.store.getattr(key, OI_KEY))
        except (FileNotFoundError, KeyError, ValueError):
            return 0
        hinfo = None
        try:
            hinfo = HashInfo.from_bytes(
                self.store.getattr(key, HINFO_KEY), self.device
            )
        except (FileNotFoundError, KeyError, ValueError):
            pass
        pg.rmw.prime_object(oid, size, hinfo, eversion=ev)
        return size

    # -- dispatch -------------------------------------------------------
    def _dispatch(self, conn: Connection, msg) -> None:
        if isinstance(msg, Ping):
            conn.send(Pong(msg.tid, self.osd_id))
        elif isinstance(msg, ECSubWrite):
            oids = msg.txn.oids()
            # Fence EVERY distinct object in the transaction, not just
            # oids[0]: a txn touching objects in more than one PG must
            # clear every PG's fence epoch, or a superseded primary
            # could slip a stale sub-write past the fence through a
            # multi-object batch (ADVICE round-5 item).
            locs = list(dict.fromkeys(
                split_shard_key(o)[0] for o in oids
            )) or [""]
            loc = locs[0]
            if not all(
                self._sub_write_interval_ok(msg, l) for l in locs
            ):
                # interval fence (OSD::require_same_or_newer_map /
                # the MOSDECSubOpWrite map_epoch check): a superseded
                # primary whose map lags behind mine must not commit
                # through me — without this, a revived ex-primary
                # served an append from its stale state and tore the
                # log the REAL primary was appending to (round-5
                # kill/revive thrash find). Rejected: the stale op
                # never acks, its client resends against a fresh map.
                conn.send(
                    ECSubWriteReply(msg.tid, msg.shard, committed=False)
                )
                return
            from ceph_tpu_torch.pipeline.inject import ec_inject

            if ec_inject.test_write_error3(loc):
                # ECInject write type 3: handle_sub_write aborts the
                # OSD (ceph_abort, ECBackend.cc:922-926). The write is
                # never applied, the ack never sent; heartbeats and the
                # mon take it from here. Stop on a side thread — stop()
                # joins the worker/messenger threads this may run on.
                threading.Thread(target=self.stop, daemon=True).start()
                return
            def _applied_ack() -> None:
                # crash point: the txn is durable in this member's
                # store, the ack not yet on the wire — a kill here is
                # the half-committed sub-write (the sender parks; on
                # restart the pg log rolls this member forward or the
                # election rolls its divergence back)
                crash_points.fire(
                    "rmw.subwrite_applied_before_ack", daemon=self,
                    tid=msg.tid, shard=msg.shard,
                )
                conn.send(ECSubWriteReply(msg.tid, msg.shard))

            with tracer.continue_trace(msg.trace_id, msg.parent_span):
                with tracer.span(
                    "sub_write", osd=self.osd_id, shard=msg.shard,
                    tid=msg.tid,
                ):
                    self.local.submit_shard_txn(
                        self.osd_id, msg.txn, _applied_ack
                    )
        elif isinstance(msg, ECSubWriteBatch):
            self._handle_sub_write_batch(conn, msg)
        elif isinstance(msg, ECSubRead):
            with tracer.continue_trace(msg.trace_id, msg.parent_span):
                with tracer.span(
                    "sub_read", osd=self.osd_id, shard=msg.shard,
                    tid=msg.tid,
                ):
                    self._handle_sub_read(conn, msg)
        elif isinstance(msg, GetAttrs):
            serve_get_attrs(self.store, self.osd_id, conn, msg)
        elif isinstance(msg, PGList):
            self._handle_pg_list(conn, msg)
        elif isinstance(msg, PGInfo):
            self._handle_pg_info(conn, msg)
        elif isinstance(msg, PGActivate):
            self._handle_pg_activate(conn, msg)
        elif isinstance(msg, BackfillReserve):
            self._handle_backfill_reserve(conn, msg)
        elif isinstance(msg, OSDOp):
            self._handle_client_op(conn, msg)
        elif isinstance(msg, NotifyAck):
            self._handle_notify_ack(msg)

    def _handle_sub_write_batch(
        self, conn: Connection, msg: ECSubWriteBatch
    ) -> None:
        """One frame, many sub-writes (the round-10 fan-out batching).
        Every item passes the SAME gates the solo ECSubWrite path
        runs — per-loc interval fence, ECInject consultation — and
        applies independently: a fenced/stale item answers
        committed=False in the batch reply without poisoning its
        batch-mates; an injected drop simply stays un-acked (parked
        at the sender, like a lost solo ack)."""
        import types

        from ceph_tpu_torch.pipeline.inject import ec_inject

        results: list[tuple[int, bool]] = []
        for tid, shard, epoch, from_osd, txn in msg.items:
            oids = txn.oids()
            locs = list(dict.fromkeys(
                split_shard_key(o)[0] for o in oids
            )) or [""]
            stamp = types.SimpleNamespace(epoch=epoch, from_osd=from_osd)
            if not all(
                self._sub_write_interval_ok(stamp, l) for l in locs
            ):
                results.append((tid, False))
                continue
            if ec_inject.test_write_error3(locs[0]):
                # abort the daemon mid-batch (ECBackend.cc:922-926):
                # nothing later applies, no reply — every un-acked
                # item parks at the sender
                threading.Thread(target=self.stop, daemon=True).start()
                return
            acked: list[bool] = []
            with tracer.span(
                "sub_write", osd=self.osd_id, shard=shard, tid=tid,
            ):
                self.local.submit_shard_txn(
                    self.osd_id, txn, lambda a=acked: a.append(True)
                )
            if acked:
                # same applied-but-unacked crash class as the solo
                # path: everything up to here is durable, this item's
                # ack (and its batch-mates') may never leave
                crash_points.fire(
                    "rmw.subwrite_applied_before_ack", daemon=self,
                    tid=tid, shard=shard,
                )
                results.append((tid, True))
        conn.send(ECSubWriteBatchReply(msg.tid, self.osd_id, results))

    def _handle_sub_read(self, conn: Connection, msg: ECSubRead) -> None:
        def reply(_shard, result) -> None:
            if isinstance(result, Exception):
                kind = getattr(result, "kind", "eio")
                conn.send(ECSubReadReply(msg.tid, msg.shard, error=kind))
            else:
                offsets = sorted(result)
                conn.send(
                    ECSubReadReply(
                        msg.tid, msg.shard, offsets,
                        [bytes(result[o]) for o in offsets],
                    )
                )

        if msg.logical is not None and not self.store.exists(msg.oid):
            conn.send(ECSubReadReply(msg.tid, msg.shard, error="missing"))
            return
        self.local.read_shard_async(
            self.osd_id, msg.oid,
            ExtentSet((s, e) for s, e in msg.extents), reply,
        )

    def _handle_pg_list(self, conn: Connection, msg: PGList) -> None:
        """Backfill scan service: which of this PG's objects do I
        hold, which logical shard are they, how big is the object.
        Placement math from the message, not my (possibly old) map."""
        from ceph_tpu_torch.placement import stable_hash

        oids = []
        for loc, si in self._scan_pg_keys(msg.pool_id, msg.pg_num, msg.pgid):
            size, ev = -1, (0, 0)
            try:
                size, ev = parse_oi(
                    self.store.getattr(shard_key(loc, si), OI_KEY)
                )
            except (FileNotFoundError, KeyError, ValueError):
                pass
            oids.append((loc, si, size, ev[0], ev[1]))
        conn.send(PGListReply(msg.tid, msg.shard, oids))

    # -- client ops (the PrimaryLogPG::do_op role) ----------------------
    def _handle_client_op(self, conn: Connection, msg: OSDOp) -> None:
        """Reader thread: enqueue in mClock order; the worker runs it
        (OSD::enqueue_op -> mClock queue -> dequeue_op, osd/OSD.cc:
        9874,9933). Cost scales with payload so a large write consumes
        proportionally more of the class's rate."""
        if msg.op in ("watch", "unwatch"):
            # quick registry flips: reader thread, no queueing
            self._run_client_op(conn, msg)
            return
        if msg.op == "notify":
            # A notify WAITS for acks. Not on the worker (it would
            # freeze all queued IO) and not on this reader either —
            # when the notifier also watches the object over this
            # same connection, its own ack arrives HERE and a parked
            # reader would deadlock against itself. Own short-lived
            # thread.
            threading.Thread(
                target=self._run_client_op, args=(conn, msg),
                name="notify", daemon=True,
            ).start()
            return
        from ceph_tpu_torch.utils import config as _cfg

        cost = _qos.op_cost(max(len(msg.data), msg.length))
        # multi-tenant classing: a tagged op queues under its tenant's
        # own mClock clocks (client.<tenant>), an untagged one under
        # its pool's (client.<pool>) — the flooding neighbor throttles
        # against its own tags. osd_op_qos=false is the escape hatch:
        # everything shares the flat "client" class again.
        cls = (
            _qos.client_class(msg.tenant, msg.pool)
            if _cfg.get("osd_op_qos") else "client"
        )
        self._schedule(cls, _ClientOpItem(self, conn, msg), cost)

    def _run_client_op(
        self, conn: Connection, msg: OSDOp, shard: int = 0
    ) -> None:
        try:
            # adopt the client's trace context (the wire hop of the
            # ZTracer-through-the-pipeline pattern): this daemon's
            # spans — and the sub-op spans it fans out — share the
            # client op's trace id
            with tracer.continue_trace(msg.trace_id, msg.parent_span):
                with tracer.span(
                    "osd_op", op=msg.op, oid=msg.oid,
                    osd=self.osd_id, tid=msg.tid,
                ):
                    reply = self._execute_client_op(msg, conn, shard)
        except Exception as e:  # never kill the worker
            self.log.error(
                "client op", msg.op, f"{msg.pool}/{msg.oid}",
                "tid", msg.tid, "failed:", type(e).__name__, e
            )
            reply = OSDOpReply(
                msg.tid, self.osdmap.epoch, error="eio", data=str(e).encode()
            )
        if msg.op in _MUTATING_OPS and not reply.error:
            # crash point: the mutation is committed cluster-wide, the
            # client reply not yet sent — a kill here forces the
            # client's ambiguous resend, which MUST dedup through the
            # replicated reqid window on the takeover primary (outside
            # the try above: an armed abort must lose the reply like
            # the crash it models, never morph into an eio answer)
            crash_points.fire(
                "rmw.primary_committed_before_reply", daemon=self,
                tid=msg.tid, op=msg.op,
            )
        conn.send(reply)

    def _execute_client_op(
        self, msg: OSDOp, conn: "Connection | None" = None,
        shard: int = 0,
    ) -> OSDOpReply:
        epoch = self.osdmap.epoch
        spec = self.osdmap.pools.get(msg.pool)
        if spec is None:
            return OSDOpReply(msg.tid, epoch, error="enoent")
        if msg.op == "pgls":
            # PG-addressed, not object-addressed: offset carries pgid
            pgid = msg.offset
            if self.osdmap.pg_primary(msg.pool, pgid) != self.osd_id:
                return OSDOpReply(msg.tid, epoch, error="eagain")
            return self._op_pgls(msg, spec, pgid)
        if self.osdmap.primary(msg.pool, msg.oid) != self.osd_id:
            return OSDOpReply(msg.tid, epoch, error="eagain")
        pgid = self.osdmap.object_to_pg(msg.pool, msg.oid)
        # peering gate: a primary that has not finished this
        # interval's authoritative-log election must not serve — its
        # own store may hold divergent state (the returning
        # ex-primary). Ops WAIT briefly (the reference queues ops on
        # a peering PG until it activates, waiting_for_peered), then
        # eagain for the client's resend backoff. Peering never
        # depends on this worker thread (no QoS admission on the
        # rewind path), so the wait cannot deadlock.
        if not self._get_pg(msg.pool, pgid).peered.wait(timeout=5.0):
            return OSDOpReply(msg.tid, epoch, error="eagain")
        client_oid = msg.oid
        msg.oid = make_loc(spec.pool_id, msg.oid)  # pool-scoped store key
        # watch/notify live OUTSIDE the op lock: a notify waits for
        # acks (reader threads deliver them) and must not starve IO
        if msg.op == "watch":
            return self._op_watch(msg, conn)
        if msg.op == "unwatch":
            return self._op_unwatch(msg)
        if msg.op == "notify":
            return self._op_notify(msg, client_oid)
        with self._op_shards[shard]:
            self._drain_req_flushes()
            reply, pg = self._mutating_gate(msg, spec, pgid, epoch)
            if reply is not None:
                return reply
            if msg.op == "write":
                return self._record_completed(msg, self._op_write(pg, msg))
            if msg.op == "append":
                # atomic under _op_lock: offset resolves to the
                # CURRENT size, so concurrent appends serialize
                # without overlap (rados_append)
                msg.offset = self._object_size(pg, msg.oid)
                return self._record_completed(msg, self._op_write(pg, msg))
            if msg.op == "truncate":
                return self._record_completed(
                    msg, self._op_truncate(pg, msg)
                )
            if msg.op == "writefull":
                # write-then-shrink under one lock scope: the object
                # is exactly the payload afterwards (rados_write_full).
                # The reqid window stamps ONLY the final sub-op: a
                # crash between the two would otherwise make every
                # resend replay the half-applied state (stale tail
                # never cut); with the write unstamped, the resend
                # re-runs both halves — idempotent.
                saved_reqid = msg.reqid
                msg.reqid = ""
                try:
                    reply = self._op_write(pg, msg)
                finally:
                    msg.reqid = saved_reqid
                if reply.error:
                    return self._record_completed(msg, reply)
                msg.offset = len(msg.data)
                return self._record_completed(
                    msg, self._op_truncate(pg, msg)
                )
            if msg.op == "rollback":
                return self._record_completed(
                    msg, self._op_rollback(pg, spec, msg)
                )
            if msg.op == "read":
                if msg.snap:
                    return self._op_snap_read(pg, spec, msg)
                return self._op_read(pg, msg)
            if msg.op == "stat":
                if not self._object_exists(pg, msg.oid):
                    return OSDOpReply(msg.tid, epoch, error="enoent")
                size = self._object_size(pg, msg.oid)
                return OSDOpReply(msg.tid, epoch, size=size)
            if msg.op == "remove":
                return self._record_completed(msg, self._op_remove(pg, msg))
            if msg.op in ("setxattr", "rmxattr"):
                return self._record_completed(msg, self._op_setxattr(pg, msg))
            if msg.op == "getxattr":
                return self._op_getxattr(pg, msg)
            if msg.op == "getxattrs":
                return self._op_getxattrs(pg, msg)
            if msg.op == "omapset":
                return self._record_completed(msg, self._op_omapset(pg, msg))
            if msg.op == "omapget":
                return self._op_omapget(pg, msg)
            if msg.op == "omaplist":
                return self._op_omaplist(pg, msg)
            return OSDOpReply(msg.tid, epoch, error="eio",
                              data=f"bad op {msg.op!r}".encode())

    # -- coalesced tick execution (the round-10 serving tier) ----------
    # Concurrent client EC writes queued at this daemon execute as ONE
    # tick batch: the bookkeeping prelude (dedup gate, durability
    # settlement, COW, reqid-window stamping) runs SERIALLY under
    # _op_lock exactly as the classic path would, then per-PG groups
    # execute concurrently — encodes from different PGs share batched
    # device dispatches through the streaming ring
    # (pipeline/dispatcher.py), and every group's sub-writes stage per
    # peer OSD and flush as one framed message (ECSubWriteBatch).
    # Per-op error isolation: one op's failure (inject, codec fault,
    # degraded read) replies eio for THAT op; batch-mates commit.

    def _run_coalesced_batch(
        self, items: "list[_ClientOpItem]", shard: int = 0
    ) -> None:
        to_send: list[tuple] = []
        pre: list[_CoalCtx] = []
        for it in items:
            msg = it.msg
            epoch = self.osdmap.epoch
            try:
                spec = self.osdmap.pools.get(msg.pool)
                if spec is None:
                    to_send.append((it.conn, OSDOpReply(
                        msg.tid, epoch, error="enoent")))
                    continue
                if self.osdmap.primary(msg.pool, msg.oid) != self.osd_id:
                    to_send.append((it.conn, OSDOpReply(
                        msg.tid, epoch, error="eagain")))
                    continue
                pgid = self.osdmap.object_to_pg(msg.pool, msg.oid)
                # peering gate BEFORE the lock (the serial path's
                # ordering): peering never needs the op worker
                if not self._get_pg(msg.pool, pgid).peered.wait(
                    timeout=5.0
                ):
                    to_send.append((it.conn, OSDOpReply(
                        msg.tid, epoch, error="eagain")))
                    continue
                msg.oid = make_loc(spec.pool_id, msg.oid)
                pre.append(_CoalCtx(it.conn, msg, spec, pgid, epoch))
            except Exception as e:
                to_send.append((it.conn, OSDOpReply(
                    msg.tid, epoch, error="eio",
                    data=str(e).encode())))
        executed = 0
        if pre:
            with self._op_shards[shard]:
                self._drain_req_flushes()
                pending = pre
                while pending:
                    # one WAVE per distinct object: a second op on the
                    # same object waits for its predecessor's commit
                    # AND reqid-window stamp (the serial path's
                    # ordering), so it defers to the next wave
                    wave: list[_CoalCtx] = []
                    deferred: list[_CoalCtx] = []
                    seen: set[str] = set()
                    for ctx in pending:
                        if ctx.msg.oid in seen:
                            deferred.append(ctx)
                            continue
                        seen.add(ctx.msg.oid)
                        if not self._coalesce_prelude(ctx, to_send):
                            continue
                        wave.append(ctx)
                    if wave:
                        self._coalesce_execute(wave)
                        for ctx in wave:
                            to_send.append(
                                (ctx.conn, self._coalesce_epilogue(ctx))
                            )
                        executed += len(wave)
                    pending = deferred
        if len(items) > 1:
            self.coalesce_pc.inc("op_coalesced", executed)
            self.coalesce_pc.hinc("batch_size", len(items))
        for conn, reply in to_send:
            try:
                conn.send(reply)
            except (ConnectionError, OSError):
                pass  # client gone; its resend finds the answer cached

    def _coalesce_prelude(
        self, ctx: _CoalCtx, to_send: list
    ) -> bool:
        """Serial per-op prelude under _op_lock: the shared mutating
        gate, then the write-shape bookkeeping the classic handlers
        do before dispatch. False = the op answered here (gate reply
        or prelude fault) and must not execute."""
        msg = ctx.msg
        try:
            reply, pg = self._mutating_gate(
                msg, ctx.spec, ctx.pgid, ctx.epoch
            )
        except Exception as e:
            to_send.append((ctx.conn, OSDOpReply(
                msg.tid, ctx.epoch, error="eio",
                data=str(e).encode())))
            return False
        if reply is not None:
            to_send.append((ctx.conn, reply))
            return False
        ctx.pg = pg
        try:
            cur = self._object_size(pg, msg.oid)  # prime on takeover
            if msg.op == "write":
                ctx.w_offset = msg.offset
                ctx.result_size = max(cur, msg.offset + len(msg.data))
                ctx.attrs = self._req_attr_for(
                    pg, msg.oid, msg.reqid, ctx.result_size
                )
            else:  # writefull: write half stays reqid-unstamped (a
                # crash between write and shrink must re-run both —
                # see the serial handler), the truncate half carries
                # the window. Window state is frozen for the whole
                # batch (_op_lock held; all window mutations are in
                # serial phases), so precomputing here is exact.
                ctx.w_offset = 0
                ctx.result_size = len(msg.data)
                ctx.attrs = None
                ctx.trunc_attrs = self._req_attr_for(
                    pg, msg.oid, msg.reqid, len(msg.data)
                )
        except Exception as e:
            to_send.append((ctx.conn, OSDOpReply(
                msg.tid, ctx.epoch, error="eio",
                data=str(e).encode())))
            return False
        return True

    def _coalesce_execute(self, wave: "list[_CoalCtx]") -> None:
        """Run one wave: per-PG groups execute concurrently, each
        group pipelining its ops through the PG's RMW machinery.
        Sub-writes stage per peer for the whole wave (one frame per
        peer), encodes ride the streaming ring across groups."""
        groups: dict[tuple, list[_CoalCtx]] = {}
        for ctx in wave:
            groups.setdefault(
                (ctx.msg.pool, ctx.pgid), []
            ).append(ctx)
        with self.peers.subwrite_batching():
            if len(groups) == 1:
                self._coalesce_run_group(next(iter(groups.values())))
            else:
                threads = [
                    threading.Thread(
                        target=self._coalesce_run_group, args=(ctxs,),
                        daemon=True,
                        name=f"osd.{self.osd_id}-coal",
                    )
                    for ctxs in groups.values()
                ]
                for t in threads:
                    t.start()
                # drains inside each group are op_timeout-bounded, so
                # the join only guards against a pathological stall
                cap = self.op_timeout * (2 * len(wave)) + 10.0
                for t in threads:
                    t.join(timeout=cap)
        for ctx in wave:
            if ctx.outcome is None:
                ctx.outcome = ("exc", "coalesced execution stalled")

    def _coalesce_run_group(self, ctxs: "list[_CoalCtx]") -> None:
        """One PG's slice of a wave, on its own thread. Writes
        PIPELINE: every op submits before the first drain (the RMW
        in-order commit machinery keeps tid order), so the group's
        sub-writes share per-peer frames and its encodes overlap
        other groups' in the ring."""
        from ceph_tpu_torch.pipeline import dispatcher as _disp

        with _disp.coalescing_scope():
            live: list[_CoalCtx] = []
            for ctx in ctxs:
                try:
                    # osd_op_submit, not osd_op: this span covers the
                    # submit alone; the wave's drains and the truncate
                    # half run after it, shared by the batch, where the
                    # serial path's osd_op covers the op to its reply
                    with tracer.continue_trace(
                        ctx.msg.trace_id, ctx.msg.parent_span
                    ), tracer.span(
                        "osd_op_submit", op=ctx.msg.op,
                        oid=ctx.msg.oid, osd=self.osd_id,
                        tid=ctx.msg.tid,
                    ):
                        ctx.trace_ctx = tracer.current()
                        ctx.pg.rmw.submit(
                            ctx.msg.oid, ctx.w_offset, ctx.msg.data,
                            on_commit=lambda op, c=ctx: c.done.append(op),
                            extra_attrs=ctx.attrs,
                        )
                    live.append(ctx)
                except Exception as e:
                    ctx.outcome = ("exc", f"{type(e).__name__}: {e}")
            self._coalesce_drain(live)
            for ctx in list(live):
                if ctx.done and ctx.done[0].error is not None:
                    ctx.outcome = ("eio", str(ctx.done[0].error))
                    live.remove(ctx)
                elif not ctx.done:
                    # drain timed out with the write still in flight:
                    # stalled (a truncate queued behind it would only
                    # deepen the wedge — the serial path raises here)
                    live.remove(ctx)
            # writefull second half: the shrink that makes the object
            # exactly the payload (pipelined + drained the same way)
            trunc = [c for c in live if c.msg.op == "writefull"]
            for ctx in trunc:
                ctx.done = []
                try:
                    # re-enter the op's own osd_op_submit context: the
                    # shrink's sub-op spans must land under the SAME
                    # primary subtree the write half opened (the serial
                    # path runs both halves inside one osd_op span) — the
                    # coalesced-path trace gap of CAPABILITIES §4b
                    with tracer.continue_trace(*ctx.trace_ctx):
                        ctx.pg.rmw.submit_truncate(
                            ctx.msg.oid, len(ctx.msg.data),
                            on_commit=lambda op, c=ctx: c.done.append(op),
                            extra_attrs=ctx.trunc_attrs,
                        )
                except Exception as e:
                    ctx.outcome = ("exc", f"{type(e).__name__}: {e}")
                    live.remove(ctx)
            self._coalesce_drain([c for c in trunc if c in live])
            for ctx in list(live):
                if ctx.done and ctx.done[0].error is not None:
                    ctx.outcome = ("eio", str(ctx.done[0].error))
                    live.remove(ctx)
            for ctx in live:
                if not ctx.done:
                    continue  # drain timeout: outcome set by caller
                ctx.size = (
                    len(ctx.msg.data) if ctx.msg.op == "writefull"
                    else ctx.pg.rmw.object_size(ctx.msg.oid)
                )
                ctx.outcome = ("ok", None)

    def _coalesce_drain(self, ctxs: "list[_CoalCtx]") -> None:
        if not ctxs:
            return
        try:
            ctxs[0].pg.backend.drain_until(
                lambda: all(bool(c.done) for c in ctxs),
                timeout=self.op_timeout * (1 + len(ctxs)),
            )
        except TimeoutError:
            pass  # un-done ops surface as stalled in the epilogue

    def _coalesce_epilogue(self, ctx: _CoalCtx) -> OSDOpReply:
        """Serial per-op completion under _op_lock: window commit,
        backfill-dirty marking, reply + resend-replay recording —
        the same tail the classic handlers run."""
        msg, pg = ctx.msg, ctx.pg
        kind, detail = ctx.outcome
        if kind == "ok":
            self._req_commit(pg, msg.oid, msg.reqid, ctx.result_size)
            if pg.backfilling:
                with self._pg_lock:
                    pg.backfill_dirty.add(msg.oid)
            return self._record_completed(
                msg, OSDOpReply(msg.tid, ctx.epoch, size=ctx.size)
            )
        if kind == "eio":
            if self._transient_degraded(pg, detail or ""):
                return OSDOpReply(msg.tid, ctx.epoch, error="eagain")
            return self._record_completed(
                msg, OSDOpReply(msg.tid, ctx.epoch, error="eio",
                                data=(detail or "").encode())
            )
        # "exc": mirrors the serial path's exception catch — replied
        # eio but NOT recorded for resend replay
        self.log.error(
            "coalesced op", msg.op, msg.oid, "tid", msg.tid,
            "failed:", detail,
        )
        return OSDOpReply(
            msg.tid, ctx.epoch, error="eio",
            data=(detail or "").encode(),
        )

    def _mutating_gate(
        self, msg: OSDOp, spec, pgid: int, epoch: int
    ) -> "tuple[OSDOpReply | None, _PG | None]":
        """The dedup/durability gate every client op passes before its
        handler (caller holds ``_op_lock``; shared by the serial and
        the coalesced execution paths so they cannot diverge). Returns
        ``(reply, pg)`` — a non-None reply short-circuits the op."""
        polled = None  # durability fan-out, shared consult->resolve
        if msg.op in _MUTATING_OPS and msg.reqid:
            cached = self._completed_ops.get(msg.reqid)
            if cached is not None:
                self.net_pc.inc("dedup_hits")
                return OSDOpReply(
                    msg.tid, epoch, error=cached.error,
                    size=cached.size, data=cached.data,
                ), None
            # failover path: the replicated per-object window (the
            # pg-log reqid role) survives the old primary — a
            # resent append/write/truncate replays its recorded
            # result instead of re-applying. A STORAGE-seeded
            # entry must first prove durable: the dead primary may
            # have stamped it on < k shards (never acked, not
            # reconstructible) — replaying that as success loses
            # the write (round-4 advisor finding).
            pg0 = self._get_pg(msg.pool, pgid)
            hit = next(
                (t for t in self._req_window(pg0, msg.oid)
                 if t[0] == msg.reqid), None
            )
            if hit is not None:
                unv = self._req_unverified.get(msg.oid)
                if unv and msg.reqid in unv:
                    # async fan-out: a cached verdict resolves
                    # NOW; otherwise a poller thread is working
                    # (or cooldown/budget defers one) and the op
                    # parks in the client's retry loop — eagain,
                    # never a multi-second wait on the op worker
                    polled = self._take_or_spawn_poll(
                        pg0, msg.oid
                    )
                    if polled is None:
                        return OSDOpReply(
                            msg.tid, epoch, error="eagain"
                        ), None
                    members = sum(
                        1 for o in pg0.acting if o != SHARD_NONE
                    )
                    verdict = self._classify_req(
                        polled[0], msg.reqid, pg0.rmw.sinfo.k,
                        max(members - len(polled[0]), 0),
                    )
                else:
                    verdict = "durable"
                if verdict == "durable":
                    if unv:
                        unv.discard(msg.reqid)
                    self.net_pc.inc("dedup_hits")
                    return OSDOpReply(msg.tid, epoch, size=hit[1]), None
                if verdict == "unknown":
                    # unreachable members could still prove the
                    # op durable — back off instead of guessing
                    return OSDOpReply(
                        msg.tid, epoch, error="eagain"
                    ), None
                if verdict == "ambiguous":
                    return OSDOpReply(
                        msg.tid, epoch, error="eio",
                        data=b"resent op is not durable and later "
                             b"writes exist (unfound analog)",
                    ), None
                # "reapply": first attempt reached < k shards and
                # nothing newer exists anywhere — drop the seeded
                # entry and re-execute, healing the torn stripe.
                # An append re-applies at its ORIGINAL offset (the
                # recorded result size minus the payload), not the
                # current size a partial apply may have inflated.
                self.log.info(
                    "op", msg.oid, "resend", msg.reqid,
                    "not durable - re-applying"
                )
                self._req_windows[msg.oid] = [
                    t for t in self._req_window(pg0, msg.oid)
                    if t[0] != msg.reqid
                ]
                if unv:
                    unv.discard(msg.reqid)
                if msg.op == "append":
                    msg.op = "write"
                    msg.offset = max(hit[1] - len(msg.data), 0)
        pg = self._get_pg(msg.pool, pgid)
        if msg.op in _MUTATING_OPS:
            # settle storage-seeded reqid entries BEFORE anything
            # reads this object's size or stamps its window: a
            # torn never-acked write must be erased and rolled
            # back, or an append would build on the inflated OI
            # and a committed op's attr stamp would launder the
            # entry to every shard (round-5 review finding)
            if not self._resolve_unverified_reqs(
                pg, msg.oid, polled=polled
            ):
                return OSDOpReply(msg.tid, epoch, error="eagain"), None
            # copy-on-first-write after a pool snapshot: the head
            # must be preserved as the newest snap's clone BEFORE
            # any mutation lands (make_writeable role,
            # osd/PrimaryLogPG.cc)
            self._maybe_cow(pg, spec, msg.oid)
        return None, pg

    def _transient_degraded(self, pg: _PG, err) -> bool:
        """True when a below-min-size abort is a TRANSIENT local view
        (lossy-link down-marks on members the map still calls up —
        the recheck probe clears them within a tick): the op should
        answer eagain for the client's resend ladder, not a terminal
        eio. A genuinely under-replicated PG (map-level holes below
        k) keeps the fast eio."""
        text = str(err)
        if (
            "shards available" not in text
            and "cannot decode" not in text
            and "interval changed" not in text
        ):
            return False
        acting = self.osdmap.pg_to_up_acting(pg.pool, pg.pgid)
        live = sum(1 for o in acting if o != SHARD_NONE)
        return live >= pg.sinfo.k

    def _record_completed(self, msg: OSDOp, reply: OSDOpReply) -> OSDOpReply:
        """Remember a mutation's outcome under its client reqid so a
        resend (lost reply) replays the result instead of re-applying.
        Caller holds _op_lock. eagain is never recorded — it is an
        invitation to retry, and a cached one would replay forever."""
        if reply.error == "eagain":
            return reply
        if msg.reqid:
            # insert + trim under the reqcache leaf: shards record
            # concurrently, and an interleaved popitem while another
            # shard trims must not double-evict past the cap
            with self._reqcache_lock:
                self._completed_ops[msg.reqid] = reply
                while len(self._completed_ops) > self._completed_cap:
                    self._completed_ops.popitem(last=False)
        return reply

    def _drain_req_flushes(self) -> None:
        """Apply queued reqid-cache invalidations. Caller holds
        _op_lock; runs before any window is consulted, so an entry a
        mid-kick op re-inserted (it held _op_lock across the kick)
        is dropped before the next op can judge from it."""
        with self._req_flush_lock:
            if not self._req_flush:
                return
            pending, self._req_flush = self._req_flush, set()
        # the apply phase iterates a key-union of the reqid dicts:
        # another shard's _req_window seeding a NEW loc mid-union
        # would blow up the iteration — structural phase takes the
        # reqcache leaf (rank 35; _req_poll_lock nests under it)
        with self._reqcache_lock:
            self._apply_req_flushes(pending)

    def _apply_req_flushes(self, pending: set) -> None:
        if None in pending:
            self._req_windows.clear()
            self._req_unverified.clear()
            self._req_poll_at.clear()
            with self._req_poll_lock:
                # a verdict polled in the flushed interval must not
                # judge a window re-seeded in the new one
                self._req_poll_results.clear()
            return
        from ceph_tpu_torch.placement import stable_hash

        pools = {e[1] for e in pending if e[0] == "pool"}
        pgs = {(e[1], e[3]): e[2] for e in pending if e[0] == "pg"}
        doomed = []
        with self._req_poll_lock:
            poll_locs = set(self._req_poll_results)
        for loc in (
            self._req_windows.keys()
            | self._req_unverified.keys()
            | self._req_poll_at.keys()
            | poll_locs
        ):
            try:
                pool_id, oid = split_loc(loc)
            except ValueError:
                doomed.append(loc)  # unparseable: never judge from it
                continue
            if pool_id in pools:
                doomed.append(loc)
                continue
            for (pid, pgid), pg_num in pgs.items():
                if pool_id == pid and stable_hash(
                    str(pid), head_of_loc(oid)
                ) % pg_num == pgid:
                    doomed.append(loc)
                    break
        for loc in doomed:
            self._req_windows.pop(loc, None)
            self._req_unverified.pop(loc, None)
            self._req_poll_at.pop(loc, None)
            with self._req_poll_lock:
                self._req_poll_results.pop(loc, None)

    def _req_window(self, pg: _PG, loc: str) -> list:
        """This object's reqid window, seeding from the stored attr
        the first time (the takeover path: a new primary reads what
        the old one replicated)."""
        win = self._req_windows.get(loc)
        if win is None:
            win = []
            key = self._my_key(pg, loc)
            if key is not None:
                try:
                    win = parse_reqs(self.store.getattr(key, REQ_KEY))
                except (FileNotFoundError, KeyError, ValueError):
                    pass
            # structural inserts + trim under the reqcache leaf: the
            # trim's next(iter(...)) and a sibling shard's new-key
            # insert must not interleave. No double-seed race to
            # resolve — same loc always lands on the same shard.
            with self._reqcache_lock:
                if win:
                    # storage-seeded entries are suspect until a
                    # quorum poll proves them durable (see
                    # _verify_req_durable)
                    self._req_unverified[loc] = {t[0] for t in win}
                if len(self._req_windows) > 4096:
                    old = next(iter(self._req_windows))
                    self._req_windows.pop(old)
                    self._req_unverified.pop(old, None)
                    self._req_poll_at.pop(old, None)
                self._req_windows[loc] = win
        return win

    #: deadline for the one-shot durability fan-out (rare failover
    #: path; it runs on its OWN thread — never under _op_lock, never
    #: on the op worker — so it cannot stall unrelated client ops)
    REQ_POLL_TIMEOUT = 2.5
    #: minimum spacing between fan-out STARTS for the SAME unsettled
    #: object (client retries answer eagain; a finished poll's cached
    #: verdict is consumed regardless of the cooldown)
    REQ_POLL_COOLDOWN = 1.0
    #: daemon-wide cap on concurrent fan-out threads: an adversarial
    #: burst of torn objects must not spawn unbounded pollers — ops
    #: past the budget answer eagain and retry into a free slot
    REQ_POLL_BUDGET = 2

    def _take_or_spawn_poll(self, pg: _PG, loc: str):
        """PARK-AND-RE-ENTER for the durability fan-out (ADVICE r5
        osd_daemon:1912: the 2.5 s fan-out used to run under _op_lock
        ON the single op worker, so a handful of torn objects
        serialized multi-second stalls onto every client op).

        Returns a finished poll's ``(windows, infos)`` if one is
        cached for this object, else starts one on a dedicated
        thread (cooldown- and budget-gated) and returns None — the
        caller answers eagain, the client's retry loop re-enters,
        and a later attempt consumes the verdict synchronously. The
        op worker never blocks. Caller holds _op_lock."""
        with self._req_poll_lock:
            res = self._req_poll_results.pop(loc, None)
            if res is not None:
                return res
            if loc in self._req_polls_inflight:
                return None  # fan-out already running: retry later
        import time as _time

        now = _time.monotonic()
        if now - self._req_poll_at.get(loc, 0.0) < self.REQ_POLL_COOLDOWN:
            return None
        if not self._req_poll_sem.acquire(blocking=False):
            return None  # budget exhausted: eagain, retry into a slot
        with self._reqcache_lock:  # possibly a new key: structural
            self._req_poll_at[loc] = now
        with self._req_poll_lock:
            self._req_polls_inflight.add(loc)

        def run() -> None:
            try:
                polled = self._poll_req_state(pg, loc)
            except Exception:
                polled = ([], [])  # classify from nothing -> back off
            finally:
                self._req_poll_sem.release()
            with self._req_poll_lock:
                self._req_polls_inflight.discard(loc)
                self._req_poll_results[loc] = polled
                while len(self._req_poll_results) > 256:
                    # an abandoned verdict (client gave up) must not
                    # accumulate forever
                    self._req_poll_results.pop(
                        next(iter(self._req_poll_results))
                    )

        threading.Thread(
            target=run, daemon=True,
            name=f"osd.{self.osd_id}-req-poll",
        ).start()
        return None

    def _poll_req_state(self, pg: _PG, loc: str):
        """ONE async fan-out to the acting members for the object's
        replicated REQ window + OI (the scrub-tally get_attrs_async
        pattern — sequential sync RPCs under _op_lock stalled the
        daemon for members that are slow exactly during failover).

        Returns ``(windows, infos)``: parsed reqid windows from every
        member that answered (self included, read locally), and the
        OTHER members' (size, eversion) OIs — the rollback target
        source."""
        results: list = []
        pending = 0
        for si, osd in enumerate(pg.acting):
            if osd == SHARD_NONE or osd == self.osd_id:
                continue
            if si in pg.backend.recovering:
                # a RETURNED member mid-log-replay is behind: its
                # window/OI reflect the state from before it died, so
                # its "I have no record of that op" is not evidence —
                # counting it erased a committed append in the
                # kill/revive thrash (round-5 chaos find). It stays
                # un-answered (-> "unknown"/eagain) until the replay
                # admits it; then its vote counts.
                continue
            key = shard_key(loc, si)
            if self.peers.get_attrs_async(
                osd, key, [REQ_KEY, OI_KEY],
                lambda r, _o=osd: results.append(r),
            ):
                pending += 1
        windows: list = []
        infos: list = []
        try:
            key = self._my_key(pg, loc)
            raw = self.store.getattr(key, REQ_KEY) if key else None
            windows.append(parse_reqs(raw) if raw else [])
        except (FileNotFoundError, KeyError, ValueError):
            windows.append([])
        try:
            self.peers.drain_until(
                lambda: len(results) >= pending,
                timeout=self.REQ_POLL_TIMEOUT,
            )
        except TimeoutError:
            pass  # best-effort deadline: classify from who answered
        for r in results:
            if isinstance(r, Exception):
                continue  # unreachable: cannot vouch either way
            if getattr(r, "error", None):
                if r.error == "enoent":
                    # a DEFINITIVE "no record at my position" is an
                    # answer, not an absence of one: it votes an empty
                    # window, or a torn create (stamped only on the
                    # successor) would classify "unknown" forever and
                    # wedge the object in eagain (round-5 review).
                    # Safe even for an op committed at pre-remap
                    # positions: re-apply is a fixed-offset write.
                    windows.append([])
                continue
            attrs = r.attrs
            try:
                raw = attrs.get(REQ_KEY)
                windows.append(parse_reqs(raw) if raw else [])
            except ValueError:
                windows.append([])
            try:
                raw = attrs.get(OI_KEY)
                if raw:
                    size, ev = parse_oi(raw)
                    infos.append((size, tuple(ev)))
            except ValueError:
                pass
        return windows, infos

    @staticmethod
    def _classify_req(
        windows: list, reqid: str, k: int, unanswered: int = 0
    ) -> str:
        """Durability verdict for one suspect reqid over the polled
        windows (round-4 advisor finding: a storage-seeded entry may
        record an op the dead primary applied on fewer than k shards
        — never acked to the client, not reconstructible).

        ``"durable"``: >= k members recorded the reqid (sub-writes
        apply in tid order per shard, so those k copies are at a
        consistent version and any shard can be rebuilt).
        ``"unknown"``: the members that did NOT answer could still
        bring support to k — absence of an answer is not evidence of
        non-durability (a partitioned quorum must not erase a
        committed op; round-5 review finding). Callers back off.
        ``"reapply"``: provably under-supported and nowhere followed
        by a later mutation — re-executing the resend is safe and
        heals the torn stripe.
        ``"ambiguous"``: provably under-supported but later writes
        exist in some window; re-applying would clobber them — fail
        the resend instead of lying. The reference blocks such
        objects as "unfound" (osd_types.h pg_missing_t;
        PeeringState::proc_master_log rolls back what no quorum can
        support)."""
        support = 0
        later = False
        for win in windows:
            ids = [t[0] for t in win]
            if reqid in ids:
                support += 1
                if ids[-1] != reqid:
                    later = True
        if support >= k:
            return "durable"
        if support + unanswered >= k:
            return "unknown"
        return "ambiguous" if later else "reapply"

    def _resolve_unverified_reqs(
        self, pg: _PG, loc: str, polled=None
    ) -> bool:
        """Settle every storage-seeded window entry BEFORE a new op
        stamps the window onward (round-5 review finding: stamping an
        unverified entry into a committed op's attr replicates it to
        all shards, laundering a torn never-acked write into a
        'durable' one). Durable entries stay; provably-under-
        supported ones are erased from the window and the object is
        rolled back to its committed state so the new op builds on
        clean bytes.

        Returns False when the object's state CANNOT be settled now
        (too few members answered to classify, an entry is ambiguous,
        or the rollback could not establish the committed state) —
        the caller must not mutate the object (eagain; the client's
        backoff retries once the members answer). ``polled`` reuses a
        fan-out the caller already paid for."""
        win0 = self._req_window(pg, loc)  # force the storage seed
        unv = self._req_unverified.get(loc)
        if not unv:
            return True
        if polled is not None:
            windows, infos = polled
        else:
            # async fan-out (cooldown + budget inside): no verdict
            # ready yet -> eagain; the client's retry re-enters and
            # consumes it once the poller thread finishes. The old
            # synchronous poll held _op_lock for the full 2.5 s
            # deadline and several torn objects serialized that stall
            # onto every client op (ADVICE r5).
            res = self._take_or_spawn_poll(pg, loc)
            if res is None:
                return False
            windows, infos = res
        k = pg.rmw.sinfo.k
        members = sum(1 for o in pg.acting if o != SHARD_NONE)
        unanswered = max(members - len(windows), 0)
        keep, dropped = [], []
        for t in win0:
            if t[0] not in unv:
                keep.append(t)
                continue
            verdict = self._classify_req(windows, t[0], k, unanswered)
            if verdict == "durable":
                keep.append(t)
            elif verdict == "reapply":
                dropped.append(t[0])
            else:
                # unknown/ambiguous: not settleable — keep everything
                # marked and make the caller back off rather than
                # build on (or erase) state we cannot judge
                return False
        if dropped and not self._rollback_torn_object(pg, loc, infos):
            return False  # window untouched: retry when members answer
        self._req_windows[loc] = keep
        self._req_unverified.pop(loc, None)
        if dropped:
            self.log.info(
                "op", loc, "erased non-durable seeded reqids",
                dropped, "- object rolled back to committed state"
            )
        return True

    def _rollback_torn_object(
        self, pg: _PG, loc: str, infos: list
    ) -> bool:
        """Roll my shard back to the committed state and report
        success. The committed state is the max OI eversion WITNESSED
        by >= k members — witnessing is monotone (a shard whose OI is
        at ev' >= ev necessarily applied the commit at ev, sub-writes
        being in tid order), so members carrying a torn later stamp
        still vote for the committed prefix. My own (possibly torn)
        OI witnesses too. Plain agreement-counting needed k matching
        REMOTE OIs, unattainable for m=1 pools (round-5 review)."""
        k = pg.rmw.sinfo.k
        evs = [ev for _size, ev in infos]
        my_size = 0
        try:
            key = self._my_key(pg, loc)
            if key is not None:
                my_size, my_ev = parse_oi(self.store.getattr(key, OI_KEY))
                evs.append(tuple(my_ev))
        except (FileNotFoundError, KeyError, ValueError):
            pass
        good = [
            ev for ev in set(evs)
            if sum(1 for e in evs if e >= ev) >= k
        ]
        if not good:
            self.log.error(
                "op", loc, "cannot roll back torn object:",
                "no k-witnessed committed OI among reachable members"
            )
            return False
        target = max(good)
        sizes = [s for s, ev in infos if ev == target]
        size = max(sizes) if sizes else my_size
        pg.rmw.prime_object(loc, max(size, 0), eversion=target)
        try:
            my_pos = pg.acting.index(self.osd_id)
        except ValueError:
            return False
        try:
            pg.recovery.recover_object(loc, {my_pos})
        except Exception as e:
            self.log.error(
                "op", loc, "torn-object rollback recovery failed:",
                type(e).__name__, str(e),
            )
            return False
        return True

    def _req_attr_for(self, pg: _PG, loc: str, reqid: str,
                      size: int) -> "dict[str, bytes] | None":
        """extra_attrs carrying the window INCLUDING this op — stamped
        into the op's own shard txns, atomically replicated with it.
        PURE: the in-memory window only updates via _req_commit once
        the op actually commits — a failed op's reqid must never be
        replayable as a success."""
        if not reqid:
            return None
        # settle seeded entries FIRST: stamping an unverified reqid
        # into this op's replicated attr would spread it to every
        # shard and launder a torn write into a "durable" one. The
        # client-op path already settled (or eagained) before calling
        # here — failing loudly covers any future caller that didn't.
        if not self._resolve_unverified_reqs(pg, loc):
            raise RuntimeError(
                f"unsettled seeded reqid window for {loc!r}"
            )
        win = [t for t in self._req_window(pg, loc) if t[0] != reqid]
        win.append((reqid, size))
        del win[:-REQ_WINDOW]
        return {REQ_KEY: pack_reqs(win)}

    def _req_commit(self, pg: _PG, loc: str, reqid: str,
                    size: int) -> None:
        if not reqid:
            return
        win = [t for t in self._req_window(pg, loc) if t[0] != reqid]
        win.append((reqid, size))
        del win[:-REQ_WINDOW]
        self._req_windows[loc] = win

    def _op_write(self, pg: _PG, msg: OSDOp) -> OSDOpReply:
        cur = self._object_size(pg, msg.oid)  # prime attrs on takeover
        result_size = max(cur, msg.offset + len(msg.data))
        done: list = []
        pg.rmw.submit(
            msg.oid, msg.offset, msg.data,
            on_commit=lambda op: done.append(op),
            extra_attrs=self._req_attr_for(
                pg, msg.oid, msg.reqid, result_size
            ),
        )
        pg.backend.drain_until(lambda: bool(done), timeout=self.op_timeout)
        op = done[0]
        if op.error is not None:
            if self._transient_degraded(pg, op.error):
                # lossy-link transient (map still healthy): the
                # client's resend ladder retries past it
                return OSDOpReply(
                    msg.tid, self.osdmap.epoch, error="eagain"
                )
            return OSDOpReply(
                msg.tid, self.osdmap.epoch, error="eio",
                data=str(op.error).encode(),
            )
        self._req_commit(pg, msg.oid, msg.reqid, result_size)
        if pg.backfilling:
            with self._pg_lock:
                pg.backfill_dirty.add(msg.oid)  # re-pushed pre-cutover
        return OSDOpReply(
            msg.tid, self.osdmap.epoch, size=pg.rmw.object_size(msg.oid)
        )

    def _op_truncate(self, pg: _PG, msg: OSDOp) -> OSDOpReply:
        """rados_trunc: msg.offset carries the new size. Rides the
        RMW pipeline's per-object FIFO so it serializes with in-flight
        writes."""
        self._object_size(pg, msg.oid)  # prime from attrs on takeover
        done: list = []
        pg.rmw.submit_truncate(
            msg.oid, msg.offset, on_commit=lambda op: done.append(op),
            extra_attrs=self._req_attr_for(
                pg, msg.oid, msg.reqid, msg.offset
            ),
        )
        pg.backend.drain_until(lambda: bool(done), timeout=self.op_timeout)
        op = done[0]
        if op.error is not None:
            if self._transient_degraded(pg, op.error):
                # lossy-link transient (map still healthy): the
                # client's resend ladder retries past it
                return OSDOpReply(
                    msg.tid, self.osdmap.epoch, error="eagain"
                )
            return OSDOpReply(
                msg.tid, self.osdmap.epoch, error="eio",
                data=str(op.error).encode(),
            )
        self._req_commit(pg, msg.oid, msg.reqid, msg.offset)
        if pg.backfilling:
            with self._pg_lock:
                pg.backfill_dirty.add(msg.oid)
        return OSDOpReply(msg.tid, self.osdmap.epoch, size=msg.offset)

    def _op_read(self, pg: _PG, msg: OSDOp) -> OSDOpReply:
        if not self._object_exists(pg, msg.oid):
            return OSDOpReply(msg.tid, self.osdmap.epoch, error="enoent")
        size = self._object_size(pg, msg.oid)
        length = msg.length if msg.length else max(size - msg.offset, 0)
        done: list = []
        pg.reads.submit(
            msg.oid, msg.offset, length, on_complete=lambda op: done.append(op)
        )
        pg.backend.drain_until(lambda: bool(done), timeout=self.op_timeout)
        op = done[0]
        if op.error is not None:
            if self._transient_degraded(pg, op.error):
                # lossy-link transient (map still healthy): the
                # client's resend ladder retries past it
                return OSDOpReply(
                    msg.tid, self.osdmap.epoch, error="eagain"
                )
            return OSDOpReply(
                msg.tid, self.osdmap.epoch, error="eio",
                data=str(op.error).encode(),
            )
        return OSDOpReply(
            msg.tid, self.osdmap.epoch, size=size, data=op.data
        )

    def _op_remove(self, pg: _PG, msg: OSDOp) -> OSDOpReply:
        if not self._object_exists(pg, msg.oid):
            return OSDOpReply(msg.tid, self.osdmap.epoch, error="enoent")
        done: list = []
        pg.rmw.submit_remove(msg.oid, on_commit=lambda op: done.append(op))
        pg.backend.drain_until(lambda: bool(done), timeout=self.op_timeout)
        op = done[0]
        if op.error is not None:
            if self._transient_degraded(pg, op.error):
                # lossy-link transient (map still healthy): the
                # client's resend ladder retries past it
                return OSDOpReply(
                    msg.tid, self.osdmap.epoch, error="eagain"
                )
            return OSDOpReply(
                msg.tid, self.osdmap.epoch, error="eio",
                data=str(op.error).encode(),
            )
        if pg.backfilling:
            with self._pg_lock:
                pg.backfill_dirty.add(msg.oid)
        return OSDOpReply(msg.tid, self.osdmap.epoch)

    # -- snapshots (pool snaps + clone-on-first-write) ------------------
    def _read_full(self, pg: _PG, loc: str) -> bytes:
        """Whole-object read through the read pipeline (reconstructs
        under erasures like any client read). Caller holds _op_lock."""
        size = self._object_size(pg, loc)
        if size == 0:
            return b""
        done: list = []
        pg.reads.submit(
            loc, 0, size, on_complete=lambda op: done.append(op)
        )
        pg.backend.drain_until(lambda: bool(done), timeout=self.op_timeout)
        op = done[0]
        if op.error is not None:
            raise IOError(f"read {loc}: {op.error}")
        return op.data

    def _write_internal(self, pg: _PG, loc: str, data: bytes) -> None:
        done: list = []
        pg.rmw.submit(loc, 0, data, on_commit=lambda op: done.append(op))
        pg.backend.drain_until(lambda: bool(done), timeout=self.op_timeout)
        if done[0].error is not None:
            raise IOError(f"write {loc}: {done[0].error}")

    def _remove_internal(self, pg: _PG, loc: str) -> None:
        done: list = []
        pg.rmw.submit_remove(loc, on_commit=lambda op: done.append(op))
        pg.backend.drain_until(lambda: bool(done), timeout=self.op_timeout)

    def _maybe_cow(self, pg: _PG, spec, loc: str) -> None:
        """Preserve the head as the newest snap's clone before the
        first mutation after that snap. The head predates the snap iff
        its last-write epoch <= the snap's creation epoch — objects
        created after the snap never clone (and snap reads of them
        answer enoent). Caller holds _op_lock."""
        if not spec.snaps or snap_of_loc(loc):
            return  # no snaps / already a clone (rollback internals)
        snapid, _name, snap_epoch = spec.snaps[-1]
        cl = clone_loc(loc, snapid)
        if self._object_exists(pg, cl):
            return
        if not self._object_exists(pg, loc):
            return
        # A write stamped at the snap's own commit epoch happened
        # AFTER it (the snap commit is itself the map change) — only
        # strictly-older eversions predate the snap.
        ev = self._authoritative_eversion(pg, loc)
        if ev is not None and ev[0] >= snap_epoch:
            return  # head born/written after the snap: nothing to keep
        data = self._read_full(pg, loc)
        self._write_internal(pg, cl, data)
        attrs = dict(self._replicated_attrs(pg, loc))
        # The clone remembers the epoch its CONTENT was last written
        # at — older snaps consult it to tell "existed then" from
        # "born between snaps" (see _resolve_snap). Replicated (u:)
        # so shard rebuilds keep it; the \x1f makes client-namespace
        # collisions impossible.
        attrs["u:\x1forigin"] = str(ev[0] if ev else 0).encode()
        done: list = []
        pg.rmw.submit_attr_updates(
            cl, attrs, on_commit=lambda op: done.append(op)
        )
        pg.backend.drain_until(
            lambda: bool(done), timeout=self.op_timeout
        )

    def _resolve_snap(
        self, pg: _PG, spec, loc: str, snapid: int
    ) -> "str | None":
        """The loc serving a read at snapshot ``snapid``: the oldest
        clone at-or-after it, else the head when the head predates the
        snap, else None (object did not exist then)."""
        entry = next(
            (s for s in spec.snaps if s[0] == snapid), None
        )
        if entry is None:
            return None  # snap deleted (or never existed)
        for sid, _n, _e in spec.snaps:
            if sid < snapid:
                continue
            cl = clone_loc(loc, sid)
            if self._object_exists(pg, cl):
                # A later clone only serves an EARLIER snap if its
                # content predates that snap — otherwise the object
                # was born between the snaps and reading the clone
                # would resurrect it at a time it did not exist.
                origin = self._replicated_attrs(
                    pg, cl, ("u:\x1forigin",)
                ).get("u:\x1forigin")
                if origin is not None and int(origin) >= entry[2]:
                    return None  # monotonic: later clones only newer
                return cl
        if self._object_exists(pg, loc):
            ev = self._authoritative_eversion(pg, loc)
            # strictly-older epoch = head predates the snap (same
            # strictness as _maybe_cow; an unknown eversion reads as
            # old — serving stale head beats refusing a valid read)
            if ev is None or ev[0] < entry[2]:
                return loc
        return None

    def _op_snap_read(self, pg: _PG, spec, msg: OSDOp) -> OSDOpReply:
        src = self._resolve_snap(pg, spec, msg.oid, msg.snap)
        if src is None:
            return OSDOpReply(msg.tid, self.osdmap.epoch, error="enoent")
        redirected = OSDOp(
            msg.tid, msg.epoch, msg.pool, src, "read",
            msg.offset, msg.length,
        )
        return self._op_read(pg, redirected)

    def _op_rollback(self, pg: _PG, spec, msg: OSDOp) -> OSDOpReply:
        """rados_ioctx_snap_rollback: head becomes the snap's content
        (the pre-rollback head was preserved by the _maybe_cow that
        ran before this op)."""
        src = self._resolve_snap(pg, spec, msg.oid, msg.snap)
        if src is None:
            return OSDOpReply(msg.tid, self.osdmap.epoch, error="enoent")
        data = self._read_full(pg, src) if src != msg.oid else None
        if data is None:
            return OSDOpReply(msg.tid, self.osdmap.epoch)  # already it
        # the snapshot's ATTR state comes back too (minus the clone's
        # internal origin marker) — _maybe_cow preserved it for this
        attrs = {
            k: v
            for k, v in self._replicated_attrs(pg, src).items()
            if k != "u:\x1forigin"
        }
        self._remove_internal(pg, msg.oid)
        self._write_internal(pg, msg.oid, data)
        if attrs:
            done: list = []
            pg.rmw.submit_attr_updates(
                msg.oid, attrs, on_commit=lambda op: done.append(op)
            )
            pg.backend.drain_until(
                lambda: bool(done), timeout=self.op_timeout
            )
        if pg.backfilling:
            with self._pg_lock:
                pg.backfill_dirty.add(msg.oid)
        return OSDOpReply(
            msg.tid, self.osdmap.epoch, size=len(data)
        )

    def _gc_dropped_snaps(self) -> None:
        """Tick sweep: delete my shard keys of clones whose snapid the
        pool no longer lists (snap trimming, each member trims its own
        shards independently). The store scan only runs when the
        cluster's snap state CHANGED since the last sweep (plus once
        at startup), so steady-state ticks pay nothing."""
        state = tuple(
            sorted(
                (spec.pool_id, tuple(s[0] for s in spec.snaps))
                for spec in self.osdmap.pools.values()
            )
        )
        if state == getattr(self, "_snap_state_swept", None):
            return
        swept_clean = True
        live: dict[int, set[int]] = {}
        for spec in self.osdmap.pools.values():
            live[spec.pool_id] = {s[0] for s in spec.snaps}
        for key in list(self.store.list_objects()):
            try:
                loc, _si = split_shard_key(key)
                pool_id, _oid = split_loc(loc)
            except ValueError:
                continue
            sid = snap_of_loc(loc)
            if not sid:
                continue
            if sid not in live.get(pool_id, set()):
                try:
                    self.store.queue_transactions(
                        Transaction().remove(key)
                    )
                except Exception:
                    swept_clean = False  # keep the sweep armed
        if swept_clean:
            # only a FULLY clean sweep disarms: a failed removal (or
            # an exception above) leaves the state mismatch in place
            # so the next tick rescans
            self._snap_state_swept = state

    # -- watch / notify (librados watch/notify role) --------------------
    def _op_watch(self, msg: OSDOp, conn) -> OSDOpReply:
        """Register the sending connection as a watcher of the object
        (cookie in msg.name). Soft state on the primary — a primary
        change or daemon restart drops it, like the reference's watch
        timeout forces re-watch."""
        if conn is None:
            return OSDOpReply(
                msg.tid, self.osdmap.epoch, error="eio",
                data=b"watch needs a connection",
            )
        with self._watch_lock:
            self._watchers.setdefault(
                (msg.pool, msg.oid), {}
            )[msg.name] = conn
        return OSDOpReply(msg.tid, self.osdmap.epoch)

    def _op_unwatch(self, msg: OSDOp) -> OSDOpReply:
        with self._watch_lock:
            entry = self._watchers.get((msg.pool, msg.oid), {})
            entry.pop(msg.name, None)
        return OSDOpReply(msg.tid, self.osdmap.epoch)

    def _op_notify(self, msg: OSDOp, client_oid: str) -> OSDOpReply:
        """Fan the payload to every watcher, wait for acks (bounded),
        reply with who acked / who timed out (notify_ack collection,
        osd/Watch.cc role)."""
        import json as _json

        # client-supplied, but capped: one misbehaving notifier must
        # not park this reader thread forever
        timeout = min((msg.length / 1000.0) if msg.length else 1.0, 30.0)
        with self._watch_lock:
            watchers = dict(self._watchers.get((msg.pool, msg.oid), {}))
            notify_id = self._next_notify_id
            self._next_notify_id += 1
        if not watchers:
            return OSDOpReply(
                msg.tid, self.osdmap.epoch,
                data=_json.dumps({"acked": [], "missed": []}).encode(),
            )
        ev = threading.Event()
        state = {"pending": set(watchers), "acked": []}
        with self._watch_lock:
            self._pending_notifies[notify_id] = (state, ev)
        dead = []
        for cookie, wconn in watchers.items():
            try:
                wconn.send(WatchNotify(
                    notify_id, cookie, msg.pool, client_oid, msg.data
                ))
            except Exception:
                dead.append(cookie)
        if dead:
            with self._watch_lock:
                for cookie in dead:
                    state["pending"].discard(cookie)
                    self._watchers.get(
                        (msg.pool, msg.oid), {}
                    ).pop(cookie, None)
                if not state["pending"]:
                    ev.set()
        ev.wait(timeout)
        with self._watch_lock:
            self._pending_notifies.pop(notify_id, None)
            acked = list(state["acked"])
            missed = sorted(state["pending"])
        return OSDOpReply(
            msg.tid, self.osdmap.epoch,
            data=_json.dumps(
                {"acked": sorted(acked), "missed": missed}
            ).encode(),
        )

    def _handle_notify_ack(self, msg) -> None:
        with self._watch_lock:
            entry = self._pending_notifies.get(msg.notify_id)
            if entry is None:
                return
            state, ev = entry
            if msg.cookie in state["pending"]:
                state["pending"].discard(msg.cookie)
                state["acked"].append(msg.cookie)
            if not state["pending"]:
                ev.set()

    def _op_pgls(self, msg, spec, pgid: int):
        """List one PG's objects (the PGLS op behind rados ls). The
        primary's own scan suffices when its acting set is whole
        (every write touched it); peers are consulted only when the
        set has holes/recovering members — an object written while MY
        position was a hole must still list."""
        import json as _json

        pg = self._get_pg(msg.pool, pgid)
        degraded = pg.backend.recovering or any(
            o == SHARD_NONE for o in pg.acting
        )
        if degraded:
            locs = set(self._backfill_scan(msg.pool, pgid, spec, pg))
        else:
            locs = {
                loc for loc, _si in self._scan_pg_keys(
                    spec.pool_id, spec.pg_num, pgid
                )
            }
        # snapshot clones are internal objects: they backfill and
        # scrub, but never list (rados ls shows heads only)
        oids = sorted(
            split_loc(loc)[1]
            for loc in locs
            if not snap_of_loc(loc)
        )
        return OSDOpReply(
            msg.tid, self.osdmap.epoch,
            data=_json.dumps(oids).encode(),
        )

    def _meta_read_guard(
        self, pg: _PG, msg: OSDOp
    ) -> "OSDOpReply | None":
        """Common gate for metadata reads served from the primary's
        own shard copy: enoent when the object doesn't exist, a
        degraded-metadata EIO when the object exists but MY copy is
        missing (hole-written, not yet refreshed)."""
        if not self._object_exists(pg, msg.oid):
            return OSDOpReply(msg.tid, self.osdmap.epoch, error="enoent")
        key = self._my_key(pg, msg.oid)
        if key is None or not self.store.exists(key):
            return OSDOpReply(
                msg.tid, self.osdmap.epoch, error="eio",
                data=b"primary shard copy missing (recovering)",
            )
        return None

    def _run_attr_update(
        self, pg: _PG, msg: OSDOp, updates: "dict[str, bytes | None]"
    ) -> OSDOpReply:
        """Submit one logged attr batch and wait for commit (shared by
        the xattr and omap mutation handlers)."""
        done: list = []
        pg.rmw.submit_attr_updates(
            msg.oid, updates, on_commit=lambda op: done.append(op)
        )
        pg.backend.drain_until(lambda: bool(done), timeout=self.op_timeout)
        op = done[0]
        if op.error is not None:
            if self._transient_degraded(pg, op.error):
                # lossy-link transient (map still healthy): the
                # client's resend ladder retries past it
                return OSDOpReply(
                    msg.tid, self.osdmap.epoch, error="eagain"
                )
            return OSDOpReply(
                msg.tid, self.osdmap.epoch, error="eio",
                data=str(op.error).encode(),
            )
        if pg.backfilling:
            with self._pg_lock:
                pg.backfill_dirty.add(msg.oid)
        return OSDOpReply(msg.tid, self.osdmap.epoch)

    def _op_setxattr(self, pg: _PG, msg: OSDOp) -> OSDOpReply:
        if not self._object_exists(pg, msg.oid):
            return OSDOpReply(msg.tid, self.osdmap.epoch, error="enoent")
        value = msg.data if msg.op == "setxattr" else None
        return self._run_attr_update(pg, msg, {"u:" + msg.name: value})

    def _op_getxattr(self, pg: _PG, msg: OSDOp) -> OSDOpReply:
        if not self._object_exists(pg, msg.oid):
            return OSDOpReply(msg.tid, self.osdmap.epoch, error="enoent")
        key = self._my_key(pg, msg.oid)
        try:
            val = self.store.getattr(key, "u:" + msg.name)
        except FileNotFoundError:
            # the OBJECT is missing from my own shard (written while
            # my position was a hole, not yet refreshed): a degraded-
            # metadata condition, NOT proof the attr doesn't exist
            return OSDOpReply(
                msg.tid, self.osdmap.epoch, error="eio",
                data=b"primary shard copy missing (recovering)",
            )
        except KeyError:
            return OSDOpReply(msg.tid, self.osdmap.epoch, error="enodata")
        return OSDOpReply(msg.tid, self.osdmap.epoch, data=val)

    def _op_getxattrs(self, pg: _PG, msg: OSDOp) -> OSDOpReply:
        import json as _json

        bad = self._meta_read_guard(pg, msg)
        if bad is not None:
            return bad
        attrs = self._user_attrs(pg, msg.oid)
        return OSDOpReply(
            msg.tid, self.osdmap.epoch,
            data=_json.dumps(
                {k[2:]: v.hex() for k, v in attrs.items()}
            ).encode(),
        )

    def _op_omapset(self, pg: _PG, msg: OSDOp) -> OSDOpReply:
        """Batched omap mutations: data = json {key: hex value | null
        (remove)} — one ordered, logged commit for the whole batch
        (rados omap_set/omap_rm_keys)."""
        import json as _json

        if not self._object_exists(pg, msg.oid):
            return OSDOpReply(msg.tid, self.osdmap.epoch, error="enoent")
        try:
            kv = _json.loads(msg.data.decode())
            updates = {
                "m:" + k: (bytes.fromhex(v) if v is not None else None)
                for k, v in kv.items()
            }
        except (ValueError, AttributeError) as e:
            return OSDOpReply(
                msg.tid, self.osdmap.epoch, error="eio",
                data=f"bad omap batch: {e}".encode(),
            )
        return self._run_attr_update(pg, msg, updates)

    def _op_omapget(self, pg: _PG, msg: OSDOp) -> OSDOpReply:
        import json as _json

        bad = self._meta_read_guard(pg, msg)
        if bad is not None:
            return bad
        want = _json.loads(msg.data.decode()) if msg.data else None
        attrs = self._replicated_attrs(pg, msg.oid, ("m:",))
        out = {}
        for k, v in attrs.items():
            bare = k[2:]
            if want is None or bare in want:
                out[bare] = v.hex()
        return OSDOpReply(
            msg.tid, self.osdmap.epoch, data=_json.dumps(out).encode()
        )

    def _op_omaplist(self, pg: _PG, msg: OSDOp) -> OSDOpReply:
        """Sorted key range: name = start-after cursor, length = max
        entries (rados omap_get_keys2 pagination shape)."""
        import json as _json

        bad = self._meta_read_guard(pg, msg)
        if bad is not None:
            return bad
        attrs = self._replicated_attrs(pg, msg.oid, ("m:",))
        keys = sorted(k[2:] for k in attrs)
        if msg.name:
            import bisect

            keys = keys[bisect.bisect_right(keys, msg.name):]
        limit = msg.length or len(keys)
        page = keys[:limit]  # encode only the returned page's values
        return OSDOpReply(
            msg.tid, self.osdmap.epoch,
            data=_json.dumps(
                [[k, attrs["m:" + k].hex()] for k in page]
            ).encode(),
        )

    # -- backfill (rebalance data movement, pg_temp-protected) ----------
    def _request_pg_temp(self, pool: str, pgid: int, pg: _PG) -> bool:
        try:
            self.monitor.pg_temp_set(pool, pgid, list(pg.raw))
            return True
        except Exception:
            return False

    def _handle_backfill_reserve(
        self, conn: Connection, msg: BackfillReserve
    ) -> None:
        """Remote-reservation service (the MBackfillReserve target
        side): a request's GRANT reply may be delayed until a slot
        frees — the requesting primary blocks in reserve_backfill,
        which is exactly the throttle."""
        key = (msg.pool_id, msg.pgid)
        if msg.action == "release":
            self.remote_reserver.release(key)
            conn.send(BackfillReserveReply(msg.tid, msg.shard, True))
            return

        def grant(conn=conn, tid=msg.tid, shard=msg.shard) -> None:
            try:
                conn.send(BackfillReserveReply(tid, shard, True))
            except Exception:
                # requester gone: free the slot for the next in line
                self.remote_reserver.release(key)

        self.remote_reserver.request(key, msg.prio, grant)

    def _start_backfill(self, pool: str, pgid: int, pg: _PG) -> None:
        key = (pool, pgid)
        with self._pg_lock:
            if key in self._backfills and self._backfills[key].is_alive():
                return
            t = threading.Thread(
                target=self._backfill_pg, args=(pool, pgid, pg), daemon=True
            )
            self._backfills[key] = t
        pg.backfilling = True
        t.start()

    def tick(self) -> None:
        """Periodic maintenance: restart stalled backfills for PGs I
        serve under pg_temp (a failed pass leaves the temp mapping in
        place; the tick is the retry seam), finish pool-deletion
        sweeps, and kick due background scrubs."""
        self._adopt_pg_temps()
        self._maybe_gc_pools()
        self._maybe_schedule_scrubs()
        self._gc_dropped_snaps()
        # lossy-link hygiene: a peer down-marked by a single lost ack
        # (RPC expiry under the injected fault plane, or any transient
        # stall) is re-probed while the map still says it's up; a Pong
        # that postdates the mark clears it. Real failures never pong,
        # so their marks stand until the map changes.
        self.peers.recheck_down(
            {o for o in self.peers.down_shards if self.osdmap.is_up(o)}
        )
        # a failed peering pass leaves the gate closed; retry here
        with self._pg_lock:
            stuck = [
                pg for pg in self._pgs.values()
                if not pg.peered.is_set()
                and first_live(pg.acting) == self.osd_id
                and not pg.fsm._draining
            ]
        for pg in stuck:
            self._kick_peering(pg)
        # a failed shard catch-up reverts the member to a hole
        # (_catch_up_shard's except path) — with no further map
        # epoch, nothing would ever retry and the PG stays degraded
        # forever on a settled cluster. The tick re-heals: any shard
        # the CURRENT map says is up but my acting view holds as a
        # hole goes back through the recovering -> catch-up pipeline.
        to_heal: list[tuple[_PG, int]] = []
        with self._pg_lock:
            for (pool, pgid), pg in self._pgs.items():
                if first_live(pg.acting) != self.osd_id:
                    continue
                if pool not in self.osdmap.pools or pg.backfilling:
                    continue
                if self.osdmap.pg_to_raw(pool, pgid) != pg.raw:
                    continue  # layout moved: backfill's problem
                map_acting = self.osdmap.pg_to_up_acting(pool, pgid)
                for i, osd in enumerate(map_acting):
                    if (
                        osd != SHARD_NONE
                        and pg.acting[i] == SHARD_NONE
                        and i not in pg.backend.recovering
                    ):
                        pg.acting[i] = osd
                        pg.backend.acting[i] = osd
                        pg.backend.recovering.add(i)
                        to_heal.append((pg, i))
                # lossy-link quarantine drain: a position parked in
                # ``recovering`` by avail_shards (locally down-marked
                # while the map said up) re-enters through catch-up
                # once the peer answers pings again — the replay
                # brings it the writes hole-journaled past it, and
                # only the admission returns it to the read set
                for i, osd in enumerate(pg.acting):
                    if (
                        osd != SHARD_NONE
                        and osd != self.osd_id
                        and i in pg.backend.recovering
                        and i not in pg._catchup_inflight
                        and self.osdmap.is_up(osd)
                        and osd not in self.peers.down_shards
                    ):
                        to_heal.append((pg, i))
        for pg, shard in to_heal:
            self.log.info(
                "pg", f"{pg.pool}/{pg.pgid}:", "re-healing shard",
                shard, "(previous catch-up failed)"
            )
            if pg.acting[shard] == self.osd_id:
                # my own position: the election re-admits it (see
                # _admit_self_positions) — never a transfer to self
                pg.fsm.post_interval()
                continue
            self._spawn_catch_up(pg, shard)
        self._qos_tick()
        self.report_pg_stats()

    # -- PG-stats reporting (the MPGStats sender) -----------------------
    def report_pg_stats(self, force: bool = False) -> int:
        """Ship one pg_stats record per PG this daemon serves as
        primary, plus its osd_stat, to the monitor's PGMap. Driven by
        the tick at ``osd_stats_report_interval``; ``force`` flushes
        now regardless (the CLI surfaces call it so `status`/`pg
        dump`/`df` read fresh numbers without waiting a tick).
        Returns accepted records."""
        from ceph_tpu_torch.utils import config as _cfg

        iv = _cfg.get("osd_stats_report_interval")
        if iv <= 0 and not force:
            return 0
        now = time.monotonic()
        if not force and now - self._last_stats_report < iv:
            return 0
        self._last_stats_report = now
        if self._stopped:
            return 0
        osdmap = self.osdmap
        self._stats_seq += 1
        led_keys = self._map_led_pgs(osdmap)
        # ONE store pass serves every PG's census AND the osd_stat —
        # per-PG scans would be O(keys x pgs) per report
        census, used, n_keys = self._stats_census(osdmap, led_keys)
        stats = []
        with self._pg_lock:
            led = [
                (key, pg) for key, pg in self._pgs.items()
                if first_live(pg.acting) == self.osd_id
            ]
        covered: set[tuple[str, int]] = set()
        for (pool, pgid), pg in led:
            spec = osdmap.pools.get(pool)
            if spec is None:
                continue
            if (pool, pgid) not in led_keys:
                continue  # demoted: the new primary reports
            try:
                stats.append(self._collect_pg_stats(
                    pool, pgid, pg, spec, osdmap,
                    census.get((pool, pgid), {}),
                ))
                covered.add((pool, pgid))
            except Exception:
                pass  # a half-built PG must not sink the report
        # instance-less PGs the map says I lead (idle since boot, or
        # re-adopted after a revive without an interval change) still
        # report — from the store census + map acting alone — so the
        # PGMap never serves a stale record for a PG whose primary is
        # alive (the stats-derived recovery wait keys on fresh epochs)
        with self._pg_lock:
            have_instance = set(self._pgs)
        for pool, pgid in led_keys:
            if (pool, pgid) in covered or (pool, pgid) in have_instance:
                continue
            spec = osdmap.pools.get(pool)
            if spec is None:
                continue
            try:
                stats.append(self._collect_idle_pg_stats(
                    pool, pgid, spec, osdmap,
                    census.get((pool, pgid), {}),
                ))
            except Exception:
                pass
        from .pgmap import OSDStat

        cap = getattr(self.store, "device_size", 0) or _cfg.get(
            "osd_device_capacity_bytes"
        )
        osd_stat = OSDStat(
            osd=self.osd_id, used_bytes=used,
            capacity_bytes=int(cap), num_objects=n_keys,
        )
        try:
            return self.monitor.pg_stats_report(
                self.osd_id, osdmap.epoch, stats, osd_stat
            )
        except Exception:
            return 0  # a mon hiccup must not kill the tick loop

    def _map_led_pgs(self, osdmap: OSDMap) -> set:
        """{(pool, pgid) whose CRUSH primary I am}, cached per map
        epoch — the primary sweep must not run per report."""
        epoch, cached = self._led_cache
        if epoch == osdmap.epoch:
            return cached
        led = {
            (pool, pgid)
            for pool, spec in osdmap.pools.items()
            for pgid in range(spec.pg_num)
            if osdmap.pg_primary(pool, pgid) == self.osd_id
        }
        self._led_cache = (osdmap.epoch, led)
        return led

    def _stats_census(
        self, osdmap: OSDMap, led_keys: set
    ) -> tuple[dict, int, int]:
        """One pass over my store: ({(pool, pgid) -> {loc: logical
        size}} for the PGs in ``led_keys``, used bytes, key count).
        Logical sizes come from the OI attr (the object_info_t size),
        shard bytes from stat; keys of PGs led elsewhere only feed
        the used-bytes total."""
        from ceph_tpu_torch.placement import stable_hash

        by_id = {
            spec.pool_id: (pool, spec)
            for pool, spec in osdmap.pools.items()
        }
        census: dict[tuple[str, int], dict[str, int]] = {}
        used = 0
        keys = self.store.list_objects()
        for key in keys:
            try:
                used += self.store.stat(key)
            except (FileNotFoundError, OSError):
                pass
            try:
                loc, _si = split_shard_key(key)
                pool_id, oid = split_loc(loc)
            except ValueError:
                continue
            entry = by_id.get(pool_id)
            if entry is None:
                continue
            pool, spec = entry
            pgid = stable_hash(
                str(pool_id), head_of_loc(oid)
            ) % spec.pg_num
            if (pool, pgid) not in led_keys:
                continue
            sized = census.setdefault((pool, pgid), {})
            if loc in sized:
                continue
            try:
                size, _ev = parse_oi(self.store.getattr(key, OI_KEY))
            except (FileNotFoundError, KeyError, ValueError):
                size = 0
            sized[loc] = size
        return census, used, len(keys)

    def _collect_pg_stats(
        self, pool: str, pgid: int, pg: _PG, spec, osdmap: OSDMap,
        sized: "dict[str, int]",
    ):
        """One pg_stats_t record from live primary state + the shared
        store census (``sized``: loc -> logical size for this PG):
        state bits, object/byte counts, degraded/misplaced tallies,
        and the cumulative client/recovery counters the PGMap cuts
        rates from."""
        from .pgmap import PGStats

        acting = tuple(pg.acting)
        holes = {i for i, o in enumerate(acting) if o == SHARD_NONE}
        recovering = set(pg.backend.recovering) - holes
        degraded_pos = holes | recovering
        live = len(acting) - len(holes)
        peered = pg.peered.is_set()
        backfilling = bool(pg.backfilling) or (
            (pool, pgid) in osdmap.pg_temp
        )
        states = []
        if not peered:
            states.append("peering")
        elif live < spec.k:
            states.append("down")
        else:
            states.append("active")
        if holes:
            states.append("undersized")
        if degraded_pos:
            states.append("degraded")
        if recovering:
            states.append("recovering")
        if backfilling:
            states.append("backfilling")
        if (
            peered and live >= spec.k and not degraded_pos
            and not backfilling
        ):
            states.append("clean")
        # object/byte census from my own shard keys (the primary
        # holds one shard of every object it leads; OI attrs carry
        # the logical size — no peer IO, no pipeline locks)
        n_obj = len(sized)
        n_bytes = sum(sized.values())
        misplaced = 0
        if (pool, pgid) in osdmap.pg_temp:
            target = osdmap.pg_to_raw(pool, pgid, ignore_temp=True)
            moved = sum(
                1 for a, t in zip(acting, target) if a != t
            )
            misplaced = n_obj * moved
        rmw = pg.rmw.perf
        reads = pg.reads.perf
        rec = pg.recovery.perf
        return PGStats(
            pool=pool,
            pool_id=spec.pool_id,
            pgid=pgid,
            state=tuple(sorted(states)),
            up=tuple(osdmap.pg_to_raw(pool, pgid)),
            acting=acting,
            num_objects=n_obj,
            num_bytes=n_bytes,
            degraded=n_obj * len(degraded_pos),
            misplaced=misplaced,
            log_size=len(pg.pglog.entries),
            client_write_ops=rmw.get("write_ops"),
            client_write_bytes=rmw.get("write_bytes"),
            client_read_ops=reads.get("read_ops"),
            client_read_bytes=reads.get("read_bytes"),
            recovery_ops=rec.get("recovery_ops"),
            recovery_bytes=rec.get("recovered_bytes"),
            reported_epoch=osdmap.epoch,
            reported_seq=self._stats_seq,
            primary=self.osd_id,
        )

    def _collect_idle_pg_stats(
        self, pool: str, pgid: int, spec, osdmap: OSDMap,
        sized: "dict[str, int]",
    ):
        """A pg_stats record for a PG I lead per the map but hold no
        live instance for (no client IO this interval): state from
        the map acting set, census from the shared store pass, zero
        IO counters."""
        from .pgmap import PGStats

        acting = tuple(osdmap.pg_to_up_acting(pool, pgid))
        holes = sum(1 for o in acting if o == SHARD_NONE)
        live = len(acting) - holes
        states = ["active"] if live >= spec.k else ["down"]
        if holes:
            states += ["undersized", "degraded"]
        elif live >= spec.k:
            states.append("clean")
        return PGStats(
            pool=pool,
            pool_id=spec.pool_id,
            pgid=pgid,
            state=tuple(sorted(states)),
            up=tuple(osdmap.pg_to_raw(pool, pgid)),
            acting=acting,
            num_objects=len(sized),
            num_bytes=sum(sized.values()),
            degraded=len(sized) * holes,
            reported_epoch=osdmap.epoch,
            reported_seq=self._stats_seq,
            primary=self.osd_id,
        )

    # -- background scrub scheduler (osd/scrubber/osd_scrub.cc role) ----
    def _scrub_due(
        self, key: tuple[str, int], now: float
    ) -> "str | None":
        """"deep"/"shallow" when the PG's randomized due time passed,
        else None. Each PG gets a stable jitter fraction so scrubs
        spread inside the interval instead of storming together
        (osd_scrub_interval_randomize_ratio)."""
        import random

        from ceph_tpu_torch.utils import config

        stamps = self._scrub_stamps.setdefault(key, [0.0, 0.0])
        jitter = self._scrub_jitter.setdefault(key, random.random())
        ratio = config.get("osd_scrub_interval_randomize_ratio")
        shallow_iv = config.get("osd_scrub_min_interval") * (
            1.0 + jitter * ratio
        )
        deep_iv = config.get("osd_deep_scrub_interval") * (
            1.0 + jitter * ratio
        )
        if stamps[1] == 0.0 or now - stamps[1] >= deep_iv:
            return "deep"
        if stamps[0] == 0.0 or now - stamps[0] >= shallow_iv:
            # chance-based early deepening (PrimaryLogScrub's
            # deep_scrub_on_error/randomize behavior)
            if random.random() < config.get(
                "osd_deep_scrub_randomize_ratio"
            ):
                return "deep"
            return "shallow"
        return None

    def _maybe_schedule_scrubs(self) -> None:
        import time as _time

        from ceph_tpu_torch.utils import config

        now = _time.monotonic()
        with self._scrub_lock:
            if self._scrubs_running >= config.get("osd_max_scrubs"):
                return
        with self._pg_lock:
            keys = list(self._pgs)
        for key in keys:
            pool, pgid = key
            if pool not in self.osdmap.pools:
                continue
            if self.osdmap.pg_primary(pool, pgid) != self.osd_id:
                continue  # only the primary scrubs (reservation holder)
            kind = self._scrub_due(key, now)
            if kind is None:
                continue
            with self._scrub_lock:
                if self._scrubs_running >= config.get("osd_max_scrubs"):
                    return
                if key in self._scrubs_inflight:
                    continue  # still running: not due again yet
                self._scrubs_inflight.add(key)
                self._scrubs_running += 1
            threading.Thread(
                target=self._run_scheduled_scrub,
                args=(pool, pgid, kind),
                name=f"scrub-{pool}-{pgid}",
                daemon=True,
            ).start()

    def _run_scheduled_scrub(
        self, pool: str, pgid: int, kind: str
    ) -> None:
        import time as _time

        from ceph_tpu_torch.utils import config

        key = (pool, pgid)
        try:
            if kind == "deep":
                results = self.scrub_pg(
                    pool, pgid,
                    repair=config.get("osd_scrub_auto_repair"),
                )
            else:
                results = self.scrub_pg_shallow(pool, pgid)
            n_err = sum(len(r.errors) for r in results)
            repaired = any(getattr(r, "repaired", False) for r in results)
            now = _time.monotonic()
            stamps = self._scrub_stamps.setdefault(key, [0.0, 0.0])
            stamps[0] = now
            if kind == "deep":
                stamps[1] = now
            self.scrub_history[key] = (now, kind, n_err, repaired)
            if n_err:
                self.log.info(
                    "scheduled", kind, "scrub", f"{pool}/{pgid}:",
                    n_err, "errors",
                    "(repaired)" if repaired else "",
                )
                from ceph_tpu_torch.utils.cluster_log import cluster_log

                cluster_log.log(
                    f"osd.{self.osd_id}", "scrub_error",
                    f"{kind} scrub of pg {pool}/{pgid}: {n_err} "
                    f"errors{' (repaired)' if repaired else ''}",
                    severity="WRN", epoch=self.osdmap.epoch,
                    repaired=repaired,
                )
        except Exception as e:
            # scrubbing must never take the daemon down; the PG stays
            # due and the next tick retries
            self.log.error(
                "scheduled scrub failed", f"{pool}/{pgid}:",
                type(e).__name__, e,
            )
        finally:
            with self._scrub_lock:
                self._scrubs_running -= 1
                self._scrubs_inflight.discard(key)

    def scrub_pg_shallow(self, pool: str, pgid: int) -> "list":
        """Metadata-only scrub: every object's shards must agree on
        the HashInfo attr (consensus without dissent) — no payload
        reads (the reference's shallow scrub compares metadata only).
        """
        from ceph_tpu_torch.pipeline.recovery import ScrubError, ScrubResult

        spec = self.osdmap.pools[pool]
        pg = self._get_pg(pool, pgid)
        locs = sorted(self._backfill_scan(pool, pgid, spec, pg))
        results = []
        op_lock = self._op_lock_for(pool, pgid)
        for loc in locs:
            self.admit("scrub")
            with op_lock:
                if not self._object_size(pg, loc) and not (
                    self._have_object(pg, loc)
                ):
                    continue
                result = ScrubResult(loc)
                hinfo, dissent = self._consensus_hinfo(pg, loc)
                if hinfo is None:
                    result.errors.append(ScrubError(
                        -1, "hinfo_conflict" if dissent else "missing_attr"
                    ))
                elif dissent:
                    result.errors.append(
                        ScrubError(-1, "hinfo_dissent", str(dissent))
                    )
                results.append(result)
        return results

    def _backfill_pg(self, pool: str, pgid: int, pg: _PG) -> None:
        """Move every object of the PG to its CRUSH target layout,
        then drop pg_temp (the reference's backfill machinery:
        interval scan + push, last_backfill semantics collapsed to a
        dirty-set re-pass + final quiesce under the op lock).

        Reservation protocol (backfill_reservation.rst): a LOCAL slot
        from my reserver first, then a REMOTE slot from every
        reachable backfill target; only then does data move. A target
        whose remote reserver is full delays its grant — this thread
        waits, which IS the cluster-wide throttle. All slots release
        on exit (success or failure)."""
        key = (pool, pgid)
        local_granted = threading.Event()
        self.local_reserver.request(key, 0, local_granted.set)
        remote_reserved: list[int] = []
        try:
            if not local_granted.wait(timeout=60):
                raise RuntimeError("local backfill slot never granted")
            spec0 = self.osdmap.pools[pool]
            targets = sorted(
                set(self.osdmap.pg_to_raw(pool, pgid, ignore_temp=True))
                - {SHARD_NONE, self.osd_id}
            )
            for osd in targets:
                if osd not in self.peers.avail_shards():
                    continue  # pushes to it will fail+retry anyway
                # track BEFORE the RPC: a timed-out request may still
                # be queued (or later granted) at the target — the
                # finally must release/cancel it either way, or the
                # slot leaks when this backfill never retries
                remote_reserved.append(osd)
                if not self.peers.reserve_backfill(
                    osd, spec0.pool_id, pgid, 0, timeout=60.0
                ):
                    raise RuntimeError(
                        f"osd.{osd} backfill reservation not granted"
                    )
            self._backfill_pg_reserved(pool, pgid, pg)
        except Exception:
            # survivors short / peer died / reservation timed out:
            # keep pg_temp (the PG stays served from the old layout);
            # tick() retries
            pg.backfilling = False
        finally:
            for osd in remote_reserved:
                try:
                    self.peers.release_backfill(
                        osd, spec0.pool_id, pgid
                    )
                except Exception:
                    pass
            self.local_reserver.release(key)

    def _backfill_pg_reserved(
        self, pool: str, pgid: int, pg: _PG
    ) -> None:
        from ceph_tpu_torch.utils.optracker import op_tracker

        # one tracked op per backfill pass, each object move a marked
        # item: a wedged backfill shows WHERE it parked (scan, a
        # specific object's push, the final locked pass)
        top = op_tracker.register(
            "backfill", daemon=f"osd.{self.osd_id}",
            pool=pool, pgid=pgid,
        )
        try:
            spec = self.osdmap.pools[pool]
            # pass 1: scan + move everything currently known
            hints = self._backfill_scan(pool, pgid, spec, pg)
            top.mark_event("scanned", objects=len(hints))
            self.log.debug(
                "backfill pg", f"{pool}/{pgid}:", len(hints),
                "objects to place"
            )
            for oid in sorted(hints):
                # QoS: each object move admits through the backfill
                # class, at byte-proportional cost, so client IO keeps
                # its reservation
                self.admit(
                    "backfill", cost=_qos.op_cost(max(hints[oid], 0))
                )
                # clear the dirty flag BEFORE pushing: a client write
                # landing mid-push re-marks it and the final pass
                # re-pushes; discarding after would erase that evidence
                with self._pg_lock:
                    pg.backfill_dirty.discard(oid)
                top.mark_event("item", oid=oid)
                self._backfill_object(pool, pgid, pg, oid, hints[oid])
            # final pass: writes that landed mid-backfill, under the
            # op lock so nothing new sneaks in; then drop pg_temp
            top.mark_event("final_pass")
            with self._op_lock_for(pool, pgid):
                while True:
                    with self._pg_lock:
                        dirty = set(pg.backfill_dirty)
                        pg.backfill_dirty.clear()
                    if not dirty:
                        break
                    for oid in sorted(dirty):
                        self._backfill_object(pool, pgid, pg, oid)
                pg.backfilling = False
                pg.backfill_done = True  # _on_map drops, not re-temps
                self.monitor.pg_temp_clear(pool, pgid)
            self._backfill_gc(pool, pgid, pg, spec)
            top.finish("done")
        except Exception as e:
            # survivors short / peer died mid-pass: keep pg_temp (the
            # PG stays served from the old layout); tick() retries
            top.finish(f"error:{type(e).__name__}")
            pg.backfilling = False

    def _backfill_scan(
        self, pool: str, pgid: int, spec, pg: _PG,
        exclude: int | None = None,
    ) -> dict[str, int]:
        """Union of the PG's oids across my store and every reachable
        member of both layouts (old holders + targets with partial
        prior pushes), with the best known ro size per oid — the size
        hint covers objects the primary's own store is missing."""
        oids: dict[str, int] = {}
        for loc, _si in self._scan_pg_keys(spec.pool_id, spec.pg_num, pgid):
            oids[loc] = -1
        peers = (set(pg.acting) | set(
            self.osdmap.pg_to_raw(pool, pgid, ignore_temp=True)
        )) - {SHARD_NONE, self.osd_id, exclude}
        for osd in sorted(peers):
            if osd not in self.peers.avail_shards():
                continue
            try:
                for oid, _si, size, *_ev in self.peers.list_pg(
                    osd, spec.pool_id, spec.pg_num, pgid
                ):
                    oids[oid] = max(oids.get(oid, -1), size)
            except Exception:
                continue  # scan is best-effort; pushes verify reality
        return oids

    def _backfill_object(
        self, pool: str, pgid: int, pg: _PG, oid: str,
        size_hint: int = -1,
    ) -> None:
        """Push one object's shards to the CRUSH target layout."""
        from ceph_tpu_torch.pipeline.read import (
            get_min_avail_to_read_shards,
            reconstruct_shards,
        )
        from ceph_tpu_torch.pipeline.shard_map import ShardExtentMap

        target = self.osdmap.pg_to_raw(pool, pgid, ignore_temp=True)
        size = self._object_size(pg, oid)
        exists = bool(size) or self._have_object(pg, oid)
        if not exists and size_hint > 0:
            # a peer holds it even though my store doesn't (written
            # while my position was a hole): not a delete
            size, exists = size_hint, True
            pg.rmw.prime_object(oid, size)
        reachable = self.peers.avail_shards() | {self.osd_id}
        moves = [
            i for i, tgt in enumerate(target)
            if tgt != SHARD_NONE and tgt != pg.acting[i]
            and tgt in reachable  # a down target would wedge the push;
            # it catches up via log recovery when it returns
        ]
        if not moves:
            return
        if not exists:
            # removed mid-backfill: propagate the delete to targets
            for i in moves:
                self._push_delete(target[i], oid, i)
            return
        shard_len = pg.sinfo.object_size_to_shard_size(size, 0)
        want = {i: ExtentSet([(0, shard_len)]) for i in moves}
        avail = pg.backend.avail_shards()
        reads, need_decode = get_min_avail_to_read_shards(
            pg.sinfo, pg.codec, want, avail
        )
        smap = ShardExtentMap(pg.sinfo)
        for sr in reads.values():
            for start, buf in pg.backend.read_shard(
                sr.shard, oid, sr.extents
            ).items():
                smap.insert(sr.shard, start, buf)
        if need_decode:
            # reconstruct_shards, not a bare smap.decode: when the
            # plan carried CLAY sub-chunk selectors the survivors hold
            # only repair planes, which fractional repair consumes and
            # a windowed decode would mis-read as missing data
            reconstruct_shards(
                pg.sinfo, pg.codec, smap, want, reads, size
            )
        hinfo = pg.rmw.hinfo(oid)
        my_key = self._my_key(pg, oid)
        try:
            hinfo_bytes = (
                hinfo.to_bytes() if hinfo is not None
                else self.store.getattr(my_key, HINFO_KEY)
                if my_key is not None else None
            )
        except (FileNotFoundError, KeyError):
            hinfo_bytes = None
        user_attrs = self._replicated_attrs(pg, oid)
        for i in moves:
            key = shard_key(oid, i)
            buf = bytes(smap.get(i, 0, shard_len))
            txn = Transaction().touch(key).write(key, 0, buf)
            txn.truncate(key, shard_len)
            if hinfo_bytes is not None:
                txn.setattr(key, HINFO_KEY, hinfo_bytes)
            txn.setattr(
                key, OI_KEY,
                pack_oi(size, self._authoritative_eversion(pg, oid) or (0, 0)),
            )
            txn.setattr(key, SI_KEY, str(i).encode())
            for aname, aval in user_attrs.items():
                txn.setattr(key, aname, aval)
            self._push_shard_txn(target[i], txn)

    def _push_delete(self, osd: int, loc: str, shard: int) -> None:
        """Propagate a whole-object delete to one shard holder
        (touch+remove: no-op if the key never existed)."""
        key = shard_key(loc, shard)
        self._push_shard_txn(osd, Transaction().touch(key).remove(key))

    def _push_shard_txn(self, osd: int, txn) -> None:
        """Synchronous push to one osd (local or peer)."""
        if osd == self.osd_id:
            self.store.queue_transactions(txn)
            return
        done: list = []
        self.peers.submit_shard_txn(osd, txn, lambda: done.append(1))
        self.peers.drain_until(lambda: bool(done), timeout=self.op_timeout)

    def _backfill_gc(
        self, pool: str, pgid: int, pg: _PG, spec
    ) -> None:
        """Drop copies that don't belong to the new layout: ex-members
        lose all their pg keys; members that changed position lose the
        old position's key (shard-scoped keys make this precise)."""
        target = self.osdmap.pg_to_raw(pool, pgid, ignore_temp=True)
        members = (set(pg.acting) | set(target)) - {SHARD_NONE}
        for osd in sorted(members):
            if osd == self.osd_id:
                held = self._scan_pg_keys(spec.pool_id, spec.pg_num, pgid)
            else:
                if osd not in self.peers.avail_shards():
                    continue  # unreachable: stale copies are inert
                             # (shard keys can't be misread as current)
                try:
                    held = [
                        (loc, si) for loc, si, _sz, *_ev in self.peers.list_pg(
                            osd, spec.pool_id, spec.pg_num, pgid
                        )
                    ]
                except Exception:
                    continue
            for loc, si in held:
                keep = 0 <= si < len(target) and target[si] == osd
                if keep:
                    continue
                key = shard_key(loc, si)
                try:
                    self._push_shard_txn(
                        osd, Transaction().touch(key).remove(key)
                    )
                except Exception:
                    pass

    # -- deep scrub (be_deep_scrub over the wire + repair) --------------
    def scrub_pg(
        self, pool: str, pgid: int, repair: bool = False
    ) -> "list":
        """Deep-scrub every object of a PG I lead: read each live
        shard's hashed window, verify against the persisted HashInfo
        cumulative CRCs (ECBackend.cc:1829-1869 — the verify loop IS
        ``pipeline.recovery.be_deep_scrub``, run over the wire through
        an adapter), and with ``repair`` rebuild mismatched shards from
        the good ones. Objects are enumerated across MY store and every
        reachable member (the same union scan backfill uses) so a
        primary missing its own shard key still scrubs the object."""
        spec = self.osdmap.pools[pool]
        pg = self._get_pg(pool, pgid)
        locs = sorted(self._backfill_scan(pool, pgid, spec, pg))
        results = []
        for loc in locs:
            # deep scrub reads every live shard's payload: price the
            # sweep by object size, not per-object flat
            self.admit(
                "scrub", cost=_qos.op_cost(self._object_size(pg, loc))
            )
            # serialize with client ops: a scrub racing a mid-commit
            # write would see mixed-epoch shards and (with repair)
            # write the mixture back
            with self._op_lock_for(pool, pgid):
                results.append(self._scrub_object(pg, loc, repair))
        return results

    def _scrub_object(self, pg: _PG, oid: str, repair: bool):
        from ceph_tpu_torch.pipeline.recovery import (
            ScrubError,
            ScrubResult,
            be_deep_scrub,
        )

        if not self._object_size(pg, oid) and not self._have_object(
            pg, oid
        ):
            # removed between enumeration and this lock: clean skip,
            # not an inconsistency
            return ScrubResult(oid)
        hinfo, dissent = self._consensus_hinfo(pg, oid)
        if hinfo is None:
            result = ScrubResult(oid)
            result.errors.append(ScrubError(
                -1, "hinfo_conflict" if dissent else "missing_attr"
            ))
            return result
        if dissent:
            self.log.info(
                "scrub", oid + ":", "hinfo dissent from shards", dissent,
                "- majority copy wins"
            )
        result = be_deep_scrub(
            pg.sinfo, _ScrubBackendView(pg), oid, hinfo=hinfo,
            device=self.device,
        )
        bad = sorted({e.shard for e in result.errors if e.shard >= 0})
        if repair and bad:
            try:
                # the rebuilt shards must carry the ELECTED hinfo, not
                # whatever (possibly divergent) copy the rmw cache was
                # primed with — else the dissenting attr survives the
                # repair and every later scrub re-flags the shard
                pg.rmw.prime_object(
                    oid, self._object_size(pg, oid), hinfo
                )
                pg.recovery.recover_object(oid, set(bad))
                result.repaired = True
            except Exception as e:
                result.errors.append(ScrubError(-1, "read_error", str(e)))
        return result

    def _gather_hinfo_votes(
        self, pg: _PG, oid: str
    ) -> "dict[bytes, tuple[list[int], tuple[int, int]]]":
        """attr-bytes -> (holder positions, newest accompanying OI
        eversion). One concurrent fan-out: all remote fetches go out
        before any reply is awaited (no per-member round trips, no
        long _op_lock stalls on a slow peer). Members still under
        catch-up (backend.recovering) do not vote — their attrs are
        mid-replay by definition."""
        votes: dict[bytes, tuple[list[int], tuple[int, int]]] = {}

        def tally(pos: int, attrs: dict) -> None:
            raw = attrs.get(HINFO_KEY)
            if not raw:
                return
            ev = (0, 0)
            oi = attrs.get(OI_KEY)
            if oi:
                try:
                    _sz, ev = parse_oi(oi)
                except ValueError:
                    pass
            holders, best = votes.setdefault((bytes(raw)), ([], (0, 0)))
            holders.append(pos)
            votes[bytes(raw)] = (holders, max(best, ev))

        reachable = self.peers.avail_shards() | {self.osd_id}
        pending: set[int] = set()

        def on_reply(pos: int, reply) -> None:
            pending.discard(pos)
            if not isinstance(reply, Exception) and not reply.error:
                tally(pos, reply.attrs)

        for pos, osd in enumerate(pg.acting):
            if (
                osd == SHARD_NONE
                or osd not in reachable
                or pos in pg.backend.recovering
            ):
                continue
            key = shard_key(oid, pos)
            if osd == self.osd_id:
                try:
                    attrs = self.store.getattrs(key)
                    tally(pos, {
                        HINFO_KEY: attrs.get(HINFO_KEY),
                        OI_KEY: attrs.get(OI_KEY),
                    })
                except Exception:
                    pass  # corrupt/missing attrs: this shard abstains
                continue
            if self.peers.get_attrs_async(
                osd, key, [HINFO_KEY, OI_KEY],
                lambda r, p=pos: on_reply(p, r),
            ):
                pending.add(pos)
        if pending:
            try:
                self.peers.drain_until(
                    lambda: not pending, timeout=self.op_timeout
                )
            except TimeoutError:
                pass  # non-repliers abstain
        return votes

    def _consensus_hinfo(
        self, pg: _PG, oid: str
    ) -> "tuple[HashInfo | None, list[int]]":
        """(elected HashInfo, dissenting shard positions).

        Every shard's store carries its own copy of the object's
        HashInfo attr; trusting only the PRIMARY's copy lets a
        divergent ex-primary 'repair' the good majority into garbage.
        Election, in order (the auth_log_shard role scoped to the
        integrity attr scrub consumes):

        1. If this primary has LIVE history for the object (in-memory
           rmw state or an in-window pg log entry — trustworthy, unlike
           a cold-boot attr), the copy whose accompanying OI eversion
           matches it wins regardless of count: two stale copies must
           not outvote the one member holding the committed write.
        2. Otherwise plurality of the cast votes; a TIE elects nobody
           (hinfo_conflict, no repair) — a coin flip must never
           overwrite a good shard."""
        votes = self._gather_hinfo_votes(pg, oid)
        if not votes:
            return None, []
        # ONLY write-origin evidence anchors the election: rmw stamps
        # recorded by this pipeline's own writes, or in-window pg log
        # entries. object_eversion may be primed from the primary's
        # own cold attr — which is exactly what a divergent ex-primary
        # would use to elect itself.
        live_ev = pg.rmw.live_eversion(oid) or pg.pglog.last_eversion(oid)
        winner = None
        if live_ev is not None and live_ev != (0, 0):
            matching = [
                raw for raw, (_h, ev) in votes.items() if ev == live_ev
            ]
            if len(matching) == 1:
                winner = matching[0]
        if winner is None:
            counts = sorted(
                (len(h) for h, _ev in votes.values()), reverse=True
            )
            if len(counts) > 1 and counts[0] == counts[1]:
                return None, sorted(
                    pos for h, _ev in votes.values() for pos in h
                )
            winner = max(votes.items(), key=lambda kv: len(kv[1][0]))[0]
        dissent = sorted(
            pos for raw, (holders, _ev) in votes.items()
            if raw != winner for pos in holders
        )
        try:
            return HashInfo.from_bytes(winner, self.device), dissent
        except (TypeError, ValueError):
            return None, dissent

    def scrub_all(self, repair: bool = False) -> "dict":
        """Scrub every PG this daemon currently leads."""
        out = {}
        for pool, spec in self.osdmap.pools.items():
            for pgid in range(spec.pg_num):
                acting = self.osdmap.pg_to_up_acting(pool, pgid)
                primary = next(
                    (o for o in acting if o != SHARD_NONE), SHARD_NONE
                )
                if primary == self.osd_id:
                    out[(pool, pgid)] = self.scrub_pg(pool, pgid, repair)
        return out

    # -- failure detection ----------------------------------------------
    def report_down_peers(self) -> None:
        """Forward locally observed peer deaths to the monitor (the
        OSD→mon failure-report channel; OSDMonitor quorum-counts them)."""
        for osd in sorted(self.peers.down_shards):
            if self.osdmap.is_up(osd):
                self.monitor.report_failure(self.osd_id, osd)

    def __repr__(self) -> str:
        return f"OSDDaemon(osd.{self.osd_id}, e{self.osdmap.epoch})"
