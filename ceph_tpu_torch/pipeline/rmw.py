"""The RMW (read-modify-write) pipeline — ``RMWPipeline`` +
``ECTransaction`` analog.

Behavioral mirror of the reference write path
(osd/ECCommon.cc:649 ``start_rmw`` → ECExtentCache → ``cache_ready`` →
``Op::generate_transactions`` → osd/ECTransaction.cc:916 → per-shard
sub-writes → in-order commit via ``waiting_commit``,
ECCommon.h:553-555):

1. ``WritePlan`` (ECTransaction.h:62-64): choose full-stripe re-encode
   vs parity-delta per codec flags and read cost, and compute the
   shard extents that must be fetched before encoding.
2. The extent cache satisfies reads (hit) or issues ONE backend read.
3. On cache-ready, the encode runs — ``ShardExtentMap.encode`` or
   ``encode_parity_delta`` (the device dispatch) — and per-shard
   ``Transaction``s are generated, including the ``hinfo_key`` attr
   update (ECTransaction.cc:497,902; attr name ECUtil.cc:1179).
4. Sub-writes dispatch to every shard's store; client commit callbacks
   fire strictly in tid order no matter the ack order.

Deltas from the reference: the encode is one batched kernel launch per
op (not per 4K slice), and the whole pipeline is an event-driven state
machine a host thread drives between launches — no per-op
threads, mirroring crimson's run-to-completion stance more than the
classic OSD's thread pools.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from collections.abc import Callable
from dataclasses import dataclass, field

import numpy as np

from ceph_tpu_torch.codecs.interface import Flag
from ceph_tpu_torch.store import Transaction
from ceph_tpu_torch.utils import tracer
from ceph_tpu_torch.utils.crash_points import crash_points
from ceph_tpu_torch.utils.optracker import NULL_OP, op_tracker

from .extent_cache import CacheOp, ECExtentCache
from .extents import ExtentSet
from .hashinfo import HashInfo
from .shard_map import ShardExtentMap
from .stripe import StripeInfo
from ceph_tpu_torch.utils.lockdep import DebugRLock

HINFO_KEY = "hinfo_key"  # ECUtil.cc:1179
#: object-info attr: the rados object size travels with every shard
#: txn (the object_info_t "_" attr role) so a NEW primary can recover
#: sizes after failover instead of trusting in-memory state.
OI_KEY = "oi"


def pack_oi(size: int, eversion: tuple[int, int] = (0, 0)) -> bytes:
    """object_info_t attr payload: ro size + last-write eversion.

    The eversion is the reference's ``eversion_t`` (osd_types.h) —
    (map epoch, op version) stamped atomically with every sub-write,
    so peering can tell a shard whose content matches authoritative
    history from one that diverged (a partitioned ex-primary's
    locally-applied writes)."""
    return f"{size}:{eversion[0]}:{eversion[1]}".encode()


def parse_oi(raw: bytes) -> tuple[int, tuple[int, int]]:
    """(size, eversion); bare-size payloads (pre-eversion format)
    parse with the null eversion (0, 0) = 'unknown'. Any other shape
    is corrupt and raises ValueError (the error every caller already
    handles)."""
    parts = raw.decode().split(":")
    if len(parts) == 1:
        return int(parts[0]), (0, 0)
    if len(parts) != 3:
        raise ValueError(f"corrupt OI payload: {raw!r}")
    return int(parts[0]), (int(parts[1]), int(parts[2]))
#: shard-index attr: which logical EC shard these bytes are. Read
#: paths compare it against the position they are asking for, so a
#: CRUSH remap can never silently serve shard j's bytes as shard i
#: (misplaced data reads as a clean error until backfill moves it).
SI_KEY = "si"


@dataclass
class WritePlan:
    """What one write op will read and write, and via which strategy
    (the ECTransaction.h:62-64 ``WritePlan{want_read, plans}`` analog)."""

    do_parity_delta: bool
    to_read: dict[int, ExtentSet] = field(default_factory=dict)
    to_write: dict[int, ExtentSet] = field(default_factory=dict)

    def read_bytes(self) -> int:
        return sum(es.size() for es in self.to_read.values())


def plan_write(
    sinfo: StripeInfo,
    flags: Flag,
    ro_offset: int,
    length: int,
    object_size: int,
) -> WritePlan:
    """Choose the write strategy (ECTransaction.cc:77-79 decision).

    Costs, in bytes read from the backend:
    - full-stripe: the UNWRITTEN data-shard extents of every touched
      stripe (so parity can be re-encoded from complete stripes);
    - parity-delta: the OLD values of written data extents plus the
      old parity extents (delta = old XOR new; parity' = parity XOR
      G·delta).
    Parity-delta additionally requires the codec's
    PARITY_DELTA_OPTIMIZATION flag (jerasure matrix/ISA families).
    Reads beyond current object size are elided (absent bytes are
    zero by the zero-padding convention).
    """
    touched = sinfo.ro_range_to_shard_extent_set(ro_offset, length, parity=True)
    to_write = {s: es.align(4096) for s, es in touched.items()}
    if flags & Flag.PARITY_DELTA_CHUNK_GRANULARITY:
        # packet-layout codes scatter a sub-chunk write's parity
        # update across the whole chunk: parity reads/writes must
        # cover whole chunks so the delta driver can hand the codec
        # chunk-shaped windows with the old parity present. Align to
        # the CHUNK, exactly the widening encode_parity_delta applies
        # — max(chunk, page) only coincides with chunk boundaries
        # when chunk is a page multiple (a sub-page liberation chunk
        # like 1792 would leave the widened window's old parity
        # unread and zero-filled: silent corruption).
        to_write = {
            s: (
                es.align(sinfo.chunk_size)
                if sinfo.is_parity_shard(s) else es
            )
            for s, es in to_write.items()
        }

    def clip_to_stored(shard: int, es: ExtentSet) -> ExtentSet:
        stored = sinfo.object_size_to_shard_size(object_size, shard)
        out = ExtentSet()
        for s, e in es:
            if s < stored:
                out.insert(s, min(e, stored) - s)
        return out

    # Subtract only the bytes the client actually overwrites (the
    # UNALIGNED extents): a sub-page boundary still needs its old bytes
    # read so the re-encode and the page write both see them — aligned
    # extents here once dropped boundary bytes, encoding zeros into
    # parity while the store kept the old data (silent corruption).
    data_written = {
        s: es for s, es in touched.items() if sinfo.is_data_shard(s)
    }

    # Full-stripe read set: the PAGE window of the write minus what we
    # overwrite. The window must be the page-aligned to_write hull, not
    # the chunk hull: the encode pads to pages, so a parity page covers
    # every stripe inside it — with chunk_size < page that reaches
    # stripes the chunk hull misses, and encoding them without their
    # old data would zero them into parity (silent corruption).
    full_read: dict[int, ExtentSet] = {}
    lo = min(es.range_start() for es in to_write.values())
    hi = max(es.range_end() for es in to_write.values())
    for raw in range(sinfo.k):
        shard = sinfo.get_shard(raw)
        hull = ExtentSet([(lo, hi)])
        need = hull.difference(data_written.get(shard, ExtentSet()))
        need = clip_to_stored(shard, need)
        if need:
            full_read[shard] = need

    # Parity-delta read set: old data under the written extents + parity.
    delta_read: dict[int, ExtentSet] = {}
    for shard, es in to_write.items():
        need = clip_to_stored(shard, es)
        if need:
            delta_read[shard] = need

    full = WritePlan(False, full_read, to_write)
    if not (flags & Flag.PARITY_DELTA_OPTIMIZATION):
        return full
    delta = WritePlan(True, delta_read, to_write)
    # Nothing stored yet -> both read nothing; full-stripe encode is the
    # degenerate winner (no old parity to delta against).
    if not delta_read or all(
        sinfo.is_parity_shard(s) and not clip_to_stored(s, es)
        for s, es in delta_read.items()
    ):
        return full
    # tie goes to delta: it touches only the written chunks' pages,
    # where full-stripe re-encode rewrites every parity page
    return delta if delta.read_bytes() <= full.read_bytes() else full


class ClientOp:
    """One in-flight client write (the RMWPipeline::Op analog)."""

    def __init__(
        self,
        tid: int,
        oid: str,
        ro_offset: int,
        data: bytes,
        on_commit: Callable[["ClientOp"], None] | None,
    ) -> None:
        self.tid = tid
        self.oid = oid
        self.ro_offset = ro_offset
        self.data = data
        self.on_commit = on_commit
        self.plan: WritePlan | None = None
        self.cache_op: CacheOp | None = None
        self.pending_shards: set[int] = set()
        self.acked_shards: set[int] = set()
        self.extra_attrs: "dict[str, bytes] | None" = None
        self.written: "ShardExtentMap | None" = None
        self.committed = False
        self.notified = False
        self.error: Exception | None = None
        self.t_submit: float | None = None
        #: perf_counter stamp of waiting_for_subops
        self.t_subops: float | None = None
        #: live-op handle (dump_ops_in_flight): queued -> dispatched
        #: -> waiting_for_subops -> committed -> done
        self.tracked = NULL_OP


class ShardBackend:
    """Dispatch boundary for per-shard sub-ops (the MOSDECSubOpWrite/
    Read fan-out seam). The local implementation writes straight into
    per-shard MemStores; the distributed layer substitutes messengers.

    ``defer_acks``/``defer_reads``: tests set these to capture callbacks
    and release them out of order, exercising the in-order queues.
    ``down_shards``/``fail_read_shards``: availability + EIO injection
    (the ECInject seam — reads from those shards error).
    """

    def __init__(self, stores: dict[int, "object"]) -> None:
        self.stores = stores
        self.defer_acks = False
        self.deferred: list[tuple[int, Callable[[], None]]] = []
        self.down_shards: set[int] = set()
        self.fail_read_shards: set[int] = set()
        self.defer_reads = False
        self.deferred_reads: list[tuple[int, Callable[[], None]]] = []

    def avail_shards(self) -> set[int]:
        """Shards the read planner may target (acting-set analog)."""
        return set(self.stores) - self.down_shards

    def read_shard_async(
        self,
        shard: int,
        oid: str,
        extents: ExtentSet,
        cb: Callable[[int, "dict[int, bytes] | Exception"], None],
    ) -> None:
        """Sub-read fan-out seam (ECSubRead → handle_sub_read). Calls
        ``cb(shard, {offset: bytes})`` or ``cb(shard, ShardReadError)``.
        Consults the ECInject registry the way handle_sub_read does."""
        from .inject import ec_inject
        from .read import ShardReadError

        def run() -> None:
            if shard in self.fail_read_shards or shard in self.down_shards:
                cb(shard, ShardReadError(shard, oid))
            elif ec_inject.test_read_error0(oid, shard):
                cb(shard, ShardReadError(shard, oid, kind="eio"))
            elif ec_inject.test_read_error1(oid, shard):
                cb(shard, ShardReadError(shard, oid, kind="missing"))
            else:
                try:
                    cb(shard, self.read_shard(shard, oid, extents))
                except Exception:
                    # store-level EIO (e.g. a BlockStore csum failure)
                    # answers as a shard error — the reference's
                    # handle_sub_read returns -EIO, it never tears the
                    # connection down (ECBackend.cc:998)
                    cb(shard, ShardReadError(shard, oid, kind="eio"))

        if self.defer_reads:
            self.deferred_reads.append((shard, run))
        else:
            run()

    def release_deferred_reads(self, order: list[int] | None = None) -> None:
        pending = self.deferred_reads
        self.deferred_reads = []
        if order is not None:
            pending = sorted(
                pending, key=lambda t: order.index(t[0]) if t[0] in order else 99
            )
        for _, run in pending:
            run()

    def read_shard(self, shard: int, oid: str, extents: ExtentSet) -> dict[int, bytes]:
        from .inject import ec_inject

        store = self.stores[shard]
        out = {}
        for start, end in extents:
            try:
                buf = store.read(oid, start, end - start)
            except FileNotFoundError:
                buf = b""
            buf = buf + b"\0" * (end - start - len(buf))  # zero-pad EOF
            out[start] = buf
        if ec_inject.test_read_error2(oid, shard):
            # ECInject read type 2: the payload leaves here silently
            # corrupted — only an integrity tier may notice
            out = {
                start: ec_inject.corrupt(buf)
                for start, buf in out.items()
            }
        return out

    def submit_shard_txn(
        self, shard: int, txn: Transaction, ack: Callable[[], None]
    ) -> None:
        from .inject import ec_inject

        oid = txn.oids()[0] if txn.oids() else ""
        if ec_inject.test_write_error3(oid, exact=True):
            # ECInject write type 3: the receiving OSD aborts in
            # handle_sub_write (ECBackend.cc:922-926). In-process
            # analog: the shard's OSD dies — nothing applies, no ack,
            # and the shard drops out of the acting set. Exact-oid
            # consult: at the daemon tier this hop sees per-shard
            # store keys and the daemon already consulted the rule
            # under the base oid — matching here too would decrement
            # when/duration twice per op.
            self.down_shards.add(shard)
            return
        if ec_inject.test_write_error1(oid, shard):
            return  # sub-write silently dropped: ack never arrives
        self.stores[shard].queue_transactions(txn)
        if self.defer_acks:
            self.deferred.append((shard, ack))
        else:
            ack()

    def release_deferred(self, order: list[int] | None = None) -> None:
        pending = self.deferred
        self.deferred = []
        if order is not None:
            pending = sorted(
                pending, key=lambda t: order.index(t[0]) if t[0] in order else 99
            )
        for _, ack in pending:
            ack()


class RMWPipeline:
    """start_rmw → cache → encode → sub-writes → in-order commit."""

    def __init__(
        self,
        sinfo: StripeInfo,
        codec,
        backend: ShardBackend,
        cache_lines: int | None = None,
        perf_name: str = "ec_rmw",
        pglog=None,
    ) -> None:
        self.pglog = pglog
        self.sinfo = sinfo
        self.codec = codec
        self.backend = backend
        #: csum-block granularity for the fused encode+checksum path
        #: (matches the stores' BlueStore-analog default); the encode
        #: dispatch emits per-block crc32c for all k+m shards at this
        #: granularity and sub-writes carry them to the stores
        from ceph_tpu_torch.utils import config as _config

        self.csum_block = int(_config.get("csum_block_size"))
        if cache_lines is None:
            from ceph_tpu_torch.utils import config

            cache_lines = config.get("ec_extent_cache_lines")
        self.cache = ECExtentCache(sinfo, self._backend_read, cache_lines)
        self._next_tid = 1
        self._inflight: "OrderedDict[int, ClientOp]" = OrderedDict()
        self._object_sizes: dict[str, int] = {}
        #: size as of the LAST SUBMITTED op (dispatch updates
        #: _object_sizes later): decisions made at submit time about
        #: a racing in-flight op's outcome — the truncate boundary
        #: re-encode — must use the projected view, not the
        #: dispatch-time one
        self._projected_sizes: dict[str, int] = {}
        self._hinfo: dict[str, HashInfo] = {}
        #: current map epoch, stamped (with the op tid) into every
        #: write's OI attr as the object's eversion; the owning daemon
        #: refreshes it on map change
        self.epoch = 0
        self._eversions: dict[str, tuple[int, int]] = {}
        #: stamps recorded by writes THIS pipeline instance performed
        #: (never seeded from stored attrs): the only eversions strong
        #: enough to anchor a scrub election — a cold-boot attr may
        #: itself be divergent
        self._live_eversions: dict[str, tuple[int, int]] = {}
        #: oid -> backend-read failure awaiting its op (degraded RMW
        #: read failed; the op aborts in _cache_ready, in order)
        self._read_errors: dict[str, Exception] = {}
        #: ECInject write-type-2 seam: the owning daemon points this at
        #: its "mark me down" mon command (ECBackend.cc:1158-1167);
        #: standalone pipelines leave it None
        self.on_osd_down_inject: Callable[[], None] | None = None
        #: the owning OSD daemon (None for standalone pipelines) —
        #: crash points fire with it so osd= filters and the ``kill``
        #: action resolve; never otherwise consulted
        self.owner = None
        #: serializes ack/commit bookkeeping: sub-write acks arrive on
        #: messenger pump threads while map changes release dead
        #: shards' acks from the monitor-notify thread — both mutate
        #: pending_shards/_inflight. Reentrant: a local synchronous
        #: dispatch acks inside submit, and on_commit may re-enter.
        self._ack_lock = DebugRLock("rmw.ack")
        from ceph_tpu_torch.utils import PerfCountersBuilder, perf_collection

        self.perf = (
            PerfCountersBuilder(perf_collection, perf_name)
            .add_u64_counter("write_ops", "client writes submitted")
            .add_u64_counter("write_bytes", "client bytes written")
            .add_u64_counter("parity_delta_ops", "writes via parity delta")
            .add_u64_counter("full_stripe_ops", "writes via full re-encode")
            .add_u64_counter("aborts", "writes failed before dispatch")
            .add_avg("commit_lat", "submit-to-commit seconds")
            .add_u64_counter(
                "committed", "writes whose sub-writes all acked"
            )
            .add_time(
                "subop_wait_s",
                "seconds from waiting_for_subops to committed, summed",
            )
            .create_perf_counters()
        )

    def on_interval_change(self) -> None:
        """Drop every in-memory projection of object state (sizes,
        eversions, hinfo, cached extents) — PG::on_change. While this
        daemon was NOT the serving primary, its STORE advanced through
        the replica sub-write role, which never updates these caches:
        a re-elected ex-primary serving from them computed append
        offsets from its last primacy's sizes and tore the log the
        interim primary had extended (round-5 kill/revive thrash
        find). The next op re-primes from the store's OI/HashInfo
        attrs.

        In-flight ops of the OLD interval are REQUEUED-as-errors (the
        reference requeues them into the new interval and the client
        resend dedups via reqid): their sub-writes are fenced at the
        members — `committed=False`, no ack ever — so leaving them
        parked wedges the per-object cache FIFO, and every new-interval
        op on the object queues behind the corpse forever (the
        kill × net_flaky composition found the wedge: a live,
        re-elected primary kept its own fenced op parked, stalling the
        coalesce drain for the whole worker). Completing them with the
        retryable interval error releases the cache; the resend
        re-runs them against the new interval's election."""
        stale: list[ClientOp] = []
        with self._ack_lock:
            self._object_sizes.clear()
            self._projected_sizes.clear()
            self._eversions.clear()
            self._live_eversions.clear()
            self._hinfo.clear()
            for op in self._inflight.values():
                if not op.committed and op.written is not None:
                    # dispatched (sub-writes on the wire, fenceable);
                    # un-dispatched ops still ride the cache queue and
                    # will dispatch -> fence -> ... so requeue them on
                    # their dispatch instead: leave them be
                    op.error = IOError(
                        "interval changed - op requeued for resend"
                    )
                    op.committed = True
                    op.tracked.mark_event("interval_fenced")
                    self.perf.inc("aborts")
                    stale.append(op)
            self.cache.on_change()
        # cache release outside the lock (the write_done may cascade);
        # a requeued op publishes an EMPTY map like any failed op
        for op in stale:
            self.cache.write_done(op.cache_op, ShardExtentMap(self.sinfo))
        with self._ack_lock:
            self._check_commit_order()

    def _track(self, op: ClientOp, kind: str) -> None:
        """Register the op with the live tracker under the OWNING
        daemon's name (pipeline-grade perf names collapse to osd.N);
        the commit-order pop finishes it."""
        op.tracked = op_tracker.register(
            kind,
            daemon=(
                f"osd.{self.owner.osd_id}" if self.owner is not None
                else self.perf.name
            ),
            oid=op.oid, tid=op.tid,
        )
        op.tracked.mark_event("queued")

    # -- client entry (ECBackend::submit_transaction analog) -----------
    def submit(
        self,
        oid: str,
        ro_offset: int,
        data: bytes,
        on_commit: Callable[[ClientOp], None] | None = None,
        extra_attrs: "dict[str, bytes] | None" = None,
    ) -> int:
        """``extra_attrs`` ride every shard txn of this op (the
        daemon's replicated reqid-dedup window travels here, so a
        resend after primary failover can be replayed instead of
        re-applied — the pg-log reqid role)."""
        op = ClientOp(self._next_tid, oid, ro_offset, bytes(data), on_commit)
        op.extra_attrs = dict(extra_attrs) if extra_attrs else None
        op.t_submit = time.perf_counter()
        self._next_tid += 1
        self._inflight[op.tid] = op
        self._track(op, "rmw_write")
        self.perf.inc("write_ops")
        self.perf.inc("write_bytes", len(data))

        if not data:
            # Zero-length write: a no-op that still commits in order
            # (plan_write has no extents to plan over).
            op.committed = True
            self._check_commit_order()
            return op.tid

        from .inject import ec_inject

        if ec_inject.test_write_error0(oid):
            # Injected client-write abort (ECInject write type 0): the
            # op completes in order with an error, nothing dispatches.
            op.error = IOError(f"injected write error on {oid!r}")
            op.committed = True
            self.perf.inc("aborts")
            self._check_commit_order()
            return op.tid

        self._projected_sizes[oid] = max(
            self._projected_sizes.get(
                oid, self._object_sizes.get(oid, 0)
            ),
            ro_offset + len(data),
        )
        with tracer.span("ec_write", oid=oid, tid=op.tid, bytes=len(data)):
            object_size = self._object_sizes.get(oid, 0)
            op.plan = plan_write(
                self.sinfo,
                self.codec.get_flags(),
                ro_offset,
                len(data),
                object_size,
            )
            self.perf.inc(
                "parity_delta_ops" if op.plan.do_parity_delta
                else "full_stripe_ops"
            )
            op.cache_op = self.cache.prepare(
                oid,
                op.plan.to_read,
                op.plan.to_write,
                object_size,
                lambda cop, _op=op: self._cache_ready(_op),
            )
            self.cache.execute([op.cache_op])
        return op.tid

    def submit_remove(
        self,
        oid: str,
        on_commit: Callable[[ClientOp], None] | None = None,
    ) -> int:
        """Whole-object remove, ordered through the same per-object
        cache FIFO as writes (a remove racing an in-flight write must
        apply after it) and journaled in the pg log so a down shard
        cannot resurrect the object on recovery."""
        self._projected_sizes.pop(oid, None)
        op = ClientOp(self._next_tid, oid, 0, b"", on_commit)
        op.t_submit = time.perf_counter()
        self._next_tid += 1
        self._inflight[op.tid] = op
        self._track(op, "rmw_remove")

        def dispatch(cop, _op=op) -> None:
            try:
                live = set(self.backend.avail_shards())
                if self.pglog is not None:
                    self.pglog.append_delete(_op.tid, oid)
                _op.tracked.mark_event(
                    "waiting_for_subops", n=len(live)
                )
                _op.pending_shards = set(live)
                _op.written = ShardExtentMap(self.sinfo)
                self._object_sizes.pop(oid, None)
                self._hinfo.pop(oid, None)
                self._eversions.pop(oid, None)
                self._live_eversions.pop(oid, None)
                for shard in sorted(live):
                    # touch+remove: no-op on shards that never got the
                    # object (a hole at write time)
                    self.backend.submit_shard_txn(
                        shard,
                        Transaction().touch(oid).remove(oid),
                        lambda s=shard, o=_op: self._shard_ack(o, s),
                    )
            except Exception as e:
                self._abort_op(_op, e)

        op.cache_op = self.cache.prepare(oid, {}, {}, 0, dispatch)
        self.cache.execute([op.cache_op])
        return op.tid

    def submit_truncate(
        self,
        oid: str,
        new_size: int,
        on_commit: Callable[[ClientOp], None] | None = None,
        extra_attrs: "dict[str, bytes] | None" = None,
    ) -> int:
        """rados_trunc: resize the object, ordered through the
        per-object cache FIFO like writes. Shrink cuts every shard at
        its exact size (the zero-padding convention must be REAL: a
        later extend-write elides reads past the recorded size, so
        stale tail bytes would silently corrupt parity) and clears the
        cumulative HashInfo like an overwrite; grow just raises the
        recorded size — the gap reads as zeros, rados' hole
        semantics. The pg log journals the cut region so a down shard
        replays it (survivors decode the zero-padded tail to zeros).

        A ragged shrink first writes ZEROS over the boundary stripe's
        tail through the normal RMW path: parity still encodes the
        old bytes there, and cutting the data shards without
        re-encoding would leave the stripe inconsistent (a degraded
        read would decode the pre-truncate content back to life)."""
        old_size_now = self._projected_sizes.get(
            oid, self._object_sizes.get(oid, 0)
        )
        if new_size < old_size_now:
            sw = self.sinfo.stripe_width
            boundary_end = min(-(-new_size // sw) * sw, old_size_now)
            if boundary_end > new_size:
                self.submit(
                    oid, new_size, b"\0" * (boundary_end - new_size)
                )
        # the projection lands AFTER the boundary zero-write's own
        # submit raised it — the post-truncate size is the cut
        self._projected_sizes[oid] = new_size
        op = ClientOp(self._next_tid, oid, 0, b"", on_commit)
        op.t_submit = time.perf_counter()
        self._next_tid += 1
        self._inflight[op.tid] = op
        self._track(op, "rmw_truncate")
        sinfo = self.sinfo

        def dispatch(cop, _op=op) -> None:
            try:
                live = set(self.backend.avail_shards())
                if len(live) < sinfo.k:
                    raise IOError(
                        f"only {len(live)} shards available, need {sinfo.k}"
                    )
                old_size = self._object_sizes.get(oid, 0)
                self._object_sizes[oid] = new_size
                ev = (self.epoch, _op.tid)
                self._eversions[oid] = ev
                self._live_eversions[oid] = ev
                hinfo = self._get_hinfo(oid)
                if new_size < old_size:
                    hinfo.clear()
                hinfo_bytes = hinfo.to_bytes()
                cut: dict[int, ExtentSet] = {}
                txns: list[tuple[int, Transaction]] = []
                for raw in range(sinfo.k + sinfo.m):
                    shard = sinfo.get_shard(raw)
                    new_exact = sinfo.object_size_to_exact_shard_size(
                        new_size, shard
                    )
                    old_exact = sinfo.object_size_to_exact_shard_size(
                        old_size, shard
                    )
                    if old_exact > new_exact:
                        cut[shard] = ExtentSet(
                            [(new_exact, old_exact)]
                        )
                    txn = self._stamp_identity(
                        Transaction().touch(oid).truncate(oid, new_exact),
                        oid, shard, new_size, ev, hinfo_bytes,
                        extra_attrs,
                    )
                    txns.append((shard, txn))
                if self.pglog is not None:
                    # identity attrs journal WITH the cut: a shard
                    # down for a grow (cut == {}) still replays the
                    # new size, or a later takeover on it would clip
                    # the object back to the pre-truncate length
                    self.pglog.append(
                        _op.tid, oid, cut, epoch=self.epoch,
                        xattrs=self._journal_attrs(
                            new_size, ev, hinfo_bytes, extra_attrs
                        ),
                    )
                # stale tail content must leave the cache before any
                # later op snapshots it
                self.cache.invalidate_object(oid)
                _op.tracked.mark_event(
                    "waiting_for_subops", n=len(live)
                )
                _op.pending_shards = set(live)
                _op.written = ShardExtentMap(sinfo)
                for shard, txn in txns:
                    if shard not in live:
                        continue  # hole: journaled; recovered later
                    self.backend.submit_shard_txn(
                        shard, txn,
                        lambda s=shard, o=_op: self._shard_ack(o, s),
                    )
            except Exception as e:
                self._abort_op(_op, e)

        op.cache_op = self.cache.prepare(oid, {}, {}, 0, dispatch)
        self.cache.execute([op.cache_op])
        return op.tid

    def submit_attr_updates(
        self,
        oid: str,
        updates: "dict[str, bytes | None]",
        on_commit: Callable[[ClientOp], None] | None = None,
    ) -> int:
        """Replicated-attr mutations (value None = remove), ordered
        through the per-object cache FIFO like writes/removes and
        journaled in the pg log so a down shard replays them on
        return. Keys are FULL attr names (callers prefix: ``u:`` for
        user xattrs, ``m:`` for omap entries) so identity attrs never
        collide and one batch may mix namespaces."""
        op = ClientOp(self._next_tid, oid, 0, b"", on_commit)
        op.t_submit = time.perf_counter()
        self._next_tid += 1
        self._inflight[op.tid] = op
        self._track(op, "rmw_attrs")
        updates = dict(updates)

        def dispatch(cop, _op=op) -> None:
            try:
                live = set(self.backend.avail_shards())
                if self.pglog is not None:
                    self.pglog.append_xattrs(_op.tid, oid, updates)
                _op.tracked.mark_event(
                    "waiting_for_subops", n=len(live)
                )
                _op.pending_shards = set(live)
                _op.written = ShardExtentMap(self.sinfo)
                for shard in sorted(live):
                    txn = Transaction().touch(oid)
                    for key, value in sorted(updates.items()):
                        if value is None:
                            txn.rmattr(oid, key, ignore_missing=True)
                        else:
                            txn.setattr(oid, key, value)
                    self.backend.submit_shard_txn(
                        shard, txn,
                        lambda s=shard, o=_op: self._shard_ack(o, s),
                    )
            except Exception as e:
                self._abort_op(_op, e)

        op.cache_op = self.cache.prepare(oid, {}, {}, 0, dispatch)
        self.cache.execute([op.cache_op])
        return op.tid

    def submit_setxattr(
        self,
        oid: str,
        name: str,
        value: "bytes | None",
        on_commit: Callable[[ClientOp], None] | None = None,
    ) -> int:
        """User-xattr mutation (the ``u:`` namespace convenience)."""
        return self.submit_attr_updates(
            oid, {"u:" + name: value}, on_commit
        )

    def object_size(self, oid: str) -> int:
        return self._object_sizes.get(oid, 0)

    def forget_object(self, oid: str) -> None:
        """Drop all in-memory per-object state — the peering
        divergent-create removal path: the object never existed in
        authoritative history, so no trace of the divergent stamps
        may survive to answer later authority lookups."""
        self._object_sizes.pop(oid, None)
        self._hinfo.pop(oid, None)
        self._eversions.pop(oid, None)
        self._live_eversions.pop(oid, None)

    def object_eversion(self, oid: str) -> tuple[int, int] | None:
        """Last known (epoch, tid) stamp — may come from a stored
        attr (prime_object); use live_eversion when trust matters."""
        return self._eversions.get(oid)

    def live_eversion(self, oid: str) -> tuple[int, int] | None:
        """(epoch, tid) of a write THIS pipeline performed; None for
        state only known from stored attrs."""
        return self._live_eversions.get(oid)

    def prime_object(
        self, oid: str, size: int, hinfo: HashInfo | None = None,
        eversion: tuple[int, int] | None = None,
    ) -> None:
        """Seed per-object state recovered from stored attrs (OI_KEY /
        HINFO_KEY) — the new-primary takeover path: a freshly elected
        primary must not assume unknown objects are empty."""
        self._object_sizes[oid] = size
        if hinfo is not None:
            self._hinfo[oid] = hinfo
        if eversion is not None and eversion != (0, 0):
            self._eversions[oid] = eversion

    def hinfo(self, oid: str) -> HashInfo | None:
        return self._hinfo.get(oid)

    # -- pipeline stages ------------------------------------------------
    def _backend_read(self, oid: str, want: dict[int, ExtentSet]) -> None:
        """Fetch old data for an RMW. When a wanted shard is down its
        old bytes are reconstructed from a MINIMAL survivor set — the
        same planner + decode the degraded client read uses
        (get_min_avail_to_read_shards / objects_read_and_reconstruct,
        osd/ECBackend.cc:1725). Failures never propagate: the error is
        parked for ``_cache_ready`` to abort the op in order."""
        from .read import get_min_avail_to_read_shards

        smap = ShardExtentMap(self.sinfo)
        try:
            avail = set(self.backend.avail_shards())
            holes = {s for s in want if s not in avail}
            reads, need_decode = get_min_avail_to_read_shards(
                self.sinfo, self.codec, want, avail
            )
            for sr in reads.values():
                for start, buf in self.backend.read_shard(
                    sr.shard, oid, sr.extents
                ).items():
                    smap.insert(sr.shard, start, buf)
            if need_decode:
                smap.decode(
                    self.codec, holes, self._object_sizes.get(oid, 0)
                )
        except Exception as e:
            self._read_errors[oid] = e
        self.cache.read_done(oid, smap)

    def _abort_op(self, op: ClientOp, err: Exception) -> None:
        """Fail an op cleanly AFTER it entered the cache: release the
        cache op (else its pinned lines wedge every later write to the
        object) and complete in order with the error."""
        op.error = err
        op.committed = True
        op.tracked.mark_event("aborted", err=type(err).__name__)
        self.perf.inc("aborts")
        if op.cache_op is not None and op.written is None:
            self.cache.write_done(op.cache_op, ShardExtentMap(self.sinfo))
        self._check_commit_order()

    def _cache_ready(self, op: ClientOp) -> None:
        """Old data present — encode and generate per-shard transactions
        (the cache_ready → generate_transactions hop, ECCommon.cc:688).
        Any failure in here (degraded read couldn't reconstruct, codec
        error) aborts the op in order instead of wedging the pipeline."""
        err = self._read_errors.pop(op.oid, None)
        if err is not None:
            self._abort_op(op, err)
            return
        op.tracked.mark_event("cache_ready")
        try:
            self._cache_ready_inner(op)
        except Exception as e:
            self._abort_op(op, e)

    def _cache_ready_inner(self, op: ClientOp) -> None:
        sinfo = self.sinfo
        old_map = op.cache_op.result
        old_size = self._object_sizes.get(op.oid, 0)
        new_size = max(old_size, op.ro_offset + len(op.data))

        new_map = ShardExtentMap(sinfo)
        pos = op.ro_offset
        data = np.frombuffer(op.data, dtype=np.uint8)
        taken = 0
        with tracer.timer("ec_stage"), new_map.tally(len(op.data)):
            while taken < len(op.data):
                chunk_index = pos // sinfo.chunk_size
                raw = chunk_index % sinfo.k
                in_chunk = pos % sinfo.chunk_size
                take = min(sinfo.chunk_size - in_chunk, len(op.data) - taken)
                shard_off = (
                    (chunk_index // sinfo.k) * sinfo.chunk_size + in_chunk
                )
                new_map.insert(
                    sinfo.get_shard(raw), shard_off,
                    data[taken : taken + take],
                )
                pos += take
                taken += take

        hinfo = self._get_hinfo(op.oid)
        hashed = hinfo.get_total_chunk_size()
        append_base = None
        if op.plan.do_parity_delta:
            new_map.encode_parity_delta(self.codec, old_map)
            hinfo.clear()  # overwrite invalidates cumulative shard crcs
        else:
            # merge old data under the new so parity encodes full stripes
            with tracer.timer("ec_stage"):
                for shard in old_map.shards():
                    if not sinfo.is_data_shard(shard):
                        continue
                    for start, end in old_map.get_extent_set(shard):
                        gap = ExtentSet([(start, end)]).difference(
                            new_map.get_extent_set(shard)
                        )
                        for s, e in gap:
                            new_map.insert(
                                shard, s, old_map.get(shard, s, e - s)
                            )
            lo, _hi = new_map.ro_range()
            if lo == hashed:
                append_base = hashed
            if append_base is not None:
                new_map.encode(
                    self.codec, hinfo, old_size=append_base,
                    csum_block=self.csum_block,
                )
            else:
                # not a contiguous append: cumulative crcs can't be
                # extended — invalidate (deep scrub then skips them)
                new_map.encode(self.codec, csum_block=self.csum_block)
                if hashed:
                    hinfo.clear()

        # size publishes BEFORE the dispatch: synchronous sub-write
        # acks can complete this op and cascade the NEXT queued op's
        # dispatch from inside _generate_transactions — assigning
        # afterwards would clobber whatever that nested op set (a
        # truncate queued behind a write lost its cut this way). On
        # dispatch failure the op aborts, so the size rolls back.
        prev = self._object_sizes.get(op.oid)
        self._object_sizes[op.oid] = new_size
        try:
            self._generate_transactions(op, new_map, new_size)
        except BaseException:
            if prev is None:
                self._object_sizes.pop(op.oid, None)
            else:
                self._object_sizes[op.oid] = prev
            raise
        self._eversions[op.oid] = (self.epoch, op.tid)
        self._live_eversions[op.oid] = (self.epoch, op.tid)

    def _get_hinfo(self, oid: str) -> HashInfo:
        if oid not in self._hinfo:
            self._hinfo[oid] = HashInfo(
                self.sinfo.k + self.sinfo.m, self.codec.device
            )
        return self._hinfo[oid]

    def _generate_transactions(
        self, op: ClientOp, result: ShardExtentMap, new_size: int
    ) -> None:
        """Emit one Transaction per shard (ECTransaction.cc:916): the
        shard's written extents, a truncate to the new shard size, and
        the refreshed hinfo attr (ECTransaction.cc:497,902)."""
        sinfo = self.sinfo
        hinfo_bytes = self._get_hinfo(op.oid).to_bytes()
        # Dispatch to LIVE shards only: an acting-set hole (down OSD)
        # does not block the write — its extents are journaled in the
        # pg log for delta recovery when the shard returns (the
        # reference commits on the acting set, not k+m). Floor: k live
        # shards (min_size), else the object could become unreadable.
        live = set(self.backend.avail_shards())
        if len(live) < sinfo.k:
            # raises into _cache_ready's wrapper -> clean in-order abort
            raise IOError(
                f"only {len(live)} shards available, need {sinfo.k}"
            )
        op.pending_shards = set(live)
        written = ShardExtentMap(sinfo)
        op.written = written
        txns: list[tuple[int, Transaction]] = []
        for raw in range(sinfo.k + sinfo.m):
            shard = sinfo.get_shard(raw)
            txn = Transaction().touch(op.oid)
            shard_size = sinfo.object_size_to_shard_size(new_size, shard)
            for start, end in result.get_extent_set(shard):
                end = min(end, shard_size)
                if end <= start:
                    continue
                with tracer.timer("ec_stage"):
                    buf = bytes(result.get(shard, start, end - start))
                    written.insert(
                        shard, start, np.frombuffer(buf, np.uint8)
                    )
                # fused-kernel csums ride the sub-write when they
                # describe this exact range (block-aligned within the
                # encode window) — the store adopts them instead of
                # re-hashing the bytes it just received
                blk = result.csums_for(shard, start, end - start)
                if blk is not None:
                    txn.write(
                        op.oid, start, buf, csums=blk,
                        csum_block=result.csums["block"],
                    )
                else:
                    txn.write(op.oid, start, buf)
            self._stamp_identity(
                txn, op.oid, shard, new_size,
                (self.epoch, op.tid), hinfo_bytes, op.extra_attrs,
            )
            txns.append((shard, txn))
        if self.pglog is not None:
            # OI/HINFO ride every entry so the xattr-replay's merged
            # final state never regresses them to an older op's
            # values (a truncate's journaled size must not outlive a
            # later write's)
            self.pglog.append(
                op.tid,
                op.oid,
                {s: written.get_extent_set(s) for s in written.shards()},
                epoch=self.epoch,
                xattrs=self._journal_attrs(
                    new_size, (self.epoch, op.tid), hinfo_bytes,
                    op.extra_attrs,
                ),
            )
        op.tracked.mark_event(
            "encoded",
            strategy="delta" if op.plan.do_parity_delta else "full",
        )
        # crash point: plan chosen, stripe encoded, pg log appended —
        # nothing on the wire yet. A kill here loses the op entirely
        # (no shard saw it); the client's resend re-runs it whole.
        crash_points.fire(
            "rmw.prepare_done", daemon=self.owner, oid=op.oid,
            tid=op.tid,
        )
        op.tracked.mark_event("waiting_for_subops", n=len(live))
        op.t_subops = time.perf_counter()
        # build every txn before the first dispatch: a synchronous ack
        # (local stores) must see the complete written map
        for shard, txn in txns:
            if shard not in live:
                continue  # hole: journaled above, recovered later
            self.backend.submit_shard_txn(
                shard, txn, lambda s=shard, o=op: self._shard_ack(o, s)
            )


    # -- shared identity plumbing (write + truncate txns) --------------
    @staticmethod
    def _stamp_identity(
        txn: Transaction, oid: str, shard: int, size: int,
        ev: "tuple[int, int]", hinfo_bytes: bytes,
        extra_attrs: "dict[str, bytes] | None",
    ) -> Transaction:
        """The per-shard identity-attr suffix every mutating txn
        carries — ONE implementation so the write and truncate paths
        cannot diverge (OI/HINFO/SI plus caller extras like the
        replicated reqid window)."""
        txn.setattr(oid, HINFO_KEY, hinfo_bytes)
        txn.setattr(oid, OI_KEY, pack_oi(size, ev))
        txn.setattr(oid, SI_KEY, str(shard).encode())
        for aname, aval in (extra_attrs or {}).items():
            txn.setattr(oid, aname, aval)
        return txn

    @staticmethod
    def _journal_attrs(
        size: int, ev: "tuple[int, int]", hinfo_bytes: bytes,
        extra_attrs: "dict[str, bytes] | None",
    ) -> "dict[str, bytes]":
        """The xattrs journaled with each entry so a shard that missed
        the op replays the SAME identity state the txns carried —
        including the reqid window (a recovered shard that later hosts
        the primary must not lose failover dedup)."""
        return {
            OI_KEY: pack_oi(size, ev),
            HINFO_KEY: hinfo_bytes,
            **(extra_attrs or {}),
        }

    def _shard_ack(self, op: ClientOp, shard: int) -> None:
        finish = False
        with self._ack_lock:
            if len(op.pending_shards) == 1 and shard in op.pending_shards:
                # final sub-write reply for this op: the reference
                # consults ECInject write type 2 here (pending_commits
                # == 1 in handle_sub_write_reply, ECBackend.cc:1158-
                # 1167) and, if armed, has the primary mark ITSELF
                # down via mon command. Hook check FIRST: where no
                # down-hook exists the armed rule must not be consumed
                # to no effect.
                from .inject import ec_inject

                if self.on_osd_down_inject is not None and (
                    ec_inject.test_write_error2(op.oid)
                ):
                    self.on_osd_down_inject()
            if self.pglog is not None:
                self.pglog.ack(shard, op.tid)
            op.pending_shards.discard(shard)
            op.acked_shards.add(shard)
            op.tracked.mark_event("subop_ack", shard=shard)
            if not op.pending_shards and not op.committed:
                # crash point: every sub-write durable on its shard,
                # the commit decision not yet taken. A kill here is
                # the fully-applied-but-unreported crash: replay must
                # ROLL FORWARD (all shards agree) and the client's
                # resend dedup via the replicated reqid window.
                crash_points.fire(
                    "rmw.primary_before_commit", daemon=self.owner,
                    oid=op.oid, tid=op.tid,
                )
                op.committed = True
                op.tracked.mark_event("committed")
                if op.t_subops is not None:
                    self.perf.add_many((
                        ("committed", 1),
                        ("subop_wait_s", time.perf_counter() - op.t_subops),
                    ))
                finish = True
        # cache release OUTSIDE the ack lock: write_done may dispatch
        # the next queued op for this object, whose RMW backend read
        # blocks on the messenger — IO must never run under _ack_lock
        # (ABBA with the reply-pump thread's _shard_ack)
        if finish:
            self.cache.write_done(op.cache_op, op.written)
            with self._ack_lock:
                self._check_commit_order()

    def on_shard_down(self, shard: int) -> None:
        """An acting member died with sub-write acks outstanding: those
        acks will never arrive. Commit parked ops on the surviving set
        — the mirror of the hole-journaling ``_dispatch_writes``
        applies when the member is already down at dispatch time. The
        pg log is NOT acked for the dead shard, so its missed extents
        stay dirty for delta recovery when it returns (the reference
        requeues the op into the new interval; the client's resend
        dedups via reqid).

        Durability floor: an op may only report success if at least k
        shards actually acked — the same min_size floor
        ``_generate_transactions`` enforces at dispatch. Below that the
        new stripe cannot be decoded (survivors mix old and new
        chunks), so the op completes with an error instead."""
        finished: list[ClientOp] = []
        with self._ack_lock:
            for op in list(self._inflight.values()):
                if shard in op.pending_shards:
                    op.pending_shards.discard(shard)
                    op.tracked.mark_event("subop_lost", shard=shard)
                    if not op.pending_shards and not op.committed:
                        if len(op.acked_shards) < self.sinfo.k:
                            op.error = IOError(
                                f"write lost below min_size: only "
                                f"{len(op.acked_shards)} of {self.sinfo.k}"
                                f" required shards durable"
                            )
                            self.perf.inc("aborts")
                        op.committed = True
                        finished.append(op)
        # cache release outside _ack_lock (see _shard_ack). A failed
        # op publishes an EMPTY map, exactly like _abort_op: the cache
        # must not serve bytes the client was told were lost.
        for op in finished:
            self.cache.write_done(
                op.cache_op,
                op.written if op.error is None
                else ShardExtentMap(self.sinfo),
            )
        with self._ack_lock:
            self._check_commit_order()

    def on_shard_recovered(
        self, shard: int, up_to_tid: int | None = None
    ) -> None:
        """Log-driven recovery rebuilt this shard's missed extents:
        treat the lost sub-write acks as durable and let parked ops
        commit — the rollforward of partially-committed EC writes
        (pending_roll_forward semantics, ECCommon.h:500-503 + PGLog)."""
        with self._ack_lock:
            self._on_shard_recovered_locked(shard, up_to_tid)

    def _on_shard_recovered_locked(
        self, shard: int, up_to_tid: int | None
    ) -> None:
        for tid, op in list(self._inflight.items()):
            if up_to_tid is not None and tid > up_to_tid:
                continue
            if shard in op.pending_shards:
                self._shard_ack(op, shard)

    def _check_commit_order(self) -> None:
        """Fire on_commit strictly in tid order (waiting_commit /
        completed_to semantics, ECCommon.h:553-555)."""
        while self._inflight:
            tid, op = next(iter(self._inflight.items()))
            if not op.committed:
                return
            self._inflight.pop(tid)
            op.notified = True
            op.tracked.finish(
                "done" if op.error is None
                else f"error:{type(op.error).__name__}"
            )
            if op.t_submit is not None:
                self.perf.ainc(
                    "commit_lat", time.perf_counter() - op.t_submit
                )
            if op.on_commit is not None:
                op.on_commit(op)
