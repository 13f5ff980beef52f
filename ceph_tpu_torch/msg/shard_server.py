"""Shard daemon + networked shard backend — the mini-OSD tier.

``ShardServer`` is the remote end of the EC fan-out: it owns one
shard's store and serves ECSubWrite/ECSubRead exactly like the
reference's ``handle_sub_write``/``handle_sub_read``
(osd/ECBackend.cc:912,998) by delegating to the same local
``ShardBackend`` the in-process pipelines use (one source of truth for
zero-padding and ECInject consultation), over the framed wire protocol.

``NetShardBackend`` is a drop-in for ``pipeline.rmw.ShardBackend``
whose sub-ops travel over sockets. Sub-op sends are asynchronous (the
whole k+m fan-out goes out before any reply is awaited — one RTT per
op, not per shard); replies are queued and executed on the CALLER's
thread via ``drain_until``, so pipeline state stays single-threaded
(the crimson run-to-completion stance, not reader-thread reentrancy).
RPC timeouts and connection failures mark the shard down (the
failure-detection seam), so degraded reads and recovery route around a
dead daemon automatically; a lost sub-write ack parks its op exactly
like the reference until recovery intervenes.

Deep scrub currently requires local stores (it reads attrs directly);
a getattr sub-op is the natural extension point.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections.abc import Callable

from ceph_tpu_torch.store import MemStore, Transaction
from ceph_tpu_torch.utils import tracer

from .messages import (
    ECSubRead,
    ECSubReadReply,
    ECSubWrite,
    ECSubWriteBatch,
    ECSubWriteBatchReply,
    ECSubWriteReply,
    BackfillReserve,
    BackfillReserveReply,
    GetAttrs,
    GetAttrsReply,
    PGActivate,
    PGActivateAck,
    PGInfo,
    PGInfoReply,
    PGList,
    PGListReply,
    Ping,
    Pong,
)
from .messenger import Connection, Messenger
from ceph_tpu_torch.utils import lockdep
from ceph_tpu_torch.utils.lockdep import DebugLock, DebugRLock


class ShardServer:
    """One shard's daemon: store + messenger + sub-op handlers."""

    def __init__(
        self,
        shard: int,
        store: MemStore | None = None,
        secret: bytes | None = None,
    ) -> None:
        from ceph_tpu_torch.pipeline.rmw import ShardBackend

        self.shard = shard
        self.store = store or MemStore(f"osd.{shard}")
        # Delegate sub-op semantics (zero-pad reads, inject hooks) to
        # the same backend the in-process pipelines use.
        self._local = ShardBackend({shard: self.store})
        self.messenger = Messenger(f"osd.{shard}", secret=secret)
        self.messenger.set_dispatcher(self._dispatch)
        self.addr: tuple[str, int] | None = None

    def start(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        self.addr = self.messenger.bind(host, port)
        return self.addr

    def stop(self) -> None:
        self.messenger.shutdown()

    # -- sub-op handlers (handle_sub_write / handle_sub_read) ----------
    def _dispatch(self, conn: Connection, msg) -> None:
        if isinstance(msg, Ping):
            conn.send(Pong(msg.tid, self.shard))
        elif isinstance(msg, GetAttrs):
            from .messages import serve_get_attrs

            serve_get_attrs(self.store, self.shard, conn, msg)
        elif isinstance(msg, ECSubWrite):
            with tracer.continue_trace(msg.trace_id, msg.parent_span):
                with tracer.span(
                    "sub_write", shard=self.shard, tid=msg.tid,
                ):
                    self._local.submit_shard_txn(
                        self.shard,
                        msg.txn,
                        lambda: conn.send(
                            ECSubWriteReply(msg.tid, self.shard)
                        ),
                    )
        elif isinstance(msg, ECSubWriteBatch):
            results = []
            for tid, shard, _epoch, _from, txn in msg.items:
                acked: list[bool] = []
                with tracer.span(
                    "sub_write", shard=self.shard, tid=tid,
                ):
                    self._local.submit_shard_txn(
                        self.shard, txn, lambda a=acked: a.append(True)
                    )
                if acked:  # injected drops stay un-acked (parked)
                    results.append((tid, True))
            conn.send(
                ECSubWriteBatchReply(msg.tid, self.shard, results)
            )
        elif isinstance(msg, ECSubRead):
            from ceph_tpu_torch.pipeline.extents import ExtentSet

            def reply(shard: int, result) -> None:
                if isinstance(result, Exception):
                    kind = getattr(result, "kind", "eio")
                    conn.send(
                        ECSubReadReply(msg.tid, shard, error=kind)
                    )
                else:
                    offsets = sorted(result)
                    conn.send(
                        ECSubReadReply(
                            msg.tid,
                            shard,
                            offsets,
                            [bytes(result[o]) for o in offsets],
                        )
                    )

            with tracer.continue_trace(msg.trace_id, msg.parent_span), \
                    tracer.span(
                        "sub_read", shard=self.shard, tid=msg.tid,
                    ):
                self._local.read_shard_async(
                    self.shard,
                    msg.oid,
                    ExtentSet((s, e) for s, e in msg.extents),
                    reply,
                )


class _Pending:
    __slots__ = (
        "shard", "oid", "on_reply", "deadline", "is_read", "soft",
        "resend", "retry_at", "tries", "tracked",
    )

    def __init__(self, shard, oid, on_reply, deadline, is_read,
                 soft=False, resend=None, retry_at=None,
                 tracked=None):
        from ceph_tpu_torch.utils.optracker import NULL_OP

        self.shard = shard
        self.oid = oid
        self.on_reply = on_reply
        self.deadline = deadline
        self.is_read = is_read
        #: live-op handle: a wedged peer RPC (lost frame, dead peer)
        #: shows in dump_ops_in_flight with how long it has waited
        self.tracked = tracked if tracked is not None else NULL_OP
        #: soft RPCs are EXPECTED to wait (delayed reservation
        #: grants): expiry wakes the waiter but must not mark the
        #: merely-busy peer down
        self.soft = soft
        #: sub-op retransmit (the lossless-messenger replay collapsed
        #: to idempotent re-send; armed only on lossy-link runs via
        #: ``osd_subop_resend_interval``): re-fires the frame on a
        #: doubling ladder until the reply lands or the deadline
        #: expires. Safe because sub-writes carry absolute extents +
        #: attrs (re-apply = same bytes), the interval fence rejects
        #: cross-interval staleness, and a duplicate ack is absorbed
        #: by the pending-entry pop exactly-once.
        self.resend = resend
        self.retry_at = retry_at
        self.tries = 0


class NetShardBackend:
    """ShardBackend over the wire: same surface the pipelines consume
    (avail_shards / read_shard / read_shard_async / submit_shard_txn).

    Callbacks are NEVER invoked from reader threads: replies queue into
    an inbox that ``drain_until`` executes on the calling thread.
    """

    def __init__(
        self,
        addrs: dict[int, tuple[str, int]],
        timeout: float = 10.0,
        secret: bytes | None = None,
        name: str = "client",
    ) -> None:
        from ceph_tpu_torch.utils.log import get_logger

        from ceph_tpu_torch.utils import config as _cfg

        self.addrs = dict(addrs)
        self.timeout = timeout
        #: seconds before an un-replied sub-op is re-sent (0 = never,
        #: the default: TCP is lossless, parked semantics stand).
        #: Lossy-link runs (the injected fault plane) arm it so a lost
        #: frame resolves in fractions of the RPC deadline.
        self.resend_interval = float(
            _cfg.get("osd_subop_resend_interval")
        )
        self.down_shards: set[int] = set()
        #: shard -> monotonic stamp of its LAST down-marking (the
        #: recheck probe only clears a mark once liveness evidence —
        #: a Pong — postdates it)
        self._down_at: dict[int, float] = {}
        self._log = get_logger("msgr")
        # ``name`` identifies this endpoint on the fault plane's link
        # rules (an OSD daemon passes its own name so inter-OSD links
        # read as osd.i -> osd.j, not client -> osd.j)
        self.messenger = Messenger(name, secret=secret)
        self.messenger.set_dispatcher(self._dispatch)
        self._conns: dict[int, Connection] = {}
        self._tids = itertools.count(1)
        self._lock = DebugLock("msgr.shard_sessions")
        self._waiting: dict[tuple[int, int], _Pending] = {}
        self._inbox: "queue.Queue[Callable[[], None]]" = queue.Queue()
        # Serializes reply-callback execution (and predicate checks)
        # across concurrent drainers: client-op workers, backfill and
        # catch-up recovery threads all drain the one inbox, and the
        # RMW/read pipelines assume their callbacks never run
        # concurrently (crimson run-to-completion stance). RLock: a
        # callback may itself drain (sync read inside a recovery step).
        self._cb_lock = DebugRLock("msgr.shard_cb")
        self._last_seen: dict[int, float] = {}
        self._hb_stop: threading.Event | None = None
        self._hb_thread: threading.Thread | None = None
        # -- sub-write batching (round-10 fan-out coalescing): inside
        # a ``subwrite_batching`` scope, sub-writes stage per peer and
        # flush as ONE ECSubWriteBatch frame each. Flush points:
        # scope exit, and the top of every drain_until loop — every
        # submitter drains right after its fan-out, so a staged txn
        # is never more than one drain iteration from the wire (and
        # any concurrent thread's drain carries it along).
        self._stage_depth = 0
        self._staged: dict[int, list] = {}
        #: observability hook the owning daemon points at its
        #: coalesce counters: called with the item count of every
        #: multi-sub-write frame sent
        self.on_subwrite_batch: Callable[[int], None] | None = None

    # -- plumbing ------------------------------------------------------
    def _conn(self, shard: int) -> Connection:
        with self._lock:
            conn = self._conns.get(shard)
        if conn is not None and conn.alive:
            return conn
        conn = self.messenger.connect(self.addrs[shard])
        with self._lock:
            self._conns[shard] = conn
        return conn

    def _dispatch(self, conn: Connection, msg) -> None:
        """Reader thread: queue the reply for the caller to drain.
        Pongs update liveness directly (no pipeline state touched)."""
        if isinstance(msg, Pong):
            self._last_seen[msg.shard] = time.monotonic()
            return
        if isinstance(msg, ECSubWriteBatchReply):
            # demux the batch into its items' pending entries: each
            # staged sub-write registered under its OWN tid, so the
            # ack path below it is indistinguishable from a solo
            # ECSubWriteReply (parked items simply stay registered)
            for tid, committed in msg.results:
                with self._lock:
                    entry = self._waiting.pop((tid, msg.shard), None)
                if entry is not None:
                    entry.tracked.finish(
                        "replied" if committed else "fenced"
                    )
                    self._inbox.put(
                        lambda e=entry, t=tid, c=committed: e.on_reply(
                            ECSubWriteReply(t, msg.shard, c)
                        )
                    )
                else:
                    self._absorbed()
            return
        if not isinstance(
            msg,
            (ECSubWriteReply, ECSubReadReply, PGListReply, GetAttrsReply,
             PGInfoReply, PGActivateAck, BackfillReserveReply),
        ):
            return  # a reflected request must never satisfy an RPC
        with self._lock:
            entry = self._waiting.pop((msg.tid, msg.shard), None)
        if entry is not None:
            entry.tracked.finish("replied")
            self._inbox.put(lambda: entry.on_reply(msg))
        elif isinstance(msg, (ECSubWriteReply, ECSubWriteBatchReply)):
            self._absorbed()

    def _absorbed(self) -> None:
        """A write ack with no pending entry: a duplicated frame's
        second copy, or a straggler ack that outlived its RPC deadline
        — either way the commit path already consumed (or re-sent) the
        op, so the ack is absorbed exactly-once. Observable on the
        owning daemon's ``osd.N.net`` counter set."""
        pc = self.messenger.net_pc
        if pc is not None:
            pc.inc("resends_absorbed")

    def _register(
        self, tid, shard, oid, on_reply, is_read,
        deadline=None, soft=False, resend=None,
    ) -> None:
        retry_at = None
        if resend is not None and self.resend_interval > 0:
            retry_at = time.monotonic() + self.resend_interval
        tracked = None
        if not soft:
            # soft RPCs (delayed reservation grants) are EXPECTED to
            # wait — tracking them would feed false slow-op complaints
            from ceph_tpu_torch.utils.optracker import op_tracker

            tracked = op_tracker.register(
                "peer_subop", daemon=self.messenger.name,
                to=f"osd.{shard}", tid=tid,
                kind="read" if is_read else "write", oid=oid,
            )
        with self._lock:
            self._waiting[(tid, shard)] = _Pending(
                shard, oid, on_reply,
                deadline if deadline is not None
                else time.monotonic() + self.timeout,
                is_read, soft, resend=resend, retry_at=retry_at,
                tracked=tracked,
            )

    def _send(self, shard: int, msg, tid: int) -> bool:
        try:
            self._conn(shard).send(msg)
            return True
        except (ConnectionError, OSError, KeyError):
            with self._lock:
                entry = self._waiting.pop((tid, shard), None)
            if entry is not None:
                entry.tracked.finish("send_failed")
            self._mark_down(shard, "send failed")
            return False

    def _mark_down(self, shard: int, why: str) -> None:
        if shard not in self.down_shards:
            self._log.info("shard", shard, f"marked down ({why})")
        self.down_shards.add(shard)
        self._down_at[shard] = time.monotonic()

    def recheck_down(self, shards=None) -> None:
        """Re-probe locally down-marked peers (callers pass only ones
        the OSDMap still says are up): a mark earned on a LOSSY link
        — one lost ack tripping the RPC deadline — must not exclude a
        healthy peer until the next map change. Evidence-based: a
        Pong that postdates the down-mark clears it; otherwise a
        fresh Ping goes out and a later recheck consumes its Pong. A
        genuinely dead or partitioned peer never pongs, so its mark
        stands (one-way marking is preserved for real failures)."""
        now = time.monotonic()
        for shard in list(self.down_shards):
            if shards is not None and shard not in shards:
                continue
            if self._last_seen.get(shard, 0.0) > self._down_at.get(
                shard, now
            ):
                self.down_shards.discard(shard)
                self._down_at.pop(shard, None)
                self._log.info(
                    "shard", shard, "back up (pong after down-mark)"
                )
                continue
            try:
                self._conn(shard).send(Ping(next(self._tids), shard))
            except (ConnectionError, OSError, KeyError):
                pass

    def _expire(self) -> None:
        """Timed-out RPCs: mark the shard down; reads get an error
        callback, writes stay parked (lost-ack semantics). Before the
        deadline, entries with a retransmit ladder re-fire on their
        doubling schedule (lossy-link runs only; see _Pending)."""
        now = time.monotonic()
        expired = []
        resends = []
        with self._lock:
            for key, entry in list(self._waiting.items()):
                if entry.deadline <= now:
                    expired.append((key, entry))
                    del self._waiting[key]
                elif (
                    entry.retry_at is not None and entry.retry_at <= now
                ):
                    entry.tries += 1
                    entry.retry_at = now + self.resend_interval * (
                        2 ** entry.tries
                    )
                    entry.tracked.mark_event("resent", tries=entry.tries)
                    resends.append(entry.resend)
        for fire in resends:  # outside the lock: sends can block
            try:
                fire()
            except (ConnectionError, OSError, KeyError):
                pass  # dead link: the deadline path judges it
        for (tid, shard), entry in expired:
            entry.tracked.finish("rpc_timeout")
            if not entry.soft:
                self._mark_down(shard, "rpc timeout")
            if entry.is_read:
                from ceph_tpu_torch.pipeline.read import ShardReadError

                self._inbox.put(
                    lambda e=entry: e.on_reply(
                        ShardReadError(e.shard, e.oid)
                    )
                )

    # -- caller-thread event loop --------------------------------------
    def drain_until(
        self, pred: Callable[[], bool], timeout: float = 30.0
    ) -> None:
        """Run queued reply callbacks on this thread until ``pred``
        holds. Raises TimeoutError if it never does. Any thread may
        drain; pipeline callbacks stay mutually serialized under
        ``_cb_lock`` (a drainer may execute another waiter's thunk —
        the state change it was waiting on is shared, so its own
        predicate pass sees it)."""
        with lockdep.blocking_region("peers.drain_until"):
            self._drain_until(pred, timeout)

    def _drain_until(
        self, pred: Callable[[], bool], timeout: float
    ) -> None:
        end = time.monotonic() + timeout
        while True:
            with self._cb_lock:
                if pred():
                    return
            self._expire()
            self._flush_staged()
            try:
                thunk = self._inbox.get(timeout=0.05)
            except queue.Empty:
                if time.monotonic() > end:
                    raise TimeoutError("drain_until: condition never held")
                continue
            # Execute only if no other thread is mid-callback: blocking
            # here would park this thunk — possibly the very reply the
            # lock holder's nested drain is waiting on — on our stack
            # and starve it into a spurious TimeoutError. Re-queue and
            # let the holder's own (re-entrant) drain loop pop it.
            if self._cb_lock.acquire(blocking=False):
                try:
                    thunk()
                finally:
                    self._cb_lock.release()
            else:
                self._inbox.put(thunk)
                pc = self.messenger.net_pc
                if pc is not None:
                    pc.inc("drain.requeues")
                time.sleep(0.001)

    # -- ShardBackend surface ------------------------------------------
    def set_addr(self, shard: int, addr: tuple[str, int]) -> None:
        """Point a shard at a replacement daemon and mark it up (the
        osdmap-update analog after an OSD is replaced)."""
        with self._lock:
            self.addrs[shard] = addr
            conn = self._conns.pop(shard, None)
        if conn is not None:
            conn.close()
        self._last_seen[shard] = time.monotonic()
        self.down_shards.discard(shard)
        self._down_at.pop(shard, None)

    def avail_shards(self) -> set[int]:
        return set(self.addrs) - self.down_shards

    def read_shard_async(
        self,
        shard: int,
        oid: str,
        extents,
        cb: Callable[[int, object], None],
        logical: int | None = None,
    ) -> None:
        from ceph_tpu_torch.pipeline.read import ShardReadError

        tid = next(self._tids)

        def on_reply(reply) -> None:
            if isinstance(reply, Exception):
                cb(shard, reply)
            elif reply.error:
                cb(shard, ShardReadError(shard, oid, kind=reply.error))
            else:
                cb(shard, dict(zip(reply.offsets, reply.buffers)))

        t_id, t_span = tracer.current()
        msg = ECSubRead(
            tid, shard, oid, [(s, e) for s, e in extents], logical=logical,
            trace_id=t_id, parent_span=t_span,
        )
        self._register(
            tid, shard, oid, on_reply, is_read=True,
            resend=lambda: self._conn(shard).send(msg),
        )
        if not self._send(shard, msg, tid):
            self._inbox.put(lambda: cb(shard, ShardReadError(shard, oid)))

    def read_shard(
        self, shard: int, oid: str, extents, logical: int | None = None
    ) -> dict[int, bytes]:
        """Synchronous single-shard read (drains inline)."""
        out: dict[str, object] = {}
        self.read_shard_async(
            shard, oid, extents, lambda s, r: out.update(r=r),
            logical=logical,
        )
        self.drain_until(lambda: "r" in out, timeout=self.timeout + 5)
        result = out["r"]
        if isinstance(result, Exception):
            raise result
        return result

    def list_pg(
        self, shard: int, pool_id: int, pg_num: int, pgid: int
    ) -> list[tuple[str, int, int]]:
        """Synchronous backfill scan: which objects of this PG does the
        peer hold, as (oid, held_shard_index, ro_size) tuples."""
        tid = next(self._tids)
        out: dict[str, object] = {}
        self._register(
            tid, shard, "", lambda r: out.update(r=r), is_read=True
        )
        if not self._send(
            shard, PGList(tid, shard, pool_id, pg_num, pgid), tid
        ):
            raise ConnectionError(f"osd.{shard} unreachable for pg list")
        self.drain_until(lambda: "r" in out, timeout=self.timeout + 5)
        result = out["r"]
        if isinstance(result, Exception):
            raise result
        return result.oids

    def get_pg_info(
        self, shard: int, pool_id: int, pg_num: int, pgid: int,
        epoch: int = 0,
    ) -> tuple[int, tuple[int, int]]:
        """Synchronous peering info fetch: the peer's
        (last_epoch_started, last_update) for one PG, answered from
        its durable store (proc_replica_info's data source).
        ``epoch`` fences the answering member against sub-writes from
        older intervals of this PG before it answers."""
        tid = next(self._tids)
        out: dict[str, object] = {}
        self._register(
            tid, shard, "", lambda r: out.update(r=r), is_read=True
        )
        if not self._send(
            shard, PGInfo(tid, shard, pool_id, pg_num, pgid, epoch), tid
        ):
            raise ConnectionError(f"osd.{shard} unreachable for pg info")
        self.drain_until(lambda: "r" in out, timeout=self.timeout + 5)
        result = out["r"]
        if isinstance(result, Exception):
            raise result
        return result.les, (result.lu_epoch, result.lu_tid)

    def activate_pg(
        self, shard: int, pool_id: int, pgid: int, epoch: int
    ) -> bool:
        """Push an interval activation (les=epoch) to one member;
        waits for the ack so the les write is durable before the
        primary starts serving. Returns False when the member is
        unreachable (it keeps its stale les — by design)."""
        tid = next(self._tids)
        out: dict[str, object] = {}
        self._register(
            tid, shard, "", lambda r: out.update(r=r), is_read=True
        )
        if not self._send(
            shard, PGActivate(tid, shard, pool_id, pgid, epoch), tid
        ):
            return False
        try:
            self.drain_until(lambda: "r" in out, timeout=self.timeout)
        except TimeoutError:
            return False
        return not isinstance(out.get("r"), Exception)

    def reserve_backfill(
        self, shard: int, pool_id: int, pgid: int, prio: int,
        timeout: float,
    ) -> bool:
        """Ask a backfill target for a remote reservation slot. The
        grant may be DELAYED while the target's remote reserver is
        full — ``timeout`` bounds the wait; False means unreachable
        or not granted in time (the caller backs off and retries)."""
        tid = next(self._tids)
        out: dict[str, object] = {}
        # soft + per-call deadline: a full target DELAYS its grant by
        # design, so the generic RPC expiry must neither cut the wait
        # short nor mark the healthy-but-busy peer down
        self._register(
            tid, shard, "", lambda r: out.update(r=r), is_read=True,
            deadline=time.monotonic() + timeout, soft=True,
        )
        if not self._send(
            shard,
            BackfillReserve(tid, shard, "request", pool_id, pgid, prio),
            tid,
        ):
            return False
        try:
            self.drain_until(lambda: "r" in out, timeout=timeout)
        except TimeoutError:
            return False
        r = out.get("r")
        return (
            not isinstance(r, Exception)
            and getattr(r, "granted", False)
        )

    def release_backfill(self, shard: int, pool_id: int, pgid: int) -> None:
        """Fire-and-forget remote-slot release (acked, but the caller
        has nothing to do with the ack)."""
        tid = next(self._tids)
        self._register(tid, shard, "", lambda r: None, is_read=True)
        self._send(
            shard,
            BackfillReserve(tid, shard, "release", pool_id, pgid),
            tid,
        )

    def get_attrs_async(
        self, shard: int, oid: str, names: list[str], cb
    ) -> bool:
        """Async attr fetch (the read_shard_async pattern): ``cb`` gets
        a GetAttrsReply, an Exception, or is never called when the
        send itself fails (returns False so the caller can count)."""
        tid = next(self._tids)
        self._register(tid, shard, oid, cb, is_read=True)
        return self._send(shard, GetAttrs(tid, shard, oid, names), tid)

    def get_attrs(
        self, shard: int, oid: str, names: list[str]
    ) -> dict:
        """Synchronous attr fetch from one shard's store (the getattr
        sub-op): name -> bytes | None. Raises on enoent/unreachable."""
        out: dict[str, object] = {}
        if not self.get_attrs_async(
            shard, oid, names, lambda r: out.update(r=r)
        ):
            raise ConnectionError(f"osd.{shard} unreachable for attrs")
        self.drain_until(lambda: "r" in out, timeout=self.timeout)
        result = out["r"]
        if isinstance(result, Exception):
            raise result
        if result.error:
            raise FileNotFoundError(oid)
        return result.attrs

    #: set by the owning OSD daemon: () -> (map_epoch, osd_id), the
    #: sender interval stamped into every sub-write for the replica
    #: fence (standalone pipeline tests leave it None: no fencing)
    interval_fn = None

    # -- sub-write batching scope --------------------------------------
    def subwrite_batching(self):
        """Scope within which sub-writes stage per peer instead of
        going out one frame each; nesting-safe, flushes on exit."""
        import contextlib

        @contextlib.contextmanager
        def scope():
            with self._lock:
                self._stage_depth += 1
            try:
                yield
            finally:
                with self._lock:
                    self._stage_depth -= 1
                self._flush_staged()

        return scope()

    def _flush_staged(self) -> None:
        """Ship every staged sub-write: one ECSubWriteBatch per peer
        with >= 2 items, plain ECSubWrite for singletons (the wire
        stays byte-identical when nothing actually coalesced)."""
        with self._lock:
            if not self._staged:
                return
            staged, self._staged = self._staged, {}
        for shard, items in staged.items():
            if len(items) == 1:
                tid, epoch, from_osd, txn = items[0]
                self._send(
                    shard,
                    ECSubWrite(
                        tid, shard, txn, epoch=epoch, from_osd=from_osd
                    ),
                    tid,
                )
                continue
            batch_tid = next(self._tids)
            msg = ECSubWriteBatch(
                batch_tid, shard,
                [(tid, shard, epoch, from_osd, txn)
                 for tid, epoch, from_osd, txn in items],
            )
            try:
                self._conn(shard).send(msg)
                if self.on_subwrite_batch is not None:
                    self.on_subwrite_batch(len(items))
            except (ConnectionError, OSError, KeyError):
                # the whole frame is lost: drop every item's pending
                # entry and mark the peer down, exactly like a failed
                # solo send (writes park; recovery's problem)
                dropped = []
                with self._lock:
                    for tid, *_rest in items:
                        e = self._waiting.pop((tid, shard), None)
                        if e is not None:
                            dropped.append(e)
                for e in dropped:
                    e.tracked.finish("send_failed")
                self._mark_down(shard, "send failed")

    def submit_shard_txn(
        self, shard: int, txn: Transaction, ack: Callable[[], None]
    ) -> None:
        tid = next(self._tids)

        def on_reply(reply) -> None:
            if not isinstance(reply, Exception) and reply.committed:
                ack()
            # else parked: ack never fires, recovery's problem

        epoch, from_osd = (
            self.interval_fn() if self.interval_fn else (0, -1)
        )
        t_id, t_span = tracer.current()
        msg = ECSubWrite(
            tid, shard, txn, trace_id=t_id, parent_span=t_span,
            epoch=epoch, from_osd=from_osd,
        )
        # retransmits always go out SOLO (even for batch-staged
        # items): the receiver path is identical and the frame is
        # self-contained
        self._register(
            tid, shard, "", on_reply, is_read=False,
            resend=lambda: self._conn(shard).send(msg),
        )
        with self._lock:
            if self._stage_depth > 0:
                self._staged.setdefault(shard, []).append(
                    (tid, epoch, from_osd, txn)
                )
                return
        self._send(shard, msg, tid)

    # -- heartbeats (OSD::handle_osd_ping / stale-ping culling) --------
    def start_heartbeat(
        self, period: float = 0.5, grace: float = 2.0
    ) -> None:
        """Ping every shard each ``period`` seconds; a shard silent for
        ``grace`` seconds (or unreachable) is marked down so the
        planners route around it BEFORE any IO trips over the failure
        (osd/OSD.cc:5854 heartbeat + :6148 stale-ping culling).
        Down-marking is one-way: a replaced daemon comes back via
        ``set_addr`` (the osdmap-update path), never silently."""
        self.stop_heartbeat()
        self._hb_stop = threading.Event()
        now = time.monotonic()
        for shard in self.addrs:
            self._last_seen.setdefault(shard, now)

        def loop() -> None:
            while not self._hb_stop.wait(period):
                for shard in list(self.addrs):
                    if shard in self.down_shards:
                        continue
                    try:
                        self._conn(shard).send(
                            Ping(next(self._tids), shard)
                        )
                    except (ConnectionError, OSError):
                        self._mark_down(shard, "ping failed")
                        continue
                    age = time.monotonic() - self._last_seen.get(shard, 0)
                    if age > grace:
                        self._mark_down(shard, "ping silence")

        self._hb_thread = threading.Thread(target=loop, daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()
            if self._hb_thread is not None:
                self._hb_thread.join(timeout=2.0)
        self._hb_stop = None
        self._hb_thread = None

    def shutdown(self) -> None:
        self.stop_heartbeat()
        with self._lock:
            pending = list(self._waiting.values())
            self._waiting.clear()
        for entry in pending:
            # a stopped backend's RPCs died with it — the live tracker
            # must not carry (and complain about) them forever
            entry.tracked.finish("backend_shutdown")
        self.messenger.shutdown()
