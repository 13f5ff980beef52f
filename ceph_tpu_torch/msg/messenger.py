"""Socket messenger — the AsyncMessenger analog (host/DCN tier).

Mirrors the roles of msg/async/AsyncMessenger.{h,cc}: a ``Messenger``
binds a listening address and dispatches inbound typed messages to its
dispatcher (the ``ms_fast_dispatch`` seam, osd/OSD.cc:7686);
``Connection`` objects carry framed messages (wire.py) over TCP with a
reader thread per connection. Event-loop sophistication (epoll worker
pools, lossy/lossless policies with replay) is intentionally replaced
by one thread per connection — connection counts here are k+m, not
thousands; the wire format, per-segment CRC, and dispatch contract are
the load-bearing parts.

Network-fault plane (the tc/netem analog, qa thrasher msgr-failures
role): :data:`net_faults` is a process-global, seeded registry of
per-link (src name → dst name) rules — drop probability, delay
distribution, duplication, reordering, and full/asymmetric partitions.
Faults apply to LOGICAL frames above TCP, at the connection-initiating
end, which knows both endpoint names (outbound requests in ``send``,
inbound replies after decode in the read loop) — each direction of a
link is therefore faulted exactly once, and a delayed outbound frame
is re-sent through the normal seal-under-lock path so secure-mode
counters stay consistent with socket order. Every decision comes from
a per-link ``random.Random`` seeded from (plane seed, src, dst): the
same seed replays the same per-link firing sequence, which is what
makes a chaos run a regression test instead of a dice roll. When
nothing is armed the cost is one attribute check per frame.
"""

from __future__ import annotations

import fnmatch
import heapq
import itertools
import socket
import threading
import time
import zlib
from collections.abc import Callable

from . import secure as secure_mod
from . import shm_ring
from .messages import decode_message, message_type
from .wire import HEADER_BYTES, BadFrame, decode_frame, encode_frame
from ceph_tpu_torch.utils import lockdep, tracer
from ceph_tpu_torch.utils.lockdep import DebugLock


#: listening addr -> messenger name, registered at bind() — how a
#: connecting end resolves the PEER's name so the fault plane can key
#: its link rules on (src, dst) daemon names (in-process clusters
#: only; a cross-host deployment would carry names in a hello frame)
_addr_names: dict[tuple[str, int], str] = {}
_addr_lock = DebugLock("msgr.addr_registry")


class LinkRule:
    """One link's injection profile. Probabilities are per logical
    frame per direction; ``delay_ms`` + uniform ``delay_jitter_ms``
    is the netem delay/jitter pair (p95 = delay + 0.95·jitter);
    ``reorder`` holds a frame until the next one on the link passes
    it; ``partition`` drops everything (compose two asymmetric rules
    for a full partition)."""

    __slots__ = (
        "drop", "dup", "delay_ms", "delay_jitter_ms", "reorder",
        "partition",
    )

    def __init__(
        self,
        drop: float = 0.0,
        dup: float = 0.0,
        delay_ms: float = 0.0,
        delay_jitter_ms: float = 0.0,
        reorder: float = 0.0,
        partition: bool = False,
    ) -> None:
        for name, p in (("drop", drop), ("dup", dup), ("reorder", reorder)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be a probability, got {p}")
        if delay_ms < 0 or delay_jitter_ms < 0:
            raise ValueError("delays must be >= 0")
        self.drop = drop
        self.dup = dup
        self.delay_ms = delay_ms
        self.delay_jitter_ms = delay_jitter_ms
        self.reorder = reorder
        self.partition = partition

    def __repr__(self) -> str:  # the `tc qdisc show` analog
        parts = []
        if self.partition:
            parts.append("partition")
        if self.drop:
            parts.append(f"drop={self.drop}")
        if self.dup:
            parts.append(f"dup={self.dup}")
        if self.delay_ms or self.delay_jitter_ms:
            parts.append(
                f"delay={self.delay_ms}ms+{self.delay_jitter_ms}ms"
            )
        if self.reorder:
            parts.append(f"reorder={self.reorder}")
        return f"LinkRule({' '.join(parts) or 'clean'})"


class _Lane:
    """Per-(src, dst) state: the resolved rule, a deterministic RNG,
    and the held-frame slot the reorder fault uses."""

    __slots__ = ("rule", "rng", "held", "lock")

    def __init__(self, rule: "LinkRule | None", seed: int) -> None:
        import random

        self.rule = rule
        self.rng = random.Random(seed)
        self.held: "Callable[[], None] | None" = None
        self.lock = DebugLock("msgr.net_lane")


#: counters the plane keeps (process totals; per-daemon slices ride
#: the owning messenger's ``net_pc`` perf set when one is attached)
FAULT_COUNTERS = (
    "frames_dropped", "frames_delayed", "frames_duped",
    "frames_reordered",
)


class NetFaultPlane:
    """Process-global seeded link-fault registry (see module doc).

    Arm with :meth:`add_rule` / :meth:`partition`; every armed plane
    change bumps a generation so lanes re-resolve their rule lazily.
    ``clear()`` disarms and FLUSHES in-flight delayed/held frames
    (delivered immediately — a cleared plane must not keep eating
    frames), so a fault window has a crisp settle edge."""

    #: failsafe: a reorder-held frame is force-flushed after this many
    #: seconds even if no follow-up frame ever crosses the lane
    REORDER_FLUSH_S = 0.1

    def __init__(self) -> None:
        self._lock = DebugLock("msgr.net_faults")
        self._rules: list[tuple[str, str, LinkRule]] = []
        self._lanes: dict[tuple[str, int], _Lane] = {}
        self._gen = 0
        self.seed = 0
        self.active = False
        self.counters = dict.fromkeys(FAULT_COUNTERS, 0)
        # delayed-delivery timer machinery (lazy daemon thread)
        self._timers: list[tuple[float, int, Callable[[], None]]] = []
        self._timer_seq = itertools.count(1)
        self._timer_cv = threading.Condition()
        self._timer_thread: threading.Thread | None = None

    # -- operator surface (the `tc qdisc add` analog) -------------------
    def configure(self, seed: int) -> "NetFaultPlane":
        """Set the plane seed and reset lane RNGs — call once per run
        BEFORE arming rules; same seed => same per-link firings."""
        with self._lock:
            self.seed = int(seed)
            self._lanes.clear()
            self._gen += 1
        return self

    def add_rule(self, src: str, dst: str, rule: LinkRule) -> None:
        """Arm ``rule`` for frames src→dst (fnmatch patterns, e.g.
        ``("osd.*", "osd.*")``). First matching rule wins. The
        ``msgr_fault_plane`` config gate (evaluated at arm time) is
        the operator escape hatch that keeps armed rules inert."""
        from ceph_tpu_torch.utils import config
        from ceph_tpu_torch.utils.cluster_log import cluster_log

        with self._lock:
            self._rules.append((src, dst, rule))
            self._gen += 1
            self.active = bool(config.get("msgr_fault_plane"))
        # the arm lands in the cluster log so a chaos run's fallout
        # (slow ops, down-marks) lines up against its cause
        cluster_log.log(
            "net", "net_fault_armed",
            f"link rule armed {src} -> {dst}: {rule!r}"
            + ("" if self.active else " (inert: msgr_fault_plane=false)"),
            severity="WRN", seed=self.seed,
        )

    def partition(
        self, names, peers: str = "*", asymmetric: bool = False
    ) -> None:
        """Partition every name in ``names`` from ``peers``:
        symmetric by default; ``asymmetric=True`` cuts only the
        INBOUND direction (peers → victim), the half-partition that
        makes a victim keep talking into a void — the peering
        re-election torture case."""
        if isinstance(names, str):
            names = [names]
        for name in names:
            self.add_rule(peers, name, LinkRule(partition=True))
            if not asymmetric:
                self.add_rule(name, peers, LinkRule(partition=True))

    def clear(self) -> None:
        """Disarm everything and flush held/delayed frames NOW."""
        with self._lock:
            had_rules = bool(self._rules)
            self._rules.clear()
            self._gen += 1
            self.active = False
            lanes = list(self._lanes.values())
        if had_rules:
            from ceph_tpu_torch.utils.cluster_log import cluster_log

            cluster_log.log(
                "net", "net_fault_cleared",
                "fault plane cleared (held/delayed frames flushed)",
            )
        held = []
        for lane in lanes:
            with lane.lock:
                if lane.held is not None:
                    held.append(lane.held)
                    lane.held = None
        with self._timer_cv:
            pending = [fn for _w, _s, fn in self._timers]
            self._timers.clear()
            self._timer_cv.notify()
        for fn in held + pending:
            try:
                fn()
            except Exception:
                pass  # the link may have died while the frame was held
        with self._lock:
            self._lanes.clear()

    def reset_counters(self) -> None:
        with self._lock:
            self.counters = dict.fromkeys(FAULT_COUNTERS, 0)

    # -- plumbing -------------------------------------------------------
    def _resolve(self, src: str, dst: str) -> "LinkRule | None":
        for pat_s, pat_d, rule in self._rules:
            if fnmatch.fnmatchcase(src, pat_s) and fnmatch.fnmatchcase(
                dst, pat_d
            ):
                return rule
        return None

    def _lane(self, src: str, dst: str) -> _Lane:
        key = (f"{src}>{dst}", self._gen)
        with self._lock:
            lane = self._lanes.get(key)
            if lane is None:
                # prune lanes from superseded generations (their rule
                # resolution is stale; the RNG restarts per arming,
                # which keeps a configure+arm block deterministic)
                for old in [k for k in self._lanes if k[1] != self._gen]:
                    del self._lanes[old]
                lane = self._lanes[key] = _Lane(
                    self._resolve(src, dst),
                    zlib.crc32(f"{self.seed}|{src}>{dst}".encode()),
                )
            return lane

    def _count(self, kind: str, owner: "Messenger | None") -> None:
        with self._lock:
            self.counters[kind] += 1
        pc = getattr(owner, "net_pc", None)
        if pc is not None:
            pc.inc(kind)

    def _at(self, when: float, fn: Callable[[], None]) -> None:
        with self._timer_cv:
            heapq.heappush(
                self._timers, (when, next(self._timer_seq), fn)
            )
            if self._timer_thread is None or not self._timer_thread.is_alive():
                self._timer_thread = threading.Thread(
                    target=self._timer_loop, daemon=True,
                    name="net-fault-timer",
                )
                self._timer_thread.start()
            self._timer_cv.notify()

    def _timer_loop(self) -> None:
        while True:
            with self._timer_cv:
                if not self._timers:
                    if not self._timer_cv.wait(5.0) and not self._timers:
                        self._timer_thread = None
                        return
                    continue
                when = self._timers[0][0]
                now = time.monotonic()
                if when > now:
                    self._timer_cv.wait(min(when - now, 0.5))
                    continue
                _w, _s, fn = heapq.heappop(self._timers)
            try:
                fn()
            except Exception:
                pass  # a dead link eats the frame, like a real drop

    # -- the per-frame decision (the netem hook) ------------------------
    def process(
        self,
        src: str,
        dst: str,
        deliver: Callable[[], None],
        owner: "Messenger | None" = None,
    ) -> None:
        """Run one frame src→dst through the link's rule. ``deliver``
        performs the actual send/dispatch; it may run synchronously
        (clean frame — exceptions propagate to the caller exactly as
        without the plane), later on the timer thread (delay/reorder/
        dup copies; exceptions there are swallowed, the frame is
        simply lost like any fault), or never (drop/partition)."""
        lane = self._lane(src, dst)
        rule = lane.rule
        if rule is None:
            deliver()
            return
        with lane.lock:
            rng = lane.rng
            # one draw per fault class per frame, in a FIXED order, so
            # the per-link decision sequence is a pure function of
            # (seed, frame index on the link)
            p_drop = rng.random()
            p_dup = rng.random()
            p_delay = rng.random()
            p_reorder = rng.random()
            dropped = rule.partition or (
                rule.drop > 0.0 and p_drop < rule.drop
            )
            dup = rule.dup > 0.0 and p_dup < rule.dup
            delay = 0.0
            if rule.delay_ms or rule.delay_jitter_ms:
                delay = (
                    rule.delay_ms + rule.delay_jitter_ms * p_delay
                ) / 1000.0
            reorder = rule.reorder > 0.0 and p_reorder < rule.reorder
            released, lane.held = lane.held, None
        if dropped:
            self._count("frames_dropped", owner)
            if released is not None:
                self._guarded(released)
            return
        if dup:
            self._count("frames_duped", owner)

        def emit() -> None:
            deliver()
            if dup:
                self._guarded(deliver)

        if reorder and released is None:
            # hold THIS frame; the next frame on the lane (or the
            # failsafe timer) releases it behind itself
            self._count("frames_reordered", owner)
            hold = (
                emit if delay == 0.0
                else lambda: self._later(delay, emit, owner, count=False)
            )
            with lane.lock:
                if lane.held is None:
                    lane.held = hold
                    self._at(
                        time.monotonic() + delay + self.REORDER_FLUSH_S,
                        lambda: self._flush_lane(lane),
                    )
                    if delay:
                        self._count("frames_delayed", owner)
                    return
            # lost the slot to a racing frame: fall through, deliver
        if delay:
            self._count("frames_delayed", owner)
            self._later(delay, emit, owner, count=False)
        else:
            emit()
        if released is not None:
            self._guarded(released)

    def _later(self, delay, fn, owner, count=True) -> None:
        if count:
            self._count("frames_delayed", owner)
        self._at(time.monotonic() + delay, lambda: self._guarded(fn))

    def _flush_lane(self, lane: _Lane) -> None:
        with lane.lock:
            held, lane.held = lane.held, None
        if held is not None:
            self._guarded(held)

    @staticmethod
    def _guarded(fn: Callable[[], None]) -> None:
        try:
            fn()
        except Exception:
            pass  # faulted copy on a dead link: just lost


#: the process-global fault plane (tests and loadgen arm it)
net_faults = NetFaultPlane()

# In-the-clear handshake frame type for secure-mode nonce exchange
# (outside the normal message-type space; auth_none + CephX roles).
HANDSHAKE_TYPE = 0x7FFF


class Connection:
    """One peer link; ``send(msg)`` frames and writes atomically.

    With a cluster secret configured, the connection runs the secure
    handshake (nonce exchange -> per-direction AES-GCM sessions)
    synchronously before the reader thread starts, so no payload
    message ever travels in the clear."""

    def __init__(
        self,
        sock: socket.socket,
        messenger: "Messenger",
        is_client: bool = False,
        peer_name: "str | None" = None,
    ) -> None:
        self.sock = sock
        self.messenger = messenger
        #: the remote messenger's name when known (client-initiated
        #: conns resolve it from the bind registry). The fault plane
        #: only acts where BOTH names are known — i.e. once per
        #: logical direction, at the connection-initiating end.
        self.peer_name = peer_name
        self._send_lock = DebugLock("msgr.send")
        self._seq = 0
        self.alive = True
        self._tx = self._rx = None
        if messenger.secret is not None:
            try:
                self._handshake(is_client)
            except Exception:
                self.alive = False
                try:
                    self.sock.close()
                except OSError:
                    pass
                raise
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _handshake(self, is_client: bool) -> None:
        # Bounded: a peer that connects and goes silent must not wedge
        # the accept loop (the reference bounds auth exchanges too).
        self.sock.settimeout(5)
        try:
            self._do_handshake(is_client)
        finally:
            self.sock.settimeout(None)

    def _do_handshake(self, is_client: bool) -> None:
        my_nonce = secure_mod.fresh_nonce()
        hello = encode_frame(HANDSHAKE_TYPE, 0, [my_nonce])
        try:
            if is_client:
                self.sock.sendall(hello)
                peer_nonce = self._read_handshake()
                nonce_c, nonce_s = my_nonce, peer_nonce
            else:
                peer_nonce = self._read_handshake()
                self.sock.sendall(hello)
                nonce_c, nonce_s = peer_nonce, my_nonce
        except (EOFError, BadFrame, socket.timeout) as e:
            # A clear-mode or garbage-speaking peer must look like any
            # other dead link (callers map ConnectionError to a down
            # shard), not raise EOFError/BadFrame out of the op path.
            raise ConnectionError(f"secure handshake failed: {e!r}") from e
        self._tx, self._rx = secure_mod.derive_session(
            self.messenger.secret, nonce_c, nonce_s, is_client
        )

    def _read_handshake(self) -> bytes:
        msg_type, _seq, segments = decode_frame(self._read_exact)
        if msg_type != HANDSHAKE_TYPE or len(segments) != 1:
            raise ConnectionError("peer did not offer secure handshake")
        return segments[0]

    def send(self, msg) -> None:
        # lockdep checkpoint: a socket write is a blocking call —
        # executing one while an op-serializing lock is held is only
        # legitimate on the op's own (bounded) commit path, which the
        # "messenger.send" waiver documents
        with lockdep.blocking_region("messenger.send"):
            self._send_faulted(msg)

    def _send_faulted(self, msg) -> None:
        if net_faults.active and self.peer_name is not None:
            # outbound half of the link: the plane may drop the frame
            # (caller sees success — exactly a lost frame), defer it
            # (re-enters _send_now on the timer thread; sealing order
            # still matches socket order because encode happens at
            # delivery time under the send lock), or duplicate it.
            net_faults.process(
                self.messenger.name,
                self.peer_name,
                lambda m=msg: self._send_now(m),
                owner=self.messenger,
            )
            return
        self._send_now(msg)

    def _send_now(self, msg) -> None:
        with self._send_lock:
            self._seq += 1
            # Sealing must happen under the send lock: the AEAD tx
            # counter and the socket write have to agree on order.
            with tracer.timer("msg_encode"):
                frame = encode_frame(
                    message_type(msg),
                    self._seq,
                    msg.encode(),
                    compress=self.messenger.compress,
                    secure=self._tx,
                )
            try:
                with tracer.timer("msg_send"):
                    self.sock.sendall(frame)
            except OSError as e:
                self.alive = False
                raise ConnectionError(str(e)) from e

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise EOFError
            buf += chunk
        return buf

    def _read_frame(self):
        """Block until the next frame's header, then read and decode
        the rest under the ``msg_decode`` timer (the wait for a frame
        is idle time, not decode time)."""
        header = [self._read_exact(HEADER_BYTES)]

        def read_exact(n: int) -> bytes:
            return header.pop() if header else self._read_exact(n)

        with tracer.timer("msg_decode"):
            msg_type, _seq, segments = decode_frame(
                read_exact, secure=self._rx
            )
            return decode_message(msg_type, segments)

    def _read_loop(self) -> None:
        try:
            while True:
                msg = self._read_frame()
                if net_faults.active and self.peer_name is not None:
                    # inbound half of the link (peer → me): replies on
                    # a client-initiated conn are faulted HERE, after
                    # decode — the server end never needs to know our
                    # name, and secure frames are already opened
                    net_faults.process(
                        self.peer_name,
                        self.messenger.name,
                        lambda m=msg: self.messenger.dispatch(self, m),
                        owner=self.messenger,
                    )
                else:
                    self.messenger.dispatch(self, msg)
        except (EOFError, OSError):
            pass
        except Exception:
            # Decode/dispatch failure (bad frame, unknown type, handler
            # bug): drop the connection loudly-at-the-socket so the
            # peer sees EOF and fails fast instead of waiting out RPC
            # timeouts on a wedged link.
            pass
        finally:
            self.alive = False
            try:
                self.sock.close()
            except OSError:
                pass
            self.messenger._conn_closed(self)

    def close(self) -> None:
        self.alive = False
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class Messenger:
    """Bind/connect endpoint + dispatcher registry."""

    def __init__(
        self,
        name: str,
        compress: bool = False,
        secret: bytes | None = None,
    ) -> None:
        self.name = name
        # On-wire compression for frames WE send (receivers auto-detect
        # via the frame flags — compression_onwire.cc role).
        self.compress = compress
        # Cluster pre-shared secret (keyring role): non-None enables
        # AES-GCM secure mode on every connection of this messenger.
        # Both ends must agree — a secure peer rejects clear frames
        # and vice versa (mode is per-connection, negotiated up front).
        self.secret = secret
        #: per-daemon net-fault counter set (``osd.N.net``): the
        #: owning daemon attaches one; the fault plane increments it
        #: for frames it drops/delays/dupes/reorders on this
        #: messenger's links
        self.net_pc = None
        self.dispatcher: Callable[[Connection, object], None] | None = None
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._stopping = False
        self._conns: set[Connection] = set()
        self._lock = DebugLock("msgr.conns")
        self.addr: tuple[str, int] | None = None

    def set_dispatcher(self, fn: Callable[[Connection, object], None]) -> None:
        self.dispatcher = fn

    def dispatch(self, conn: Connection, msg) -> None:
        if self.dispatcher is not None:
            self.dispatcher(conn, msg)

    # -- server side ---------------------------------------------------
    def bind(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, port))
        s.listen(64)
        # Poll with a timeout: closing a listener out from under a
        # thread blocked in accept() does NOT close the kernel-side
        # open file description — the old accept keeps serving the
        # port. The flag + timeout loop is the portable shutdown.
        s.settimeout(0.2)
        self._stopping = False
        self._listener = s
        self.addr = s.getsockname()
        with _addr_lock:
            _addr_names[self.addr] = self.name
        # shm-ring lane registration (always cheap; the msgr_transport
        # gate decides at connect() time whether anyone upgrades)
        shm_ring.register(self.addr, self)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True
        )
        self._accept_thread.start()
        return self.addr

    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                sock, _peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # Finish connection setup off the accept thread: the secure
            # handshake blocks up to its 5 s timeout, and one silent
            # connector must not starve other peers' accepts.
            threading.Thread(
                target=self._finish_accept, args=(sock,), daemon=True
            ).start()
        try:
            self._listener.close()
        except OSError:
            pass

    def _finish_accept(self, sock: socket.socket) -> None:
        try:
            conn = Connection(sock, self, is_client=False)
        except Exception:
            return  # failed handshake drops the socket, not us
        with self._lock:
            if self._stopping:
                conn.close()
                return
            self._conns.add(conn)

    # -- client side ---------------------------------------------------
    def connect(self, addr: tuple[str, int]) -> Connection:
        # Transport negotiation: when the shm-ring lane is configured
        # and the peer listens in-process, skip the kernel socket
        # entirely — the Connection (framing, CRC, secure handshake,
        # fault-plane hooks) runs unchanged over the ring pair.
        target = shm_ring.lookup(addr)
        if target is not None:
            client_sock, server_sock = shm_ring.socketpair()
            # the server end rides the normal accept path, off-thread
            # (the secure handshake blocks, exactly like TCP accepts)
            threading.Thread(
                target=target._finish_accept,
                args=(server_sock,),
                daemon=True,
            ).start()
            conn = Connection(
                client_sock, self, is_client=True, peer_name=target.name
            )
            with self._lock:
                self._conns.add(conn)
            return conn
        sock = socket.create_connection(addr, timeout=10)
        if sock.getsockname() == sock.getpeername():
            # TCP self-connect: the kernel picked the (freed) target
            # port as our ephemeral source port — the peer is gone.
            sock.close()
            raise ConnectionError(f"self-connect to dead peer {addr}")
        sock.settimeout(None)  # connect timeout must not become a
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)  # recv timeout
        with _addr_lock:
            peer_name = _addr_names.get(tuple(addr))
        conn = Connection(sock, self, is_client=True, peer_name=peer_name)
        with self._lock:
            self._conns.add(conn)
        return conn

    def _conn_closed(self, conn: Connection) -> None:
        with self._lock:
            self._conns.discard(conn)

    def shutdown(self) -> None:
        self._stopping = True
        if self.addr is not None:
            shm_ring.unregister(self.addr, self)
            with _addr_lock:
                if _addr_names.get(self.addr) == self.name:
                    del _addr_names[self.addr]
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=1.0)
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            conn.close()
