"""The port's messenger tier (``msg/``: wire frames, messages, the
shared-memory ring lane, the messenger and the shard server) against
ceph_tpu's, on the CPU.

The mirrors run the reference's ``tests/test_wire_native.py``,
``tests/test_shm_ring.py``, ``tests/test_messenger.py`` and the wire legs
of ``tests/test_format_freeze.py`` (the frame header and the
transaction op codec) against ``ceph_tpu_torch``. The twin cases hold
every message type's frame byte-equal in both directions between the
packages, compressed and not, the native and pure-Python frame codecs
equal, and the timed ring's push/pop return codes equal to the
reference's.
"""

import struct
import zlib
import pytest
import threading
from types import SimpleNamespace
import time
import numpy as np

torch = pytest.importorskip("torch")

from ceph_tpu_torch import native  # noqa: E402
from ceph_tpu_torch.msg.wire import (  # noqa: E402
    BadFrame,
    CRC_SEED,
    MAX_SEGMENTS,
    decode_frame,
    encode_frame,
    frame_from_buffer,
)
from ceph_tpu_torch.utils.config import config  # noqa: E402
from ceph_tpu_torch.msg import shm_ring  # noqa: E402
from ceph_tpu_torch.msg.messages import Ping, Pong  # noqa: E402
from ceph_tpu_torch.msg.messenger import (  # noqa: E402
    LinkRule,
    Messenger,
    net_faults,
)
from ceph_tpu_torch.codecs import registry  # noqa: E402
from ceph_tpu_torch.msg import (  # noqa: E402
    BadFrame,
    ECSubRead,
    ECSubReadReply,
    ECSubWrite,
    ECSubWriteReply,
    NetShardBackend,
    ShardServer,
    decode_message,
    encode_frame,
)
from ceph_tpu_torch.msg.messages import message_type  # noqa: E402
from ceph_tpu_torch.msg.wire import frame_from_buffer  # noqa: E402
from ceph_tpu_torch.pipeline.inject import ec_inject  # noqa: E402
from ceph_tpu_torch.pipeline.read import ReadPipeline  # noqa: E402
from ceph_tpu_torch.pipeline.recovery import RecoveryBackend  # noqa: E402
from ceph_tpu_torch.pipeline.rmw import RMWPipeline  # noqa: E402
from ceph_tpu_torch.pipeline.stripe import PAGE_SIZE, StripeInfo  # noqa: E402
from ceph_tpu_torch.store import MemStore, Transaction  # noqa: E402


# -- mirror of tests/test_wire_native.py ----------------------------------

needs_native = pytest.mark.skipif(
    not native.available(), reason="native tier unavailable"
)


def _py_frame(msg_type, seq, segments, **kw):
    with config.override(msgr_native_codec=False):
        return encode_frame(msg_type, seq, segments, **kw)


def _native_frame(msg_type, seq, segments, **kw):
    with config.override(msgr_native_codec=True):
        return encode_frame(msg_type, seq, segments, **kw)


def _py_decode(buf):
    with config.override(msgr_native_codec=False):
        return frame_from_buffer(buf)


def _native_decode(buf):
    with config.override(msgr_native_codec=True):
        return frame_from_buffer(buf)


CASES = [
    [b"x"],
    [b""],
    [b"payload" * 500],
    [b"a", b"", b"bb", b"ccc"],
    [bytes(range(256)) * 16] * MAX_SEGMENTS,
    [b"\x00" * 4096, b"\xff" * 333],
]


# ---------------------------------------------------------------------------
# encode parity: the native assembler is bit-identical to the oracle
# ---------------------------------------------------------------------------
@needs_native
class TestEncodeParity:
    @pytest.mark.parametrize("segs", CASES)
    def test_bit_identical_clear(self, segs):
        assert _native_frame(9, 77, segs) == _py_frame(9, 77, segs)

    @pytest.mark.parametrize("segs", CASES)
    def test_bit_identical_compressed(self, segs):
        a = _native_frame(9, 77, segs, compress=True)
        b = _py_frame(9, 77, segs, compress=True)
        assert a == b

    def test_header_fields_survive(self):
        for msg_type, seq in [(0, 0), (65535, 2**63), (112, 1)]:
            t, s, segs = _py_decode(_native_frame(msg_type, seq, [b"p"]))
            assert (t, s, segs) == (msg_type, seq, [b"p"])


# ---------------------------------------------------------------------------
# decode parity: either path decodes either path's frames ("legacy
# frames" = python-encoded bytes through the native verifier and
# vice versa), compression transparent, roundtrip closed
# ---------------------------------------------------------------------------
@needs_native
class TestDecodeParity:
    @pytest.mark.parametrize("segs", CASES)
    def test_cross_decode(self, segs):
        py = _py_frame(5, 3, segs)
        nat = _native_frame(5, 3, segs)
        assert _native_decode(py) == (5, 3, segs)
        assert _py_decode(nat) == (5, 3, segs)

    def test_compressed_roundtrip_both_paths(self):
        segs = [b"Z" * 20_000, b"tail"]
        buf = _native_frame(5, 3, segs, compress=True)
        assert _py_decode(buf) == (5, 3, segs)
        assert _native_decode(buf) == (5, 3, segs)

    def test_streaming_decode_native(self):
        """decode_frame's read_exact streaming entry, native armed:
        the single table read + single payload read reassemble."""
        segs = [b"a" * 100, b"b" * 17]
        buf = _native_frame(5, 9, segs)
        pos = [0]

        def read_exact(n):
            out = buf[pos[0] : pos[0] + n]
            if len(out) != n:
                raise EOFError
            pos[0] += n
            return out

        with config.override(msgr_native_codec=True):
            assert decode_frame(read_exact) == (5, 9, segs)
        assert pos[0] == len(buf)


# ---------------------------------------------------------------------------
# corruption taxonomy: truncation and bit flips raise the same
# BadFrame family through both verifiers
# ---------------------------------------------------------------------------
@needs_native
class TestCorruption:
    def test_payload_bitflip_both_paths(self):
        buf = bytearray(_py_frame(7, 1, [b"seg-one" * 50, b"seg-two" * 50]))
        buf[-3] ^= 0x40
        for dec in (_py_decode, _native_decode):
            with pytest.raises(BadFrame, match="crc"):
                dec(bytes(buf))

    def test_table_crc_bitflip(self):
        buf = bytearray(_py_frame(7, 1, [b"payload" * 100]))
        buf[16 + 4] ^= 0x01  # first table entry's crc field
        for dec in (_py_decode, _native_decode):
            with pytest.raises(BadFrame, match="crc"):
                dec(bytes(buf))

    def test_native_reports_bad_segment_index(self):
        segs = [b"a" * 64, b"b" * 64, b"c" * 64]
        buf = bytearray(_native_frame(7, 1, segs))
        buf[-1] ^= 0x80  # last byte = inside segment 2
        with pytest.raises(BadFrame, match="segment 2"):
            _native_decode(bytes(buf))

    def test_truncated_frame(self):
        buf = _native_frame(7, 1, [b"payload" * 100])
        for cut in (4, 15, 20, len(buf) - 1):
            for dec in (_py_decode, _native_decode):
                with pytest.raises((BadFrame, EOFError)):
                    dec(buf[:cut])

    def test_bad_magic_checked_before_codec(self):
        buf = bytearray(_native_frame(7, 1, [b"x"]))
        buf[0] ^= 0xFF
        for dec in (_py_decode, _native_decode):
            with pytest.raises(BadFrame, match="magic"):
                dec(bytes(buf))

    def test_compressed_corruption_caught_by_crc_first(self):
        """Corrupt compressed bytes die at the CRC gate, never inside
        the decompressor — on both paths."""
        buf = bytearray(_native_frame(7, 1, [b"Q" * 30_000], compress=True))
        buf[30] ^= 0x10
        for dec in (_py_decode, _native_decode):
            with pytest.raises(BadFrame, match="crc"):
                dec(bytes(buf))


# ---------------------------------------------------------------------------
# secure mode: the AEAD path bypasses the codec entirely (GCM tag
# replaces per-segment CRC) — the codec gate must not disturb it
# ---------------------------------------------------------------------------
class TestSecureMode:
    def test_secure_frames_identical_with_codec_armed(self):
        pytest.importorskip(
            "cryptography.hazmat.primitives.ciphers.aead",
            reason="secure mode needs the cryptography package",
        )
        from ceph_tpu_torch.msg.secure import KEY_BYTES, SALT_BYTES, SecureSession

        key, salt = b"k" * KEY_BYTES, b"s" * SALT_BYTES
        segs = [b"sealed-payload" * 10]
        tx_a = SecureSession(key, salt)
        tx_b = SecureSession(key, salt)
        with config.override(msgr_native_codec=True):
            sealed_a = encode_frame(3, 8, segs, secure=tx_a)
        with config.override(msgr_native_codec=False):
            sealed_b = encode_frame(3, 8, segs, secure=tx_b)
        assert sealed_a == sealed_b
        rx = SecureSession(key, salt)
        with config.override(msgr_native_codec=True):
            assert frame_from_buffer(sealed_a, secure=rx) == (3, 8, segs)

    def test_clear_frame_on_secure_session_still_rejected(self):
        buf = _py_frame(3, 8, [b"x"])
        with pytest.raises(BadFrame, match="secure-mode mismatch"):
            frame_from_buffer(buf, secure=object())


# ---------------------------------------------------------------------------
# satellite 1: CRC oracle across every checksum backend — the wire
# CRC must be byte-identical no matter which implementation serves it
# ---------------------------------------------------------------------------
class TestCrcOracle:
    VECTORS = [
        b"",
        b"a",
        b"123456789",
        bytes(range(256)),
        b"\x00" * 4096,
        b"payload" * 1000,
    ]

    def _backends(self):
        from ceph_tpu_torch.checksum import crc32c_scalar, crc32c_wire
        from ceph_tpu_torch.checksum.reference import crc32c_ref

        backends = {
            "wire": crc32c_wire,
            "scalar": crc32c_scalar,
            "ref": crc32c_ref,
        }
        if native.available():
            backends["native"] = native.crc32c
            backends["native_bytes"] = native.crc32c_bytes
        return backends

    @pytest.mark.parametrize("data", VECTORS)
    def test_all_backends_agree(self, data):
        got = {
            name: fn(CRC_SEED, data) & 0xFFFFFFFF
            for name, fn in self._backends().items()
        }
        assert len(set(got.values())) == 1, got

    def test_wire_crc_matches_frame_table(self):
        """The CRC the frame table carries IS crc32c_wire(seed, seg) —
        pinned so a backend swap can never silently reframe."""
        from ceph_tpu_torch.checksum import crc32c_wire

        seg = b"pinned-segment" * 9
        buf = _py_frame(7, 1, [seg])
        _len, crc = struct.unpack_from("<II", buf, 16)
        assert crc == crc32c_wire(CRC_SEED, seg) & 0xFFFFFFFF

    def test_seeded_not_plain_crc32(self):
        seg = b"123456789"
        from ceph_tpu_torch.checksum import crc32c_wire

        assert crc32c_wire(CRC_SEED, seg) != zlib.crc32(seg)


# ---------------------------------------------------------------------------
# config gate: msgr_native_codec=false forces the oracle path even
# when the native tier is loaded
# ---------------------------------------------------------------------------
@needs_native
def test_codec_gate_respected(monkeypatch):
    from ceph_tpu_torch.msg import wire

    calls = []
    real = native.frame_encode

    def spy(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(wire._native(), "frame_encode", spy, raising=False)
    with config.override(msgr_native_codec=False):
        encode_frame(7, 1, [b"x"])
    assert not calls
    with config.override(msgr_native_codec=True):
        encode_frame(7, 1, [b"x"])
    assert calls


# -- mirror of tests/test_shm_ring.py -------------------------------------

@pytest.fixture(autouse=True)
def clean_plane():
    net_faults.clear()
    net_faults.reset_counters()
    shm_ring.reset_stats()
    yield
    net_faults.clear()
    net_faults.reset_counters()


def _pair(transport, server_name="osd.50", client_name="cli.s"):
    srv = Messenger(server_name)
    srv_got = []
    srv.set_dispatcher(lambda c, m: srv_got.append(m))
    addr = srv.bind()
    cli = Messenger(client_name)
    cli_got = []
    cli.set_dispatcher(lambda c, m: cli_got.append(m))
    with config.override(msgr_transport=transport):
        conn = cli.connect(addr)
    return srv, srv_got, cli, cli_got, conn


def _wait(pred, timeout=2.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


# ---------------------------------------------------------------------------
# lane negotiation
# ---------------------------------------------------------------------------
class TestNegotiation:
    def test_shm_lane_taken_for_in_process_peer(self):
        srv, srv_got, cli, _cg, conn = _pair("shm_ring")
        try:
            assert isinstance(conn.sock, shm_ring.RingSock)
            assert conn.peer_name == "osd.50"
            conn.send(Ping(1, 0))
            assert _wait(lambda: srv_got)
            assert srv_got[0].tid == 1
            assert shm_ring.snapshot()["connections"] == 1
        finally:
            cli.shutdown()
            srv.shutdown()

    def test_tcp_default_untouched(self):
        srv, srv_got, cli, _cg, conn = _pair("tcp")
        try:
            assert not isinstance(conn.sock, shm_ring.RingSock)
            conn.send(Ping(2, 0))
            assert _wait(lambda: srv_got)
        finally:
            cli.shutdown()
            srv.shutdown()

    def test_unregistered_address_falls_back_to_tcp(self):
        """shm_ring configured but the peer is not in-process (no
        registry entry): the dial transparently goes TCP."""
        srv = Messenger("osd.51")
        got = []
        srv.set_dispatcher(lambda c, m: got.append(m))
        addr = srv.bind()
        shm_ring.unregister(addr, srv)  # simulate an out-of-process peer
        cli = Messenger("cli.f")
        try:
            with config.override(msgr_transport="shm_ring"):
                conn = cli.connect(addr)
            assert not isinstance(conn.sock, shm_ring.RingSock)
            conn.send(Ping(3, 0))
            assert _wait(lambda: got)
        finally:
            cli.shutdown()
            srv.shutdown()


# ---------------------------------------------------------------------------
# stream semantics: big frames, bidirectional traffic, teardown
# ---------------------------------------------------------------------------
class TestStream:
    def test_pingpong_roundtrip(self):
        srv, _sg, cli, cli_got, conn = _pair("shm_ring")
        srv.set_dispatcher(lambda c, m: c.send(Pong(m.tid, 7)))
        try:
            for i in range(25):
                conn.send(Ping(i, 0))
            assert _wait(lambda: len(cli_got) == 25)
            assert [m.tid for m in cli_got] == list(range(25))
        finally:
            cli.shutdown()
            srv.shutdown()

    def test_frame_larger_than_slot(self):
        """A frame spanning many ring slots reassembles byte-exact
        (chunking is below the framing layer)."""
        from ceph_tpu_torch.msg.messages import OSDOp

        srv, srv_got, cli, _cg, conn = _pair("shm_ring")
        try:
            data = bytes(range(256)) * 1024  # 256 KiB >> SLOT_BYTES
            conn.send(OSDOp(9, 1, "pool", "obj", "write", data=data))
            assert _wait(lambda: srv_got)
            assert srv_got[0].data == data
        finally:
            cli.shutdown()
            srv.shutdown()

    def test_send_after_shutdown_raises(self):
        srv, _sg, cli, _cg, conn = _pair("shm_ring")
        srv.shutdown()
        assert _wait(lambda: not conn.alive)
        with pytest.raises((ConnectionError, OSError)):
            for _ in range(4):  # first sends may land in ring buffers
                conn.send(Ping(1, 0))
                time.sleep(0.05)
        cli.shutdown()

    def test_compressed_messenger_over_shm(self):
        srv = Messenger("osd.52", compress=True)
        srv_got = []
        srv.set_dispatcher(lambda c, m: srv_got.append(m))
        addr = srv.bind()
        cli = Messenger("cli.z", compress=True)
        try:
            with config.override(msgr_transport="shm_ring"):
                conn = cli.connect(addr)
            assert isinstance(conn.sock, shm_ring.RingSock)
            conn.send(Ping(4, 0))
            assert _wait(lambda: srv_got)
            assert srv_got[0].tid == 4
        finally:
            cli.shutdown()
            srv.shutdown()


# ---------------------------------------------------------------------------
# satellite 2: fault-plane parity — identical rules, seeds and
# traffic produce identical fault counters on both transports
# ---------------------------------------------------------------------------
class TestFaultParity:
    def _run_leg(self, transport, rule, n=40, seed=77):
        srv, srv_got, cli, _cg, conn = _pair(transport)
        try:
            net_faults.configure(seed)
            net_faults.add_rule("cli.s", "osd.50", rule)
            before = dict(net_faults.counters)
            for i in range(n):
                conn.send(Ping(i, 0))
            time.sleep(0.4)  # let delays/reorders flush
            after = dict(net_faults.counters)
            delta = {k: after[k] - before.get(k, 0) for k in after}
            return delta, [m.tid for m in srv_got]
        finally:
            net_faults.clear()
            cli.shutdown()
            srv.shutdown()

    @pytest.mark.parametrize(
        "rule",
        [
            LinkRule(drop=0.5),
            LinkRule(dup=0.4),
            LinkRule(delay_ms=30, delay_jitter_ms=10),
            LinkRule(drop=0.2, dup=0.2, reorder=0.3),
        ],
        ids=["drop", "dup", "delay", "mixed"],
    )
    def test_counters_match_tcp(self, rule):
        """Same seed, same link names, same traffic: the fault plane
        fires frame-for-frame identically over shm rings and TCP —
        the plane sits above the transport, so the per-lane RNG
        draws the same sequence either way."""
        tcp_delta, tcp_tids = self._run_leg("tcp", rule)
        net_faults.reset_counters()
        shm_delta, shm_tids = self._run_leg("shm_ring", rule)
        assert shm_delta == tcp_delta
        # delivered sets match too (dup/reorder may reorder arrival,
        # drop decides by the same draws)
        assert sorted(shm_tids) == sorted(tcp_tids)

    def test_partition_blocks_shm_link(self):
        srv, srv_got, cli, _cg, conn = _pair("shm_ring")
        try:
            net_faults.configure(1)
            net_faults.add_rule("cli.s", "osd.50", LinkRule(partition=True))
            conn.send(Ping(1, 0))
            time.sleep(0.25)
            assert srv_got == []
            assert net_faults.counters["frames_dropped"] >= 1
            net_faults.clear()
            conn.send(Ping(2, 0))
            assert _wait(lambda: srv_got)
            assert [m.tid for m in srv_got] == [2]
        finally:
            cli.shutdown()
            srv.shutdown()

    def test_inbound_faults_fire_on_shm_reader(self):
        """Server->client direction faults at the client's read loop
        — same placement as TCP (the accepted end has no peer name)."""
        srv, _sg, cli, cli_got, conn = _pair("shm_ring")
        srv.set_dispatcher(lambda c, m: c.send(Pong(m.tid, 7)))
        try:
            net_faults.configure(1)
            net_faults.add_rule("osd.50", "cli.s", LinkRule(partition=True))
            conn.send(Ping(1, 0))
            time.sleep(0.25)
            assert cli_got == []
            net_faults.clear()
            conn.send(Ping(2, 0))
            assert _wait(lambda: cli_got)
            assert [m.tid for m in cli_got] == [2]
        finally:
            cli.shutdown()
            srv.shutdown()


# ---------------------------------------------------------------------------
# ring unit behavior (both native and the pure-Python fallback)
# ---------------------------------------------------------------------------
class TestRingUnits:
    @pytest.fixture(params=["auto", "pyring"])
    def ring_pair(self, request):
        if request.param == "pyring":
            return shm_ring._PyRing(4), "pyring"
        return shm_ring._make_ring(), "auto"

    def test_push_pop_fifo(self, ring_pair):
        ring, _ = ring_pair
        for i in range(3):
            assert ring.push_timed(bytes([i]) * 8, 1.0) == 1
        for i in range(3):
            rc, chunk = ring.pop_timed(1.0)
            assert rc == 1 and chunk == bytes([i]) * 8
        ring.close()

    def test_pop_timeout(self, ring_pair):
        ring, _ = ring_pair
        rc, chunk = ring.pop_timed(0.05)
        assert rc == -2 and chunk is None
        ring.close()

    def test_close_drains_then_eof(self, ring_pair):
        """FIN-then-drain: buffered chunks survive close; the pop
        after the last one reports closed (EOF), never loses data."""
        ring, _ = ring_pair
        assert ring.push_timed(b"last-words", 1.0) == 1
        ring.close()
        rc, chunk = ring.pop_timed(1.0)
        assert rc == 1 and chunk == b"last-words"
        rc, chunk = ring.pop_timed(1.0)
        assert rc == 0 and chunk is None

    def test_push_to_closed_ring_rejected(self, ring_pair):
        ring, _ = ring_pair
        ring.close()
        assert ring.push_timed(b"x", 0.2) == 0

    def test_blocked_push_wakes_on_pop(self):
        ring = shm_ring._PyRing(1)
        assert ring.push_timed(b"a", 0.5) == 1
        results = []

        def pusher():
            results.append(ring.push_timed(b"b", 2.0))

        t = threading.Thread(target=pusher)
        t.start()
        time.sleep(0.05)
        assert ring.pop_timed(0.5) == (1, b"a")
        t.join(timeout=3)
        assert results == [1]
        assert ring.pop_timed(0.5) == (1, b"b")
        ring.close()

    def test_ringsock_recv_chunk_splitting(self):
        a, b = shm_ring.socketpair()
        a.settimeout(1.0)
        b.settimeout(1.0)
        a.sendall(b"0123456789")
        assert b.recv(4) == b"0123"
        assert b.recv(4) == b"4567"
        assert b.recv(4) == b"89"
        a.close()
        assert b.recv(4) == b""  # EOF after drain


# -- mirror of tests/test_messenger.py ------------------------------------

K, M = 4, 2
CHUNK = PAGE_SIZE


@pytest.fixture(autouse=True)
def clean_inject():
    ec_inject.clear_all()
    yield
    ec_inject.clear_all()


class TestWire:
    def test_round_trip(self):
        segs = [b"header-ish", b"x" * 10000, b""]
        buf = encode_frame(7, 42, segs)
        msg_type, seq, out = frame_from_buffer(buf)
        assert (msg_type, seq, out) == (7, 42, segs)

    def test_corruption_detected(self):
        buf = bytearray(encode_frame(7, 1, [b"payload-bytes" * 100]))
        buf[-5] ^= 0x01  # flip one payload bit
        with pytest.raises(BadFrame, match="crc"):
            frame_from_buffer(bytes(buf))

    def test_bad_magic(self):
        buf = bytearray(encode_frame(7, 1, [b"x"]))
        buf[0] ^= 0xFF
        with pytest.raises(BadFrame, match="magic"):
            frame_from_buffer(bytes(buf))


class TestTransactionCodec:
    def test_round_trip(self):
        txn = (
            Transaction()
            .touch("o")
            .write("o", 4096, b"\x00\x01\x02" * 100)
            .zero("o", 0, 512)
            .truncate("o", 9999)
            .setattr("o", "hinfo_key", b"{}")
            .rmattr("o", "junk")
            .remove("gone")
        )
        back = Transaction.from_bytes(txn.to_bytes())
        assert [
            (op.kind, op.oid, op.offset, op.length, op.data, op.name)
            for op in back.ops
        ] == [
            (op.kind, op.oid, op.offset, op.length, op.data, op.name)
            for op in txn.ops
        ]


class TestMessages:
    def test_all_types_round_trip(self):
        msgs = [
            ECSubWrite(5, 2, Transaction().write("o", 0, b"abc")),
            ECSubWriteReply(5, 2, committed=True),
            ECSubRead(6, 1, "o", [(0, 4096), (8192, 12288)], [(0, 4)]),
            ECSubReadReply(6, 1, [0, 8192], [b"a" * 10, b"b" * 20]),
            ECSubReadReply(7, 3, error="eio"),
        ]
        for msg in msgs:
            buf = encode_frame(message_type(msg), 1, msg.encode())
            msg_type, _seq, segs = frame_from_buffer(buf)
            back = decode_message(msg_type, segs)
            assert type(back) is type(msg)
            if isinstance(msg, ECSubWrite):
                assert back.txn.to_bytes() == msg.txn.to_bytes()
                assert (back.tid, back.shard) == (msg.tid, msg.shard)
            else:
                assert back == msg


def boot_cluster(n=K + M, timeout=3.0):
    servers = {s: ShardServer(s) for s in range(n)}
    addrs = {s: srv.start() for s, srv in servers.items()}
    backend = NetShardBackend(addrs, timeout=timeout)
    return servers, backend


class TestCompression:
    def test_compressed_round_trip(self):
        segs = [b"header", b"A" * 50_000]
        buf = encode_frame(7, 1, segs, compress=True)
        assert len(buf) < 1000  # deflate crushed the run
        assert frame_from_buffer(buf)[2] == segs

    def test_compressed_corruption_detected(self):
        buf = bytearray(encode_frame(7, 1, [b"B" * 10_000], compress=True))
        buf[-3] ^= 0x01
        with pytest.raises(BadFrame, match="crc"):
            frame_from_buffer(bytes(buf))

    def test_compressed_messenger_end_to_end(self, rng):
        """A compressing client against a plain server: receivers
        auto-detect per frame, so mixed peers interoperate."""
        server = ShardServer(0)
        addr = server.start()
        backend = NetShardBackend({0: addr}, timeout=3.0)
        backend.messenger.compress = True
        try:
            payload = bytes(1000) + rng.integers(0, 4, 5000, np.uint8).tobytes()
            acked = []
            backend.submit_shard_txn(
                0,
                Transaction().write("o", 0, payload),
                lambda: acked.append(True),
            )
            backend.drain_until(lambda: acked)
            from ceph_tpu_torch.pipeline.extents import ExtentSet

            out = backend.read_shard(0, "o", ExtentSet([(0, len(payload))]))
            assert out[0] == payload
        finally:
            backend.shutdown()
            server.stop()


class TestHeartbeat:
    def test_detects_dead_daemon_without_io(self):
        servers, backend = boot_cluster(3, timeout=3.0)
        try:
            backend.start_heartbeat(period=0.05, grace=0.3)
            time.sleep(0.3)
            assert backend.down_shards == set()
            servers[1].stop()
            deadline = time.monotonic() + 5.0
            while 1 not in backend.down_shards:
                assert time.monotonic() < deadline, "heartbeat never fired"
                time.sleep(0.05)
            assert backend.avail_shards() == {0, 2}
        finally:
            backend.shutdown()
            for srv in servers.values():
                srv.stop()

    def test_set_addr_revives(self):
        servers, backend = boot_cluster(2, timeout=3.0)
        try:
            backend.start_heartbeat(period=0.05, grace=0.3)
            servers[0].stop()
            deadline = time.monotonic() + 5.0
            while 0 not in backend.down_shards:
                assert time.monotonic() < deadline
                time.sleep(0.05)
            replacement = ShardServer(0)
            backend.set_addr(0, replacement.start())
            time.sleep(0.4)  # heartbeats flow again; no re-down
            assert 0 not in backend.down_shards
            replacement.stop()
        finally:
            backend.shutdown()
            for srv in servers.values():
                srv.stop()


class TestShardServer:
    def test_write_then_read(self, rng):
        servers, backend = boot_cluster(1)
        try:
            payload = rng.integers(0, 256, 10000, np.uint8).tobytes()
            acked = []
            backend.submit_shard_txn(
                0,
                Transaction().write("o", 0, payload),
                lambda: acked.append(True),
            )
            backend.drain_until(lambda: acked)
            assert acked == [True]
            from ceph_tpu_torch.pipeline.extents import ExtentSet

            out = backend.read_shard(0, "o", ExtentSet([(0, 10000)]))
            assert out[0] == payload
            # absent tail zero-pads, absent object reads as zeros
            out = backend.read_shard(0, "ghost", ExtentSet([(0, 16)]))
            assert out[0] == b"\0" * 16
        finally:
            backend.shutdown()
            for srv in servers.values():
                srv.stop()


class TestDistributedPipeline:
    def make(self, timeout=3.0):
        servers, backend = boot_cluster(timeout=timeout)
        sinfo = StripeInfo(K, M, K * CHUNK)
        codec = registry.factory(
            "jerasure",
            {"technique": "reed_sol_van", "k": str(K), "m": str(M)}, device="cpu"
        )
        rmw = RMWPipeline(sinfo, codec, backend, perf_name="net_rmw")
        reads = ReadPipeline(
            sinfo, codec, backend, rmw.object_size, perf_name="net_read"
        )
        return servers, backend, sinfo, codec, rmw, reads

    def teardown_cluster(self, servers, backend):
        backend.shutdown()
        for srv in servers.values():
            srv.stop()

    @staticmethod
    def net_write(rmw, backend, oid, offset, data):
        """Submit + drain: sub-write acks arrive via the event loop."""
        done = []
        rmw.submit(oid, offset, data, lambda op: done.append(op.tid))
        backend.drain_until(lambda: done)
        return done

    def test_write_read_over_sockets(self, rng):
        servers, backend, sinfo, codec, rmw, reads = self.make()
        try:
            data = rng.integers(
                0, 256, 3 * K * CHUNK + 501, np.uint8
            ).tobytes()
            done = self.net_write(rmw, backend, "obj", 0, data)
            assert done == [1]  # all k+m sub-writes acked over the wire
            assert reads.read_sync("obj", 0, len(data)) == data
            # the shard stores really hold the data remotely
            assert servers[0].store.exists("obj")
        finally:
            self.teardown_cluster(servers, backend)

    def test_daemon_death_degraded_read_and_recovery(self, rng):
        servers, backend, sinfo, codec, rmw, reads = self.make()
        try:
            data = rng.integers(0, 256, 2 * K * CHUNK, np.uint8).tobytes()
            self.net_write(rmw, backend, "obj", 0, data)
            # Kill shard 1's daemon: first read discovers the failure,
            # marks it down, and reconstructs.
            old_store = servers[1].store
            servers[1].stop()
            assert reads.read_sync("obj", 0, len(data)) == data
            assert 1 in backend.down_shards

            # Replacement daemon on a new port; backfill over the wire.
            replacement = ShardServer(1, MemStore("osd.1.reborn"))
            backend.set_addr(1, replacement.start())
            rec = RecoveryBackend(
                sinfo, codec, backend, rmw.object_size, rmw.hinfo,
                perf_name="net_recovery",
            )
            rec.recover_object("obj", {1})
            assert replacement.store.read("obj") == old_store.read("obj")
            # And the recovered shard serves reads with another down.
            servers[0].stop()
            assert reads.read_sync("obj", 0, len(data)) == data
            replacement.stop()
        finally:
            self.teardown_cluster(servers, backend)

    def test_inject_eio_server_side(self, rng):
        servers, backend, sinfo, codec, rmw, reads = self.make()
        try:
            data = rng.integers(0, 256, K * CHUNK, np.uint8).tobytes()
            self.net_write(rmw, backend, "obj", 0, data)
            ec_inject.read_error("obj", 0, duration=1, shard=2)
            assert reads.read_sync("obj", 0, len(data)) == data
            assert reads.perf.get("retries") >= 1
        finally:
            self.teardown_cluster(servers, backend)


# -- mirror of the wire legs of tests/test_format_freeze.py ----------

class TestWireFrameFrozen:
    GOLDEN = bytes.fromhex(
        "43547632070000022a000000000000000a0000008aef3e8d0d000000"
        "c623f6106865616465722d6973687061796c6f61642d6279746573"
    )

    def test_frame_bytes_frozen(self):
        from ceph_tpu_torch.msg.wire import encode_frame

        assert (
            encode_frame(7, 42, [b"header-ish", b"payload-bytes"])
            == self.GOLDEN
        )

    def test_golden_decodes(self):
        from ceph_tpu_torch.msg.wire import frame_from_buffer

        assert frame_from_buffer(self.GOLDEN) == (
            7, 42, [b"header-ish", b"payload-bytes"],
        )


class TestTransactionCodecFrozen:
    GOLDEN_TXN = bytes.fromhex(
        "010400000001030000006f626a40000000000000000500000000000000"
        "0000000005000000627974657305030000006f626a0000000000000000"
        "00000000000000000100000061010000007603030000006f626a640000"
        "0000000000000000000000000000000000000000000404000000676f6e"
        "65000000000000000000000000000000000000000000000000"
    )

    def test_txn_payload_frozen(self):
        """The binary op-list payload of an ECSubWrite (explicit stable
        op codes — enum reorder must never re-number the wire)."""
        from ceph_tpu_torch.msg.messages import ECSubWrite
        from ceph_tpu_torch.store import Transaction

        txn = (
            Transaction()
            .write("obj", 64, b"bytes")
            .setattr("obj", "a", b"v")
            .truncate("obj", 100)
            .remove("gone")
        )
        segs = ECSubWrite(5, 2, txn).encode()
        assert len(segs) == 2
        assert segs[1] == self.GOLDEN_TXN

    def test_golden_decodes(self):
        from ceph_tpu_torch.msg.messages import ECSubWrite
        from ceph_tpu_torch.store import OpKind

        hdr = (
            b'{"v": 1, "kind": "sub_write", "tid": 5, "shard": 2}'
        )
        msg = ECSubWrite.decode([hdr, self.GOLDEN_TXN])
        kinds = [op.kind for op in msg.txn.ops]
        assert kinds == [
            OpKind.WRITE, OpKind.SETATTR, OpKind.TRUNCATE, OpKind.REMOVE,
        ]
        assert msg.txn.ops[0].data == b"bytes"


# -- twins: frames and messages byte-equal across the packages ---------

def _pkg(root):
    import importlib

    return SimpleNamespace(
        messages=importlib.import_module(f"{root}.msg.messages"),
        wire=importlib.import_module(f"{root}.msg.wire"),
        store=importlib.import_module(f"{root}.store"),
        native=importlib.import_module(f"{root}.native"),
        config=importlib.import_module(f"{root}.utils.config").config,
    )


REF_MSG, PORT_MSG = _pkg("ceph_tpu"), _pkg("ceph_tpu_torch")


def _every_message(pkg):
    """One instance of every message type, built in ``pkg``."""
    m, T = pkg.messages, pkg.store.Transaction
    txn = (T().write("1:o#s2", 64, b"bytes" * 9).setattr("1:o#s2", "a", b"v")
           .truncate("1:o#s2", 100).remove("gone"))
    return [
        m.ECSubWrite(5, 2, txn, trace_id="t1", parent_span="p1", epoch=9,
                     from_osd=3),
        m.ECSubWriteReply(5, 2, committed=False),
        m.ECSubWriteBatch(11, 4, [(5, 2, 9, 3, txn), (6, 1, 9, 3, T())]),
        m.ECSubWriteBatchReply(11, 4, [(5, True), (6, False)]),
        m.ECSubRead(6, 1, "o", [(0, 4096), (8192, 12288)], [(0, 4)],
                    logical=3, trace_id="t", parent_span="s"),
        m.ECSubReadReply(6, 1, [0, 8192], [b"a" * 10, b"b" * 20]),
        m.ECSubReadReply(7, 3, error="eio"),
        m.Ping(1, 2),
        m.Pong(1, 2),
        m.OSDOp(12, 7, "rbd", "obj", "write", offset=4096, length=3,
                data=b"xyz", reqid="client.1:12", tenant="gold"),
        m.OSDOp(13, 7, "rbd", "obj", "read", length=8192),
        m.OSDOpReply(12, 7, size=4099, data=b"ok"),
        m.OSDOpReply(13, 7, error="enoent"),
        m.PGList(2, 0, 1, 32, 5),
        m.PGListReply(2, 0, [("1:a", 3, 4096), ("1:b", 0, 0)]),
        m.PGInfo(3, 1, 1, 32, 5, epoch=8),
        m.PGInfoReply(3, 1, 7, 6, 42),
        m.PGActivate(4, 1, 1, 5, 8),
        m.PGActivateAck(4, 1),
        m.BackfillReserve(5, 2, "request", 1, 5, prio=3),
        m.BackfillReserveReply(5, 2, granted=False),
        m.GetAttrs(6, 3, "1:o#s3", ["hinfo_key", "_"]),
        m.GetAttrsReply(6, 3, {"hinfo_key": b"\x00\x01", "_": b"oi"}),
        m.GetAttrsReply(7, 3, error="enoent"),
        m.WatchNotify(1, "cookie", "rbd", "obj", b"payload"),
        m.NotifyAck(1, "cookie"),
        m.DcnHello(0, 2, 1, 2),
        m.DcnCmd(8, "encode", {"k": 4}, b"\x01\x02"),
        m.DcnReply(8, 1, {"ok": True}, b"\x03"),
    ]


def _frame(pkg, msg, seq, compress):
    return pkg.wire.encode_frame(pkg.messages.message_type(msg), seq,
                                 msg.encode(), compress=compress)


def test_twin_covers_every_message_type():
    built = {type(msg).__name__ for msg in _every_message(PORT_MSG)}
    assert built == {cls.__name__ for cls in PORT_MSG.messages._TYPE_OF}


@pytest.mark.parametrize("compress", [False, True])
def test_twin_frames_byte_equal_both_ways(compress):
    for seq, (ref, port) in enumerate(zip(_every_message(REF_MSG),
                                          _every_message(PORT_MSG))):
        buf = _frame(PORT_MSG, port, seq, compress)
        assert buf == _frame(REF_MSG, ref, seq, compress), type(port)
        # port frame -> ceph_tpu message, and back
        t, s, segs = REF_MSG.wire.frame_from_buffer(buf)
        back = REF_MSG.messages.decode_message(t, segs)
        assert _frame(REF_MSG, back, s, compress) == buf
        # ceph_tpu frame -> port message, and back
        t, s, segs = PORT_MSG.wire.frame_from_buffer(
            _frame(REF_MSG, ref, seq, compress))
        back = PORT_MSG.messages.decode_message(t, segs)
        assert type(back).__name__ == type(port).__name__
        assert _frame(PORT_MSG, back, s, compress) == buf


@pytest.mark.parametrize("compress", [False, True])
def test_twin_native_and_python_codecs_equal(compress):
    if not PORT_MSG.native.available():
        pytest.skip("the native host tier did not build")
    for seq, msg in enumerate(_every_message(PORT_MSG)):
        bufs = []
        for native in (True, False):
            with PORT_MSG.config.override(msgr_native_codec=native):
                bufs.append(_frame(PORT_MSG, msg, seq, compress))
                assert PORT_MSG.wire.frame_from_buffer(bufs[-1])[1] == seq
        assert bufs[0] == bufs[1], type(msg)


def test_twin_native_frame_verify_codes_equal():
    if not (PORT_MSG.native.available() and REF_MSG.native.available()):
        pytest.skip("a native host tier did not build")
    frame = _frame(PORT_MSG, _every_message(PORT_MSG)[0], 1, False)
    nseg = frame[7]
    table, payload = frame[16:16 + 8 * nseg], frame[16 + 8 * nseg:]
    flipped = bytearray(payload)
    flipped[-1] ^= 1
    for tbl, pay in ((table, payload), (table, bytes(flipped)),
                     (table, payload[:-1])):
        assert PORT_MSG.native.frame_verify(tbl, pay) == \
            REF_MSG.native.frame_verify(tbl, pay)
    assert PORT_MSG.native.frame_verify(table, payload) == -1


def test_twin_timed_ring_return_codes():
    if not (PORT_MSG.native.available() and REF_MSG.native.available()):
        pytest.skip("a native host tier did not build")

    def run(native):
        ring = native.RingBuffer(2, 64)
        out = [ring.push_timed(b"a" * 10, 0.01),
               ring.push_timed(b"b" * 64, 0.01),
               ring.push_timed(b"c", 0.01)]  # full: times out
        out += [ring.pop_timed(0.01), ring.pop_timed(0.01),
                ring.pop_timed(0.01)]  # empty: times out
        try:
            ring.push_timed(b"x" * 65, 0.01)
        except ValueError:
            out.append("overflow")
        ring.push_timed(b"d", None)
        ring.close()
        out += [ring.pop_timed(0.01), ring.pop_timed(0.01),
                ring.push_timed(b"e", 0.01)]
        return out

    got = run(PORT_MSG.native)
    assert got == run(REF_MSG.native)
    assert got[:3] == [1, 1, -2] and got[5] == (-2, None)
    assert got[7] == (1, b"d") and got[8] == (0, None) and got[9] == 0
