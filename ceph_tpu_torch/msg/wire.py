"""Framed wire protocol with per-segment CRC — the ProtocolV2 analog.

Mirrors the frame shape of msg/async/frames_v2.{h,cc}: a fixed header
(magic, message type, sequence, segment count) followed by a segment
table (length + crc32c per segment) and the segment payloads. Every
segment's crc32c is verified on decode — a flipped bit anywhere raises
``BadFrame``, the on-wire integrity contract ProtocolV2 provides
(SURVEY.md section 5.8; the reference seeds crc32c with -1).

On-wire compression is flag bit 0 (the compression_onwire.cc analog):
segments are zlib-deflated before framing and the per-segment CRC
covers the compressed bytes, so corruption is still caught before any
decompressor touches the data.

AES-GCM secure mode is flag bit 1 (the crypto_onwire.cc analog — see
secure.py): the segment table and payloads are sealed into one AEAD
blob with the frame header as associated data, and the GCM tag
REPLACES per-segment CRC (ProtocolV2 rev-1 secure mode likewise
drops crc protection in favor of the auth tag). Layout:

    header | counter u64 | ct_len u32 | ciphertext+tag

Compression composes: segments deflate first, then the whole frame
body seals. Tampering with header or body raises ``BadFrame`` via the
AEAD check; replayed frames are rejected by the session counter.

Clear-mode (CRC) frames have a native fast path: header + segment
table + per-segment crc32c assemble/verify in one C call each
(native/src/ceph_tpu_torch_native.cc frame codec), gated on
``msgr_native_codec`` and ``CEPH_TPU_TORCH_NO_NATIVE``, bit-identical to
the pure-Python path kept below as the fallback and oracle.
"""

from __future__ import annotations

import struct
import zlib

from ceph_tpu_torch.checksum import crc32c_wire as _crc32c_host
from ceph_tpu_torch.utils.config import config as _config

MAGIC = b"CTv2"
_HDR = struct.Struct("<4sHBBQ")  # magic, type, flags, nseg, seq
#: bytes of a frame's fixed header, the first read ``decode_frame`` makes
HEADER_BYTES = _HDR.size
_SEG = struct.Struct("<II")      # length, crc32c
_SLEN = struct.Struct("<I")      # secure mode: plain length table entry
_SECHDR = struct.Struct("<QI")   # secure mode: counter, ciphertext len
CRC_SEED = 0xFFFFFFFF

FLAG_COMPRESSED = 0x01
FLAG_SECURE = 0x02

MAX_SEGMENTS = 8
MAX_SEGMENT_BYTES = 1 << 30


class BadFrame(Exception):
    pass


def _crc(data: bytes) -> int:
    return _crc32c_host(CRC_SEED, data)


# Native frame codec (ceph_tpu_torch_native.cc frame_encode/frame_verify):
# the clear-mode header+table+CRC assembly runs as one C call instead
# of per-segment struct.pack / bytes churn. The module probe is cached;
# the config gate (msgr_native_codec) is read per frame so bench A/B
# legs can flip it with config.override. CEPH_TPU_TORCH_NO_NATIVE disables
# the probe entirely; the pure-Python path below stays bit-identical
# (pinned by tests/test_torch_msg.py).
_native_mod = None
_native_probed = False


def _native():
    global _native_mod, _native_probed
    if not _native_probed:
        _native_probed = True
        try:
            from ceph_tpu_torch import native as _n

            if _n.available():
                _native_mod = _n
        except Exception:
            _native_mod = None
    return _native_mod


def _codec():
    """The native codec module when loaded AND enabled, else None."""
    mod = _native()
    if mod is None:
        return None
    return mod if _config.get("msgr_native_codec") else None


def encode_frame(
    msg_type: int,
    seq: int,
    segments: list[bytes],
    compress: bool = False,
    secure=None,
) -> bytes:
    """Frame ``segments``; ``secure`` is a secure.SecureSession for
    AES-GCM sealing (tx direction) or None for crc mode."""
    if not 0 < len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"1..{MAX_SEGMENTS} segments, got {len(segments)}")
    flags = 0
    if compress:
        flags |= FLAG_COMPRESSED
        segments = [zlib.compress(seg, 1) for seg in segments]
    if secure is not None:
        flags |= FLAG_SECURE
        hdr = _HDR.pack(MAGIC, msg_type, flags, len(segments), seq)
        body = bytearray()
        for seg in segments:
            body += _SLEN.pack(len(seg))
        for seg in segments:
            body += seg
        counter, ct = secure.seal(hdr, bytes(body))
        return hdr + _SECHDR.pack(counter, len(ct)) + ct
    codec = _codec()
    if codec is not None:
        return codec.frame_encode(msg_type, flags, seq, segments)
    out = bytearray(_HDR.pack(MAGIC, msg_type, flags, len(segments), seq))
    for seg in segments:
        out += _SEG.pack(len(seg), _crc(seg))
    for seg in segments:
        out += seg
    return bytes(out)


def decode_frame(read_exact, secure=None) -> tuple[int, int, list[bytes]]:
    """Parse one frame from ``read_exact(n) -> bytes`` (raises
    ``EOFError`` at stream end). Returns (msg_type, seq, segments).
    Compressed frames are transparently inflated AFTER CRC (or AEAD)
    checks. ``secure`` is the rx-direction secure.SecureSession; a
    secure frame arriving without one (or vice versa) is rejected —
    mode is negotiated per connection, not per frame."""
    hdr = read_exact(_HDR.size)
    magic, msg_type, flags, nseg, seq = _HDR.unpack(hdr)
    if magic != MAGIC:
        raise BadFrame(f"bad magic {magic!r}")
    if flags & ~(FLAG_COMPRESSED | FLAG_SECURE):
        raise BadFrame(f"unsupported flags {flags:#x}")
    if not 0 < nseg <= MAX_SEGMENTS:
        raise BadFrame(f"bad segment count {nseg}")
    if bool(flags & FLAG_SECURE) != (secure is not None):
        raise BadFrame(
            "secure-mode mismatch: frame "
            + ("sealed" if flags & FLAG_SECURE else "clear")
            + " but session "
            + ("clear" if secure is None else "secure")
        )
    if secure is not None:
        from .secure import SecurityError

        counter, ct_len = _SECHDR.unpack(read_exact(_SECHDR.size))
        if ct_len > MAX_SEGMENT_BYTES:
            raise BadFrame(f"ciphertext too large: {ct_len}")
        try:
            body = secure.open(hdr, counter, read_exact(ct_len))
        except SecurityError as e:
            raise BadFrame(str(e)) from e
        pos = nseg * _SLEN.size
        lengths = [
            _SLEN.unpack_from(body, i * _SLEN.size)[0] for i in range(nseg)
        ]
        if pos + sum(lengths) != len(body):
            raise BadFrame("secure body length mismatch")
        segments = []
        for length in lengths:
            seg = body[pos : pos + length]
            pos += length
            if flags & FLAG_COMPRESSED:
                try:
                    seg = zlib.decompress(seg)
                except zlib.error as e:
                    raise BadFrame(f"segment inflate failed: {e}") from e
            segments.append(seg)
        return msg_type, seq, segments
    # Clear mode: one read for the whole segment table, one for the
    # concatenated payloads (fewer recv round-trips than the old
    # entry-at-a-time loop), then a single native batch CRC verify
    # when the codec is armed — per-segment Python CRC otherwise.
    table_raw = read_exact(nseg * _SEG.size)
    table = []
    total = 0
    for length, crc in _SEG.iter_unpack(table_raw):
        if length > MAX_SEGMENT_BYTES:
            raise BadFrame(f"segment too large: {length}")
        table.append((length, crc))
        total += length
    payload = read_exact(total)
    codec = _codec()
    if codec is not None:
        bad = codec.frame_verify(table_raw, payload)
        if bad == -2:
            raise BadFrame("segment table/payload length mismatch")
        if bad >= 0:
            raise BadFrame(
                f"segment crc mismatch: segment {bad}"
                f" want {table[bad][1]:#x}"
            )
    segments = []
    pos = 0
    for length, crc in table:
        seg = payload[pos : pos + length]
        pos += length
        if codec is None and _crc(seg) != crc:
            raise BadFrame(
                f"segment crc mismatch: got {_crc(seg):#x} want {crc:#x}"
            )
        if flags & FLAG_COMPRESSED:
            try:
                seg = zlib.decompress(seg)
            except zlib.error as e:
                raise BadFrame(f"segment inflate failed: {e}") from e
        segments.append(seg)
    return msg_type, seq, segments


def frame_from_buffer(buf: bytes, secure=None) -> tuple[int, int, list[bytes]]:
    """Decode a frame held fully in memory (tests / datagram use)."""
    pos = 0

    def read_exact(n: int) -> bytes:
        nonlocal pos
        if pos + n > len(buf):
            raise EOFError
        out = buf[pos : pos + n]
        pos += n
        return out

    return decode_frame(read_exact, secure=secure)
