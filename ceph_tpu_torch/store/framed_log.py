"""Crc-framed append-only log — the shared WAL framing used by both
the FileStore journal and the monitor store (one implementation of
the length+crc32c record format, one torn-tail policy).

Records are ``<u32 len><u32 crc32c(payload)><payload>``. ``scan``
returns every intact record plus the byte offset where validity ends;
``replay`` additionally TRUNCATES the file at that offset — a torn
tail must not survive, or appends after a crash would land behind it
and every later record would be unreachable to the next scan.
"""

from __future__ import annotations

import os
import struct

from ceph_tpu_torch.checksum import crc32c_scalar as _crc

HDR = struct.Struct("<II")


def append(path: str, payload: bytes, sync: bool = True) -> None:
    with open(path, "ab") as f:
        f.write(HDR.pack(len(payload), _crc(0xFFFFFFFF, payload)))
        f.write(payload)
        if sync:
            f.flush()
            os.fsync(f.fileno())


def scan(raw: bytes) -> tuple[list[bytes], int]:
    """Intact payloads + the offset where the valid prefix ends."""
    out: list[bytes] = []
    pos = 0
    while pos + HDR.size <= len(raw):
        length, crc = HDR.unpack_from(raw, pos)
        payload = raw[pos + HDR.size : pos + HDR.size + length]
        if len(payload) < length or _crc(0xFFFFFFFF, payload) != crc:
            break  # torn tail
        out.append(payload)
        pos += HDR.size + length
    return out, pos


def replay(path: str) -> list[bytes]:
    """Read intact records; truncate any torn tail away."""
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        raw = f.read()
    payloads, valid = scan(raw)
    if valid < len(raw):
        with open(path, "r+b") as f:
            f.truncate(valid)
            f.flush()
            os.fsync(f.fileno())
    return payloads
