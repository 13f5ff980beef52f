"""Scalar host reference implementation (test oracle).

``crc32c_ref`` matches ``ceph_crc32c(init, data, len)`` semantics —
raw register in/out, reflected Castagnoli polynomial, NO final XOR
(verified against src/test/common/test_crc32c.cc:21-43 vectors).
"""

from __future__ import annotations

CRC32C_POLY_REFLECTED = 0x82F63B78

_M32 = 0xFFFFFFFF


def crc32c_ref(init: int, data: bytes) -> int:
    crc = init & _M32
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (CRC32C_POLY_REFLECTED if crc & 1 else 0)
    return crc
