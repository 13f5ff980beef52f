"""Scalar host reference implementations (test oracles).

``crc32c_ref`` matches ``ceph_crc32c(init, data, len)`` semantics —
raw register in/out, reflected Castagnoli polynomial, NO final XOR
(verified against src/test/common/test_crc32c.cc:21-43 vectors).
``xxh32_ref``/``xxh64_ref`` match the vendored xxHash used by
Checksummer (src/common/Checksummer.h:137-193), verified against the
canonical XXH32/XXH64 test vectors.
"""

from __future__ import annotations

CRC32C_POLY_REFLECTED = 0x82F63B78

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def crc32c_ref(init: int, data: bytes) -> int:
    crc = init & _M32
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (CRC32C_POLY_REFLECTED if crc & 1 else 0)
    return crc


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


_P32 = (2654435761, 2246822519, 3266489917, 668265263, 374761393)
_P64 = (
    11400714785074694791,
    14029467366897019727,
    1609587929392839161,
    9650029242287828579,
    2870177450012600261,
)


def xxh32_ref(data: bytes, seed: int = 0) -> int:
    p1, p2, p3, p4, p5 = _P32
    n = len(data)
    i = 0
    if n >= 16:
        acc = [
            (seed + p1 + p2) & _M32,
            (seed + p2) & _M32,
            seed & _M32,
            (seed - p1) & _M32,
        ]
        while i + 16 <= n:
            for j in range(4):
                lane = int.from_bytes(data[i + 4 * j : i + 4 * j + 4], "little")
                a = (acc[j] + lane * p2) & _M32
                acc[j] = (_rotl32(a, 13) * p1) & _M32
            i += 16
        h = (
            _rotl32(acc[0], 1)
            + _rotl32(acc[1], 7)
            + _rotl32(acc[2], 12)
            + _rotl32(acc[3], 18)
        ) & _M32
    else:
        h = (seed + p5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        lane = int.from_bytes(data[i : i + 4], "little")
        h = (h + lane * p3) & _M32
        h = (_rotl32(h, 17) * p4) & _M32
        i += 4
    while i < n:
        h = (h + data[i] * p5) & _M32
        h = (_rotl32(h, 11) * p1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * p2) & _M32
    h ^= h >> 13
    h = (h * p3) & _M32
    h ^= h >> 16
    return h


def _xxh64_round(acc: int, lane: int) -> int:
    p1, p2 = _P64[0], _P64[1]
    acc = (acc + lane * p2) & _M64
    return (_rotl64(acc, 31) * p1) & _M64


def xxh64_ref(data: bytes, seed: int = 0) -> int:
    p1, p2, p3, p4, p5 = _P64
    n = len(data)
    i = 0
    if n >= 32:
        acc = [
            (seed + p1 + p2) & _M64,
            (seed + p2) & _M64,
            seed & _M64,
            (seed - p1) & _M64,
        ]
        while i + 32 <= n:
            for j in range(4):
                lane = int.from_bytes(data[i + 8 * j : i + 8 * j + 8], "little")
                acc[j] = _xxh64_round(acc[j], lane)
            i += 32
        h = (
            _rotl64(acc[0], 1)
            + _rotl64(acc[1], 7)
            + _rotl64(acc[2], 12)
            + _rotl64(acc[3], 18)
        ) & _M64
        for j in range(4):
            h ^= _xxh64_round(0, acc[j])
            h = (h * p1 + p4) & _M64
    else:
        h = (seed + p5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        lane = int.from_bytes(data[i : i + 8], "little")
        h ^= _xxh64_round(0, lane)
        h = (_rotl64(h, 27) * p1 + p4) & _M64
        i += 8
    if i + 4 <= n:
        lane = int.from_bytes(data[i : i + 4], "little")
        h ^= (lane * p1) & _M64
        h = (_rotl64(h, 23) * p2 + p3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * p5) & _M64
        h = (_rotl64(h, 11) * p1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * p2) & _M64
    h ^= h >> 29
    h = (h * p3) & _M64
    h ^= h >> 32
    return h
