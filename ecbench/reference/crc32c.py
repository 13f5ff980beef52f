"""CRC32C (Castagnoli, reflected 0x82F63B78) in ``ceph_crc32c(seed,
data, len)``'s form: the raw register in and out, no final XOR.

CRC with no inversion is linear over GF(2) in the register and the data
together, so

- a block's zero-seeded CRC is the XOR over its positions of
  ``T[pos, byte]``, the CRC of that byte alone followed by the rest of
  the block as zeros (``block_crcs``), and
- ``crc(seed, B1 B2 ...)`` folds block by block:
  ``c = shift(c) ^ crc(0, Bi)``, where ``shift`` is what a block of
  zero bytes does to the register (``chain``).

Plain numpy builds the tables; plain PyTorch applies them on whatever
device the data is on. Imports nothing of the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0x82F63B78
SEED = 0xFFFFFFFF


def crc32c_bitwise(seed: int, data: bytes) -> int:
    """The definition, one bit at a time (tests only: slow)."""
    crc = seed & 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (POLY if crc & 1 else 0)
    return crc


@functools.lru_cache(maxsize=1)
def _byte_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint64)
    for _ in range(8):
        t = np.where(t & 1, (t >> np.uint64(1)) ^ np.uint64(POLY),
                     t >> np.uint64(1))
    return t


def _zero_bytes(state: np.ndarray, n: int) -> np.ndarray:
    """The register after ``n`` zero bytes, for every entry of state."""
    t = _byte_table()
    s = state.astype(np.uint64)
    for _ in range(n):
        s = (s >> np.uint64(8)) ^ t[s & np.uint64(0xFF)]
    return s


@functools.lru_cache(maxsize=8)
def _position_table(block: int) -> np.ndarray:
    """[block * 256] int32: T[pos, byte] flattened."""
    t = _byte_table()
    out = np.zeros((block, 256), dtype=np.uint64)
    row = t.copy()  # a byte in the last position
    for pos in range(block - 1, -1, -1):
        out[pos] = row
        row = (row >> np.uint64(8)) ^ t[row & np.uint64(0xFF)]
    return out.astype(np.uint32).view(np.int32).reshape(-1)


@functools.lru_cache(maxsize=8)
def _shift_table(block: int) -> np.ndarray:
    """[4, 256] int64: the register after ``block`` zero bytes, one table
    for each byte of the register's value."""
    vals = np.arange(256, dtype=np.uint64)
    rows = [_zero_bytes(vals << np.uint64(8 * j), block) for j in range(4)]
    return np.stack(rows).astype(np.int64)


def block_crcs(data: torch.Tensor, block: int,
               rows_per_pass: int = 2048) -> torch.Tensor:
    """Zero-seeded CRC32C of every ``block`` bytes of ``data`` (uint8,
    any leading shape, last dim a multiple of ``block``), as int64 in
    [0, 2^32), shape ``data.shape[:-1] + (last // block,)``."""
    dev = data.device
    table = torch.from_numpy(_position_table(block)).to(dev)
    offs = torch.arange(block, device=dev, dtype=torch.int64) * 256
    lead = data.shape[:-1]
    rows = data.reshape(-1, block)
    out = torch.empty(rows.shape[0], dtype=torch.int64, device=dev)
    for lo in range(0, rows.shape[0], rows_per_pass):
        part = rows[lo:lo + rows_per_pass].to(torch.int64) + offs
        vals = table[part]
        while vals.shape[1] > 1:
            half = vals.shape[1] // 2
            if vals.shape[1] % 2:
                vals = torch.cat(
                    [vals[:, :half] ^ vals[:, half:2 * half],
                     vals[:, 2 * half:]], dim=1)
            else:
                vals = vals[:, :half] ^ vals[:, half:]
        out[lo:lo + rows_per_pass] = vals[:, 0].to(torch.int64) & 0xFFFFFFFF
    return out.reshape(*lead, -1)


def chain(seed: torch.Tensor, crcs: torch.Tensor, block: int) -> torch.Tensor:
    """``crc(seed, B1 B2 ... Bn)`` from the zero-seeded CRCs of the
    blocks (last dim n), for every leading index; ``seed`` broadcasts."""
    shift = torch.from_numpy(_shift_table(block)).to(crcs.device)
    c = torch.broadcast_to(
        torch.as_tensor(seed, dtype=torch.int64, device=crcs.device),
        crcs.shape[:-1]).clone()
    for i in range(crcs.shape[-1]):
        s = (shift[0][c & 0xFF] ^ shift[1][(c >> 8) & 0xFF]
             ^ shift[2][(c >> 16) & 0xFF] ^ shift[3][(c >> 24) & 0xFF])
        c = s ^ crcs[..., i]
    return c


def crc32c(seed: int, data: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """``ceph_crc32c(seed, data)`` over the last dim of ``data`` (a
    multiple of ``block``), for every leading index."""
    return chain(seed, block_crcs(data, block), block)
