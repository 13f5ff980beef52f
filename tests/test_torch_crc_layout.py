"""A numpy model of Kernel C (``csrc/crc32c.cu``): the staged pass
layout (which 16-byte unit each lane loads, where it lands in the warp's
padded buffer, which bytes a lane hashes back), the replicated
slicing-by-4 tables and their per-lane addresses, the direct byte path,
and the one-level lane join with the host's per-lane shift matrices —
against the port's plain fold and ceph_tpu's bitwise oracle. The CUDA
kernel runs only on the card; this is the CPU's view of its layout. The
constants are read from the source, so the model follows the kernel."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu.checksum import crc32c_ref  # noqa: E402
from ceph_tpu_torch.checksum.crc32c import (  # noqa: E402
    crc32c_fold_plain,
    crc32c_seed_shift,
)
from ceph_tpu_torch.checksum.cuda_crc import lane_shift_matrices  # noqa: E402

SRC = (Path(__file__).resolve().parents[1] / "ceph_tpu_torch" / "csrc"
       / "crc32c.cu").read_text()
COPIES = int(re.search(r"#define CRC_TABLE_COPIES (\d+)", SRC).group(1))
MAX_PIECE = int(re.search(r"#define CRC_MAX_PIECE (\d+)", SRC).group(1))
POLY = 0x82F63B78
LANES = np.arange(32)


def base_tables() -> np.ndarray:
    """[4, 256]: T_k[e], the register after byte e and k zero bytes,
    computed bit by bit as the kernel's fill does."""
    t = np.zeros((4, 256), np.uint32)
    for k in range(4):
        for e in range(256):
            c = e
            for _ in range(8 * (k + 1)):
                c = (c >> 1) ^ (POLY if c & 1 else 0)
            t[k, e] = c
    return t


BASE = base_tables()
#: the shared-memory table: word f holds base word f // COPIES
REPLICATED = np.repeat(BASE.reshape(-1), COPIES)


def tab_at(k: int, e: np.ndarray) -> np.ndarray:
    """Lane l's lookup: word ((k * 256 + e) * COPIES + l % COPIES)."""
    return REPLICATED[(k * 256 + e.astype(np.int64)) * COPIES + LANES % COPIES]


def step4(crc, w):
    a = crc ^ w
    return (tab_at(3, a & 0xFF) ^ tab_at(2, (a >> 8) & 0xFF)
            ^ tab_at(1, (a >> 16) & 0xFF) ^ tab_at(0, a >> 24))


def step1(crc, byte):
    return tab_at(0, (crc ^ byte) & 0xFF) ^ (crc >> 8)


def words_of(rows: np.ndarray) -> np.ndarray:
    """[32, 4 q] bytes -> [32, q] little-endian words."""
    return np.ascontiguousarray(rows).view("<u4").astype(np.uint32)


def piece_of(seg: int) -> int:
    piece = MAX_PIECE
    while seg % piece:
        piece //= 2
    return piece


def hash_staged(block: np.ndarray, seg: int) -> np.ndarray:
    """Every lane's zero-init CRC of its segment, through the staging
    buffer pass by pass."""
    piece = piece_of(seg)
    nu = piece // 16
    spad = 16 if piece == 16 else piece + 16
    crc = np.zeros(32, np.uint32)
    for ps in range(seg // piece):
        stage = np.zeros(32 * spad, np.uint8)
        for m in range(nu):
            for lane in range(32):
                u = lane + 32 * m
                pc, off = u // nu, (u % nu) * 16
                src = pc * seg + ps * piece + off
                stage[pc * spad + off:pc * spad + off + 16] = block[src:src + 16]
        mine = np.stack([stage[lane * spad:lane * spad + piece]
                         for lane in range(32)])
        for w in words_of(mine).T:
            crc = step4(crc, w)
    return crc


def hash_direct(block: np.ndarray, seg: int) -> np.ndarray:
    """Every lane's zero-init CRC of its segment, loaded byte by byte."""
    segs = block[:32 * seg].reshape(32, seg)
    crc = np.zeros(32, np.uint32)
    whole = seg - seg % 4
    for w in words_of(segs[:, :whole]).T:
        crc = step4(crc, w)
    for i in range(whole, seg):
        crc = step1(crc, segs[:, i].astype(np.uint32))
    return crc


def kernel_c_model(block: np.ndarray, init: int, aligned: bool) -> int:
    length = block.size
    seg = length // 32
    staged = aligned and length % 512 == 0
    crc = hash_staged(block, seg) if staged else hash_direct(block, seg)
    mats = lane_shift_matrices(seg)
    moved = 0
    for lane in range(32):
        for j in range(32):
            if int(crc[lane]) >> j & 1:
                moved ^= int(mats[lane, j])
    reg = np.full(32, moved, np.uint32)  # lane 0's tail
    for byte in block[32 * seg:]:
        reg = step1(reg, np.uint32(byte))
    return int(reg[0]) ^ crc32c_seed_shift(length, init)


def test_replicated_table_addresses(rng):
    """Every (k, e, lane) address of the replicated table holds T_k[e];
    whatever the data, at most 32 / COPIES lanes of a warp read one bank;
    and the fill's bit loop equals the slicing-by-8 recurrence of
    crc32c_common.cuh."""
    for k in range(4):
        for e in range(256):
            got = tab_at(k, np.full(32, e))
            assert (got == BASE[k, e]).all()
    for _ in range(200):
        e = rng.integers(0, 256, 32)
        k = int(rng.integers(0, 4))
        banks = ((k * 256 + e) * COPIES + LANES % COPIES) % 32
        assert np.bincount(banks).max() <= max(1, 32 // COPIES)
    t0 = BASE[0]
    for k in range(1, 4):
        assert np.array_equal(BASE[k], (BASE[k - 1] >> 8) ^ t0[BASE[k - 1] & 0xFF])


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("init", [0, 0xFFFFFFFF, 0x5EED1234])
@pytest.mark.parametrize("length", [1, 31, 32, 33, 512, 1000, 4096, 65536])
def test_model_matches_plain_and_oracle(rng, length, init, offset):
    """offset 1: a base pointer one byte off, which takes the direct
    byte path."""
    block = rng.integers(0, 256, length, dtype=np.uint8)
    got = kernel_c_model(block, init, aligned=offset == 0)
    assert got == crc32c_ref(init, block.tobytes())
    plain = crc32c_fold_plain(torch.from_numpy(block[None]), init)
    assert got == int(plain[0])
