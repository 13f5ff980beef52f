"""Kernels A and B wrappers: GF(2^8) matrix apply, plain and fused with
per-block CRC32C.

The counterpart of ``ceph_tpu/ops/pallas_encode.py``. The four Pallas
entry points map onto two CUDA kernels (``csrc/gf_apply.cu``), each
serving a stacked and a per-shard form:

- ``gf_apply`` / ``gf_apply_shards``: [..., C, N] or C x [..., N] in,
  [..., R, N] or R x [..., N] out (Kernel A);
- ``gf_apply_csum`` / ``gf_apply_csum_shards``: the same plus
  [..., C+R, N/cb] ZERO-INIT CRC32C of every cb-byte block of every
  input and output row (Kernel B).

They keep the JAX contract of taking the code as an [8R, 8C] GF(2)
bitmatrix; the byte coefficients the kernels need are recovered from
it on the host (``bitmatrix_coefficients``). A CPU tensor takes the
plain PyTorch version (``ops.bitplane`` and ``checksum.crc32c``); a
CUDA tensor launches the kernel or raises. The kernels take any chunk
length N >= 1 and mask the ragged tail, so there is no tiling gate.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ceph_tpu_torch.checksum.crc32c import crc32c_fold_plain, shift_columns
from ceph_tpu_torch.checksum.cuda_crc import lane_shift_matrices
from ceph_tpu_torch.gf.tables import MUL_BITMATRIX

from .bitplane import gf_encode_bitplane

MAX_ROWS = 32  # ISA caps k and m at 32; the kernels size their params by it
#: Kernel B: the widest step (columns of every row a block stages at once),
#: warps a block (``GF_CSUM_THREADS`` / 32), bytes of its replicated CRC
#: tables (``kCsumCopies`` = 16 copies), the per-block shared-memory cap
CSUM_TILE_MAX = 4096
CSUM_WARPS = 8
CSUM_TABLE_BYTES = 4 * 256 * 16 * 4
SMEM_MAX = 232448
#: bytes between lane segments of 32 bytes up in shared memory
#: (``GF_CSUM_PAD``)
CSUM_PAD = 16
#: a lane join (32 masked XORs, five shuffles) costs about what hashing
#: this many more bytes of a piece does
CSUM_JOIN_BYTES = 128


@functools.lru_cache(maxsize=256)
def _coefficients(mat_bytes: bytes, r8: int, c8: int) -> np.ndarray:
    bm = np.frombuffer(mat_bytes, np.uint8).reshape(r8 // 8, 8, c8 // 8, 8)
    blocks = bm.transpose(0, 2, 1, 3)  # [R, C, 8, 8]
    weights = (1 << np.arange(8)).astype(np.int64)
    coef = (blocks[..., :, 0].astype(np.int64) * weights).sum(-1)
    coef = coef.astype(np.uint8)
    if not np.array_equal(MUL_BITMATRIX[coef], blocks):
        raise ValueError(
            "bitmatrix is not a GF(2^8) byte matrix: some 8x8 block is "
            "not a multiply-by-constant matrix (packet bitmatrices are "
            "the XOR-schedule kernels' input)"
        )
    return coef


def bitmatrix_coefficients(bitmatrix) -> np.ndarray:
    """[8R, 8C] GF(2) bitmatrix -> [R, C] uint8 GF(2^8) coefficients.
    Block (r, c) must equal ``MUL_BITMATRIX[g]``; g is its column 0,
    packed LSB-first. Raises for any other bitmatrix."""
    mat = np.ascontiguousarray(np.asarray(bitmatrix, dtype=np.uint8))
    r8, c8 = mat.shape
    if r8 % 8 or c8 % 8:
        raise ValueError(f"bitmatrix shape {mat.shape} not a multiple of 8")
    return _coefficients(mat.tobytes(), r8, c8)


def _rows2d(x: torch.Tensor, n: int, what: str) -> torch.Tensor:
    """A [..., N] row tensor as a [B, N] view with unit column stride
    (a uniform stripe stride is fine: out[..., j, :] views qualify)."""
    if x.dtype != torch.uint8:
        raise ValueError(f"{what} must be uint8, got {x.dtype}")
    if x.shape[-1] != n:
        raise ValueError(f"{what} has length {x.shape[-1]}, want {n}")
    try:
        v = x.view(-1, n)
    except RuntimeError as e:
        raise ValueError(f"{what} is not a strided [B, N] view: {e}") from e
    if n > 1 and v.stride(1) != 1:
        raise ValueError(f"{what} has column stride {v.stride(1)}, want 1")
    return v


def _check_device(tensors) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all shards must lie on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _ptr_rows(rows: list[torch.Tensor]):
    """(pointer array, stripe-stride array) for [B, N] row views."""
    ptrs = np.array([r.data_ptr() for r in rows], dtype=np.uint64)
    strides = np.array(
        [r.stride(0) if r.shape[0] > 1 else r.shape[1] for r in rows],
        dtype=np.int64,
    )
    return ptrs, strides


def _check_dims(c: int, r: int) -> None:
    if not (1 <= c <= MAX_ROWS and 1 <= r <= MAX_ROWS):
        raise ValueError(
            f"the kernels take 1..{MAX_ROWS} input and output rows, "
            f"got C={c} R={r}"
        )


def _launch_apply(coef, ins, outs, b: int, n: int) -> None:
    from ceph_tpu_torch.kernels import GF_APPLY

    r, c = coef.shape
    _check_dims(c, r)
    ip, ist = _ptr_rows(ins)
    op, ost = _ptr_rows(outs)
    cf = np.ascontiguousarray(coef)
    with torch.cuda.device(ins[0].device):
        GF_APPLY(ip.ctypes.data, ist.ctypes.data, c, op.ctypes.data,
                 ost.ctypes.data, r, cf.ctypes.data, b, n)


class CsumPlan(NamedTuple):
    tile: int  # columns a step
    piece: int  # bytes of a row one warp task hashes
    smem: int  # bytes a block


def csum_smem(c: int, r: int, tile: int, piece: int) -> int:
    """Kernel B's shared memory a block (``gf_apply_csum_smem_bytes``):
    the tables, two buffers of C rows and R parity rows (lane segments
    of piece / 32 bytes padded by 16 from 32 bytes up), the pieces'
    CRCs; at least 4 KB past the tables."""
    seg = piece // 32
    spad = seg + CSUM_PAD if seg >= 32 else seg
    rest = (2 * c + r) * (tile // seg * spad) + 4 * (c + r) * (tile // piece)
    return CSUM_TABLE_BYTES + max(rest, 4096)


def csum_plan(c: int, r: int, n: int, cb: int) -> CsumPlan:
    """Kernel B's step and hash split for C inputs, R outputs, rows of
    N bytes and cb-byte windows (``csum_supported``).

    The step is the widest power of two up to ``CSUM_TILE_MAX`` that
    divides N and is a multiple or a divisor of cb, narrowed until a
    block fits shared memory. The piece (power of two, 256 bytes up,
    dividing the step and cb) spreads the (C + R) * step / piece hash
    tasks over the warps with the least work on the busiest warp (its
    tasks' bytes, and a join each); ties go to the larger piece."""
    tile = min(cb, CSUM_TILE_MAX)
    while tile < CSUM_TILE_MAX and n % (2 * tile) == 0:
        tile *= 2
    while True:
        pieces = [min(tile, cb) >> i for i in range(64)
                  if min(tile, cb) >> i >= 256]
        fits = [CsumPlan(tile, pc, csum_smem(c, r, tile, pc)) for pc in pieces]
        fits = [plan for plan in fits if plan.smem <= SMEM_MAX]
        if fits:
            return min(fits, key=lambda plan: -(-(c + r) * (tile // plan.piece)
                                                // CSUM_WARPS)
                       * (plan.piece + CSUM_JOIN_BYTES))
        tile //= 2


@functools.lru_cache(maxsize=32)
def csum_piece_matrix(piece: int) -> np.ndarray:
    """[32] uint32: the shift across one piece, which chains a row's
    pieces into its window's CRC."""
    return np.ascontiguousarray(shift_columns(piece))


@functools.lru_cache(maxsize=32)
def _lane_matrices_on(seg: int, device: torch.device) -> torch.Tensor:
    """Kernel B's [32, 32] lane join matrices for seg-byte lane segments
    (lane 31's the identity), uploaded once per (seg, device)."""
    mats = lane_shift_matrices(seg).astype(np.uint32).view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(mats)).to(device)


def csum_supported(n: int, csum_block: int) -> bool:
    """The fused contract: cb a power of two >= 256 dividing N."""
    return (
        csum_block >= 256
        and csum_block & (csum_block - 1) == 0
        and n % csum_block == 0
    )


def _launch_apply_csum(coef, ins, outs, b, n, csums, cb) -> None:
    from ceph_tpu_torch.kernels import GF_APPLY_CSUM

    r, c = coef.shape
    _check_dims(c, r)
    plan = csum_plan(c, r, n, cb)
    lanes = _lane_matrices_on(plan.piece // 32, ins[0].device)
    piece_mat = csum_piece_matrix(plan.piece)
    ip, ist = _ptr_rows(ins)
    op, ost = _ptr_rows(outs)
    cf = np.ascontiguousarray(coef)
    with torch.cuda.device(ins[0].device):
        GF_APPLY_CSUM(ip.ctypes.data, ist.ctypes.data, c, op.ctypes.data,
                      ost.ctypes.data, r, cf.ctypes.data, b, n,
                      csums.data_ptr(), cb, plan.tile, plan.piece,
                      lanes.data_ptr(), piece_mat.ctypes.data)


# ---------------------------------------------------------- plain forms
def gf_apply_csum_plain(bitmatrix, data: torch.Tensor, csum_block: int):
    """Plain fused apply: ([B, R, N] parity, [B, C+R, N/cb] int64
    zero-init CRC32C) — what Kernel B is held against."""
    parity = gf_encode_bitplane(bitmatrix, data)
    b, c, n = data.shape
    full = torch.cat([data, parity], dim=1)
    rows = full.shape[1]
    nb = n // csum_block
    csums = crc32c_fold_plain(full.reshape(b * rows * nb, csum_block), 0)
    return parity, csums.reshape(b, rows, nb)


# ------------------------------------------------------------- Kernel A
def gf_apply(bitmatrix, data: torch.Tensor) -> torch.Tensor:
    """Stacked apply (the K1 form): [..., C, N] uint8 -> [..., R, N]."""
    coef = bitmatrix_coefficients(bitmatrix)
    r, c = coef.shape
    if data.dim() < 2 or data.shape[-2] != c:
        raise ValueError(f"data {tuple(data.shape)} does not match C={c}")
    dev = _check_device([data])
    if dev.type == "cpu":
        return gf_encode_bitplane(bitmatrix, data)
    lead, n = tuple(data.shape[:-2]), int(data.shape[-1])
    if data.dtype != torch.uint8:
        raise ValueError(f"data must be uint8, got {data.dtype}")
    flat = data.reshape((-1, c, n))
    if n > 1 and flat.stride(2) != 1:
        raise ValueError("data must have unit column stride")
    b = flat.shape[0]
    out = torch.empty((b, r, n), dtype=torch.uint8, device=dev)
    if b and n:
        _launch_apply(
            coef, [flat[:, i] for i in range(c)],
            [out[:, j] for j in range(r)], b, n,
        )
    return out.reshape(lead + (r, n))


def gf_apply_shards(bitmatrix, shards: list) -> list:
    """Per-shard apply (the K2 form): C x [..., N] -> R x [..., N],
    neither side ever stacked."""
    coef = bitmatrix_coefficients(bitmatrix)
    r, c = coef.shape
    if len(shards) != c:
        raise ValueError(f"{len(shards)} shards for C={c}")
    dev = _check_device(shards)
    if dev.type == "cpu":
        out = gf_encode_bitplane(bitmatrix, torch.stack(shards, dim=-2))
        return [out[..., j, :] for j in range(r)]
    lead, n = tuple(shards[0].shape[:-1]), int(shards[0].shape[-1])
    rows = [_rows2d(s, n, f"shard {i}") for i, s in enumerate(shards)]
    b = rows[0].shape[0]
    if any(v.shape[0] != b for v in rows):
        raise ValueError("shards differ in stripe count")
    outs = [torch.empty((b, n), dtype=torch.uint8, device=dev)
            for _ in range(r)]
    if b and n:
        _launch_apply(coef, rows, outs, b, n)
    return [o.reshape(lead + (n,)) for o in outs]


# ------------------------------------------------------------- Kernel B
def gf_apply_csum(bitmatrix, data: torch.Tensor, csum_block: int):
    """Stacked fused apply (the K3 form): [..., C, N] -> ([..., R, N]
    parity, [..., C+R, N/cb] int64 zero-init CRC32C; rows 0..C-1 are
    the inputs in order, C.. the outputs)."""
    coef = bitmatrix_coefficients(bitmatrix)
    r, c = coef.shape
    if data.dim() < 2 or data.shape[-2] != c:
        raise ValueError(f"data {tuple(data.shape)} does not match C={c}")
    lead, n = tuple(data.shape[:-2]), int(data.shape[-1])
    if not csum_supported(n, csum_block):
        raise ValueError(f"csum_block {csum_block} outside the contract "
                         f"for N={n}")
    dev = _check_device([data])
    flat = data.reshape((-1, c, n))
    if dev.type == "cpu":
        parity, csums = gf_apply_csum_plain(bitmatrix, flat, csum_block)
    else:
        if data.dtype != torch.uint8:
            raise ValueError(f"data must be uint8, got {data.dtype}")
        if flat.stride(2) != 1:
            raise ValueError("data must have unit column stride")
        b = flat.shape[0]
        parity = torch.empty((b, r, n), dtype=torch.uint8, device=dev)
        csums = _fused_launch(
            coef, [flat[:, i] for i in range(c)],
            [parity[:, j] for j in range(r)], b, n, csum_block,
        )
    nb = n // csum_block
    return (parity.reshape(lead + (r, n)),
            csums.reshape(lead + (c + r, nb)))


def gf_apply_csum_shards(bitmatrix, shards: list, csum_block: int):
    """Per-shard fused apply (the K4 form): C x [..., N] -> (R x
    [..., N] parity, [..., C+R, N/cb] int64 zero-init CRC32C)."""
    coef = bitmatrix_coefficients(bitmatrix)
    r, c = coef.shape
    if len(shards) != c:
        raise ValueError(f"{len(shards)} shards for C={c}")
    lead, n = tuple(shards[0].shape[:-1]), int(shards[0].shape[-1])
    if not csum_supported(n, csum_block):
        raise ValueError(f"csum_block {csum_block} outside the contract "
                         f"for N={n}")
    dev = _check_device(shards)
    nb = n // csum_block
    if dev.type == "cpu":
        stacked = torch.stack(shards, dim=-2).reshape(-1, c, n)
        parity, csums = gf_apply_csum_plain(bitmatrix, stacked, csum_block)
        parity = [parity[:, j].reshape(lead + (n,)) for j in range(r)]
        return parity, csums.reshape(lead + (c + r, nb))
    rows = [_rows2d(s, n, f"shard {i}") for i, s in enumerate(shards)]
    b = rows[0].shape[0]
    if any(v.shape[0] != b for v in rows):
        raise ValueError("shards differ in stripe count")
    parity = [torch.empty((b, n), dtype=torch.uint8, device=dev)
              for _ in range(r)]
    csums = _fused_launch(coef, rows, parity, b, n, csum_block)
    return ([p.reshape(lead + (n,)) for p in parity],
            csums.reshape(lead + (c + r, nb)))


def _fused_launch(coef, rows, outs, b, n, cb) -> torch.Tensor:
    """Launch Kernel B over [B, N] row views; returns the csums."""
    r, c = coef.shape
    csums = torch.empty(
        (b, c + r, n // cb), dtype=torch.int32, device=rows[0].device
    )
    if b:
        _launch_apply_csum(coef, rows, outs, b, n, csums, cb)
    return csums.to(torch.int64) & 0xFFFFFFFF
