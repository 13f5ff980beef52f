"""xxhash32/64 over batches of blocks, as PyTorch ops on the blocks'
device.

Unlike CRC, xxhash is non-linear (multiplicative avalanche), so each
block is a true sequential chain: the parallelism is across blocks.
Deep scrub and blob verify checksum thousands of blocks at once, so
every round runs on a [blocks, 4] tensor of the four accumulator lanes
while the loop walks the stripes. Mirrors the exact algorithm
Checksummer wraps (src/common/Checksummer.h:137-193, vendored
src/xxHash). ``ceph_tpu`` runs it as XLA, not Pallas, so it has no hand
kernel here either.

xxhash32 keeps its u32 values in int64 tensors and masks after each
multiply and add; xxhash64 keeps its u64 values in int64 tensors with
the same bits (``u64``). Block words are assembled little-endian from
the bytes. Block sizes are any length, tails
included.
"""

from __future__ import annotations

import numpy as np
import torch

from . import u64

_P32 = (2654435761, 2246822519, 3266489917, 668265263, 374761393)
_P64 = (
    11400714785074694791,
    14029467366897019727,
    1609587929392839161,
    9650029242287828579,
    2870177450012600261,
)
_M32 = 0xFFFFFFFF


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _words32(data: torch.Tensor, nwords: int) -> torch.Tensor:
    """[B, L] uint8 -> [B, nwords] int64 little-endian u32 words."""
    b = data[:, : nwords * 4].reshape(data.shape[0], nwords, 4)
    b = b.to(torch.int64)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _words64(data: torch.Tensor, nwords: int) -> torch.Tensor:
    """[B, L] uint8 -> [B, nwords] int64 holding little-endian u64 words."""
    w = _words32(data, 2 * nwords)
    return w[:, 0::2] | (w[:, 1::2] << 32)


def xxh32_blocks(data: torch.Tensor, seed: int) -> torch.Tensor:
    """[B, L] uint8 tensor -> [B] int64 holding each block's xxhash32."""
    p1, p2, p3, p4, p5 = _P32
    n = int(data.shape[-1])
    bsz = int(data.shape[0])
    seed &= _M32
    wt = _words32(data, n // 4)
    i = 0
    if n >= 16:
        nstripes = n // 16
        # [stripes, B, 4]: each step reads one contiguous lane block
        lanes = wt[:, : nstripes * 4].reshape(bsz, nstripes, 4)
        lanes = lanes.transpose(0, 1).contiguous()
        acc = torch.tensor(
            [(seed + p1 + p2) & _M32, (seed + p2) & _M32, seed,
             (seed - p1) & _M32],
            dtype=torch.int64, device=data.device,
        ).expand(bsz, 4)
        for s in range(nstripes):
            acc = (acc + lanes[s] * p2) & _M32
            acc = (_rotl32(acc, 13) * p1) & _M32
        h = (
            _rotl32(acc[:, 0], 1) + _rotl32(acc[:, 1], 7)
            + _rotl32(acc[:, 2], 12) + _rotl32(acc[:, 3], 18)
        ) & _M32
        i = nstripes * 16
    else:
        h = torch.full((bsz,), (seed + p5) & _M32, dtype=torch.int64,
                       device=data.device)
    h = (h + n) & _M32
    while i + 4 <= n:
        h = (h + wt[:, i // 4] * p3) & _M32
        h = (_rotl32(h, 17) * p4) & _M32
        i += 4
    while i < n:
        h = (h + data[:, i].to(torch.int64) * p5) & _M32
        h = (_rotl32(h, 11) * p1) & _M32
        i += 1
    h = h ^ (h >> 15)
    h = (h * p2) & _M32
    h = h ^ (h >> 13)
    h = (h * p3) & _M32
    return h ^ (h >> 16)


def _xxh64_round(acc: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    return u64.mul_const(
        u64.rotl(acc + u64.mul_const(lane, _P64[1]), 31), _P64[0]
    )


def xxh64_blocks(data: torch.Tensor, seed: int) -> torch.Tensor:
    """[B, L] uint8 tensor -> [B] int64 with the bits of each block's
    xxhash64."""
    p1, p2, p3, p4, p5 = _P64
    n = int(data.shape[-1])
    bsz = int(data.shape[0])
    dev = data.device
    w64 = _words64(data, n // 8)
    i = 0
    if n >= 32:
        nstripes = n // 32
        lanes = w64[:, : nstripes * 4].reshape(bsz, nstripes, 4)
        lanes = lanes.transpose(0, 1).contiguous()
        acc = torch.tensor(
            [u64.from_const(seed + p1 + p2), u64.from_const(seed + p2),
             u64.from_const(seed), u64.from_const(seed - p1)],
            dtype=torch.int64, device=dev,
        ).expand(bsz, 4)
        for s in range(nstripes):
            acc = _xxh64_round(acc, lanes[s])
        h = (u64.rotl(acc[:, 0], 1) + u64.rotl(acc[:, 1], 7)
             + u64.rotl(acc[:, 2], 12) + u64.rotl(acc[:, 3], 18))
        for lane in range(4):
            h = h ^ _xxh64_round(torch.zeros_like(h), acc[:, lane])
            h = u64.mul_const(h, p1) + u64.from_const(p4)
        i = nstripes * 32
    else:
        h = torch.full((bsz,), u64.from_const(seed + p5), dtype=torch.int64,
                       device=dev)
    h = h + n
    while i + 8 <= n:
        h = h ^ _xxh64_round(torch.zeros_like(h), w64[:, i // 8])
        h = u64.mul_const(u64.rotl(h, 27), p1) + u64.from_const(p4)
        i += 8
    if i + 4 <= n:
        lane = _words32(data[:, i : i + 4], 1)[:, 0]
        h = h ^ u64.mul_const(lane, p1)
        h = u64.mul_const(u64.rotl(h, 23), p2) + u64.from_const(p3)
        i += 4
    while i < n:
        h = h ^ u64.mul_const(data[:, i].to(torch.int64), p5)
        h = u64.mul_const(u64.rotl(h, 11), p1)
        i += 1
    h = h ^ u64.shr(h, 33)
    h = u64.mul_const(h, p2)
    h = h ^ u64.shr(h, 29)
    h = u64.mul_const(h, p3)
    return h ^ u64.shr(h, 32)


def _flat_blocks(data, device) -> torch.Tensor:
    from ceph_tpu_torch.utils.device import resolve_device, to_tensor

    if not isinstance(data, torch.Tensor):
        data = to_tensor(data, resolve_device(device))
    return data.reshape(-1, int(data.shape[-1]))


def xxh32_device(data, seed: int = 0, device="cuda") -> np.ndarray:
    """Per-block xxhash32: [..., L] uint8 -> [...] uint32. A tensor is
    hashed where it lies; a host array goes to ``device`` first."""
    lead = tuple(data.shape[:-1])
    out = xxh32_blocks(_flat_blocks(data, device), int(seed))
    return out.cpu().numpy().astype(np.uint32).reshape(lead)


def xxh64_device(
    data, seed: int = 0, device="cuda"
) -> tuple[np.ndarray, np.ndarray]:
    """Per-block xxhash64: [..., L] uint8 -> (hi, lo) [...] uint32 pair,
    ``ceph_tpu``'s form of the 64-bit values."""
    lead = tuple(data.shape[:-1])
    out = u64.to_numpy_u64(
        xxh64_blocks(_flat_blocks(data, device), int(seed))
    ).reshape(lead)
    return (
        (out >> np.uint64(32)).astype(np.uint32),
        (out & np.uint64(_M32)).astype(np.uint32),
    )
