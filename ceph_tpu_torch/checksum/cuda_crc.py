"""Kernel C wrapper: batched per-block CRC32C on the card.

The counterpart of ``ceph_tpu/checksum/pallas_crc.py``
(``crc32c_fold_pallas``). The kernel (``csrc/crc32c.cu``) hashes
blocks with a table-driven CRC, one warp per block, lane i over the
i-th of 32 equal segments; it joins them by moving each lane's CRC to
the end of the run with the shift matrix built here from
``zero_gap_matrix``, then XOR-summing the lanes. A CPU tensor takes the plain fold
(``crc32c.crc32c_fold_plain``); a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .crc32c import crc32c_fold_plain, crc32c_seed_shift, shift_columns


@functools.lru_cache(maxsize=64)
def lane_shift_matrices(seg: int) -> np.ndarray:
    """[32, 32] uint32: row i shifts across (31 - i) * seg bytes — what
    moves lane i's segment CRC to the end of a warp's 32 segments
    before the lanes are XOR-summed."""
    return np.stack([shift_columns((31 - i) * seg) for i in range(32)])


def crc32c_blocks(data: torch.Tensor, init: int) -> torch.Tensor:
    """[B, L] uint8 -> [B] int64 holding ``ceph_crc32c(init, block, L)``."""
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"want a [B, L] uint8 tensor, got {data.dtype} "
                         f"{tuple(data.shape)}")
    if data.device.type == "cpu":
        return crc32c_fold_plain(data, init)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if not data.is_contiguous():
        raise ValueError("crc32c_blocks needs a contiguous [B, L] tensor")
    from ceph_tpu_torch.kernels import CRC32C_BLOCKS

    nblocks, block_bytes = data.shape
    out = torch.empty(nblocks, dtype=torch.int32, device=data.device)
    if nblocks:
        mats = np.ascontiguousarray(lane_shift_matrices(block_bytes // 32))
        with torch.cuda.device(data.device):
            CRC32C_BLOCKS(
                data.data_ptr(), out.data_ptr(), nblocks, block_bytes,
                crc32c_seed_shift(block_bytes, init), mats.ctypes.data,
            )
    return out.to(torch.int64) & 0xFFFFFFFF
