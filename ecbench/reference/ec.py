"""Ceph's EC object layout and a plain systematic encode.

An object of S bytes is cut into stripes of k * unit bytes; data shard
i holds the i-th unit of every stripe, back to back, so each shard is
S / k bytes (``to_shards``). Parity shard j is the GF(2^8) sum over the
data shards of ``G[k + j, i] * shard_i`` (``encode``). A shard's
HashInfo is ``crc32c(0xFFFFFFFF, shard[:n])`` of every shard with the
hashed length n beside it: the whole shard after an object is written
whole once; after an overwrite either cleared (all hashes 0xFFFFFFFF,
length 0) or, once a later write appends at the hashed length again,
the hashes of a shorter prefix (``prefix_hashinfo``).

Plain PyTorch on any device; imports nothing of the program.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import crc32c, gf


@functools.lru_cache(maxsize=4)
def _mul_table_np() -> np.ndarray:
    return gf.mul_table()


def to_shards(objects: torch.Tensor, k: int, unit: int) -> torch.Tensor:
    """[n, S] uint8 objects -> [n, k, S / k] data shards."""
    n, size = objects.shape
    if size % (k * unit):
        raise ValueError(f"object size {size} is not whole stripes of "
                         f"{k} x {unit}")
    return (objects.reshape(n, size // (k * unit), k, unit)
            .permute(0, 2, 1, 3).reshape(n, k, size // k))


def encode(gen: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """[n, k, L] data shards -> [n, m, L] parity shards under the
    (k+m) x k generator ``gen``."""
    k = data.shape[1]
    m = gen.shape[0] - k
    table = torch.from_numpy(_mul_table_np()).to(data.device)
    out = torch.zeros((data.shape[0], m, data.shape[2]), dtype=torch.uint8,
                      device=data.device)
    idx = data.to(torch.int64)
    for j in range(m):
        for i in range(k):
            c = int(gen[k + j, i])
            if c:
                out[:, j] ^= table[c][idx[:, i]]
    return out


def hashinfo(shards: torch.Tensor, block: int = 4096) -> list[dict]:
    """[n, k+m, L] shards -> each object's HashInfo as the store keeps
    it: ``{"total_chunk_size": L, "hashes": [crc32c(-1, shard), ...]}``."""
    crcs = crc32c.crc32c(crc32c.SEED, shards, block).cpu().tolist()
    return [{"total_chunk_size": int(shards.shape[2]),
             "hashes": [int(h) for h in row]} for row in crcs]


def prefix_hashinfo(shards: torch.Tensor, length: int,
                    block: int = 4096) -> dict:
    """[k+m, L] shards -> the HashInfo of their first ``length`` bytes."""
    crcs = crc32c.block_crcs(shards, block)[:, :length // block]
    hashes = crc32c.chain(crc32c.SEED, crcs, block).cpu().tolist()
    return {"total_chunk_size": int(length),
            "hashes": [int(h) for h in hashes]}


def cleared_hashinfo(n_shards: int) -> dict:
    return {"total_chunk_size": 0, "hashes": [crc32c.SEED] * n_shards}
