"""Toy XOR codec — the ``ErasureCodeExample`` analog.

The reference exercises its base-class logic against a trivial XOR
code (src/test/erasure-code/ErasureCodeExample.h: k data chunks, one
parity = XOR of all, any single erasure recoverable). Same role here:
a minimal, obviously-correct codec for registry and base-class tests,
and the smallest possible example of implementing the codec contract.
It XORs where its buffers lie: numpy on the host, tensors on their
device. Registered on first use (``registry.factory("example", ...)``),
as in ``ceph_tpu``; the in-tree plugins are preloaded instead.
"""

from __future__ import annotations

from .base import Buffer, ErasureCodeBase, to_int
from .interface import ErasureCodeProfile, Flag
from .registry import registry


class ErasureCodeExample(ErasureCodeBase):
    """k data + 1 XOR parity; decodes any single missing chunk."""

    def init(self, profile: ErasureCodeProfile) -> None:
        self.profile = dict(profile)
        self.k = to_int("k", profile, 2)
        self.m = 1
        if self.k < 2:
            raise ValueError(f"k={self.k} must be >= 2")

    def get_flags(self) -> Flag:
        return Flag.ZERO_PADDING_EXPECTED | Flag.PARITY_DELTA_OPTIMIZATION

    def encode_chunks(self, data: dict[int, Buffer]) -> dict[int, Buffer]:
        shards = self._shard_list(data)
        parity = shards[0]
        for shard in shards[1:]:
            parity = parity ^ shard
        return {self.k: parity}

    def decode_chunks(
        self, want_to_read: set[int], chunks: dict[int, Buffer]
    ) -> dict[int, Buffer]:
        missing = [s for s in want_to_read if s not in chunks]
        if not missing:
            return {s: chunks[s] for s in want_to_read}
        if len(missing) > 1:
            raise ValueError(
                f"XOR code cannot decode {len(missing)} erasures"
            )
        acc = None
        for s, c in chunks.items():
            if s <= self.k:  # data or the single parity
                acc = c if acc is None else acc ^ c
        out = {s: chunks[s] for s in want_to_read if s in chunks}
        out[missing[0]] = acc
        return out

    def encode_delta(self, old_data: Buffer, new_data: Buffer) -> Buffer:
        return old_data ^ new_data

    def apply_delta(
        self, delta: dict[int, Buffer], parity: dict[int, Buffer]
    ) -> dict[int, Buffer]:
        out = dict(parity)
        for _shard, d in delta.items():
            out[self.k] = out[self.k] ^ d
        return out


registry.register("example", ErasureCodeExample)
