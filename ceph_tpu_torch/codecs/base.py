"""Shared codec behavior — the ``ErasureCode`` base-class analog.

Default implementations mirroring src/erasure-code/ErasureCode.{h,cc}:
profile parsing helpers (``to_int``/``to_bool`` — ErasureCode.h:136-152),
padded data preparation (``encode_prepare`` — ErasureCode.cc), byte-level
``encode``/``decode`` wrappers over the chunk APIs, chunk remapping, and
availability-based ``minimum_to_decode``.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.utils.device import resolve_device, to_numpy, to_tensor

from .interface import Buffer, ErasureCodeProfile, Flag, SubChunkPlan

# Chunk sizes are padded to a multiple of this (the SIMD_ALIGN analog,
# ErasureCode.h). ceph_tpu chose it as the TPU lane width; the port
# keeps it because it fixes chunk sizes, hence the on-disk layout and
# the golden corpus.
CHUNK_ALIGN = 128


def to_int(name: str, profile: ErasureCodeProfile, default: int) -> int:
    v = profile.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except (TypeError, ValueError):
        raise ValueError(f"profile key {name}={v!r} is not an integer")


def to_bool(name: str, profile: ErasureCodeProfile, default: bool) -> bool:
    v = profile.get(name)
    if v is None or v == "":
        return default
    return str(v).lower() in ("1", "true", "yes", "on")


class ErasureCodeBase:
    """Concrete shared machinery; code families subclass this."""

    def __init__(self) -> None:
        self.k = 0
        self.m = 0
        self.profile: ErasureCodeProfile = {}
        self.chunk_mapping: list[int] = []
        #: where host arrays above the host-route threshold go; set by
        #: ``registry.factory(..., device=)`` (``set_device``)
        self.device: torch.device | None = None

    def set_device(self, device) -> None:
        """Adopt ``device``; raises for CUDA when no card is present."""
        self.device = resolve_device(device)

    def _target_device(self) -> torch.device:
        if self.device is None:
            raise RuntimeError(
                "codec has no device: build it with registry.factory("
                "name, profile, device=...) or call set_device()"
            )
        return self.device

    # -- geometry -----------------------------------------------------
    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_coding_chunk_count(self) -> int:
        return self.m

    def get_sub_chunk_count(self) -> int:
        return 1

    def get_chunk_size(self, stripe_width: int) -> int:
        """ceil(stripe_width / k) rounded up to CHUNK_ALIGN bytes."""
        per = -(-stripe_width // self.k)
        return -(-per // CHUNK_ALIGN) * CHUNK_ALIGN

    def get_flags(self) -> Flag:
        return Flag.NONE

    def get_chunk_mapping(self) -> list[int]:
        return self.chunk_mapping or list(range(self.get_chunk_count()))

    # -- planning -----------------------------------------------------
    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> SubChunkPlan:
        """Default: any k available shards, whole chunks.

        Mirrors ErasureCode::_minimum_to_decode — prefer the wanted
        shards themselves, fill with other survivors up to k.
        """
        if want_to_read <= available:
            return {s: [(0, self.get_sub_chunk_count())] for s in want_to_read}
        chosen = sorted(want_to_read & available)
        for s in sorted(available - want_to_read):
            if len(chosen) >= self.k:
                break
            chosen.append(s)
        if len(chosen) < self.k:
            raise ValueError(
                f"cannot decode {sorted(want_to_read)} from "
                f"{sorted(available)}: need {self.k} shards"
            )
        return {s: [(0, self.get_sub_chunk_count())] for s in chosen[: self.k]}

    def minimum_to_decode_with_cost(
        self, want_to_read: set[int], available: dict[int, int]
    ) -> set[int]:
        """Pick the cheapest k-cover (ErasureCodeInterface.h:346): widen
        a cheapest-first candidate window until a plan exists."""
        ordered = sorted(available, key=lambda s: (available[s], s))
        for cut in range(self.k, len(ordered)):
            try:
                plan = self.minimum_to_decode(
                    want_to_read, set(ordered[:cut])
                )
                return set(plan)
            except ValueError:
                continue
        return set(self.minimum_to_decode(want_to_read, set(ordered)))

    # -- shared shard plumbing ----------------------------------------
    def _as_tensors(self, shards: list) -> list:
        """Tensors stay where they lie; host arrays join them (or go to
        the codec's device when no tensor is given)."""
        dev = next(
            (s.device for s in shards if isinstance(s, torch.Tensor)),
            None,
        ) or self._target_device()
        return [to_tensor(s, dev) for s in shards]

    def _shard_list(self, data: dict[int, Buffer]) -> list:
        """k shard buffers in index order; absent shards are zero (the
        shared zero-buffer convention of the reference's encode_chunks).
        All-numpy inputs stay on the host so small ops can take the
        host GF path without a copy to the card; otherwise every
        buffer becomes a tensor (``_as_tensors``)."""
        vals = list(data.values())
        if all(isinstance(v, np.ndarray) for v in vals):
            zero = np.zeros_like(vals[0])
            return [data.get(i, zero) for i in range(self.k)]
        tensors = dict(zip(data, self._as_tensors(vals)))
        zero = torch.zeros_like(next(iter(tensors.values())))
        return [tensors.get(i, zero) for i in range(self.k)]

    # -- byte-level wrappers (legacy-interface parity) ----------------
    def encode_prepare(self, data: bytes) -> torch.Tensor:
        """Pad + split a flat byte string into [k, chunk_size] on
        ``self.device``.

        The encode() front half of ErasureCode.cc (zero-pad the tail so
        every chunk is full and aligned — ZERO_PADDING_EXPECTED).
        """
        cs = self.get_chunk_size(len(data))
        buf = np.zeros(self.k * cs, dtype=np.uint8)
        buf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
        return torch.from_numpy(buf.reshape(self.k, cs)).to(
            self._target_device()
        )

    def encode(self, data: bytes) -> dict[int, bytes]:
        """Whole-object encode returning all k+m chunks as bytes
        (the legacy encode() contract, ErasureCodeInterface.h:403)."""
        shards = self.encode_prepare(data)
        data_map = {i: shards[i] for i in range(self.k)}
        parity = self.encode_chunks(data_map)
        out = {}
        host = to_numpy(shards)
        for i in range(self.k):
            out[i] = host[i].tobytes()
        for i, p in parity.items():
            out[i] = to_numpy(p).tobytes()
        return out

    def decode(
        self, want_to_read: set[int], chunks: dict[int, bytes]
    ) -> dict[int, bytes]:
        """Byte-level decode wrapper (ErasureCodeInterface.h:539)."""
        arrs = {
            i: to_tensor(
                np.frombuffer(c, dtype=np.uint8), self._target_device()
            )
            for i, c in chunks.items()
        }
        out = self.decode_chunks(want_to_read, arrs)
        return {i: to_numpy(a).tobytes() for i, a in out.items()}
