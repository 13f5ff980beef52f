"""The erasure-codec contract.

Behavioral mirror of ``ErasureCodeInterface``
(reference src/erasure-code/ErasureCodeInterface.h:182-725), new
("optimized EC") generation: chunk maps are ``dict[int, Array]`` keyed by
shard id (the ``shard_id_map`` analog), encode/decode operate on
batched device arrays, parity-delta read-modify-write is first-class,
and sub-chunk granularity (CLAY) is expressed as per-shard
``(offset, count)`` ranges exactly as the reference's
``minimum_to_decode`` returns them (ErasureCodeInterface.h:309-344).

Design deltas from the reference, on purpose:

- Chunks carry an arbitrary leading batch shape ``[..., chunk_bytes]``;
  a "stripe batch" is one tensor, so a million stripes encode in one
  kernel launch instead of a per-stripe virtual call. A chunk is a
  uint8 ``torch.Tensor`` (on the card or the CPU) or a host numpy
  array; small host arrays stay on the host (``codecs.matrix_codec``).
- No dlopen: codecs are Python classes in a registry with an explicit
  ABI-version handshake (``ceph_tpu_torch.PLUGIN_ABI_VERSION``), preserving
  the load-path contract that the reference tests aggressively
  (src/test/erasure-code/ErasureCodePlugin*.cc).
"""

from __future__ import annotations

import enum
from typing import Protocol, runtime_checkable

import numpy as np
import torch

ErasureCodeProfile = dict[str, str]

#: one shard buffer: a uint8 tensor or a host numpy array
Buffer = "torch.Tensor | np.ndarray"

# Per-shard sub-chunk read plan: list of (offset, count) in sub-chunk
# units — ErasureCodeInterface.h:309 ("vector<pair<int,int>>").
SubChunkPlan = dict[int, list[tuple[int, int]]]


class Flag(enum.Flag):
    """Plugin optimization capability flags.

    Mirrors the enum at ErasureCodeInterface.h:646-684. The pipeline
    consults these to choose partial-write strategies (WritePlan) and
    zero-elision, exactly like ECTransaction does in the reference.
    """

    NONE = 0
    PARTIAL_READ_OPTIMIZATION = enum.auto()
    PARTIAL_WRITE_OPTIMIZATION = enum.auto()
    ZERO_INPUT_ZERO_OUTPUT = enum.auto()
    ZERO_PADDING_EXPECTED = enum.auto()
    PARITY_DELTA_OPTIMIZATION = enum.auto()
    REQUIRE_SUB_CHUNKS = enum.auto()
    OPTIMIZED_SUPPORTED = enum.auto()
    #: Parity-delta windows must be whole chunks: packet-layout codes
    #: (liberation family) scatter a sub-chunk write's parity update
    #: across the entire chunk through the packet structure — the
    #: packetsize-granularity constraint of jerasure's
    #: schedule_apply_delta (ErasureCodeJerasure.h:110-119). The
    #: write planner chunk-aligns parity extents and the delta driver
    #: hands the codec chunk-shaped buffers when this is set.
    PARITY_DELTA_CHUNK_GRANULARITY = enum.auto()


@runtime_checkable
class ErasureCodec(Protocol):
    """The codec contract. All array maps are ``{shard_id: [..., bytes]}``.

    Shard ids 0..k-1 are data, k..k+m-1 are parity *logical* positions;
    ``get_chunk_mapping`` permutes logical -> stored positions
    (ErasureCodeInterface.h:613).
    """

    def init(self, profile: ErasureCodeProfile) -> None:
        """Validate + adopt a profile; raise ValueError on bad/missing keys
        (the init/parse contract of ErasureCodeInterface.h:223-240)."""
        ...

    def get_chunk_count(self) -> int: ...          # k + m
    def get_data_chunk_count(self) -> int: ...     # k
    def get_coding_chunk_count(self) -> int: ...   # m
    def get_sub_chunk_count(self) -> int: ...      # 1 except CLAY (q^t)

    def get_chunk_size(self, stripe_width: int) -> int:
        """Bytes per chunk for an object of ``stripe_width`` bytes,
        including padding/alignment (ErasureCodeInterface.h:269)."""
        ...

    def get_flags(self) -> Flag: ...

    def get_chunk_mapping(self) -> list[int]: ...

    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> SubChunkPlan:
        """Minimum shards (with sub-chunk ranges) needed to produce
        ``want_to_read``; raise IOError-alike ValueError if impossible
        (ErasureCodeInterface.h:309)."""
        ...

    def minimum_to_decode_with_cost(
        self, want_to_read: set[int], available: dict[int, int]
    ) -> set[int]:
        """Cost-aware variant (ErasureCodeInterface.h:346)."""
        ...

    def encode_chunks(
        self, data: dict[int, Buffer]
    ) -> dict[int, Buffer]:
        """All-data-shards in, parity map out (ErasureCodeInterface.h:449).
        Missing data shards are treated as zero (the shared zero-buffer
        convention of the reference's encode_chunks)."""
        ...

    def decode_chunks(
        self,
        want_to_read: set[int],
        chunks: dict[int, Buffer],
    ) -> dict[int, Buffer]:
        """Reconstruct ``want_to_read`` shards from surviving ``chunks``
        (ErasureCodeInterface.h:571)."""
        ...

    def encode_delta(
        self, old_data: Buffer, new_data: Buffer
    ) -> Buffer:
        """Delta for parity-delta RMW (ErasureCodeInterface.h:471)."""
        ...

    def apply_delta(
        self,
        delta: dict[int, Buffer],
        parity: dict[int, Buffer],
    ) -> dict[int, Buffer]:
        """parity' = parity + G_col * delta per changed data shard
        (ErasureCodeInterface.h:499)."""
        ...
