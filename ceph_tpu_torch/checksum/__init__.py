"""Block checksumming — the BlueStore/deep-scrub integrity family.

The crc32c ``Checksummer`` algorithms of the reference
(src/common/Checksummer.h:15-23: crc32c, crc32c_16, crc32c_8) with the
same block-granular calculate/verify contract (Checksummer.h:196-271),
plus the raw ``ceph_crc32c``-style entry points (src/common/crc32c.h).

CRC32C is GF(2)-linear in the message bits: the plain PyTorch version
folds a batch of blocks with one einsum against precomputed matrices
(``crc32c.py``); the CUDA kernel (``cuda_crc.py``, ``csrc/crc32c.cu``)
hashes each block with shared-memory tables and joins lane segments
with the same matrices. xxhash32/64 (``xxhash.py``) run as PyTorch ops
across a batch of blocks.
"""

from . import backends
from .checksummer import (
    CSUM_ALGORITHMS,
    Checksummer,
    crc32c_scalar,
    csum_value_size,
)
from .crc32c import crc32c as crc32c_host
from .host import crc32c_wire
from .crc32c import (
    crc32c_chain,
    crc32c_device,
    crc32c_seed_shift,
    crc32c_stream,
)
from .reference import crc32c_ref, xxh32_ref, xxh64_ref
from .xxhash import xxh32_device, xxh64_device

__all__ = [
    "CSUM_ALGORITHMS",
    "Checksummer",
    "backends",
    "crc32c_chain",
    "crc32c_host",
    "crc32c_device",
    "crc32c_ref",
    "crc32c_scalar",
    "crc32c_seed_shift",
    "crc32c_stream",
    "crc32c_wire",
    "csum_value_size",
    "xxh32_device",
    "xxh32_ref",
    "xxh64_device",
    "xxh64_ref",
]
