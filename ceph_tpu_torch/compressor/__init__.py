"""Compression plugin family — the ``src/compressor`` analog.

Mirrors the reference's second codec-plugin registry
(compressor/Compressor.h, CompressionPlugin.h): named algorithms
behind one ``Compressor`` contract (compress/decompress with an
optional compressor_message side-channel), a registry with the same
load/handshake semantics as the EC one, compression MODES
(none/passive/aggressive/force, Compressor.h:62-67) driving the
hint-based should-compress decision BlueStore makes per blob, and a
``maybe_compress`` helper implementing the required-ratio gate
(bluestore_compression_required_ratio semantics: keep the compressed
blob only if it actually saved enough).

Algorithms here are zlib / bz2 / lzma (stdlib-backed — the vendored
snappy/zstd/lz4 role) plus ``none``. The QAT/UADK accelerator-offload
precedent maps to device-batched codecs: ``tpu_zeroelim`` and
``tpu_zlib`` scan for zero blocks on the compressor's device (the
registry names are the reference's, since pools and blobs record
them). ``registry.create(name, device=...)`` runs on the card unless
the caller asks for the CPU.
"""

from .compressor import (
    CompressionMode,
    Compressor,
    CompressorRegistry,
    maybe_compress,
    registry,
)
from . import tpu_offload  # noqa: F401  (registers the tpu_* plugins)

__all__ = [
    "CompressionMode",
    "Compressor",
    "CompressorRegistry",
    "maybe_compress",
    "registry",
]
