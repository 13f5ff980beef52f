"""ceph_tpu_torch — the erasure-coding data path on PyTorch and CUDA.

The same behavioral contract as ``ceph_tpu`` (Ceph's
``ErasureCodeInterface`` plus BlueStore-style CRC32C), for an NVIDIA
Hopper card:

- GF(2^8) math: host tables and generator matrices (``gf``), the plain
  PyTorch bit-plane engine (``ops.bitplane``) and the hand-written CUDA
  matrix-apply kernels (``ops.cuda_encode``, ``csrc/gf_apply.cu``);
- the erasure-code families behind the plugin registry (``codecs``);
- per-block checksums: CRC32C (host reference, plain fold and the CUDA
  kernel, ``csrc/crc32c.cu``) and xxhash32/64 (``checksum``);
- the OSD EC backend on the per-op path: stripe geometry, shard extent
  maps, HashInfo, the RMW write, the read pipeline, recovery and deep
  scrub (``pipeline``) over MemStore shards (``store``), with the
  runtime pieces they use (``utils``).

Entry points run on the card unless the caller passes
``device="cpu"``; without a card they raise instead of running on the
CPU. The package imports neither JAX nor ``ceph_tpu``.
"""

__version__ = "0.1.0"

# Interface generation implemented: the "optimized EC" plugin contract
# (src/osd/ECSwitch.h:6-18), under this package's own handshake string
# (src/erasure-code/ErasureCodePlugin.cc:30-33).
PLUGIN_ABI_VERSION = "ceph_tpu_torch-ec-2.0"
