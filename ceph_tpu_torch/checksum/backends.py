"""Checksum backend observability.

Every crc routing decision records here — module-level counters,
incremented under a lock (the cluster tier hashes from many threads at
once), plus a last-backend marker the ``Checksummer`` facade surfaces
per call.

Backends:
- ``kernel`` — the CUDA fold kernel (checksum/cuda_crc.py, csrc/crc32c.cu)
- ``plain``  — the plain PyTorch fold (checksum/crc32c.py), on a CPU
  tensor, or on a CUDA tensor with ``ec_use_kernels`` off
- ``host``   — the host scalar path (checksum/host.py)
- ``device`` — xxhash's PyTorch ops on the blocks' device
  (checksum/xxhash.py; no hand kernel, as ``ceph_tpu`` has none)
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counts: dict[str, int] = {}
_bytes: dict[str, int] = {}
_last: str | None = None


def record(backend: str, nbytes: int = 0) -> None:
    global _last
    with _lock:
        _counts[backend] = _counts.get(backend, 0) + 1
        if nbytes:
            _bytes[backend] = _bytes.get(backend, 0) + int(nbytes)
        _last = backend


def last_backend() -> str | None:
    """Backend of the most recent checksum computation."""
    return _last


def counts() -> dict[str, int]:
    with _lock:
        return dict(_counts)


def bytes_hashed() -> dict[str, int]:
    with _lock:
        return dict(_bytes)


def reset() -> None:
    global _last
    with _lock:
        _counts.clear()
        _bytes.clear()
        _last = None
