"""Host checksum dispatch — the ``ceph_crc32c`` runtime-probe analog.

The reference probes CPU features once and routes every crc32c call to
the fastest implementation (src/common/crc32c.cc:19-32). Here: native
(SSE4.2 hardware or slicing-by-8, ``ceph_tpu_torch.native``) when the
C++ tier loads, the bitwise Python oracle otherwise. Both are
bit-identical — tests/test_torch_native.py holds them to each other and
to ``ceph_tpu``'s.

The batched Checksummer paths (checksum/crc32c.py, the CUDA kernel)
remain the bulk route; this is for host-side hot spots: blob csums the
stores verify on every read, HashInfo chaining, wire frame CRCs.
"""

from __future__ import annotations

from ceph_tpu_torch import native

from .reference import crc32c_ref

_native: "bool | None" = None


def native_selected() -> bool:
    """True when the host entries below go to the native tier (decided
    at the first call: the tier builds on first use, never at
    import)."""
    global _native
    if _native is None:
        _native = native.available()
    return _native


def crc32c(init: int, data) -> int:
    if native_selected():
        return native.crc32c(init, data)
    return crc32c_ref(init, data)


def crc32c_wire(init: int, data) -> int:
    """The wire-frame entry: zero-copy for ``bytes`` (no numpy
    round-trip per segment) on the native tier."""
    if native_selected():
        return native.crc32c_bytes(init, data)
    return crc32c_ref(init, bytes(data))
