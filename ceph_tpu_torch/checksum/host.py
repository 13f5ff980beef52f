"""Host checksum entry — the ``ceph_crc32c`` runtime-probe analog.

The reference routes every host crc32c call to the fastest
implementation it probes (src/common/crc32c.cc:19-32). Until the native
C++ tier is ported this is the bitwise Python oracle, which is exact
but slow: the host path serves only batches below
``csum_device_min_bytes``.
"""

from __future__ import annotations

from .reference import crc32c_ref as crc32c  # noqa: F401
