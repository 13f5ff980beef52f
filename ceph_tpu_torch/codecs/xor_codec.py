"""Single-parity XOR codec — the ``xor`` plugin.

One parity chunk equal to the XOR of the k data chunks (an all-ones
generator parity row over GF(2^8); MDS for m=1). ``codecs.lrc`` uses it
for generated local layers under ``local_parity=xor`` (Azure-LRC-style
XOR local parities), so local-group encode, repair and parity-delta
rows are 0/1 and ride the XOR-schedule kernel's w=1 route
(``matrix_codec._try_sched_bytes``, ``sched_*`` counters). Usable
standalone too (``plugin=xor``, profile ``k=<n>``).
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch import PLUGIN_ABI_VERSION

from .base import to_int
from .interface import ErasureCodeProfile
from .matrix_codec import MatrixErasureCodec
from .registry import registry


class XorCodec(MatrixErasureCodec):
    """k data chunks + 1 XOR parity on the shared byte-matrix engine."""

    DEFAULT_K = 2

    def init(self, profile: ErasureCodeProfile) -> None:
        self.profile = dict(profile)
        self.k = to_int("k", profile, self.DEFAULT_K)
        self.m = to_int("m", profile, 1)
        if self.k < 1:
            raise ValueError(f"k={self.k} must be >= 1")
        if self.m != 1:
            raise ValueError("xor plugin supports m=1 only")
        g = np.vstack(
            [np.eye(self.k, dtype=np.uint8),
             np.ones((1, self.k), dtype=np.uint8)]
        )
        self._set_generator(g)


registry.register("xor", XorCodec, PLUGIN_ABI_VERSION)
