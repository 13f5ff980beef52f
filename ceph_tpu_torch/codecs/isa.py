"""The ISA plugin equivalent: Reed-Solomon with matrix-type selection.

Mirrors isa/ErasureCodeIsa.{h,cc}: profile key ``technique`` chooses
``reed_sol_van`` (gf_gen_rs_matrix — MDS only inside the envelope
documented at isa/README:23-24, enforced here) or ``cauchy``
(gf_gen_cauchy1_matrix). Hard caps MAX_K=32 / MAX_M=32
(isa/ErasureCodeIsa.h:48-49). Decode tables are LRU-cached per erasure
signature (ErasureCodeIsaTableCache semantics — shared DecodeTableCache).
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch import PLUGIN_ABI_VERSION
from ceph_tpu_torch.gf import isa_cauchy_matrix, isa_rs_matrix
from ceph_tpu_torch.gf.matrices import MAX_K, MAX_M

from .base import to_int
from .interface import ErasureCodeProfile
from .matrix_codec import MatrixErasureCodec
from .registry import registry


def _vandermonde_envelope_ok(k: int, m: int) -> bool:
    """isa/README:23-24: RS-Vandermonde verified MDS up to (21,4)/(32,3)."""
    if m <= 1:
        return True
    if m == 2:
        return k <= 32
    if m == 3:
        return k <= 32
    if m == 4:
        return k <= 21
    return False


class ErasureCodeIsa(MatrixErasureCodec):
    DEFAULT_K = 7   # isa plugin defaults (k=7, m=3 upstream)
    DEFAULT_M = 3

    def init(self, profile: ErasureCodeProfile) -> None:
        self.profile = dict(profile)
        self.k = to_int("k", profile, self.DEFAULT_K)
        self.m = to_int("m", profile, self.DEFAULT_M)
        technique = profile.get("technique", "reed_sol_van")
        if self.k < 1 or self.m < 1:
            raise ValueError(f"k={self.k}, m={self.m} must be >= 1")
        if self.k > MAX_K or self.m > MAX_M:
            raise ValueError(
                f"k={self.k} m={self.m} exceed ISA caps ({MAX_K},{MAX_M})"
            )
        if technique == "reed_sol_van":
            if not _vandermonde_envelope_ok(self.k, self.m):
                raise ValueError(
                    f"(k={self.k}, m={self.m}) outside the RS-Vandermonde "
                    "MDS envelope (max (21,4)/(32,3)); use technique=cauchy"
                )
            gen = isa_rs_matrix(self.k, self.m)
        elif technique == "cauchy":
            gen = isa_cauchy_matrix(self.k, self.m)
        else:
            raise ValueError(
                f"unknown isa technique {technique!r}; "
                "choose reed_sol_van or cauchy"
            )
        self._set_generator(np.asarray(gen))


registry.register("isa", ErasureCodeIsa, PLUGIN_ABI_VERSION)
