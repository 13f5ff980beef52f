"""The jerasure plugin's seven techniques.

Mirrors ErasureCodeJerasure.{h,cc} (reference
src/erasure-code/jerasure/ErasureCodeJerasure.h:124-324): one codec
class per technique, selected by the ``technique`` profile key. The
matrix techniques run on the GF(2^8) matrix engine (``matrix_codec``);
the bit-matrix techniques on the XOR-schedule engine
(``bitmatrix_codec``).

- reed_sol_van      — Vandermonde RS
- reed_sol_r6_op    — RAID-6 optimized (P = XOR, Q = powers of 2)
- cauchy_orig       — original Cauchy matrix
- cauchy_good       — Cauchy with XOR-count-minimizing row scaling
- liberation        — minimal-density RAID-6 bit-matrix, w prime, k <= w
- blaum_roth        — RAID-6 bit-matrix, w+1 prime, k <= w
- liber8tion        — RAID-6 bit-matrix, w = 8, k <= 8

Profile keys: k, m, technique, w, packetsize, construction.
``packetsize`` is accepted for interop (the reference plugin writes its
default into every profile it normalizes) but is advisory: the packet
is chunk/w. ``construction=v0`` pins the round-1 bit-matrix
constructions of ``ceph_tpu`` that the corpus-v0 archives hold; an
unversioned profile means the reference-derived construction. The
techniques, matrices and chunk layout are ``ceph_tpu``'s byte for byte.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch import PLUGIN_ABI_VERSION
from ceph_tpu_torch.gf import (
    cauchy_good_matrix,
    cauchy_original_matrix,
    raid6_matrix,
    vandermonde_rs_matrix,
)
from ceph_tpu_torch.utils.device import resolve_device

from .base import to_int
from .bitmatrix_codec import (
    BitMatrixCodec,
    _is_prime,
    blaum_roth_bitmatrix,
    gf2w_power_bitmatrix,
    liberation_bitmatrix,
    raid6_bitmatrix,
    sparse_power_bitmatrix,
)
from .interface import ErasureCodeProfile
from .matrix_codec import MatrixErasureCodec
from .registry import registry


def _accept_packetsize(profile: ErasureCodeProfile) -> int:
    """packetsize: accepted, validated, advisory (0/omitted means the
    same thing: the packet is chunk/w)."""
    ps = to_int("packetsize", profile, 0)
    if ps < 0:
        raise ValueError(f"packetsize={ps} must be >= 0")
    return ps


class JerasureMatrixCodec(MatrixErasureCodec):
    technique = "reed_sol_van"
    DEFAULT_K = 2   # ErasureCodeJerasure defaults (k=2, m=1 upstream)
    DEFAULT_M = 1

    def init(self, profile: ErasureCodeProfile) -> None:
        self.profile = dict(profile)
        self.packetsize = _accept_packetsize(profile)
        self.k = to_int("k", profile, self.DEFAULT_K)
        self.m = to_int("m", profile, self.DEFAULT_M)
        self.w = to_int("w", profile, 8)
        if self.k < 1 or self.m < 1:
            raise ValueError(f"k={self.k}, m={self.m} must be >= 1")
        if self.w != 8:
            # the engine is GF(2^8); w=8 is also the reference default
            raise ValueError(f"technique {self.technique} supports w=8 only")
        self._set_generator(self._make_matrix())

    def _make_matrix(self) -> np.ndarray:
        return vandermonde_rs_matrix(self.k, self.m)


class ReedSolVan(JerasureMatrixCodec):
    technique = "reed_sol_van"


class ReedSolR6(JerasureMatrixCodec):
    technique = "reed_sol_r6_op"
    DEFAULT_M = 2

    def init(self, profile: ErasureCodeProfile) -> None:
        if to_int("m", profile, 2) != 2:
            raise ValueError("reed_sol_r6_op requires m=2")
        super().init(profile)

    def _make_matrix(self) -> np.ndarray:
        return raid6_matrix(self.k)


class CauchyOrig(JerasureMatrixCodec):
    technique = "cauchy_orig"

    def _make_matrix(self) -> np.ndarray:
        return cauchy_original_matrix(self.k, self.m)


class CauchyGood(JerasureMatrixCodec):
    technique = "cauchy_good"

    def _make_matrix(self) -> np.ndarray:
        return cauchy_good_matrix(self.k, self.m)


class LiberationBase(BitMatrixCodec):
    """Shared init for the RAID-6 bit-matrix techniques; subclasses
    override ``_check_w`` and ``_build_matrix``."""

    technique = "liberation"
    DEFAULT_W = 7
    CONSTRUCTIONS = ("default", "v0")

    def init(self, profile: ErasureCodeProfile) -> None:
        self.profile = dict(profile)
        self.k = to_int("k", profile, 2)
        self.m = to_int("m", profile, 2)
        self.w = to_int("w", profile, self.DEFAULT_W)
        self.construction = str(profile.get("construction", "default"))
        self.packetsize = _accept_packetsize(profile)
        if self.construction not in self.CONSTRUCTIONS:
            raise ValueError(
                f"unknown construction {self.construction!r}; choose "
                f"from {self.CONSTRUCTIONS}"
            )
        if self.k < 1:
            raise ValueError(f"k={self.k} must be >= 1")
        if self.m != 2:
            raise ValueError(f"technique {self.technique} requires m=2")
        self._check_w()
        if self.k > self.w:
            raise ValueError(f"k={self.k} must be <= w={self.w}")
        coding = np.frombuffer(
            self._build_matrix(), dtype=np.uint8
        ).reshape(2 * self.w, self.k * self.w)
        self._set_bitmatrix(coding)

    def _check_w(self) -> None:
        if not _is_prime(self.w):
            raise ValueError(f"liberation requires prime w, got {self.w}")

    def _build_matrix(self) -> bytes:
        if self.construction == "v0":
            return raid6_bitmatrix(self.k, self.w)
        return liberation_bitmatrix(self.k, self.w)


class Liberation(LiberationBase):
    technique = "liberation"


class BlaumRoth(LiberationBase):
    technique = "blaum_roth"
    DEFAULT_W = 6

    def _check_w(self) -> None:
        if not _is_prime(self.w + 1):
            raise ValueError(
                f"blaum_roth requires w+1 prime, got w={self.w}"
            )

    def _build_matrix(self) -> bytes:
        # one construction only: the ring form IS the Blaum-Roth 1993
        # definition, stable since v0
        return blaum_roth_bitmatrix(self.k, self.w)


class Liber8tion(LiberationBase):
    technique = "liber8tion"
    DEFAULT_W = 8

    def _check_w(self) -> None:
        if self.w != 8:
            raise ValueError("liber8tion requires w=8")
        if to_int("k", self.profile, 2) > 8:
            raise ValueError("liber8tion requires k <= 8")

    def _build_matrix(self) -> bytes:
        if self.construction == "v0":
            return gf2w_power_bitmatrix(self.k, 8)
        # k <= 4: minimal-density search; k >= 5: the k sparsest
        # GF(2^8) generator-power blocks (frozen, corpus-pinned)
        if self.k <= 4:
            return raid6_bitmatrix(self.k, 8)
        return sparse_power_bitmatrix(self.k, 8)


TECHNIQUES = {
    c.technique: c
    for c in (
        ReedSolVan,
        ReedSolR6,
        CauchyOrig,
        CauchyGood,
        Liberation,
        BlaumRoth,
        Liber8tion,
    )
}


class JerasureDispatch:
    """Factory facade: reads ``technique`` and becomes the right class
    (the ErasureCodePluginJerasure::factory switch), on the device the
    registry gave it."""

    device = None

    def set_device(self, device) -> None:
        self.device = resolve_device(device)

    def init(self, profile: ErasureCodeProfile) -> None:
        technique = profile.get("technique", "reed_sol_van")
        if technique not in TECHNIQUES:
            raise ValueError(
                f"unknown jerasure technique {technique!r}; "
                f"choose from {sorted(TECHNIQUES)}"
            )
        impl = TECHNIQUES[technique]()
        impl.device = self.device
        impl.init(profile)
        # adopt the concrete technique's class and state wholesale, so
        # isinstance() stays truthful
        self.__class__ = impl.__class__
        self.__dict__ = impl.__dict__


registry.register("jerasure", JerasureDispatch, PLUGIN_ABI_VERSION)
