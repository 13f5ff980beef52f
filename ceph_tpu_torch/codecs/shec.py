"""Shingled Erasure Code (SHEC) — the shec plugin.

Behavioral mirror of src/erasure-code/shec/ErasureCodeShec.{h,cc}
(Fujitsu): parameters (k, m, c) where c is the "durability" — every
data chunk is covered by c parity chunks, but each parity only covers a
*shingle* (circular window) of the data, so single-failure recovery
reads fewer chunks than k. Non-MDS by design: recoverability of a given
erasure pattern is decided by a determinant search over parity subsets
(shec_make_decoding_matrix, ErasureCodeShec.cc:745-973), whose result —
a minimal invertible reconstruction system — is cached per
(want, avails) signature (the ShecTableCache analog).

Technique ``multiple`` splits (m, c) into two shingle bands (m1, c1) +
(m2, c2) chosen to minimize expected single-failure recovery reads
(shec_calc_recovery_efficiency1); ``single`` keeps one band.

The coding matrix is jerasure's Vandermonde RS coding matrix with the
out-of-shingle entries zeroed (shec_reedsolomon_coding_matrix,
ErasureCodeShec.cc:675-742). Encode/decode bulk math rides the same
GF(2^8) apply (Kernel A on the card) as the other matrix codes; the
shingle search and the reconstruction matrices are host algebra.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch import PLUGIN_ABI_VERSION
from ceph_tpu_torch.gf import (
    gf_invert_matrix,
    gf_matmul_np,
    gf_matrix_to_bitmatrix,
    vandermonde_rs_matrix,
)

from .base import to_int
from .interface import Buffer, ErasureCodeProfile, Flag, SubChunkPlan
from .matrix_codec import MatrixErasureCodec
from .registry import registry


def _shingle_bands(k: int, m: int, c: int, single: bool) -> tuple[int, int, int, int]:
    """(m1, c1, m2, c2): the shingle-band split. ``multiple`` minimizes
    recovery efficiency r_e1 over valid splits (ErasureCodeShec.cc
    shec_reedsolomon_coding_matrix)."""
    if single:
        return 0, 0, m, c
    best = (None, None)
    min_r_e1 = 100.0
    for c1 in range(c // 2 + 1):
        for m1 in range(m + 1):
            c2, m2 = c - c1, m - m1
            if m1 < c1 or m2 < c2:
                continue
            if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
                continue
            if (m1 != 0 and c1 == 0) or (m2 != 0 and c2 == 0):
                continue
            r_e1 = _recovery_efficiency1(k, m1, m2, c1, c2)
            if min_r_e1 - r_e1 > np.finfo(float).eps and r_e1 < min_r_e1:
                min_r_e1 = r_e1
                best = (m1, c1)
    m1, c1 = best
    return m1, c1, m - m1, c - c1


def _recovery_efficiency1(k: int, m1: int, m2: int, c1: int, c2: int) -> float:
    """Expected single-failure recovery read cost
    (shec_calc_recovery_efficiency1, ErasureCodeShec.cc)."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [100000000] * k
    r_e1 = 0.0
    for band_m, band_c, _row0 in ((m1, c1, 0), (m2, c2, m1)):
        for rr in range(band_m):
            start = ((rr * k) // band_m) % k
            end = (((rr + band_c) * k) // band_m) % k
            width = ((rr + band_c) * k) // band_m - (rr * k) // band_m
            cc = start
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(r_eff_k[cc], width)
                cc = (cc + 1) % k
            r_e1 += width
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


def shec_coding_matrix(k: int, m: int, c: int, single: bool) -> np.ndarray:
    """[m, k] GF(2^8) coding matrix: Vandermonde RS rows with entries
    outside each row's shingle window zeroed."""
    m1, c1, m2, c2 = _shingle_bands(k, m, c, single)
    mat = vandermonde_rs_matrix(k, m)[k:, :].copy()
    for band_m, band_c, row0 in ((m1, c1, 0), (m2, c2, m1)):
        for rr in range(band_m):
            end = ((rr * k) // band_m) % k
            start = (((rr + band_c) * k) // band_m) % k
            cc = start
            while cc != end:
                mat[row0 + rr, cc] = 0
                cc = (cc + 1) % k
    return mat


class ShecCodec(MatrixErasureCodec):
    """shec ReedSolomonVandermonde (single|multiple)."""

    technique = "multiple"
    MAX_K = 12       # ErasureCodeShec.cc parse: k <= 12
    MAX_KM = 20      # k + m <= 20

    def init(self, profile: ErasureCodeProfile) -> None:
        self.profile = dict(profile)
        t = profile.get("technique", "multiple")
        if t not in ("single", "multiple"):
            raise ValueError(
                f"technique={t} is not a valid coding technique"
            )
        self.technique = t
        has_any = any(x in profile for x in ("k", "m", "c"))
        has_all = all(x in profile for x in ("k", "m", "c"))
        if has_any and not has_all:
            raise ValueError("(k, m, c) must all be chosen or none")
        self.k = to_int("k", profile, 4)
        self.m = to_int("m", profile, 3)
        self.c = to_int("c", profile, 2)
        self.w = to_int("w", profile, 8)
        if self.k <= 0 or self.m <= 0 or self.c <= 0:
            raise ValueError(
                f"k={self.k}, m={self.m}, c={self.c} must be positive"
            )
        if self.m < self.c:
            raise ValueError(f"c={self.c} must be <= m={self.m}")
        if self.k > self.MAX_K:
            raise ValueError(f"k={self.k} must be <= {self.MAX_K}")
        if self.k + self.m > self.MAX_KM:
            raise ValueError(f"k+m={self.k + self.m} must be <= {self.MAX_KM}")
        if self.k < self.m:
            raise ValueError(f"m={self.m} must be <= k={self.k}")
        if self.w not in (8, 16, 32):
            self.w = 8  # the reference warns and falls back to default
        if self.w != 8:
            # the apply engine is GF(2^8); reference default is also 8.
            raise ValueError("shec supports w=8 only")
        self.coding = shec_coding_matrix(
            self.k, self.m, self.c, self.technique == "single"
        )
        full = np.zeros((self.k + self.m, self.k), dtype=np.uint8)
        full[: self.k] = np.eye(self.k, dtype=np.uint8)
        full[self.k :] = self.coding
        self._set_generator(full)

    def get_flags(self) -> Flag:
        # ErasureCodeShec.h get_supported_optimizations
        return (
            Flag.PARTIAL_READ_OPTIMIZATION
            | Flag.PARTIAL_WRITE_OPTIMIZATION
            | Flag.ZERO_INPUT_ZERO_OUTPUT
            | Flag.PARITY_DELTA_OPTIMIZATION
        )

    # -- the shingled decoding search ---------------------------------
    def _search(
        self, want: list[int], avails: list[int]
    ) -> tuple[list[int], list[int], np.ndarray | None, list[int]]:
        """Port of shec_make_decoding_matrix's subset search.

        Returns (dm_row, dm_column, inv, minimum): chunk ids whose
        values feed the solve, the data columns treated as unknowns,
        the inverted system (None when nothing is erased), and the
        minimum chunk-id set to read. Raises ValueError when no parity
        subset recovers the pattern.
        """
        k, m = self.k, self.m
        mat = self.coding
        want = list(want)
        # A wanted-but-missing parity needs its contributing data.
        for i in range(m):
            if want[k + i] and not avails[k + i]:
                for j in range(k):
                    if mat[i, j]:
                        want[j] = 1
        mindup, minp = k + 1, k + 1
        best: tuple | None = None
        for pp in range(1 << m):
            p = [i for i in range(m) if pp & (1 << i)]
            if len(p) > minp:
                continue
            if any(not avails[k + i] for i in p):
                continue
            tmprow = [0] * (k + m)
            tmpcol = [0] * k
            for i in range(k):
                if want[i] and not avails[i]:
                    tmpcol[i] = 1
            for i in p:
                tmprow[k + i] = 1
                for j in range(k):
                    if mat[i, j]:
                        tmpcol[j] = 1
                        if avails[j]:
                            tmprow[j] = 1
            dup_row = sum(tmprow)
            dup_col = sum(tmpcol)
            if dup_row != dup_col:
                continue
            dup = dup_row
            if dup == 0:
                mindup = 0
                best = ([], [], None, len(p))
                break
            if dup >= mindup:
                continue
            rows = [i for i in range(k + m) if tmprow[i]]
            cols = [j for j in range(k) if tmpcol[j]]
            sysmat = np.zeros((dup, dup), dtype=np.uint8)
            for ri, i in enumerate(rows):
                for ci, j in enumerate(cols):
                    sysmat[ri, ci] = (
                        1 if (i < k and i == j)
                        else (0 if i < k else mat[i - k, j])
                    )
            try:
                inv = gf_invert_matrix(sysmat)
            except ValueError:
                continue  # det == 0
            mindup = dup
            minp = len(p)
            best = (rows, cols, inv, len(p))
        if best is None:
            raise ValueError(
                f"cannot find recover matrix for want={want} avails={avails}"
            )
        rows, cols, inv, _ = best
        minimum = [0] * (k + m)
        for i in rows:
            minimum[i] = 1
        for i in range(k):
            if want[i] and avails[i]:
                minimum[i] = 1
        for i in range(m):
            if want[k + i] and avails[k + i] and not minimum[k + i]:
                if any(mat[i, j] and not want[j] for j in range(k)):
                    minimum[k + i] = 1
        return rows, cols, inv, [i for i in range(k + m) if minimum[i]]

    # -- interface -----------------------------------------------------
    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> SubChunkPlan:
        if set(want_to_read) <= set(available):
            return {s: [(0, 1)] for s in want_to_read}
        n = self.k + self.m
        want = [1 if i in want_to_read else 0 for i in range(n)]
        avails = [1 if i in available else 0 for i in range(n)]
        *_, minimum = self._search(want, avails)
        return {s: [(0, 1)] for s in minimum}

    def decode_chunks(
        self,
        want_to_read: set[int],
        chunks: dict[int, Buffer],
    ) -> dict[int, Buffer]:
        missing = sorted(s for s in want_to_read if s not in chunks)
        if not missing:
            return {s: chunks[s] for s in want_to_read}
        key = ("shec", tuple(sorted(chunks)), tuple(missing))
        inputs, bmat_np = self._tables.get(
            key, lambda: self._build_reconstruction(set(chunks), missing)
        )
        # shards-form launch: survivors already on the card feed the
        # kernel as per-shard operands (no [.., C, N] stack); host
        # arrays go over stacked, in one copy
        outs = self._dispatch_bitmatrix_shards(
            bmat_np, [chunks[i] for i in inputs], "decode"
        )
        result = {s: chunks[s] for s in want_to_read if s in chunks}
        for idx, s in enumerate(missing):
            result[s] = outs[idx]
        return result

    def _build_reconstruction(
        self, available: set[int], missing: list[int]
    ) -> tuple[list[int], np.ndarray]:
        """One GF matrix mapping survivor chunks -> all missing wanted
        shards: erased data via the inverted shingle system, erased
        parity re-encoded by composition (shec_matrix_decode)."""
        k, m = self.k, self.m
        n = k + m
        want = [0] * n
        for s in missing:
            want[s] = 1
        avails = [1 if i in available else 0 for i in range(n)]
        rows, cols, inv, _minimum = self._search(want, avails)
        # Unknown data column cols[j] = sum_i inv[j, i] * chunk[rows[i]].
        # Inputs: the solve's rows plus only the available data columns
        # a wanted parity row actually references — stacking all
        # survivors would widen the dispatch and the cache key for
        # nothing (shingle locality is the point of SHEC).
        referenced: set[int] = set(rows)
        for s in missing:
            if s >= k:
                for j in range(k):
                    if self.coding[s - k, j] and avails[j]:
                        referenced.add(j)
        col_solution: dict[int, np.ndarray] = {}
        inputs = sorted(referenced)
        in_idx = {s: i for i, s in enumerate(inputs)}
        if inv is not None:
            for j, coljd in enumerate(cols):
                vec = np.zeros(len(inputs), dtype=np.uint8)
                for i, r in enumerate(rows):
                    vec[in_idx[r]] ^= inv[j, i]
                col_solution[coljd] = vec
        out_rows = []
        for s in missing:
            if s < k:
                out_rows.append(col_solution[s])
            else:
                # parity s: row over data columns, substituting solved
                # columns for erased data.
                vec = np.zeros(len(inputs), dtype=np.uint8)
                for j in range(k):
                    coeff = int(self.coding[s - k, j])
                    if not coeff:
                        continue
                    if avails[j]:
                        base = np.zeros(len(inputs), dtype=np.uint8)
                        base[in_idx[j]] = 1
                        contrib = base
                    else:
                        contrib = col_solution[j]
                    vec ^= gf_matmul_np(
                        np.array([[coeff]], dtype=np.uint8),
                        contrib[None, :],
                    )[0]
                out_rows.append(vec)
        return inputs, gf_matrix_to_bitmatrix(np.stack(out_rows))


registry.register("shec", ShecCodec, PLUGIN_ABI_VERSION)
