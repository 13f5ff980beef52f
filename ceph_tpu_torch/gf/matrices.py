"""Generator-matrix construction and GF(2^8) linear algebra (host-side).

Mirrors the matrix generators of the reference's plugins:

- ``vandermonde_rs_matrix`` — jerasure ``reed_sol_van`` (systematized
  Vandermonde; reference src/erasure-code/jerasure/ErasureCodeJerasure.h:124).
- ``isa_rs_matrix`` — ISA-L ``gf_gen_rs_matrix`` semantics (identity top,
  parity rows p[j] = gen_i^j with gen_i = 2^(i-k), so parity row 0 is
  all-ones; only MDS inside the envelope documented at
  src/erasure-code/isa/README:23-24).
- ``isa_cauchy_matrix`` — ISA-L ``gf_gen_cauchy1_matrix``
  (reference src/erasure-code/isa/ErasureCodeIsa.cc:598-600).
- ``cauchy_original_matrix`` / ``cauchy_good_matrix`` — jerasure
  ``cauchy_orig`` / ``cauchy_good`` techniques.
- ``raid6_matrix`` — jerasure ``reed_sol_r6_op`` (P = XOR, Q = powers of 2).

Matrix inversion is tiny (<=32x32 — isa/ErasureCodeIsa.h:48-49 caps) and
sequential, so it stays host-side; decode kernels stay erasure-pattern
agnostic and consume the cached inverted matrix (the TableCache precedent,
isa/ErasureCodeIsaTableCache.cc — SURVEY.md section 7 "Hard parts").
"""

from __future__ import annotations

import numpy as np

from .tables import gf_div, gf_inv, gf_mul, gf_pow

MAX_K = 32  # isa/ErasureCodeIsa.h:48
MAX_M = 32  # isa/ErasureCodeIsa.h:49


def identity(k: int) -> np.ndarray:
    return np.eye(k, dtype=np.uint8)


def gf_matmul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product (numpy reference; small matrices only)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            acc = 0
            for t in range(a.shape[1]):
                acc ^= gf_mul(int(a[i, t]), int(b[t, j]))
            out[i, j] = acc
    return out


def gf_invert_matrix(m: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix by Gauss-Jordan elimination.

    Raises ValueError if singular (the caller treats that as "erasure
    pattern not decodable", e.g. SHEC's determinant search).
    """
    m = np.asarray(m, dtype=np.uint8).copy()
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError(f"not square: {m.shape}")
    inv = identity(n)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if m[row, col]:
                pivot = row
                break
        if pivot is None:
            raise ValueError("singular GF(2^8) matrix")
        if pivot != col:
            m[[col, pivot]] = m[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        pv = gf_inv(int(m[col, col]))
        for j in range(n):
            m[col, j] = gf_mul(int(m[col, j]), pv)
            inv[col, j] = gf_mul(int(inv[col, j]), pv)
        for row in range(n):
            if row != col and m[row, col]:
                f = int(m[row, col])
                for j in range(n):
                    m[row, j] ^= gf_mul(f, int(m[col, j]))
                    inv[row, j] ^= gf_mul(f, int(inv[col, j]))
    return inv


def vandermonde_rs_matrix(k: int, m: int) -> np.ndarray:
    """jerasure reed_sol_van: systematized (k+m) x k Vandermonde.

    Build V[i, j] = i^j over GF(2^8) for i in [0, k+m), then right-multiply
    by inv(top k x k block) so the top becomes identity — algebraically the
    distribution matrix jerasure's reed_sol_vandermonde_coding_matrix
    produces by column elimination. Rows k.. are the parity (coding) rows.
    """
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for GF(2^8) Vandermonde")
    v = np.zeros((k + m, k), dtype=np.uint8)
    for i in range(k + m):
        for j in range(k):
            v[i, j] = gf_pow(i, j) if i > 0 else (1 if j == 0 else 0)
    top_inv = gf_invert_matrix(v[:k, :])
    return gf_matmul_np(v, top_inv)


def isa_rs_matrix(k: int, m: int) -> np.ndarray:
    """ISA-L gf_gen_rs_matrix semantics: identity + geometric parity rows.

    Parity row i (0-based among parities) is the geometric sequence
    p[j] = gen_i^j with gen_i = 2^i: row 0 is all-ones, the base
    doubles per row. MDS only
    within (k<=21,m<=4)/(k<=32,m<=3) envelope (isa/README:23-24); callers
    must respect that envelope exactly as the reference does.
    """
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for GF(2^8)")
    a = np.zeros((k + m, k), dtype=np.uint8)
    for i in range(k):
        a[i, i] = 1
    gen = 1
    for i in range(m):
        p = 1
        for j in range(k):
            a[k + i, j] = p
            p = gf_mul(gen, p)
        gen = gf_mul(gen, 2)
    return a


def isa_cauchy_matrix(k: int, m: int) -> np.ndarray:
    """ISA-L gf_gen_cauchy1_matrix: identity top, then 1/(i ^ j) rows.

    Reference call site: isa/ErasureCodeIsa.cc:598-600 (matrixtype
    kVandermonde vs kCauchy). Always MDS for k+m <= 256.
    """
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for GF(2^8)")
    a = np.zeros((k + m, k), dtype=np.uint8)
    for i in range(k):
        a[i, i] = 1
    for i in range(k, k + m):
        for j in range(k):
            a[i, j] = gf_inv(i ^ j)  # i >= k > j so i^j != 0
    return a


def cauchy_original_matrix(k: int, m: int) -> np.ndarray:
    """jerasure cauchy_original_coding_matrix: C[i][j] = 1/(i ^ (m+j)).

    Points x_i = i (parities) and y_j = m+j (data) are disjoint, so every
    minor is nonsingular (classic Cauchy MDS property). Returns the full
    systematic (k+m) x k matrix (identity on top).
    """
    if k + m > 256:
        raise ValueError("k+m must be <= 256")
    a = np.zeros((k + m, k), dtype=np.uint8)
    for i in range(k):
        a[i, i] = 1
    for i in range(m):
        for j in range(k):
            a[k + i, j] = gf_inv(i ^ (m + j))
    return a


def _ones_in_bitmatrix_row(c: int) -> int:
    from .tables import mul_bitmatrix

    return int(mul_bitmatrix(c).sum())


def cauchy_good_matrix(k: int, m: int) -> np.ndarray:
    """jerasure cauchy_good: original Cauchy improved to minimize XOR count.

    jerasure's improve_coding_matrix: (1) scale each column so parity row 0
    becomes all ones, (2) for each later parity row, try scaling the row by
    the inverse of each of its elements and keep the scaling with the
    fewest total ones across the row's 8x8 mul bitmatrices. Row/column
    scaling by nonzero constants preserves the Cauchy MDS property.
    """
    a = cauchy_original_matrix(k, m)
    p = a[k:, :].copy()
    for j in range(k):
        f = gf_inv(int(p[0, j]))
        for i in range(m):
            p[i, j] = gf_mul(int(p[i, j]), f)
    for i in range(1, m):
        best_row = p[i, :].copy()
        best_cost = sum(_ones_in_bitmatrix_row(int(c)) for c in best_row)
        for divisor in sorted({int(c) for c in p[i, :] if c > 1}):
            cand = np.array(
                [gf_div(int(c), divisor) for c in p[i, :]], dtype=np.uint8
            )
            cost = sum(_ones_in_bitmatrix_row(int(c)) for c in cand)
            if cost < best_cost:
                best_cost = cost
                best_row = cand
        p[i, :] = best_row
    out = a.copy()
    out[k:, :] = p
    return out


def raid6_matrix(k: int) -> np.ndarray:
    """jerasure reed_sol_r6_op layout: P = XOR of data, Q = sum 2^j * d_j."""
    a = np.zeros((k + 2, k), dtype=np.uint8)
    for i in range(k):
        a[i, i] = 1
    a[k, :] = 1
    for j in range(k):
        a[k + 1, j] = gf_pow(2, j)
    return a


def decode_matrix(
    generator: np.ndarray, k: int, present_rows: list[int]
) -> np.ndarray:
    """Rows that reconstruct ALL k data chunks from ``present_rows`` chunks.

    ``generator`` is the full (k+m) x k systematic matrix; ``present_rows``
    selects >= k surviving chunk indices (data rows are identity rows).
    Returns a k x len(present_rows) matrix D with data = D @ survivors.
    Equivalent to the invert-submatrix step of ISA-L decode
    (isa/ErasureCodeIsa.cc:504-516). Raises ValueError if the pattern is
    undecodable (non-MDS codes like isa Vandermonde outside its envelope,
    or SHEC with too many erasures).
    """
    if len(present_rows) < k:
        raise ValueError(f"need >= {k} chunks, have {len(present_rows)}")
    rows = sorted(present_rows)[: generator.shape[0]]
    # Choose k linearly independent survivor rows by greedy rank extension
    # (incremental Gaussian elimination) — O(len(rows) * k^2), needed for
    # non-MDS codes where the first k survivors may be dependent.
    chosen: list[int] = []
    echelon: list[np.ndarray] = []  # reduced rows mirroring `chosen`
    for r in rows:
        if len(chosen) == k:
            break
        v = generator[r].astype(np.uint8).copy()
        for e in echelon:
            lead = int(np.argmax(e != 0))
            if v[lead]:
                f = gf_div(int(v[lead]), int(e[lead]))
                for j in range(k):
                    v[j] ^= gf_mul(f, int(e[j]))
        if v.any():
            chosen.append(r)
            echelon.append(v)
    if len(chosen) < k:
        raise ValueError("erasure pattern not decodable")
    inv = gf_invert_matrix(np.stack([generator[r] for r in chosen]))
    d = np.zeros((k, len(rows)), dtype=np.uint8)
    for out_col, r in enumerate(rows):
        if r in chosen:
            d[:, out_col] = inv[:, chosen.index(r)]
    return d
