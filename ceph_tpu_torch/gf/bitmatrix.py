"""GF(2) bit-matrix operations.

Two uses, mirroring the reference:

1. Lowering a GF(2^8) generator matrix to one (m*8) x (k*8) binary matrix
   so encode is a single mod-2 matmul — the plain replacement for jerasure's
   ``jerasure_matrix_to_bitmatrix`` + XOR schedules.
2. Native bit-matrix codes (cauchy_good schedules, liberation family,
   blaum_roth, liber8tion — ErasureCodeJerasure.h:188-324) whose
   generators are defined directly over GF(2) with word size w.
"""

from __future__ import annotations

import numpy as np

from .tables import MUL_BITMATRIX


def gf_matrix_to_bitmatrix(m: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) matrix [r, c] to its GF(2) form [r*8, c*8].

    Block (i, j) is the 8x8 multiply-by-m[i,j] matrix, so
    bits(out_i) = XOR_j block(i,j) @ bits(in_j) with LSB-first bit order.
    """
    m = np.asarray(m, dtype=np.uint8)
    r, c = m.shape
    blocks = MUL_BITMATRIX[m]  # [r, c, 8, 8]
    return blocks.transpose(0, 2, 1, 3).reshape(r * 8, c * 8).astype(np.uint8)


def bitmatrix_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2)."""
    return (a.astype(np.int64) @ b.astype(np.int64) % 2).astype(np.uint8)


def bitmatrix_invert(m: np.ndarray) -> np.ndarray:
    """Invert a square GF(2) matrix; ValueError if singular.

    Used for decode of native bit-matrix codes (liberation family), where
    the decode transform is the inverse of the surviving (k*w) x (k*w)
    sub-bitmatrix — jerasure_invert_bitmatrix's role in the reference.
    """
    m = np.asarray(m, dtype=np.uint8).copy()
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError(f"not square: {m.shape}")
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if m[row, col]:
                pivot = row
                break
        if pivot is None:
            raise ValueError("singular GF(2) matrix")
        if pivot != col:
            m[[col, pivot]] = m[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        for row in range(n):
            if row != col and m[row, col]:
                m[row, :] ^= m[col, :]
                inv[row, :] ^= inv[col, :]
    return inv
