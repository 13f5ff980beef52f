"""GF(2^8) arithmetic and the two generator matrices the benchmark's
configurations name, written from the plugins' published constructions.

- ``isa_rs_matrix``: ISA-L ``gf_gen_rs_matrix`` (the ``isa`` plugin's
  ``reed_sol_van``): identity on top, parity row i the geometric
  sequence of gen_i = 2^i, so parity row 0 is all ones.
- ``jerasure_rs_van_matrix``: jerasure ``reed_sol_van``: the extended
  Vandermonde matrix V[i, j] = i^j over GF(2^8), brought to systematic
  form by right-multiplying with the inverse of its top k x k block.

Field: x^8 + x^4 + x^3 + x^2 + 1 (0x11D), bit i the coefficient of x^i,
as ISA-L and gf-complete use it. Plain numpy; imports nothing of the
program. Both matrices are held to the repository's golden corpus by
``ecbench/tests/test_ecbench_reference.py``.
"""

from __future__ import annotations

import numpy as np

POLY = 0x11D


def _tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]
    return exp, log


EXP, LOG = _tables()


def mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of zero")
    return int(EXP[255 - LOG[a]])


def power(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP[(LOG[a] * n) % 255])


def mul_table() -> np.ndarray:
    """[256, 256] uint8: row c holds c * x for every byte x."""
    t = np.zeros((256, 256), dtype=np.uint8)
    nz = np.arange(1, 256)
    for c in range(1, 256):
        t[c, 1:] = EXP[LOG[c] + LOG[nz]]
    return t


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            acc = 0
            for t in range(a.shape[1]):
                acc ^= mul(int(a[i, t]), int(b[t, j]))
            out[i, j] = acc
    return out


def invert(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan over GF(2^8); ValueError when singular."""
    m = np.array(m, dtype=np.uint8)
    n = m.shape[0]
    out = np.eye(n, dtype=np.uint8)
    for col in range(n):
        pivot = next((r for r in range(col, n) if m[r, col]), None)
        if pivot is None:
            raise ValueError("singular GF(2^8) matrix")
        m[[col, pivot]] = m[[pivot, col]]
        out[[col, pivot]] = out[[pivot, col]]
        p = inv(int(m[col, col]))
        m[col] = [mul(int(v), p) for v in m[col]]
        out[col] = [mul(int(v), p) for v in out[col]]
        for r in range(n):
            f = int(m[r, col])
            if r != col and f:
                m[r] ^= np.array([mul(f, int(v)) for v in m[col]], np.uint8)
                out[r] ^= np.array(
                    [mul(f, int(v)) for v in out[col]], np.uint8)
    return out


def isa_rs_matrix(k: int, m: int) -> np.ndarray:
    a = np.zeros((k + m, k), dtype=np.uint8)
    a[:k] = np.eye(k, dtype=np.uint8)
    gen = 1
    for i in range(m):
        p = 1
        for j in range(k):
            a[k + i, j] = p
            p = mul(gen, p)
        gen = mul(gen, 2)
    return a


def jerasure_rs_van_matrix(k: int, m: int) -> np.ndarray:
    v = np.zeros((k + m, k), dtype=np.uint8)
    for i in range(k + m):
        for j in range(k):
            v[i, j] = power(i, j) if i > 0 else int(j == 0)
    return matmul(v, invert(v[:k]))


def generator(plugin: str, technique: str, k: int, m: int) -> np.ndarray:
    """(k+m) x k systematic generator of a configuration's profile."""
    if technique != "reed_sol_van":
        raise ValueError(f"no reference for technique {technique!r}")
    if plugin == "isa":
        return isa_rs_matrix(k, m)
    if plugin == "jerasure":
        return jerasure_rs_van_matrix(k, m)
    raise ValueError(f"no reference for plugin {plugin!r}")
