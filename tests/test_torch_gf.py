"""ceph_tpu_torch.gf against ceph_tpu.gf: tables, generator matrices,
decode matrices, bit-matrix forms and the host apply must be equal."""

import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

import ceph_tpu.gf as ref  # noqa: E402
import ceph_tpu_torch.gf as port  # noqa: E402
from ceph_tpu.gf.tables import gf_apply_bytes_host as ref_apply  # noqa: E402
from ceph_tpu_torch.gf.tables import (  # noqa: E402
    gf_apply_bytes_host as port_apply,
)

GENERATORS = [
    "isa_rs_matrix", "isa_cauchy_matrix", "vandermonde_rs_matrix",
    "cauchy_original_matrix", "cauchy_good_matrix",
]
GEOMETRIES = [(4, 2), (5, 3), (6, 3), (8, 3), (8, 4), (10, 4), (21, 4)]


def test_tables_equal():
    assert np.array_equal(port.gf_exp, ref.gf_exp)
    assert np.array_equal(port.gf_log, ref.gf_log)
    assert np.array_equal(port.gf_inv_table, ref.gf_inv_table)
    assert np.array_equal(port.MUL_BITMATRIX, ref.MUL_BITMATRIX)
    for a, b in itertools.product(range(0, 256, 7), range(1, 256, 11)):
        assert port.gf_mul(a, b) == ref.gf_mul(a, b)
        assert port.gf_div(a, b) == ref.gf_div(a, b)


@pytest.mark.parametrize("name", GENERATORS)
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_generator_matrices_equal(name, k, m):
    got = getattr(port, name)(k, m)
    want = getattr(ref, name)(k, m)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(
        port.gf_matrix_to_bitmatrix(got[k:]),
        ref.gf_matrix_to_bitmatrix(want[k:]),
    )


@pytest.mark.parametrize("k,m", [(4, 2), (8, 3), (8, 4)])
def test_decode_matrices_equal(k, m):
    gen = port.isa_rs_matrix(k, m)
    for lost in itertools.combinations(range(k + m), m):
        present = [i for i in range(k + m) if i not in lost]
        assert np.array_equal(
            port.decode_matrix(gen, k, present),
            ref.decode_matrix(gen, k, present),
        )


def test_bitmatrix_invert_equal(rng):
    gen = port.isa_cauchy_matrix(6, 3)
    sub = port.gf_matrix_to_bitmatrix(gen[[0, 2, 4, 6, 7, 8]])
    assert np.array_equal(
        port.bitmatrix_invert(sub), ref.bitmatrix_invert(sub)
    )
    assert np.array_equal(
        port.bitmatrix_matmul(sub, port.bitmatrix_invert(sub)),
        np.eye(48, dtype=np.uint8),
    )


@pytest.mark.parametrize("k,m", [(4, 2), (8, 4), (10, 4)])
def test_host_apply_equal(rng, k, m):
    gen = port.isa_cauchy_matrix(k, m)
    data = rng.integers(0, 256, (3, k, 777), dtype=np.uint8)
    assert np.array_equal(
        port_apply(gen[k:], data), ref_apply(gen[k:], data)
    )
