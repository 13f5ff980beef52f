"""GF(2^8) arithmetic for erasure coding.

Host side (numpy): tables, generator-matrix construction, inversion
(``tables``, ``matrices``) and the GF(2) bit-matrix form
(``bitmatrix``). Device side: ``ceph_tpu_torch.ops``.

Polynomial: x^8 + x^4 + x^3 + x^2 + 1 (0x11D), the field used by both
ISA-L and gf-complete's default w=8 field (the two SIMD GF backends the
reference vendors — SURVEY.md section 2.1).
"""

from .tables import (  # noqa: F401
    GF_POLY,
    gf_exp,
    gf_log,
    gf_inv_table,
    gf_mul,
    gf_div,
    gf_inv,
    gf_pow,
    gf_apply_bytes_host,
    gf_mul_bytes,
    mul_bitmatrix,
    MUL_BITMATRIX,
)
from .matrices import (  # noqa: F401
    identity,
    vandermonde_rs_matrix,
    isa_rs_matrix,
    isa_cauchy_matrix,
    cauchy_original_matrix,
    cauchy_good_matrix,
    raid6_matrix,
    gf_matmul_np,
    gf_invert_matrix,
    decode_matrix,
)
from .bitmatrix import (  # noqa: F401
    gf_matrix_to_bitmatrix,
    bitmatrix_invert,
    bitmatrix_matmul,
)
