"""Erasure-code families behind one codec protocol.

The plugin subsystem of the reference (src/erasure-code/ — SURVEY.md
section 2.1): a registry of codec factories (``registry``), the
contract (``interface``), shared default behavior (``base``), the
GF(2^8) matrix engine (``matrix_codec``), the packet bit-matrix engine
(``bitmatrix_codec``) and the ported families:

- ``isa``: Reed-Solomon Vandermonde + Cauchy with decode-table cache
- ``jerasure``: the seven techniques (reed_sol_van, reed_sol_r6_op,
  cauchy_orig, cauchy_good, liberation, blaum_roth, liber8tion)
- ``xor``: single XOR parity
- ``lrc``: layered locally repairable codes (kml and explicit layers)
- ``clay``: coupled-layer MSR codes with fractional single-chunk repair
- ``shec``: shingled erasure codes (non-MDS, fewer reads per repair)
"""

from .interface import (  # noqa: F401
    ErasureCodec,
    ErasureCodeProfile,
    Flag,
    SubChunkPlan,
)
from .registry import (  # noqa: F401
    ErasureCodePluginRegistry,
    registry,
    create_codec,
)

# Register in-tree plugins (the analog of osd_erasure_code_plugins
# preload — global.yaml.in:2638).
from . import clay as _clay  # noqa: E402,F401
from . import isa as _isa  # noqa: E402,F401
from . import jerasure as _jerasure  # noqa: E402,F401
from . import lrc as _lrc  # noqa: E402,F401
from . import shec as _shec  # noqa: E402,F401
from . import xor_codec as _xor  # noqa: E402,F401
