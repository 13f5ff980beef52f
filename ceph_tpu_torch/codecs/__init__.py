"""Erasure-code families behind one codec protocol.

The plugin subsystem of the reference (src/erasure-code/ — SURVEY.md
section 2.1): a registry of codec factories (``registry``), the
contract (``interface``), shared default behavior (``base``), the
matrix engine (``matrix_codec``) and the ported families:

- ``isa``: Reed-Solomon Vandermonde + Cauchy with decode-table cache

jerasure, lrc, shec, clay and xor are still to be ported (ROADMAP.md).
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
from . import isa as _isa  # noqa: E402,F401
