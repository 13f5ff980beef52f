"""Multi-device shard fan-out over a (dp, sp) mesh of torch devices:
the mesh and its sharded encode / decode (``mesh``), the ring and
sequence-parallel CRC schedules (``collectives``), the process-wide
dispatch seam the codecs route through (``dispatch``), and the
multi-process DCN hosts (``dcn``)."""

from .collectives import (  # noqa: F401
    ring_parity,
    sharded_crc32c,
)
from .dispatch import (  # noqa: F401
    get_dcn,
    get_mesh,
    mesh_apply_bitmatrix,
    mesh_supported,
    set_dcn,
    set_mesh,
    use_dcn,
    use_mesh,
)
from .mesh import (  # noqa: F401
    EcMesh,
    make_ec_mesh,
    sharded_decode,
    sharded_encode,
    sharded_pipeline_step,
)
