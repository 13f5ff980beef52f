"""EC pipeline: the OSD EC data-path semantics over batched launches.

Mirrors the role of the reference's osd/EC* stack (SURVEY.md section
2.2): ``stripe`` is the ECUtil geometry, ``shard_map`` the
shard_extent_map_t codec drivers, ``hashinfo`` the ECUtil::HashInfo
cumulative crcs, ``extent_cache`` the ECExtentCache, ``rmw`` the
RMWPipeline and ECTransaction write planning, ``read`` the
ReadPipeline (read plan, sub-read fan-out, EIO retry, reconstruction,
CLAY fractional repair included), ``recovery`` the RecoveryBackend and
deep scrub, ``pglog`` the PGLog's dirty extents and ``inject`` the
ECInject fault seams. Shards live in ``ceph_tpu_torch.store`` stores.
"""

from .extents import ExtentSet
from .hashinfo import HashInfo
from .stripe import StripeInfo
from .shard_map import ShardExtentMap
from .read import ReadPipeline, ShardReadError
from .recovery import RecoveryBackend, RecoveryState, be_deep_scrub
from .pglog import PGLog

__all__ = [
    "ExtentSet",
    "HashInfo",
    "StripeInfo",
    "ShardExtentMap",
    "ReadPipeline",
    "ShardReadError",
    "RecoveryBackend",
    "RecoveryState",
    "be_deep_scrub",
    "PGLog",
]
