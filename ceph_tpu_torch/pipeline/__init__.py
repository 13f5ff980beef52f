"""EC pipeline slice: the OSD EC data-path semantics over batched launches.

Mirrors the role of the reference's osd/EC* stack (SURVEY.md section
2.2): ``stripe`` is the ECUtil geometry, ``shard_map`` the
shard_extent_map_t codec drivers, ``hashinfo`` the ECUtil::HashInfo
cumulative crcs, ``read`` the read plan and reconstruction (CLAY
fractional repair included). RMW, the read pipeline's fan-out and retry,
recovery and the stores are still to be ported (ROADMAP.md).
"""

from .extents import ExtentSet
from .hashinfo import HashInfo
from .shard_map import ShardExtentMap
from .stripe import StripeInfo

__all__ = ["ExtentSet", "HashInfo", "ShardExtentMap", "StripeInfo"]
