"""Runtime utilities: perf counters, config, tracing, the op tracker and
cluster log, the admin command surface — the ``src/common/`` analog
layer — plus device choice (``device``). Crash points
(``crash_points``), the lock-order checker (``lockdep``), logging
(``log``), the dmClock scheduler (``mclock``) and the reservers
(``reserver``) are imported from their modules."""

from .perf_counters import (
    PerfCounters,
    PerfCountersBuilder,
    PerfCountersCollection,
    perf_collection,
)
from .config import ConfigProxy, Option, config
from .trace import Tracer, tracer
from .optracker import NULL_OP, OpTracker, TrackedOp, op_tracker
from .cluster_log import ClusterLog, cluster_log
from .admin_socket import AdminSocket, admin_socket

__all__ = [
    "PerfCounters",
    "PerfCountersBuilder",
    "PerfCountersCollection",
    "perf_collection",
    "ConfigProxy",
    "Option",
    "config",
    "Tracer",
    "tracer",
    "NULL_OP",
    "OpTracker",
    "TrackedOp",
    "op_tracker",
    "ClusterLog",
    "cluster_log",
    "AdminSocket",
    "admin_socket",
]
