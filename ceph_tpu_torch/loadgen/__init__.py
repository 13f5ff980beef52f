"""Live-cluster load generation & benchmarking — the radosbench /
thrash-erasure-code-workload analog (qa/suites/rados/
thrash-erasure-code/workloads/ec-radosbench.yaml).

Everything the kernel benchmarks cannot see lives here: the client ->
socket OSDs -> device codec -> store money path under a declarative
op mix, with per-op verification, exactly-once accounting, HDR-style
latency recording, and a fault schedule that kills/revives OSDs
mid-run to measure degraded-window throughput and time-to-recovered.
The cluster's monitor and daemons run on the card unless
``LoadCluster(device="cpu")`` asks for the CPU.

    from ceph_tpu_torch.loadgen import (
        FaultEvent, FaultSchedule, LoadCluster, WorkloadSpec, run_spec,
    )

    cluster = LoadCluster(n_osds=6, k=3, m=2)  # device="cuda"
    try:
        report = run_spec(
            cluster,
            WorkloadSpec(mix={"seq_write": 1, "read": 2},
                         total_ops=200),
            FaultSchedule([FaultEvent(60, "kill"),
                           FaultEvent(120, "revive")]),
        )
    finally:
        cluster.shutdown()
"""

from .cluster import LoadCluster
from .driver import LoadGenerator, run_multi_tenant, run_spec
from .faults import FaultEvent, FaultSchedule
from .forensics import run_is_green, write_bundle
from .histogram import Log2Histogram
from .recorder import DeviceClock, RunRecorder
from .spec import (
    OP_CLASSES,
    PRESETS,
    Popularity,
    WorkloadSpec,
    default_tenants,
    expected_image,
    object_bytes,
    parse_mix,
    patch_bytes,
    preset,
    tenant_specs,
)

__all__ = [
    "DeviceClock",
    "FaultEvent",
    "FaultSchedule",
    "LoadCluster",
    "LoadGenerator",
    "Log2Histogram",
    "OP_CLASSES",
    "PRESETS",
    "Popularity",
    "RunRecorder",
    "WorkloadSpec",
    "default_tenants",
    "expected_image",
    "object_bytes",
    "parse_mix",
    "patch_bytes",
    "preset",
    "run_is_green",
    "run_multi_tenant",
    "run_spec",
    "tenant_specs",
    "write_bundle",
]
