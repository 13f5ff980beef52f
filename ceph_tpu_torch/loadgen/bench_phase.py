"""The BENCH json ``cluster`` phase: what the LIVE TIER gives back.

Every other bench phase clocks a kernel or a codec dispatch; this one
boots the real mini-cluster (mon + socket OSDs + device codecs +
stores), drives a mixed workload with a mid-run OSD kill/revive, and
reports the end-to-end service numbers next to the kernel ones:

- ``cluster_gbps`` / ``cluster_iops``   measured-window aggregate
- ``cluster_p99_ms``                    small-op p99 from the DEVICE
  clock (host floor replaced by the device time of one encode, from
  CUDA events; ``cluster_p99_host_ms`` keeps the raw host row for
  comparison)
- ``cluster_degraded_gbps`` / ``cluster_degraded_window_s`` /
  ``cluster_time_to_recovered_s``       the fault-schedule cut
- ``cluster_vs_kernel_frac``            cluster_gbps over the flagship
  kernel encode rate — the tax the whole service stack levies on the
  raw codec (client, sockets, daemon locks, store writes, checksums)

Round 10 adds the serving-tier observables:

- the main leg runs at qd ≫ 12 with zipfian popularity through the
  ASYNC objecter + per-tick op coalescing, and a second leg in the
  SAME run with ``osd_op_coalescing=false`` pins the A/B:
  ``cluster_gbps_nocoal`` / ``cluster_vs_kernel_frac_nocoal`` /
  ``cluster_coalesce_speedup``;
- a scaling row: ``cluster_scale_osd<N>_gbps`` / ``_iops`` legs over
  OSD counts, and ``cluster_scale_chips<C>_gbps`` / ``_iops`` legs
  with the dispatch mesh installed over C devices (the chip axis) —
  GB/s and IOPS vs OSD count / chip count in one run. The chip legs
  count the box's physical devices of the cluster's device type (one
  for the CPU) and ask the mesh for that many physical devices: a
  scaling number is never measured over logical devices, so on one
  card only the one-chip leg runs (a leg above it would raise the
  mesh's ``ValueError``).

Round 14 adds the observability-plane A/B: the same workload with
the live-op tracker + tracer OFF (``cluster_gbps_tracked`` /
``cluster_gbps_untracked`` / ``trace_overhead_frac`` = 1 −
tracked/untracked, acceptance < 0.02) — proving the always-on
plane (TrackedOp registration + event marks across objecter, RMW
and sub-op layers) is cheap enough to leave on.

Round 15 adds the stats-plane A/B the same way: reports on vs
``osd_stats_report_interval=0`` (``cluster_gbps_stats_on`` /
``cluster_gbps_stats_off`` / ``stats_report_overhead_frac`` = 1 −
on/off, acceptance < 0.01) — the PG-stats pipeline's cost on the
smallop-heavy serving path.

Sized by ``CEPH_TPU_BENCH_CLUSTER_OPS`` (default 240 ops at queue
depth ``CEPH_TPU_BENCH_CLUSTER_QD`` = 32 over
``CEPH_TPU_BENCH_CLUSTER_OBJECTS`` = 256 objects of 256 KiB; larger
runs raise the env vars — thousands of objects — without code
edits). Scaling legs run at half the main leg's ops each.

Every leg boots its cluster on ``device`` (``"cuda"`` unless the caller
asks for the CPU); the result keys are the JAX package's."""

from __future__ import annotations

import os

from .cluster import LoadCluster
from .driver import run_spec
from .faults import FaultEvent, FaultSchedule
from .spec import WorkloadSpec

_MIX = {
    "seq_write": 2, "rand_write": 1, "read": 3,
    "reconstruct_read": 1, "rmw_overwrite": 1,
}


def _leg(
    total_ops: int,
    qd: int,
    max_objects: int,
    *,
    n_osds: int = 6,
    k: int = 4,
    m: int = 2,
    faults: bool = False,
    net_flaky: bool = False,
    device_clock: bool = False,
    use_mesh: bool = False,
    mesh_devices: int | None = None,
    seed: int = 0xEC,
    device="cuda",
) -> dict:
    from ceph_tpu_torch.utils import config as _cfg

    overrides = {}
    if net_flaky:
        # lossy-link leg: lost frames must resolve via the sub-op
        # retransmit ladder + a short RPC deadline, not 10 s parks
        overrides = dict(
            osd_peer_rpc_timeout=1.0, osd_subop_resend_interval=0.2,
        )
    with _cfg.override(**overrides):
        cluster = LoadCluster(
            n_osds=n_osds, k=k, m=m, pg_num=8, chunk_size=16384,
            use_mesh=use_mesh, mesh_devices=mesh_devices, device=device,
        )
        try:
            spec = WorkloadSpec(
                mix=dict(_MIX),
                object_size=256 * 1024,
                max_objects=max_objects,
                queue_depth=qd,
                total_ops=total_ops,
                warmup_ops=max(total_ops // 10, 8),
                popularity="zipfian",
                device_clock=device_clock,
                seed=seed,
            )
            schedule = None
            if faults:
                schedule = FaultSchedule(
                    [
                        FaultEvent(at_op=total_ops // 3, action="kill"),
                        FaultEvent(at_op=(2 * total_ops) // 3,
                                   action="revive"),
                    ]
                )
            elif net_flaky:
                # degraded-link leg: the acceptance profile held for
                # the MIDDLE half of the run (fire/settle offsets)
                schedule = FaultSchedule.net_flaky(
                    total_ops, seed=seed,
                )
            return run_spec(cluster, spec, schedule)
        finally:
            cluster.shutdown()


def measure_cluster(
    result: dict, enc_gbps: float, device="cuda"
) -> None:
    from ceph_tpu_torch.utils import config

    total_ops = int(
        os.environ.get("CEPH_TPU_BENCH_CLUSTER_OPS", "240")
    )
    qd = int(os.environ.get("CEPH_TPU_BENCH_CLUSTER_QD", "32"))
    max_objects = int(
        os.environ.get("CEPH_TPU_BENCH_CLUSTER_OBJECTS", "256")
    )
    report = _leg(
        total_ops, qd, max_objects, faults=True, device_clock=True,
        device=device,
    )

    result["cluster_gbps"] = report["gbps"]
    result["cluster_iops"] = report["iops"]
    result["cluster_qd"] = qd
    result["cluster_objects"] = max_objects
    if "lat_p99_ms" in report:
        result["cluster_p99_host_ms"] = report["lat_p99_ms"]
        # device-clock p99 when the cluster runs on the card (the
        # host row keeps the constant socket and dispatch floor)
        result["cluster_p99_ms"] = report.get(
            "lat_p99_ms_device", report["lat_p99_ms"]
        )
    fault = report.get("fault", {})
    for key in (
        "degraded_gbps", "degraded_window_s", "time_to_recovered_s"
    ):
        if key in fault:
            result[f"cluster_{key}"] = fault[key]
    result["cluster_verify_failures"] = report["verify_failures"]
    result["cluster_errors"] = report["errors"]
    result["cluster_recovered"] = bool(report.get("recovered"))
    if enc_gbps:
        # the kernel-vs-cluster efficiency ratio: how much of the raw
        # codec rate survives the full service path (8 decimals so a
        # Python-socket-tier number doesn't round to zero)
        result["cluster_vs_kernel_frac"] = round(
            report["gbps"] / enc_gbps, 8
        )

    # -- degraded-link row: the same workload under the seeded
    # net_flaky acceptance profile (>=2% drop + dup + ~50 ms p95
    # delay on every inter-OSD link for the middle half of the run)
    # — what the serving tier returns when the FABRIC, not a member,
    # is the fault (arxiv 1906.08602's degraded-mode thesis)
    flaky = _leg(
        total_ops, qd, max_objects, net_flaky=True, device=device
    )
    result["cluster_degraded_link_gbps"] = flaky["gbps"]
    result["cluster_degraded_link_iops"] = flaky["iops"]
    result["cluster_degraded_link_verify_failures"] = (
        flaky["verify_failures"]
    )
    if report["gbps"]:
        result["cluster_degraded_link_frac"] = round(
            flaky["gbps"] / report["gbps"], 6
        )

    # -- A/B: the same workload with coalescing OFF, in the same run
    # (the acceptance comparison is within-run, not across BENCH
    # files — host load drifts between runs)
    with config.override(osd_op_coalescing=False):
        off = _leg(
            total_ops, qd, max_objects, seed=0xEC0FF, device=device
        )
    result["cluster_gbps_nocoal"] = off["gbps"]
    result["cluster_iops_nocoal"] = off["iops"]
    if enc_gbps:
        result["cluster_vs_kernel_frac_nocoal"] = round(
            off["gbps"] / enc_gbps, 8
        )
    if off["gbps"]:
        result["cluster_coalesce_speedup"] = round(
            report["gbps"] / off["gbps"], 4
        )

    # -- A/B: tracked vs untracked (round-14 observability plane) —
    # the SAME seed and sizing with the live-op tracker + tracer off,
    # pinning what the always-on plane costs the smallop-heavy path.
    # trace_overhead_frac = 1 - tracked/untracked; acceptance < 0.02
    # (cheap enough to leave on), within-run like the coalesce A/B.
    scale_ops = max(total_ops // 2, 40)
    tracked = _leg(
        scale_ops, qd, max_objects, seed=0x7ACE, device=device
    )
    from ceph_tpu_torch.utils import tracer as _tracer

    with config.override(osd_enable_op_tracker=False):
        _was = _tracer.enabled
        _tracer.enabled = False
        try:
            untracked = _leg(
                scale_ops, qd, max_objects, seed=0x7ACE, device=device
            )
        finally:
            _tracer.enabled = _was
    result["cluster_gbps_tracked"] = tracked["gbps"]
    result["cluster_gbps_untracked"] = untracked["gbps"]
    if untracked["gbps"]:
        result["trace_overhead_frac"] = round(
            max(1.0 - tracked["gbps"] / untracked["gbps"], 0.0), 6
        )

    # -- A/B: stats reporting on vs off (round-15 stats plane) — the
    # SAME seed and sizing with `osd_stats_report_interval=0` as the
    # off arm, pinning what the tick-driven PG-stats pipeline (store
    # census + report fold + rate rings) costs the serving path.
    # stats_report_overhead_frac = 1 - on/off; acceptance < 0.01.
    stats_on = _leg(
        scale_ops, qd, max_objects, seed=0x57A75, device=device
    )
    with config.override(osd_stats_report_interval=0.0):
        stats_off = _leg(
            scale_ops, qd, max_objects, seed=0x57A75, device=device
        )
    result["cluster_gbps_stats_on"] = stats_on["gbps"]
    result["cluster_gbps_stats_off"] = stats_off["gbps"]
    if stats_off["gbps"]:
        result["stats_report_overhead_frac"] = round(
            max(1.0 - stats_on["gbps"] / stats_off["gbps"], 0.0), 6
        )

    # -- scaling rows: GB/s and IOPS vs OSD count, then vs chip count
    # (dispatch mesh over C devices). Half-length legs, no faults.
    for n_osds in (6, 9, 12):
        rep = _leg(
            scale_ops, qd, max_objects, n_osds=n_osds,
            seed=0x5CA1E + n_osds, device=device,
        )
        result[f"cluster_scale_osd{n_osds}_gbps"] = rep["gbps"]
        result[f"cluster_scale_osd{n_osds}_iops"] = rep["iops"]
    # the chip axis counts the physical devices of the cluster's
    # device type (one for the CPU); a leg above one chip installs the
    # dispatch mesh over that many physical devices, never logical ones
    import torch

    n_dev = (
        torch.cuda.device_count()
        if torch.device(device).type == "cuda" else 1
    )
    chip_legs = sorted(
        {c for c in (1, 2, 4, n_dev) if 1 <= c <= n_dev}
    )
    for chips in chip_legs:
        rep = _leg(
            scale_ops, qd, max_objects,
            use_mesh=chips > 1, mesh_devices=chips if chips > 1 else None,
            seed=0xC41B + chips, device=device,
        )
        result[f"cluster_scale_chips{chips}_gbps"] = rep["gbps"]
        result[f"cluster_scale_chips{chips}_iops"] = rep["iops"]


# -- the round-19 QoS phase: noisy neighbor + recovery slosh ------------
#: tenant A: a modest latency-sensitive mix with a reservation-bearing
#: QoS spec — the tenant whose p99 the plane must defend
_TENANT_A = {
    "mix": {"seq_write": 1, "read": 3, "rmw_overwrite": 1},
    "object_size": 64 * 1024,
    "qos": {"res_ops": 64.0, "res_bytes": 8 << 20, "weight": 4.0},
}
#: tenant B: the write-heavy flood (big objects, deep queue) whose
#: cost-tagged ops must throttle against B's OWN clocks
_TENANT_B = {
    "mix": {"seq_write": 3, "rand_write": 2},
    "object_size": 512 * 1024,
    "qos": {"weight": 1.0},
}


def qos_leg(
    total_ops: int,
    qd: int,
    max_objects: int,
    *,
    flood: bool = False,
    faults: bool = False,
    qos_on: bool = True,
    profile: str = "balanced",
    device_clock: bool = False,
    seed: int = 0x905,
    device="cuda",
) -> dict:
    """One multi-tenant leg: tenant A's modest mix, optionally tenant
    B's flood on top, optionally a mid-run most-primary kill/revive
    (recovery competing with clients), under one slosh-knob profile.
    ``qos_on=False`` is the escape hatch — every op back on the flat
    shared class."""
    from ceph_tpu_torch.utils import config as _cfg

    tenants: dict = {"tenantA": dict(_TENANT_A)}
    tenants["tenantA"]["queue_depth"] = max(qd // 4, 2)
    tenants["tenantA"]["total_ops"] = total_ops
    if flood:
        tenants["tenantB"] = dict(_TENANT_B)
        tenants["tenantB"]["queue_depth"] = qd
        tenants["tenantB"]["total_ops"] = total_ops * 2
    with _cfg.override(osd_op_qos=qos_on, osd_mclock_profile=profile):
        cluster = LoadCluster(
            n_osds=6, k=4, m=2, pg_num=8, chunk_size=16384,
            device=device,
        )
        try:
            spec = WorkloadSpec(
                mix=dict(_MIX),
                object_size=64 * 1024,
                max_objects=max_objects,
                queue_depth=qd,
                total_ops=total_ops,
                warmup_ops=max(total_ops // 10, 8),
                popularity="zipfian",
                device_clock=device_clock,
                seed=seed,
                tenants=tenants,
            )
            schedule = None
            if faults:
                # kill the most-primary OSD a third in, revive at two
                # thirds: recovery work overlaps the measured window
                schedule = FaultSchedule(
                    [
                        FaultEvent(at_op=total_ops // 3, action="kill"),
                        FaultEvent(at_op=(2 * total_ops) // 3,
                                   action="revive"),
                    ]
                )
            return run_spec(cluster, spec, schedule)
        finally:
            cluster.shutdown()


def measure_qos(result: dict, device="cuda") -> None:
    """The noisy-neighbor A/B row and the recovery-slosh curve.

    - ``qos_tenantA_p99_{solo,noisy,noqos}_ms``: tenant A's p99 alone,
      under a tenant-B flood + concurrent recovery with QoS armed, and
      the same storm with ``osd_op_qos=false`` (the escape hatch must
      demonstrably blow past the bound or the A/B proves nothing);
      ``qos_noisy_neighbor_frac`` / ``qos_escape_hatch_frac`` are the
      degradations vs solo.
    - ``qos_slosh_<profile>_{recovery_s,p99_ms}``: time-to-recovered
      vs tenant-A p99 across the three slosh-knob settings — the knob
      must trade them monotonically.

    Sized by CEPH_TPU_BENCH_QOS_OPS / _QD (defaults 160 / 16)."""
    total_ops = int(os.environ.get("CEPH_TPU_BENCH_QOS_OPS", "160"))
    qd = int(os.environ.get("CEPH_TPU_BENCH_QOS_QD", "16"))
    max_objects = 64

    solo = qos_leg(total_ops, qd, max_objects, seed=0x905, device=device)
    noisy = qos_leg(
        total_ops, qd, max_objects, flood=True, faults=True,
        seed=0x905, device=device,
    )
    noqos = qos_leg(
        total_ops, qd, max_objects, flood=True, faults=True,
        qos_on=False, seed=0x905, device=device,
    )
    rows = {"solo": solo, "noisy": noisy, "noqos": noqos}
    a_p99: dict[str, float] = {}
    for name, rep in rows.items():
        a = rep.get("tenants", {}).get("tenantA", {})
        p99 = a.get("lat_p99_ms")
        if p99 is not None:
            a_p99[name] = p99
            result[f"qos_tenantA_p99_{name}_ms"] = p99
        result[f"qos_{name}_verify_failures"] = rep.get(
            "verify_failures", -1
        )
    if a_p99.get("solo"):
        if "noisy" in a_p99:
            result["qos_noisy_neighbor_frac"] = round(
                a_p99["noisy"] / a_p99["solo"], 4
            )
        if "noqos" in a_p99:
            result["qos_escape_hatch_frac"] = round(
                a_p99["noqos"] / a_p99["solo"], 4
            )

    # the slosh curve: one recovery-under-load leg per knob setting
    for prof in ("high_client", "balanced", "high_recovery"):
        rep = qos_leg(
            total_ops, qd, max_objects, faults=True, profile=prof,
            seed=0x5105, device=device,
        )
        ttr = rep.get("fault", {}).get("time_to_recovered_s")
        if ttr is not None:
            result[f"qos_slosh_{prof}_recovery_s"] = ttr
        a = rep.get("tenants", {}).get("tenantA", {})
        if a.get("lat_p99_ms") is not None:
            result[f"qos_slosh_{prof}_p99_ms"] = a["lat_p99_ms"]


# -- the round-20 transport phase: shm-ring lane + native codec ---------
def transport_leg(
    total_ops: int,
    qd: int,
    max_objects: int,
    *,
    transport: str = "tcp",
    native_codec: bool = True,
    op_shards: int = 1,
    faults: bool = False,
    seed: int = 0xEC20,
    device="cuda",
) -> dict:
    """One transport A/B leg: the standard mixed workload with the
    messenger lane (tcp | shm_ring), the clear-frame codec
    (native C | pure Python) and the op-shard count pinned by
    config for the whole cluster lifetime. The shm stats registry
    is reset per leg so chunks/bytes are leg-scoped."""
    from ceph_tpu_torch.msg import shm_ring
    from ceph_tpu_torch.utils import config as _cfg

    shm_ring.reset_stats()
    with _cfg.override(
        msgr_transport=transport,
        msgr_native_codec=native_codec,
        osd_op_num_shards=op_shards,
    ):
        cluster = LoadCluster(
            n_osds=6, k=4, m=2, pg_num=8, chunk_size=16384,
            device=device,
        )
        try:
            spec = WorkloadSpec(
                mix=dict(_MIX),
                object_size=256 * 1024,
                max_objects=max_objects,
                queue_depth=qd,
                total_ops=total_ops,
                warmup_ops=max(total_ops // 10, 8),
                popularity="zipfian",
                seed=seed,
            )
            schedule = None
            if faults:
                schedule = FaultSchedule(
                    [
                        FaultEvent(at_op=total_ops // 3, action="kill"),
                        FaultEvent(at_op=(2 * total_ops) // 3,
                                   action="revive"),
                    ]
                )
            report = run_spec(cluster, spec, schedule)
            report["shm"] = shm_ring.snapshot()
            return report
        finally:
            cluster.shutdown()


def hol_probe_ms(
    nshards: int, park_s: float = 0.75, device="cuda"
) -> float:
    """Deterministic head-of-line probe: park one op shard's lock on
    a primary for ``park_s`` (the stand-in for the EC write wedged in
    its sub-write ``drain_until`` ladder) and time a write to a
    DIFFERENT PG on the SAME primary. At one shard the sibling rides
    the park (~park_s); with a shard pool it lands in milliseconds.
    Unlike the flood x kill legs this exercises the wedge on every
    run — the ``on_shard_down`` race the real cliff needs is
    nondeterministic."""
    import time as _time

    from ceph_tpu_torch.utils import config as _cfg

    with _cfg.override(osd_op_num_shards=nshards):
        cluster = LoadCluster(
            n_osds=5, k=2, m=1, pg_num=8, chunk_size=4096,
            device=device,
        )
        try:
            mon, pool = cluster.mon, cluster.pool
            pick = None
            by_primary: dict = {}
            for i in range(200):
                oid = f"holp-{i}"
                pgid = mon.osdmap.object_to_pg(pool, oid)
                primary = mon.osdmap.pg_primary(pool, pgid)
                d = cluster.daemons[primary]
                shard = d._op_shard_index(pool, pgid)
                slots = by_primary.setdefault(primary, {})
                # one shard: any two distinct PGs share slot key 0,
                # so key by pgid instead to get two distinct queues
                key = shard if nshards > 1 else pgid
                slots.setdefault(key, (oid, shard))
                if len(slots) >= 2:
                    (oid_a, shard_a), (oid_b, _sb) = list(
                        slots.values()
                    )[:2]
                    pick = (d, oid_a, shard_a, oid_b)
                    break
            if pick is None:
                return -1.0
            d, oid_a, shard_a, oid_b = pick
            payload = b"\x5a" * 8192
            cluster.io.write_full(oid_a, payload)  # peer + seed windows
            cluster.io.write_full(oid_b, payload)
            lock_a = d._op_shards[shard_a]
            with lock_a:
                t0 = _time.monotonic()
                comp = cluster.io.aio_write_full(oid_b, payload)
                try:
                    comp.wait_for_complete(park_s)
                except TimeoutError:
                    pass  # the 1-shard arm rides the park by design
            try:
                comp.wait_for_complete(10.0)
            except TimeoutError:
                return -1.0
            elapsed = _time.monotonic() - t0
            return round(elapsed * 1e3, 3) if comp.is_complete() else -1.0
        finally:
            cluster.shutdown()


def measure_transport(
    result: dict, enc_gbps: float, device="cuda"
) -> None:
    """The within-run A/B grid (transport x codec), the
    shm-lane headline, and the flood-kill shard ladder:

    - ``transport_{tcp,shm}_{py,native}_gbps`` four-leg grid plus a
      per-leg ``cluster_vs_kernel_frac`` row
      (``transport_<leg>_vs_kernel_frac``) — same workload, same
      seed, one process, so the ratios are drift-free;
    - ``frame_codec_speedup``  tcp+native over tcp+python — what
      moving frame assembly/verify into C buys the wire path;
    - ``shm_ring_gbps`` / ``shm_ring_speedup``  the co-located lane
      over loopback TCP (both on the native codec);
    - ``shm_ring_chunks`` / ``shm_ring_bytes``  lane traffic proof
      (zero chunks means the negotiation never upgraded — a red
      flag, not a fast run);
    - ``transport_shards{1,4}_p{50,95,99}_ms`` /
      ``shard_hol_p95_frac``  flood x kill tenant-A latency spread
      at 1 vs 4 op shards — the head-of-line regression row. The
      parked EC write itself still drains its ~15 s ``drain_until``
      ladder at ANY shard count (that is the sub-write retransmit
      path, not the worker), so the max/p99 can cliff either way;
      what the shard pool removes is the COLLATERAL wedge — every
      other PG's queue head stuck behind the parked op — which is
      exactly the p50/p95 spread (BASELINE row 64's caveat).

    Sized by CEPH_TPU_BENCH_TRANSPORT_OPS / _QD (defaults 160/24)."""
    total_ops = int(
        os.environ.get("CEPH_TPU_BENCH_TRANSPORT_OPS", "160")
    )
    qd = int(os.environ.get("CEPH_TPU_BENCH_TRANSPORT_QD", "24"))
    max_objects = 128

    legs = {}
    for tag, transport, native in (
        ("tcp_py", "tcp", False),
        ("tcp_native", "tcp", True),
        ("shm_py", "shm_ring", False),
        ("shm_native", "shm_ring", True),
    ):
        rep = transport_leg(
            total_ops, qd, max_objects,
            transport=transport, native_codec=native, device=device,
        )
        legs[tag] = rep
        result[f"transport_{tag}_gbps"] = rep["gbps"]
        result[f"transport_{tag}_iops"] = rep["iops"]
        if enc_gbps:
            result[f"transport_{tag}_vs_kernel_frac"] = round(
                rep["gbps"] / enc_gbps, 8
            )
    if legs["tcp_py"]["gbps"]:
        result["frame_codec_speedup"] = round(
            legs["tcp_native"]["gbps"] / legs["tcp_py"]["gbps"], 4
        )
    result["shm_ring_gbps"] = legs["shm_native"]["gbps"]
    if legs["tcp_native"]["gbps"]:
        result["shm_ring_speedup"] = round(
            legs["shm_native"]["gbps"] / legs["tcp_native"]["gbps"], 4
        )
    result["shm_ring_chunks"] = legs["shm_native"]["shm"]["chunks"]
    result["shm_ring_bytes"] = legs["shm_native"]["shm"]["bytes"]

    # -- flood x kill shard ladder: the head-of-line row. Same storm
    # (tenant flood + mid-run kill/revive, qos_leg's schedule shape)
    # at 1 shard vs 4; the collateral wedge shows in the tenant-A
    # latency SPREAD (p50/p95), not the single parked op's own p99.
    from ceph_tpu_torch.utils import config as _cfg

    for n in (1, 4):
        with _cfg.override(osd_op_num_shards=n):
            rep = qos_leg(
                total_ops, qd, max_objects=64, flood=True,
                faults=True, seed=0xEC20, device=device,
            )
        a = rep.get("tenants", {}).get("tenantA", {})
        for pct in ("p50", "p95", "p99"):
            v = a.get(f"lat_{pct}_ms")
            if v is not None:
                result[f"transport_shards{n}_{pct}_ms"] = v
    p1 = result.get("transport_shards1_p95_ms")
    pn = result.get("transport_shards4_p95_ms")
    if p1 and pn:
        # < 1.0 means the shard pool cut the storm's latency spread
        result["shard_hol_p95_frac"] = round(pn / p1, 4)

    # -- the deterministic wedge probe (parked shard, timed sibling)
    h1 = hol_probe_ms(1, device=device)
    h4 = hol_probe_ms(4, device=device)
    if h1 > 0:
        result["shard_hol_probe_shards1_ms"] = h1
    if h4 > 0:
        result["shard_hol_probe_shards4_ms"] = h4
    if h1 > 0 and h4 > 0:
        result["shard_hol_probe_frac"] = round(h4 / h1, 4)
