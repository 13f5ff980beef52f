"""Soak/loadgen forensics bundle — the artifact a non-green run leaves
behind instead of a shrug.

When a loadgen run goes non-green (verify failures, accounting
mismatch, op errors, failed recovery) — or converges SLOWLY after a
kill (``time_to_recovered_s`` past a threshold: the ~1/7 minute-scale
outlier the chaos tier keeps brushing against) — the driver dumps one
directory of correlated state, captured BEFORE cluster teardown so
wedged ops are still live:

- ``ops_in_flight.json``   every live tracked op with its event
                           timeline (the wedged ones are the story)
- ``traces.txt``           top-N slowest assembled traces with
                           critical-path attribution
- ``traces_chrome.json``   the same traces as Chrome trace-event JSON
                           (open in Perfetto)
- ``cluster_log.jsonl``    the cluster-log tail (down-marks, slow-op
                           complaints, peering stalls, net-fault
                           arms, crash-point fires)
- ``perf_dump.json``       the full perf-counter collection
- ``lockdep.json``         the lock-dependency graph + findings
                           (cycles / rank violations / blocking-
                           under-lock, with backtraces) when the
                           run armed the lockdep detector
- ``report.json``          the run report that triggered the dump
- ``status.json``          the `ceph -s` snapshot from the stats
                           plane (when a cluster is passed in)
- ``pg_dump.json``         every PG's stats row (`ceph pg dump`)
- ``MANIFEST.json``        reason + file list

``tools/soak.sh`` arms this via ``bench_cli loadgen --forensics-dir``
on its background load loop; any harness can call
:func:`write_bundle` directly.
"""

from __future__ import annotations

import json
import os
import time


def run_is_green(
    report: dict, slow_convergence_s: float = 0.0
) -> tuple[bool, str]:
    """(green, reason): the non-green predicate the forensics trigger
    shares with the soak gate.  ``slow_convergence_s`` > 0 also trips
    on post-kill convergence slower than the threshold."""
    if report.get("verify_failures"):
        return False, (
            f"{report['verify_failures']} content-verify failures"
        )
    if not report.get("exactly_once", True):
        return False, (
            f"accounting mismatch: issued {report.get('ops_in')} != "
            f"accounted {report.get('ops_accounted')}"
        )
    if report.get("errors"):
        return False, f"{report['errors']} op errors"
    if "recovered" in report and not report["recovered"]:
        return False, "cluster not recovered at exit"
    ld = report.get("lockdep")
    if ld and any(ld.values()):
        # lockdep-armed run (soak.sh --lockdep): a cycle / rank
        # violation / unwaived blocking-under-lock finding is as red
        # as a verify failure — it is tomorrow's deadlock
        return False, (
            "lockdep findings: "
            + ", ".join(f"{k}={v}" for k, v in sorted(ld.items()) if v)
        )
    ttr = (report.get("fault") or {}).get("time_to_recovered_s")
    if (
        slow_convergence_s > 0
        and ttr is not None
        and ttr > slow_convergence_s
    ):
        return False, (
            f"slow convergence: time_to_recovered_s={ttr} > "
            f"{slow_convergence_s}"
        )
    return True, "green"


def write_bundle(
    out_dir: str,
    report: "dict | None" = None,
    reason: str = "",
    trace_capture: int = 8,
    cluster=None,
) -> dict:
    """Write the forensics bundle under ``out_dir/<stamp>/``; returns
    the manifest (with ``dir`` pointing at the bundle).  Never raises
    past best effort — forensics must not turn a red run redder.
    With ``cluster`` (a LoadCluster), the bundle also captures the
    stats plane: ``status.json`` (the `ceph -s` shape) and
    ``pg_dump.json`` (every PG's stats row) — the aggregate view a
    wedged run is triaged from."""
    from ceph_tpu_torch.utils.cluster_log import cluster_log
    from ceph_tpu_torch.utils.optracker import op_tracker
    from ceph_tpu_torch.utils.perf_counters import perf_collection
    from ceph_tpu_torch.utils.trace_assembly import capture_traces

    stamp = time.strftime("%Y%m%d-%H%M%S") + f"-{os.getpid()}"
    bundle_dir = os.path.join(out_dir, stamp)
    os.makedirs(bundle_dir, exist_ok=True)
    files: list[str] = []

    def dump(name: str, payload, jsonl: bool = False) -> None:
        path = os.path.join(bundle_dir, name)
        try:
            with open(path, "w", encoding="utf-8") as f:
                if jsonl:
                    for item in payload:
                        f.write(json.dumps(item, default=str) + "\n")
                elif isinstance(payload, str):
                    f.write(payload)
                else:
                    json.dump(payload, f, default=str, indent=1)
            files.append(name)
        except Exception:
            pass

    dump("ops_in_flight.json", op_tracker.dump_ops_in_flight())
    traces = capture_traces(limit=trace_capture)
    dump("traces.txt", traces["text"])
    dump("traces_chrome.json", traces["chrome_json"])
    dump("cluster_log.jsonl", cluster_log.last(2000), jsonl=True)
    dump("perf_dump.json", perf_collection.dump())
    from ceph_tpu_torch.utils import lockdep

    # the lockdep graph + findings (cycles/rank/blocking carry full
    # backtraces) — trivially small when the detector is disarmed
    dump("lockdep.json", lockdep.dump())
    if report is not None:
        dump("report.json", report)
    mon = getattr(cluster, "mon", None)
    if mon is not None and getattr(mon, "pgmap", None) is not None:
        try:
            from ceph_tpu_torch.cluster.pgmap import status_dict

            for d in cluster.daemons.values():
                if d.osd_id not in cluster.dead:
                    d.report_pg_stats(force=True)
            dump("status.json", status_dict(mon))
            dump("pg_dump.json", mon.pgmap.pg_dump())
        except Exception:
            pass
    manifest = {
        "reason": reason,
        "stamp": stamp,
        "dir": bundle_dir,
        "files": files,
        "live_ops": op_tracker.live_count(),
        "traces_captured": traces["captured"],
    }
    dump("MANIFEST.json", manifest)
    return manifest
