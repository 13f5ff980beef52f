"""One run of one cell: set-up, the measured window, the check.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: its
``config`` names an entry of ``configs`` (whose ``file`` holds the
cluster), its ``traffic`` names ``ecbench/mixes/<traffic>.json``, and
its metrics are the manifest's entries that apply to it, each computed
by the reader file of its name (``ecbench/e2e/`` for end-to-end,
``ecbench/metrics/`` for per-layer). Adding a configuration, a mix or a
metric therefore adds files and entries and edits none.

The system under test is the port's mini-cluster
(``ceph_tpu_torch.loadgen.cluster.LoadCluster``: a monitor and one OSD
daemon per shard over MemStores, TCP on loopback) and its client
(``IoCtx``), driven only through their public calls.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch

from .loop import ClosedLoop, write_image
from .reading import Reading
from .reference import check as reference_check
from .reference.gf import generator
from .traffic import Traffic, object_name

ROOT = Path(__file__).resolve().parent.parent
#: the most objects whose shards the check reads back from the stores
CHECK_OBJECTS = 64
#: how long ops outstanding at the window's close may take to come back
DRAIN_S = 60.0
#: the client's resend ladder: the objecter's own defaults (``Objecter``:
#: 30 s an attempt, 8 attempts, 0.05 s backoff), not ``LoadCluster``'s
#: 3 s fault-drill timeout, which would resend 4 MiB writes that are
#: only slow. Part of the guarantee, so no configuration changes it.
CLIENT_OP_TIMEOUT_S = 30.0
CLIENT_MAX_ATTEMPTS = 8
CLIENT_BACKOFF_S = 0.05


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload entry resolved to its configuration and mix files, and
    the metrics that apply to it."""

    def __init__(self, root: Path, bench: dict, name: str) -> None:
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in bench["configs"]
                    if c["name"] == entry["config"])
        self.root = root
        self.name = name
        self.chips = int(entry["chips"])
        self.config = load_json(root / conf["file"])
        self.mix = load_json(root / "ecbench" / "mixes"
                             / f"{entry['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)
        ]

    def reader(self, folder: str, metric: str):
        path = self.root / "ecbench" / folder / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"ecbench.{folder}.{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc; 10 ms ticks)."""
    import os

    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def process_cpu_s() -> tuple[float, float]:
    """This process's user and system CPU seconds so far."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime, ru.ru_stime


def host_pace_s(steps: int = 1_000_000) -> float:
    """Seconds a fixed pure-Python loop takes: the host's pace for one
    core, read once the program has stopped. The window's rates are
    bound to the host's pace (PERF.md §2), so a slow run shows here."""
    t = time.perf_counter()
    x = 0
    for i in range(steps):
        x += i ^ 5
    return time.perf_counter() - t


def _numeric_delta(before: dict, after: dict) -> dict:
    out = {}
    for name, vals in after.items():
        prev = before.get(name, {})
        row = {key: v - prev.get(key, 0) for key, v in vals.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)}
        if row:
            out[name] = row
    return out


def _pgs_scrubbed(cluster, pgids) -> bool:
    osdmap = cluster.mon.osdmap
    for pgid in pgids:
        primary = osdmap.pg_primary(cluster.pool, pgid)
        d = cluster.daemons.get(primary)
        if d is None or (cluster.pool, pgid) not in d.scrub_history:
            return False
    return True


def settle(cluster, timeout: float = 60.0) -> None:
    """Bring every PG's primary to its first (background) scrub before
    anything is timed. A daemon deep-scrubs a PG it leads one tick after
    it first serves it; a ``stat`` of a name in each PG makes every
    primary serve every PG now, so those scrubs run in the set-up
    rather than inside the window."""
    osdmap = cluster.mon.osdmap
    pg_num = osdmap.pools[cluster.pool].pg_num
    probes: dict[int, str] = {}
    i = 0
    while len(probes) < pg_num:
        name = f"ecbench_probe.{i}"
        probes.setdefault(osdmap.object_to_pg(cluster.pool, name), name)
        i += 1
    objecter = cluster.client.objecter
    comps = [objecter.aio_submit(cluster.pool, name, "stat")
             for name in probes.values()]
    for c in comps:
        try:
            c.wait_for_complete(timeout)
        except FileNotFoundError:
            pass
    end = time.monotonic() + timeout
    while not _pgs_scrubbed(cluster, probes):
        if time.monotonic() > end:
            raise RuntimeError("PGs did not finish their first scrub")
        time.sleep(0.05)


def _shard_keys(store, pool_id: int) -> dict[str, list[tuple[int, str]]]:
    """object name -> [(shard, store key)] of a store's shard objects
    (the port's keys are ``<pool>:<name>#s<shard>``)."""
    out: dict[str, list[tuple[int, str]]] = {}
    prefix = f"{pool_id}:"
    for key in store.list_objects():
        if not key.startswith(prefix) or "#s" not in key:
            continue
        loc, _, s = key.rpartition("#s")
        out.setdefault(loc[len(prefix):], []).append((int(s), key))
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", fault: str | None = None,
             age_at_start: float = 0.0, t_start: float | None = None,
             log=None) -> dict:
    """Run the cell once; return the result line's fields plus
    ``limits`` and ``setup_parts``. The caller has checked for a card."""
    import contextlib

    log = log or (lambda msg: None)
    t_start = time.perf_counter() if t_start is None else t_start
    mark = [time.perf_counter()]
    #: interpreter start and imports, then each stage of the set-up
    parts: dict[str, float] = {"start": age_at_start + mark[0] - t_start}

    def part(name: str) -> None:
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    cfg, mix = cell.config, cell.mix
    k, m, unit = int(cfg["k"]), int(cfg["m"]), int(cfg["stripe_unit"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    part("cuda_init")

    from ceph_tpu_torch.loadgen.cluster import LoadCluster
    from ceph_tpu_torch.utils import perf_collection
    from ceph_tpu_torch.utils.log import root_log

    if on_card:
        from ceph_tpu_torch import kernels

        kernels.build_all()
    part("library_load")

    traffic = Traffic(mix, seed)
    traffic.make_data(dev)
    if on_card:
        # the peak is the program's: the payloads left the card
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    part("payloads")

    stack = contextlib.ExitStack()
    if fault is not None:
        from .faults import plant

        stack.enter_context(plant(fault, k))
    with stack:
        cluster = LoadCluster(
            n_osds=int(cfg["osds"]), k=k, m=m, pg_num=int(cfg["pg_num"]),
            chunk_size=unit, plugin=cfg["plugin"],
            technique=cfg["technique"], device=dev,
            client_op_timeout=CLIENT_OP_TIMEOUT_S,
            client_backoff=CLIENT_BACKOFF_S,
            client_max_attempts=CLIENT_MAX_ATTEMPTS,
        )
        try:
            result = _run_on(cell, cluster, traffic, seed, seconds, trace,
                             dev, part, parts, log, age_at_start, t_start,
                             perf_collection)
        finally:
            cluster.shutdown()
            root_log.flush()
    root_log.stop()
    log(f"host pace: a fixed Python loop took {host_pace_s():.4f} s")
    # the program's state is gone; the reference runs in its place
    del cluster
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = reference_check.check(
        result.pop("records"), traffic.payload, traffic.image,
        traffic.objects, result.pop("stored"), result.pop("check_objs"),
        generator(cfg["plugin"], cfg["technique"], k, m), unit, dev)
    result["check_s"] = time.perf_counter() - t
    result["limits"] = {name: {"value": numbers[name], "limit": lim}
                        for name, lim in reference_check.LIMITS.items()}
    result["correct"] = all(numbers[n] <= lim
                            for n, lim in reference_check.LIMITS.items())
    return result


def _run_on(cell, cluster, traffic, seed, seconds, trace, dev, part, parts,
            log, age_at_start, t_start, perf_collection) -> dict:
    cfg, mix = cell.config, cell.mix
    pool_id = cluster.mon.osdmap.pools[cluster.pool].pool_id
    settle(cluster)
    part("boot")

    if traffic.prefill:
        errors = write_image(cluster.io, traffic)
        if errors:
            raise RuntimeError(f"prefill failed: {errors[:3]}")
    part("prefill")

    lost: dict[int, list[int]] = {}
    kill = [int(o) for o in mix.get("kill_osds", [])]
    if kill:
        names = {object_name(i): i for i in range(traffic.objects)}
        for osd in kill:
            for name, shards in _shard_keys(cluster.stores[osd],
                                            pool_id).items():
                if name in names:
                    lost.setdefault(names[name], []).extend(
                        s for s, _key in shards)
            cluster.kill(osd)
        settle(cluster)
    part("kill_repeer")

    loop = ClosedLoop(cluster.io, traffic)
    loop.run_ops(int(mix.get("warmup_ops", 0)))
    part("warmup")

    before = perf_collection.dump()
    tracer = None
    if trace and dev.type == "cuda":
        from .trace import DeviceTrace

        tracer = DeviceTrace()
        tracer.start()
    cpu0 = process_cpu_s()
    t0 = time.perf_counter()
    setup_s = age_at_start + (t0 - t_start)
    end = t0 + seconds
    loop.run(lambda: time.perf_counter() >= end)
    while time.perf_counter() < end:
        time.sleep(min(end - time.perf_counter(), 0.01))
    t1 = time.perf_counter()
    cpu1 = process_cpu_s()
    after = perf_collection.dump()
    if tracer is not None:
        tracer.stop()
    drained = loop.drain(DRAIN_S)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    slices = [0] * max(int((t1 - t0) // 5), 1)
    for r in loop.records:
        if r.error is None and r.t_done and t0 <= r.t_done < t1:
            slices[min(int((r.t_done - t0) // 5), len(slices) - 1)] += 1
    log(f"window {t1 - t0:.3f} s, drained={drained}, "
        f"ops {len(loop.records)}, completed a 5 s slice {slices}")
    log(f"process CPU over the window: user {cpu1[0] - cpu0[0]:.2f} s, "
        f"system {cpu1[1] - cpu0[1]:.2f} s")

    records = loop.records
    active = [r for r in records
              if r.t_issue < t1 and (r.t_done >= t0 or not r.t_done)]
    done = [r for r in records
            if r.error is None and r.t_done and t0 <= r.t_done <= t1]

    # what the check reads from the program, taken before it is freed
    if traffic.prefill:
        written = sorted(range(traffic.objects))
    else:
        written = sorted({r.op.obj for r in records if r.op.writes})
    rng = np.random.default_rng([seed, 11])
    objs = written if len(written) <= CHECK_OBJECTS else sorted(
        int(i) for i in rng.choice(written, CHECK_OBJECTS, replace=False))
    want = {object_name(i): i for i in objs}
    stored: dict[int, dict[int, list]] = {}
    for osd, store in cluster.stores.items():
        for name, shards in _shard_keys(store, pool_id).items():
            if name not in want:
                continue
            for s, key in shards:
                stored.setdefault(want[name], {}).setdefault(s, []).append(
                    (store.read(key), store.getattrs(key).get("hinfo_key")))
    client = perf_collection.dump().get("loadgen_client", {})

    reading = Reading(
        config=cfg, mix=mix, window_s=t1 - t0, ops=done, setup_s=setup_s,
        counters=_numeric_delta(before, after), trace=tracer, lost=lost,
        device_kind=(torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else "cpu"))
    metrics = {}
    spec = cell.per_layer if trace else cell.end_to_end
    for entry in spec:
        folder = "metrics" if trace else "e2e"
        value = cell.reader(folder, entry["name"])(reading)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    out = {
        "attempted": len(active),
        "failed": sum(1 for r in active if r.error is not None
                      or not r.t_done),
        "metrics": metrics,
        "memory_peak_bytes": int(peak),
        "setup_parts": parts,
        "resends": client.get("op_resend", 0),
        "records": records,
        "stored": stored,
        "check_objs": objs,
        "window_ops": len(done),
    }
    if tracer is not None:
        out["busy_s"] = tracer.busy_s
        out["window_s"] = tracer.window_s
        out["breakdown"] = tracer.breakdown()
    return out
