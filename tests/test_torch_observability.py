"""The port's observability plane (``utils/exporter.py``,
``utils/trace_assembly.py``, ``loadgen/forensics.py``) against ceph_tpu's,
on the CPU.

The exposition text is a scrape contract: the same counters render the
same bytes in both packages (metric names keep the ``ceph_tpu_`` prefix).
Trace assembly, critical paths, Chrome trace JSON and the text report
are compared on the same spans. The mirrors run the reference's
``tests/test_exporter.py``, the exporter legs of
``tests/test_stats_plane.py`` and the offline classes of
``tests/test_trace_tool.py`` (``TestAssembly``, ``TestCriticalPath``,
``TestChromeTrace``, ``TestCaptureTraces``, ``TestForensicsBundle``) on
the port, with ``device="cpu"`` wherever a cluster boots; and the live
legs of ``tests/test_stats_plane.py`` (``TestLiveStatsPlane``: a kill seen
as degraded counts and a revive back to clean, the stats-derived recovery
time against the direct poll, reporting off at interval 0, the forensics
bundle's stats), each under a time limit.
"""

import importlib
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOTS = ("ceph_tpu", "ceph_tpu_torch")


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def parse_exposition(text: str) -> dict[str, float]:
    out = {}
    for line in text.strip().splitlines():
        if line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        out[name] = float(value)
    return out


def _collection(root, seed=0):
    """A private collection with every counter type, filled from one
    numpy seed; set names with and without a ``.pool.`` segment."""
    pc_mod = _mod(root, "utils.perf_counters")
    rng = np.random.default_rng(seed)
    coll = pc_mod.PerfCountersCollection()
    for name in ("osd.0.pool.1.rmw", "objecter.pool.my\"pool",
                 "osd.12.peering", "9lives"):
        pc = (
            pc_mod.PerfCountersBuilder(coll, name)
            .add_u64_counter("write_ops")
            .add_u64_gauge("queue_depth")
            .add_time("busy")
            .add_avg("commit_lat")
            .add_histogram("op_size", [100.0, 1000.0, 1e4])
            .create_perf_counters()
        )
        pc.inc("write_ops", int(rng.integers(0, 100)))
        pc.set("queue_depth", int(rng.integers(0, 9)))
        pc.tinc("busy", float(rng.integers(1, 1000)) / 8)
        for _ in range(int(rng.integers(1, 5))):
            pc.ainc("commit_lat", float(rng.integers(1, 100)) / 64)
        for v in rng.integers(1, 20000, 7):
            pc.hinc("op_size", int(v))
    return coll


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_render_exposition_is_byte_equal(seed):
    texts = [_mod(root, "utils.exporter").render_exposition(
        _collection(root, seed)) for root in ROOTS]
    assert texts[1] == texts[0]
    assert "ceph_tpu_write_ops" in texts[1]
    assert 'pool="my\\"pool"' in texts[1]


def test_twin_empty_collection_renders_a_newline():
    for root in ROOTS:
        pc_mod = _mod(root, "utils.perf_counters")
        assert _mod(root, "utils.exporter").render_exposition(
            pc_mod.PerfCountersCollection()) == "\n"


@pytest.fixture
def collection():
    from ceph_tpu_torch.utils.perf_counters import (
        PerfCountersBuilder,
        PerfCountersCollection,
    )

    coll = PerfCountersCollection()
    pc = (
        PerfCountersBuilder(coll, "osd.0.pool.1.rmw")
        .add_u64_counter("write_ops")
        .add_u64_gauge("queue_depth")
        .add_time("busy")
        .add_avg("commit_lat")
        .add_histogram("op_size", [100.0, 1000.0])
        .create_perf_counters()
    )
    pc.inc("write_ops", 7)
    pc.set("queue_depth", 3)
    pc.tinc("busy", 1.5)
    pc.ainc("commit_lat", 0.25)
    pc.ainc("commit_lat", 0.75)
    pc.hinc("op_size", 50)
    pc.hinc("op_size", 500)
    pc.hinc("op_size", 5000)
    return coll


def test_all_types(collection):
    from ceph_tpu_torch.utils.exporter import render_exposition

    text = render_exposition(collection)
    samples = parse_exposition(text)
    label = 'set="osd.0.pool.1.rmw"'
    assert samples[f"ceph_tpu_write_ops{{{label}}}"] == 7
    assert samples[f"ceph_tpu_queue_depth{{{label}}}"] == 3
    assert samples[f"ceph_tpu_busy_seconds{{{label}}}"] == 1.5
    assert samples[f"ceph_tpu_commit_lat_sum{{{label}}}"] == 1.0
    assert samples[f"ceph_tpu_commit_lat_count{{{label}}}"] == 2
    assert samples[f'ceph_tpu_op_size_bucket{{{label},le="100.0"}}'] == 1
    assert samples[f'ceph_tpu_op_size_bucket{{{label},le="1000.0"}}'] == 2
    assert samples[f'ceph_tpu_op_size_bucket{{{label},le="+Inf"}}'] == 3
    assert samples[f"ceph_tpu_op_size_count{{{label}}}"] == 3
    assert "# TYPE ceph_tpu_write_ops counter" in text
    assert "# TYPE ceph_tpu_queue_depth gauge" in text


def test_scrape_and_404(collection):
    from ceph_tpu_torch.utils.exporter import Exporter

    exp = Exporter(collection)
    host, port = exp.start()
    try:
        with urllib.request.urlopen(
            f"http://{host}:{port}/metrics", timeout=5
        ) as resp:
            assert resp.status == 200
            assert "text/plain" in resp.headers["Content-Type"]
            body = resp.read().decode()
        assert "ceph_tpu_write_ops" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://{host}:{port}/nope", timeout=5)
    finally:
        exp.stop()


def test_live_cluster_metrics_scrapable():
    """A port cluster on the CPU: per-PG rmw sets and peering sets
    appear on the exporter of the process-global collection."""
    from ceph_tpu_torch.cluster import Monitor, OSDDaemon, RadosClient
    from ceph_tpu_torch.utils.exporter import Exporter

    mon = Monitor(device="cpu")
    daemons = []
    for i in range(4):
        mon.osd_crush_add(i, zone=f"z{i % 2}")
    client = None
    exp = Exporter()
    try:
        for i in range(4):
            d = OSDDaemon(i, mon, chunk_size=1024, device="cpu")
            d.start()
            daemons.append(d)
        mon.osd_erasure_code_profile_set(
            "rs21", {"plugin": "isa", "k": "2", "m": "1"})
        mon.osd_pool_create("mp", 4, "rs21")
        client = RadosClient(mon, backoff=0.01)
        host, port = exp.start()
        io = client.open_ioctx("mp")
        rng = np.random.default_rng(5)
        for i in range(3):
            io.write(f"m{i}", rng.integers(0, 256, 2048, np.uint8).tobytes())
        with urllib.request.urlopen(
            f"http://{host}:{port}/metrics", timeout=5
        ) as resp:
            samples = parse_exposition(resp.read().decode())
        rmw = {k: v for k, v in samples.items()
               if k.startswith("ceph_tpu_write_ops") and ".rmw" in k}
        assert rmw and sum(rmw.values()) >= 3
        elections = {k: v for k, v in samples.items()
                     if k.startswith("ceph_tpu_elections_run")
                     and ".peering" in k}
        assert elections and sum(elections.values()) >= 1
    finally:
        exp.stop()
        if client is not None:
            client.shutdown()
        for d in daemons:
            d.stop()


def test_twin_peering_and_optracker_sets_render_equal():
    """The peering set and a daemon's optracker set, filled the same
    way in each package's global collection, render the same lines."""
    texts = []
    for root in ROOTS:
        pc_glob = _mod(root, "utils.perf_counters").perf_collection
        ex = _mod(root, "utils.exporter")
        pc = _mod(root, "cluster.peering").make_peering_perf("osd.77.peering")
        pc.inc("elections_run", 3)
        pc.inc("rewinds")
        pc.inc("interval_fences_rejected", 2)
        pc.hinc("state_dwell_ms", 1.7)
        pc.ainc("peering_ms", 12.5)
        tr = _mod(root, "utils.optracker").OpTracker()
        opc = tr._perf_for("osd.88")
        opc.inc("ops_tracked", 5)
        opc.set("slow_ops", 2)
        opc.inc("slow_ops_total", 3)
        opc.hinc("slow_op_age_s", 31.5)
        try:
            text = ex.render_exposition(pc_glob)
        finally:
            pc_glob.deregister("osd.77.peering")
            pc_glob.deregister("osd.88.optracker")
        texts.append([ln for ln in text.splitlines()
                      if "osd.77.peering" in ln or "osd.88.optracker" in ln])
    assert texts[1] == texts[0]
    samples = parse_exposition("\n".join(texts[1]))
    assert samples['ceph_tpu_elections_run{set="osd.77.peering"}'] == 3
    assert samples['ceph_tpu_slow_ops{set="osd.88.optracker"}'] == 2


def test_cluster_log_and_slow_op_reach_the_exporter():
    import time

    from ceph_tpu_torch.utils import config
    from ceph_tpu_torch.utils.cluster_log import cluster_log
    from ceph_tpu_torch.utils.exporter import render_exposition
    from ceph_tpu_torch.utils.optracker import op_tracker
    from ceph_tpu_torch.utils.perf_counters import perf_collection

    before = perf_collection.dump().get("cluster_log")
    cluster_log.log("exp", "probe", "warn me", severity="WRN")
    samples = parse_exposition(render_exposition())
    assert samples['ceph_tpu_events{set="cluster_log"}'] >= 1
    assert samples['ceph_tpu_events_warn{set="cluster_log"}'] == \
        (before or {}).get("events_warn", 0) + 1
    with config.override(osd_op_complaint_time=0.05):
        top = op_tracker.register("x", daemon="osd.89")
        try:
            deadline = time.monotonic() + 5.0
            while not top.slow and time.monotonic() < deadline:
                op_tracker.poke()
                time.sleep(0.02)
            assert top.slow
            samples = parse_exposition(render_exposition())
            assert samples['ceph_tpu_slow_ops{set="osd.89.optracker"}'] >= 1
        finally:
            top.finish()


def _pgmap_lines(root):
    """tests/test_stats_plane.py's exporter leg: a monitor with one pool
    and one PG report; the pgmap set's exposition lines."""
    cl = _mod(root, "cluster")
    pgm = _mod(root, "cluster.pgmap")
    ex = _mod(root, "utils.exporter")
    pc_glob = _mod(root, "utils.perf_counters").perf_collection
    mon = cl.Monitor(**({"device": "cpu"} if root == ROOTS[1] else {}))
    for i in range(6):
        mon.osd_crush_add(i, zone=f"z{i % 3}")
        mon.osd_boot(i, ("127.0.0.1", 7000 + i))
    mon.osd_erasure_code_profile_set(
        "p", {"plugin": "jerasure", "technique": "reed_sol_van",
              "k": "2", "m": "1"})
    mon.osd_pool_create("p1", 8, "p")
    spec = mon.osdmap.pools["p1"]
    mon.pg_stats_report(0, mon.osdmap.epoch, [pgm.PGStats(
        pool="p1", pool_id=spec.pool_id, pgid=0,
        state=("active", "clean"), reported_epoch=mon.osdmap.epoch,
        reported_seq=1, primary=0, num_objects=3, num_bytes=300)])
    text = ex.render_exposition(pc_glob)
    # the pgmap set is process-global: pools of clusters an earlier test
    # booted keep their per-pool gauges, so only this pool's lines and
    # the cluster-wide ones are this monitor's
    return [ln for ln in text.splitlines()
            if 'set="pgmap"' in ln and "rate" not in ln
            and ("pool=" not in ln or 'pool="p1"' in ln)]


def test_twin_pgmap_sets_render_equal():
    lines = [_pgmap_lines(root) for root in ROOTS]
    assert lines[1] == lines[0]
    assert 'ceph_tpu_pool_objects{pool="p1",set="pgmap"} 3' in lines[1]
    assert any(ln.startswith('ceph_tpu_pgs{set="pgmap"}') for ln in lines[1])


def test_objecter_per_pool_accounting():
    """The pool-labelled objecter set through the port's LoadCluster."""
    from ceph_tpu_torch.loadgen import LoadCluster
    from ceph_tpu_torch.utils.exporter import render_exposition
    from ceph_tpu_torch.utils.perf_counters import perf_collection

    cluster = LoadCluster(n_osds=4, k=2, m=1, pg_num=4, chunk_size=1024,
                          device="cpu")
    try:
        cluster.io.write_full("acct-obj", b"x" * 4096)
        assert cluster.io.read("acct-obj") == b"x" * 4096
    finally:
        cluster.shutdown()
    dump = perf_collection.dump()
    key = "loadgen_client.pool.loadpool"
    assert dump[key]["pool_op_w"] >= 1 and dump[key]["pool_op_r"] >= 1
    assert dump[key]["pool_bytes_w"] >= 4096
    assert dump[key]["pool_bytes_r"] >= 4096
    assert ('ceph_tpu_pool_op_w{pool="loadpool",set="loadgen_client"}'
            in render_exposition(perf_collection))


# -- trace assembly (tests/test_trace_tool.py, offline classes) --------

def span(sid, parent, name, start, dur, trace="T", **tags):
    return {
        "span_id": sid, "parent_id": parent, "name": name,
        "start": start, "start_mono": start, "duration": dur,
        "tags": tags, "trace_id": trace,
    }


def synthetic():
    return [
        span("c1", None, "client_op", 10.000, 0.001, op="write"),
        span("o1", "c1", "osd_op", 10.005, 0.050, osd=0),
        span("w1", "o1", "sub_write", 10.010, 0.004, osd=1, shard=1),
        span("w2", "o1", "sub_write", 10.012, 0.030, osd=2, shard=2),
    ]


def seeded_spans(seed):
    """A pile of span trees from one numpy seed: several traces, nested
    children on random lanes, orphans, a cross-process (wall-clock
    only) span, and untagged spans that inherit their parent's lane."""
    rng = np.random.default_rng(seed)
    spans = []
    for t in range(int(rng.integers(3, 7))):
        tid = f"T{t}"
        start = float(rng.integers(0, 10_000)) / 1e3
        nodes = [("r", None, start, float(rng.integers(5, 100)) / 1e3)]
        spans.append(span(f"{tid}r", None, "client_op", start,
                          nodes[0][3], trace=tid, op="write"))
        for j in range(int(rng.integers(1, 9))):
            parent = nodes[int(rng.integers(0, len(nodes)))]
            s0 = parent[2] + float(rng.integers(0, 50)) / 1e4
            dur = float(rng.integers(1, 80)) / 1e3
            tags = {} if rng.integers(0, 3) == 0 else \
                {"osd": int(rng.integers(0, 6))}
            name = ("osd_op", "sub_write", "ec_write", "sub_read")[
                int(rng.integers(0, 4))]
            sp = span(f"{tid}{j}", f"{tid}{parent[0]}", name, s0, dur,
                      trace=tid, **tags)
            if rng.integers(0, 6) == 0:
                sp["start_mono"] = None
            spans.append(sp)
            nodes.append((str(j), None, s0, dur))
        if rng.integers(0, 3) == 0:
            spans.append(span(f"{tid}x", "ghost", "sub_read", start + 0.001,
                              0.002, trace=tid, osd=3))
    return spans


LIVE = [{
    "seq": 7, "type": "rmw_write", "daemon": "osd.0",
    "description": {"oid": "o"}, "trace_id": "T",
    "started": 10.02, "age": 5.0, "slow": True,
    "events": [{"t": 0.0, "event": "queued"}],
}]


def _assembled(root, spans, live):
    ta = _mod(root, "utils.trace_assembly")
    trees = ta.assemble_traces(spans, live)
    return {
        "trees": trees,
        "paths": [ta.critical_path(t) for t in trees],
        "chrome": json.dumps(ta.chrome_trace(trees)),
        "report": ta.format_report(trees, top=4),
        "live": ta.live_ops_as_spans(live or []),
    }


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_twin_trace_assembly_equal(seed):
    """assemble_traces, critical_path, chrome_trace, format_report and
    live_ops_as_spans give the same output on the same spans."""
    spans = seeded_spans(seed) + synthetic()
    got = [_assembled(root, spans, LIVE) for root in ROOTS]
    assert got[1] == got[0]
    assert got[1]["trees"]


def test_tree_shape_and_completeness():
    from ceph_tpu_torch.utils.trace_assembly import assemble_traces

    trees = assemble_traces(synthetic())
    assert len(trees) == 1
    t = trees[0]
    assert t["complete"] and t["orphans"] == 0 and t["n_spans"] == 4
    root = t["roots"][0]
    assert root["name"] == "client_op"
    (osd,) = root["children"]
    assert [c["name"] for c in osd["children"]] == ["sub_write", "sub_write"]
    assert t["duration"] == pytest.approx(10.055 - 10.0)
    orphaned = assemble_traces(synthetic() + [
        span("x9", "ghost", "sub_read", 10.02, 0.001, osd=3)])[0]
    assert not orphaned["complete"] and orphaned["orphans"] == 1
    assert len(orphaned["roots"]) == 2
    other = [span("q1", None, "client_op", 20.0, 0.9, trace="U")]
    assert [t["trace_id"] for t in assemble_traces(synthetic() + other)] \
        == ["U", "T"]
    joined = assemble_traces(synthetic(), LIVE)[0]
    assert "live:rmw_write" in {r["name"] for r in joined["roots"]}
    assert joined["n_spans"] == 5


def test_critical_path_stages_and_lanes():
    from ceph_tpu_torch.utils.trace_assembly import (
        assemble_traces,
        critical_path,
    )

    cp = critical_path(assemble_traces(synthetic())[0])
    names = [s["name"] for s in cp["stages"]]
    assert names == ["client_op", "gap:client_op->osd_op", "osd_op",
                     "sub_write"]
    by = dict(zip(names, cp["stages"]))
    assert by["gap:client_op->osd_op"]["self_s"] == pytest.approx(0.004)
    assert by["gap:client_op->osd_op"]["lane"] == "wire/queue"
    assert by["sub_write"]["lane"] == "osd.2"
    assert by["osd_op"]["self_s"] == pytest.approx(0.020)
    assert cp["total_s"] == pytest.approx(0.055)
    assert sum(s["self_s"] for s in cp["stages"]) == \
        pytest.approx(cp["total_s"])
    inherited = critical_path(assemble_traces([
        span("a", None, "osd_op", 0.0, 1.0, osd=4),
        span("b", "a", "ec_write", 0.1, 0.8)])[0])
    assert inherited["stages"][-1]["lane"] == "osd.4"


def test_chrome_trace_and_report():
    from ceph_tpu_torch.utils.trace_assembly import (
        assemble_traces,
        chrome_trace,
        format_report,
    )

    trees = assemble_traces(synthetic())
    data = json.loads(json.dumps(chrome_trace(trees)))
    xs = [e for e in data["traceEvents"] if e["ph"] == "X"]
    lanes = {m["args"]["name"] for m in data["traceEvents"]
             if m["ph"] == "M"}
    assert len(xs) == 4
    assert {"client", "osd.0", "osd.1", "osd.2"} <= lanes
    w2 = next(e for e in xs if e["args"].get("shard") == 2)
    assert w2["ts"] == pytest.approx(10.012 * 1e6)
    assert w2["dur"] == pytest.approx(0.030 * 1e6)
    text = format_report(trees)
    assert "client_op" in text and "critical path" in text
    assert format_report([]) == "(no traces)"


def test_twin_capture_traces_from_process_state():
    """Each package's tracer records the same two nested spans; the
    captures agree once the ids and clocks each tracer stamps are set
    equal (they are process state, not the assembly's output)."""
    caps = []
    for root in ROOTS:
        ta = _mod(root, "utils.trace_assembly")
        tracer = _mod(root, "utils").tracer
        tracer.clear()
        with tracer.span("client_op", op="x"):
            with tracer.span("osd_op"):
                pass
        spans = tracer.dump_historic()
        ids = {s["span_id"]: f"s{i}" for i, s in enumerate(spans)}
        for i, s in enumerate(spans):
            s.update(span_id=ids[s["span_id"]],
                     parent_id=ids.get(s["parent_id"]), trace_id="t",
                     start=float(i), start_mono=float(i), duration=1.0)
        cap = ta.capture_traces(limit=2, spans=spans, live_ops=[])
        assert cap["captured"] >= 1 and "client_op" in cap["text"]
        assert json.loads(cap["chrome_json"])["traceEvents"]
        caps.append(cap)
    assert caps[1] == caps[0]


def test_capture_from_the_ports_process_state():
    from ceph_tpu_torch.utils import tracer
    from ceph_tpu_torch.utils.trace_assembly import capture_traces

    tracer.clear()
    with tracer.span("client_op", op="x"):
        with tracer.span("osd_op"):
            pass
    cap = capture_traces(limit=2)
    assert cap["captured"] >= 1
    assert json.loads(cap["chrome_json"])["traceEvents"]
    assert "client_op" in cap["text"]


# -- forensics (TestForensicsBundle) -----------------------------------

def test_write_bundle_files(tmp_path):
    from ceph_tpu_torch.loadgen.forensics import run_is_green, write_bundle
    from ceph_tpu_torch.utils.cluster_log import cluster_log
    from ceph_tpu_torch.utils.optracker import op_tracker

    cluster_log.log("test", "probe", "forensics probe")
    top = op_tracker.register("x", daemon="osd.99", oid="wedged")
    try:
        manifest = write_bundle(str(tmp_path), report={"verify_failures": 1},
                                reason="unit test")
    finally:
        top.finish()
    assert set(manifest["files"]) >= {
        "ops_in_flight.json", "traces.txt", "traces_chrome.json",
        "cluster_log.jsonl", "perf_dump.json", "report.json",
        "MANIFEST.json"}
    bundle = tmp_path / manifest["stamp"]
    ops = json.loads((bundle / "ops_in_flight.json").read_text())
    assert any(o["description"].get("oid") == "wedged" for o in ops["ops"])
    json.loads((bundle / "traces_chrome.json").read_text())
    lines = (bundle / "cluster_log.jsonl").read_text().splitlines()
    assert any(json.loads(line)["type"] == "probe" for line in lines)
    assert run_is_green({"verify_failures": 0}) == (True, "green")
    assert not run_is_green({"verify_failures": 2})[0]


@pytest.mark.parametrize("report,slow", [
    ({"verify_failures": 0}, 0.0),
    ({"verify_failures": 2}, 0.0),
    ({"verify_failures": 0, "fault": {"time_to_recovered_s": 90.0}}, 30.0),
    ({"verify_failures": 0, "fault": {"time_to_recovered_s": 9.0}}, 30.0),
    ({"verify_failures": 0, "errors": 3}, 0.0),
    ({"verify_failures": 0, "exactly_once": False}, 0.0),
    ({"verify_failures": 0, "lockdep": {"cycles": [["a", "b"]]}}, 0.0),
    ({"verify_failures": 0, "recovered": False, "fault": {}}, 0.0),
], ids=lambda v: json.dumps(v, sort_keys=True) if isinstance(v, dict)
    else str(v))
def test_twin_run_is_green(report, slow):
    got = [_mod(root, "loadgen.forensics").run_is_green(report, slow)
           for root in ROOTS]
    assert got[1] == got[0]


def test_bench_cli_forced_forensics(tmp_path):
    """--force-forensics writes a bundle on a green smoke run."""
    from ceph_tpu_torch import bench_cli

    rc = bench_cli.main([
        "loadgen", "--smoke", "--seed", "11", "--device", "cpu",
        "--forensics-dir", str(tmp_path), "--force-forensics",
        "--trace-capture", "3",
    ])
    assert rc == 0
    bundles = list(tmp_path.iterdir())
    assert len(bundles) == 1
    manifest = json.loads((bundles[0] / "MANIFEST.json").read_text())
    assert manifest["reason"].startswith("forced")
    assert "traces.txt" in manifest["files"]


# -- the live legs of tests/test_stats_plane.py (TestLiveStatsPlane) ------

class TestLiveStatsPlane:
    """The stats plane sees a primary kill as rising degraded counts and
    recovery, and converges back to clean when recovery completes."""

    def test_kill_degrades_revive_cleans(self):
        import time

        from test_torch_dcn import time_limit

        from ceph_tpu_torch.cluster import Manager
        from ceph_tpu_torch.cluster.pgmap import status_dict
        from ceph_tpu_torch.loadgen import LoadCluster

        with time_limit(150):
            cluster = LoadCluster(
                n_osds=5, k=2, m=1, pg_num=4, chunk_size=1024,
                device="cpu",
            )
            try:
                rng_data = bytes(range(256)) * 16
                for i in range(8):
                    cluster.io.write_full(f"sp-{i}", rng_data)
                for d in cluster.daemons.values():
                    d.report_pg_stats(force=True)
                pm = cluster.pgmap
                st = status_dict(cluster.mon)
                assert st["objects"] == 8
                assert st["pgs"]["histogram"].get("active+clean", 0) >= 1
                deadline = time.monotonic() + 15.0
                i = 0
                while time.monotonic() < deadline:
                    cluster.io.write_full(f"sp-{i % 8}", rng_data)
                    i += 1
                    io = pm.rates()
                    if io["client_write_bps"] > 0:
                        break
                    time.sleep(0.05)
                assert io["client_write_bps"] > 0
                victim = cluster.most_primary_osd()
                cluster.kill(victim)
                deadline = time.monotonic() + 15.0
                while time.monotonic() < deadline:
                    if pm.degraded_objects() > 0:
                        break
                    time.sleep(0.1)
                assert pm.degraded_objects() > 0, (
                    "stats plane never saw the kill"
                )
                hist = pm.state_histogram()
                assert any("degraded" in k for k in hist), hist
                checks = Manager(cluster.mon).health()["checks"]
                assert "PG_DEGRADED" in checks
                assert "object copies" in checks["PG_DEGRADED"]["detail"]
                cluster.revive(victim)
                min_epoch = cluster.mon.osdmap.epoch
                assert cluster.wait_recovered(timeout=60.0)
                assert cluster.wait_recovered_stats(
                    timeout=10.0, min_epoch=min_epoch
                ), "stats plane never converged after recovery"
                assert pm.degraded_objects() == 0
                hist = pm.state_histogram()
                assert set(hist) == {"active+clean"}, hist
            finally:
                cluster.shutdown()

    def test_time_to_recovered_agreement(self):
        """The stats-derived time_to_recovered_s trails the direct-state
        poll by at most one report interval."""
        from test_torch_dcn import time_limit

        from ceph_tpu_torch.loadgen import (
            FaultSchedule,
            LoadCluster,
            WorkloadSpec,
            run_spec,
        )

        with time_limit(150):
            cluster = LoadCluster(
                n_osds=5, k=2, m=1, pg_num=4, chunk_size=1024,
                device="cpu",
            )
            try:
                report = run_spec(cluster, WorkloadSpec(
                    mix={"seq_write": 2, "read": 1, "rmw_overwrite": 1},
                    object_size=4096, max_objects=8, queue_depth=4,
                    total_ops=60, seed=0x57A7,
                ), FaultSchedule.primary_kill(60, recovery_timeout=60.0))
            finally:
                cluster.shutdown()
        assert report["verify_failures"] == 0
        assert report["errors"] == 0
        assert report["recovered"]
        fault = report["fault"]
        assert "time_to_recovered_s" in fault, fault
        assert "time_to_recovered_legacy_s" in fault, fault
        lag = (
            fault["time_to_recovered_s"]
            - fault["time_to_recovered_legacy_s"]
        )
        assert -0.001 <= lag <= 1.0, fault
        assert report["pg_states"] == {"active+clean": 4}
        assert report["degraded_objects"] == 0
        assert "active+clean" in report["status_digest"]

    def test_interval_zero_disables_reporting(self):
        import time

        from test_torch_dcn import time_limit

        from ceph_tpu_torch.loadgen import LoadCluster
        from ceph_tpu_torch.utils import config

        with time_limit(60), config.override(osd_stats_report_interval=0.0):
            cluster = LoadCluster(
                n_osds=4, k=2, m=1, pg_num=4, chunk_size=1024,
                device="cpu",
            )
            try:
                cluster.io.write_full("quiet", b"q" * 2048)
                time.sleep(0.8)
                assert cluster.pgmap.version == 0
            finally:
                cluster.shutdown()

    def test_forensics_bundle_captures_stats(self, tmp_path):
        from test_torch_dcn import time_limit

        from ceph_tpu_torch.loadgen import LoadCluster, write_bundle

        with time_limit(60):
            cluster = LoadCluster(
                n_osds=4, k=2, m=1, pg_num=4, chunk_size=1024,
                device="cpu",
            )
            try:
                cluster.io.write_full("fb-obj", b"f" * 2048)
                manifest = write_bundle(
                    str(tmp_path), report={"verify_failures": 0},
                    reason="stats-plane unit", cluster=cluster,
                )
            finally:
                cluster.shutdown()
        assert "status.json" in manifest["files"]
        assert "pg_dump.json" in manifest["files"]
        bundle = tmp_path / manifest["stamp"]
        st = json.loads((bundle / "status.json").read_text())
        assert st["objects"] >= 1
        dump = json.loads((bundle / "pg_dump.json").read_text())
        assert dump["pg_stats"]


# -- the live legs of tests/test_trace_tool.py (TestLiveCluster) ------------
# test_loadgen_trace_capture_contract is not mirrored: it rests on how many
# ops the daemons coalesce in one run.

#: the benchmark's per-layer readers of the host accounting
HOST_METRICS = (
    "staging_bytes_per_byte", "staging_cpu_ms", "codec_host_ms",
    "messenger_cpu_ms", "op_queue_wait_ms", "subop_wait_ms",
    "store_cpu_ms", "drain_requeues_per_op",
)
#: timers a write and a degraded read run on the port's cluster
LIVE_TIMERS = ("msg_encode", "msg_send", "msg_decode", "ec_stage",
               "ec_encode", "ec_decode", "store_commit", "store_read")


def _collect(node, out):
    out.append(node)
    for c in node["children"]:
        _collect(c, out)
    return out


class TestLiveTrace:
    """A live ``LoadCluster`` on the CPU: one client write assembles
    into one span tree across the daemons, writes and reads move every
    counter of the host accounting, and a capture with
    ``profile_all_threads`` holds its timers' ranges from several
    threads."""

    @pytest.fixture(scope="class")
    def cluster(self):
        from test_torch_dcn import time_limit

        from ceph_tpu_torch.loadgen import LoadCluster

        with time_limit(60):
            cluster = LoadCluster(n_osds=5, k=2, m=1, pg_num=4,
                                  chunk_size=1024, device="cpu")
        try:
            yield cluster
        finally:
            cluster.shutdown()

    @staticmethod
    def _io(cluster, tag: str) -> list:
        """4 KiB and 64 KiB writes and reads, one read degraded by an
        injected shard error; returns each op's user bytes."""
        from ceph_tpu_torch.cluster.osd_daemon import make_loc, shard_key
        from ceph_tpu_torch.pipeline.inject import ec_inject

        rng = np.random.default_rng(17)
        sizes, written = [], {}
        for i, n in enumerate((4096, 65536, 4096, 65536)):
            oid = f"{tag}-{i}"
            written[oid] = rng.integers(0, 256, n, np.uint8).tobytes()
            assert cluster.io.write_full(oid, written[oid]) == n
            assert cluster.io.read(oid) == written[oid]
            sizes += [n, n]
        oid = f"{tag}-1"
        loc = make_loc(cluster.mon.osdmap.pools[cluster.pool].pool_id, oid)
        ec_inject.read_error(shard_key(loc, 0), 0, duration=1_000_000)
        try:
            assert cluster.io.read(oid) == written[oid]
        finally:
            ec_inject.clear_read_error(shard_key(loc, 0), 0)
        sizes.append(len(written[oid]))
        return sizes

    def test_multidaemon_trace_reassembles(self, cluster):
        from ceph_tpu_torch.utils import tracer
        from ceph_tpu_torch.utils.trace_assembly import (
            assemble_traces,
            chrome_trace,
            critical_path,
        )

        tracer.clear()
        data = np.random.default_rng(3).integers(
            0, 256, 4096, np.uint8).tobytes()
        cluster.io.write("trace-me", data)
        assert cluster.io.read("trace-me") == data
        trees = assemble_traces(tracer.dump_historic())
        mine = [t for t in trees for r in t["roots"]
                if r["name"] == "client_op"
                and r["tags"].get("oid") == "trace-me"
                and r["tags"].get("op") == "write"]
        assert mine, "client write trace missing"
        t = mine[0]
        assert t["complete"], t
        nodes = _collect(t["roots"][0], [])
        names = [n["name"] for n in nodes]
        assert "osd_op" in names
        subs = [n for n in nodes if n["name"] == "sub_write"]
        assert len(subs) >= 2, names
        assert len({n["tags"]["osd"] for n in subs}) >= 2, \
            "sub-writes on one daemon only"
        cp = critical_path(t)
        assert cp["total_s"] > 0
        assert cp["stages"][0]["name"] == "client_op"
        json.loads(json.dumps(chrome_trace([t])))

    def test_io_moves_every_counter_and_reader(self, cluster):
        import types

        from ecbench.harness import _numeric_delta
        from ecbench.reading import Reading

        from ceph_tpu_torch.utils import perf_collection
        from ceph_tpu_torch.utils.trace_assembly import span_totals

        before = perf_collection.dump()
        sizes = self._io(cluster, "acct")
        after = perf_collection.dump()
        delta = _numeric_delta(before, after)
        trace = delta["trace"]
        for name in LIVE_TIMERS:
            for stat in ("count", "wall_s", "self_s", "cpu_s"):
                assert trace[f"{name}.{stat}"] > 0, (name, stat)
        assert {r["name"] for r in span_totals(trace)} >= set(LIVE_TIMERS)
        assert delta["ec_staging"]["copy_bytes"] > 0
        assert delta["ec_staging"]["zero_bytes"] > 0
        # every write's payload is scattered once, every read's gathered
        assert delta["ec_staging"]["user_bytes"] == sum(sizes)

        def total(suffix, key):
            return sum(v.get(key, 0) for n, v in delta.items()
                       if n.startswith("osd.") and n.endswith(suffix))

        assert total(".op_queue", "op_queue.dequeued") >= len(sizes)
        assert total(".op_queue", "op_queue.wait_s") > 0
        assert total(".rmw", "committed") >= 4
        assert total(".rmw", "subop_wait_s") > 0
        assert any("drain.requeues" in v for n, v in delta.items()
                   if n.endswith(".net"))
        reading = Reading(
            config={"k": 2, "m": 1}, mix={}, window_s=1.0,
            ops=[types.SimpleNamespace(op=types.SimpleNamespace(length=n))
                 for n in sizes],
            setup_s=0.0, counters=delta, trace=None, lost={},
            device_kind="cpu")
        for metric in HOST_METRICS:
            reader = importlib.import_module(f"ecbench.metrics.{metric}")
            value = reader.read(reading)
            assert isinstance(value, float | int) and np.isfinite(value), \
                metric
            assert value >= 0, metric

    def test_profiler_sees_timers_on_several_threads(self, cluster):
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        with profile(
            activities=[ProfilerActivity.CPU],
            experimental_config=_ExperimentalConfig(
                profile_all_threads=True),
        ) as prof:
            self._io(cluster, "prof")
        threads: dict[str, set] = {}
        for e in prof.events():
            threads.setdefault(e.name, set()).add(e.thread)
        for name in ("msg_decode", "ec_stage", "store_commit"):
            assert len(threads.get(name, ())) > 1, (name, threads.get(name))
