"""The port's load generator (``loadgen/``) against ceph_tpu's, on the
CPU.

The twin cases run the same inputs, from one numpy seed, through both
packages: ``Log2Histogram`` state, ``WorkloadSpec`` / ``PRESETS`` /
``parse_mix`` and the content model, the fault schedules (``net_flaky``
and the rest) and what they ask a cluster to do, the recorder's
accounting, and a ``LoadGenerator`` run at queue depth 1 with no faults:
the same op sequence, the same client reads and byte-equal OSD stores
(the reqid attr ``rq``, a client nonce, aside). The bench phases
(``measure_cluster``, ``measure_qos``, ``measure_transport``) run with
their legs replaced by the same fixed reports in both packages and give
the same result dicts; the reference counts JAX's (CPU) devices for the
chip-scaling legs, the port the devices of its device type (one on the
CPU), so only the one-chip legs are shared.

The mirrors run the reference's ``tests/test_loadgen.py`` (not its
``slow`` full-size run) on the port with ``device="cpu"``: the smoke
preset's kill/revive run over a socket cluster, the CLAY cluster smoke
and the CLI surface.
"""

import dataclasses
import importlib
import json
import time
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOTS = ("ceph_tpu", "ceph_tpu_torch")


def _lg(root, name=None):
    return importlib.import_module(
        f"{root}.loadgen" + (f".{name}" if name else ""))


def _dev(root):
    return {"device": "cpu"} if root == "ceph_tpu_torch" else {}


def _both(fn):
    return [fn(root) for root in ROOTS]


# -- histogram ----------------------------------------------------------

def _hist_state(h):
    return (h.n, list(h.counts), h.min, h.max, h.sum,
            [h.percentile(p) for p in (1, 50, 90, 95, 99, 99.9, 100)],
            h.snapshot(), h.perf_buckets())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_histogram_state(seed):
    """The same seeded samples (log-uniform over the range and past
    both ends), merged from two halves: equal state and percentiles."""
    rng = np.random.default_rng(seed)
    samples = 10.0 ** rng.uniform(-10, 7, 500)

    def run(root):
        mod = _lg(root)
        a, b = mod.Log2Histogram(), mod.Log2Histogram()
        for v in samples[:250]:
            a.record(float(v))
        for v in samples[250:]:
            b.record(float(v))
        a.merge(b)
        return _hist_state(a)

    got = _both(run)
    assert got[1] == got[0]
    assert got[1][0] == 500


def test_histogram_percentiles_and_extremes():
    from ceph_tpu_torch.loadgen import Log2Histogram

    h = Log2Histogram()
    for ms in range(1, 1001):
        h.record(ms / 1e3)
    assert h.n == 1000
    assert abs(h.percentile(50) - 0.5) / 0.5 < 0.1
    assert abs(h.percentile(99) - 0.99) / 0.99 < 0.1
    assert h.percentile(100) == h.max == 1.0 and h.min == 1e-3
    one = Log2Histogram()
    one.record(0.0423)
    assert all(one.percentile(p) == 0.0423 for p in (1, 50, 99, 100))
    bounds, counts = one.perf_buckets()
    assert len(counts) == len(bounds) + 1 and sum(counts) == 1


# -- spec and the content model -----------------------------------------

def test_twin_presets_and_specs():
    def run(root):
        mod = _lg(root)
        specs = {name: dataclasses.asdict(mod.preset(name))
                 for name in sorted(mod.PRESETS)}
        over = dataclasses.asdict(mod.preset("smoke", total_ops=33, seed=5))
        return mod.PRESETS, specs, over, mod.OP_CLASSES

    got = _both(run)
    assert got[1] == got[0]
    assert got[1][1]["mixed"]["total_ops"] == 600
    assert got[1][1]["mixed"]["object_size"] == 256 * 1024


@pytest.mark.parametrize("text", [
    "seq_write=2, read=5,rmw_overwrite", "read", "seq_write=1,shred=9",
    "", "read=0", "seq_write=0.5,reconstruct_read=3,rand_write=1",
    "read=x",
])
def test_twin_parse_mix(text):
    def run(root):
        try:
            return _lg(root).parse_mix(text)
        except Exception as e:
            return type(e).__name__, str(e)

    got = _both(run)
    assert got[1] == got[0]


@pytest.mark.parametrize("kw", [
    {"mix": {"nope": 1.0}}, {"total_ops": 10, "warmup_ops": 10},
    {"popularity": "hot"}, {"queue_depth": 0}, {"object_size": 0},
    {"mix": {"read": 0.0}},
], ids=lambda kw: ",".join(kw))
def test_twin_spec_validation(kw):
    def run(root):
        with pytest.raises(ValueError) as exc:
            _lg(root).WorkloadSpec(**kw)
        return str(exc.value)

    got = _both(run)
    assert got[1] == got[0]


def test_twin_tenants():
    def run(root):
        mod = _lg(root)
        spec = mod.WorkloadSpec(seed=0x77, tenants={
            "gold": {"mix": "read=3,seq_write=1", "queue_depth": 2,
                     "qos": {"res_ops": 8.0}},
            **mod.default_tenants(3)})
        per = mod.tenant_specs(spec)
        return {t: (dataclasses.asdict(s), q) for t, (s, q) in per.items()}

    got = _both(run)
    assert got[1] == got[0]
    assert sorted(got[1]) == ["gold", "t0", "t1", "t2"]


@pytest.mark.parametrize("seed", [0, 7, 0xEC])
def test_twin_content_model_and_popularity(seed):
    """object_bytes / patch_bytes / expected_image, and the uniform and
    zipfian pickers on one generator: equal in both packages."""
    def run(root):
        mod = _lg(root)
        out = []
        for idx in range(4):
            for version in (1, 2):
                out.append(mod.object_bytes(seed, idx, version, 4096))
                out.append(mod.patch_bytes(seed, idx, version, 3, 4096, 512))
                out.append(mod.expected_image(seed, idx, version, 3, 4096,
                                              512))
        for pop, theta in (("uniform", 0.9), ("zipfian", 1.2)):
            picker = mod.Popularity(mod.WorkloadSpec(
                popularity=pop, zipf_theta=theta, seed=seed))
            rng = np.random.default_rng(seed)
            out.append([picker.pick(rng, n) for n in (1, 7, 100)
                        for _ in range(50)])
        return out

    got = _both(run)
    assert got[1] == got[0]


def test_zipfian_skew():
    from ceph_tpu_torch.loadgen import Popularity, WorkloadSpec

    pop = Popularity(WorkloadSpec(popularity="zipfian", zipf_theta=1.2))
    rng = np.random.default_rng(3)
    _, counts = np.unique([pop.pick(rng, 100) for _ in range(4000)],
                          return_counts=True)
    assert np.sort(counts)[::-1][0] > 4000 * 0.10


# -- fault schedules ----------------------------------------------------

class FakeCluster:
    """Records what a schedule asks of a cluster; pickers answer from a
    fixed primary census."""

    def __init__(self):
        self.calls = []
        self.dead = []

    def live_osds(self):
        return [i for i in range(6) if i not in self.dead]

    def most_primary_osd(self):
        return 4

    def least_primary_osd(self):
        return 1

    def kill(self, osd):
        self.calls.append(("kill", osd))
        self.dead.append(osd)

    def revive(self, osd):
        self.calls.append(("revive", osd))
        self.dead.remove(osd)

    def net_flaky(self, **kw):
        self.calls.append(("net_flaky", sorted(kw.items())))

    def net_partition(self, osd, **kw):
        self.calls.append(("net_partition", osd, sorted(kw.items())))

    def net_heal(self):
        self.calls.append(("net_heal",))


def _schedules(mod):
    F, S = mod.FaultEvent, mod.FaultSchedule
    return {
        "kill_revive": S([F(30, "revive"), F(10, "kill")]),
        "named": S([F(5, "kill", osd="most_primary"),
                    F(6, "kill", osd="least_primary"),
                    F(9, "revive", osd=4), F(12, "revive")]),
        "primary_kill": S.primary_kill(90),
        "net_flaky": S.net_flaky(200, seed=0x1234, drop=0.05, dup=0.01,
                                 delay_ms=2.0),
        "net_partition": S.net_partition(120, victim="least_primary",
                                         seed=3),
    }


@pytest.mark.parametrize("name", ["kill_revive", "named", "primary_kill",
                                  "net_flaky", "net_partition"])
def test_twin_fault_schedules(name):
    """The same schedule in both packages: equal events, and equal calls
    on a cluster as the op counter crosses each offset."""
    def run(root):
        sched = _schedules(_lg(root))[name]
        cluster = FakeCluster()
        for done in range(0, 301, 7):
            sched.maybe_fire(done, cluster)
        events = [dataclasses.asdict(e) for e in sched.events]
        return events, sched.recovery_timeout, cluster.calls, sched.killed

    got = _both(run)
    assert got[1] == got[0]
    assert got[1][2], "the schedule fired nothing"


@pytest.mark.parametrize("args", [
    (5, "shred"), (5, "revive", "most_primary"), (5, "kill", "hottest"),
], ids=["action", "picker_on_revive", "picker"])
def test_twin_fault_event_validation(args):
    def run(root):
        with pytest.raises(ValueError) as exc:
            _lg(root).FaultEvent(*args)
        return str(exc.value)

    got = _both(run)
    assert got[1] == got[0]


# -- recorder -----------------------------------------------------------

def test_twin_recorder_accounting():
    """The same records: equal per-class counts, bytes and histogram
    rows (the time-based rates and duration aside)."""
    rng = np.random.default_rng(11)
    recs = [(("read", "seq_write", "rmw_overwrite")[int(rng.integers(0, 3))],
             float(rng.integers(1, 5000)) / 1e4, int(rng.integers(0, 9000)),
             bool(rng.integers(0, 8)), not bool(rng.integers(0, 20)))
            for _ in range(300)]
    timed = {"duration_s", "gbps", "iops"}

    def run(root):
        rec = _lg(root).RunRecorder(warmup_ops=13)
        for cls, lat, nbytes, ok, vf in recs:
            rec.record(cls, lat, nbytes, ok=ok or vf, verify_failed=vf)
        rec.device_floor_s = 0.002
        rec.finish()
        rep = rec.report()
        rep["classes"] = {c: {k: v for k, v in e.items() if k not in timed}
                          for c, e in rep["classes"].items()}
        return {k: v for k, v in rep.items() if k not in timed}

    got = _both(run)
    assert got[1] == got[0]
    assert got[1]["ops_accounted"] == 300


def test_recorder_warmup_and_device_floor():
    from ceph_tpu_torch.loadgen import RunRecorder

    r = RunRecorder(warmup_ops=3)
    for _ in range(10):
        r.record("read", 0.01, 100)
    r.record("read", 0.01, 100, ok=False)
    r.finish()
    rep = r.report()
    assert rep["classes"]["read"]["warmup_ops"] == 3
    assert rep["classes"]["read"]["ops"] == 7
    assert rep["classes"]["read"]["errors"] == 1
    assert rep["ops_accounted"] == 11 and rep["bytes"] == 700
    r = RunRecorder()
    for lat in (0.100, 0.101, 0.102, 0.110):
        for _ in range(25):
            r.record("read", lat, 100)
    r.device_floor_s = 0.002
    r.finish()
    rep = r.report()
    assert rep["lat_p99_ms"] >= 100.0
    assert rep["lat_p99_ms_device"] == pytest.approx(
        rep["lat_p99_ms"] - 100.0 + 2.0, abs=1.5)
    t0 = time.monotonic()
    r = RunRecorder()
    r.record("read", 0.0, 1000)
    time.sleep(0.02)
    r.record("read", 0.0, 5000)
    r.finish()
    assert r.window_gbps(t0 - 1, time.monotonic()) > 0


def test_device_clock_is_none_on_the_cpu():
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.loadgen import DeviceClock

    codec = registry.factory("isa", {"k": "4", "m": "2"}, device="cpu")
    assert DeviceClock.measure(codec, 4096) is None


# -- LoadGenerator twins at queue depth 1 -------------------------------

#: the reqid window attr carries each client's random nonce
TWIN_SKIP_ATTRS = ("rq",)


class LoggedIo:
    """An IoCtx proxy that logs every call the generator makes."""

    def __init__(self, io, log):
        self._io = io
        self._log = log

    def __getattr__(self, name):
        fn = getattr(self._io, name)

        def call(*args, **kw):
            out = fn(*args, **kw)
            digest = [a if not isinstance(a, bytes) else
                      ("bytes", len(a), hash(a)) for a in args]
            res = out if not isinstance(out, bytes) else \
                ("bytes", len(out), hash(out))
            self._log.append((name, digest, sorted(kw.items()), res))
            return out

        return call


def _stores(cluster):
    out = {}
    for i, d in cluster.daemons.items():
        st = d.store
        out[i] = {key: (st.read(key), {a: v for a, v in
                                       st.getattrs(key).items()
                                       if a not in TWIN_SKIP_ATTRS})
                  for key in st.list_objects()}
    return out


def _twin_run(root, spec_kw, cluster_kw):
    mod = _lg(root)
    cluster = mod.LoadCluster(**cluster_kw, **_dev(root))
    try:
        spec = mod.WorkloadSpec(queue_depth=1, async_submit=False,
                                **spec_kw)
        log = []
        gen = mod.LoadGenerator(cluster, spec,
                                io=LoggedIo(cluster.io, log))
        report = gen.run()
        return log, report, _stores(cluster)
    finally:
        cluster.shutdown()


@pytest.mark.parametrize("seed,plugin", [(5, "jerasure"), (9, "isa")])
def test_twin_load_generator_qd1_stores_equal(seed, plugin):
    """No faults, one op in flight: both packages issue the same op
    sequence with the same payloads, read the same bytes, verify every
    op, and leave every OSD's store equal in keys, bytes and attrs."""
    spec_kw = dict(mix={"seq_write": 3, "rand_write": 1, "read": 3,
                        "reconstruct_read": 1, "rmw_overwrite": 2},
                   object_size=6144, max_objects=8, total_ops=40,
                   warmup_ops=2, popularity="zipfian", seed=seed)
    cluster_kw = dict(n_osds=5, k=2, m=1, pg_num=4, chunk_size=1024,
                      plugin=plugin)
    ref, port = (_twin_run(root, spec_kw, cluster_kw) for root in ROOTS)
    assert port[0] == ref[0]
    assert len(port[0]) == 40
    for rep in (ref[1], port[1]):
        assert rep["verify_failures"] == 0 and rep["errors"] == 0
        assert rep["exactly_once"]
    counts = [{c: (e["ops"], e["warmup_ops"], e["bytes"])
               for c, e in rep["classes"].items()} for rep in (ref[1],
                                                                port[1])]
    assert counts[1] == counts[0]
    assert port[2] == ref[2]


# -- the smoke run on the port (tests/test_loadgen.py) ------------------

@pytest.fixture(scope="module")
def smoke_run():
    from ceph_tpu_torch.loadgen import (
        FaultEvent,
        FaultSchedule,
        LoadCluster,
        LoadGenerator,
        WorkloadSpec,
    )

    cluster = LoadCluster(n_osds=5, k=2, m=1, pg_num=4, chunk_size=1024,
                          device="cpu")
    try:
        spec = WorkloadSpec(
            mix={"seq_write": 3, "rand_write": 1, "read": 3,
                 "reconstruct_read": 1, "rmw_overwrite": 1},
            object_size=8192, max_objects=16, queue_depth=4,
            total_ops=80, warmup_ops=8, popularity="zipfian", seed=7,
        )
        victim = cluster.most_primary_osd()
        faults = FaultSchedule(
            [FaultEvent(26, "kill", osd=victim),
             FaultEvent(53, "revive", osd=victim)],
            recovery_timeout=60,
        )
        gen = LoadGenerator(cluster, spec, faults)
        report = gen.run()
        yield cluster, spec, gen, report
    finally:
        cluster.shutdown()


def test_smoke_verifies_and_accounts_exactly_once(smoke_run):
    _c, spec, _g, report = smoke_run
    assert report["verify_failures"] == 0
    assert report["errors"] <= 3, report.get("error_samples")
    assert report["ops_in"] == spec.total_ops
    assert report["ops_accounted"] == report["ops_in"]
    assert report["exactly_once"] is True
    assert sum(e["ops"] + e["warmup_ops"] + e["errors"]
               for e in report["classes"].values()) == report["ops_in"]


def test_smoke_fault_metrics_and_recovery(smoke_run):
    cluster, _s, _g, report = smoke_run
    assert report["fault"]["degraded_window_s"] > 0
    assert "time_to_recovered_s" in report["fault"]
    assert report["recovered"] is True
    assert cluster.is_recovered()
    assert cluster.scrub_clean()
    recon = report["classes"].get("reconstruct_read", {}).get("ops", 0)
    assert recon + report["reclassified_reads"] > 0


def test_smoke_rows_and_counters(smoke_run):
    from ceph_tpu_torch.utils.admin_socket import admin_socket
    from ceph_tpu_torch.utils.exporter import render_exposition

    _c, _s, _g, report = smoke_run
    assert report["bytes"] > 0 and report["gbps"] > 0
    assert report["iops"] > 0 and report["lat_p99_ms"] > 0
    dump = admin_socket.execute("perf dump")
    client = dump["loadgen_client"]
    assert client["op_completed"] >= report["ops_in"] - report["errors"]
    assert client["op_inflight"] == 0 and client["verify_failed"] == 0
    lg = dump["loadgen"]
    for cls, e in report["classes"].items():
        assert lg[f"ops_{cls}"] == e["ops"] + e["warmup_ops"]
    text = render_exposition()
    assert 'ceph_tpu_ops_seq_write{set="loadgen"}' in text
    assert "ceph_tpu_op_latency_sum" in text


def test_clay_cluster_reconstruct_and_recovery():
    """Mirror of TestClayClusterSmoke at its sizes: reconstruct reads
    over a CLAY(4,2,d=5) pool with one OSD down, then the returning
    shard rebuilt from d/(q*k) = 5/8 of a naive decode's bytes."""
    from ceph_tpu_torch.loadgen import LoadCluster, LoadGenerator, \
        WorkloadSpec
    from ceph_tpu_torch.utils.perf_counters import perf_collection

    def totals():
        dump = perf_collection.dump()
        return {key: sum(v.get(key, 0) for name, v in dump.items()
                         if ".recovery" in name)
                for key in ("recovery_ops", "recovery_read_bytes",
                            "recovered_bytes")}

    size, n_obj = 16384, 3
    rng = np.random.default_rng(21)
    cluster = LoadCluster(n_osds=7, k=4, m=2, pg_num=4, chunk_size=4096,
                          plugin="clay", d=5, device="cpu")
    try:
        data0 = bytes(rng.integers(0, 256, size, np.uint8))
        for i in range(n_obj):
            cluster.io.write_full(f"clayobj{i}", data0)
        victim = cluster.least_primary_osd()
        cluster.kill(victim)
        report = LoadGenerator(cluster, WorkloadSpec(
            mix={"seq_write": 1, "reconstruct_read": 3}, object_size=size,
            max_objects=4, queue_depth=2, total_ops=24, warmup_ops=4,
            seed=13)).run()
        assert report["verify_failures"] == 0
        assert report["classes"]["reconstruct_read"]["ops"] > 0
        data1 = bytes(rng.integers(0, 256, size, np.uint8))
        for i in range(n_obj):
            cluster.io.write_full(f"clayobj{i}", data1)
        before = totals()
        cluster.revive(victim)
        assert cluster.wait_recovered(60)
        rec = {k: v - before[k] for k, v in totals().items()}
        assert rec["recovery_ops"] > 0 and rec["recovered_bytes"] > 0
        frac = rec["recovery_read_bytes"] / (4 * rec["recovered_bytes"])
        assert frac == pytest.approx(5 / 8, rel=0.05), frac
        for i in range(n_obj):
            assert cluster.io.read(f"clayobj{i}", 0, size) == data1
        assert cluster.scrub_clean()
    finally:
        cluster.shutdown()


# -- bench phases: the same legs, the same result dicts -----------------

class FixedLegs:
    """Stands in for every leg: a fixed report drawn from the leg's
    arguments (the device and the mesh options aside), so the same leg
    gets the same report in both packages."""

    SKIP = ("device", "use_mesh", "mesh_devices")

    def leg(self, *args, **kw):
        key = repr((args, sorted((k, v) for k, v in kw.items()
                                 if k not in self.SKIP)))
        n = zlib.crc32(key.encode()) % 997 + 1
        return {
            "gbps": 0.5 + n / 8, "iops": 100.0 * n, "lat_p99_ms": 9.0 + n,
            "lat_p99_ms_device": 2.0 + n / 4, "verify_failures": 0,
            "errors": n % 2, "recovered": True,
            "fault": {"degraded_gbps": n / 16, "degraded_window_s": 1.5,
                      "time_to_recovered_s": 2.0 + n},
            "tenants": {"tenantA": {"lat_p50_ms": 1.0 + n,
                                    "lat_p95_ms": 3.0 + n,
                                    "lat_p99_ms": 5.0 + n}},
            "shm": {"chunks": 10 * n, "bytes": 4096 * n},
        }

    def hol(self, nshards, *args, **kw):
        return 750.0 if nshards == 1 else 4.25


def _phases(root, monkeypatch):
    bp = _lg(root, "bench_phase")
    legs = FixedLegs()
    for name in ("_leg", "qos_leg", "transport_leg"):
        monkeypatch.setattr(bp, name, legs.leg)
    monkeypatch.setattr(bp, "hol_probe_ms", legs.hol)
    out = {}
    bp.measure_cluster(out, 12.5, **_dev(root))
    bp.measure_qos(out, **_dev(root))
    bp.measure_transport(out, 12.5, **_dev(root))
    return out


def test_twin_bench_phase_results(monkeypatch):
    """measure_cluster / measure_qos / measure_transport with their legs
    fixed: the same result keys and values in both packages, the
    one-chip scaling leg included; the reference also has a leg for
    each of JAX's further (CPU) devices, which the port has not."""
    ref, port = (_phases(root, monkeypatch) for root in ROOTS)
    multi = [k for k in ref if k.startswith("cluster_scale_chips")
             and not k.startswith("cluster_scale_chips1_")]
    ref_shared = {k: v for k, v in ref.items() if k not in multi}
    assert sorted(port) == sorted(ref_shared)
    assert port == ref_shared
    assert "cluster_scale_chips1_gbps" in port
    assert not [k for k in port if k.startswith("cluster_scale_chips")
                and "chips1_" not in k]


def test_chip_legs_above_one_raise():
    """A leg over more than one chip needs the dispatch mesh: the port
    refuses it instead of running on one device."""
    from ceph_tpu_torch.loadgen import bench_phase

    with pytest.raises(NotImplementedError, match="multi-device"):
        bench_phase._leg(8, 2, 4, use_mesh=True, mesh_devices=2,
                         device="cpu")


# -- the CLI surface ----------------------------------------------------

def test_cli_smoke_two_column_contract(capsys):
    from ceph_tpu_torch import bench_cli

    rc = bench_cli.main(["loadgen", "--smoke", "--device", "cpu"])
    captured = capsys.readouterr()
    assert rc == 0
    elapsed, kib = captured.out.strip().split("\t")
    assert float(elapsed) > 0 and int(kib) > 0
    report = json.loads(captured.err.strip().splitlines()[-1])
    assert report["verify_failures"] == 0 and report["exactly_once"]


def test_twin_cli_flags_parse():
    argvs = [
        ["loadgen", "--mix", "seq_write=1,read=2", "--objects", "8",
         "--object-size", "4096", "--queue-depth", "2", "--ops", "20",
         "--popularity", "zipfian", "--fault-at", "5", "--revive-at",
         "10", "-P", "k=2", "-P", "m=1"],
        ["loadgen", "--smoke", "--net-fault", "flaky", "--net-drop",
         "0.05", "--net-dup", "0.01", "--net-delay-ms", "2"],
        ["loadgen", "--smoke", "--net-fault", "partition", "--lockdep"],
        ["loadgen", "--preset", "mixed", "--device-clock",
         "--trace-capture", "8", "--tenants", "2", "--qos-profile",
         "high_client", "--transport", "shm_ring", "--op-shards", "4"],
        ["encode", "-P", "k=8", "-P", "m=4"],
        ["decode", "--erasures", "2", "--erasures-generation",
         "exhaustive"],
        ["checksum", "--csum-alg", "crc32c", "--csum-block", "4096"],
    ]

    def run(root):
        bc = importlib.import_module(f"{root}.bench_cli")
        out = [vars(bc.parse_args(argv)) for argv in argvs]
        with pytest.raises(SystemExit):
            bc.parse_args(["loadgen", "--net-fault", "bogus"])
        return out

    ref, port = _both(run)
    for r, p in zip(ref, port):
        assert p.pop("device") == "cuda"
        assert p == r
