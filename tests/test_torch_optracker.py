"""The port's ops-in-flight tracker, slow-op watchdog, cluster log and
perf reset against ceph_tpu's, on the CPU.

Mirrors ``tests/test_optracker.py`` on ``ceph_tpu_torch.utils``: a
crash-point ``pause`` wedges a live RMW op (``device="cpu"``),
``dump_ops_in_flight`` shows it with its timeline, the watchdog posts a
slow-op complaint to the cluster log and bumps the ``slow_ops`` counters
on the perf dump and the exporter, and the release drains it; the
cluster log's ring, filters, sink and summary; perf-counter reset
through the collection and the admin socket. The twins run one script
of ops, events and log records through both packages' trackers and
cluster logs: the ``dump_ops_in_flight`` dumps (clock fields aside), the
cluster-log records and summaries, and the exposition text of the
trackers' counter sets and of a reset set are equal. The exporter's
slow-op leg is also in ``test_torch_observability.py``.
"""

import importlib
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from ceph_tpu_torch.codecs import registry  # noqa: E402
from ceph_tpu_torch.pipeline.rmw import RMWPipeline, ShardBackend  # noqa: E402
from ceph_tpu_torch.pipeline.stripe import PAGE_SIZE, StripeInfo  # noqa: E402
from ceph_tpu_torch.store import MemStore  # noqa: E402
from ceph_tpu_torch.utils import config  # noqa: E402
from ceph_tpu_torch.utils.admin_socket import admin_socket  # noqa: E402
from ceph_tpu_torch.utils.cluster_log import ClusterLog, cluster_log  # noqa: E402
from ceph_tpu_torch.utils.crash_points import crash_points  # noqa: E402
from ceph_tpu_torch.utils.exporter import render_exposition  # noqa: E402
from ceph_tpu_torch.utils.optracker import (  # noqa: E402
    NULL_OP,
    OpTracker,
    op_tracker,
)
from ceph_tpu_torch.utils.perf_counters import (  # noqa: E402
    PerfCountersBuilder,
    PerfCountersCollection,
    perf_collection,
)


@pytest.fixture(autouse=True)
def _clean_tracker():
    op_tracker.clear()
    yield
    op_tracker.clear()
    crash_points.clear()


def make_rmw(perf_name="opt_rmw"):
    k, m, chunk = 2, 1, PAGE_SIZE
    sinfo = StripeInfo(k, m, k * chunk)
    codec = registry.factory(
        "jerasure",
        {"technique": "reed_sol_van", "k": str(k), "m": str(m)},
        device="cpu",
    )
    backend = ShardBackend(
        {s: MemStore(f"osd.{s}") for s in range(k + m)}
    )
    return RMWPipeline(sinfo, codec, backend, perf_name=perf_name), sinfo


class TestTrackedOp:
    def test_register_timeline_and_dump(self):
        top = op_tracker.register(
            "client_op", daemon="osd.7.pool.0.rmw", oid="o1", tid=4
        )
        top.mark_event("queued")
        top.mark_event("sent", osd=3)
        d = op_tracker.dump_ops_in_flight()
        assert d["num_ops"] == 1
        op = d["ops"][0]
        # pipeline-grade names collapse to the owning daemon
        assert op["daemon"] == "osd.7"
        assert op["description"] == {"oid": "o1", "tid": 4}
        assert [e["event"] for e in op["events"]] == [
            "queued", "sent osd=3"
        ]
        assert op["age"] >= 0
        top.finish("done")
        assert op_tracker.dump_ops_in_flight()["num_ops"] == 0

    def test_age_sorted_oldest_first(self):
        a = op_tracker.register("x", daemon="d1")
        time.sleep(0.01)
        b = op_tracker.register("x", daemon="d2")
        ops = op_tracker.dump_ops_in_flight()["ops"]
        assert [o["seq"] for o in ops] == [a.seq, b.seq]
        a.finish()
        b.finish()

    def test_daemon_filter(self):
        a = op_tracker.register("x", daemon="osd.1")
        b = op_tracker.register("x", daemon="osd.2")
        d = op_tracker.dump_ops_in_flight(daemon="osd.2")
        assert d["num_ops"] == 1 and d["ops"][0]["seq"] == b.seq
        a.finish()
        b.finish()

    def test_disabled_returns_null_op(self):
        with config.override(osd_enable_op_tracker=False):
            top = op_tracker.register("x", daemon="osd.1")
            assert top is NULL_OP
            top.mark_event("whatever")  # no-op, no error
            top.finish()
            assert op_tracker.dump_ops_in_flight()["num_ops"] == 0

    def test_track_context_marks_errors(self):
        with pytest.raises(ValueError):
            with op_tracker.track("x", daemon="osd.5") as top:
                raise ValueError("boom")
        assert op_tracker.dump_ops_in_flight()["num_ops"] == 0
        assert top.events[-1][1] == "error:ValueError"

    def test_finish_all_for_daemon(self):
        op_tracker.register("x", daemon="osd.3")
        keep = op_tracker.register("x", daemon="osd.4")
        n = op_tracker.finish_all("osd.3", event="daemon_stopped")
        assert n == 1
        assert op_tracker.dump_ops_in_flight()["num_ops"] == 1
        keep.finish()

    def test_trace_id_adopted_from_current_span(self):
        from ceph_tpu_torch.utils import tracer

        with tracer.span("client_op") as sp:
            top = op_tracker.register("x", daemon="osd.1")
        assert top.trace_id == sp.trace_id
        top.finish()


class TestSlowOpWatchdog:
    def test_slow_op_complaint_and_counters(self):
        cluster_log.clear()
        with config.override(osd_op_complaint_time=0.05):
            top = op_tracker.register(
                "rmw_write", daemon="osd.42", oid="slowobj"
            )
            top.mark_event("waiting_for_subops", n=3)
            deadline = time.monotonic() + 5.0
            while not top.slow and time.monotonic() < deadline:
                op_tracker.poke()
                time.sleep(0.02)
            assert top.slow, "watchdog never flagged the op"
            dump = perf_collection.dump()["osd.42.optracker"]
            assert dump["slow_ops_total"] == 1
            assert dump["slow_ops"] >= 1
            # the complaint carries the op's last event + WRN severity
            events = cluster_log.last(50, daemon="osd.42")
            slow = [e for e in events if e["type"] == "slow_op"]
            assert slow and slow[-1]["severity"] == "WRN"
            assert "waiting_for_subops" in slow[-1]["message"]
            top.finish("done")
            # final age of a completed slow op lands in the histogram
            dump = perf_collection.dump()["osd.42.optracker"]
            assert sum(dump["slow_op_age_s"]["counts"]) == 1

    def test_complaint_fires_once_per_op(self):
        cluster_log.clear()
        with config.override(osd_op_complaint_time=0.03):
            top = op_tracker.register("x", daemon="osd.43")
            deadline = time.monotonic() + 5.0
            while not top.slow and time.monotonic() < deadline:
                op_tracker.poke()
                time.sleep(0.02)
            for _ in range(3):
                op_tracker.poke()
                time.sleep(0.03)
            slow = [
                e for e in cluster_log.last(100, daemon="osd.43")
                if e["type"] == "slow_op"
            ]
            assert len(slow) == 1
            top.finish()


class TestWedgedOpSmoke:
    """The tier-1 acceptance smoke: crash-point pause wedges an op;
    the plane explains it live; release drains it."""

    def test_pause_wedge_dump_complain_release(self, rng):
        cluster_log.clear()
        rmw, sinfo = make_rmw()
        data = rng.integers(
            0, 256, sinfo.k * sinfo.chunk_size, np.uint8
        ).tobytes()
        pt = crash_points.arm(
            "rmw.prepare_done", "pause", pause_cap=20.0
        )
        done = threading.Event()
        with config.override(osd_op_complaint_time=0.05):
            t = threading.Thread(
                target=lambda: (
                    rmw.submit("wedged", 0, data), done.set()
                ),
                daemon=True,
            )
            t.start()
            assert pt.wait_hit(5.0), "crash point never fired"
            # 1) the wedged op is visible live, with its timeline
            d = admin_socket.execute("dump_ops_in_flight")
            mine = [
                o for o in d["ops"]
                if o["type"] == "rmw_write"
                and o["description"].get("oid") == "wedged"
            ]
            assert mine, d
            events = [e["event"] for e in mine[0]["events"]]
            assert "queued" in events
            assert any(e.startswith("encoded") for e in events)
            assert mine[0]["age"] > 0
            # 2) the watchdog complains into the cluster log
            top_live = mine[0]
            deadline = time.monotonic() + 5.0
            complained = []
            while not complained and time.monotonic() < deadline:
                op_tracker.poke()
                time.sleep(0.02)
                complained = [
                    e for e in cluster_log.last(100)
                    if e["type"] == "slow_op"
                    and e.get("op_seq") == top_live["seq"]
                ]
            assert complained, "no slow-op complaint landed"
            # 3) slow_ops counters on perf dump AND the exporter
            dump = perf_collection.dump()
            # the pipeline has no owner: daemon key is the perf name
            assert dump["opt_rmw.optracker"]["slow_ops_total"] >= 1
            text = render_exposition()
            assert 'ceph_tpu_slow_ops{set="opt_rmw.optracker"}' in text
            # 4) release: the op drains and leaves the live set
            pt.release()
            assert done.wait(10.0), "op never completed after release"
            d = admin_socket.execute("dump_ops_in_flight")
            assert not [
                o for o in d["ops"]
                if o["description"].get("oid") == "wedged"
            ]

    def test_commit_timeline_complete(self, rng):
        """A clean write's tracked timeline walks the whole ladder:
        queued -> cache_ready -> encoded -> waiting_for_subops ->
        subop_ack xN -> committed (then finishes on commit-order)."""
        rmw, sinfo = make_rmw(perf_name="opt_rmw2")
        data = rng.integers(
            0, 256, sinfo.k * sinfo.chunk_size, np.uint8
        ).tobytes()
        seen: list = []
        orig_register = op_tracker.register

        def spy(op_type, daemon="", trace_id=None, **desc):
            top = orig_register(
                op_type, daemon, trace_id, **desc
            )
            if op_type == "rmw_write":
                seen.append(top)
            return top

        op_tracker.register = spy
        try:
            rmw.submit("clean", 0, data)
        finally:
            op_tracker.register = orig_register
        assert len(seen) == 1
        events = [e for _, e in seen[0].events]
        assert events[0] == "queued"
        assert "cache_ready" in events
        assert any(e.startswith("encoded") for e in events)
        assert any(
            e.startswith("waiting_for_subops") for e in events
        )
        assert sum(
            1 for e in events if e.startswith("subop_ack")
        ) == sinfo.k + sinfo.m
        assert "committed" in events
        assert events[-1] == "done"
        assert op_tracker.dump_ops_in_flight()["num_ops"] == 0


class TestClusterLog:
    def test_ring_severity_and_filters(self):
        cl = ClusterLog(max_events=4)
        for i in range(6):
            cl.log("osd.1", "t", f"m{i}")
        assert len(cl.last(100)) == 4  # bounded ring
        cl.log("osd.2", "warny", "w", severity="WRN")
        assert cl.last(1)[0]["type"] == "warny"
        assert [
            e["type"] for e in cl.last(100, severity="WRN")
        ] == ["warny"]
        assert cl.last(100, daemon="osd.2")[0]["daemon"] == "osd.2"

    def test_trace_id_stamped_inside_span(self):
        from ceph_tpu_torch.utils import tracer

        cl = ClusterLog()
        with tracer.span("client_op") as sp:
            e = cl.log("osd.1", "t", "inside")
        assert e["trace_id"] == sp.trace_id

    def test_jsonl_sink(self, tmp_path):
        import json

        cl = ClusterLog()
        path = tmp_path / "cluster.jsonl"
        cl.set_sink(str(path))
        cl.log("osd.1", "t1", "hello", severity="WRN", extra=7)
        cl.set_sink(None)
        lines = path.read_text().strip().splitlines()
        assert len(lines) == 1
        ev = json.loads(lines[0])
        assert ev["type"] == "t1" and ev["extra"] == 7

    def test_summary_counts_warnings(self):
        cl = ClusterLog()
        cl.log("a", "x", "fine")
        cl.log("a", "y", "bad", severity="ERR")
        s = cl.summary()
        assert s["events"] == 2 and s["warnings"] == 1
        assert s["recent_warnings"][0]["type"] == "y"

    def test_global_counters_on_perf_dump(self):
        before = perf_collection.dump().get(
            "cluster_log", {"events": 0}
        )["events"]
        cluster_log.log("test", "tick", "counted")
        after = perf_collection.dump()["cluster_log"]["events"]
        assert after == before + 1

    def test_admin_log_last(self):
        cluster_log.log("test", "adminx", "via socket")
        out = admin_socket.execute("log last", n=5)
        assert any(e["type"] == "adminx" for e in out)


class TestPerfReset:
    def make(self):
        coll = PerfCountersCollection()
        pc = (
            PerfCountersBuilder(coll, "r")
            .add_u64_counter("ops")
            .add_u64_gauge("depth")
            .add_time("busy")
            .add_avg("lat")
            .add_histogram("sizes", [10.0, 100.0])
            .create_perf_counters()
        )
        pc.inc("ops", 3)
        pc.set("depth", 2)
        pc.tinc("busy", 1.5)
        pc.ainc("lat", 0.5)
        pc.hinc("sizes", 50)
        return coll, pc

    def test_reset_one_set(self):
        coll, pc = self.make()
        assert coll.reset("r") == 1
        d = coll.dump()["r"]
        assert d["ops"] == 0 and d["depth"] == 0 and d["busy"] == 0.0
        assert d["lat"] == {"avgcount": 0, "sum": 0.0}
        assert d["sizes"]["counts"] == [0, 0, 0]
        assert d["sizes"]["sum"] == 0.0

    def test_reset_all_and_unknown(self):
        coll, _ = self.make()
        (
            PerfCountersBuilder(coll, "r2").add_u64_counter("n")
            .create_perf_counters()
        ).inc("n")
        assert coll.reset() == 2
        assert coll.dump()["r2"]["n"] == 0
        with pytest.raises(KeyError):
            coll.reset("ghost")

    def test_admin_perf_reset(self):
        pc = (
            PerfCountersBuilder(perf_collection, "reset_probe")
            .add_u64_counter("n")
            .create_perf_counters()
        )
        pc.inc("n", 9)
        assert (
            admin_socket.execute("perf reset", name="reset_probe") == 1
        )
        assert perf_collection.dump()["reset_probe"]["n"] == 0
        perf_collection.deregister("reset_probe")


class TestCrashPointClusterLog:
    def test_fire_logs_event(self):
        cluster_log.clear()
        crash_points.arm("unit.test.point", "fail")
        with pytest.raises(Exception):
            crash_points.fire("unit.test.point")
        ev = [
            e for e in cluster_log.last(20)
            if e["type"] == "crash_point"
        ]
        assert ev and "unit.test.point" in ev[-1]["message"]


class TestWatchdogIsolation:
    def test_independent_tracker_instance(self):
        """A standalone tracker never cross-talks the global one."""
        t = OpTracker()
        top = t.register("x", daemon="iso.1")
        assert t.live_count() == 1
        assert op_tracker.dump_ops_in_flight(daemon="iso.1")[
            "num_ops"
        ] == 0
        top.finish()
        assert t.live_count() == 0


# -- twins ---------------------------------------------------------------

def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def _untimed(dump):
    """A dump without its clock fields (start, age, event offsets)."""
    return {
        "num_ops": dump["num_ops"],
        "ops": [{k: v for k, v in op.items()
                 if k not in ("started", "age", "events", "seq")}
                | {"events": [e["event"] for e in op["events"]]}
                for op in dump["ops"]],
    }


def _tracker_script(root):
    """The same registrations, events, finishes and daemon filter in
    one package's fresh tracker."""
    tr = _mod(root, "utils.optracker").OpTracker()
    a = tr.register("client_op", daemon="osd.7.pool.0.rmw", oid="o1", tid=4)
    a.mark_event("queued")
    a.mark_event("sent", osd=3)
    time.sleep(0.002)
    b = tr.register("rmw_write", daemon="osd.2", oid="o2")
    b.mark_event("waiting_for_subops", n=3)
    c = tr.register("x", daemon="")
    out = [_untimed(tr.dump_ops_in_flight()),
           _untimed(tr.dump_ops_in_flight(daemon="osd.7"))]
    out.append(tr.finish_all("osd.2", event="daemon_stopped"))
    c.finish("done")
    out.append(_untimed(tr.dump_ops_in_flight()))
    a.finish()
    out.append((tr.live_count(), [ev for _t, ev in b.events]))
    return out


def test_tracker_dumps_equal_the_reference():
    ref, port = (_tracker_script(r) for r in ("ceph_tpu", "ceph_tpu_torch"))
    assert port == ref
    assert port[0]["ops"][0]["daemon"] == "osd.7"
    assert port[-1] == (0, ["waiting_for_subops n=3", "daemon_stopped"])


def _log_script(root):
    cl = _mod(root, "utils.cluster_log").ClusterLog(max_events=4)
    for i in range(6):
        cl.log("osd.1", "t", f"m{i}", epoch=i)
    cl.log("osd.2", "warny", "w", severity="WRN", extra=7)
    cl.log("osd.3", "bad", "e", severity="ERR")
    cl.log("osd.3", "odd", "x", severity="NOPE")
    strip = lambda evs: [{k: v for k, v in e.items() if k != "ts"}  # noqa: E731
                         for e in evs]
    s = cl.summary()
    s["recent_warnings"] = strip(s["recent_warnings"])
    return [strip(cl.last(100)), strip(cl.last(100, severity="WRN")),
            strip(cl.last(100, daemon="osd.3")), s]


def test_cluster_log_records_equal_the_reference():
    ref, port = (_log_script(r) for r in ("ceph_tpu", "ceph_tpu_torch"))
    assert port == ref
    assert len(port[0]) == 4


def test_tracker_and_reset_exposition_equal_the_reference():
    """A tracker's counter set after two slow ops, then a reset set,
    render the same exposition lines in both packages."""
    texts = []
    for root in ("ceph_tpu", "ceph_tpu_torch"):
        pcm = _mod(root, "utils.perf_counters")
        coll = pcm.PerfCountersCollection()
        pc = (pcm.PerfCountersBuilder(coll, "osd.91.optracker")
              .add_u64_counter("ops_tracked").add_u64_gauge("slow_ops")
              .add_u64_counter("slow_ops_total")
              .add_histogram("slow_op_age_s",
                             _mod(root, "utils.optracker").AGE_BUCKETS_S)
              .create_perf_counters())
        pc.inc("ops_tracked", 5)
        pc.set("slow_ops", 2)
        pc.inc("slow_ops_total", 2)
        pc.hinc("slow_op_age_s", 0.7)
        pc.hinc("slow_op_age_s", 31.5)
        r = (pcm.PerfCountersBuilder(coll, "r").add_u64_counter("ops")
             .add_time("busy").add_avg("lat").create_perf_counters())
        r.inc("ops", 3)
        r.tinc("busy", 1.5)
        r.ainc("lat", 0.5)
        ex = _mod(root, "utils.exporter")
        before = ex.render_exposition(coll)
        coll.reset("r")
        texts.append((before, ex.render_exposition(coll), coll.dump()))
    assert texts[1] == texts[0]
    assert 'ceph_tpu_slow_ops{set="osd.91.optracker"} 2' in texts[1][0]
