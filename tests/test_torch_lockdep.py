"""The port's runtime lockdep plane against ceph_tpu's, on the CPU.

Mirrors ``tests/test_lockdep.py`` on ``ceph_tpu_torch`` with
``device="cpu"``: planted order inversions and blocking-under-lock
findings detected deterministically, the disarmed constructors handing
back plain threading primitives, the admin-socket and forensics
surfaces, and the armed live-cluster gate (a small cluster through
writes, reads, RMW and a primary kill and revive with zero findings).

The planted scenarios are twinned: the same locks taken in the same
order under each package's detector give the same findings, the same
lock classes, edges, cycle pairs and rank violations (the backtraces
name each package's own frames and are left out). Every
cluster-booting case runs under a time limit of its own.
"""

import importlib
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from test_torch_dcn import limited  # noqa: E402

from ceph_tpu_torch.utils import lockdep  # noqa: E402
from ceph_tpu_torch.utils.config import config  # noqa: E402
from ceph_tpu_torch.utils.lockdep import DebugLock, DebugRLock  # noqa: E402


@pytest.fixture
def armed():
    with config.override(lockdep=True):
        lockdep.reset()
        yield
    lockdep.reset()


# -- disarmed: plain primitives, zero steady-state cost ------------------

def test_disarmed_constructs_plain_locks():
    with config.override(lockdep=False):
        lk = DebugLock("t.off")
        rlk = DebugRLock("t.off_r")
    assert isinstance(lk, type(threading.Lock()))
    assert isinstance(rlk, type(threading.RLock()))


def test_overhead_ab_sanity(armed):
    """The armed wrapper stays usable (a generous constant factor)."""
    plain = threading.Lock()
    t0 = time.perf_counter()
    for _ in range(20_000):
        with plain:
            pass
    plain_s = time.perf_counter() - t0

    tracked = DebugLock("t.ab")
    t0 = time.perf_counter()
    for _ in range(20_000):
        with tracked:
            pass
    tracked_s = time.perf_counter() - t0
    assert tracked_s < max(plain_s * 2000, 10.0), (plain_s, tracked_s)


# -- planted order inversion ---------------------------------------------

def test_planted_inversion_detected(armed):
    """(A then B) and (B then A) on two threads, one after the other:
    no deadlock, yet the graph reports the would-deadlock cycle with
    both acquisition backtraces."""
    A = DebugLock("t.inv_a")
    B = DebugLock("t.inv_b")
    done = []

    def ab():
        with A:
            with B:
                done.append("ab")

    def ba():
        with B:
            with A:
                done.append("ba")

    for fn in (ab, ba):
        t = threading.Thread(target=fn)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive(), "planted inversion actually deadlocked"
    assert done == ["ab", "ba"]

    d = lockdep.dump()
    assert len(d["cycles"]) == 1, d["cycles"]
    c = d["cycles"][0]
    assert set(c["pair"]) == {"t.inv_a", "t.inv_b"}
    assert any("test_torch_lockdep" in fr for fr in c["this_backtrace"])
    assert any("test_torch_lockdep" in fr for fr in c["held_backtrace"])
    for edge in c["edges"]:
        assert edge["acquire_backtrace"], edge
    assert lockdep.findings()["cycles"] == 1


def test_inversion_reported_once(armed):
    A = DebugLock("t.once_a")
    B = DebugLock("t.once_b")
    for _ in range(3):
        with A:
            with B:
                pass
        with B:
            with A:
                pass
    assert lockdep.findings()["cycles"] == 1


def test_rank_violation_reported(armed):
    outer = DebugLock("t.rank_hi", rank=50)
    inner = DebugLock("t.rank_lo", rank=10)
    with outer:
        with inner:
            pass
    d = lockdep.dump()
    assert len(d["rank_violations"]) == 1
    v = d["rank_violations"][0]
    assert v["held"] == "t.rank_hi" and v["acquired"] == "t.rank_lo"
    with inner:
        pass
    with DebugLock("t.rank_mid", rank=30):
        pass
    assert lockdep.findings()["rank_violations"] == 1


def test_rlock_reentry_is_not_an_edge(armed):
    R = DebugRLock("t.reent")
    with R:
        with R:
            pass
    d = lockdep.dump()
    assert "t.reent -> t.reent" not in d["edges"]
    assert lockdep.findings()["cycles"] == 0


# -- planted blocking-under-lock -----------------------------------------

def test_planted_blocking_under_op_lock_flagged(armed):
    OP = DebugLock("t.op", op_serializing=True)
    with OP:
        with lockdep.blocking_region("test.planted_block"):
            pass
    d = lockdep.dump()
    hits = d["blocking_under_lock"]
    assert len(hits) == 1, hits
    assert hits[0]["label"] == "test.planted_block"
    assert hits[0]["lock"] == "t.op"
    assert hits[0]["blocking_backtrace"], hits[0]
    with lockdep.blocking_region("test.planted_block2"):
        pass
    assert lockdep.findings()["blocking_under_lock"] == 1


def test_waived_label_not_flagged(armed):
    OP = DebugLock("t.op2", op_serializing=True)
    with OP:
        with lockdep.blocking_region("peers.drain_until"):
            pass
    assert lockdep.findings()["blocking_under_lock"] == 0


def test_non_op_lock_blocking_is_fine(armed):
    plain = DebugLock("t.not_op")
    with plain:
        with lockdep.blocking_region("test.nblock"):
            pass
    assert lockdep.findings()["blocking_under_lock"] == 0


def test_checked_sleep_flags_under_op_lock(armed):
    OP = DebugLock("t.op3", op_serializing=True)
    with OP:
        lockdep.checked_sleep(0.001, label="test.sleep_shim")
    assert lockdep.findings()["blocking_under_lock"] == 1


def test_blocking_waivers_all_justified():
    for label, why in lockdep.BLOCKING_WAIVERS.items():
        assert isinstance(why, str) and len(why) >= 20, (
            f"waiver {label!r} needs a real one-line justification"
        )


# -- the planted scenarios twinned ----------------------------------------

def _planted(root):
    """Every planted scenario above under ``root``'s detector; returns
    its findings, lock classes, edges, cycle pairs, rank violations,
    blocking labels and waivers."""
    ld = importlib.import_module(f"{root}.utils.lockdep")
    cfg = importlib.import_module(f"{root}.utils.config").config
    with cfg.override(lockdep=True):
        ld.reset()
        A, B = ld.DebugLock("t.tw_a"), ld.DebugLock("t.tw_b")
        for first, second in ((A, B), (B, A), (A, B)):
            with first:
                with second:
                    pass
        with ld.DebugLock("t.tw_hi", rank=50):
            with ld.DebugLock("t.tw_lo", rank=10):
                pass
        R = ld.DebugRLock("t.tw_r")
        with R:
            with R:
                pass
        OP = ld.DebugLock("t.tw_op", op_serializing=True)
        with OP:
            with ld.blocking_region("test.tw_block"):
                pass
            with ld.blocking_region("peers.drain_until"):
                pass
            ld.checked_sleep(0.001, label="test.tw_sleep")
        d = ld.dump()
        out = (ld.findings(), sorted(d["lock_classes"]), sorted(d["edges"]),
               sorted(tuple(sorted(c["pair"])) for c in d["cycles"]),
               [(v["held"], v["acquired"]) for v in d["rank_violations"]],
               [(h["label"], h["lock"]) for h in d["blocking_under_lock"]],
               sorted(d["blocking_waivers"]))
    ld.reset()
    return out


def test_twin_planted_findings_equal():
    ref = _planted("ceph_tpu")
    port = _planted("ceph_tpu_torch")
    assert port == ref
    assert port[0] == {"cycles": 1, "rank_violations": 1,
                       "blocking_under_lock": 2}


# -- integration surfaces -------------------------------------------------

def test_condition_over_debug_locks(armed):
    for lk in (DebugLock("t.cv"), DebugRLock("t.cv_r")):
        cv = threading.Condition(lk)
        got = []

        def waiter():
            with cv:
                got.append(cv.wait(timeout=5))

        t = threading.Thread(target=waiter)
        t.start()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with cv:
                waiting = bool(cv._waiters)
            if waiting:
                break
            time.sleep(0.005)
        with cv:
            cv.notify()
        t.join(timeout=5)
        assert got == [True]


def test_admin_socket_lockdep_dump(armed):
    from ceph_tpu_torch.utils import admin_socket

    d = admin_socket.execute("lockdep")
    for key in ("enabled", "edges", "cycles", "rank_violations",
                "blocking_under_lock", "blocking_waivers"):
        assert key in d


def test_reset_clears_findings(armed):
    A = DebugLock("t.rst_a")
    B = DebugLock("t.rst_b")
    with A:
        with B:
            pass
    with B:
        with A:
            pass
    assert lockdep.findings()["cycles"] == 1
    lockdep.reset()
    assert lockdep.findings() == {
        "cycles": 0, "rank_violations": 0, "blocking_under_lock": 0,
    }


# -- forensics / soak routing ---------------------------------------------

def test_forensics_bundle_contains_lockdep_dump(tmp_path):
    import json
    import os

    from ceph_tpu_torch.loadgen.forensics import write_bundle

    manifest = write_bundle(str(tmp_path), {"probe": 1}, reason="test")
    assert "lockdep.json" in manifest["files"]
    with open(os.path.join(manifest["dir"], "lockdep.json")) as f:
        d = json.load(f)
    assert "cycles" in d and "blocking_under_lock" in d


def test_lockdep_findings_turn_run_nongreen():
    from ceph_tpu_torch.loadgen.forensics import run_is_green

    base = {"verify_failures": 0, "exactly_once": True, "errors": 0}
    green, _ = run_is_green({**base, "lockdep": {
        "cycles": 0, "rank_violations": 0, "blocking_under_lock": 0,
    }})
    assert green
    green, why = run_is_green({**base, "lockdep": {
        "cycles": 1, "rank_violations": 0, "blocking_under_lock": 0,
    }})
    assert not green and "lockdep" in why


# -- the armed live-cluster gate ------------------------------------------

@limited(120)
def test_armed_cluster_smoke_zero_findings():
    """A small live cluster (write / read / RMW / primary kill + revive
    + recovery) runs under the detector with zero cycles, zero rank
    violations and zero unwaived blocking-under-lock findings, and
    records lock dependencies (the gate is real)."""
    from ceph_tpu_torch.loadgen.cluster import LoadCluster
    from ceph_tpu_torch.loadgen.driver import LoadGenerator
    from ceph_tpu_torch.loadgen.faults import FaultEvent, FaultSchedule
    from ceph_tpu_torch.loadgen.spec import WorkloadSpec

    with config.override(lockdep=True):
        lockdep.reset()
        cluster = LoadCluster(
            n_osds=5, k=2, m=1, pg_num=4, chunk_size=1024, device="cpu",
        )
        try:
            spec = WorkloadSpec(
                mix={"seq_write": 2, "read": 2, "rmw_overwrite": 1},
                object_size=4096, max_objects=8, queue_depth=2,
                total_ops=30, warmup_ops=2, seed=11,
            )
            victim = cluster.most_primary_osd()
            faults = FaultSchedule(
                [FaultEvent(10, "kill", osd=victim),
                 FaultEvent(20, "revive", osd=victim)],
                recovery_timeout=60,
            )
            report = LoadGenerator(cluster, spec, faults).run()
            assert report["verify_failures"] == 0
        finally:
            cluster.shutdown()

    found = lockdep.findings()
    d = lockdep.dump()
    assert found["cycles"] == 0, d["cycles"]
    assert found["rank_violations"] == 0, d["rank_violations"]
    assert found["blocking_under_lock"] == 0, d["blocking_under_lock"]
    assert d["edges"], "armed cluster recorded no lock dependencies?"
    assert "osd.op" in d["lock_classes"]
    lockdep.reset()
