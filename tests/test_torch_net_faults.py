"""The port's network-fault plane against ceph_tpu's, on the CPU.

Mirrors ``tests/test_net_faults.py`` on ``ceph_tpu_torch`` with
``device="cpu"``: the plane's per-fault semantics, both directions of a
messenger link, duplicate sub-write absorption, the objecter's resend
ladder under total loss, and the cluster chaos legs (a loadgen run under
the flaky profile, an asymmetric partition of the most-primary OSD, and
duplicated client frames absorbed by the reqid dedup).

The plane's decisions are twinned: the same seed, rules and traffic
through ``ceph_tpu``'s ``NetFaultPlane`` and the port's give the same
per-link sequence of drops, duplicates, delays and reorders, frame for
frame, and the same counters. Every cluster-booting case runs under a
time limit of its own.
"""

import importlib
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from test_torch_dcn import limited, time_limit  # noqa: E402

from ceph_tpu_torch.msg.messenger import (  # noqa: E402
    LinkRule,
    Messenger,
    NetFaultPlane,
    net_faults,
)

ROOTS = ("ceph_tpu", "ceph_tpu_torch")


def _msgr(root):
    return importlib.import_module(f"{root}.msg.messenger")


@pytest.fixture(autouse=True)
def clean_plane():
    for root in ROOTS:
        _msgr(root).net_faults.clear()
        _msgr(root).net_faults.reset_counters()
    yield
    for root in ROOTS:
        _msgr(root).net_faults.clear()
        _msgr(root).net_faults.reset_counters()


def _pattern(root, seed, n=300, rule=None):
    mod = _msgr(root)
    plane = mod.NetFaultPlane().configure(seed)
    plane.add_rule("a", "b", rule or mod.LinkRule(drop=0.3, dup=0.2))
    out = []
    for i in range(n):
        hits = []
        plane.process("a", "b", lambda i=i, h=hits: h.append(i))
        out.append(len(hits))  # 0 = dropped, 1 = clean, 2 = dup
    return out


def _rule(root, **kw):
    return _msgr(root).LinkRule(**kw)


def _both_patterns(seed, n=300, **kw):
    kw = kw or dict(drop=0.3, dup=0.2)
    return [_pattern(root, seed, n, _rule(root, **kw)) for root in ROOTS]


# ---------------------------------------------------------------------------
# plane units: decision determinism and per-fault semantics
# ---------------------------------------------------------------------------
class TestPlaneUnits:
    def test_same_seed_same_firings(self):
        """Same seed => the same per-link firing sequence, frame for
        frame, run to run and package to package."""
        ref, port = _both_patterns(1234)
        assert port == _pattern("ceph_tpu_torch", 1234, rule=LinkRule(
            drop=0.3, dup=0.2))
        assert port == ref

    def test_different_seed_different_firings(self):
        assert _both_patterns(1234)[1] != _both_patterns(4321)[1]

    def test_link_lanes_are_independent(self):
        """osd.0->osd.1 and osd.0->osd.2 draw from different RNG
        streams; both packages draw the same ones."""
        out = {}
        for root in ROOTS:
            mod = _msgr(root)
            plane = mod.NetFaultPlane().configure(7)
            plane.add_rule("osd.*", "osd.*", mod.LinkRule(drop=0.5))
            seq = {}
            for dst in ("osd.1", "osd.2"):
                got = []
                for _ in range(64):
                    hits = []
                    plane.process("osd.0", dst, lambda h=hits: h.append(1))
                    got.append(bool(hits))
                seq[dst] = got
            assert seq["osd.1"] != seq["osd.2"]
            out[root] = seq
        assert out["ceph_tpu_torch"] == out["ceph_tpu"]

    def test_drop_rate_and_counters(self):
        ref, port = _both_patterns(99, n=1000, drop=0.5)
        assert 400 < port.count(0) < 600
        assert port == ref

    def test_dup_delivers_twice(self):
        ref, port = _both_patterns(5, n=50, dup=1.0)
        assert port == ref == [2] * 50

    def test_partition_drops_everything(self):
        plane = NetFaultPlane().configure(1)
        plane.partition("b")
        hits = []
        for _ in range(20):
            plane.process("a", "b", lambda: hits.append("in"))
            plane.process("b", "a", lambda: hits.append("out"))
        assert hits == []
        assert plane.counters["frames_dropped"] == 40

    def test_asymmetric_partition_is_one_way(self):
        plane = NetFaultPlane().configure(1)
        plane.partition("b", asymmetric=True)
        hits = []
        plane.process("a", "b", lambda: hits.append("to_victim"))
        plane.process("b", "a", lambda: hits.append("from_victim"))
        assert hits == ["from_victim"]

    def test_delay_defers_delivery(self):
        plane = NetFaultPlane().configure(3)
        plane.add_rule("a", "b", LinkRule(delay_ms=80))
        done = threading.Event()
        t0 = time.monotonic()
        plane.process("a", "b", done.set)
        assert not done.is_set()
        assert done.wait(2.0)
        assert time.monotonic() - t0 >= 0.06
        assert plane.counters["frames_delayed"] == 1

    def test_reorder_swaps_with_next_frame(self):
        plane = NetFaultPlane().configure(3)
        plane.add_rule("a", "b", LinkRule(reorder=1.0))
        order = []
        ev = threading.Event()
        plane.process("a", "b", lambda: order.append("first"))
        plane.process("a", "b", lambda: (order.append("second"), ev.set()))
        assert ev.wait(2.0)
        assert order[0] == "second"
        time.sleep(plane.REORDER_FLUSH_S + 0.1)
        assert "first" in order
        assert plane.counters["frames_reordered"] >= 1

    def test_clear_flushes_held_frames(self):
        plane = NetFaultPlane().configure(3)
        plane.add_rule("a", "b", LinkRule(reorder=1.0))
        order = []
        plane.process("a", "b", lambda: order.append("held"))
        assert order == []
        plane.clear()
        assert order == ["held"]
        plane.process("a", "b", lambda: order.append("clean"))
        assert order == ["held", "clean"]


#: the twin's rules: every fault class alone and mixed; delays of a
#: minute or more, so no timer fires before ``clear()`` flushes them
TWIN_RULES = {
    "drop": dict(drop=0.4),
    "dup": dict(dup=0.5),
    "delay": dict(delay_ms=60_000, delay_jitter_ms=1_000, drop=0.1),
    "reorder": dict(reorder=0.5),
    "mixed": dict(drop=0.2, dup=0.2, reorder=0.3, delay_ms=60_000,
                  delay_jitter_ms=30_000),
    "acceptance": dict(drop=0.02, dup=0.02, delay_ms=60_000,
                       delay_jitter_ms=47, reorder=0.01),
}


def _decisions(root, seed, rule):
    """Frames over three links through one plane: for each frame, the
    frames delivered while it was processed (in order), then what
    ``clear()`` flushed; and the counters. A held frame's failsafe
    flush is pushed past the run, so nothing but the frames themselves
    and ``clear()`` releases one."""
    mod = _msgr(root)
    plane = mod.NetFaultPlane().configure(seed)
    plane.REORDER_FLUSH_S = 3600.0
    plane.add_rule("osd.*", "osd.*", mod.LinkRule(**rule))
    plane.add_rule("client", "osd.1", mod.LinkRule(**rule))
    got: list = []
    steps = []
    links = [("osd.0", "osd.1"), ("osd.1", "osd.0"), ("client", "osd.1"),
             ("client", "osd.2")]
    try:
        for i in range(240):
            src, dst = links[i % len(links)]
            mark = len(got)
            plane.process(src, dst, lambda i=i: got.append(i))
            steps.append((f"{src}>{dst}", got[mark:]))
    finally:
        mark = len(got)
        plane.clear()
    return steps, sorted(got[mark:]), dict(plane.counters)


@pytest.mark.parametrize("seed", [0xEC, 0x5EED])
@pytest.mark.parametrize("name", sorted(TWIN_RULES))
def test_twin_plane_decisions(name, seed):
    """The same seed, rules and traffic in both packages: every link's
    sequence of drops, duplicates, delays and reorders is equal frame
    for frame, and so are the counters; each fault class fired."""
    ref = _decisions("ceph_tpu", seed, TWIN_RULES[name])
    port = _decisions("ceph_tpu_torch", seed, TWIN_RULES[name])
    assert port == ref
    counters = port[2]
    for key, kind in (("frames_dropped", "drop"), ("frames_duped", "dup"),
                      ("frames_reordered", "reorder")):
        if TWIN_RULES[name].get(kind):
            assert counters[key] > 0, (name, counters)
    if any(TWIN_RULES[name].get(k) for k in ("delay_ms",
                                               "delay_jitter_ms")):
        assert counters["frames_delayed"] > 0 and port[1]
    # the unruled link (client -> osd.2) delivered every frame at once
    assert all(got == [i * 4 + 3] for i, (link, got) in enumerate(
        port[0][3::4])) and port[0][3][0] == "client>osd.2"


# ---------------------------------------------------------------------------
# messenger integration: name resolution + both fault directions
# ---------------------------------------------------------------------------
class TestMessengerIntegration:
    def _pair(self, server_name="osd.77", client_name="cli.t"):
        from ceph_tpu_torch.msg.messages import Ping

        srv = Messenger(server_name)
        srv_got = []
        srv.set_dispatcher(lambda c, m: srv_got.append(m))
        addr = srv.bind()
        cli = Messenger(client_name)
        cli_got = []
        cli.set_dispatcher(lambda c, m: cli_got.append(m))
        conn = cli.connect(addr)
        return srv, srv_got, cli, cli_got, conn, Ping

    def test_peer_name_resolved_from_bind_registry(self):
        srv, _sg, cli, _cg, conn, _Ping = self._pair()
        try:
            assert conn.peer_name == "osd.77"
        finally:
            cli.shutdown()
            srv.shutdown()

    def test_outbound_drop_eats_request(self):
        srv, srv_got, cli, _cg, conn, Ping = self._pair()
        try:
            net_faults.configure(1)
            net_faults.add_rule("cli.t", "osd.77", LinkRule(partition=True))
            conn.send(Ping(1, 0))
            time.sleep(0.25)
            assert srv_got == []
            net_faults.clear()
            conn.send(Ping(2, 0))
            deadline = time.monotonic() + 2
            while not srv_got and time.monotonic() < deadline:
                time.sleep(0.01)
            assert [m.tid for m in srv_got] == [2]
        finally:
            cli.shutdown()
            srv.shutdown()

    def test_inbound_reply_faulted_at_client_end(self):
        """Server->client frames are faulted on the client's read loop:
        a dropped reply is exactly a lost ack."""
        from ceph_tpu_torch.msg.messages import Pong

        srv, _sg, cli, cli_got, conn, Ping = self._pair()
        srv.set_dispatcher(lambda c, m: c.send(Pong(m.tid, 9)))
        try:
            net_faults.configure(1)
            net_faults.add_rule("osd.77", "cli.t", LinkRule(partition=True))
            conn.send(Ping(1, 0))
            time.sleep(0.25)
            assert cli_got == []
            net_faults.clear()
            conn.send(Ping(2, 0))
            deadline = time.monotonic() + 2
            while not cli_got and time.monotonic() < deadline:
                time.sleep(0.01)
            assert [m.tid for m in cli_got] == [2]
        finally:
            cli.shutdown()
            srv.shutdown()

    def test_duplicated_frames_arrive_twice(self):
        srv, srv_got, cli, _cg, conn, Ping = self._pair()
        try:
            net_faults.configure(1)
            net_faults.add_rule("cli.t", "osd.77", LinkRule(dup=1.0))
            conn.send(Ping(5, 0))
            deadline = time.monotonic() + 2
            while len(srv_got) < 2 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert [m.tid for m in srv_got] == [5, 5]
        finally:
            cli.shutdown()
            srv.shutdown()

    def test_escape_hatch_keeps_armed_rules_inert(self):
        from ceph_tpu_torch.utils import config

        srv, srv_got, cli, _cg, conn, Ping = self._pair()
        try:
            with config.override(msgr_fault_plane=False):
                net_faults.configure(1)
                net_faults.add_rule(
                    "cli.t", "osd.77", LinkRule(partition=True)
                )
                assert not net_faults.active
                conn.send(Ping(3, 0))
                deadline = time.monotonic() + 2
                while not srv_got and time.monotonic() < deadline:
                    time.sleep(0.01)
                assert [m.tid for m in srv_got] == [3]
        finally:
            cli.shutdown()
            srv.shutdown()


# ---------------------------------------------------------------------------
# duplicate sub-write absorption
# ---------------------------------------------------------------------------
class TestDuplicateSubWrites:
    @limited(60)
    def test_duplicated_batch_frame_commits_once(self):
        """A duplicated MSG_EC_SUB_WRITE_BATCH frame: the receiver
        re-applies idempotently, the sender's pending window absorbs
        the second ack set, each sub-write acks its op exactly once."""
        from ceph_tpu_torch.msg.shard_server import (
            NetShardBackend,
            ShardServer,
        )
        from ceph_tpu_torch.store import Transaction

        server = ShardServer(0)
        addr = server.start()
        backend = NetShardBackend({0: addr}, timeout=5.0, name="cli.dup")

        class _PC:
            absorbed = 0

            def inc(self, key, n=1):
                if key == "resends_absorbed":
                    _PC.absorbed += n

        backend.messenger.net_pc = _PC()
        net_faults.configure(11)
        net_faults.add_rule("cli.dup", "osd.0", LinkRule(dup=1.0))
        acks = {"a": 0, "b": 0}
        try:
            with backend.subwrite_batching():
                backend.submit_shard_txn(
                    0, Transaction().write("a", 0, b"AAAA"),
                    lambda: acks.__setitem__("a", acks["a"] + 1),
                )
                backend.submit_shard_txn(
                    0, Transaction().write("b", 0, b"BBBB"),
                    lambda: acks.__setitem__("b", acks["b"] + 1),
                )
            backend.drain_until(
                lambda: acks["a"] and acks["b"], timeout=10
            )
            deadline = time.monotonic() + 3
            while _PC.absorbed < 2 and time.monotonic() < deadline:
                backend.drain_until(lambda: True, timeout=0.2)
                time.sleep(0.02)
            assert acks == {"a": 1, "b": 1}, "an op must commit once"
            assert _PC.absorbed >= 2
            assert server.store.read("a") == b"AAAA"
            assert server.store.read("b") == b"BBBB"
        finally:
            backend.shutdown()
            server.stop()


# ---------------------------------------------------------------------------
# objecter backoff ladder under sustained loss
# ---------------------------------------------------------------------------
class TestObjecterLadderUnderLoss:
    @limited(60)
    def test_exhaustion_is_a_clean_error_with_exponential_spacing(self):
        from ceph_tpu_torch.cluster.objecter import NoPrimary
        from ceph_tpu_torch.loadgen import LoadCluster

        cluster = LoadCluster(
            n_osds=3, k=2, m=1, pg_num=2, chunk_size=1024,
            client_op_timeout=0.25, client_backoff=0.1,
            client_max_attempts=4, tick_period=0.1, device="cpu",
        )
        obj = cluster.client.objecter
        orig = obj._send_attempt
        try:
            cluster.io.write_full("pre", b"x" * 512)
            attempt_times = []

            def timed(aop):
                attempt_times.append(time.monotonic())
                return orig(aop)

            obj._send_attempt = timed
            base_resends = obj.resends
            net_faults.configure(2)
            net_faults.add_rule("client", "osd.*", LinkRule(partition=True))
            t0 = time.monotonic()
            with pytest.raises(NoPrimary) as exc:
                cluster.io.write_full("lost", b"y" * 512)
            assert "gave up after 4 attempts" in str(exc.value)
            assert time.monotonic() - t0 < 10.0
            assert obj.resends - base_resends == 3
            assert obj.perf.get("op_resend") >= 3
            gaps = [
                b - a
                for a, b in zip(attempt_times[-4:-1], attempt_times[-3:])
            ]
            assert gaps[-1] > gaps[0] + 0.15, (
                f"expected exponential spacing, got {gaps}"
            )
            net_faults.clear()
            assert cluster.io.write_full("post", b"z" * 512) == 512
            assert cluster.io.read("post") == b"z" * 512
        finally:
            obj._send_attempt = orig
            cluster.shutdown()


# ---------------------------------------------------------------------------
# the cluster chaos legs
# ---------------------------------------------------------------------------
def _chaos_cluster():
    from ceph_tpu_torch.loadgen import LoadCluster

    return LoadCluster(
        n_osds=5, k=2, m=1, pg_num=4, chunk_size=1024,
        tick_period=0.2, device="cpu",
    )


@pytest.fixture
def chaos():
    """The reference's chaos boot: peer timeouts short (daemons read
    them at boot), under a time limit."""
    from ceph_tpu_torch.utils import config

    with time_limit(150), config.override(
        osd_peer_rpc_timeout=1.0, osd_subop_resend_interval=0.2,
    ):
        cluster = _chaos_cluster()
        try:
            yield cluster
        finally:
            cluster.shutdown()


@pytest.mark.net_chaos
class TestChaosSmoke:
    def test_flaky_links_zero_verify_failures_exactly_once(self, chaos):
        """A mixed loadgen run under the seeded flaky profile on every
        inter-OSD link: zero verify failures, exactly once, recovered
        and scrub clean; the injections show on the plane, on the
        daemons' osd.N.net sets and in the exposition."""
        from ceph_tpu_torch.loadgen import FaultSchedule, preset, run_spec

        cluster = chaos
        spec = preset("smoke", seed=0xEC)
        sched = FaultSchedule.net_flaky(spec.total_ops, seed=0xEC)
        report = run_spec(cluster, spec, sched)
        assert report["verify_failures"] == 0
        assert report["errors"] == 0
        assert report["exactly_once"]
        assert report["ops_in"] == spec.total_ops
        assert report["recovered"]
        assert cluster.scrub_clean()
        assert net_faults.counters["frames_dropped"] > 0
        assert net_faults.counters["frames_delayed"] > 0
        assert net_faults.counters["frames_duped"] > 0
        dropped = sum(
            d.net_pc.get("frames_dropped")
            for d in cluster.daemons.values()
        )
        assert dropped > 0
        from ceph_tpu_torch.utils import perf_collection
        from ceph_tpu_torch.utils.exporter import render_exposition

        text = render_exposition(perf_collection)
        assert "frames_dropped" in text
        assert "resends_absorbed" in text

    def test_asymmetric_partition_heals_scrub_clean(self, chaos):
        """The most-primary OSD cut asymmetrically mid-run and merged
        at 2/3: re-elections counted, the run verify-clean, the merged
        cluster scrub clean."""
        from ceph_tpu_torch.loadgen import FaultSchedule, preset, run_spec

        cluster = chaos
        elections0 = sum(
            d.peering_pc.get("elections_run")
            for d in cluster.daemons.values()
        )
        spec = preset("smoke", seed=0xEC)
        sched = FaultSchedule.net_partition(
            spec.total_ops, victim="most_primary",
            asymmetric=True, seed=7,
        )
        report = run_spec(cluster, spec, sched)
        assert report["verify_failures"] == 0
        assert report["exactly_once"]
        assert report["recovered"]
        assert cluster.scrub_clean()
        assert not cluster.partitioned
        elections1 = sum(
            d.peering_pc.get("elections_run")
            for d in cluster.daemons.values()
        )
        assert elections1 > elections0, (
            "the partition must have forced re-elections"
        )

    def test_reqid_dedup_absorbs_duplicated_client_ops(self, chaos):
        """Every client->primary frame duplicated: each resent or
        duplicated mutation is replayed by the reqid dedup, never
        re-applied (appends would double)."""
        cluster = chaos
        net_faults.configure(5)
        net_faults.add_rule("client", "osd.*", LinkRule(dup=1.0))
        oid = "dup-client"
        cluster.io.write_full(oid, b"base|")
        for i in range(4):
            cluster.io.append(oid, f"seg{i}|".encode())
        got = cluster.io.read(oid)
        assert got == b"base|seg0|seg1|seg2|seg3|"
        net_faults.clear()
        hits = sum(
            d.net_pc.get("dedup_hits")
            for d in cluster.daemons.values()
        )
        assert hits > 0, "duplicated mutations must hit the dedup gate"
