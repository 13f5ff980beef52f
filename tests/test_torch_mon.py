"""The port's replicated monitor (``cluster/paxos.py``,
``cluster/mon_quorum.py``, ``cluster/mon_store.py``) against ceph_tpu's,
on the CPU.

The twin cases run one scenario through both packages and compare what
it leaves: the committed Paxos values, every rank's ``OSDMap`` bytes,
the epochs, and the errors raised. The mirrors run the reference's
``tests/test_paxos.py``, ``tests/test_mon_quorum.py`` and
``tests/test_config_monitor.py`` cases on the port with ``device="cpu"``
(the live-cluster ones boot the port's OSD daemons, whose timing is not
the reference's, so they are held to the reference's assertions rather
than to its bytes). ``MonStore`` files reopen across the packages in
both directions with the same epochs and map bytes.

Every daemon binds ``127.0.0.1:0``, every wait has a deadline, and every
client and daemon is shut down in teardown.
"""

import importlib
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOTS = ("ceph_tpu", "ceph_tpu_torch")


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


def _dev(root):
    return {"device": "cpu"} if root == "ceph_tpu_torch" else {}


def payload(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8
    ).tobytes()


# -- Paxos twins (tests/test_paxos.py) ---------------------------------

def _values(mc):
    return [node.committed_values() for node in mc.nodes]


def _sc_majority(px):
    mc = px.MonCluster(3)
    slots = [mc.commit(b"epoch1"), mc.commit(b"epoch2")]
    return slots, _values(mc)


def _sc_minority(px):
    mc = px.MonCluster(3)
    mc.commit(b"before")
    mc.transport.partition((0,), (1, 2))
    try:
        mc.nodes[0].propose(1, b"doomed")
        raised = None
    except px.QuorumLost:
        raised = "QuorumLost"
    leader = mc.elect(from_rank=1)
    mc.commit(b"after", leader=leader)
    return raised, leader.rank, _values(mc), mc.nodes[0].last_committed()


def _sc_healed(px):
    mc = px.MonCluster(3)
    mc.commit(b"a")
    mc.transport.partition((0,), (1, 2))
    mc.commit(b"b", leader=mc.elect(from_rank=1))
    mc.transport.heal()
    mc.commit(b"c")
    return _values(mc)


def _sc_competing(px):
    mc = px.MonCluster(3)
    v1 = mc.nodes[0].propose(0, b"from0")
    v2 = mc.nodes[2].propose(0, b"from2")
    return v1, v2, [node.slots[0].committed for node in mc.nodes]


def _sc_ghost(px):
    mc = px.MonCluster(3)
    n0 = mc.nodes[0]
    pn = n0._next_pn()
    steps = [n0.on_prepare(0, pn)[0], mc.nodes[1].on_prepare(0, pn)[0],
             n0.on_accept(0, pn, b"ghost"),
             mc.nodes[1].on_accept(0, pn, b"ghost")]
    mc.transport.partition((0,), (1, 2))
    leader = mc.elect(from_rank=1)
    synced = mc.nodes[1].slots[0].committed
    return steps, leader.rank, synced, mc.commit(b"next", leader=leader)


def _sc_five(px):
    mc = px.MonCluster(5)
    mc.commit(b"x")
    mc.transport.partition((3, 4), (0, 1, 2))
    leader = mc.elect()
    mc.commit(b"y", leader=leader)
    mc.transport.partition((0,), (1, 2))
    try:
        mc.elect(from_rank=1)
        raised = None
    except px.QuorumLost:
        raised = "QuorumLost"
    return leader.rank, mc.nodes[2].committed_values(), raised


@pytest.mark.parametrize("scenario", [
    _sc_majority, _sc_minority, _sc_healed, _sc_competing, _sc_ghost,
    _sc_five,
], ids=lambda f: f.__name__[4:])
def test_twin_paxos_scenarios(scenario):
    """Each tests/test_paxos.py scenario through both packages' Paxos:
    the same slots, leaders, decided values and errors."""
    got = [scenario(_mod(root, "cluster.paxos")) for root in ROOTS]
    assert got[1] == got[0]


def _monitor_over_paxos(root):
    cl = _mod(root, "cluster")
    px = _mod(root, "cluster.paxos")
    mc = px.MonCluster(3)
    mon = cl.Monitor(commit_fn=lambda incr: mc.commit(incr.to_bytes()),
                     **_dev(root))
    for i in range(4):
        mon.osd_crush_add(i, zone=f"z{i}")
        mon.osd_boot(i, ("127.0.0.1", 7000 + i))
    mon.osd_erasure_code_profile_set(
        "p", {"plugin": "jerasure", "technique": "reed_sol_van",
              "k": "2", "m": "1"})
    mon.osd_pool_create("pool", 8, "p")
    m = cl.OSDMap()
    for blob in mc.nodes[2].committed_values():
        m = m.apply(cl.Incremental.from_bytes(blob))
    assert m.to_bytes() == mon.osdmap.to_bytes()
    return mc.nodes[2].committed_values(), mon.osdmap.to_bytes()


def test_twin_monitor_over_paxos_replicates_incrementals():
    """Monitor(commit_fn=quorum): every epoch lands in the replicated
    log, a replica's log rebuilds the map, and both packages log the
    same incrementals byte for byte."""
    ref, port = (_monitor_over_paxos(root) for root in ROOTS)
    assert port == ref


def test_twin_monitor_with_lost_quorum_rejects_commands():
    out = []
    for root in ROOTS:
        cl, px = _mod(root, "cluster"), _mod(root, "cluster.paxos")
        mc = px.MonCluster(3)
        leader = mc.elect()
        mon = cl.Monitor(commit_fn=lambda incr, mc=mc, leader=leader:
                         mc.commit(incr.to_bytes(), leader=leader),
                         **_dev(root))
        mon.osd_crush_add(0)
        mc.transport.partition((0,), (1, 2))
        with pytest.raises(px.QuorumLost):
            mon.osd_crush_add(1)
        assert 1 not in mon.osdmap.osds
        out.append((mon.osdmap.epoch, mon.osdmap.to_bytes()))
    assert out[1] == out[0] and out[0][0] == 1


# -- MonQuorumService twins (tests/test_mon_quorum.py) -----------------

def _quorum(root, n=3):
    mq = _mod(root, "cluster.mon_quorum")
    svc = mq.MonQuorumService(n, **_dev(root))
    return svc, mq.QuorumMonitor(svc)


def _rank_maps(svc):
    return [m.osdmap.to_bytes() for m in svc.monitors]


def _replicate(root):
    svc, mon = _quorum(root)
    for i in range(4):
        mon.osd_crush_add(i, zone=f"z{i}")
        mon.osd_boot(i, ("127.0.0.1", 7100 + i))
    mon.osd_erasure_code_profile_set(
        "p", {"plugin": "jerasure", "technique": "reed_sol_van",
              "k": "2", "m": "1"})
    mon.osd_pool_create("pool", 4, "p")
    maps = _rank_maps(svc)
    assert maps == [mon.osdmap.to_bytes()] * 3
    return maps


def _leader_kill(root):
    cl = _mod(root, "cluster")
    svc, mon = _quorum(root)
    for i in range(3):
        mon.osd_crush_add(i, zone=f"z{i}")
        mon.osd_boot(i, ("127.0.0.1", 7200 + i))
    before = mon.osdmap.epoch
    leader0 = svc.leader_rank()
    svc.kill(leader0)
    mon.osd_down(0)
    assert svc.leader_rank() != leader0
    assert mon.osdmap.epoch == before + 1
    m = cl.OSDMap()
    for blob in svc.paxos.nodes[svc.leader_rank()].committed_values():
        m = m.apply(cl.Incremental.from_bytes(blob))
    assert m.to_bytes() == mon.osdmap.to_bytes()
    return leader0, svc.leader_rank(), mon.osdmap.to_bytes()


def _minority(root):
    px = _mod(root, "cluster.paxos")
    svc, mon = _quorum(root)
    mon.osd_crush_add(0, zone="z")
    svc.kill(0)
    svc.kill(1)
    with pytest.raises(px.QuorumLost):
        mon.osd_crush_add(1, zone="z")
    return mon.osdmap.to_bytes()


def _revived(root):
    svc, mon = _quorum(root)
    mon.osd_crush_add(0, zone="z")
    svc.kill(2)
    for i in range(1, 4):
        mon.osd_crush_add(i, zone=f"z{i}")
    svc.revive(2)
    assert svc.monitors[2].osdmap.to_bytes() == mon.osdmap.to_bytes()
    return _rank_maps(svc)


def _ex_leader(root):
    svc, mon = _quorum(root)
    mon.osd_crush_add(0, zone="z")
    svc.kill(0)
    for i in range(1, 4):
        mon.osd_crush_add(i, zone=f"z{i}")
    svc.revive(0)
    assert svc.leader_rank() == 0
    mon.osd_crush_add(4, zone="z4")
    maps = _rank_maps(svc)
    assert maps == [mon.osdmap.to_bytes()] * 3
    return maps


def _config_quorum(root):
    svc, qmon = _quorum(root)
    qmon.config_set("osd_scrub_min_interval", "42", who="osd")
    for rank in range(3):
        assert svc.monitors[rank].osdmap.config.get(
            ("osd", "osd_scrub_min_interval")) == "42"
    svc.kill(svc._leader_rank)
    qmon.config_set("osd_scrub_min_interval", "43", who="osd")
    live = [r for r in range(3) if r not in svc.dead]
    for rank in live:
        assert svc.monitors[rank].osdmap.config[
            ("osd", "osd_scrub_min_interval")] == "43"
    return [svc.monitors[r].osdmap.to_bytes() for r in live]


@pytest.mark.parametrize("scenario", [
    _replicate, _leader_kill, _minority, _revived, _ex_leader,
    _config_quorum,
], ids=lambda f: f.__name__.lstrip("_"))
def test_twin_quorum_service(scenario):
    """tests/test_mon_quorum.py's service cases (and the config db
    through a quorum, tests/test_config_monitor.py) through both
    packages: each rank's map bytes, leaders and errors equal."""
    got = [scenario(root) for root in ROOTS]
    assert got[1] == got[0]


def test_quorum_monitors_run_on_the_service_device():
    svc, _mon = _quorum("ceph_tpu_torch")
    assert svc.device == torch.device("cpu")
    assert {m.device for m in svc.monitors} == {torch.device("cpu")}


# -- the live cluster behind a quorum (port daemons) -------------------

def _live(pool, pg_num=8):
    from ceph_tpu_torch.cluster import OSDDaemon, RadosClient

    svc, mon = _quorum("ceph_tpu_torch")
    daemons = []
    for i in range(5):
        mon.osd_crush_add(i, zone=f"z{i % 3}")
    try:
        for i in range(5):
            d = OSDDaemon(i, mon, chunk_size=1024, device="cpu")
            d.start()
            daemons.append(d)
        mon.osd_erasure_code_profile_set(
            "rs32", {"plugin": "jerasure", "technique": "reed_sol_van",
                     "k": "3", "m": "2"})
        mon.osd_pool_create(pool, pg_num, "rs32")
        client = RadosClient(mon, backoff=0.01)
    except Exception:
        for d in daemons:
            d.stop()
        raise
    return svc, mon, daemons, client


@pytest.fixture
def live_quorum():
    made = []

    def boot(pool, pg_num=8):
        c = _live(pool, pg_num)
        made.append(c)
        return c

    yield boot
    for _svc, _mon, daemons, client in made:
        client.shutdown()
        for d in daemons:
            d.stop()


def test_leader_killed_mid_workload(live_quorum):
    """Mirror of TestLiveClusterQuorum: the leader dies while a client
    writes; commands fail over, no committed epoch is lost on any
    survivor, and every write reads back."""
    from ceph_tpu_torch.cluster.osdmap import Incremental, OSDMap

    svc, mon, daemons, client = live_quorum("ecpool")
    io = client.open_ioctx("ecpool")
    blobs = {f"pre{i}": payload(3000, seed=i) for i in range(4)}
    for oid, b in blobs.items():
        io.write(oid, b)
    epoch_before = mon.osdmap.epoch
    stop = threading.Event()
    errors: list = []
    written: dict = {}

    def workload():
        i = 0
        while not stop.is_set():
            oid = f"w{i % 6}"
            data = payload(2000, seed=100 + i)
            try:
                io.write(oid, data)
                written[oid] = data
            except Exception as e:
                errors.append(e)
                return
            i += 1

    t = threading.Thread(target=workload)
    t.start()
    try:
        time.sleep(0.3)
        leader0 = svc.leader_rank()
        svc.kill(leader0)
        time.sleep(0.5)
        victim = mon.osdmap.object_to_acting("ecpool", "pre0")[1]
        mon.osd_down(victim)
        mon.osd_boot(victim, daemons[victim].addr)
        time.sleep(0.3)
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert not errors, f"workload died during failover: {errors[0]}"
    assert svc.leader_rank() != leader0
    assert mon.osdmap.epoch > epoch_before
    for r in range(3):
        if r == leader0:
            continue
        m = OSDMap()
        for blob in svc.paxos.nodes[r].committed_values():
            m = m.apply(Incremental.from_bytes(blob))
        assert m.epoch == mon.osdmap.epoch, f"rank {r} lost epochs"
    for oid, b in {**blobs, **written}.items():
        assert io.read(oid) == b, f"{oid} corrupted by failover"
    io.write("post", payload(2500, seed=999))
    assert io.read("post") == payload(2500, seed=999)


def test_io_survives_quorum_loss_on_last_map(live_quorum):
    """Mirror of TestQuorumLossUnderIO: two of three monitors dead,
    commands raise QuorumLost, reads and writes go on."""
    from ceph_tpu_torch.cluster.paxos import QuorumLost

    svc, mon, _daemons, client = live_quorum("qpool", pg_num=4)
    io = client.open_ioctx("qpool")
    io.write("pre", payload(3000))
    svc.kill(svc.leader_rank())
    svc.kill(svc.leader_rank())
    with pytest.raises(QuorumLost):
        mon.osd_down(4)
    io.write("during", payload(2500, seed=5))
    assert io.read("pre") == payload(3000)
    assert io.read("during") == payload(2500, seed=5)


# -- the central config db (tests/test_config_monitor.py) --------------

@pytest.fixture
def config_cluster():
    from ceph_tpu_torch.cluster import Monitor, OSDDaemon, RadosClient
    from ceph_tpu_torch.utils import config

    mon = Monitor(device="cpu")
    daemons = []
    for i in range(3):
        mon.osd_crush_add(i, zone=f"z{i}")
    client = None
    try:
        for i in range(3):
            d = OSDDaemon(i, mon, chunk_size=1024, device="cpu")
            d.start()
            daemons.append(d)
        mon.osd_erasure_code_profile_set(
            "rs21", {"plugin": "jerasure", "technique": "reed_sol_van",
                     "k": "2", "m": "1"})
        mon.osd_pool_create("pool", 4, "rs21")
        client = RadosClient(mon, backoff=0.01)
        yield mon, daemons, client
    finally:
        if client is not None:
            client.shutdown()
        for d in daemons:
            d.stop()
        for name in ("osd_scrub_min_interval", "ec_use_sched"):
            config.rm(name, layer="mon")


def _wait(pred, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_config_set_reaches_live_daemon(config_cluster):
    from ceph_tpu_torch.utils import config

    mon, _daemons, _client = config_cluster
    assert config.get("osd_scrub_min_interval") == 86400.0
    mon.config_set("osd_scrub_min_interval", "123.5", who="osd")
    assert _wait(lambda: config.get("osd_scrub_min_interval") == 123.5)
    assert config.get_source("osd_scrub_min_interval") == "mon"
    mon.config_rm("osd_scrub_min_interval", who="osd")
    assert _wait(lambda: config.get("osd_scrub_min_interval") == 86400.0)


def test_config_observers_and_local_override(config_cluster):
    from ceph_tpu_torch.utils import config

    mon, _daemons, _client = config_cluster
    seen = []
    config.add_observer("osd_scrub_min_interval",
                        lambda n, v: seen.append(v))
    mon.config_set("osd_scrub_min_interval", "77", who="")
    assert _wait(lambda: 77.0 in seen)
    assert _wait(lambda: config.get("osd_scrub_min_interval") == 77.0)
    config.set("osd_scrub_min_interval", "99", layer="runtime")
    try:
        assert config.get("osd_scrub_min_interval") == 99.0
        assert config.get_source("osd_scrub_min_interval") == "runtime"
    finally:
        config.rm("osd_scrub_min_interval", layer="runtime")
    assert config.get("osd_scrub_min_interval") == 77.0
    mon.config_rm("osd_scrub_min_interval", who="")
    assert _wait(lambda: 86400.0 in seen)


def test_twin_config_validation_and_scoping():
    out = []
    for root in ROOTS:
        cl = _mod(root, "cluster")
        mon = cl.Monitor(**_dev(root))
        errors = []
        for args in (("no_such_option", "1"),
                     ("osd_scrub_min_interval", "not-a-float"),
                     ("osd_scrub_min_interval", "1", "weird.x")):
            with pytest.raises(cl.CommandError) as exc:
                mon.config_set(*args[:2], who=args[2] if len(args) > 2
                               else "")
            errors.append(str(exc.value))
        mon.config_set("osd_scrub_min_interval", "5", who="osd.2")
        out.append((errors, mon.config_db(), mon.osdmap.to_bytes()))
    assert out[1] == out[0]
    assert out[0][1] == {"osd.2/osd_scrub_min_interval": "5"}


# -- MonStore across packages ------------------------------------------

def _incrs(root, n=6):
    od = _mod(root, "cluster.osdmap")
    out = []
    for e in range(1, n + 1):
        pools = (od.PoolSpec("p5", 5, 8, "prof", "isa", 2, 1),) if e == 1 \
            else ()
        out.append(od.Incremental(
            epoch=e, new_osds=(od.OSDInfo(e % 3, 1.0, f"z{e % 3}", True,
                                          True, ("h", 7000 + e)),),
            new_pools=pools))
    return out


def _write_store(root, path, keep, trim_at=None):
    od = _mod(root, "cluster.osdmap")
    ms = _mod(root, "cluster.mon_store")
    store = ms.MonStore(path, keep=keep)
    m = od.OSDMap()
    for incr in _incrs(root):
        store.append(incr)
        m = m.apply(incr)
        if trim_at == incr.epoch:
            store.trim(m)
    return m.to_bytes()


def _read_store(root, path, keep):
    ms = _mod(root, "cluster.mon_store")
    store = ms.MonStore(path, keep=keep)
    m, hist = store.replay()
    return m.epoch, m.to_bytes(), [h.epoch for h in hist], \
        [h.to_bytes() for h in hist], store.pool_id_floor()


@pytest.mark.parametrize("writer,reader", [ROOTS, ROOTS[::-1]],
                         ids=["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("keep,trim_at", [(1024, None), (2, 4)],
                         ids=["untrimmed", "trimmed"])
def test_mon_store_reopens_across_packages(tmp_path, writer, reader, keep,
                                           trim_at):
    """A MonStore written by one package opens in the other with the
    same epochs, map bytes, in-window incrementals and pool-id floor;
    the files on disk are the same bytes whichever package wrote them."""
    paths = {root: str(tmp_path / root / "mon" / "store.log")
             for root in ROOTS}
    want = _write_store(writer, paths[writer], keep, trim_at)
    got = _read_store(reader, paths[writer], keep)
    assert got[1] == want and got[0] == 6
    assert got == _read_store(writer, paths[writer], keep)
    # the other package writes the same history into a fresh directory:
    # every file under the two store roots is equal
    _write_store(reader, paths[reader], keep, trim_at)
    roots = {root: os.path.dirname(paths[root]) for root in ROOTS}
    files = {root: {os.path.relpath(os.path.join(d, name), roots[root]):
                    open(os.path.join(d, name), "rb").read()
                    for d, _sub, names in os.walk(roots[root])
                    for name in names}
             for root in ROOTS}
    assert files[ROOTS[0]] == files[ROOTS[1]]


@pytest.mark.parametrize("writer", ROOTS)
def test_legacy_mon_log_migrates_in_either_package(tmp_path, writer):
    """The framed legacy log one package wrote is absorbed by the
    other's MonStore on first open, then removed."""
    reader = ROOTS[1] if writer == ROOTS[0] else ROOTS[0]
    fl = _mod(writer, "store.framed_log")
    od = _mod(writer, "cluster.osdmap")
    path = str(tmp_path / "mon" / "store.log")
    os.makedirs(os.path.dirname(path))
    m = od.OSDMap()
    for incr in _incrs(writer, 4):
        fl.append(path, incr.to_bytes())
        m = m.apply(incr)
    got = _read_store(reader, path, 1024)
    assert not os.path.exists(path)
    assert got[1] == m.to_bytes() and got[2] == [1, 2, 3, 4]


def test_port_monitor_restarts_from_a_reference_store(tmp_path):
    """A monitor's store written by ceph_tpu (trimmed, with a pool id
    burned in the trimmed history) restarts a port Monitor at the same
    map, and the next pool id skips the burned one."""
    from ceph_tpu_torch.cluster import Monitor
    from ceph_tpu_torch.cluster.mon_store import MonStore

    path = str(tmp_path / "mon" / "store.log")
    want = _write_store("ceph_tpu", path, 2, trim_at=5)
    store = MonStore(path, keep=2)
    m, hist = store.replay()
    assert m.to_bytes() == want
    mon = Monitor(initial=m, history=hist,
                  pool_id_floor=store.pool_id_floor(), device="cpu")
    assert mon.osdmap.to_bytes() == want
    assert mon._next_pool_id > 5
