"""The port's dev-cluster CLI against ceph_tpu's, on the CPU.

Mirrors ``tests/test_cli.py`` on ``ceph_tpu_torch.cli`` with
``--device cpu``: every invocation boots the cluster from its state
directory (monitor store replay, FileStore / BlockStore recovery),
runs one command and shuts down. A state directory made by either
package's CLI (``mon/store.log`` or ``mon.N/`` quorum stores, ``osd.N/``
FileStore or BlockStore trees, ``mons``) boots under the other and
serves ``get``, ``ls`` and ``scrub``; the global ``--device`` reaches the
monitor and every OSD daemon. (The ``MonStore`` cases of test_cli.py are
mirrored in ``test_torch_mon.py``.)
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from ceph_tpu import cli as ref_cli  # noqa: E402
from ceph_tpu_torch.cli import Cluster, main  # noqa: E402


def run(capsys, cdir, *argv) -> str:
    rc = main(["-d", cdir, "--device", "cpu", *argv])
    assert rc == 0, f"{argv} -> rc {rc}"
    return capsys.readouterr().out


def run_ref(capsys, cdir, *argv) -> str:
    rc = ref_cli.main(["-d", cdir, *argv])
    assert rc == 0, f"reference {argv} -> rc {rc}"
    return capsys.readouterr().out


@pytest.fixture
def cdir(tmp_path):
    return str(tmp_path / "cluster")


def test_full_cli_lifecycle_across_invocations(cdir, tmp_path, capsys):
    run(capsys, cdir, "vstart", "--osds", "6")
    run(capsys, cdir, "profile-set", "rs42",
        "plugin=jerasure", "technique=reed_sol_van", "k=4", "m=2")
    run(capsys, cdir, "pool-create", "data", "8", "rs42")
    blob = np.random.default_rng(3).integers(
        0, 256, 50_000, dtype=np.uint8).tobytes()
    src = tmp_path / "in.bin"
    src.write_bytes(blob)
    run(capsys, cdir, "put", "data", "obj1", str(src))
    out = run(capsys, cdir, "status")
    assert "pool 'data'" in out and "EC 4+2" in out and "clean" in out
    dst = tmp_path / "out.bin"
    run(capsys, cdir, "get", "data", "obj1", str(dst))
    assert dst.read_bytes() == blob
    assert run(capsys, cdir, "ls", "data").split() == ["obj1"]
    assert "50000 bytes" in run(capsys, cdir, "stat", "data", "obj1")
    run(capsys, cdir, "rm", "data", "obj1")
    with pytest.raises(FileNotFoundError):
        main(["-d", cdir, "--device", "cpu", "stat", "data", "obj1"])
    capsys.readouterr()


def test_cli_stats_surfaces(cdir, tmp_path, capsys):
    import json as _json

    run(capsys, cdir, "vstart", "--osds", "5")
    run(capsys, cdir, "profile-set", "rs21",
        "plugin=jerasure", "technique=reed_sol_van", "k=2", "m=1")
    run(capsys, cdir, "pool-create", "sp", "4", "rs21")
    src = tmp_path / "s.bin"
    src.write_bytes(b"stats" * 2000)
    run(capsys, cdir, "put", "sp", "sobj", str(src))
    out = run(capsys, cdir, "status")
    assert "health:" in out and "active+clean" in out
    assert "objects" in out and "usage:" in out
    out = run(capsys, cdir, "pg", "dump")
    assert "sp/0" in out and "active+clean" in out and "OSD\tUSED" in out
    df = _json.loads(run(capsys, cdir, "df", "--json"))
    assert df["pools"]["sp"]["objects"] >= 1
    assert df["cluster"]["capacity_bytes"] > 0


def test_pool_ids_never_reused_across_restarts(cdir, capsys):
    run(capsys, cdir, "vstart", "--osds", "4")
    run(capsys, cdir, "pool-create", "a", "4")  # id 1
    run(capsys, cdir, "pool-create", "b", "4")  # id 2
    cl = Cluster(cdir, device="cpu")
    try:
        assert cl.mon.osdmap.pools["b"].pool_id == 2
        cl.mon.osd_pool_rm("b")
    finally:
        cl.shutdown()
    run(capsys, cdir, "pool-create", "c", "4")  # separate boot
    cl = Cluster(cdir, device="cpu")
    try:
        assert cl.mon.osdmap.pools["c"].pool_id == 3  # not 2
    finally:
        cl.shutdown()


def test_cli_degraded_service_and_rebalance(cdir, tmp_path, capsys):
    run(capsys, cdir, "vstart", "--osds", "6")
    run(capsys, cdir, "profile-set", "rs32",
        "plugin=jerasure", "technique=reed_sol_van", "k=3", "m=2")
    run(capsys, cdir, "pool-create", "p", "4", "rs32")
    blob = b"payload" * 1000
    src = tmp_path / "b.bin"
    src.write_bytes(blob)
    run(capsys, cdir, "put", "p", "x", str(src))
    run(capsys, cdir, "osd-down", "5")
    dst = tmp_path / "o.bin"
    run(capsys, cdir, "get", "p", "x", str(dst))
    assert dst.read_bytes() == blob
    run(capsys, cdir, "osd-out", "5")
    assert "clean" in run(capsys, cdir, "status")
    run(capsys, cdir, "get", "p", "x", str(dst))
    assert dst.read_bytes() == blob


def test_cli_down_persists_and_up_recovers(cdir, tmp_path, capsys):
    run(capsys, cdir, "vstart", "--osds", "6")
    run(capsys, cdir, "pool-create", "p", "4")
    src = tmp_path / "b.bin"
    src.write_bytes(b"abc" * 5000)
    run(capsys, cdir, "put", "p", "x", str(src))
    run(capsys, cdir, "osd-down", "1")
    out = run(capsys, cdir, "osd-tree")
    assert "osd.1\tweight 1.00\tzone z1\tdown/in" in out
    blob2 = b"xyz" * 5000
    src.write_bytes(blob2)
    run(capsys, cdir, "put", "p", "x2", str(src))
    run(capsys, cdir, "osd-up", "1")
    assert "osd.1\tweight 1.00\tzone z1\tup/in" in run(
        capsys, cdir, "osd-tree")
    dst = tmp_path / "o.bin"
    run(capsys, cdir, "get", "p", "x2", str(dst))
    assert dst.read_bytes() == blob2
    run(capsys, cdir, "osd-out", "1")
    assert "osd.1\tweight 1.00\tzone z1\tup/out" in run(
        capsys, cdir, "osd-tree")
    run(capsys, cdir, "osd-in", "1")
    assert "osd.1\tweight 1.00\tzone z1\tup/in" in run(
        capsys, cdir, "osd-tree")


def test_cli_scrub_and_bench(cdir, capsys):
    run(capsys, cdir, "vstart", "--osds", "5")
    run(capsys, cdir, "pool-create", "p", "4")
    assert "write_MBps" in run(capsys, cdir, "bench", "p", "--size",
                               "8192", "--count", "4")
    assert "0 inconsistent" in run(capsys, cdir, "scrub")


def test_cli_mgr_commands(cdir, capsys):
    run(capsys, cdir, "vstart", "--osds", "3")
    run(capsys, cdir, "profile-set", "rs21", "plugin=isa", "k=2", "m=1")
    run(capsys, cdir, "pool-create", "p", "64", "rs21")
    assert run(capsys, cdir, "health").splitlines()[0] == "HEALTH_OK"
    out = run(capsys, cdir, "autoscale-status")
    assert "pool 'p'" in out and "ideal" in out
    assert "balanced in" in run(capsys, cdir, "balance", "--timeout", "10")
    run(capsys, cdir, "osd-down", "2")
    rc = main(["-d", cdir, "--device", "cpu", "health"])
    out = capsys.readouterr().out
    assert rc == 1
    assert ("HEALTH_WARN" in out or "HEALTH_ERR" in out) and "OSD_DOWN" in out


def test_cli_secure_cluster(cdir, tmp_path, capsys):
    pytest.importorskip(
        "cryptography",
        reason="secure messenger mode requires the cryptography lib",
    )
    out = run(capsys, cdir, "vstart", "--osds", "4", "--secure")
    assert "keyring written" in out
    run(capsys, cdir, "profile-set", "rs21", "plugin=isa", "k=2", "m=1")
    run(capsys, cdir, "pool-create", "p", "8", "rs21")
    blob = tmp_path / "blob"
    blob.write_bytes(b"sealed-bytes" * 100)
    run(capsys, cdir, "put", "p", "obj", str(blob))
    out_file = tmp_path / "out"
    run(capsys, cdir, "get", "p", "obj", str(out_file))
    assert out_file.read_bytes() == blob.read_bytes()


def test_cli_pool_snapshots(cdir, capsys):
    run(capsys, cdir, "vstart", "--osds", "4")
    run(capsys, cdir, "profile-set", "snapprof", "plugin=isa", "k=2", "m=1")
    run(capsys, cdir, "pool-create", "snappl", "8", "snapprof")
    run(capsys, cdir, "snap", "create", "snappl", "s1")
    assert "s1" in run(capsys, cdir, "snap", "ls", "snappl")
    run(capsys, cdir, "snap", "rm", "snappl", "s1")
    assert "s1" not in run(capsys, cdir, "snap", "ls", "snappl")


def test_device_reaches_the_monitor_and_every_daemon(cdir, capsys):
    import torch

    run(capsys, cdir, "vstart", "--osds", "3")
    cl = Cluster(cdir, device="cpu")
    try:
        assert cl.mon.device == torch.device("cpu")
        assert {d.device for d in cl.daemons.values()} == {
            torch.device("cpu")}
    finally:
        cl.shutdown()


def test_boot_waits_until_every_daemon_links(cdir, tmp_path, capsys):
    """A boot returns once every daemon reaches every other up OSD and
    every PG a daemon leads is peered with no position held back (the
    daemons boot one after another), so a scrub right after it finds
    every shard."""
    run(capsys, cdir, "vstart", "--osds", "6")
    run(capsys, cdir, "profile-set", "rs42", "plugin=isa", "k=4", "m=2")
    run(capsys, cdir, "pool-create", "p", "8", "rs42")
    src = tmp_path / "in.bin"
    src.write_bytes(bytes(range(256)) * 300)
    run(capsys, cdir, "put", "p", "o1", str(src))
    cl = Cluster(cdir, device="cpu")
    try:
        assert cl.wait_linked(timeout=0)
        results = [r for d in cl.daemons.values()
                   for res in d.scrub_all().values() for r in res]
        assert len(results) == 1 and results[0].ok, results
    finally:
        cl.shutdown()


@pytest.mark.parametrize("store", ["file", "block"])
@pytest.mark.parametrize("mons", [1, 3])
@pytest.mark.parametrize("maker", ["ref", "port"])
def test_state_dirs_cross_between_the_packages(
    maker, mons, store, cdir, tmp_path, capsys
):
    """A cluster made and written by one package's CLI boots under the
    other's and serves get, ls and scrub; an object the second package
    writes reads back through the first."""
    first, second = (run_ref, run) if maker == "ref" else (run, run_ref)
    argv = ["vstart", "--osds", "6", "--store", store]
    if mons > 1:
        argv += ["--mons", str(mons)]
    first(capsys, cdir, *argv)
    first(capsys, cdir, "profile-set", "rs42", "plugin=isa", "k=4", "m=2")
    first(capsys, cdir, "pool-create", "p", "8", "rs42")
    blob = np.random.default_rng(7).integers(
        0, 256, 70_000, dtype=np.uint8).tobytes()
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(blob)
    first(capsys, cdir, "put", "p", "o1", str(src))
    second(capsys, cdir, "get", "p", "o1", str(dst))
    assert dst.read_bytes() == blob
    assert second(capsys, cdir, "ls", "p").split() == ["o1"]
    assert "0 inconsistent" in second(capsys, cdir, "scrub")
    src.write_bytes(blob[::-1])
    second(capsys, cdir, "put", "p", "o2", str(src))
    first(capsys, cdir, "get", "p", "o2", str(dst))
    assert dst.read_bytes() == blob[::-1]
