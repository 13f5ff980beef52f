"""The port's offline store tool against ceph_tpu's, on the CPU.

Mirrors ``tests/test_objectstore_tool.py`` on
``ceph_tpu_torch.objectstore_tool`` (``--device cpu``) over FileStore
and BlockStore directories: list / info / export / import / remove /
fsck, the shard-salvage round trip, fsck catching on-device bit rot
and a corrupt OI attr. Both tools print the same JSON rows for the same
store, and an export archive made by either package imports through the
other into a store of the other package.
"""

import json
import os

import pytest

pytest.importorskip("torch")

from ceph_tpu import objectstore_tool as ref_tool  # noqa: E402
from ceph_tpu import store as ref_store  # noqa: E402
from ceph_tpu_torch import objectstore_tool as tool  # noqa: E402
from ceph_tpu_torch.pipeline.hashinfo import HashInfo  # noqa: E402
from ceph_tpu_torch.store import (  # noqa: E402
    BlockStore,
    FileStore,
    Transaction,
)

HINFO = HashInfo(3, device="cpu")
HINFO.append(0, {0: b"a" * 4096, 1: b"b" * 4096, 2: b"c" * 4096})


def _fill(st):
    st.queue_transactions(
        Transaction()
        .write("1:alpha#s0", 0, b"A" * 3000)
        .setattr("1:alpha#s0", "oi", b"3000:5:17")
        .setattr("1:alpha#s0", "u:tag", b"hello")
        .setattr("1:alpha#s0", "hinfo_key", HINFO.to_bytes())
    )
    st.queue_transactions(Transaction().write("1:beta#s2", 0, b"B" * 500))
    if hasattr(st, "close"):
        st.close()


@pytest.fixture(params=["file", "block"])
def store_dir(request, tmp_path):
    path = str(tmp_path / "osd.0")
    if request.param == "block":
        st = BlockStore(path, size=1 << 22)
    else:
        st = FileStore(path)
    with open(os.path.join(path, "backend"), "w") as f:
        f.write(request.param)
    _fill(st)
    return path


def run(capsys, *argv, main=None):
    if main is None:
        rc = tool.main([*argv, "--device", "cpu"])
    else:
        rc = main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


class TestListInfo:
    def test_list_json_rows(self, store_dir, capsys):
        rc, out, _ = run(capsys, "--data-path", store_dir, "--op", "list")
        assert rc == 0
        rows = [json.loads(line) for line in out.strip().splitlines()]
        byoid = {r["oid"]: r for r in rows}
        assert byoid["1:alpha#s0"]["bytes"] == 3000
        assert byoid["1:alpha#s0"]["eversion"] == [5, 17]
        assert byoid["1:beta#s2"]["bytes"] == 500

    def test_info_dumps_attrs(self, store_dir, capsys):
        rc, out, _ = run(
            capsys, "--data-path", store_dir, "--op", "info", "1:alpha#s0"
        )
        assert rc == 0
        row = json.loads(out)
        assert row["ro_size"] == 3000
        assert bytes.fromhex(row["attrs"]["u:tag"]) == b"hello"
        assert row["hinfo"]["total_chunk_size"] == 4096

    def test_info_missing_object(self, store_dir, capsys):
        rc, _, err = run(
            capsys, "--data-path", store_dir, "--op", "info", "ghost"
        )
        assert rc == 1 and "not found" in err

    @pytest.mark.parametrize("op", [["list"], ["info", "1:alpha#s0"],
                                    ["fsck"]])
    def test_output_equals_the_reference(self, store_dir, capsys, op):
        argv = ["--data-path", store_dir, "--op", *op]
        rc_p, out_p, _ = run(capsys, *argv)
        rc_r, out_r, _ = run(capsys, *argv, main=ref_tool.main)
        assert (rc_p, out_p) == (rc_r, out_r)

    def test_info_needs_the_card_by_default(self, store_dir, monkeypatch):
        torch = pytest.importorskip("torch")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(["--data-path", store_dir, "--op", "info",
                       "1:alpha#s0"])


class TestExportImport:
    def test_salvage_round_trip(self, store_dir, tmp_path, capsys):
        archive = str(tmp_path / "dump.bin")
        rc, out, _ = run(
            capsys, "--data-path", store_dir, "--op", "export",
            "--file", archive,
        )
        assert rc == 0 and "exported 2 objects" in out
        dest = str(tmp_path / "osd.1")
        FileStore(dest)
        rc, out, _ = run(
            capsys, "--data-path", dest, "--op", "import",
            "--file", archive,
        )
        assert rc == 0 and "imported 2 objects" in out
        st = FileStore(dest)
        assert st.read("1:alpha#s0") == b"A" * 3000
        assert st.getattr("1:alpha#s0", "u:tag") == b"hello"
        assert st.read("1:beta#s2") == b"B" * 500

    def test_import_refuses_overwrite_without_force(
        self, store_dir, tmp_path, capsys
    ):
        archive = str(tmp_path / "dump.bin")
        run(capsys, "--data-path", store_dir, "--op", "export",
            "--file", archive)
        rc, _, err = run(
            capsys, "--data-path", store_dir, "--op", "import",
            "--file", archive,
        )
        assert rc == 1 and "exists" in err
        rc, out, _ = run(
            capsys, "--data-path", store_dir, "--op", "import",
            "--file", archive, "--force",
        )
        assert rc == 0

    def test_corrupt_archive_tail_detected(
        self, store_dir, tmp_path, capsys
    ):
        archive = str(tmp_path / "dump.bin")
        run(capsys, "--data-path", store_dir, "--op", "export",
            "--file", archive)
        with open(archive, "r+b") as f:
            f.seek(-3, os.SEEK_END)
            f.write(b"\xff\xff\xff")  # corrupt the LAST record
        dest = str(tmp_path / "osd.2")
        FileStore(dest)
        rc, out, err = run(
            capsys, "--data-path", dest, "--op", "import",
            "--file", archive,
        )
        assert rc == 1
        assert "corrupt" in err
        assert "imported 1 objects" in out

    @pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
    @pytest.mark.parametrize("dest_kind", ["file", "block"])
    def test_archives_cross_both_ways(
        self, store_dir, tmp_path, capsys, direction, dest_kind
    ):
        """An archive either package exports is byte-equal to the
        other's and imports through the other tool into the other
        package's store; the stores then read back equal."""
        a_port, a_ref = str(tmp_path / "p.bin"), str(tmp_path / "r.bin")
        run(capsys, "--data-path", store_dir, "--op", "export",
            "--file", a_port)
        run(capsys, "--data-path", store_dir, "--op", "export",
            "--file", a_ref, main=ref_tool.main)
        assert open(a_port, "rb").read() == open(a_ref, "rb").read()
        dest = str(tmp_path / "osd.7")
        if direction == "port-to-ref":
            kinds = {"file": ref_store.FileStore, "block": ref_store.BlockStore}
            importer, archive = ref_tool.main, a_port
        else:
            kinds = {"file": FileStore, "block": BlockStore}
            importer, archive = None, a_ref
        st = (kinds[dest_kind](dest, size=1 << 22) if dest_kind == "block"
              else kinds[dest_kind](dest))
        if hasattr(st, "close"):
            st.close()
        with open(os.path.join(dest, "backend"), "w") as f:
            f.write(dest_kind)
        rc, out, _ = run(capsys, "--data-path", dest, "--op", "import",
                         "--file", archive, main=importer)
        assert rc == 0 and "imported 2 objects" in out
        src = tool.open_store(store_dir)
        back = (ref_tool.open_store(dest) if direction == "port-to-ref"
                else tool.open_store(dest))
        try:
            for oid in src.list_objects():
                assert back.read(oid) == src.read(oid)
                assert back.getattrs(oid) == src.getattrs(oid)
        finally:
            for st in (src, back):
                if hasattr(st, "close"):
                    st.close()


class TestRemoveFsck:
    def test_remove(self, store_dir, capsys):
        rc, out, _ = run(
            capsys, "--data-path", store_dir, "--op", "remove",
            "1:beta#s2",
        )
        assert rc == 0
        rc, out, _ = run(capsys, "--data-path", store_dir, "--op", "list")
        assert "1:beta#s2" not in out

    def test_fsck_clean(self, store_dir, capsys):
        rc, out, _ = run(capsys, "--data-path", store_dir, "--op", "fsck")
        assert rc == 0 and "2 objects, 0 errors" in out

    @pytest.mark.parametrize("pkg", ["port", "ref"])
    def test_fsck_catches_bit_rot_on_blockstore(self, tmp_path, capsys, pkg):
        """The same flipped device byte, in a store either package
        wrote, is caught by both tools with the same report."""
        path = str(tmp_path / "osd.9")
        pkg_store = {"port": (BlockStore, Transaction),
                     "ref": (ref_store.BlockStore, ref_store.Transaction)}
        make, txn = pkg_store[pkg]
        st = make(path, size=1 << 22)
        st.queue_transactions(txn().write("o", 0, b"Z" * 8000))
        dev_off = next(iter(st._objects["o"].blobs.values())).offset
        st.close()
        with open(os.path.join(path, "block"), "r+b") as f:
            f.seek(dev_off + 11)
            f.write(b"\x01")
        rc, out, _ = run(capsys, "--data-path", path, "--op", "fsck")
        assert rc == 1 and "data error" in out
        assert run(capsys, "--data-path", path, "--op", "fsck",
                   main=ref_tool.main)[:2] == (rc, out)

    def test_fsck_catches_corrupt_oi(self, tmp_path, capsys):
        path = str(tmp_path / "osd.8")
        st = FileStore(path)
        st.queue_transactions(
            Transaction().write("o", 0, b"x").setattr("o", "oi", b"12:9")
        )
        rc, out, _ = run(capsys, "--data-path", path, "--op", "fsck")
        assert rc == 1 and "corrupt OI" in out
        assert run(capsys, "--data-path", path, "--op", "fsck",
                   main=ref_tool.main)[:2] == (rc, out)
