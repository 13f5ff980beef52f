"""The port's golden-corpus tool against ceph_tpu's, on the CPU.

Mirrors ``tests/test_corpus.py`` on ``ceph_tpu_torch.corpus`` with
``device="cpu"``: every shipped entry under ``tests/corpus/v0-v2``
checks clean (re-encode byte-equal, every 1- and 2-erasure decode), the
payload generator and slugs are frozen, and corruption is caught. Both
packages ``create`` the same suites into ``tmp_path`` and the two trees
are compared file by file, byte for byte; each package checks the
other's tree.
"""

import os
from pathlib import Path

import pytest

pytest.importorskip("torch")

from ceph_tpu import corpus as ref_corpus  # noqa: E402
from ceph_tpu_torch import corpus  # noqa: E402
from ceph_tpu_torch.corpus import (  # noqa: E402
    deterministic_payload,
    iter_entries,
    profile_slug,
    run_check,
    run_create,
)

CORPUS_ROOT = os.path.join(os.path.dirname(__file__), "corpus")

ENTRIES = sorted(
    e
    for v in (os.listdir(CORPUS_ROOT) if os.path.isdir(CORPUS_ROOT) else ())
    if os.path.isdir(os.path.join(CORPUS_ROOT, v))
    for e in iter_entries(os.path.join(CORPUS_ROOT, v))
)


def test_corpus_exists():
    assert len(ENTRIES) >= 15


@pytest.mark.parametrize(
    "entry", ENTRIES,
    ids=[
        f"{os.path.basename(os.path.dirname(os.path.dirname(e)))}-"
        f"{os.path.basename(e)}"
        for e in ENTRIES
    ],
)
def test_non_regression(entry):
    assert run_check(entry, device="cpu") == []


def test_payload_generator_and_slugs_are_frozen():
    assert deterministic_payload(8, "pin").hex() == "74b05dd103836d89"
    for suite in corpus.SUITES.values():
        for entry in suite:
            assert profile_slug(entry[0], entry[1]) == ref_corpus.profile_slug(
                entry[0], entry[1])
    assert corpus.SUITES == ref_corpus.SUITES
    assert corpus.PAYLOAD_SIZE == ref_corpus.PAYLOAD_SIZE


def test_create_then_check_roundtrip(tmp_path):
    path = run_create(
        str(tmp_path), "jerasure",
        {"technique": "reed_sol_van", "k": "3", "m": "2"}, size=5000,
        device="cpu",
    )
    assert run_check(path, device="cpu") == []


def test_check_detects_corruption(tmp_path):
    path = run_create(
        str(tmp_path), "jerasure",
        {"technique": "reed_sol_van", "k": "3", "m": "2"}, size=5000,
        device="cpu",
    )
    chunk_path = os.path.join(path, "chunk.1")
    raw = bytearray(open(chunk_path, "rb").read())
    raw[10] ^= 0xFF
    open(chunk_path, "wb").write(bytes(raw))
    errors = run_check(path, device="cpu")
    assert any("chunk 1" in e or "differs" in e for e in errors)


def _tree(root: Path) -> dict[str, bytes]:
    return {
        str(p.relative_to(root)): p.read_bytes()
        for p in sorted(root.rglob("*")) if p.is_file()
    }


@pytest.mark.parametrize("version", ["v0", "v1", "v2"])
def test_both_packages_create_the_same_tree(version, tmp_path, capsys):
    """``create`` of a whole suite through each package's CLI: the trees
    are equal file for file, their chunks and payloads equal the shipped
    archive's where the names match, and each package's ``check``
    passes the other's tree."""
    port_base = tmp_path / "port" / version
    ref_base = tmp_path / "ref" / version
    assert corpus.main(["create", "--base", str(port_base),
                        "--device", "cpu"]) == 0
    assert ref_corpus.main(["create", "--base", str(ref_base)]) == 0
    port_tree, ref_tree = _tree(port_base), _tree(ref_base)
    assert port_tree.keys() == ref_tree.keys()
    for name in port_tree:
        assert port_tree[name] == ref_tree[name], name
    # entries the suite still creates under their shipped names (v0's
    # liberation and liber8tion pin construction=v0 in their slug now)
    shipped = _tree(Path(CORPUS_ROOT) / version)
    common = [n for n in shipped
              if n in port_tree and not n.endswith("profile.json")]
    assert common
    for name in common:
        assert port_tree[name] == shipped[name], name
    capsys.readouterr()
    assert corpus.main(["check", "--base", str(ref_base),
                        "--device", "cpu"]) == 0
    assert ref_corpus.main(["check", "--base", str(port_base)]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out


def test_cli_check_of_the_shipped_archive(capsys):
    assert corpus.main(["check", "--base", os.path.join(CORPUS_ROOT, "v0"),
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("ok  ") == len(list(iter_entries(
        os.path.join(CORPUS_ROOT, "v0"))))
