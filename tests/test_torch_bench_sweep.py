"""The port's ``bench_sweep`` (the bench.sh + bench.html analog) against
ceph_tpu's, on the CPU.

Mirrors the sweep legs of ``tests/test_bench_cli.py``: the five
BASELINE.md configs are the reference's and every argv parses (with
``--device``); the baseline and a k/m sweep run end to end with
``--device cpu`` at shrunk sizes through ``bench_cli`` and give rows
with the reference's keys and KiB columns; the HTML report is the
reference's template over the same rows.
"""

import json

import pytest

pytest.importorskip("torch")

from ceph_tpu import bench_sweep as ref_sweep  # noqa: E402
from ceph_tpu_torch import bench_cli, bench_sweep  # noqa: E402


def test_baseline_configs_cover_all_five():
    assert bench_sweep.BASELINE_CONFIGS == ref_sweep.BASELINE_CONFIGS
    names = [name for name, _ in bench_sweep.BASELINE_CONFIGS]
    assert any("jerasure" in n for n in names)
    assert any("isa" in n for n in names)
    assert any("cauchy" in n for n in names)
    assert any("clay" in n for n in names)
    assert sum("crc32c" in n for n in names) == 3  # 4/16/64K blocks
    for _, argv in bench_sweep.BASELINE_CONFIGS:
        assert bench_cli.parse_args(argv + ["--device", "cpu"]).device == "cpu"


def _shrunk(configs):
    """The configs with the per-iteration size cut to a few stripes
    and two iterations (the shapes and plugins unchanged)."""
    out = []
    for name, argv in configs:
        argv = list(argv)
        i = argv.index("--size")
        argv[i + 1] = str(min(int(argv[i + 1]), 1 << 16))
        for flag, value in (("--iterations", "2"), ("--batch", "2")):
            if flag in argv:
                argv[argv.index(flag) + 1] = value
        out.append((name, argv))
    return out


def test_baseline_runs_on_the_asked_device(monkeypatch, capsys):
    """--baseline through both packages: the same rows, keys and KiB
    (seconds and GB/s are times), no error row."""
    for mod in (bench_sweep, ref_sweep):
        monkeypatch.setattr(mod, "BASELINE_CONFIGS",
                            _shrunk(ref_sweep.BASELINE_CONFIGS))
    seen = []
    orig = bench_cli.run

    def run(args):
        seen.append(args.device)
        return orig(args)

    monkeypatch.setattr(bench_cli, "run", run)
    port = bench_sweep.run_baseline("cpu")
    ref = ref_sweep.run_baseline()
    assert set(seen) == {"cpu"} and len(seen) == len(port)
    assert [r.keys() for r in port] == [r.keys() for r in ref]
    assert [(r["config"], r["KiB"]) for r in port] == [
        (r["config"], r["KiB"]) for r in ref
    ]
    assert not any("error" in r for r in port)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines[:len(port)] == port


def test_sweep_rows_match_the_reference():
    argv = ["--plugins", "isa", "jerasure", "--k", "2", "4", "--m", "2",
            "--size", "32768", "--iterations", "2", "--batch", "2"]
    port = bench_sweep.sweep(bench_sweep.parse_args(argv + ["--device",
                                                            "cpu"]))
    ref = ref_sweep.sweep(ref_sweep.parse_args(argv))
    key = ("plugin", "k", "m", "workload", "KiB")
    assert [tuple(r[k] for k in key) for r in port] == [
        tuple(r[k] for k in key) for r in ref
    ]
    assert [r.keys() for r in port] == [r.keys() for r in ref]


def test_error_rows_and_html(tmp_path):
    """A workload the codec refuses becomes an error row (and a nonzero
    exit); the HTML is the reference's template over the rows."""
    argv = ["--plugins", "isa", "--k", "2", "--m", "2",
            "--workloads", "decode", "--erasures", "3",
            "--size", "8192", "--iterations", "1", "--batch", "2",
            "--html", str(tmp_path / "p.html")]
    assert bench_sweep.main(argv + ["--device", "cpu"]) == 1
    assert ref_sweep.main(argv[:-1] + [str(tmp_path / "r.html")]) == 1
    assert (tmp_path / "p.html").read_text() == (
        tmp_path / "r.html").read_text()
    rows = [{"plugin": "isa", "k": 2, "m": 2, "workload": "encode",
             "seconds": 0.5, "KiB": 64, "GBps": 0.131}]
    bench_sweep.write_html(str(tmp_path / "a.html"), rows)
    ref_sweep.write_html(str(tmp_path / "b.html"), rows)
    assert (tmp_path / "a.html").read_text() == (
        tmp_path / "b.html").read_text()


def test_default_device_is_the_card():
    assert bench_sweep.parse_args([]).device == "cuda"
