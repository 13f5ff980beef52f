"""The port's ``bench_cli`` (the ``ceph_erasure_code_benchmark`` analog)
against ceph_tpu's, on the CPU.

Each workload runs through both packages' ``bench_cli.run`` with the
same flags (the port with ``--device cpu``), at shrunk sizes: the KiB
column is equal, and so is every codec output the workload produced
(the parity of each encode, the chunks of each decode and repair, the
checksums of each calculate), byte for byte. The seconds column is a
time and is not compared. The mirrors run the reference's
``tests/test_bench_cli.py`` cases on the port, plus its decode check (a
wrong decoded byte raises) and ``python -m ceph_tpu_torch.bench_cli``.
"""

import importlib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOTS = ("ceph_tpu", "ceph_tpu_torch")
ROOT = Path(__file__).resolve().parent.parent


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _capture(root, monkeypatch, log):
    """Wrap every codec the package's registry builds so that the
    outermost encode / decode / repair call logs its outputs, and every
    Checksummer.calculate its checksums."""
    reg = importlib.import_module(f"{root}.codecs").registry
    orig = reg.factory
    depth = [0]

    def factory(*args, **kw):
        codec = orig(*args, **kw)
        for name in ("encode_chunks", "decode_chunks", "repair"):
            fn = getattr(codec, name, None)
            if fn is None:
                continue

            def wrapped(*a, _fn=fn, _name=name, **k):
                depth[0] += 1
                try:
                    out = _fn(*a, **k)
                finally:
                    depth[0] -= 1
                if depth[0] == 0:
                    log.append((_name, {i: _host(c).tobytes()
                                        for i, c in sorted(out.items())}))
                return out

            setattr(codec, name, wrapped)
        return codec

    monkeypatch.setattr(reg, "factory", factory)
    summer = importlib.import_module(f"{root}.checksum").Checksummer
    calc = summer.calculate

    def calculate(self, *a, **k):
        out = calc(self, *a, **k)
        log.append(("calculate", _host(out).tobytes()))
        return out

    monkeypatch.setattr(summer, "calculate", calculate)


def _run(root, argv, monkeypatch):
    bc = importlib.import_module(f"{root}.bench_cli")
    log: list = []
    with monkeypatch.context() as mp:
        _capture(root, mp, log)
        extra = ["--device", "cpu"] if root == "ceph_tpu_torch" else []
        elapsed, kib = bc.run(bc.parse_args(argv + extra))
    return elapsed, kib, log


WORKLOADS = {
    "encode_isa": ["encode", "--plugin", "isa", "-P", "k=4", "-P", "m=2",
                   "--size", "65536", "--batch", "2", "--iterations", "3"],
    "encode_jerasure_cauchy": [
        "encode", "--plugin", "jerasure", "-P", "technique=cauchy_good",
        "-P", "k=4", "-P", "m=2", "--size", "65536", "--batch", "2",
        "--iterations", "2"],
    "decode_exhaustive": [
        "decode", "--plugin", "isa", "-P", "k=4", "-P", "m=2", "--size",
        "32768", "--batch", "2", "--iterations", "6", "--erasures", "2",
        "--erasures-generation", "exhaustive"],
    "decode_random": [
        "decode", "--plugin", "jerasure", "-P", "technique=reed_sol_van",
        "-P", "k=4", "-P", "m=2", "--size", "32768", "--batch", "2",
        "--iterations", "5", "--erasures", "2"],
    "decode_one_erasure_k8": [
        "decode", "--plugin", "isa", "-P", "k=8", "-P", "m=4", "--size",
        "65536", "--batch", "2", "--iterations", "4"],
    "repair_clay": [
        "repair", "--plugin", "clay", "-P", "k=4", "-P", "m=2", "-P", "d=5",
        "--size", "4096", "--iterations", "6"],
    "checksum_crc32c": [
        "checksum", "--csum-alg", "crc32c", "--csum-block", "4096",
        "--size", str(4096 * 16), "--iterations", "3"],
    "checksum_xxhash64": [
        "checksum", "--csum-alg", "xxhash64", "--csum-block", "16384",
        "--size", str(16384 * 16), "--iterations", "3"],
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_twin_workload_outputs_and_kib(name, monkeypatch):
    """The same workload through both packages: the same KiB column and
    the same codec outputs, call for call, byte for byte."""
    argv = WORKLOADS[name]
    (_t0, kib0, log0), (t1, kib1, log1) = (
        _run(root, argv, monkeypatch) for root in ROOTS)
    assert t1 > 0
    assert kib1 == kib0 and kib1 > 0
    assert log1 and [entry[0] for entry in log1] == \
        [entry[0] for entry in log0]
    assert log1 == log0


def test_encode_contract():
    from ceph_tpu_torch import bench_cli

    elapsed, kib = bench_cli.run(bench_cli.parse_args([
        "encode", "--plugin", "isa", "-P", "k=4", "-P", "m=2", "--size",
        "65536", "--batch", "2", "--iterations", "3", "--device", "cpu"]))
    assert elapsed > 0
    assert kib > 0 and kib == int(kib)


def test_repair_counts_fractional_helper_bytes():
    from ceph_tpu_torch import bench_cli
    from ceph_tpu_torch.codecs.registry import registry

    args = bench_cli.parse_args([
        "repair", "-P", "k=4", "-P", "m=2", "-P", "d=5", "--size", "4096",
        "--iterations", "6", "--device", "cpu"])
    elapsed, kib = bench_cli.run(args)
    assert args.plugin == "clay" and elapsed > 0
    chunk = registry.factory("clay", {"k": "4", "m": "2", "d": "5"},
                             device="cpu").get_chunk_size(4096)
    assert kib / 6 < 4 * chunk / 1024


def test_repair_needs_an_msr_codec():
    from ceph_tpu_torch import bench_cli

    with pytest.raises(RuntimeError, match="no fractional repair"):
        bench_cli.run(bench_cli.parse_args([
            "repair", "--plugin", "isa", "-P", "k=4", "-P", "m=2",
            "--size", "4096", "--iterations", "1", "--device", "cpu"]))


def test_checksum_rejects_undersized_buffer():
    from ceph_tpu_torch import bench_cli

    with pytest.raises(RuntimeError):
        bench_cli.run(bench_cli.parse_args([
            "checksum", "--csum-block", "4096", "--size", "100",
            "--device", "cpu"]))


def test_decode_raises_on_a_wrong_byte(monkeypatch):
    """Every erased chunk is checked against the original: a decode
    that returns one wrong byte fails the run."""
    from ceph_tpu_torch import bench_cli
    from ceph_tpu_torch.codecs.matrix_codec import MatrixErasureCodec

    orig = MatrixErasureCodec.decode_chunks

    def corrupt(self, want, chunks):
        out = orig(self, want, chunks)
        lost = min(w for w in want if w not in chunks)
        bad = out[lost].clone()
        bad.view(-1)[7] ^= 1
        return {**out, lost: bad}

    monkeypatch.setattr(MatrixErasureCodec, "decode_chunks", corrupt)
    with pytest.raises(RuntimeError, match="differs after decode"):
        bench_cli.run(bench_cli.parse_args([
            "decode", "--plugin", "isa", "-P", "k=4", "-P", "m=2",
            "--size", "32768", "--batch", "2", "--iterations", "2",
            "--device", "cpu"]))
    assert bench_cli.main([
        "decode", "--plugin", "isa", "-P", "k=4", "-P", "m=2", "--size",
        "32768", "--batch", "2", "--iterations", "2", "--device",
        "cpu"]) == 1


def test_runs_as_a_module():
    """``python -m ceph_tpu_torch.bench_cli`` prints the two columns."""
    out = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.bench_cli", "checksum",
         "--device", "cpu", "--size", "65536", "--iterations", "2"],
        capture_output=True, text=True, timeout=120, check=True, cwd=ROOT,
    ).stdout
    assert re.fullmatch(r"\d+\.\d{6}\t128\n", out), out
