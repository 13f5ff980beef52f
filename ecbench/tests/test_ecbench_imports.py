"""What the benchmark loads: nothing whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``ceph_tpu`` (compared whole: ``ceph_tpu_torch``
is the system under test), and a reference that loads nothing of the
program at all."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "ecbench" / "reference"


def _python(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_reference_package(tmp_path):
    """A whole run (a tiny cell on the CPU) in a fresh interpreter, then
    the same look ``run.py`` makes before it prints a result."""
    got = _python(
        "import json, sys, pathlib\n"
        "import ecbench.run as run\n"
        "from ecbench.tests.tiny import tiny_copy, run_tiny\n"
        f"root = tiny_copy(pathlib.Path({str(tmp_path)!r}))\n"
        "res = run_tiny(root, 'isa-k8m4.write-4m', seconds=1.0)\n"
        "tops = sorted({m.split('.', 1)[0] for m in sys.modules})\n"
        "print(json.dumps({'forbidden': run.forbidden_modules(),\n"
        "                  'tops': tops, 'correct': res['correct']}))\n")
    assert got["correct"]
    assert got["forbidden"] == []
    assert "ceph_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "ceph_tpu"} & set(got["tops"])


def test_forbidden_names_are_compared_whole(monkeypatch):
    import types

    import ecbench.run as run

    monkeypatch.setitem(sys.modules, "ceph_tpu_torch_twin",
                        types.ModuleType("ceph_tpu_torch_twin"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like",
                        types.ModuleType("jaxtyping_like"))
    assert not {"ceph_tpu", "jax"} & set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax" in run.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    got = _python(
        "import json, sys\n"
        "import ecbench.reference.check, ecbench.reference.ec\n"
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))")
    assert not {"ceph_tpu_torch", "ceph_tpu", "jax"} & set(got)
    for path in REFERENCE.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] in {
                    "__future__", "functools", "json", "numpy", "torch",
                    "itertools"}, f"{path.name} imports {name}"


def test_no_card_exits_nonzero_without_a_result():
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "ecbench.run", "--workload",
         "isa-k8m4.write-4m", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_checkout_of_the_benchmark_alone_exits_nonzero(tmp_path):
    """A directory that holds only BENCHMARK.json and ecbench/ has no
    system to run."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "ecbench", tmp_path / "ecbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "ecbench.run", "--workload",
         "isa-k8m4.write-4m", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
