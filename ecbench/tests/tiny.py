"""A copy of the benchmark in a temporary directory with every mix cut
to a size the CPU runs in seconds (objects of 256 KiB, 16 of them in a
prefilled image), for the tests that drive whole runs."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SMALL = 256 * 1024


def tiny_copy(dest: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "ecbench", dest / "ecbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    for path in (dest / "ecbench" / "mixes").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["object_bytes"] = SMALL
        if mix["prefill"]:
            mix["objects"] = 16
        for op in mix["ops"]:
            op["bytes"] = min(op["bytes"], SMALL)
            op["align"] = min(op.get("align", op["bytes"]), SMALL)
        mix["warmup_ops"] = min(mix["warmup_ops"], 16)
        if mix["pool_bytes"]:
            mix["pool_bytes"] = 4 << 20
        path.write_text(json.dumps(mix))
    return dest


def run_tiny(root: Path, cell: str, seed: int = 2**31 + 99,
             seconds: float = 2.0, fault: str | None = None,
             trace: bool = False) -> dict:
    from ecbench.harness import Cell, run_cell

    bench = json.loads((root / "BENCHMARK.json").read_text())
    return run_cell(Cell(root, bench, cell), seed, seconds, trace,
                    device="cpu", fault=fault)
