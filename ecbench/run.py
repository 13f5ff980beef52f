"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m ecbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs as many CUDA cards as the cell asks for and exits 2, printing
no result, without them. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``limits``: each number
the check compared beside its limit); the last lines of standard error
repeat those numbers and limits. With ``--trace 0`` the metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.

``--fault <name>`` plants one of ``ecbench/faults.py``'s faults under
the timed path: the control's entry, never used by a benchmark run.
"""

from __future__ import annotations

import os
import sys
import time

_T_START = time.perf_counter()
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache of the program at a fixed path inside the
# checkout, so only a checkout's first run builds
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
    _ROOT, "ecbench", ".cache", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(
    _ROOT, "ecbench", ".cache", "triton")
os.environ["USE_FLAX"] = "0"

#: top-level module names that no run may hold once its window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "ceph_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _parse(argv):
    import argparse

    p = argparse.ArgumentParser(prog="python3 -m ecbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    import json
    from pathlib import Path

    args = _parse(argv)
    root = Path(_ROOT)
    try:
        with open(root / "BENCHMARK.json") as f:
            bench = json.load(f)
        from ecbench.harness import Cell, process_age_s, run_cell

        cell = Cell(root, bench, args.workload)
        import torch  # noqa: F401  (after the cache directories are set)
    except (OSError, KeyError, ValueError, ImportError) as e:
        print(f"ecbench: cannot set up {args.workload!r}: {e}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"ecbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg: str) -> None:
        print(f"ecbench: {msg}", file=sys.stderr, flush=True)

    age = process_age_s() - (time.perf_counter() - _T_START)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda", fault=args.fault,
                      age_at_start=max(age, 0.0), t_start=_T_START, log=log)
    found = forbidden_modules()
    if found:
        print(f"ecbench: the run loaded {found}", file=sys.stderr)
        return 3
    log("setup parts: " + json.dumps(result["setup_parts"]))
    log(f"window ops {result['window_ops']}, resends {result['resends']}, "
        f"check {result['check_s']:.3f} s")
    line = {
        "correct": result["correct"],
        "attempted": result["attempted"],
        "failed": result["failed"],
        "metrics": result["metrics"],
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": cell.chips,
            "memory_peak_bytes": result["memory_peak_bytes"],
        },
        "setup_parts": result["setup_parts"],
    }
    if args.trace:
        line["device"]["busy_s"] = result["busy_s"]
        line["device"]["window_s"] = result["window_s"]
        line["breakdown"] = result["breakdown"]
    line["limits"] = result["limits"]
    for name, v in result["limits"].items():
        print(f"{name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
