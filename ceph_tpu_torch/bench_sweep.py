"""k/m sweep benchmark harness — the bench.sh + bench.html analog.

Mirrors qa/workunits/erasure-code/bench.sh:20-48: sweep k (and m)
across plugins, run the encode and/or decode workload for each
configuration through the ``ecbench`` CLI machinery, and emit results
as JSON lines plus an optional self-contained HTML bar chart (the
flot-plot role, dependency-free).

    python -m ceph_tpu_torch.bench_sweep --plugins isa jerasure \
        --k 2 4 8 --m 2 4 --size 16777216 --iterations 5 \
        --html bench.html

``--baseline`` ignores the sweep axes and reproduces the five
BASELINE.md benchmark configs 1:1 (jerasure rs k=4 m=2 4K; isa rs
k=8 m=3 64K; cauchy k=10 m=4 1M x 1024 stripes; CLAY (8,4,d=11)
single-chunk repair; CRC32C over 4/16/64 KiB blocks):

    python -m ceph_tpu_torch.bench_sweep --baseline

Every workload runs on ``--device`` (``cuda`` unless the caller asks
for the CPU), passed to each ``bench_cli`` run. The configs, the JSON
rows' keys and the HTML template are ``ceph_tpu``'s.
"""

from __future__ import annotations

import argparse
import json
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="ceph_tpu_torch.bench_sweep")
    p.add_argument("--plugins", nargs="+", default=["isa", "jerasure"])
    p.add_argument("--k", nargs="+", type=int, default=[2, 4, 6, 8, 11])
    p.add_argument("--m", nargs="+", type=int, default=[2])
    p.add_argument("--workloads", nargs="+", default=["encode", "decode"],
                   choices=["encode", "decode"])
    p.add_argument("--size", type=int, default=16 * 1024 * 1024)
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--erasures", type=int, default=1)
    p.add_argument("--html", default=None,
                   help="also write a self-contained HTML chart here")
    p.add_argument("--baseline", action="store_true",
                   help="run the five BASELINE.md configs instead of "
                        "the k/m sweep")
    p.add_argument("--device", default="cuda",
                   help="where every workload runs (cuda, or cpu)")
    return p.parse_args(argv)


# BASELINE.md "Benchmark configs to reproduce 1:1". Sizes follow the
# config text (per-chunk/stripe bytes); iterations kept modest so the
# full set runs in minutes on one chip.
BASELINE_CONFIGS: list[tuple[str, list[str]]] = [
    # --size is total bytes per iteration across the stripe batch:
    # chunk_bytes * k * batch.
    ("1 jerasure reed_sol_van k=4 m=2 4K chunks",
     ["encode", "--plugin", "jerasure", "-P", "technique=reed_sol_van",
      "-P", "k=4", "-P", "m=2", "--size", str(4096 * 4 * 256),
      "--batch", "256", "--iterations", "20"]),
    ("2 isa rs k=8 m=3 64K stripe",
     ["encode", "--plugin", "isa", "-P", "k=8", "-P", "m=3",
      "--size", str(64 * 1024 * 64), "--batch", "64",
      "--iterations", "20"]),
    ("3 cauchy k=10 m=4 1M objects, 1024-stripe batch",
     ["encode", "--plugin", "jerasure", "-P", "technique=cauchy_good",
      "-P", "k=10", "-P", "m=4", "--size", str((1 << 20) * 1024),
      "--batch", "1024", "--iterations", "10"]),
    ("4 clay (8,4,d=11) single-chunk repair",
     ["repair", "--plugin", "clay", "-P", "k=8", "-P", "m=4",
      "-P", "d=11", "--size", str(1 << 20), "--iterations", "12"]),
    ("5a crc32c 4K blocks", ["checksum", "--csum-alg", "crc32c",
     "--csum-block", "4096", "--size", str(64 << 20), "--iterations", "5"]),
    ("5b crc32c 16K blocks", ["checksum", "--csum-alg", "crc32c",
     "--csum-block", "16384", "--size", str(64 << 20), "--iterations", "5"]),
    ("5c crc32c 64K blocks", ["checksum", "--csum-alg", "crc32c",
     "--csum-block", "65536", "--size", str(64 << 20), "--iterations", "5"]),
]


def run_baseline(device: str = "cuda") -> list[dict]:
    from ceph_tpu_torch import bench_cli
    from ceph_tpu_torch.utils.device import resolve_device

    # a missing card raises here, not as one error row per config
    resolve_device(device)

    results = []
    for name, argv in BASELINE_CONFIGS:
        try:
            elapsed, total_kib = bench_cli.run(
                bench_cli.parse_args(argv + ["--device", device])
            )
        except (ValueError, RuntimeError) as e:
            row = {"config": name, "error": str(e)}
        else:
            gbps = total_kib * 1024 / max(elapsed, 1e-9) / 1e9
            row = {
                "config": name,
                "seconds": round(elapsed, 6),
                "KiB": int(total_kib),
                "GBps": round(gbps, 3),
            }
        results.append(row)
        print(json.dumps(row), flush=True)
    return results


def sweep(args) -> list[dict]:
    from ceph_tpu_torch import bench_cli
    from ceph_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)

    results = []
    for plugin in args.plugins:
        for k in args.k:
            for m in args.m:
                for workload in args.workloads:
                    argv = [
                        workload, "--plugin", plugin,
                        "-P", f"k={k}", "-P", f"m={m}",
                        "--size", str(args.size),
                        "--iterations", str(args.iterations),
                        "--batch", str(args.batch),
                        "--erasures", str(args.erasures),
                        "--device", args.device,
                    ]
                    if plugin == "jerasure":
                        argv += ["-P", "technique=reed_sol_van"]
                    try:
                        elapsed, total_kib = bench_cli.run(
                            bench_cli.parse_args(argv)
                        )
                    except (ValueError, RuntimeError) as e:
                        results.append({
                            "plugin": plugin, "k": k, "m": m,
                            "workload": workload, "error": str(e),
                        })
                        continue
                    gbps = total_kib * 1024 / max(elapsed, 1e-9) / 1e9
                    row = {
                        "plugin": plugin, "k": k, "m": m,
                        "workload": workload,
                        "seconds": round(elapsed, 6),
                        "KiB": int(total_kib),
                        "GBps": round(gbps, 3),
                    }
                    results.append(row)
                    print(json.dumps(row), flush=True)
    return results


_HTML = """<!doctype html><meta charset="utf-8">
<title>ceph_tpu EC bench sweep</title>
<style>
 body {{ font: 14px system-ui; margin: 2em; }}
 .bar {{ height: 18px; background: #4a79a4; margin: 2px 0; }}
 .row {{ display: grid; grid-template-columns: 22em 1fr 7em;
         gap: .75em; align-items: center; }}
 .lbl {{ text-align: right; color: #333; }}
 .val {{ color: #555; }}
</style>
<h1>EC throughput sweep</h1>
<div id="chart"></div>
<script>
const data = {data};
const max = Math.max(...data.filter(d => d.GBps).map(d => d.GBps));
const el = document.getElementById("chart");
for (const d of data) {{
  const row = document.createElement("div");
  row.className = "row";
  const label = d.config ??
    `${{d.plugin}} k=${{d.k}} m=${{d.m}} ${{d.workload}}`;
  if (d.error) {{
    row.innerHTML = `<div class="lbl">${{label}}</div>` +
      `<div></div><div class="val">error</div>`;
  }} else {{
    const w = (100 * d.GBps / max).toFixed(1);
    row.innerHTML = `<div class="lbl">${{label}}</div>` +
      `<div><div class="bar" style="width:${{w}}%"></div></div>` +
      `<div class="val">${{d.GBps}} GB/s</div>`;
  }}
  el.appendChild(row);
}}
</script>
"""


def write_html(path: str, results: list[dict]) -> None:
    with open(path, "w") as f:
        f.write(_HTML.format(data=json.dumps(results)))


def main(argv=None) -> int:
    args = parse_args(argv)
    results = run_baseline(args.device) if args.baseline else sweep(args)
    if args.html:
        write_html(args.html, results)
        print(f"wrote {args.html}", file=sys.stderr)
    return 0 if all("error" not in r for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
