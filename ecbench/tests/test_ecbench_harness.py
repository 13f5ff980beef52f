"""The harness is driven by data: a configuration, a mix and a
per-layer metric dropped in as new files, with new manifest entries,
run as a cell with no edit to any file that was there."""

from __future__ import annotations

import hashlib
import json

from ecbench.tests.tiny import run_tiny, tiny_copy


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in (root / "ecbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_need_no_edit(tmp_path):
    root = tiny_copy(tmp_path)
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    eb = root / "ecbench"
    (eb / "configs" / "jerasure-k3m2.json").write_text(json.dumps({
        "name": "jerasure-k3m2", "plugin": "jerasure",
        "technique": "reed_sol_van", "k": 3, "m": 2, "osds": 5,
        "pg_num": 8, "stripe_unit": 4096, "store": "memstore"}))
    (eb / "mixes" / "read-64k.json").write_text(json.dumps({
        "name": "read-64k", "objects": 8, "object_bytes": 3 * 65536,
        "prefill": True, "pick": "uniform", "depth": 4,
        "ops": [{"kind": "read", "weight": 1, "bytes": 65536,
                 "align": 65536}],
        "warmup_ops": 4, "kill_osds": [], "pool_bytes": 0}))
    (eb / "metrics" / "reads_in_window.py").write_text(
        "def read(r):\n"
        "    return sum(1 for rec in r.ops if rec.op.kind == 'read')\n")
    bench["configs"].append({
        "name": "jerasure-k3m2", "source": "https://example.org/k3m2",
        "file": "ecbench/configs/jerasure-k3m2.json", "reduced": [],
        "why": "test"})
    bench["workloads"].append({
        "name": "jerasure-k3m2.read-64k", "config": "jerasure-k3m2",
        "traffic": "read-64k", "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "reads_in_window", "unit": "ops", "better": "higher",
        "source": "host_clock", "layer": "client", "moves": "client_gbps",
        "workloads": ["jerasure-k3m2.read-64k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    e2e = run_tiny(root, "jerasure-k3m2.read-64k", seconds=1.0)
    assert e2e["correct"], e2e["limits"]
    # op_p50_ms lists its cells; the new cell reports the others
    assert set(e2e["metrics"]) == {"client_gbps", "setup_s"}
    layer = run_tiny(root, "jerasure-k3m2.read-64k", seconds=1.0,
                     trace=True)
    assert layer["correct"], layer["limits"]
    assert layer["metrics"]["reads_in_window"]["value"] > 0
    # readers that need the card's trace found nothing and stay silent
    assert "device_idle_frac" not in layer["metrics"]
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())


def test_cells_report_their_manifest_metrics():
    from ecbench.harness import ROOT, Cell

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = Cell(ROOT, bench, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.end_to_end:
            assert (ROOT / "ecbench" / "e2e" / f"{m['name']}.py").exists()
        for m in cell.per_layer:
            assert (ROOT / "ecbench" / "metrics" / f"{m['name']}.py").exists()
            assert m["moves"] in names
