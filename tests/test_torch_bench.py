"""The port's flagship benchmark (``ceph_tpu_torch.bench``) against the
JAX package's ``bench.py``, on the CPU at small sizes.

- The feedback loop: over the plain Kernel A form, the port's loop ends
  with the same uint8 accumulator as the JAX bench's jitted
  ``_feedback_loop(..., opaque=True)`` over ``ceph_tpu``'s bit-plane
  encode, for the same seeded input.
- Kernel K10's plain form (the roofline copy) is ``x ^ 1`` over any
  shape, and the roofline loop over it is the JAX bench's loop body.
- The host rows (the schedule optimizer's XOR counts, the CLAY helper
  read fractions, the LRC repair's survivor count) equal what
  ``ceph_tpu`` computes.
- A ``--device cpu`` run of ``main()`` emits the JAX bench's key set:
  every key of ``BENCH_r05.json``'s record and every key that root
  ``bench.py``'s source writes (read from its syntax tree), less the
  three ``mxu_*`` keys that the port leaves out and the device-clock
  small-op row that only a card gives. The module's sizes are shrunk
  with ``monkeypatch``, the loop timer is a fixed function of the trip
  count (every loop still runs), and the cluster, qos and transport
  legs are fixed reports (``test_torch_loadgen.FixedLegs``), so the
  key set does not depend on timing.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import bench as ref_bench  # noqa: E402  the JAX package's bench.py

from ceph_tpu_torch import bench  # noqa: E402

MXU_KEYS = {"mxu_tops", "mxu_util_frac", "mxu_useful_util_frac"}


def _enc_bitmatrix():
    from ceph_tpu.gf import gf_matrix_to_bitmatrix, vandermonde_rs_matrix

    return gf_matrix_to_bitmatrix(vandermonde_rs_matrix(8, 4)[8:, :])


@pytest.mark.parametrize("iters", [1, 5, 17])
def test_feedback_loop_accumulator_equals_the_reference(iters):
    import jax.numpy as jnp

    from ceph_tpu.ops.bitplane import gf_encode_bitplane

    bmat = _enc_bitmatrix()
    data = np.random.default_rng(0xBE7C).integers(0, 256, (2, 8, 4096),
                                                  np.uint8)
    dev_bmat = jnp.asarray(bmat)
    ref_loop = ref_bench._feedback_loop(
        lambda d: gf_encode_bitplane(dev_bmat, d), opaque=True)
    want = int(np.asarray(ref_loop(jnp.asarray(data), iters)))
    port_loop = bench._feedback_loop(bench._kernel_apply(bmat))
    x = torch.from_numpy(data.copy())
    got = port_loop(x, iters)
    assert got.dtype == torch.uint8
    assert int(got) == want
    # every run starts from the input's bytes: the input is not patched
    assert np.array_equal(x.numpy(), data)
    assert int(port_loop(x, iters)) == want


def _plan_cases():
    """(plan factory, plain form) of Kernels A, B and C over one [3, 8,
    1024] buffer, the plain form's output as the plan's result."""
    from ceph_tpu_torch.checksum.crc32c import crc32c_fold_plain
    from ceph_tpu_torch.checksum.cuda_crc import crc32c_blocks_plan
    from ceph_tpu_torch.ops import cuda_encode as ce
    from ceph_tpu_torch.ops.bitplane import gf_encode_bitplane

    bm = _enc_bitmatrix()
    return {
        "gf_apply": (lambda d: ce.gf_apply_plan(bm, d),
                     lambda d: gf_encode_bitplane(bm, d)),
        "gf_apply_csum": (lambda d: ce.gf_apply_csum_plan(bm, d, 256),
                          lambda d: ce.gf_apply_csum_plain(bm, d, 256)),
        "crc32c_blocks": (
            lambda d: crc32c_blocks_plan(d.view(-1, 512), 0xFFFFFFFF),
            lambda d: crc32c_fold_plain(d.view(-1, 512), 0xFFFFFFFF)),
    }


@pytest.mark.parametrize("kind", ["gf_apply", "gf_apply_csum",
                                  "crc32c_blocks"])
def test_plans_answer_in_one_output_for_the_buffers_bytes(kind):
    """A plan returns the same tensors call after call, holding its
    plain form of the buffer's current bytes: what the bench's loops
    rely on to make their fold views once."""
    make, plain = _plan_cases()[kind]
    d = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (3, 8, 1024), np.uint8))
    plan = make(d)
    for _ in range(3):
        got = plan()
        assert got is plan.result
        want = plain(d)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
        d[0, 0, :128] ^= 0x5A


@pytest.mark.parametrize("shape", [(0,), (1,), (15,), (16,), (17,),
                                   (4096 + 3,), (3, 4099), (2, 5, 33)])
def test_roofline_copy_plain_form_is_xor_one(shape):
    from ceph_tpu_torch.ops.cuda_copy import xor1_copy, xor1_copy_plain

    x = np.random.default_rng(len(shape) * 1000 + shape[-1]).integers(
        0, 256, shape, np.uint8)
    t = torch.from_numpy(x)
    for fn in (xor1_copy, xor1_copy_plain):
        out = fn(t)
        assert out.dtype == torch.uint8 and tuple(out.shape) == shape
        assert np.array_equal(out.numpy(), x ^ 1)


def test_roofline_copy_refuses_other_dtypes_and_devices():
    from ceph_tpu_torch.ops.cuda_copy import xor1_copy

    with pytest.raises(ValueError, match="uint8"):
        xor1_copy(torch.zeros(16, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        xor1_copy(torch.empty(16, dtype=torch.uint8, device="meta"))


@pytest.mark.parametrize("iters", [1, 3, 300])
def test_roofline_loop_is_the_reference_loop(iters):
    """The port's loop over K10's plain form against a numpy model of
    the JAX bench's roofline loop body (bench.py:246-259): the copy's
    first 128 bytes of row 0, XOR (i + 1) as uint8, patch the input;
    the accumulator XORs their first byte. 300 iterations wrap i + 1."""
    from ceph_tpu_torch.ops.cuda_copy import xor1_copy

    x = np.random.default_rng(iters).integers(0, 256, (4, 512), np.uint8)
    d, acc = x.copy(), 0
    for i in range(iters):
        fold = (d ^ 1)[0, :128]
        d[0, :128] = fold ^ np.uint8((i + 1) & 0xFF)
        acc ^= int(fold[0])
    loop = bench._feedback_loop(lambda d: functools.partial(xor1_copy, d))
    got = loop(torch.from_numpy(x), iters)
    assert int(got) == acc


# -- a small --device cpu bench --------------------------------------

def _fake_timed(loop, data, iters):
    """Runs the loop, then reports a time linear in the trip count."""
    loop(data, iters).item()
    return 1e-6 + 2e-6 * iters


@pytest.fixture
def small(monkeypatch):
    """The module's sizes shrunk to a few KiB a config, the ladder cut
    to its first rung, and a fixed loop timer."""
    b = bench
    monkeypatch.setattr(b, "_timed", _fake_timed)
    monkeypatch.setattr(b, "SPAN_TARGET_S", 0.0)
    monkeypatch.setattr(b, "LADDER_START", 4)
    monkeypatch.setattr(b, "CHUNK", 8192)
    monkeypatch.setattr(b, "BATCH", 2)
    monkeypatch.setattr(b, "ROOF_ROWS", 4)
    monkeypatch.setattr(b, "ROOF_LANES", 1024)
    monkeypatch.setattr(b, "BASELINE_CONFIGS", [
        (key, gen, k, m, min(chunk, 4096), 2)
        for key, gen, k, m, chunk, _s in b.BASELINE_CONFIGS])
    monkeypatch.setattr(b, "FAMILIES", [
        (key, plugin, profile, chunk // 16 if "w" in profile else 4096, 2)
        for key, plugin, profile, chunk, _s in b.FAMILIES])
    monkeypatch.setattr(b, "LRC_REPAIR_CHUNK", 4096)
    monkeypatch.setattr(b, "LRC_REPAIR_STRIPES", 2)
    monkeypatch.setattr(b, "CLAY_STRIPES", 1)
    monkeypatch.setattr(b, "SMALLOP_CHUNK", 1024)
    monkeypatch.setattr(b, "SMALLOP_WRITERS", 4)
    monkeypatch.setattr(b, "SMALLOP_OPS", 3)
    monkeypatch.setattr(b, "RECONSTRUCT_ITERS", 5)
    monkeypatch.setattr(b, "SINGLE_CORE_ITERS", 1)
    monkeypatch.setattr(b, "LAT_CHUNK", 4096)
    monkeypatch.setattr(b, "CSUM_BYTES", 1 << 17)
    monkeypatch.setattr(b, "HOST_CSUM_SAMPLE", 1 << 15)
    return b


CPU = torch.device("cpu")


def test_sched_host_rows_equal_the_reference(small):
    from ceph_tpu.codecs.registry import registry as ref_registry
    from ceph_tpu.ops import xor_schedule as ref_xs

    result: dict = {}
    small._measure_sched_superopt(result, small.Run(CPU))
    for fam, w in (("liberation", 7), ("blaum_roth", 6), ("liber8tion", 8)):
        codec = ref_registry.factory("jerasure", {
            "technique": fam, "k": "4", "m": "2", "w": str(w)})
        st = ref_xs.cse_stats(codec.coding_bitmatrix)
        assert result[f"{fam}_sched_raw_xors"] == st["raw_xors"]
        assert result[f"{fam}_sched_opt_xors"] == st["opt_xors"]
        assert result[f"{fam}_sched_cse_saving"] == st["saving_frac"]
    lrc = ref_registry.factory(
        "lrc", {"k": "4", "m": "2", "l": "3", "local_parity": "xor"})
    plan = lrc.minimum_to_decode({0}, set(range(lrc.k + lrc.m)) - {0})
    assert result["lrc_local_repair_survivors"] == len(plan) == 3


def test_clay_read_fractions_equal_the_reference(small):
    """The helper-read fraction of each CLAY geometry's repair, from
    ``ceph_tpu``'s plan as bench.py:660-721 computes it (64 KiB chunks
    a data shard, a parity chunk lost)."""
    from ceph_tpu.codecs.registry import registry as ref_registry

    result = {"decode1_gbps": 1.0}
    small._measure_clay_repair(result, small.Run(CPU))
    for key, profile in _ref_clay_geometries():
        codec = ref_registry.factory("clay", profile)
        k, m = codec.k, codec.m
        chunk = codec.get_chunk_size(k << 16)
        sc = chunk // codec.get_sub_chunk_count()
        lost = k + 1
        plan = codec.minimum_to_decode({lost}, set(range(k + m)) - {lost})
        read = sum(cnt for ranges in plan.values() for _i, cnt in ranges) * sc
        assert result[f"{key}_read_frac"] == round(read / (k * chunk), 3)
        assert f"{key}_time_vs_naive" in result


def _ref_clay_geometries():
    """The JAX bench's CLAY geometries, read from its source."""
    fn = _ref_functions()["_measure_clay_repair"]
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "geometries"
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("no geometries in bench.py's _measure_clay_repair")


# -- the key set, from the JAX bench's own source -----------------------

def _ref_functions() -> dict:
    tree = ast.parse((ROOT / "bench.py").read_text())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _loop_bindings(fn) -> dict[str, set[str]]:
    """name -> the string values a ``for`` loop of ``fn`` binds it to,
    over a literal sequence or a name assigned one in ``fn``."""
    literals = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(
                node.value, (ast.List, ast.Tuple)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    literals[t.id] = node.value
    out: dict[str, set[str]] = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.For):
            continue
        seq = node.iter
        if isinstance(seq, ast.Name):
            seq = literals.get(seq.id)
        if not isinstance(seq, (ast.List, ast.Tuple)):
            continue
        targets = (node.target.elts if isinstance(node.target, ast.Tuple)
                   else [node.target])
        for elt in seq.elts:
            vals = elt.elts if isinstance(elt, ast.Tuple) else [elt]
            for t, v in zip(targets, vals):
                if isinstance(t, ast.Name) and isinstance(
                        v, ast.Constant) and isinstance(v.value, str):
                    out.setdefault(t.id, set()).add(v.value)
    return out


def _key_values(node, bindings) -> set[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, ast.Name):
        return bindings[node.id]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return {a + b for a in _key_values(node.left, bindings)
                for b in _key_values(node.right, bindings)}
    if isinstance(node, ast.JoinedStr):
        out = {""}
        for part in node.values:
            vals = (_key_values(part.value, bindings)
                    if isinstance(part, ast.FormattedValue)
                    else _key_values(part, bindings))
            out = {a + b for a in out for b in vals}
        return out
    raise AssertionError(f"bench.py line {node.lineno}: a result key the "
                         f"test cannot read: {ast.dump(node)}")


def _ref_source_keys() -> set[str]:
    """Every key a ``result[...] = `` of root bench.py writes."""
    keys: set[str] = set()
    for fn in _ref_functions().values():
        bindings = _loop_bindings(fn)
        for node in ast.walk(fn):
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Store)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "result"):
                keys |= _key_values(node.slice, bindings)
    return keys


def _fix_legs(monkeypatch, module):
    from test_torch_loadgen import FixedLegs

    legs = FixedLegs()
    for name in ("_leg", "qos_leg", "transport_leg"):
        monkeypatch.setattr(module, name, legs.leg)
    monkeypatch.setattr(module, "hol_probe_ms", legs.hol)


def _ref_phase_keys(monkeypatch) -> set[str]:
    """The keys of the JAX package's cluster, qos and transport phases
    with their legs fixed, less the chip legs above one that it runs
    for JAX's further CPU devices."""
    from ceph_tpu.loadgen import bench_phase as ref_phase

    _fix_legs(monkeypatch, ref_phase)
    out: dict = {}
    ref_phase.measure_cluster(out, 12.5)
    ref_phase.measure_qos(out)
    ref_phase.measure_transport(out, 12.5)
    return {k for k in out if not (k.startswith("cluster_scale_chips")
                                   and not k.startswith(
                                       "cluster_scale_chips1_"))}


def test_reference_source_keys_cover_bench_r05():
    """The source reading finds every key of the recorded run."""
    r05 = set(json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"])
    headline = {"metric", "value", "unit", "vs_baseline"}
    assert r05 - headline <= _ref_source_keys()


def test_cpu_run_emits_the_reference_key_set(small, monkeypatch):
    from ceph_tpu_torch.loadgen import bench_phase

    _fix_legs(monkeypatch, bench_phase)
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        assert bench.main(["--device", "cpu"]) == 0
    lines = stdout.getvalue().strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])

    r05 = set(json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"])
    want = (r05 | _ref_source_keys() | _ref_phase_keys(monkeypatch)
            | {"metric", "value", "unit", "vs_baseline"})
    # the device-clock small-op row needs a card; without it the JAX
    # bench writes latency_degraded, as the port does
    want -= MXU_KEYS | {"smallop_p99_device_ms"}
    assert set(got) == want
    assert not MXU_KEYS & set(got)
    assert got["latency_degraded"] in (True, False)
    assert got["metric"] == "EC(8,4) reed_sol_van batched stripe encode"
    assert got["unit"] == "GB/s data-in per chip"
    assert got["vs_baseline"] == pytest.approx(got["value"] / 25.0, abs=1e-3)
    for key in ("hbm_copy_gbps", "value", "decode_gbps", "crc32c_gbps",
                "fused_write_path_gbps", "clay_repair_gbps"):
        assert got[key] > 0, key
