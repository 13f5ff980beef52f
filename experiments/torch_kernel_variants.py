"""Design variants of Kernels D and B on one CUDA card, beside the kernels
of an older tree, with Kernels A and C in the same run.

Builds ``ceph_tpu_torch/csrc/xor_schedule.cu`` (Kernel D) and
``csrc/gf_apply.cu`` (Kernels A and B) with the design flags of
``D_DESIGNS`` and ``B_DESIGNS``, ``csrc/crc32c.cu`` (Kernel C) as it
stands, and, with ``--parent DIR``, the same three sources found in DIR
(an unpacked older tree's ``ceph_tpu_torch/csrc``, called with that
tree's conventions: Kernel D's program without a packet header, Kernel
B's sub-tile shift tree). Two of B's builds are diagnostic, timing-only:
one compiles the hash out, one the products, to say which phase holds
the fused kernel. Every other build is held byte for byte against the
plain forms at each shape, then all are timed there: the kernel's
device time per launch (torch.profiler, 20 launches after a warm-up;
also CUDA events around 20 wrapper calls), in turns (parent, variants,
variants in reverse, parent), since two builds compare only inside one
run. The yardstick of the fused kernel, Kernel A then Kernel C over the
same bytes (``unfused``), is timed in the same turns.

Shapes: D at the liberation k=6 m=2 w=7 encode, [16, 42, 147,456] ->
14 packets (stacked and per-shard), its decode of lost {1, 4}, and the
LRC local repair, 3 x [16, 1 MiB] -> 1 (w = 1); B, A and C at EC(8,4),
[8, 8, 1 MiB] with 4 KiB windows (C over the 96 MiB of all 12 rows, and
in 64 KiB blocks). Prints one line per build and shape and writes
``chiprun_out/torch_kernel_variants.json``. Imports nothing of JAX or
ceph_tpu.

Usage: python3 experiments/torch_kernel_variants.py [--parent DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
MIB = 1 << 20
LIB_P, LIB_STRIPES = 147456, 16
#: Kernel D builds: name -> (-D flags, host knobs of ops/cuda_xor.py)
D_DESIGNS = {
    "D staged": ([], {}),
    "D staged, every program in shared memory": ([], {"SHORT_PROG": 0}),
    "D direct vec=2 batch=4": ([], {"stage": False}),
    "D direct vec=1 batch=4": (["-DXOR_VEC=1"], {"stage": False, "VEC": 1}),
}
#: Kernel B builds: name -> (-D flags, host knobs of ops/cuda_encode.py);
#: the "diagnostic" ones are timed only
B_DESIGNS = {
    "B": ([], {}),
    "B ilp=1": (["-DGF_CSUM_ILP=1"], {}),
    "B 512 threads, 8 B units": (
        ["-DGF_CSUM_THREADS=512", "-DGF_CSUM_UNIT=8"], {"CSUM_WARPS": 16}),
    "B unpadded": (["-DGF_CSUM_PAD=0"], {"CSUM_PAD": 0}),
    "B diagnostic: no hash": (["-DGF_CSUM_NO_HASH"], {}),
    "B diagnostic: no products": (["-DGF_CSUM_NO_PRODUCTS"], {}),
}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the build whose Kernel A is timed beside the parent's
A_BUILD = "B"
#: the older tree's entry points (for --parent)
PARENT_ARGTYPES = {
    "xor_schedule": [_P, _P, _I, _I, _P, _P, _I, _I, _P, _I, _I, _L, _L, _P],
    "gf_apply_csum": [_P, _P, _I, _P, _P, _I, _P, _L, _L, _P, _L, _I, _P, _P],
}


def build(src: Path, out: Path, defines: list[str]):
    """Start nvcc on one source with extra -D flags; returns the process."""
    from ceph_tpu_torch import kernels

    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *defines, "-o", str(out),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def load(so: Path, like, argtypes=None):
    """A Kernel with ``like``'s entry point, bound to the library ``so``."""
    from ceph_tpu_torch import kernels

    argtypes = argtypes or like.argtypes
    kern = kernels.Kernel(like.source, like.symbol, argtypes)
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, like.symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    err = getattr(lib, f"{like.source}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    kern._fn, kern._err = fn, err
    return kern


def sass_histogram(name: str, so: Path) -> None:
    """Static instruction counts by opcode of every kernel in ``so``
    (cuobjdump -sass), the twelve most frequent per kernel."""
    import collections
    import re

    from ceph_tpu_torch import kernels

    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    for block in text.split("Function : ")[1:]:
        fn = block.split("\n", 1)[0].strip()
        ops = collections.Counter(
            m.group(1).split(".")[0]
            for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                                 block))
        print(f"sass {name} {fn}: {sum(ops.values())} instructions; "
              + ", ".join(f"{op} {n}" for op, n in ops.most_common(12)))


def parent_program(sched) -> tuple[np.ndarray, int]:
    """The older tree's Kernel D program: per op kind, destination,
    source count, sources (s >= 0 input packet s, s < 0 slot -1 - s)."""
    from ceph_tpu_torch.ops import xor_schedule as xs

    if isinstance(sched, xs.Schedule):
        ops, n_slots = xs._linearize(sched)
        if n_slots > 232448 // (32 * 16):
            return parent_program(xs.flatten_schedule(sched))
    else:
        ops = tuple(("o", q, tuple((0, j) for j in row))
                    for q, row in enumerate(sched))
        n_slots = 0
    words: list[int] = []
    for kind, dst, srcs in ops:
        words += [0 if kind == "t" else 1, dst, len(srcs)]
        words += [i if k == 0 else -1 - i for k, i in srcs]
    return np.asarray(words, dtype=np.int32), n_slots


def parent_csum_tile(c: int, r: int, cb: int) -> int:
    t = min(cb, 4096)
    while t > 256 and (c + r) * (t + 512) > 64 * 1024:
        t //= 2
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an older tree's ceph_tpu_torch/csrc")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sass", action="store_true",
                    help="print each default build's kernels' instruction "
                    "counts by opcode (cuobjdump -sass)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from ceph_tpu_torch import kernels
    from ceph_tpu_torch.checksum.crc32c import crc32c_fold_plain, shift_columns
    from ceph_tpu_torch.checksum.cuda_crc import crc32c_blocks
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.gf import gf_matrix_to_bitmatrix, isa_rs_matrix
    from ceph_tpu_torch.ops import cuda_encode as ce
    from ceph_tpu_torch.ops import cuda_xor
    from ceph_tpu_torch.ops import xor_schedule as xs
    from ceph_tpu_torch.ops.bitplane import gf_encode_bitplane

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    csrc = ROOT / "ceph_tpu_torch" / "csrc"
    out_dir = ROOT / "ceph_tpu_torch" / "_build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}  # name -> (kind, so, process, knobs)
    for i, (name, (defines, knobs)) in enumerate(D_DESIGNS.items()):
        so = out_dir / f"xor_schedule_{i}.so"
        jobs[name] = ("D", so, build(csrc / "xor_schedule.cu", so, defines),
                      knobs)
    for i, (name, (defines, knobs)) in enumerate(B_DESIGNS.items()):
        so = out_dir / f"gf_apply_{i}.so"
        jobs[name] = ("B", so, build(csrc / "gf_apply.cu", so, defines),
                      knobs)
    so = out_dir / "crc32c.so"
    jobs["C"] = ("C", so, build(csrc / "crc32c.cu", so, []), {})
    if args.parent:
        for kind, src in (("D", "xor_schedule.cu"), ("B", "gf_apply.cu"),
                          ("C", "crc32c.cu")):
            so = out_dir / f"parent_{Path(src).stem}.so"
            jobs[f"{kind} parent"] = (kind + "p", so,
                                      build(args.parent / src, so, []), {})
    t0 = time.perf_counter()
    regs = {}
    for name, (_, _, proc, _) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs[name] = [ln.split("Used")[-1].strip() for ln in log.splitlines()
                      if "registers" in ln]
    print(f"built {len(jobs)} variants in {time.perf_counter() - t0:.1f} s")
    if args.sass:
        for name in ("D staged", "B", "C"):
            sass_histogram(name, jobs[name][1])

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    bw = cs.H100_BYTES_PER_S

    # -- Kernel D's shapes ---------------------------------------------
    lib = registry.factory("jerasure", {"technique": "liberation", "k": "6",
                                        "m": "2", "w": "7"}, device="cuda")
    enc_s = xs.routable_schedule(lib.coding_bitmatrix)
    dec_s = xs.routable_schedule(lib._build_decode_bitmatrix(
        [0, 2, 3, 5, 6, 7], [1, 4]))
    lrc_s = xs.optimize_schedule(np.ones((1, 3), np.uint8))
    packets = cs.rand_on(rng, dev, (LIB_STRIPES, 42, LIB_P))
    shards = [packets[:, 7 * i:7 * i + 7].reshape(LIB_STRIPES, 7 * LIB_P)
              .contiguous() for i in range(6)]
    group = [cs.rand_on(rng, dev, (16, MIB)) for _ in range(3)]
    d_shapes = {  # shape -> (schedule, inputs, w (None: stacked), bytes)
        "liberation encode [16, 42, 147456] -> 14, stacked": (
            enc_s, packets, None, 56 * LIB_P * LIB_STRIPES),
        "liberation encode, per-shard": (
            enc_s, shards, 7, 56 * LIB_P * LIB_STRIPES),
        "liberation decode {1, 4}, stacked": (
            dec_s, packets, None, 56 * LIB_P * LIB_STRIPES),
        "LRC local repair 3 x [16, 1 MiB] -> 1": (
            lrc_s, group, 1, 4 * 16 * MIB),
    }

    def d_plain(sched, ins, w):
        if w is None:
            return xs.xor_schedule_plain(sched, ins)
        return torch.stack(xs.xor_schedule_plain_shards(sched, ins, w), 1)

    def d_new(kern, knobs, sched, ins, w):
        kernels.XOR_SCHEDULE = kern
        for key, val in d_defaults.items():
            setattr(cuda_xor, key, knobs.get(key, val))
        cuda_xor.launch_plan = functools.partial(
            plan_default, stage=knobs.get("stage", True))
        if w is None:
            return cuda_xor.xor_schedule_apply(sched, ins)
        return torch.stack(cuda_xor.xor_schedule_apply_shards(sched, ins, w), 1)

    @functools.lru_cache(maxsize=None)
    def parent_prog(sched):
        words, n_slots = parent_program(sched)
        return torch.from_numpy(words).to(dev), n_slots

    def d_parent(kern, _, sched, ins, w):
        prog, n_slots = parent_prog(sched)
        rows = xs._n_rows(sched)
        if w is None:
            b, kw, p = ins.shape
            out = torch.empty((b, rows, p), dtype=torch.uint8, device=dev)
            ins_l, in_w, outs, out_w = [ins.view(b, -1)], kw, [
                out.view(b, -1)], rows
        else:
            b, p = ins[0].shape[0], ins[0].shape[1] // w
            outs = [torch.empty((b, w * p), dtype=torch.uint8, device=dev)
                    for _ in range(rows // w)]
            ins_l, in_w, out_w = ins, w, w
        ip, ist = ce._ptr_rows(ins_l)
        op, ost = ce._ptr_rows(outs)
        kern(ip.ctypes.data, ist.ctypes.data, len(ins_l), in_w, op.ctypes.data,
             ost.ctypes.data, len(outs), out_w, prog.data_ptr(), prog.numel(),
             n_slots, b, p)
        return out if w is None else torch.stack(outs, 1)

    d_defaults = {key: getattr(cuda_xor, key)
                  for key in ("STAGE_THREADS", "SHORT_PROG", "VEC")}
    plan_default = cuda_xor.launch_plan

    # -- Kernels B, A and C at EC(8,4) ---------------------------------
    gen = isa_rs_matrix(8, 4)
    enc = gf_matrix_to_bitmatrix(gen[8:])
    main_in = cs.rand_on(rng, dev, (8, 8, MIB))
    main_shards = [main_in[:, i].contiguous() for i in range(8)]
    want_b = ce.gf_apply_csum_plain(enc, main_in, 4096)
    rows12 = torch.cat([main_in, want_b[0]], 1).reshape(-1, 4096)
    want_c = crc32c_fold_plain(rows12, 0)
    crc64 = rows12.view(-1, 65536)
    want_c64 = crc32c_fold_plain(crc64, 0)
    b_bytes = 12 * 8 * MIB + 4 * rows12.shape[0]
    b_defaults = {key: getattr(ce, key) for key in (
        "CSUM_TABLE_BYTES", "CSUM_TILE_MAX", "CSUM_WARPS", "CSUM_PAD")}

    def b_new(kern, knobs, form):
        kernels.GF_APPLY_CSUM = kern
        for key, val in b_defaults.items():
            setattr(ce, key, knobs.get(key, val))
        if form == "stacked":
            p, c = ce.gf_apply_csum(enc, main_in, 4096)
            return p, c
        p, c = ce.gf_apply_csum_shards(enc, main_shards, 4096)
        return torch.stack(p, 1), c

    def b_parent(kern, _, form):
        coef = ce.bitmatrix_coefficients(enc)
        tile = parent_csum_tile(8, 4, 4096)
        seg = tile // 32
        mats = np.ascontiguousarray(np.stack(
            [shift_columns(seg << lvl) for lvl in range(5)]
            + [shift_columns(tile)]))
        ins = ([main_in[:, i] for i in range(8)] if form == "stacked"
               else main_shards)
        par = torch.empty((8, 4, MIB), dtype=torch.uint8, device=dev)
        csums = torch.empty((8, 12, MIB // 4096), dtype=torch.int32,
                            device=dev)
        ip, ist = ce._ptr_rows(ins)
        op, ost = ce._ptr_rows([par[:, j] for j in range(4)])
        cf = np.ascontiguousarray(coef)
        kern(ip.ctypes.data, ist.ctypes.data, 8, op.ctypes.data,
             ost.ctypes.data, 4, cf.ctypes.data, 8, MIB, csums.data_ptr(),
             4096, tile, mats.ctypes.data)
        return par, csums.to(torch.int64) & 0xFFFFFFFF

    cases = {}  # name -> {shape: (fn, symbol, want or None, bytes)}
    originals = (kernels.XOR_SCHEDULE, kernels.GF_APPLY, kernels.GF_APPLY_CSUM,
                 kernels.CRC32C_BLOCKS)
    for name, (kind, so, _, knobs) in jobs.items():
        if kind in ("D", "Dp"):
            kern = load(so, kernels.XOR_SCHEDULE,
                        PARENT_ARGTYPES["xor_schedule"] if kind == "Dp"
                        else None)
            run = d_parent if kind == "Dp" else d_new
            cases[name] = {
                shape: (functools.partial(run, kern, knobs, sched, ins, w),
                        "xor_schedule", d_plain(sched, ins, w), nbytes)
                for shape, (sched, ins, w, nbytes) in d_shapes.items()}
        elif kind in ("B", "Bp"):
            kern = load(so, kernels.GF_APPLY_CSUM,
                        PARENT_ARGTYPES["gf_apply_csum"] if kind == "Bp"
                        else None)
            run = b_parent if kind == "Bp" else b_new
            want = None if "diagnostic" in name else want_b
            cases[name] = {
                f"EC(8,4) [8, 8, 1 MiB], 4 KiB windows, {form}": (
                    functools.partial(run, kern, knobs, form),
                    "gf_apply_csum_kernel", want, b_bytes)
                for form in ("stacked", "per-shard")}
            if name in (A_BUILD, "B parent"):  # Kernel A in the same library
                akern = load(so, kernels.GF_APPLY)

                def a_fn(akern=akern):
                    kernels.GF_APPLY = akern
                    return ce.gf_apply(enc, main_in)

                cases["A parent" if kind == "Bp" else "A"] = {
                    "EC(8,4) encode [8, 8, 1 MiB] -> 4": (
                        a_fn, "gf_apply_kernel", want_b[0], 12 * 8 * MIB)}
        else:
            kern = load(so, kernels.CRC32C_BLOCKS)

            def c_fn(data, kern=kern):
                kernels.CRC32C_BLOCKS = kern
                return crc32c_blocks(data, 0)

            cases[name] = {
                "96 MiB in 4 KiB blocks (the 12 rows of B)": (
                    functools.partial(c_fn, rows12), "crc32c_blocks_kernel",
                    want_c, 96 * MIB + 4 * rows12.shape[0]),
                "96 MiB in 64 KiB blocks": (
                    functools.partial(c_fn, crc64), "crc32c_blocks_kernel",
                    want_c64, 96 * MIB + 4 * crc64.shape[0]),
            }

    def restore():
        (kernels.XOR_SCHEDULE, kernels.GF_APPLY, kernels.GF_APPLY_CSUM,
         kernels.CRC32C_BLOCKS) = originals
        cuda_xor.launch_plan = plan_default
        for key, val in {**d_defaults}.items():
            setattr(cuda_xor, key, val)
        for key, val in b_defaults.items():
            setattr(ce, key, val)

    def same(got, want):
        if isinstance(want, tuple):
            return all(torch.equal(g, w) for g, w in zip(got, want))
        return torch.equal(got, want)

    for name, shapes in cases.items():
        for shape, (fn, _, want, _) in shapes.items():
            if want is not None:
                cs.check(same(fn(), want), f"{name} {shape} disagrees with "
                         "its plain form")
            restore()
    print("every build byte-exact against the plain forms (diagnostic "
          "builds timed only)")

    names = list(cases)
    parents = [n for n in names if n.endswith("parent")]
    others = [n for n in names if n not in parents]
    order = parents + others + others[::-1] + parents
    times: dict = {}
    for name in order:
        for shape, (fn, symbol, _, nbytes) in cases[name].items():
            row = times.setdefault(name, {}).setdefault(shape, {
                "runs_ms": [], "events_ms": [], "bound_ms": nbytes / bw * 1e3})
            try:
                row["runs_ms"].append(cs.kernel_ms(fn, 20, symbol))
            except AssertionError as e:  # a profiler session that lost its events
                print(f"  {name} {shape}: {e}")
            row["events_ms"].append(cs.time_ms(fn, 20))
            restore()
            print(f"  {name} {shape}: profiler {row['runs_ms']}, events "
                  f"{row['events_ms'][-1]:.4f} ms", flush=True)
    for name in names:
        for shape, row in times[name].items():
            row["ms"] = float(np.mean(row["runs_ms"])) if row["runs_ms"] \
                else None
            row["a_call_ms"] = float(np.mean(row["events_ms"]))
            ms = "not measured" if row["ms"] is None else f"{row['ms']:.4f}"
            print(f"{name:28s} {shape:52s} {ms} ms "
                  f"(runs {', '.join(f'{t:.4f}' for t in row['runs_ms'])}), "
                  f"a call {row['a_call_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms; registers "
                  f"{'; '.join(regs.get(name, regs.get({'A': A_BUILD, 'A parent': 'B parent'}.get(name), [])))}")
    unfused = {}
    for a_name, c_name in (("A", "C"), ("A parent", "C parent")):
        if a_name in times and c_name in times:
            a_ms = times[a_name]["EC(8,4) encode [8, 8, 1 MiB] -> 4"]["ms"]
            c_ms = times[c_name]["96 MiB in 4 KiB blocks (the 12 rows of B)"][
                "ms"]
            if a_ms is not None and c_ms is not None:
                unfused[a_name.replace("A", "A + C")] = a_ms + c_ms
                print(f"unfused yardstick {a_name} + {c_name}: "
                      f"{a_ms + c_ms:.4f} ms")
    print(smi)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_kernel_variants.json").write_text(json.dumps(
        {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
         "times": times, "unfused_ms": unfused, "registers": regs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
