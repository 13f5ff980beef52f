"""Design variants of Kernels A and C on one CUDA card, beside the kernels
of an older tree.

Builds ``ceph_tpu_torch/csrc/gf_apply.cu`` with each set of design
flags of ``A_DESIGNS`` and ``csrc/crc32c.cu`` at each (table copies,
warps, staged piece) of ``C_DESIGNS``,
and, with ``--parent DIR``, the ``gf_apply.cu`` and ``crc32c.cu`` found
in DIR (an unpacked older tree's ``ceph_tpu_torch/csrc``; its Kernel C
takes the five shuffle-tree join matrices). Every build is held
byte for byte against the plain forms at the main-path shapes, then
timed there: the kernel's device time per launch (torch.profiler, 20
launches after a warm-up; also CUDA events around 20 wrapper calls),
in turns (parent, variants, variants in reverse, parent), since two
builds compare only inside one run.

Shapes: Kernel A at EC(8,4) encode, [8, 8, 1 MiB] -> 4 rows (stacked),
and at the CLAY(8,4,d=11) repair's inner decode, 8 x [64, 131,072] -> 4
rows (per-shard); Kernel C over 96 MiB in 4 KiB and in 64 KiB blocks.
Prints one line per build and shape and writes
``chiprun_out/torch_kernel_variants.json``. Imports nothing of JAX or
ceph_tpu.

Usage: python3 experiments/torch_kernel_variants.py [--parent DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
MIB = 1 << 20
#: Kernel A builds: GF_APPLY_VEC, the 16-byte vectors per row a thread owns
A_DESIGNS = {f"A vec={v}": [f"-DGF_APPLY_VEC={v}"] for v in (1, 2, 4)}
#: Kernel C builds: (table copies, warps per block, staged bytes per lane
#: segment and pass)
C_DESIGNS = ((32, 8, 128), (16, 16, 128), (16, 16, 64), (16, 24, 64),
             (32, 12, 64))


def build(src: Path, out: Path, defines: list[str]):
    """Start nvcc on one source with extra -D flags; returns the process."""
    from ceph_tpu_torch import kernels

    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *defines, "-o", str(out),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def load(so: Path, like):
    """A Kernel with ``like``'s entry point, bound to the library ``so``."""
    from ceph_tpu_torch import kernels

    kern = kernels.Kernel(like.source, like.symbol, like.argtypes)
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, like.symbol)
    fn.argtypes, fn.restype = like.argtypes, ctypes.c_int
    err = getattr(lib, f"{like.source}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    kern._fn, kern._err = fn, err
    return kern


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an older tree's ceph_tpu_torch/csrc")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from ceph_tpu_torch import kernels
    from ceph_tpu_torch.checksum.crc32c import (
        crc32c_fold_plain,
        crc32c_seed_shift,
        shift_columns,
    )
    from ceph_tpu_torch.checksum.cuda_crc import crc32c_blocks
    from ceph_tpu_torch.gf import gf_matrix_to_bitmatrix, isa_rs_matrix
    from ceph_tpu_torch.ops import cuda_encode as ce
    from ceph_tpu_torch.ops.bitplane import gf_encode_bitplane

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    csrc = ROOT / "ceph_tpu_torch" / "csrc"
    out_dir = ROOT / "ceph_tpu_torch" / "_build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}  # name -> (kind, so, process)
    for i, (name, defines) in enumerate(A_DESIGNS.items()):
        so = out_dir / f"gf_apply_{i}.so"
        jobs[name] = ("A", so, build(csrc / "gf_apply.cu", so, defines))
    for copies, warps, piece in C_DESIGNS:
        so = out_dir / f"crc32c_c{copies}_w{warps}_p{piece}.so"
        jobs[f"C copies={copies} warps={warps} piece={piece}"] = (
            "C", so, build(csrc / "crc32c.cu", so, [
                f"-DCRC_TABLE_COPIES={copies}", f"-DCRC_WARPS={warps}",
                f"-DCRC_MAX_PIECE={piece}"]))
    if args.parent:
        for kind, src in (("A", "gf_apply.cu"), ("C", "crc32c.cu")):
            so = out_dir / f"parent_{Path(src).stem}.so"
            jobs[f"{kind} parent"] = (kind + "p", so,
                                      build(args.parent / src, so, []))
    t0 = time.perf_counter()
    regs = {}
    for name, (_, _, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs[name] = [ln.split("Used")[-1].strip() for ln in log.splitlines()
                      if "registers" in ln]
    print(f"built {len(jobs)} variants in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    gen = isa_rs_matrix(8, 4)
    enc = gf_matrix_to_bitmatrix(gen[8:])
    dec = gf_matrix_to_bitmatrix(
        rng.integers(1, 256, (4, 8), dtype=np.uint8))
    main_in = cs.rand_on(rng, dev, (8, 8, MIB))
    clay_in = [cs.rand_on(rng, dev, (64, 131072)) for _ in range(8)]
    want_enc = gf_encode_bitplane(enc, main_in)
    want_dec = gf_encode_bitplane(dec, torch.stack(clay_in, 1))
    verify = cs.rand_on(rng, dev, (96 * MIB,))
    crc_shapes = {L: verify.view(-1, L) for L in (4096, 65536)}
    want_crc = {L: crc32c_fold_plain(v, 0xFFFFFFFF)
                for L, v in crc_shapes.items()}
    bw = cs.H100_BYTES_PER_S

    def parent_crc(kern, data, init):
        nb, L = data.shape
        mats = np.ascontiguousarray(np.stack(
            [shift_columns((L // 32) << lvl) for lvl in range(5)]))
        out = torch.empty(nb, dtype=torch.int32, device=data.device)
        kern(data.data_ptr(), out.data_ptr(), nb, L,
             crc32c_seed_shift(L, init), mats.ctypes.data)
        return out.to(torch.int64) & 0xFFFFFFFF

    cases = {}  # name -> {shape: (fn, symbol)}
    for name, (kind, so, _) in jobs.items():
        if kind.startswith("A"):
            kern = load(so, kernels.GF_APPLY)

            def enc_fn(kern=kern):
                kernels.GF_APPLY = kern
                return ce.gf_apply(enc, main_in)

            def dec_fn(kern=kern):
                kernels.GF_APPLY = kern
                return torch.stack(ce.gf_apply_shards(dec, clay_in), 1)

            cases[name] = {
                "encode [8, 8, 1 MiB] -> 4": (enc_fn, "gf_apply_kernel",
                                              want_enc, 12 * 8 * MIB),
                "clay decode 8 x [64, 131072] -> 4": (
                    dec_fn, "gf_apply_kernel", want_dec, 12 * 64 * 131072),
            }
        else:
            kern = load(so, kernels.CRC32C_BLOCKS)
            cases[name] = {}
            for L, data in crc_shapes.items():
                if kind == "Cp":
                    def fn(kern=kern, data=data):
                        return parent_crc(kern, data, 0xFFFFFFFF)
                else:
                    def fn(kern=kern, data=data):
                        kernels.CRC32C_BLOCKS = kern
                        return crc32c_blocks(data, 0xFFFFFFFF)
                cases[name][f"96 MiB in {L // 1024} KiB blocks"] = (
                    fn, "crc32c_blocks_kernel", want_crc[L],
                    96 * MIB + 4 * data.shape[0])
    original = (kernels.GF_APPLY, kernels.CRC32C_BLOCKS)
    for name, shapes in cases.items():
        for shape, (fn, _, want, _) in shapes.items():
            cs.check(torch.equal(fn(), want), f"{name} {shape} disagrees "
                     "with its plain form")
    print("every build byte-exact against the plain forms")

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
            print(f"  {name} {shape}: profiler {row['runs_ms']}, events "
                  f"{row['events_ms'][-1]:.4f} ms", flush=True)
    kernels.GF_APPLY, kernels.CRC32C_BLOCKS = original
    for name in names:
        for shape, row in times[name].items():
            row["ms"] = float(np.mean(row["runs_ms"])) if row["runs_ms"] \
                else None
            row["a_call_ms"] = float(np.mean(row["events_ms"]))
            ms = "not measured" if row["ms"] is None else f"{row['ms']:.4f}"
            print(f"{name:44s} {shape:36s} {ms} ms "
                  f"(runs {', '.join(f'{t:.4f}' for t in row['runs_ms'])}), "
                  f"a call {row['a_call_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms; registers "
                  f"{'; '.join(regs[name])}")
    print(smi)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_kernel_variants.json").write_text(json.dumps(
        {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
         "times": times, "registers": regs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
