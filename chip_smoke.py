#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ceph_tpu_torch``) on one card.

Drives the erasure-coded write, the degraded read and the CRC32C verify
of ISA-L ``reed_sol_van`` EC(8,4) through the package's public entry
points, at BlueStore's 4 KiB csum block:

1. set-up: the card's name and power limit; build every kernel in
   ``ceph_tpu_torch/csrc/`` (all sources in parallel) and print the time;
2. every kernel against its plain PyTorch version on the card, byte for
   byte, at the listed shapes (ragged chunk lengths included), timed at
   the shapes the main path gives it;
3. the write: ``ShardExtentMap.encode`` of 8 stripes x 8 x 1 MiB chunks
   (64 MiB data, 32 MiB parity) with fused csums and HashInfo, then the
   same through ``encode_chunks_with_csums`` / ``encode_chunks`` on
   CUDA tensors;
4. the degraded read: shards {0, 3, 9, 11} lost, rebuilt through
   ``ShardExtentMap.decode`` and ``decode_chunks`` on CUDA tensors;
5. verify: ``Checksummer("crc32c", 4096).verify`` over all 12 shards,
   clean and with one flipped byte; HashInfo from the fused csums equals
   HashInfo appended from the bytes;
6. the golden corpus entry ``tests/corpus/v0/isa/isa_k=8_m=3_technique=
   reed_sol_van`` re-encoded (and one erasure pair decoded) on the card.

Kernel launch counts and the ``ec_dispatch`` / ``checksum.backends``
counters are zeroed just before phase 3 and read just after phase 6:
every kernel must have launched, and no plain, host or fused-fallback
route may have served the path. Outputs are then checked against the
plain versions on the card and the host oracles. Any failure raises and
the script exits non-zero; so does a machine without a card, or a
directory without the package.

Usage: python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MIB = 1 << 20
K, M = 8, 4
STRIPES = 8
CHUNK = MIB
CSUM_BLOCK = 4096
LOST = (0, 3, 9, 11)
H100_BYTES_PER_S = 3.35e12  # H100 SXM data sheet (80 GB HBM3)
CORPUS = ROOT / "tests/corpus/v0/isa/isa_k=8_m=3_technique=reed_sol_van"

KERNEL_INFO = {
    "gf_apply": (
        "ceph_tpu_torch/csrc/gf_apply.cu",
        "ceph_tpu/ops/pallas_encode.py:329; ceph_tpu/ops/pallas_encode.py:434",
    ),
    "gf_apply_csum": (
        "ceph_tpu_torch/csrc/gf_apply.cu",
        "ceph_tpu/ops/pallas_encode.py:617; ceph_tpu/ops/pallas_encode.py:791",
    ),
    "crc32c_blocks": (
        "ceph_tpu_torch/csrc/crc32c.cu",
        "ceph_tpu/checksum/pallas_crc.py:141",
    ),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_err(a, b) -> int:
    import torch

    check(tuple(a.shape) == tuple(b.shape), f"shape {a.shape} != {b.shape}")
    if a.numel() == 0:
        return 0
    d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
    return int(d.item())


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class Phase:
    """CUDA-event and host-clock time of one phase of the main path."""

    results: list[dict] = []

    def __init__(self, name: str, nbytes: int) -> None:
        self.name = name
        self.nbytes = nbytes

    def __enter__(self):
        import torch

        torch.cuda.synchronize()
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.t0 = time.perf_counter()
        self.start.record()
        return self

    def __exit__(self, *exc):
        import torch

        if exc[0] is not None:
            return False
        self.end.record()
        torch.cuda.synchronize()
        ms = self.start.elapsed_time(self.end)
        wall = (time.perf_counter() - self.t0) * 1e3
        row = {
            "phase": self.name, "ms": ms, "wall_ms": wall,
            "bytes": self.nbytes, "GB_per_s": self.nbytes / ms / 1e6,
        }
        Phase.results.append(row)
        print(f"phase {self.name}: {ms:.3f} ms (events), {wall:.3f} ms "
              f"(host clock), {row['GB_per_s']:.3f} GB/s over "
              f"{self.nbytes} bytes")
        return False


def kernel_vs_plain(rng, dev) -> dict:
    """Phase 2: each kernel against its plain version on the card.
    Returns per kernel {max_abs_err, ms, plain_ms, bound_ms}."""
    import torch

    from ceph_tpu_torch.checksum.crc32c import crc32c_fold_plain
    from ceph_tpu_torch.checksum.cuda_crc import crc32c_blocks
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.gf import (
        gf_matrix_to_bitmatrix,
        isa_cauchy_matrix,
        isa_rs_matrix,
    )
    from ceph_tpu_torch.ops import cuda_encode as ce
    from ceph_tpu_torch.ops.bitplane import gf_encode_bitplane

    def rand(shape):
        return torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)
        ).to(dev)

    out = {name: {"max_abs_err": 0} for name in KERNEL_INFO}

    def note(name, err, what):
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        print(f"  {name} {what}: max_abs_err {err}")
        check(err == 0, f"{name} {what} disagrees with its plain version")

    gen = isa_rs_matrix(K, M)
    enc = gf_matrix_to_bitmatrix(gen[K:])
    present = [i for i in range(K + M) if i not in LOST]
    codec = registry.factory("isa", {"k": str(K), "m": str(M)}, device=dev)
    # Kernel A: encode, the 4-row decode of the main path, a one-column
    # delta, C in {5, 8, 10}, aligned and ragged chunk lengths, stacked
    # and per-shard forms
    cases = [
        ("encode C=8 R=4", enc, 8),
        ("decode C=8 R=4", gf_matrix_to_bitmatrix(
            codec._build_decode_bytes(present, list(LOST))), 8),
        ("delta C=1 R=4", gf_matrix_to_bitmatrix(gen[K:, [5]]), 1),
        ("cauchy C=5 R=3",
         gf_matrix_to_bitmatrix(isa_cauchy_matrix(5, 3)[5:]), 5),
        ("cauchy C=10 R=4",
         gf_matrix_to_bitmatrix(isa_cauchy_matrix(10, 4)[10:]), 10),
    ]
    for n in (CHUNK, CHUNK + 37):
        for label, bm, c in cases:
            data = rand((4, c, n))
            want = gf_encode_bitplane(bm, data)
            note("gf_apply", max_err(ce.gf_apply(bm, data), want),
                 f"{label} N={n} stacked")
            shards = [data[:, i].contiguous() for i in range(c)]
            got = torch.stack(ce.gf_apply_shards(bm, shards), dim=1)
            note("gf_apply", max_err(got, want), f"{label} N={n} shards")
            del data, want, shards, got
    # Kernel B at cb in {256, 4096, 65536}, stacked and per-shard
    main = rand((STRIPES, K, CHUNK))
    for cb in (256, CSUM_BLOCK, 65536):
        wp, wc = ce.gf_apply_csum_plain(enc, main, cb)
        gp, gc = ce.gf_apply_csum(enc, main, cb)
        note("gf_apply_csum", max(max_err(gp, wp), max_err(gc, wc)),
             f"C=8 R=4 cb={cb} stacked")
        shards = [main[:, i].contiguous() for i in range(K)]
        sp, sc = ce.gf_apply_csum_shards(enc, shards, cb)
        note("gf_apply_csum",
             max(max_err(torch.stack(sp, 1), wp), max_err(sc, wc)),
             f"C=8 R=4 cb={cb} shards")
        del wp, wc, gp, gc, shards, sp, sc
    # Kernel C at 4/16/64 KiB blocks, three inits
    for block in (4096, 16384, 65536):
        data = rand(((32 * MIB) // block, block))
        for init in (0, 0xFFFFFFFF, int(rng.integers(0, 1 << 32))):
            note("crc32c_blocks",
                 max_err(crc32c_blocks(data, init),
                         crc32c_fold_plain(data, init)),
                 f"L={block} init={init:#x}")
        del data

    # times at the shapes the main path gives each kernel
    io = (K + M) * STRIPES * CHUNK
    out["gf_apply"].update(
        ms=time_ms(lambda: ce.gf_apply(enc, main), 20),
        plain_ms=time_ms(lambda: gf_encode_bitplane(enc, main), 3),
        bound_ms=io / H100_BYTES_PER_S * 1e3,
    )
    csum_bytes = 4 * STRIPES * (K + M) * (CHUNK // CSUM_BLOCK)
    out["gf_apply_csum"].update(
        ms=time_ms(lambda: ce.gf_apply_csum(enc, main, CSUM_BLOCK), 20),
        plain_ms=time_ms(
            lambda: ce.gf_apply_csum_plain(enc, main, CSUM_BLOCK), 3
        ),
        bound_ms=(io + csum_bytes) / H100_BYTES_PER_S * 1e3,
    )
    verify = rand((io // CSUM_BLOCK, CSUM_BLOCK))
    out["crc32c_blocks"].update(
        ms=time_ms(lambda: crc32c_blocks(verify, 0xFFFFFFFF), 20),
        plain_ms=time_ms(lambda: crc32c_fold_plain(verify, 0xFFFFFFFF), 3),
        bound_ms=(io + 4 * verify.shape[0]) / H100_BYTES_PER_S * 1e3,
    )
    for name, row in out.items():
        print(f"  {name}: {row['ms']:.4f} ms kernel, {row['plain_ms']:.3f} "
              f"ms plain, bound {row['bound_ms']:.4f} ms (bytes)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "ceph_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no ceph_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    # -- 1. set-up ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    from ceph_tpu_torch import kernels

    t0 = time.perf_counter()
    logs = kernels.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s "
          "(all sources in parallel)")
    for src, (secs, log) in sorted(logs.items()):
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {src}: {secs:.1f} s; " + " | ".join(regs))

    # -- 2. every kernel against its plain version ----------------------
    print("kernel vs plain on the card:")
    rows = kernel_vs_plain(rng, dev)
    torch.cuda.empty_cache()

    # -- 3..6. the main path, counted -----------------------------------
    from ceph_tpu_torch.checksum import Checksummer, backends
    from ceph_tpu_torch.checksum.crc32c import (
        crc32c_fold_plain,
        crc32c_seed_shift,
    )
    from ceph_tpu_torch.checksum.reference import crc32c_ref
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters
    from ceph_tpu_torch.gf import (
        gf_apply_bytes_host,
        gf_matrix_to_bitmatrix,
        isa_rs_matrix,
    )
    from ceph_tpu_torch.ops.bitplane import gf_encode_bitplane
    from ceph_tpu_torch.pipeline import (
        HashInfo,
        ShardExtentMap,
        StripeInfo,
    )
    from ceph_tpu_torch.utils.device import to_numpy

    payload = rng.integers(0, 256, K * STRIPES * CHUNK, dtype=np.uint8)
    # shard r's byte stream: chunk r of every stripe, in stripe order
    streams = payload.reshape(STRIPES, K, CHUNK).transpose(1, 0, 2)
    streams = np.ascontiguousarray(streams).reshape(K, STRIPES * CHUNK)
    sinfo = StripeInfo(K, M, K * CHUNK)
    shard_bytes = STRIPES * CHUNK
    data_bytes = K * shard_bytes

    for kern in kernels.ALL:
        kern.launches = 0
    dispatch_counters().reset()
    backends.reset()

    codec = registry.factory(
        "isa", {"k": str(K), "m": str(M), "technique": "reed_sol_van"},
        device="cuda",
    )
    smap = ShardExtentMap(sinfo)
    for r in range(K):
        smap.insert(r, 0, streams[r])
    hinfo = HashInfo(K + M, device="cuda")
    with Phase("write_host_staged", data_bytes):
        smap.encode(codec, hinfo, csum_block=CSUM_BLOCK)
    stored = {s: smap.get(s, 0, shard_bytes) for s in range(K + M)}
    fused = smap.csums

    dev_data = torch.from_numpy(
        payload.reshape(STRIPES, K, CHUNK).transpose(1, 0, 2).copy()
    ).to(dev)  # [K, STRIPES, CHUNK]: shard i is dev_data[i]
    with Phase("write_device_resident", data_bytes):
        par_c, csums_dev = codec.encode_chunks_with_csums(
            {i: dev_data[i] for i in range(K)}, CSUM_BLOCK
        )
        par_p = codec.encode_chunks({i: dev_data[i] for i in range(K)})
        par_c = {j: to_numpy(v) for j, v in par_c.items()}
        par_p = {j: to_numpy(v) for j, v in par_p.items()}

    survivors = ShardExtentMap(sinfo)
    for s in range(K + M):
        if s not in LOST:
            survivors.insert(s, 0, stored[s])
    with Phase("degraded_read_host_staged", K * shard_bytes):
        survivors.decode(codec, set(LOST), K * shard_bytes)
    rebuilt = {s: survivors.get(s, 0, shard_bytes) for s in LOST}

    chunks_dev = {
        s: torch.from_numpy(stored[s].reshape(STRIPES, CHUNK)).to(dev)
        for s in range(K + M) if s not in LOST
    }
    with Phase("degraded_read_device_resident", K * shard_bytes):
        rebuilt_dev = codec.decode_chunks(set(LOST), chunks_dev)
        rebuilt_dev = {s: to_numpy(rebuilt_dev[s]) for s in LOST}

    seed_xor = crc32c_seed_shift(CSUM_BLOCK, 0xFFFFFFFF)
    all_shards = np.concatenate([stored[s] for s in range(K + M)])
    blob_csums = np.concatenate(
        [fused["shards"][s][1] for s in range(K + M)]
    ) ^ np.uint32(seed_xor)
    summer = Checksummer("crc32c", CSUM_BLOCK, device="cuda")
    flip_at = 5 * shard_bytes + 123457
    corrupt = all_shards.copy()
    corrupt[flip_at] ^= 0x5A
    hinfo_bytes = HashInfo(K + M, device="cuda")
    with Phase("verify", 2 * all_shards.nbytes + all_shards.nbytes):
        clean = summer.verify(all_shards, blob_csums)
        dirty = summer.verify(corrupt, blob_csums)
        hinfo_bytes.append(0, stored)

    meta = json.loads((CORPUS / "profile.json").read_text())
    corpus_payload = (CORPUS / "payload.bin").read_bytes()
    corpus_codec = registry.factory(
        meta["plugin"], meta["profile"], device="cuda"
    )
    want_chunks = {
        i: (CORPUS / f"chunk.{i}").read_bytes()
        for i in range(corpus_codec.get_chunk_count())
    }
    with Phase("corpus", len(corpus_payload)):
        corpus_now = corpus_codec.encode(corpus_payload)
        corpus_dec = corpus_codec.decode(
            {1, 9}, {i: c for i, c in want_chunks.items() if i not in (1, 9)}
        )
    torch.cuda.synchronize()

    launches = {k.symbol: k.launches for k in kernels.ALL}
    dispatch = dispatch_counters().dump()
    csum_backends = backends.counts()
    print(f"main-path launches: {launches}")
    print(f"ec_dispatch: {dispatch}")
    print(f"checksum.backends: {csum_backends}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    for key, val in dispatch.items():
        if key.startswith(("plain_", "host_")) or key == "fused_fallback":
            check(val == 0, f"ec_dispatch {key} = {val}, want 0")
    check(dispatch["kernel_encode"] > 0 and dispatch["kernel_decode"] > 0
          and dispatch["fused_encode"] > 0, "kernel_* did not move")
    check(set(csum_backends) == {"kernel"},
          f"checksum backends {csum_backends}, want kernel only")

    # -- the outputs, against the plain versions and the host oracles ---
    gen = isa_rs_matrix(K, M)
    enc = gf_matrix_to_bitmatrix(gen[K:])
    stacked = torch.from_numpy(payload.reshape(STRIPES, K, CHUNK)).to(dev)
    want_par = to_numpy(gf_encode_bitplane(enc, stacked))  # [S, M, C]
    for j in range(M):
        want_stream = want_par[:, j, :].reshape(-1)
        check(np.array_equal(stored[K + j], want_stream),
              f"host-staged parity {K + j} differs from the plain apply")
        check(np.array_equal(par_c[K + j].reshape(-1), want_stream),
              f"fused device parity {K + j} differs")
        check(np.array_equal(par_p[K + j].reshape(-1), want_stream),
              f"device parity {K + j} differs")
    cols = slice(0, 4096)  # host GF tables on a column slice, no torch
    host_par = gf_apply_bytes_host(
        gen[K:], payload.reshape(STRIPES, K, CHUNK)[..., cols]
    )
    check(np.array_equal(host_par, want_par[..., cols]),
          "plain apply differs from the host GF tables")
    full = torch.from_numpy(
        np.stack([stored[s] for s in range(K + M)])
    ).to(dev)
    want_cs = to_numpy(crc32c_fold_plain(
        full.reshape(-1, CSUM_BLOCK), 0
    )).astype(np.uint32).reshape(K + M, STRIPES, CHUNK // CSUM_BLOCK)
    for s in range(K + M):
        check(np.array_equal(fused["shards"][s][1], want_cs[s].reshape(-1)),
              f"fused csums of shard {s} differ from the plain fold")
        check(np.array_equal(csums_dev[:, s, :], want_cs[s]),
              f"device fused csums of shard {s} differ")
    for s, q in ((0, 0), (9, 77), (11, 2047)):
        blk = stored[s][q * CSUM_BLOCK : (q + 1) * CSUM_BLOCK].tobytes()
        check(int(fused["shards"][s][1][q]) == crc32c_ref(0, blk),
              f"csum of shard {s} block {q} differs from the bitwise oracle")
    for s in LOST:
        check(np.array_equal(rebuilt[s], stored[s]),
              f"ShardExtentMap.decode rebuilt shard {s} wrong")
        check(np.array_equal(rebuilt_dev[s].reshape(-1), stored[s]),
              f"decode_chunks rebuilt shard {s} wrong")
    reassembled = np.stack(
        [rebuilt[r] if r in LOST else stored[r] for r in range(K)]
    ).reshape(K, STRIPES, CHUNK).transpose(1, 0, 2).reshape(-1)
    check(np.array_equal(reassembled, payload), "degraded read != payload")
    check(clean == (-1, 0), f"clean verify returned {clean}")
    want_bad = (flip_at // CSUM_BLOCK) * CSUM_BLOCK
    check(dirty[0] == want_bad,
          f"verify of the flipped byte returned {dirty}, want {want_bad}")
    check(hinfo == hinfo_bytes,
          f"fused-seeded {hinfo} != byte-appended {hinfo_bytes}")
    for i, chunk in want_chunks.items():
        check(corpus_now[i] == chunk, f"corpus chunk {i} differs")
    for i in (1, 9):
        check(corpus_dec[i] == want_chunks[i], f"corpus decode {i} differs")
    print("outputs: parity, csums, HashInfo, rebuilt shards, verify and "
          "corpus all byte-exact")

    print(json.dumps({"phases": Phase.results}))
    kern_rows = []
    for kern in (kernels.GF_APPLY, kernels.GF_APPLY_CSUM,
                 kernels.CRC32C_BLOCKS):
        name = kern.symbol
        src, replaces = KERNEL_INFO[name]
        kern_rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rows[name]["max_abs_err"],
            "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
            "bound_ms": rows[name]["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
        })
    print(json.dumps({"kernels": kern_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
