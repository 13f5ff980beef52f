#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ceph_tpu_torch``) on one card.

Drives fourteen paths through the package's public entry points, at
BlueStore's 4 KiB csum block, each counted on its own:

1. set-up: the card's name and power limit; build the native host tier
   (``ceph_tpu_torch/native/src``, ``g++``) and every kernel in
   ``ceph_tpu_torch/csrc/`` (all sources in parallel) and print the
   times;
2. every kernel against its plain PyTorch version on the card, byte for
   byte, at the listed shapes (ragged lengths included; Kernels A-D
   also at the edges of their contracts: lengths around their vectors,
   columns and passes, C and R up to 32, one or 131 CRC blocks, windows
   of 256 B to 64 KiB spanning one to 131 of a row, a schedule at the
   kernel's scratch-slot limit and one past it, rows and base pointers
   one byte off alignment), timed at the shapes the main paths give it:
   the kernel's device time per launch (torch.profiler; the ``ms`` of
   the ``{"kernels": ...}`` line), one wrapper call and the plain
   version (CUDA events); Kernel A also at the CLAY repair's
   inner-decode shape, Kernel B beside Kernel A then Kernel C over the
   same stripes (``unfused_ms``); Kernel A also as
   ``gf_mul_const_bytes`` (a 1x1 code);
3. the ISA-L path, ``reed_sol_van`` EC(8,4): the write
   (``ShardExtentMap.encode`` of 8 stripes x 8 x 1 MiB chunks with fused
   csums and HashInfo, then ``encode_chunks_with_csums`` /
   ``encode_chunks`` on CUDA tensors), the degraded read of shards
   {0, 3, 9, 11} (``ShardExtentMap.decode`` and ``decode_chunks``), the
   ``Checksummer`` verify (clean and one flipped byte) and the corpus
   entry ``tests/corpus/v0/isa/isa_k=8_m=3_technique=reed_sol_van``;
4. the XOR-schedule path, jerasure ``liberation`` k=6 m=2 w=7 over 16
   stripes of 1,032,192-byte chunks (7 packets of 147,456 bytes): the
   write (``ShardExtentMap.encode`` with HashInfo plus the blob csums,
   then ``encode_chunks`` on CUDA tensors), the degraded read of shards
   {1, 4} (both routes), the RMW of one chunk of data shard 3
   (``encode_parity_delta`` and ``apply_delta`` on CUDA tensors); LRC
   k=4 m=2 l=3 ``local_parity=xor`` over 16 stripes of 1 MiB chunks
   (encode, ``minimum_to_decode`` of one lost chunk, its local repair
   through ``decode_chunks``); and the v1 corpus entries liberation
   k=6 w=7, blaum_roth k=4 and liber8tion k=8, encoded and one
   2-erasure decode each;
5. the CLAY path, CLAY(8,4,d=11) over 64 objects of 4 MiB (Ceph's
   default object size, one stripe each): ``encode_chunks`` on CUDA
   tensors (checked against the host path on 2 objects), the
   host-staged write (``ShardExtentMap.encode`` with HashInfo), the
   fractional repair of every chunk from its d=11 helpers' 16 of 64
   sub-chunks gathered on the card, the CLAY(8,4,d=10) repair of
   chunks {0, 7, 8, 11} with one aloof helper, the degraded read of
   shard 9 through ``get_min_avail_to_read_shards`` and
   ``reconstruct_shards`` (11/32 of a naive decode's bytes), the
   decode of {0, 8}, the repair time against a naive RS(8,4) decode of
   the same chunk (``clay_repair_time_vs_naive``), and the clay corpus
   (v0 and v2): encode and repair of chunks 0 and n-1. Kernels E and F
   (phase 2) are held against their plain versions over four
   geometries x five sub-chunk sizes x two stripe counts;
6. the pipeline path, the OSD EC backend over 12 ``MemStore`` shards
   (``ShardBackend`` + ``RMWPipeline`` with a ``PGLog`` +
   ``ReadPipeline`` + ``RecoveryBackend``), ISA ``reed_sol_van``
   EC(8,4) at Ceph's default 4 KiB stripe unit, 64 objects of 4 MiB:
   the write (two 2 MiB appends each, fused csums extending HashInfo),
   the overwrites with shard 5 down (a 2 MiB full-stripe re-encode on
   16 objects, then 64 parity deltas of 4 KiB on the host GF tables,
   and again from the same state with ``ec_host_dispatch_bytes`` 0 on
   Kernel A, byte-equal), the degraded read with shards {0, 5, 9} down
   (every whole object, 64 ranges of 64 KiB), ``recover_from_log`` of
   shard 5, the rebuild of shard 9 into an empty store (bytes and attrs
   equal to the lost store's), ``be_deep_scrub`` of every object and of
   one flipped byte (found, repaired, clean), the read-back of every
   object against a numpy model; SHEC k=8 m=4 c=3 (encode, a repair
   from 4 of 11 chunks, the v0 corpus entry), CLAY k=4 m=3 over SHEC
   (encode and repair on Kernels A, E and F) and xxhash32/64 over
   64 MiB. Each phase's kernel launches, ``ec_dispatch`` and
   ``checksum.backends`` counts are held against a prediction from the
   op sizes and printed as the route split;
7. the store path, the same EC(8,4) backend over 12 ``BlockStore``
   shards (``osd.0``-``osd.11``, one preallocated device file each in a
   temporary directory), 64 objects of 4 MiB: 8 PG threads, each with
   its own ``RMWPipeline`` and ``PGLog``, append 128 KiB at a time
   (2,048 fused encode+csum ops) through the streaming dispatcher's
   native ring with ``ec_streaming_dispatch`` on, every batch one
   Kernel B launch and every blob csum adopted from the kernel (no
   host hash: the smoke counts ``BlockStore._csum`` calls); a per-op
   twin writes the same appends on one thread into fresh stores, equal
   in bytes, attrs and blob csums; then the read-back (blob csums
   verified on the host through the native crc), the degraded read of
   shards {0, 9} (Kernel A; 64 ranges on the native GF tables), the
   rebuild of shard 9 into an empty store (Kernels A and C), a reopen
   of every store from its device file, ``be_deep_scrub`` (Kernel C),
   and one byte flipped in shard 3's device file: the read raises
   ``CsumError``, the scrub raises it as ``ceph_tpu``'s does, the
   degraded read is exact, and after the object is rebuilt on shard 3
   the read-back is exact and the scrub clean. The ring's
   ``ec_stream`` counters and the native tier's calls join the route
   split.
8. the cluster path, the system's entry point: a ``Monitor`` and 12
   ``OSDDaemon``s on the card (``osd.0``-``osd.11``) over ``MemStore``s,
   one pool of the pipeline's ISA EC(8,4) profile at a 4 KiB stripe
   unit with 32 PGs (Ceph's ``osd_pool_default_pg_num``), and 16 client
   threads with a ``RadosClient`` each, over TCP on loopback: the
   ``write_full`` of 64 objects of 4 MiB with ``ec_streaming_dispatch``
   off, the same over fresh stores with it on (stores equal in bytes
   and HINFO), 64 objects of 128 KiB through the ring (one Kernel B
   launch a batch), the read-back, 64 overwrites of 4 KiB (host parity
   deltas), osd.3 and osd.7 stopped and marked down and every object
   read degraded (Kernel A or D, as the map's lost positions ask), 16
   objects rewritten while they are down, osd.3 back with its store
   (catch-up from the log) and osd.7 marked out (backfill), every
   object read with osd.10 down, the deep scrub on every primary
   (Kernel C), and one byte flipped in one OSD's ``MemStore``: the
   scrub of its PG reports it, ``scrub_all(repair=True)`` repairs it,
   and a further scrub is clean. Every read is held against a numpy
   model, every phase's routes, the ring's counters and the daemons'
   ``osd.N.coalesce`` counters against ``predict_cluster``;
9. the bench CLI path, ``ceph_tpu_torch.bench_cli.run`` in-process, the
   ``ceph_erasure_code_benchmark`` workloads at their default sizes:
   ISA EC(8,4) encode of 80 MiB a call (Kernel A), decode of every
   2-erasure pattern (66, then 100 timed; A or D by the pattern's
   matrix, every decoded chunk byte-checked by the CLI), CLAY(8,4,d=11)
   repair of 10 MiB chunks (Kernels E, A and F) and crc32c over 64 MiB
   in 4 KiB blocks (Kernel C); each workload's two columns and GB/s
   printed, its routes held to ``predict_bench``;
10. the loadgen path, ``bench_cli loadgen --preset mixed`` in-process:
   the repo's ``mixed`` preset (600 ops of 256 KiB objects over 128
   objects, queue depth 16, zipfian) on 12 OSD daemons on the card,
   jerasure ``reed_sol_van`` EC(8,4) (``LoadCluster``'s plugin) at a 4
   KiB stripe unit, 32 PGs, the most-primary OSD
   killed at op 200 and revived at op 400, the device clock and 8
   captured traces, with the host/device crossovers at 64 KiB (codec)
   and 32 KiB (checksum) so whole-object decodes and shard hashes reach
   the card; the run must be green and its cluster scrub-clean, every
   write's fused encode (alone or in a ring batch), RMW delta, decode
   and hash is held to the driver's op counts and its recorded
   decodes, and one ``Exporter`` scrape to the per-class op counts;
   prints p99 (host and device clock), GB/s and the device idle share;
11. the quorum path: a 3-rank ``MonQuorumService`` behind 12
   ``OSDDaemon``s on the card (ISA EC(8,4), 4 KiB stripe unit, 32 PGs)
   and 16 client threads: 64 objects of 4 MiB written (one Kernel B
   launch each), the leader killed after the first 32, every surviving
   rank holding every committed epoch, every object read back and then
   read degraded with one OSD down (A or D per object, as the map's
   holes and their matrices ask);
12. the tools path: the compressor registry's ``tpu_zeroelim`` and
   ``tpu_zlib`` over a 4 MiB buffer half of zero pages (the zero-block
   mask a torch reduction on the card, counted; blobs equal to the CPU
   form's, exact round trips); ``corpus.run_check`` of every shipped
   entry (v0, v1, v2) on the card with the host crossovers at 0 (byte
   and packet matrix entries held to a prediction from their matrices;
   the LRC, SHEC and CLAY entries' A/D/E/F counts reported); the
   dev-cluster CLI (``ceph_tpu_torch.cli.main``) over a state directory:
   ``vstart`` of 12 BlockStore OSDs (EC(8,4) maps one shard to an OSD),
   ``profile-set`` ISA k=8 m=4, ``pool-create``, ``put`` and ``get`` of a
   4 MiB object, ``osd-down`` of a data shard's OSD, a degraded ``get``,
   ``osd-up``, ``scrub`` and ``bench`` of 16 objects of 4 MiB, then a
   3-mon quorum directory with one ``put`` and ``get``;
   ``objectstore_tool`` list, info, export, import into a fresh
   BlockStore and fsck of the stopped OSD's store (read back equal); and
   ``bench_sweep --baseline`` (five configs, no error row);
13. the multi-device path, over logical devices on one card (its times
   are not scaling numbers): a (dp 2 x sp 4) mesh of 8 logical devices
   runs ``sharded_encode`` and ``sharded_decode`` of EC(8,4) over 8
   stripes x 8 x 1 MiB, ``ring_parity`` (against the all-reduce) and
   ``sharded_crc32c`` of a 256 MiB + 4097 B object, each byte-equal to
   single-device Kernel A or C; an RMW write and a reconstruct read
   through ``use_mesh``; ``LoadCluster(use_mesh=True, mesh_devices=8)``
   over 6 OSDs; and a DCN pair (2 hosts x 2 logical devices, gloo,
   printed) that encodes and decodes on its hosts' mesh route, takes an
   RMW write and a reconstruct read on ``dcn_*``, then loses a host and
   serves the next op on ``dcn_fallback``. Every mesh cell launches Kernel A once a dispatch
   (dp x sp launches), every CRC device Kernel C once, every DCN host
   Kernel A once a local device an op;
14. the cluster life-cycle path: a ``Monitor`` and 12 ``OSDDaemon``s on
   the card over ``MemStore``s, ISA EC(8,4), 32 PGs, 16 clients: 32
   RADOS objects of 4 MiB; a 64 MiB object through ``StripedIoCtx``'s
   default layout (16 objects of 4 MiB); a pool snapshot, half the
   objects overwritten, head and snap read, one rolled back; two
   watchers notified; the primary of the fullest PG stopped, its
   objects rewritten through the new primary, the old one revived and
   caught up; one OSD marked out and every object read while backfill
   runs under ``pg_temp``; one data and one parity shard corrupted,
   repaired by ``scrub_all(repair=True)``, a clean second scrub; the
   mgr's health and one balancer pass. Routes held to
   ``predict_lifecycle`` (Kernel B writes, A or D decodes, C hashes).

Kernel launch counts and the ``ec_dispatch`` / ``checksum.backends``
counters are zeroed just before each path and read just after it: every
kernel of the path must have launched, and no plain, host or fallback
route may have served it. Outputs are then checked against the plain
versions on the card and the host oracles. Any failure raises and the
script exits non-zero; so does a machine without a card, or a directory
without the package.

Usage: python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MIB = 1 << 20
CSUM_BLOCK = 4096
H100_BYTES_PER_S = 3.35e12  # H100 SXM data sheet (80 GB HBM3)

# the ISA-L path
K, M = 8, 4
STRIPES = 8
CHUNK = MIB
LOST = (0, 3, 9, 11)
CORPUS = ROOT / "tests/corpus/v0/isa/isa_k=8_m=3_technique=reed_sol_van"

# the XOR-schedule path
LIB_PROFILE = {"technique": "liberation", "k": "6", "m": "2", "w": "7"}
LIB_K, LIB_M, LIB_W = 6, 2, 7
LIB_STRIPES = 16
LIB_P = 147456  # 144 KiB packets
LIB_CHUNK = LIB_W * LIB_P  # 1,032,192 B: a multiple of 7 * 128 and 4 KiB
LIB_LOST = (1, 4)
LRC_PROFILE = {"k": "4", "m": "2", "l": "3", "local_parity": "xor"}
LRC_STRIPES, LRC_CHUNK = 16, MIB
LIB_CORPUS = [
    ROOT / "tests/corpus/v1/jerasure" / name for name in (
        "jerasure_k=6_m=2_technique=liberation_w=7",
        "jerasure_k=4_m=2_technique=blaum_roth",
        "jerasure_k=8_m=2_technique=liber8tion",
    )
]

# the CLAY path: 64 RADOS objects of 4 MiB (Ceph's default object size),
# one stripe each
CLAY_PROFILE = {"k": "8", "m": "4", "d": "11"}  # q=4 t=3, 64 sub-chunks
CLAY_GENERAL = {"k": "8", "m": "4", "d": "10"}  # q=3 t=4, one aloof helper
CLAY_OBJECTS = 64
OBJECT_BYTES = 4 * MIB
CLAY_LOST = 9  # the degraded read's shard and the naive comparator's
CLAY_GENERAL_LOST = (0, 7, 8, 11)
CLAY_CORPUS = [ROOT / "tests/corpus/v0/clay/clay_d=5_k=4_m=2"] + [
    ROOT / "tests/corpus/v2/clay" / name for name in (
        "clay_d=10_k=8_m=4", "clay_d=5_k=4_m=2", "clay_d=6_k=4_m=3",
        "clay_d=7_k=6_m=3",
    )
]
#: Kernels E and F against their plain versions: (profile, lost chunks)
#: x sub-chunk bytes x stripes
CLAY_KERNEL_CASES = [
    (CLAY_PROFILE, (0, 9)),
    (CLAY_GENERAL, (0, 8)),
    ({"k": "6", "m": "3", "d": "7"}, (0, 6)),  # nu = 1: virtual members
    ({"k": "8", "m": "4", "d": "9"}, (0, 11)),  # two aloof helpers
]
CLAY_KERNEL_SC = (8192, 6528, 128, 8, 1003)
CLAY_KERNEL_B = (64, 3)

# the pipeline path: the OSD EC backend over MemStore shards, ISA
# reed_sol_van EC(8,4) at Ceph's default stripe unit (4 KiB, so a 32 KiB
# stripe width), 64 RADOS objects of 4 MiB
PIPE_PROFILE = {"k": "8", "m": "4", "technique": "reed_sol_van"}
PIPE_UNIT = 4096
PIPE_OBJECTS = 64
PIPE_OBJECT_BYTES = 4 * MIB  # written as two appends of half each
PIPE_OVERWRITTEN = 16  # objects that take the overwrites
PIPE_BIG_OFF, PIPE_BIG = MIB, 2 * MIB  # a full-stripe re-encode each
PIPE_SMALL_OPS, PIPE_SMALL = 64, 4096  # parity deltas of one chunk each
PIPE_RANGES, PIPE_RANGE = 64, 64 * 1024
PIPE_LOG_SHARD = 5  # down through the overwrites, recovered from the log
#: data shards the small overwrites land on: all but the log shard (its
#: RMW read would decode)
PIPE_SMALL_SHARDS = (0, 1, 2, 3, 4, 6, 7)
PIPE_READ_DOWN = (0, 9)  # down, beside the log shard, for the reads
PIPE_WIPED = 9  # its store replaced by an empty one and rebuilt
PIPE_FLIP_SHARD = 2
SHEC_PROFILE = {"k": "8", "m": "4", "c": "3"}  # Ceph's SHEC doc example
SHEC_STRIPES, SHEC_CHUNK, SHEC_LOST = 64, 512 * 1024, 0
SHEC_CORPUS = ROOT / "tests/corpus/v0/shec/shec_c=2_k=4_m=3"
CLAY_SHEC_PROFILE = {"k": "4", "m": "3", "scalar_mds": "shec"}
CLAY_SHEC_STRIPES = 16  # of one 4 MiB object each
XXH_BYTES = 64 * MIB

# the store path: the same EC(8,4) pipeline over 12 BlockStore shards
# (osd.0-osd.11, one preallocated device file each), 64 objects of 4 MiB
# appended by 8 PG threads through the streaming dispatcher's ring
STORE_OBJECTS = 64
STORE_APPEND = 128 * 1024  # 4 full stripes: its 128 KiB fits one ring slot
STORE_THREADS = 8  # PGs, each with its own RMWPipeline and PGLog
#: per shard: 32 MiB of shard data, the KV WAL and snapshots, COW headroom
STORE_DEVICE_BYTES = 64 * MIB
STORE_READ_DOWN = (0, 9)
STORE_LOST = 9  # rebuilt into an empty store
STORE_FLIP_SHARD = 3
STORE_RANGES, STORE_RANGE = 64, 64 * 1024
STREAM_KEYS = ("ops", "batches", "batched_ops", "max_batch", "batch_faults",
               "solo_retries")

# the cluster path: a Monitor, 12 OSD daemons over MemStores, one pool of
# the pipeline's EC(8,4) profile, 16 client threads over TCP on loopback
CLUSTER_OSDS = 12
CLUSTER_PG_NUM = 32  # osd_pool_default_pg_num
CLUSTER_OBJECTS = 64
CLUSTER_CLIENTS = 16
CLUSTER_SMALL = 128 * 1024  # the ring phase's objects: one ring slot each
CLUSTER_OVERWRITES = 64
CLUSTER_DOWN = (3, 7)  # both stopped; osd.3 returns, osd.7 goes out
CLUSTER_DEGRADED_WRITES = 16  # objects rewritten while both are down
CLUSTER_THIRD = 10  # down for the read that the recovered shards serve
CLUSTER_TICK = 0.5  # s: the daemons' retry seam (peering, catch-up, backfill)

#: Kernel A, B, C and D edge cases (phase 2)
A_EDGE_N = (1, 15, 16, 17, 4095, MIB + 37)
B_EDGE_CR = (1, 12, 32)  # C and R, each pair with C + R <= 64
B_EDGE_CB = (256, 4096, 65536)
B_EDGE_WINDOWS = (1, 3, 131)  # N = cb x windows
C_EDGE_L = (1, 31, 32, 33, 512, 1000, 4096, 65536, MIB)
D_EDGE_P = (1, 15, 16, 17, 2048, LIB_P)

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
    "xor_schedule": (
        "ceph_tpu_torch/csrc/xor_schedule.cu",
        "ceph_tpu/ops/xor_schedule.py:460; ceph_tpu/ops/xor_schedule.py:640",
    ),
    "clay_uncoupled": (
        "ceph_tpu_torch/csrc/clay_repair.cu",
        "ceph_tpu/ops/clay_kernels.py:283",
    ),
    "clay_couple_scatter": (
        "ceph_tpu_torch/csrc/clay_repair.cu",
        "ceph_tpu/ops/clay_kernels.py:369",
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
    """Mean time of one call, from CUDA events around ``iters`` calls
    after one warm-up call. For a kernel shorter than its wrapper's host
    work this is the wrapper's rate, not the kernel's: see
    ``kernel_ms``."""
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


def kernel_ms(fn, iters: int, kernel: str) -> float:
    """Mean device time of one launch of the CUDA kernel whose symbol
    contains ``kernel``, from torch.profiler over ``iters`` calls after
    one warm-up: the kernel alone, without the host time of its
    wrapper.

    The wrapper's own launch count must grow by exactly ``iters`` in
    each session: one launch a call. The profiler now and then drops a
    kernel record, so a session that kept fewer than the wrapper made
    is taken again, twice at most; if none kept them all, the mean is
    over the records of the fullest session (at least half), and a line
    says so. A record the wrapper did not make fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch import kernels

    kern = max((k for k in kernels.ALL if kernel.startswith(k.symbol)),
               key=lambda k: len(k.symbol))
    fn()
    torch.cuda.synchronize()
    best = (0.0, 0)
    for _ in range(3):
        before = kern.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        launched = kern.launches - before
        check(launched == iters, f"{kern.symbol} launched {launched} times "
              f"in {iters} calls, want one a call")
        total_us, count = 0.0, 0
        for evt in prof.key_averages():
            if kernel in evt.key:
                total_us += getattr(evt, "self_device_time_total", None) or \
                    getattr(evt, "self_cuda_time_total", 0)
                count += evt.count
        check(count <= launched, f"profiler saw {count} launches of "
              f"{kernel}, its wrapper made {launched}")
        if count == launched and total_us > 0:
            return total_us / count / 1e3
        if total_us > 0 and count > best[1]:
            best = (total_us, count)
    check(2 * best[1] >= iters, f"profiler kept {best[1]} of {iters} "
          f"launches of {kernel} at best in three sessions")
    print(f"  note: the profiler kept {best[1]} of {iters} launches of "
          f"{kernel} at best in three sessions; ms is their mean")
    return best[0] / best[1] / 1e3


class Phase:
    """CUDA-event and host-clock time of one phase of a main path."""

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


class Counted:
    """One main path's counts: every kernel's launches and the
    ``ec_dispatch`` and ``checksum.backends`` counters, zeroed on entry
    and read on exit."""

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        from ceph_tpu_torch import kernels
        from ceph_tpu_torch.checksum import backends
        from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters

        for kern in kernels.ALL:
            kern.launches = 0
        dispatch_counters().reset()
        backends.reset()
        return self

    def __exit__(self, *exc):
        import torch

        from ceph_tpu_torch import kernels
        from ceph_tpu_torch.checksum import backends
        from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters

        if exc[0] is not None:
            return False
        torch.cuda.synchronize()
        self.launches = {k.symbol: k.launches for k in kernels.ALL}
        self.dispatch = dispatch_counters().dump()
        self.backends = backends.counts()
        print(f"{self.name} path launches: {self.launches}")
        print(f"{self.name} path ec_dispatch: "
              f"{ {k: v for k, v in self.dispatch.items() if v} }")
        print(f"{self.name} path checksum.backends: {self.backends}")
        return False

    def check_routes(self, kernels_used) -> None:
        """Every kernel of the path launched; no plain, host or fallback
        route served it; every checksum ran on the kernel."""
        for name in kernels_used:
            check(self.launches[name] > 0,
                  f"kernel {name} never launched on the {self.name} path")
        for key, val in self.dispatch.items():
            if key.startswith(("plain_", "host_")) or key in (
                "fused_fallback", "sched_rejected_shape"
            ):
                check(val == 0, f"{self.name} path ec_dispatch {key} = "
                      f"{val}, want 0")
        check(set(self.backends) == {"kernel"},
              f"{self.name} path checksum backends {self.backends}, want "
              "kernel only")


def rand_on(rng, dev, shape):
    import torch

    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)


def kernel_vs_plain(rng, dev) -> dict:
    """Phase 2, Kernels A-C: each against its plain version on the card.
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
        return rand_on(rng, dev, shape)

    out = {name: {"max_abs_err": 0} for name in
           ("gf_apply", "gf_apply_csum", "crc32c_blocks")}

    def note(name, err, what, quiet=False):
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        if not quiet:
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
    # Kernel A at the edges of its contract: lengths around its vectors
    # and column run, C and R up to 32, rows one byte off alignment
    edges = 0
    for n in A_EDGE_N:
        for c in (1, 12, 32):
            for r in (1, 32):
                bm = gf_matrix_to_bitmatrix(
                    rng.integers(0, 256, (r, c), dtype=np.uint8))
                for offset in (0, 1):
                    data = rand((2, c, n + offset))[..., offset:]
                    want = gf_encode_bitplane(bm, data.contiguous())
                    what = f"edge C={c} R={r} N={n} offset {offset}"
                    note("gf_apply", max_err(ce.gf_apply(bm, data), want),
                         what + " stacked", quiet=True)
                    got = torch.stack(ce.gf_apply_shards(
                        bm, [data[:, i] for i in range(c)]), dim=1)
                    note("gf_apply", max_err(got, want), what + " shards",
                         quiet=True)
                    edges += 2
                    del data, want, got
    print(f"  gf_apply edges: {edges} cases (N in {A_EDGE_N}, C in "
          "{1, 12, 32}, R in {1, 32}, offsets 0 and 1, both forms): "
          f"max_abs_err {out['gf_apply']['max_abs_err']}")
    # Kernel A as a 1x1 code: gf_mul_const_bytes, every byte times one
    # constant, against the plain bit-plane product and the host tables
    from ceph_tpu_torch.gf.tables import gf_mul_bytes, mul_bitmatrix
    from ceph_tpu_torch.ops.bitplane import gf_mul_const_bytes
    from ceph_tpu_torch.utils.device import to_numpy

    for c_val in (0, 1, 2, 0x53, 0xFF):
        for shape in ((CHUNK + 37,), (STRIPES, 3, 4095)):
            x = rand(shape)
            got = gf_mul_const_bytes(c_val, x)
            want = gf_encode_bitplane(mul_bitmatrix(c_val),
                                      x.reshape(-1, 1, shape[-1]))
            note("gf_apply", max_err(got, want.reshape(shape)),
                 f"gf_mul_const_bytes c={c_val} {shape}", quiet=True)
            check(np.array_equal(to_numpy(got),
                                 gf_mul_bytes(c_val, to_numpy(x))),
                  f"gf_mul_const_bytes c={c_val} differs from the tables")
    print("  gf_apply as gf_mul_const_bytes: 5 constants x 2 shapes: "
          f"max_abs_err {out['gf_apply']['max_abs_err']}")
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
    # Kernel B at the edges of its contract: C and R up to 32, windows
    # from 256 B to 64 KiB, one, three or 131 windows a row (steps that
    # cover several windows, or one window in several steps; items that
    # do not divide evenly over the grid), rows one byte off alignment
    # (the load path), both forms
    edges = 0
    for c in B_EDGE_CR:
        for r in B_EDGE_CR:
            bm = gf_matrix_to_bitmatrix(
                rng.integers(0, 256, (r, c), dtype=np.uint8))
            for cb in B_EDGE_CB:
                for nw in B_EDGE_WINDOWS:
                    n, b = cb * nw, (1 if cb * nw > MIB else 2)
                    for offset in (0, 1):
                        data = rand((b, c, n + offset))[..., offset:]
                        wp, wc = ce.gf_apply_csum_plain(bm, data.contiguous(),
                                                        cb)
                        what = (f"edge C={c} R={r} cb={cb} N={n} offset "
                                f"{offset}")
                        gp, gc = ce.gf_apply_csum(bm, data, cb)
                        note("gf_apply_csum",
                             max(max_err(gp, wp), max_err(gc, wc)),
                             what + " stacked", quiet=True)
                        sp, sc = ce.gf_apply_csum_shards(
                            bm, [data[:, i] for i in range(c)], cb)
                        note("gf_apply_csum",
                             max(max_err(torch.stack(sp, 1), wp),
                                 max_err(sc, wc)), what + " shards",
                             quiet=True)
                        edges += 2
                        del data, wp, wc, gp, gc, sp, sc
    print(f"  gf_apply_csum edges: {edges} cases (C, R in {B_EDGE_CR}, cb "
          f"in {B_EDGE_CB}, N = cb x {B_EDGE_WINDOWS}, offsets 0 and 1, "
          f"both forms): max_abs_err {out['gf_apply_csum']['max_abs_err']}")
    # Kernel C at 4/16/64 KiB blocks, three inits
    for block in (4096, 16384, 65536):
        data = rand(((32 * MIB) // block, block))
        for init in (0, 0xFFFFFFFF, int(rng.integers(0, 1 << 32))):
            note("crc32c_blocks",
                 max_err(crc32c_blocks(data, init),
                         crc32c_fold_plain(data, init)),
                 f"L={block} init={init:#x}")
        del data
    # Kernel C at the edges of its contract: lengths around its lane
    # segments and staged passes, 1 block or 131 (no multiple of a
    # block's warps), a base pointer one byte off
    edges = 0
    for block in C_EDGE_L:
        for nb in (1, 131):
            for offset in (0, 1):
                data = rand((nb * block + offset,))[offset:].view(nb, block)
                for init in (0, 0xFFFFFFFF, int(rng.integers(0, 1 << 32))):
                    note("crc32c_blocks",
                         max_err(crc32c_blocks(data, init),
                                 crc32c_fold_plain(data, init)),
                         f"edge L={block} blocks={nb} offset {offset} "
                         f"init={init:#x}", quiet=True)
                    edges += 1
                del data
    print(f"  crc32c_blocks edges: {edges} cases (L in {C_EDGE_L}, 1 and "
          "131 blocks, offsets 0 and 1, three inits): max_abs_err "
          f"{out['crc32c_blocks']['max_abs_err']}")

    # times at the shapes the main path gives each kernel: the kernel's
    # device time (profiler), one wrapper call (CUDA events), the plain
    # version (CUDA events)
    io = (K + M) * STRIPES * CHUNK
    csum_bytes = 4 * STRIPES * (K + M) * (CHUNK // CSUM_BLOCK)
    verify = rand((io // CSUM_BLOCK, CSUM_BLOCK))
    timed = {
        "gf_apply": (lambda: ce.gf_apply(enc, main),
                     lambda: gf_encode_bitplane(enc, main),
                     "gf_apply_kernel", io),
        "gf_apply_csum": (
            lambda: ce.gf_apply_csum(enc, main, CSUM_BLOCK),
            lambda: ce.gf_apply_csum_plain(enc, main, CSUM_BLOCK),
            "gf_apply_csum_kernel", io + csum_bytes),
        "crc32c_blocks": (
            lambda: crc32c_blocks(verify, 0xFFFFFFFF),
            lambda: crc32c_fold_plain(verify, 0xFFFFFFFF),
            "crc32c_blocks_kernel", io + 4 * verify.shape[0]),
    }
    for name, (fn, plain, symbol, nbytes) in timed.items():
        out[name].update(
            ms=kernel_ms(fn, 20, symbol), call_ms=time_ms(fn, 20),
            plain_ms=time_ms(plain, 3),
            bound_ms=nbytes / H100_BYTES_PER_S * 1e3,
        )
        row = out[name]
        print(f"  {name}: {row['ms']:.4f} ms kernel (profiler), "
              f"{row['call_ms']:.4f} ms a call (events), "
              f"{row['plain_ms']:.3f} ms plain, bound "
              f"{row['bound_ms']:.4f} ms (bytes)")
    # Kernel B's yardstick: Kernel A then Kernel C over the same stripes
    # (the 12 rows' 4 KiB windows, zero-init), device time
    rows12 = torch.cat([main, ce.gf_apply(enc, main)], 1).reshape(
        -1, CSUM_BLOCK)
    row = out["gf_apply_csum"]
    row["unfused_ms"] = out["gf_apply"]["ms"] + kernel_ms(
        lambda: crc32c_blocks(rows12, 0), 20, "crc32c_blocks_kernel")
    print(f"  gf_apply_csum {row['ms']:.4f} ms against A then C over the "
          f"same stripes (unfused_ms) {row['unfused_ms']:.4f} ms")
    del rows12
    # Kernel A at the CLAY repair's inner decode: 8 U arrays of [64,
    # 16 x 8 KiB] in, the lost row's 4 out, per-shard
    width = 16 * (OBJECT_BYTES // int(CLAY_PROFILE["k"]) // 64)
    clay_in = [rand((CLAY_OBJECTS, width)) for _ in range(8)]
    dec = cases[1][1]
    row = out["gf_apply"]
    row["clay_decode_ms"] = kernel_ms(
        lambda: ce.gf_apply_shards(dec, clay_in), 20, "gf_apply_kernel")
    row["clay_decode_bound_ms"] = (12 * CLAY_OBJECTS * width
                                   / H100_BYTES_PER_S * 1e3)
    print(f"  gf_apply at the CLAY repair's inner decode [{CLAY_OBJECTS}, "
          f"8 x {width}] -> 4 rows: {row['clay_decode_ms']:.4f} ms kernel "
          f"(profiler), bound {row['clay_decode_bound_ms']:.4f} ms (bytes)")
    return out


def xor_cases(rng):
    """(label, schedule, w, rows, cols) for Kernel D: the liberation
    k=6 w=7 encode (CSE'd and selection form), its inverted decode for
    lost {1, 4}, a one-column delta, blaum_roth k=4 w=6 and liber8tion
    k=8 encodes, the w=1 all-ones row and the LRC local-repair row, an
    empty output row, and a dense random 56x56 matrix after CSE."""
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.ops import xor_schedule as xs

    def coding(profile):
        return registry.factory(
            "jerasure", profile, device="cuda").coding_bitmatrix

    lib = registry.factory("jerasure", LIB_PROFILE, device="cuda")
    enc = lib.coding_bitmatrix
    present = [s for s in range(LIB_K + LIB_M) if s not in LIB_LOST]
    dec = lib._build_decode_bitmatrix(present, list(LIB_LOST))
    lrc = registry.factory("lrc", LRC_PROFILE, device="cuda")
    local = lrc.layers[1].codec._build_decode_bytes([1, 2, 3], [0])
    empty = enc.copy()
    empty[5] = 0
    dense = (rng.random((56, 56)) < 0.5).astype(np.uint8)
    mats = [
        ("liberation k=6 w=7 encode", enc, 7),
        ("liberation decode lost {1,4}", dec, 7),
        ("liberation delta of column 3",
         np.ascontiguousarray(enc[:, 3 * 7:4 * 7]), 7),
        ("blaum_roth k=4 w=6 encode", coding(
            {"technique": "blaum_roth", "k": "4", "m": "2", "w": "6"}), 6),
        ("liber8tion k=8 encode", coding(
            {"technique": "liber8tion", "k": "8", "m": "2"}), 8),
        ("all-ones row w=1", np.ones((1, 5), np.uint8), 1),
        ("LRC local repair row w=1", local, 1),
        ("empty output row", empty, 7),
        ("dense 56x56", dense, 8),
    ]
    cases = [(f"{label} (CSE)", xs.optimize_schedule(m), w, *m.shape)
             for label, m, w in mats]
    cases.insert(1, ("liberation k=6 w=7 encode (selection rows)",
                     xs.schedule_rows(enc), 7, *enc.shape))
    return cases


def slot_schedule(n_slots: int):
    """A Schedule whose program needs exactly ``n_slots`` scratch slots:
    intermediates t_i = packet i ^ packet i+1, all read by output 0 (so
    all live together before it), outputs 1-3 single packets; a multiple
    of 4 input packets and 4 outputs, so w = 4 gives whole shards."""
    from ceph_tpu_torch.ops import xor_schedule as xs

    n_in = -(-(n_slots + 5) // 4) * 4
    temps = tuple((i, i + 1) for i in range(n_slots))
    outputs = (tuple(n_in + t for t in range(n_slots)), (0,), (1,), (n_in - 1,))
    return xs.Schedule(n_in, temps, outputs)


def xor_edges(rng, dev) -> int:
    """Kernel D at the edges of its contract, both forms, byte for byte:
    packet lengths around its 16-byte columns and tiles (D_EDGE_P), base
    pointers one byte off (the direct form), w = 1, and a schedule at
    MAX_SLOTS scratch slots and one past it (flattened to selection
    rows). Returns the largest error."""
    import torch

    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.ops import cuda_xor
    from ceph_tpu_torch.ops import xor_schedule as xs

    enc = registry.factory("jerasure", LIB_PROFILE, device="cuda"
                           ).coding_bitmatrix
    cases = [("liberation encode", xs.optimize_schedule(enc), 7, 42, p, 4)
             for p in D_EDGE_P]
    cases += [("w=1 row", xs.optimize_schedule(np.ones((1, 5), np.uint8)),
               1, 5, p, 4) for p in (1, 17, 4096 + 16)]
    for n in (cuda_xor.MAX_SLOTS, cuda_xor.MAX_SLOTS + 1):
        sched = slot_schedule(n)
        words, slots = cuda_xor.encode_program(sched, 4, 4)
        check(slots == (n if n <= cuda_xor.MAX_SLOTS else 0),
              f"a {n}-slot schedule runs with {slots} slots")
        cases.append((f"{n} slots", sched, 4, sched.n_in, 2048, 2))
    err, count = 0, 0
    for label, sched, w, cols, p, b in cases:
        rows = xs._n_rows(sched)
        for offset in (0, 1):
            base = rand_on(rng, dev, (b * cols * p + offset,))
            packets = base[offset:].view(b, cols, p)
            want = xs.xor_schedule_plain(sched, packets)
            e1 = max_err(cuda_xor.xor_schedule_apply(sched, packets), want)
            sbase = rand_on(rng, dev, (cols // w * b * w * p + offset,))
            shards = [sbase[offset + i * b * w * p:offset + (i + 1) * b * w * p]
                      .view(b, w * p) for i in range(cols // w)]
            for i, sh in enumerate(shards):
                sh.copy_(packets[:, i * w:(i + 1) * w].reshape(b, w * p))
            got = cuda_xor.xor_schedule_apply_shards(sched, shards, w)
            e2 = max_err(torch.stack(got, 1), want.reshape(b, rows // w, w * p))
            check(e1 == 0 and e2 == 0, f"xor_schedule edge {label} P={p} "
                  f"offset {offset} disagrees with its plain version")
            err = max(err, e1, e2)
            count += 2
            del base, packets, want, sbase, shards, got
    print(f"  xor_schedule edges: {count} cases (P in {D_EDGE_P}, w = 1, "
          f"{cuda_xor.MAX_SLOTS} and {cuda_xor.MAX_SLOTS + 1} slots, offsets "
          f"0 and 1, both forms): max_abs_err {err}")
    return err


def xor_vs_plain(rng, dev) -> dict:
    """Phase 2, Kernel D: both forms against the plain version, byte for
    byte, at P = 147,456 (the main path's packet), 2,048 and a ragged
    1,003; then timed at the main path's shape."""
    import torch

    from ceph_tpu_torch.ops import cuda_xor
    from ceph_tpu_torch.ops import xor_schedule as xs

    err = 0
    for label, sched, w, rows, cols in xor_cases(rng):
        slots = (xs._linearize(sched)[1]
                 if isinstance(sched, xs.Schedule) else 0)
        for p, b in ((LIB_P, LIB_STRIPES), (2048, 8), (1003, 8)):
            packets = rand_on(rng, dev, (b, cols, p))
            want = xs.xor_schedule_plain(sched, packets)
            e1 = max_err(cuda_xor.xor_schedule_apply(sched, packets), want)
            shards = [packets[:, i * w:(i + 1) * w].reshape(b, w * p)
                      .contiguous() for i in range(cols // w)]
            got = cuda_xor.xor_schedule_apply_shards(sched, shards, w)
            e2 = max_err(torch.stack(got, 1),
                         want.reshape(b, rows // w, w * p))
            print(f"  xor_schedule {label} [{rows}x{cols}, {slots} slots] "
                  f"P={p}: max_abs_err stacked {e1}, shards {e2}")
            check(e1 == 0 and e2 == 0,
                  f"xor_schedule {label} P={p} disagrees with its plain "
                  "version")
            err = max(err, e1, e2)
            del packets, want, shards, got

    err = max(err, xor_edges(rng, dev))

    # the main path's shape: the liberation encode's CSE'd schedule
    from ceph_tpu_torch.codecs import registry

    enc = registry.factory(
        "jerasure", LIB_PROFILE, device="cuda").coding_bitmatrix
    sched = xs.routable_schedule(enc)
    kw, mw = enc.shape[1], enc.shape[0]
    packets = rand_on(rng, dev, (LIB_STRIPES, kw, LIB_P))
    shards = [packets[:, i * LIB_W:(i + 1) * LIB_W].reshape(
        LIB_STRIPES, LIB_CHUNK).contiguous() for i in range(LIB_K)]
    def stacked():
        return cuda_xor.xor_schedule_apply(sched, packets)

    def per_shard():
        return cuda_xor.xor_schedule_apply_shards(sched, shards, LIB_W)

    symbol = "xor_schedule_"  # the staged or the direct form
    row = {
        "max_abs_err": err,
        "ms": kernel_ms(stacked, 20, symbol),
        "call_ms": time_ms(stacked, 20),
        "shards_ms": kernel_ms(per_shard, 20, symbol),
        "shards_call_ms": time_ms(per_shard, 20),
        "plain_ms": time_ms(lambda: xs.xor_schedule_plain(sched, packets),
                            3),
        "bound_ms": (kw + mw) * LIB_P * LIB_STRIPES / H100_BYTES_PER_S * 1e3,
    }
    # the LRC local repair: 3 whole 1 MiB chunks -> 1, w = 1
    local = xs.optimize_schedule(np.ones((1, 3), np.uint8))
    group = [rand_on(rng, dev, (LRC_STRIPES, LRC_CHUNK)) for _ in range(3)]
    row["lrc_repair_ms"] = kernel_ms(
        lambda: cuda_xor.xor_schedule_apply_shards(local, group, 1), 20,
        symbol)
    row["lrc_repair_bound_ms"] = (4 * LRC_STRIPES * LRC_CHUNK
                                  / H100_BYTES_PER_S * 1e3)
    print(f"  xor_schedule: {row['ms']:.4f} ms kernel stacked, "
          f"{row['shards_ms']:.4f} ms kernel per-shard (profiler); "
          f"{row['call_ms']:.4f} / {row['shards_call_ms']:.4f} ms a call "
          f"(events); {row['plain_ms']:.3f} ms plain; bound "
          f"{row['bound_ms']:.4f} ms (bytes); LRC local repair "
          f"{row['lrc_repair_ms']:.4f} ms kernel, bound "
          f"{row['lrc_repair_bound_ms']:.4f} ms")

    # Kernel A against Kernel D on 0/1 byte matrices (w = 1), which
    # either could serve: the LRC repair row and a dense random 0/1
    # [4, 12] matrix over 16 stripes of 1 MiB chunks
    from ceph_tpu_torch.gf import gf_matrix_to_bitmatrix
    from ceph_tpu_torch.ops import cuda_encode

    dense01 = (rng.random((4, 12)) < 0.5).astype(np.uint8)
    wide = [rand_on(rng, dev, (LRC_STRIPES, LRC_CHUNK)) for _ in range(12)]
    for label, mat, srcs in (("LRC repair row 1x3", np.ones((1, 3), np.uint8),
                              group), ("dense 0/1 4x12", dense01, wide)):
        bits = gf_matrix_to_bitmatrix(mat)
        opt = xs.optimize_schedule(mat)
        a = kernel_ms(lambda: cuda_encode.gf_apply_shards(bits, srcs), 20,
                      "gf_apply_kernel")
        d = kernel_ms(
            lambda: cuda_xor.xor_schedule_apply_shards(opt, srcs, 1), 20,
            symbol)
        row[f"A_vs_D {label}"] = (a, d)
        print(f"  0/1 byte matrix {label}: Kernel A {a:.4f} ms, Kernel D "
              f"{d:.4f} ms (profiler)")
    return row


def isa_path(rng, dev) -> Counted:
    """Phases 3-6: the ISA-L reed_sol_van EC(8,4) write, degraded read,
    verify and corpus, counted; then its outputs checked."""
    import torch

    from ceph_tpu_torch.checksum import Checksummer
    from ceph_tpu_torch.checksum.crc32c import (
        crc32c_fold_plain,
        crc32c_seed_shift,
    )
    from ceph_tpu_torch.checksum.reference import crc32c_ref
    from ceph_tpu_torch.codecs import registry
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

    with Counted("isa") as counted:
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
                {1, 9},
                {i: c for i, c in want_chunks.items() if i not in (1, 9)},
            )
    counted.check_routes(("gf_apply", "gf_apply_csum", "crc32c_blocks"))
    d = counted.dispatch
    check(d["kernel_encode"] > 0 and d["kernel_decode"] > 0
          and d["fused_encode"] > 0, "kernel_* did not move")

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
    print("isa outputs: parity, csums, HashInfo, rebuilt shards, verify and "
          "corpus all byte-exact")
    return counted


def schedule_path(rng, dev) -> Counted:
    """The XOR-schedule path: the liberation k=6 m=2 w=7 write, degraded
    read and RMW, the LRC xor-local repair and the v1 corpus entries,
    counted; then their outputs checked."""
    import torch

    from ceph_tpu_torch.checksum import Checksummer
    from ceph_tpu_torch.checksum.crc32c import (
        crc32c_chain,
        crc32c_fold_plain,
    )
    from ceph_tpu_torch.checksum.reference import crc32c_ref
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.gf import gf_apply_bytes_host, gf_matrix_to_bitmatrix
    from ceph_tpu_torch.ops import xor_schedule as xs
    from ceph_tpu_torch.ops.bitplane import gf_encode_bitplane
    from ceph_tpu_torch.pipeline import (
        HashInfo,
        ShardExtentMap,
        StripeInfo,
    )
    from ceph_tpu_torch.utils import config
    from ceph_tpu_torch.utils.device import to_numpy

    k, m, n, chunk = LIB_K, LIB_M, LIB_K + LIB_M, LIB_CHUNK
    payload = rng.integers(0, 256, k * LIB_STRIPES * chunk, dtype=np.uint8)
    by_stripe = payload.reshape(LIB_STRIPES, k, chunk)
    streams = np.ascontiguousarray(by_stripe.transpose(1, 0, 2)).reshape(
        k, LIB_STRIPES * chunk)
    sinfo = StripeInfo(k, m, k * chunk)
    shard_bytes = LIB_STRIPES * chunk
    data_bytes = k * shard_bytes
    new_chunk = rng.integers(0, 256, chunk, dtype=np.uint8)
    lrc_data = rng.integers(0, 256, (4, LRC_STRIPES, LRC_CHUNK),
                            dtype=np.uint8)
    corpus = []
    for entry in LIB_CORPUS:
        meta = json.loads((entry / "profile.json").read_text())
        n_chunks = int(meta["profile"]["k"]) + int(meta["profile"]["m"])
        corpus.append((meta, (entry / "payload.bin").read_bytes(), {
            i: (entry / f"chunk.{i}").read_bytes() for i in range(n_chunks)
        }))
    dev_data = torch.from_numpy(by_stripe.transpose(1, 0, 2).copy()).to(dev)
    lrc_dev = torch.from_numpy(lrc_data).to(dev)

    with Counted("schedule") as counted:
        codec = registry.factory("jerasure", LIB_PROFILE, device="cuda")
        smap = ShardExtentMap(sinfo)
        for r in range(k):
            smap.insert(r, 0, streams[r])
        hinfo = HashInfo(n, device="cuda")
        summer = Checksummer("crc32c", CSUM_BLOCK, device="cuda")
        with Phase("lib_write_host_staged", data_bytes):
            smap.encode(codec, hinfo, csum_block=CSUM_BLOCK)
            stored = {s: smap.get(s, 0, shard_bytes) for s in range(n)}
            blob = summer.calculate(
                np.concatenate([stored[s] for s in range(n)]))

        with Phase("lib_write_device_resident", data_bytes):
            par = codec.encode_chunks({i: dev_data[i] for i in range(k)})
            par = {j: to_numpy(v) for j, v in par.items()}

        survivors = ShardExtentMap(sinfo)
        for s in range(n):
            if s not in LIB_LOST:
                survivors.insert(s, 0, stored[s])
        with Phase("lib_degraded_read_host_staged", data_bytes):
            survivors.decode(codec, set(LIB_LOST), k * shard_bytes)
        rebuilt = {s: survivors.get(s, 0, shard_bytes) for s in LIB_LOST}
        chunks_dev = {
            s: torch.from_numpy(stored[s].reshape(LIB_STRIPES, chunk)).to(dev)
            for s in range(n) if s not in LIB_LOST
        }
        with Phase("lib_degraded_read_device_resident", data_bytes):
            rebuilt_dev = codec.decode_chunks(set(LIB_LOST), chunks_dev)
            rebuilt_dev = {s: to_numpy(rebuilt_dev[s]) for s in LIB_LOST}

        # RMW of chunk 1 (the second stripe) of data shard 3
        old_map = ShardExtentMap(sinfo)
        for s in range(n):
            old_map.insert(s, 0, stored[s])
        new_map = ShardExtentMap(sinfo)
        new_map.insert(3, chunk, new_chunk)
        old_parity = {s: stored[s][chunk:2 * chunk] for s in (k, k + 1)}
        delta_dev = torch.from_numpy(
            np.bitwise_xor(stored[3][chunk:2 * chunk], new_chunk)
        ).to(dev)
        # each RMW reads a delta chunk and m parity chunks, writes m
        with Phase("lib_rmw", 2 * (1 + 2 * m) * chunk):
            # one 1,008 KiB chunk is under the 1 MiB host threshold: 0
            # sends this small write's delta to the card
            with config.override(ec_host_dispatch_bytes=0):
                new_map.encode_parity_delta(codec, old_map)
            rmw = {s: new_map.get(s, chunk, chunk) for s in (k, k + 1)}
            rmw_dev = codec.apply_delta(
                {3: delta_dev},
                {s: torch.from_numpy(p).to(dev)
                 for s, p in old_parity.items()},
            )
            rmw_dev = {s: to_numpy(v) for s, v in rmw_dev.items()}

        lrc = registry.factory("lrc", LRC_PROFILE, device="cuda")
        with Phase("lrc_xor_local", 4 * LRC_STRIPES * LRC_CHUNK):
            lrc_par = lrc.encode_chunks({i: lrc_dev[i] for i in range(4)})
            lrc_full = {**{i: lrc_dev[i] for i in range(4)}, **lrc_par}
            plan = lrc.minimum_to_decode({0}, set(range(8)) - {0})
            repaired = lrc.decode_chunks(
                {0}, {s: lrc_full[s] for s in plan})
            repaired = to_numpy(repaired[0])
            lrc_par = {j: to_numpy(v) for j, v in lrc_par.items()}

        corpus_out = []
        with Phase("lib_corpus", sum(len(p) for _, p, _ in corpus)):
            for meta, corpus_payload, want_chunks in corpus:
                cc = registry.factory(meta["plugin"], meta["profile"],
                                      device="cuda")
                corpus_out.append((
                    cc.encode(corpus_payload),
                    cc.decode({1, 3}, {i: c for i, c in want_chunks.items()
                                       if i not in (1, 3)}),
                ))
    counted.check_routes(("xor_schedule", "crc32c_blocks", "gf_apply"))
    d = counted.dispatch
    for key in ("sched_encode", "sched_decode", "sched_delta"):
        check(d[key] > 0, f"schedule path ec_dispatch {key} did not move")
    print(f"schedule path sched_rejected_density = "
          f"{d['sched_rejected_density']}")

    # -- the outputs, against the plain version and the host oracles ----
    coding = codec.coding_bitmatrix
    rows = xs.schedule_rows(coding)  # no CSE: independent of the kernel's

    def plain_parity(data):  # [S, k, chunk] -> [S, m, chunk] on the card
        pk = torch.from_numpy(np.ascontiguousarray(data)).to(dev).reshape(
            data.shape[0], k * LIB_W, LIB_P)
        return to_numpy(xs.xor_schedule_plain(rows, pk)).reshape(
            data.shape[0], m, chunk)

    want_par = plain_parity(by_stripe)
    for j in range(m):
        want_stream = want_par[:, j].reshape(-1)
        check(np.array_equal(stored[k + j], want_stream),
              f"host-staged parity {k + j} differs from the plain version")
        check(np.array_equal(par[k + j].reshape(-1), want_stream),
              f"device parity {k + j} differs from the plain version")
    cols = 1024  # host GF tables over the packets' first bytes
    host_pk = by_stripe.reshape(LIB_STRIPES, k * LIB_W, LIB_P)[..., :cols]
    check(np.array_equal(
        gf_apply_bytes_host(coding, host_pk),
        want_par.reshape(LIB_STRIPES, m * LIB_W, LIB_P)[..., :cols]),
        "plain parity differs from the host GF tables")
    full = torch.from_numpy(np.stack([stored[s] for s in range(n)])).to(dev)
    want_blob = to_numpy(crc32c_fold_plain(
        full.reshape(-1, CSUM_BLOCK), 0xFFFFFFFF)).astype(np.uint32)
    check(np.array_equal(blob, want_blob),
          "blob csums differ from the plain fold")
    blk = stored[k][:CSUM_BLOCK].tobytes()
    check(int(blob[k * shard_bytes // CSUM_BLOCK]) ==
          crc32c_ref(0xFFFFFFFF, blk),
          "a parity blob csum differs from the bitwise oracle")
    for s in range(n):
        c0 = crc32c_fold_plain(full[s].reshape(-1, CSUM_BLOCK), 0)
        check(hinfo.get_chunk_hash(s) ==
              crc32c_chain(0xFFFFFFFF, to_numpy(c0), CSUM_BLOCK),
              f"HashInfo of shard {s} differs from the plain fold")
    for s in LIB_LOST:
        check(np.array_equal(rebuilt[s], stored[s]),
              f"ShardExtentMap.decode rebuilt shard {s} wrong")
        check(np.array_equal(rebuilt_dev[s].reshape(-1), stored[s]),
              f"decode_chunks rebuilt shard {s} wrong")
    patched = np.stack([stored[i][chunk:2 * chunk] for i in range(k)])
    patched[3] = new_chunk
    want_rmw = plain_parity(patched[None])[0]
    for j in range(m):
        check(np.array_equal(rmw[k + j], want_rmw[j]),
              f"encode_parity_delta parity {k + j} != a full re-encode")
        check(np.array_equal(rmw_dev[k + j], want_rmw[j]),
              f"device apply_delta parity {k + j} != a full re-encode")
    check(len(plan) == 3, f"LRC local repair plan {sorted(plan)}, want the "
          "3-chunk local group")
    check(np.array_equal(repaired, lrc_data[0]), "LRC local repair wrong")
    want_lrc = to_numpy(gf_encode_bitplane(
        gf_matrix_to_bitmatrix(lrc._composite),
        torch.from_numpy(lrc_data.transpose(1, 0, 2).copy()).to(dev)))
    for j in range(lrc.m):
        check(np.array_equal(lrc_par[lrc.k + j], want_lrc[:, j]),
              f"LRC parity {lrc.k + j} differs from the plain apply")
    by_pos = {lrc.chunk_mapping[i]: v for i, v in
              {**dict(enumerate(lrc_data)), **lrc_par}.items()}
    check(np.array_equal(by_pos[3], by_pos[0] ^ by_pos[1] ^ by_pos[2]),
          "LRC local parity is not the XOR of its group")
    for (meta, _, want_chunks), (now, dec) in zip(corpus, corpus_out):
        name = meta["profile"]["technique"]
        for i, c in want_chunks.items():
            check(now[i] == c, f"corpus {name} chunk {i} differs")
        for i in (1, 3):
            check(dec[i] == want_chunks[i], f"corpus {name} decode {i} "
                  "differs")
    print("schedule outputs: parity, csums, HashInfo, rebuilt shards, delta "
          "parity, LRC repair and corpus all byte-exact")
    return counted


def clay_repair_plan(codec, lost):
    """(kernel plan, helper plan) of the repair of chunk ``lost`` from
    exactly d helpers: the first d survivors, or the last d when those
    miss a member of the lost chunk's group (the reference tests'
    choice); the survivors left out are the aloof nodes."""
    n = codec.get_chunk_count()
    avail = sorted(set(range(n)) - {lost})[:codec.d]
    if not codec.is_repair({lost}, set(avail)):
        avail = sorted(set(range(n)) - {lost})[-codec.d:]
    helpers = codec.minimum_to_decode({lost}, set(avail))
    aloof = frozenset(codec._to_node(c) for c in range(n)
                      if c != lost and c not in helpers)
    return codec._kernel_plan(codec._to_node(lost), aloof), helpers


def gather_subchunks(chunk, runs, sub_chunks: int):
    """A helper's repair bytes: the (index, count) sub-chunk runs of a
    [..., chunk] tensor, concatenated in plane order, on its device."""
    import torch

    lead, n = tuple(chunk.shape[:-1]), int(chunk.shape[-1])
    planes = torch.tensor([z for i, c in runs for z in range(i, i + c)],
                          device=chunk.device)
    view = chunk.reshape(lead + (sub_chunks, n // sub_chunks))
    return view.index_select(len(lead), planes).reshape(lead + (-1,))


def clay_vs_plain(rng, dev) -> dict:
    """Phase 2, Kernels E and F: each against its plain version, byte for
    byte, over the plans of CLAY_KERNEL_CASES x CLAY_KERNEL_SC x
    CLAY_KERNEL_B; then timed at the main path's shape (CLAY(8,4,d=11),
    lost chunk 9, 64 stripes of 8 KiB sub-chunks)."""
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.ops import clay_repair as cr

    out = {name: {"max_abs_err": 0}
           for name in ("clay_uncoupled", "clay_couple_scatter")}

    def note(name, got, want, what):
        err = max((max_err(g, w) for g, w in zip(got, want)), default=0)
        check(len(got) == len(want), f"{name} {what}: {len(got)} outputs, "
              f"want {len(want)}")
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        check(err == 0, f"{name} {what} disagrees with its plain version")
        return err

    def args(profile, lost, sc, b):
        codec = registry.factory("clay", profile, device=dev)
        plan, _ = clay_repair_plan(codec, lost)
        q, r = codec.q, codec.sub_chunk_no // codec.q
        x_l = codec._to_node(lost) % q
        n_real = sum(k == "r" for row in plan["kinds"] for k in row)
        n_help = sum(1 for x in range(q)
                     if x != x_l and plan["lost_kinds"][x] == "r")
        a = (q, plan["strides"], plan["kinds"], plan["pair_fwd"],
             [rand_on(rng, dev, (b, r * sc)) for _ in range(n_real)], r, sc)
        c = (q, x_l, plan["lost_kinds"], plan["pair_inv"],
             [rand_on(rng, dev, (b, r * sc)) for _ in range(q)],
             [rand_on(rng, dev, (b, r * sc)) for _ in range(n_help)],
             plan["seq"], r, sc)
        return a, c

    for profile, losts in CLAY_KERNEL_CASES:
        for lost in losts:
            for sc in CLAY_KERNEL_SC:
                for b in CLAY_KERNEL_B:
                    a, c = args(profile, lost, sc, b)
                    what = (f"k={profile['k']} m={profile['m']} "
                            f"d={profile['d']} lost {lost} sc={sc} B={b}")
                    e1 = note("clay_uncoupled", cr.uncoupled_rows(*a),
                              cr.uncoupled_rows_plain(*a), what)
                    e2 = note("clay_couple_scatter", [cr.couple_scatter(*c)],
                              [cr.couple_scatter_plain(*c)], what)
                    print(f"  clay kernels {what}: max_abs_err E {e1}, "
                          f"F {e2}")
                    del a, c

    # the main path's shape: E reads 8 helpers and writes 8 U arrays of
    # [64, 16 x 8192]; F reads 4 U + 3 helpers and writes [64, 64 x 8192]
    sc = OBJECT_BYTES // int(CLAY_PROFILE["k"]) // 64
    a, c = args(CLAY_PROFILE, CLAY_LOST, sc, CLAY_OBJECTS)
    row_bytes = CLAY_OBJECTS * a[5] * sc
    moved = {
        "clay_uncoupled": (len(a[4]) + sum(
            k != "a" for row in a[2] for k in row)) * row_bytes,
        "clay_couple_scatter": (len(c[4]) + len(c[5]) + c[0]) * row_bytes,
    }
    timed = {
        "clay_uncoupled": (lambda: cr.uncoupled_rows(*a),
                           lambda: cr.uncoupled_rows_plain(*a),
                           "clay_uncoupled_kernel"),
        "clay_couple_scatter": (lambda: cr.couple_scatter(*c),
                                lambda: cr.couple_scatter_plain(*c),
                                "clay_couple_scatter_kernel"),
    }
    for name, (fn, plain, symbol) in timed.items():
        out[name].update(
            ms=kernel_ms(fn, 20, symbol), call_ms=time_ms(fn, 20),
            plain_ms=time_ms(plain, 3),
            bound_ms=moved[name] / H100_BYTES_PER_S * 1e3,
        )
        row = out[name]
        print(f"  {name}: {row['ms']:.4f} ms kernel (profiler), "
              f"{row['call_ms']:.4f} ms a call (events), "
              f"{row['plain_ms']:.3f} ms plain, bound "
              f"{row['bound_ms']:.4f} ms (bytes: {moved[name]})")
    return out


def clay_path(rng, dev) -> Counted:
    """The CLAY path, CLAY(8,4,d=11) over 64 objects of 4 MiB: the
    device-resident encode, the host-staged write with HashInfo, the
    fractional repair of every chunk, the general-d (8,4,d=10) repair
    with an aloof helper, the degraded read of shard 9 through
    ``reconstruct_shards``, a two-erasure decode, the naive RS(8,4)
    comparator and the clay corpus, counted; then the outputs checked."""
    import torch

    from ceph_tpu_torch.checksum.crc32c import crc32c_chain, crc32c_fold_plain
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.pipeline import (
        ExtentSet,
        HashInfo,
        ShardExtentMap,
        StripeInfo,
    )
    from ceph_tpu_torch.pipeline.read import (
        get_min_avail_to_read_shards,
        reconstruct_shards,
    )
    from ceph_tpu_torch.utils import config
    from ceph_tpu_torch.utils.device import to_numpy

    cpu = registry.factory("clay", CLAY_PROFILE, device="cpu")
    k, m, n, d = cpu.k, cpu.m, cpu.k + cpu.m, cpu.d
    chunk = cpu.get_chunk_size(OBJECT_BYTES)  # 512 KiB
    subs = cpu.get_sub_chunk_count()
    objs = CLAY_OBJECTS
    payload = rng.integers(0, 256, (objs, k, chunk), dtype=np.uint8)
    by_shard = np.ascontiguousarray(payload.transpose(1, 0, 2))
    streams = by_shard.reshape(k, objs * chunk)
    sinfo = StripeInfo(k, m, k * chunk)
    shard_bytes = objs * chunk
    object_size = k * shard_bytes
    dev_data = torch.from_numpy(by_shard).to(dev)  # shard i: [objs, chunk]
    gen = registry.factory("clay", CLAY_GENERAL, device="cpu")
    chunk10 = gen.get_chunk_size(OBJECT_BYTES)  # 528,768 B
    dev10 = torch.from_numpy(rng.integers(
        0, 256, (k, objs, chunk10), dtype=np.uint8)).to(dev)
    corpus = []
    for entry in CLAY_CORPUS:
        meta = json.loads((entry / "profile.json").read_text())
        nc = int(meta["profile"]["k"]) + int(meta["profile"]["m"])
        corpus.append((entry.parent.parent.name + "/" + entry.name, meta,
                       (entry / "payload.bin").read_bytes(),
                       {i: (entry / f"chunk.{i}").read_bytes()
                        for i in range(nc)}))

    with Counted("clay") as counted:
        codec = registry.factory("clay", CLAY_PROFILE, device="cuda")
        with Phase("clay_encode_device_resident", object_size):
            par = codec.encode_chunks({i: dev_data[i] for i in range(k)})
        full = {**{i: dev_data[i] for i in range(k)}, **par}

        smap = ShardExtentMap(sinfo)
        for r in range(k):
            smap.insert(r, 0, streams[r])
        hinfo = HashInfo(n, device="cuda")
        with Phase("clay_write_host_staged", object_size):
            smap.encode(codec, hinfo, csum_block=CSUM_BLOCK)
        stored = {s: smap.get(s, 0, shard_bytes) for s in range(n)}

        # every chunk lost in turn, its d helpers' sub-chunks gathered on
        # the card
        plans, repaired = {}, {}
        helper9 = None
        read_bytes = d * objs * chunk // cpu.q
        with Phase("clay_repair_every_chunk", n * read_bytes):
            for lost in range(n):
                plans[lost] = codec.minimum_to_decode(
                    {lost}, set(range(n)) - {lost})
                helpers = {s: gather_subchunks(full[s], runs, subs)
                           for s, runs in plans[lost].items()}
                repaired[lost] = codec.repair({lost}, helpers)[lost]
                if lost == CLAY_LOST:
                    helper9 = helpers

        codec10 = registry.factory("clay", CLAY_GENERAL, device="cuda")
        with Phase("clay_d10_encode_device_resident", dev10.numel()):
            par10 = codec10.encode_chunks({i: dev10[i] for i in range(k)})
        full10 = {**{i: dev10[i] for i in range(k)}, **par10}
        plans10, repaired10 = {}, {}
        with Phase("clay_d10_repair_aloof",
                   len(CLAY_GENERAL_LOST) * codec10.d * objs * chunk10
                   // codec10.q):
            for lost in CLAY_GENERAL_LOST:
                _, plans10[lost] = clay_repair_plan(codec10, lost)
                helpers = {s: gather_subchunks(full10[s], runs,
                                               codec10.sub_chunk_no)
                           for s, runs in plans10[lost].items()}
                repaired10[lost] = codec10.repair({lost}, helpers)[lost]

        want = {CLAY_LOST: ExtentSet([(0, shard_bytes)])}
        with Phase("clay_degraded_read_reconstruct", read_bytes):
            reads, need_decode = get_min_avail_to_read_shards(
                sinfo, codec, want, set(range(n)) - {CLAY_LOST})
            result = ShardExtentMap(sinfo)
            for s, sr in reads.items():
                for lo, hi in sr.extents:
                    result.insert(s, lo, smap.get(s, lo, hi - lo))
            reconstruct_shards(sinfo, codec, result, want, reads,
                               object_size)
        rebuilt = result.get(CLAY_LOST, 0, shard_bytes)

        erased = (0, 8)
        with Phase("clay_decode_two_erasures", object_size):
            decoded = codec.decode_chunks(
                set(erased), {i: v for i, v in full.items()
                              if i not in erased})

        # the naive comparator: RS(8,4) rebuilds chunk 9 from k whole
        # chunks (bench.py's decode1 against clay_repair_time_vs_naive)
        rs = registry.factory("jerasure", {"technique": "reed_sol_van",
                                           "k": "8", "m": "4"}, device="cuda")
        rs_full = {**{i: dev_data[i] for i in range(k)},
                   **rs.encode_chunks({i: dev_data[i] for i in range(k)})}
        rs_in = {i: rs_full[i] for i in range(1, k + 1)}
        repair_ms = time_ms(lambda: codec.repair({CLAY_LOST}, helper9), 5)
        naive_ms = time_ms(lambda: rs.decode_chunks({CLAY_LOST}, rs_in), 5)
        naive = rs.decode_chunks({CLAY_LOST}, rs_in)[CLAY_LOST]

        corpus_out = []
        with Phase("clay_corpus", sum(len(p) for _, _, p, _ in corpus)):
            for name, meta, cpay, want_chunks in corpus:
                cc = registry.factory("clay", meta["profile"], device="cuda")
                nc = cc.get_chunk_count()
                have = {i: torch.frombuffer(bytearray(c), dtype=torch.uint8)
                        .to(dev) for i, c in want_chunks.items()}
                reps = {}
                for lost in (0, nc - 1):
                    plan = cc.minimum_to_decode({lost}, set(range(nc)) - {lost})
                    reps[lost] = to_numpy(cc.repair({lost}, {
                        s: gather_subchunks(have[s], runs,
                                            cc.get_sub_chunk_count())
                        for s, runs in plan.items()})[lost])
                corpus_out.append((cc.encode(cpay), reps))
    counted.check_routes(("clay_uncoupled", "clay_couple_scatter", "gf_apply",
                          "crc32c_blocks"))
    check(counted.dispatch["kernel_decode"] > 0,
          "clay path ec_dispatch kernel_decode did not move")
    ratio = repair_ms / naive_ms
    print(f"clay repair of chunk {CLAY_LOST}: {repair_ms:.4f} ms (events), "
          f"naive RS(8,4) decode {naive_ms:.4f} ms; "
          f"clay_repair_time_vs_naive = {ratio:.4f}")
    print(json.dumps({"clay_repair_time_vs_naive": ratio,
                      "clay_repair_ms": repair_ms,
                      "naive_decode_ms": naive_ms}))

    # -- the outputs, against the source chunks and the host path -------
    for j in range(m):
        dev_par = to_numpy(par[k + j])
        check(np.array_equal(stored[k + j], dev_par.reshape(-1)),
              f"host-staged parity {k + j} differs from device-resident")
    host_objs = 2  # the host path (numpy, host GF tables) on 2 objects
    with config.override(ec_host_dispatch_bytes=1 << 40):
        host_par = cpu.encode_chunks(
            {i: np.ascontiguousarray(payload[:host_objs, i])
             for i in range(k)})
    for j in range(m):
        check(isinstance(host_par[k + j], np.ndarray),
              "the host check did not take the host path")
        check(np.array_equal(host_par[k + j],
                             to_numpy(par[k + j][:host_objs])),
              f"device parity {k + j} differs from the host path")
    full_host = np.stack([stored[s] for s in range(n)])
    full_dev = torch.from_numpy(full_host).to(dev)
    for s in range(n):
        c0 = crc32c_fold_plain(full_dev[s].reshape(-1, CSUM_BLOCK), 0)
        check(hinfo.get_chunk_hash(s) ==
              crc32c_chain(0xFFFFFFFF, to_numpy(c0), CSUM_BLOCK),
              f"HashInfo of shard {s} differs from the plain fold")
    for lost in range(n):
        runs = plans[lost]
        check(len(runs) == d and all(
            sum(c for _, c in r) == subs // cpu.q for r in runs.values()),
            f"repair plan of {lost}: {len(runs)} helpers, want {d} with "
            f"{subs // cpu.q} of {subs} sub-chunks each")
        check(torch.equal(repaired[lost], full[lost]),
              f"repair of chunk {lost} differs from the source chunk")
    for lost in CLAY_GENERAL_LOST:
        check(len(plans10[lost]) == codec10.d and
              len(set(range(n)) - {lost} - set(plans10[lost])) == 1,
              f"d=10 repair of {lost} has no aloof helper")
        check(torch.equal(repaired10[lost], full10[lost]),
              f"d=10 repair of chunk {lost} differs from the source chunk")
    runs9 = codec.get_repair_subchunks(codec._to_node(CLAY_LOST))
    helper_bytes = sum(sr.extents.size() for sr in reads.values())
    check(need_decode and len(reads) == d and all(
        sr.subchunks == runs9 for sr in reads.values()),
        "the degraded read plan carries no repair sub-chunk selectors")
    check(helper_bytes * 32 == k * shard_bytes * 11,
          f"degraded read reads {helper_bytes} B, want 11/32 of "
          f"{k * shard_bytes}")
    check(np.array_equal(rebuilt, stored[CLAY_LOST]),
          "reconstruct_shards rebuilt shard 9 wrong")
    for s in erased:
        check(torch.equal(decoded[s], full[s]), f"decode of {s} wrong")
    check(torch.equal(naive, rs_full[CLAY_LOST]), "naive RS decode wrong")
    for (name, _, _, want_chunks), (now, reps) in zip(corpus, corpus_out):
        for i, c in want_chunks.items():
            check(now[i] == c, f"corpus {name} chunk {i} differs")
        for lost, got in reps.items():
            check(got.tobytes() == want_chunks[lost],
                  f"corpus {name} repair of {lost} differs")
    print(f"clay outputs: encode (device, host-staged, host path), repair of "
          f"all {n} chunks, d=10 repair of {list(CLAY_GENERAL_LOST)}, "
          f"reconstruct_shards (reads {helper_bytes} B = 11/32 of naive), "
          f"decode {list(erased)}, HashInfo and {len(corpus)} corpus entries "
          "all byte-exact")
    return counted


class Routes:
    """Per-phase route counts of the pipeline path: each kernel's
    launches (``launch.<kernel>``), the ``ec_dispatch`` counters and the
    ``checksum.backends`` counts (``backend.<name>``), read before and
    after a phase; ``rows`` keeps each phase's nonzero differences."""

    def __init__(self) -> None:
        self.rows: dict[str, dict[str, int]] = {}

    @staticmethod
    def _now() -> dict[str, int]:
        from ceph_tpu_torch import kernels
        from ceph_tpu_torch.checksum import backends
        from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters

        out = {f"launch.{k.symbol}": k.launches for k in kernels.ALL}
        out.update(dispatch_counters().dump())
        out.update({f"backend.{b}": n for b, n in backends.counts().items()})
        return out

    @contextlib.contextmanager
    def __call__(self, name: str):
        before = self._now()
        yield
        self.rows[name] = {
            key: val - before.get(key, 0)
            for key, val in sorted(self._now().items())
            if val != before.get(key, 0)
        }


def xor_route(on_card: bool, mat) -> bool:
    """Whether the card serves a byte matrix with Kernel D: a matrix of
    zeros and ones (an XOR) that the schedule optimizer can run."""
    import numpy as np

    from ceph_tpu_torch.ops import xor_schedule
    from ceph_tpu_torch.utils import config

    return on_card and config.get("ec_use_sched") and int(
        mat.max()) <= 1 and xor_schedule.routable_schedule(
            np.ascontiguousarray(mat, np.uint8),
            config.get("ec_sched_opt")) is not None


def predict_pipeline(
    on_card: bool, small_shards: list[int]
) -> dict[str, dict[str, int]]:
    """The route of every codec and checksum call of the pipeline path,
    from the op sizes and the routing options, per phase; ``small_shards``
    is the data shard of each small overwrite. Host arrays at or below
    ``ec_host_dispatch_bytes`` take the host GF tables (the fused
    encode+csum has no host route); larger ones take the apply kernel
    (A), or the fused kernel (B) for csum-block appends; a matrix of
    zeros and ones (an XOR: a decode row of all ones, the parity column
    of a data shard whose coefficients are all one) takes the schedule
    kernel (D); streams at or above ``csum_device_min_bytes`` hash on
    Kernel C. On the CPU (a rehearsal) every kernel route is its plain
    form, and nothing launches."""
    import numpy as np

    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.utils import config

    k = int(PIPE_PROFILE["k"])
    limit = int(config.get("ec_host_dispatch_bytes"))
    csum_min = int(config.get("csum_device_min_bytes"))
    shard = PIPE_OBJECT_BYTES // k  # a whole object's bytes per shard
    coding = registry.factory(
        "isa", PIPE_PROFILE, device="cpu").generator[k:]

    def apply(op, n, nbytes, mat=None, limit=limit):
        """``n`` matrix applies of ``op`` over ``nbytes`` of host input;
        ``mat`` is the byte matrix where it may be an XOR."""
        if n == 0:
            return {}
        if 0 < limit and nbytes <= limit:
            return {f"host_{op}": n}
        if mat is not None and xor_route(on_card, mat):
            return {f"sched_{op}": n, "launch.xor_schedule": n}
        if not on_card:
            return {f"plain_{op}": n}
        return {f"kernel_{op}": n, "launch.gf_apply": n}

    def crc(n, nbytes):
        if 0 < csum_min and nbytes < csum_min:
            return {"backend.host": n}
        if not on_card:
            return {"backend.plain": n}
        return {"backend.kernel": n, "launch.crc32c_blocks": n}

    clean = PIPE_OBJECTS - PIPE_OVERWRITTEN  # objects whose HashInfo holds
    return {
        # two appends per object, csum blocks fused into the encode
        "write": fused_writes(on_card, 2 * PIPE_OBJECTS),
        # a whole-stripe overwrite reads nothing and re-encodes, fused
        "overwrite_full": fused_writes(on_card, PIPE_OVERWRITTEN),
        # one chunk's delta applied to the four parity chunks
        "overwrite_small": apply("delta", PIPE_SMALL_OPS, PIPE_SMALL),
        # the same with no host route: each data shard's parity column
        "overwrite_small_device": merge_routes(*(
            apply("delta", small_shards.count(s), PIPE_SMALL,
                  mat=coding[:, s:s + 1], limit=0)
            for s in sorted(set(small_shards)))),
        # data shards 0 and the log shard decoded from 6 data + 2 parity
        "degraded_read_objects": apply("decode", PIPE_OBJECTS, k * shard),
        # a 64 KiB range spans 2-3 stripes: k survivors of <= 3 chunks
        "degraded_read_ranges": apply(
            "decode", PIPE_RANGES,
            k * (PIPE_RANGE // (k * PIPE_UNIT) + 1) * PIPE_UNIT),
        # the log shard's dirty window of each fully overwritten object,
        # with shard 0 still down: 6 data + 2 parity survivors
        "log_recovery": apply(
            "decode", PIPE_OVERWRITTEN, k * PIPE_BIG // k),
        # parity shard 9 re-encoded from the k data shards, then the
        # objects with a HashInfo verified
        "rebuild": merge_routes(apply("decode", PIPE_OBJECTS, k * shard),
                                crc(clean, shard)),
        # every shard of the clean objects; the overwritten ones have a
        # cleared HashInfo and read nothing
        "deep_scrub": crc(clean * (k + int(PIPE_PROFILE["m"])), shard),
        # one corrupt shard: scrub, rebuild from the other data shards
        # and the all-ones parity (an XOR), verify, scrub again
        "scrub_repair": merge_routes(
            crc(2 * (k + int(PIPE_PROFILE["m"])) + 1, shard),
            apply("decode", 1, k * shard, mat=np.ones((1, k), np.uint8))),
        "model_check": {},
    }


def pipeline_path(rng, dev) -> Counted:
    """The pipeline path: the OSD EC backend (RMW write, client read,
    recovery, deep scrub) over 12 MemStore shards, ISA EC(8,4) at a
    4 KiB stripe unit, 64 objects of 4 MiB; then SHEC, CLAY over SHEC
    and xxhash. Each phase's routes are held against the prediction,
    and every object's bytes against a numpy model of the writes."""
    import torch

    from ceph_tpu_torch.checksum import Checksummer, xxh32_ref, xxh64_ref
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.gf import gf_apply_bytes_host
    from ceph_tpu_torch.pipeline import (
        HashInfo,
        PGLog,
        ReadPipeline,
        RecoveryBackend,
        StripeInfo,
        be_deep_scrub,
    )
    from ceph_tpu_torch.pipeline.rmw import (
        HINFO_KEY,
        OI_KEY,
        RMWPipeline,
        ShardBackend,
        parse_oi,
    )
    from ceph_tpu_torch.store import MemStore, Transaction
    from ceph_tpu_torch.utils import config
    from ceph_tpu_torch.utils.device import to_numpy

    k, m = int(PIPE_PROFILE["k"]), int(PIPE_PROFILE["m"])
    n = k + m
    size = PIPE_OBJECT_BYTES
    half = size // 2
    shard_bytes = size // k
    oids = [f"rbd_data.{i:016x}" for i in range(PIPE_OBJECTS)]
    over = oids[:PIPE_OVERWRITTEN]
    clean = oids[PIPE_OVERWRITTEN:]
    model = {oid: rng.integers(0, 256, size, dtype=np.uint8) for oid in oids}
    # small overwrites: one whole chunk on an allowed data shard
    stripes = size // (k * PIPE_UNIT)
    small = []
    for _ in range(PIPE_SMALL_OPS):
        oid = over[int(rng.integers(0, len(over)))]
        raw = PIPE_SMALL_SHARDS[int(rng.integers(0, len(PIPE_SMALL_SHARDS)))]
        off = (int(rng.integers(0, stripes)) * k + raw) * PIPE_UNIT
        small.append((oid, off, rng.integers(0, 256, PIPE_SMALL, np.uint8)))
    ranges = [(oids[int(rng.integers(0, len(oids)))],
               int(rng.integers(0, size - PIPE_RANGE)))
              for _ in range(PIPE_RANGES)]
    big = {oid: rng.integers(0, 256, PIPE_BIG, dtype=np.uint8) for oid in over}

    def stack(stores, pglog):
        codec = registry.factory("isa", PIPE_PROFILE, device=dev)
        sinfo = StripeInfo(k, m, k * PIPE_UNIT)
        backend = ShardBackend(stores)
        rmw = RMWPipeline(sinfo, codec, backend, pglog=pglog)
        reads = ReadPipeline(sinfo, codec, backend, rmw.object_size)
        rec = RecoveryBackend(sinfo, codec, backend, rmw.object_size,
                              rmw.hinfo, eversion_fn=rmw.object_eversion)
        return codec, sinfo, backend, rmw, reads, rec

    def submit(rmw, oid, off, data):
        done = []
        rmw.submit(oid, off, data.tobytes(), done.append)
        check(len(done) == 1 and done[0].error is None,
              f"write of {oid} at {off} did not commit: {done}")

    def shard_state(stores, objs):
        return {s: {oid: (st.read(oid), st.getattrs(oid)) for oid in objs}
                for s, st in stores.items()}

    routes = Routes()
    with Counted("pipeline") as counted:
        with config.override(csum_block_size=CSUM_BLOCK,
                             osd_deep_scrub_stride=524288):
            pglog = PGLog(n)
            stores = {s: MemStore(f"osd.{s}") for s in range(n)}
            codec, sinfo, backend, rmw, reads, rec = stack(stores, pglog)
            check(rmw.csum_block == CSUM_BLOCK, "csum_block_size not read")

            with routes("write"), Phase("pipeline_write", 2 * PIPE_OBJECTS * half):
                for oid in oids:
                    submit(rmw, oid, 0, model[oid][:half])
                    submit(rmw, oid, half, model[oid][half:])
            for oid in oids:
                check(rmw.hinfo(oid).get_total_chunk_size() == shard_bytes,
                      f"HashInfo of {oid} not extended by the second append")

            backend.down_shards.add(PIPE_LOG_SHARD)
            with routes("overwrite_full"), Phase(
                    "pipeline_overwrite_full", PIPE_OVERWRITTEN * PIPE_BIG):
                for oid in over:
                    submit(rmw, oid, PIPE_BIG_OFF, big[oid])
                    model[oid][PIPE_BIG_OFF:PIPE_BIG_OFF + PIPE_BIG] = big[oid]
            dirty = pglog.dirty_extents(PIPE_LOG_SHARD)
            check(sorted(dirty) == sorted(over),
                  f"the log holds dirty extents of {sorted(dirty)}")
            # the state the small overwrites start from, for the second pass
            before = shard_state(stores, over)
            next_tid = rmw._next_tid
            with routes("overwrite_small"), Phase(
                    "pipeline_overwrite_small_host",
                    PIPE_SMALL_OPS * PIPE_SMALL):
                for oid, off, data in small:
                    submit(rmw, oid, off, data)
                    model[oid][off:off + PIPE_SMALL] = data
            check(rmw.perf.get("parity_delta_ops") == PIPE_SMALL_OPS,
                  "the small overwrites did not all take parity delta")

            # the same overwrites from the same state, every one on the card
            stores2 = {s: MemStore.from_snapshot(f"osd.{s}.b", objs)
                       for s, objs in before.items()}
            del before
            _, _, backend2, rmw2, _, _ = stack(stores2, PGLog(n))
            backend2.down_shards.add(PIPE_LOG_SHARD)
            for oid in over:
                raw = stores2[0].getattr(oid, OI_KEY)
                osize, ev = parse_oi(raw)
                rmw2.prime_object(oid, osize, HashInfo.from_bytes(
                    stores2[0].getattr(oid, HINFO_KEY), dev), ev)
            # the second pass continues the first's op sequence (the OI
            # attr stamps the tid; prime_object leaves it alone)
            rmw2._next_tid = next_tid
            with config.override(ec_host_dispatch_bytes=0), \
                    routes("overwrite_small_device"), Phase(
                        "pipeline_overwrite_small_device",
                        PIPE_SMALL_OPS * PIPE_SMALL):
                for oid, off, data in small:
                    submit(rmw2, oid, off, data)
            check(shard_state(stores2, over) == shard_state(stores, over),
                  "the device-route overwrites stored other bytes than the "
                  "host route's")
            del stores2, backend2, rmw2

            backend.down_shards.update(PIPE_READ_DOWN)
            got_objects = {}
            with routes("degraded_read_objects"), Phase(
                    "pipeline_degraded_read_objects", PIPE_OBJECTS * size):
                for oid in oids:
                    got_objects[oid] = reads.read_sync(oid, 0, size)
            got_ranges = []
            with routes("degraded_read_ranges"), Phase(
                    "pipeline_degraded_read_ranges", PIPE_RANGES * PIPE_RANGE):
                for oid, off in ranges:
                    got_ranges.append(reads.read_sync(oid, off, PIPE_RANGE))

            backend.down_shards.discard(PIPE_LOG_SHARD)
            with routes("log_recovery"), Phase(
                    "pipeline_log_recovery", PIPE_OVERWRITTEN * PIPE_BIG):
                log_ops = rec.recover_from_log(pglog, PIPE_LOG_SHARD)
            check(sorted(log_ops) == sorted(over)
                  and not pglog.dirty_extents(PIPE_LOG_SHARD),
                  "the log recovery left dirty extents")
            backend.down_shards.clear()

            wiped = stores[PIPE_WIPED]
            pre_wipe = shard_state({0: wiped}, oids)[0]
            backend.stores[PIPE_WIPED] = MemStore(f"osd.{PIPE_WIPED}.new")
            with routes("rebuild"), Phase(
                    "pipeline_rebuild_shard", PIPE_OBJECTS * k * shard_bytes):
                for oid in oids:
                    rec.recover_object(oid, {PIPE_WIPED})
            rebuilt = shard_state({0: backend.stores[PIPE_WIPED]}, oids)[0]
            check(rebuilt == pre_wipe,
                  f"shard {PIPE_WIPED} rebuilt with other bytes or attrs")
            del pre_wipe, rebuilt, wiped

            with routes("deep_scrub"), Phase(
                    "pipeline_deep_scrub", len(clean) * n * shard_bytes):
                scrubs = {oid: be_deep_scrub(sinfo, backend, oid, device=dev)
                          for oid in oids}
            for oid, res in scrubs.items():
                check(res.ok, f"scrub of {oid}: {res.errors}")
            victim = clean[0]
            with routes("scrub_repair"), Phase(
                    "pipeline_scrub_repair", 2 * n * shard_bytes):
                st = backend.stores[PIPE_FLIP_SHARD]
                byte = st.read(victim, 12345, 1)[0]
                st.queue_transactions(Transaction().write(
                    victim, 12345, bytes([byte ^ 0x5A])))
                bad = be_deep_scrub(sinfo, backend, victim, device=dev)
                rec.recover_object(victim, {PIPE_FLIP_SHARD})
                fixed = be_deep_scrub(sinfo, backend, victim, device=dev)
            check([(e.shard, e.kind) for e in bad.errors]
                  == [(PIPE_FLIP_SHARD, "crc_mismatch")],
                  f"the flipped byte scrubbed as {bad.errors}")
            check(fixed.ok, f"scrub after the repair: {fixed.errors}")

            with routes("model_check"), Phase(
                    "pipeline_read_back", PIPE_OBJECTS * size):
                for oid in oids:
                    check(reads.read_sync(oid, 0, size) == model[oid].tobytes(),
                          f"{oid} reads back other bytes than were written")
        for oid in oids:
            check(got_objects[oid] == model[oid].tobytes(),
                  f"degraded read of {oid} differs from the model")
        for (oid, off), got in zip(ranges, got_ranges):
            check(got == model[oid][off:off + PIPE_RANGE].tobytes(),
                  f"degraded range {oid}@{off} differs from the model")
        del got_objects, stores, backend, rmw, reads, rec

        # -- SHEC: encode, a repair with fewer than k reads, the corpus ---
        shec = registry.factory("shec", SHEC_PROFILE, device=dev)
        sk, sm = shec.k, shec.m
        shec_data = torch.from_numpy(rng.integers(
            0, 256, (sk, SHEC_STRIPES, SHEC_CHUNK), dtype=np.uint8)).to(dev)
        with routes("shec"), Phase("shec_encode_decode",
                                   sk * SHEC_STRIPES * SHEC_CHUNK):
            shec_par = shec.encode_chunks({i: shec_data[i] for i in range(sk)})
            plan = shec.minimum_to_decode(
                {SHEC_LOST}, set(range(sk + sm)) - {SHEC_LOST})
            full = {**{i: shec_data[i] for i in range(sk)}, **shec_par}
            shec_dec = shec.decode_chunks(
                {SHEC_LOST}, {i: full[i] for i in plan})[SHEC_LOST]
            meta = json.loads((SHEC_CORPUS / "profile.json").read_text())
            cshec = registry.factory("shec", meta["profile"], device=dev)
            cpay = (SHEC_CORPUS / "payload.bin").read_bytes()
            cwant = {i: (SHEC_CORPUS / f"chunk.{i}").read_bytes()
                     for i in range(cshec.get_chunk_count())}
            cnow = cshec.encode(cpay)
            cdec = cshec.decode({0, 5}, {i: c for i, c in cwant.items()
                                         if i not in (0, 5)})
        check(len(plan) < sk, f"SHEC repair of {SHEC_LOST} reads {len(plan)}")
        check(torch.equal(shec_dec, shec_data[SHEC_LOST]),
              "SHEC decode differs from the source chunk")
        want_par = gf_apply_bytes_host(
            shec.coding, to_numpy(shec_data[:, :2, :4096]).transpose(1, 0, 2))
        for j in range(sm):
            check(np.array_equal(to_numpy(shec_par[sk + j][:2, :4096]),
                                 want_par[:, j]),
                  f"SHEC parity {sk + j} differs from the host GF tables")
        for i, c in cwant.items():
            check(cnow[i] == c, f"SHEC corpus chunk {i} differs")
        check(cdec[0] == cwant[0] and cdec[5] == cwant[5],
              "SHEC corpus decode differs")

        cs_codec = registry.factory("clay", CLAY_SHEC_PROFILE, device=dev)
        ck = cs_codec.k
        cn = cs_codec.get_chunk_count()
        csize = cs_codec.get_chunk_size(OBJECT_BYTES)
        cdata = torch.from_numpy(rng.integers(
            0, 256, (ck, CLAY_SHEC_STRIPES, csize), dtype=np.uint8)).to(dev)
        with routes("clay_over_shec"), Phase(
                "clay_over_shec", ck * CLAY_SHEC_STRIPES * csize):
            cpar = cs_codec.encode_chunks({i: cdata[i] for i in range(ck)})
            cfull = {**{i: cdata[i] for i in range(ck)}, **cpar}
            cplan = cs_codec.minimum_to_decode({1}, set(range(cn)) - {1})
            crep = cs_codec.repair({1}, {
                s: gather_subchunks(cfull[s], runs,
                                    cs_codec.get_sub_chunk_count())
                for s, runs in cplan.items()})[1]
        check(torch.equal(crep, cfull[1]), "CLAY over SHEC repair differs")

        # -- xxhash through the Checksummer, on the card ------------------
        blob = torch.from_numpy(rng.integers(
            0, 256, XXH_BYTES, dtype=np.uint8)).to(dev)
        flip_at = XXH_BYTES // 3 + 7
        bad_blob = blob.clone()
        bad_blob[flip_at] ^= 0x5A
        xx = {}
        with routes("xxhash"), Phase("xxhash_calculate_verify",
                                     6 * XXH_BYTES):
            for alg in ("xxhash32", "xxhash64"):
                summer = Checksummer(alg, CSUM_BLOCK, device=dev)
                vals = summer.calculate(blob)
                xx[alg] = (vals, summer.verify(blob, vals),
                           summer.verify(bad_blob, vals))
        host_blob = to_numpy(blob)
        for alg, ref in (("xxhash32", xxh32_ref), ("xxhash64", xxh64_ref)):
            vals, ok, bad = xx[alg]
            seed = (1 << (32 if alg == "xxhash32" else 64)) - 1
            for q in (0, 77, len(vals) - 1):
                blk = host_blob[q * CSUM_BLOCK:(q + 1) * CSUM_BLOCK].tobytes()
                check(int(vals[q]) == ref(blk, seed),
                      f"{alg} of block {q} differs from the reference")
            check(ok == (-1, 0), f"{alg} clean verify returned {ok}")
            want_bad = (flip_at // CSUM_BLOCK) * CSUM_BLOCK
            check(bad[0] == want_bad,
                  f"{alg} verify of the flipped byte returned {bad}")

    # CLAY over SHEC's parity against the host path (numpy in, one
    # object), outside the counted run
    cpu_cs = registry.factory("clay", CLAY_SHEC_PROFILE, device="cpu")
    with config.override(ec_host_dispatch_bytes=1 << 40):
        host_par = cpu_cs.encode_chunks(
            {i: to_numpy(cdata[i][:1]) for i in range(ck)})
    for j in host_par:
        check(np.array_equal(host_par[j], to_numpy(cpar[j][:1])),
              f"CLAY over SHEC parity {j} differs from the host path")

    # -- the routes, against the prediction --------------------------------
    on_card = dev.type == "cuda"
    predicted = predict_pipeline(
        on_card, [off // PIPE_UNIT % k for _, off, _ in small])
    # SHEC: the device-resident encode and repair, the corpus encode and
    # decode (bytes go to the codec's device whatever their size)
    predicted["shec"] = (
        {"kernel_encode": 2, "kernel_decode": 2, "launch.gf_apply": 4}
        if on_card else {"plain_encode": 2, "plain_decode": 2})
    predicted["xxhash"] = {"backend.device": 6}
    print("pipeline route split: " + json.dumps(
        {"predicted": predicted, "observed": routes.rows}))
    for phase, want in predicted.items():
        check(routes.rows.get(phase, {}) == want,
              f"pipeline phase {phase} routes {routes.rows.get(phase)}, "
              f"predicted {want}")
    # CLAY over SHEC: its inner-decode count is the layered engine's, so
    # the check is the routes it may take and the kernels it must launch
    clay_row = routes.rows["clay_over_shec"]
    bad = [key for key in clay_row
           if key.startswith(("plain_", "sched_", "host_"))]
    check(on_card and not bad and all(
        clay_row.get(f"launch.{kern}", 0) > 0 for kern in (
            "gf_apply", "clay_uncoupled", "clay_couple_scatter")),
        f"CLAY over SHEC routes {clay_row}: want Kernels A, E and F only")
    for kern in ("gf_apply", "gf_apply_csum", "crc32c_blocks"):
        check(counted.launches[kern] > 0,
              f"kernel {kern} never launched on the pipeline path")
    print(f"pipeline outputs: {PIPE_OBJECTS} objects written, overwritten "
          "(host and device delta routes byte-equal), read degraded, "
          "recovered from the log, shard rebuilt with equal bytes and "
          "attrs, scrubbed clean, one flipped byte found and repaired, "
          "read back equal to the model; SHEC, CLAY over SHEC and xxhash "
          "byte-exact")
    return counted


class StoreRoutes(Routes):
    """``Routes`` plus the ``ec_stream`` counters (``stream.<name>``) and
    the smoke's own call counts (``calls.<name>``): the native tier's
    crc32c and gf_matrix_encode, and ``BlockStore``'s host csum helper."""

    def __init__(self, calls: dict[str, int]) -> None:
        super().__init__()
        self.calls = calls

    def _now(self) -> dict[str, int]:
        from ceph_tpu_torch.pipeline.dispatcher import _stream_counters

        out = Routes._now()
        pc = _stream_counters()
        out.update({f"stream.{n}": pc.get(n) for n in STREAM_KEYS
                    if n != "max_batch"})
        out.update({f"calls.{n}": v for n, v in self.calls.items()})
        return out


@contextlib.contextmanager
def counting_calls(owner, names, calls: dict[str, int]):
    """Replace ``owner.<name>`` for each name by a wrapper that counts
    its calls into ``calls`` (from any thread), and restore it on
    exit: the smoke's view of which route ran, with no counter added
    to the package."""
    import threading

    lock = threading.Lock()
    saved = {name: getattr(owner, name) for name in names}

    def wrapper(name, fn):
        def counted(*args, **kwargs):
            with lock:
                calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return counted

    for name, fn in saved.items():
        calls.setdefault(name, 0)
        setattr(owner, name, wrapper(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(owner, name, fn)


def predict_store(
    on_card: bool, batches: int, batched_ops: int, range_stripes: int
) -> dict[str, dict[str, int]]:
    """The routes of the store path's phases. ``batches`` and
    ``batched_ops`` are the ring's counts in the coalesced write (they
    depend on the threads' timing: the check is that each batch is one
    Kernel B launch and one fused encode) and ``range_stripes`` the
    stripes the ranged degraded reads decode (one native
    ``gf_matrix_encode`` each, on the host GF tables). Every csum block
    a read returns is verified on the host through the native crc
    (``calls.crc32c``, ``backend.host``); a write carrying the kernel's
    csums hashes nothing (no ``calls._csum``), one without them hashes
    its blob once (``calls._csum``, checked apart: the allocator may
    split a blob). On the CPU (a rehearsal) the kernel routes are their
    plain forms and nothing launches."""
    from ceph_tpu_torch.codecs import registry

    k, m = int(PIPE_PROFILE["k"]), int(PIPE_PROFILE["m"])
    n = k + m
    blocks = OBJECT_BYTES // k // CSUM_BLOCK  # per object and shard
    ops = STORE_OBJECTS * OBJECT_BYTES // STORE_APPEND
    route = "kernel" if on_card else "plain"
    flip = 12345 // CSUM_BLOCK  # the flipped byte's csum block

    codec = registry.factory("isa", PIPE_PROFILE, device="cpu")

    def decode(count, lost):
        """``count`` decodes of ``lost`` from the first k survivors (the
        read planner's and recovery's choice): Kernel D where the rows
        are an XOR (a lost data shard beside the all-ones parity 8),
        Kernel A otherwise."""
        present = [s for s in range(n) if s not in lost][:k]
        mat = codec._build_decode_bytes(present, sorted(lost))
        if xor_route(on_card, mat):
            return {"sched_decode": count, "launch.xor_schedule": count}
        out = {f"{route}_decode": count}
        if on_card:
            out["launch.gf_apply"] = count
        return out

    def host_crc(count):
        return {"backend.host": count, "calls.crc32c": count}

    return {
        "coalesced_write": merge_routes(fused_writes(on_card, batches), {
            "stream.ops": ops, "stream.batches": batches,
            "stream.batched_ops": batched_ops}),
        "per_op_write": fused_writes(on_card, ops),
        # the k data shards of every object
        "read_back": host_crc(STORE_OBJECTS * k * blocks),
        # k survivors of every object, shard 0 decoded on the card (shard
        # 9 is a parity: only 0 is rebuilt); the ranges decode each
        # stripe's k survivor blocks on the host
        "degraded_read": merge_routes(
            decode(STORE_OBJECTS, {0}),
            host_crc(STORE_OBJECTS * k * blocks + k * range_stripes),
            {"host_decode": STORE_RANGES,
             "calls.gf_matrix_encode": range_stripes}),
        # k survivors read, shard 9 decoded, verified against HashInfo,
        # then written and hashed once
        "rebuild": merge_routes(decode(STORE_OBJECTS, {STORE_LOST}),
                                hashes(on_card, STORE_OBJECTS),
                                host_crc(STORE_OBJECTS * (k + 1) * blocks)),
        "reopen_read_back": host_crc(STORE_OBJECTS * k * blocks),
        "deep_scrub": merge_routes(hashes(on_card, STORE_OBJECTS * n),
                                   host_crc(STORE_OBJECTS * n * blocks)),
        # the read stops at the bad block; the scrub at it, after the
        # shards before it; the degraded read; the rebuild (as above);
        # the read-back; the clean scrub
        "flipped_byte": merge_routes(
            host_crc(2 * (flip + 1) + STORE_FLIP_SHARD * blocks
                     + 3 * k * blocks + blocks + n * blocks),
            hashes(on_card, STORE_FLIP_SHARD + 1 + n),
            decode(2, {STORE_FLIP_SHARD})),
    }


def store_path(rng, dev) -> Counted:
    """The store path: the EC(8,4) pipeline of the pipeline path over
    12 BlockStore shards (one preallocated device file each, in a
    temporary directory), 64 objects of 4 MiB. 8 PG threads append
    through the streaming dispatcher's ring, a per-op twin writes the
    same appends into fresh stores; then read-back, degraded read,
    rebuild into an empty store, reopen from the device files, deep
    scrub, and one byte flipped under a store. Each phase's routes are
    held against ``predict_store``."""
    import tempfile
    import threading

    from ceph_tpu_torch import native
    from ceph_tpu_torch.checksum import host as host_crc
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.pipeline import (
        HashInfo,
        PGLog,
        ReadPipeline,
        RecoveryBackend,
        StripeInfo,
        be_deep_scrub,
    )
    from ceph_tpu_torch.pipeline.dispatcher import (
        _stream_counters,
        shutdown_all,
    )
    from ceph_tpu_torch.pipeline.rmw import (
        HINFO_KEY,
        OI_KEY,
        RMWPipeline,
        ShardBackend,
        parse_oi,
    )
    from ceph_tpu_torch.store import BlockStore, CsumError, Transaction
    from ceph_tpu_torch.utils import config

    check(native.available(), "the native host tier did not build: "
          + native.build_log[-2000:])
    k, m = int(PIPE_PROFILE["k"]), int(PIPE_PROFILE["m"])
    n = k + m
    size = OBJECT_BYTES
    shard_bytes = size // k
    oids = [f"rbd_data.{i:016x}" for i in range(STORE_OBJECTS)]
    per_pg = STORE_OBJECTS // STORE_THREADS
    pg_oids = [oids[t * per_pg:(t + 1) * per_pg]
               for t in range(STORE_THREADS)]
    model = {oid: rng.integers(0, 256, size, dtype=np.uint8) for oid in oids}
    ranges = [(oids[int(rng.integers(0, len(oids)))],
               int(rng.integers(0, size - STORE_RANGE)))
              for _ in range(STORE_RANGES)]
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_store_")
    root = Path(tmp.name)

    def open_store(name):
        return BlockStore(str(root / name), size=STORE_DEVICE_BYTES,
                          name=name)

    def pg_stack(stores):
        codec = registry.factory("isa", PIPE_PROFILE, device=dev)
        sinfo = StripeInfo(k, m, k * PIPE_UNIT)
        return RMWPipeline(sinfo, codec, ShardBackend(stores),
                           pglog=PGLog(n))

    def append_all(rmw, objs, errors):
        try:
            for oid in objs:
                for off in range(0, size, STORE_APPEND):
                    done = []
                    rmw.submit(oid, off,
                               model[oid][off:off + STORE_APPEND].tobytes(),
                               done.append)
                    check(len(done) == 1 and done[0].error is None,
                          f"append to {oid} at {off} did not commit: {done}")
                check(rmw.hinfo(oid).get_total_chunk_size() == shard_bytes,
                      f"HashInfo of {oid} not extended by every append")
        except Exception as e:  # reported by the joining thread
            errors.append(e)

    def blob_csums(store, oid):
        """{logical offset of a csum block: its csum} of one object:
        independent of where the allocator put the blobs."""
        out = {}
        for boff, blob in store._objects[oid].blobs.items():
            for i, val in enumerate(blob.csums):
                out[boff + i * store.csum_block] = val
        return out

    def state(stores, objs):
        return {s: {oid: (st.read(oid), st.getattrs(oid),
                          blob_csums(st, oid)) for oid in objs}
                for s, st in stores.items()}

    calls: dict[str, int] = {}
    routes = StoreRoutes(calls)
    with contextlib.ExitStack() as stack:
        stack.enter_context(tmp)
        stack.enter_context(counting_calls(
            native, ("crc32c", "gf_matrix_encode"), calls))
        stack.enter_context(counting_calls(BlockStore, ("_csum",), calls))
        stack.enter_context(config.override(
            csum_block_size=CSUM_BLOCK, osd_deep_scrub_stride=524288))
        counted = stack.enter_context(Counted("store"))
        _stream_counters().reset()
        stores = {s: open_store(f"osd.{s}") for s in range(n)}

        # -- 1. coalesced write: 8 PG threads through the ring ----------
        pgs = [pg_stack(stores) for _ in range(STORE_THREADS)]
        errors: list = []
        with config.override(ec_streaming_dispatch=True), \
                routes("coalesced_write"), \
                Phase("store_coalesced_write", STORE_OBJECTS * size):
            threads = [threading.Thread(target=append_all,
                                        args=(pgs[t], pg_oids[t], errors),
                                        name=f"pg-{t}")
                       for t in range(STORE_THREADS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
            check(not any(th.is_alive() for th in threads),
                  "a PG thread of the coalesced write hung")
        if errors:
            raise errors[0]
        stream = {n_: _stream_counters().get(n_) for n_ in STREAM_KEYS}
        shutdown_all()
        print(f"store path ec_stream: {stream}")

        # -- 2. the per-op twin: the same appends, one thread, no ring --
        twin = {s: open_store(f"twin.{s}") for s in range(n)}
        twin_pgs = [pg_stack(twin) for _ in range(STORE_THREADS)]
        with config.override(ec_streaming_dispatch=False), \
                routes("per_op_write"), \
                Phase("store_per_op_write", STORE_OBJECTS * size):
            for t in range(STORE_THREADS):
                append_all(twin_pgs[t], pg_oids[t], errors)
                if errors:
                    raise errors[0]
        check(state(twin, oids) == state(stores, oids),
              "the per-op twin stored other bytes, attrs or blob csums "
              "than the coalesced write")
        for st in twin.values():
            st.close()
        del twin, twin_pgs, pgs
        wall = {r["phase"]: r["wall_ms"] for r in Phase.results}
        print("store path write: " + "; ".join(
            f"{what} {wall[f'store_{phase}']:.3f} ms (host clock), "
            f"{routes.rows[phase].get('launch.gf_apply_csum', 0)} Kernel B "
            "launches" for what, phase in (("coalesced", "coalesced_write"),
                                           ("per-op", "per_op_write"))))

        # a stack that knows every object from its stored attrs
        def read_stack(stores):
            rmw = pg_stack(stores)
            for oid in oids:
                osize, ev = parse_oi(stores[0].getattr(oid, OI_KEY))
                rmw.prime_object(oid, osize, HashInfo.from_bytes(
                    stores[0].getattr(oid, HINFO_KEY), dev), ev)
            reads = ReadPipeline(rmw.sinfo, rmw.codec, rmw.backend,
                                 rmw.object_size)
            rec = RecoveryBackend(rmw.sinfo, rmw.codec, rmw.backend,
                                  rmw.object_size, rmw.hinfo,
                                  eversion_fn=rmw.object_eversion)
            return rmw, reads, rec

        rmw, reads, rec = read_stack(stores)
        backend, sinfo = rmw.backend, rmw.sinfo

        # -- 3. read-back with every shard up ----------------------------
        with routes("read_back"), Phase("store_read_back",
                                        STORE_OBJECTS * size):
            for oid in oids:
                check(reads.read_sync(oid, 0, size) == model[oid].tobytes(),
                      f"{oid} reads back other bytes than were written")

        # -- 4. degraded read, shards 0 and 9 down -----------------------
        backend.down_shards.update(STORE_READ_DOWN)
        with routes("degraded_read"), Phase(
                "store_degraded_read",
                STORE_OBJECTS * size + STORE_RANGES * STORE_RANGE):
            for oid in oids:
                check(reads.read_sync(oid, 0, size) == model[oid].tobytes(),
                      f"degraded read of {oid} differs from the model")
            for oid, off in ranges:
                check(reads.read_sync(oid, off, STORE_RANGE)
                      == model[oid][off:off + STORE_RANGE].tobytes(),
                      f"degraded range {oid}@{off} differs from the model")
        backend.down_shards.clear()

        # -- 5. rebuild of shard 9 into an empty store -------------------
        lost = stores[STORE_LOST]
        pre = state({0: lost}, oids)[0]
        backend.stores[STORE_LOST] = open_store(f"osd.{STORE_LOST}.new")
        with routes("rebuild"), Phase("store_rebuild_shard",
                                      STORE_OBJECTS * k * shard_bytes):
            for oid in oids:
                rec.recover_object(oid, {STORE_LOST})
        rebuilt = {oid: (v[0], v[1]) for oid, v in
                   state({0: backend.stores[STORE_LOST]}, oids)[0].items()}
        check(rebuilt == {oid: (v[0], v[1]) for oid, v in pre.items()},
              f"shard {STORE_LOST} rebuilt with other bytes or attrs")
        lost.close()
        del pre, rebuilt, lost

        # -- 6. close every store, reopen from its device file ----------
        roots = {s: st.root for s, st in backend.stores.items()}
        for st in backend.stores.values():
            st.close()
        with routes("reopen_read_back"), Phase("store_reopen_read_back",
                                               STORE_OBJECTS * size):
            stores = {s: BlockStore(roots[s], size=STORE_DEVICE_BYTES,
                                    name=Path(roots[s]).name)
                      for s in range(n)}
            rmw, reads, rec = read_stack(stores)
            backend, sinfo = rmw.backend, rmw.sinfo
            for oid in oids:
                check(reads.read_sync(oid, 0, size) == model[oid].tobytes(),
                      f"{oid} reads back other bytes after the reopen")

        # -- 7. deep scrub on Kernel C ------------------------------------
        with routes("deep_scrub"), Phase("store_deep_scrub",
                                         STORE_OBJECTS * n * shard_bytes):
            scrubs = {oid: be_deep_scrub(sinfo, backend, oid, device=dev)
                      for oid in oids}
        for oid, res in scrubs.items():
            check(res.ok, f"scrub of {oid}: {res.errors}")

        # -- 8. one byte flipped in shard 3's device file ----------------
        victim = oids[0]
        st = stores[STORE_FLIP_SHARD]
        at = 12345  # a byte of the victim's shard
        boff = max(b for b in st._objects[victim].blobs if b <= at)
        dev_off = st._objects[victim].blobs[boff].offset + at - boff
        st.close()
        with open(st.device_path, "r+b") as f:
            f.seek(dev_off)
            byte = f.read(1)[0]
            f.seek(dev_off)
            f.write(bytes([byte ^ 0x5A]))
        st = stores[STORE_FLIP_SHARD] = backend.stores[STORE_FLIP_SHARD] = \
            BlockStore(roots[STORE_FLIP_SHARD], size=STORE_DEVICE_BYTES)
        outcome = {}
        with routes("flipped_byte"), Phase("store_flipped_byte",
                                           3 * size + n * shard_bytes):
            for what, call in (
                ("read", lambda: st.read(victim)),
                ("scrub", lambda: be_deep_scrub(sinfo, backend, victim,
                                                device=dev)),
            ):
                try:
                    call()
                    outcome[what] = None
                except CsumError as e:
                    outcome[what] = e
            backend.down_shards.add(STORE_FLIP_SHARD)
            degraded = reads.read_sync(victim, 0, size)
            backend.down_shards.clear()
            st.queue_transactions(Transaction().remove(victim))
            rec.recover_object(victim, {STORE_FLIP_SHARD})
            healed = reads.read_sync(victim, 0, size)
            fixed = be_deep_scrub(sinfo, backend, victim, device=dev)
        check(isinstance(outcome["read"], IOError),
              "a read over the flipped byte returned bytes instead of "
              "raising CsumError")
        check(isinstance(outcome["scrub"], CsumError),
              "the deep scrub over the flipped byte did not raise the "
              "store's CsumError, as ceph_tpu's does")
        check(degraded == model[victim].tobytes(),
              "the degraded read around the flipped byte differs")
        check(healed == model[victim].tobytes(),
              "the read-back after the rebuild differs")
        check(fixed.ok, f"scrub after the rebuild: {fixed.errors}")
        for st in stores.values():
            st.close()

    on_card = dev.type == "cuda"
    rows = routes.rows
    ops = STORE_OBJECTS * size // STORE_APPEND
    wrote = rows["coalesced_write"]
    batches = wrote.get("stream.batches", 0)
    check(wrote.get("stream.ops") == ops,
          f"ec_stream.ops {wrote.get('stream.ops')}, want {ops}")
    check(stream["max_batch"] >= 2 and stream["batched_ops"] > 0,
          f"the ring never batched: {stream}")
    check(stream["batch_faults"] == 0 and stream["solo_retries"] == 0,
          f"the ring split batches: {stream}")
    range_stripes = rows["degraded_read"].get("calls.gf_matrix_encode", 0)
    check(STORE_RANGES * 2 <= range_stripes <= STORE_RANGES * 3,
          f"the ranged reads decoded {range_stripes} stripes")
    for phase, want in (("rebuild", STORE_OBJECTS), ("flipped_byte", 1)):
        hashed = rows[phase].pop("calls._csum", 0)
        check(hashed >= want, f"store phase {phase} hashed {hashed} blobs "
              f"on the host, want one or more per rebuilt object")
    predicted = predict_store(on_card, batches, stream["batched_ops"],
                              range_stripes)
    print("store route split: " + json.dumps(
        {"predicted": predicted, "observed": rows}))
    for phase, want in predicted.items():
        check(rows.get(phase, {}) == want,
              f"store phase {phase} routes {rows.get(phase)}, predicted "
              f"{want}")
    check(host_crc.native_selected(),
          "checksum.host.crc32c did not select the native tier")
    print(f"store outputs: {STORE_OBJECTS} objects appended by "
          f"{STORE_THREADS} PG threads through the ring "
          f"({batches} Kernel B launches for {ops} ops, max batch "
          f"{stream['max_batch']}), equal to the per-op twin's bytes, attrs "
          "and blob csums; read back, read degraded, shard rebuilt with "
          "equal bytes and attrs, reopened from the device files, scrubbed "
          "clean; a flipped byte raised CsumError on read and scrub, read "
          "degraded exact, rebuilt and scrubbed clean")
    return counted


class ClusterRoutes(Routes):
    """``Routes`` plus the ring's ``ec_stream`` counters
    (``stream.<name>``), the daemons' ``osd.N.coalesce`` counters summed
    over every daemon started (``coalesce.<name>``; a returning OSD is a
    new daemon with counters of its own) and the decode calls the
    codecs took (``ClusterRoutes.decodes``: present shards, wanted
    shards, input bytes, whether the input was on the host), which
    ``predict_cluster`` routes by their matrices."""

    COALESCE_KEYS = ("op_coalesced", "subwrite_batches",
                     "subwrite_batched_ops")

    def __init__(self, daemons: list) -> None:
        super().__init__()
        self.daemons = daemons  # every daemon started, stopped ones too
        self.decodes: list[tuple] = []
        #: the codec that took each decode of ``decodes`` (its matrix
        #: routes the call)
        self.codecs: list = []
        self.phase_decodes: dict[str, list[tuple]] = {}
        self.phase_codecs: dict[str, list] = {}

    def _now(self) -> dict[str, int]:
        from ceph_tpu_torch.pipeline.dispatcher import _stream_counters

        out = Routes._now()
        pc = _stream_counters()
        out.update({f"stream.{n}": pc.get(n) for n in STREAM_KEYS
                    if n != "max_batch"})
        for key in self.COALESCE_KEYS:
            out[f"coalesce.{key}"] = sum(
                d.coalesce_pc.get(key) for d in list(self.daemons))
        return out

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = len(self.decodes)
        with Routes.__call__(self, name):
            yield
        self.phase_decodes[name] = self.decodes[start:]
        self.phase_codecs[name] = self.codecs[start:]

    @contextlib.contextmanager
    def recording(self):
        """Record every ISA decode (``MatrixErasureCodec.decode_chunks``)
        from any thread, and restore the method on exit."""
        import threading

        import torch

        from ceph_tpu_torch.codecs.matrix_codec import MatrixErasureCodec

        lock = threading.Lock()
        orig = MatrixErasureCodec.decode_chunks

        def decode_chunks(codec, want_to_read, chunks):
            want = tuple(sorted(w for w in want_to_read if w not in chunks))
            if want:
                bufs = list(chunks.values())
                call = (tuple(sorted(chunks)), want,
                        sum(int(b.nbytes) for b in bufs),
                        not any(isinstance(b, torch.Tensor) for b in bufs))
                with lock:
                    self.decodes.append(call)
                    self.codecs.append(codec)
            return orig(codec, want_to_read, chunks)

        MatrixErasureCodec.decode_chunks = decode_chunks
        try:
            yield self
        finally:
            MatrixErasureCodec.decode_chunks = orig


def wait_settled(mon, live, what: str, deadline_s: float = 300.0) -> None:
    """Wait until a cluster is quiet: no pg_temp, every PG a live daemon
    leads peered, no catch-up, backfill or peering pass in flight. Fails
    loudly at the deadline."""
    end = time.monotonic() + deadline_s
    while True:
        busy = [("pg_temp", key) for key in mon.osdmap.pg_temp]
        for d in live:
            with d._pg_lock:
                pgs = list(d._pgs.items())
            for (pl, pgid), pg in pgs:
                if pg._catchup_inflight or pg.fsm._draining:
                    busy.append((d.osd_id, pgid, "recovering"))
                elif (mon.osdmap.pg_primary(pl, pgid) == d.osd_id
                      and not pg.peered.is_set()):
                    busy.append((d.osd_id, pgid, "peering"))
            busy += [(d.osd_id, key, "backfill")
                     for key, th in list(d._backfills.items())
                     if th.is_alive()]
        if not busy:
            return
        check(time.monotonic() < end, f"the cluster did not settle "
              f"{what} within {deadline_s} s: {busy[:8]}")
        time.sleep(0.05)


def cluster_reads(osdmap, pool: str, oids, k: int, n: int) -> list[tuple]:
    """The decode each whole-object read of ``oids`` needs under
    ``osdmap``: the lost data positions (holes below k) from the first k
    live positions; none when only parity positions are lost."""
    from ceph_tpu_torch.cluster.osdmap import SHARD_NONE

    out = []
    for oid in oids:
        acting = osdmap.object_to_acting(pool, oid)
        holes = {i for i, o in enumerate(acting) if o == SHARD_NONE}
        want = tuple(sorted(h for h in holes if h < k))
        if want:
            present = tuple([i for i in range(n) if i not in holes][:k])
            out.append((present, want))
    return out


def predict_cluster(
    on_card: bool, decodes: dict[str, list[tuple]], ring: dict[str, int],
    scrubbed: dict[str, int], verifies: dict[str, int],
) -> dict[str, dict[str, int]]:
    """The routes of the cluster path's phases, from the op sizes and,
    for every decode the codecs took, its matrix: a whole 4 MiB write
    is one fused encode+csum (Kernel B) — too large for a ring slot, so
    it runs per op even with ``ec_streaming_dispatch`` on — while the
    128 KiB writes of the ring phase stage in the ring, one Kernel B
    launch a batch (``ring``: the ring's batches and batched ops, which
    depend on the clients' timing); a 4 KiB overwrite is a parity delta on the
    host GF tables; a decode whose input is at or below
    ``ec_host_dispatch_bytes`` on the host takes the host tables, one
    whose rows are an XOR (a lost data shard beside the all-ones parity
    8) Kernel D, any other Kernel A; deep scrub hashes every live shard
    of every object last written whole once on Kernel C (``scrubbed``:
    the shards of a pass), and a repair verifies the rebuilt shard once
    more.
    Recovery verifies each object it rebuilt whole against its
    HashInfo: ``verifies`` holds their count, which follows the PG
    logs, and the prediction holds their route (Kernel C). On the CPU (a rehearsal) the kernel routes are
    their plain forms and nothing launches."""
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.utils import config

    limit = int(config.get("ec_host_dispatch_bytes"))
    codec = registry.factory("isa", PIPE_PROFILE, device="cpu")

    def decoded(phase):
        return merge_routes(*(decode_route(on_card, codec, call, limit)
                              for call in decodes.get(phase, [])))

    return {
        "write": fused_writes(on_card, CLUSTER_OBJECTS),
        "write_streaming": fused_writes(on_card, CLUSTER_OBJECTS),
        "write_ring": merge_routes(fused_writes(on_card, ring["batches"]), {
            "stream.ops": CLUSTER_OBJECTS,
            "stream.batches": ring["batches"],
            "stream.batched_ops": ring["batched_ops"]}),
        "read": {},
        "overwrite": {"host_delta": CLUSTER_OVERWRITES},
        "degraded_read": decoded("degraded_read"),
        "degraded_write": fused_writes(on_card, CLUSTER_DEGRADED_WRITES),
        "catch_up": merge_routes(decoded("catch_up"),
                                 hashes(on_card, verifies["catch_up"])),
        "backfill": merge_routes(decoded("backfill"),
                                 hashes(on_card, verifies["backfill"])),
        "read_recovered": decoded("read_recovered"),
        "deep_scrub": hashes(on_card, scrubbed["deep_scrub"]),
        "flipped_byte_scrub": hashes(on_card,
                                     scrubbed["flipped_byte_scrub"]),
        "repair": merge_routes(hashes(on_card, scrubbed["repair"] + 1),
                               decoded("repair")),
        "scrub_after_repair": hashes(on_card,
                                     scrubbed["scrub_after_repair"]),
    }


def run_threads(jobs, what: str, timeout: float = 600) -> None:
    """Run each callable of ``jobs`` on a thread of its own and join
    them; raise the first error, and fail if a thread outlives
    ``timeout``."""
    errors: list = []

    def run(job):
        try:
            job()
        except Exception as e:  # reported by the joining thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(job,), name=f"{what}-{t}")
               for t, job in enumerate(jobs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout)
    check(not any(th.is_alive() for th in threads), f"a {what} thread hung")
    if errors:
        raise errors[0]


class SmokeCluster:
    """The daemons and clients of a cluster path: ``OSDDaemon``s on the
    card at the pipeline's stripe unit, each stamped at boot, and
    ``CLUSTER_CLIENTS`` client threads, each on its own
    ``RadosClient`` over TCP on loopback."""

    def __init__(self, dev, pool: str, name: str) -> None:
        self.dev, self.pool, self.name = dev, pool, name
        #: every daemon started, stopped ones too (``ClusterRoutes``
        #: sums their counters)
        self.started: list = []
        self.open_clients: list = []
        self.ioctxs: list = []

    def start_osd(self, mon, i: int, store=None):
        from ceph_tpu_torch.cluster import OSDDaemon

        d = OSDDaemon(i, mon, store=store, chunk_size=PIPE_UNIT,
                      tick_period=CLUSTER_TICK, device=self.dev)
        # The tick's scrub scheduler takes a PG it has never scrubbed
        # as due at once (its stamps start at 0; Ceph stamps a PG when
        # the pool creates it), so every PG would deep-scrub one tick
        # after boot, and again on each new primary, with launches in
        # every phase. The smoke stamps them (before the pool exists,
        # and before the daemon's first tick) as Ceph's pool creation
        # does, and scrubs in a phase of its own.
        now = time.monotonic()
        d._scrub_stamps.update(
            {(self.pool, pg): [now, now] for pg in range(CLUSTER_PG_NUM)})
        self.started.append(d)
        d.start()
        return d

    def connect(self, mon) -> None:
        from ceph_tpu_torch.cluster import RadosClient

        for _ in range(CLUSTER_CLIENTS):
            client = RadosClient(mon, backoff=0.01)
            self.open_clients.append(client)
            self.ioctxs.append(client.open_ioctx(self.pool))

    def clients(self, fn, items) -> None:
        """``fn(ioctx, item)`` over ``items``, one thread a client."""
        def serve(io, part):
            for item in part:
                fn(io, item)

        n = len(self.ioctxs)
        run_threads([functools.partial(serve, io, items[t::n])
                     for t, io in enumerate(self.ioctxs)],
                     f"{self.name}-client")

    def stop_all(self) -> None:
        from ceph_tpu_torch.pipeline.dispatcher import shutdown_all

        while self.open_clients:
            self.open_clients.pop().shutdown()
        self.ioctxs.clear()
        for d in self.started:
            if not d._stopped:
                d.stop()
        shutdown_all()


def read_back(model, io, oid: str) -> None:
    check(io.read(oid) == model[oid].tobytes(),
          f"{oid} read back other bytes than the model's")


def scrub_live(live, repair: bool = False) -> dict:
    """``scrub_all`` on every live daemon at once, as each OSD scrubs
    the PGs it leads on its own (each paced by its own mClock scrub
    class): {loc: ScrubResult}."""
    out: dict = {}

    def one(d):
        for results in d.scrub_all(repair=repair).values():
            for res in results:
                out[res.oid] = res

    run_threads([functools.partial(one, d) for d in live], "scrub")
    return out


def hashed_shards(mon, pool: str, daemons, locs) -> int:
    """The live shards of the objects ``locs`` (heads or clones) that a
    deep scrub hashes on the card: those of objects whose HashInfo (read
    from a live shard's HINFO attr) holds shard hashes, at
    ``csum_device_min_bytes`` or more a shard. A 4 KiB overwrite clears
    the hashes, and so does a ``write_full`` over an object that has
    them (it overwrites before it truncates); a ``write_full`` over a
    cleared object hashes afresh."""
    from ceph_tpu_torch.cluster.osd_daemon import SNAP_SEP, shard_key
    from ceph_tpu_torch.cluster.osdmap import SHARD_NONE
    from ceph_tpu_torch.pipeline.rmw import HINFO_KEY
    from ceph_tpu_torch.utils import config

    floor = int(config.get("csum_device_min_bytes"))
    total = 0
    for loc in locs:
        oid = loc.split(":", 1)[1].split(SNAP_SEP, 1)[0]
        acting = mon.osdmap.object_to_acting(pool, oid)
        live_pos = [i for i, o in enumerate(acting) if o != SHARD_NONE]
        st = daemons[acting[live_pos[0]]].store
        key = shard_key(loc, live_pos[0])
        hinfo = json.loads(st.getattr(key, HINFO_KEY))
        if hinfo["total_chunk_size"] and st.stat(key) >= floor:
            total += len(live_pos)
    return total


def cluster_path(rng, dev) -> Counted:
    """The cluster path: a ``Monitor``, 12 ``OSDDaemon``s on the card
    over ``MemStore``s, one ISA EC(8,4) pool of 32 PGs, and 16 client
    threads, each with its own ``RadosClient`` over TCP on loopback.
    Writes, the ring's batched writes, read-back, overwrites, a degraded
    read with two OSDs down, writes while they are down, the return of
    one (catch-up from the log) and the other marked out (backfill), a
    read with a third down, deep scrub, and one flipped byte found,
    repaired and scrubbed clean. Each phase's routes are held against
    ``predict_cluster``, each read against a numpy model."""
    from ceph_tpu_torch.cluster import Monitor
    from ceph_tpu_torch.cluster.osd_daemon import make_loc, shard_key
    from ceph_tpu_torch.cluster.osdmap import SHARD_NONE
    from ceph_tpu_torch.pipeline.dispatcher import _stream_counters
    from ceph_tpu_torch.pipeline.rmw import HINFO_KEY
    from ceph_tpu_torch.store import Transaction
    from ceph_tpu_torch.utils import config

    k, m = int(PIPE_PROFILE["k"]), int(PIPE_PROFILE["m"])
    n = k + m
    size = OBJECT_BYTES
    pool = "rbd"
    oids = [f"rbd_data.{i:016x}" for i in range(CLUSTER_OBJECTS)]
    small = [f"rbd_header.{i:016x}" for i in range(CLUSTER_OBJECTS)]
    model = {oid: rng.integers(0, 256, size, dtype=np.uint8) for oid in oids}
    small_model = {oid: rng.integers(0, 256, CLUSTER_SMALL, dtype=np.uint8)
                   for oid in small}
    down_a, down_b = CLUSTER_DOWN
    cl = SmokeCluster(dev, pool, "cluster")
    clients = cl.clients
    read_all = functools.partial(read_back, model)

    def boot():
        """A monitor, the daemons, the pool, and CLUSTER_CLIENTS
        clients, connected before any phase's clock starts."""
        mon = Monitor(device=dev)
        for i in range(CLUSTER_OSDS):
            mon.osd_crush_add(i)
        daemons = [cl.start_osd(mon, i) for i in range(CLUSTER_OSDS)]
        mon.osd_erasure_code_profile_set(
            "isa84", {"plugin": "isa", **PIPE_PROFILE})
        mon.osd_pool_create(pool, CLUSTER_PG_NUM, "isa84")
        cl.connect(mon)
        return mon, daemons

    def settle(live, what, deadline_s=300.0):
        wait_settled(mon, live, what, deadline_s)

    def stores_of(daemons, objs):
        """{osd: {shard key: (bytes, HINFO attr)}} of ``objs``."""
        pool_id = mon.osdmap.pools[pool].pool_id
        locs = {make_loc(pool_id, oid) for oid in objs}
        out = {}
        for d in daemons:
            st = d.store
            out[d.osd_id] = {
                key: (st.read(key), st.getattr(key, HINFO_KEY))
                for key in st.list_objects()
                if key.partition("#")[0] in locs
            }
        return out

    def hashed(objs):
        pool_id = mon.osdmap.pools[pool].pool_id
        return hashed_shards(mon, pool, daemons,
                             [make_loc(pool_id, oid) for oid in objs])

    routes = ClusterRoutes(cl.started)
    write_bytes = CLUSTER_OBJECTS * size
    with contextlib.ExitStack() as stack:
        stack.callback(cl.stop_all)
        stack.enter_context(config.override(
            csum_block_size=CSUM_BLOCK, osd_deep_scrub_stride=524288))
        counted = stack.enter_context(Counted("cluster"))
        stack.enter_context(routes.recording())
        _stream_counters().reset()

        # -- 1. write every object, ec_streaming_dispatch off -----------
        mon, daemons = boot()
        with config.override(ec_streaming_dispatch=False), \
                routes("write"), Phase("cluster_write", write_bytes):
            clients(lambda io, oid: io.write_full(oid, model[oid].tobytes()),
                    oids)
        first = stores_of(daemons, oids)
        cl.stop_all()

        # -- 2. the same over fresh stores, ec_streaming_dispatch on ----
        mon, daemons = boot()
        with config.override(ec_streaming_dispatch=True):
            with routes("write_streaming"), \
                    Phase("cluster_write_streaming", write_bytes):
                clients(lambda io, oid: io.write_full(
                    oid, model[oid].tobytes()), oids)
            check(stores_of(daemons, oids) == first,
                  "the stores after the streaming write differ from the "
                  "first write's in bytes or HINFO")
            del first
            # 128 KiB objects fit a ring slot: batched Kernel B launches
            with routes("write_ring"), Phase(
                    "cluster_write_ring", CLUSTER_OBJECTS * CLUSTER_SMALL):
                clients(lambda io, oid: io.write_full(
                    oid, small_model[oid].tobytes()), small)
        stream = {n_: _stream_counters().get(n_) for n_ in STREAM_KEYS}
        print(f"cluster path ec_stream: {stream}")

        def read_small(io, oid):
            check(io.read(oid) == small_model[oid].tobytes(),
                  f"{oid} read back other bytes than were written")
            io.remove(oid)

        clients(read_small, small)

        # -- 3. read-back of every object -------------------------------
        with routes("read"), Phase("cluster_read", write_bytes):
            clients(read_all, oids)

        # -- 4. overwrites of 4 KiB at seeded offsets -------------------
        patches = [(oids[int(rng.integers(0, len(oids)))],
                    int(rng.integers(0, size // PIPE_UNIT)) * PIPE_UNIT,
                    rng.integers(0, 256, PIPE_UNIT, dtype=np.uint8))
                   for _ in range(CLUSTER_OVERWRITES)]
        io = cl.ioctxs[0]
        with routes("overwrite"), Phase(
                "cluster_overwrite", CLUSTER_OVERWRITES * PIPE_UNIT):
            for oid, off, patch in patches:
                io.write(oid, patch.tobytes(), offset=off)
                model[oid][off:off + PIPE_UNIT] = patch
        for oid in sorted({p[0] for p in patches}):
            read_all(io, oid)

        # -- 5. two OSDs stopped and marked down: degraded read ---------
        for i in CLUSTER_DOWN:
            daemons[i].stop()
            mon.osd_down(i)
        live = [d for d in daemons if d.osd_id not in CLUSTER_DOWN]
        settle(live, "after two OSDs went down")
        want_reads = cluster_reads(mon.osdmap, pool, oids, k, n)
        with routes("degraded_read"), Phase("cluster_degraded_read",
                                            write_bytes):
            clients(read_all, oids)
        rewritten = oids[:CLUSTER_DEGRADED_WRITES]
        for oid in rewritten:
            model[oid] = rng.integers(0, 256, size, dtype=np.uint8)
        with routes("degraded_write"), Phase(
                "cluster_degraded_write", len(rewritten) * size):
            clients(lambda io, oid: io.write_full(oid, model[oid].tobytes()),
                    rewritten)

        # -- 6. one returns and catches up, the other goes out ----------
        with routes("catch_up"), Phase("cluster_catch_up",
                                       len(rewritten) * size):
            daemons[down_a] = cl.start_osd(mon, down_a,
                                           daemons[down_a].store)
            live.append(daemons[down_a])
            settle(live, f"after osd.{down_a} returned")
        catch_up_want = {pos for oid in oids for pos, o in enumerate(
            mon.osdmap.object_to_acting(pool, oid)) if o == down_a}
        with routes("backfill"), Phase("cluster_backfill", write_bytes):
            mon.osd_out(down_b)
            settle(live, f"after osd.{down_b} went out")
        third = CLUSTER_THIRD
        daemons[third].stop()
        mon.osd_down(third)
        live = [d for d in live if d.osd_id != third]
        settle(live, f"after osd.{third} went down")
        want_recovered = cluster_reads(mon.osdmap, pool, oids, k, n)
        with routes("read_recovered"), Phase("cluster_read_recovered",
                                             write_bytes):
            clients(read_all, oids)

        # -- 7. deep scrub, a flipped byte, repair ----------------------
        shard_bytes = size // k
        scrubbed = {"deep_scrub": hashed(oids)}
        with routes("deep_scrub"), Phase(
                "cluster_deep_scrub", scrubbed["deep_scrub"] * shard_bytes):
            results = scrub_live(live)
        check(len(results) == len(oids)
              and all(r.ok for r in results.values()),
              f"deep scrub not clean: "
              f"{[(o, r.errors) for o, r in results.items() if not r.ok]}")
        pool_id = mon.osdmap.pools[pool].pool_id
        victim = next(oid for oid in rewritten if hashed([oid]))
        acting = mon.osdmap.object_to_acting(pool, victim)
        pos = next(i for i in range(k - 1, -1, -1) if acting[i] != SHARD_NONE)
        key = shard_key(make_loc(pool_id, victim), pos)
        store = daemons[acting[pos]].store
        at = 12345
        byte = store.read(key, at, 1)[0]
        store.queue_transactions(Transaction().write(
            key, at, bytes([byte ^ 0x5A])))
        # the victim's PG alone finds it; the repair pass takes them all
        pgid = mon.osdmap.object_to_pg(pool, victim)
        pg_objs = [oid for oid in oids
                   if mon.osdmap.object_to_pg(pool, oid) == pgid]
        scrubbed["flipped_byte_scrub"] = hashed(pg_objs)
        with routes("flipped_byte_scrub"), Phase(
                "cluster_flipped_byte_scrub",
                scrubbed["flipped_byte_scrub"] * shard_bytes):
            found = daemons[mon.osdmap.primary(pool, victim)].scrub_pg(
                pool, pgid)
        bad = {r.oid: sorted({e.shard for e in r.errors})
               for r in found if not r.ok}
        check(bad == {make_loc(pool_id, victim): [pos]},
              f"the scrub over the flipped byte reported {bad}, want "
              f"{victim} shard {pos}")
        scrubbed["repair"] = scrubbed["deep_scrub"]
        with routes("repair"), Phase("cluster_repair",
                                     scrubbed["repair"] * shard_bytes):
            fixed = scrub_live(live, repair=True)
        check([o for o, r in fixed.items() if getattr(r, "repaired", False)]
              == [make_loc(pool_id, victim)],
              "the repair pass did not repair exactly the flipped object")
        scrubbed["scrub_after_repair"] = hashed(oids)
        with routes("scrub_after_repair"), Phase(
                "cluster_scrub_after_repair",
                scrubbed["scrub_after_repair"] * shard_bytes):
            again = scrub_live(live)
        check(all(r.ok for r in again.values()),
              "the scrub after the repair is not clean")
        read_all(io, victim)

    on_card = dev.type == "cuda"
    rows = routes.rows
    decodes = routes.phase_decodes
    for phase, want in (("degraded_read", want_reads),
                        ("read_recovered", want_recovered)):
        got = sorted(call[:2] for call in decodes[phase])
        check(got == sorted(want), f"cluster phase {phase} decoded "
              f"{got}, the map asks for {sorted(want)}")
    check(all(call[1] and set(call[1]) <= catch_up_want
              for call in decodes["catch_up"]),
          f"the catch-up rebuilt other shards than osd.{down_a}'s: "
          f"{decodes['catch_up']}")
    ring = {"batches": rows["write_ring"].get("stream.batches", 0),
            "batched_ops": rows["write_ring"].get("stream.batched_ops", 0)}
    check(stream["batch_faults"] == 0 and stream["solo_retries"] == 0,
          f"the ring split batches: {stream}")
    verifies = {phase: sum(v for key, v in rows[phase].items()
                           if key.startswith("backend."))
                for phase in ("catch_up", "backfill")}
    coalesce = {phase: {key: row.pop(f"coalesce.{key}", 0)
                        for key in ClusterRoutes.COALESCE_KEYS}
                for phase, row in rows.items()}
    coalesced = {phase: c["op_coalesced"] for phase, c in coalesce.items()}
    client_writes = {"write": CLUSTER_OBJECTS,
                     "write_streaming": CLUSTER_OBJECTS,
                     "write_ring": CLUSTER_OBJECTS,
                     "overwrite": CLUSTER_OVERWRITES,
                     "degraded_write": CLUSTER_DEGRADED_WRITES}
    for phase, ops in coalesced.items():
        check(ops <= client_writes.get(phase, 0),
              f"cluster phase {phase}: {ops} ops coalesced, more than its "
              f"{client_writes.get(phase, 0)} client writes")
    print("cluster coalesce counters: " + json.dumps(
        {p: c for p, c in coalesce.items() if any(c.values())}))
    predicted = predict_cluster(on_card, decodes, ring, scrubbed, verifies)
    print("cluster route split: " + json.dumps(
        {"predicted": predicted, "observed": rows}))
    for phase, want in predicted.items():
        check(rows.get(phase, {}) == want,
              f"cluster phase {phase} routes {rows.get(phase)}, predicted "
              f"{want}")
    launches = rows["write_ring"].get("launch.gf_apply_csum", 0)
    print(f"cluster outputs: {CLUSTER_OBJECTS} objects of {size} B written "
          f"twice by {CLUSTER_CLIENTS} clients over TCP (one Kernel B "
          f"launch an op, stores equal in bytes and HINFO), "
          f"{CLUSTER_OBJECTS} objects of {CLUSTER_SMALL} B through the "
          f"ring ({ring['batches']} batches, {launches} Kernel B launches, "
          f"{ring['batched_ops']} batched ops), read back, overwritten, "
          f"read degraded with osd.{down_a} and osd.{down_b} down, "
          f"{len(rewritten)} rewritten, osd.{down_a} caught up, "
          f"osd.{down_b} backfilled out, read with osd.{third} down, "
          "scrubbed clean; a flipped byte found, repaired and scrubbed "
          "clean")
    return counted


# -- the bench CLI, loadgen and quorum paths -------------------------------

#: the bench CLI path: ``ceph_erasure_code_benchmark``'s four codec
#: workloads at their default sizes (80 MiB a call, 100 iterations; 64 MiB
#: for the checksum)
BENCH_WORKLOADS = (
    ("encode", ["encode", "--plugin", "isa", "-P", "k=8", "-P", "m=4"]),
    ("decode", ["decode", "--plugin", "isa", "-P", "k=8", "-P", "m=4",
                "--erasures", "2", "--erasures-generation", "exhaustive"]),
    ("repair", ["repair", "--plugin", "clay", "-P", "k=8", "-P", "m=4",
                "-P", "d=11"]),
    ("checksum", ["checksum", "--csum-alg", "crc32c", "--csum-block",
                  str(CSUM_BLOCK), "--size", str(64 * MIB)]),
)
#: the loadgen path: the repo's ``mixed`` preset (600 ops of 256 KiB
#: objects over 128 objects, queue depth 16, zipfian) on 12 OSDs, jerasure
#: reed_sol_van EC(8,4) (LoadCluster's default plugin; its parity rows are
#: not 0/1, so no decode is an XOR) at a 4 KiB stripe unit, 32 PGs, the
#: most-primary OSD killed at op 200 and revived at op 400
LOADGEN_ARGV = ["loadgen", "--preset", "mixed", "-P", "k=8", "-P", "m=4",
                "--osds", "12", "--pg-num", "32", "--chunk-size", "4096",
                "--fault-at", "200", "--revive-at", "400", "--device-clock",
                "--trace-capture", "8"]
#: the host/device crossovers of the loadgen run: the defaults (1 MiB for
#: codec inputs, 256 KiB for checksum streams) keep every call of a 256 KiB
#: object on the host; at these a whole-object decode (256 KiB of
#: survivors) and a shard's hash (32 KiB) take the card, a 2 KiB RMW
#: delta stays on the host tables
LOADGEN_OVERRIDES = {"ec_host_dispatch_bytes": 64 * 1024,
                     "csum_device_min_bytes": 32 * 1024,
                     # the smoke scrubs once, itself, after the run: the
                     # daemons' scheduler would scrub every PG whose stamp
                     # (0 at boot) is an interval older than the host's
                     # monotonic clock, in any phase, on some hosts only
                     "osd_scrub_min_interval": 1e12,
                     "osd_deep_scrub_interval": 1e12}
LOADGEN_CLASSES = ("seq_write", "rand_write", "read", "reconstruct_read",
                   "rmw_overwrite")
#: DeviceClock.measure's encodes: one warm-up, then 3 runs of 24
DEVICE_CLOCK_ENCODES = 1 + 3 * 24
QUORUM_RANKS = 3
QUORUM_OBJECTS = 64
QUORUM_DOWN = 5  # stopped and marked down for the degraded read


def merge_routes(*parts) -> dict[str, int]:
    out: dict[str, int] = {}
    for part in parts:
        for key, val in part.items():
            out[key] = out.get(key, 0) + val
    return {key: val for key, val in out.items() if val}


def decode_route(on_card: bool, codec, call: tuple, limit: int) -> dict:
    """The route of one recorded decode (``ClusterRoutes``: present,
    wanted, input bytes, host input) of ``codec``: host input at or below
    ``limit`` (``ec_host_dispatch_bytes``) on the host GF tables, a
    matrix of zeros and ones on Kernel D, any other on Kernel A; on the
    CPU the plain forms."""
    present, want, nbytes, host = call
    if 0 < limit and host and nbytes <= limit:
        return {"host_decode": 1}
    mat = codec._build_decode_bytes(list(present), list(want))
    if xor_route(on_card, mat):
        return {"sched_decode": 1, "launch.xor_schedule": 1}
    if not on_card:
        return {"plain_decode": 1}
    return {"kernel_decode": 1, "launch.gf_apply": 1}


def recorded_routes(on_card: bool, routes, phase: str, limit: int) -> dict:
    return merge_routes(*(
        decode_route(on_card, codec, call, limit) for call, codec in zip(
            routes.phase_decodes.get(phase, []),
            routes.phase_codecs.get(phase, []))))


def applies(on_card: bool, op: str, count: int) -> dict:
    """``count`` GF(2^8) applies of CUDA tensors: Kernel A (plain on the
    CPU)."""
    if not on_card:
        return {f"plain_{op}": count}
    return {f"kernel_{op}": count, "launch.gf_apply": count}


def hashes(on_card: bool, count: int) -> dict:
    """``count`` checksum calls that take the device route: Kernel C."""
    if not count:
        return {}
    if not on_card:
        return {"backend.plain": count}
    return {"backend.kernel": count, "launch.crc32c_blocks": count}


def fused_writes(on_card: bool, count: int) -> dict:
    """``count`` fused encode+csum calls: Kernel B."""
    if not count:
        return {}
    out = {f"{'kernel' if on_card else 'plain'}_encode": count,
           "fused_encode": count}
    if on_card:
        out["launch.gf_apply_csum"] = count
    return out


def predict_bench(on_card: bool, runs: dict, routes) -> dict:
    """The routes of the bench CLI's workloads: each encode of CUDA
    tensors one Kernel A launch (the warm-up call included); each decode
    A or D by its matrix (``xor_route``); each CLAY repair one Kernel E,
    one inner decode on Kernel A and one Kernel F, after one CLAY encode
    (its inner decode of the parity row, routed by its matrix); each
    checksum call one Kernel C launch. Inputs live on the card, so no
    host route is taken."""
    n_repair = runs["repair"].iterations + 12  # one warm-up per chunk
    repair = merge_routes(applies(on_card, "decode", n_repair),
                          recorded_routes(on_card, routes, "repair", 0))
    if on_card:
        repair.update({"launch.clay_uncoupled": n_repair,
                       "launch.clay_couple_scatter": n_repair})
    return {
        "encode": applies(on_card, "encode", runs["encode"].iterations + 1),
        "decode": merge_routes(applies(on_card, "encode", 1),
                               recorded_routes(on_card, routes, "decode", 0)),
        "repair": repair,
        "checksum": hashes(on_card, runs["checksum"].iterations + 1),
    }


def bench_cli_path(dev) -> Counted:
    """The bench CLI path: ``ceph_tpu_torch.bench_cli.run`` in-process
    (so its launches count) for the encode, decode (every 2-erasure
    pattern, each decoded chunk byte-checked by the CLI), CLAY repair and
    checksum workloads, each workload's routes held to ``predict_bench``
    and its decodes to the patterns the CLI generates."""
    from itertools import combinations

    from ceph_tpu_torch import bench_cli

    routes = ClusterRoutes([])
    runs = {}
    with contextlib.ExitStack() as stack:
        counted = stack.enter_context(Counted("bench_cli"))
        stack.enter_context(routes.recording())
        for name, argv in BENCH_WORKLOADS:
            args = bench_cli.parse_args(argv + ["--device", dev.type])
            with routes(name):
                elapsed, kib = bench_cli.run(args)
            runs[name] = args
            print(f"bench_cli {name}: {elapsed:.6f}\t{int(kib)}  "
                  f"({kib * 1024 / elapsed / 1e9:.3f} GB/s)")
    on_card = dev.type == "cuda"
    n = 12
    patterns = list(combinations(range(n), 2))
    want = [tuple(sorted(e)) for e in set(patterns)] + [
        patterns[it % len(patterns)]
        for it in range(runs["decode"].iterations)]
    got = [call[1] for call in routes.phase_decodes["decode"]]
    check(sorted(got) == sorted(want),
          f"bench decode took {len(got)} decodes, the CLI's patterns ask "
          f"for {len(want)}")
    check(all(call[0] == tuple(i for i in range(n) if i not in call[1])
              for call in routes.phase_decodes["decode"]),
          "a bench decode was not given every surviving chunk")
    predicted = predict_bench(on_card, runs, routes)
    rows = {name: {key: val for key, val in row.items()
                   if not key.startswith("coalesce.")}
            for name, row in routes.rows.items()}
    print("bench_cli route split: " + json.dumps(
        {"predicted": predicted, "observed": rows}))
    for phase, want_row in predicted.items():
        check(rows.get(phase, {}) == want_row,
              f"bench_cli {phase} routes {rows.get(phase)}, predicted "
              f"{want_row}")
    if on_card:
        counted.check_routes(("gf_apply", "crc32c_blocks", "clay_uncoupled",
                              "clay_couple_scatter"))
    return counted


def device_busy_us(prof) -> float:
    """Device time summed over the kernels and copies a finished
    torch.profiler run saw on the card (CUPTI's buffer requests
    aside)."""
    total = 0.0
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        if evt.key.startswith("Activity Buffer Request"):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        total += float(dev_us or 0)
    return total


def loadgen_path(dev) -> Counted:
    """The loadgen path: ``bench_cli loadgen --preset mixed`` in-process
    on 12 OSD daemons on the card, the most-primary OSD killed at op 200
    and revived at op 400, with the device clock and 8 captured traces.
    The run must be green (no verify failure, exactly once, recovered)
    and its cluster scrub-clean (a scrub pass, without repair, before it
    shuts down). Every write's fused encode is held to the driver's write
    ops, every RMW delta to its overwrites (re-executions of ops resent
    across the kill at most), every decode to its matrix, every hash to
    Kernel C; an ``Exporter`` scrape matches the per-class op counts."""
    import io
    import urllib.request

    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch import bench_cli, loadgen
    from ceph_tpu_torch.loadgen.forensics import run_is_green
    from ceph_tpu_torch.pipeline import recovery
    from ceph_tpu_torch.pipeline.recovery import be_deep_scrub
    from ceph_tpu_torch.utils import config
    from ceph_tpu_torch.utils.exporter import Exporter
    from ceph_tpu_torch.utils.perf_counters import perf_collection

    on_card = dev.type == "cuda"
    routes = ClusterRoutes([])
    seen: dict = {}

    def scrub_hashes(sinfo, backend, oid, hinfo=None, device="cuda"):
        """``be_deep_scrub``, counting the hashes it will take: one a
        stride of every live shard, when the HashInfo the scrub elected
        from the shards' HINFO attrs holds hashes (an RMW overwrite
        clears them)."""
        if hinfo is not None and hinfo.get_total_chunk_size():
            stride = max(int(config.get("osd_deep_scrub_stride")), 4096)
            seen["hashed"] += len(backend.avail_shards()) * -(
                -hinfo.get_total_chunk_size() // stride)
        return be_deep_scrub(sinfo, backend, oid, hinfo=hinfo,
                             device=device)

    class SmokeCluster(loadgen.LoadCluster):
        """The CLI's cluster: scrubbed once (no repair) before it shuts
        down, the scrub counted as a phase of its own."""

        def shutdown(self):
            try:
                # every PG instantiated on its primary (the scrub would
                # instantiate the rest, and their peering may catch a
                # stale shard up from the log mid-scrub), then the run's
                # recovery left to finish
                live = [self.daemons[i] for i in self.live_osds()]
                osdmap = self.mon.osdmap
                for pgid in range(osdmap.pools[self.pool].pg_num):
                    self.daemons[osdmap.pg_primary(self.pool, pgid)]._get_pg(
                        self.pool, pgid)
                # quiet: settled, and no route moved over two ticks
                end = time.monotonic() + 120.0
                while True:
                    wait_settled(self.mon, live, "after the loadgen run")
                    before = routes._now()
                    time.sleep(2 * self._tick_period)
                    if routes._now() == before:
                        break
                    check(time.monotonic() < end, "the loadgen cluster "
                          "did not go quiet after the run within 120 s")
                seen["hashed"] = 0
                recovery.be_deep_scrub = scrub_hashes
                try:
                    with routes("scrub"):
                        seen["scrub_clean"] = self.scrub_clean(
                            repair=False)
                finally:
                    recovery.be_deep_scrub = be_deep_scrub
                seen["resends"] = perf_collection.dump()[
                    "loadgen_client"]["op_resend"]
            finally:
                super().shutdown()

    err = io.StringIO()
    args = bench_cli.parse_args(LOADGEN_ARGV + ["--device", dev.type])
    with contextlib.ExitStack() as stack:
        counted = stack.enter_context(Counted("loadgen"))
        stack.enter_context(routes.recording())
        stack.enter_context(config.override(**LOADGEN_OVERRIDES))
        real = loadgen.LoadCluster
        loadgen.LoadCluster = SmokeCluster
        stack.callback(setattr, loadgen, "LoadCluster", real)
        prof = stack.enter_context(profile(
            activities=[ProfilerActivity.CUDA])) if on_card else None
        t0 = time.perf_counter()
        with routes("run"), contextlib.redirect_stderr(err):
            elapsed, kib = bench_cli.run(args)
        wall_s = time.perf_counter() - t0
    lines = err.getvalue().splitlines()
    report = json.loads(next(ln for ln in reversed(lines)
                             if ln.startswith("{")))
    busy_s = device_busy_us(prof) / 1e6 if on_card else 0.0
    green, why = run_is_green(report)
    check(green, f"the loadgen run is not green: {why}")
    check(report["verify_failures"] == 0 and report["exactly_once"]
          and report.get("recovered") is True,
          "the loadgen run failed a verify, lost an op or did not recover")
    check(seen.get("scrub_clean") is True,
          "the loadgen cluster is not scrub-clean after the run")
    check(report["traces"]["captured"] == min(8, report["traces"][
        "total_traces"]) > 0, "the loadgen run captured no traces")
    check((report.get("lat_p99_ms_device") is not None) == on_card,
          "the device clock did not report (or reported on the CPU)")
    classes = report["classes"]
    done = {c: classes[c]["ops"] + classes[c]["warmup_ops"]
            for c in classes}
    failed = {c: classes[c]["errors"] for c in classes}

    # one Exporter scrape: the per-class counters equal the report's
    exp = Exporter()
    host, port = exp.start()
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                    timeout=10) as resp:
            text = resp.read().decode()
    finally:
        exp.stop()
    scraped = dict.fromkeys(LOADGEN_CLASSES, 0)
    for line in text.splitlines():
        for cls in LOADGEN_CLASSES:
            if line.startswith(f'ceph_tpu_ops_{cls}{{set="loadgen"}} '):
                scraped[cls] = int(float(line.rpartition(" ")[2]))
    check(scraped == {c: done.get(c, 0) for c in LOADGEN_CLASSES},
          f"the exporter's per-class ops {scraped} differ from the "
          f"report's {done}")

    # -- routes: held to the driver's counts and the recorded decodes ---
    rows = {name: {key: val for key, val in row.items()
                   if not key.startswith("coalesce.")}
            for name, row in routes.rows.items()}
    run_row = rows["run"]
    scrub_row = rows.get("scrub", {})
    own = {key: run_row.get(key, 0) - scrub_row.get(key, 0)
           for key in set(run_row) | set(scrub_row)}
    writes = done.get("seq_write", 0) + done.get("rand_write", 0)
    write_errs = failed.get("seq_write", 0) + failed.get("rand_write", 0)
    patches = done.get("rmw_overwrite", 0)
    reads = done.get("read", 0) + done.get("reconstruct_read", 0)
    resends = seen["resends"]
    # a write's encode runs alone (one fused launch) or, in a coalesced
    # wave, staged in the ring (one fused launch a batch); an op resent
    # across the kill may run twice
    batches = own.get("stream.batches", 0)
    ring_ops = own.get("stream.ops", 0)
    alone = own.get("fused_encode", 0) - batches
    deltas = own.get("host_delta", 0)
    print("loadgen counts: " + json.dumps({
        "done": done, "failed": failed, "resends": resends,
        "writes_alone": alone, "writes_in_ring": ring_ops,
        "ring_batches": batches, "host_deltas": deltas,
        "decodes": len(routes.phase_decodes.get("run", [])),
        "shards_scrubbed": seen["hashed"]}))
    check(writes <= alone + ring_ops <= writes + write_errs + resends,
          f"{alone} writes encoded alone and {ring_ops} in the ring for "
          f"{writes} write ops ({write_errs} failed, {resends} resends)")
    check(patches <= deltas <= patches + failed.get("rmw_overwrite", 0)
          + resends, f"{deltas} host deltas for {patches} overwrites "
          f"({resends} resends)")
    check(batches <= ring_ops, f"{batches} ring batches for {ring_ops} ops")
    verifies = sum(val for key, val in own.items()
                   if key.startswith("backend.") and key != "backend.host")
    limit = LOADGEN_OVERRIDES["ec_host_dispatch_bytes"]
    clock = applies(on_card, "encode", DEVICE_CLOCK_ENCODES) if on_card \
        else {}
    ring = {f"stream.{key}": own.get(f"stream.{key}", 0)
            for key in ("ops", "batches", "batched_ops")}
    scrub = hashes(on_card, seen["hashed"])
    predicted = {
        # the run's own routes (the driver verifies each read with two
        # host CRCs of 256 KiB; recovery verifies rebuilt shards on the
        # card), then the scrub pass inside it
        "run": merge_routes(
            fused_writes(on_card, alone + batches), ring,
            {"host_delta": deltas, "backend.host": 2 * reads}, clock,
            recorded_routes(on_card, routes, "run", limit),
            hashes(on_card, verifies), scrub),
        "scrub": scrub,
    }
    observed = {"run": run_row, "scrub": scrub_row}
    print("loadgen route split: " + json.dumps(
        {"predicted": predicted, "observed": observed}))
    for phase, want_row in predicted.items():
        check(observed[phase] == want_row,
              f"loadgen {phase} routes {observed[phase]}, predicted "
              f"{want_row}")
    check(all(len(call[1]) == 1 for call in routes.phase_decodes["run"]),
          "a loadgen decode wanted more than the one killed OSD's shard")
    if on_card:
        for name in ("gf_apply_csum", "gf_apply", "crc32c_blocks"):
            check(counted.launches[name] > 0,
                  f"kernel {name} never launched on the loadgen path")
    idle = 1.0 - busy_s / wall_s
    print(f"loadgen: {elapsed:.6f}\t{int(kib)}  "
          f"({report['gbps']:.6f} GB/s over the measured window; "
          f"lat_p99_ms {report.get('lat_p99_ms')}, lat_p99_ms_device "
          f"{report.get('lat_p99_ms_device')}, device idle share "
          f"{idle:.4f} of {wall_s:.3f} s)")
    print(json.dumps({"loadgen": {
        "lat_p99_ms": report.get("lat_p99_ms"),
        "lat_p99_ms_device": report.get("lat_p99_ms_device"),
        "device_floor_ms": report.get("device_floor_ms"),
        "gbps": report["gbps"], "iops": report["iops"],
        "fault": report.get("fault"), "wall_s": wall_s,
        "device_busy_s": busy_s, "device_idle_share": idle,
        "ops": done, "errors": failed}}))
    return counted


def quorum_path(rng, dev) -> Counted:
    """The quorum path: a 3-rank ``MonQuorumService`` behind 12
    ``OSDDaemon``s on the card (ISA EC(8,4), 4 KiB stripe unit, 32 PGs)
    and 16 client threads over TCP: 64 objects of 4 MiB written, the
    leader killed after the first 32, the rest written; every surviving
    rank holds every committed epoch; every object read back, then read
    degraded with one OSD stopped and marked down through the new leader.
    Routes: one Kernel B launch a write; each degraded object's decode
    by its matrix, the decodes held to the map's holes."""
    from ceph_tpu_torch.cluster.mon_quorum import (
        MonQuorumService,
        QuorumMonitor,
    )
    from ceph_tpu_torch.cluster.osdmap import Incremental, OSDMap
    from ceph_tpu_torch.utils import config

    k, m = int(PIPE_PROFILE["k"]), int(PIPE_PROFILE["m"])
    n = k + m
    size = OBJECT_BYTES
    pool = "rbd"
    oids = [f"rbd_data.q{i:015x}" for i in range(QUORUM_OBJECTS)]
    model = {oid: rng.integers(0, 256, size, dtype=np.uint8) for oid in oids}
    half = QUORUM_OBJECTS // 2
    cl = SmokeCluster(dev, pool, "quorum")
    daemons = cl.started
    clients = cl.clients
    read = functools.partial(read_back, model)

    def write(io, oid):
        io.write_full(oid, model[oid].tobytes())

    def log_epochs(rank):
        return [Incremental.from_bytes(b).epoch
                for b in svc.paxos.nodes[rank].committed_values()]

    routes = ClusterRoutes(daemons)
    with contextlib.ExitStack() as stack:
        stack.callback(cl.stop_all)
        stack.enter_context(config.override(csum_block_size=CSUM_BLOCK))
        counted = stack.enter_context(Counted("quorum"))
        stack.enter_context(routes.recording())
        svc = MonQuorumService(QUORUM_RANKS, device=dev)
        mon = QuorumMonitor(svc)
        for i in range(CLUSTER_OSDS):
            mon.osd_crush_add(i)
        for i in range(CLUSTER_OSDS):
            cl.start_osd(mon, i)
        mon.osd_erasure_code_profile_set(
            "isa84", {"plugin": "isa", **PIPE_PROFILE})
        mon.osd_pool_create(pool, CLUSTER_PG_NUM, "isa84")
        cl.connect(mon)
        wait_settled(mon, daemons, "after boot")

        with routes("write_before_kill"), Phase(
                "quorum_write_before_kill", half * size):
            clients(write, oids[:half])
        leader0 = svc.leader_rank()
        epoch_before = mon.osdmap.epoch
        log_before = svc.paxos.nodes[leader0].committed_values()
        svc.kill(leader0)
        with routes("write_after_kill"), Phase(
                "quorum_write_after_kill", (QUORUM_OBJECTS - half) * size):
            clients(write, oids[half:])
        with routes("read"), Phase("quorum_read", QUORUM_OBJECTS * size):
            clients(read, oids)
        daemons[QUORUM_DOWN].stop()
        mon.osd_down(QUORUM_DOWN)  # committed through the new leader
        leader1 = svc.leader_rank()
        live = [d for d in daemons if d.osd_id != QUORUM_DOWN]
        wait_settled(mon, live, f"after osd.{QUORUM_DOWN} went down")
        want_reads = cluster_reads(mon.osdmap, pool, oids, k, n)
        with routes("degraded_read"), Phase("quorum_degraded_read",
                                            QUORUM_OBJECTS * size):
            clients(read, oids)
        svc.replicate()
        final = mon.osdmap.epoch
        survivors = [r for r in range(QUORUM_RANKS) if r != leader0]
        logs = {r: log_epochs(r) for r in survivors}
        maps = {r: svc.monitors[r].osdmap.to_bytes() for r in survivors}
        rebuilt = {}
        for r in survivors:
            osdmap = OSDMap()
            for blob in svc.paxos.nodes[r].committed_values():
                osdmap = osdmap.apply(Incremental.from_bytes(blob))
            rebuilt[r] = osdmap.to_bytes()
        prefix = {r: svc.paxos.nodes[r].committed_values()[:len(log_before)]
                  for r in survivors}

    check(leader1 != leader0, f"mon.{leader0} was killed and still leads")
    check(final > epoch_before, "no epoch was committed after the kill")
    for r in survivors:
        check(logs[r] == list(range(1, final + 1)),
              f"mon.{r} holds epochs {logs[r][:3]}..{logs[r][-3:]}, want "
              f"1..{final}")
        check(prefix[r] == log_before,
              f"mon.{r} lost or changed an epoch committed before the kill")
        check(maps[r] == rebuilt[r] == mon.osdmap.to_bytes(),
              f"mon.{r}'s map differs from its log or the leader's")
    on_card = dev.type == "cuda"
    got = sorted(call[:2] for call in routes.phase_decodes["degraded_read"])
    check(got == sorted(want_reads), f"quorum degraded read decoded {got}, "
          f"the map asks for {sorted(want_reads)}")
    limit = int(config.get("ec_host_dispatch_bytes"))
    predicted = {
        "write_before_kill": fused_writes(on_card, half),
        "write_after_kill": fused_writes(on_card, QUORUM_OBJECTS - half),
        "read": {},
        "degraded_read": recorded_routes(on_card, routes, "degraded_read",
                                         limit),
    }
    rows = {name: {key: val for key, val in row.items()
                   if not key.startswith("coalesce.")}
            for name, row in routes.rows.items()}
    print("quorum route split: " + json.dumps(
        {"predicted": predicted, "observed": rows}))
    for phase, want_row in predicted.items():
        check(rows.get(phase, {}) == want_row,
              f"quorum {phase} routes {rows.get(phase)}, predicted "
              f"{want_row}")
    if on_card:
        check(counted.launches["gf_apply_csum"] > 0 and (
            counted.launches["gf_apply"] + counted.launches["xor_schedule"]
            > 0), "the quorum path launched no write or no decode kernel")
    print(f"quorum outputs: {QUORUM_OBJECTS} objects of {size} B written "
          f"by {CLUSTER_CLIENTS} clients, mon.{leader0} (leader) killed "
          f"after {half}; mon.{leader1} leads; ranks {survivors} hold "
          f"epochs 1..{final} ({epoch_before} before the kill); every "
          f"object read back, and read degraded with osd.{QUORUM_DOWN} "
          f"down ({len(want_reads)} decodes)")
    return counted


#: path 12 (tools): the compressor's buffer (half zero pages), the CLI
#: cluster (EC(8,4) needs one OSD a shard: 12), its objects, the data
#: position whose OSD goes down for the degraded get
TOOLS_COMPRESS_BYTES = 4 * MIB
TOOLS_CLI_OSDS = 12
TOOLS_BENCH_COUNT = 16
TOOLS_DOWN_POS = 1
#: the CLI's daemons scrub only when the smoke asks: every boot starts
#: fresh scrub clocks, which the scheduler would take as overdue
CLI_OVERRIDES = {"osd_scrub_min_interval": 1e12,
                 "osd_deep_scrub_interval": 1e12}
#: the corpus entries are 31 KiB + 17 B: at the defaults every op of
#: theirs stays on the host; at 0 the card serves them
CORPUS_OVERRIDES = {"ec_host_dispatch_bytes": 0, "csum_device_min_bytes": 0}
PACKET_TECHNIQUES = ("liberation", "blaum_roth", "liber8tion")
#: path 13 (multi-device): the logical mesh (dp 2 x sp 4 at k = 8, the
#: reference's 8-device dry run), the flagship dispatch of 8 stripes x 8
#: x 1 MiB, the decode's lost shards, the sequence-parallel CRC's
#: object (256 MiB, ragged), the DCN geometry and its stripes
MESH_DEVICES = 8
MESH_LOST = (0, 3)
SEQ_CRC_BYTES = 256 * MIB + 4097
DCN_HOSTS, DCN_DEVICES, DCN_STRIPES = 2, 2, 4
DCN_BACKEND = "gloo"  # the hosts share one card: NCCL refuses that


def stream_hashes(on_card: bool, count: int, nbytes: int) -> dict:
    """``count`` host-array checksum streams of ``nbytes`` each: Kernel C
    from ``csum_device_min_bytes`` up, the host scalar path below."""
    from ceph_tpu_torch.utils import config

    if nbytes < int(config.get("csum_device_min_bytes")):
        return {"backend.host": count} if count else {}
    return hashes(on_card, count)


def corpus_groups() -> dict[str, list]:
    """The shipped corpus entries (v0, v1, v2) by route family: byte
    matrix codecs, packet (bit-matrix) codecs, and the layered ones."""
    from ceph_tpu_torch import corpus

    groups: dict[str, list] = {"matrix": [], "packet": [], "layered": []}
    for version in ("v0", "v1", "v2"):
        for entry in corpus.iter_entries(str(ROOT / "tests/corpus" / version)):
            meta = json.loads((Path(entry) / "profile.json").read_text())
            plugin, profile = meta["plugin"], meta["profile"]
            if plugin in ("lrc", "shec", "clay"):
                groups["layered"].append(entry)
            elif profile.get("technique") in PACKET_TECHNIQUES:
                groups["packet"].append(entry)
            else:
                groups["matrix"].append(entry)
    return groups


def predict_corpus(on_card: bool, entries, group: str) -> dict:
    """The routes of ``corpus.run_check`` over ``entries`` with the host
    crossovers at 0, from the codecs' matrices: one encode a entry and
    one decode for every 1- and 2-erasure pattern, each of CUDA tensors.
    A byte-matrix op whose rows are all 0/1 takes Kernel D, any other
    Kernel A; a packet code's op takes Kernel D (the schedule kernel
    runs a rejected matrix in selection form and counts it)."""
    from itertools import combinations

    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.ops import xor_schedule
    from ceph_tpu_torch.utils import config

    out: list = []
    for entry in entries:
        meta = json.loads((Path(entry) / "profile.json").read_text())
        codec = registry.factory(meta["plugin"], meta["profile"], "cpu")
        n, m = codec.get_chunk_count(), codec.get_coding_chunk_count()
        combos = [c for r in range(1, min(2, m) + 1)
                  for c in combinations(range(n), r)]
        if group == "packet":
            mats = [codec.coding_bitmatrix] + [
                codec._build_decode_bitmatrix(
                    [i for i in range(n) if i not in c], list(c))
                for c in combos]
            for op, mat in zip(["encode"] + ["decode"] * len(combos), mats):
                row = {f"{'sched' if on_card else 'plain'}_{op}": 1}
                if on_card:
                    row["launch.xor_schedule"] = 1
                if on_card and xor_schedule.routable_schedule(
                        mat, config.get("ec_sched_opt")) is None:
                    row["sched_rejected_density"] = 1
                out.append(row)
            continue
        parity = codec.generator[codec.k:]
        if xor_route(on_card, parity):
            out.append({"sched_encode": 1, "launch.xor_schedule": 1})
        else:
            out.append(applies(on_card, "encode", 1))
        for c in combos:
            present = tuple(i for i in range(n) if i not in c)
            out.append(decode_route(on_card, codec, (present, c, 0, False), 0))
    return merge_routes(*out)


def predict_sweep(on_card: bool, routes) -> dict:
    """The routes of ``bench_sweep --baseline``, from its configs: each
    encode and checksum call one Kernel A or C launch (with the warm-up
    call), each CLAY repair one Kernel E, inner decode (A) and F (with a
    warm-up a chunk), after one CLAY encode whose inner decode is routed
    by its matrix."""
    from ceph_tpu_torch import bench_cli, bench_sweep

    parts = [recorded_routes(on_card, routes, "bench_sweep", 0)]
    for _name, argv in bench_sweep.BASELINE_CONFIGS:
        args = bench_cli.parse_args(argv)
        if args.workload == "encode":
            parts.append(applies(on_card, "encode", args.iterations + 1))
        elif args.workload == "checksum":
            parts.append(hashes(on_card, args.iterations + 1))
        else:  # CLAY (8,4,d=11) repair: one warm-up per chunk
            n_repair = args.iterations + 12
            parts.append(applies(on_card, "decode", n_repair))
            if on_card:
                parts.append({"launch.clay_uncoupled": n_repair,
                              "launch.clay_couple_scatter": n_repair})
    return merge_routes(*parts)


@contextlib.contextmanager
def stamped_daemons(*modules):
    """While entered, every ``OSDDaemon`` that ``modules`` construct
    stamps a PG's scrub clocks the first time it looks at it, as the
    cluster path's daemons are stamped at boot. A daemon's scheduler
    deep-scrubs a PG it has no stamp for one tick after boot (at any
    interval), so the CLI's daemons, booted fresh for every command, and
    a ``LoadCluster``'s would hash every shard in whatever phase follows;
    stamped, only a phase that asks for a scrub scrubs."""
    from ceph_tpu_torch.cluster import OSDDaemon

    class Stamped(OSDDaemon):
        def _scrub_due(self, key, now):
            self._scrub_stamps.setdefault(key, [now, now])
            return super()._scrub_due(key, now)

    for mod in modules:
        mod.OSDDaemon = Stamped
    try:
        yield
    finally:
        for mod in modules:
            mod.OSDDaemon = OSDDaemon


def wait_linked(mon, live, what: str, deadline_s: float = 120.0) -> None:
    """Wait until every live daemon reaches every other up OSD over its
    messenger and no PG holds a position back for catch-up, then until
    the cluster is quiet (``wait_settled``). A daemon that boots before
    a peer it shares a PG with holds that position out of reads until a
    tick's catch-up re-admits it; a read in that window decodes around a
    live shard."""
    end = time.monotonic() + deadline_s
    while True:
        up = mon.osdmap.up_osds()
        busy = []
        for d in live:
            unlinked = (up - {d.osd_id}) - d.peers.avail_shards()
            if unlinked:
                busy.append((d.osd_id, "unlinked", sorted(unlinked)))
            with d._pg_lock:
                pgs = list(d._pgs.items())
            busy += [(d.osd_id, pgid, "held", sorted(pg.backend.recovering))
                     for (_pl, pgid), pg in pgs if pg.backend.recovering]
        if not busy:
            break
        check(time.monotonic() < end, f"the daemons did not link {what} "
              f"within {deadline_s} s: {busy[:8]}")
        time.sleep(0.05)
    wait_settled(mon, live, what, max(end - time.monotonic(), 1.0))


@contextlib.contextmanager
def settled_cli():
    """While entered, every CLI command boots stamped daemons
    (``stamped_daemons``) and runs once its cluster is linked and quiet
    (``wait_linked``): the CLI boots its daemons one after another, and
    its own wait (``Cluster.wait_linked``) gives up silently after 10 s,
    where a command that reads could decode around a shard whose daemon
    booted after the primary; the smoke's fails loudly."""
    from ceph_tpu_torch import cli

    boot = cli.Cluster

    class Settled(boot):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            wait_linked(self.mon, list(self.daemons.values()),
                        f"after the CLI booted {self.root}")

    cli.Cluster = Settled
    try:
        with stamped_daemons(cli):
            yield
    finally:
        cli.Cluster = boot


def tools_path(rng, dev) -> Counted:
    """The tools path: the compressor's device scan (``tpu_zeroelim``,
    ``tpu_zlib``) of a 4 MiB buffer that is half zero pages; ``corpus
    check`` of every shipped entry (v0-v2) on the card; the dev-cluster
    CLI over a state directory (12 BlockStore OSDs, an ISA EC(8,4) pool:
    put and get of a 4 MiB object, a degraded get with one OSD down, the
    OSD back, a scrub, ``bench`` of 16 objects of 4 MiB; then a 3-mon
    quorum directory with one put and get); ``objectstore_tool`` list,
    info, export, import into a fresh BlockStore and fsck of one stopped
    OSD's store, read back equal; and ``bench_sweep --baseline``. Every
    phase's routes are held to a prediction from its op sizes and
    matrices; outputs to the CPU forms and the models."""
    import collections
    import io
    import os
    import tempfile

    from ceph_tpu_torch import bench_sweep, cli, corpus, objectstore_tool
    from ceph_tpu_torch.cluster.mon_store import MonStore
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.compressor import registry as comp_registry
    from ceph_tpu_torch.compressor import tpu_offload
    from ceph_tpu_torch.store import BlockStore, open_store
    from ceph_tpu_torch.utils import config

    on_card = dev.type == "cuda"
    k, m = int(PIPE_PROFILE["k"]), int(PIPE_PROFILE["m"])
    n = k + m
    routes = ClusterRoutes([])
    predicted: dict[str, dict] = {}

    def quiet(fn, *argv) -> tuple[int, str]:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = fn(list(argv))
        return rc, out.getvalue()

    def cli_run(state, *argv) -> str:
        rc, out = quiet(cli.main, "-d", state, "--device", dev.type, *argv)
        check(rc == 0, f"cli {argv} exited {rc}: {out[-400:]}")
        return out

    with contextlib.ExitStack() as stack:
        tmp = stack.enter_context(tempfile.TemporaryDirectory(
            prefix="smoke-tools-"))
        counted = stack.enter_context(Counted("tools"))
        stack.enter_context(routes.recording())

        # -- compressor ---------------------------------------------------
        pages = rng.integers(0, 256, (TOOLS_COMPRESS_BYTES // 4096, 4096),
                             dtype=np.uint8)
        pages[::2] = 0
        buf = pages.tobytes()
        names = ("tpu_zeroelim", "tpu_zlib")
        masks0 = tpu_offload.device_masks()
        with routes("compress"), Phase("tools_compress", 2 * len(buf)):
            blobs = {nm: comp_registry.create(nm, device=dev).compress(buf)
                     for nm in names}
        masks = tpu_offload.device_masks() - masks0
        for nm in names:
            cpu_blob = comp_registry.create(nm, device="cpu").compress(buf)
            check(blobs[nm] == cpu_blob,
                  f"{nm}'s blob differs from its CPU form's")
            check(comp_registry.create(nm, device=dev).decompress(
                *blobs[nm]) == buf, f"{nm} did not round-trip")
        check(masks == len(names), f"{masks} device masks, want one a "
              f"compressor over {len(buf)} B (>= DEVICE_THRESHOLD)")
        predicted["compress"] = {}
        print(f"tools compressor: {len(buf)} B half zero pages -> "
              + ", ".join(f"{nm} {len(blobs[nm][0])} B" for nm in names)
              + f"; {masks} masks on {dev}")

        # -- corpus check on the card --------------------------------------
        groups = corpus_groups()
        with config.override(**CORPUS_OVERRIDES):
            for group, entries in groups.items():
                nbytes = sum(json.loads((Path(e) / "profile.json")
                                        .read_text())["size"]
                             for e in entries)
                with routes(f"corpus_{group}"), Phase(
                        f"tools_corpus_{group}", nbytes):
                    for entry in entries:
                        errors = corpus.run_check(entry, device=dev)
                        check(not errors, f"corpus {entry}: {errors}")
                if group != "layered":
                    predicted[f"corpus_{group}"] = predict_corpus(
                        on_card, entries, group)
        layered = routes.rows["corpus_layered"]
        check(not any(key.startswith(("plain_", "host_"))
                      for key in layered) or not on_card,
              f"the layered corpus entries took {layered}")
        print(f"tools corpus: {sum(map(len, groups.values()))} entries "
              "checked on the card; A/D/E/F launches "
              + json.dumps({g: {kk: v for kk, v in routes.rows[
                  f"corpus_{g}"].items() if kk.startswith("launch.")}
                  for g in groups}))

        # -- the dev-cluster CLI -------------------------------------------
        state = os.path.join(tmp, "cluster")
        obj_in = os.path.join(tmp, "in.bin")
        obj_out = os.path.join(tmp, "out.bin")
        blob = rng.integers(0, 256, OBJECT_BYTES, dtype=np.uint8).tobytes()
        with open(obj_in, "wb") as f:
            f.write(blob)
        stack.enter_context(config.override(**CLI_OVERRIDES))
        stack.enter_context(settled_cli())
        limit = int(config.get("ec_host_dispatch_bytes"))
        with routes("cli_vstart"), Phase("tools_cli_vstart", 0):
            cli_run(state, "vstart", "--osds", str(TOOLS_CLI_OSDS),
                    "--store", "block")
            cli_run(state, "profile-set", "isa84", "plugin=isa",
                    *(f"{key}={val}" for key, val in PIPE_PROFILE.items()))
            cli_run(state, "pool-create", "p", "8", "isa84")
        with routes("cli_put"), Phase("tools_cli_put", len(blob)):
            cli_run(state, "put", "p", "big", obj_in)
        with routes("cli_get"), Phase("tools_cli_get", len(blob)):
            cli_run(state, "get", "p", "big", obj_out)
        check(Path(obj_out).read_bytes() == blob, "cli get returned other "
              "bytes than were put")
        osdmap, _ = MonStore(os.path.join(state, "mon", "store.log")).replay()
        victim = osdmap.object_to_acting("p", "big")[TOOLS_DOWN_POS]
        cli_run(state, "osd-down", str(victim))
        osdmap, _ = MonStore(os.path.join(state, "mon", "store.log")).replay()
        want_reads = cluster_reads(osdmap, "p", ["big"], k, n)
        with routes("cli_degraded_get"), Phase("tools_cli_degraded_get",
                                               len(blob)):
            cli_run(state, "get", "p", "big", obj_out)
        check(Path(obj_out).read_bytes() == blob, "the degraded cli get "
              "returned other bytes than were put")
        # the map's hole and nothing else is decoded: a position the
        # daemons held back as well is listed with its count
        got = sorted(call[:2] for call in
                     routes.phase_decodes["cli_degraded_get"])
        holes = {pos for _, want in want_reads for pos in want}
        extra = collections.Counter(pos for _, want in got for pos in want
                                    if pos not in holes)
        check(got == sorted(want_reads), f"the degraded get decoded {got}, "
              f"the map asks for {sorted(want_reads)}; positions past the "
              f"map's hole: {dict(extra)}")
        with routes("cli_osd_up"), Phase("tools_cli_osd_up", 0):
            cli_run(state, "osd-up", str(victim))
        with routes("cli_scrub"), Phase("tools_cli_scrub", len(blob) // k * n):
            out = cli_run(state, "scrub")
        check("scrubbed 1 objects: 0 inconsistent" in out, out)
        bench_bytes = TOOLS_BENCH_COUNT * OBJECT_BYTES
        with routes("cli_bench"), Phase("tools_cli_bench", 2 * bench_bytes):
            out = cli_run(state, "bench", "p", "--size", str(OBJECT_BYTES),
                          "--count", str(TOOLS_BENCH_COUNT))
        bench = json.loads(out.strip().splitlines()[-1])
        print(f"tools cli bench: {json.dumps(bench)}; the degraded get "
              f"decoded {got} (positions past the map's hole: "
              f"{dict(extra)})")
        quorum = os.path.join(tmp, "quorum")
        cli_run(quorum, "vstart", "--osds", str(TOOLS_CLI_OSDS), "--mons", "3")
        cli_run(quorum, "profile-set", "isa84", "plugin=isa",
                *(f"{key}={val}" for key, val in PIPE_PROFILE.items()))
        cli_run(quorum, "pool-create", "p", "8", "isa84")
        with routes("cli_quorum_put"), Phase("tools_cli_quorum_put",
                                             len(blob)):
            out = cli_run(quorum, "put", "p", "q", obj_in)
        with routes("cli_quorum_get"), Phase("tools_cli_quorum_get",
                                             len(blob)):
            cli_run(quorum, "get", "p", "q", obj_out)
        check(Path(obj_out).read_bytes() == blob, "the quorum cluster's get "
              "returned other bytes than were put")
        check("3 mons" in cli_run(quorum, "vstart", "--osds", "0"),
              "the second directory did not boot a 3-mon quorum")
        for phase in ("cli_get", "cli_quorum_get"):
            calls = routes.phase_decodes[phase]
            check(not calls, f"{phase} decoded {calls} with every OSD up")
        codec = registry.factory("isa", PIPE_PROFILE, device="cpu")
        predicted.update({
            "cli_vstart": {},
            "cli_put": fused_writes(on_card, 1),
            # with every OSD up a get reads the data shards; with one
            # down, one decode of the map's hole (the reads arrive as host
            # bytes, the whole object's k shards)
            "cli_get": {},
            "cli_degraded_get": merge_routes(*(
                decode_route(on_card, codec, (present, want, len(blob),
                                              True), limit)
                for present, want in want_reads)),
            "cli_osd_up": {},
            "cli_scrub": stream_hashes(on_card, n, len(blob) // k),
            "cli_bench": fused_writes(on_card, TOOLS_BENCH_COUNT),
            "cli_quorum_put": fused_writes(on_card, 1),
            "cli_quorum_get": {},
        })

        # -- the offline store tool on a stopped OSD -------------------------
        osd_dir = os.path.join(state, f"osd.{victim}")
        fresh = os.path.join(tmp, "fresh")
        archive = os.path.join(tmp, "export.bin")
        BlockStore(fresh).close()
        with open(os.path.join(fresh, "backend"), "w") as f:
            f.write("block")
        tool = ["--device", dev.type]
        with routes("objectstore_tool"), Phase("tools_objectstore_tool",
                                               len(blob) // k):
            rc, out = quiet(objectstore_tool.main, "--data-path", osd_dir,
                            "--op", "list", *tool)
            rows = [json.loads(line) for line in out.splitlines()]
            keys = [r["oid"] for r in rows if "big" in r["oid"]]
            check(rc == 0 and len(keys) == 1, f"list: {rc} {out[-300:]}")
            key = keys[0]  # the object's shard; the rest are PG metadata
            rc, out = quiet(objectstore_tool.main, "--data-path", osd_dir,
                            "--op", "info", key, *tool)
            info = json.loads(out)
            check(rc == 0 and info["hinfo"]["total_chunk_size"]
                  == len(blob) // k, f"info: {out[-300:]}")
            for argv in ((osd_dir, "export", "--file", archive),
                         (fresh, "import", "--file", archive),
                         (osd_dir, "fsck"), (fresh, "fsck")):
                rc, out = quiet(objectstore_tool.main, "--data-path",
                                argv[0], "--op", *argv[1:], *tool)
                check(rc == 0, f"objectstore_tool {argv[1:]}: {out[-300:]}")
        src, dst = open_store(osd_dir), open_store(fresh)
        try:
            names = src.list_objects()
            check(dst.list_objects() == names and len(names) == len(rows),
                  "the import holds other objects than the export")
            for name in names:
                check(src.read(name) == dst.read(name)
                      and src.getattrs(name) == dst.getattrs(name),
                      f"imported {name!r} reads back other bytes or attrs")
        finally:
            src.close()
            dst.close()
        predicted["objectstore_tool"] = {}

        # -- bench_sweep --baseline ------------------------------------------
        with routes("bench_sweep"), Phase("tools_bench_sweep", 0):
            rc, out = quiet(bench_sweep.main, "--baseline", "--device",
                            dev.type)
        sweep_rows = [json.loads(line) for line in out.splitlines()
                      if line.startswith("{")]
        check(rc == 0 and len(sweep_rows) == len(
            bench_sweep.BASELINE_CONFIGS) and not any(
                "error" in row for row in sweep_rows),
              f"bench_sweep --baseline: {rc} {sweep_rows}")
        for row in sweep_rows:
            print(f"tools bench_sweep: {json.dumps(row)}")
        predicted["bench_sweep"] = predict_sweep(on_card, routes)

    # BlockStore hashes its own 4 KiB blob csums on the host (store
    # metadata, not a route of the card): the CLI and store-tool phases
    # are compared without them
    def card_routes(name, row):
        drop = ("coalesce.", "stream.") + (
            ("backend.host",) if name.startswith(("cli_", "objectstore"))
            else ())
        return {key: val for key, val in row.items()
                if not key.startswith(drop)}

    rows = {name: card_routes(name, row) for name, row in routes.rows.items()}
    predicted = {name: card_routes(name, row)
                 for name, row in predicted.items()}
    print("tools route split: " + json.dumps(
        {"predicted": predicted, "observed": rows}))
    for phase, want_row in predicted.items():
        check(rows.get(phase, {}) == want_row,
              f"tools {phase} routes {rows.get(phase)}, predicted {want_row}")
    if on_card:
        for name in ("gf_apply", "gf_apply_csum", "crc32c_blocks",
                     "xor_schedule", "clay_uncoupled", "clay_couple_scatter"):
            check(counted.launches[name] > 0,
                  f"kernel {name} never launched on the tools path")
    return counted


def mesh_reference(data, bm, dec_bm, present, crc_obj) -> dict:
    """The single-device results the mesh's are held to: Kernel A over
    the whole dispatch, the survivors ``present`` of data and parity,
    Kernel A's decode of them, and Kernel C over the whole object."""
    import torch

    from ceph_tpu_torch.checksum.cuda_crc import crc32c_blocks
    from ceph_tpu_torch.ops import cuda_encode

    parity = cuda_encode.gf_apply(bm, data)
    survivors = torch.cat([data, parity], dim=1)[:, list(present)]
    survivors = survivors.contiguous()
    return {
        "parity": parity, "survivors": survivors,
        "decoded": cuda_encode.gf_apply(dec_bm, survivors),
        "crc": crc32c_blocks(crc_obj, 0xFFFFFFFF),
    }


def multi_device_path(rng, dev) -> Counted:
    """The multi-device path, over logical devices on one card (not a
    scaling number): a (dp 2 x sp 4) mesh of 8 logical devices —
    ``sharded_encode`` and ``sharded_decode`` of ISA EC(8,4) over 8
    stripes x 8 x 1 MiB, ``ring_parity`` against the all-reduce schedule,
    ``sharded_crc32c`` of a ragged 256 MiB object — each byte-equal to
    single-device Kernel A or C; the codec route through ``use_mesh`` (a
    4 MiB RMW write and a reconstruct read over 12 MemStores); a live
    ``LoadCluster(use_mesh=True, mesh_devices=8)`` over 6 OSDs; and a
    DCN pair of 2 hosts x 2 logical devices over gloo (encode and
    decode on the hosts, an RMW write and a reconstruct read on
    ``dcn_*``, then one host killed and the next op served on
    ``dcn_fallback``). Each cell of a mesh launches
    Kernel A once a dispatch: dp x sp launches; each device of the CRC
    one Kernel C; each DCN host one Kernel A a local device."""
    import torch

    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.gf import decode_matrix, gf_matrix_to_bitmatrix
    from ceph_tpu_torch.loadgen import LoadCluster
    from ceph_tpu_torch.loadgen import cluster as loadgen_cluster
    from ceph_tpu_torch.ops import cuda_encode
    from ceph_tpu_torch.parallel import (
        make_ec_mesh,
        ring_parity,
        sharded_crc32c,
        sharded_decode,
        sharded_encode,
        use_dcn,
        use_mesh,
    )
    from ceph_tpu_torch.parallel.dcn import DcnCluster
    from ceph_tpu_torch.pipeline import ShardExtentMap, StripeInfo
    from ceph_tpu_torch.pipeline.rmw import RMWPipeline, ShardBackend
    from ceph_tpu_torch.store import MemStore
    from ceph_tpu_torch.utils import config

    on_card = dev.type == "cuda"
    k, m = int(PIPE_PROFILE["k"]), int(PIPE_PROFILE["m"])
    n = k + m
    codec = registry.factory("isa", PIPE_PROFILE, device=dev)
    bm = codec._encode_bmat_np
    present = [i for i in range(n) if i not in MESH_LOST][:k]
    dec_bm = gf_matrix_to_bitmatrix(
        decode_matrix(codec.generator, k, present)[list(MESH_LOST)])
    data = rand_on(rng, dev, (STRIPES, k, CHUNK))
    crc_obj = rand_on(rng, dev, (1, SEQ_CRC_BYTES))
    ref = mesh_reference(data, bm, dec_bm, present, crc_obj)
    survivors = ref["survivors"]
    mesh = make_ec_mesh(MESH_DEVICES, k=k, devices=[dev] * MESH_DEVICES)
    cells = mesh.size
    routes = Routes()
    predicted: dict[str, dict] = {}

    def launches(kernel: str, count: int) -> dict:
        return {f"launch.{kernel}": count} if on_card else {}

    with contextlib.ExitStack() as stack:
        counted = stack.enter_context(Counted("multi_device"))
        nbytes = STRIPES * k * CHUNK
        print(f"mesh: {mesh} (logical devices on one card)")
        # one untimed round first: the allocator's and the per-shape
        # caches' first touch is not the ops' time
        sharded_encode(mesh, bm, data)
        ring_parity(mesh, bm, data)
        sharded_crc32c(mesh, crc_obj)
        with routes("mesh_encode"), Phase("logical_mesh_encode", nbytes):
            parity = sharded_encode(mesh, bm, data)
        with routes("mesh_decode"), Phase("logical_mesh_decode", nbytes):
            decoded = sharded_decode(mesh, dec_bm, survivors)
        with routes("mesh_ring_parity"), Phase("logical_mesh_ring_parity", nbytes):
            ring = ring_parity(mesh, bm, data)
        with routes("mesh_crc"), Phase("logical_mesh_sequence_parallel_crc32c",
                                       SEQ_CRC_BYTES):
            crc = sharded_crc32c(mesh, crc_obj)
        check(torch.equal(parity, ref["parity"]),
              "sharded_encode differs from single-device Kernel A")
        check(torch.equal(ring, parity), "ring_parity differs from the "
              "all-reduce schedule")
        check(torch.equal(decoded, ref["decoded"]),
              "sharded_decode differs from single-device Kernel A")
        check(torch.equal(crc.to(ref["crc"].device), ref["crc"]),
              "sharded_crc32c differs from Kernel C over the whole object")
        predicted.update({
            "mesh_encode": launches("gf_apply", cells),
            "mesh_decode": launches("gf_apply", cells),
            "mesh_ring_parity": launches("gf_apply", cells),
            "mesh_crc": launches("crc32c_blocks", cells),
        })

        # -- the codec route: an RMW write and a reconstruct read ----------
        sinfo = StripeInfo(k, m, k * PIPE_UNIT)
        backend = ShardBackend({s: MemStore(f"osd.{s}") for s in range(n)})
        pipe = RMWPipeline(sinfo, codec, backend)
        payload = rng.integers(0, 256, OBJECT_BYTES, dtype=np.uint8)
        with use_mesh(mesh):
            with routes("mesh_rmw_write"), Phase("logical_mesh_rmw_write",
                                                 OBJECT_BYTES):
                pipe.submit("obj", 0, payload.tobytes())
            lost = {sinfo.get_shard(i) for i in MESH_LOST}
            smap = ShardExtentMap(sinfo)
            for shard, store in backend.stores.items():
                if shard not in lost:
                    smap.insert(shard, 0, np.frombuffer(store.read("obj"),
                                                        np.uint8))
            with routes("mesh_reconstruct"), Phase("logical_mesh_reconstruct",
                                                   OBJECT_BYTES):
                smap.decode(codec, lost, OBJECT_BYTES)
        for shard in lost:
            want = backend.stores[shard].read("obj")
            got = smap.get(shard, 0, len(want))
            check(np.array_equal(np.asarray(got), np.frombuffer(
                want, np.uint8)), f"the mesh reconstruct of shard {shard} "
                "differs from the written shard")
        # the multi-device routes own the encode, so HashInfo hashes each
        # shard's stream itself (no fused csums)
        predicted["mesh_rmw_write"] = merge_routes(
            {"mesh_encode": 1}, launches("gf_apply", cells),
            stream_hashes(on_card, n, OBJECT_BYTES // k))
        predicted["mesh_reconstruct"] = merge_routes(
            {"mesh_decode": 1}, launches("gf_apply", cells))

        # -- a live cluster on the mesh --------------------------------------
        live_objects, live_bytes, live_k, live_m = 6, 16384, 4, 2
        with routes("mesh_live_cluster"), Phase(
                "logical_mesh_live_cluster", 2 * live_objects * live_bytes
        ), stamped_daemons(loadgen_cluster):
            cluster = LoadCluster(
                n_osds=6, k=live_k, m=live_m, pg_num=2, chunk_size=2048,
                pool="meshpool", use_mesh=True, mesh_devices=MESH_DEVICES,
                mesh_device_list=[dev] * MESH_DEVICES, device=dev)
            try:
                wait_linked(cluster.mon, list(cluster.daemons.values()),
                            "after the mesh cluster booted")
                blobs = [rng.integers(0, 256, live_bytes, dtype=np.uint8)
                         .tobytes() for _ in range(live_objects)]
                comps = [cluster.io.aio_write_full(f"m{i}", b)
                         for i, b in enumerate(blobs)]
                for c in comps:
                    c.wait_for_complete(60)
                    check(c.is_complete(), "a mesh cluster write hung")
                for i, b in enumerate(blobs):
                    check(cluster.io.read(f"m{i}") == b,
                          f"mesh cluster object m{i} read back wrong")
                live_cells = cluster.mesh.size
            finally:
                cluster.shutdown()
        # each write is one encode on the mesh (the daemons coalesce
        # concurrent writes' bookkeeping, not their encodes: the
        # streaming ring is off), one Kernel A launch a cell, and a host
        # csum of each of its k + m shards (4 KiB, under
        # csum_device_min_bytes) for the HashInfo; the reads take the
        # data shards and decode nothing
        predicted["mesh_live_cluster"] = merge_routes(
            {"mesh_encode": live_objects},
            launches("gf_apply", live_objects * live_cells),
            {"backend.host": (live_k + live_m) * live_objects})

        # -- DCN: 2 hosts x 2 logical devices over gloo ------------------
        host = data[:DCN_STRIPES].cpu().numpy()
        dcn = DcnCluster(DCN_HOSTS, DCN_DEVICES, device=dev,
                         backend=DCN_BACKEND)
        with Phase("logical_dcn_start", 0):
            dcn.start()
        stack.callback(dcn.stop)
        print(f"dcn: {DCN_HOSTS} hosts x {DCN_DEVICES} logical devices on "
              f"{dev}, backend {dcn.backend}")
        per_op = DCN_HOSTS * DCN_DEVICES
        dcn_bytes = DCN_STRIPES * k * CHUNK
        with Phase("logical_dcn_encode", dcn_bytes):
            dparity, counters = dcn.encode("isa", PIPE_PROFILE, host)
        check(np.array_equal(dparity, ref["parity"][:DCN_STRIPES]
                             .cpu().numpy()),
              "the DCN encode differs from single-device Kernel A")
        check(all(c.get("mesh_encode") == 1 for c in counters.values()),
              f"DCN hosts' counters {counters}")
        with Phase("logical_dcn_decode", dcn_bytes):
            ddec, counters = dcn.decode(
                "isa", PIPE_PROFILE, present, list(MESH_LOST),
                survivors[:DCN_STRIPES].cpu().numpy())
        check(np.array_equal(ddec, ref["decoded"][:DCN_STRIPES]
                             .cpu().numpy()),
              "the DCN decode differs from single-device Kernel A")
        host_codec = registry.factory("isa", PIPE_PROFILE, device=dev)
        dbackend = ShardBackend({s: MemStore(f"osd.{s}") for s in range(n)})
        dpipe = RMWPipeline(sinfo, host_codec, dbackend)
        # a half chunk into data chunks 0 and 1: a parity delta of two
        # columns (read 2 + 4 ties the re-encode's 6; a tie takes the
        # delta), which splits over the two hosts
        patch = rng.integers(0, 256, PIPE_UNIT, dtype=np.uint8)
        off = PIPE_UNIT // 2
        with use_dcn(dcn), routes("dcn_rmw"), Phase(
                "logical_dcn_rmw_write", OBJECT_BYTES + len(patch)):
            dpipe.submit("obj", 0, payload.tobytes())
            dpipe.submit("obj", off, patch.tobytes())
        model = payload.copy()
        model[off:off + len(patch)] = patch
        stripes = model.reshape(-1, k, PIPE_UNIT)
        want_parity = cuda_encode.gf_apply(bm, torch.from_numpy(stripes)
                                           .to(dev)).cpu().numpy()
        for j in range(m):
            got = np.frombuffer(dbackend.stores[sinfo.get_shard(k + j)]
                                .read("obj"), np.uint8)
            check(np.array_equal(got.reshape(-1, PIPE_UNIT),
                                 want_parity[:, j]),
                  f"DCN RMW parity shard {k + j} differs from Kernel A's")
        drow = routes.rows["dcn_rmw"]
        predicted["dcn_rmw"] = merge_routes(
            {"dcn_encode": 1, "dcn_delta": 1},
            stream_hashes(on_card, n, OBJECT_BYTES // k))
        # the reconstruct read of two lost shards from the host-staged
        # survivors rides the hosts too
        lost = {sinfo.get_shard(i) for i in MESH_LOST}
        dsmap = ShardExtentMap(sinfo)
        for shard, store in dbackend.stores.items():
            if shard not in lost:
                dsmap.insert(shard, 0, np.frombuffer(store.read("obj"),
                                                     np.uint8))
        with use_dcn(dcn), routes("dcn_reconstruct"), Phase(
                "logical_dcn_reconstruct", OBJECT_BYTES):
            dsmap.decode(host_codec, lost, OBJECT_BYTES)
        for shard in lost:
            want = dbackend.stores[shard].read("obj")
            check(np.array_equal(np.asarray(dsmap.get(shard, 0, len(want))),
                                 np.frombuffer(want, np.uint8)),
                  f"the DCN reconstruct of shard {shard} differs from the "
                  "written shard")
        predicted["dcn_reconstruct"] = {"dcn_decode": 1}
        worker_launches = dcn.kernel_launches
        ops = 3 + drow.get("dcn_encode", 0) + drow.get("dcn_delta", 0)
        check(not on_card or worker_launches == ops * per_op,
              f"DCN hosts launched Kernel A {worker_launches} times for "
              f"{ops} ops, want {per_op} an op")
        # one host dies without goodbye: the next op fails over
        dcn.procs[1].kill()
        dcn.procs[1].wait(timeout=60)
        one = {i: host[0, i] for i in range(k)}
        with use_dcn(dcn), routes("dcn_fallback"), Phase(
                "logical_dcn_dead_host_encode", k * CHUNK):
            dcn.apply_bitmatrix = lambda bmx, d: DcnCluster.apply_bitmatrix(
                dcn, bmx, d, timeout=10.0)
            fell = host_codec.encode_chunks(one)
        for j in range(m):
            check(np.array_equal(np.asarray(fell[k + j].cpu()),
                                 ref["parity"][0, j].cpu().numpy()),
                  f"the op after the host kill gave wrong parity {k + j}")
        predicted["dcn_fallback"] = merge_routes(
            {"dcn_fallback": 1}, applies(on_card, "encode", 1))

    rows = dict(routes.rows)
    print("multi_device route split: " + json.dumps(
        {"predicted": predicted, "observed": rows}))
    print(f"dcn hosts' Kernel A launches: {worker_launches} over {ops} ops")
    for phase, want_row in predicted.items():
        check(rows.get(phase, {}) == want_row,
              f"multi_device {phase} routes {rows.get(phase)}, predicted "
              f"{want_row}")
    return counted


# -- path 14: the cluster life cycle ----------------------------------------

#: path 14: RADOS objects of Ceph's default object size, a striped object
#: in libradosstriper's default layout (64 KiB units, 4 stripes, 4 MiB
#: objects: 16 objects), the half overwritten after the snapshot
LIFE_OBJECTS = 32
LIFE_STRIPED_BYTES = 64 * MIB
#: the striped object's calls: the op size in which ``rados put
#: --striper`` writes a file (src/tools/rados/rados.cc, default_op_size
#: = 1 << 22), 16 stripe units on each of 4 objects a call
LIFE_STRIPED_CALL = 4 * MIB
LIFE_WATCHERS = 2
LIFE_OUT = 11  # marked out (and left up) for the backfill phase
LIFE_PHASES = ("write", "striped_write", "striped_read", "snap_overwrite",
               "snap_read", "rollback", "watch_notify", "takeover",
               "recovery", "read_recovered", "backfill", "scrub_repair",
               "scrub_clean", "read_after_out", "mgr")


def predict_lifecycle(
    on_card: bool, ops: dict[str, int], ring: dict[str, dict[str, int]],
    decodes: dict[str, list[tuple]], hashed: dict[str, int],
) -> dict[str, dict[str, int]]:
    """The routes of path 14's phases. ``ops``: the fused writes each
    phase drives, from its op counts (every one a whole stripe or more
    at the 4 KiB csum block: one Kernel B launch each, except that ops a
    primary coalesces share one launch a ring batch; ``ring``: each
    phase's ``stream.*`` counts, which follow the clients' timing, as on
    the cluster path). ``decodes``: each phase's decode calls, from the
    map's holes and the reads' sizes (a phase whose decodes follow
    timing or the PG logs passes the calls it recorded, once they are
    held to the positions the map allows), each routed by its matrix
    and size as ``predict_cluster`` routes them. ``hashed``: the Kernel
    C hashes of each phase (a deep scrub hashes every live shard of
    every object with HashInfo once, a repair each rebuilt shard once
    more; recovery verifies follow the PG logs, as on the cluster path;
    no other phase hashes)."""
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.utils import config

    limit = int(config.get("ec_host_dispatch_bytes"))
    codec = registry.factory("isa", PIPE_PROFILE, device="cpu")

    def routed(phase):
        batched = ring.get(phase, {})
        launches = (ops.get(phase, 0) - batched.get("stream.ops", 0)
                    + batched.get("stream.batches", 0))
        return merge_routes(
            fused_writes(on_card, launches), batched,
            *(decode_route(on_card, codec, call, limit)
              for call in decodes.get(phase, [])),
            hashes(on_card, hashed.get(phase, 0)))

    return {phase: routed(phase) for phase in LIFE_PHASES}


def object_decodes(osdmap, pool: str, reads, k: int, n: int) -> list[tuple]:
    """The decode call (present, wanted, input bytes, host input) that
    each read of ``reads`` ((oid, bytes a shard)) needs under
    ``osdmap``: the lost data positions from the first k live
    positions' bytes, as the stores return them (host memory); none when
    only parity positions are lost."""
    return [(present, want, k * nbytes, True) for oid, nbytes in reads
            for present, want in cluster_reads(osdmap, pool, [oid], k, n)]


def lifecycle_path(rng, dev) -> Counted:
    """Path 14, the cluster life cycle: a ``Monitor`` and 12
    ``OSDDaemon``s on the card over ``MemStore``s, one ISA EC(8,4) pool
    of 32 PGs at a 4 KiB stripe unit, 16 client threads. 32 RADOS
    objects of 4 MiB; a 64 MiB object through ``StripedIoCtx``'s
    default layout (16 objects of 4 MiB) in calls of 4 MiB; a pool
    snapshot, half the objects overwritten (each clones its head first),
    head and snap read back, one object rolled back; two watchers and a
    notify; the primary of the PG with the most objects stopped, its
    objects rewritten through the new primary, the old one revived and
    caught up; one OSD marked out and every object read while backfill
    moves its shards under ``pg_temp``; one data and one parity shard
    corrupted, ``scrub_all(repair=True)`` and a clean second scrub;
    every object and the striped one read around the out OSD's hole;
    the mgr's health and one balancer pass. Every read is held against
    a numpy model, every phase's routes against ``predict_lifecycle``,
    every decode against the positions the map leaves."""
    from ceph_tpu_torch.cluster import Manager, Monitor, RadosClient
    from ceph_tpu_torch.cluster.osd_daemon import make_loc, shard_key
    from ceph_tpu_torch.cluster.striper import StripedIoCtx
    from ceph_tpu_torch.store import Transaction
    from ceph_tpu_torch.utils import config

    k, m = int(PIPE_PROFILE["k"]), int(PIPE_PROFILE["m"])
    n = k + m
    size = OBJECT_BYTES
    shard = size // k
    pool = "rbd"
    oids = [f"rbd_data.life.{i:016x}" for i in range(LIFE_OBJECTS)]
    model = {oid: rng.integers(0, 256, size, dtype=np.uint8) for oid in oids}
    striped = rng.integers(0, 256, LIFE_STRIPED_BYTES, dtype=np.uint8)
    cl = SmokeCluster(dev, pool, "life")
    clients = cl.clients
    read_all = functools.partial(read_back, model)

    def whole_reads(objs):
        """The decodes of whole reads of ``objs`` under today's map."""
        return object_decodes(mon.osdmap, pool, [(o, shard) for o in objs],
                              k, n)

    def striped_reads(st):
        """The decodes of a whole read of the striped object: one read
        a run of each piece (``StripedIoCtx._extents``)."""
        return object_decodes(mon.osdmap, pool, [
            (st._piece("vol", idx), run // k)
            for idx, _off, run in st._extents(0, LIFE_STRIPED_BYTES)], k, n)

    routes = ClusterRoutes(cl.started)
    ops: dict[str, int] = {}
    hashed: dict[str, int] = {}
    want: dict[str, list] = {}  # each phase's decodes, from the map
    with contextlib.ExitStack() as stack:
        stack.callback(cl.stop_all)
        stack.enter_context(config.override(
            csum_block_size=CSUM_BLOCK, osd_deep_scrub_stride=524288,
            ec_streaming_dispatch=False))
        counted = stack.enter_context(Counted("cluster_lifecycle"))
        stack.enter_context(routes.recording())

        mon = Monitor(device=dev)
        for i in range(CLUSTER_OSDS):
            mon.osd_crush_add(i)
        daemons = [cl.start_osd(mon, i) for i in range(CLUSTER_OSDS)]
        mon.osd_erasure_code_profile_set(
            "isa84", {"plugin": "isa", **PIPE_PROFILE})
        mon.osd_pool_create(pool, CLUSTER_PG_NUM, "isa84")
        cl.connect(mon)
        wait_linked(mon, daemons, "after the life-cycle cluster booted")
        io = cl.ioctxs[0]
        pool_id = mon.osdmap.pools[pool].pool_id

        # -- 1. 32 RADOS objects of 4 MiB -------------------------------
        ops["write"] = len(oids)
        with routes("write"), Phase("life_write", len(oids) * size):
            clients(lambda io, oid: io.write_full(oid, model[oid].tobytes()),
                    oids)

        # -- 2. 64 MiB through the striper's default layout -------------
        st = StripedIoCtx(io)
        check((st.su, st.sc, st.object_size) == (65536, 4, 4 * MIB),
              "StripedIoCtx's default layout is not 64 KiB x 4 x 4 MiB")
        calls = LIFE_STRIPED_BYTES // LIFE_STRIPED_CALL
        units = LIFE_STRIPED_CALL // st.su
        # each call: one 64 KiB write a stripe unit (in flight at once,
        # 16 on each of 4 objects), and the size metadata object
        # rewritten once
        ops["striped_write"] = calls * (units + 1)
        with routes("striped_write"), Phase("life_striped_write",
                                            LIFE_STRIPED_BYTES):
            for c in range(calls):
                lo = c * LIFE_STRIPED_CALL
                st.write("vol", striped[lo:lo + LIFE_STRIPED_CALL].tobytes(),
                         offset=lo)
        pieces = sorted(o for o in io.list_objects() if o.startswith("vol."))
        check(len(pieces) == LIFE_STRIPED_BYTES // st.object_size + 1,
              f"the striped object spans {pieces}")
        with routes("striped_read"), Phase("life_striped_read",
                                           LIFE_STRIPED_BYTES):
            check(st.stat("vol") == LIFE_STRIPED_BYTES
                  and st.read("vol") == striped.tobytes(),
                  "the striped object read back other bytes")

        # -- 3. a pool snapshot, half overwritten, one rolled back ------
        io.snap_create("life1")
        snapped = {oid: model[oid].copy() for oid in oids}
        over = oids[::2]
        for oid in over:
            model[oid] = rng.integers(0, 256, size, dtype=np.uint8)
        # each overwrite clones its head first (one whole write more)
        ops["snap_overwrite"] = 2 * len(over)
        with routes("snap_overwrite"), Phase("life_snap_overwrite",
                                             len(over) * size):
            clients(lambda io, oid: io.write_full(oid, model[oid].tobytes()),
                    over)

        def read_both(io, oid):
            read_all(io, oid)
            check(io.read(oid, snap="life1") == snapped[oid].tobytes(),
                  f"{oid} at the snapshot read back other bytes")

        with routes("snap_read"), Phase("life_snap_read", 2 * len(oids) * size):
            clients(read_both, oids)
        back = over[0]
        ops["rollback"] = 1
        with routes("rollback"), Phase("life_rollback", size):
            io.snap_rollback(back, "life1")
            model[back] = snapped[back].copy()
            read_all(io, back)

        # -- 4. two watchers and a notify --------------------------------
        watched = oids[1]
        events: list = []
        watchers = [RadosClient(mon, backoff=0.01)
                    for _ in range(LIFE_WATCHERS)]
        cl.open_clients.extend(watchers)
        with routes("watch_notify"):
            cookies = [w.open_ioctx(pool).watch(
                watched, lambda o, d, w=w: events.append((o, bytes(d))))
                for w in watchers]
            acked = io.notify(watched, b"life-cycle")
        check(sorted(acked["acked"]) == sorted(cookies)
              and acked["missed"] == []
              and events == [(watched, b"life-cycle")] * LIFE_WATCHERS,
              f"notify reached {acked}, events {events}")

        # -- 5. the primary of the fullest PG stopped, then revived -----
        by_pg: dict[int, list] = {}
        for oid in oids:
            by_pg.setdefault(mon.osdmap.object_to_pg(pool, oid), []).append(oid)
        pgid, pg_oids = max(sorted(by_pg.items()), key=lambda kv: len(kv[1]))
        victim = mon.osdmap.pg_primary(pool, pgid)
        # the positions the victim holds in any PG: its catch-up and
        # the repair of the PGs it leads rebuild only those
        victim_pos = {mon.osdmap.pg_to_up_acting(pool, p).index(victim)
                      for p in range(CLUSTER_PG_NUM)}
        daemons[victim].stop()
        mon.osd_down(victim)
        live = [d for d in daemons if d.osd_id != victim]
        wait_settled(mon, live, f"after osd.{victim} went down")
        new_primary = mon.osdmap.pg_primary(pool, pgid)
        for oid in pg_oids:
            model[oid] = rng.integers(0, 256, size, dtype=np.uint8)
        # a head the snapshot still shares clones first: a degraded
        # read of the old head around the victim's hole, and one whole
        # write more
        cloned = [oid for oid in pg_oids if oid not in over]
        ops["takeover"] = len(pg_oids) + len(cloned)
        want["takeover"] = whole_reads(cloned)
        with routes("takeover"), Phase("life_takeover", len(pg_oids) * size):
            clients(lambda io, oid: io.write_full(oid, model[oid].tobytes()),
                    pg_oids)
        # A returning daemon peers a PG it leads at the PG's first op:
        # one stat an object has every PG peer, the victim's repair its
        # own shards, before the phase ends.
        with routes("recovery"), Phase("life_recovery", len(pg_oids) * size):
            daemons[victim] = cl.start_osd(mon, victim, daemons[victim].store)
            live.append(daemons[victim])
            wait_settled(mon, live, f"after osd.{victim} returned")
            clients(lambda io, oid: io.stat(oid), oids)
            wait_settled(mon, live, f"after osd.{victim}'s PGs peered")
        check(mon.osdmap.pg_primary(pool, pgid) == victim,
              f"osd.{victim} did not lead PG {pgid} again")
        want["read_recovered"] = []
        with routes("read_recovered"), Phase("life_read_recovered",
                                             2 * len(pg_oids) * size):
            for oid in pg_oids:
                read_all(io, oid)
                check(io.read(oid, snap="life1") == snapped[oid].tobytes(),
                      f"{oid} at the snapshot changed through the takeover")

        # -- 6. one OSD out: reads under pg_temp while backfill runs ----
        out_osd = LIFE_OUT if LIFE_OUT != victim else LIFE_OUT - 1
        with routes("backfill"), Phase("life_backfill", len(oids) * size):
            mon.osd_out(out_osd)
            under_temp = bool(mon.osdmap.pg_temp)
            clients(read_all, oids)
            wait_settled(mon, live, f"after osd.{out_osd} went out")
        print(f"life-cycle backfill: pg_temp {'up' if under_temp else 'down'}"
              " when the reads started")
        check(not any(out_osd in mon.osdmap.object_to_acting(pool, oid)
                      for oid in oids),
              f"osd.{out_osd} still holds a position after backfill")
        # a read that found its PG's pg_temp cleared decodes around the
        # out OSD's hole; one under pg_temp decodes nothing
        want["backfill"] = whole_reads(oids)

        # -- 7. one data and one parity shard corrupted, repaired -------
        locs = sorted({key.rpartition("#s")[0] for d in live
                       for key in d.store.list_objects()
                       if key.startswith(f"{pool_id}:")})
        bad = {}
        for oid, pos in ((oids[3], 2), (oids[5], k + 1)):
            acting = mon.osdmap.object_to_acting(pool, oid)
            key = shard_key(make_loc(pool_id, oid), pos)
            store = daemons[acting[pos]].store
            byte = store.read(key, 777, 1)[0]
            store.queue_transactions(Transaction().write(
                key, 777, bytes([byte ^ 0x5A])))
            bad[make_loc(pool_id, oid)] = [pos]
        hashed["scrub_repair"] = (hashed_shards(mon, pool, daemons, locs)
                                  + len(bad))
        with routes("scrub_repair"), Phase(
                "life_scrub_repair", len(oids) * size):
            fixed = scrub_live(live, repair=True)
        got = {loc: sorted({e.shard for e in r.errors})
               for loc, r in fixed.items() if not r.ok}
        check(got == bad and all(fixed[loc].repaired for loc in bad),
              f"the repair scrub found {got}, want {bad} repaired")
        hashed["scrub_clean"] = hashed_shards(mon, pool, daemons, locs)
        with routes("scrub_clean"), Phase("life_scrub_clean",
                                          len(oids) * size):
            again = scrub_live(live)
        check(sorted(again) == locs and all(r.ok for r in again.values()),
              "the scrub after the repair is not clean")

        # -- 8. every object read around the out OSD's hole -------------
        want["read_after_out"] = whole_reads(oids) + striped_reads(st)
        with routes("read_after_out"), Phase(
                "life_read_after_out", len(oids) * size + LIFE_STRIPED_BYTES):
            clients(read_all, oids)
            check(st.read("vol") == striped.tobytes(),
                  "the striped object changed through the backfill")

        # -- 9. the mgr: health and one balancer pass --------------------
        # 12 OSDs for 12 positions: with one out, every PG has a hole
        # (undersized and degraded, one missing shard an object), and
        # nothing else is wrong; every OSD holds a shard of every PG, so
        # the balancer has nothing to move
        mgr = Manager(mon)
        want["mgr"] = []
        with routes("mgr"):
            for d in live:
                d.report_pg_stats(force=True)
            health = mgr.health()
            reweights = mgr.balance_once()
            wait_settled(mon, live, "after the balancer pass")
        print(f"life-cycle mgr: {health['status']} {health['checks']}; "
              f"balancer reweights {reweights}")
        degraded = f"{CLUSTER_PG_NUM} pgs degraded ({len(locs)} object copies)"
        check(health["status"] == "HEALTH_WARN"
              and health["checks"].get("PG_DEGRADED", {}).get("detail")
              == degraded and set(health["checks"]) <= {"PG_DEGRADED",
                                                        "PG_STUCK"},
              f"the mgr's health after the life cycle: {health}, want "
              f"PG_DEGRADED {degraded!r} alone (PG_STUCK aside)")
        check(not reweights, f"the balancer moved {reweights}")

    on_card = dev.type == "cuda"
    rows = routes.rows
    decodes = routes.phase_decodes
    print("cluster_lifecycle decodes: " + json.dumps(
        {phase: [list(map(list, call[:2])) + list(call[2:])
                 for call in calls] for phase, calls in decodes.items()
         if calls}))
    # phases whose decodes the map and the reads' sizes fix
    for phase in ("takeover", "read_recovered", "read_after_out", "mgr"):
        check(sorted(decodes.get(phase, [])) == sorted(want[phase]),
              f"life-cycle phase {phase} decoded {decodes.get(phase)}, "
              f"the map asks for {want[phase]}")
    # phases whose decodes follow timing or the PG logs: held to the
    # positions the map allows
    left = list(want["backfill"])
    for call in decodes.get("backfill", []):
        check(call in left, f"the backfill phase decoded {call}, outside "
              f"the out OSD's holes {want['backfill']}")
        left.remove(call)
    check(all(call[1] and set(call[1]) <= victim_pos
              for call in decodes.get("recovery", [])),
          f"the recovery rebuilt other shards than osd.{victim}'s "
          f"{sorted(victim_pos)}: {decodes.get('recovery')}")
    repaired = sorted(call[1] for call in decodes.get("scrub_repair", []))
    check(repaired == [(2,), (k + 1,)],
          f"the repair rebuilt {repaired}, want positions 2 and {k + 1}")
    for phase in ("backfill", "recovery", "scrub_repair"):
        want[phase] = decodes.get(phase, [])
    hashed["recovery"] = sum(v for key, v in rows.get("recovery", {}).items()
                             if key.startswith("backend."))
    for row in rows.values():
        for key in ClusterRoutes.COALESCE_KEYS:
            row.pop(f"coalesce.{key}", None)
    ring = {phase: {key: val for key, val in row.items()
                    if key.startswith("stream.")}
            for phase, row in rows.items()}
    predicted = predict_lifecycle(on_card, ops, ring, want, hashed)
    print("cluster_lifecycle route split: " + json.dumps(
        {"predicted": predicted, "observed": rows}))
    for phase, want_row in predicted.items():
        check(rows.get(phase, {}) == want_row,
              f"life-cycle phase {phase} routes {rows.get(phase)}, "
              f"predicted {want_row}")
    print(f"cluster_lifecycle outputs: {len(oids)} objects of {size} B and "
          f"a {LIFE_STRIPED_BYTES} B striped object ({len(pieces)} objects, "
          f"{calls} calls) written; snapshot read, {len(over)} overwritten, "
          f"{back} rolled back; {LIFE_WATCHERS} watchers notified; "
          f"osd.{victim} stopped ({len(pg_oids)} objects of PG {pgid} "
          f"rewritten through osd.{new_primary}) and revived; "
          f"osd.{out_osd} backfilled out; 2 corrupt shards repaired, scrub "
          f"clean; every object read around the hole; mgr "
          f"{health['status']}")
    return counted


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
    from ceph_tpu_torch import kernels, native

    t0 = time.perf_counter()
    check(native.available(), "the native host tier did not build: "
          + native.build_log[-2000:])
    print(f"native host tier built and loaded in "
          f"{time.perf_counter() - t0:.1f} s (g++)")
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
    rows["xor_schedule"] = xor_vs_plain(rng, dev)
    rows.update(clay_vs_plain(rng, dev))
    torch.cuda.empty_cache()

    # -- 3.. the main paths, each counted --------------------------------
    paths = [isa_path(rng, dev)]
    torch.cuda.empty_cache()
    paths.append(schedule_path(rng, dev))
    torch.cuda.empty_cache()
    paths.append(clay_path(rng, dev))
    torch.cuda.empty_cache()
    paths.append(pipeline_path(rng, dev))
    torch.cuda.empty_cache()
    paths.append(store_path(rng, dev))
    torch.cuda.empty_cache()
    paths.append(cluster_path(rng, dev))
    torch.cuda.empty_cache()
    paths.append(bench_cli_path(dev))
    torch.cuda.empty_cache()
    paths.append(loadgen_path(dev))
    torch.cuda.empty_cache()
    paths.append(quorum_path(rng, dev))
    torch.cuda.empty_cache()
    paths.append(tools_path(rng, dev))
    torch.cuda.empty_cache()
    paths.append(multi_device_path(rng, dev))
    torch.cuda.empty_cache()
    paths.append(lifecycle_path(rng, dev))

    print(json.dumps({"phases": Phase.results}))
    kern_rows = []
    for kern in kernels.ALL:
        name = kern.symbol
        src, replaces = KERNEL_INFO[name]
        kern_rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(p.launches[name] for p in paths),
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
