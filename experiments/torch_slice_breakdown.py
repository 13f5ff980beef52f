"""Where the time of the ported slices goes, on one CUDA card.

Runs the main paths of ``chip_smoke.py`` once to warm up, then once
under ``torch.profiler`` (CPU + CUDA activities) and once under
``cProfile``: the ISA EC(8,4) host-staged write with fused csums and
HashInfo, degraded read and verify; the jerasure liberation k=6 w=7
host-staged write with HashInfo, degraded read of shards {1, 4} and the
RMW of one chunk; the LRC xor-local repair of one chunk on CUDA
tensors; and CLAY(8,4,d=11) over 64 objects of 4 MiB: the encode of
device-resident data (the layered engine, one eager op per pair
transform), the host-staged write with HashInfo, the repair of chunk 9
from device-resident helper sub-chunks, the degraded read of shard 9
through ``reconstruct_shards``, the two-erasure decode {0, 8}, and the
CLAY(8,4,d=10) repair of chunk 8 with one aloof helper; and the
pipeline path's OSD EC backend (ISA EC(8,4) at a 4 KiB stripe unit over
12 MemStores, 64 objects of 4 MiB, as in ``chip_smoke.py``): the write
(two 2 MiB appends each), 64 parity-delta overwrites of 4 KiB on the
data shards other than 5, the degraded read of every object with shards
{0, 5, 9} down, the rebuild of shard 9 into an empty store, the deep
scrub, and xxhash64 over 64 MiB on the card; and the store path's write
over 12 BlockStores (16 objects of 4 MiB in 128 KiB appends): 8 PG
threads through the streaming dispatcher's ring against the same
appends per op on one thread (``store_phases``); and the cluster path
(``cluster_phases``: 12 OSD daemons on the card, 16 clients over TCP,
16 objects of 4 MiB): write, read-back, degraded read with two OSDs
down (on a second cluster), deep scrub; and the loadgen path
(``loadgen_phases``: ``bench_cli loadgen --preset mixed`` as the smoke
runs it, one phase of its own cluster's boot, 600 ops with a kill and
revive, recovery, and shutdown). Prints per phase:

- host-clock time, and device busy time summed over kernels and copies
  (from the profiler's device events), hence the device idle share, and
  the number of device operations (kernels and copies) the phase ran;
- the launches of each of the port's kernels in the host-clock run
  (their ``launches`` counts, zeroed just before the phase);
- the top device operations by total device time;
- the top host functions by cumulative time and by self time
  (cProfile: it slows every Python call, so its shares lean toward
  call-heavy code; on Python 3.12 it sees every thread, so cumulative
  times sum the threads' blocking waits).

Writes the full report to ``chiprun_out/torch_slice_breakdown.json``.
Not part of the package; imports nothing of JAX or ceph_tpu.

Usage: python3 experiments/torch_slice_breakdown.py [--seed N]
       [--only isa|schedule|clay|pipeline|store|cluster|loadgen ...]
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
K, M, STRIPES, CHUNK, CB = 8, 4, 8, 1 << 20, 4096
LOST = (0, 3, 9, 11)
LIB = {"technique": "liberation", "k": "6", "m": "2", "w": "7"}
LIB_K, LIB_N, LIB_STRIPES, LIB_CHUNK = 6, 8, 16, 7 * 147456
LIB_LOST = (1, 4)
CLAY = {"k": "8", "m": "4", "d": "11"}
CLAY_GENERAL = {"k": "8", "m": "4", "d": "10"}
CLAY_OBJECTS = 64
PIPE_OBJECTS, PIPE_OBJECT_BYTES = 64, 4 << 20
PIPE_SMALL_SHARDS = (0, 1, 2, 3, 4, 6, 7)
#: the store phases: fewer objects than the smoke's 64 (four runs each)
STORE_OBJECTS, STORE_THREADS, STORE_APPEND = 16, 8, 128 << 10
STORE_DEVICE_BYTES = 64 << 20
#: the cluster phases: 12 OSDs, 32 PGs, 16 clients, as in the smoke, at
#: fewer objects (each phase runs four times)
CLUSTER_OSDS, CLUSTER_PG_NUM, CLUSTER_CLIENTS = 12, 32, 16
CLUSTER_OBJECTS, CLUSTER_DOWN = 16, (3, 7)


def phases(payload, dev_name="cuda"):
    """name -> zero-argument callable for each phase of the main path,
    built fresh so every run does the same work."""
    from ceph_tpu_torch.checksum import Checksummer
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.pipeline import HashInfo, ShardExtentMap, StripeInfo

    codec = registry.factory(
        "isa", {"k": str(K), "m": str(M)}, device=dev_name
    )
    sinfo = StripeInfo(K, M, K * CHUNK)
    streams = np.ascontiguousarray(
        payload.reshape(STRIPES, K, CHUNK).transpose(1, 0, 2)
    ).reshape(K, -1)
    shard_bytes = STRIPES * CHUNK
    state = {}

    def write():
        smap = ShardExtentMap(sinfo)
        for r in range(K):
            smap.insert(r, 0, streams[r])
        smap.encode(codec, HashInfo(K + M, device=dev_name), csum_block=CB)
        state["stored"] = {s: smap.get(s, 0, shard_bytes)
                           for s in range(K + M)}
        state["csums"] = smap.csums

    def degraded_read():
        smap = ShardExtentMap(sinfo)
        for s, buf in state["stored"].items():
            if s not in LOST:
                smap.insert(s, 0, buf)
        smap.decode(codec, set(LOST), K * shard_bytes)

    def verify():
        from ceph_tpu_torch.checksum.crc32c import crc32c_seed_shift

        blob = np.concatenate(
            [state["csums"]["shards"][s][1] for s in range(K + M)]
        ) ^ np.uint32(crc32c_seed_shift(CB, 0xFFFFFFFF))
        data = np.concatenate([state["stored"][s] for s in range(K + M)])
        assert Checksummer("crc32c", CB, device=dev_name).verify(
            data, blob) == (-1, 0)

    return {"write": write, "degraded_read": degraded_read,
            "verify": verify}


def schedule_phases(rng, dev_name="cuda"):
    """The XOR-schedule path's phases, as ``phases``."""
    import torch

    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.pipeline import HashInfo, ShardExtentMap, StripeInfo
    from ceph_tpu_torch.utils import config

    codec = registry.factory("jerasure", LIB, device=dev_name)
    sinfo = StripeInfo(LIB_K, LIB_N - LIB_K, LIB_K * LIB_CHUNK)
    shard_bytes = LIB_STRIPES * LIB_CHUNK
    streams = rng.integers(0, 256, (LIB_K, shard_bytes), dtype=np.uint8)
    new_chunk = rng.integers(0, 256, LIB_CHUNK, dtype=np.uint8)
    lrc = registry.factory(
        "lrc", {"k": "4", "m": "2", "l": "3", "local_parity": "xor"},
        device=dev_name)
    group = [torch.from_numpy(rng.integers(
        0, 256, (16, 1 << 20), dtype=np.uint8)).to(dev_name)
        for _ in range(3)]
    state = {}

    def stored_map():
        smap = ShardExtentMap(sinfo)
        for s, buf in state["stored"].items():
            smap.insert(s, 0, buf)
        return smap

    def lib_write():
        smap = ShardExtentMap(sinfo)
        for r in range(LIB_K):
            smap.insert(r, 0, streams[r])
        smap.encode(codec, HashInfo(LIB_N, device=dev_name), csum_block=CB)
        state["stored"] = {s: smap.get(s, 0, shard_bytes)
                           for s in range(LIB_N)}

    def lib_degraded_read():
        smap = stored_map()
        for s in LIB_LOST:
            smap.erase_shard(s)
        smap.decode(codec, set(LIB_LOST), LIB_K * shard_bytes)

    def lib_rmw():
        new = ShardExtentMap(sinfo)
        new.insert(3, LIB_CHUNK, new_chunk)
        with config.override(ec_host_dispatch_bytes=0):
            new.encode_parity_delta(codec, stored_map())

    def lrc_local_repair():
        # minimum_to_decode's plan for chunk 0: data 1, the group's
        # global parity (4) and its local parity (5); random bytes time
        # the same as a codeword
        lrc.decode_chunks({0}, {1: group[0], 4: group[1], 5: group[2]})

    return {"lib_write": lib_write, "lib_degraded_read": lib_degraded_read,
            "lib_rmw": lib_rmw, "lrc_local_repair": lrc_local_repair}


def clay_phases(rng, dev_name="cuda"):
    """The CLAY path's phases, as ``phases``."""
    import torch

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

    codec = registry.factory("clay", CLAY, device=dev_name)
    gen = registry.factory("clay", CLAY_GENERAL, device=dev_name)
    k, n, objs = 8, 12, CLAY_OBJECTS
    chunk = codec.get_chunk_size(4 << 20)
    sinfo = StripeInfo(k, n - k, k * chunk)
    shard_bytes = objs * chunk
    data = {i: torch.from_numpy(rng.integers(
        0, 256, (objs, chunk), dtype=np.uint8)).to(dev_name)
        for i in range(k)}
    chunk10 = gen.get_chunk_size(4 << 20)
    data10 = {i: torch.from_numpy(rng.integers(
        0, 256, (objs, chunk10), dtype=np.uint8)).to(dev_name)
        for i in range(k)}
    full = {**data, **codec.encode_chunks(data)}
    full10 = {**data10, **gen.encode_chunks(data10)}

    def helpers(c, chunks, lost, avail):
        out = {}
        z = c.get_sub_chunk_count()
        for s, runs in c.minimum_to_decode({lost}, avail).items():
            planes = torch.tensor(
                [p for i, cnt in runs for p in range(i, i + cnt)],
                device=dev_name)
            out[s] = chunks[s].reshape(objs, z, -1).index_select(
                1, planes).reshape(objs, -1)
        return out

    help9 = helpers(codec, full, 9, set(range(n)) - {9})
    help10 = helpers(gen, full10, 8, set(range(n)) - {8, 11})
    streams = {i: full[i].cpu().numpy().reshape(-1) for i in range(n)}
    state = {}

    def clay_encode_device():
        codec.encode_chunks(data)

    def clay_write():
        smap = ShardExtentMap(sinfo)
        for r in range(k):
            smap.insert(r, 0, streams[r])
        smap.encode(codec, HashInfo(n, device=dev_name), csum_block=CB)
        state["smap"] = smap

    def clay_repair_device():
        codec.repair({9}, help9)

    def clay_degraded_read():
        want = {9: ExtentSet([(0, shard_bytes)])}
        reads, _ = get_min_avail_to_read_shards(
            sinfo, codec, want, set(range(n)) - {9})
        result = ShardExtentMap(sinfo)
        for s, sr in reads.items():
            for lo, hi in sr.extents:
                result.insert(s, lo, state["smap"].get(s, lo, hi - lo))
        reconstruct_shards(sinfo, codec, result, want, reads,
                           k * shard_bytes)

    def clay_decode_two():
        codec.decode_chunks({0, 8}, {i: v for i, v in full.items()
                                     if i not in (0, 8)})

    def clay_d10_repair_aloof():
        gen.repair({8}, help10)

    return {"clay_encode_device": clay_encode_device,
            "clay_write": clay_write,
            "clay_repair_device": clay_repair_device,
            "clay_degraded_read": clay_degraded_read,
            "clay_decode_two": clay_decode_two,
            "clay_d10_repair_aloof": clay_d10_repair_aloof}


def pipeline_phases(rng, dev_name="cuda"):
    """The OSD EC backend's phases over one stack; each callable leaves
    the stack as it found it or rebuilds what it needs."""
    from ceph_tpu_torch.checksum import Checksummer
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.pipeline import (
        PGLog, ReadPipeline, RecoveryBackend, StripeInfo, be_deep_scrub,
    )
    from ceph_tpu_torch.pipeline.rmw import RMWPipeline, ShardBackend
    from ceph_tpu_torch.store import MemStore

    import torch

    prof = {"k": str(K), "m": str(M), "technique": "reed_sol_van"}
    sinfo = StripeInfo(K, M, K * 4096)
    oids = [f"obj{i}" for i in range(PIPE_OBJECTS)]
    data = {o: rng.integers(0, 256, PIPE_OBJECT_BYTES, dtype=np.uint8)
            .tobytes() for o in oids}
    half = PIPE_OBJECT_BYTES // 2
    small = [(oids[int(rng.integers(0, len(oids)))],
              (int(rng.integers(0, PIPE_OBJECT_BYTES // (K * 4096))) * K
               + PIPE_SMALL_SHARDS[int(rng.integers(0, 7))]) * 4096,
              rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())
             for _ in range(64)]

    def stack():
        codec = registry.factory("isa", prof, device=dev_name)
        backend = ShardBackend({s: MemStore(f"osd.{s}") for s in range(K + M)})
        rmw = RMWPipeline(sinfo, codec, backend, pglog=PGLog(K + M))
        return codec, backend, rmw

    def write_all(rmw):
        for o in oids:
            rmw.submit(o, 0, data[o][:half])
            rmw.submit(o, half, data[o][half:])

    codec, backend, rmw = stack()
    write_all(rmw)
    # the overwrites clear the HashInfo of what they touch: they get a
    # stack of their own, so the scrub below still verifies every shard
    _, _, rmw_small = stack()
    write_all(rmw_small)
    reads = ReadPipeline(sinfo, codec, backend, rmw.object_size)
    rec = RecoveryBackend(sinfo, codec, backend, rmw.object_size, rmw.hinfo,
                          eversion_fn=rmw.object_eversion)
    blob = torch.from_numpy(rng.integers(0, 256, 64 << 20, dtype=np.uint8)
                            ).to(dev_name)

    def pipe_write():
        write_all(stack()[2])

    def pipe_overwrite_small():
        for o, off, p in small:
            rmw_small.submit(o, off, p)

    def pipe_degraded_read():
        backend.down_shards.update({0, 5, 9})
        for o in oids:
            reads.read_sync(o, 0, PIPE_OBJECT_BYTES)
        backend.down_shards.clear()

    def pipe_rebuild_shard():
        backend.stores[9] = MemStore("osd.9.new")
        for o in oids:
            rec.recover_object(o, {9})

    def pipe_deep_scrub():
        for o in oids:
            be_deep_scrub(sinfo, backend, o, device=dev_name)

    def xxhash64_64mib():
        Checksummer("xxhash64", CB, device=dev_name).calculate(blob)

    return {"pipe_write": pipe_write,
            "pipe_overwrite_small": pipe_overwrite_small,
            "pipe_degraded_read": pipe_degraded_read,
            "pipe_rebuild_shard": pipe_rebuild_shard,
            "pipe_deep_scrub": pipe_deep_scrub,
            "xxhash64_64mib": xxhash64_64mib}


def store_phases(rng, dev_name="cuda"):
    """The store path's write, as in ``chip_smoke.py`` at fewer objects:
    ISA EC(8,4) at a 4 KiB stripe unit over 12 fresh BlockStores (device
    files in a temporary directory), 128 KiB appends. The coalesced
    write runs 8 PG threads (each its own ``RMWPipeline`` and ``PGLog``)
    with ``ec_streaming_dispatch`` on; the per-op write runs the same
    appends on one thread with it off. From Python 3.12 cProfile sees
    every thread, so the ring phase's cumulative times sum over the PG
    threads and the dispatcher's."""
    import tempfile
    import threading

    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.pipeline import PGLog, StripeInfo
    from ceph_tpu_torch.pipeline.dispatcher import shutdown_all
    from ceph_tpu_torch.pipeline.rmw import RMWPipeline, ShardBackend
    from ceph_tpu_torch.store import BlockStore
    from ceph_tpu_torch.utils import config

    prof = {"k": str(K), "m": str(M), "technique": "reed_sol_van"}
    sinfo = StripeInfo(K, M, K * 4096)
    oids = [f"rbd_data.{i:016x}" for i in range(STORE_OBJECTS)]
    data = {o: rng.integers(0, 256, PIPE_OBJECT_BYTES, dtype=np.uint8)
            .tobytes() for o in oids}
    per_pg = STORE_OBJECTS // STORE_THREADS

    def append_all(stores, objs):
        rmw = RMWPipeline(sinfo, registry.factory("isa", prof,
                                                  device=dev_name),
                          ShardBackend(stores), pglog=PGLog(K + M))
        for o in objs:
            for off in range(0, PIPE_OBJECT_BYTES, STORE_APPEND):
                done = []
                rmw.submit(o, off, data[o][off:off + STORE_APPEND],
                           done.append)
                if len(done) != 1 or done[0].error is not None:
                    raise RuntimeError(f"append to {o} failed: {done}")

    def pg_thread(stores, objs, errors):
        try:
            append_all(stores, objs)
        except Exception as e:  # reported by the joining thread
            errors.append(e)

    def write(coalesced: bool):
        with tempfile.TemporaryDirectory() as tmp:
            stores = {s: BlockStore(f"{tmp}/osd.{s}", size=STORE_DEVICE_BYTES)
                      for s in range(K + M)}
            groups = [oids[t * per_pg:(t + 1) * per_pg]
                      for t in range(STORE_THREADS)]
            errors: list = []
            if coalesced:
                with config.override(ec_streaming_dispatch=True):
                    threads = [threading.Thread(target=pg_thread,
                                                args=(stores, g, errors))
                               for g in groups]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join(timeout=900)
                    if any(t.is_alive() for t in threads):
                        raise RuntimeError("a PG thread hung")
                shutdown_all()
            else:
                for g in groups:
                    append_all(stores, g)
            for st in stores.values():
                st.close()
            if errors:
                raise errors[0]

    return {"store_coalesced_write": lambda: write(True),
            "store_per_op_write": lambda: write(False)}


def cluster_phases(rng, dev_name="cuda"):
    """The cluster path of ``chip_smoke.py`` at fewer objects: a Monitor,
    12 OSDDaemons on the card over MemStores, ISA EC(8,4) at a 4 KiB
    stripe unit in one pool of 32 PGs, 16 client threads with a
    RadosClient each over TCP on loopback. Two such clusters: on the
    healthy one the write takes fresh object names each run, and the
    read and the deep scrub (every PG on its primary) read what the
    first write stored; the other holds the same objects with osd.3
    and osd.7 stopped and marked down, and serves the degraded read.
    The daemons' scrub stamps are set at boot, as the smoke sets them,
    so no background scrub runs in a phase."""
    import threading

    from ceph_tpu_torch.cluster import Monitor, OSDDaemon, RadosClient

    data = [rng.integers(0, 256, PIPE_OBJECT_BYTES, dtype=np.uint8)
            .tobytes() for _ in range(CLUSTER_OBJECTS)]
    clients_made, daemons_made = [], []

    def boot():
        mon = Monitor(device=dev_name)
        for i in range(CLUSTER_OSDS):
            mon.osd_crush_add(i)
        daemons = []
        for i in range(CLUSTER_OSDS):
            d = OSDDaemon(i, mon, chunk_size=4096, tick_period=0.5,
                          device=dev_name)
            now = time.monotonic()
            d._scrub_stamps.update({("rbd", pg): [now, now]
                                    for pg in range(CLUSTER_PG_NUM)})
            daemons_made.append(d)
            d.start()
            daemons.append(d)
        mon.osd_erasure_code_profile_set(
            "isa84", {"plugin": "isa", "technique": "reed_sol_van",
                      "k": str(K), "m": str(M)})
        mon.osd_pool_create("rbd", CLUSTER_PG_NUM, "isa84")
        # connected once, before any phase: a client's shutdown closes
        # its sockets and joins its threads, which is no work of a phase
        made = [RadosClient(mon, backoff=0.01)
                for _ in range(CLUSTER_CLIENTS)]
        clients_made.extend(made)
        return mon, daemons, [c.open_ioctx("rbd") for c in made]

    def clients(ioctxs, fn, items):
        errors: list = []

        def run(io, part):
            try:
                for item in part:
                    fn(io, item)
            except Exception as e:  # reported by the joining thread
                errors.append(e)

        threads = [threading.Thread(target=run,
                                    args=(io, items[t::CLUSTER_CLIENTS]))
                   for t, io in enumerate(ioctxs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a client thread hung")
        if errors:
            raise errors[0]

    def write_as(ioctxs, prefix):
        clients(ioctxs, lambda io, i: io.write_full(f"{prefix}.{i}",
                                                    data[i]),
                list(range(CLUSTER_OBJECTS)))

    def read_from(ioctxs):
        def one(io, i):
            if io.read(f"obj0.{i}") != data[i]:
                raise RuntimeError(f"obj0.{i} read back other bytes")

        clients(ioctxs, one, list(range(CLUSTER_OBJECTS)))

    _mon, healthy, ioctxs = boot()
    down_mon, down, down_ioctxs = boot()
    write_as(down_ioctxs, "obj0")
    for i in CLUSTER_DOWN:
        down[i].stop()
        down_mon.osd_down(i)
    runs = {"write": 0}

    def write():
        write_as(ioctxs, f"obj{runs['write']}")
        runs["write"] += 1

    def deep_scrub():
        for d in healthy:
            for results in d.scrub_all().values():
                if not all(r.ok for r in results):
                    raise RuntimeError(f"deep scrub on osd.{d.osd_id} "
                                       "not clean")

    return {"cluster_write": write,
            "cluster_read": lambda: read_from(ioctxs),
            "cluster_degraded_read": lambda: read_from(down_ioctxs),
            "cluster_deep_scrub": deep_scrub}, (clients_made, daemons_made)


def loadgen_phases(dev_name="cuda"):
    """The loadgen path of ``chip_smoke.py``: ``bench_cli loadgen
    --preset mixed`` in-process (600 ops of 256 KiB objects, queue depth
    16, zipfian, on 12 OSD daemons on the card, jerasure reed_sol_van
    EC(8,4) at a 4 KiB stripe unit, 32 PGs, the most-primary OSD killed
    at op 200 and revived at op 400, the device clock and 8 captured
    traces), under the
    smoke's config (host/device crossovers of 64 KiB for codec inputs and
    32 KiB for checksum streams, no scheduled scrubs). Each run boots its
    own cluster; the JSON report of the last run is kept."""
    import contextlib
    import io

    from chip_smoke import LOADGEN_ARGV, LOADGEN_OVERRIDES
    from ceph_tpu_torch import bench_cli
    from ceph_tpu_torch.utils import config

    last: dict = {}

    def run():
        err = io.StringIO()
        with config.override(**LOADGEN_OVERRIDES), \
                contextlib.redirect_stderr(err):
            bench_cli.run(bench_cli.parse_args(
                LOADGEN_ARGV + ["--device", dev_name]))
        lines = err.getvalue().splitlines()
        last["report"] = json.loads(next(
            ln for ln in reversed(lines) if ln.startswith("{")))

    return {"loadgen": run}, last


def device_time_us(prof, spans=()) -> tuple[float, list, int]:
    """Sum of device time over the kernels and copies the card ran, and
    the top ones, from a finished torch.profiler run. Only events that
    ran on the device count: a host op's device total (aten::copy_)
    repeats its children's, CUPTI's own buffer requests are no work of
    the program, and the device-side ranges of the pipeline's tracer
    spans (``spans``: their names; torch.profiler.record_function) only
    bracket kernels already counted."""
    rows = []
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        if evt.key.startswith("Activity Buffer Request") or evt.key in spans:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us:
            rows.append({"name": evt.key, "device_us": float(dev_us),
                         "count": int(evt.count)})
    rows.sort(key=lambda r: -r["device_us"])
    return (sum(r["device_us"] for r in rows), rows[:8],
            sum(r["count"] for r in rows))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", nargs="+",
                    choices=("isa", "schedule", "clay", "pipeline", "store",
                             "cluster", "loadgen"),
                    default=("isa", "schedule", "clay", "pipeline",
                             "store", "cluster", "loadgen"))
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    payload = np.random.default_rng(args.seed).integers(
        0, 256, K * STRIPES * CHUNK, dtype=np.uint8
    )
    steps = phases(payload) if "isa" in args.only else {}
    if "schedule" in args.only:
        steps.update(schedule_phases(np.random.default_rng(args.seed + 1)))
    if "clay" in args.only:
        steps.update(clay_phases(np.random.default_rng(args.seed + 2)))
    if "pipeline" in args.only:
        steps.update(pipeline_phases(np.random.default_rng(args.seed + 3)))
    if "store" in args.only:
        steps.update(store_phases(np.random.default_rng(args.seed + 4)))
    cluster_parts = ([], [])
    if "cluster" in args.only:
        cluster_steps, cluster_parts = cluster_phases(
            np.random.default_rng(args.seed + 5))
        steps.update(cluster_steps)
    loadgen_last: dict = {}
    if "loadgen" in args.only:
        loadgen_steps, loadgen_last = loadgen_phases()
        steps.update(loadgen_steps)
    for fn in steps.values():  # warm-up: build, caches, tables
        fn()
    torch.cuda.synchronize()

    from ceph_tpu_torch import kernels

    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi)
    report = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "phases": {}}
    for name, fn in steps.items():
        for kern in kernels.ALL:
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        launches = {k.symbol: k.launches for k in kernels.ALL if k.launches}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        from ceph_tpu_torch.utils import tracer

        spans = {sp["name"] for sp in tracer.dump_historic()}
        busy_us, top_dev, ops = device_time_us(prof, spans)
        cp = cProfile.Profile()
        cp.enable()
        fn()
        torch.cuda.synchronize()
        cp.disable()
        buf = io.StringIO()
        pstats.Stats(cp, stream=buf).sort_stats("cumulative").print_stats(14)
        # self time: where the host itself computes (cumulative time
        # sums every thread's blocking waits as well)
        own = io.StringIO()
        pstats.Stats(cp, stream=own).sort_stats("tottime").print_stats(12)
        report["phases"][name] = {
            "wall_us": wall_us, "device_busy_us": busy_us,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "device_ops": ops, "kernel_launches": launches,
            "top_device_ops": top_dev, "cprofile_top": buf.getvalue(),
            "cprofile_self": own.getvalue(),
        }
        print(f"== {name}: {wall_us:.0f} us host clock, {busy_us:.0f} us "
              f"device busy, idle share {1 - busy_us / wall_us:.3f}, "
              f"{ops} device ops; kernel launches {launches}")
        for row in top_dev:
            print(f"   device {row['device_us']:9.1f} us x{row['count']:<4} "
                  f"{row['name'][:70]}")
        print("\n".join(buf.getvalue().splitlines()[:40]))
        print("\n".join(own.getvalue().splitlines()[:30]))
    for client in cluster_parts[0]:
        client.shutdown()
    for d in cluster_parts[1]:
        if not d._stopped:
            d.stop()
    if loadgen_last:
        rep = loadgen_last["report"]
        report["loadgen_report"] = {
            key: rep.get(key) for key in (
                "duration_s", "gbps", "iops", "lat_p50_ms", "lat_p99_ms",
                "lat_p99_ms_device", "device_floor_ms", "fault",
                "verify_failures", "errors", "exactly_once", "recovered",
                "op_coalesced", "subwrite_batches")}
        report["loadgen_report"]["classes"] = {
            cls: {k: e.get(k) for k in ("ops", "p50_ms", "p99_ms", "gbps")}
            for cls, e in rep.get("classes", {}).items()}
        print("loadgen report (last run): "
              + json.dumps(report["loadgen_report"]))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_slice_breakdown.json").write_text(
        json.dumps(report, indent=1)
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
