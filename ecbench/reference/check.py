"""The comparison that decides ``correct``.

Handed the inputs the benchmark generated (the image, the payload of
every write), the op log in issue order, every read's returned bytes
and the shards and HashInfo attrs read straight out of each OSD's store
after the window, it replays the ops on plain byte images, encodes the
final images itself and counts what differs:

- ``ops_failed``: ops that returned an error or never came back;
- ``read_bytes_wrong``: bytes of every read (degraded reads included)
  that differ from the replayed image at the read's issue;
- ``shard_bytes_wrong``: bytes of the data and parity shards of the
  checked objects that differ from the reference's encode, a missing
  shard counting whole;
- ``hashinfo_wrong``: shard copies whose HashInfo attr is not the
  reference's CRC32C of the shards. An object written whole once (the
  prefill, or a write_full of a new object) must carry the hashes of its
  whole shards. Once overwritten (a partial write, or a write_full of an
  object that exists) its HashInfo may be cleared, or may hash a prefix
  of whole 4 KiB blocks again (a later write that appended at the hashed
  length, as Ceph's append-only HashInfo does); whatever it holds must
  then be the CRC32C of the reference's bytes of that prefix.

Every limit is 0: the data path is exact. Runs on ``device`` (the card
in a benchmark run) in blocks of objects, after the program's state is
freed.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import ec

LIMITS = {
    "ops_failed": 0,
    "read_bytes_wrong": 0,
    "shard_bytes_wrong": 0,
    "hashinfo_wrong": 0,
}


def replay(records, payload, image, n_objects: int):
    """Walk the op log in issue order. Returns (read_bytes_wrong, a
    function giving an object's final image, HashInfo state
    {obj: "full" | "overwritten"}). ``payload(op)`` rebuilds a write's
    bytes; ``image`` is the prefilled [objects, S] array or None."""
    state: dict[int, np.ndarray] = {}
    #: objects whose image is one write_full's payload, built on demand
    whole: dict[int, object] = {}
    hinfo: dict[int, str] = {}
    if image is not None:
        hinfo = {i: "full" for i in range(n_objects)}
    wrong = 0

    def current(obj: int) -> np.ndarray | None:
        if obj in whole:
            state[obj] = payload(whole.pop(obj))
        if obj in state:
            return state[obj]
        return image[obj] if image is not None else None

    for rec in records:
        op = rec.op
        if op.kind == "write_full":
            state.pop(op.obj, None)
            whole[op.obj] = op
            # a new object's shards are hashed whole; rewriting one is
            # an overwrite
            hinfo[op.obj] = "overwritten" if op.obj in hinfo else "full"
        elif op.kind == "write":
            base = current(op.obj)
            if op.obj not in state:
                state[op.obj] = base.copy()
            state[op.obj][op.offset:op.offset + op.length] = payload(op)
            hinfo[op.obj] = "overwritten"
        else:
            if rec.data is None:
                continue  # failed: counted in ops_failed
            want = current(op.obj)[op.offset:op.offset + op.length]
            got = np.frombuffer(rec.data, dtype=np.uint8)
            n = min(len(got), len(want))
            wrong += int(np.count_nonzero(got[:n] != want[:n]))
            wrong += abs(len(got) - len(want))
    return wrong, current, hinfo


def compare_stores(objs, image_of, hinfo, stored, gen, unit: int, device,
                   block: int = 8) -> tuple[int, int]:
    """``image_of(obj)``: the reference's final image of an object;
    ``stored[obj][shard]``: the (bytes, hinfo attr) of every copy of
    that shard the stores hold. Returns (shard_bytes_wrong,
    hashinfo_wrong) over ``objs``."""
    k = gen.shape[1]
    n_shards = gen.shape[0]
    bytes_wrong = hinfo_wrong = 0
    for lo in range(0, len(objs), block):
        part = objs[lo:lo + block]
        full = torch.from_numpy(np.stack([image_of(o) for o in part])).to(device)
        data = ec.to_shards(full, k, unit)
        shards = torch.cat([data, ec.encode(gen, data)], dim=1)
        length = shards.shape[2]
        want_full = ec.hashinfo(shards)
        for row, obj in enumerate(part):
            whole = hinfo.get(obj) == "full"
            for s in range(n_shards):
                copies = stored.get(obj, {}).get(s, [])
                if not copies:
                    bytes_wrong += length
                    hinfo_wrong += 1
                    continue
                for data_b, attr in copies:
                    got = torch.frombuffer(bytearray(data_b),
                                           dtype=torch.uint8).to(device)
                    n = min(got.numel(), length)
                    bytes_wrong += int((got[:n] != shards[row, s, :n]).sum())
                    bytes_wrong += abs(got.numel() - length)
                    if not _hinfo_ok(attr, whole, want_full[row],
                                     shards[row], n_shards):
                        hinfo_wrong += 1
    return bytes_wrong, hinfo_wrong


def _hinfo_ok(attr, whole: bool, want_full: dict, shards, n_shards: int,
              block: int = 4096) -> bool:
    try:
        h = json.loads(attr.decode()) if attr else None
    except ValueError:
        return False
    if whole:
        return h == want_full
    if h == ec.cleared_hashinfo(n_shards):
        return True
    try:
        n = int(h["total_chunk_size"])
    except (TypeError, KeyError, ValueError):
        return False
    if n <= 0 or n % block or n > shards.shape[1]:
        return False
    return h == ec.prefix_hashinfo(shards, n, block)


def check(records, payload, image, n_objects: int, stored, objs, gen,
          unit: int, device) -> dict:
    """Every compared number, in ``LIMITS``' order."""
    failed = sum(1 for r in records if r.error is not None or not r.t_done)
    read_wrong, final, hinfo = replay(records, payload, image, n_objects)
    shard_wrong, hinfo_wrong = compare_stores(
        objs, final, hinfo, stored, gen, unit, device)
    return {
        "ops_failed": failed,
        "read_bytes_wrong": read_wrong,
        "shard_bytes_wrong": shard_wrong,
        "hashinfo_wrong": hinfo_wrong,
    }
