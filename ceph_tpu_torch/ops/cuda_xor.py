"""Kernel D wrappers: XOR-schedule apply on the card.

The counterpart of ``ceph_tpu/ops/xor_schedule.py``'s two Pallas entry
points, served by one CUDA kernel (``csrc/xor_schedule.cu``):

- ``xor_schedule_apply(sched, packets)``: [..., KW, P] packets in,
  [..., MW, P] out (the K6 form, behind host-staged packet matrices;
  packets not contiguous within a stripe are copied first);
- ``xor_schedule_apply_shards(sched, shards, w)``: n_in x [..., chunk]
  shards in, rows/w x [..., chunk] shards out, packet j being slice
  ``j % w`` of shard ``j // w`` (the K7 form; w = 1 is whole-chunk XOR).

Both take either schedule form: selection rows or a ``Schedule``. A CPU
tensor takes the plain version (``xor_schedule.xor_schedule_plain``); a
CUDA tensor launches the kernel or raises. The kernel takes any packet
length P >= 1 and any schedule: one whose scratch would not fit a
block's shared memory runs as the selection rows it computes
(``flatten_schedule``), which need no scratch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .cuda_encode import _check_device, _ptr_rows, _rows2d
from .xor_schedule import (
    Schedule,
    _linearize,
    _n_rows,
    flatten_schedule,
    xor_schedule_plain,
    xor_schedule_plain_shards,
)

#: shards per side the kernel's parameter block holds
MAX_SHARDS = 64
#: per-block shared memory the kernel may opt into (227 KB on sm_90)
SMEM_MAX = 232448
#: scratch slots that still fit at the smallest block (32 threads)
MAX_SLOTS = SMEM_MAX // (32 * 16)


def encode_program(sched) -> tuple[np.ndarray, int]:
    """(flat int32 program, n_slots) for either schedule form — the
    layout ``csrc/xor_schedule.cu`` interprets: per op ``kind`` (0 =
    scratch slot, 1 = output packet), destination, source count, then
    the sources (s >= 0: input packet s; s < 0: slot -1 - s)."""
    if isinstance(sched, Schedule):
        ops, n_slots = _linearize(sched)
        if n_slots > MAX_SLOTS:
            return encode_program(flatten_schedule(sched))
    else:
        ops = tuple(
            ("o", q, tuple((0, j) for j in row)) for q, row in enumerate(sched)
        )
        n_slots = 0
    words: list[int] = []
    for kind, dst, srcs in ops:
        words += [0 if kind == "t" else 1, dst, len(srcs)]
        words += [i if k == 0 else -1 - i for k, i in srcs]
    return np.asarray(words, dtype=np.int32), n_slots


@functools.lru_cache(maxsize=256)
def _device_program(sched, device: torch.device):
    """The program uploaded once per (schedule, device)."""
    words, n_slots = encode_program(sched)
    return torch.from_numpy(words).to(device), n_slots


def _check_schedule(sched, n_in: int) -> None:
    """Every source must name one of the ``n_in`` input packets."""
    if isinstance(sched, Schedule):
        if sched.n_in != n_in:
            raise ValueError(f"schedule takes {sched.n_in} input packets, "
                             f"got {n_in}")
        return
    top = max((max(row) for row in sched if row), default=-1)
    if top >= n_in:
        raise ValueError(f"schedule reads packet {top} of {n_in}")


def _launch(sched, ins, in_w: int, outs, out_w: int, b: int, p: int) -> None:
    from ceph_tpu_torch.kernels import XOR_SCHEDULE

    if len(ins) > MAX_SHARDS or len(outs) > MAX_SHARDS:
        raise ValueError(f"the kernel takes at most {MAX_SHARDS} shards "
                         f"a side, got {len(ins)} in, {len(outs)} out")
    prog, n_slots = _device_program(sched, ins[0].device)
    ip, ist = _ptr_rows(ins)
    op, ost = _ptr_rows(outs)
    with torch.cuda.device(ins[0].device):
        XOR_SCHEDULE(ip.ctypes.data, ist.ctypes.data, len(ins), in_w,
                     op.ctypes.data, ost.ctypes.data, len(outs), out_w,
                     prog.data_ptr(), prog.numel(), n_slots, b, p)


def xor_schedule_apply(sched, packets: torch.Tensor) -> torch.Tensor:
    """Stacked apply (the K6 form): [..., KW, P] uint8 -> [..., MW, P]."""
    if packets.dim() < 2:
        raise ValueError(f"packets {tuple(packets.shape)} are not [..., KW, P]")
    kw, p = int(packets.shape[-2]), int(packets.shape[-1])
    _check_schedule(sched, kw)
    dev = _check_device([packets])
    if dev.type == "cpu":
        return xor_schedule_plain(sched, packets)
    if packets.dtype != torch.uint8:
        raise ValueError(f"packets must be uint8, got {packets.dtype}")
    lead, mw = tuple(packets.shape[:-2]), _n_rows(sched)
    # one stripe's packets as one row (a view for the packetized
    # chunks the codecs pass; anything else is copied first)
    rows = _rows2d(packets.reshape(-1, kw * p), kw * p, "packets")
    b = rows.shape[0]
    out = torch.empty((b, mw, p), dtype=torch.uint8, device=dev)
    if b and p and mw:
        _launch(sched, [rows], kw, [out.view(b, mw * p)], mw, b, p)
    return out.reshape(lead + (mw, p))


def xor_schedule_apply_shards(sched, shards: list, w: int) -> list:
    """Per-shard apply (the K7 form): n_in x [..., chunk] uint8 ->
    rows/w x [..., chunk], neither side ever stacked."""
    rows = _n_rows(sched)
    if w < 1 or rows % w:
        raise ValueError(f"{rows} schedule rows are not whole shards of w={w}")
    n_in, n_out = len(shards), rows // w
    lead, chunk = tuple(shards[0].shape[:-1]), int(shards[0].shape[-1])
    if chunk % w:
        raise ValueError(f"chunk {chunk} is not w={w} packets")
    _check_schedule(sched, n_in * w)
    dev = _check_device(shards)
    if dev.type == "cpu":
        return xor_schedule_plain_shards(sched, shards, w)
    views = [_rows2d(s, chunk, f"shard {i}") for i, s in enumerate(shards)]
    b = views[0].shape[0]
    if any(v.shape[0] != b for v in views):
        raise ValueError("shards differ in stripe count")
    outs = [torch.empty((b, chunk), dtype=torch.uint8, device=dev)
            for _ in range(n_out)]
    if b and chunk and n_out:
        _launch(sched, views, w, outs, w, b, chunk // w)
    return [o.reshape(lead + (chunk,)) for o in outs]
