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
from typing import NamedTuple

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
#: per-block shared memory the kernel may opt into (227 KB on sm_90),
#: and an SM's (228 KB)
SMEM_MAX = 232448
SM_SMEM = 233472
#: direct form: 16-byte columns a thread owns (``XOR_VEC`` in the source)
#: and threads a block at most (``kThreads``)
VEC = 2
DIRECT_THREADS = 256
#: staged form: threads a block at most (``kStageThreads``)
STAGE_THREADS = 128
#: scratch slots that still fit at the smallest direct block (32 threads)
MAX_SLOTS = SMEM_MAX // (32 * 16 * VEC)
#: a packet code is shard << CODE_BITS | packet within the shard
CODE_BITS = 24
#: the program lengths (int32 words) and pointer tables a block copies
#: into shared memory: a short program is read from device memory
#: through L1 and spares the block that set-up and its barrier
SHORT_PROG = 64
PROG_SMEM_WORDS = 4096
TABLE_MAX = 2048


def encode_program(sched, in_w: int, out_w: int) -> tuple[np.ndarray, int]:
    """(flat int32 program, n_slots) for either schedule form and the
    packets per input and output shard — the layout
    ``csrc/xor_schedule.cu`` interprets: ``n_used`` and the codes
    (shard << 24 | packet) of the input packets the program reads, in
    first-read order; then per op ``n_in | n_slot << 16``, the
    destination (an output packet's code, or -1 - slot for a scratch
    slot), the op's input sources as indices into the used packets, then
    its slot sources."""
    if isinstance(sched, Schedule):
        ops, n_slots = _linearize(sched)
        if n_slots > MAX_SLOTS:
            return encode_program(flatten_schedule(sched), in_w, out_w)
    else:
        ops = tuple(
            ("o", q, tuple((0, j) for j in row)) for q, row in enumerate(sched)
        )
        n_slots = 0

    def code(j: int, w: int) -> int:
        sh, t = divmod(j, w)
        if sh >= MAX_SHARDS or t >= 1 << CODE_BITS:
            raise ValueError(f"packet {j} of {w}-packet shards is out of "
                             "the kernel's reach")
        return sh << CODE_BITS | t

    used: dict[int, int] = {}
    body: list[int] = []
    for kind, dst, srcs in ops:
        ins = [i for k, i in srcs if k == 0]
        slots = [i for k, i in srcs if k == 1]
        if len(ins) > 0xFFFF or len(slots) > 0x7FFF:
            raise ValueError(f"an op of {len(srcs)} sources is too long")
        body += [len(ins) | len(slots) << 16,
                 -1 - dst if kind == "t" else code(dst, out_w)]
        body += [used.setdefault(j, len(used)) for j in ins] + slots
    head = [len(used)] + [code(j, in_w) for j in used]
    return np.asarray(head + body, dtype=np.int32), n_slots


@functools.lru_cache(maxsize=256)
def _device_program(sched, in_w: int, out_w: int, device: torch.device):
    """The program uploaded once per (schedule, form, device)."""
    words, n_slots = encode_program(sched, in_w, out_w)
    return torch.from_numpy(words).to(device), n_slots, int(words[0])


class LaunchPlan(NamedTuple):
    staged: bool
    threads: int
    table: bool  # the used packets' row pointers in shared memory
    prog_in_smem: bool
    smem: int  # bytes a block


def _resident(threads: int, smem: int) -> int:
    """Threads of such blocks one SM holds at once: 2,048 threads, 32
    blocks and 228 KB of shared memory (1 KB of it reserved a block)."""
    blocks = min(2048 // threads, 32, SM_SMEM // (smem + 1024))
    return blocks * threads


def launch_plan(n_used: int, n_slots: int, prog_len: int,
                aligned: bool, stage: bool = True) -> LaunchPlan:
    """Kernel D's form for one launch (its shared memory mirrors
    ``xor_schedule_smem_bytes`` of the source): staged when the data is
    16-byte aligned and a block of at least 32 threads can stage every
    used packet beside its slots; else direct. Within a form, the block
    of up to ``STAGE_THREADS`` / ``DIRECT_THREADS`` threads that puts the
    most threads on an SM at once. The pointer table and the program go
    to shared memory when the program is longer than ``SHORT_PROG``
    words but within the size limits, and room is left."""
    small = (SHORT_PROG < prog_len <= PROG_SMEM_WORDS and n_used <= TABLE_MAX,
             SHORT_PROG < prog_len <= PROG_SMEM_WORDS)
    forms = ([(True, STAGE_THREADS, (n_used + n_slots) * 16)]
             if stage and aligned else [])
    forms.append((False, DIRECT_THREADS, n_slots * 16 * VEC))
    for staged, most, per in forms:
        for table, in_smem in (small, (False, False)):
            fixed = (((n_used * 8 + 15) & ~15) if table else 0) + \
                (((prog_len * 4 + 15) & ~15) if in_smem else 0)
            fits = [t for t in range(most, 31, -32)
                    if fixed + per * t <= SMEM_MAX]
            if fits:
                t = max(fits, key=lambda t: _resident(t, fixed + per * t))
                return LaunchPlan(staged, t, table, in_smem, fixed + per * t)
    raise ValueError(f"{n_slots} scratch slots exceed the kernel's "
                     f"{MAX_SLOTS}")


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
    prog, n_slots, n_used = _device_program(sched, in_w, out_w, ins[0].device)
    ip, ist = _ptr_rows(ins)
    op, ost = _ptr_rows(outs)
    aligned = (p % 16 == 0 and not (ip % 16).any() and not (ist % 16).any()
               and not (op % 16).any() and not (ost % 16).any())
    plan = launch_plan(n_used, n_slots, prog.numel(), aligned)
    with torch.cuda.device(ins[0].device):
        XOR_SCHEDULE(ip.ctypes.data, ist.ctypes.data, len(ins),
                     op.ctypes.data, ost.ctypes.data, len(outs),
                     prog.data_ptr(), prog.numel(), n_used, n_slots, b, p,
                     int(plan.staged), plan.threads, int(plan.table),
                     int(plan.prog_in_smem))


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
