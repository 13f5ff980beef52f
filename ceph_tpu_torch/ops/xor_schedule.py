"""XOR schedules for 0/1 matrices: how the programs are built, and their
plain PyTorch version.

The reference runs liberation / blaum_roth / liber8tion as XOR
*schedules*: ``jerasure_smart_bitmatrix_to_schedule`` walks the 0/1
coding matrix and emits one XOR per set bit, so the cost tracks the
matrix's density, not its dimension (jerasure/ErasureCodeJerasure.h:
255-324, ``jerasure_schedule_encode``). This is the host half of
``ceph_tpu/ops/xor_schedule.py``, without JAX:

- ``schedule_rows``: the single-level selection form (row q = XOR of
  the packets its matrix row selects), the pinned escape hatch
  (``ec_sched_opt=false``);
- ``optimize_schedule``: greedy pairwise common-subexpression
  elimination over the 0/1 matrix (Paar's algorithm, as in
  "Accelerating XOR-based Erasure Coding using Program Optimization
  Techniques", arxiv 2108.02692), giving a multi-level ``Schedule``;
- ``_linearize``: the execution order of a ``Schedule``, with
  intermediates in scratch slots recycled at last use;
- the gates (``profitable``, ``profitable_opt``, ``routable_schedule``)
  and the op-count scorecard (``schedule_xors``, ``cse_stats``).

``xor_schedule_plain`` (and its shards form) is the plain version that
the CUDA kernel (``ops.cuda_xor``, ``csrc/xor_schedule.cu``) is held
against: ``_xla_apply`` of ``ceph_tpu`` with ``torch.bitwise_xor``
chains. XOR is exact on uint8, so every schedule of one matrix gives
the same bytes.

What is not here: ``ceph_tpu``'s TPU tiling and VMEM gates
(``LANE_TILE``, ``BEST_TILE``, ``_pick_tile``, ``supported``,
``shards_supported``, ``VMEM_BUDGET``, ``SUBLANE``, ``on_tpu``). They
describe the TPU's vector memory; the CUDA kernel takes any packet
length and any schedule, so no shape is rejected.
"""

from __future__ import annotations

import functools
import heapq
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

#: gate for the UN-optimized (selection-form) schedule: (ones + rows)
#: per data column — ``ceph_tpu``'s traffic-ratio model, kept so that
#: both packages choose the same schedule for the same matrix
MAX_TRAFFIC_RATIO = 5.0

#: gate for OPTIMIZED schedules: (post-CSE XORs + output writes) per
#: data column, the same constant measured after CSE
MAX_OP_RATIO = 5.0


class Schedule(NamedTuple):
    """A multi-level XOR program over packet node ids.

    Nodes 0..n_in-1 are the input packets; node n_in + t is
    intermediate ``temps[t]``, the XOR of two earlier nodes (inputs or
    intermediates). Output row q is the XOR of ``outputs[q]``'s nodes;
    an empty tuple means a zero packet. The fields are ``ceph_tpu``'s,
    so ``Schedule(*ref_schedule)`` carries one across. Hashable: it
    keys the program caches the way the selection rows do.
    """

    n_in: int
    temps: tuple[tuple[int, int], ...]
    outputs: tuple[tuple[int, ...], ...]


def schedule_rows(mat01: np.ndarray) -> tuple[tuple[int, ...], ...]:
    """Single-level XOR schedule: row q -> indices of the packets to
    XOR (the ``jerasure_smart_bitmatrix_to_schedule`` analog, pure
    selection with no factoring)."""
    m = np.asarray(mat01)
    return tuple(
        tuple(int(j) for j in np.flatnonzero(m[q])) for q in range(m.shape[0])
    )


def optimize_schedule(mat01: np.ndarray) -> Schedule:
    """Greedy pairwise CSE over a 0/1 matrix (Paar's algorithm).

    Repeatedly factor the operand pair co-occurring in the most rows
    into a fresh intermediate, substituting it everywhere, including
    into pairs with other intermediates, so the result is multi-level.
    Deterministic: ties break to the lexicographically smallest pair.
    Pair counts update incrementally with a lazy max-heap."""
    m = np.asarray(mat01, dtype=np.uint8)
    n_out, n_in = m.shape
    rows = [set(int(j) for j in np.flatnonzero(m[q])) for q in range(n_out)]
    cnt: Counter = Counter()
    for r in rows:
        s = sorted(r)
        for i in range(len(s)):
            for j in range(i + 1, len(s)):
                cnt[(s[i], s[j])] += 1
    heap = [(-c, p) for p, c in cnt.items()]
    heapq.heapify(heap)
    temps: list[tuple[int, int]] = []
    next_id = n_in

    def bump(pair: tuple[int, int], d: int) -> None:
        c = cnt[pair] + d
        if c <= 0:
            cnt.pop(pair, None)
        else:
            cnt[pair] = c
            heapq.heappush(heap, (-c, pair))

    while heap:
        negc, pair = heapq.heappop(heap)
        if cnt.get(pair, 0) != -negc:
            continue  # stale heap entry (lazy deletion)
        if -negc < 2:
            break
        a, b = pair
        tid = next_id
        next_id += 1
        temps.append((a, b))
        hits = 0
        for r in rows:
            if a in r and b in r:
                hits += 1
                r.discard(a)
                r.discard(b)
                for x in r:
                    bump((x, a) if x < a else (a, x), -1)
                    bump((x, b) if x < b else (b, x), -1)
                    bump((x, tid), +1)  # tid > every existing node
                r.add(tid)
        bump(pair, -hits)
    return Schedule(
        n_in,
        tuple(temps),
        tuple(tuple(sorted(r)) for r in rows),
    )


def schedule_xors(sel) -> int:
    """XOR ops a schedule executes (either form): intermediate XORs
    plus per-row chain XORs."""
    if isinstance(sel, Schedule):
        return len(sel.temps) + sum(
            max(len(o) - 1, 0) for o in sel.outputs
        )
    return sum(max(len(s) - 1, 0) for s in sel)


def cse_stats(mat01: np.ndarray) -> dict:
    """Optimizer scorecard for one matrix: raw ones / selection-form
    XORs / post-CSE XORs / intermediate count / scratch-slot peak."""
    m = np.asarray(mat01, dtype=np.uint8)
    rows = schedule_rows(m)
    sched = optimize_schedule(m)
    raw = schedule_xors(rows)
    opt = schedule_xors(sched)
    return {
        "ones": int(m.sum()),
        "raw_xors": raw,
        "opt_xors": opt,
        "temps": len(sched.temps),
        "saving_frac": round(1.0 - opt / max(raw, 1), 3),
        "scratch_slots": _linearize(sched)[1],
    }


def profitable(
    sel_rows: tuple[tuple[int, ...], ...], cols: int
) -> bool:
    """Selection-form gate: (ones + rows) <= MAX_TRAFFIC_RATIO * cols."""
    if not sel_rows or cols <= 0:
        return False
    ones = sum(len(s) for s in sel_rows)
    return (ones + len(sel_rows)) <= MAX_TRAFFIC_RATIO * cols


def profitable_opt(sched: Schedule, cols: int) -> bool:
    """Optimized gate: (post-CSE XORs + output writes) <=
    MAX_OP_RATIO * cols."""
    if not sched.outputs or cols <= 0:
        return False
    return (schedule_xors(sched) + len(sched.outputs)) <= (
        MAX_OP_RATIO * cols
    )


@functools.lru_cache(maxsize=1024)
def _routable_cached(mat_bytes: bytes, shape: tuple, opt: bool):
    m = np.frombuffer(mat_bytes, dtype=np.uint8).reshape(shape)
    if opt:
        sched = optimize_schedule(m)
        return sched if profitable_opt(sched, shape[1]) else None
    rows = schedule_rows(m)
    return rows if profitable(rows, shape[1]) else None


def routable_schedule(mat01: np.ndarray, opt: bool = True):
    """The schedule the route should execute for a 0/1 matrix, or
    None when it stays over its gate. ``opt=False`` is the
    ``ec_sched_opt`` escape hatch: the selection form under the
    traffic-ratio gate. Cached process-wide by the matrix bytes."""
    m = np.ascontiguousarray(np.asarray(mat01, dtype=np.uint8))
    return _routable_cached(m.tobytes(), m.shape, bool(opt))


def _n_rows(sel) -> int:
    """Output-row count of either schedule form."""
    return len(sel.outputs) if isinstance(sel, Schedule) else len(sel)


# ------------------------------------------------------ linearization
@functools.lru_cache(maxsize=512)
def _linearize(sched: Schedule):
    """Compile a Schedule into ``(ops, n_slots)``, the execution order
    the kernel runs.

    - Output rows chain greedily by operand affinity (the next row
      shares the most operands with the previous one).
    - Intermediates materialize just before their first use and their
      scratch slot is recycled at last use: ``n_slots`` is the DAG's
      peak liveness, not its size.
    - Within a row, intermediate operands lead (most recent first) and
      input packets follow in index order.

    ``ops`` entries: ``("t", slot, (src, src))`` materializes an
    intermediate, ``("o", q, (src, ...))`` emits output row q; each
    ``src`` is ``(0, input_index)`` or ``(1, slot)``.
    """
    n_in, temps, outputs = sched.n_in, sched.temps, sched.outputs
    remaining = list(range(len(outputs)))
    order: list[int] = []
    prev: set[int] = set()
    while remaining:
        q = max(
            remaining,
            key=lambda r: (len(prev & set(outputs[r])), -r),
        )
        order.append(q)
        remaining.remove(q)
        prev = set(outputs[q])

    seq: list[tuple[str, int]] = []
    emitted: set[int] = set()

    def emit(t: int) -> None:
        if t in emitted:
            return
        emitted.add(t)
        for d in temps[t]:
            if d >= n_in:
                emit(d - n_in)
        seq.append(("t", t))

    for q in order:
        for x in outputs[q]:
            if x >= n_in:
                emit(x - n_in)
        seq.append(("o", q))

    last_use: dict[int, int] = {}
    for i, (kind, x) in enumerate(seq):
        for r in temps[x] if kind == "t" else outputs[x]:
            if r >= n_in:
                last_use[r - n_in] = i

    slot_of: dict[int, int] = {}
    free: list[int] = []
    n_slots = 0
    ops: list[tuple] = []

    def src(v: int) -> tuple[int, int]:
        return (0, v) if v < n_in else (1, slot_of[v - n_in])

    for i, (kind, x) in enumerate(seq):
        if kind == "t":
            a, b = temps[x]
            srcs = (src(a), src(b))
            # destination allocated BEFORE operand slots release, so
            # a temp never aliases its own operands' storage
            s = free.pop() if free else n_slots
            n_slots = max(n_slots, s + 1)
            slot_of[x] = s
            ops.append(("t", s, srcs))
        else:
            ids = outputs[x]
            ts = sorted((v for v in ids if v >= n_in), reverse=True)
            ins_ = sorted(v for v in ids if v < n_in)
            ops.append(("o", x, tuple(src(v) for v in ts + ins_)))
        for r in temps[x] if kind == "t" else outputs[x]:
            if r >= n_in and last_use.get(r - n_in) == i:
                free.append(slot_of[r - n_in])
    return tuple(ops), n_slots


def flatten_schedule(sched: Schedule) -> tuple[tuple[int, ...], ...]:
    """The selection rows a Schedule computes: each node's set of input
    packets (XOR of node sets is their symmetric difference)."""
    nodes = [frozenset((i,)) for i in range(sched.n_in)]
    for a, b in sched.temps:
        nodes.append(nodes[a] ^ nodes[b])
    rows = []
    for out in sched.outputs:
        acc: frozenset = frozenset()
        for v in out:
            acc = acc ^ nodes[v]
        rows.append(tuple(sorted(acc)))
    return tuple(rows)


# --------------------------------------------------------- plain forms
def xor_schedule_plain(sel_rows, packets: torch.Tensor) -> torch.Tensor:
    """Apply a schedule (either form) to [..., KW, P] uint8 packets ->
    [..., MW, P], on the tensor's device: unrolled XOR chains, with
    intermediates as ordinary tensors and zero packets for empty
    rows. The port of ``ceph_tpu``'s ``_xla_apply``."""
    if isinstance(sel_rows, Schedule):
        n_in = sel_rows.n_in
        vals: dict[int, torch.Tensor] = {}

        def fetch(i):
            return packets[..., i, :] if i < n_in else vals[i]

        for t, (a, b) in enumerate(sel_rows.temps):
            vals[n_in + t] = torch.bitwise_xor(fetch(a), fetch(b))
        rows = sel_rows.outputs
    else:
        rows = sel_rows

        def fetch(j):
            return packets[..., j, :]

    outs = []
    zero = None
    for sel in rows:
        if sel:
            acc = fetch(sel[0])
            for j in sel[1:]:
                acc = torch.bitwise_xor(acc, fetch(j))
        else:
            if zero is None:
                zero = torch.zeros_like(packets[..., 0, :])
            acc = zero
        outs.append(acc)
    return torch.stack(outs, dim=-2)


def xor_schedule_plain_shards(sel_rows, shards: list, w: int) -> list:
    """Shards form of the plain version: n_in x [..., chunk] in,
    rows/w x [..., chunk] out; packet j is slice ``j % w`` of shard
    ``j // w``. Stacks and packetizes, as ``ceph_tpu`` does off the
    TPU."""
    n_in = len(shards)
    lead = tuple(shards[0].shape[:-1])
    chunk = int(shards[0].shape[-1])
    n_out = _n_rows(sel_rows) // w
    pk = torch.stack(list(shards), dim=-2).reshape(
        lead + (n_in * w, chunk // w)
    )
    out = xor_schedule_plain(sel_rows, pk).reshape(lead + (n_out, chunk))
    return [out[..., j, :] for j in range(n_out)]
