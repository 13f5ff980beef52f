"""A numpy model of Kernel D (``csrc/xor_schedule.cu``): the host's launch
plan and the kernel's shared-memory budget, and both forms' tiling over
ragged packet lengths — the staged form (a thread's 16-byte column of
every used packet, each input byte copied once) and the
direct form (``XOR_VEC`` columns a thread, an op's sources loaded in
batches of ``kBatch``) — with the scratch-slot addresses, against the
plain version. The CUDA kernel runs only on the card; this is the CPU's
view of its addressing. The constants are read from the source, so the
model follows the kernel."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu_torch.codecs import registry  # noqa: E402
from ceph_tpu_torch.ops import cuda_xor  # noqa: E402
from ceph_tpu_torch.ops import xor_schedule as xs  # noqa: E402

SRC = (Path(__file__).resolve().parents[1] / "ceph_tpu_torch" / "csrc"
       / "xor_schedule.cu").read_text()


def _const(pattern: str) -> int:
    return int(re.search(pattern, SRC).group(1))


VEC = _const(r"#define XOR_VEC (\d+)")
BATCH = _const(r"constexpr int kBatch = (\d+);")
STAGE_THREADS = _const(r"constexpr int kStageThreads = (\d+);")
THREADS = _const(r"constexpr int kThreads = (\d+);")
SMEM_MAX = _const(r"constexpr int kSmemMax = (\d+);")
CODE_BITS = _const(r"constexpr int kCodeBits = (\d+);")
MAX_SHARDS = _const(r"constexpr int kMaxShards = (\d+);")


def smem_bytes(staged, threads, n_used, n_slots, prog_len, table,
               prog_in_smem):
    """``xor_schedule_smem_bytes`` of the source."""
    fixed = ((n_used * 8 + 15) & ~15 if table else 0) + \
        ((prog_len * 4 + 15) & ~15 if prog_in_smem else 0)
    if staged:
        return fixed + (n_used + n_slots) * threads * 16
    return fixed + n_slots * VEC * threads * 16


def liberation():
    return registry.factory("jerasure", {"technique": "liberation", "k": "6",
                                         "m": "2", "w": "7"}, device="cpu")


def slot_schedule(n_slots):
    n_in = -(-(n_slots + 5) // 4) * 4
    temps = tuple((i, i + 1) for i in range(n_slots))
    outputs = (tuple(n_in + t for t in range(n_slots)), (0,), (1,), (n_in - 1,))
    return xs.Schedule(n_in, temps, outputs)


def kernel_d_model(words, n_slots, plan, ins, n_out, out_w, p):
    """Run the program as the planned form's threads do, block by block.
    ``ins``: shards [B, in_w * p]. Returns the output shards and the
    number of device reads of every input byte."""
    b_count = ins[0].shape[0]
    mask = (1 << CODE_BITS) - 1
    n_used = int(words[0])
    codes = [int(c) for c in words[1:1 + n_used]]
    nt = plan.threads
    per_thread = 1 if plan.staged else VEC
    tile = nt * 16 * per_thread
    tiles = -(-p // tile)
    outs = [np.full((b_count, out_w * p), 0xA5, np.uint8)
            for _ in range(n_out)]
    writes = [np.zeros((b_count, out_w * p), np.int64) for _ in range(n_out)]
    reads = [np.zeros(x.shape, np.int64) for x in ins]
    fixed = plan.smem - smem_bytes(plan.staged, plan.threads, n_used,
                                   n_slots, len(words), False, False)
    assert fixed >= 0
    for blk in range(b_count * tiles):
        b, t0 = divmod(blk, tiles)
        # the thread's columns: [v, thread] -> first byte
        v = np.arange(per_thread)[:, None]
        t = np.arange(nt)[None, :]
        col = (t0 * tile + (v * nt + t) * 16).reshape(-1)
        byte = col[:, None] + np.arange(16)[None, :]
        valid = byte < p  # the staged form: whole units (p % 16 == 0)
        if plan.staged:
            assert (valid.all(1) | ~valid.any(1)).all()
        cols_at = np.where(valid, byte, 0)

        def gather(i):
            sh, k = codes[i] >> CODE_BITS, codes[i] & mask
            return np.where(valid, ins[sh][b, k * p + cols_at], 0).astype(
                np.uint8), sh, k

        rows = {}
        if plan.staged:  # every used packet copied once
            for i in range(n_used):
                rows[i], sh, k = gather(i)
                np.add.at(reads[sh][b], (k * p + cols_at)[valid], 1)
        slots = {}
        slot_top = -1  # the highest slot uint4 index the block touches
        pc = 1 + n_used
        while pc < len(words):
            w0, dst = int(words[pc]), int(words[pc + 1])
            n_in, n_slot = w0 & 0xFFFF, w0 >> 16
            pc += 2
            srcs = [int(x) for x in words[pc:pc + n_in]]
            acc = np.zeros(valid.shape, np.uint8)
            if plan.staged:
                for i in srcs:
                    acc ^= rows[i]
            else:  # batches of BATCH sources, then the rest one by one
                full = len(srcs) - len(srcs) % BATCH
                batches = [srcs[s:s + BATCH] for s in range(0, full, BATCH)]
                batches += [[i] for i in srcs[full:]]
                assert sum(map(len, batches)) == n_in
                for batch in batches:
                    for i in batch:
                        x, sh, k = gather(i)
                        np.add.at(reads[sh][b], (k * p + cols_at)[valid], 1)
                        acc ^= x
            pc += n_in
            for s in (int(x) for x in words[pc:pc + n_slot]):
                acc ^= slots[s]
            pc += n_slot
            if dst < 0:
                s = -1 - dst
                assert 0 <= s < n_slots
                # the slot's uint4 index of the block's last thread
                top = ((n_used + s) * nt if plan.staged
                       else (s * VEC + VEC - 1) * nt) + nt - 1
                slot_top = max(slot_top, top)
                slots[s] = acc
            else:
                sh, k = dst >> CODE_BITS, dst & mask
                tgt = (k * p + cols_at)[valid]
                outs[sh][b, tgt] = acc[valid]
                np.add.at(writes[sh][b], tgt, 1)
        assert fixed + (slot_top + 1) * 16 <= plan.smem
    for w in writes:
        assert (w == 1).all()  # every output byte written once
    return outs, reads


def test_host_constants_follow_the_source():
    assert (cuda_xor.VEC, cuda_xor.DIRECT_THREADS, cuda_xor.STAGE_THREADS,
            cuda_xor.SMEM_MAX, cuda_xor.CODE_BITS, cuda_xor.MAX_SHARDS) == \
        (VEC, THREADS, STAGE_THREADS, SMEM_MAX, CODE_BITS, MAX_SHARDS)
    assert cuda_xor.MAX_SLOTS == SMEM_MAX // (32 * 16 * VEC)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n_used,n_slots,prog_len", [
    (42, 4, 170), (42, 16, 301), (3, 0, 10), (5, 0, 12), (229, 227, 2000),
    (236, 0, 700), (2048, 0, 20000), (3000, 10, 50000)])
def test_launch_plan_fits(n_used, n_slots, prog_len, aligned):
    plan = cuda_xor.launch_plan(n_used, n_slots, prog_len, aligned)
    assert plan.smem == smem_bytes(plan.staged, plan.threads, n_used,
                                   n_slots, prog_len, plan.table,
                                   plan.prog_in_smem) <= SMEM_MAX
    assert plan.threads % 32 == 0 and plan.threads >= 32
    assert plan.threads <= (STAGE_THREADS if plan.staged else THREADS)
    assert aligned or not plan.staged
    assert not plan.table or n_used <= cuda_xor.TABLE_MAX
    short = prog_len <= cuda_xor.SHORT_PROG
    assert not short or not (plan.table or plan.prog_in_smem)


def test_launch_plan_main_shapes():
    """The liberation encode stages, with its program and pointers in
    shared memory; the LRC repair (a nine-word program) stages with both
    left in device memory; unaligned data and a schedule at MAX_SLOTS run
    direct, the latter at 32 threads with program and pointers left in
    device memory."""
    lib = liberation()
    words, slots = cuda_xor.encode_program(
        xs.routable_schedule(lib.coding_bitmatrix), 42, 14)
    plan = cuda_xor.launch_plan(int(words[0]), slots, len(words), True)
    assert plan.staged and plan.table and plan.prog_in_smem
    assert not cuda_xor.launch_plan(int(words[0]), slots, len(words),
                                    False).staged
    words, slots = cuda_xor.encode_program(
        xs.optimize_schedule(np.ones((1, 3), np.uint8)), 1, 1)
    plan = cuda_xor.launch_plan(int(words[0]), slots, len(words), True)
    assert len(words) == 9
    assert plan.staged and not (plan.table or plan.prog_in_smem)
    words, slots = cuda_xor.encode_program(
        slot_schedule(cuda_xor.MAX_SLOTS), 4, 4)
    assert slots == cuda_xor.MAX_SLOTS
    plan = cuda_xor.launch_plan(int(words[0]), slots, len(words), True)
    assert (plan.staged, plan.threads, plan.table, plan.prog_in_smem) == \
        (False, 32, False, False)
    _, slots = cuda_xor.encode_program(
        slot_schedule(cuda_xor.MAX_SLOTS + 1), 4, 4)
    assert slots == 0


def _cases():
    lib = liberation()
    enc = lib.coding_bitmatrix
    dec = lib._build_decode_bitmatrix([0, 2, 3, 5, 6, 7], [1, 4])
    return {
        "liberation encode": (xs.routable_schedule(enc), 7, 42),
        "liberation decode": (xs.routable_schedule(dec), 7, 42),
        "selection rows": (xs.schedule_rows(enc), 7, 42),
        "w=1 row": (xs.optimize_schedule(np.ones((1, 5), np.uint8)), 1, 5),
    }


CASES = _cases()


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("p", [1, 15, 16, 17, 2048, 2048 + 48])
@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_plain(rng, case, p, aligned, stacked):
    """Both forms over ragged packet lengths: every output byte written
    once, the plain version's bytes; the staged form reads every input
    byte of a used packet exactly once."""
    sched, w, cols = CASES[case]
    rows = xs._n_rows(sched)
    b = 2
    packets = rng.integers(0, 256, (b, cols, p), dtype=np.uint8)
    want = xs.xor_schedule_plain(sched, torch.from_numpy(packets)).numpy()
    if stacked:
        ins, in_w, n_out, out_w = [packets.reshape(b, -1)], cols, 1, rows
    else:
        ins = [packets[:, i * w:(i + 1) * w].reshape(b, -1)
               for i in range(cols // w)]
        in_w, n_out, out_w = w, rows // w, w
    words, n_slots = cuda_xor.encode_program(sched, in_w, out_w)
    plan = cuda_xor.launch_plan(int(words[0]), n_slots, len(words),
                                aligned and p % 16 == 0)
    outs, reads = kernel_d_model(words, n_slots, plan, ins, n_out, out_w, p)
    got = np.concatenate(outs, 1).reshape(b, rows, p)
    assert np.array_equal(got, want)
    if plan.staged:
        used = {int(c) for c in words[1:1 + int(words[0])]}
        for sh, r in enumerate(reads):
            for k in range(in_w):
                code = sh << CODE_BITS | k
                assert (r[:, k * p:(k + 1) * p] == (code in used)).all()
