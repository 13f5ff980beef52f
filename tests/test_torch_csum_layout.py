"""A numpy model of Kernel B (``csrc/gf_apply.cu``, gf_apply_csum_kernel):
the host's step and hash split (``csum_plan``) against the kernel's
shared-memory budget; the persistent grid's walk over steps (every step
once, an item's steps in order on one block); the staged rows' padded
addresses; the (row, piece) hash tasks over the warps, ``GF_CSUM_ILP`` at
a time; and the whole kernel — ladder products from the staged tile,
lane segments hashed from shared memory, the one-level lane join and the
pieces chained into each window's CRC — against the plain fused form
and the bitwise CRC oracle. The CUDA kernel runs only on the card; this
is the CPU's view of its layout. The constants are read from the source,
so the model follows the kernel."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu_torch.checksum.cuda_crc import lane_shift_matrices  # noqa: E402
from ceph_tpu_torch.checksum.reference import crc32c_ref  # noqa: E402
from ceph_tpu_torch.gf import gf_matrix_to_bitmatrix  # noqa: E402
from ceph_tpu_torch.gf.tables import gf_mul  # noqa: E402
from ceph_tpu_torch.ops import cuda_encode as ce  # noqa: E402

SRC = (Path(__file__).resolve().parents[1] / "ceph_tpu_torch" / "csrc"
       / "gf_apply.cu").read_text()


def _const(pattern: str) -> int:
    return int(re.search(pattern, SRC).group(1))


THREADS = _const(r"#define GF_CSUM_THREADS (\d+)")
UNIT = _const(r"#define GF_CSUM_UNIT (\d+)")
COPIES = _const(r"constexpr int kCsumCopies = (\d+);")
ILP = _const(r"#define GF_CSUM_ILP (\d+)")
PAD = _const(r"#define GF_CSUM_PAD (\d+)")
WARPS = THREADS // 32
POLY = 0x82F63B78


def layout(tile: int, piece: int):
    """(seg, spad, tpad, pieces) of CsumLayout."""
    seg = piece // 32
    spad = seg + PAD if seg >= 32 else seg
    return seg, spad, tile // seg * spad, tile // piece


def off(i: int, seg: int, spad: int) -> int:
    return (i // seg) * spad + i % seg


def smem_bytes(c, r, tile, piece):
    """``gf_apply_csum_smem_bytes`` of the source."""
    _, _, tpad, pieces = layout(tile, piece)
    return 4 * 256 * COPIES * 4 + max(4096, (2 * c + r) * tpad
                                      + 4 * (c + r) * pieces)


def step_of(blk: int, grid: int, k: int, item_steps: int, steps: int) -> int:
    """csum_step: the step block ``blk`` takes k-th."""
    s = (blk + (k // item_steps) * grid) * item_steps
    return s + k % item_steps if s < steps else steps


def warp_tasks(warp: int, ntasks: int):
    """The kernel's hash loops: rounds of ILP tasks a warp apart while the
    round's last task exists, then single tasks."""
    rounds, task0 = [], warp
    while task0 + (ILP - 1) * WARPS < ntasks:
        rounds.append([task0 + n * WARPS for n in range(ILP)])
        task0 += ILP * WARPS
    while task0 < ntasks:
        rounds.append([task0])
        task0 += WARPS
    return rounds


def test_host_constants_follow_the_source():
    assert ce.CSUM_WARPS == WARPS
    assert ce.CSUM_TABLE_BYTES == 4 * 256 * COPIES * 4
    assert ce.CSUM_PAD == PAD
    assert UNIT in (8, 16) and THREADS % 32 == 0


CR = [(c, r) for c in (1, 5, 12, 32) for r in (1, 4, 12, 32)]


@pytest.mark.parametrize("cb", [256, 1024, 4096, 65536])
@pytest.mark.parametrize("windows", [1, 3, 131])
@pytest.mark.parametrize("c,r", CR)
def test_plan_fits_and_divides(c, r, cb, windows):
    n = cb * windows
    plan = ce.csum_plan(c, r, n, cb)
    tile, piece = plan.tile, plan.piece
    assert tile >= 256 and tile & (tile - 1) == 0 and n % tile == 0
    assert tile % cb == 0 or cb % tile == 0
    assert piece >= 256 and piece & (piece - 1) == 0
    assert tile % piece == 0 and cb % piece == 0
    assert plan.smem == smem_bytes(c, r, tile, piece) <= ce.SMEM_MAX
    assert tile <= ce.CSUM_TILE_MAX
    assert (tile // UNIT) % THREADS == 0 or tile // UNIT < THREADS


@pytest.mark.parametrize("grid", [1, 3, 7, 132])
@pytest.mark.parametrize("cb,tile,windows,b", [
    (4096, 4096, 256, 8), (256, 4096, 48, 3), (65536, 4096, 3, 2),
    (1024, 1024, 131, 1)])
def test_item_walk(cb, tile, windows, b, grid):
    """Every step once; the steps of one item (a window, or the windows
    of one step) on one block, consecutively and in column order, so each
    block's running CRC of a row never crosses items."""
    n = cb * windows
    steps = b * n // tile
    item_steps = max(cb, tile) // tile
    items = steps // item_steps
    grid = min(grid, items)
    seen = np.zeros(steps, np.int64)
    for blk in range(grid):
        k, prev = 0, None
        while (s := step_of(blk, grid, k, item_steps, steps)) < steps:
            seen[s] += 1
            if prev is not None and k % item_steps:
                assert s == prev + 1  # the same item, the next step
            prev, k = s, k + 1
    assert (seen == 1).all()


@pytest.mark.parametrize("tile,piece", [(4096, 2048), (4096, 256), (256, 256),
                                        (1024, 1024), (2048, 512)])
def test_staged_addresses(tile, piece):
    """The padded layout is one to one; a product unit and a 16-byte
    staging unit never straddle a pad; a lane's segment is contiguous;
    rows lie tpad apart without overlap."""
    seg, spad, tpad, _ = layout(tile, piece)
    where = np.array([off(i, seg, spad) for i in range(tile)])
    assert len(set(where.tolist())) == tile and where.max() < tpad
    for unit in (16, UNIT):
        for i in range(0, tile, unit):
            assert where[i + unit - 1] == where[i] + unit - 1
    for s in range(tile // seg):
        assert (np.diff(where[s * seg:(s + 1) * seg]) == 1).all()
    if seg >= 16:  # a quarter warp's 16-byte reads of one pass hit 8 banks
        for o in range(0, seg, 16):
            banks = {((lane * spad + o) // 16) % 8 for lane in range(8)}
            assert len(banks) == 8


@pytest.mark.parametrize("ntasks", [1, 7, 12, 24, 26, 48, 528])
def test_hash_split(ntasks):
    """Every (row, piece) task on exactly one warp; no warp more than
    ceil(tasks / warps) of them."""
    count = np.zeros(ntasks, np.int64)
    per_warp = []
    for w in range(WARPS):
        tasks = [t for rnd in warp_tasks(w, ntasks) for t in rnd]
        per_warp.append(len(tasks))
        for t in tasks:
            count[t] += 1
    assert (count == 1).all()
    assert max(per_warp) == -(-ntasks // WARPS)


def mul2w(x):
    x = x.astype(np.uint32)
    return (((x & np.uint32(0x7F7F7F7F)) << np.uint32(1))
            ^ (((x >> np.uint32(7)) & np.uint32(0x01010101)) * np.uint32(0x1D)))


def crc_lanes(segs: np.ndarray) -> list:
    """Zero-init CRC32C of each lane's segment ([32, seg] bytes)."""
    return [crc32c_ref(0, row.tobytes()) for row in segs]


def apply_cols(cols, v: int) -> int:
    out = 0
    for j in range(32):
        if v >> j & 1:
            out ^= int(cols[j])
    return out


def kernel_b_model(coef: np.ndarray, data: np.ndarray, cb: int, grid: int):
    """[R, C] coefficients, [B, C, N] bytes -> (parity, csums) the way
    gf_apply_csum_kernel computes them."""
    r_count, c_count = coef.shape
    b_count, _, n = data.shape
    rows = c_count + r_count
    plan = ce.csum_plan(c_count, r_count, n, cb)
    tile, piece = plan.tile, plan.piece
    seg, spad, tpad, pieces = layout(tile, piece)
    per_stripe = n // tile
    steps = b_count * per_stripe
    item_steps = max(cb, tile) // tile
    grid = min(grid, steps // item_steps)
    lane_mats = lane_shift_matrices(seg)
    piece_mat = ce.csum_piece_matrix(piece)
    parity = np.zeros((b_count, r_count, n), np.uint8)
    csums = np.zeros((b_count, rows, n // cb), np.uint32)
    where = np.array([off(i, seg, spad) for i in range(tile)])
    for blk in range(grid):
        carry = [0] * rows
        k = 0
        while (s := step_of(blk, grid, k, item_steps, steps)) < steps:
            k += 1
            b, col0 = divmod(s, per_stripe)
            col0 *= tile
            buf = np.zeros((c_count, tpad), np.uint8)
            for c in range(c_count):  # staging, 16-byte units
                buf[c, where] = data[b, c, col0:col0 + tile]
            par = np.zeros((r_count, tpad), np.uint8)
            # products: kCsumUnit bytes of every row a thread, the ladder
            words = np.stack([buf[c, where].view("<u4") for c in range(c_count)])
            acc = np.zeros((r_count, tile // 4), np.uint32)
            for c in range(c_count):
                x = words[c].astype(np.uint32)
                for i in range(8):
                    for j in range(r_count):
                        if int(coef[j, c]) >> i & 1:
                            acc[j] ^= x
                    x = mul2w(x)
            out = acc.view(np.uint8).reshape(r_count, tile)
            parity[b, :, col0:col0 + tile] = out
            par[:, where] = out
            # hash: tasks over the warps, lanes over their segments
            pcrc = np.zeros(rows * pieces, np.uint32)
            for w in range(WARPS):
                for rnd in warp_tasks(w, rows * pieces):
                    for task in rnd:
                        row, pc = divmod(task, pieces)
                        src = buf[row] if row < c_count else par[row - c_count]
                        segs = np.stack([
                            src[(pc * 32 + lane) * spad:
                                (pc * 32 + lane) * spad + seg]
                            for lane in range(32)])
                        lanes = crc_lanes(segs)
                        moved = 0
                        for lane in range(32):
                            moved ^= apply_cols(lane_mats[lane], lanes[lane])
                        pcrc[task] = moved
            # the finisher: thread r chains row r's pieces
            for rr in range(rows):
                for pc in range(pieces):
                    pos = col0 + pc * piece
                    v = int(pcrc[rr * pieces + pc])
                    carry[rr] = v if pos % cb == 0 else \
                        apply_cols(piece_mat, carry[rr]) ^ v
                    if (pos + piece) % cb == 0:
                        csums[b, rr, pos // cb] = carry[rr]
    return parity, csums


def test_ladder_matches_tables():
    x = np.arange(256, dtype=np.uint8).view("<u4")
    for g in (1, 2, 3, 0x1D, 0x80, 0xFF):
        acc = np.zeros_like(x)
        y = x.copy()
        for i in range(8):
            if g >> i & 1:
                acc ^= y
            y = mul2w(y)
        want = np.array([gf_mul(g, v) for v in range(256)], np.uint8)
        assert np.array_equal(acc.view(np.uint8), want)


@pytest.mark.parametrize("grid", [1, 5])
@pytest.mark.parametrize("c,r,cb,windows", [
    (3, 2, 256, 3), (2, 1, 4096, 1), (1, 2, 8192, 2), (4, 3, 1024, 5)])
def test_model_matches_plain_and_oracle(rng, c, r, cb, windows, grid):
    coef = rng.integers(0, 256, (r, c), dtype=np.uint8)
    bm = gf_matrix_to_bitmatrix(coef)
    n = cb * windows
    data = rng.integers(0, 256, (2, c, n), dtype=np.uint8)
    parity, csums = kernel_b_model(ce.bitmatrix_coefficients(bm), data, cb,
                                   grid)
    wp, wc = ce.gf_apply_csum_plain(bm, torch.from_numpy(data), cb)
    assert np.array_equal(parity, wp.numpy())
    assert np.array_equal(csums, wc.numpy().astype(np.uint32))
    full = np.concatenate([data, parity], 1)
    assert int(csums[1, c + r - 1, windows - 1]) == crc32c_ref(
        0, full[1, c + r - 1, n - cb:].tobytes())
