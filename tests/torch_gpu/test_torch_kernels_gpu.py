"""The CUDA kernels of ceph_tpu_torch against their plain PyTorch
versions, on the card, byte for byte (integer math: no tolerance).

Marked ``gpu``: without a card every test skips. On a machine with one,
run ``python -m pytest --noconftest -m gpu tests/torch_gpu/`` (the
``--noconftest`` because the suite's conftest imports JAX, which the
port's machines need not have). Imports nothing of JAX or ceph_tpu.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu_torch.checksum.crc32c import crc32c_fold_plain  # noqa: E402
from ceph_tpu_torch.checksum.cuda_crc import crc32c_blocks  # noqa: E402
from ceph_tpu_torch.gf import (  # noqa: E402
    decode_matrix,
    gf_matrix_to_bitmatrix,
    isa_cauchy_matrix,
    isa_rs_matrix,
)
from ceph_tpu_torch.ops import cuda_encode as ce  # noqa: E402
from ceph_tpu_torch.ops.bitplane import gf_encode_bitplane  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _data(shape, seed=7):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))


@pytest.mark.parametrize("c,r", [(5, 3), (8, 4), (10, 4), (8, 1)])
@pytest.mark.parametrize("n", [1, 37, 4096, 65536 + 37])
def test_gf_apply_matches_plain(cuda, c, r, n):
    gen = isa_cauchy_matrix(c, r)
    bm = gf_matrix_to_bitmatrix(gen[c:])
    data = _data((3, c, n)).to(cuda)
    want = gf_encode_bitplane(bm, data)
    assert torch.equal(ce.gf_apply(bm, data), want)
    shards = [data[:, i].contiguous() for i in range(c)]
    for j, got in enumerate(ce.gf_apply_shards(bm, shards)):
        assert torch.equal(got, want[:, j])
    torch.cuda.synchronize()


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("c,r", [(1, 1), (1, 32), (12, 1), (12, 32), (32, 1),
                                 (32, 32)])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 4095, (1 << 20) + 37])
def test_gf_apply_edges(cuda, n, c, r, offset):
    """Kernel A at the edges of its contract: lengths around its 16-byte
    vectors and its column run, C and R up to 32, and rows one byte off
    alignment (offset 1: the byte-load path), both forms."""
    rng = np.random.default_rng(n + 100 * c + r)
    bm = gf_matrix_to_bitmatrix(rng.integers(0, 256, (r, c), dtype=np.uint8))
    base = _data((2, c, n + offset), seed=c + r).to(cuda)
    data = base[..., offset:]
    want = gf_encode_bitplane(bm, data.contiguous())
    assert torch.equal(ce.gf_apply(bm, data), want)
    got = ce.gf_apply_shards(bm, [data[:, i] for i in range(c)])
    assert all(torch.equal(g, want[:, j]) for j, g in enumerate(got))
    torch.cuda.synchronize()


def test_gf_apply_decode_matrix(cuda):
    gen = isa_rs_matrix(8, 4)
    present = [1, 2, 4, 5, 6, 7, 8, 10]
    bm = gf_matrix_to_bitmatrix(decode_matrix(gen, 8, present)[[0, 3]])
    data = _data((2, 8, 8192)).to(cuda)
    assert torch.equal(ce.gf_apply(bm, data), gf_encode_bitplane(bm, data))


@pytest.mark.parametrize("cb", [256, 1024, 4096, 65536])
@pytest.mark.parametrize("c,r", [(8, 4), (5, 3), (10, 4)])
def test_gf_apply_csum_matches_plain(cuda, c, r, cb):
    bm = gf_matrix_to_bitmatrix(isa_cauchy_matrix(c, r)[c:])
    data = _data((2, c, 2 * 65536)).to(cuda)
    want_p, want_c = ce.gf_apply_csum_plain(bm, data, cb)
    got_p, got_c = ce.gf_apply_csum(bm, data, cb)
    assert torch.equal(got_p, want_p) and torch.equal(got_c, want_c)
    shards = [data[:, i].contiguous() for i in range(c)]
    sp, sc = ce.gf_apply_csum_shards(bm, shards, cb)
    assert all(torch.equal(sp[j], want_p[:, j]) for j in range(r))
    assert torch.equal(sc, want_c)


_CR = [(c, r) for c in (1, 12, 32) for r in (1, 12, 32)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("windows", [1, 3, 131])
@pytest.mark.parametrize("cb", [256, 4096, 65536])
@pytest.mark.parametrize("c,r", _CR)
def test_gf_apply_csum_edges(cuda, c, r, cb, windows, offset):
    """Kernel B at the edges of its contract: C and R up to 32, windows
    of 256 B to 64 KiB, one, three or 131 windows a row (a step over
    several windows, a window over several steps, items that do not
    divide evenly over the persistent grid), and rows one byte off
    alignment (offset 1: the load path), both forms."""
    rng = np.random.default_rng(c + 100 * r + cb + windows)
    bm = gf_matrix_to_bitmatrix(rng.integers(0, 256, (r, c), dtype=np.uint8))
    n = cb * windows
    b = 1 if n > (1 << 20) else 2
    data = _data((b, c, n + offset), seed=c + r).to(cuda)[..., offset:]
    want_p, want_c = ce.gf_apply_csum_plain(bm, data.contiguous(), cb)
    got_p, got_c = ce.gf_apply_csum(bm, data, cb)
    assert torch.equal(got_p, want_p) and torch.equal(got_c, want_c)
    sp, sc = ce.gf_apply_csum_shards(bm, [data[:, i] for i in range(c)], cb)
    assert all(torch.equal(sp[j], want_p[:, j]) for j in range(r))
    assert torch.equal(sc, want_c)
    torch.cuda.synchronize()


@pytest.mark.parametrize("block", [1, 31, 512, 4096, 65536, 1000])
@pytest.mark.parametrize("init", [0, 0xFFFFFFFF, 0x1234ABCD])
def test_crc32c_blocks_matches_plain(cuda, block, init):
    data = _data((33, block)).to(cuda)
    assert torch.equal(
        crc32c_blocks(data, init), crc32c_fold_plain(data, init)
    )


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("nblocks", [1, 131])
@pytest.mark.parametrize("block", [1, 31, 32, 33, 512, 1000, 4096, 65536,
                                   1 << 20])
def test_crc32c_edges(cuda, block, nblocks, offset):
    """Kernel C at the edges of its contract: lengths around its lane
    segments and staged passes, one block or a count that is no multiple
    of a block's warps, and a base pointer one byte off (offset 1: the
    direct byte path)."""
    buf = _data((nblocks * block + offset,), seed=block).to(cuda)
    data = buf[offset:].view(nblocks, block)
    for init in (0, 0xFFFFFFFF, 0x1234ABCD):
        assert torch.equal(crc32c_blocks(data, init),
                           crc32c_fold_plain(data, init))


def test_crc32c_more_blocks_than_resident_warps(cuda):
    """The persistent grid: far more CRC blocks than warps on the card,
    and a count no multiple of the block's warps."""
    data = _data((132 * 16 * 4 + 5, 4096), seed=3).to(cuda)
    assert torch.equal(crc32c_blocks(data, 0xFFFFFFFF),
                       crc32c_fold_plain(data, 0xFFFFFFFF))


def test_codec_routes_on_the_card(cuda):
    """CUDA tensors ride the kernels (kernel_*); ec_use_kernels off runs
    the plain forms on the card (plain_*); both give the same bytes."""
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters
    from ceph_tpu_torch.utils import config

    codec = registry.factory("isa", {"k": "8", "m": "4"}, device="cuda")
    data = {i: _data((2, 8192), seed=i).to(cuda) for i in range(8)}
    counters = dispatch_counters()
    results = {}
    for use in (True, False):
        counters.reset()
        with config.override(ec_use_kernels=use):
            par, csums = codec.encode_chunks_with_csums(data, 4096)
            dec = codec.decode_chunks(
                {0, 9}, {i: v for i, v in {**data, **par}.items()
                         if i not in (0, 9)})
        route = "kernel" if use else "plain"
        got = counters.dump()
        assert got[f"{route}_encode"] == 1 and got[f"{route}_decode"] == 1
        results[use] = (par, csums, dec)
    (pk, ck, dk), (pp, cp, dp) = results[True], results[False]
    assert all(torch.equal(pk[j], pp[j]) for j in pk)
    assert np.array_equal(ck, cp)
    assert torch.equal(dk[0], data[0]) and torch.equal(dp[9], pk[9])


# ------------------------------------------------------------- Kernel D
def _liberation(k=6, w=7):
    from ceph_tpu_torch.codecs import registry

    return registry.factory(
        "jerasure",
        {"technique": "liberation", "k": str(k), "m": "2", "w": str(w)},
        device="cuda",
    )


def _xor_cases():
    """(label, 0/1 matrix, w) for Kernel D: liberation encode, its
    inverted decode for lost {1, 4}, a one-column delta, a dense random
    matrix (many scratch slots), an empty row and the w=1 rows."""
    from ceph_tpu_torch.codecs.bitmatrix_codec import liberation_bitmatrix

    enc = np.frombuffer(liberation_bitmatrix(6, 7), np.uint8).reshape(14, 42)
    codec = _liberation()
    present = [0, 2, 3, 5, 6, 7]
    dec = codec._build_decode_bitmatrix(present, [1, 4])
    rng = np.random.default_rng(5)
    dense = (rng.random((56, 56)) < 0.5).astype(np.uint8)
    empty = enc.copy()
    empty[3] = 0
    return [
        ("liberation encode", enc, 7),
        ("liberation decode {1,4}", dec, 7),
        ("liberation delta col 3", np.ascontiguousarray(enc[:, 21:28]), 7),
        ("dense 56x56", dense, 8),
        ("empty row", empty, 7),
        ("all-ones w=1", np.ones((1, 5), np.uint8), 1),
    ]


@pytest.mark.parametrize("p", [2048, 1003, 147456])
@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("opt", [True, False])
def test_xor_schedule_matches_plain(cuda, p, case, opt):
    from ceph_tpu_torch.ops import cuda_xor
    from ceph_tpu_torch.ops import xor_schedule as xs

    label, mat, w = _xor_cases()[case]
    sched = xs.optimize_schedule(mat) if opt else xs.schedule_rows(mat)
    rows, cols = mat.shape
    packets = _data((3, cols, p), seed=case).to(cuda)
    want = xs.xor_schedule_plain(sched, packets)
    assert torch.equal(cuda_xor.xor_schedule_apply(sched, packets), want)
    shards = [packets[:, i * w:(i + 1) * w].reshape(3, w * p).contiguous()
              for i in range(cols // w)]
    got = cuda_xor.xor_schedule_apply_shards(sched, shards, w)
    assert len(got) == rows // w
    for j, o in enumerate(got):
        assert torch.equal(o, want[:, j * w:(j + 1) * w].reshape(3, w * p))
    torch.cuda.synchronize()


def _slot_schedule(n_slots):
    """A Schedule needing exactly ``n_slots`` scratch slots (intermediates
    t_i = packet i ^ packet i+1, all read by output 0), with a multiple of
    4 inputs and 4 outputs."""
    from ceph_tpu_torch.ops import xor_schedule as xs

    n_in = -(-(n_slots + 5) // 4) * 4
    temps = tuple((i, i + 1) for i in range(n_slots))
    outputs = (tuple(n_in + t for t in range(n_slots)), (0,), (1,), (n_in - 1,))
    return xs.Schedule(n_in, temps, outputs)


def _xor_both_forms(cuda, sched, w, cols, p, b, offset, seed):
    """Stacked and per-shard applies of ``sched`` on packets (and shards)
    starting ``offset`` bytes past an allocation, against the plain form."""
    from ceph_tpu_torch.ops import cuda_xor
    from ceph_tpu_torch.ops import xor_schedule as xs

    rows = xs._n_rows(sched)
    packets = _data((b * cols * p + offset,), seed=seed).to(cuda)[offset:].view(
        b, cols, p)
    want = xs.xor_schedule_plain(sched, packets)
    assert torch.equal(cuda_xor.xor_schedule_apply(sched, packets), want)
    size = b * w * p
    sbase = torch.empty(cols // w * size + offset, dtype=torch.uint8,
                        device=cuda)
    shards = [sbase[offset + i * size:offset + (i + 1) * size].view(b, w * p)
              for i in range(cols // w)]
    for i, sh in enumerate(shards):
        sh.copy_(packets[:, i * w:(i + 1) * w].reshape(b, w * p))
    got = cuda_xor.xor_schedule_apply_shards(sched, shards, w)
    for j, o in enumerate(got):
        assert torch.equal(o, want[:, j * w:(j + 1) * w].reshape(b, w * p))
    torch.cuda.synchronize()


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("p", [1, 15, 16, 17, 2048, 147456])
def test_xor_schedule_edges(cuda, p, offset):
    """Kernel D at the edges of its contract: packet lengths around its
    16-byte columns and tiles, base pointers one byte off (offset 1: the
    direct form), the liberation encode and a w = 1 row, both forms."""
    from ceph_tpu_torch.ops import xor_schedule as xs

    enc = _xor_cases()[0][1]
    _xor_both_forms(cuda, xs.optimize_schedule(enc), 7, 42, p, 3, offset, p)
    _xor_both_forms(cuda, xs.optimize_schedule(np.ones((1, 5), np.uint8)), 1,
                    5, p, 3, offset, p + 1)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("extra", [0, 1])
def test_xor_schedule_at_max_slots(cuda, extra, offset):
    """A schedule at the kernel's MAX_SLOTS scratch slots (the direct form
    at the shared-memory limit) and one past it (run as the selection
    rows it computes)."""
    from ceph_tpu_torch.ops import cuda_xor

    sched = _slot_schedule(cuda_xor.MAX_SLOTS + extra)
    _, slots = cuda_xor.encode_program(sched, 4, 4)
    assert slots == (0 if extra else cuda_xor.MAX_SLOTS)
    _xor_both_forms(cuda, sched, 4, sched.n_in, 2048, 2, offset, extra)


def test_xor_schedule_unaligned_views(cuda):
    """Shards at odd byte offsets take the byte-load path."""
    from ceph_tpu_torch.ops import cuda_xor
    from ceph_tpu_torch.ops import xor_schedule as xs

    mat = np.ones((1, 3), np.uint8)
    base = _data((4, 3 * 1001 + 1)).to(cuda)
    shards = [base[:, 1 + i * 1001:1 + (i + 1) * 1001] for i in range(3)]
    (got,) = cuda_xor.xor_schedule_apply_shards(
        xs.optimize_schedule(mat), shards, 1)
    assert torch.equal(got, shards[0] ^ shards[1] ^ shards[2])


def test_liberation_encode_on_card_moves_sched_counters(cuda):
    from ceph_tpu_torch import kernels
    from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters

    codec = _liberation()
    data = {i: _data((2, 7 * 2048), seed=i).to(cuda) for i in range(6)}
    counters = dispatch_counters()
    counters.reset()
    before = kernels.XOR_SCHEDULE.launches
    parity = codec.encode_chunks(data)
    assert kernels.XOR_SCHEDULE.launches == before + 1
    got = counters.dump()
    assert got["sched_encode"] == 1 and got["plain_encode"] == 0
    from ceph_tpu_torch.codecs import registry

    ref = registry.factory("jerasure", dict(codec.profile), device="cpu")
    want = ref.encode_chunks({i: v.cpu() for i, v in data.items()})
    for j in want:
        assert torch.equal(parity[j].cpu(), want[j])
    # host-staged input above the threshold: the packetized form
    host = {i: v.cpu().numpy() for i, v in data.items()}
    from ceph_tpu_torch.utils import config

    with config.override(ec_host_dispatch_bytes=0):
        staged = codec.encode_chunks(host)
    assert counters.dump()["sched_encode"] == 2
    for j in want:
        assert torch.equal(staged[j].cpu(), want[j])


def test_lrc_xor_local_repair_on_card(cuda):
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters

    codec = registry.factory(
        "lrc", {"k": "4", "m": "2", "l": "3", "local_parity": "xor"},
        device="cuda")
    data = {i: _data((4, 65536), seed=i).to(cuda) for i in range(4)}
    parity = codec.encode_chunks(data)
    full = {**data, **parity}
    plan = codec.minimum_to_decode({0}, set(range(8)) - {0})
    assert len(plan) == 3
    counters = dispatch_counters()
    counters.reset()
    out = codec.decode_chunks({0}, {s: full[s] for s in plan})
    assert counters.dump()["sched_decode"] == 1
    assert torch.equal(out[0], data[0])


def test_ec_use_sched_off_takes_the_apply_kernel(cuda):
    """0/1 byte matrices ride Kernel D by default and Kernel A with
    ec_use_sched off, to the same bytes."""
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters
    from ceph_tpu_torch.utils import config

    codec = registry.factory("xor", {"k": "4"}, device="cuda")
    data = {i: _data((2, 8192), seed=i).to(cuda) for i in range(4)}
    counters = dispatch_counters()
    counters.reset()
    sched = codec.encode_chunks(data)
    with config.override(ec_use_sched=False):
        kern = codec.encode_chunks(data)
    got = counters.dump()
    assert got["sched_encode"] == 1 and got["kernel_encode"] == 1
    assert torch.equal(sched[4], kern[4])
    assert torch.equal(sched[4], data[0] ^ data[1] ^ data[2] ^ data[3])


# --------------------------------------------------------- Kernels E, F
_CLAY_CASES = [
    ({"k": "8", "m": "4", "d": "11"}, 0), ({"k": "8", "m": "4", "d": "11"}, 9),
    ({"k": "8", "m": "4", "d": "10"}, 0), ({"k": "8", "m": "4", "d": "10"}, 8),
    ({"k": "6", "m": "3", "d": "7"}, 0), ({"k": "6", "m": "3", "d": "7"}, 6),
    ({"k": "8", "m": "4", "d": "9"}, 0), ({"k": "8", "m": "4", "d": "9"}, 11),
]


def _clay_plan(profile, lost):
    """(codec, kernel plan) of the repair of ``lost`` from the first d
    survivors (the last d when those miss a member of its group)."""
    from ceph_tpu_torch.codecs import registry

    codec = registry.factory("clay", profile, device="cpu")
    n = codec.get_chunk_count()
    avail = sorted(set(range(n)) - {lost})[:codec.d]
    if not codec.is_repair({lost}, set(avail)):
        avail = sorted(set(range(n)) - {lost})[-codec.d:]
    helpers = codec.minimum_to_decode({lost}, set(avail))
    aloof = frozenset(codec._to_node(c) for c in range(n)
                      if c != lost and c not in helpers)
    return codec, codec._kernel_plan(codec._to_node(lost), aloof)


@pytest.mark.parametrize("b", [64, 3])
@pytest.mark.parametrize("sc", [8192, 6528, 128, 8, 1003])
@pytest.mark.parametrize("case", range(len(_CLAY_CASES)))
def test_clay_kernels_match_plain(cuda, case, sc, b):
    from ceph_tpu_torch.ops import clay_repair as cr

    codec, plan = _clay_plan(*_CLAY_CASES[case])
    q, r = codec.q, codec.sub_chunk_no // codec.q
    n_real = sum(k == "r" for row in plan["kinds"] for k in row)
    hs = [_data((b, r * sc), seed=i).to(cuda) for i in range(n_real)]
    args = (q, plan["strides"], plan["kinds"], plan["pair_fwd"], hs, r, sc)
    got, want = cr.uncoupled_rows(*args), cr.uncoupled_rows_plain(*args)
    assert len(got) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    x_l = codec._to_node(_CLAY_CASES[case][1]) % q
    n_help = sum(1 for x in range(q)
                 if x != x_l and plan["lost_kinds"][x] == "r")
    ud = [_data((b, r * sc), seed=50 + i).to(cuda) for i in range(q)]
    lh = [_data((b, r * sc), seed=90 + i).to(cuda) for i in range(n_help)]
    args = (q, x_l, plan["lost_kinds"], plan["pair_inv"], ud, lh,
            plan["seq"], r, sc)
    assert torch.equal(cr.couple_scatter(*args), cr.couple_scatter_plain(*args))
    torch.cuda.synchronize()


@pytest.mark.parametrize("profile,lost", [
    ({"k": "8", "m": "4", "d": "11"}, 9), ({"k": "8", "m": "4", "d": "10"}, 3),
])
def test_clay_repair_on_card_moves_counters(cuda, profile, lost):
    """A CUDA-tensor repair launches Kernels E and F once each and the
    inner decodes on Kernel A (kernel_decode), to the source chunk."""
    from ceph_tpu_torch import kernels
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters

    codec = registry.factory("clay", profile, device="cuda")
    z = codec.get_sub_chunk_count()
    data = {i: _data((4, z * 256), seed=i).to(cuda) for i in range(codec.k)}
    full = {**data, **codec.encode_chunks(data)}
    _, plan = _clay_plan(profile, lost)
    n = codec.get_chunk_count()
    avail = sorted(set(range(n)) - {lost})[:codec.d]
    if not codec.is_repair({lost}, set(avail)):
        avail = sorted(set(range(n)) - {lost})[-codec.d:]
    helpers = {}
    for s, runs in codec.minimum_to_decode({lost}, set(avail)).items():
        planes = torch.tensor([p for i, c in runs for p in range(i, i + c)],
                              device=cuda)
        helpers[s] = full[s].view(4, z, 256).index_select(1, planes).reshape(
            4, -1)
    counters = dispatch_counters()
    counters.reset()
    before = (kernels.CLAY_UNCOUPLED.launches,
              kernels.CLAY_COUPLE_SCATTER.launches)
    out = codec.repair({lost}, helpers)[lost]
    assert (kernels.CLAY_UNCOUPLED.launches,
            kernels.CLAY_COUPLE_SCATTER.launches) == (before[0] + 1,
                                                      before[1] + 1)
    got = counters.dump()
    assert got["kernel_decode"] == len(plan["groups"])
    assert got["plain_decode"] == 0 and got["host_decode"] == 0
    assert torch.equal(out, full[lost])


# -- the pipeline path's kernel routes -----------------------------------
def _pipeline(cuda, **cfg):
    """ISA EC(8,4) at a 4 KiB stripe unit over 12 MemStores, as
    chip_smoke's pipeline path wires it."""
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.pipeline import (
        PGLog, ReadPipeline, RecoveryBackend, StripeInfo,
    )
    from ceph_tpu_torch.pipeline.rmw import RMWPipeline, ShardBackend
    from ceph_tpu_torch.store import MemStore

    codec = registry.factory("isa", {"k": "8", "m": "4"}, device=cuda)
    sinfo = StripeInfo(8, 4, 8 * 4096)
    backend = ShardBackend({s: MemStore(f"osd.{s}") for s in range(12)})
    rmw = RMWPipeline(sinfo, codec, backend, pglog=PGLog(12))
    reads = ReadPipeline(sinfo, codec, backend, rmw.object_size)
    rec = RecoveryBackend(sinfo, codec, backend, rmw.object_size, rmw.hinfo,
                          eversion_fn=rmw.object_eversion)
    return sinfo, backend, rmw, reads, rec


def _launches():
    from ceph_tpu_torch import kernels

    return {k.symbol: k.launches for k in kernels.ALL}


def _grew(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def test_pipeline_append_takes_the_fused_kernel(cuda):
    """A 2 MiB append with 4 KiB csum blocks: one Kernel B launch, and
    the HashInfo it seeds equals a byte-hashed one."""
    from ceph_tpu_torch.pipeline import HashInfo

    sinfo, backend, rmw, reads, _ = _pipeline(cuda)
    data = _data((2 << 20,)).numpy()
    before = _launches()
    rmw.submit("o", 0, data.tobytes())
    assert _grew(before, _launches()) == {"gf_apply_csum": 1}
    hi = HashInfo(12, device=cuda)
    hi.append(0, {s: np.frombuffer(backend.stores[s].read("o"), np.uint8)
                  for s in range(12)})
    assert hi == rmw.hinfo("o")
    assert reads.read_sync("o", 0, len(data)) == data.tobytes()


def _delta_on_card_equals_host(cuda, shard, kern):
    """A 4 KiB overwrite of data shard ``shard``: its parity delta takes
    the host GF tables under the default threshold and ``kern`` at 0;
    the stores end byte-equal."""
    from ceph_tpu_torch.utils import config

    data = _data((1 << 20,), seed=3).numpy().tobytes()
    patch = _data((4096,), seed=4).numpy().tobytes()
    snaps = []
    for limit in (1 << 20, 0):
        _, backend, rmw, _, _ = _pipeline(cuda)
        rmw.submit("o", 0, data)
        before = _launches()
        with config.override(ec_host_dispatch_bytes=limit):
            rmw.submit("o", shard * 4096, patch)
        assert _grew(before, _launches()) == ({} if limit else {kern: 1})
        snaps.append({s: (st.read("o"), st.getattrs("o"))
                      for s, st in backend.stores.items()})
    assert snaps[0] == snaps[1]


def test_pipeline_parity_delta_on_kernel_a_equals_host(cuda):
    _delta_on_card_equals_host(cuda, 3, "gf_apply")


def test_pipeline_parity_delta_of_shard_0_on_kernel_d_equals_host(cuda):
    """Shard 0's parity column is all ones: an XOR, Kernel D's."""
    _delta_on_card_equals_host(cuda, 0, "xor_schedule")


def test_pipeline_rebuild_and_scrub_on_kernels_a_and_c(cuda):
    """Rebuilding parity shard 9 of a 4 MiB object: one Kernel A decode
    and one Kernel C verify; the deep scrub hashes all 12 shards on
    Kernel C and finds a flipped byte."""
    from ceph_tpu_torch.pipeline import be_deep_scrub
    from ceph_tpu_torch.store import MemStore, Transaction

    sinfo, backend, rmw, _, rec = _pipeline(cuda)
    rmw.submit("o", 0, _data((4 << 20,), seed=5).numpy().tobytes())
    old = backend.stores[9]
    backend.stores[9] = MemStore("osd.9.new")
    before = _launches()
    rec.recover_object("o", {9})
    assert _grew(before, _launches()) == {"gf_apply": 1, "crc32c_blocks": 1}
    assert backend.stores[9].read("o") == old.read("o")
    assert backend.stores[9].getattrs("o") == old.getattrs("o")
    before = _launches()
    assert be_deep_scrub(sinfo, backend, "o", device=cuda).ok
    assert _grew(before, _launches()) == {"crc32c_blocks": 12}
    byte = backend.stores[2].read("o", 77, 1)[0]
    backend.stores[2].queue_transactions(
        Transaction().write("o", 77, bytes([byte ^ 1])))
    res = be_deep_scrub(sinfo, backend, "o", device=cuda)
    assert [(e.shard, e.kind) for e in res.errors] == [(2, "crc_mismatch")]


def test_ring_batch_is_one_kernel_b_launch(cuda):
    """Three fused encode+csum ops submitted to the streaming
    dispatcher's ring while its drain thread is held: the thread then
    drains them as one batch, one Kernel B launch under the codec's
    device, parity and csums equal to each op's own plain fused form.
    The hold is a plain encode whose completion callback (which runs
    on the drain thread) waits until the three are queued."""
    import threading

    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.pipeline.dispatcher import (
        StreamingDispatcher,
        _stream_counters,
    )

    wait = 60  # seconds: every wait of this test
    codec = registry.factory("isa", {"k": "8", "m": "4"}, device=cuda)
    disp = StreamingDispatcher(codec)
    try:
        held, release = threading.Event(), threading.Event()

        def hold(_result):
            held.set()
            release.wait(wait)

        disp.submit(np.zeros((8, 4096), np.uint8), hold)
        assert held.wait(wait), "the drain thread never took the hold"
        cs, cb = 4096, 4096
        ops = [_data((8, nc, cs), seed=20 + nc).numpy() for nc in (4, 1, 3)]
        results: dict[int, object] = {}
        done = threading.Event()

        def deliver(result, i):
            results[i] = result
            if len(results) == len(ops):
                done.set()

        pc = _stream_counters()
        batches = pc.get("batches")
        before = _launches()
        for idx, chunks in enumerate(ops):
            nc = chunks.shape[1]
            disp.submit(np.ascontiguousarray(chunks).reshape(8, nc * cs),
                        lambda r, i=idx: deliver(r, i),
                        csum_block=cb, n_chunks=nc)
        release.set()
        assert done.wait(wait), "the ring batch never completed"
        torch.cuda.synchronize()
        assert _grew(before, _launches()) == {"gf_apply_csum": 1}
        assert pc.get("batches") == batches + 1
        for idx, chunks in enumerate(ops):
            assert not isinstance(results[idx], Exception), results[idx]
            parity2d, csums = results[idx]
            nc = chunks.shape[1]
            want_p, want_c = ce.gf_apply_csum_plain(
                codec._encode_bmat_np,
                torch.from_numpy(chunks.transpose(1, 0, 2).copy()).to(cuda),
                cb)
            assert np.array_equal(
                parity2d, want_p.cpu().numpy().transpose(1, 0, 2)
                .reshape(4, nc * cs))
            assert np.array_equal(csums, want_c.cpu().numpy())
    finally:
        disp.stop()


@pytest.mark.parametrize("alg,ref", [("xxhash32", 32), ("xxhash64", 64)])
def test_xxhash_on_card_matches_reference(cuda, alg, ref):
    from ceph_tpu_torch.checksum import Checksummer, xxh32_ref, xxh64_ref

    buf = _data((4096 * 64 + 0,), seed=9).to(cuda)
    vals = Checksummer(alg, 4096, device=cuda).calculate(buf)
    fn = xxh32_ref if ref == 32 else xxh64_ref
    host = buf.cpu().numpy()
    for q in (0, 31, 63):
        assert int(vals[q]) == fn(host[q * 4096:(q + 1) * 4096].tobytes(),
                                  (1 << ref) - 1)


def test_cluster_write_reaches_the_fused_kernel(cuda):
    """A 6-OSD cluster on the card (ISA EC(4,2), 4 KiB stripe unit): a
    client's 4 MiB write over TCP is one Kernel B launch on its primary;
    a degraded read with one data shard's OSD down decodes on the card;
    both read back exact."""
    from ceph_tpu_torch.cluster import Monitor, OSDDaemon, RadosClient
    from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters

    mon = Monitor(device=cuda)
    for i in range(6):
        mon.osd_crush_add(i)
    daemons = []
    client = None
    try:
        for i in range(6):
            d = OSDDaemon(i, mon, chunk_size=4096, device=cuda)
            daemons.append(d)
            d.start()
        mon.osd_erasure_code_profile_set(
            "isa42", {"plugin": "isa", "k": "4", "m": "2"})
        mon.osd_pool_create("pool", 8, "isa42")
        client = RadosClient(mon, backoff=0.01)
        io = client.open_ioctx("pool")
        data = _data((4 << 20,), seed=11).numpy().tobytes()
        before = _launches()
        io.write_full("obj", data)
        torch.cuda.synchronize()
        assert _grew(before, _launches()) == {"gf_apply_csum": 1}
        assert io.read("obj") == data
        victim = mon.osdmap.object_to_acting("pool", "obj")[1]
        daemons[victim].stop()
        mon.osd_down(victim)
        counts = dispatch_counters()
        decodes = counts.get("kernel_decode") + counts.get("sched_decode")
        assert io.read("obj") == data
        assert counts.get("kernel_decode") + counts.get(
            "sched_decode") > decodes
    finally:
        if client is not None:
            client.shutdown()
        for d in daemons:
            d.stop()


def _bench(argv, device, monkeypatch):
    """``bench_cli.run`` on ``device``; every outermost codec output and
    every checksum array it produced, as host bytes, and the launches."""
    from ceph_tpu_torch import bench_cli
    from ceph_tpu_torch.checksum import Checksummer
    from ceph_tpu_torch.codecs import registry

    log = []
    orig, calc = registry.factory, Checksummer.calculate

    def factory(*args, **kw):
        codec = orig(*args, **kw)
        for name in ("encode_chunks", "decode_chunks"):
            fn = getattr(codec, name)

            def wrapped(*a, _fn=fn, _name=name, **k):
                out = _fn(*a, **k)
                log.append((_name, {i: c.cpu().numpy().tobytes()
                                    for i, c in sorted(out.items())}))
                return out

            setattr(codec, name, wrapped)
        return codec

    def calculate(self, *a, **k):
        out = calc(self, *a, **k)
        log.append(("calculate", np.asarray(out).tobytes()))
        return out

    with monkeypatch.context() as mp:
        mp.setattr(registry, "factory", factory)
        mp.setattr(Checksummer, "calculate", calculate)
        before = _launches()
        elapsed, kib = bench_cli.run(bench_cli.parse_args(
            argv + ["--device", device]))
        torch.cuda.synchronize()
        grew = _grew(before, _launches())
    return elapsed, kib, log, grew


@pytest.mark.parametrize("argv,main,optional", [
    (["encode", "-P", "k=8", "-P", "m=4", "--size", str(8 << 20),
      "--iterations", "3"], "gf_apply", set()),
    (["decode", "-P", "k=8", "-P", "m=4", "--size", str(4 << 20),
      "--iterations", "12", "--erasures", "2",
      "--erasures-generation", "exhaustive"], "gf_apply", {"xor_schedule"}),
    (["checksum", "--csum-alg", "crc32c", "--csum-block", "4096",
      "--size", str(8 << 20), "--iterations", "3"], "crc32c_blocks", set()),
], ids=["encode", "decode", "checksum"])
def test_bench_cli_on_the_card_matches_the_cpu(cuda, monkeypatch, argv,
                                               main, optional):
    """The bench CLI's encode, decode and checksum workloads on the card:
    the KiB column and every output byte equal to ``--device cpu``, and
    every launch on the card's kernels (none on the CPU run). A decode
    whose matrix is an XOR may take Kernel D (``optional``)."""
    t_gpu, kib_gpu, log_gpu, grew_gpu = _bench(argv, "cuda", monkeypatch)
    t_cpu, kib_cpu, log_cpu, grew_cpu = _bench(argv, "cpu", monkeypatch)
    assert t_gpu > 0 and kib_gpu == kib_cpu > 0
    assert log_gpu and log_gpu == log_cpu
    assert main in grew_gpu and set(grew_gpu) <= {main} | optional
    assert all(v > 0 for v in grew_gpu.values())
    assert grew_cpu == {}


def test_device_clock_measures_on_the_card(cuda):
    """DeviceClock.measure: a positive time per encode on the card, one
    Kernel A launch per encode (warm-up included); None on the CPU."""
    from ceph_tpu_torch.codecs import registry
    from ceph_tpu_torch.loadgen import DeviceClock

    codec = registry.factory("isa", {"k": "8", "m": "4"}, device=cuda)
    before = _launches()
    per = DeviceClock.measure(codec, 32768, iters=8, reps=2)
    assert per is not None and 0 < per < 1.0
    assert _grew(before, _launches()) == {"gf_apply": 1 + 8 * 2}
    cpu = registry.factory("isa", {"k": "8", "m": "4"}, device="cpu")
    assert DeviceClock.measure(cpu, 32768) is None


def test_device_clock_of_a_cpu_cluster_is_none():
    from ceph_tpu_torch.loadgen import DeviceClock, LoadCluster

    cluster = LoadCluster(n_osds=4, k=2, m=1, pg_num=4, chunk_size=1024,
                          device="cpu")
    try:
        codec = cluster.codec()
        assert codec.device.type == "cpu"
        assert DeviceClock.measure(codec, 4096) is None
    finally:
        cluster.shutdown()
