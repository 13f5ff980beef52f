"""The port's XOR-schedule engine (ops/xor_schedule.py, ops/cuda_xor.py)
against ceph_tpu's, byte for byte (tolerance 0: XOR is exact).

- The optimizer, gates and op counts: the same ``Schedule`` field for
  field, the same ``_linearize`` output and the same golden post-CSE
  counts (liberation 42, blaum_roth 41, liber8tion 48) from the same
  matrix.
- The plain version against ceph_tpu's Pallas kernels in interpret mode
  (P = 2048), its XLA form and a matrix oracle, in both forms; a
  schedule built by ceph_tpu runs in the port to the same bytes.
- Kernel D's program (ops/cuda_xor.encode_program) run by a numpy
  interpreter with the kernel's addressing, against the plain version:
  the CPU's check of what the CUDA kernel executes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu.codecs import registry as ref_registry  # noqa: E402
from ceph_tpu.ops import xor_schedule as ref_xs  # noqa: E402
from ceph_tpu_torch.codecs import registry  # noqa: E402
from ceph_tpu_torch.ops import cuda_xor  # noqa: E402
from ceph_tpu_torch.ops import xor_schedule as xs  # noqa: E402

FAMILY_PROFILES = [
    {"technique": "liberation", "k": "4", "m": "2", "w": "7"},
    {"technique": "blaum_roth", "k": "4", "m": "2", "w": "6"},
    {"technique": "liber8tion", "k": "4", "m": "2", "w": "8"},
]
#: ceph_tpu's golden pins (tests/test_sched_superopt.py)
GOLDEN_OPS = {
    "liberation": {"ones": 59, "raw_xors": 45, "opt_xors": 42},
    "blaum_roth": {"ones": 63, "raw_xors": 51, "opt_xors": 41},
    "liber8tion": {"ones": 68, "raw_xors": 52, "opt_xors": 48},
}


def matrix_oracle(mat01, packets):
    """One XOR per set bit, straight off the matrix."""
    m = np.asarray(mat01)
    out = np.zeros(
        packets.shape[:-2] + (m.shape[0], packets.shape[-1]), np.uint8
    )
    for q in range(m.shape[0]):
        for j in np.flatnonzero(m[q]):
            out[..., q, :] ^= packets[..., j, :]
    return out


def random_matrix(seed):
    rng = np.random.default_rng(seed)
    n_out = int(rng.integers(1, 10))
    n_in = int(rng.integers(2, 14))
    return (rng.random((n_out, n_in)) < rng.uniform(0.2, 0.8)).astype(
        np.uint8
    )


def codec_pair(profile):
    return (registry.factory("jerasure", dict(profile), device="cpu"),
            ref_registry.factory("jerasure", dict(profile)))


def plain(sched, packets: np.ndarray) -> np.ndarray:
    return xs.xor_schedule_plain(sched, torch.from_numpy(packets)).numpy()


# ------------------------------------------------------ optimizer core
def test_optimize_schedule_factors_shared_pairs():
    mat = np.array(
        [[1, 1, 1, 0], [1, 1, 0, 1], [0, 0, 1, 1]], np.uint8
    )
    sched = xs.optimize_schedule(mat)
    assert sched.n_in == 4 and (0, 1) in sched.temps
    assert xs.schedule_xors(sched) == 4
    assert xs.schedule_xors(xs.schedule_rows(mat)) == 5


@pytest.mark.parametrize("seed", range(25))
def test_optimizer_matches_reference(seed):
    """Same Schedule field for field, deterministic, never worse than
    the selection form, and the same linearized program."""
    m = random_matrix(seed)
    port, ref = xs.optimize_schedule(m), ref_xs.optimize_schedule(m)
    assert tuple(port) == tuple(ref)
    assert port == xs.optimize_schedule(m)
    assert xs.schedule_rows(m) == ref_xs.schedule_rows(m)
    assert xs.schedule_xors(port) <= xs.schedule_xors(xs.schedule_rows(m))
    assert xs._linearize(port) == ref_xs._linearize(ref)
    assert xs.cse_stats(m) == ref_xs.cse_stats(m)


def test_gates_match_reference():
    shared = np.ones((8, 16), np.uint8)
    rows = xs.schedule_rows(shared)
    assert not xs.profitable(rows, 16)  # (128 + 8) / 16 = 8.5
    assert xs.profitable_opt(xs.optimize_schedule(shared), 16)
    assert not xs.profitable_opt(xs.Schedule(4, (), ()), 4)
    assert not xs.profitable((), 4)
    for seed in range(10):
        m = random_matrix(seed)
        for opt in (True, False):
            got = xs.routable_schedule(m, opt)
            want = ref_xs.routable_schedule(m, opt)
            assert (got is None) == (want is None)
            if got is not None:
                assert tuple(got) == tuple(want)


def test_routable_schedule_forms():
    mat = np.array([[1, 1, 0], [0, 1, 1]], np.uint8)
    assert isinstance(xs.routable_schedule(mat, True), xs.Schedule)
    assert xs.routable_schedule(mat, False) == xs.schedule_rows(mat)


@pytest.mark.parametrize(
    "profile", FAMILY_PROFILES, ids=lambda p: p["technique"]
)
def test_linearize_recycles_scratch_slots(profile):
    port, ref = codec_pair(profile)
    dec = port._build_decode_bitmatrix([2, 3, 4, 5], [0, 1])
    assert np.array_equal(dec, ref._build_decode_bitmatrix([2, 3, 4, 5],
                                                           [0, 1]))
    sched = xs.optimize_schedule(dec)
    ops, n_slots = xs._linearize(sched)
    assert (ops, n_slots) == ref_xs._linearize(ref_xs.Schedule(*sched))
    assert 0 < n_slots < len(sched.temps)
    written: dict[int, int] = {}
    for i, entry in enumerate(ops):
        for kind, idx in entry[2]:
            if kind == 1:
                assert idx in written and written[idx] < i
        if entry[0] == "t":
            written[entry[1]] = i


# ------------------------------------------------------ op-count pins
@pytest.mark.parametrize(
    "profile", FAMILY_PROFILES, ids=lambda p: p["technique"]
)
def test_golden_post_cse_op_counts(profile):
    port, ref = codec_pair(profile)
    st = xs.cse_stats(port.coding_bitmatrix)
    want = GOLDEN_OPS[profile["technique"]]
    assert {k: st[k] for k in want} == want
    assert st == ref_xs.cse_stats(ref.coding_bitmatrix)
    assert st["opt_xors"] < st["ones"]


@pytest.mark.parametrize(
    "profile", FAMILY_PROFILES, ids=lambda p: p["technique"]
)
def test_inverted_decode_matrices_pass_post_cse_gate(profile):
    port, _ = codec_pair(profile)
    dec = port._build_decode_bitmatrix([2, 3, 4, 5], [0, 1])
    assert not xs.profitable(xs.schedule_rows(dec), dec.shape[1])
    assert xs.profitable_opt(xs.optimize_schedule(dec), dec.shape[1])


def test_lrc_xor_local_rows_op_counts():
    """The LRC xor-local encode, repair and delta rows: the same
    scorecard as ceph_tpu's."""
    port = registry.factory(
        "lrc", {"k": "4", "m": "2", "l": "3", "local_parity": "xor"},
        device="cpu")
    ref = ref_registry.factory(
        "lrc", {"k": "4", "m": "2", "l": "3", "local_parity": "xor"})
    for pl, rl in zip(port.layers[1:], ref.layers[1:]):
        assert np.array_equal(pl.codec.generator, rl.codec.generator)
        mats = [
            pl.codec.generator[3:],
            pl.codec._build_decode_bytes([1, 2, 3], [0]),
            pl.codec.generator[3:, [1]],
        ]
        for mat in mats:
            assert xs.cse_stats(mat) == ref_xs.cse_stats(mat)
            assert xs.routable_schedule(mat) is not None


# --------------------------------------------- plain vs the reference
@pytest.mark.parametrize("seed", range(4))
def test_plain_matches_reference_kernels(seed):
    m = random_matrix(seed)
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 256, (2, m.shape[1], 2048), np.uint8)
    want = matrix_oracle(m, pk)
    sched = xs.optimize_schedule(m)
    rows = xs.schedule_rows(m)
    rsched = ref_xs.Schedule(*sched)
    assert np.array_equal(plain(sched, pk), want)
    assert np.array_equal(plain(rows, pk), want)
    assert np.array_equal(
        np.asarray(ref_xs.xor_schedule_apply(rsched, pk, interpret=True)),
        want)
    assert np.array_equal(
        np.asarray(ref_xs.xor_schedule_apply(rows, pk, interpret=True)),
        want)
    assert np.array_equal(np.asarray(ref_xs._xla_apply(rsched, pk)), want)


@pytest.mark.parametrize("w,k,mo", [(3, 4, 2), (1, 5, 2), (7, 4, 2)])
def test_shards_plain_matches_reference_kernel(rng, w, k, mo):
    chunk = w * 2048
    m = (rng.random((mo * w, k * w)) < 0.5).astype(np.uint8)
    m[:2, :2] = 1  # at least one shared pair -> an intermediate
    sched = xs.optimize_schedule(m)
    assert sched.temps
    shards = [rng.integers(0, 256, (8, chunk), np.uint8) for _ in range(k)]
    pk = np.stack(shards, axis=-2).reshape(8, k * w, chunk // w)
    want = matrix_oracle(m, pk).reshape(8, mo, chunk)
    ref = ref_xs.xor_schedule_apply_shards(
        ref_xs.Schedule(*sched), shards, w, interpret=True)
    got = xs.xor_schedule_plain_shards(
        sched, [torch.from_numpy(s) for s in shards], w)
    via_wrapper = cuda_xor.xor_schedule_apply_shards(
        sched, [torch.from_numpy(s) for s in shards], w)
    assert len(got) == len(ref) == len(via_wrapper) == mo
    for j in range(mo):
        assert np.array_equal(got[j].numpy(), want[:, j])
        assert np.array_equal(np.asarray(ref[j]), want[:, j])
        assert np.array_equal(via_wrapper[j].numpy(), want[:, j])


@pytest.mark.parametrize(
    "profile", FAMILY_PROFILES, ids=lambda p: p["technique"]
)
def test_reference_built_schedule_runs_in_port(rng, profile):
    _, ref = codec_pair(profile)
    ref_sched = ref_xs.optimize_schedule(ref.coding_bitmatrix)
    sched = xs.Schedule(*ref_sched)
    kw = ref.coding_bitmatrix.shape[1]
    pk = rng.integers(0, 256, (3, kw, 2048), np.uint8)
    want = np.asarray(ref_xs._xla_apply(ref_sched, pk))
    assert np.array_equal(plain(sched, pk), want)
    got = cuda_xor.xor_schedule_apply(sched, torch.from_numpy(pk))
    assert np.array_equal(got.numpy(), want)


def test_empty_and_single_rows(rng):
    m = np.array(
        [[0, 0, 0, 0], [1, 0, 0, 0], [1, 1, 0, 1], [1, 1, 1, 1]], np.uint8
    )
    pk = rng.integers(0, 256, (1, 4, 2048), np.uint8)
    want = matrix_oracle(m, pk)
    for sched in (xs.optimize_schedule(m), xs.schedule_rows(m)):
        assert np.array_equal(plain(sched, pk), want)
    got = ref_xs.xor_schedule_apply(
        ref_xs.Schedule(*xs.optimize_schedule(m)), pk, interpret=True)
    assert np.array_equal(np.asarray(got), want)


# ------------------------------------------- Kernel D's program on CPU
def run_program(words, n_slots, ins, n_out, out_w, p):
    """Execute an encoded program the way csrc/xor_schedule.cu does: the
    header names the used input packets by code (shard << 24 | packet
    within the shard, at byte offset packet * p); an op's input sources
    index that list, its slot sources follow; a destination >= 0 is an
    output packet's code, < 0 scratch slot -1 - dst."""
    b = ins[0].shape[0]
    outs = [np.full((b, out_w * p), 0xA5, np.uint8) for _ in range(n_out)]
    mask = (1 << cuda_xor.CODE_BITS) - 1
    n_used = int(words[0])
    rows = []
    for code in (int(x) for x in words[1:1 + n_used]):
        sh, t = code >> cuda_xor.CODE_BITS, code & mask
        rows.append(ins[sh][:, t * p:(t + 1) * p])
    slots: dict[int, np.ndarray] = {}
    pc = 1 + n_used
    while pc < len(words):
        w0, dst = int(words[pc]), int(words[pc + 1])
        n_in, n_slot = w0 & 0xFFFF, w0 >> 16
        pc += 2
        acc = np.zeros((b, p), np.uint8)
        for i in (int(x) for x in words[pc:pc + n_in]):
            assert 0 <= i < n_used
            acc ^= rows[i]
        pc += n_in
        for s in (int(x) for x in words[pc:pc + n_slot]):
            acc ^= slots[s]
        pc += n_slot
        if dst < 0:
            assert 0 <= -1 - dst < n_slots
            slots[-1 - dst] = acc
        else:
            sh, t = dst >> cuda_xor.CODE_BITS, dst & mask
            outs[sh][:, t * p:(t + 1) * p] = acc
    return outs


@pytest.mark.parametrize("seed", range(12))
def test_program_matches_plain(seed):
    rng = np.random.default_rng(seed)
    w, k, mo = (int(rng.integers(1, 9)), int(rng.integers(1, 8)),
                int(rng.integers(1, 5)))
    m = (rng.random((mo * w, k * w)) < rng.uniform(0.1, 0.9)).astype(
        np.uint8)
    m[0] = 0  # an empty row writes zeros
    p = 40
    shards = [rng.integers(0, 256, (3, w * p), np.uint8) for _ in range(k)]
    pk = np.stack(shards, -2).reshape(3, k * w, p)
    for sched in (xs.optimize_schedule(m), xs.schedule_rows(m)):
        want = plain(sched, pk)
        words, n_slots = cuda_xor.encode_program(sched, w, w)
        assert words.dtype == np.int32
        got = run_program(words, n_slots, shards, mo, w, p)
        for j in range(mo):
            assert np.array_equal(got[j].reshape(3, w, p),
                                  want[:, j * w:(j + 1) * w])
        words, n_slots = cuda_xor.encode_program(sched, k * w, mo * w)
        (stacked,) = run_program(words, n_slots, [pk.reshape(3, -1)],
                                 1, mo * w, p)
        assert np.array_equal(stacked.reshape(3, mo * w, p), want)


def test_flatten_schedule_is_the_selection_form():
    for seed in range(10):
        m = random_matrix(seed)
        assert xs.flatten_schedule(xs.optimize_schedule(m)) == \
            xs.schedule_rows(m)


def test_oversized_scratch_runs_as_selection_rows(monkeypatch):
    m = (np.random.default_rng(3).random((24, 24)) < 0.5).astype(np.uint8)
    sched = xs.optimize_schedule(m)
    assert xs._linearize(sched)[1] > 0
    monkeypatch.setattr(cuda_xor, "MAX_SLOTS", 0)
    words, n_slots = cuda_xor.encode_program(sched, 24, 24)
    assert n_slots == 0
    assert np.array_equal(
        words, cuda_xor.encode_program(xs.schedule_rows(m), 24, 24)[0])


def test_wrappers_check_the_schedule(rng):
    rows = ((0, 2), (1,))
    pk = torch.from_numpy(rng.integers(0, 256, (2, 3, 64), np.uint8))
    assert torch.equal(cuda_xor.xor_schedule_apply(rows, pk),
                       xs.xor_schedule_plain(rows, pk))
    with pytest.raises(ValueError, match="reads packet 2"):
        cuda_xor.xor_schedule_apply(rows, pk[:, :2])
    sched = xs.optimize_schedule(np.ones((2, 3), np.uint8))
    with pytest.raises(ValueError, match="input packets"):
        cuda_xor.xor_schedule_apply(sched, pk[:, :2])
    with pytest.raises(ValueError, match="whole shards"):
        cuda_xor.xor_schedule_apply_shards(rows, [pk[:, 0]], 3)
