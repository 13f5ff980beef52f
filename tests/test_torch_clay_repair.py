"""CLAY repair stages of the port against ceph_tpu's, byte for byte
(tolerance 0), on the CPU — the mirror of tests/test_clay_general_d.py
plus the kernels' own checks:

- the GF(2^8) tensor helpers against the host tables;
- ``_build_kernel_plan`` equal to ceph_tpu's, field by field, for every
  lost node of (8,4,11), (8,4,10), (6,3,7) and (8,4,9);
- the plain forms of Kernels E and F (``uncoupled_rows_plain``,
  ``couple_scatter_plain``) against the Pallas kernels K8/K9 in
  interpret mode on ceph_tpu's own plans, at B=8 and sc=128 (the
  reference kernels' gates);
- a numpy model of the CUDA kernels' thread addressing (16-byte
  segments per sub-chunk, member order, partner planes) against the
  plain forms, ragged sub-chunks included: the CPU's only view of what
  ``csrc/clay_repair.cu`` computes;
- repair through the kernel route (CPU tensors: the plain forms) for
  aloof geometries, large sub-chunks, the ``ec_clay_kernels=false``
  routes and every clay corpus entry.

Inputs are made with numpy from fixed seeds.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu.codecs import registry as ref_registry  # noqa: E402
from ceph_tpu_torch.codecs import registry  # noqa: E402
from ceph_tpu_torch.gf.tables import gf_mul_bytes  # noqa: E402
from ceph_tpu_torch.ops import clay_repair  # noqa: E402
from ceph_tpu_torch.utils import config  # noqa: E402
from ceph_tpu_torch.utils.device import to_numpy  # noqa: E402

CORPUS_ROOT = os.path.join(os.path.dirname(__file__), "corpus")
GEOMETRIES = [(8, 4, 11), (8, 4, 10), (6, 3, 7), (8, 4, 9)]


def make(k, m, d):
    return registry.factory(
        "clay", {"k": str(k), "m": str(m), "d": str(d)}, device="cpu")


def make_ref(k, m, d):
    return ref_registry.factory(
        "clay", {"k": str(k), "m": str(m), "d": str(d)})


def choose_available(codec, lost, drop=()):
    """The reference tests' helper choice (test_clay_general_d.py
    run_geometry): the first d survivors, or the last d."""
    n = codec.get_chunk_count()
    available = sorted(set(range(n)) - {lost} - set(drop))[:codec.d]
    if not codec.is_repair({lost}, set(available)):
        available = sorted(set(range(n)) - {lost})[-codec.d:]
    return available


def aloof_of(codec, lost, available):
    helpers = codec.minimum_to_decode({lost}, set(available))
    n = codec.get_chunk_count()
    return frozenset(codec._to_node(c) for c in range(n)
                     if c != lost and c not in helpers)


def encode_all(codec, rng, chunk_bytes):
    data = {i: rng.integers(0, 256, chunk_bytes, dtype=np.uint8)
            for i in range(codec.k)}
    return {**data, **codec.encode_chunks(dict(data))}


def repair_helpers(codec, chunks, lost, available, stripes, sc):
    plan = codec.minimum_to_decode({lost}, set(available))
    helper = {}
    for node, ranges in plan.items():
        one = np.concatenate([
            chunks[node][idx * sc:(idx + cnt) * sc] for idx, cnt in ranges
        ])
        helper[node] = np.broadcast_to(one, (stripes, one.size)).copy()
    return helper


def run_geometry(k, m, d, sc, losts, stripes=8):
    """Repair through the kernel route on CPU tensors, held against the
    port's host path, ceph_tpu's host path and the source chunk."""
    rng = np.random.default_rng(k * 100 + m * 10 + d)
    codec, ref = make(k, m, d), make_ref(k, m, d)
    Z = codec.get_sub_chunk_count()
    chunks = encode_all(codec, rng, Z * sc)
    for lost in losts:
        available = choose_available(codec, lost)
        helper = repair_helpers(codec, chunks, lost, available, stripes, sc)
        dev = codec.repair(
            {lost}, {i: torch.from_numpy(v) for i, v in helper.items()}
        )[lost]
        assert isinstance(dev, torch.Tensor)
        truth = np.broadcast_to(chunks[lost], (stripes, Z * sc))
        assert np.array_equal(dev.numpy(), truth), (k, m, d, lost)
        host = codec.repair({lost}, {i: v[:1] for i, v in helper.items()})
        assert np.array_equal(host[lost], truth[:1])
        want = ref.repair({lost}, {i: v[:1] for i, v in helper.items()})
        assert np.array_equal(np.asarray(want[lost]), truth[:1])


# ------------------------------------------------------- GF helpers
def test_gf_helpers_match_host_tables():
    x = torch.arange(256, dtype=torch.uint8)
    xs = x.numpy()
    assert np.array_equal(clay_repair.gf_mul2(x).numpy(), gf_mul_bytes(2, xs))
    assert np.array_equal(clay_repair.gf_div2(x).numpy(),
                          gf_mul_bytes(142, xs))
    for c in range(256):
        assert np.array_equal(clay_repair.gf_mul_const(c, x).numpy(),
                              gf_mul_bytes(c, xs)), c
    cs = np.arange(256, dtype=np.uint8)
    grid = x.repeat(256, 1)  # row i is 0..255, times cs[i]
    got = clay_repair.gf_mul_vec(cs, grid, 0).numpy()
    for c in (0, 1, 2, 3, 29, 142, 143, 244, 255):
        assert np.array_equal(got[c], gf_mul_bytes(c, xs))
    assert np.array_equal(clay_repair.gf_mul_vec(cs, grid.T, 1).numpy(),
                          got.T)


@pytest.mark.parametrize("c0,c1", [(1, 0), (0, 1), (3, 2), (2, 3),
                                   (143, 142), (142, 143), (244, 122),
                                   (7, 0)])
def test_pair_combine_matches_host_tables(c0, c1):
    rng = np.random.default_rng(c0 * 256 + c1)
    a = rng.integers(0, 256, 4096, dtype=np.uint8)
    b = rng.integers(0, 256, 4096, dtype=np.uint8)
    got = clay_repair.pair_combine(c0, c1, torch.from_numpy(a),
                                   torch.from_numpy(b))
    assert np.array_equal(got.numpy(),
                          gf_mul_bytes(c0, a) ^ gf_mul_bytes(c1, b))


# ------------------------------------------------------- plans
def _plans_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        if key == "groups":
            assert got[key].keys() == want[key].keys()
            for s in want[key]:
                assert np.array_equal(got[key][s], want[key][s])
        elif key == "patches":
            assert got[key].keys() == want[key].keys()
            for s in want[key]:
                assert len(got[key][s]) == len(want[key][s])
                for g, w in zip(got[key][s], want[key][s]):
                    assert g[:2] == w[:2] and g[4:] == w[4:]
                    assert np.array_equal(g[2], w[2])
                    assert np.array_equal(g[3], w[3])
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("k,m,d", GEOMETRIES)
def test_kernel_plans_match_reference(k, m, d):
    codec, ref = make(k, m, d), make_ref(k, m, d)
    for lost in range(k + m):
        for drop in ((), (0,), (k + m - 1,)):
            if lost in drop:
                continue
            available = choose_available(codec, lost, drop)
            aloof = aloof_of(codec, lost, available)
            node = codec._to_node(lost)
            _plans_equal(codec._kernel_plan(node, aloof),
                         ref._kernel_plan(node, aloof))


# ------------------------------------------------------- plain vs Pallas
def _plan_cases():
    cases = []
    for k, m, d in GEOMETRIES:
        for lost in (0, k + m - 1, k):
            cases.append((k, m, d, lost))
    return cases


@pytest.mark.parametrize("k,m,d,lost", _plan_cases())
def test_plain_forms_match_pallas_interpret(k, m, d, lost):
    import jax.numpy as jnp

    from ceph_tpu.ops import clay_kernels

    ref = make_ref(k, m, d)
    available = choose_available(ref, lost)
    plan = ref._kernel_plan(ref._to_node(lost),
                            aloof_of(ref, lost, available))
    q, r, sc, b = ref.q, ref.sub_chunk_no // ref.q, 128, 8
    rng = np.random.default_rng(lost + 17 * d)
    n_real = sum(kk == "r" for row in plan["kinds"] for kk in row)
    helpers = [rng.integers(0, 256, (b, r * sc), dtype=np.uint8)
               for _ in range(n_real)]
    want = clay_kernels.uncoupled_rows(
        q, plan["strides"], plan["kinds"], plan["pair_fwd"],
        [jnp.asarray(h) for h in helpers], r, sc, interpret=True)
    got = clay_repair.uncoupled_rows_plain(
        q, plan["strides"], plan["kinds"], plan["pair_fwd"],
        [torch.from_numpy(h) for h in helpers], r, sc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))

    x_l = ref._to_node(lost) % q
    n_help = sum(1 for x in range(q)
                 if x != x_l and plan["lost_kinds"][x] == "r")
    udec = [rng.integers(0, 256, (b, r * sc), dtype=np.uint8)
            for _ in range(q)]
    lost_help = [rng.integers(0, 256, (b, r * sc), dtype=np.uint8)
                 for _ in range(n_help)]
    want = clay_kernels.couple_scatter(
        q, x_l, plan["lost_kinds"], plan["pair_inv"],
        [jnp.asarray(u) for u in udec], [jnp.asarray(h) for h in lost_help],
        plan["seq"], r, sc, interpret=True)
    got = clay_repair.couple_scatter_plain(
        q, x_l, plan["lost_kinds"], plan["pair_inv"],
        [torch.from_numpy(u) for u in udec],
        [torch.from_numpy(h) for h in lost_help], plan["seq"], r, sc)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------- kernel model
_KIND = {"r": 0, "v": 1, "a": 2}


def _gf_pair(c0, c1, a, b):
    return gf_mul_bytes(c0, a) ^ gf_mul_bytes(c1, b)


def model_uncoupled(q, strides, kinds, pair_fwd, helpers, r, sc):
    """Kernel E as csrc/clay_repair.cu runs it: the parameter block
    clay_uncoupled() fills, then one thread per (output j, 16-byte
    segment g of the r sub-chunks), over all stripes at once."""
    kind = [_KIND[k] for row in kinds for k in row]
    in_of, out_row, out_x = [], [], []
    for ri in range(len(kinds)):
        for x in range(q):
            mm = ri * q + x
            in_of.append(sum(1 for v in kind[:mm] if v == 0)
                         if kind[mm] == 0 else -1)
            if kind[mm] != 2:
                out_row.append(ri)
                out_x.append(x)
    segs = -(-sc // 16)
    b = helpers[0].shape[0]
    outs = [np.full((b, r * sc), 0xA5, np.uint8) for _ in out_row]
    for j, (ri, x) in enumerate(zip(out_row, out_x)):
        s = strides[ri]
        for g in range(r * segs):
            pl, seg = divmod(g, segs)
            off = seg * 16
            avail = min(16, sc - off)
            zv = (pl // s) % q
            me, mate = in_of[ri * q + x], in_of[ri * q + zv]
            o = pl * sc + off
            zero = np.zeros((b, avail), np.uint8)

            def load(i, at):
                return helpers[i][:, at:at + avail] if i >= 0 else zero

            if zv == x or (me >= 0 and kind[ri * q + zv] == 2):
                v = load(me, o)
            else:
                c0, c1 = pair_fwd[0] if x > zv else pair_fwd[1]
                v = _gf_pair(c0, c1, load(me, o),
                             load(mate, (pl + (x - zv) * s) * sc + off))
            outs[j][:, o:o + avail] = v
    return outs


def model_couple_scatter(q, x_l, kinds, pair_inv, udec, helpers, seq, r,
                         sc):
    """Kernel F as csrc/clay_repair.cu runs it: one thread per 16-byte
    segment of each of the q*r output planes."""
    hx = [x for x in range(q) if x != x_l and kinds[x] == "r"]
    h = {x: helpers[i] for i, x in enumerate(hx)}
    segs = -(-sc // 16)
    b = udec[0].shape[0]
    out = np.full((b, q * r * sc), 0xA5, np.uint8)
    for g in range(q * r * segs):
        z, seg = divmod(g, segs)
        off = seg * 16
        avail = min(16, sc - off)
        x = (z // seq) % q
        pl = (z // (q * seq)) * seq + z % seq
        o = pl * sc + off
        v = udec[x][:, o:o + avail]
        if x != x_l:
            c0, c1 = pair_inv[0] if x > x_l else pair_inv[1]
            hv = (h[x][:, o:o + avail] if x in h
                  else np.zeros((b, avail), np.uint8))
            v = _gf_pair(c0, c1, hv, v)
        out[:, z * sc + off:z * sc + off + avail] = v
    return out


@pytest.mark.parametrize("sc", [8, 24, 37])
@pytest.mark.parametrize("k,m,d", GEOMETRIES)
def test_kernel_model_matches_plain(k, m, d, sc):
    codec = make(k, m, d)
    q, r = codec.q, codec.sub_chunk_no // codec.q
    rng = np.random.default_rng(sc * 31 + d)
    for lost in (0, k + m - 1):
        available = choose_available(codec, lost)
        plan = codec._kernel_plan(codec._to_node(lost),
                                  aloof_of(codec, lost, available))
        n_real = sum(kk == "r" for row in plan["kinds"] for kk in row)
        hs = [rng.integers(0, 256, (3, r * sc), dtype=np.uint8)
              for _ in range(n_real)]
        args = (q, plan["strides"], plan["kinds"], plan["pair_fwd"])
        got = model_uncoupled(*args, hs, r, sc)
        want = clay_repair.uncoupled_rows_plain(
            *args, [torch.from_numpy(h) for h in hs], r, sc)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g, w.numpy()), (lost, sc)
        x_l = codec._to_node(lost) % q
        n_help = sum(1 for x in range(q)
                     if x != x_l and plan["lost_kinds"][x] == "r")
        ud = [rng.integers(0, 256, (3, r * sc), dtype=np.uint8)
              for _ in range(q)]
        lh = [rng.integers(0, 256, (3, r * sc), dtype=np.uint8)
              for _ in range(n_help)]
        args = (q, x_l, plan["lost_kinds"], plan["pair_inv"])
        got = model_couple_scatter(*args, ud, lh, plan["seq"], r, sc)
        want = clay_repair.couple_scatter_plain(
            *args, [torch.from_numpy(u) for u in ud],
            [torch.from_numpy(v) for v in lh], plan["seq"], r, sc)
        assert np.array_equal(got, want.numpy()), (lost, sc)


def test_wrappers_check_their_operands():
    kinds = (("r", "r"), ("r", "r"))
    h = [torch.zeros((2, 16), dtype=torch.uint8)] * 3
    with pytest.raises(ValueError, match="3 helper arrays for 4"):
        clay_repair.uncoupled_rows(2, (2, 1), kinds, ((3, 2), (3, 2)), h,
                                   4, 4)
    with pytest.raises(ValueError, match="for q=2"):
        clay_repair.couple_scatter(2, 0, ("r", "r"), ((143, 142),) * 2,
                                   h[:1], [], 1, 4, 4)


# ------------------------------------------------------- the codec
class TestKernelsCalled:
    def test_aloof_repair_rides_kernels(self, monkeypatch):
        """The general-d routing reaches the kernel wrappers, once each,
        for an aloof geometry (no silent route around them)."""
        calls = {"unc": 0, "scat": 0}
        real_u = clay_repair.uncoupled_rows
        real_s = clay_repair.couple_scatter

        def unc(*a, **kw):
            calls["unc"] += 1
            return real_u(*a, **kw)

        def scat(*a, **kw):
            calls["scat"] += 1
            return real_s(*a, **kw)

        monkeypatch.setattr(clay_repair, "uncoupled_rows", unc)
        monkeypatch.setattr(clay_repair, "couple_scatter", scat)
        run_geometry(8, 4, 10, 128, losts=(3,))
        assert calls == {"unc": 1, "scat": 1}


class TestAloofGeometries:
    def test_one_aloof_q3(self):
        # (8,4,d=10): q=3, one aloof node, two score groups
        run_geometry(8, 4, 10, 128, losts=(0, 7, 8, 11))

    def test_one_aloof_shortened(self):
        # (6,3,d=7): q=2, nu=1 — virtual zero nodes share rows with
        # the aloof node
        run_geometry(6, 3, 7, 128, losts=(0, 5, 6, 8))

    def test_two_aloof(self):
        # (8,4,d=9): q=2, TWO aloof nodes, three score groups
        run_geometry(8, 4, 9, 128, losts=(0, 11))


class TestBlockedStreaming:
    def test_large_sub_chunks(self):
        """(4,2,d=5) at sc=32768: 8 stripes x 4 repair planes x 32 KiB,
        1 MiB per helper array."""
        run_geometry(4, 2, 5, 32768, losts=(1, 5), stripes=8)

    def test_lost_in_major_row(self):
        """y_l = 0: one repair run spanning every plane."""
        run_geometry(8, 4, 11, 1024, losts=(0,), stripes=8)

    def test_unaligned_sub_chunks_and_odd_batch(self):
        """The CUDA kernels take any sc and any B: sc=8 and 3 stripes."""
        run_geometry(8, 4, 10, 8, losts=(2, 9), stripes=3)


class TestCompileGateFallback:
    @pytest.mark.parametrize("k,m,d,lost", [(8, 4, 10, 3), (8, 4, 11, 9)])
    def test_torch_routes_match_kernels(self, k, m, d, lost, rng):
        """With ``ec_clay_kernels`` off, the whole-tensor (no aloof) and
        itemized (aloof) routes give the same chunk as the kernel
        route."""
        codec = make(k, m, d)
        Z = codec.get_sub_chunk_count()
        sc = 128
        chunks = encode_all(codec, rng, Z * sc)
        available = choose_available(codec, lost)
        helper = {i: torch.from_numpy(v) for i, v in repair_helpers(
            codec, chunks, lost, available, 8, sc).items()}
        with_kernels = codec.repair({lost}, helper)[lost]
        with config.override(ec_clay_kernels=False):
            without = codec.repair({lost}, helper)[lost]
        assert torch.equal(with_kernels, without)
        assert np.array_equal(with_kernels[0].numpy(), chunks[lost])


def _clay_corpus_entries():
    out = []
    for version in sorted(os.listdir(CORPUS_ROOT)):
        cdir = os.path.join(CORPUS_ROOT, version, "clay")
        if not os.path.isdir(cdir):
            continue
        for slug in sorted(os.listdir(cdir)):
            entry = os.path.join(cdir, slug)
            meta = os.path.join(entry, "profile.json")
            if os.path.isfile(meta):
                with open(meta) as f:
                    out.append((f"{version}-{slug}", entry, json.load(f)))
    return out


class TestTracedVsCorpus:
    """Every archived clay corpus entry: the port's encode of the payload
    reproduces the frozen chunks, and repairing chunks 0 and n-1
    through the kernel route (CPU tensors) reproduces them too."""

    @pytest.mark.parametrize(
        "entry,meta",
        [(e, m) for _id, e, m in _clay_corpus_entries()],
        ids=[i for i, _e, _m in _clay_corpus_entries()],
    )
    def test_repair_matches_archive(self, entry, meta):
        codec = registry.factory("clay", dict(meta["profile"]), device="cpu")
        n = codec.get_chunk_count()
        stored = {}
        for i in range(n):
            with open(os.path.join(entry, f"chunk.{i}"), "rb") as f:
                stored[i] = np.frombuffer(f.read(), np.uint8)
        with open(os.path.join(entry, "payload.bin"), "rb") as f:
            encoded = codec.encode(f.read())
        assert all(encoded[i] == stored[i].tobytes() for i in range(n))
        Z = codec.get_sub_chunk_count()
        sc = stored[0].size // Z
        for lost in (0, n - 1):
            available = set(range(n)) - {lost}
            assert codec.is_repair({lost}, available)
            helper = repair_helpers(codec, stored, lost, sorted(available),
                                    3, sc)
            out = codec.repair(
                {lost}, {i: torch.from_numpy(v) for i, v in helper.items()}
            )[lost]
            assert np.array_equal(
                to_numpy(out),
                np.broadcast_to(stored[lost], (3, stored[lost].size)),
            ), (entry, lost)
