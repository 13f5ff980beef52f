"""The port's SHEC codec (``codecs/shec.py``) against ceph_tpu's, byte
for byte (tolerance 0), on the CPU: profile parsing and its errors, the
shingled coding matrix, ``minimum_to_decode`` plans and ``_search``
results, encode and decode over every single and double erasure on
numpy and CPU tensors (the apply kernel's plain form), the SHEC legs of
``tests/test_zero_waste_packing.py`` (shingle reconstruction matrices),
the v0 corpus entry ``shec_c=2_k=4_m=3``, and CLAY over a SHEC inner
code. Mirrors ``tests/test_shec.py``.
"""

import itertools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu.codecs import registry as ref_registry  # noqa: E402
from ceph_tpu.codecs import shec as ref_shec  # noqa: E402
from ceph_tpu_torch.codecs import registry  # noqa: E402
from ceph_tpu_torch.codecs import shec  # noqa: E402
from ceph_tpu_torch.codecs.matrix_codec import dispatch_counters  # noqa: E402
from ceph_tpu_torch.gf import gf_apply_bytes_host  # noqa: E402
from ceph_tpu_torch.utils.device import to_numpy  # noqa: E402

CHUNK = 256
CORPUS = Path(__file__).parent / "corpus"


def pair(plugin="shec", **kv):
    prof = {k: str(v) for k, v in kv.items()}
    return (registry.factory(plugin, prof, device="cpu"),
            ref_registry.factory(plugin, prof))


def encode_all(codec, rng, lead=()):
    k = codec.get_data_chunk_count()
    data = {i: rng.integers(0, 256, lead + (CHUNK,), np.uint8)
            for i in range(k)}
    parity = codec.encode_chunks(data)
    return {**data, **{i: to_numpy(v) for i, v in parity.items()}}


class TestParse:
    def test_defaults(self):
        port, ref = pair()
        assert (port.k, port.m, port.c, port.technique) == (
            ref.k, ref.m, ref.c, ref.technique) == (4, 3, 2, "multiple")

    @pytest.mark.parametrize("kv", [
        dict(k=4, m=3), dict(k=4, m=2, c=3), dict(k=13, m=3, c=2),
        dict(k=12, m=12, c=2), dict(k=3, m=4, c=2),
        dict(k=4, m=3, c=2, technique="bogus"), dict(k=0, m=1, c=1),
        dict(k=4, m=3, c=2, w=16),
    ])
    def test_errors_match(self, kv):
        msgs = []
        for reg, kw in ((registry, {"device": "cpu"}), (ref_registry, {})):
            with pytest.raises(ValueError) as ei:
                reg.factory("shec", {k: str(v) for k, v in kv.items()}, **kw)
            msgs.append(str(ei.value))
        if "w" not in kv:  # the w=8-only message names no device
            assert msgs[0] == msgs[1]

    def test_flags_and_registry(self):
        port, ref = pair()
        assert port.get_flags().value == ref.get_flags().value
        assert type(port) is shec.ShecCodec


@pytest.mark.parametrize("k,m,c,single", [
    (8, 4, 2, False), (6, 3, 2, True), (8, 4, 3, False), (10, 4, 2, False),
    (4, 3, 2, False), (12, 8, 3, False),
])
def test_coding_matrix_and_bands(k, m, c, single):
    assert shec._shingle_bands(k, m, c, single) == ref_shec._shingle_bands(
        k, m, c, single)
    got = shec.shec_coding_matrix(k, m, c, single)
    assert np.array_equal(got, ref_shec.shec_coding_matrix(k, m, c, single))
    assert ((got != 0).sum(axis=0) >= c).all()


@pytest.mark.parametrize("k,m,c", [(4, 3, 2), (6, 4, 2), (8, 4, 3)])
def test_plans_and_search_match(k, m, c):
    port, ref = pair(k=k, m=m, c=c)
    n = k + m
    for lost in itertools.chain(
            itertools.combinations(range(n), 1),
            itertools.combinations(range(n), 2)):
        avail = set(range(n)) - set(lost)
        res = []
        for codec in (port, ref):
            try:
                res.append(codec.minimum_to_decode(set(lost), avail))
            except ValueError as e:
                res.append(str(e))
        assert res[0] == res[1], lost
        want = [1 if i in lost else 0 for i in range(n)]
        av = [0 if i in lost else 1 for i in range(n)]
        try:
            a = port._search(want, av)
        except ValueError:
            continue
        b = ref._search(want, av)
        assert a[:2] == b[:2] and a[3] == b[3]
        assert (a[2] is None) == (b[2] is None)
        if a[2] is not None:
            assert np.array_equal(a[2], b[2])


@pytest.mark.parametrize("tensors", [False, True])
def test_round_trip_all_double_erasures(rng, tensors):
    port, ref = pair(k=6, m=4, c=2)
    chunks = encode_all(ref, rng, lead=(2,))
    mine = encode_all(port, np.random.default_rng(0xCEF), lead=(2,))
    assert all(np.array_equal(chunks[i], mine[i]) for i in chunks)
    conv = (lambda v: torch.from_numpy(v)) if tensors else (lambda v: v)
    n = port.get_chunk_count()
    for lost in itertools.chain(itertools.combinations(range(n), 1),
                                itertools.combinations(range(n), 2)):
        have = {i: conv(v) for i, v in chunks.items() if i not in lost}
        out = port.decode_chunks(set(lost), have)
        for s in lost:
            assert np.array_equal(to_numpy(out[s]), chunks[s]), lost


def test_locality_reads_fewer_than_k():
    port, ref = pair(k=6, m=4, c=2)
    plan = port.minimum_to_decode({0}, set(range(1, 10)))
    assert plan == ref.minimum_to_decode({0}, set(range(1, 10)))
    assert len(plan) < port.k


@pytest.mark.parametrize("k,m,c", [
    (2, 1, 1), (3, 2, 1), (3, 2, 2), (4, 3, 2), (5, 3, 2), (6, 3, 3),
    (8, 4, 3), (10, 4, 2),
])
def test_sweep_encode_single_decode(rng, k, m, c):
    port, ref = pair(k=k, m=m, c=c)
    data = {i: rng.integers(0, 256, CHUNK, np.uint8) for i in range(k)}
    pp = port.encode_chunks(data)
    pr = ref.encode_chunks(data)
    chunks = {**data, **{i: to_numpy(v) for i, v in pp.items()}}
    for i in pr:
        assert np.array_equal(chunks[i], np.asarray(pr[i]))
    for lost in range(k + m):
        have = {i: v for i, v in chunks.items() if i != lost}
        assert np.array_equal(
            to_numpy(port.decode_chunks({lost}, have)[lost]), chunks[lost])


@pytest.mark.parametrize("k,m,c", [(4, 3, 2), (6, 4, 3)])
def test_reconstruction_matrices_match(rng, k, m, c):
    """The zero-waste-packing SHEC legs: the shingle system's
    reconstruction matrix equals ceph_tpu's, and applied through the
    port's apply (plain form of Kernel A) it returns the erased shard."""
    port, ref = pair(k=k, m=m, c=c)
    data = rng.integers(0, 256, (2, k, 512), np.uint8)
    want = gf_apply_bytes_host(port.coding, data)
    par = port.encode_chunks({i: torch.from_numpy(data[:, i]) for i in range(k)})
    assert np.array_equal(np.stack([to_numpy(par[k + j]) for j in range(m)],
                                   axis=1), want)
    full = np.concatenate([data, want], axis=1)
    for missing in ([0], [k], [1, k + 1]):
        avail = set(range(k + m)) - set(missing)
        try:
            a = port._build_reconstruction(avail, missing)
        except ValueError:
            continue
        b = ref._build_reconstruction(avail, missing)
        assert a[0] == b[0] and np.array_equal(a[1], b[1])
        from ceph_tpu_torch.ops import cuda_encode

        got = cuda_encode.gf_apply(a[1], torch.from_numpy(
            np.ascontiguousarray(full[:, a[0], :])))
        assert np.array_equal(got.numpy(), full[:, missing, :])


def test_decode_takes_the_apply_route(rng):
    """Host survivors go to the codec's device stacked (kernel_decode
    on the card, plain_decode on the CPU): the SHEC decode has no host
    route, as in ceph_tpu."""
    port, _ = pair(k=4, m=3, c=2)
    chunks = encode_all(port, rng)
    before = dispatch_counters().dump()
    port.decode_chunks({1}, {i: v for i, v in chunks.items() if i != 1})
    after = dispatch_counters().dump()
    assert after["plain_decode"] == before["plain_decode"] + 1
    assert after["host_decode"] == before["host_decode"]


def test_corpus_entry():
    entry = CORPUS / "v0" / "shec" / "shec_c=2_k=4_m=3"
    meta = json.loads((entry / "profile.json").read_text())
    codec = registry.factory(meta["plugin"], meta["profile"], device="cpu")
    payload = (entry / "payload.bin").read_bytes()
    n = codec.get_chunk_count()
    stored = {i: (entry / f"chunk.{i}").read_bytes() for i in range(n)}
    assert codec.encode(payload) == stored
    for erased in itertools.chain(itertools.combinations(range(n), 1),
                                  itertools.combinations(range(n), 2)):
        have = {i: c for i, c in stored.items() if i not in erased}
        try:
            out = codec.decode(set(erased), have)
        except ValueError:
            continue  # non-MDS: the shingle search has no system
        assert all(out[e] == stored[e] for e in erased), erased


@pytest.mark.parametrize("tensors", [False, True])
def test_clay_over_shec_matches_reference(rng, tensors):
    """CLAY k=4 m=3 with a SHEC inner code: encode, two-erasure decode
    and single-chunk repair equal ceph_tpu's (tensors run the repair
    kernels' plain forms around the SHEC decode)."""
    port, ref = pair("clay", k=4, m=3, scalar_mds="shec")
    assert port.mds.c == ref.mds.c == 2
    cs = port.get_chunk_size(4 * 1024)
    assert cs == ref.get_chunk_size(4 * 1024)
    data = {i: rng.integers(0, 256, (2, cs), np.uint8) for i in range(4)}
    conv = (lambda v: torch.from_numpy(v)) if tensors else (lambda v: v)
    pp = port.encode_chunks({i: conv(v) for i, v in data.items()})
    pr = ref.encode_chunks(data)
    chunks = {**data, **{j: np.asarray(pr[j]) for j in pr}}
    for j in pr:
        assert np.array_equal(to_numpy(pp[j]), chunks[j])
    # the inner code is not MDS: some erasure pairs have no shingle
    # system, and the port must refuse exactly those
    decoded = 0
    for lost in itertools.combinations(range(7), 2):
        res = []
        for codec, feed in ((port, conv), (ref, lambda v: v)):
            have = {i: feed(v) for i, v in chunks.items() if i not in lost}
            try:
                out = codec.decode_chunks(set(lost), have)
                res.append([to_numpy(out[s]).tobytes() for s in lost])
            except ValueError as e:
                res.append(str(e))
        assert res[0] == res[1], lost
        if isinstance(res[0], list):
            decoded += 1
            assert res[0] == [chunks[s].tobytes() for s in lost]
    assert 0 < decoded < 21
    sub = port.get_sub_chunk_count()
    scs = cs // sub
    for lost in (0, 4, 6):
        plan = port.minimum_to_decode({lost}, set(range(7)) - {lost})
        assert plan == ref.minimum_to_decode({lost}, set(range(7)) - {lost})
        helpers = {h: np.concatenate(
            [chunks[h][:, i * scs:(i + c) * scs] for i, c in runs], axis=-1)
            for h, runs in plan.items()}
        got = port.repair({lost}, {h: conv(v) for h, v in helpers.items()})
        want = ref.repair({lost}, helpers)
        assert np.array_equal(to_numpy(got[lost]), np.asarray(want[lost]))
        assert np.array_equal(to_numpy(got[lost]), chunks[lost])
