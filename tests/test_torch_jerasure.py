"""The port's jerasure and xor plugins against ceph_tpu's, byte for byte
(tolerance 0), on the CPU: the coding matrices of every technique and
construction, encode, every decode pattern up to m erasures at k=4,
parity delta, the golden corpus (v0 and v1 jerasure entries), the
profile contract, and the liberation slice end to end through
ShardExtentMap with HashInfo, degraded read and RMW. Host arrays at or
below ``ec_host_dispatch_bytes`` take the host route; CPU tensors and
larger host arrays the plain version of the XOR-schedule kernel."""

import itertools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ceph_tpu.pipeline as ref_pl  # noqa: E402
from ceph_tpu.codecs import bitmatrix_codec as ref_bm  # noqa: E402
from ceph_tpu.codecs import registry as ref_registry  # noqa: E402
from ceph_tpu.utils import config as ref_config  # noqa: E402
import ceph_tpu_torch.pipeline as port_pl  # noqa: E402
from ceph_tpu_torch.codecs import bitmatrix_codec as bm  # noqa: E402
from ceph_tpu_torch.codecs import registry  # noqa: E402
from ceph_tpu_torch.codecs.interface import Flag  # noqa: E402
from ceph_tpu_torch.codecs.matrix_codec import (  # noqa: E402
    dispatch_counters,
)
from ceph_tpu_torch.utils import config  # noqa: E402
from ceph_tpu_torch.utils.device import to_numpy  # noqa: E402

CORPUS = Path(__file__).parent / "corpus"
JERASURE_ENTRIES = sorted(
    p.parent for p in CORPUS.glob("v[01]/jerasure/*/profile.json")
)
TECHNIQUES_K4 = [
    {"technique": "reed_sol_van", "k": "4", "m": "2"},
    {"technique": "reed_sol_r6_op", "k": "4", "m": "2"},
    {"technique": "cauchy_orig", "k": "4", "m": "2"},
    {"technique": "cauchy_good", "k": "4", "m": "2"},
    {"technique": "liberation", "k": "4", "m": "2", "w": "7"},
    {"technique": "blaum_roth", "k": "4", "m": "2", "w": "6"},
    {"technique": "liber8tion", "k": "4", "m": "2"},
]
BITMATRIX_PROFILES = [
    {"technique": "liberation", "k": "6", "m": "2", "w": "7"},
    {"technique": "liberation", "k": "4", "m": "2", "w": "7",
     "construction": "v0"},
    {"technique": "liberation", "k": "3", "m": "2", "w": "5"},
    {"technique": "blaum_roth", "k": "4", "m": "2", "w": "6"},
    {"technique": "blaum_roth", "k": "6", "m": "2", "w": "10"},
    {"technique": "liber8tion", "k": "4", "m": "2"},
    {"technique": "liber8tion", "k": "8", "m": "2"},
    {"technique": "liber8tion", "k": "5", "m": "2", "construction": "v0"},
]


def ids(profiles):
    return ["-".join(f"{k}={v}" for k, v in sorted(p.items()))
            for p in profiles]


def pair(profile, plugin="jerasure"):
    return (registry.factory(plugin, dict(profile), device="cpu"),
            ref_registry.factory(plugin, dict(profile)))


def chunk_data(codec, rng, stripes=2):
    n = codec.get_chunk_size(codec.k * 2048)
    return {i: rng.integers(0, 256, (stripes, n), dtype=np.uint8)
            for i in range(codec.k)}


def as_tensors(bufs):
    return {i: torch.from_numpy(np.ascontiguousarray(v))
            for i, v in bufs.items()}


# ------------------------------------------------------------ matrices
@pytest.mark.parametrize("profile", BITMATRIX_PROFILES,
                         ids=ids(BITMATRIX_PROFILES))
def test_coding_bitmatrix_matches_reference(profile):
    port, ref = pair(profile)
    assert port.coding_bitmatrix.tobytes() == ref.coding_bitmatrix.tobytes()
    assert port.w == ref.w


@pytest.mark.parametrize("profile", TECHNIQUES_K4[:4],
                         ids=ids(TECHNIQUES_K4[:4]))
def test_generator_matches_reference(profile):
    port, ref = pair(profile)
    assert np.array_equal(port.generator, ref.generator)


@pytest.mark.parametrize("fn,args", [
    ("raid6_bitmatrix", (4, 7)), ("raid6_bitmatrix", (3, 8)),
    ("liberation_bitmatrix", (7, 7)), ("liberation_bitmatrix", (5, 11)),
    ("blaum_roth_bitmatrix", (4, 4)), ("blaum_roth_bitmatrix", (10, 12)),
    ("sparse_power_bitmatrix", (8, 8)), ("gf2w_power_bitmatrix", (6, 8)),
])
def test_constructions_are_byte_identical(fn, args):
    assert getattr(bm, fn)(*args) == getattr(ref_bm, fn)(*args)


# ---------------------------------------------------- encode / decode
@pytest.mark.parametrize("profile", TECHNIQUES_K4, ids=ids(TECHNIQUES_K4))
def test_encode_matches_reference(rng, profile):
    port, ref = pair(profile)
    data = chunk_data(port, rng)
    want = {j: np.asarray(v) for j, v in ref.encode_chunks(data).items()}
    host = port.encode_chunks(data)
    plain = port.encode_chunks(as_tensors(data))
    with config.override(ec_host_dispatch_bytes=0):
        staged = port.encode_chunks(data)
    for j in want:
        assert isinstance(host[j], np.ndarray)
        assert np.array_equal(host[j], want[j])
        assert np.array_equal(to_numpy(plain[j]), want[j])
        assert np.array_equal(to_numpy(staged[j]), want[j])


@pytest.mark.parametrize("profile", TECHNIQUES_K4, ids=ids(TECHNIQUES_K4))
def test_every_decode_pattern_k4(rng, profile):
    port, ref = pair(profile)
    data = chunk_data(port, rng, stripes=1)
    full = {**data, **{j: np.asarray(v)
                       for j, v in ref.encode_chunks(data).items()}}
    n = port.get_chunk_count()
    for count in (1, 2):
        for lost in itertools.combinations(range(n), count):
            have = {i: v for i, v in full.items() if i not in lost}
            host = port.decode_chunks(set(lost), have)
            plain = port.decode_chunks(set(lost), as_tensors(have))
            ref_out = ref.decode_chunks(set(lost), have)
            for s in lost:
                assert np.array_equal(host[s], full[s]), lost
                assert np.array_equal(to_numpy(plain[s]), full[s]), lost
                assert np.array_equal(np.asarray(ref_out[s]), full[s])


@pytest.mark.parametrize("profile", TECHNIQUES_K4, ids=ids(TECHNIQUES_K4))
@pytest.mark.parametrize("host", [True, False])
def test_apply_delta_matches_reference(rng, profile, host):
    port, ref = pair(profile)
    old = chunk_data(port, rng)
    new = dict(old)
    cols = (1, 3)
    for i in cols:
        new[i] = rng.integers(0, 256, old[i].shape, dtype=np.uint8)
    parity = {j: np.asarray(v) for j, v in ref.encode_chunks(old).items()}
    delta = {i: to_numpy(port.encode_delta(old[i], new[i])) for i in cols}
    got = port.apply_delta(delta if host else as_tensors(delta), parity)
    want = ref.apply_delta(delta, parity)
    fresh = ref.encode_chunks(new)
    for j in parity:
        assert np.array_equal(to_numpy(got[j]), np.asarray(want[j]))
        assert np.array_equal(to_numpy(got[j]), np.asarray(fresh[j]))


def test_routes_are_counted(rng):
    port, _ = pair({"technique": "liberation", "k": "4", "m": "2"})
    counters = dispatch_counters()
    counters.reset()
    data = chunk_data(port, rng, stripes=1)
    port.encode_chunks(data)
    port.encode_chunks(as_tensors(data))
    full = {**data, **port.encode_chunks(data)}
    port.decode_chunks({0}, {i: v for i, v in full.items() if i})
    with config.override(ec_host_dispatch_bytes=0):
        out = port.decode_chunks({0}, {i: v for i, v in full.items() if i})
        port.apply_delta({2: data[2]}, {4: full[4], 5: full[5]})
    assert isinstance(out[0], torch.Tensor) and out[0].device.type == "cpu"
    got = counters.dump()
    assert (got["host_encode"], got["plain_encode"]) == (2, 1)
    assert (got["host_decode"], got["plain_decode"]) == (1, 1)
    assert got["plain_delta"] == 1
    assert all(v == 0 for k, v in got.items() if k.startswith("sched"))


# ------------------------------------------------------------- corpus
@pytest.mark.parametrize(
    "entry", JERASURE_ENTRIES,
    ids=[f"{p.parent.parent.name}/{p.name}" for p in JERASURE_ENTRIES])
def test_corpus_encode_and_decode(entry):
    meta = json.loads((entry / "profile.json").read_text())
    codec = registry.factory(meta["plugin"], meta["profile"], device="cpu")
    payload = (entry / "payload.bin").read_bytes()
    n = codec.get_chunk_count()
    stored = {i: (entry / f"chunk.{i}").read_bytes() for i in range(n)}
    assert codec.encode(payload) == stored
    for erased in itertools.combinations(range(n), 2):
        have = {i: c for i, c in stored.items() if i not in erased}
        out = codec.decode(set(erased), have)
        assert all(out[e] == stored[e] for e in erased), erased


# ----------------------------------------------------- profile contract
def test_profile_contract():
    def make(**kv):
        return registry.factory("jerasure", {k: str(v) for k, v in
                                             kv.items()}, device="cpu")

    lib = make(technique="liberation", k=4, m=2, w=7)
    assert lib.get_chunk_size(4 * 800) == 7 * 128
    assert lib.get_chunk_size(4 * 1000) == 2 * 7 * 128
    assert lib.get_flags() & Flag.PARITY_DELTA_CHUNK_GRANULARITY
    van = make(technique="reed_sol_van", k=4, m=2)
    assert not van.get_flags() & Flag.PARITY_DELTA_CHUNK_GRANULARITY
    assert van.get_chunk_size(4 * 1000) == 1024
    assert make(technique="liberation", k=4, m=2, w=7,
                packetsize=2048).packetsize == 2048
    assert type(make()).__name__ == "ReedSolVan"
    for bad, match in [
        (dict(technique="not_a_technique"), "unknown jerasure technique"),
        (dict(technique="liberation", k=4, m=2, w=6), "prime w"),
        (dict(technique="liberation", k=8, m=2, w=7), "k=8 must be <= w"),
        (dict(technique="liberation", k=4, m=3, w=7), "requires m=2"),
        (dict(technique="blaum_roth", k=4, m=2, w=7), "w\\+1 prime"),
        (dict(technique="liber8tion", k=4, m=2, w=7), "w=8"),
        (dict(technique="liber8tion", k=9, m=2), "k <= 8"),
        (dict(technique="liberation", construction="v9"), "construction"),
        (dict(technique="liberation", packetsize=-1), "packetsize"),
        (dict(technique="reed_sol_r6_op", k=4, m=3), "m=2"),
        (dict(technique="reed_sol_van", w=16), "w=8 only"),
    ]:
        with pytest.raises(ValueError, match=match):
            make(**bad)


# ---------------------------------------------------------- xor plugin
@pytest.mark.parametrize("host", [True, False])
def test_xor_plugin_matches_reference(rng, host):
    port, ref = pair({"k": "3"}, plugin="xor")
    data = {i: rng.integers(0, 256, (4, 1024), np.uint8) for i in range(3)}
    feed = data if host else as_tensors(data)
    parity = port.encode_chunks(feed)
    want = data[0] ^ data[1] ^ data[2]
    assert np.array_equal(to_numpy(parity[3]), want)
    assert np.array_equal(np.asarray(ref.encode_chunks(data)[3]), want)
    full = {**data, 3: want}
    for lost in range(4):
        have = {i: v for i, v in full.items() if i != lost}
        out = port.decode_chunks({lost}, have if host else as_tensors(have))
        assert np.array_equal(to_numpy(out[lost]), full[lost])
    delta = {1: rng.integers(0, 256, (4, 1024), np.uint8)}
    got = port.apply_delta(delta if host else as_tensors(delta),
                           {3: want})
    assert np.array_equal(to_numpy(got[3]), want ^ delta[1])
    with pytest.raises(ValueError, match="m=1"):
        registry.factory("xor", {"k": "3", "m": "2"}, device="cpu")


# ------------------------------------------------- the slice end to end
K, M, W, STRIPES = 6, 2, 7, 3
LOST = (1, 4)


def _run_slice(pl, codec, hinfo, data, chunk):
    """Write with HashInfo, degraded read of LOST, RMW of one chunk of
    data shard 3; returns (stored, rebuilt, rmw parity, hashes)."""
    sinfo = pl.StripeInfo(K, M, K * chunk)
    shard_bytes = STRIPES * chunk
    smap = pl.ShardExtentMap(sinfo)
    streams = data.reshape(STRIPES, K, chunk).transpose(1, 0, 2)
    for r in range(K):
        smap.insert(r, 0, np.ascontiguousarray(streams[r]).reshape(-1))
    smap.encode(codec, hinfo, csum_block=4096)
    stored = {s: smap.get(s, 0, shard_bytes) for s in range(K + M)}
    deg = pl.ShardExtentMap(sinfo)
    for s, buf in stored.items():
        if s not in LOST:
            deg.insert(s, 0, buf)
    deg.decode(codec, set(LOST), K * shard_bytes)
    rebuilt = {s: deg.get(s, 0, shard_bytes) for s in LOST}
    old = pl.ShardExtentMap(sinfo)
    for s, buf in stored.items():
        old.insert(s, 0, buf)
    new = pl.ShardExtentMap(sinfo)
    patch = (np.arange(chunk, dtype=np.uint32) * 7 % 251).astype(np.uint8)
    new.insert(3, chunk, patch)  # the second chunk of data shard 3
    new.encode_parity_delta(codec, old)
    rmw = {s: new.get(s, chunk, chunk) for s in (K, K + 1)}
    return stored, rebuilt, rmw, list(hinfo.cumulative_shard_hashes)


def test_liberation_slice_matches_reference(rng):
    profile = {"technique": "liberation", "k": str(K), "m": str(M),
               "w": str(W)}
    port, ref = pair(profile)
    chunk = W * 1152
    data = rng.integers(0, 256, K * chunk * STRIPES, dtype=np.uint8)
    counters = dispatch_counters()
    counters.reset()
    with config.override(ec_host_dispatch_bytes=0, csum_device_min_bytes=0):
        got = _run_slice(port_pl, port, port_pl.HashInfo(K + M, "cpu"),
                         data, chunk)
    with ref_config.override(ec_host_dispatch_bytes=0):
        want = _run_slice(ref_pl, ref, ref_pl.HashInfo(K + M), data, chunk)
    dump = counters.dump()
    assert dump["plain_encode"] == 1 and dump["plain_decode"] == 1
    assert dump["plain_delta"] == 1
    for g, w in zip(got[:3], want[:3]):
        assert g.keys() == w.keys()
        assert all(np.array_equal(g[s], w[s]) for s in g)
    assert got[3] == want[3]
    assert all(np.array_equal(got[1][s], got[0][s]) for s in LOST)
    # the RMW parity is a fresh encode of the patched stripe
    fresh = port.encode_chunks(
        {i: got[0][i][chunk:2 * chunk] for i in range(K)} |
        {3: (np.arange(chunk, dtype=np.uint32) * 7 % 251).astype(np.uint8)})
    for s in (K, K + 1):
        assert np.array_equal(got[2][s], fresh[s])


@pytest.mark.parametrize("technique", ["liberation", "blaum_roth",
                                       "liber8tion"])
def test_selection_form_and_rejected_decode(rng, technique):
    """ec_sched_opt off runs the selection form to the same bytes; its
    raw-density gate rejects the inverted 2-lost decode matrix, which is
    counted and still served (packet matrices have no other engine)."""
    port, ref = pair({"technique": technique, "k": "4", "m": "2"})
    data = as_tensors(chunk_data(port, rng))
    counters = dispatch_counters()
    parity = port.encode_chunks(data)
    have = {i: v for i, v in {**data, **parity}.items() if i > 1}
    counters.reset()
    with config.override(ec_sched_opt=False):
        raw = port.encode_chunks(data)
        out = port.decode_chunks({0, 1}, have)
    assert all(torch.equal(raw[j], parity[j]) for j in parity)
    assert torch.equal(out[0], data[0]) and torch.equal(out[1], data[1])
    got = counters.dump()
    assert got["sched_rejected_density"] == 1
    assert got["plain_encode"] == 1 and got["plain_decode"] == 1
    ref_out = ref.decode_chunks({0, 1}, {i: v.numpy() for i, v in
                                         have.items()})
    assert np.array_equal(np.asarray(ref_out[0]), data[0].numpy())
