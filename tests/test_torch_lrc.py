"""The port's lrc plugin against ceph_tpu's, byte for byte (tolerance
0), on the CPU: the layer-DSL parse errors, the kml expansion (rs and
xor local parities), encode, every single and double erasure, explicit
layers, the locality-aware minimum_to_decode, the composite generator
against the layered walk, the golden corpus entry, and the inner codecs'
device."""

import itertools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu.codecs import registry as ref_registry  # noqa: E402
from ceph_tpu_torch.codecs import registry  # noqa: E402
from ceph_tpu_torch.utils.device import to_numpy  # noqa: E402

CORPUS = Path(__file__).parent / "corpus" / "v0" / "lrc"
KML = {"k": "4", "m": "2", "l": "3"}
XOR_KML = {**KML, "local_parity": "xor"}
EXPLICIT = {"mapping": "DDD__",
            "layers": json.dumps([["DDDc_", ""], ["DDD_c", ""]])}
PROFILES = [KML, XOR_KML, EXPLICIT]
IDS = ["kml", "kml-xor", "explicit"]


def make(profile):
    return registry.factory(
        "lrc", {k: str(v) for k, v in profile.items()}, device="cpu")


def pair(profile):
    return make(profile), ref_registry.factory("lrc", dict(profile))


def encode_all(port, ref, rng, n=1024, host=True):
    data = {i: rng.integers(0, 256, (2, n), dtype=np.uint8)
            for i in range(port.k)}
    feed = data if host else {i: torch.from_numpy(v)
                              for i, v in data.items()}
    parity = port.encode_chunks(feed)
    want = ref.encode_chunks(dict(data))
    assert parity.keys() == want.keys()
    for j in want:
        assert np.array_equal(to_numpy(parity[j]), np.asarray(want[j]))
    return {**data, **{j: to_numpy(v) for j, v in parity.items()}}


@pytest.mark.parametrize("profile,match", [
    ({"layers": json.dumps([["DD_", ""]])}, "mapping"),
    ({"mapping": "DD_"}, "layers"),
    ({"mapping": "DD_", "layers": "not json"}, "JSON"),
    ({"mapping": "DD_", "layers": json.dumps(["DDc"])}, "array"),
    ({"mapping": "DD_", "layers": json.dumps([[3, ""]])}, "string"),
    ({"mapping": "DD_", "layers": json.dumps([["DDcc", ""]])},
     "characters long"),
    ({"k": 4, "m": 2}, "All of k, m, l"),
    ({"k": 4, "m": 2, "l": 3, "mapping": "DD_"}, "cannot be set"),
    ({"k": 4, "m": 2, "l": 4}, "multiple of l"),
    ({"mapping": "DD__", "layers": json.dumps([["DDc_", ""]])},
     "no layer produces"),
    ({"mapping": "DD__", "layers": json.dumps([["DDDc", ""]])},
     "no earlier layer"),
    ({**KML, "local_parity": "no"}, "local_parity"),
    ({**EXPLICIT, "local_parity": "xor"}, "k/m/l form only"),
])
def test_parse_errors(profile, match):
    with pytest.raises(ValueError, match=match):
        make(profile)


def test_kml_expansion():
    rs, xor = make(KML), make(XOR_KML)
    assert rs.mapping == xor.mapping == "DD__DD__"
    assert (rs.get_data_chunk_count(), rs.get_chunk_count()) == (4, 8)
    assert [ly.profile.get("plugin") for ly in rs.layers] == [None] * 3
    assert [ly.profile.get("plugin") for ly in xor.layers] == \
        [None, "xor", "xor"]
    assert rs.get_chunk_mapping() == make(KML).get_chunk_mapping()
    c = make({"mapping": "DD_", "layers": json.dumps(
        [["DDc", "plugin=jerasure technique=reed_sol_van"]])})
    assert c.get_chunk_count() == 3


def test_inner_codecs_take_the_lrc_device():
    for profile in PROFILES:
        codec = make(profile)
        assert codec.device == torch.device("cpu")
        assert all(ly.codec.device == torch.device("cpu")
                   for ly in codec.layers)


@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
@pytest.mark.parametrize("host", [True, False])
def test_every_single_and_double_erasure(rng, profile, host):
    port, ref = pair(profile)
    full = encode_all(port, ref, rng, host=host)
    n = port.get_chunk_count()
    for count in (1, 2):
        for lost in itertools.combinations(range(n), count):
            have = {i: v for i, v in full.items() if i not in lost}
            feed = have if host else {i: torch.from_numpy(v)
                                      for i, v in have.items()}
            try:
                want = ref.decode_chunks(set(lost), dict(have))
            except ValueError:
                with pytest.raises(ValueError):
                    port.decode_chunks(set(lost), feed)
                continue
            out = port.decode_chunks(set(lost), feed)
            for s in lost:
                assert np.array_equal(to_numpy(out[s]), full[s]), lost
                assert np.array_equal(np.asarray(want[s]), full[s])


@pytest.mark.parametrize("profile", PROFILES, ids=IDS)
def test_minimum_to_decode_matches_reference(profile):
    port, ref = pair(profile)
    n = port.get_chunk_count()
    for want in ({0}, {1}, {0, 3}, set(range(port.k))):
        for lost in itertools.chain(
                itertools.combinations(range(n), 1),
                itertools.combinations(range(n), 2)):
            avail = set(range(n)) - set(lost)
            try:
                ref_plan = ref.minimum_to_decode(set(want), avail)
            except ValueError:
                with pytest.raises(ValueError):
                    port.minimum_to_decode(set(want), avail)
                continue
            assert port.minimum_to_decode(set(want), avail) == ref_plan


def test_local_repair_reads_the_local_group(rng):
    port, ref = pair(XOR_KML)
    full = encode_all(port, ref, rng)
    pos = {port.chunk_mapping[i]: v for i, v in full.items()}
    # the local parity IS the XOR of its group (Azure-LRC layout)
    assert np.array_equal(pos[3], pos[0] ^ pos[1] ^ pos[2])
    plan = port.minimum_to_decode({0}, set(range(8)) - {0})
    assert len(plan) == 3
    out = port.decode_chunks({0}, {s: torch.from_numpy(full[s])
                                   for s in plan})
    assert np.array_equal(out[0].numpy(), full[0])
    with pytest.raises(ValueError):
        port.minimum_to_decode({0}, set(range(8)) - {0, 1, 4, 5})


@pytest.mark.parametrize("profile", [
    KML, XOR_KML, {"mapping": "DD__",
                   "layers": '[["DDc_", ""], ["DD_c", ""]]'}],
    ids=["kml", "kml-xor", "explicit"])
def test_composite_encode_matches_layered(rng, profile):
    codec = make(profile)
    assert codec._composite is not None
    data = {i: rng.integers(0, 256, (3, 2048), np.uint8)
            for i in range(codec.k)}
    comp = codec._encode_composite(dict(data))
    layered = codec._encode_layered(dict(data))
    assert comp.keys() == layered.keys()
    for j in comp:
        assert np.array_equal(to_numpy(comp[j]), to_numpy(layered[j]))


def test_global_parities_shared_by_both_layouts(rng):
    rs, xor = make(KML), make(XOR_KML)
    data = {i: rng.integers(0, 256, (2, 4096), np.uint8) for i in range(4)}
    p_rs, p_xor = rs.encode_chunks(data), xor.encode_chunks(data)
    for g in (4, 5):
        assert np.array_equal(p_rs[g], p_xor[g])


def test_corpus_entry():
    entry = CORPUS / "lrc_k=4_l=3_m=2"
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
