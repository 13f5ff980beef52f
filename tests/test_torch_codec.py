"""The port's ISA codecs against the golden corpus and against
ceph_tpu's: encode, every decode pattern up to m erasures at (4,2),
sampled patterns at (8,4), and parity-delta RMW — byte for byte, on the
host route (small numpy input) and on the plain route (CPU tensors and
numpy above the host threshold)."""

import itertools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu.codecs import registry as ref_registry  # noqa: E402
from ceph_tpu_torch.codecs import create_codec, registry  # noqa: E402
from ceph_tpu_torch.codecs.interface import Flag  # noqa: E402
from ceph_tpu_torch.codecs.matrix_codec import (  # noqa: E402
    dispatch_counters,
)
from ceph_tpu_torch.utils import config  # noqa: E402
from ceph_tpu_torch.utils.device import to_numpy  # noqa: E402

CORPUS = Path(__file__).parent / "corpus"
ISA_ENTRIES = sorted(
    p.parent for p in CORPUS.glob("v[01]/isa/*/profile.json")
)


def _pair(profile):
    return (registry.factory("isa", profile, device="cpu"),
            ref_registry.factory("isa", profile))


@pytest.mark.parametrize(
    "entry", ISA_ENTRIES, ids=[f"{p.parent.parent.name}/{p.name}"
                               for p in ISA_ENTRIES])
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
        assert all(out[e] == stored[e] for e in erased)


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy"])
def test_every_decode_pattern_4_2(rng, technique):
    profile = {"k": "4", "m": "2", "technique": technique}
    port, ref = _pair(profile)
    data = {i: rng.integers(0, 256, (2, 512), dtype=np.uint8)
            for i in range(4)}
    parity = port.encode_chunks(data)
    want = ref.encode_chunks(data)
    assert all(np.array_equal(parity[j], np.asarray(want[j]))
               for j in want)
    full = {**data, **{j: np.asarray(v) for j, v in parity.items()}}
    for count in (1, 2):
        for lost in itertools.combinations(range(6), count):
            have = {i: v for i, v in full.items() if i not in lost}
            ref_out = ref.decode_chunks(set(lost), have)
            host = port.decode_chunks(set(lost), have)
            plain = port.decode_chunks(
                set(lost), {i: torch.from_numpy(v) for i, v in have.items()})
            for w in lost:
                assert np.array_equal(host[w], full[w])
                assert np.array_equal(to_numpy(plain[w]), full[w])
                assert np.array_equal(np.asarray(ref_out[w]), full[w])


LOST_8_4 = [(0,), (11,), (0, 3), (2, 9), (0, 3, 9), (0, 3, 9, 11),
            (4, 5, 6, 7), (1, 8, 10, 11)]


def test_sampled_decode_patterns_8_4(rng):
    port, ref = _pair({"k": "8", "m": "4"})
    data = {i: rng.integers(0, 256, (2, 4096), dtype=np.uint8)
            for i in range(8)}
    with config.override(ec_host_dispatch_bytes=0):
        parity = port.encode_chunks(data)  # above the threshold: plain
    full = {**data, **{j: to_numpy(v) for j, v in parity.items()}}
    want = ref.encode_chunks(data)
    assert all(np.array_equal(full[j], np.asarray(want[j])) for j in want)
    for lost in LOST_8_4:
        have = {i: v for i, v in full.items() if i not in lost}
        with config.override(ec_host_dispatch_bytes=0):
            out = port.decode_chunks(set(lost), have)
        ref_out = ref.decode_chunks(set(lost), have)
        for w in lost:
            assert np.array_equal(to_numpy(out[w]), full[w])
            assert np.array_equal(np.asarray(ref_out[w]), full[w])


@pytest.mark.parametrize("host", [True, False])
def test_apply_delta_matches_reference(rng, host):
    port, ref = _pair({"k": "8", "m": "4"})
    old = {i: rng.integers(0, 256, 2048, dtype=np.uint8) for i in range(8)}
    new = dict(old)
    for i in (2, 5):
        new[i] = rng.integers(0, 256, 2048, dtype=np.uint8)
    parity = {j: np.asarray(v) for j, v in ref.encode_chunks(old).items()}
    delta = {i: to_numpy(port.encode_delta(old[i], new[i])) for i in (2, 5)}
    if not host:
        delta = {i: torch.from_numpy(v) for i, v in delta.items()}
    got = port.apply_delta(delta, parity)
    want = ref.apply_delta({i: to_numpy(v) for i, v in delta.items()},
                           parity)
    fresh = ref.encode_chunks(new)
    for j in range(8, 12):
        assert np.array_equal(to_numpy(got[j]), np.asarray(want[j]))
        assert np.array_equal(to_numpy(got[j]), np.asarray(fresh[j]))


def test_routes_are_counted(rng):
    port, _ = _pair({"k": "4", "m": "2"})
    counters = dispatch_counters()
    counters.reset()
    small = {i: rng.integers(0, 256, 256, dtype=np.uint8) for i in range(4)}
    port.encode_chunks(small)
    port.encode_chunks({i: torch.from_numpy(v) for i, v in small.items()})
    with config.override(ec_host_dispatch_bytes=0):
        out = port.encode_chunks(small)
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in out.values())
    got = counters.dump()
    assert got["host_encode"] == 1 and got["plain_encode"] == 2
    assert got["kernel_encode"] == 0


def test_fused_csums_contract(rng):
    port, _ = _pair({"k": "4", "m": "2"})
    counters = dispatch_counters()
    counters.reset()
    data = {i: rng.integers(0, 256, (2, 4096), dtype=np.uint8)
            for i in range(4)}
    parity, csums = port.encode_chunks_with_csums(data, 1024)
    assert csums.dtype == np.uint32 and csums.shape == (2, 6, 4)
    plain = port.encode_chunks(data)
    assert all(np.array_equal(to_numpy(parity[j]), plain[j]) for j in plain)
    assert port.encode_chunks_with_csums(data, 3000) == (None, None)
    assert port.encode_chunks_with_csums(data, 128) == (None, None)
    got = counters.dump()
    assert got["fused_encode"] == 1 and got["fused_fallback"] == 2


def test_registry_and_profile_contract():
    codec = create_codec("isa", device="cpu", k="8", m="4")
    assert (codec.get_chunk_count(), codec.get_data_chunk_count()) == (12, 8)
    assert codec.get_chunk_size(8 * 1000) == 1024  # CHUNK_ALIGN = 128
    assert codec.get_flags() & Flag.PARITY_DELTA_OPTIMIZATION
    # the in-tree plugins are preloaded; ``example`` registers on first
    # use, as in ceph_tpu
    registry.factory("example", {"k": "3"}, device="cpu")
    assert registry.names() == ["clay", "example", "isa", "jerasure", "lrc",
                                "shec", "xor"]
    with pytest.raises(ValueError, match="envelope"):
        registry.factory("isa", {"k": "22", "m": "4"}, device="cpu")
    with pytest.raises(ValueError, match="technique"):
        registry.factory("isa", {"technique": "liberation"}, device="cpu")
    from ceph_tpu_torch.codecs.registry import PluginLoadError

    with pytest.raises(PluginLoadError):
        registry.factory("no_such_plugin", {}, device="cpu")
