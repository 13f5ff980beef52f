"""The frozen reference against the repository's golden corpus and the
CRC32C definition."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ecbench.reference import crc32c, ec, gf

CORPUS = Path(__file__).resolve().parents[2] / "tests" / "corpus" / "v0"


@pytest.mark.parametrize("entry", [
    "jerasure/jerasure_k=4_m=2_technique=reed_sol_van",
    "isa/isa_k=8_m=3_technique=reed_sol_van",
])
def test_generator_matches_corpus(entry):
    d = CORPUS / entry
    prof = json.loads((d / "profile.json").read_text())
    k, m = int(prof["profile"]["k"]), int(prof["profile"]["m"])
    chunks = [(d / f"chunk.{i}").read_bytes() for i in range(k + m)]
    length = len(chunks[0])
    payload = (d / "payload.bin").read_bytes()
    buf = np.zeros(k * length, np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    data = torch.from_numpy(buf.reshape(1, k, length))
    gen = gf.generator(prof["plugin"], prof["profile"]["technique"], k, m)
    shards = torch.cat([data, ec.encode(gen, data)], dim=1)
    for i in range(k + m):
        assert bytes(shards[0, i].numpy()) == chunks[i], f"shard {i}"


def test_generators_are_mds_for_the_configs():
    """Every k-subset of rows inverts: any k shards rebuild the object."""
    import itertools

    for plugin, k, m in (("isa", 8, 4), ("jerasure", 4, 2)):
        g = gf.generator(plugin, "reed_sol_van", k, m)
        assert (g[:k] == np.eye(k, dtype=np.uint8)).all()
        for rows in itertools.combinations(range(k + m), k):
            gf.invert(g[list(rows)])


def test_crc32c_check_value_and_definition():
    # the standard check value: init ~0, final xor ~0
    assert crc32c.crc32c_bitwise(0xFFFFFFFF, b"123456789") ^ 0xFFFFFFFF \
        == 0xE3069283
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (3, 3 * 512), dtype=np.uint8)
    got = crc32c.crc32c(0xFFFFFFFF, torch.from_numpy(data), 512).tolist()
    want = [crc32c.crc32c_bitwise(0xFFFFFFFF, bytes(r)) for r in data]
    assert got == want
    blocks = crc32c.block_crcs(torch.from_numpy(data), 512).tolist()
    assert blocks[0] == [crc32c.crc32c_bitwise(0, bytes(data[0, i:i + 512]))
                         for i in range(0, 3 * 512, 512)]


def test_layout_striping():
    k, unit = 4, 16
    obj = torch.arange(2 * k * unit * 3, dtype=torch.int64).remainder(251) \
        .to(torch.uint8).reshape(2, -1)
    shards = ec.to_shards(obj, k, unit)
    assert shards.shape == (2, k, 3 * unit)
    # shard 1 holds the second unit of every stripe
    assert torch.equal(shards[0, 1, :unit], obj[0, unit:2 * unit])
    assert torch.equal(shards[0, 1, unit:2 * unit],
                       obj[0, k * unit + unit:k * unit + 2 * unit])
    # and every byte lands once
    assert torch.equal(shards.reshape(2, -1).sort().values,
                       obj.sort().values)


def test_hashinfo_matches_bitwise_crc():
    rng = np.random.default_rng(5)
    shards = torch.from_numpy(rng.integers(0, 256, (1, 3, 8192),
                                           dtype=np.uint8))
    h = ec.hashinfo(shards)[0]
    assert h["total_chunk_size"] == 8192
    assert h["hashes"] == [crc32c.crc32c_bitwise(0xFFFFFFFF,
                                                 bytes(shards[0, i].numpy()))
                           for i in range(3)]


@pytest.mark.gpu
def test_reference_on_the_card_equals_the_cpu(cuda):
    rng = np.random.default_rng(9)
    data = torch.from_numpy(rng.integers(0, 256, (2, 8, 1 << 16),
                                         dtype=np.uint8))
    gen = gf.generator("isa", "reed_sol_van", 8, 4)
    cpu = torch.cat([data, ec.encode(gen, data)], dim=1)
    dev = torch.cat([data.to(cuda), ec.encode(gen, data.to(cuda))], dim=1)
    assert torch.equal(cpu, dev.cpu())
    assert ec.hashinfo(cpu) == ec.hashinfo(dev)
