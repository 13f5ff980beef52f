"""The port's compressor family against ceph_tpu's, on the CPU.

Mirrors ``tests/test_compressor.py`` on ``ceph_tpu_torch.compressor``
(every compressor made with ``device="cpu"``), and holds the two
packages to one blob format: the same input compresses to the same
bytes in both, and a blob made by either decompresses in the other.
The zero-block scan's torch reduction (taken at or above
``DEVICE_THRESHOLD``) is checked against the host mask and counted.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu.compressor import registry as ref_registry  # noqa: E402
from ceph_tpu_torch.codecs.registry import PluginLoadError  # noqa: E402
from ceph_tpu_torch.compressor import (  # noqa: E402
    CompressionMode,
    maybe_compress,
    registry,
    tpu_offload,
)
from ceph_tpu_torch.compressor.compressor import (  # noqa: E402
    Hint,
    should_compress,
)

ALL = ["zlib", "bz2", "lzma", "none", "tpu_zeroelim", "tpu_zlib"]


def _create(name):
    return registry.create(name, device="cpu")


def _sparse(rng, pages=40, page=512, tail=b"tail"):
    """Zero pages interleaved with random pages, ragged tail."""
    parts = [
        b"\0" * page if i % 3 else
        rng.integers(0, 256, page, np.uint8).tobytes()
        for i in range(pages)
    ]
    return b"".join(parts) + tail


class TestRoundTrip:
    @pytest.mark.parametrize("name", ["zlib", "bz2", "lzma", "none"])
    def test_round_trip(self, name, rng):
        comp = _create(name)
        data = rng.integers(0, 16, 50_000, np.uint8).tobytes()  # squashy
        out, msg = comp.compress(data)
        assert comp.decompress(out, msg) == data
        if name != "none":
            assert len(out) < len(data)

    @pytest.mark.parametrize("name", ["zlib", "bz2", "lzma"])
    def test_corrupt_input_raises(self, name):
        comp = _create(name)
        with pytest.raises(ValueError):
            comp.decompress(b"\x00garbage\xff" * 10)


class TestRegistry:
    def test_names(self):
        assert set(registry.names()) == set(ref_registry.names()) == set(ALL)

    def test_unknown(self):
        with pytest.raises(PluginLoadError):
            registry.create("snappy9000", device="cpu")

    def test_version_handshake(self):
        with pytest.raises(PluginLoadError, match="ABI"):
            registry.register("old", lambda: None, version="v0")

    def test_created_on_the_asked_device(self):
        assert _create("tpu_zeroelim").device == torch.device("cpu")


class TestModes:
    def test_matrix(self):
        cases = [
            (CompressionMode.NONE, Hint.COMPRESSIBLE, False),
            (CompressionMode.FORCE, Hint.INCOMPRESSIBLE, True),
            (CompressionMode.PASSIVE, Hint.NONE, False),
            (CompressionMode.PASSIVE, Hint.COMPRESSIBLE, True),
            (CompressionMode.AGGRESSIVE, Hint.NONE, True),
            (CompressionMode.AGGRESSIVE, Hint.INCOMPRESSIBLE, False),
        ]
        for mode, hint, want in cases:
            assert should_compress(mode, hint) is want, (mode, hint)


class TestRequiredRatio:
    def test_keeps_compressed_when_worth_it(self):
        comp = _create("zlib")
        data = b"A" * 10_000
        blob, compressed, msg = maybe_compress(comp, data)
        assert compressed and len(blob) < len(data)
        assert comp.decompress(blob, msg) == data

    def test_rejects_incompressible(self, rng):
        comp = _create("zlib")
        data = rng.integers(0, 256, 10_000, np.uint8).tobytes()
        blob, compressed, _ = maybe_compress(comp, data)
        assert not compressed and blob == data

    def test_mode_none_passthrough(self):
        comp = _create("zlib")
        blob, compressed, _ = maybe_compress(
            comp, b"A" * 1000, mode=CompressionMode.NONE
        )
        assert not compressed and blob == b"A" * 1000


class TestZeroElim:
    """The accelerator-offloaded codec: zero-block elimination with the
    scan on the compressor's device, optional zlib residue."""

    def test_round_trip_mixed_content(self, rng):
        for name in ("tpu_zeroelim", "tpu_zlib"):
            comp = _create(name)
            blob = _sparse(rng)
            packed, msg = comp.compress(blob)
            assert len(packed) < len(blob)  # zeros eliminated
            assert comp.decompress(packed, msg) == blob

    def test_all_zero_and_all_random(self, rng):
        comp = _create("tpu_zeroelim")
        zeros = b"\0" * 100_000
        packed, msg = comp.compress(zeros)
        assert len(packed) < 200  # header + bitmap only
        assert comp.decompress(packed, msg) == zeros
        noise = rng.integers(0, 256, 10_000, np.uint8).tobytes()
        packed, msg = comp.compress(noise)
        assert comp.decompress(packed, msg) == noise

    def test_required_ratio_gate_rejects_incompressible(self, rng):
        comp = _create("tpu_zeroelim")
        noise = rng.integers(0, 256, 8_192, np.uint8).tobytes()
        blob, compressed, _msg = maybe_compress(
            comp, noise, required_ratio=0.9
        )
        assert not compressed and blob == noise

    def test_device_and_host_masks_agree(self, rng, monkeypatch):
        blocks = rng.integers(0, 2, (8192, tpu_offload.BLOCK), np.uint8)
        blocks[::4] = 0
        host = blocks.any(axis=1)
        monkeypatch.setattr(tpu_offload, "DEVICE_THRESHOLD", 0)
        before = tpu_offload.device_masks()
        dev = tpu_offload._nonzero_mask(blocks, torch.device("cpu"))
        np.testing.assert_array_equal(host, dev)
        assert tpu_offload.device_masks() == before + 1

    def test_threshold_routes_the_scan(self, rng):
        """At DEVICE_THRESHOLD bytes of whole blocks the scan is a torch
        reduction on the device, one below it stays on the host."""
        comp = _create("tpu_zeroelim")
        big = bytearray(tpu_offload.DEVICE_THRESHOLD)
        big[5000] = 7
        before = tpu_offload.device_masks()
        comp.compress(bytes(big))
        assert tpu_offload.device_masks() == before + 1
        comp.compress(bytes(big[:-tpu_offload.BLOCK]))
        assert tpu_offload.device_masks() == before + 1

    def test_empty_input(self):
        comp = _create("tpu_zeroelim")
        packed, msg = comp.compress(b"")
        assert comp.decompress(packed, msg) == b""

    def test_corrupt_blobs_raise(self):
        comp = _create("tpu_zlib")
        packed, _ = comp.compress(b"\1" * 3000)
        for bad in (packed[:3], packed[:5], packed[:-4] + b"\0\0\0\0"):
            with pytest.raises(ValueError):
                comp.decompress(bad)


def _inputs(rng):
    big = bytearray(3 << 20)  # above DEVICE_THRESHOLD: the torch scan
    big[1 << 20:(1 << 20) + 9000] = rng.integers(
        0, 256, 9000, np.uint8).tobytes()
    return {
        "sparse": _sparse(rng),
        "squashy": rng.integers(0, 16, 50_000, np.uint8).tobytes(),
        "noise": rng.integers(0, 256, 4097, np.uint8).tobytes(),
        "empty": b"",
        "big-half-zero": bytes(big),
    }


@pytest.mark.parametrize("name", ALL)
def test_blobs_equal_and_cross_both_ways(name, rng):
    """Both packages make the same blob from the same bytes, and each
    decompresses the other's."""
    port, ref = _create(name), ref_registry.create(name)
    for label, data in _inputs(rng).items():
        blob_p, msg_p = port.compress(data)
        blob_r, msg_r = ref.compress(data)
        assert (blob_p, msg_p) == (blob_r, msg_r), (name, label)
        assert ref.decompress(blob_p, msg_p) == data, (name, label)
        assert port.decompress(blob_r, msg_r) == data, (name, label)
