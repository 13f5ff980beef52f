"""The port's plugin registry against ceph_tpu's, on the CPU.

Mirrors ``tests/test_registry.py`` on ``ceph_tpu_torch.codecs.registry``
(the ErasureCodePlugin fake-plugin suite): an unknown plugin, a module
that never registers, an ABI mismatch, a duplicate registration and a
factory whose init raises all fail as the reference's do; preload,
idempotent loads and ``create_codec``; the ``example`` XOR codec over
CPU tensors. The twins compare with ceph_tpu: the same error messages
(bar the ABI strings, which name each package), the same plugin names
after preload, and the example codec's chunks byte for byte.
"""

import importlib
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ceph_tpu_torch import PLUGIN_ABI_VERSION  # noqa: E402,F401
from ceph_tpu_torch.codecs.registry import (  # noqa: E402
    ErasureCodePluginRegistry,
    PluginLoadError,
    registry,
)


class TestLoadFailures:
    def test_unknown_plugin(self):
        with pytest.raises(PluginLoadError, match="cannot load"):
            registry.load("no_such_plugin")

    def test_module_without_registration(self, monkeypatch):
        """A plugin module that imports fine but never registers —
        the MissingEntryPoint analog."""
        mod = types.ModuleType("ceph_tpu_torch.codecs.fake_noreg")
        monkeypatch.setitem(sys.modules, "ceph_tpu_torch.codecs.fake_noreg", mod)
        r = ErasureCodePluginRegistry()
        with pytest.raises(PluginLoadError, match="did not register"):
            r.load("fake_noreg")

    def test_version_mismatch(self):
        """The __erasure_code_version handshake (MissingVersion /
        wrong-version analog)."""
        r = ErasureCodePluginRegistry()
        with pytest.raises(PluginLoadError, match="ABI"):
            r.register("fake_old", lambda: None, version="v0-ancient")

    def test_duplicate_registration(self):
        r = ErasureCodePluginRegistry()
        r.register("dup", lambda: None)
        with pytest.raises(PluginLoadError, match="already registered"):
            r.register("dup", lambda: None)

    def test_fail_to_initialize(self, monkeypatch):
        """Factory whose init raises — FailToInitialize analog: the
        error propagates to the caller (mon-side profile validation)."""
        mod = types.ModuleType("ceph_tpu_torch.codecs.fake_badinit")

        class BadInit:
            def set_device(self, device):
                pass

            def init(self, profile):
                raise ValueError("broken plugin")

        r = ErasureCodePluginRegistry()

        def fake_import(name):
            r.register("fake_badinit", BadInit)
            return mod

        monkeypatch.setitem(
            sys.modules, "ceph_tpu_torch.codecs.fake_badinit", mod
        )
        r.register("fake_badinit", BadInit)
        with pytest.raises(ValueError, match="broken plugin"):
            r.factory("fake_badinit", {}, device="cpu")


class TestPreloadAndCaching:
    def test_preload_all_families(self):
        registry.preload(["jerasure", "isa", "lrc", "shec", "clay"])
        for name in ("jerasure", "isa", "lrc", "shec", "clay"):
            assert name in registry.names()

    def test_load_idempotent(self):
        registry.load("isa")
        registry.load("isa")  # cached, no duplicate-registration error

    def test_create_codec_convenience(self):
        from ceph_tpu_torch.codecs.registry import create_codec

        c = create_codec("isa", device="cpu", k=4, m=2)
        assert c.get_data_chunk_count() == 4


class TestExampleCodec:
    """Base-class behavior against the toy XOR code."""

    def make(self, k=3):
        return registry.factory("example", {"k": str(k)}, device="cpu")

    def test_round_trip_any_single_erasure(self, rng):
        codec = self.make(4)
        data = rng.integers(0, 256, (4, 256), np.uint8)
        parity = codec.encode_chunks(
            {i: torch.from_numpy(data[i]) for i in range(4)}
        )
        chunks = {i: torch.from_numpy(data[i]) for i in range(4)}
        chunks[4] = parity[4]
        for lost in range(5):
            have = {i: c for i, c in chunks.items() if i != lost}
            out = codec.decode_chunks({lost}, have)
            expect = (
                data[lost]
                if lost < 4
                else parity[4].numpy()
            )
            assert (out[lost].numpy() == expect).all(), lost

    def test_double_erasure_rejected(self, rng):
        codec = self.make(3)
        data = rng.integers(0, 256, (3, 64), np.uint8)
        parity = codec.encode_chunks(
            {i: torch.from_numpy(data[i]) for i in range(3)}
        )
        with pytest.raises(ValueError):
            codec.decode_chunks(
                {0, 1}, {2: torch.from_numpy(data[2]), 3: parity[3]}
            )

    def test_byte_level_encode_decode(self, rng):
        codec = self.make(3)
        payload = rng.integers(0, 256, 1000, np.uint8).tobytes()
        chunks = codec.encode(payload)
        assert len(chunks) == 4
        out = codec.decode({1}, {i: c for i, c in chunks.items() if i != 1})
        assert out[1] == chunks[1]

    def test_profile_validation(self):
        with pytest.raises(ValueError):
            self.make(k=1)


# -- twins ---------------------------------------------------------------

def _errors(root):
    reg_mod = importlib.import_module(f"{root}.codecs.registry")
    out = []
    r = reg_mod.ErasureCodePluginRegistry()
    for fn in (lambda: r.load("no_such_plugin"),
               lambda: (r.register("dup", lambda: None),
                        r.register("dup", lambda: None))):
        try:
            fn()
        except reg_mod.PluginLoadError as e:
            out.append(str(e).split(":")[0])
    reg_mod.registry.preload(["jerasure", "isa", "lrc", "shec", "clay",
                              "example"])
    return out + [reg_mod.registry.names()]


def test_load_errors_and_names_equal_the_reference():
    ref, port = _errors("ceph_tpu"), _errors("ceph_tpu_torch")
    assert port == ref
    assert port[0] == "cannot load plugin 'no_such_plugin'"


@pytest.mark.parametrize("k", [2, 3, 5])
def test_example_codec_bytes_equal_the_reference(rng, k):
    payload = rng.integers(0, 256, 1000 * k + 7, np.uint8).tobytes()
    ref = importlib.import_module("ceph_tpu.codecs.registry").registry.factory(
        "example", {"k": str(k)})
    port = registry.factory("example", {"k": str(k)}, device="cpu")
    a, b = ref.encode(payload), port.encode(payload)
    assert {i: bytes(c) for i, c in b.items()} == \
        {i: bytes(c) for i, c in a.items()}
    lost = int(rng.integers(0, k + 1))
    have = {i: c for i, c in b.items() if i != lost}
    assert port.decode({lost}, have)[lost] == a[lost]
