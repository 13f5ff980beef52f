"""Codec plugin registry.

The dlopen-free analog of ``ErasureCodePluginRegistry``
(src/erasure-code/ErasureCodePlugin.{h,cc}): a process-wide singleton
mapping plugin name -> factory, with the same tested contract —
version handshake before registration (ErasureCodePlugin.cc:120-178),
factory() caching, ``preload()`` at startup, and typed failures for the
load-path behaviors the reference exercises with fake plugins
(FailToInitialize / FailToRegister / MissingVersion —
src/test/erasure-code/ErasureCodePlugin*.cc).
"""

from __future__ import annotations

import threading
from typing import Callable

from ceph_tpu_torch import PLUGIN_ABI_VERSION

from .interface import ErasureCodec, ErasureCodeProfile


class PluginLoadError(RuntimeError):
    """Load/handshake failures (bad version, missing entry point)."""


class ErasureCodePluginRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._factories: dict[str, Callable[[], ErasureCodec]] = {}
        self._versions: dict[str, str] = {}

    def register(
        self,
        name: str,
        factory: Callable[[], ErasureCodec],
        version: str = PLUGIN_ABI_VERSION,
    ) -> None:
        """The __erasure_code_init entry-point analog. Refuses mismatched
        ABI versions (the __erasure_code_version handshake)."""
        if version != PLUGIN_ABI_VERSION:
            raise PluginLoadError(
                f"plugin {name!r} ABI {version!r} != {PLUGIN_ABI_VERSION!r}"
            )
        with self._lock:
            if name in self._factories:
                raise PluginLoadError(f"plugin {name!r} already registered")
            self._factories[name] = factory
            self._versions[name] = version

    def load(self, name: str) -> None:
        """Import ceph_tpu_torch.codecs.<name> so it can self-register — the
        dlopen("libec_<name>.so") analog."""
        import importlib

        with self._lock:
            if name in self._factories:
                return
        try:
            importlib.import_module(f"ceph_tpu_torch.codecs.{name}")
        except ImportError as e:
            raise PluginLoadError(f"cannot load plugin {name!r}: {e}") from e
        with self._lock:
            if name not in self._factories:
                raise PluginLoadError(
                    f"plugin module {name!r} loaded but did not register"
                )

    def preload(self, names: list[str]) -> None:
        """Daemon-start preload (verified by the reference's standalone
        tests, qa/standalone/erasure-code/test-erasure-code.sh:35)."""
        for n in names:
            self.load(n)

    def factory(
        self, name: str, profile: ErasureCodeProfile, device="cuda"
    ) -> ErasureCodec:
        """Instantiate + init a codec on ``device`` (``"cuda"`` unless
        the caller asks for the CPU; without a card that raises);
        ValueError propagates for invalid profiles (the mon-side
        validation path, OSDMonitor.cc:7714)."""
        self.load(name)
        with self._lock:
            fac = self._factories[name]
        codec = fac()
        codec.set_device(device)
        codec.init(dict(profile))
        return codec

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._factories)


registry = ErasureCodePluginRegistry()


def create_codec(name: str, device="cuda", **profile: str) -> ErasureCodec:
    """Convenience: ``create_codec("isa", k="8", m="4")``."""
    return registry.factory(
        name, {k: str(v) for k, v in profile.items()}, device
    )
