"""Compressor contract + registry + stdlib-backed plugins.

Behavioral mirror of compressor/Compressor.{h,cc}: ``compress``
returns compressed bytes plus an optional integer ``compressor_message``
(the zstd/QAT side-channel slot — Compressor.h:85); ``decompress``
takes it back. Plugins register by name with the ABI handshake the EC
registry uses. ``CompressionMode`` + ``should_compress`` reproduce the
hint logic (COMP_NONE/PASSIVE/AGGRESSIVE/FORCE, Compressor.h:62-67);
``maybe_compress`` applies the required-ratio gate BlueStore uses
before keeping a compressed blob.
"""

from __future__ import annotations

import bz2
import enum
import lzma
import threading
import zlib
from collections.abc import Callable

from ceph_tpu_torch import PLUGIN_ABI_VERSION
from ceph_tpu_torch.codecs.registry import PluginLoadError
from ceph_tpu_torch.utils.device import resolve_device


class CompressionMode(enum.Enum):
    """Compressor.h:62-67."""

    NONE = "none"            # compress never
    PASSIVE = "passive"      # compress if hinted COMPRESSIBLE
    AGGRESSIVE = "aggressive"  # compress unless hinted INCOMPRESSIBLE
    FORCE = "force"          # compress always


class Hint(enum.Enum):
    NONE = "none"
    COMPRESSIBLE = "compressible"
    INCOMPRESSIBLE = "incompressible"


def should_compress(mode: CompressionMode, hint: Hint = Hint.NONE) -> bool:
    if mode is CompressionMode.NONE:
        return False
    if mode is CompressionMode.FORCE:
        return True
    if mode is CompressionMode.PASSIVE:
        return hint is Hint.COMPRESSIBLE
    return hint is not Hint.INCOMPRESSIBLE  # AGGRESSIVE


class Compressor:
    """One algorithm; subclasses implement _compress/_decompress."""

    name = "none"

    def __init__(self, device="cuda") -> None:
        # ``"cuda"`` unless the caller asks for the CPU; without a card
        # that raises. Only the zero-block scan of ``tpu_zeroelim`` /
        # ``tpu_zlib`` runs there; the stdlib algorithms are host work.
        self.device = resolve_device(device)

    def get_type_name(self) -> str:
        return self.name

    def compress(self, data: bytes) -> tuple[bytes, int | None]:
        """-> (compressed, compressor_message)."""
        return self._compress(bytes(data))

    def decompress(
        self, data: bytes, compressor_message: int | None = None
    ) -> bytes:
        return self._decompress(bytes(data), compressor_message)

    # defaults: identity
    def _compress(self, data: bytes) -> tuple[bytes, int | None]:
        return data, None

    def _decompress(self, data: bytes, msg: int | None) -> bytes:
        return data


class ZlibCompressor(Compressor):
    name = "zlib"

    def __init__(self, device="cuda", level: int = 5) -> None:
        super().__init__(device)
        self.level = level

    def _compress(self, data):
        return zlib.compress(data, self.level), None

    def _decompress(self, data, msg):
        try:
            return zlib.decompress(data)
        except zlib.error as e:
            raise ValueError(f"zlib decompress failed: {e}") from e


class Bz2Compressor(Compressor):
    name = "bz2"

    def _compress(self, data):
        return bz2.compress(data), None

    def _decompress(self, data, msg):
        try:
            return bz2.decompress(data)
        except OSError as e:
            raise ValueError(f"bz2 decompress failed: {e}") from e


class LzmaCompressor(Compressor):
    name = "lzma"

    def _compress(self, data):
        return lzma.compress(data), None

    def _decompress(self, data, msg):
        try:
            return lzma.decompress(data)
        except lzma.LZMAError as e:
            raise ValueError(f"lzma decompress failed: {e}") from e


class NoneCompressor(Compressor):
    name = "none"


class CompressorRegistry:
    """CompressionPlugin registry (same handshake as the EC one)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._factories: dict[str, Callable[..., Compressor]] = {}

    def register(
        self,
        name: str,
        factory: Callable[..., Compressor],
        version: str = PLUGIN_ABI_VERSION,
    ) -> None:
        if version != PLUGIN_ABI_VERSION:
            raise PluginLoadError(
                f"compressor {name!r} ABI {version!r} != "
                f"{PLUGIN_ABI_VERSION!r}"
            )
        with self._lock:
            if name in self._factories:
                raise PluginLoadError(
                    f"compressor {name!r} already registered"
                )
            self._factories[name] = factory

    def create(self, name: str, device="cuda") -> Compressor:
        """A new ``name`` compressor bound to ``device`` (see
        ``Compressor``); a factory takes the device as its argument."""
        with self._lock:
            fac = self._factories.get(name)
        if fac is None:
            raise PluginLoadError(f"no compressor {name!r}")
        return fac(device)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._factories)


registry = CompressorRegistry()
registry.register("none", NoneCompressor)
registry.register("zlib", ZlibCompressor)
registry.register("bz2", Bz2Compressor)
registry.register("lzma", LzmaCompressor)


def maybe_compress(
    comp: Compressor,
    data: bytes,
    required_ratio: float = 0.875,
    mode: CompressionMode = CompressionMode.AGGRESSIVE,
    hint: Hint = Hint.NONE,
) -> tuple[bytes, bool, int | None]:
    """Compress-if-worth-it (the bluestore_compression_required_ratio
    gate): returns (blob, compressed?, compressor_message). The blob
    is kept compressed only when len(out) <= ratio * len(in)."""
    if not should_compress(mode, hint) or not data:
        return data, False, None
    out, msg = comp.compress(data)
    if len(out) <= required_ratio * len(data):
        return out, True, msg
    return data, False, None
