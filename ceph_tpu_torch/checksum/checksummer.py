"""The Checksummer calculate/verify contract, batched on device.

Mirrors src/common/Checksummer.h:196-271: ``calculate`` fills a
per-block value array for a [offset, offset+length) range of a buffer;
``verify`` recomputes and returns the first bad byte offset (or -1)
plus the bad computed checksum. The crc32c family with the reference's
exact value widths (Checksummer.h:63-73): crc32c (u32), crc32c_16
(u16), crc32c_8 (u8), xxhash32 (u32) and xxhash64 (u64).

Defaults match the reference: init_value -1 → all-ones register for
CRC (the BlueStore convention) and all-ones seed for xxhash.

Backend policy: host arrays below ``csum_device_min_bytes`` take the
host scalar path — the launch and the copy dwarf the hash there — and
larger ones go to the Checksummer's device. Tensors are hashed where
they lie: on the card through the CUDA kernel (``csrc/crc32c.cu``), on
the CPU through the plain fold. Every call records which backend
served it (``checksum.backends``); ``Checksummer.last_backend`` exposes
the choice per instance. xxhash has no hand kernel (it is XLA work in
``ceph_tpu``): its PyTorch ops run on the blocks' device, recorded as
``device``. The write path does not pass through here
when the fused encode+csum kernel runs: blob and HashInfo csums then
arrive with the parity, and this facade is the verify tier.
"""

from __future__ import annotations

import numpy as np
import torch

from . import backends
from .crc32c import crc32c_device
from .xxhash import xxh32_device, xxh64_device


def crc32c_scalar(init: int, data) -> int:
    """Host scalar crc32c behind the Checksummer facade — THE
    sanctioned host entry point for code outside ``checksum/`` (the
    stores' blob csums and framed logs import it, never
    ``checksum.host``). Records the ``host`` backend."""
    from .host import crc32c as _host_crc

    if isinstance(data, np.ndarray):
        data = data.tobytes()
    backends.record("host", len(data))
    return _host_crc(init, data)


def _nbytes(blocks) -> int:
    if isinstance(blocks, torch.Tensor):
        return blocks.numel() * blocks.element_size()
    return blocks.nbytes


class _Alg:
    name: str
    value_dtype: np.dtype

    def digest_blocks(self, blocks, init_value: int, device) -> np.ndarray:
        raise NotImplementedError


class _Crc32c(_Alg):
    name = "crc32c"
    value_dtype = np.dtype("<u4")
    mask = 0xFFFFFFFF

    def digest_blocks(self, blocks, init_value, device):
        init = init_value & 0xFFFFFFFF
        if isinstance(blocks, np.ndarray):
            from ceph_tpu_torch.utils import config

            limit = int(config.get("csum_device_min_bytes"))
            if limit > 0 and blocks.nbytes < limit:
                from .host import crc32c as _host_crc

                backends.record("host", blocks.nbytes)
                out = np.fromiter(
                    (
                        _host_crc(init, blocks[i].tobytes())
                        for i in range(blocks.shape[0])
                    ),
                    dtype=np.uint32,
                    count=blocks.shape[0],
                )
                return (out & self.mask).astype(self.value_dtype)
        out = crc32c_device(blocks, init, device)
        return (out & self.mask).astype(self.value_dtype)


class _Crc32c16(_Crc32c):
    name = "crc32c_16"
    value_dtype = np.dtype("<u2")
    mask = 0xFFFF


class _Crc32c8(_Crc32c):
    name = "crc32c_8"
    value_dtype = np.dtype("u1")
    mask = 0xFF


class _XxHash32(_Alg):
    name = "xxhash32"
    value_dtype = np.dtype("<u4")

    def digest_blocks(self, blocks, init_value, device):
        seed = init_value & 0xFFFFFFFF
        backends.record("device", _nbytes(blocks))
        return xxh32_device(blocks, seed, device).astype(self.value_dtype)


class _XxHash64(_Alg):
    name = "xxhash64"
    value_dtype = np.dtype("<u8")

    def digest_blocks(self, blocks, init_value, device):
        seed = init_value & 0xFFFFFFFFFFFFFFFF
        backends.record("device", _nbytes(blocks))
        hi, lo = xxh64_device(blocks, seed, device)
        return (
            (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
        ).astype(self.value_dtype)


CSUM_ALGORITHMS: dict[str, _Alg] = {
    a.name: a() for a in (_Crc32c, _Crc32c16, _Crc32c8, _XxHash32, _XxHash64)
}

# CSumType enum values (Checksummer.h:15-23) for wire/attr parity.
CSUM_TYPE_IDS = {
    "none": 1,
    "xxhash32": 2,
    "xxhash64": 3,
    "crc32c": 4,
    "crc32c_16": 5,
    "crc32c_8": 6,
}


def csum_value_size(alg: str) -> int:
    """Checksummer::get_csum_value_size (Checksummer.h:63-73)."""
    if alg == "none":
        return 0
    return CSUM_ALGORITHMS[alg].value_dtype.itemsize


def _as_blocks(
    data, csum_block_size: int
) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(data, dtype=np.uint8)
    elif isinstance(data, np.ndarray):
        # Reinterpret the underlying BYTES (never value-cast): a csum
        # covers the wire/disk representation, not truncated values.
        buf = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    elif isinstance(data, torch.Tensor):
        # Tensor: hashed where it lies — a blob already on the card
        # verifies in place; only the tiny csum array returns. Same
        # bytes-not-values rule as the host branch.
        buf = data.contiguous().reshape(-1).view(torch.uint8)
    else:
        raise TypeError(f"cannot checksum {type(data).__name__}")
    if len(buf) % csum_block_size:
        raise ValueError(
            f"length {len(buf)} not a multiple of block {csum_block_size}"
        )
    return buf.reshape(-1, csum_block_size)


class Checksummer:
    """Block-checksum facade; one instance per (algorithm, block size),
    like a BlueStore blob's csum settings (bluestore_types.h).

    ``calculate``/``verify`` batch blocks through the backend policy
    at the top of this module; host arrays above the threshold go to
    ``device`` (``"cuda"`` unless the caller asks for the CPU; without
    a card that raises here). After each call ``last_backend`` names
    the backend that actually ran."""

    def __init__(
        self, alg: str, csum_block_size: int = 4096, device="cuda"
    ) -> None:
        from ceph_tpu_torch.utils.device import resolve_device

        if alg not in CSUM_ALGORITHMS:
            raise ValueError(
                f"unknown csum alg {alg!r}; choose from "
                f"{sorted(CSUM_ALGORITHMS)}"
            )
        if csum_block_size & (csum_block_size - 1):
            raise ValueError("csum_block_size must be a power of two")
        self.alg = CSUM_ALGORITHMS[alg]
        self.block_size = csum_block_size
        self.device = resolve_device(device)
        #: backend that served the most recent calculate/verify call
        #: ("host" | "kernel" | "plain" | None)
        self.last_backend: str | None = None

    def calculate(
        self,
        data: "bytes | np.ndarray | torch.Tensor",
        init_value: int = -1,
    ) -> np.ndarray:
        """Per-block checksum array for ``data`` (length must be a
        block multiple — the reference asserts the same,
        Checksummer.h:215)."""
        blocks = _as_blocks(data, self.block_size)
        out = self.alg.digest_blocks(blocks, init_value, self.device)
        self.last_backend = backends.last_backend()
        return out

    def verify(
        self,
        data: "bytes | np.ndarray | torch.Tensor",
        csum_data: np.ndarray,
        offset: int = 0,
        init_value: int = -1,
    ) -> tuple[int, int]:
        """Returns (-1, 0) if clean, else (first bad byte offset,
        computed bad csum) — the verify contract of Checksummer.h:236.
        ``offset`` indexes into csum_data in block units * block_size;
        ``init_value`` must match the one used at calculate time."""
        blocks = _as_blocks(data, self.block_size)
        got = self.alg.digest_blocks(blocks, init_value, self.device)
        self.last_backend = backends.last_backend()
        expect = np.asarray(csum_data, dtype=self.alg.value_dtype)[
            offset // self.block_size : offset // self.block_size
            + blocks.shape[0]
        ]
        bad = np.nonzero(got != expect)[0]
        if bad.size == 0:
            return -1, 0
        first = int(bad[0])
        return offset + first * self.block_size, int(got[first])
