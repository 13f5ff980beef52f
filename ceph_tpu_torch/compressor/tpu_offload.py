"""Accelerator-offloaded compressor — the QAT/UADK plugin role.

The reference ships hardware-offload compression plugins
(compressor/QatAccel.{h,cc}, UADK) behind the same registry as the
software codecs. The offloaded stage here is the batched zero-block
scan: storage blobs are full of zero pages (sparse writes, truncate
tails, the EC zero-padding convention), and finding them is a
bandwidth-bound reduction the card does at memory speed.

``TpuZeroElimCompressor``: split into fixed blocks, reduce an
any-nonzero mask per block on the compressor's device (one reduction
for the whole buffer), emit ``u32 orig_len | u8 flags | bitmap |
nonzero blocks``. ``tpu_zlib`` also runs the surviving blocks through
zlib on the host (the QAT split: scan offloaded, entropy stage on the
host). Buffers below ``DEVICE_THRESHOLD`` are scanned on the host, as
``ceph_tpu`` routes them. The blob format and the registry names are
``ceph_tpu``'s: a blob compressed by either package decompresses in
the other.

On a CUDA device the scan is ``(blocks != 0).any(dim=1)`` on the card,
and a failure there raises: the host answer is never substituted.
``device_masks()`` counts the masks computed on a device.

Decompression is pure host reassembly — a scatter of the stored blocks
into a zero canvas (reads must not require an accelerator).
"""

from __future__ import annotations

import struct
import threading
import zlib

import numpy as np
import torch

from .compressor import Compressor, registry

BLOCK = 256
_HDR = struct.Struct("<IB")  # original length, flags
_FLAG_ZLIB = 0x01

#: below this, the mask computes on the host (the launch and the copy
#: dominate tiny buffers — the ec_host_dispatch_bytes discipline)
DEVICE_THRESHOLD = 1 << 20

_lock = threading.Lock()
_device_masks = 0


def device_masks() -> int:
    """Masks computed by a torch reduction on a device since start."""
    return _device_masks


def _nonzero_mask(blocks: np.ndarray, device: torch.device) -> np.ndarray:
    """[B, BLOCK] -> [B] bool, reduced on ``device`` when the buffer is
    at least ``DEVICE_THRESHOLD`` bytes, else on the host."""
    global _device_masks
    if blocks.nbytes < DEVICE_THRESHOLD:
        return blocks.any(axis=1)
    src = blocks if blocks.flags.writeable else blocks.copy()
    t = torch.from_numpy(src).to(device)
    mask = (t != 0).any(dim=1).cpu().numpy()
    with _lock:
        _device_masks += 1
    return mask


class TpuZeroElimCompressor(Compressor):
    """Zero-block elimination with a device-offloaded scan."""

    name = "tpu_zeroelim"
    _zlib_residue = False

    def _compress(self, data: bytes) -> tuple[bytes, int | None]:
        orig_len = len(data)
        arr = np.frombuffer(data, np.uint8)
        aligned = (orig_len // BLOCK) * BLOCK
        # view of the aligned prefix; only the ragged tail (< BLOCK
        # bytes) is copy-padded
        blocks = arr[:aligned].reshape(-1, BLOCK)
        mask = _nonzero_mask(blocks, self.device)
        parts = [blocks[mask]]
        if aligned != orig_len:
            tail = np.zeros(BLOCK, np.uint8)
            tail[: orig_len - aligned] = arr[aligned:]
            tail_nz = bool(tail.any())
            mask = np.concatenate([mask, np.array([tail_nz])])
            if tail_nz:
                parts.append(tail[None, :])
        residue = np.concatenate(parts).tobytes() if parts else b""
        flags = 0
        if self._zlib_residue:
            flags |= _FLAG_ZLIB
            residue = zlib.compress(residue, 5)
        out = bytearray(_HDR.pack(orig_len, flags))
        out += np.packbits(mask).tobytes()
        out += residue
        return bytes(out), None

    def _decompress(self, data: bytes, msg: int | None) -> bytes:
        # every corruption surfaces as ValueError — the contract the
        # whole compressor family honors
        if len(data) < _HDR.size:
            raise ValueError("zeroelim blob shorter than its header")
        orig_len, flags = _HDR.unpack_from(data, 0)
        nblocks = -(-orig_len // BLOCK)
        bitmap_bytes = -(-nblocks // 8)
        pos = _HDR.size
        if len(data) < pos + bitmap_bytes:
            raise ValueError("zeroelim blob truncated in bitmap")
        mask = np.unpackbits(
            np.frombuffer(data, np.uint8, bitmap_bytes, pos)
        )[:nblocks].astype(bool)
        pos += bitmap_bytes
        residue = data[pos:]
        if flags & _FLAG_ZLIB:
            try:
                residue = zlib.decompress(residue)
            except zlib.error as e:
                raise ValueError(f"corrupt zlib residue: {e}") from e
        stored = np.frombuffer(residue, np.uint8)
        if stored.size != int(mask.sum()) * BLOCK:
            raise ValueError("zeroelim residue length mismatch")
        canvas = np.zeros((nblocks, BLOCK), np.uint8)
        canvas[mask] = stored.reshape(-1, BLOCK)
        return canvas.reshape(-1)[:orig_len].tobytes()


class TpuZlibCompressor(TpuZeroElimCompressor):
    """Device scan + host zlib on the surviving blocks — the QAT
    split: offload the bandwidth stage, keep entropy coding where it
    is cheap."""

    name = "tpu_zlib"
    _zlib_residue = True


registry.register("tpu_zeroelim", TpuZeroElimCompressor)
registry.register("tpu_zlib", TpuZlibCompressor)
