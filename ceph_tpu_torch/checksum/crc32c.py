"""CRC32C: host matrices, the plain PyTorch fold, and the routed entries.

CRC32C with the reflected Castagnoli polynomial is GF(2)-linear in the
register and the message bits (SURVEY.md §7 "Hard parts"):

    crc(init, msg) = A_L @ init  ⊕  Σ_i  K_i @ bits(chunk_i)

over GF(2), where A_L is the 32x32 zero-message transition for L bytes
and K_i folds chunk i's bits to its final-position remainder. The host
helpers here build those matrices once per size; the plain fold
(``crc32c_fold_plain``) applies them to a batch of blocks with one
float32 einsum of 0/1 operands (exact: counts stay below 2^24), and the
CUDA kernel (``checksum.cuda_crc``, ``csrc/crc32c.cu``) is held against
it. Because ``crc(init, B) = crc(0, B) ^ (A_L @ init)`` for every block
B, both compute zero-init CRCs and XOR one host constant for the seed.

Bit convention is LSB-first everywhere (bit b of byte j sits at index
j*8+b), matching the reflected register order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .reference import crc32c_ref

CHUNK_BYTES = 64  # fold granularity of the plain version


def _bits32(v: int) -> np.ndarray:
    return np.array([(v >> i) & 1 for i in range(32)], dtype=np.uint8)


def _pack32(bits: np.ndarray) -> int:
    return int(sum(int(b) << i for i, b in enumerate(bits)))


@functools.lru_cache(maxsize=None)
def byte_step_matrix() -> bytes:
    """32x32 GF(2) matrix M: register transition for one ZERO byte.
    Column j = register after one zero byte from the unit register e_j."""
    m = np.zeros((32, 32), dtype=np.uint8)
    for j in range(32):
        m[:, j] = _bits32(crc32c_ref(1 << j, b"\x00"))
    return m.tobytes()


def mat32(b: bytes) -> np.ndarray:
    """Decode a ``zero_gap_matrix``/``byte_step_matrix`` payload."""
    return np.frombuffer(b, dtype=np.uint8).reshape(32, 32)


@functools.lru_cache(maxsize=None)
def zero_gap_matrix(nbytes: int) -> bytes:
    """A_n = M^n: transition across n zero bytes (square-and-multiply)."""
    result = np.eye(32, dtype=np.uint8)
    base = mat32(byte_step_matrix())
    n = nbytes
    while n:
        if n & 1:
            result = (result @ base) & 1
        base = (base @ base) & 1
        n >>= 1
    return result.astype(np.uint8).tobytes()


def shift_columns(nbytes: int) -> np.ndarray:
    """A_n as 32 packed uint32 columns (col[j] = A_n @ e_j, bit i =
    row i) — the form the CUDA kernels take their shift matrices in."""
    m = mat32(zero_gap_matrix(nbytes)).astype(np.uint64)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (m * weights[:, None]).sum(axis=0).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def chunk_fold_matrix(c: int = CHUNK_BYTES) -> bytes:
    """B_c [32, c*8]: remainder of a c-byte chunk from zero init.
    Column j*8+b = register after the chunk whose only set bit is bit b
    of byte j."""
    out = np.zeros((32, c * 8), dtype=np.uint8)
    for j in range(c):
        for b in range(8):
            msg = bytearray(c)
            msg[j] = 1 << b
            out[:, j * 8 + b] = _bits32(crc32c_ref(0, bytes(msg)))
    return out.tobytes()


@functools.lru_cache(maxsize=16)
def fold_tensor(block_bytes: int, c: int = CHUNK_BYTES) -> np.ndarray:
    """K [S, 32, c*8] with K_i = A_{(S-1-i)*c} @ B_c."""
    if block_bytes % c:
        raise ValueError(f"block {block_bytes} not a multiple of chunk {c}")
    s = block_bytes // c
    bc = np.frombuffer(chunk_fold_matrix(c), dtype=np.uint8).reshape(32, c * 8)
    k = np.empty((s, 32, c * 8), dtype=np.uint8)
    for i in range(s):
        a = mat32(zero_gap_matrix((s - 1 - i) * c))
        k[i] = (a @ bc) & 1
    return k


def _pick_chunk(block_bytes: int) -> int:
    c = CHUNK_BYTES
    while block_bytes % c:
        c >>= 1
    return c


def crc32c_fold_plain(data: torch.Tensor, init: int) -> torch.Tensor:
    """Plain per-block CRC32C: [B, L] uint8 tensor -> [B] int64 holding
    ``ceph_crc32c(init, block, L)`` in [0, 2^32). Runs on the tensor's
    device; the reference that ``csrc/crc32c.cu`` is held against."""
    nblocks, block_bytes = data.shape
    seed = crc32c_seed_shift(block_bytes, init)
    if nblocks == 0 or block_bytes == 0:
        return torch.full(
            (nblocks,), seed, dtype=torch.int64, device=data.device
        )
    if data.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    c = _pick_chunk(block_bytes)
    k = torch.as_tensor(fold_tensor(block_bytes, c), device=data.device)
    s = k.shape[0]
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    chunks = data.reshape(nblocks, s, c)
    # one einsum per group of chunks whose counts stay below 2^24
    group = max(1, (1 << 21) // c)
    acc = torch.zeros((nblocks, 32), dtype=torch.int64, device=data.device)
    for lo in range(0, s, group):
        part = chunks[:, lo : lo + group]
        bits = ((part[..., None] >> shifts) & 1).reshape(
            nblocks, part.shape[1], c * 8
        )
        counts = torch.einsum(
            "src,bsc->br",
            k[lo : lo + group].to(torch.float32),
            bits.to(torch.float32),
        )
        acc ^= counts.to(torch.int64) & 1
    weights = torch.ones(32, dtype=torch.int64, device=data.device) << (
        torch.arange(32, device=data.device)
    )
    return (acc * weights).sum(dim=-1) ^ seed


def crc32c_device(data, init: int = 0xFFFFFFFF, device="cuda") -> np.ndarray:
    """Per-block CRC32C of ``data`` [..., block_bytes] -> [...] uint32.

    Device analog of ``ceph_crc32c(init, block, len)`` over every
    block. A tensor is hashed where it lies; a host array goes to
    ``device`` first. CUDA tensors run the kernel (the plain fold with
    ``ec_use_kernels`` off), CPU tensors the plain fold."""
    from ceph_tpu_torch.utils import config
    from ceph_tpu_torch.utils.device import resolve_device, to_tensor

    from . import backends
    from .cuda_crc import crc32c_blocks

    if not isinstance(data, torch.Tensor):
        data = to_tensor(data, resolve_device(device))
    block_bytes = int(data.shape[-1])
    lead = tuple(data.shape[:-1])
    flat = data.reshape(-1, block_bytes)
    if flat.is_cuda and config.get("ec_use_kernels"):
        backends.record("kernel", flat.numel())
        out = crc32c_blocks(flat, init)
    else:
        backends.record("plain", flat.numel())
        out = crc32c_fold_plain(flat, init)
    return out.cpu().numpy().astype(np.uint32).reshape(lead)


def crc32c(init: int, data: bytes) -> int:
    """Host scalar API mirroring ``ceph_crc32c`` exactly — including the
    crc-of-zeros fast path the reference gets from crc32c_null
    (common/crc32c.h): runs the matrix transition, no byte loop."""
    if not data:
        return init & 0xFFFFFFFF
    if not any(data):
        return crc32c_seed_shift(len(data), init)
    return crc32c_ref(init, data)


def crc32c_concat(crc_a: int, crc_b_zero_init: int, len_b: int) -> int:
    """crc(A||B) from crc(A) and crc(B with zero init) — the bufferlist
    cached-crc range concatenation (common/crc32c.h, buffer.cc):
    crc(A||B) = A_{len_b} @ crc(A) ⊕ crc_0(B)."""
    return crc32c_seed_shift(len_b, crc_a) ^ crc_b_zero_init


def crc32c_seed_shift(block_bytes: int, init: int) -> int:
    """The constant with crc(init, B) = crc(0, B) ^ shift for EVERY
    block of ``block_bytes`` (linearity: the init register's journey
    through the message is independent of the message bits). The fused
    encode+csum kernel emits ZERO-INIT per-block csums so one launch
    serves every consumer seed — blob csums (seed -1), HashInfo chains,
    wire csums — via this one XOR."""
    return _pack32(
        (mat32(zero_gap_matrix(block_bytes)) @ _bits32(init & 0xFFFFFFFF)) & 1
    )


def crc32c_chain(init: int, block_csums, block_bytes: int) -> int:
    """Fold ZERO-INIT per-block crc32c values into a running register:
    cum' = A_block @ cum ⊕ crc_0(B_i), repeated. How HashInfo seeds
    cumulative shard hashes from fused-kernel csums without touching
    the bytes again."""
    a = mat32(zero_gap_matrix(block_bytes))
    reg = _bits32(init & 0xFFFFFFFF)
    for c0 in np.asarray(block_csums).reshape(-1):
        reg = ((a @ reg) & 1) ^ _bits32(int(c0))
    return _pack32(reg)


def crc32c_stream(data, init: int = 0xFFFFFFFF, device="cuda") -> int:
    """Cumulative crc32c of one byte stream, backend-routed: host scalar
    below ``csum_device_min_bytes``, device-batched fold above — whole
    blocks go through ``crc32c_device`` zero-init and chain via
    ``crc32c_chain``; a ragged tail finishes on the host. Callers chain
    across pieces by passing the previous return as ``init``."""
    from ceph_tpu_torch.utils import config

    from . import backends
    from .host import crc32c as _host_crc

    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(data, dtype=np.uint8)
    else:
        buf = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    n = int(buf.size)
    limit = int(config.get("csum_device_min_bytes"))
    # 0 = always the device, as the option documents (ceph_tpu's copy
    # sends everything to the host at 0); streams shorter than one
    # block have nothing to batch
    if (limit > 0 and n < limit) or n < 4096:
        backends.record("host", n)
        return _host_crc(init, buf.tobytes())
    cb = 65536 if n >= 4 * 65536 else 4096
    nb = n // cb
    c0 = crc32c_device(buf[: nb * cb].reshape(nb, cb), 0, device)
    reg = crc32c_chain(init, c0, cb)
    tail = buf[nb * cb :]
    if tail.size:
        reg = _host_crc(reg, tail.tobytes())
    return reg
