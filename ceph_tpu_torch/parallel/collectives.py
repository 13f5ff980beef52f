"""Alternative collective schedules for the EC fan-out: ring parity
accumulation and sequence-parallel CRC.

**Ring parity** (``ring_parity``): the XOR-reduction across the shard
axis as the bandwidth-optimal ring all-reduce — a reduce-scatter phase
(each of sp-1 hops moves ONE 1/sp slice of the parity; after them
device d owns the fully reduced slice (d+1) mod sp) then an all-gather
phase (sp-1 more one-slice hops). The accumulator travels packed
(bytes, never bit planes). Byte-equal to ``sharded_encode``'s
all-reduce; falls back to it when the lane axis does not split into sp
slices. Every hop is a copy into the receiving device's buffer.

**Sequence-parallel CRC32C** (``sharded_crc32c``): one long object's
bytes split across the mesh. CRC is position-dependent, but linear:
each device folds its own slice from a zero register with Kernel C
(``checksum.cuda_crc.crc32c_blocks``), moves the result past the bytes
to its right with the zero-gap transition
(``checksum.crc32c.zero_gap_matrix`` / ``shift_columns``), and the
results XOR together. The init's contribution uses the object's true
length; the object is left-padded with zero bytes to the mesh
granularity, a no-op for a zero-register fold.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ceph_tpu_torch.checksum.crc32c import mat32, zero_gap_matrix

from .mesh import (
    EcMesh,
    cell_partials,
    copy_to,
    gather_rows,
)

#: bytes a device folds in one Kernel C row: a slice runs as
#: ceil(slice / FOLD_BLOCK_MAX) rows of the kernel, joined by shifts
FOLD_BLOCK_MAX = 65536


def ring_schedule(n: int, owned: list[int], parts: list, hop) -> list:
    """The ring reduce-scatter + all-gather over ring positions 0..n-1,
    run for the positions in ``owned`` (``parts[i]`` is position
    ``owned[i]``'s [..., N] partial; N divides by n). ``hop(xs)`` sends
    each owned position's ``xs[i]`` to position + 1 and returns what
    each owned position receives from position - 1, in a new buffer.
    Returns each owned position's full XOR sum."""
    w = parts[0].shape[-1] // n

    def slice_at(x, j):
        return x[..., j * w:(j + 1) * w]

    # reduce-scatter: at step t position d holds the partially reduced
    # slice (d - t) mod n, sends it on, and folds its own part of the
    # slice arriving from d - 1 into it
    carry = [slice_at(p, d).clone() for d, p in zip(owned, parts)]
    for t in range(n - 1):
        carry = [
            got.bitwise_xor_(slice_at(p, (d - t - 1) % n))
            for got, d, p in zip(hop(carry), owned, parts)
        ]
    # all-gather: position d owns slice (d + 1) mod n; circulate them
    outs = []
    for d, p, c in zip(owned, parts, carry):
        out = torch.zeros_like(p)
        slice_at(out, (d + 1) % n).copy_(c)
        outs.append(out)
    moving = carry
    for t in range(n - 1):
        moving = hop(moving)
        for d, out, got in zip(owned, outs, moving):
            slice_at(out, (d - t) % n).copy_(got)
    return outs


def ring_reduce(parts: list[torch.Tensor], devices: list) -> list:
    """``ring_schedule`` over the sp partials ``parts`` of one process,
    device d holding ``parts[d]``: every hop a copy into the receiving
    device's buffer. Returns each device's full XOR sum."""
    sp = len(parts)

    def hop(xs):
        return [copy_to(xs[(d - 1) % sp], devices[d]) for d in range(sp)]

    return ring_schedule(sp, list(range(sp)), parts, hop)


def ring_parity(mesh: EcMesh, bitmatrix, data) -> torch.Tensor:
    """[B, k, N] uint8 -> [B, m, N] parity; the XOR-reduction over
    ``sp`` as a ring reduce-scatter + all-gather."""
    sp = mesh.shape["sp"]
    n = data.shape[-1]
    if sp == 1 or n % sp:
        # no ring to run / lane axis unsliceable: the all-reduce is the
        # schedule
        from .mesh import sharded_encode

        return sharded_encode(mesh, bitmatrix, data)
    parts = cell_partials(mesh, bitmatrix, data)
    rows = [
        ring_reduce(parts[i], mesh.devices[i])[0]
        for i in range(mesh.shape["dp"])
    ]
    return gather_rows(mesh, rows)


def _pick_geometry(total: int, n_dev: int) -> tuple[int, int, int]:
    """(fb, npieces, padded): the fold block is chosen first (padding
    with zeros is free), so awkward lengths never degenerate into tiny
    folds — the object pads up to n_dev * npieces * fb."""
    local = -(-total // n_dev)
    fb = min(FOLD_BLOCK_MAX, max(64, ((local + 63) // 64) * 64))
    npieces = -(-local // fb)
    return fb, npieces, n_dev * npieces * fb


@functools.lru_cache(maxsize=64)
def _shift_stack(gaps: tuple, device: torch.device) -> torch.Tensor:
    """[P, 32, 32] float32 on ``device``: A_g for each gap g in bytes."""
    mats = np.stack([mat32(zero_gap_matrix(int(g))) for g in gaps])
    return torch.from_numpy(mats.astype(np.float32)).to(device)


@functools.lru_cache(maxsize=64)
def _piece_shifts(fb: int, npieces: int, device: torch.device):
    """[P, 32, 32] float32: row p = A_{(P-1-p)*fb}, the powers of A_fb
    (one 32x32 product a piece, not a zero-gap ladder each)."""
    step = mat32(zero_gap_matrix(fb)).astype(np.int64)
    mats = np.empty((npieces, 32, 32), np.float32)
    acc = np.eye(32, dtype=np.int64)
    for p in range(npieces - 1, -1, -1):
        mats[p] = acc
        acc = (step @ acc) & 1
    return torch.from_numpy(mats).to(device)


def _bits(crc: torch.Tensor) -> torch.Tensor:
    """[...] int64 CRC values -> [..., 32] float32 register bits."""
    shifts = torch.arange(32, device=crc.device)
    return ((crc.unsqueeze(-1) >> shifts) & 1).to(torch.float32)


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """[..., 32] 0/1 -> [...] int64."""
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << (
        torch.arange(32, device=bits.device))
    return (bits.to(torch.int64) * weights).sum(-1)


def _shifted(crc: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """XOR over p of A_p @ crc[..., p]: [B, P] int64 -> [B, 32] bits
    (sums stay below 2^24, exact in float32)."""
    acc = torch.einsum("pij,bpj->bi", mats, _bits(crc))
    return torch.remainder(acc, 2)


def sharded_crc32c(
    mesh: EcMesh, data, init: int = 0xFFFFFFFF,
    axes: tuple[str, ...] = ("dp", "sp"),
) -> torch.Tensor:
    """Per-row CRC32C of [B, L] uint8 with the byte axis split across
    the devices of ``axes`` (the whole mesh by default: this op has no
    stripe axis to give ``dp``). Returns [B] int64 CRC values on the
    mesh's output device, equal to Kernel C over the whole rows with
    ``init``."""
    from ceph_tpu_torch.checksum.cuda_crc import crc32c_blocks

    devices = mesh.flat(axes)
    n_dev = len(devices)
    nblocks, total = data.shape
    fb, npieces, padded = _pick_geometry(total, n_dev)
    local = npieces * fb
    pad = padded - total
    out_dev = mesh.out_device
    acc = torch.zeros((nblocks, 32), dtype=torch.float32, device=out_dev)
    for d, dev in enumerate(devices if npieces else []):
        # device d's slice of the left-padded object: [d*local,
        # (d+1)*local) in padded coordinates; the hop is the copy into
        # the device's own buffer
        lo, hi = d * local - pad, (d + 1) * local - pad
        seg = torch.zeros((nblocks, local), dtype=torch.uint8, device=dev)
        a, b = max(lo, 0), max(hi, 0)
        if b > a:
            src = data[:, a:b]
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.ascontiguousarray(src))
            seg[:, a - lo:].copy_(src)
        crcs = crc32c_blocks(seg.reshape(nblocks * npieces, fb), 0)
        # each piece moves past the pieces after it on this device, then
        # the slice's CRC past every later device's slice
        bits = _shifted(crcs.reshape(nblocks, npieces),
                        _piece_shifts(fb, npieces, dev))
        suffix = _shift_stack(((n_dev - 1 - d) * local,), dev)[0]
        bits = torch.remainder(bits @ suffix.T, 2)
        acc += copy_to(bits, out_dev)
    seed = torch.full((nblocks, 1), init & 0xFFFFFFFF, dtype=torch.int64,
                      device=out_dev)
    acc += _shifted(seed, _shift_stack((total,), out_dev))
    return _pack(torch.remainder(acc, 2))
