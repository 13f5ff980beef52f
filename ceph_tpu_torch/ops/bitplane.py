"""Plain PyTorch bit-plane GF(2^8) engine — the reference the CUDA
kernels are held against.

The same formulation as ``ceph_tpu.ops.bitplane``: a GF(2^8) matrix
G[R, C] becomes one binary matrix B[8R, 8C] (each entry an 8x8
multiply-by-constant GF(2) block), data bytes become 8 bit planes, and

    out_bits[8R, N] = (B @ data_bits[8C, N]) mod 2

It runs on CPU and CUDA tensors alike: the CPU tests compare it with
the JAX package, and ``chip_smoke.py`` compares the kernels with it on
the card. ``torch.matmul`` has no integer path on CUDA, so the product
takes 0/1 operands in float32 with TF32 off: every count is at most
8*C <= 256, which float32 holds exactly.
"""

from __future__ import annotations

import torch


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """[..., S, N] uint8 -> [..., S*8, N] uint8 bits in {0,1}
    (LSB-first planes). Row s*8+b of the output is bit b of shard s,
    matching ``gf.tables.mul_bitmatrix``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    b = (x[..., :, None, :] >> shifts[:, None]) & 1
    return b.reshape(*x.shape[:-2], x.shape[-2] * 8, x.shape[-1])


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., S*8, N] bits in {0,1} -> [..., S, N] uint8 (LSB-first)."""
    s8, n = bits.shape[-2], bits.shape[-1]
    if s8 % 8:
        raise ValueError(f"bit rows {s8} not a multiple of 8")
    b = bits.reshape(*bits.shape[:-2], s8 // 8, 8, n).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (b << shifts[:, None]).sum(dim=-2, dtype=torch.uint8)


def mod2_matmul(bmat: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(bmat @ bits) mod 2. bmat [R, C] in {0,1}; bits [..., C, N] in
    {0,1}. Exact: 0/1 float32 operands, counts <= C <= 256."""
    if bits.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    acc = torch.matmul(
        bmat.to(device=bits.device, dtype=torch.float32),
        bits.to(torch.float32),
    )
    return (acc.to(torch.int32) & 1).to(torch.uint8)


def gf_encode_bitplane(bitmatrix, data: torch.Tensor) -> torch.Tensor:
    """Apply a GF(2^8) code in bit-plane form.

    ``bitmatrix``: [R*8, S*8] binary (``gf.gf_matrix_to_bitmatrix`` of
    an [R, S] GF matrix), numpy or tensor. ``data``: [..., S, N] uint8.
    Returns [..., R, N] uint8 on ``data``'s device — parity for encode,
    rebuilt shards for decode, contributions for apply_delta."""
    bmat = torch.as_tensor(bitmatrix, device=data.device)
    return pack_bits(mod2_matmul(bmat, unpack_bits(data)))


def xor_bytes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GF(2^8) addition — the encode_delta contract (new XOR old,
    ErasureCodeInterface.h:471)."""
    return torch.bitwise_xor(a, b)


def unpack_bits_lanes(x: torch.Tensor) -> torch.Tensor:
    """[..., C, P] uint8 -> [..., C, P*8] bits, bit planes along lanes.

    Element [..., c, p*8+b] is bit b of byte [..., c, p] (LSB-first)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    b = (x[..., :, :, None] >> shifts) & 1
    return b.reshape(*x.shape[:-1], x.shape[-1] * 8)


def pack_bits_lanes(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of ``unpack_bits_lanes``: [..., C, P*8] -> [..., C, P]."""
    p8 = bits.shape[-1]
    if p8 % 8:
        raise ValueError(f"bit lanes {p8} not a multiple of 8")
    b = bits.reshape(*bits.shape[:-1], p8 // 8, 8).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return (b << shifts).sum(dim=-1, dtype=torch.uint8)


def packet_mod2_apply(bitmatrix, packets: torch.Tensor) -> torch.Tensor:
    """Native bit-matrix codes on the jerasure *packet* layout.

    ``packets``: [..., C, P] uint8, each of the C = k*w rows a packet of
    P bytes (chunk = w consecutive packets). Output row r is the XOR of
    the packets bitmatrix row r selects: unpacking byte bits along the
    lanes keeps the selection one [R, C] mod-2 product (XOR acts on
    each bit lane alone)."""
    bmat = torch.as_tensor(bitmatrix, device=packets.device)
    return pack_bits_lanes(mod2_matmul(bmat, unpack_bits_lanes(packets)))


def gf_mul_const_bytes(c: int, x: torch.Tensor) -> torch.Tensor:
    """Multiply every byte of ``x`` by the GF(2^8) constant ``c``.

    The 8x8 bit matrix of ``c`` is a 1x1 code: on a CUDA tensor it runs
    as one Kernel A launch (``ops.cuda_encode.gf_apply``), on a CPU
    tensor as that wrapper's plain form."""
    from ceph_tpu_torch.gf.tables import mul_bitmatrix

    from .cuda_encode import gf_apply

    flat = x.contiguous().reshape(-1, 1, x.shape[-1])
    return gf_apply(mul_bitmatrix(c), flat).reshape(x.shape)
