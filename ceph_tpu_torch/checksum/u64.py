"""uint64 arithmetic on int64 tensors — the xxhash64 lanes.

``ceph_tpu`` builds u64 from uint32 pairs because JAX runs with 32-bit
ints. torch has int64 everywhere, but its uint64 dtype lacks most
arithmetic, so a u64 value lives in an int64 tensor with the same 64
bits. ``+``, ``*`` and ``<<`` wrap mod 2^64 in two's complement, which
is exactly uint64 arithmetic on those bits, and ``^`` is bitwise, so
those stay plain operators.
Two things differ: right shift of int64 is arithmetic (``shr`` masks the
copied sign bits off), and constants at or above 2^63 enter as their
signed twins (``from_const``). Comparisons are signed; xxhash needs none.
"""

from __future__ import annotations

import numpy as np
import torch

_M64 = (1 << 64) - 1


def from_const(v: int) -> int:
    """The int64 whose bits are ``v`` mod 2^64."""
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


def mul_const(a: torch.Tensor, c: int) -> torch.Tensor:
    """Low 64 bits of a * constant."""
    return a * from_const(c)


def shr(a: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift."""
    r &= 63
    if r == 0:
        return a
    return (a >> r) & ((1 << (64 - r)) - 1)


def rotl(a: torch.Tensor, r: int) -> torch.Tensor:
    r &= 63
    if r == 0:
        return a
    return (a << r) | shr(a, 64 - r)


def to_numpy_u64(a: torch.Tensor) -> np.ndarray:
    """The tensor's bits as host uint64."""
    return a.detach().cpu().numpy().view(np.uint64)
