"""Kernel K10 wrapper: the bench's roofline copy, ``out = x ^ 1``.

The counterpart of the Pallas kernel inside root ``bench.py``'s
``_measure_roofline`` (``copy``, bench.py:236-243): a pure copy that
flips one bit of every byte, so its read+write rate is what the card's
memory gives a stream with no other work. ``csrc/copy_probe.cu`` runs
it with 16-byte vector loads and stores over any length. A CPU tensor
takes the plain form; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch


def xor1_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain form: every byte XOR 1, on the tensor's device."""
    return torch.bitwise_xor(x, 1)


def xor1_copy(x: torch.Tensor) -> torch.Tensor:
    """A new uint8 tensor of ``x``'s shape holding ``x ^ 1``."""
    if x.dtype != torch.uint8:
        raise ValueError(f"xor1_copy takes uint8, got {x.dtype}")
    if x.device.type == "cpu":
        return xor1_copy_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("xor1_copy needs a contiguous tensor")
    from ceph_tpu_torch.kernels import XOR1_COPY

    out = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            XOR1_COPY(x.data_ptr(), out.data_ptr(), x.numel())
    return out
