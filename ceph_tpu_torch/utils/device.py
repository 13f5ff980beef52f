"""Device choice and host/device conversion at the package's edges.

Entry points take ``device="cuda"`` by default. Without a card that
raises: the plain PyTorch path runs only when the caller asks for the
CPU, so a run on the wrong machine fails loudly instead of measuring
the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and no
    card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_tensor(x, device: torch.device) -> torch.Tensor:
    """uint8 host bytes -> tensor on ``device``; tensors stay where
    they are (they carry their own device)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.ascontiguousarray(x, dtype=np.uint8)
    if not arr.flags.writeable:
        arr = arr.copy()  # torch.from_numpy warns on read-only buffers
    return torch.from_numpy(arr).to(device)


def to_numpy(x) -> np.ndarray:
    """Tensor (any device) or array -> host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
