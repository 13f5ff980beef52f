"""Published peaks of the cards a run may land on, by the name
``torch.cuda.get_device_name()`` gives. NVIDIA's H100 data sheet, SXM
part: 3.35 TB/s of HBM3 at the full 700 W power limit."""

from __future__ import annotations

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(kind: str) -> float | None:
    return HBM_BYTES_PER_S.get(kind)
