"""Distributed EC: shard fan-out over a (dp, sp) mesh of torch devices.

The reference fans per-shard sub-ops to k+m-1 remote OSDs over
AsyncMessenger (MOSDECSubOpWrite — SURVEY.md section 5.8). ``ceph_tpu``
replaces that with SPMD over a device mesh; this module keeps its
design with one controller in one process:

- axis ``dp`` — stripe batch (data parallel): independent stripes on
  different devices, no communication;
- axis ``sp`` — the shard axis: each device holds a block of the input
  shards and the matching column block of the GF(2) coding matrix, and
  computes that block's partial parity with Kernel A
  (``ops.cuda_encode.gf_apply``); the partials combine across ``sp`` by
  byte XOR.

XOR is addition over GF(2), so the byte XOR of partial parities equals
``ceph_tpu``'s ``psum`` of partial bit counts followed by ``& 1``.

A mesh names its devices outright. ``make_ec_mesh`` takes the box's
physical devices by default and refuses to hand out more than it has;
a caller may instead name the devices itself, the same device more
than once (``devices=["cuda"] * 8``) — the explicit analog of XLA's
forced host device count. Such a mesh records that its devices are
logical, and every hop between two of them is still a copy into the
receiving device's own buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.ops import cuda_encode
from ceph_tpu_torch.utils.device import resolve_device


class EcMesh:
    """A [dp, sp] grid of torch devices, axes named ``dp`` and ``sp``."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: list, dp: int, sp: int) -> None:
        if len(devices) != dp * sp:
            raise ValueError(f"{len(devices)} devices for a {dp}x{sp} mesh")
        self.devices = [list(devices[i * sp:(i + 1) * sp]) for i in range(dp)]
        self.shape = {"dp": dp, "sp": sp}
        #: True when some device appears more than once: the mesh's
        #: devices are logical, several of them one physical device
        self.logical = len(set(devices)) < len(devices)

    @property
    def size(self) -> int:
        return self.shape["dp"] * self.shape["sp"]

    @property
    def out_device(self) -> torch.device:
        """Where results are assembled: device (0, 0)."""
        return self.devices[0][0]

    def flat(self, axes: tuple[str, ...] = ("dp", "sp")) -> list:
        """The devices along ``axes``, row-major; an axis left out is
        held at index 0."""
        rows = range(self.shape["dp"]) if "dp" in axes else [0]
        cols = range(self.shape["sp"]) if "sp" in axes else [0]
        return [self.devices[i][j] for i in rows for j in cols]

    def __repr__(self) -> str:
        kind = "logical" if self.logical else "physical"
        return (f"EcMesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"{kind}, {self.devices[0][0]})")


def _physical_devices(kind: str) -> list:
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device {kind}")


def make_ec_mesh(
    n_devices: int | None = None, k: int = 8, devices=None,
    device="cuda",
) -> EcMesh:
    """Mesh over (dp, sp): sp divides both n_devices and k so the shard
    axis splits evenly; prefer using both axes when possible.

    ``devices`` names the mesh's devices (repeats allowed: logical
    devices); without it the mesh takes the physical devices of
    ``device``'s type, and asking for more than the box has raises
    ``ValueError``."""
    if devices is None:
        avail = _physical_devices(torch.device(device).type)
        n = n_devices or len(avail)
        if n > len(avail):
            raise ValueError(
                f"requested {n} devices but only {len(avail)} available; "
                "a degenerate mesh would silently skip the collective path"
            )
        if n == 0:
            resolve_device(device)  # raises: no CUDA device
        devs = avail[:n]
    else:
        avail = [resolve_device(d) for d in devices]
        n = n_devices or len(avail)
        if n > len(avail):
            raise ValueError(
                f"requested {n} devices but only {len(avail)} named"
            )
        devs = avail[:n]
    # sp must divide BOTH n (for the reshape) and k (for even shard
    # split); prefer the largest such sp that still leaves dp > 1 so
    # both axes are exercised, else fall back to sp = gcd(n, k).
    divisors = [d for d in range(1, n + 1) if n % d == 0 and k % d == 0]
    proper = [d for d in divisors if d < n]
    sp = max(proper) if proper else max(divisors)
    return EcMesh(devs, n // sp, sp)


def copy_to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A hop: ``x`` copied into a new buffer on ``device``, even when
    ``device`` is the one ``x`` lies on."""
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    out.copy_(x)
    return out


def place(data, device: torch.device) -> torch.Tensor:
    """A block of host or device bytes, copied onto ``device``."""
    if isinstance(data, torch.Tensor):
        return copy_to(data, device)
    arr = np.ascontiguousarray(data, dtype=np.uint8)
    return torch.from_numpy(arr.copy()).to(device)


def apply_block(bitmatrix: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Kernel A (``gf_apply``) of an [8R, 8C] bitmatrix over [b, C, N]
    on ``x``'s device; a code wider than the kernel's 32 rows or columns
    runs as several launches whose column groups XOR together."""
    lim = cuda_encode.MAX_ROWS
    r, c = bitmatrix.shape[0] // 8, bitmatrix.shape[1] // 8
    rows = []
    for r0 in range(0, r, lim):
        acc = None
        for c0 in range(0, c, lim):
            part = cuda_encode.gf_apply(
                bitmatrix[r0 * 8:(r0 + lim) * 8, c0 * 8:(c0 + lim) * 8],
                x[:, c0:c0 + lim],
            )
            acc = part if acc is None else acc.bitwise_xor_(part)
        rows.append(acc)
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)


def cell_partials(mesh: EcMesh, bitmatrix, data) -> list[list[torch.Tensor]]:
    """Each (dp, sp) cell's partial parity: its stripe rows and shard
    block placed on its device, times its column block of the matrix.
    [B, k, N] in; cell (i, j) holds [B/dp, R, N]."""
    bm = np.ascontiguousarray(np.asarray(bitmatrix, dtype=np.uint8))
    b, c, _n = data.shape
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if b % dp or c % sp or bm.shape[1] != c * 8:
        raise ValueError(
            f"data {tuple(data.shape)} / bitmatrix {bm.shape} do not split "
            f"over a {dp}x{sp} mesh"
        )
    bb, cb = b // dp, c // sp
    return [
        [
            apply_block(
                bm[:, j * cb * 8:(j + 1) * cb * 8],
                place(data[i * bb:(i + 1) * bb, j * cb:(j + 1) * cb],
                      mesh.devices[i][j]),
            )
            for j in range(sp)
        ]
        for i in range(dp)
    ]


def allreduce_xor(parts: list[torch.Tensor], devices: list) -> list:
    """The all-reduce schedule: every device receives every other
    device's partial (a copy into its buffer) and XORs them; each ends
    with the full sum, as ``psum`` leaves it."""
    out = []
    for d, dev in enumerate(devices):
        acc = parts[d].clone()
        for j, p in enumerate(parts):
            if j != d:
                acc.bitwise_xor_(copy_to(p, dev))
        out.append(acc)
    return out


def gather_rows(mesh: EcMesh, rows: list[torch.Tensor]) -> torch.Tensor:
    """The dp rows' results (one per row) concatenated on the mesh's
    output device."""
    dev = mesh.out_device
    return torch.cat([copy_to(r, dev) for r in rows], dim=0)


def sharded_encode(mesh: EcMesh, bitmatrix, data) -> torch.Tensor:
    """Encode [B, k, N] uint8 -> [B, m, N] parity, stripes sharded over
    ``dp`` and shards over ``sp``, the partials combined by the
    all-reduce schedule. ``bitmatrix`` is the [m*8, k*8] GF(2) coding
    matrix; its column blocks follow the data shards."""
    parts = cell_partials(mesh, bitmatrix, data)
    rows = [
        allreduce_xor(parts[i], mesh.devices[i])[0]
        for i in range(mesh.shape["dp"])
    ]
    return gather_rows(mesh, rows)


def sharded_decode(mesh: EcMesh, dec_bitmatrix, survivors) -> torch.Tensor:
    """Distributed reconstruct: decode is the same GF(2) apply with the
    inverted-submatrix rows, so the survivor axis shards over ``sp``
    and the partials combine the same way. ``survivors`` is [B, k, N]
    (rows matching the decode matrix's columns); returns the missing
    shards."""
    return sharded_encode(mesh, dec_bitmatrix, survivors)


def sharded_pipeline_step(mesh: EcMesh, bitmatrix, data) -> dict:
    """One distributed EC step: encode over the mesh, then the
    per-chunk CRC32C (seed -1) of every parity chunk with Kernel C on
    the output device. Returns {"parity": [B, m, N], "csum": [B, m]}."""
    from ceph_tpu_torch.checksum.cuda_crc import crc32c_blocks

    parity = sharded_encode(mesh, bitmatrix, data)
    b, m, n = parity.shape
    csum = crc32c_blocks(parity.reshape(b * m, n), 0xFFFFFFFF)
    return {"parity": parity, "csum": csum.reshape(b, m)}
