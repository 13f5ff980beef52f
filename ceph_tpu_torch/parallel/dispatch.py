"""Mesh dispatch context: the seam that makes the multi-device tier a
system component instead of a standalone demo.

The reference's distributed backend is the per-shard sub-op fan-out
over AsyncMessenger (MOSDECSubOpWrite). Here the equivalent seam is a
process-wide active mesh (``parallel.mesh.EcMesh``): when one is
installed and the ``ec_use_mesh`` option is on, every bitmatrix
dispatch of the codec tier — encode, decode, parity delta — shards the
stripe batch over ``dp`` and the shard axis over ``sp``, computes each
cell's partial parity with Kernel A and combines them with the ring
XOR schedule (``parallel.collectives.ring_parity``), counted in
``ec_dispatch`` as ``mesh_encode`` / ``mesh_decode`` / ``mesh_delta``
/ ``mesh_fallback``.

A DCN cluster (``parallel.dcn.DcnCluster``) installs the same way and
outranks the mesh for host-staged dispatches (``dcn_*``).

The RMW and read pipelines need no code of their own for this: their
device work flows through ``codec.encode_chunks`` / ``decode_chunks`` /
``apply_delta``, which reach the codec router this module feeds.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

# Process-wide, NOT thread-local: OSD daemons dispatch codec work from
# their connection-reader threads, and those must see the mesh the
# operator installed.
_mesh = None

#: the installed multi-host cluster (parallel/dcn.DcnCluster): when
#: present, host-staged codec dispatches fan out across OS-process
#: hosts — installing it is the opt-in
_dcn = None


def set_mesh(mesh) -> None:
    """Install (or clear) the process-wide EC dispatch mesh."""
    global _mesh
    _mesh = mesh


def get_mesh():
    return _mesh


def set_dcn(cluster) -> None:
    """Install (or clear) the process-wide DCN dispatch cluster."""
    global _dcn
    _dcn = cluster


def get_dcn():
    return _dcn


@contextlib.contextmanager
def use_mesh(mesh):
    """Scoped mesh activation (tests, smoke runs)."""
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


@contextlib.contextmanager
def use_dcn(cluster):
    """Scoped DCN-cluster activation (tests, smoke runs)."""
    prev = get_dcn()
    set_dcn(cluster)
    try:
        yield cluster
    finally:
        set_dcn(prev)


def mesh_supported(mesh, bitmatrix_shape, data_shape) -> bool:
    """Divisibility contract for the sharded route: stripes split over
    ``dp`` (directly, or by folding the lane axis into the batch — the
    bitmatrix apply is lane-independent; parity-delta dispatches arrive
    with batch 1), and bitmatrix columns (= input shards) match the
    data. The shard axis pads with zero shards up to sp (exact in
    GF(2)), and the residual lane axis need not split — ring_parity
    falls back to the all-reduce when it does not."""
    if len(data_shape) != 3:
        return False
    batch, c, n = data_shape
    if bitmatrix_shape[1] != c * 8:
        return False
    dp = mesh.shape.get("dp", 1)
    return batch % dp == 0 or n % dp == 0


def mesh_apply_bitmatrix(mesh, bitmatrix, data):
    """[R*8, C*8] GF(2) bitmatrix over [B, C, N] uint8 shards (host
    array or tensor), stripe batch over ``dp``, shard axis over ``sp``,
    ring-XOR parity combine. Returns [B, R, N] on the mesh's output
    device — the contract of the single-device kernel routes.

    When the batch does not divide ``dp``, the lane axis is folded into
    the batch before the fan-out and unfolded after — exact, because
    the GF(2) apply is independent per lane. When the shard count does
    not divide ``sp`` (a parity delta touching few columns, an odd
    survivor set), zero shards pad it out — zeros contribute nothing
    in GF(2)."""
    from .collectives import ring_parity

    b, c, n = data.shape
    sp = mesh.shape.get("sp", 1)
    bm = np.asarray(bitmatrix, dtype=np.uint8)
    pad = (-c) % sp
    if pad:
        if isinstance(data, torch.Tensor):
            data = torch.cat(
                [data, data.new_zeros((b, pad, n))], dim=1
            )
        else:
            data = np.concatenate(
                [data, np.zeros((b, pad, n), np.uint8)], axis=1
            )
        bm = np.concatenate(
            [bm, np.zeros((bm.shape[0], pad * 8), np.uint8)], axis=1
        )
        c += pad
    dp = mesh.shape.get("dp", 1)
    if b % dp == 0:
        return ring_parity(mesh, bm, data)
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.ascontiguousarray(data))
    folded = (
        data.reshape(b, c, dp, n // dp)
        .permute(0, 2, 1, 3)
        .reshape(b * dp, c, n // dp)
    )
    out = ring_parity(mesh, bm, folded)
    r = out.shape[1]
    return (
        out.reshape(b, dp, r, n // dp)
        .permute(0, 2, 1, 3)
        .reshape(b, r, n)
    )
