"""Kernels E and F wrappers: the two elementwise stages of CLAY repair.

The counterpart of ``ceph_tpu/ops/clay_kernels.py``, with the same
argument contracts, served by ``csrc/clay_repair.cu``:

- ``uncoupled_rows(q, strides, kinds, pair_fwd, helpers, r, sc)``: stage
  a. One [B, r*sc] helper array per REAL member of the helper rows, in
  (row, x) order, in; one [B, r*sc] U array per non-aloof member, in the
  same order, out (virtual members included; aloof companions leave the
  helper's own C as the placeholder ``codecs/clay.py`` patches). K8,
  Kernel E.
- ``couple_scatter(q, x_l, kinds, pair_inv, udec, helpers, seq, r,
  sc)``: stage c. The lost row's q decoded U arrays and its real helper
  arrays in, the recovered chunk [B, q*r*sc] out in plane order. K9,
  Kernel F.

``kinds`` marks each member 'r'eal, 'v'irtual (shortened, all zero) or
'a'loof (no bytes); ``strides`` is each helper row's repair-index digit
stride; ``pair_fwd`` / ``pair_inv`` the (self, partner) coefficients of
the member with the larger and the smaller x (``codecs/clay.py``
``_build_kernel_plan``). A CPU tensor takes the plain PyTorch version
(``*_plain``: views, gathers and GF ladders); a CUDA tensor launches
the kernel or raises.

The TPU's gates have no mirror here: ``SB``, ``STEP_BYTES``,
``MAX_REFS``, ``supported``, ``_pick_sb``, ``_pick_lb`` and the sublane
bitcasts sized Pallas blocks for VMEM and the (8, 128) tiling. The CUDA
kernels take any stripe count, any sub-chunk size and any q and t whose
plan fits their parameter block (``MAX_MEMBERS``, ``MAX_Q``); beyond it
the wrapper raises ``ValueError`` instead of routing around the kernel.

The GF(2^8) helpers on uint8 tensors live here too: the plain versions
and the codec's tensor routes share them. ``gf_mul2`` / ``gf_div2`` /
``gf_mul_const`` are ``ceph_tpu/codecs/clay.py``'s ``_gf_mul2`` /
``_gf_div2`` / ``_gf_mul_traced``; ``gf_mul_vec`` serves both
``_gf_mul_planes`` (``dim=-2``) and ``_gf_mul_vec_traced`` (``dim=0``);
``pair_combine`` is the two-coefficient step they build.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_encode import _check_device, _ptr_rows, _rows2d

#: helper-row members ((t-1)*q) Kernel E's parameter block holds
MAX_MEMBERS = 64
#: helper rows (t-1) Kernel E holds
MAX_ROWS = 32
#: lost-row members (q) Kernel F holds
MAX_Q = 32
_KIND = {"r": 0, "v": 1, "a": 2}


# ----------------------------------------------------- GF(2^8) on tensors
def gf_mul2(x: torch.Tensor) -> torch.Tensor:
    """x * 2 in GF(2^8)/0x11D, bytewise on a uint8 tensor."""
    return (x << 1) ^ ((x >> 7) * 0x1D)


def gf_div2(x: torch.Tensor) -> torch.Tensor:
    """x * inv(2) = x * 142."""
    return (x >> 1) ^ ((x & 1) * 0x8E)


def gf_mul_const(c: int, x: torch.Tensor) -> torch.Tensor:
    """x * c for a constant c: the shift/xor ladder, one mul-by-2 step
    per bit of c."""
    if c == 0:
        return torch.zeros_like(x)
    if c == 1:
        return x
    acc = None
    cc = c
    while cc:
        if cc & 1:
            acc = x if acc is None else acc ^ x
        cc >>= 1
        if cc:
            x = gf_mul2(x)
    return acc


def gf_mul_vec(cs, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """x * cs[i] for index i of ``dim``: one ladder over the whole
    tensor, truncated to the bit length of the largest constant."""
    cs = np.asarray(cs, dtype=np.uint8)
    shape = [1] * x.dim()
    shape[dim] = -1
    c = torch.from_numpy(cs.copy()).to(x.device).reshape(shape)
    nbits = max((int(v).bit_length() for v in cs), default=0)
    acc = torch.zeros_like(x)
    for j in range(nbits):
        acc ^= x * ((c >> j) & 1)
        if j < nbits - 1:
            x = gf_mul2(x)
    return acc


def pair_combine(c0: int, c1: int, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """c0*a ^ c1*b; the canonical RS(2,2) coupling pairs (3, 2) and
    (143, 142) fuse to one mul-by-2 or div-by-2 step, as in the kernels
    (3a ^ 2b = a ^ 2(a^b); 143a ^ 142b = a ^ 142(a^b))."""
    if (c0, c1) == (1, 0):
        return a
    if (c0, c1) == (0, 1):
        return b
    if (c0, c1) == (3, 2):
        return a ^ gf_mul2(a ^ b)
    if (c0, c1) == (2, 3):
        return b ^ gf_mul2(a ^ b)
    if (c0, c1) == (143, 142):
        return a ^ gf_div2(a ^ b)
    if (c0, c1) == (142, 143):
        return b ^ gf_div2(a ^ b)
    return gf_mul_const(c0, a) ^ gf_mul_const(c1, b)


# ----------------------------------------------------------- plain forms
def uncoupled_rows_plain(q, strides, kinds, pair_fwd, helpers, r, sc):
    """Stage a in PyTorch: row ri's arrays viewed [B, r/(q*s), q, s, sc]
    put the plane digit on axis 2, so the partner of member x's class zv
    is member zv's class x."""
    b = helpers[0].shape[0]
    it = iter(helpers)
    outs = []
    for ri, row in enumerate(kinds):
        s = strides[ri]
        views = {
            x: next(it).reshape(b, r // (q * s), q, s, sc)
            for x in range(q) if row[x] == "r"
        }
        zero = torch.zeros((b, r // (q * s), s, sc), dtype=torch.uint8,
                           device=helpers[0].device)
        for x in range(q):
            if row[x] == "a":
                continue
            own = views[x] if x in views else None
            cls = []
            for zv in range(q):
                mine = own[:, :, zv] if own is not None else zero
                if zv == x or (own is not None and row[zv] == "a"):
                    cls.append(mine)
                    continue
                mate = views[zv][:, :, x] if zv in views else zero
                c0, c1 = pair_fwd[0] if x > zv else pair_fwd[1]
                cls.append(pair_combine(c0, c1, mine, mate))
            outs.append(torch.stack(cls, dim=2).reshape(b, r * sc))
    return outs


def couple_scatter_plain(q, x_l, kinds, pair_inv, udec, helpers, seq, r, sc):
    """Stage c in PyTorch: the output viewed [B, r/seq, q, seq*sc] holds
    member x's ``seq`` planes of each repair run at index x of axis 2."""
    b = udec[0].shape[0]
    runs = r // seq
    hx = [x for x in range(q) if x != x_l and kinds[x] == "r"]
    hmap = dict(zip(hx, helpers))
    cols = []
    for x in range(q):
        u = udec[x].reshape(b, runs, seq * sc)
        if x == x_l:
            cols.append(u)
            continue
        h = (hmap[x].reshape(b, runs, seq * sc) if x in hmap
             else torch.zeros_like(u))
        c0, c1 = pair_inv[0] if x > x_l else pair_inv[1]
        cols.append(pair_combine(c0, c1, h, u))
    return torch.stack(cols, dim=2).reshape(b, q * r * sc)


# --------------------------------------------------------------- checks
def _rows(arrs, n: int, what: str) -> list:
    rows = [_rows2d(a, n, f"{what} {i}") for i, a in enumerate(arrs)]
    if any(v.shape[0] != rows[0].shape[0] for v in rows):
        raise ValueError(f"{what} arrays differ in stripe count")
    return rows


def _pair_words(pair) -> np.ndarray:
    return np.array([pair[0][0], pair[0][1], pair[1][0], pair[1][1]],
                    dtype=np.int32)


# ------------------------------------------------------------- Kernel E
def uncoupled_rows(q, strides, kinds, pair_fwd, helpers, r, sc):
    """Stage a: one [B, r*sc] array per REAL member in, one U array per
    non-aloof member out, both in (row, x) order."""
    n_real = sum(k == "r" for row in kinds for k in row)
    if len(helpers) != n_real or not helpers:
        raise ValueError(f"{len(helpers)} helper arrays for {n_real} real "
                         "members")
    dev = _check_device(helpers)
    if dev.type == "cpu":
        return uncoupled_rows_plain(q, strides, kinds, pair_fwd, helpers,
                                    r, sc)
    n_rows = len(kinds)
    if n_rows > MAX_ROWS or n_rows * q > MAX_MEMBERS:
        raise ValueError(
            f"Kernel E takes at most {MAX_MEMBERS} helper-row members and "
            f"{MAX_ROWS} rows, got {n_rows} rows of q={q}")
    rows = _rows(helpers, r * sc, "helper")
    b = rows[0].shape[0]
    n_out = sum(k != "a" for row in kinds for k in row)
    outs = [torch.empty((b, r * sc), dtype=torch.uint8, device=dev)
            for _ in range(n_out)]
    if b:
        from ceph_tpu_torch.kernels import CLAY_UNCOUPLED

        ip, ist = _ptr_rows(rows)
        op, ost = _ptr_rows(outs)
        st = np.asarray(strides, dtype=np.int64)
        kd = np.array([_KIND[k] for row in kinds for k in row],
                      dtype=np.int32)
        pw = _pair_words(pair_fwd)
        with torch.cuda.device(dev):
            CLAY_UNCOUPLED(ip.ctypes.data, ist.ctypes.data, len(rows),
                           op.ctypes.data, ost.ctypes.data, n_out, q,
                           n_rows, st.ctypes.data, kd.ctypes.data,
                           pw.ctypes.data, b, r, sc)
    return outs


# ------------------------------------------------------------- Kernel F
def couple_scatter(q, x_l, kinds, pair_inv, udec, helpers, seq, r, sc):
    """Stage c: q decoded lost-row U arrays [B, r*sc] (ascending x) and
    the REAL lost-row helper arrays (ascending x, x_l and virtual
    members absent) in; the recovered chunk [B, q*r*sc] out."""
    hx = [x for x in range(q) if x != x_l and kinds[x] == "r"]
    if len(udec) != q or len(helpers) != len(hx):
        raise ValueError(f"{len(udec)} U and {len(helpers)} helper arrays "
                         f"for q={q} with {len(hx)} real helpers")
    dev = _check_device(list(udec) + list(helpers))
    if dev.type == "cpu":
        return couple_scatter_plain(q, x_l, kinds, pair_inv, udec, helpers,
                                    seq, r, sc)
    if q > MAX_Q:
        raise ValueError(f"Kernel F takes q <= {MAX_Q}, got {q}")
    rows = _rows(list(udec) + list(helpers), r * sc, "U/helper")
    b = rows[0].shape[0]
    out = torch.empty((b, q * r * sc), dtype=torch.uint8, device=dev)
    if b:
        from ceph_tpu_torch.kernels import CLAY_COUPLE_SCATTER

        up, ust = _ptr_rows(rows[:q])
        hp = np.zeros(q, dtype=np.uint64)
        hst = np.zeros(q, dtype=np.int64)
        hptr, hstride = _ptr_rows(rows[q:]) if hx else ((), ())
        for x, p, s in zip(hx, hptr, hstride):
            hp[x], hst[x] = p, s
        pw = _pair_words(pair_inv)
        with torch.cuda.device(dev):
            CLAY_COUPLE_SCATTER(up.ctypes.data, ust.ctypes.data,
                                hp.ctypes.data, hst.ctypes.data, q, x_l,
                                pw.ctypes.data, out.data_ptr(), q * r * sc,
                                b, r, sc, seq)
    return out
