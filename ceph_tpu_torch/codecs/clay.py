"""Coupled-Layer (CLAY) MSR regenerating code — the clay plugin.

Behavioral mirror of src/erasure-code/clay/ErasureCodeClay.{h,cc}
(IISc): parameters (k, m, d) with k+1 <= d <= k+m-1. Derived geometry
(ErasureCodeClay.cc:316-348): q = d-k+1, nu pads k+m to a multiple of q
(shortened zero chunks), t = (k+m+nu)/q, and every chunk consists of
``sub_chunk_no = q^t`` sub-chunks ("planes"). Nodes live on a q x t
grid; plane z has a base-q digit vector z_vec[t]; node (x, y) is a
"dot" in plane z when x == z_vec[y], else it pairs with node
(z_vec[y], y) in the companion plane z_sw (digit y swapped to x).

Stored ("coupled") values C and intermediate ("uncoupled") values U are
linked pairwise by an invertible 2x2 GF(2^8) transform, explicit here:
(U_hi, U_lo) = P @ (C_hi, C_lo) where "hi" is the pair member with the
larger x. Across nodes, each plane of U is a codeword of an inner scalar
MDS code (k+nu data, m parity — default jerasure reed_sol_van), built on
this codec's device.

Encode = decode with all parity erased (ErasureCodeClay.cc:141-169).
Single-chunk repair reads only sub_chunk_no/q sub-chunks from each of d
helpers — the MSR property (repair*, ErasureCodeClay.cc:454-699).

Routing is by where the bytes are, as in ``matrix_codec``:

- all numpy at or below ``ec_host_dispatch_bytes``: the host path —
  in-place numpy, ``gf_mul_bytes``, itemized repair;
- all numpy above it: the bytes go to the codec's device as tensors and
  take the tensor path;
- tensors: ``encode_chunks`` / ``decode_chunks`` run the same in-place
  layered engine with torch ops on the tensors' device (one eager op per
  (plane, node) pair transform; the inner decodes take the GF(2^8) apply
  kernel on the card). ``repair`` with ``ec_clay_kernels`` on runs
  stage a on Kernel E, one inner decode per intersection-score group and
  stage c on Kernel F (``_repair_kernels``; CPU tensors take the
  kernels' plain versions); with it off, the whole-tensor route when no
  helper is aloof (``_repair_fast``), the itemized stacked route
  otherwise.

Deltas from the reference: planes of equal intersection score are
independent, so their inner decodes are batched into one call per
score group; pair transforms are closed-form 2-coefficient GF
combinations, not recursive codec calls; ``is_repair`` is enabled (the
reference disables it pending its new-EC refactor,
ErasureCodeClay.cc:356-368; this implements the documented
pre-refactor semantics).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ceph_tpu_torch import PLUGIN_ABI_VERSION
from ceph_tpu_torch.gf import vandermonde_rs_matrix
from ceph_tpu_torch.gf.matrices import gf_invert_matrix, gf_matmul_np
from ceph_tpu_torch.gf.tables import gf_mul_bytes
from ceph_tpu_torch.ops import clay_repair
from ceph_tpu_torch.ops.clay_repair import gf_mul2, gf_mul_vec, pair_combine
from ceph_tpu_torch.utils.device import to_numpy

from .base import CHUNK_ALIGN, ErasureCodeBase, to_int
from .interface import Buffer, ErasureCodeProfile, Flag, SubChunkPlan
from .matrix_codec import BitplaneDispatchMixin
from .registry import registry


def _zeros(shape, like):
    """A zero array beside ``like``: numpy, or a tensor on its device."""
    if isinstance(like, torch.Tensor):
        return torch.zeros(shape, dtype=torch.uint8, device=like.device)
    return np.zeros(shape, np.uint8)


def _pair(c0: int, c1: int, a, b):
    """c0*a ^ c1*b: host GF tables for numpy, fused ladders for tensors."""
    if isinstance(a, np.ndarray):
        return gf_mul_bytes(c0, a) ^ gf_mul_bytes(c1, b)
    return pair_combine(c0, c1, a, b)


class ClayCodec(ErasureCodeBase):
    SCALAR_MDS = ("jerasure", "isa", "shec")

    def init(self, profile: ErasureCodeProfile) -> None:
        self.profile = dict(profile)
        self.k = to_int("k", profile, 4)
        self.m = to_int("m", profile, 2)
        self.d = to_int("d", profile, self.k + self.m - 1)
        self.w = to_int("w", profile, 8)
        if self.k < 2 or self.m < 1:
            raise ValueError(f"k={self.k} must be >= 2 and m={self.m} >= 1")
        if not (self.k + 1 <= self.d <= self.k + self.m - 1):
            raise ValueError(
                f"value of d {self.d} must be within "
                f"[{self.k + 1},{self.k + self.m - 1}]"
            )
        scalar_mds = profile.get("scalar_mds") or "jerasure"
        self.scalar_mds = scalar_mds
        if scalar_mds not in self.SCALAR_MDS:
            raise ValueError(
                f"scalar_mds {scalar_mds!r} is not supported, use one of "
                f"{self.SCALAR_MDS}"
            )
        technique = profile.get("technique") or (
            "reed_sol_van" if scalar_mds in ("jerasure", "isa") else "single"
        )
        self.q = self.d - self.k + 1
        self.nu = (
            0
            if (self.k + self.m) % self.q == 0
            else self.q - (self.k + self.m) % self.q
        )
        if self.k + self.m + self.nu > 254:
            raise ValueError("k + m + nu must be <= 254")
        self.t = (self.k + self.m + self.nu) // self.q
        self.sub_chunk_no = self.q**self.t
        mds_profile = {
            "k": str(self.k + self.nu),
            "m": str(self.m),
            "technique": technique,
            "w": "8",
        }
        if scalar_mds == "shec":
            mds_profile["c"] = "2"
        self.mds = registry.factory(
            scalar_mds, mds_profile, device=self._target_device()
        )
        # Pairwise transform: G4 maps (C_hi, C_lo) -> (C_hi, C_lo,
        # U_hi, U_lo); any 2 of the 4 determine the rest (RS(2,2) MDS).
        self._g4 = vandermonde_rs_matrix(2, 2)  # [4, 2]
        self._pair_cache: dict[tuple, tuple[int, int]] = {}
        #: kernel-repair plans keyed by (lost_node, aloof set): digit
        #: strides, member kinds, pair coefficients, score groups and
        #: B2 patch items, shared by every repair of the same pattern
        self._kernel_plans: dict[tuple, dict] = {}

    # -- geometry ------------------------------------------------------
    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_chunk_size(self, stripe_width: int) -> int:
        # Chunks split into q^t sub-chunks of CHUNK_ALIGN multiples (the
        # sub_chunk_no * k * scalar-alignment rule of
        # ErasureCodeClay.cc:95-101); this fixes the on-disk layout.
        align = self.sub_chunk_no * CHUNK_ALIGN
        per = -(-stripe_width // self.k)
        return -(-per // align) * align

    def get_flags(self) -> Flag:
        flags = Flag.PARTIAL_READ_OPTIMIZATION | Flag.REQUIRE_SUB_CHUNKS
        if self.m == 1:
            flags |= Flag.PARTIAL_WRITE_OPTIMIZATION
        return flags

    # -- plane arithmetic ---------------------------------------------
    def _plane_vector(self, z: int) -> list[int]:
        vec = [0] * self.t
        for i in range(self.t):
            vec[self.t - 1 - i] = z % self.q
            z //= self.q
        return vec

    def _z_sw(self, z: int, x: int, y: int, z_vec: list[int]) -> int:
        return z + (x - z_vec[y]) * self.q ** (self.t - 1 - y)

    # -- pair algebra --------------------------------------------------
    def _pair_coeffs(self, known: tuple[int, int], want: int) -> tuple[int, int]:
        """v[want] = c0*v[known[0]] + c1*v[known[1]] in the 4-tuple
        (C_hi, C_lo, U_hi, U_lo)."""
        key = (known, want)
        if key not in self._pair_cache:
            msub = self._g4[list(known), :]  # [2, 2]
            inv = gf_invert_matrix(msub)
            row = gf_matmul_np(self._g4[want : want + 1, :], inv)[0]
            self._pair_cache[key] = (int(row[0]), int(row[1]))
        return self._pair_cache[key]

    def _pair_solve(self, known: tuple[int, int], a, b, want: int):
        return _pair(*self._pair_coeffs(known, want), a, b)

    def _pair_idx(self, x: int, x_other: int) -> tuple[int, int]:
        """(C index, U index) of the member with coordinate ``x`` in the
        canonical tuple: larger-x member is (0, 2), smaller is (1, 3)."""
        return (0, 2) if x > x_other else (1, 3)

    # -- repair planning (the MSR read-savings surface) ----------------
    def is_repair(self, want_to_read: set[int], available: set[int]) -> bool:
        """True when the fractional-read repair path applies: a single
        lost chunk, all other members of its x-group available, and at
        least d helpers (the documented semantics of
        ErasureCodeClay.cc:356-382 before the upstream disable)."""
        if set(want_to_read) <= set(available):
            return False
        if len(want_to_read) != 1:
            return False
        lost = next(iter(want_to_read))
        lost_node = self._to_node(lost)
        for x in range(self.q):
            node = (lost_node // self.q) * self.q + x
            if self.k <= node < self.k + self.nu:
                continue  # shortened (virtual) node — always "available"
            chunk = self._from_node(node)
            if chunk != lost and chunk not in available:
                return False
        return len(available) >= self.d

    def get_repair_subchunks(self, lost_node: int) -> list[tuple[int, int]]:
        """(index, count) runs of the planes where the lost node is a
        dot: digit y_lost == x_lost (ErasureCodeClay.cc:422-436)."""
        y_lost, x_lost = lost_node // self.q, lost_node % self.q
        seq = self.q ** (self.t - 1 - y_lost)
        out = []
        index = x_lost * seq
        for _ in range(self.q**y_lost):
            out.append((index, seq))
            index += self.q * seq
        return out

    def get_repair_sub_chunk_count(self, want_to_read: set[int]) -> int:
        weights = [0] * self.t
        for node in want_to_read:
            weights[node // self.q] += 1
        remaining = 1
        for y in range(self.t):
            remaining *= self.q - weights[y]
        return self.sub_chunk_no - remaining

    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> SubChunkPlan:
        if self.is_repair(want_to_read, available):
            return self._minimum_to_repair(want_to_read, available)
        return super().minimum_to_decode(want_to_read, available)

    def _minimum_to_repair(
        self, want_to_read: set[int], available: set[int]
    ) -> SubChunkPlan:
        lost = next(iter(want_to_read))
        lost_node = lost if lost < self.k else lost + self.nu
        sub_ind = self.get_repair_subchunks(lost_node)
        minimum: SubChunkPlan = {}
        # Same x-group members first (they are mandatory helpers).
        for j in range(self.q):
            node = (lost_node // self.q) * self.q + j
            if j != lost_node % self.q:
                if node < self.k:
                    minimum[node] = list(sub_ind)
                elif node >= self.k + self.nu:
                    minimum[node - self.nu] = list(sub_ind)
        for chunk in sorted(available):
            if len(minimum) >= self.d:
                break
            if chunk not in minimum and chunk != lost:
                minimum[chunk] = list(sub_ind)
        if len(minimum) != self.d:
            raise ValueError(
                f"cannot repair {lost}: need {self.d} helpers from "
                f"{sorted(available)}"
            )
        return minimum

    # -- node-id mapping (shortening) ---------------------------------
    def _to_node(self, chunk: int) -> int:
        return chunk if chunk < self.k else chunk + self.nu

    def _from_node(self, node: int) -> int:
        return node if node < self.k else node - self.nu

    # -- where the bytes go --------------------------------------------
    def _staged(self, buffers: dict) -> tuple[dict, bool]:
        """(buffers, host): small all-numpy input stays on the host;
        anything else becomes tensors, on the device of the tensors
        given or, for numpy above ``ec_host_dispatch_bytes``, on the
        codec's device."""
        vals = list(buffers.values())
        if BitplaneDispatchMixin._host_sized(*vals):
            return {i: np.asarray(v, np.uint8)
                    for i, v in buffers.items()}, True
        return dict(zip(buffers, self._as_tensors(vals))), False

    @staticmethod
    def _reshaped(arr, shape):
        # always a copy: the engine mutates C in place and must never
        # touch the caller's buffers (a torch reshape may be a view)
        if isinstance(arr, np.ndarray):
            return arr.reshape(shape).astype(np.uint8)
        return arr.reshape(shape).to(dtype=torch.uint8, copy=True)

    # -- encode --------------------------------------------------------
    def encode_chunks(self, data: dict[int, Buffer]) -> dict[int, Buffer]:
        # encode = decode with all parity erased
        data, _host = self._staged(data)
        sample = next(iter(data.values()))
        nbytes = sample.shape[-1]
        if nbytes % self.sub_chunk_no:
            raise ValueError(
                f"chunk bytes {nbytes} not divisible by sub_chunk_no "
                f"{self.sub_chunk_no}"
            )
        sc = nbytes // self.sub_chunk_no
        n = self.q * self.t
        lead = tuple(sample.shape[:-1])
        shape = lead + (self.sub_chunk_no, sc)
        C = {}
        for i in range(self.k):
            C[i] = (self._reshaped(data[i], shape) if i in data
                    else _zeros(shape, sample))
        for i in range(self.k, n):
            C[i] = _zeros(shape, sample)
        self._decode_layered(set(range(self.k + self.nu, n)), C)
        return {
            self.k + j: C[self.k + self.nu + j].reshape(lead + (nbytes,))
            for j in range(self.m)
        }

    # -- full decode ---------------------------------------------------
    def decode_chunks(
        self,
        want_to_read: set[int],
        chunks: dict[int, Buffer],
    ) -> dict[int, Buffer]:
        missing = [s for s in want_to_read if s not in chunks]
        if not missing:
            return {s: chunks[s] for s in want_to_read}
        if len(chunks) < self.k:
            raise ValueError(
                f"cannot decode: {len(chunks)} < k={self.k} chunks"
            )
        staged, _host = self._staged(chunks)
        sample = next(iter(staged.values()))
        nbytes = sample.shape[-1]
        if nbytes % self.sub_chunk_no:
            raise ValueError(
                f"chunk bytes {nbytes} not divisible by sub_chunk_no "
                f"{self.sub_chunk_no}"
            )
        sc = nbytes // self.sub_chunk_no
        lead = tuple(sample.shape[:-1])
        shape = lead + (self.sub_chunk_no, sc)
        C = {}
        erased = set()
        for chunk_id in range(self.k + self.m):
            node = self._to_node(chunk_id)
            if chunk_id in staged:
                C[node] = self._reshaped(staged[chunk_id], shape)
            else:
                C[node] = _zeros(shape, sample)
                erased.add(node)
        for i in range(self.k, self.k + self.nu):
            C[i] = _zeros(shape, sample)
        self._decode_layered(erased, C)
        out = {s: chunks[s] for s in want_to_read if s in chunks}
        for s in missing:
            out[s] = C[self._to_node(s)].reshape(lead + (nbytes,))
        return out

    # -- the layered engine -------------------------------------------
    def _decode_layered(self, erased_chunks: set[int], C: dict) -> None:
        """Recover coupled values of ``erased_chunks`` (node ids) in
        ``C`` in place (decode_layered, ErasureCodeClay.cc:702-767). One
        engine for numpy arrays and tensors alike."""
        q, n = self.q, self.q * self.t
        erased = set(erased_chunks)
        for i in range(self.k + self.nu, n):
            if len(erased) >= self.m:
                break
            erased.add(i)
        if len(erased) > self.m:
            raise ValueError(
                f"too many erasures {sorted(erased_chunks)} for m={self.m}"
            )
        sample = next(iter(C.values()))
        U = {i: _zeros(sample.shape, sample) for i in range(n)}

        # order[z] = number of erased nodes that are dots in plane z.
        order: dict[int, list[int]] = {}
        for z in range(self.sub_chunk_no):
            z_vec = self._plane_vector(z)
            sc_order = sum(1 for i in erased if i % q == z_vec[i // q])
            order.setdefault(sc_order, []).append(z)

        for iscore in sorted(order):
            planes = order[iscore]
            # Step a: uncoupled values of non-erased nodes, plane by
            # plane (pair reads touch companion planes of other groups,
            # already final).
            for z in planes:
                self._compute_uncoupled(erased, z, C, U)
            # Step b: ONE batched inner-MDS decode across this score
            # group (the reference dispatches per plane).
            self._decode_uncoupled_batch(erased, planes, U)
            # Step c: uncoupled -> coupled for erased nodes.
            for z in planes:
                z_vec = self._plane_vector(z)
                for node in sorted(erased):
                    x, y = node % q, node // q
                    node_sw = y * q + z_vec[y]
                    z_sw = self._z_sw(z, x, y, z_vec)
                    if z_vec[y] == x:  # dot: C = U
                        C[node][..., z, :] = U[node][..., z, :]
                    elif node_sw not in erased:
                        # recover_type1: C_xy from (C_sw, U_xy).
                        ci, ui = self._pair_idx(x, z_vec[y])
                        cj, _ = self._pair_idx(z_vec[y], x)
                        C[node][..., z, :] = self._pair_solve(
                            (cj, ui), C[node_sw][..., z_sw, :],
                            U[node][..., z, :], ci,
                        )
                    elif z_vec[y] < x:
                        # Both pair members erased: invert the full
                        # pair transform from (U_xy, U_sw).
                        u_xy = U[node][..., z, :]
                        u_sw = U[node_sw][..., z_sw, :]
                        C[node][..., z, :] = self._pair_solve(
                            (2, 3), u_xy, u_sw, 0)
                        C[node_sw][..., z_sw, :] = self._pair_solve(
                            (2, 3), u_xy, u_sw, 1)

    def _compute_uncoupled(self, erased: set[int], z: int, C: dict,
                           U: dict) -> None:
        """U values of non-erased nodes in plane z (decode_erasures,
        ErasureCodeClay.cc:769-796)."""
        q, t = self.q, self.t
        z_vec = self._plane_vector(z)
        for x in range(q):
            for y in range(t):
                node = q * y + x
                if node in erased:
                    continue
                node_sw = q * y + z_vec[y]
                z_sw = self._z_sw(z, x, y, z_vec)
                if z_vec[y] == x:
                    U[node][..., z, :] = C[node][..., z, :]
                elif z_vec[y] < x or node_sw in erased:
                    # Forward transform of the coupled pair fills the
                    # U of both members.
                    node_c, node_u = self._pair_idx(x, z_vec[y])
                    sw_c, sw_u = self._pair_idx(z_vec[y], x)
                    a = C[node][..., z, :]
                    b = C[node_sw][..., z_sw, :]
                    U[node][..., z, :] = self._pair_solve(
                        (node_c, sw_c), a, b, node_u)
                    U[node_sw][..., z_sw, :] = self._pair_solve(
                        (node_c, sw_c), a, b, sw_u)

    def _decode_uncoupled_batch(self, erased: set[int], planes: list[int],
                                U: dict) -> None:
        """Inner-MDS decode of erased nodes' U over a batch of planes in
        one call (decode_uncoupled, ErasureCodeClay.cc:798-816); also
        the per-score-group decode of the itemized repair. The inner
        codec routes as usual: small host arrays on the host GF tables,
        tensors on the apply kernel (or its plain form on the CPU)."""
        zsel = list(planes)
        known = {
            node: U[node][..., zsel, :]
            for node in range(self.q * self.t)
            if node not in erased
        }
        out = self.mds.decode_chunks(set(erased), known)
        for node in erased:
            val = out[node]
            if isinstance(U[node], np.ndarray):
                val = to_numpy(val)
            U[node][..., zsel, :] = val

    def _inner_decode_shards(self, present: list, want: list,
                             shards: list) -> list:
        """Inner-MDS decode of the ``want`` nodes from the ``present``
        nodes' shards, one output per wanted node. A Reed-Solomon inner
        code applies its cached decode bit-matrix to the shards; a SHEC
        inner code runs its own decode, whose shingle search picks the
        survivors it reads. Both are one GF(2^8) apply (Kernel A on the
        card)."""
        if self.scalar_mds == "shec":
            out = self.mds.decode_chunks(
                set(want), dict(zip(present, shards))
            )
            return [out[nd] for nd in want]
        key = (tuple(present), tuple(want))
        bmat_np = self.mds._tables.get(
            key, lambda: self.mds._build_decode_bmat(present, want)
        )
        return self.mds._dispatch_bitmatrix_shards(bmat_np, shards, "decode")

    # -- fractional repair ---------------------------------------------
    def repair(
        self,
        want_to_read: set[int],
        chunks: dict[int, Buffer],
    ) -> dict[int, Buffer]:
        """Single-chunk repair from d helpers' repair sub-chunks
        (repair + repair_one_lost_chunk, ErasureCodeClay.cc:454-699).

        ``chunks`` maps helper chunk id -> the CONCATENATED repair
        sub-chunks selected by minimum_to_decode (in plane order), any
        leading stripe dims. Returns the full lost chunk: numpy on the
        host path, a tensor on the tensor routes (module docstring).
        """
        if len(want_to_read) != 1 or len(chunks) != self.d:
            raise ValueError(
                f"repair wants 1 chunk from exactly d={self.d} helpers"
            )
        lost = next(iter(want_to_read))
        lost_node = self._to_node(lost)
        chunks, host = self._staged(chunks)

        repair_planes: list[int] = []
        for index, count in self.get_repair_subchunks(lost_node):
            repair_planes.extend(range(index, index + count))
        plane_ind = {z: i for i, z in enumerate(repair_planes)}
        r = len(repair_planes)

        sample = next(iter(chunks.values()))
        if sample.shape[-1] % r:
            raise ValueError(
                f"helper bytes {sample.shape[-1]} not divisible by "
                f"{r} repair planes"
            )
        sc = sample.shape[-1] // r
        lead = tuple(sample.shape[:-1])
        helper = {}
        aloof = set()
        for chunk_id in range(self.k + self.m):
            node = self._to_node(chunk_id)
            if chunk_id in chunks:
                helper[node] = chunks[chunk_id].reshape(lead + (r, sc))
            elif chunk_id != lost:
                aloof.add(node)
        for i in range(self.k, self.k + self.nu):
            helper[i] = _zeros(lead + (r, sc), sample)

        from ceph_tpu_torch.utils import config

        if host:
            recovered = self._repair_itemized(
                lost_node, helper, aloof, repair_planes, plane_ind)
        elif config.get("ec_clay_kernels"):
            recovered = self._repair_kernels(lost_node, helper, aloof, sc)
        elif not aloof:
            recovered = self._repair_fast(
                lost_node, helper, repair_planes, plane_ind)
        else:
            recovered = self._repair_itemized(
                lost_node, helper, aloof, repair_planes, plane_ind)
        return {lost: recovered.reshape(lead + (self.sub_chunk_no * sc,))}

    def _repair_itemized(self, lost_node, helper, aloof, repair_planes,
                         plane_ind):
        """The general repair over numpy (item by item, host GF tables)
        or tensors (each score group's items stacked into one ladder):
        per intersection-score group, the helpers' U, one inner decode
        of the lost row and the aloof nodes, then the lost chunk's
        coupled values."""
        q = self.q
        sample = helper[next(iter(helper))]
        shape = tuple(sample.shape[:-2]) + (self.sub_chunk_no,
                                            sample.shape[-1])
        stacked = isinstance(sample, torch.Tensor)
        recovered = _zeros(shape, sample)
        U = {i: _zeros(shape, sample) for i in range(q * self.t)}

        # Erasures for the uncoupled decode: the lost node's whole
        # x-row plus the aloof nodes.
        erasures = {lost_node - lost_node % q + i for i in range(q)}
        erasures |= aloof
        if len(erasures) > self.m:
            raise ValueError(
                f"repair infeasible: {len(erasures)} uncoupled erasures "
                f"> m={self.m}"
            )

        # Order repair planes by intersection score w.r.t. the lost
        # node and aloof nodes.
        ordered: dict[int, list[int]] = {}
        for z in repair_planes:
            z_vec = self._plane_vector(z)
            o = sum(
                1
                for nd in ({lost_node} | aloof)
                if nd % q == z_vec[nd // q]
            )
            if o <= 0:
                raise AssertionError("repair plane with zero order")
            ordered.setdefault(o, []).append(z)

        for o in sorted(ordered):
            planes = ordered[o]
            uitems, citems = self._plan_repair_group(
                planes, erasures, aloof, lost_node
            )
            if stacked:
                self._exec_uitems_stacked(uitems, helper, U, plane_ind)
            else:
                for (node, z, c0, c1, asrc, bsrc) in uitems:
                    a = self._item_slice(asrc, helper, U, plane_ind)
                    b = self._item_slice(bsrc, helper, U, plane_ind)
                    U[node][..., z, :] = (
                        a if (c0, c1) == (1, 0) else _pair(c0, c1, a, b))
            # Batched uncoupled decode over this order group.
            self._decode_uncoupled_batch(erasures, planes, U)
            # Convert: recover coupled values of the lost chunk.
            if stacked:
                self._exec_citems_stacked(
                    citems, helper, U, plane_ind, recovered)
            else:
                for (zdst, c0, c1, asrc, bsrc) in citems:
                    a = self._item_slice(asrc, helper, U, plane_ind)
                    b = self._item_slice(bsrc, helper, U, plane_ind)
                    recovered[..., zdst, :] = (
                        a if (c0, c1) == (1, 0) else _pair(c0, c1, a, b))
        return recovered

    # -- fast repair (aloof-free: d = k+m-1) ---------------------------
    def _repair_fast(self, lost_node: int, helper: dict,
                     repair_planes: list, plane_ind: dict):
        """Whole-tensor repair for the aloof-free case. With d = k+m-1
        every helper node is present, every repair plane has
        intersection score 1, and the pair algebra reduces to
        per-plane-constant GF ladders:

        a. For each row y != y_lost, the q helpers' uncoupled values
           are c0(z)*h[x][z] ^ c1(z)*h[x'][z'] where (x', z') is a
           static permutation of the same row's (helper, plane) grid —
           one stack, one gather and one fused pair step per row.
        b. The lost ROW's uncoupled values come from ONE inner-MDS
           decode with the plane axis folded into the byte axis.
        c. The lost chunk's q^t coupled planes are a static
           permutation of q per-row-member pair combinations.

        Matches repair_one_lost_chunk (ErasureCodeClay.cc:454-699)
        restricted to aloof == {}; the itemized path keeps the general
        case."""
        q, t, n = self.q, self.t, self.q * self.t
        y_l, x_l = lost_node // q, lost_node % q
        P = len(repair_planes)
        pvecs = [self._plane_vector(z) for z in repair_planes]
        sc = helper[next(iter(helper))].shape[-1]
        dev = helper[next(iter(helper))].device

        # -- a: uncoupled values of every non-lost row ---------------
        row_u: list = []  # Uy per non-lost row, ascending y
        for y in range(t):
            if y == y_l:
                continue
            Hy = torch.stack(
                [helper[y * q + x] for x in range(q)], dim=-3
            )  # [..., q, P, sc]
            lead = Hy.shape[:-3]
            flat = Hy.reshape(lead + (q * P, sc))
            c0s = np.zeros(q * P, np.uint8)
            c1s = np.zeros(q * P, np.uint8)
            bidx = np.zeros(q * P, np.int64)
            for x in range(q):
                for p in range(P):
                    zv = pvecs[p][y]
                    i = x * P + p
                    if zv == x:  # dot: U = C
                        c0s[i], c1s[i], bidx[i] = 1, 0, i
                        continue
                    node_c, node_u = self._pair_idx(x, zv)
                    sw_c, _ = self._pair_idx(zv, x)
                    c0s[i], c1s[i] = self._pair_coeffs(
                        (node_c, sw_c), node_u
                    )
                    z_sw = repair_planes[p] + (x - zv) * q ** (t - 1 - y)
                    bidx[i] = zv * P + plane_ind[z_sw]
            B = flat.index_select(-2, torch.from_numpy(bidx).to(dev))
            # The canonical pair transform is U = C ^ 2*(C_hi^C_lo)
            # for BOTH members ((c0,c1) = (3,2) on (self, partner)),
            # so the whole row reduces to one masked mul-by-2.
            if all(
                (int(c0s[i]), int(c1s[i])) in ((1, 0), (3, 2))
                for i in range(q * P)
            ):
                mask = torch.from_numpy(
                    (c1s != 0).astype(np.uint8)).to(dev).reshape(-1, 1)
                Uy = flat ^ gf_mul2((flat ^ B) * mask)
            else:
                Uy = gf_mul_vec(c0s, flat, -2) ^ gf_mul_vec(c1s, B, -2)
            row_u.append(Uy.reshape(Hy.shape))

        # -- b: one batched inner-MDS decode of the lost row ---------
        erased_row = {y_l * q + x for x in range(q)}
        present = [nd for nd in range(n) if nd not in erased_row]
        want = sorted(erased_row)
        stack = torch.cat(row_u, dim=-3)  # [.., (t-1)q, P, sc]
        lead = stack.shape[:-3]
        ks = stack.reshape(lead + (len(present), P * sc))
        dec = self._inner_decode_shards(
            present, want, [ks[..., i, :] for i in range(len(present))]
        )
        U = {node: dec[i].reshape(lead + (P, sc))
             for i, node in enumerate(want)}

        # -- c: coupled planes of the lost chunk ---------------------
        srcs = []
        for x in range(q):
            node = y_l * q + x
            if x == x_l:
                srcs.append(U[lost_node])
                continue
            node_c, node_u = self._pair_idx(x, x_l)
            lost_c, _ = self._pair_idx(x_l, x)
            c0, c1 = self._pair_coeffs((node_c, node_u), lost_c)
            srcs.append(pair_combine(c0, c1, helper[node], U[node]))
        stack4 = torch.stack(srcs, dim=-3)  # [..., q, P, sc]
        flat = stack4.reshape(stack4.shape[:-3] + (q * P, sc))
        inv = np.zeros(self.sub_chunk_no, np.int64)
        for x in range(q):
            for p in range(P):
                z_dst = repair_planes[p] + (x - x_l) * q ** (t - 1 - y_l)
                inv[z_dst] = x * P + p
        return flat.index_select(-2, torch.from_numpy(inv).to(dev))

    # -- kernel repair (general d) ---------------------------------------
    def _kernel_plan(self, lost_node: int, aloof: frozenset) -> dict:
        """Static planning for the kernel repair path, cached per
        (lost node, aloof set) — digit strides, member kinds, pair
        coefficients, intersection-score groups and the B2 patch
        items.  Pure host arithmetic: one dict serves every repair of
        the same erasure pattern."""
        key = (lost_node, aloof)
        plan = self._kernel_plans.get(key)
        if plan is None:
            plan = self._build_kernel_plan(lost_node, aloof)
            self._kernel_plans[key] = plan
        return plan

    def _build_kernel_plan(self, lost_node: int, aloof: frozenset) -> dict:
        q, t = self.q, self.t
        y_l, x_l = lost_node // q, lost_node % q
        r = self.sub_chunk_no // q
        rows = [y for y in range(t) if y != y_l]

        def stride(y: int) -> int:
            # repair-index stride of digit y: q per free digit minor
            # to it (free = every row but y_l; y=0 most significant)
            return q ** sum(1 for y2 in rows if y2 > y)

        def kind(node: int) -> str:
            if node in aloof:
                return "a"
            if self.k <= node < self.k + self.nu:
                return "v"
            return "r"

        strides = tuple(stride(y) for y in rows)
        kinds = tuple(
            tuple(kind(y * q + x) for x in range(q)) for y in rows
        )
        lost_kinds = tuple(kind(y_l * q + x) for x in range(q))
        # (self, partner) coefficients: forward transform U_self from
        # (C_self, C_partner), hi/lo member; inverse C_lost from
        # (C_helper, U_helper) of a lost-row member.
        pair_fwd = (
            self._pair_coeffs((0, 1), 2),
            self._pair_coeffs((1, 0), 3),
        )
        pair_inv = (
            self._pair_coeffs((0, 2), 1),
            self._pair_coeffs((1, 3), 0),
        )
        present = [
            y * q + x
            for y in rows
            for x in range(q)
            if (y * q + x) not in aloof
        ]
        want = sorted({y_l * q + x for x in range(q)} | aloof)

        def digit(p: int, y: int) -> int:
            return (p // stride(y)) % q

        score = [
            1 + sum(
                1 for nd in aloof if digit(p, nd // q) == nd % q
            )
            for p in range(r)
        ]
        groups: dict[int, np.ndarray] = {}
        for s in sorted(set(score)):
            groups[s] = np.array(
                [p for p in range(r) if score[p] == s], np.int64
            )
        # B2 patch items: helpers sharing a row with an aloof node, at
        # the planes where that aloof node is a dot.  Their uncoupled
        # value needs the aloof node's U from the companion plane (one
        # score lower) — patched between group decodes.
        patches: dict[int, list] = {}
        for nd_a in sorted(aloof):
            x_a, y_a = nd_a % q, nd_a // q
            s_a = stride(y_a)
            dots = [p for p in range(r) if digit(p, y_a) == x_a]
            for x in range(q):
                nd = y_a * q + x
                if x == x_a or nd in aloof:
                    continue
                node_c, node_u = self._pair_idx(x, x_a)
                _sw_c, sw_u = self._pair_idx(x_a, x)
                c0, c1 = self._pair_coeffs((node_c, sw_u), node_u)
                by_score: dict[int, list[int]] = {}
                for p in dots:
                    by_score.setdefault(score[p], []).append(p)
                for s, ps in by_score.items():
                    psw = [p + (x - x_a) * s_a for p in ps]
                    patches.setdefault(s, []).append((
                        nd, nd_a,
                        np.array(ps, np.int64),
                        np.array(psw, np.int64),
                        c0, c1,
                    ))
        return {
            "rows": rows,
            "strides": strides,
            "kinds": kinds,
            "lost_kinds": lost_kinds,
            "pair_fwd": pair_fwd,
            "pair_inv": pair_inv,
            "present": present,
            "want": want,
            "groups": groups,
            "patches": patches,
            "seq": q ** sum(1 for y2 in rows if y2 > y_l),
        }

    def _repair_kernels(self, lost_node, helper, aloof, sc):
        """All repair stages on Kernels E and F around per-score-group
        inner decodes (Kernel A): device memory sees each helper byte
        in and each recovered byte out, without the stack, gather and
        permute intermediates of ``_repair_fast``. General d: aloof
        nodes are decoded alongside the lost row and their U feeds the
        next score group's B2 patches (repair_one_lost_chunk's helper
        split, ErasureCodeClay.cc:454-699). Takes every geometry; CPU
        tensors run the kernels' plain versions."""
        q = self.q
        r = self.sub_chunk_no // q
        sample = helper[next(iter(helper))]
        lead = tuple(sample.shape[:-2])
        b = math.prod(lead)
        dev = sample.device

        plan = self._kernel_plan(lost_node, frozenset(aloof))
        flat = {
            node: helper[node].reshape((b, r * sc)) for node in helper
        }
        real_in = [
            flat[y * q + x]
            for ri, y in enumerate(plan["rows"])
            for x in range(q)
            if plan["kinds"][ri][x] == "r"
        ]
        # stage a: every B1 pair transform in one launch
        U = dict(zip(plan["present"], clay_repair.uncoupled_rows(
            q, plan["strides"], plan["kinds"], plan["pair_fwd"],
            real_in, r, sc,
        )))
        # stage b: inner-MDS decode of lost row + aloof, one apply per
        # intersection-score group (aloof-free: exactly one).
        present, want = plan["present"], plan["want"]
        groups = plan["groups"]
        if len(groups) == 1:
            dec = self._inner_decode_shards(
                present, want, [U[nd] for nd in present]
            )
            Uw = dict(zip(want, dec))
        else:
            Uv = {nd: U[nd].reshape(b, r, sc) for nd in present}
            Uwb = {
                nd: torch.zeros((b, r, sc), dtype=torch.uint8, device=dev)
                for nd in want
            }
            for s in sorted(groups):
                for (nd, nd_a, ps, psw, c0, c1) in plan[
                    "patches"
                ].get(s, ()):
                    ps_t = torch.from_numpy(ps).to(dev)
                    cx = flat[nd].reshape(b, r, sc).index_select(1, ps_t)
                    ua = Uwb[nd_a].index_select(
                        1, torch.from_numpy(psw).to(dev))
                    Uv[nd].index_copy_(1, ps_t, pair_combine(c0, c1, cx, ua))
                zsel = torch.from_numpy(groups[s]).to(dev)
                known = [
                    Uv[nd].index_select(1, zsel).reshape(b, -1)
                    for nd in present
                ]
                dec = self._inner_decode_shards(present, want, known)
                for i, nd in enumerate(want):
                    Uwb[nd].index_copy_(
                        1, zsel, dec[i].reshape(b, len(groups[s]), sc))
            Uw = {nd: v.reshape(b, r * sc) for nd, v in Uwb.items()}
        # stage c: couple + scatter of the lost chunk
        y_l, x_l = lost_node // q, lost_node % q
        udec = [Uw[y_l * q + x] for x in range(q)]
        lost_help = [
            flat[y_l * q + x]
            for x in range(q)
            if x != x_l and plan["lost_kinds"][x] == "r"
        ]
        rec = clay_repair.couple_scatter(
            q, x_l, plan["lost_kinds"], plan["pair_inv"],
            udec, lost_help, plan["seq"], r, sc,
        )
        return rec.reshape(lead + (self.sub_chunk_no, sc))

    # -- repair work-item planning + stacked execution -----------------
    def _plan_repair_group(
        self,
        planes: list[int],
        erasures: set[int],
        aloof: set[int],
        lost_node: int,
    ):
        """Static work items for one intersection-score group — ONE
        source of truth for the pair algebra, executed either stacked
        (tensors) or element-at-a-time (numpy).

        U item:  (node, z, c0, c1, a_src, b_src): U[node][z] =
                 c0*a ^ c1*b.
        C item:  (z_dst, c0, c1, a_src, b_src): recovered[z_dst] = ...
        src: ("h", node, z) helper packet at repair-plane z, or
             ("u", node, z) U packet at absolute plane z.
        """
        q, t = self.q, self.t
        uitems, citems = [], []
        for z in planes:
            z_vec = self._plane_vector(z)
            for y in range(t):
                for x in range(q):
                    node = y * q + x
                    if node in erasures:
                        continue
                    node_sw = y * q + z_vec[y]
                    z_sw = self._z_sw(z, x, y, z_vec)
                    # Tuple indices of this node and its companion in
                    # the canonical (C_hi, C_lo, U_hi, U_lo).
                    node_c, node_u = self._pair_idx(x, z_vec[y])
                    sw_c, sw_u = self._pair_idx(z_vec[y], x)
                    if node_sw in aloof:
                        # U_xy from (C_xy, U_sw) — U_sw was decoded in
                        # an earlier (lower-order) plane group.
                        c0, c1 = self._pair_coeffs((node_c, sw_u), node_u)
                        uitems.append((
                            node, z, c0, c1,
                            ("h", node, z), ("u", node_sw, z_sw),
                        ))
                    elif z_vec[y] != x:
                        # Both coupled values are helper data.
                        c0, c1 = self._pair_coeffs((node_c, sw_c), node_u)
                        uitems.append((
                            node, z, c0, c1,
                            ("h", node, z), ("h", node_sw, z_sw),
                        ))
                    else:
                        uitems.append((
                            node, z, 1, 0,
                            ("h", node, z), ("h", node, z),
                        ))
            for node in sorted(erasures):
                if node in aloof:
                    continue
                x, y = node % q, node // q
                node_sw = y * q + z_vec[y]
                z_sw = self._z_sw(z, x, y, z_vec)
                if x == z_vec[y]:
                    if node == lost_node:
                        citems.append((
                            z, 1, 0, ("u", node, z), ("u", node, z)
                        ))
                else:
                    # Helper member of the lost row: its coupled
                    # (helper) value plus its U give the LOST node's
                    # coupled value at the companion plane.
                    if y != lost_node // q or node_sw != lost_node:
                        raise AssertionError("unexpected repair pair")
                    node_c, node_u = self._pair_idx(x, z_vec[y])
                    lost_c, _ = self._pair_idx(z_vec[y], x)
                    c0, c1 = self._pair_coeffs((node_c, node_u), lost_c)
                    citems.append((
                        z_sw, c0, c1, ("h", node, z), ("u", node, z)
                    ))
        return uitems, citems

    @staticmethod
    def _item_slice(src, helper, U, plane_ind):
        kind, node, z = src
        if kind == "h":
            return helper[node][..., plane_ind[z], :]
        return U[node][..., z, :]

    def _stack_items(self, items, ia, ib, helper, U, plane_ind):
        """c0*a ^ c1*b of every item as one [items, ...] ladder."""
        A = torch.stack([self._item_slice(it[ia], helper, U, plane_ind)
                         for it in items])
        B = torch.stack([self._item_slice(it[ib], helper, U, plane_ind)
                         for it in items])
        c0s = np.array([it[ia - 2] for it in items], np.uint8)
        c1s = np.array([it[ia - 1] for it in items], np.uint8)
        return gf_mul_vec(c0s, A) ^ gf_mul_vec(c1s, B)

    def _exec_uitems_stacked(self, uitems, helper, U, plane_ind) -> None:
        """All pair transforms of a plane group as one stacked ladder,
        then a grouped scatter back into U."""
        if not uitems:
            return
        out = self._stack_items(uitems, 4, 5, helper, U, plane_ind)
        by_node: dict[int, list[int]] = {}
        for idx, (node, *_rest) in enumerate(uitems):
            by_node.setdefault(node, []).append(idx)
        for node, idxs in by_node.items():
            zs = [uitems[i][1] for i in idxs]
            U[node][..., zs, :] = out[idxs].movedim(0, -2)

    def _exec_citems_stacked(self, citems, helper, U, plane_ind,
                             recovered) -> None:
        if not citems:
            return
        out = self._stack_items(citems, 3, 4, helper, U, plane_ind)
        zs = [it[0] for it in citems]
        recovered[..., zs, :] = out.movedim(0, -2)


registry.register("clay", ClayCodec, PLUGIN_ABI_VERSION)
