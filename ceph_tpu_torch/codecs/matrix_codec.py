"""Generic GF(2^8) matrix erasure codec on the CUDA matrix-apply kernels.

The shared engine under the matrix-style families (ISA-L RS/Cauchy) —
the role ``ec_encode_data`` plays in the reference — where one launch
encodes an arbitrary stripe batch.

Routing of one matrix application (``ceph_tpu``'s, minus its mesh and
DCN routes, which are not ported yet):

- host numpy input at or below ``ec_host_dispatch_bytes``: the host GF
  tables, numpy out (``host_*`` counters);
- a matrix whose entries are all 0 or 1 (the xor plugin, LRC xor-local
  layers, an ISA decode needing only the all-ones parity row), on the
  card with ``ec_use_sched`` on and within the schedule gate: the
  XOR-schedule kernel over the shards, w = 1 (``sched_*``); over the
  gate it is counted in ``sched_rejected_density`` and goes on below;
- a CUDA tensor, or host input above the threshold (sent to the
  codec's device): the GF(2^8) apply kernel (``kernel_*``) — per-shard
  operands when the shards already lie on the card, the stacked form
  for host input;
- a CPU tensor, or a CUDA tensor with ``ec_use_kernels`` off: the plain
  PyTorch version (``plain_*``).

Decode matrices are computed host-side (tiny <=32x32 inversions) and
cached in an LRU keyed by the erasure signature — the TableCache
precedent (isa/ErasureCodeIsaTableCache.cc).
"""

from __future__ import annotations

import functools
from collections import OrderedDict

import numpy as np
import torch

from ceph_tpu_torch.gf import decode_matrix, gf_matrix_to_bitmatrix
from ceph_tpu_torch.ops import cuda_encode, cuda_xor, xor_schedule
from ceph_tpu_torch.ops.bitplane import gf_encode_bitplane
from ceph_tpu_torch.utils.device import to_numpy, to_tensor

from .base import ErasureCodeBase
from .interface import Buffer, Flag


@functools.lru_cache(maxsize=1)
def dispatch_counters():
    """Which engine served each matrix application (CUDA kernel, plain
    PyTorch, host GF tables) and how the fused encode+csum requests
    went. Served by ``perf dump`` as ``ec_dispatch``."""
    from ceph_tpu_torch.utils.perf_counters import (
        PerfCountersBuilder,
        perf_collection,
    )

    b = PerfCountersBuilder(perf_collection, "ec_dispatch")
    for op in ("encode", "decode", "delta"):
        b.add_u64_counter(
            f"kernel_{op}", f"{op}s served by the GF(2^8) apply kernel"
        )
        b.add_u64_counter(
            f"plain_{op}", f"{op}s served by the plain PyTorch version"
        )
        b.add_u64_counter(f"host_{op}", f"{op}s served by host GF tables")
        b.add_u64_counter(
            f"sched_{op}",
            f"{op}s served by the XOR-schedule kernel (0/1 packet and "
            "byte matrices)",
        )
    b.add_u64_counter(
        "fused_encode",
        "encodes that also produced per-block crc32c of every shard in "
        "the same launch (counted beside kernel_encode/plain_encode)",
    )
    b.add_u64_counter(
        "fused_fallback",
        "fused encode+csum requests outside the contract (csum block "
        "not a power of two >= 256 dividing the chunk): the caller "
        "encodes normally and hashes separately",
    )
    b.add_u64_counter(
        "sched_rejected_density",
        "0/1 matrix applies whose schedule stayed over the op-count "
        "gate: byte matrices then take the GF(2^8) apply kernel, packet "
        "matrices the schedule kernel or its plain version all the same "
        "(in selection form; no other kernel takes k*w columns)",
    )
    b.add_u64_counter(
        "sched_rejected_shape",
        "schedule-eligible applies no schedule kernel form could take "
        "(ceph_tpu's tiling gates; the CUDA kernel takes every shape, so "
        "this stays 0 — kept for perf dump parity)",
    )
    return b.create_perf_counters()


class DecodeTableCache:
    """LRU of decode matrices keyed by (present-shards, wanted-shards).

    The ISA plugin caches inverted decode tables because inversion is the
    sequential hot-path cost under churny erasure patterns
    (ErasureCodeIsaTableCache.cc). Same idea; values are whatever the
    builder returns (byte or bit matrices, host-side)."""

    def __init__(self, maxsize: int = 256) -> None:
        self.maxsize = maxsize
        self._cache: OrderedDict[tuple, object] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple, build):
        if key in self._cache:
            self._cache.move_to_end(key)
            self.hits += 1
            return self._cache[key]
        self.misses += 1
        val = build()
        self._cache[key] = val
        if len(self._cache) > self.maxsize:
            self._cache.popitem(last=False)
        return val


def _all_host(arrays) -> bool:
    return all(isinstance(a, np.ndarray) for a in arrays)


class BitplaneDispatchMixin:
    """Route one bitmatrix application to the host GF tables, the CUDA
    kernels or the plain PyTorch version, every route visible in the
    ``ec_dispatch`` counters. Needs ``ErasureCodeBase``'s device
    helpers."""

    @staticmethod
    def _host_sized(*arrays) -> bool:
        """Small host-side inputs skip the card entirely: below the
        threshold the copy and the launch dwarf the GF math."""
        from ceph_tpu_torch.utils import config

        limit = config.get("ec_host_dispatch_bytes")
        return (
            limit > 0
            and _all_host(arrays)
            and sum(a.nbytes for a in arrays) <= limit
        )

    @staticmethod
    def _use_kernel(t: torch.Tensor) -> bool:
        from ceph_tpu_torch.utils import config

        return t.is_cuda and bool(config.get("ec_use_kernels"))

    def _count(self, t: torch.Tensor, op: str) -> None:
        route = "kernel" if self._use_kernel(t) else "plain"
        dispatch_counters().inc(f"{route}_{op}")

    def _schedule(self, mat01: np.ndarray, keep_rejected: bool):
        """The schedule to run for a 0/1 matrix: the CSE'd program
        under ``ec_sched_opt`` (gated on post-CSE op count), the
        selection form otherwise (gated on raw density). A matrix over
        its gate counts ``sched_rejected_density`` and runs as selection
        rows if ``keep_rejected``, else the result is None."""
        from ceph_tpu_torch.utils import config

        sched = xor_schedule.routable_schedule(
            mat01, config.get("ec_sched_opt")
        )
        if sched is None:
            dispatch_counters().inc("sched_rejected_density")
            if keep_rejected:
                sched = xor_schedule.schedule_rows(mat01)
        return sched

    def _sched_shards_route(
        self, mat01: np.ndarray, shards: list, w: int, op: str,
        keep_rejected: bool = True,
    ):
        """Serve a 0/1 matrix apply with the XOR-schedule kernel's
        per-shard form (w packets per chunk; w = 1 is whole-chunk byte
        rows): shards in, shards out, nothing stacked. Host arrays above
        the host threshold go to the codec's device shard by shard.
        Returns the output shards, or None when the op is not the
        kernel's: unequal shapes, a host-sized op, the CPU,
        ``ec_use_kernels`` off, or a rejected matrix without
        ``keep_rejected``."""
        from ceph_tpu_torch.utils import config

        if self._host_sized(*shards):
            return None
        shape = tuple(shards[0].shape)
        if any(tuple(s.shape) != shape for s in shards[1:]):
            return None
        dev = next(
            (s.device for s in shards if isinstance(s, torch.Tensor)),
            None,
        ) or self._target_device()
        if dev.type != "cuda" or not config.get("ec_use_kernels"):
            return None
        sched = self._schedule(mat01, keep_rejected)
        if sched is None:
            return None
        dispatch_counters().inc(f"sched_{op}")
        return cuda_xor.xor_schedule_apply_shards(
            sched, self._as_tensors(shards), w
        )

    def _try_sched_bytes(self, mat: np.ndarray, shards: list, op: str):
        """w = 1 schedule route for GF(2^8) byte matrices whose entries
        are all 0/1: over the subfield {0, 1} each output chunk is a
        pure XOR of input chunks. Other matrices bail on the max()
        probe with no counter (not eligible, not rejected); rejected
        ones, and every one with ``ec_use_sched`` off, keep the GF(2^8)
        apply kernel."""
        from ceph_tpu_torch.utils import config

        mat = np.asarray(mat)
        if (not config.get("ec_use_sched") or mat.size == 0
                or int(mat.max()) > 1):
            return None
        return self._sched_shards_route(
            np.ascontiguousarray(mat, dtype=np.uint8), shards, 1, op,
            keep_rejected=False,
        )

    def _dispatch_bitmatrix_shards(
        self, bmat_np: np.ndarray, shards: list, op: str
    ) -> list:
        """Apply ``bmat_np`` [8R, 8C] to C shard buffers; returns R
        tensors. Host arrays go to the device stacked (one copy, the K1
        form); shards already on the card take the per-shard kernel
        form (K2), which never stacks them."""
        if _all_host(shards):
            stacked = to_tensor(
                np.stack(shards, axis=-2), self._target_device()
            )
            self._count(stacked, op)
            if self._use_kernel(stacked) or not stacked.is_cuda:
                out = cuda_encode.gf_apply(bmat_np, stacked)
            else:
                out = gf_encode_bitplane(bmat_np, stacked)
            return [out[..., j, :] for j in range(out.shape[-2])]
        shards = self._as_tensors(shards)
        self._count(shards[0], op)
        if self._use_kernel(shards[0]) or not shards[0].is_cuda:
            return cuda_encode.gf_apply_shards(bmat_np, shards)
        out = gf_encode_bitplane(bmat_np, torch.stack(shards, dim=-2))
        return [out[..., j, :] for j in range(out.shape[-2])]


class MatrixErasureCodec(BitplaneDispatchMixin, ErasureCodeBase):
    """Codec defined by a systematic (k+m) x k GF(2^8) generator matrix."""

    def __init__(self) -> None:
        super().__init__()
        self.generator: np.ndarray | None = None  # [(k+m), k] uint8
        self._tables = DecodeTableCache()  # bit matrices
        self._host_tables = DecodeTableCache()  # byte matrices

    # Subclasses set self.k/self.m then call this from init().
    def _set_generator(self, generator: np.ndarray) -> None:
        self.generator = np.asarray(generator, dtype=np.uint8)
        if self.generator.shape != (self.k + self.m, self.k):
            raise ValueError(
                f"generator {self.generator.shape} is not "
                f"({self.k + self.m}, {self.k})"
            )
        self._encode_bmat_np = gf_matrix_to_bitmatrix(
            self.generator[self.k :, :]
        )

    def get_flags(self) -> Flag:
        return (
            Flag.OPTIMIZED_SUPPORTED
            | Flag.PARITY_DELTA_OPTIMIZATION
            | Flag.ZERO_INPUT_ZERO_OUTPUT
            | Flag.ZERO_PADDING_EXPECTED
            | Flag.PARTIAL_READ_OPTIMIZATION
            | Flag.PARTIAL_WRITE_OPTIMIZATION
        )

    # -- encode -------------------------------------------------------
    def encode_chunks(self, data: dict[int, Buffer]) -> dict[int, Buffer]:
        parity = self._encode_shards(self._shard_list(data))
        return {self.k + i: parity[i] for i in range(self.m)}

    def encode_chunks_with_csums(
        self, data: dict[int, Buffer], csum_block: int
    ):
        """Fused encode+checksum: (parity dict, csums) where ``csums``
        is a ``[..., k+m, nblocks]`` numpy uint32 array of ZERO-INIT
        per-block crc32c (row i = shard i; seed conversion is a
        constant XOR, ``checksum.crc32c.crc32c_seed_shift``). Returns
        ``(None, None)`` for a ``csum_block`` outside the contract (not
        a power of two >= 256, or not dividing the chunk) — callers
        then encode normally and hash separately."""
        from ceph_tpu_torch.utils import config

        if not config.get("ec_fused_csum"):
            return None, None
        shards = self._shard_list(data)
        n = int(shards[0].shape[-1])
        if not cuda_encode.csum_supported(n, csum_block):
            dispatch_counters().inc("fused_fallback")
            return None, None
        host = _all_host(shards)  # else _shard_list made them tensors
        if host:
            stacked = to_tensor(
                np.stack(shards, axis=-2), self._target_device()
            )
        probe = stacked if host else shards[0]
        self._count(probe, "encode")
        dispatch_counters().inc("fused_encode")
        bm = self._encode_bmat_np
        if probe.is_cuda and not self._use_kernel(probe):
            if not host:
                stacked = torch.stack(shards, dim=-2)
            lead = tuple(stacked.shape[:-2])
            par, csums = cuda_encode.gf_apply_csum_plain(
                bm, stacked.reshape(-1, self.k, n), csum_block
            )
            par = par.reshape(lead + (self.m, n))
            csums = csums.reshape(lead + tuple(csums.shape[-2:]))
            parity = [par[..., j, :] for j in range(self.m)]
        elif host:
            par, csums = cuda_encode.gf_apply_csum(bm, stacked, csum_block)
            parity = [par[..., j, :] for j in range(self.m)]
        else:
            parity, csums = cuda_encode.gf_apply_csum_shards(
                bm, shards, csum_block
            )
        return (
            {self.k + j: parity[j] for j in range(self.m)},
            to_numpy(csums).astype(np.uint32),
        )

    def _encode_shards(self, shards: list) -> list:
        if self._host_sized(*shards):
            from ceph_tpu_torch.gf import gf_apply_bytes_host

            dispatch_counters().inc("host_encode")
            out = gf_apply_bytes_host(
                self.generator[self.k :, :], np.stack(shards, axis=-2)
            )
            return [out[..., j, :] for j in range(self.m)]
        outs = self._try_sched_bytes(
            self.generator[self.k :, :], shards, "encode"
        )
        if outs is not None:
            return outs
        return self._dispatch_bitmatrix_shards(
            self._encode_bmat_np, shards, "encode"
        )

    # -- decode -------------------------------------------------------
    def decode_chunks(
        self,
        want_to_read: set[int],
        chunks: dict[int, Buffer],
    ) -> dict[int, Buffer]:
        present = sorted(chunks)
        # Only reconstruct what is actually missing: wanted-but-present
        # shards pass through, keeping decode tables (and the LRU keys)
        # erasure-pattern-minimal.
        want = sorted(w for w in want_to_read if w not in chunks)
        if not want:
            return {w: chunks[w] for w in want_to_read}
        key = (tuple(present), tuple(want))
        shards = [chunks[i] for i in present]
        if self._host_sized(*shards):
            from ceph_tpu_torch.gf import gf_apply_bytes_host

            dispatch_counters().inc("host_decode")
            mat = self._host_tables.get(
                key, lambda: self._build_decode_bytes(present, want)
            )
            out = gf_apply_bytes_host(mat, np.stack(shards, axis=-2))
            outs = [out[..., j, :] for j in range(len(want))]
        else:
            # 0/1 decode rows (an XOR-parity group's repair) ride the
            # schedule kernel; the byte matrix is the host route's
            mat = self._host_tables.get(
                key, lambda: self._build_decode_bytes(present, want)
            )
            outs = self._try_sched_bytes(mat, shards, "decode")
            if outs is None:
                bmat_np = self._tables.get(
                    key, lambda: self._build_decode_bmat(present, want)
                )
                outs = self._dispatch_bitmatrix_shards(
                    bmat_np, shards, "decode"
                )
        result = {w: chunks[w] for w in want_to_read if w in chunks}
        for idx, w in enumerate(want):
            result[w] = outs[idx]
        return result

    def _build_decode_bytes(
        self, present: list[int], want: list[int]
    ) -> np.ndarray:
        """Byte-matrix rows producing each wanted shard from the
        present shards. Data shards come from the inverted-submatrix
        rows; wanted parity shards are re-encoded as G_parity_row @
        (decode rows) — the decode-of-data + re-encode-of-parity split
        of shard_extent_map_t::decode (osd/ECUtil.cc:648-729)."""
        from ceph_tpu_torch.gf import gf_matmul_np

        d = decode_matrix(self.generator, self.k, present)
        rows = []
        for w in want:
            if w < self.k:
                rows.append(d[w, :])
            else:
                rows.append(gf_matmul_np(self.generator[w : w + 1, :], d)[0])
        return np.stack(rows)

    def _build_decode_bmat(
        self, present: list[int], want: list[int]
    ) -> np.ndarray:
        return gf_matrix_to_bitmatrix(
            self._host_tables.get(
                (tuple(present), tuple(want)),
                lambda: self._build_decode_bytes(present, want),
            )
        )

    # -- parity delta (RMW) -------------------------------------------
    def encode_delta(self, old_data: Buffer, new_data: Buffer) -> Buffer:
        if _all_host((old_data, new_data)):
            return np.bitwise_xor(old_data, new_data)
        a, b = self._as_tensors([old_data, new_data])
        return torch.bitwise_xor(a, b)

    def apply_delta(
        self,
        delta: dict[int, Buffer],
        parity: dict[int, Buffer],
    ) -> dict[int, Buffer]:
        """parity'_j = parity_j XOR sum_i G[j, i] * delta_i.

        The matrix_apply_delta analog (ErasureCodeJerasure.h:110-119):
        one small apply over just the changed columns."""
        cols = sorted(delta)
        shards = [delta[c] for c in cols]
        if self._host_sized(*shards):
            from ceph_tpu_torch.gf import gf_apply_bytes_host

            dispatch_counters().inc("host_delta")
            contrib = gf_apply_bytes_host(
                self.generator[self.k :, cols],
                np.stack(shards, axis=-2),
            )
            return {
                pid: np.bitwise_xor(
                    to_numpy(p), contrib[..., pid - self.k, :]
                )
                for pid, p in parity.items()
            }
        contribs = self._try_sched_bytes(
            self.generator[self.k :, cols], shards, "delta"
        )
        if contribs is None:
            bmat_np = self._tables.get(
                ("delta", tuple(cols)),
                lambda: gf_matrix_to_bitmatrix(
                    self.generator[self.k :, cols]
                ),
            )
            contribs = self._dispatch_bitmatrix_shards(
                bmat_np, shards, "delta"
            )
        return {
            pid: torch.bitwise_xor(
                to_tensor(p, contribs[0].device), contribs[pid - self.k]
            )
            for pid, p in parity.items()
        }
