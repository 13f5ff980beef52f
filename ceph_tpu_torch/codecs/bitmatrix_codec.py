"""Bit-matrix (XOR-schedule) erasure codecs — the liberation family.

The reference's jerasure plugin runs liberation / blaum_roth /
liber8tion as w-bit bit-matrix codes executed as XOR schedules over
"packets" (ErasureCodeJerasure.h:188-324). A chunk is w packets and the
coding matrix is [m*w, k*w] over GF(2); encode, decode and parity delta
are XOR programs over packets, run by the XOR-schedule kernel
(``ops.cuda_xor``, ``csrc/xor_schedule.cu``).

The constructions are ``ceph_tpu``'s, byte for byte (the corpus pins
them): ``liberation_bitmatrix`` is Plank's FAST'08 construction,
``blaum_roth_bitmatrix`` the Blaum-Roth ring form over
GF(2)[x]/(1 + x + ... + x^w), ``sparse_power_bitmatrix`` and
``gf2w_power_bitmatrix`` the liber8tion envelope, and
``raid6_bitmatrix`` the searched minimal-density matrices pinned as
``construction=v0``. Every construction re-verifies MDS at build time.

Routing of one packet-matrix apply:

- shards already on the card: the kernel's per-shard form, nothing
  stacked (``sched_*``);
- host arrays at or below ``ec_host_dispatch_bytes``: the host GF tables
  over the packets (``host_*``);
- larger host arrays: stacked, sent to the codec's device and run on
  the kernel's packetized form (``sched_*``; the ``ShardExtentMap``
  route);
- a CPU tensor, or the card with ``ec_use_kernels`` off: the plain
  version of the same schedule (``plain_*``).

A matrix over the schedule gate still runs on the XOR-schedule kernel,
in selection form, counted in ``sched_rejected_density``, and
``ec_use_sched`` does not apply here: the GF(2^8) apply kernel takes at
most 32 columns and a packet matrix has k*w of them. ``ceph_tpu``'s
mesh and DCN routes are not ported (ROADMAP item 16).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ceph_tpu_torch.gf.bitmatrix import bitmatrix_invert, bitmatrix_matmul
from ceph_tpu_torch.ops import cuda_xor, xor_schedule
from ceph_tpu_torch.utils.device import to_tensor

from .base import CHUNK_ALIGN, ErasureCodeBase
from .interface import Buffer, Flag
from .matrix_codec import (
    BitplaneDispatchMixin,
    DecodeTableCache,
    _all_host,
    dispatch_counters,
)


def _shift(w: int, d: int) -> np.ndarray:
    """Cyclic shift matrix S^d: ones at (i, (i+d) mod w)."""
    m = np.zeros((w, w), dtype=np.uint8)
    for i in range(w):
        m[i, (i + d) % w] = 1
    return m


def _invertible(m: np.ndarray) -> bool:
    try:
        bitmatrix_invert(m)
        return True
    except ValueError:
        return False


@functools.lru_cache(maxsize=None)
def raid6_bitmatrix(k: int, w: int) -> bytes:
    """Search a minimal-density RAID-6 bit-matrix code.

    P row: identity blocks. Q row: X_j = S^j plus the fewest correction
    bits (deterministic scan order) such that every X_j and every
    pairwise X_i ^ X_j is invertible — the exact MDS condition for
    two-parity bit-matrix codes. Returns [2*w, k*w] packed bytes.
    """
    if k > w:
        raise ValueError(f"k={k} must be <= w={w}")
    blocks: list[np.ndarray] = []
    cells = [(r, c) for r in range(w) for c in range(w)]
    for j in range(k):
        base = _shift(w, j)
        placed = None

        # iterative deepening over correction-bit count: the bare shift,
        # then 1 bit, then 2 (even w, where S^d ^ S^e is never
        # invertible, needs 2)
        def candidates():
            yield ()
            for cell in cells:
                yield (cell,)
            for a in range(len(cells)):
                for b in range(a + 1, len(cells)):
                    yield (cells[a], cells[b])

        for cand in candidates():
            x = base.copy()
            for r, c in cand:
                x[r, c] ^= 1
            if not _invertible(x):
                continue
            if all(_invertible(x ^ b) for b in blocks):
                placed = x
                break
        if placed is None:
            raise ValueError(
                f"no minimal-density RAID-6 construction found for k={k}, w={w}"
            )
        blocks.append(placed)
    coding = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        coding[:w, j * w : (j + 1) * w] = np.eye(w, dtype=np.uint8)
        coding[w:, j * w : (j + 1) * w] = blocks[j]
    return coding.tobytes()


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    return all(n % i for i in range(2, int(n**0.5) + 1))


@functools.lru_cache(maxsize=None)
def liberation_bitmatrix(k: int, w: int) -> bytes:
    """The Liberation code construction (Plank, FAST'08) — the matrix
    ``liberation_coding_bitmatrix`` builds for the reference's
    liberation technique (ErasureCodeJerasure.cc:676).

    w prime, k <= w. P row: identity blocks. Q block X_i: the cyclic
    shift S^i plus, for i > 0, one extra bit at (y, (y+i-1) mod w) with
    y = i(w-1)/2 mod w: k*w + k - 1 ones, the minimal-density bound.
    MDS is re-verified exhaustively at construction time."""
    if not _is_prime(w):
        raise ValueError(f"liberation requires prime w, got {w}")
    if k > w:
        raise ValueError(f"k={k} must be <= w={w}")
    coding = np.zeros((2 * w, k * w), dtype=np.uint8)
    blocks: list[np.ndarray] = []
    for i in range(k):
        coding[:w, i * w : (i + 1) * w] = np.eye(w, dtype=np.uint8)
        x = np.zeros((w, w), dtype=np.uint8)
        for r in range(w):
            x[r, (r + i) % w] = 1
        if i > 0:
            y = (i * ((w - 1) // 2)) % w
            x[y, (y + i - 1) % w] ^= 1
        if not _invertible(x) or any(
            not _invertible(x ^ b) for b in blocks
        ):
            raise ValueError(
                f"liberation construction not MDS for k={k}, w={w}"
            )
        blocks.append(x)
        coding[w:, i * w : (i + 1) * w] = x
    return coding.tobytes()


@functools.lru_cache(maxsize=None)
def blaum_roth_bitmatrix(k: int, w: int) -> bytes:
    """Blaum-Roth RAID-6 code over the ring GF(2)[x]/(1 + x + ... + x^w).

    Requires w+1 prime. The Q block of data column j is multiplication
    by x^j (C^j, C the companion matrix of M_p(x) = (x^p - 1)/(x - 1),
    p = w+1); MDS because x^d + 1 is coprime to M_p(x) for 0 < d < p."""
    if not _is_prime(w + 1):
        raise ValueError(f"blaum_roth requires w+1 prime, got w={w}")
    if k > w:
        raise ValueError(f"k={k} must be <= w={w}")
    # Companion matrix: column j of C holds x^(j+1) mod M_p.
    c = np.zeros((w, w), dtype=np.uint8)
    for j in range(w - 1):
        c[j + 1, j] = 1
    c[:, w - 1] = 1  # x^w = 1 + x + ... + x^(w-1)
    coding = np.zeros((2 * w, k * w), dtype=np.uint8)
    block = np.eye(w, dtype=np.uint8)
    for j in range(k):
        coding[:w, j * w : (j + 1) * w] = np.eye(w, dtype=np.uint8)
        coding[w:, j * w : (j + 1) * w] = block
        block = bitmatrix_matmul(block, c)
    return coding.tobytes()


@functools.lru_cache(maxsize=None)
def sparse_power_bitmatrix(k: int, w: int = 8) -> bytes:
    """RAID-6 Q blocks = the k sparsest multiplication-by-g^e
    bitmatrices over GF(2^8). Distinct powers are pairwise MDS, so
    density is a free choice; the exponents are frozen by the
    deterministic (ones, exponent) sort."""
    from ceph_tpu_torch.gf.tables import gf_pow, mul_bitmatrix

    if w != 8:
        raise ValueError("sparse_power_bitmatrix implemented for w=8")
    if k > 2**w - 1:
        raise ValueError(f"k={k} too large for w={w}")
    dens = sorted(
        (int(np.asarray(mul_bitmatrix(gf_pow(2, e))).sum()), e)
        for e in range(2**w - 1)
    )
    chosen = sorted(e for _, e in dens[:k])
    coding = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j, e in enumerate(chosen):
        coding[:w, j * w : (j + 1) * w] = np.eye(w, dtype=np.uint8)
        coding[w:, j * w : (j + 1) * w] = mul_bitmatrix(gf_pow(2, e))
    return coding.tobytes()


@functools.lru_cache(maxsize=None)
def gf2w_power_bitmatrix(k: int, w: int = 8) -> bytes:
    """RAID-6 bit-matrix with Q blocks = powers of the GF(2^w) generator
    (X_j = multiplication by g^j, field 0x11D); MDS for k <= 2^w - 1."""
    from ceph_tpu_torch.gf.tables import gf_pow, mul_bitmatrix

    if w != 8:
        raise ValueError("gf2w_power_bitmatrix implemented for w=8")
    if k > 2**w - 1:
        raise ValueError(f"k={k} too large for w={w}")
    coding = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        coding[:w, j * w : (j + 1) * w] = np.eye(w, dtype=np.uint8)
        coding[w:, j * w : (j + 1) * w] = mul_bitmatrix(gf_pow(2, j))
    return coding.tobytes()


def _xor_into(parity: Buffer, contrib: Buffer) -> Buffer:
    """parity XOR contrib, on the host when both are host arrays."""
    if _all_host((parity, contrib)):
        return np.bitwise_xor(parity, contrib)
    return torch.bitwise_xor(to_tensor(parity, contrib.device), contrib)


class BitMatrixCodec(BitplaneDispatchMixin, ErasureCodeBase):
    """Erasure codec driven by a [m*w, k*w] GF(2) coding matrix.

    Chunk layout: chunk = w consecutive packets of chunk_size/w bytes
    (the jerasure packet convention, with the packet size implied by
    the chunk size rather than a separate profile knob)."""

    def __init__(self) -> None:
        super().__init__()
        self.w = 0
        self.coding_bitmatrix: np.ndarray | None = None  # [m*w, k*w]
        self._host_tables = DecodeTableCache()  # packet 0/1 decode matrices

    def _set_bitmatrix(self, coding: np.ndarray) -> None:
        if coding.shape != (self.m * self.w, self.k * self.w):
            raise ValueError(
                f"coding bitmatrix {coding.shape} is not "
                f"({self.m * self.w}, {self.k * self.w})"
            )
        self.coding_bitmatrix = coding.astype(np.uint8)

    def get_flags(self) -> Flag:
        return (
            Flag.OPTIMIZED_SUPPORTED
            | Flag.ZERO_INPUT_ZERO_OUTPUT
            | Flag.ZERO_PADDING_EXPECTED
            | Flag.PARITY_DELTA_OPTIMIZATION
            | Flag.PARITY_DELTA_CHUNK_GRANULARITY
        )

    def get_chunk_size(self, stripe_width: int) -> int:
        """Chunks split into w packets of a CHUNK_ALIGN multiple."""
        per = -(-stripe_width // self.k)
        unit = self.w * CHUNK_ALIGN
        return -(-per // unit) * unit

    # [..., S, N] chunks <-> [..., S*w, N/w] packets, both views
    def _to_packets(self, chunks):
        *lead, s, n = chunks.shape
        if n % self.w:
            raise ValueError(f"chunk {n} is not w={self.w} packets")
        return chunks.reshape(*lead, s * self.w, n // self.w)

    def _to_chunks(self, packets):
        *lead, sw, p = packets.shape
        return packets.reshape(*lead, sw // self.w, p * self.w)

    def _apply_packet_matrix(self, mat01: np.ndarray, stacked, op: str):
        """Apply a packet-level 0/1 matrix to [..., S, N] chunks:
        packetize (a view), route, de-packetize (a view). The plain
        route runs the schedule the kernel would."""
        if self._host_sized(stacked):
            from ceph_tpu_torch.gf import gf_apply_bytes_host

            dispatch_counters().inc(f"host_{op}")
            out = gf_apply_bytes_host(mat01, self._to_packets(stacked))
            return self._to_chunks(out)
        packets = self._to_packets(to_tensor(stacked, self._target_device()))
        sched = self._schedule(mat01, keep_rejected=True)
        if self._use_kernel(packets):
            dispatch_counters().inc(f"sched_{op}")
            out = cuda_xor.xor_schedule_apply(sched, packets)
        else:
            dispatch_counters().inc(f"plain_{op}")
            out = xor_schedule.xor_schedule_plain(sched, packets)
        return self._to_chunks(out)

    def _try_sched_shards(self, mat01: np.ndarray, shards: list, op: str):
        """The per-shard kernel route for shards already on the card;
        None for anything else (host arrays take the packetized route,
        where the host-sized ones stay on the host)."""
        if _all_host(shards):
            return None
        return self._sched_shards_route(mat01, shards, self.w, op)

    def _stack(self, shards: list):
        """[..., S, N]: numpy for host arrays, else a tensor."""
        if _all_host(shards):
            return np.stack(shards, axis=-2)
        return torch.stack(self._as_tensors(shards), dim=-2)

    def encode_chunks(self, data: dict[int, Buffer]) -> dict[int, Buffer]:
        shards = self._shard_list(data)
        outs = self._try_sched_shards(self.coding_bitmatrix, shards, "encode")
        if outs is not None:
            return {self.k + i: outs[i] for i in range(self.m)}
        parity = self._apply_packet_matrix(
            self.coding_bitmatrix, self._stack(shards), "encode"
        )
        return {self.k + i: parity[..., i, :] for i in range(self.m)}

    def decode_chunks(
        self,
        want_to_read: set[int],
        chunks: dict[int, Buffer],
    ) -> dict[int, Buffer]:
        present = sorted(chunks)
        want = sorted(w for w in want_to_read if w not in chunks)
        if not want:
            return {w: chunks[w] for w in want_to_read}
        dec01 = self._host_tables.get(
            (tuple(present), tuple(want)),
            lambda: self._build_decode_bitmatrix(present, want),
        )
        shard_list = [chunks[i] for i in present]
        outs = self._try_sched_shards(dec01, shard_list, "decode")
        if outs is None:
            out = self._apply_packet_matrix(
                dec01, self._stack(shard_list), "decode"
            )
            outs = [out[..., i, :] for i in range(len(want))]
        result = {w: chunks[w] for w in want_to_read if w in chunks}
        for idx, wshard in enumerate(want):
            result[wshard] = outs[idx]
        return result

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
        """parity'_j = parity_j XOR (packet-matrix columns of the
        changed chunks applied to the delta packets) — the
        schedule_apply_delta analog (ErasureCodeJerasure.h:110-119).

        Delta buffers must be whole chunks (PARITY_DELTA_CHUNK_
        GRANULARITY): a sub-chunk write's parity update scatters across
        the whole chunk through the packet structure."""
        cols = sorted(delta)
        w = self.w
        pcols = [c * w + t for c in cols for t in range(w)]
        mat01 = np.ascontiguousarray(self.coding_bitmatrix[:, pcols])
        shard_list = [delta[c] for c in cols]
        outs = self._try_sched_shards(mat01, shard_list, "delta")
        if outs is None:
            contrib = self._apply_packet_matrix(
                mat01, self._stack(shard_list), "delta"
            )
            outs = [contrib[..., j, :] for j in range(self.m)]
        return {
            pid: _xor_into(p, outs[pid - self.k])
            for pid, p in parity.items()
        }

    def _build_decode_bitmatrix(
        self, present: list[int], want: list[int]
    ) -> np.ndarray:
        """Invert the surviving (k*w)-row sub-bitmatrix, then compose
        the wanted rows (jerasure_invert_bitmatrix's role). Returns the
        host [len(want)*w, len(present)*w] 0/1 matrix."""
        kw = self.k * self.w
        full = np.zeros(((self.k + self.m) * self.w, kw), dtype=np.uint8)
        for i in range(self.k):
            full[i * self.w : (i + 1) * self.w, i * self.w : (i + 1) * self.w] = (
                np.eye(self.w, dtype=np.uint8)
            )
        full[kw:, :] = self.coding_bitmatrix
        rows = []
        for s in present:
            rows.extend(range(s * self.w, (s + 1) * self.w))
        # kw independent rows: the first k blocks usually suffice
        try:
            inv = bitmatrix_invert(full[rows[:kw], :])
            chosen = rows[:kw]
        except ValueError:
            # rank-extend row by row over GF(2)
            chosen = []
            basis: list[np.ndarray] = []
            for r in rows:
                if len(chosen) == kw:
                    break
                v = full[r].copy()
                for e in basis:
                    lead = int(np.argmax(e != 0))
                    if v[lead]:
                        v ^= e
                if v.any():
                    chosen.append(r)
                    basis.append(v)
            if len(chosen) < kw:
                raise ValueError("erasure pattern not decodable")
            inv = bitmatrix_invert(full[chosen, :])
        # data = inv @ chosen rows; wanted shard rows = full rows @ data
        dec = np.zeros(
            (len(want) * self.w, len(present) * self.w), dtype=np.uint8
        )
        col_of = {r: i for i, r in enumerate(rows)}
        for wi, wshard in enumerate(want):
            wrows = full[wshard * self.w : (wshard + 1) * self.w, :]
            comp = bitmatrix_matmul(wrows, inv)  # [w, kw] over chosen
            for a in range(self.w):
                for b, r in enumerate(chosen):
                    dec[wi * self.w + a, col_of[r]] = comp[a, b]
        return dec

