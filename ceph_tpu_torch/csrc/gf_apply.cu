// Kernels A and B: GF(2^8) matrix apply, out[r] = XOR_c G[r][c] * in[c],
// over C input and R output byte rows per stripe (field 0x11D, the
// ISA-L / gf-complete w=8 field).
//
// Kernel A (gf_apply) replaces the Pallas kernels
//   ceph_tpu/ops/pallas_encode.py:329 gf_encode_bitplane_pallas (_apply_tiled)
//   ceph_tpu/ops/pallas_encode.py:434 gf_encode_bitplane_pallas_shards (_shards_fn)
// Kernel B (gf_apply_csum) replaces the fused encode+checksum kernels
//   ceph_tpu/ops/pallas_encode.py:617 gf_encode_csum_bitplane_pallas (_apply_tiled_csum)
//   ceph_tpu/ops/pallas_encode.py:791 gf_encode_csum_bitplane_pallas_shards (_shards_csum_fn)
// One launcher serves the stacked and the per-shard forms: every input
// and output row is a pointer plus a stripe stride, so a stacked
// [B, C, N] tensor and C separate [B, N] tensors look alike here.
//
// Kernel A. Bound: device memory, (C + R) * B * N bytes; at EC(8,4) the
// multiply work per byte column (R * C products) keeps it within a
// factor two of that bound only if each product costs a few ALU ops per
// four bytes. The TPU ran the apply as a bit-plane matmul; the first
// port here multiplied through split-nibble tables in shared memory,
// two byte lookups and about four ALU ops per byte and product, which
// made it bound by shared-memory lookups at 4.5x its byte bound. Now no
// table: for each 32-bit word of an input row the kernel walks the
// xtime ladder x, 2x, 4x, ... 128x on packed words (gf_word.cuh, seven
// mul2w steps shared by all outputs), and output r takes rung i where
// bit i of G[r][c] is set. G lies in the __grid_constant__ parameters,
// so that test is uniform over the grid and costs no per-thread work.
// A thread owns kVec 16-byte vectors of a stripe per row, spaced a
// block width apart so each warp load covers 512 contiguous bytes, and
// loads the next input row while it multiplies the current one. Up to
// four outputs are accumulated per pass over the inputs.
// What won, by experiments/torch_kernel_variants.py on an H100 80GB
// HBM3: two vectors a thread (0.045 ms at EC(8,4), against a 0.030 ms
// byte bound) over one (0.073 ms: too few bytes in flight) and four
// (0.050 ms: 128 registers, half the resident warps). What holds it
// back now is the ladder's integer work, not the loads, so the
// bulk-copy ring that a memory-bound kernel would call for was not
// built.
//
// Kernel B adds the zero-init CRC32C of every cb-byte window of all
// C + R rows without a second pass over device memory. Bound: device
// memory, (C + R) * B * N bytes plus the csums; on the way stand A's
// ladder and C's table lookups, which share the integer issue slots. The
// first port (one block per (stripe, window), split-nibble products, one
// copy of slicing-by-8 tables) ran at 6.8x its bound and lost to A then C
// run one after the other: every block rebuilt its tables, lookups
// collided on banks, and the block loaded, multiplied and hashed in
// turn with nothing in flight. Now:
//
// - A persistent grid, as many blocks as fit at once; a block walks
//   items (a window, or several windows when cb is below the step) in
//   steps of `tile` columns and builds its CRC tables once: Kernel C's
//   slicing-by-4 tables, replicated kCsumCopies times
//   (crc32c_common.cuh).
// - Staged inputs, double-buffered: the next step's C input rows are
//   copied into shared memory by cp.async while this step is multiplied
//   and hashed. Products by A's ladder (ladder_acc) read them there, a
//   thread taking kCsumUnit bytes of every row at a time; the R parity
//   rows go to device memory and into a shared parity tile.
// - The hash split evenly: each row of a step is cut into pieces of
//   `piece` bytes, each hashed by one warp as 32 lane segments of
//   piece / 32 bytes (from 32 bytes up padded by 16 in shared memory, so
//   a quarter warp's 16-byte reads hit distinct banks); a warp interleaves
//   kCsumIlp such (row, piece) tasks, lane by lane, to hide the lookup
//   latency of its CRC registers. Lanes join with C's one-level join
//   (per-lane shift matrices, one XOR shuffle); thread r then chains
//   row r's pieces into the window's CRC with the piece shift matrix.
// The host (ops/cuda_encode.py::csum_plan) picks tile and piece.
#include <cuda_runtime.h>

#include "bytes16.cuh"
#include "crc32c_common.cuh"
#include "gf_word.cuh"

// 16-byte vectors per row a thread of Kernel A owns (the build may
// override it to compare tile widths)
#ifndef GF_APPLY_VEC
#define GF_APPLY_VEC 2
#endif
// Kernel B: threads a block, bytes of a product unit (16 or 8), hash
// tasks a warp interleaves, bytes between padded lane segments.
// GF_CSUM_NO_HASH / GF_CSUM_NO_PRODUCTS compile a phase out: timing-only
// builds that say which phase holds the kernel, never used on a path.
#ifndef GF_CSUM_THREADS
#define GF_CSUM_THREADS 256
#endif
#ifndef GF_CSUM_UNIT
#define GF_CSUM_UNIT 16
#endif
#ifndef GF_CSUM_PAD
#define GF_CSUM_PAD 16  // bytes between lane segments in shared memory
#endif
#ifndef GF_CSUM_ILP
#define GF_CSUM_ILP 3
#endif

namespace {

constexpr int kMaxRows = 32;  // ISA caps k and m at 32 (ErasureCodeIsa.h:48-49)
constexpr int kThreads = 256;
constexpr int kRowGroup = 4;  // output rows accumulated per pass
constexpr int kVec = GF_APPLY_VEC;
constexpr int kApplyTile = kThreads * 16 * kVec;  // Kernel A columns per block
constexpr int kCsumThreads = GF_CSUM_THREADS;
constexpr int kCsumWarps = kCsumThreads / 32;
constexpr int kCsumUnit = GF_CSUM_UNIT;
constexpr int kCsumWords = kCsumUnit / 4;
constexpr int kCsumCopies = 16;  // CRC table copies: two lanes a bank at most
constexpr int kCsumIlp = GF_CSUM_ILP;
constexpr int kCsumTabBytes = crc_table_words<kCsumCopies>() * 4;
constexpr int kCsumPad = GF_CSUM_PAD;

struct GfApplyParams {
  const uint8_t* in[kMaxRows];
  long long in_stride[kMaxRows];  // bytes between stripes
  uint8_t* out[kMaxRows];
  long long out_stride[kMaxRows];
  uint8_t coef[kMaxRows * kMaxRows];  // [R][C]
  int C, R;
  long long B, N;
  int aligned;  // every row pointer and stripe stride 16-byte aligned
};

struct GfCsumParams {
  GfApplyParams g;
  uint32_t* csum;              // [B, C + R, N / cb] zero-init CRC32C
  const uint32_t* lane_mats;   // [32][32] device: lane i shifts across (31 - i) * piece / 32
  long long cb;                // csum window, a power of two >= 256 dividing N
  int steps;                   // B * N / tile, below 2^31
  int per_stripe;              // N / tile
  int tile;                    // columns a step: a power of two >= 256 dividing N,
                               // a multiple or a divisor of cb
  int piece;                   // bytes of a row one warp task hashes (divides tile and cb)
  int lg_item_steps;           // log2 of the consecutive steps a block takes:
                               // max(cb, tile) / tile
  int lg_cb;
  uint32_t piece_mat[32];      // shift across piece bytes
};

// acc[j] ^= g[j] * x for the W packed words x, by the xtime ladder: x,
// 2x, ... 128x, seven mul2w steps shared by every output; output j takes
// rung i where bit i of g[j] is set. g is uniform over the grid, so the
// bit tests cost no divergence.
template <int NR, int W>
__device__ __forceinline__ void ladder_acc(uint32_t (&acc)[NR][W], uint32_t (&x)[W],
                                           const uint32_t (&g)[NR]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < NR; ++j)
      if ((g[j] >> i) & 1u)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[j][w] ^= x[w];
    if (i < 7)
#pragma unroll
      for (int w = 0; w < W; ++w) x[w] = mul2w(x[w]);
  }
}

// Kernel A, NR output rows from r0 on: one pass over the C inputs.
template <int NR>
__device__ __forceinline__ void apply_rows(const GfApplyParams& p, int r0, long long b,
                                           long long col0) {
  constexpr int W = 4 * kVec;  // words per row a thread owns
  long long col[kVec], avail[kVec];
  bool vec[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    col[v] = col0 + ((long long)v * kThreads + threadIdx.x) * 16;
    avail[v] = p.N - col[v];
    vec[v] = p.aligned && avail[v] >= 16;
  }
  uint32_t acc[NR][W];
#pragma unroll
  for (int j = 0; j < NR; ++j)
#pragma unroll
    for (int w = 0; w < W; ++w) acc[j][w] = 0u;
  uint4 next[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v)
    next[v] = load16(p.in[0] + b * p.in_stride[0] + col[v], vec[v], avail[v]);
  for (int c = 0; c < p.C; ++c) {
    uint32_t x[W];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      x[4 * v] = next[v].x;
      x[4 * v + 1] = next[v].y;
      x[4 * v + 2] = next[v].z;
      x[4 * v + 3] = next[v].w;
    }
    if (c + 1 < p.C) {  // the next row's loads fly during this row's math
      const uint8_t* row = p.in[c + 1] + b * p.in_stride[c + 1];
#pragma unroll
      for (int v = 0; v < kVec; ++v) next[v] = load16(row + col[v], vec[v], avail[v]);
    }
    uint32_t g[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) g[j] = p.coef[(r0 + j) * p.C + c];
    ladder_acc<NR, W>(acc, x, g);
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    uint8_t* row = p.out[r0 + j] + b * p.out_stride[r0 + j];
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      store16(row + col[v],
              make_uint4(acc[j][4 * v], acc[j][4 * v + 1], acc[j][4 * v + 2],
                         acc[j][4 * v + 3]),
              vec[v], avail[v]);
  }
}

// Kernel A. Block = (stripe, run of kApplyTile columns).
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const __grid_constant__ GfApplyParams p, long long col_blocks) {
  const long long b = blockIdx.x / col_blocks;
  const long long col0 = (blockIdx.x % col_blocks) * kApplyTile;
  if (col0 + threadIdx.x * 16 >= p.N) return;
  for (int r0 = 0; r0 < p.R; r0 += kRowGroup) {
    switch (p.R - r0) {  // uniform over the grid
      case 1: apply_rows<1>(p, r0, b, col0); break;
      case 2: apply_rows<2>(p, r0, b, col0); break;
      case 3: apply_rows<3>(p, r0, b, col0); break;
      default: apply_rows<4>(p, r0, b, col0); break;
    }
  }
}

// Kernel B's shared-memory rows: byte i of a step's row lies at
// (i / seg) * spad + i % seg, lane segments of seg = piece / 32 bytes
// spaced spad apart: seg + 16 from 32 bytes up (an odd number of 16-byte
// units, so the lanes of a quarter warp read distinct banks), unpadded
// below (16: already odd; 8: a 16-byte unit spans two contiguous
// segments).
struct CsumLayout {
  int seg, lg_seg, spad, tpad, pieces, lg_pieces, lg_units;
  __device__ __forceinline__ CsumLayout(int tile, int piece) {
    seg = piece >> 5;
    lg_seg = __ffs(seg) - 1;
    spad = seg >= 32 ? seg + kCsumPad : seg;
    tpad = (tile >> lg_seg) * spad;
    pieces = tile / piece;
    lg_pieces = __ffs(pieces) - 1;
    lg_units = __ffs(tile >> 4) - 1;  // 16-byte staging units a row
  }
  __device__ __forceinline__ int off(int i) const {
    return (i >> lg_seg) * spad + (i & (seg - 1));
  }
};

// The step a block takes k-th: items blockIdx.x, + gridDim.x, ..., each
// item_steps consecutive steps (>= steps: the block is done).
__device__ __forceinline__ int csum_step(const GfCsumParams& q, int k) {
  const long long s = (blockIdx.x + (long long)(k >> q.lg_item_steps) * gridDim.x)
                          << q.lg_item_steps;
  return s < q.steps ? (int)s + (k & ((1 << q.lg_item_steps) - 1)) : q.steps;
}

// Copy the C input rows of step s into buf (cp.async on aligned rows,
// loads and shared stores otherwise); one commit group.
__device__ __forceinline__ void csum_stage(const GfCsumParams& q, const CsumLayout& L,
                                           uint8_t* buf, int s) {
  const GfApplyParams& p = q.g;
  const int b = s / q.per_stripe;
  const long long col0 = (long long)(s - b * q.per_stripe) * q.tile;
  for (int u = threadIdx.x; u < p.C << L.lg_units; u += blockDim.x) {
    const int c = u >> L.lg_units;
    const int i = (u - (c << L.lg_units)) << 4;
    uint8_t* dst = buf + c * L.tpad + L.off(i);
    const uint8_t* src = p.in[c] + b * p.in_stride[c] + col0 + i;
    if (p.aligned)
      cp_async16(dst, src);
    else
      *reinterpret_cast<uint4*>(dst) = load16(src, false, 16);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// W packed words at p (16 or 8 bytes, aligned).
template <int W>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&x)[W]) {
  if constexpr (W == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = v.x, x[1] = v.y;
  }
}

template <int W>
__device__ __forceinline__ void store_words(uint8_t* p, const uint32_t (&x)[W], bool vec) {
  if (!vec) {
#pragma unroll
    for (int i = 0; i < 4 * W; ++i) p[i] = (uint8_t)(x[i >> 2] >> (8 * (i & 3)));
  } else if constexpr (W == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(x[0], x[1]);
  }
}

// Output rows r0 .. r0 + NR - 1 of the kCsumUnit-byte unit at shared
// offset off of a step (stripe column col).
template <int NR>
__device__ __forceinline__ void csum_products(const GfApplyParams& p, const CsumLayout& L,
                                              int r0, const uint8_t* buf, uint8_t* par,
                                              long long b, long long col, int off) {
  constexpr int W = kCsumWords;
  uint32_t acc[NR][W];
#pragma unroll
  for (int j = 0; j < NR; ++j)
#pragma unroll
    for (int w = 0; w < W; ++w) acc[j][w] = 0u;
  for (int c = 0; c < p.C; ++c) {
    uint32_t x[W];
    load_words<W>(buf + c * L.tpad + off, x);
    uint32_t g[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) g[j] = p.coef[(r0 + j) * p.C + c];
    ladder_acc<NR, W>(acc, x, g);
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int r = r0 + j;
    store_words<W>(p.out[r] + b * p.out_stride[r] + col, acc[j], p.aligned);
    store_words<W>(par + r * L.tpad + off, acc[j], true);
  }
}

// N hash tasks of this warp at once, tasks task0 + n * kCsumWarps: task
// = row * pieces + piece. Each lane hashes its segment of every task,
// the N registers interleaved; then the lanes are joined and lane 0
// writes the piece's zero-init CRC to pcrc[task].
template <int N>
__device__ __forceinline__ void csum_hash(const GfCsumParams& q, const CsumLayout& L,
                                          const uint32_t* t, const uint32_t (&cols)[32],
                                          const uint8_t* buf, const uint8_t* par,
                                          uint32_t* pcrc, int task0, int ntasks) {
  const int lane = threadIdx.x & 31;
  const int C = q.g.C;
  const uint8_t* src[N];
  uint32_t crc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    int task = task0 + n * kCsumWarps;
    if (task >= ntasks) task = task0;  // a spare register: hashed, never written
    const int row = task >> L.lg_pieces;
    const int pc = task - (row << L.lg_pieces);
    src[n] = (row < C ? buf + row * L.tpad : par + (row - C) * L.tpad) +
             (pc * 32 + lane) * L.spad;
    crc[n] = 0u;
  }
  if (L.seg >= 16) {
    for (int o = 0; o < L.seg; o += 16) {
      uint4 v[N];
#pragma unroll
      for (int n = 0; n < N; ++n) v[n] = *reinterpret_cast<const uint4*>(src[n] + o);
#pragma unroll
      for (int n = 0; n < N; ++n) crc[n] = crc_step4<kCsumCopies>(t, crc[n], v[n].x);
#pragma unroll
      for (int n = 0; n < N; ++n) crc[n] = crc_step4<kCsumCopies>(t, crc[n], v[n].y);
#pragma unroll
      for (int n = 0; n < N; ++n) crc[n] = crc_step4<kCsumCopies>(t, crc[n], v[n].z);
#pragma unroll
      for (int n = 0; n < N; ++n) crc[n] = crc_step4<kCsumCopies>(t, crc[n], v[n].w);
    }
  } else {  // 8-byte segments
    uint2 v[N];
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] = *reinterpret_cast<const uint2*>(src[n]);
#pragma unroll
    for (int n = 0; n < N; ++n) crc[n] = crc_step4<kCsumCopies>(t, crc[n], v[n].x);
#pragma unroll
    for (int n = 0; n < N; ++n) crc[n] = crc_step4<kCsumCopies>(t, crc[n], v[n].y);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const uint32_t moved = crc_lane_join(cols, crc[n]);
    if (lane == 0 && task0 + n * kCsumWarps < ntasks) pcrc[task0 + n * kCsumWarps] = moved;
  }
}

// Kernel B. A persistent grid; see the notes at the top.
__global__ void __launch_bounds__(kCsumThreads)
gf_apply_csum_kernel(const __grid_constant__ GfCsumParams q) {
  const GfApplyParams& p = q.g;
  extern __shared__ __align__(16) uint8_t smem[];
  const CsumLayout L(q.tile, q.piece);
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint8_t* bufs = smem + kCsumTabBytes;  // two buffers of C rows
  uint8_t* par = bufs + 2 * p.C * L.tpad;
  uint32_t* pcrc = reinterpret_cast<uint32_t*>(par + p.R * L.tpad);
  const int rows = p.C + p.R;
  const int ntasks = rows * L.pieces;
  const long long windows = p.N >> q.lg_cb;

  crc_fill_tables<kCsumCopies>(tab, reinterpret_cast<uint32_t*>(bufs));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* t = tab + lane % kCsumCopies;
  uint32_t cols[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) cols[j] = __ldg(q.lane_mats + lane * 32 + j);
  uint32_t carry = 0u;  // thread r < rows: row r's window CRC so far

  int k = 0;
  int s = csum_step(q, 0);
  if (s < q.steps) csum_stage(q, L, bufs, s);
  for (int cur = 0; s < q.steps; cur ^= 1) {
    const int ns = csum_step(q, ++k);
    uint8_t* buf = bufs + cur * p.C * L.tpad;
    if (ns < q.steps)
      csum_stage(q, L, bufs + (cur ^ 1) * p.C * L.tpad, ns);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // this step's inputs are in; the last step's hash is done
    const int b = s / q.per_stripe;
    const long long col0 = (long long)(s - b * q.per_stripe) * q.tile;
#ifndef GF_CSUM_NO_PRODUCTS
    for (int u = threadIdx.x; u < q.tile / kCsumUnit; u += blockDim.x) {
      const int off = L.off(u * kCsumUnit);
      const long long col = col0 + u * kCsumUnit;
      for (int r0 = 0; r0 < p.R; r0 += kRowGroup) {
        switch (p.R - r0) {  // uniform over the grid
          case 1: csum_products<1>(p, L, r0, buf, par, b, col, off); break;
          case 2: csum_products<2>(p, L, r0, buf, par, b, col, off); break;
          case 3: csum_products<3>(p, L, r0, buf, par, b, col, off); break;
          default: csum_products<4>(p, L, r0, buf, par, b, col, off); break;
        }
      }
    }
#endif
    __syncthreads();  // the parity tile is in
#ifndef GF_CSUM_NO_HASH
    int task0 = warp;
    for (; task0 + (kCsumIlp - 1) * kCsumWarps < ntasks; task0 += kCsumIlp * kCsumWarps)
      csum_hash<kCsumIlp>(q, L, t, cols, buf, par, pcrc, task0, ntasks);
    for (; task0 < ntasks; task0 += kCsumWarps)
      csum_hash<1>(q, L, t, cols, buf, par, pcrc, task0, ntasks);
#endif
    __syncthreads();  // every piece's CRC is in
    if (threadIdx.x < rows) {
      const int r = threadIdx.x;
      for (int pc = 0; pc < L.pieces; ++pc) {
        const long long pos = col0 + (long long)pc * q.piece;
        const uint32_t v = pcrc[r * L.pieces + pc];
        carry = (pos & (q.cb - 1)) == 0 ? v : gf2_apply(q.piece_mat, carry) ^ v;
        if (((pos + q.piece) & (q.cb - 1)) == 0)
          q.csum[(b * rows + r) * windows + (pos >> q.lg_cb)] = carry;
      }
    }
    s = ns;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

void fill_apply_params(GfApplyParams& p, const unsigned long long* in_ptrs,
                       const long long* in_strides, int C,
                       const unsigned long long* out_ptrs, const long long* out_strides,
                       int R, const unsigned char* coef, long long B, long long N) {
  p.C = C;
  p.R = R;
  p.B = B;
  p.N = N;
  bool aligned = true;
  for (int c = 0; c < C; ++c) {
    p.in[c] = reinterpret_cast<const uint8_t*>(in_ptrs[c]);
    p.in_stride[c] = in_strides[c];
    aligned = aligned && in_ptrs[c] % 16 == 0 && in_strides[c] % 16 == 0;
  }
  for (int r = 0; r < R; ++r) {
    p.out[r] = reinterpret_cast<uint8_t*>(out_ptrs[r]);
    p.out_stride[r] = out_strides[r];
    aligned = aligned && out_ptrs[r] % 16 == 0 && out_strides[r] % 16 == 0;
  }
  for (int i = 0; i < R * C; ++i) p.coef[i] = coef[i];
  p.aligned = aligned;
}

}  // namespace

extern "C" int gf_apply(const unsigned long long* in_ptrs, const long long* in_strides,
                        int C, const unsigned long long* out_ptrs,
                        const long long* out_strides, int R, const unsigned char* coef,
                        long long B, long long N, void* stream) {
  if (C < 1 || C > kMaxRows || R < 1 || R > kMaxRows) return (int)cudaErrorInvalidValue;
  GfApplyParams p;
  fill_apply_params(p, in_ptrs, in_strides, C, out_ptrs, out_strides, R, coef, B, N);
  const long long col_blocks = (N + kApplyTile - 1) / kApplyTile;
  if (B * col_blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  gf_apply_kernel<<<(unsigned int)(B * col_blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(p, col_blocks);
  return (int)cudaGetLastError();
}

// Shared memory of a Kernel B block (ops/cuda_encode.py::csum_smem
// mirrors it): the tables, two buffers of C rows, R parity rows, the
// pieces' CRCs; at least 4 KB past the tables, the fill's scratch.
extern "C" long long gf_apply_csum_smem_bytes(int C, int R, int tile, int piece) {
  const int seg = piece / 32;
  const long long spad = seg >= 32 ? seg + kCsumPad : seg;
  const long long tpad = tile / seg * spad;
  long long rest = (2LL * C + R) * tpad + 4LL * (C + R) * (tile / piece);
  if (rest < 4096) rest = 4096;
  return kCsumTabBytes + rest;
}

static bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

extern "C" int gf_apply_csum(const unsigned long long* in_ptrs, const long long* in_strides,
                             int C, const unsigned long long* out_ptrs,
                             const long long* out_strides, int R,
                             const unsigned char* coef, long long B, long long N,
                             void* csum, long long cb, int tile, int piece,
                             const void* lane_mats, const unsigned int* piece_mat,
                             void* stream) {
  if (C < 1 || C > kMaxRows || R < 1 || R > kMaxRows || B < 0 || !pow2(cb) || cb < 256 ||
      N % cb || !pow2(tile) || tile < 256 || N % tile || (tile % cb && cb % tile) ||
      !pow2(piece) || piece < 256 || tile % piece || cb % piece)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  GfCsumParams q;
  fill_apply_params(q.g, in_ptrs, in_strides, C, out_ptrs, out_strides, R, coef, B, N);
  q.csum = static_cast<uint32_t*>(csum);
  q.lane_mats = static_cast<const uint32_t*>(lane_mats);
  q.cb = cb;
  q.lg_cb = 0;
  while ((1LL << q.lg_cb) < cb) ++q.lg_cb;
  q.tile = tile;
  q.piece = piece;
  if (B * (N / tile) > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  q.steps = (int)(B * (N / tile));
  q.per_stripe = (int)(N / tile);
  q.lg_item_steps = 0;
  while ((tile << q.lg_item_steps) < cb) ++q.lg_item_steps;
  for (int j = 0; j < 32; ++j) q.piece_mat[j] = piece_mat[j];
  const long long smem = gf_apply_csum_smem_bytes(C, R, tile, piece);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gf_apply_csum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // a persistent grid: as many blocks as are resident at once, at most
  // one per item
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gf_apply_csum_kernel,
                                                           kCsumThreads, (size_t)smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = q.steps >> q.lg_item_steps;
  const long long grid = items < (long long)sms * per_sm ? items : (long long)sms * per_sm;
  gf_apply_csum_kernel<<<(unsigned int)grid, kCsumThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(q);
  return (int)cudaGetLastError();
}

extern "C" const char* gf_apply_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
