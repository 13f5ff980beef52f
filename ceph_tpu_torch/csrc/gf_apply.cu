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
// C + R rows without a second pass over device memory: a block owns one
// (stripe, window) and walks it in sub-tiles; each sub-tile's input and
// output bytes are parked in shared memory, and each warp hashes rows
// there with the slicing-by-8 tables of crc32c_common.cuh (lane segments
// joined by a shuffle tree). Sub-tiles chain with
// crc(A||B) = A_len(B) crc(A) ^ crc0(B). Its products still use the
// split-nibble tables (build_mul_tables, mul_acc). Lane segments are
// padded by 16 bytes in shared memory so that the 16-byte reads of a
// quarter warp fall in distinct banks.
#include <cuda_runtime.h>

#include "bytes16.cuh"
#include "crc32c_common.cuh"
#include "gf_word.cuh"

// 16-byte vectors per row a thread of Kernel A owns (the build may
// override it to compare tile widths)
#ifndef GF_APPLY_VEC
#define GF_APPLY_VEC 2
#endif

namespace {

constexpr int kMaxRows = 32;  // ISA caps k and m at 32 (ErasureCodeIsa.h:48-49)
constexpr int kThreads = 256;
constexpr int kRowGroup = 4;  // output rows accumulated per pass
constexpr int kVec = GF_APPLY_VEC;
constexpr int kApplyTile = kThreads * 16 * kVec;  // Kernel A columns per block

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
  uint32_t* csum;       // [B, C + R, N / cb] zero-init CRC32C
  long long cb;         // csum window, a power of two >= 256 dividing N
  int tile;             // sub-tile bytes, a power of two dividing cb
  uint32_t mats[6][32]; // shifts across seg * 2^l bytes (l = 0..4), then tile
};

__device__ __forceinline__ uint8_t gf_mul(uint8_t a, uint8_t b) {
  uint8_t p = 0;
  for (int i = 0; i < 8; ++i) {
    if (b & 1) p ^= a;
    b >>= 1;
    a = (uint8_t)((a << 1) ^ ((a & 0x80) ? 0x1D : 0));
  }
  return p;
}

// Split-nibble product tables: tab[(r*C + c)*32 + j] = G[r][c] * j for
// j < 16 and G[r][c] * ((j - 16) << 4) for j >= 16.
__device__ inline void build_mul_tables(const GfApplyParams& p, uint8_t* tab) {
  const int n = p.R * p.C * 32;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    int j = e & 31;
    uint8_t v = (uint8_t)(j < 16 ? j : (j - 16) << 4);
    tab[e] = gf_mul(p.coef[e >> 5], v);
  }
}

__device__ __forceinline__ uint32_t mul_word(const uint8_t* t, uint32_t w) {
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t b = (w >> (8 * k)) & 0xFFu;
    r |= (uint32_t)(t[b & 15u] ^ t[16 + (b >> 4)]) << (8 * k);
  }
  return r;
}

__device__ __forceinline__ void mul_acc(uint4& acc, const uint8_t* t, uint4 x) {
  acc.x ^= mul_word(t, x.x);
  acc.y ^= mul_word(t, x.y);
  acc.z ^= mul_word(t, x.z);
  acc.w ^= mul_word(t, x.w);
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

// Byte offset of byte i of a sub-tile row in shared memory: lane
// segments of `seg` bytes are spaced `spad` apart (spad = seg + 16 for
// seg >= 16, else seg: unpadded, and a 16-byte group never straddles a
// padded segment because seg is then a multiple of 16).
__device__ __forceinline__ int tile_off(int i, int seg, int spad) {
  return (i / seg) * spad + (i % seg);
}

// Kernel B. Block = (stripe, csum window).
__global__ void __launch_bounds__(kThreads)
gf_apply_csum_kernel(const __grid_constant__ GfCsumParams q, long long windows) {
  const GfApplyParams& p = q.g;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* crc_tab = reinterpret_cast<uint32_t*>(smem);       // 8 KB
  uint32_t* carry = crc_tab + kCrcTableWords;                   // 2 * kMaxRows words
  uint8_t* mul_tab = reinterpret_cast<uint8_t*>(carry + 2 * kMaxRows);
  const int rows = p.C + p.R;
  const int seg = q.tile / 32;
  const int spad = seg >= 16 ? seg + 16 : seg;
  const int pitch = 32 * spad;
  uint8_t* tile = mul_tab + ((p.R * p.C * 32 + 15) & ~15);

  build_mul_tables(p, mul_tab);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) carry[r] = 0u;
  crc_build_tables(crc_tab);  // ends with __syncthreads()

  const long long b = blockIdx.x / windows;
  const long long w = blockIdx.x % windows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int groups = q.tile / 16;  // 16-byte column groups per sub-tile
  for (long long s0 = 0; s0 < q.cb; s0 += q.tile) {
    const long long col0 = w * q.cb + s0;
    for (int t = threadIdx.x; t < groups; t += blockDim.x) {
      const long long col = col0 + 16 * t;
      const int off = tile_off(16 * t, seg, spad);
      for (int c = 0; c < p.C; ++c) {
        *reinterpret_cast<uint4*>(tile + c * pitch + off) =
            load16(p.in[c] + b * p.in_stride[c] + col, p.aligned, 16);
      }
      for (int r0 = 0; r0 < p.R; r0 += kRowGroup) {
        uint4 acc[kRowGroup];
#pragma unroll
        for (int j = 0; j < kRowGroup; ++j) acc[j] = make_uint4(0u, 0u, 0u, 0u);
        for (int c = 0; c < p.C; ++c) {
          const uint4 x = *reinterpret_cast<const uint4*>(tile + c * pitch + off);
#pragma unroll
          for (int j = 0; j < kRowGroup; ++j)
            if (r0 + j < p.R) mul_acc(acc[j], mul_tab + ((r0 + j) * p.C + c) * 32, x);
        }
#pragma unroll
        for (int j = 0; j < kRowGroup; ++j) {
          if (r0 + j >= p.R) continue;
          const int r = r0 + j;
          store16(p.out[r] + b * p.out_stride[r] + col, acc[j], p.aligned, 16);
          *reinterpret_cast<uint4*>(tile + (p.C + r) * pitch + off) = acc[j];
        }
      }
    }
    __syncthreads();
    for (int row = warp; row < rows; row += kThreads / 32) {
      uint32_t crc = crc_update<true>(crc_tab, 0u, tile + row * pitch + lane * spad, seg);
      crc = crc_warp_join(q.mats, crc);
      if (lane == 0) carry[row] = gf2_apply(q.mats[5], carry[row]) ^ crc;
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    q.csum[(b * rows + r) * windows + w] = carry[r];
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

extern "C" int gf_apply_csum_smem_bytes(int C, int R, int tile) {
  const int seg = tile / 32;
  const int spad = seg >= 16 ? seg + 16 : seg;
  return kCrcTableWords * 4 + 2 * kMaxRows * 4 + ((R * C * 32 + 15) & ~15) +
         (C + R) * 32 * spad;
}

extern "C" int gf_apply_csum(const unsigned long long* in_ptrs, const long long* in_strides,
                             int C, const unsigned long long* out_ptrs,
                             const long long* out_strides, int R,
                             const unsigned char* coef, long long B, long long N,
                             void* csum, long long cb, int tile, const unsigned int* mats,
                             void* stream) {
  if (C < 1 || C > kMaxRows || R < 1 || R > kMaxRows || C + R > 2 * kMaxRows ||
      tile < 256 || cb % tile || N % cb)
    return (int)cudaErrorInvalidValue;
  GfCsumParams q;
  fill_apply_params(q.g, in_ptrs, in_strides, C, out_ptrs, out_strides, R, coef, B, N);
  q.csum = static_cast<uint32_t*>(csum);
  q.cb = cb;
  q.tile = tile;
  for (int l = 0; l < 6; ++l)
    for (int j = 0; j < 32; ++j) q.mats[l][j] = mats[l * 32 + j];
  const int smem = gf_apply_csum_smem_bytes(C, R, tile);
  cudaError_t err = cudaFuncSetAttribute(
      gf_apply_csum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long windows = N / cb;
  if (B * windows > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  gf_apply_csum_kernel<<<(unsigned int)(B * windows), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(q, windows);
  return (int)cudaGetLastError();
}

extern "C" const char* gf_apply_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
