// CRC32C building blocks shared by crc32c.cu (Kernel C) and gf_apply.cu
// (Kernel B).
//
// Reflected Castagnoli polynomial, raw register in and out, no final
// XOR: the ceph_crc32c(init, buf, len) contract. Segments are hashed
// ZERO-INIT and joined with the linearity identity
//
//     crc0(A || B) = A_len(B) * crc0(A)  XOR  crc0(B)
//
// where A_n is the 32x32 GF(2) matrix that moves a register across n
// zero bytes (checksum/crc32c.py::zero_gap_matrix). The host passes
// each A_n as 32 packed columns: col[j] = A_n * e_j.
//
// Lookups go through slicing-by-4 tables (T_k[e]: the register after
// byte e and k zero bytes) replicated kCopies times in shared memory,
// word ((k * 256 + e) * kCopies + lane % kCopies): with 16 copies two
// lanes of a warp share a bank at most, whatever the data.
#pragma once

#include <cstdint>

constexpr uint32_t kCrc32cPoly = 0x82F63B78u;

template <int kCopies>
__host__ __device__ constexpr int crc_table_words() {
  return 4 * 256 * kCopies;
}

// Fill the replicated tables `tab`, with `base` (1,024 words that may
// alias memory the block uses later) as scratch for the four base
// tables. Every thread of the block must call this; it ends with
// __syncthreads().
template <int kCopies>
__device__ inline void crc_fill_tables(uint32_t* tab, uint32_t* base) {
  for (int f = threadIdx.x; f < 4 * 256; f += blockDim.x) {
    uint32_t c = f & 0xFF;
    for (int bit = 0; bit < 8 * (1 + (f >> 8)); ++bit)
      c = (c >> 1) ^ ((c & 1u) ? kCrc32cPoly : 0u);
    base[f] = c;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < crc_table_words<kCopies>(); f += blockDim.x)
    tab[f] = base[f / kCopies];
  __syncthreads();
}

// t is the lane's copy: tab + lane % kCopies.
template <int kCopies>
__device__ __forceinline__ uint32_t crc_tab_at(const uint32_t* t, int k, uint32_t e) {
  return t[(k * 256 + (int)e) * kCopies];
}

// Four bytes, one little-endian word, into the register.
template <int kCopies>
__device__ __forceinline__ uint32_t crc_step4(const uint32_t* t, uint32_t crc, uint32_t w) {
  const uint32_t a = crc ^ w;
  return crc_tab_at<kCopies>(t, 3, a & 0xFFu) ^ crc_tab_at<kCopies>(t, 2, (a >> 8) & 0xFFu) ^
         crc_tab_at<kCopies>(t, 1, (a >> 16) & 0xFFu) ^ crc_tab_at<kCopies>(t, 0, a >> 24);
}

template <int kCopies>
__device__ __forceinline__ uint32_t crc_step1(const uint32_t* t, uint32_t crc, uint32_t byte) {
  return crc_tab_at<kCopies>(t, 0, (crc ^ byte) & 0xFFu) ^ (crc >> 8);
}

// Multiply register v by the GF(2) matrix given as 32 packed columns.
__device__ __forceinline__ uint32_t gf2_apply(const uint32_t* cols, uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) r ^= cols[j] & (0u - ((v >> j) & 1u));
  return r;
}

// The one-level join of the zero-init CRCs of 32 consecutive equal
// segments, lane i holding segment i: each lane moves its CRC to the end
// of the run with its own shift matrix (cols: A_{(31 - i) * seg}, the
// identity for lane 31) and one XOR shuffle reduction sums the lanes.
// Every lane returns the CRC of the whole run.
__device__ __forceinline__ uint32_t crc_lane_join(const uint32_t (&cols)[32], uint32_t crc) {
  uint32_t moved = 0u;
#pragma unroll
  for (int j = 0; j < 32; ++j) moved ^= cols[j] & (uint32_t)((int32_t)(crc << (31 - j)) >> 31);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) moved ^= __shfl_xor_sync(0xFFFFFFFFu, moved, off);
  return moved;
}
