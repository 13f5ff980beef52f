// CRC32C building blocks shared by crc32c.cu and gf_apply.cu.
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
#pragma once

#include <cstdint>

constexpr uint32_t kCrc32cPoly = 0x82F63B78u;
constexpr int kCrcTableWords = 8 * 256;  // slicing-by-8

// Fill the slicing-by-8 tables in shared memory: t[k][i] is the
// register after byte i followed by k zero bytes. Every thread of the
// block must call this; it ends with __syncthreads().
__device__ inline void crc_build_tables(uint32_t* t) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1u) ? kCrc32cPoly : 0u);
    t[i] = c;
  }
  __syncthreads();
  for (int k = 1; k < 8; ++k) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
      uint32_t prev = t[(k - 1) * 256 + i];
      t[k * 256 + i] = (prev >> 8) ^ t[prev & 0xFFu];
    }
    __syncthreads();
  }
}

// One slicing-by-8 step over 8 bytes given as two little-endian words.
__device__ __forceinline__ uint32_t crc_step8(const uint32_t* t, uint32_t crc,
                                              uint32_t lo, uint32_t hi) {
  uint32_t a = crc ^ lo;
  return t[7 * 256 + (a & 0xFFu)] ^ t[6 * 256 + ((a >> 8) & 0xFFu)] ^
         t[5 * 256 + ((a >> 16) & 0xFFu)] ^ t[4 * 256 + (a >> 24)] ^
         t[3 * 256 + (hi & 0xFFu)] ^ t[2 * 256 + ((hi >> 8) & 0xFFu)] ^
         t[1 * 256 + ((hi >> 16) & 0xFFu)] ^ t[hi >> 24];
}

__device__ __forceinline__ uint32_t crc_step1(const uint32_t* t, uint32_t crc,
                                              uint32_t byte) {
  return t[(crc ^ byte) & 0xFFu] ^ (crc >> 8);
}

// Continue register `crc` over len bytes at p. With kAligned, p must be
// 16-byte aligned: whole 16-byte chunks go through vector loads (two
// slicing steps each), an 8-byte remainder through one more step, and
// the rest byte by byte. Without it every byte is loaded on its own.
template <bool kAligned>
__device__ inline uint32_t crc_update(const uint32_t* t, uint32_t crc,
                                      const uint8_t* p, long long len) {
  if (kAligned) {
    while (len >= 16) {
      uint4 v = *reinterpret_cast<const uint4*>(p);
      crc = crc_step8(t, crc, v.x, v.y);
      crc = crc_step8(t, crc, v.z, v.w);
      p += 16;
      len -= 16;
    }
    if (len >= 8) {
      uint2 v = *reinterpret_cast<const uint2*>(p);
      crc = crc_step8(t, crc, v.x, v.y);
      p += 8;
      len -= 8;
    }
  }
  for (long long i = 0; i < len; ++i) crc = crc_step1(t, crc, p[i]);
  return crc;
}

// Multiply register v by the GF(2) matrix given as 32 packed columns.
__device__ __forceinline__ uint32_t gf2_apply(const uint32_t* cols, uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) r ^= cols[j] & (0u - ((v >> j) & 1u));
  return r;
}

// Join the zero-init CRCs of the 32 consecutive equal segments a warp's
// lanes hashed (lane i holds segment i). mats[l] moves a register
// across seg * 2^l bytes, l = 0..4. Lane 0 returns the zero-init CRC of
// the whole 32-segment run; the other lanes' results are partial.
__device__ inline uint32_t crc_warp_join(const uint32_t (*mats)[32], uint32_t crc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    uint32_t right = __shfl_down_sync(0xFFFFFFFFu, crc, 1 << l);
    uint32_t shifted = gf2_apply(mats[l], crc);
    if ((lane & ((2 << l) - 1)) == 0) crc = shifted ^ right;
  }
  return crc;
}
