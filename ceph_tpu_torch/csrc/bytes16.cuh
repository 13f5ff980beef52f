// 16-byte row accesses shared by the byte-column kernels (gf_apply.cu,
// xor_schedule.cu): one uint4 when the row is 16-byte aligned and at
// least 16 bytes remain, else byte by byte up to the ragged row end; and
// the 16-byte asynchronous copy into shared memory (gf_apply.cu,
// xor_schedule.cu, crc32c.cu), both addresses 16-byte aligned.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Load up to 16 bytes (fewer at a ragged row end), zero-filled.
__device__ __forceinline__ uint4 load16(const uint8_t* p, bool vec, long long avail) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16 && i < avail; ++i) w[i >> 2] |= (uint32_t)p[i] << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(uint8_t* p, uint4 v, bool vec, long long avail) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  for (int i = 0; i < 16 && i < avail; ++i) p[i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
