// GF(2^8)/0x11D arithmetic on packed 32-bit words: four field elements
// per word, one per byte, with no table (gf_apply.cu Kernel A,
// clay_repair.cu Kernels E and F).
#pragma once

#include <stdint.h>

// Every byte of x times 2 (xtime): shift each byte left and reduce the
// bytes whose top bit fell out by the low byte of the polynomial, 0x1D.
__device__ __forceinline__ uint32_t mul2w(uint32_t x) {
  return ((x & 0x7F7F7F7Fu) << 1) ^ (((x >> 7) & 0x01010101u) * 0x1Du);
}

// Every byte of x divided by 2: the inverse of mul2w (0x8E = 0x11D >> 1).
__device__ __forceinline__ uint32_t div2w(uint32_t x) {
  return ((x >> 1) & 0x7F7F7F7Fu) ^ ((x & 0x01010101u) * 0x8Eu);
}
