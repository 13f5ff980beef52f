// Kernel C: batched per-block CRC32C, crc[b] = ceph_crc32c(init, data[b], L).
//
// Replaces the Pallas fold ceph_tpu/checksum/pallas_crc.py::crc32c_fold_pallas
// (_fold_tiled / _make_kernel). The TPU has no byte-table lookup, so it
// folds unpacked bit planes on the MXU; this card has fast shared-memory
// lookups, so each lane runs a table-driven CRC instead.
//
// Bound: device memory. The work is L bytes read and 4 bytes written per
// block; per byte a lane does one table lookup (slicing-by-8: eight
// lookups per 8 bytes), which the 8 KB table in shared memory serves
// without going back to device memory.
//
// Design: one warp per block. Lane i hashes the contiguous segment
// [i*seg, (i+1)*seg), seg = L / 32, zero-init; a five-level shuffle tree
// joins the 32 segment CRCs with 32x32 GF(2) shift matrices built on the
// host from zero_gap_matrix; lane 0 then continues the register over the
// L % 32 tail bytes and XORs in A_L * init (seed_xor, also from the host).
// No cross-block state, so blocks run in any order on any SM.
#include <cuda_runtime.h>

#include "crc32c_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

struct Crc32cParams {
  const uint8_t* data;  // [B, L] contiguous
  uint32_t* out;        // [B]
  long long nblocks;
  long long block_bytes;
  uint32_t seed_xor;     // A_L * init: crc(init, x) = crc(0, x) ^ seed_xor
  int aligned;           // data 16-byte aligned and L % 512 == 0
  uint32_t mats[5][32];  // shift across seg * 2^l bytes
};

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
crc32c_blocks_kernel(const __grid_constant__ Crc32cParams p) {
  __shared__ uint32_t tables[kCrcTableWords];
  crc_build_tables(tables);

  const int lane = threadIdx.x & 31;
  const long long blk = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (blk >= p.nblocks) return;  // whole warps leave together
  const long long seg = p.block_bytes / 32;
  const uint8_t* base = p.data + blk * p.block_bytes;
  const uint8_t* mine = base + lane * seg;
  uint32_t crc = p.aligned ? crc_update<true>(tables, 0u, mine, seg)
                           : crc_update<false>(tables, 0u, mine, seg);
  crc = crc_warp_join(p.mats, crc);
  if (lane == 0) {
    crc = crc_update<false>(tables, crc, base + 32 * seg, p.block_bytes - 32 * seg);
    p.out[blk] = crc ^ p.seed_xor;
  }
}

}  // namespace

extern "C" int crc32c_blocks(const void* data, void* out, long long nblocks,
                             long long block_bytes, unsigned int seed_xor,
                             const unsigned int* mats, void* stream) {
  Crc32cParams p;
  p.data = static_cast<const uint8_t*>(data);
  p.out = static_cast<uint32_t*>(out);
  p.nblocks = nblocks;
  p.block_bytes = block_bytes;
  p.seed_xor = seed_xor;
  p.aligned = (reinterpret_cast<uintptr_t>(data) % 16 == 0) && (block_bytes % 512 == 0);
  for (int l = 0; l < 5; ++l)
    for (int j = 0; j < 32; ++j) p.mats[l][j] = mats[l * 32 + j];
  const long long grid = (nblocks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  crc32c_blocks_kernel<<<(unsigned int)grid, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* crc32c_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
