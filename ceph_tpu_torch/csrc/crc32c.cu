// Kernel C: batched per-block CRC32C, crc[b] = ceph_crc32c(init, data[b], L).
//
// Replaces the Pallas fold ceph_tpu/checksum/pallas_crc.py:141
// crc32c_fold_pallas (_fold_tiled / _make_kernel). The TPU has no
// byte-table lookup, so it folds unpacked bit planes on the MXU; this
// card has fast shared-memory lookups, so each lane runs a table-driven
// CRC instead.
//
// Bound: device memory, L bytes read and 4 bytes written per block. On
// the way there stand two costs of a table CRC on a warp, both of which
// held the first port to 2.6x its bound: (1) a lane hashing its own
// contiguous segment makes every 16-byte warp load touch 32 lines, and
// (2) the data-indexed lookups of 32 lanes into one shared table fall on
// 3-4 lanes per bank. The design:
//
// - One warp per CRC block, as before: lane i hashes the contiguous
//   segment [i*seg, (i+1)*seg), seg = L / 32, zero-init; lane 0 continues
//   over the L % 32 tail bytes and XORs in A_L * init (seed_xor).
// - Staged reads. When the data is 16-byte aligned and L % 512 == 0 the
//   warp copies each pass of `piece` bytes of every lane's segment (up to
//   4 KiB) into a shared-memory buffer with cp.async 16-byte copies whose
//   lanes walk each piece contiguously; the warp's next (block, pass)
//   tile copies into a second buffer while the lanes hash this one.
//   Pieces are padded by 16 bytes so a quarter warp's 16-byte reads hit
//   distinct banks. Other blocks (unaligned base, ragged L) load bytes
//   directly.
// - Lookups nearly free of conflicts: crc32c_common.cuh's slicing-by-4
//   tables replicated kCopies times (with 32 copies lane l always reads
//   bank l whatever the data, 128 KB; with 16 two lanes share a bank at
//   most, 64 KB). Kernel B shares these tables and lookups.
// - A one-level join (crc_lane_join). Lane i moves its segment's CRC to
//   the end of the 32-segment run with one 32x32 GF(2) matrix,
//   A_{(31-i)*seg}, held in registers (the host builds the matrices),
//   and a five-step XOR shuffle reduction sums the lanes.
// - A persistent grid of as many blocks as fit on the card at once;
//   warps stride over CRC blocks, so the table fill is paid once per
//   resident block, not once per eight CRC blocks.
// What won, by experiments/torch_kernel_variants.py on an H100 80GB
// HBM3 over 96 MiB in 4 KiB blocks: 16 copies and 16 warps a block
// (0.0475 ms, against a 0.0301 ms byte bound) over 32 copies and 8 warps
// (0.0558 ms: shared memory caps the warps per SM, and more warps beat
// the rarer conflicts), and 128-byte pieces over 64 (equal at 4 KiB
// blocks, 0.053 against 0.065 ms at 64 KiB). What holds it back now is
// the shared-memory lookup stream, one 4-byte lookup per byte hashed,
// and the serial dependency of each lane's CRC register.
// No cross-block state, so blocks run in any order on any SM.
#include <cuda_runtime.h>

#include "bytes16.cuh"
#include "crc32c_common.cuh"

// The build may override these to compare designs.
#ifndef CRC_TABLE_COPIES
#define CRC_TABLE_COPIES 16
#endif
#ifndef CRC_WARPS
#define CRC_WARPS 16
#endif
#ifndef CRC_MAX_PIECE
#define CRC_MAX_PIECE 128
#endif

namespace {

constexpr int kCopies = CRC_TABLE_COPIES;
constexpr int kWarps = CRC_WARPS;
constexpr int kTabWords = crc_table_words<kCopies>();
constexpr int kMatPitch = 33;  // padded rows: lane i's reads of row i miss no bank
constexpr int kMaxPiece = CRC_MAX_PIECE;  // staged bytes per lane segment and pass
constexpr int kStageBytes = 32 * (kMaxPiece + 16);  // one of a warp's two buffers

struct Crc32cParams {
  const uint8_t* data;  // [B, L] contiguous
  uint32_t* out;        // [B]
  long long nblocks;
  long long block_bytes;
  uint32_t seed_xor;      // A_L * init: crc(init, x) = crc(0, x) ^ seed_xor
  int piece;              // staged bytes per segment and pass; 0: direct loads
  uint32_t mats[31][32];  // lane i < 31: shift across (31 - i) * seg bytes
};                        // (lane 31's is the identity)

constexpr size_t smem_bytes() {
  return (size_t)kTabWords * 4 + 32 * kMatPitch * 4 + (size_t)kWarps * 2 * kStageBytes;
}

__device__ __forceinline__ uint32_t step4(const uint32_t* t, uint32_t crc, uint32_t w) {
  return crc_step4<kCopies>(t, crc, w);
}

__device__ __forceinline__ uint32_t step1(const uint32_t* t, uint32_t crc, uint32_t byte) {
  return crc_step1<kCopies>(t, crc, byte);
}

// Continue the register over len bytes at p, loaded one by one.
__device__ __forceinline__ uint32_t hash_bytes(const uint32_t* t, uint32_t crc,
                                               const uint8_t* p, long long len) {
  for (; len >= 4; len -= 4, p += 4)
    crc = step4(t, crc, p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
                            (uint32_t)p[3] << 24);
  for (; len > 0; --len) crc = step1(t, crc, *p++);
  return crc;
}

// Copy one pass of the staged path into a buffer, asynchronously: unit
// u = lane + 32m (16 bytes) is byte 16 * (u % nu) of piece u / nu, where
// piece i is the pass's bytes of segment i and nu = piece / 16; pieces
// lie spad bytes apart. One commit group per pass.
__device__ __forceinline__ void stage_pass(uint8_t* buf, const uint8_t* src, long long seg,
                                           int nu, int lg, int spad) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < kMaxPiece / 16; ++m) {
    const int u = lane + 32 * m;
    if (m < nu) {
      const int off = (u & (nu - 1)) << 4;
      cp_async16(buf + (u >> lg) * spad + off, src + (u >> lg) * seg + off);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The lane's CRC moved to the end of the warp's 32 segments (cols: its
// shift matrix), summed over the lanes; lane 0 continues over the tail
// and writes the block's CRC.
__device__ __forceinline__ void finish(const Crc32cParams& p, const uint32_t* t,
                                       const uint32_t (&cols)[32], long long blk,
                                       uint32_t crc) {
  const uint32_t moved = crc_lane_join(cols, crc);
  if ((threadIdx.x & 31) == 0) {
    const long long seg = p.block_bytes / 32;
    crc = hash_bytes(t, moved, p.data + blk * p.block_bytes + 32 * seg,
                     p.block_bytes - 32 * seg);
    p.out[blk] = crc ^ p.seed_xor;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
crc32c_blocks_kernel(const __grid_constant__ Crc32cParams p) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tab = smem;
  uint32_t* mats = tab + kTabWords;
  uint8_t* stages = reinterpret_cast<uint8_t*>(mats + 32 * kMatPitch);

  for (int f = threadIdx.x; f < 32 * 32; f += blockDim.x)
    mats[(f >> 5) * kMatPitch + (f & 31)] =
        f < 31 * 32 ? p.mats[f >> 5][f & 31] : 1u << (f & 31);
  // base tables in the stage buffers, then kCopies copies of each word
  crc_fill_tables<kCopies>(tab, reinterpret_cast<uint32_t*>(stages));

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* t = tab + lane % kCopies;
  uint32_t cols[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) cols[j] = mats[lane * kMatPitch + j];

  const long long seg = p.block_bytes / 32;
  const long long stride = (long long)gridDim.x * kWarps;
  long long blk = (long long)blockIdx.x * kWarps + warp;
  if (!p.piece) {
    for (; blk < p.nblocks; blk += stride)
      finish(p, t, cols, blk, hash_bytes(t, 0u, p.data + blk * p.block_bytes + lane * seg, seg));
    return;
  }
  // staged: the warp walks its (block, pass) tiles, copying tile n + 1
  // into one buffer while its lanes hash tile n from the other
  const int nu = p.piece / 16;
  const int lg = __ffs(nu) - 1;
  const int spad = p.piece == 16 ? 16 : p.piece + 16;
  const long long passes = seg / p.piece;
  uint8_t* const bufs = stages + warp * 2 * kStageBytes;  // two buffers
  if (blk < p.nblocks) stage_pass(bufs, p.data + blk * p.block_bytes, seg, nu, lg, spad);
  long long ps = 0;
  uint32_t crc = 0u;
  for (int cur = 0; blk < p.nblocks; cur ^= 1) {
    long long nblk = blk, nps = ps + 1;
    if (nps == passes) {
      nps = 0;
      nblk += stride;
    }
    if (nblk < p.nblocks)
      stage_pass(bufs + (cur ^ 1) * kStageBytes,
                 p.data + nblk * p.block_bytes + nps * p.piece, seg, nu, lg, spad);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    const uint8_t* mine = bufs + cur * kStageBytes + lane * spad;
    for (int q = 0; q < nu; ++q) {
      const uint4 v = *reinterpret_cast<const uint4*>(mine + 16 * q);
      crc = step4(t, crc, v.x);
      crc = step4(t, crc, v.y);
      crc = step4(t, crc, v.z);
      crc = step4(t, crc, v.w);
    }
    if (nps == 0) {
      finish(p, t, cols, blk, crc);
      crc = 0u;
    }
    __syncwarp();  // every lane is done with this buffer before it is refilled
    blk = nblk;
    ps = nps;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

extern "C" int crc32c_blocks(const void* data, void* out, long long nblocks,
                             long long block_bytes, unsigned int seed_xor,
                             const unsigned int* mats, void* stream) {
  if (nblocks < 0 || block_bytes < 1) return (int)cudaErrorInvalidValue;
  if (nblocks == 0) return (int)cudaSuccess;
  Crc32cParams p;
  p.data = static_cast<const uint8_t*>(data);
  p.out = static_cast<uint32_t*>(out);
  p.nblocks = nblocks;
  p.block_bytes = block_bytes;
  p.seed_xor = seed_xor;
  p.piece = 0;
  if (reinterpret_cast<uintptr_t>(data) % 16 == 0 && block_bytes % 512 == 0) {
    const long long seg = block_bytes / 32;  // a multiple of 16
    p.piece = kMaxPiece;
    while (seg % p.piece) p.piece /= 2;
  }
  for (int i = 0; i < 31; ++i)
    for (int j = 0; j < 32; ++j) p.mats[i][j] = mats[i * 32 + j];

  // a persistent grid: as many blocks as are resident at once, at most
  // one warp per CRC block
  const int smem = (int)smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      crc32c_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crc32c_blocks_kernel,
                                                           kWarps * 32, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long need = (nblocks + kWarps - 1) / kWarps;
  const long long grid = need < (long long)sms * per_sm ? need : (long long)sms * per_sm;
  crc32c_blocks_kernel<<<(unsigned int)grid, kWarps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* crc32c_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
