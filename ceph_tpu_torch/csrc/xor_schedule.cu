// Kernel D: XOR-schedule apply. out[q] = XOR of the packets (and scratch
// intermediates) that the schedule's program names, for every stripe.
//
// Replaces the Pallas kernels
//   ceph_tpu/ops/xor_schedule.py::xor_schedule_apply (_sched_fn, K6)
//   ceph_tpu/ops/xor_schedule.py::xor_schedule_apply_shards (_sched_shards_fn, K7)
// The TPU compiled one kernel per schedule; here one compiled kernel
// interprets the schedule as data, so the many distinct decode programs
// (one per erasure pattern) cost no compile. The program is a flat int32
// array built on the host (ops/cuda_xor.py::encode_program) and uploaded
// once per (schedule, form):
//
//   n_used, then n_used packet codes: the input packets the program
//     reads, in first-read order (source index i names the i-th);
//   per op: n_in | n_slot << 16, dst, n_in source indices, n_slot slots
//     (dst >= 0: the output packet code; dst < 0: scratch slot -1 - dst)
//
// A packet code is shard << 24 | packet within the shard. Every shard is
// a pointer plus a stripe stride, so one launcher serves both forms: the
// stacked [B, KW, P] form is one shard of KW packets, the per-shard form
// n shards of w packets (w = 1: whole chunks, the LRC local-repair and
// xor-plugin rows). The host resolves each packet to its code, so the
// kernel divides nothing; nothing is stacked or copied.
//
// Bound: device memory. An apply must read every input packet once and
// write every output packet once, (KW + MW) * P * B bytes; the XORs are
// a few integer ops per 16 bytes. The first port (one 16-byte column a
// thread, the program read from global memory source by source) ran at
// 2.0x that bound: an input packet named by several ops was read from
// device memory again (1.9 reads a packet in the liberation encode), and
// each op's loads issued one behind another behind the program reads.
// Two forms now, both with the program and the used packets' row
// pointers in shared memory, read once a block (a short program stays
// in device memory, read through L1, and the block skips that set-up
// and its barrier):
//
// - Staged (the rule: 16-byte aligned shards and P a multiple of 16).
//   A thread owns one 16-byte column of every used packet and copies all
//   of them into its own shared-memory rows with cp.async before it XORs
//   anything: every input is read from device memory exactly once, and a
//   thread has as many loads in flight as the program has inputs. The
//   rows are private to their thread, so no barrier follows the copy.
//   Intermediates live beside them, [n_slots][blockDim] uint4.
// - Direct (unaligned data, or more inputs than shared memory can stage).
//   A thread owns kVec 16-byte columns a block width apart and loads an
//   op's sources from device memory in unrolled batches of kBatch, each
//   batch in flight together; intermediates as above, kVec per slot.
//
// The host (ops/cuda_xor.py::launch_plan) picks the form, the threads a
// block and what shared memory holds; this launcher checks the choice.
#include <cuda_runtime.h>

#include <cstdint>

#include "bytes16.cuh"

// The build may override this to compare designs.
#ifndef XOR_VEC
#define XOR_VEC 2  // direct form: 16-byte columns a thread owns
#endif

namespace {

constexpr int kMaxShards = 64;
constexpr int kThreads = 256;  // direct form: threads a block, at most
constexpr int kVec = XOR_VEC;
constexpr int kBatch = 4;           // direct form: source loads issued together
constexpr int kStageThreads = 128;  // staged form: threads a block, at most
constexpr int kSmemMax = 232448;  // per-block opt-in maximum on sm_90
constexpr int kCodeBits = 24;
constexpr int kCodeMask = (1 << kCodeBits) - 1;

struct XorParams {
  const uint8_t* in[kMaxShards];
  long long in_stride[kMaxShards];  // bytes between stripes
  uint8_t* out[kMaxShards];
  long long out_stride[kMaxShards];
  const int* prog;
  int prog_len;
  int n_used;        // prog[0]
  int table;         // the used packets' row pointers in shared memory
  int prog_in_smem;  // the program copied into shared memory
  long long P;
  long long tiles;   // column tiles per stripe
  int aligned;       // every shard pointer, stripe stride and P a multiple of 16
};

__device__ __forceinline__ void xor16(uint4& acc, const uint4 x) {
  acc.x ^= x.x;
  acc.y ^= x.y;
  acc.z ^= x.z;
  acc.w ^= x.w;
}

__device__ __forceinline__ uint8_t* out_row(const XorParams& p, int code, long long b) {
  const int sh = code >> kCodeBits;
  return p.out[sh] + b * p.out_stride[sh] + (long long)(code & kCodeMask) * p.P;
}

__device__ __forceinline__ const uint8_t* in_row(const XorParams& p, int code, long long b) {
  const int sh = code >> kCodeBits;
  return p.in[sh] + b * p.in_stride[sh] + (long long)(code & kCodeMask) * p.P;
}

// Shared memory: [row pointer table][program][rows and slots]. Fills the
// first two for stripe b where the host placed them there (all threads,
// then one barrier) and returns the third.
__device__ __forceinline__ uint8_t* block_setup(const XorParams& p, long long b,
                                                uint8_t* smem, const int*& prog,
                                                const uint8_t* const*& tab) {
  uint8_t* rest = smem;
  tab = nullptr;
  if (p.table) {
    const uint8_t** t = reinterpret_cast<const uint8_t**>(rest);
    for (int i = threadIdx.x; i < p.n_used; i += blockDim.x)
      t[i] = in_row(p, __ldg(p.prog + 1 + i), b);
    tab = t;
    rest += (p.n_used * 8 + 15) & ~15;
  }
  prog = p.prog;
  if (p.prog_in_smem) {
    int* s = reinterpret_cast<int*>(rest);
    for (int i = threadIdx.x; i < p.prog_len; i += blockDim.x) s[i] = __ldg(p.prog + i);
    prog = s;
    rest += (p.prog_len * 4 + 15) & ~15;
  }
  if (p.table || p.prog_in_smem) __syncthreads();
  return rest;
}

// Used packet i's row in stripe b.
__device__ __forceinline__ const uint8_t* source_row(const XorParams& p, const int* prog,
                                                     const uint8_t* const* tab, int i,
                                                     long long b) {
  return tab ? tab[i] : in_row(p, prog[1 + i], b);
}

// Staged form. Block = (stripe, blockDim * 16 columns); thread t owns the
// 16 bytes at column tile + 16 t of every used packet.
__global__ void __launch_bounds__(kStageThreads)
xor_schedule_staged_kernel(const __grid_constant__ XorParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const long long b = blockIdx.x / p.tiles;
  const long long col = ((blockIdx.x % p.tiles) * blockDim.x + threadIdx.x) * 16;
  const int* prog;
  const uint8_t* const* tab;
  uint4* mine = reinterpret_cast<uint4*>(block_setup(p, b, smem, prog, tab)) + threadIdx.x;
  if (col >= p.P) return;
  const int nt = blockDim.x;
  for (int i = 0; i < p.n_used; ++i)
    cp_async16(mine + (size_t)i * nt, source_row(p, prog, tab, i, b) + col);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  uint4* slots = mine + (size_t)p.n_used * nt;  // this thread's slot 0
  int pc = 1 + p.n_used;
  while (pc < p.prog_len) {
    const int w0 = prog[pc], dst = prog[pc + 1];
    const int n_in = w0 & 0xFFFF, n_slot = w0 >> 16;
    pc += 2;
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    for (int s = 0; s < n_in; ++s) xor16(acc, mine[(size_t)prog[pc + s] * nt]);
    pc += n_in;
    for (int s = 0; s < n_slot; ++s) xor16(acc, slots[(size_t)prog[pc + s] * nt]);
    pc += n_slot;
    if (dst < 0)
      slots[(size_t)(-1 - dst) * nt] = acc;
    else
      *reinterpret_cast<uint4*>(out_row(p, dst, b) + col) = acc;
  }
}

// Direct form. Block = (stripe, blockDim * 16 * kVec columns); thread t
// owns the 16-byte columns at tile + (v * blockDim + t) * 16, v < kVec.
__global__ void __launch_bounds__(kThreads)
xor_schedule_direct_kernel(const __grid_constant__ XorParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const long long b = blockIdx.x / p.tiles;
  const long long col0 = (blockIdx.x % p.tiles) * ((long long)blockDim.x * 16 * kVec);
  const int* prog;
  const uint8_t* const* tab;
  uint4* slots = reinterpret_cast<uint4*>(block_setup(p, b, smem, prog, tab)) + threadIdx.x;
  long long col[kVec], avail[kVec];
  bool vec[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    col[v] = col0 + ((long long)v * blockDim.x + threadIdx.x) * 16;
    avail[v] = p.P - col[v];  // <= 0: past the row end, nothing loaded or stored
    vec[v] = p.aligned && avail[v] >= 16;
  }
  if (avail[0] <= 0) return;
  const int nt = blockDim.x;
  int pc = 1 + p.n_used;
  while (pc < p.prog_len) {
    const int w0 = prog[pc], dst = prog[pc + 1];
    const int n_in = w0 & 0xFFFF, n_slot = w0 >> 16;
    pc += 2;
    uint4 acc[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) acc[v] = make_uint4(0u, 0u, 0u, 0u);
    int s = 0;
    for (; s + kBatch <= n_in; s += kBatch) {  // kBatch * kVec loads in flight
      uint4 x[kBatch][kVec];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const uint8_t* row = source_row(p, prog, tab, prog[pc + s + i], b);
#pragma unroll
        for (int v = 0; v < kVec; ++v) x[i][v] = load16(row + col[v], vec[v], avail[v]);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
#pragma unroll
        for (int v = 0; v < kVec; ++v) xor16(acc[v], x[i][v]);
    }
    for (; s < n_in; ++s) {
      const uint8_t* row = source_row(p, prog, tab, prog[pc + s], b);
#pragma unroll
      for (int v = 0; v < kVec; ++v) xor16(acc[v], load16(row + col[v], vec[v], avail[v]));
    }
    pc += n_in;
    for (int s2 = 0; s2 < n_slot; ++s2) {
      const uint4* slot = slots + (size_t)prog[pc + s2] * kVec * nt;
#pragma unroll
      for (int v = 0; v < kVec; ++v) xor16(acc[v], slot[v * nt]);
    }
    pc += n_slot;
    if (dst < 0) {
      uint4* slot = slots + (size_t)(-1 - dst) * kVec * nt;
#pragma unroll
      for (int v = 0; v < kVec; ++v) slot[v * nt] = acc[v];
    } else {
      uint8_t* row = out_row(p, dst, b);
#pragma unroll
      for (int v = 0; v < kVec; ++v) store16(row + col[v], acc[v], vec[v], avail[v]);
    }
  }
}

}  // namespace

// Shared memory a block of `threads` needs: the pointer table and the
// program where the host placed them, then staged rows and slots.
extern "C" long long xor_schedule_smem_bytes(int staged, int threads, int n_used, int n_slots,
                                             int prog_len, int table, int prog_in_smem) {
  long long bytes = 0;
  if (table) bytes += (n_used * 8LL + 15) & ~15LL;
  if (prog_in_smem) bytes += (prog_len * 4LL + 15) & ~15LL;
  if (staged) return bytes + (long long)(n_used + n_slots) * threads * 16;
  return bytes + (long long)n_slots * kVec * threads * 16;
}

extern "C" int xor_schedule(const unsigned long long* in_ptrs, const long long* in_strides,
                            int n_in, const unsigned long long* out_ptrs,
                            const long long* out_strides, int n_out, const int* prog,
                            int prog_len, int n_used, int n_slots, long long B, long long P,
                            int staged, int threads, int table, int prog_in_smem,
                            void* stream) {
  if (n_in < 1 || n_in > kMaxShards || n_out < 1 || n_out > kMaxShards || prog_len < 1 ||
      n_used < 0 || n_used >= prog_len || n_slots < 0 || B < 0 || P < 0 || threads < 32 ||
      threads % 32 || threads > (staged ? kStageThreads : kThreads))
    return (int)cudaErrorInvalidValue;
  XorParams p;
  bool aligned = P % 16 == 0;
  for (int i = 0; i < n_in; ++i) {
    p.in[i] = reinterpret_cast<const uint8_t*>(in_ptrs[i]);
    p.in_stride[i] = in_strides[i];
    aligned = aligned && in_ptrs[i] % 16 == 0 && in_strides[i] % 16 == 0;
  }
  for (int i = 0; i < n_out; ++i) {
    p.out[i] = reinterpret_cast<uint8_t*>(out_ptrs[i]);
    p.out_stride[i] = out_strides[i];
    aligned = aligned && out_ptrs[i] % 16 == 0 && out_strides[i] % 16 == 0;
  }
  if (staged && !aligned) return (int)cudaErrorInvalidValue;
  p.prog = prog;
  p.prog_len = prog_len;
  p.n_used = n_used;
  p.table = table;
  p.prog_in_smem = prog_in_smem;
  p.P = P;
  p.aligned = aligned;
  const long long smem =
      xor_schedule_smem_bytes(staged, threads, n_used, n_slots, prog_len, table, prog_in_smem);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const void* kern = staged ? (const void*)xor_schedule_staged_kernel : (const void*)xor_schedule_direct_kernel;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long tile = (long long)threads * 16 * (staged ? 1 : kVec);
  p.tiles = (P + tile - 1) / tile;
  const long long n_tiles = B * p.tiles;
  if (n_tiles == 0) return (int)cudaSuccess;
  if (n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  if (staged)
    xor_schedule_staged_kernel<<<(unsigned int)n_tiles, threads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(p);
  else
    xor_schedule_direct_kernel<<<(unsigned int)n_tiles, threads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* xor_schedule_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
