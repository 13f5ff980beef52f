// Kernel D: XOR-schedule apply. out[q] = XOR of the packets (and scratch
// intermediates) that the schedule's program names, for every stripe.
//
// Replaces the Pallas kernels
//   ceph_tpu/ops/xor_schedule.py::xor_schedule_apply (_sched_fn, K6)
//   ceph_tpu/ops/xor_schedule.py::xor_schedule_apply_shards (_sched_shards_fn, K7)
// The TPU compiled one kernel per schedule; here one compiled kernel
// interprets the schedule as data, so the many distinct decode programs
// (one per erasure pattern) cost no compile. The program is a flat int32
// array built on the host (ops/cuda_xor.py) and uploaded once per
// schedule; each op is
//   kind (0: intermediate into a scratch slot, 1: output packet),
//   destination (slot or output packet), source count n, n sources
// where a source s >= 0 is input packet s and s < 0 is slot -1 - s. An
// output with no sources is a zero packet. Threads of a block read the
// program at the same addresses, so those loads broadcast from L1.
//
// Addressing serves both forms with one launcher: input packet j lives
// in shard j / in_w at byte offset (j % in_w) * P, output packet q in
// shard q / out_w at (q % out_w) * P, and every shard is a pointer plus
// a stripe stride. The stacked [B, KW, P] form is one input shard with
// in_w = KW; the per-shard form is n shards with in_w = w (w = 1: whole
// chunks, the LRC local-repair and xor-plugin rows). Nothing is stacked
// or copied.
//
// Bound: device memory. An apply must read every input packet once and
// write every output packet once, (KW + MW) * P * B bytes; the XORs are
// a few integer ops per 16 bytes. Grid = (stripe, byte tile of the
// packet); a thread owns 16 bytes (one uint4) of one column across all
// packets, XORs its operands in registers and writes each output once.
// Intermediates live in shared memory, [n_slots][blockDim] uint4, private
// to their thread (no barrier is needed). The block shrinks as n_slots
// grows so that any schedule's scratch fits the 227 KB a block may use.
// An input packet named by several ops is re-read from global memory
// (L1/L2 hits within the block's tile); keeping it in registers or shared
// memory is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "bytes16.cuh"

namespace {

constexpr int kMaxShards = 64;
constexpr int kMaxThreads = 256;
constexpr int kSmemMax = 232448;  // per-block opt-in maximum on sm_90

struct XorParams {
  const uint8_t* in[kMaxShards];
  long long in_stride[kMaxShards];  // bytes between stripes
  uint8_t* out[kMaxShards];
  long long out_stride[kMaxShards];
  const int* prog;
  int prog_len;
  int in_w, out_w;  // packets per input / output shard
  long long B, P;
  int aligned;  // every shard pointer, stripe stride and P a multiple of 16
};

__global__ void __launch_bounds__(kMaxThreads)
xor_schedule_kernel(const __grid_constant__ XorParams p, long long tiles) {
  extern __shared__ uint4 scratch[];  // [n_slots][blockDim.x]
  const long long b = blockIdx.x / tiles;
  const long long col = ((blockIdx.x % tiles) * blockDim.x + threadIdx.x) * 16;
  if (col >= p.P) return;
  const long long avail = p.P - col;
  const bool vec = p.aligned && avail >= 16;
  const int* __restrict__ prog = p.prog;
  int pc = 0;
  while (pc < p.prog_len) {
    const int kind = __ldg(prog + pc);
    const int dst = __ldg(prog + pc + 1);
    const int ns = __ldg(prog + pc + 2);
    pc += 3;
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    for (int s = 0; s < ns; ++s) {
      const int src = __ldg(prog + pc + s);
      uint4 x;
      if (src >= 0) {
        const int sh = src / p.in_w;
        const long long off = (long long)(src - sh * p.in_w) * p.P + col;
        x = load16(p.in[sh] + b * p.in_stride[sh] + off, vec, avail);
      } else {
        x = scratch[(-1 - src) * blockDim.x + threadIdx.x];
      }
      acc.x ^= x.x;
      acc.y ^= x.y;
      acc.z ^= x.z;
      acc.w ^= x.w;
    }
    pc += ns;
    if (kind == 0) {
      scratch[dst * blockDim.x + threadIdx.x] = acc;
    } else {
      const int sh = dst / p.out_w;
      const long long off = (long long)(dst - sh * p.out_w) * p.P + col;
      store16(p.out[sh] + b * p.out_stride[sh] + off, acc, vec, avail);
    }
  }
}

// Threads per block for a schedule with n_slots scratch slots: 256, or
// the largest multiple of 32 whose scratch fits kSmemMax; 0 if none does
// (ops/cuda_xor.py flattens such schedules to selection rows first).
int threads_for(int n_slots) {
  if (n_slots <= 0) return kMaxThreads;
  const int t = kSmemMax / (n_slots * 16);
  return (t > kMaxThreads ? kMaxThreads : t) & ~31;
}

}  // namespace

extern "C" int xor_schedule(const unsigned long long* in_ptrs, const long long* in_strides,
                            int n_in, int in_w, const unsigned long long* out_ptrs,
                            const long long* out_strides, int n_out, int out_w,
                            const int* prog, int prog_len, int n_slots, long long B,
                            long long P, void* stream) {
  if (n_in < 1 || n_in > kMaxShards || n_out < 1 || n_out > kMaxShards || in_w < 1 ||
      out_w < 1 || prog_len < 0 || n_slots < 0 || B < 0 || P < 0)
    return (int)cudaErrorInvalidValue;
  const int threads = threads_for(n_slots);
  if (threads < 32) return (int)cudaErrorInvalidValue;
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
  p.prog = prog;
  p.prog_len = prog_len;
  p.in_w = in_w;
  p.out_w = out_w;
  p.B = B;
  p.P = P;
  p.aligned = aligned;
  const size_t smem = (size_t)n_slots * threads * 16;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        xor_schedule_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long tiles = (P + threads * 16LL - 1) / (threads * 16LL);
  if (B * tiles == 0) return (int)cudaSuccess;
  if (B * tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  xor_schedule_kernel<<<(unsigned int)(B * tiles), threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p, tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* xor_schedule_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
