// Kernel K10: the bench's roofline copy, out[i] = in[i] ^ 1 over n bytes.
//
// Replaces the Pallas kernel bench.py:237 (`_measure_roofline.copy`,
// its body `kernel` at :233-234), the pure-copy probe whose read+write
// rate is the bench's denominator for `hbm_roofline_frac`. The TPU
// kernel streams [16, 229376] row blocks through VMEM over a sequential
// grid; here the whole array is one flat byte range.
//
// Bound: device memory, n bytes read and n written (2 x 117,440,512 B
// at the bench's [512, 229376] shape: 0.0701 ms at 3.35 TB/s). No
// arithmetic to speak of, so the design only keeps enough bytes in
// flight:
//
// - 16-byte vector loads and stores (uint4) when `in` and `out` share
//   their offset modulo 16: a head of up to 15 bytes goes byte by byte,
//   then the aligned body in vectors, then a ragged tail of up to 15
//   bytes byte by byte. Pointers of different offsets take a byte loop.
// - Each thread issues kIlp independent vector loads before its stores,
//   so a resident grid keeps tens of KB in flight per SM.
// - A grid-stride loop over a persistent grid (as many blocks as are
//   resident at once), so every length is valid and no launch exceeds
//   the grid limits.
// - Streaming cache hints (ld.global.cs / st.global.cs): every byte is
//   touched once, so nothing is worth keeping in L2.
// No cross-block state, so blocks run in any order on any SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIlp = 4;
constexpr uint32_t kOnes = 0x01010101u;

__device__ __forceinline__ uint4 xor1(uint4 v) {
  v.x ^= kOnes;
  v.y ^= kOnes;
  v.z ^= kOnes;
  v.w ^= kOnes;
  return v;
}

// head: bytes before the first 16-byte aligned input address (0 when
// the two pointers' offsets differ: then nvec is 0 and the byte loop
// below covers everything); nvec: 16-byte vectors after the head.
__global__ void __launch_bounds__(kThreads)
    xor1_copy_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                     long long n, long long head, long long nvec) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uint4* vin = reinterpret_cast<const uint4*>(in + head);
  uint4* vout = reinterpret_cast<uint4*>(out + head);
  long long i = tid;
  for (; i + (kIlp - 1) * stride < nvec; i += kIlp * stride) {
    uint4 v[kIlp];
#pragma unroll
    for (int j = 0; j < kIlp; ++j) v[j] = __ldcs(vin + i + j * stride);
#pragma unroll
    for (int j = 0; j < kIlp; ++j) __stcs(vout + i + j * stride, xor1(v[j]));
  }
  for (; i < nvec; i += stride) __stcs(vout + i, xor1(__ldcs(vin + i)));
  // the bytes outside the vector body: the head, then the tail
  const long long body_end = head + 16 * nvec;
  const long long rest = head + (n - body_end);
  for (long long b = tid; b < rest; b += stride) {
    const long long at = b < head ? b : body_end + (b - head);
    out[at] = in[at] ^ 1;
  }
}

}  // namespace

extern "C" int xor1_copy(const void* in, void* out, long long n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const uintptr_t ia = reinterpret_cast<uintptr_t>(in) % 16;
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out) % 16;
  long long head = 0, nvec = 0;
  if (ia == oa) {
    head = (long long)((16 - ia) % 16);
    if (head > n) head = n;
    nvec = (n - head) / 16;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, xor1_copy_kernel, kThreads,
                                                           0)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // work items: vectors of the body, or bytes where there is no body
  const long long items = nvec > 0 ? nvec : n;
  const long long need = (items + kThreads - 1) / kThreads;
  const long long grid = need < (long long)sms * per_sm ? need : (long long)sms * per_sm;
  xor1_copy_kernel<<<(unsigned int)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n, head, nvec);
  return (int)cudaGetLastError();
}

extern "C" const char* copy_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
