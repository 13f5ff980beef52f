// Kernels E and F: the two elementwise stages of CLAY fractional repair
// (codecs/clay.py ClayCodec._repair_kernels), between which one GF(2^8)
// apply per intersection-score group (Kernel A) decodes the lost row.
//
// Kernel E (clay_uncoupled) replaces the Pallas kernel
//   ceph_tpu/ops/clay_kernels.py::uncoupled_rows (_uncoupled_fn, K8)
// Kernel F (clay_couple_scatter) replaces
//   ceph_tpu/ops/clay_kernels.py::couple_scatter (_couple_scatter_fn, K9)
//
// Geometry (codecs/clay.py): nodes on a q x t grid; the lost node is
// (x_l, y_l); its r = q^(t-1) repair planes are indexed 0..r-1, and
// changing digit y of a repair plane by delta moves its index by
// delta * stride[y]. Every helper and U array is [B, r * sc] bytes: r
// sub-chunks of sc bytes per stripe.
//
// Kernel E: for each non-aloof member (row ri, x) of the helper rows and
// each repair plane p, with zv = (p / stride[ri]) % q:
//   zv == x                    U = C (0 for a virtual member)
//   real x, aloof zv           U = C (placeholder the codec patches)
//   otherwise                  U = c0*C[x][p] ^ c1*C[zv][p + (x - zv)*stride]
// with (c0, c1) the forward pair coefficients of the member with the
// larger x (x > zv) or the smaller; a virtual operand is 0.
// Kernel F: output plane z of the lost chunk is member x = (z / seq) % q
// of repair plane p = (z / (q*seq)) * seq + z % seq:
//   x == x_l                   out = U[x][p]
//   otherwise                  out = c0*C[x][p] ^ c1*U[x][p]
// with the inverse pair coefficients (0 for a virtual member's C).
//
// The TPU compiled one kernel per (geometry, erasure pattern) and baked
// strides, kinds and coefficients into it. Here one compiled kernel reads
// the plan as data in __grid_constant__ parameters, so a new lost node
// or aloof set costs no compile.
//
// Bound: device memory. E must read its (t-1)*q helper arrays once and
// write one U array per non-aloof member; F reads q U arrays and the
// lost row's helpers and writes the chunk. A thread owns 16 bytes of one
// output sub-chunk (a ragged sub-chunk tail takes byte loads; a vector
// never straddles two sub-chunks, since each side of the pair may come
// from another plane). GF(2^8) multiplies by a runtime constant run on
// packed 32-bit words as an xtime ladder; the canonical pair transforms
// (3, 2) and (143, 142) of the RS(2,2) coupling fuse to one mul-by-2 or
// div-by-2 step. In E the member index varies fastest over the blocks,
// so the blocks of one stripe tile run together and a pair partner's
// load, which another member's block also issues, hits L2.
#include <cuda_runtime.h>

#include <cstdint>

#include "bytes16.cuh"
#include "gf_word.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMembers = 64;  // (t - 1) * q helper-row members
constexpr int kMaxRows = 32;
constexpr int kMaxQ = 32;
constexpr int kReal = 0, kVirtual = 1, kAloof = 2;

struct UncoupledParams {
  const uint8_t* in[kMaxMembers];
  long long in_stride[kMaxMembers];  // bytes between stripes
  uint8_t* out[kMaxMembers];
  long long out_stride[kMaxMembers];
  short in_of[kMaxMembers];  // member -> input index, -1 unless real
  short out_row[kMaxMembers], out_x[kMaxMembers];
  long long stride[kMaxRows];  // repair-index stride of each row's digit
  unsigned char kind[kMaxMembers];
  unsigned int c0[2], c1[2];  // [0]: member with the larger x, [1]: smaller
  int q, n_out;
  long long r, sc, segs;  // segs: 16-byte segments per sub-chunk
  int vec;                // pointers, strides and sc all multiples of 16
};

struct CoupleParams {
  const uint8_t* u[kMaxQ];
  long long u_stride[kMaxQ];
  const uint8_t* h[kMaxQ];  // null for x_l and virtual members
  long long h_stride[kMaxQ];
  uint8_t* out;
  long long out_stride;
  unsigned int c0[2], c1[2];  // [0]: x > x_l, [1]: x < x_l
  int q, x_l;
  long long r, sc, seq, segs;
  int vec;
};

// Every byte of x times c in GF(2^8)/0x11D.
__device__ __forceinline__ uint32_t mulw(uint32_t x, uint32_t c) {
  uint32_t acc = 0u;
  while (c) {
    if (c & 1u) acc ^= x;
    c >>= 1;
    if (c) x = mul2w(x);
  }
  return acc;
}

// c0*a ^ c1*b on one word; the branch is uniform over the launch.
__device__ __forceinline__ uint32_t pairw(uint32_t a, uint32_t b, uint32_t c0, uint32_t c1) {
  if (c0 == 3u && c1 == 2u) return a ^ mul2w(a ^ b);
  if (c0 == 2u && c1 == 3u) return b ^ mul2w(a ^ b);
  if (c0 == 143u && c1 == 142u) return a ^ div2w(a ^ b);
  if (c0 == 142u && c1 == 143u) return b ^ div2w(a ^ b);
  return mulw(a, c0) ^ mulw(b, c1);
}

__device__ __forceinline__ uint4 pair16(uint4 a, uint4 b, uint32_t c0, uint32_t c1) {
  return make_uint4(pairw(a.x, b.x, c0, c1), pairw(a.y, b.y, c0, c1),
                    pairw(a.z, b.z, c0, c1), pairw(a.w, b.w, c0, c1));
}

// Kernel E. Block = (stripe, tile of 16-byte segments, output member),
// the member fastest.
__global__ void __launch_bounds__(kThreads)
clay_uncoupled_kernel(const __grid_constant__ UncoupledParams p, long long tiles) {
  const long long bid = blockIdx.x;
  const int j = (int)(bid % p.n_out);
  const long long rest = bid / p.n_out;
  const long long b = rest / tiles;
  const long long g = (rest % tiles) * blockDim.x + threadIdx.x;
  if (g >= p.r * p.segs) return;
  const long long pl = g / p.segs;
  const long long off = (g - pl * p.segs) * 16;
  const long long avail = p.sc - off;
  const bool vec = p.vec && avail >= 16;
  const int q = p.q, ri = p.out_row[j], x = p.out_x[j];
  const long long s = p.stride[ri];
  const int zv = (int)((pl / s) % q);
  const int self = p.in_of[ri * q + x];
  const long long o = pl * p.sc + off;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (zv == x || (self >= 0 && p.kind[ri * q + zv] == kAloof)) {
    if (self >= 0) v = load16(p.in[self] + b * p.in_stride[self] + o, vec, avail);
  } else {
    uint4 a = v, c = v;
    if (self >= 0) a = load16(p.in[self] + b * p.in_stride[self] + o, vec, avail);
    const int mate = p.in_of[ri * q + zv];
    if (mate >= 0)
      c = load16(p.in[mate] + b * p.in_stride[mate] + (pl + (long long)(x - zv) * s) * p.sc + off,
                 vec, avail);
    const int h = x > zv ? 0 : 1;
    v = pair16(a, c, p.c0[h], p.c1[h]);
  }
  store16(p.out[j] + b * p.out_stride[j] + o, v, vec, avail);
}

// Kernel F. Block = (stripe, tile of the chunk's 16-byte segments).
__global__ void __launch_bounds__(kThreads)
clay_couple_scatter_kernel(const __grid_constant__ CoupleParams p, long long tiles) {
  const long long b = blockIdx.x / tiles;
  const long long g = (blockIdx.x % tiles) * blockDim.x + threadIdx.x;
  const long long planes = p.q * p.r;
  if (g >= planes * p.segs) return;
  const long long z = g / p.segs;
  const long long off = (g - z * p.segs) * 16;
  const long long avail = p.sc - off;
  const bool vec = p.vec && avail >= 16;
  const int x = (int)((z / p.seq) % p.q);
  const long long pl = (z / (p.q * p.seq)) * p.seq + z % p.seq;
  const long long o = pl * p.sc + off;
  uint4 v = load16(p.u[x] + b * p.u_stride[x] + o, vec, avail);
  if (x != p.x_l) {
    uint4 c = make_uint4(0u, 0u, 0u, 0u);
    if (p.h[x]) c = load16(p.h[x] + b * p.h_stride[x] + o, vec, avail);
    const int h = x > p.x_l ? 0 : 1;
    v = pair16(c, v, p.c0[h], p.c1[h]);
  }
  store16(p.out + b * p.out_stride + z * p.sc + off, v, vec, avail);
}

bool aligned16(unsigned long long ptr, long long stride) {
  return ptr % 16 == 0 && stride % 16 == 0;
}

}  // namespace

extern "C" int clay_uncoupled(const unsigned long long* in_ptrs, const long long* in_strides,
                              int n_in, const unsigned long long* out_ptrs,
                              const long long* out_strides, int n_out, int q, int n_rows,
                              const long long* strides, const int* kinds, const int* pair,
                              long long B, long long r, long long sc, void* stream) {
  if (q < 1 || n_rows < 1 || n_rows > kMaxRows || q * n_rows > kMaxMembers || n_in < 0 ||
      n_out < 1 || B < 0 || r < 1 || sc < 1)
    return (int)cudaErrorInvalidValue;
  UncoupledParams p;
  p.q = q;
  p.r = r;
  p.sc = sc;
  p.segs = (sc + 15) / 16;
  bool vec = sc % 16 == 0;
  int ni = 0, no = 0;
  for (int ri = 0; ri < n_rows; ++ri) {
    p.stride[ri] = strides[ri];
    if (strides[ri] < 1 || r % (q * strides[ri])) return (int)cudaErrorInvalidValue;
    for (int x = 0; x < q; ++x) {
      const int m = ri * q + x, k = kinds[m];
      if (k != kReal && k != kVirtual && k != kAloof) return (int)cudaErrorInvalidValue;
      p.kind[m] = (unsigned char)k;
      p.in_of[m] = -1;
      if (k == kReal) {
        if (ni >= n_in) return (int)cudaErrorInvalidValue;
        p.in[ni] = reinterpret_cast<const uint8_t*>(in_ptrs[ni]);
        p.in_stride[ni] = in_strides[ni];
        vec = vec && aligned16(in_ptrs[ni], in_strides[ni]);
        p.in_of[m] = (short)ni++;
      }
      if (k != kAloof) {
        if (no >= n_out) return (int)cudaErrorInvalidValue;
        p.out[no] = reinterpret_cast<uint8_t*>(out_ptrs[no]);
        p.out_stride[no] = out_strides[no];
        vec = vec && aligned16(out_ptrs[no], out_strides[no]);
        p.out_row[no] = (short)ri;
        p.out_x[no] = (short)x;
        ++no;
      }
    }
  }
  if (ni != n_in || no != n_out) return (int)cudaErrorInvalidValue;
  p.n_out = n_out;
  for (int h = 0; h < 2; ++h) {
    p.c0[h] = (unsigned int)pair[2 * h] & 0xFFu;
    p.c1[h] = (unsigned int)pair[2 * h + 1] & 0xFFu;
  }
  p.vec = vec;
  const long long tiles = (r * p.segs + kThreads - 1) / kThreads;
  const long long blocks = B * tiles * n_out;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  clay_uncoupled_kernel<<<(unsigned int)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p, tiles);
  return (int)cudaGetLastError();
}

extern "C" int clay_couple_scatter(const unsigned long long* u_ptrs, const long long* u_strides,
                                   const unsigned long long* h_ptrs,
                                   const long long* h_strides, int q, int x_l,
                                   const int* pair, void* out, long long out_stride,
                                   long long B, long long r, long long sc, long long seq,
                                   void* stream) {
  if (q < 1 || q > kMaxQ || x_l < 0 || x_l >= q || B < 0 || r < 1 || sc < 1 || seq < 1 ||
      r % seq)
    return (int)cudaErrorInvalidValue;
  CoupleParams p;
  p.q = q;
  p.x_l = x_l;
  p.r = r;
  p.sc = sc;
  p.seq = seq;
  p.segs = (sc + 15) / 16;
  bool vec = sc % 16 == 0 && aligned16(reinterpret_cast<unsigned long long>(out), out_stride);
  for (int x = 0; x < q; ++x) {
    p.u[x] = reinterpret_cast<const uint8_t*>(u_ptrs[x]);
    p.u_stride[x] = u_strides[x];
    vec = vec && aligned16(u_ptrs[x], u_strides[x]);
    p.h[x] = reinterpret_cast<const uint8_t*>(h_ptrs[x]);
    p.h_stride[x] = h_strides[x];
    if (h_ptrs[x]) vec = vec && aligned16(h_ptrs[x], h_strides[x]);
  }
  p.out = static_cast<uint8_t*>(out);
  p.out_stride = out_stride;
  for (int h = 0; h < 2; ++h) {
    p.c0[h] = (unsigned int)pair[2 * h] & 0xFFu;
    p.c1[h] = (unsigned int)pair[2 * h + 1] & 0xFFu;
  }
  p.vec = vec;
  const long long tiles = (q * r * p.segs + kThreads - 1) / kThreads;
  const long long blocks = B * tiles;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  clay_couple_scatter_kernel<<<(unsigned int)blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(p, tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* clay_repair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
