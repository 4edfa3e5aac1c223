// GF(2^8) matrix apply over shard rows, hand-written for Hopper (sm_90a).
//
// Replaces seaweedfs_tpu/ops/rs_pallas.py:_make_kernel (kernel K1), the
// fused Pallas kernel that applies an RS encode or reconstruction matrix to
// shard rows: out[o][j] = XOR_i M[o][i] * in[i][j] over GF(2^8) with the
// klauspost field (polynomial 0x11D), byte-exact.
//
// Bound: device memory.  Each input byte is read once and each output byte
// written once, so the least time is (s + r) * n bytes / 3.35 TB/s.  On the
// shared-memory side this design does r * s byte lookups per byte column
// (40 for RS(10,4) encode); at 32 a clock per SM they take about 1.14 times
// that bound, so the design itself cannot reach it.  The bit-slice form
// (pack, XORs, unpack) stays under it.
//
// Design: the TPU kernel bit-sliced the bytes because its vector unit has no
// cheap gathers; Hopper's shared memory does.  The matrix is a runtime
// argument in device memory, so one build serves the encode matrix and every
// reconstruction matrix.  Each block first fills the r * s product rows
// MUL[c][0..255] in dynamic shared memory (at most 64 KB: every EcScheme has
// at most 32 shards).  Threads then stride over 4-byte columns: one uint32
// load from each of the s input rows (coalesced along the row), four byte
// lookups per coefficient into R register accumulators, one uint32 store per
// output row.  Rows take a byte stride; a ragged tail, or rows that are not
// 4-byte aligned, go through byte loads and stores.  The XOR-scheduled
// bit-slice form is left for the formulation shootout (ROADMAP Queue A,
// item 11).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSharedBytes = 232448;  // 227 KB: the most a block may use

__device__ __forceinline__ uint32_t gf_mul(uint32_t a, uint32_t b) {
  uint32_t p = 0;
  for (int bit = 0; bit < 8; ++bit) {
    if (b & 1u) p ^= a;
    b >>= 1;
    a <<= 1;
    if (a & 0x100u) a ^= 0x11Du;
  }
  return p;
}

__device__ __forceinline__ uint32_t load_word(const uint8_t* p, int64_t valid,
                                              bool aligned) {
  if (aligned && valid >= 4) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t x = 0;
  for (int b = 0; b < 4 && b < valid; ++b) x |= uint32_t(p[b]) << (8 * b);
  return x;
}

__device__ __forceinline__ void store_word(uint8_t* p, uint32_t x,
                                           int64_t valid, bool aligned) {
  if (aligned && valid >= 4) {
    *reinterpret_cast<uint32_t*>(p) = x;
    return;
  }
  for (int b = 0; b < 4 && b < valid; ++b) p[b] = uint8_t(x >> (8 * b));
}

// R output rows are accumulated per pass; r > R takes several passes, each
// re-reading the inputs (from cache).
template <int R>
__global__ void __launch_bounds__(kThreads)
    gf_apply_kernel(const uint8_t* __restrict__ matrix, int r, int s,
                    const uint8_t* __restrict__ in, int64_t in_stride,
                    uint8_t* __restrict__ out, int64_t out_stride, int64_t n,
                    bool aligned) {
  extern __shared__ uint8_t mul[];  // mul[(o * s + i) * 256 + v] = M[o][i] * v
  const int entries = r * s * 256;
  for (int e = threadIdx.x; e < entries; e += blockDim.x)
    mul[e] = uint8_t(gf_mul(matrix[e >> 8], uint32_t(e & 255)));
  __syncthreads();

  const int64_t words = (n + 3) >> 2;
  const int64_t step = int64_t(gridDim.x) * blockDim.x;
  for (int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; w < words;
       w += step) {
    const int64_t col = w << 2;
    const int64_t valid = n - col;
    for (int o0 = 0; o0 < r; o0 += R) {
      uint32_t acc[R];
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] = 0;
      for (int i = 0; i < s; ++i) {
        const uint32_t x = load_word(in + i * in_stride + col, valid, aligned);
        const uint32_t b0 = x & 255u, b1 = (x >> 8) & 255u,
                       b2 = (x >> 16) & 255u, b3 = x >> 24;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          if (o0 + q < r) {
            const uint8_t* t = mul + ((o0 + q) * s + i) * 256;
            acc[q] ^= uint32_t(t[b0]) | (uint32_t(t[b1]) << 8) |
                      (uint32_t(t[b2]) << 16) | (uint32_t(t[b3]) << 24);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (o0 + q < r)
          store_word(out + (o0 + q) * out_stride + col, acc[q], valid, aligned);
    }
  }
}

template <int R>
cudaError_t launch(const uint8_t* matrix, int r, int s, const uint8_t* in,
                   int64_t in_stride, uint8_t* out, int64_t out_stride,
                   int64_t n, bool aligned, cudaStream_t stream) {
  const int smem = r * s * 256;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gf_apply_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gf_apply_kernel<R>, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t words = (n + 3) / 4;
  int64_t grid = (words + kThreads - 1) / kThreads;
  const int64_t resident = int64_t(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > resident) grid = resident;
  gf_apply_kernel<R><<<unsigned(grid), kThreads, smem, stream>>>(
      matrix, r, s, in, in_stride, out, out_stride, n, aligned);
  return cudaGetLastError();
}

}  // namespace

// out (r rows, byte stride out_stride) = matrix (r x s, row-major, device
// memory) applied to in (s rows, byte stride in_stride), n bytes per row, on
// `stream`.  Returns the launch's cudaError_t (0 on success).
extern "C" int sw_gf_apply(const void* matrix, int64_t r, int64_t s,
                           const void* in, int64_t in_stride, void* out,
                           int64_t out_stride, int64_t n, void* stream) {
  if (r <= 0 || s <= 0 || n <= 0 || r * s * 256 > kMaxSharedBytes)
    return int(cudaErrorInvalidValue);
  const auto in_p = static_cast<const uint8_t*>(in);
  const auto out_p = static_cast<uint8_t*>(out);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(in_p) | reinterpret_cast<uintptr_t>(out_p) |
        uintptr_t(in_stride) | uintptr_t(out_stride)) & 3u) == 0;
  const auto m = static_cast<const uint8_t*>(matrix);
  const auto st = static_cast<cudaStream_t>(stream);
  const int ri = int(r), si = int(s);
  if (r == 1) return int(launch<1>(m, ri, si, in_p, in_stride, out_p, out_stride, n, aligned, st));
  if (r == 2) return int(launch<2>(m, ri, si, in_p, in_stride, out_p, out_stride, n, aligned, st));
  if (r <= 4) return int(launch<4>(m, ri, si, in_p, in_stride, out_p, out_stride, n, aligned, st));
  return int(launch<8>(m, ri, si, in_p, in_stride, out_p, out_stride, n, aligned, st));
}

extern "C" const char* sw_gf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
