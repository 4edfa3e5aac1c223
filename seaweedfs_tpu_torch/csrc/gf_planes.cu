// GF(2) bit-plane kernels of the plane-resident rebuild hop, hand-written
// for Hopper (sm_90a).
//
// Replaces three kernels of seaweedfs_tpu/ops/rs_pallas.py, byte for byte:
//   K3 _make_pack_kernel   (pack_words)          -> sw_gf_pack
//   K4 _make_unpack_kernel (unpack_words)        -> sw_gf_unpack
//   K2 _make_plane_kernel  (apply_matrix_planes) -> sw_gf_planes_apply
//
// The layout is rs_pallas.py's plane-interleaved one.  Rows are cut into
// blocks of 32768 uint32 words (128 KB).  Within a block, byte-layout word
// q*4096 + g and plane word b*4096 + g are related, per byte lane l, by an
// 8x8 bit transpose: plane_b[g] bit (8l + q) = word_q[g] bit (8l + b).
//
// Pack and unpack.  The transpose is its own inverse, so K3 and K4 are one
// kernel body behind two launchers.  One thread per (row, block, 4
// consecutive g): eight 16-byte loads (coalesced along g), the transpose by
// three delta-swap stages (4 swaps of 6 logic ops each: 72 ops per 8 words,
// where the TPU kernel's shift-mask-or form takes 4 ops per bit pair, 256),
// eight 16-byte stores.  Bound: device memory, 2 * rows * n bytes over
// 3.35 TB/s; the 72 ops per 32 bytes stay well under it.
//
// Plane apply.  The GF(2) matrix is runtime data, as in gf_apply.cu, so one
// build serves the encode matrix, every reconstruction matrix and every
// stack of them, with no nvcc at rebuild time.  It arrives as
// masks[i * s + j], one byte per output plane i and input row j whose bit c
// is bits[i][8j + c] (8r * s bytes); each block copies its output group's
// masks into shared memory.  One thread per V consecutive g keeps the
// 8 * R * V <= 64 accumulators of its R output rows in registers.  For each
// input row j it loads that row's eight plane words and XORs each into the
// accumulators whose mask bit is set; the masks are the same for every
// thread, so the tests never diverge.  More than 8 output rows go to
// grid.y groups that each re-read the inputs.  Bound: the larger of
// (s + r) * n bytes over 3.35 TB/s and popcount(bits) * n / 32 word XORs
// at 64 logic ops per clock per SM.  The kernel executes every set bit as
// one XOR; the JAX package's CSE'd schedule (xor_sched.plan_schedule: 499
// instead of 1224 XORs for the RS(10,4) encode) is left for a later
// redesign of this kernel.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kPlaneWords = 4096;
constexpr int64_t kBlockWords = 8 * kPlaneWords;
constexpr int kMaxMaskBytes = 48 * 1024;  // shared memory a block gets without opting in

// Swap the bits of a selected by mask << shift with the bits of b selected
// by mask.
__device__ __forceinline__ void delta_swap(uint32_t& a, uint32_t& b, int shift,
                                           uint32_t mask) {
  const uint32_t t = ((a >> shift) ^ b) & mask;
  b ^= t;
  a ^= t << shift;
}

// Per byte lane, the 8x8 bit transpose x[q] bit b <-> x[b] bit q: swap the
// off-diagonal 4x4 blocks, then the 2x2 blocks inside each, then the bits.
__device__ __forceinline__ void transpose8(uint32_t* x) {
#pragma unroll
  for (int q = 0; q < 4; ++q) delta_swap(x[q], x[q + 4], 4, 0x0F0F0F0Fu);
  delta_swap(x[0], x[2], 2, 0x33333333u);
  delta_swap(x[1], x[3], 2, 0x33333333u);
  delta_swap(x[4], x[6], 2, 0x33333333u);
  delta_swap(x[5], x[7], 2, 0x33333333u);
#pragma unroll
  for (int q = 0; q < 8; q += 2) delta_swap(x[q], x[q + 1], 1, 0x55555555u);
}

// grid (ceil(width / 32 / kThreads), rows): thread t of row blockIdx.y takes
// g = 4 * (t % 1024) of block t / 1024.
__global__ void __launch_bounds__(kThreads)
    transpose_kernel(const uint32_t* __restrict__ in, int64_t in_stride,
                     uint32_t* __restrict__ out, int64_t out_stride,
                     int64_t width) {
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= width / 32) return;
  const int64_t per_block = kPlaneWords / 4;
  const int64_t base = (t / per_block) * kBlockWords + (t % per_block) * 4;
  const uint32_t* src = in + blockIdx.y * in_stride + base;
  uint32_t* dst = out + blockIdx.y * out_stride + base;
  uint32_t w[4][8];  // w[k][q]: word g + k of group q
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + q * kPlaneWords));
    w[0][q] = v.x;
    w[1][q] = v.y;
    w[2][q] = v.z;
    w[3][q] = v.w;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) transpose8(w[k]);
#pragma unroll
  for (int b = 0; b < 8; ++b)
    *reinterpret_cast<uint4*>(dst + b * kPlaneWords) =
        make_uint4(w[0][b], w[1][b], w[2][b], w[3][b]);
}

template <int V>
__device__ __forceinline__ void load_vec(const uint32_t* p, uint32_t* v) {
  if constexpr (V == 4) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (V == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(uint32_t* p, const uint32_t* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// grid (ceil(width / 8 / V / kThreads), ceil(r / R)): block row blockIdx.y
// computes output rows [R * blockIdx.y, R * blockIdx.y + R) of r.
template <int R, int V>
__global__ void __launch_bounds__(kThreads)
    planes_apply_kernel(const uint8_t* __restrict__ masks, int r, int s,
                        const uint32_t* __restrict__ in, int64_t in_stride,
                        uint32_t* __restrict__ out, int64_t out_stride,
                        int64_t width) {
  extern __shared__ uint8_t group_masks[];  // [i * s + j], i < 8R, 0 past r
  const int o0 = blockIdx.y * R;
  const int planes = 8 * min(R, r - o0);
  for (int e = threadIdx.x; e < 8 * R * s; e += blockDim.x)
    group_masks[e] = e < planes * s ? masks[int64_t(8 * o0) * s + e] : 0;
  __syncthreads();

  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= width / 8 / V) return;
  const int64_t per_block = kPlaneWords / V;
  const int64_t base = (t / per_block) * kBlockWords + (t % per_block) * V;

  uint32_t acc[8 * R][V];
#pragma unroll
  for (int i = 0; i < 8 * R; ++i)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[i][k] = 0;
  for (int j = 0; j < s; ++j) {
    const uint32_t* src = in + j * in_stride + base;
    uint32_t v[8][V];
#pragma unroll
    for (int c = 0; c < 8; ++c) load_vec<V>(src + c * kPlaneWords, v[c]);
#pragma unroll
    for (int i = 0; i < 8 * R; ++i) {
      const uint32_t m = group_masks[i * s + j];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (m & (1u << c)) {
#pragma unroll
          for (int k = 0; k < V; ++k) acc[i][k] ^= v[c][k];
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 8 * R; ++i)
    if (i < planes)
      store_vec<V>(out + (o0 + i / 8) * out_stride + (i % 8) * kPlaneWords + base,
                   acc[i]);
}

template <int R, int V>
cudaError_t launch_apply(const uint8_t* masks, int r, int s, const uint32_t* in,
                         int64_t in_stride, uint32_t* out, int64_t out_stride,
                         int64_t width, cudaStream_t stream) {
  const int64_t threads = width / 8 / V;
  const dim3 grid(unsigned((threads + kThreads - 1) / kThreads),
                  unsigned((r + R - 1) / R));
  planes_apply_kernel<R, V><<<grid, kThreads, 8 * R * s, stream>>>(
      masks, r, s, in, in_stride, out, out_stride, width);
  return cudaGetLastError();
}

bool aligned16(const void* p, int64_t stride_words) {
  return ((reinterpret_cast<uintptr_t>(p) | uintptr_t(stride_words * 4)) & 15u) == 0;
}

int transpose(const void* in, int64_t in_stride, void* out, int64_t out_stride,
              int64_t rows, int64_t width, void* stream) {
  if (rows <= 0 || rows > 65535 || width <= 0 || width % kBlockWords)
    return int(cudaErrorInvalidValue);
  if (!aligned16(in, in_stride) || !aligned16(out, out_stride))
    return int(cudaErrorMisalignedAddress);
  const dim3 grid(unsigned((width / 32 + kThreads - 1) / kThreads), unsigned(rows));
  transpose_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), in_stride, static_cast<uint32_t*>(out),
      out_stride, width);
  return int(cudaGetLastError());
}

}  // namespace

// Byte-layout rows -> plane-interleaved rows (K3).  Strides and width are in
// uint32 words; width a multiple of 32768, rows and strides 16-byte aligned.
// Returns the launch's cudaError_t (0 on success).
extern "C" int sw_gf_pack(const void* in, int64_t in_stride, void* out,
                          int64_t out_stride, int64_t rows, int64_t width,
                          void* stream) {
  return transpose(in, in_stride, out, out_stride, rows, width, stream);
}

// Plane-interleaved rows -> byte-layout rows (K4): the same transpose.
extern "C" int sw_gf_unpack(const void* in, int64_t in_stride, void* out,
                            int64_t out_stride, int64_t rows, int64_t width,
                            void* stream) {
  return transpose(in, in_stride, out, out_stride, rows, width, stream);
}

// out (r plane-interleaved rows) = the GF(2) matrix given by masks (8r x s
// bytes, device memory) applied to in (s plane-interleaved rows) (K2).
// Strides and width in uint32 words, as for sw_gf_pack.
extern "C" int sw_gf_planes_apply(const void* masks, int64_t r, int64_t s,
                                  const void* in, int64_t in_stride, void* out,
                                  int64_t out_stride, int64_t width,
                                  void* stream) {
  if (r <= 0 || s <= 0 || 64 * s > kMaxMaskBytes || (r + 7) / 8 > 65535 ||
      width <= 0 || width % kBlockWords)
    return int(cudaErrorInvalidValue);
  if (!aligned16(in, in_stride) || !aligned16(out, out_stride))
    return int(cudaErrorMisalignedAddress);
  const auto m = static_cast<const uint8_t*>(masks);
  const auto in_p = static_cast<const uint32_t*>(in);
  const auto out_p = static_cast<uint32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int ri = int(r), si = int(s);
  if (r == 1) return int(launch_apply<1, 4>(m, ri, si, in_p, in_stride, out_p, out_stride, width, st));
  if (r == 2) return int(launch_apply<2, 4>(m, ri, si, in_p, in_stride, out_p, out_stride, width, st));
  if (r <= 4) return int(launch_apply<4, 2>(m, ri, si, in_p, in_stride, out_p, out_stride, width, st));
  return int(launch_apply<8, 1>(m, ri, si, in_p, in_stride, out_p, out_stride, width, st));
}

extern "C" const char* sw_gf_planes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
