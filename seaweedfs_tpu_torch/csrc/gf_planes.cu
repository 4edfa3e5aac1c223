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
// three delta-swap stages (gf_table.cuh: 72 logic ops per 8 words, where
// the TPU kernel's shift-mask-or form takes 256), eight 16-byte stores.
// Bound: device memory, 2 * rows * n bytes over 3.35 TB/s; the 72 ops per
// 32 bytes stay well under it.
//
// Plane apply.  The GF(2) matrix is runtime data, as in gf_apply.cu, so one
// build serves the encode matrix, every reconstruction matrix and every
// stack of them, with no nvcc at rebuild time.  It arrives as
// masks[i * s + j], one byte per output plane i and input row j whose bit c
// is bits[i][8j + c] (8r * s bytes).  Its bound is device memory,
// (s + r) * n bytes; the work it must do is one word XOR per set bit at
// most.  A kernel that tests every bit of the mask instead issues 8r * 8s
// tests per word group whatever the matrix, which held the first version
// of this kernel to a quarter of its bound at 8 output rows.  This one runs
// the table apply of gf_table.cuh: each block turns its output group's mask
// nibbles into table offsets in shared memory; one thread per V consecutive
// g keeps the 8 * R * V accumulators of its R output rows in registers and,
// for each (input row, half), loads the half's four plane words (prefetched
// one step ahead), builds its 16-entry table and does one shared load and
// one XOR per output plane: 8 * R loads per (row, half), no test.  Per
// 32 bytes of column at 4 output rows that is 220 + 640 XORs (fewer than
// the 1224 set bits of the RS(10,4) encode) and 300 + 640 shared accesses;
// at 8 rows, 300 + 1280.  Shared-memory traffic now bounds it: at the
// rate the H100 reaches on it, about 70% of one 128-byte wavefront a clock
// per SM, 10 x 64 MiB takes about 0.37 ms at 4 rows and 0.63 ms at 8,
// against byte times of 0.28 and 0.36 ms.  Blocks of 128 threads and
// V = 2 at 8 rows (half the shared instructions per byte of V = 1) keep
// enough blocks resident at these register counts.  More than 8 output
// rows go to grid.y groups that each re-read the inputs.

#include <cstdint>

#include <cuda_runtime.h>

#include "gf_table.cuh"

namespace {

constexpr int kThreads = 256;  // K3/K4's block size; K2 takes gf::kThreads
constexpr int64_t kPlaneWords = 4096;
constexpr int64_t kBlockWords = 8 * kPlaneWords;

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
  for (int k = 0; k < 4; ++k) gf::transpose8(w[k]);
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

// Planes 4h .. 4h+3 of input row j, for step u = 2j + h.
template <int V>
__device__ __forceinline__ void load_half(const uint32_t* in, int64_t in_stride,
                                          int64_t base, int u, uint32_t (&p)[4][V]) {
  const uint32_t* src = in + (u >> 1) * in_stride + base + 4 * (u & 1) * kPlaneWords;
#pragma unroll
  for (int c = 0; c < 4; ++c) load_vec<V>(src + c * kPlaneWords, p[c]);
}

template <int R, int V>
constexpr int apply_shared_bytes(int s) {
  return gf::table_bytes<V>() + 2 * s * 8 * R * 4;
}

// grid (ceil(width / 8 / V / gf::kThreads), ceil(r / R)): block row blockIdx.y
// computes output rows [R * blockIdx.y, R * blockIdx.y + R) of r.  Dynamic
// shared memory: the table, then offs[u * 8R + i] for step u = 2j + h and
// output plane i of the group.
template <int R, int V>
__global__ void __launch_bounds__(gf::kThreads)
    planes_apply_kernel(const uint8_t* __restrict__ masks, int r, int s,
                        const uint32_t* __restrict__ in, int64_t in_stride,
                        uint32_t* __restrict__ out, int64_t out_stride,
                        int64_t width) {
  constexpr int P = 8 * R;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* offs = reinterpret_cast<uint32_t*>(smem + gf::table_bytes<V>());
  const int o0 = blockIdx.y * R;
  const int planes = 8 * min(R, r - o0);
  for (int e = threadIdx.x; e < 2 * s * P; e += blockDim.x) {
    const int u = e / P, i = e % P;
    const uint32_t m = i < planes ? masks[int64_t(8 * o0 + i) * s + (u >> 1)] : 0;
    offs[e] = ((m >> (4 * (u & 1))) & 15u) * gf::slot_stride<V>();
  }
  uint8_t* slots = smem + threadIdx.x * 4 * V;
  gf::clear_slot0<V>(slots);
  __syncthreads();

  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= width / 8 / V) return;
  const int64_t per_block = kPlaneWords / V;
  const int64_t base = (t / per_block) * kBlockWords + (t % per_block) * V;

  uint32_t acc[P][V];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[i][k] = 0;
  uint32_t next[4][V];
  load_half<V>(in, in_stride, base, 0, next);
  for (int u = 0; u < 2 * s; ++u) {
    uint32_t cur[4][V];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < V; ++k) cur[c][k] = next[c][k];
    if (u + 1 < 2 * s) load_half<V>(in, in_stride, base, u + 1, next);
    gf::build_table<V>(slots, cur);
    gf::apply_table<P, V>(slots, offs + u * P, acc);
  }
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (i < planes)
      store_vec<V>(out + (o0 + i / 8) * out_stride + (i % 8) * kPlaneWords + base,
                   acc[i]);
}

template <int R, int V>
cudaError_t launch_apply(const uint8_t* masks, int r, int s, const uint32_t* in,
                         int64_t in_stride, uint32_t* out, int64_t out_stride,
                         int64_t width, cudaStream_t stream) {
  const int smem = apply_shared_bytes<R, V>(s);
  if (smem > gf::kMaxSharedBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        planes_apply_kernel<R, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t threads = width / 8 / V;
  const dim3 grid(unsigned((threads + gf::kThreads - 1) / gf::kThreads),
                  unsigned((r + R - 1) / R));
  planes_apply_kernel<R, V><<<grid, gf::kThreads, smem, stream>>>(
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
// Strides and width in uint32 words, as for sw_gf_pack.  A block's shared
// memory (its table and 64 * R * s bytes of offsets, R <= 8 output rows a
// group) must fit in 227 KB: s <= 422 inputs from 5 output rows up.
extern "C" int sw_gf_planes_apply(const void* masks, int64_t r, int64_t s,
                                  const void* in, int64_t in_stride, void* out,
                                  int64_t out_stride, int64_t width,
                                  void* stream) {
  if (r <= 0 || s <= 0 || s > 65535 || (r + 7) / 8 > 65535 || width <= 0 ||
      width % kBlockWords)
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
  return int(launch_apply<8, 2>(m, ri, si, in_p, in_stride, out_p, out_stride, width, st));
}

extern "C" const char* sw_gf_planes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
