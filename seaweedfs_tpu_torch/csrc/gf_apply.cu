// GF(2^8) matrix apply over shard rows, hand-written for Hopper (sm_90a).
//
// Replaces seaweedfs_tpu/ops/rs_pallas.py:_make_kernel (kernel K1), the
// fused Pallas kernel that applies an RS encode or reconstruction matrix to
// shard rows: out[o][j] = XOR_i M[o][i] * in[i][j] over GF(2^8) with the
// klauspost field (polynomial 0x11D), byte-exact.
//
// Bound: device memory.  Each input byte is read once and each output byte
// written once, so the least time is (s + r) * n bytes / 3.35 TB/s.  The
// first version gathered from 256-byte product rows in shared memory, one
// byte lookup per coefficient per byte (1280 per 32 bytes of column at
// 10 -> 4), with bank conflicts on random bytes: that held it to 23-29% of
// the bound.
//
// Design: what the TPU kernel does, bit-slice, XOR, un-slice, with nothing
// through device memory between, but with the GF(2) work done by the table
// apply of gf_table.cuh instead of a compiled XOR schedule, so the matrix
// stays runtime data in device memory and one build serves the encode
// matrix and every reconstruction matrix.  Each block derives its table
// offsets from the matrix: for output plane (o, p), input row i and half h,
// entry k has bit c = bit p of M[o][i] * x^(4h + c).  Each thread then takes
// a column of 32 bytes of every row, as two 16-byte pieces kHalfTile (2 KB)
// apart, so that every warp load and store is contiguous.  Per input row (the
// next row's pieces prefetched) it transposes the 8 words into 8 bit-planes
// in registers (72 logic ops), builds the two 16-entry tables and does one
// shared load and XOR per output plane and half; per output row it
// transposes the 8 accumulated planes back and stores them.  Per 32 bytes of
// column at 10 -> 4 that is about 1870 logic ops and 940 shared
// accesses.  The shared accesses bound it: at the rate the H100 reaches on
// them, about 70% of one 128-byte wavefront a clock per SM, 10 x 64 MiB
// takes about 0.39 ms against a 0.28 ms byte time.  r > 8 goes to grid.y
// groups of 8 rows that each re-read and re-transpose the inputs.  Rows take
// a byte stride; a column that runs past n, or rows that are not 16-byte
// aligned, go through 4-byte or byte loads that zero-fill the missing bytes
// and stores of only the bytes inside the row (the apply is linear, so the
// zeros change nothing).

#include <cstdint>

#include <cuda_runtime.h>

#include "gf_table.cuh"

namespace {

using gf::kThreads;
constexpr int64_t kHalfTile = 16 * kThreads;  // piece B sits this far after piece A
constexpr int64_t kTileBytes = 2 * kHalfTile;  // the columns of one block

// x * a in GF(2^8) mod 0x11D.
__device__ __forceinline__ uint32_t xtime(uint32_t a) {
  a <<= 1;
  return (a & 0x100u) ? a ^ 0x11Du : a;
}

// 16 bytes at p into w, zero past `valid`; align is what p's row allows
// (16, 4 or 1 bytes).
__device__ __forceinline__ void load_piece(const uint8_t* p, int64_t valid,
                                           int align, uint32_t* w) {
  if (valid >= 16 && align == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if (valid >= 16 && align == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = __ldg(reinterpret_cast<const uint32_t*>(p) + q);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = 0;
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (b < valid) w[b >> 2] |= uint32_t(__ldg(p + b)) << (8 * (b & 3));
  }
}

__device__ __forceinline__ void store_piece(uint8_t* p, int64_t valid, int align,
                                            const uint32_t* w) {
  if (valid >= 16 && align == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (valid >= 16 && align == 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) reinterpret_cast<uint32_t*>(p)[q] = w[q];
  } else {
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (b < valid) p[b] = uint8_t(w[b >> 2] >> (8 * (b & 3)));
  }
}

// The 32-byte column of one row: words 0-3 from piece A, 4-7 from piece B.
__device__ __forceinline__ void load_column(const uint8_t* row, int64_t col,
                                            int64_t n, int align, uint32_t* x) {
  load_piece(row + col, n - col, align, x);
  load_piece(row + col + kHalfTile, n - col - kHalfTile, align, x + 4);
}

template <int R>
constexpr int apply_shared_bytes(int s) {
  return gf::table_bytes<1>() + 2 * s * 8 * R * 4;
}

// grid (ceil(n / kTileBytes), ceil(r / R)): block (x, y) computes output
// rows [R * y, R * y + R) of r over bytes [x * kTileBytes, (x + 1) *
// kTileBytes).  Dynamic shared memory: the table, then offs[u * 8R + i] for
// step u = 2i' + h (input row i', half h) and output plane i of the group.
template <int R>
__global__ void __launch_bounds__(kThreads)
    gf_apply_kernel(const uint8_t* __restrict__ matrix, int r, int s,
                    const uint8_t* __restrict__ in, int64_t in_stride,
                    uint8_t* __restrict__ out, int64_t out_stride, int64_t n,
                    int align) {
  constexpr int P = 8 * R;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* offs = reinterpret_cast<uint32_t*>(smem + gf::table_bytes<1>());
  const int o0 = blockIdx.y * R;
  for (int e = threadIdx.x; e < 2 * s * P; e += blockDim.x) {
    const int u = e / P, i = e % P;
    const int o = o0 + i / 8, p = i % 8;
    uint32_t k = 0;
    if (o < r) {
      uint32_t a = matrix[o * s + (u >> 1)];
      if (u & 1)
        for (int c = 0; c < 4; ++c) a = xtime(a);
      for (int c = 0; c < 4; ++c, a = xtime(a)) k |= ((a >> p) & 1u) << c;
    }
    offs[e] = k * gf::slot_stride<1>();
  }
  uint8_t* slots = smem + threadIdx.x * 4;
  gf::clear_slot0<1>(slots);
  __syncthreads();

  const int64_t col = int64_t(blockIdx.x) * kTileBytes + 16 * threadIdx.x;
  if (col >= n) return;

  uint32_t acc[P][1];
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i][0] = 0;
  uint32_t next[8];
  load_column(in, col, n, align, next);
  for (int i = 0; i < s; ++i) {
    uint32_t x[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = next[q];
    if (i + 1 < s) load_column(in + (i + 1) * in_stride, col, n, align, next);
    gf::transpose8(x);
    const uint32_t lo[4][1] = {{x[0]}, {x[1]}, {x[2]}, {x[3]}};
    const uint32_t hi[4][1] = {{x[4]}, {x[5]}, {x[6]}, {x[7]}};
    gf::build_table<1>(slots, lo);
    gf::apply_table<P, 1>(slots, offs + (2 * i) * P, acc);
    gf::build_table<1>(slots, hi);
    gf::apply_table<P, 1>(slots, offs + (2 * i + 1) * P, acc);
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (o0 + q >= r) break;
    uint32_t y[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) y[b] = acc[8 * q + b][0];
    gf::transpose8(y);
    uint8_t* row = out + (o0 + q) * out_stride;
    store_piece(row + col, n - col, align, y);
    store_piece(row + col + kHalfTile, n - col - kHalfTile, align, y + 4);
  }
}

template <int R>
cudaError_t launch(const uint8_t* matrix, int r, int s, const uint8_t* in,
                   int64_t in_stride, uint8_t* out, int64_t out_stride,
                   int64_t n, int align, cudaStream_t stream) {
  const int smem = apply_shared_bytes<R>(s);
  if (smem > gf::kMaxSharedBytes) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gf_apply_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(unsigned((n + kTileBytes - 1) / kTileBytes),
                  unsigned((r + R - 1) / R));
  gf_apply_kernel<R><<<grid, kThreads, smem, stream>>>(
      matrix, r, s, in, in_stride, out, out_stride, n, align);
  return cudaGetLastError();
}

}  // namespace

// out (r rows, byte stride out_stride) = matrix (r x s, row-major, device
// memory) applied to in (s rows, byte stride in_stride), n bytes per row, on
// `stream`.  Limits: a block's shared memory (8 KB of table and
// 64 * R * s bytes of offsets, R = 1, 2, 4 or 8 output rows a group) fits
// in 227 KB, and ceil(r / 8) grid rows fit in 65535.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int sw_gf_apply(const void* matrix, int64_t r, int64_t s,
                           const void* in, int64_t in_stride, void* out,
                           int64_t out_stride, int64_t n, void* stream) {
  if (r <= 0 || s <= 0 || s > 65535 || (r + 7) / 8 > 65535 || n <= 0 ||
      (n + kTileBytes - 1) / kTileBytes > 0x7FFFFFFF)
    return int(cudaErrorInvalidValue);
  const auto in_p = static_cast<const uint8_t*>(in);
  const auto out_p = static_cast<uint8_t*>(out);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(in_p) | reinterpret_cast<uintptr_t>(out_p) |
                         uintptr_t(in_stride) | uintptr_t(out_stride);
  const int align = (bits & 15u) == 0 ? 16 : (bits & 3u) == 0 ? 4 : 1;
  const auto m = static_cast<const uint8_t*>(matrix);
  const auto st = static_cast<cudaStream_t>(stream);
  const int ri = int(r), si = int(s);
  if (r == 1) return int(launch<1>(m, ri, si, in_p, in_stride, out_p, out_stride, n, align, st));
  if (r == 2) return int(launch<2>(m, ri, si, in_p, in_stride, out_p, out_stride, n, align, st));
  if (r <= 4) return int(launch<4>(m, ri, si, in_p, in_stride, out_p, out_stride, n, align, st));
  return int(launch<8>(m, ri, si, in_p, in_stride, out_p, out_stride, n, align, st));
}

extern "C" const char* sw_gf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
