// The table-driven GF(2) apply shared by gf_apply.cu (K1) and gf_planes.cu
// (K2), and the 8x8 bit transpose that K1 and the pack/unpack kernels use.
//
// A GF(2^8) matrix lowered to GF(2) maps 8 input bit-planes per shard row to
// 8 output planes per output row: output plane i is the XOR of the input
// planes (j, c) whose bit [i, 8j + c] is set.  Testing every bit costs one
// instruction per (i, j, c) whether the bit is set or not, which made the
// first K2 issue-bound.  The "method of four Russians" removes the tests:
// for each input row j and half h, the 16 XORs of subsets of planes
// 4h .. 4h+3 are built once (11 XORs, 15 shared stores), and each output
// plane then does ONE shared load and ONE XOR, at table entry k = the four
// matrix bits of (i, j, h).  The matrix stays runtime data: k becomes a
// byte offset, the same for every thread of the block, kept in shared
// memory beside the table.
//
// Each thread owns 16 slots of V words.  Slot k of thread t sits at byte
// (k * kThreads + t) * 4V of the table, so the 32 threads of a warp reading
// one k touch consecutive words: no bank conflict.  A thread reads only
// slots it wrote itself, so no barrier is needed between building a table
// and reading it, and slot 0 (all zeros) is written once.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace gf {

constexpr int kThreads = 128;  // K1's and K2's block size
constexpr int kMaxSharedBytes = 232448;  // 227 KB: the most a block may use

// Bytes between slot k and slot k + 1 of one thread.
template <int V>
__host__ __device__ constexpr uint32_t slot_stride() {
  return uint32_t(kThreads) * 4 * V;
}

// A block's table: 16 slots of V words for each of its threads.
template <int V>
__host__ __device__ constexpr int table_bytes() {
  return 16 * int(slot_stride<V>());
}

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
// 72 logic ops; it is its own inverse.
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

template <int V>
__device__ __forceinline__ void store_slot(uint8_t* p, const uint32_t* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = v[0];
  }
}

template <int V>
__device__ __forceinline__ void xor_slot(const uint8_t* p, uint32_t* acc) {
  if constexpr (V == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    acc[0] ^= x.x, acc[1] ^= x.y, acc[2] ^= x.z, acc[3] ^= x.w;
  } else if constexpr (V == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    acc[0] ^= x.x, acc[1] ^= x.y;
  } else {
    acc[0] ^= *reinterpret_cast<const uint32_t*>(p);
  }
}

// Slot 0 of this thread's table: the empty combination.
template <int V>
__device__ __forceinline__ void clear_slot0(uint8_t* slots) {
  const uint32_t zero[V] = {};
  store_slot<V>(slots, zero);
}

// Slots 1..15 of this thread's table: slot k = XOR of p[c] over the set
// bits c of k.  11 XORs per word.
template <int V>
__device__ __forceinline__ void build_table(uint8_t* slots, const uint32_t (&p)[4][V]) {
  uint32_t t[16][V];
#pragma unroll
  for (int v = 0; v < V; ++v) t[0][v] = 0;
#pragma unroll
  for (int k = 1; k < 16; ++k) {
    const int low = k & -k;
    const int c = low == 1 ? 0 : low == 2 ? 1 : low == 4 ? 2 : 3;
#pragma unroll
    for (int v = 0; v < V; ++v) t[k][v] = t[k ^ low][v] ^ p[c][v];
    store_slot<V>(slots + k * slot_stride<V>(), t[k]);
  }
}

// acc[i] ^= this thread's slot at byte offset offs[i], for P output planes
// (P a multiple of 4; offs 16-byte aligned, the same for every thread).
template <int P, int V>
__device__ __forceinline__ void apply_table(const uint8_t* slots, const uint32_t* offs,
                                            uint32_t (&acc)[P][V]) {
#pragma unroll
  for (int i = 0; i < P; i += 4) {
    const uint4 o = *reinterpret_cast<const uint4*>(offs + i);
    xor_slot<V>(slots + o.x, acc[i]);
    xor_slot<V>(slots + o.y, acc[i + 1]);
    xor_slot<V>(slots + o.z, acc[i + 2]);
    xor_slot<V>(slots + o.w, acc[i + 3]);
  }
}

}  // namespace gf
