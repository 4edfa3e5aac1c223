// GF(2^8) Reed-Solomon matrix multiply for the host CPU path.
//
// The port's copy of seaweedfs_tpu/native/gf256.cpp, built by g++ through
// ops/_build.py and bound with ctypes in ops/gf256_native.py.  Degraded
// needle reads (server/store_ec.py) and the EC scrub's repairs
// (storage/scrub.py) decode small 1 MB intervals that must not pay a
// device round trip, so they run here: the split-nibble table formulation
// klauspost/reedsolomon's AVX2 assembly and Intel ISA-L both use,
// out ^= LO[c][b & 15] ^ HI[c][b >> 4], vectorized with SSSE3 pshufb
// (runtime-dispatched), with scalar 256-entry tables otherwise.
//
// Field: x^8 + x^4 + x^3 + x^2 + 1 (0x11D), generator 2, the
// Backblaze/klauspost construction of ops/gf256.py; byte-equality with the
// plain torch codec and with the JAX package's host codec is held by
// tests/test_torch_host_codec.py.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define HAVE_X86_INTRINSICS 1
#endif

namespace {

constexpr unsigned kPoly = 0x11D;

uint8_t gf_mul_slow(unsigned a, unsigned b) {
  unsigned r = 0;
  while (b) {
    if (b & 1) r ^= a;
    a <<= 1;
    if (a & 0x100) a ^= kPoly;
    b >>= 1;
  }
  return static_cast<uint8_t>(r);
}

// ctypes releases the GIL during the foreign call and degraded reads run
// on many threads, so lazy init must be race-free: a function-local
// static ("magic static") gives C++11's guaranteed one-time, blocking
// construction — no hand-rolled flag whose store can reorder before the
// table fill.
struct Tables {
  uint8_t full[256][256];  // scalar path
  uint8_t lo[256][16];     // c * x          for x in 0..15
  uint8_t hi[256][16];     // c * (x << 4)   for x in 0..15
  Tables() {
    for (unsigned c = 0; c < 256; ++c) {
      for (unsigned x = 0; x < 256; ++x) full[c][x] = gf_mul_slow(c, x);
      for (unsigned x = 0; x < 16; ++x) {
        lo[c][x] = gf_mul_slow(c, x);
        hi[c][x] = gf_mul_slow(c, x << 4);
      }
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

void mul_xor_row_scalar(const Tables& tb, uint8_t c, const uint8_t* src,
                        uint8_t* acc, size_t n) {
  if (c == 1) {
    for (size_t j = 0; j < n; ++j) acc[j] ^= src[j];
    return;
  }
  const uint8_t* t = tb.full[c];
  for (size_t j = 0; j < n; ++j) acc[j] ^= t[src[j]];
}

#ifdef HAVE_X86_INTRINSICS
__attribute__((target("ssse3")))
void mul_xor_row_ssse3(const Tables& tb, uint8_t c, const uint8_t* src,
                       uint8_t* acc, size_t n) {
  size_t j = 0;
  if (c == 1) {
    for (; j + 16 <= n; j += 16) {
      __m128i s = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + j));
      __m128i a = _mm_loadu_si128(reinterpret_cast<__m128i*>(acc + j));
      _mm_storeu_si128(reinterpret_cast<__m128i*>(acc + j),
                       _mm_xor_si128(a, s));
    }
    for (; j < n; ++j) acc[j] ^= src[j];
    return;
  }
  const __m128i lo =
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(tb.lo[c]));
  const __m128i hi =
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(tb.hi[c]));
  const __m128i mask = _mm_set1_epi8(0x0F);
  for (; j + 16 <= n; j += 16) {
    __m128i s = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + j));
    __m128i lo_idx = _mm_and_si128(s, mask);
    __m128i hi_idx = _mm_and_si128(_mm_srli_epi64(s, 4), mask);
    __m128i prod = _mm_xor_si128(_mm_shuffle_epi8(lo, lo_idx),
                                 _mm_shuffle_epi8(hi, hi_idx));
    __m128i a = _mm_loadu_si128(reinterpret_cast<__m128i*>(acc + j));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(acc + j),
                     _mm_xor_si128(a, prod));
  }
  const uint8_t* t = tb.full[c];
  for (; j < n; ++j) acc[j] ^= t[src[j]];
}

bool has_ssse3() { return __builtin_cpu_supports("ssse3"); }
#endif

void mul_xor_row(const Tables& tb, uint8_t c, const uint8_t* src,
                 uint8_t* acc, size_t n) {
  if (c == 0) return;
#ifdef HAVE_X86_INTRINSICS
  static const bool ssse3 = has_ssse3();
  if (ssse3) {
    mul_xor_row_ssse3(tb, c, src, acc, n);
    return;
  }
#endif
  mul_xor_row_scalar(tb, c, src, acc, n);
}

// store-form multiply (dst = c * src): the leaf pass of the scheduled
// apply — skips the accumulator read the xor-form pays.
void mul_row_store_scalar(const Tables& tb, uint8_t c, const uint8_t* src,
                          uint8_t* dst, size_t n) {
  const uint8_t* t = tb.full[c];
  for (size_t j = 0; j < n; ++j) dst[j] = t[src[j]];
}

#ifdef HAVE_X86_INTRINSICS
__attribute__((target("ssse3")))
void mul_row_store_ssse3(const Tables& tb, uint8_t c, const uint8_t* src,
                         uint8_t* dst, size_t n) {
  const __m128i lo =
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(tb.lo[c]));
  const __m128i hi =
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(tb.hi[c]));
  const __m128i mask = _mm_set1_epi8(0x0F);
  size_t j = 0;
  for (; j + 16 <= n; j += 16) {
    __m128i s = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + j));
    __m128i lo_idx = _mm_and_si128(s, mask);
    __m128i hi_idx = _mm_and_si128(_mm_srli_epi64(s, 4), mask);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(dst + j),
                     _mm_xor_si128(_mm_shuffle_epi8(lo, lo_idx),
                                   _mm_shuffle_epi8(hi, hi_idx)));
  }
  const uint8_t* t = tb.full[c];
  for (; j < n; ++j) dst[j] = t[src[j]];
}
#endif

void mul_row_store(const Tables& tb, uint8_t c, const uint8_t* src,
                   uint8_t* dst, size_t n) {
  if (c == 0) {
    std::memset(dst, 0, n);
    return;
  }
  if (c == 1) {
    std::memcpy(dst, src, n);
    return;
  }
#ifdef HAVE_X86_INTRINSICS
  static const bool ssse3 = has_ssse3();
  if (ssse3) {
    mul_row_store_ssse3(tb, c, src, dst, n);
    return;
  }
#endif
  mul_row_store_scalar(tb, c, src, dst, n);
}

// dst = a ^ b, store form (no accumulator read); word-at-a-time — the
// compiler vectorizes this at -O3 and it is memory-bound anyway.
void xor_rows_store(uint8_t* dst, const uint8_t* a, const uint8_t* b,
                    size_t n) {
  size_t j = 0;
  for (; j + 8 <= n; j += 8) {
    uint64_t va, vb;
    std::memcpy(&va, a + j, 8);
    std::memcpy(&vb, b + j, 8);
    va ^= vb;
    std::memcpy(dst + j, &va, 8);
  }
  for (; j < n; ++j) dst[j] = a[j] ^ b[j];
}

}  // namespace

extern "C" {

// out_rows[r][0..n) = sum_t mat[r][t] * src_rows[t][0..n) over GF(2^8).
//
// Row-POINTER form: callers hand pread buffers and output buffers
// directly (zero staging copies).  Column-blocked so
// every src row is read from RAM once per block while all output rows
// accumulate from cache, not once per output row from RAM (k+m passes
// -> 1 streaming pass; reference klauspost does the same via its
// per-32KB "split" loop).
void sw_gf_mat_mul_rows(const uint8_t* mat, size_t rows, size_t k,
                        const uint8_t* const* src_rows, size_t n,
                        uint8_t* const* out_rows) {
  const Tables& tb = tables();
  constexpr size_t kBlock = 64 * 1024;  // fits k+rows slices in L2
  for (size_t off = 0; off < n; off += kBlock) {
    const size_t len = (n - off < kBlock) ? (n - off) : kBlock;
    for (size_t r = 0; r < rows; ++r) {
      uint8_t* acc = out_rows[r] + off;
      std::memset(acc, 0, len);
      const uint8_t* coeffs = mat + r * k;
      for (size_t t = 0; t < k; ++t) {
        mul_xor_row(tb, coeffs[t], src_rows[t] + off, acc, len);
      }
    }
  }
}

// Scheduled leaf+XOR program apply: the executor for a leaf+XOR program
// such as the JAX package's ops/xor_sched.host_plan emits (gfcheck proves
// those programs symbolically).
//
// Term space is [leaves..., ops...]: leaf i = leaf_coeff[i] *
// src_rows[leaf_src[i]] (coefficient 1 ALIASES the source row — zero
// passes, which is what turns LRC's all-ones local-repair matrices into
// pure row XOR with no table lookups); op j = term[ops[2j]] ^
// term[ops[2j+1]]; out_rows[r] = XOR of row_terms[row_offsets[r] ..
// row_offsets[r+1]).  Ops reference only earlier terms (the planner
// emits topological order; the Python binding rejects anything else).
// Column-blocked like sw_gf_mat_mul_rows so every temporary lives in
// cache; out rows must not alias src rows.
void sw_gf_sched_apply(const uint8_t* leaf_coeff, const uint32_t* leaf_src,
                       size_t n_leaves, const uint32_t* ops, size_t n_ops,
                       const uint32_t* row_offsets, const uint32_t* row_terms,
                       size_t n_out, const uint8_t* const* src_rows, size_t n,
                       uint8_t* const* out_rows) {
  const Tables& tb = tables();
  constexpr size_t kBlock = 64 * 1024;
  const size_t n_terms = n_leaves + n_ops;
  // fixed slot assignment: coefficient-1 leaves alias their source row,
  // everything else gets a scratch slot
  size_t n_slots = n_ops;
  for (size_t i = 0; i < n_leaves; ++i) {
    if (leaf_coeff[i] != 1) ++n_slots;
  }
  std::vector<uint8_t> scratch(n_slots * kBlock);
  std::vector<uint8_t*> slot_ptr(n_terms, nullptr);
  size_t slot = 0;
  for (size_t i = 0; i < n_leaves; ++i) {
    if (leaf_coeff[i] != 1) slot_ptr[i] = scratch.data() + (slot++) * kBlock;
  }
  for (size_t j = 0; j < n_ops; ++j) {
    slot_ptr[n_leaves + j] = scratch.data() + (slot++) * kBlock;
  }
  std::vector<const uint8_t*> term(n_terms);
  for (size_t off = 0; off < n; off += kBlock) {
    const size_t len = (n - off < kBlock) ? (n - off) : kBlock;
    for (size_t i = 0; i < n_leaves; ++i) {
      const uint8_t* src = src_rows[leaf_src[i]] + off;
      if (leaf_coeff[i] == 1) {
        term[i] = src;
      } else {
        mul_row_store(tb, leaf_coeff[i], src, slot_ptr[i], len);
        term[i] = slot_ptr[i];
      }
    }
    for (size_t j = 0; j < n_ops; ++j) {
      uint8_t* dst = slot_ptr[n_leaves + j];
      xor_rows_store(dst, term[ops[2 * j]], term[ops[2 * j + 1]], len);
      term[n_leaves + j] = dst;
    }
    for (size_t r = 0; r < n_out; ++r) {
      uint8_t* dst = out_rows[r] + off;
      uint32_t b = row_offsets[r], e = row_offsets[r + 1];
      if (b == e) {
        std::memset(dst, 0, len);
        continue;
      }
      std::memcpy(dst, term[row_terms[b]], len);
      for (uint32_t t = b + 1; t < e; ++t) {
        // dst ^= term: c==1 takes mul_xor_row's pure load/xor/store
        // fast path — no table shuffles anywhere in an all-ones plan
        mul_xor_row(tb, 1, term[row_terms[t]], dst, len);
      }
    }
  }
}

// out (rows, n) = mat (rows, k) × src (k, n) over GF(2^8); all row-major
// contiguous.  out must not alias src.
void sw_gf_mat_mul(const uint8_t* mat, size_t rows, size_t k,
                   const uint8_t* src, size_t n, uint8_t* out) {
  const uint8_t* srcs[256];
  uint8_t* outs[256];
  if (k <= 256 && rows <= 256) {
    for (size_t t = 0; t < k; ++t) srcs[t] = src + t * n;
    for (size_t r = 0; r < rows; ++r) outs[r] = out + r * n;
    sw_gf_mat_mul_rows(mat, rows, k, srcs, n, outs);
    return;
  }
  const Tables& tb = tables();
  for (size_t r = 0; r < rows; ++r) {
    uint8_t* acc = out + r * n;
    std::memset(acc, 0, n);
    const uint8_t* coeffs = mat + r * k;
    for (size_t t = 0; t < k; ++t) {
      mul_xor_row(tb, coeffs[t], src + t * n, acc, n);
    }
  }
}

}  // extern "C"
