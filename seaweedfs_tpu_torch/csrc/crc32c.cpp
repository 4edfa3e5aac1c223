// CRC32-Castagnoli of needle payloads, on the host: the port's counterpart
// of seaweedfs_tpu/native/crc32c.cpp (the JAX package's native library,
// which the port does not load).  Polynomial 0x1EDC6F41 (reflected
// 0x82F63B78), incremental through the `crc` argument, the same values as
// the reference's needle checksums, by slicing-by-8 tables.  Plain C
// interface, built by ops/_build.py with g++ and bound with ctypes
// (util/crc32c.py).

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = t[0][i];
      for (int s = 1; s < 8; s++) {
        c = t[0][c & 0xFF] ^ (c >> 8);
        t[s][i] = c;
      }
    }
  }
};

const Tables kTables;

uint32_t crc32c(uint32_t c, const uint8_t* p, size_t n) {
  c = ~c;
  for (; n && (reinterpret_cast<uintptr_t>(p) & 7); n--) c = kTables.t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  for (; n >= 8; n -= 8, p += 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);  // little-endian host
    w ^= c;
    c = kTables.t[7][w & 0xFF] ^ kTables.t[6][(w >> 8) & 0xFF] ^ kTables.t[5][(w >> 16) & 0xFF] ^
        kTables.t[4][(w >> 24) & 0xFF] ^ kTables.t[3][(w >> 32) & 0xFF] ^
        kTables.t[2][(w >> 40) & 0xFF] ^ kTables.t[1][(w >> 48) & 0xFF] ^ kTables.t[0][w >> 56];
  }
  for (; n; n--) c = kTables.t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return ~c;
}

}  // namespace

extern "C" {

uint32_t sw_crc32c(uint32_t c, const uint8_t* p, int64_t n) { return crc32c(c, p, size_t(n)); }

// CRCs of `rows` buffers of `len` bytes each, `stride` bytes apart.
void sw_crc32c_rows(const uint8_t* p, int64_t rows, int64_t stride, int64_t len, uint32_t* out) {
  for (int64_t i = 0; i < rows; i++) out[i] = crc32c(0, p + i * stride, size_t(len));
}
}
