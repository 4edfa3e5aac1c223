// Native HTTP data plane for the volume server's needle hot path and the
// gateways' chunk splice: the port's copy of seaweedfs_tpu/native/dp.cpp,
// with its ABI, byte formats and status codes.
//
// The reference's needle GET/POST loop is a compiled goroutine-per-connection
// server (weed/server/volume_server_handlers_read.go:132,
// volume_server_handlers_write.go:18); CPython's ThreadingHTTPServer tops out
// ~300us/request of interpreter work.  This file is a thread-per-connection
// C++ accept loop that owns the hot subset --
//
//   GET  /vid,fid          pread + needle parse from a native id->(off,size)
//                          map (cookie check, CRC verify, Range, gzip
//                          pass-through); EC volumes from local shards
//   POST /vid,fid          v2/v3 record build + CRC32C + serialized append to
//                          .dat and .idx, for unreplicated volumes, ?type=
//                          replicate peer writes and primaries whose replica
//                          addresses are known (pipelined fan-out)
//   DELETE /vid,fid        tombstone append (normal volumes only)
//
// -- and forwards byte-for-byte everything it does not understand (EC misses,
// query-string reads, JWT-gated writes, /status, /metrics) to the full Python
// server listening on an internal loopback port.  Python remains the source
// of truth for control flow; index mutations made here are pushed back
// through a bounded event queue drained by native/dataplane.py.  The px
// section (sw_px_*) is the gateway side: S3 / filer chunk bodies relayed
// volume <-> client with no CPython copies (filer/splice.py).
//
// Built by ops/_build.py with g++ (-pthread) together with crc32c.cpp into
// one host library, bound with ctypes by native/dataplane.py.
//
// Byte contracts (must stay bit-identical to the Python implementations):
//   needle record   storage/needle.py to_bytes (v2/v3)
//   .idx entry      storage/types.py pack_index_entry  (key 8BE, off/8 in
//                   the volume's offset width -- 4BE, or 4BE low + high
//                   byte at width 5 -- size 4BE signed; tombstone == -1)
//   crc             sw_crc32c (crc32c.cpp), seeded 0

#include <arpa/inet.h>
#include <linux/io_uring.h>
#include <linux/time_types.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/mman.h>
#include <sys/sendfile.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/uio.h>
#include <fcntl.h>
#include <poll.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cerrno>
#include <condition_variable>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <deque>
#include <exception>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <system_error>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

extern "C" uint32_t sw_crc32c(uint32_t crc, const uint8_t* buf, int64_t len);

namespace {

// ---------------------------------------------------------------- constants
constexpr int kNeedleHeaderSize = 16;
constexpr int kChecksumSize = 4;
constexpr int kTimestampSize = 8;
constexpr int kPad = 8;
// per-volume cap: 2^(8*offset_width) stored 8-byte units — 32GB at the
// reference-compatible width 4, 8TB at width 5 (offset_5bytes.go)
inline int64_t max_volume_size(int offset_width) {
  return (1LL << (8 * offset_width)) * 8;
}
constexpr uint8_t kFlagCompressed = 0x01;
constexpr uint8_t kFlagHasLastModified = 0x08;
constexpr size_t kMaxHeaderBytes = 64 * 1024;
constexpr int64_t kMaxNativeBody = 256LL * 1024 * 1024;
constexpr size_t kMaxEvents = 1 << 18;
constexpr int kSockTimeoutSec = 120;

// ------------------------------------------------------------- BE helpers
inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}
inline uint64_t be64(const uint8_t* p) {
  return (uint64_t(be32(p)) << 32) | be32(p + 4);
}
inline void put_be32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}
inline void put_be64(uint8_t* p, uint64_t v) {
  put_be32(p, v >> 32);
  put_be32(p + 4, (uint32_t)v);
}

inline int padding_len(int32_t size, int version) {
  int tail = kChecksumSize + (version == 3 ? kTimestampSize : 0);
  return kPad - ((kNeedleHeaderSize + size + tail) % kPad);
}
inline int64_t record_disk_size(int32_t size, int version) {
  int tail = kChecksumSize + (version == 3 ? kTimestampSize : 0);
  return kNeedleHeaderSize + size + tail + padding_len(size, version);
}

// ---------------------------------------------------------------- IO utils
bool pread_full(int fd, uint8_t* buf, size_t len, int64_t off) {
  while (len) {
    ssize_t n = ::pread(fd, buf, len, off);
    if (n <= 0) {
      if (n < 0 && errno == EINTR) continue;
      return false;
    }
    buf += n; off += n; len -= n;
  }
  return true;
}
bool pwrite_full(int fd, const uint8_t* buf, size_t len, int64_t off) {
  while (len) {
    ssize_t n = ::pwrite(fd, buf, len, off);
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    buf += n; off += n; len -= n;
  }
  return true;
}
bool write_full(int fd, const uint8_t* buf, size_t len) {
  while (len) {
    ssize_t n = ::write(fd, buf, len);
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    buf += n; len -= n;
  }
  return true;
}
bool send_full(int fd, const void* p, size_t len) {
  const uint8_t* buf = (const uint8_t*)p;
  while (len) {
    ssize_t n = ::send(fd, buf, len, MSG_NOSIGNAL);
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    buf += n; len -= n;
  }
  return true;
}
// recv with EINTR retry; 0 on orderly close, -1 on error/timeout.
ssize_t recv_some(int fd, void* buf, size_t len) {
  for (;;) {
    ssize_t n = ::recv(fd, buf, len, 0);
    if (n >= 0) return n;
    if (errno != EINTR) return -1;
  }
}

// ------------------------------------------------------------------ state
struct Entry {
  int64_t off;
  int32_t size;
};

struct Vol {
  uint32_t vid = 0;
  int dat_fd = -1;
  int idx_fd = -1;
  int version = 3;
  int offset_width = 4;  // .idx offset bytes (4 or 5); fixed per volume
  std::atomic<bool> active{false};  // not routable until the key bulk-load
                                    // lands (sw_dp_activate_volume)
  std::atomic<int> copy_count{1};
  std::atomic<bool> read_only{false};
  std::mutex append_mu;           // serializes .dat/.idx appends
  bool closed = false;            // unregistered; guarded by append_mu —
                                  // fences in-flight appends vs vacuum swap
  int64_t end = 0;                // .dat size; guarded by append_mu
  uint64_t last_ns = 0;           // guarded by append_mu
  std::shared_mutex map_mu;
  std::unordered_map<uint64_t, Entry> map;
  // peer public addresses holding the other copies (replicated volumes);
  // resolved and pushed by Python (TTL-refreshed), empty = fan-out not
  // available natively and primary writes forward
  std::shared_mutex rep_mu;
  std::vector<std::string> replicas;

  ~Vol() {
    if (dat_fd >= 0) ::close(dat_fd);
    if (idx_fd >= 0) ::close(idx_fd);
  }
};

// EC volume served natively from LOCAL shards: sorted .ecx binary
// search + striped interval reads (ec_locate.py geometry).  Reads that
// need a missing shard (remote fetch / reconstruction) forward to
// Python; deletes stay Python-side and are visible here because the
// .ecx tombstone is pwritten in place on the same inode.
struct EcVol {
  uint32_t vid = 0;
  int ecx_fd = -1;
  int version = 3;
  int offset_width = 4;
  int entry_size = 16;
  int k = 10;
  int total = 14;
  int64_t large_block = 1LL << 30;
  int64_t small_block = 1LL << 20;
  int64_t locate_shard_size = 0;  // geometry input (dat_size/k or ec00-1)
  int64_t ecx_entries = 0;
  std::shared_mutex shard_mu;
  std::vector<int> shard_fds;  // per shard id; -1 = not local

  ~EcVol() {
    if (ecx_fd >= 0) ::close(ecx_fd);
    for (int fd : shard_fds)
      if (fd >= 0) ::close(fd);
  }
};

struct Event {
  uint32_t vid;
  int32_t size;       // >0 put, -1 delete
  uint64_t key;
  uint64_t off;
  uint64_t append_ns;
  int64_t old_size;   // superseded live size, -1 if fresh
};
static_assert(sizeof(Event) == 40, "event wire size");  // py: _EVENT

// --------------------------------------------------------- observability
// Per-verb request counters + latency histograms, polled by Python
// (native/dataplane.py metrics_snapshot -> stats.NATIVE_DP_REQUESTS) so
// /metrics finally reflects the traffic this loop serves.
constexpr int kVerbGet = 0, kVerbPost = 1, kVerbDelete = 2, kVerbForward = 3;
constexpr int kNVerbs = 4;
constexpr int kNLatencyBounds = 13;  // bounds in ns; +Inf bucket appended
constexpr uint64_t kLatencyBoundsNs[kNLatencyBounds] = {
    100000ull,    250000ull,    500000ull,    1000000ull,   2500000ull,
    5000000ull,   10000000ull,  25000000ull,  50000000ull,  100000000ull,
    250000000ull, 500000000ull, 1000000000ull};
constexpr int kMetricsPerVerb = 2 + kNLatencyBounds + 1;  // count, sum_ns, buckets

struct VerbMetrics {
  std::atomic<uint64_t> count{0};
  std::atomic<uint64_t> sum_ns{0};
  std::atomic<uint64_t> buckets[kNLatencyBounds + 1]{};
};

// One span record for a natively-served request that carried a W3C
// traceparent header: Python drains these (sw_dp_trace_drain) and folds
// them into the stats/trace.py ring as native-plane child spans.
// Forwarded requests emit nothing — the Python server sees their headers
// itself and spans there.
struct TraceRec {
  char trace_id[32];   // hex, not NUL-terminated
  char parent_id[16];  // caller's span id (hex)
  uint8_t verb;
  uint8_t status;      // HTTP status / 100 (0 = unknown)
  uint16_t _pad;
  uint32_t vid;
  uint64_t start_unix_ns;
  uint64_t dur_ns;
};
static_assert(sizeof(TraceRec) == 72, "trace record wire size");  // py: _TRACE
constexpr size_t kMaxTraceRecs = 4096;

struct Dp {
  int listen_fd = -1;
  int port = 0;
  int upstream_port = 0;
  bool jwt_required = false;
  std::atomic<bool> stopping{false};
  std::thread accept_thread;

  std::shared_mutex vols_mu;
  std::unordered_map<uint32_t, std::shared_ptr<Vol>> vols;

  std::shared_mutex ec_mu;
  std::unordered_map<uint32_t, std::shared_ptr<EcVol>> ec_vols;

  std::mutex ev_mu;
  std::deque<Event> events;
  std::atomic<uint64_t> events_lost{0};

  // stats: [0]=native reads [1]=native writes [2]=forwarded [3]=read bytes
  // [4]=write bytes [5]=404s [6]=errors [7]=connections
  std::atomic<uint64_t> stats[8]{};

  VerbMetrics verb_metrics[kNVerbs];
  std::mutex tr_mu;
  std::deque<TraceRec> trace_recs;
  std::atomic<uint64_t> traces_lost{0};

  std::atomic<uint64_t> reqid_counter{1};
  // total bytes of upload bodies currently buffered by native POST threads;
  // past the bound new uploads forward to Python, whose InFlightLimiter
  // applies real backpressure (reference inFlightUploadDataLimitCond)
  std::atomic<int64_t> upload_inflight{0};

  std::shared_ptr<Vol> find(uint32_t vid) {
    std::shared_lock lk(vols_mu);
    auto it = vols.find(vid);
    if (it == vols.end() || !it->second->active.load(std::memory_order_acquire))
      return nullptr;
    return it->second;
  }
  std::shared_ptr<Vol> find_any(uint32_t vid) {  // staging included
    std::shared_lock lk(vols_mu);
    auto it = vols.find(vid);
    return it == vols.end() ? nullptr : it->second;
  }
  std::shared_ptr<EcVol> find_ec(uint32_t vid) {
    std::shared_lock lk(ec_mu);
    auto it = ec_vols.find(vid);
    return it == ec_vols.end() ? nullptr : it->second;
  }
  void push_event(const Event& e) {
    std::lock_guard lk(ev_mu);
    if (events.size() >= kMaxEvents) {
      events_lost.fetch_add(1, std::memory_order_relaxed);
      return;
    }
    events.push_back(e);
  }
  void observe(int verb, uint64_t dur_ns) {
    VerbMetrics& m = verb_metrics[verb];
    m.count.fetch_add(1, std::memory_order_relaxed);
    m.sum_ns.fetch_add(dur_ns, std::memory_order_relaxed);
    int b = 0;
    while (b < kNLatencyBounds && dur_ns > kLatencyBoundsNs[b]) b++;
    m.buckets[b].fetch_add(1, std::memory_order_relaxed);
  }
  void push_trace(const TraceRec& t) {
    std::lock_guard lk(tr_mu);
    if (trace_recs.size() >= kMaxTraceRecs) {
      // spans are diagnostics, not state: dropping the oldest keeps the
      // newest (most useful) traces when nobody drains
      trace_recs.pop_front();
      traces_lost.fetch_add(1, std::memory_order_relaxed);
    }
    trace_recs.push_back(t);
  }
};

// ------------------------------------------------------------ HTTP parsing
struct Req {
  std::string method;
  std::string target;      // path without query
  std::string query;
  std::string range;       // raw Range header value ("" if absent)
  std::string ctype;       // Content-Type (drives compress-on-write routing)
  std::string reqid;
  std::string traceparent; // W3C trace context ("" if absent)
  int64_t content_length = 0;
  bool has_content_length = false;
  bool conn_close = false;
  bool accept_gzip = false;
  bool chunked = false;
  bool expect_continue = false;
  size_t header_len = 0;   // bytes of the raw request head (incl CRLFCRLF)
};

bool iequal(const char* a, size_t alen, const char* b) {
  size_t blen = strlen(b);
  if (alen != blen) return false;
  for (size_t i = 0; i < alen; i++)
    if (tolower((unsigned char)a[i]) != b[i]) return false;
  return true;
}

// Parse the request head sitting in buf[0..len); returns false on malformed.
bool parse_request(const char* buf, size_t len, Req* r) {
  const char* end = buf + len;
  const char* line_end = (const char*)memmem(buf, len, "\r\n", 2);
  if (!line_end) return false;
  // request line: METHOD SP target SP HTTP/1.x
  const char* sp1 = (const char*)memchr(buf, ' ', line_end - buf);
  if (!sp1) return false;
  const char* sp2 = (const char*)memchr(sp1 + 1, ' ', line_end - (sp1 + 1));
  if (!sp2) return false;
  r->method.assign(buf, sp1 - buf);
  std::string raw_target(sp1 + 1, sp2 - (sp1 + 1));
  size_t q = raw_target.find('?');
  if (q == std::string::npos) {
    r->target = raw_target;
  } else {
    r->target = raw_target.substr(0, q);
    r->query = raw_target.substr(q + 1);
  }
  // headers
  const char* p = line_end + 2;
  while (p < end) {
    const char* le = (const char*)memmem(p, end - p, "\r\n", 2);
    if (!le) return false;
    if (le == p) { r->header_len = (le + 2) - buf; return true; }  // blank
    const char* colon = (const char*)memchr(p, ':', le - p);
    if (colon) {
      size_t nlen = colon - p;
      const char* v = colon + 1;
      while (v < le && (*v == ' ' || *v == '\t')) v++;
      size_t vlen = le - v;
      if (iequal(p, nlen, "content-length")) {
        r->content_length = strtoll(std::string(v, vlen).c_str(), nullptr, 10);
        r->has_content_length = true;
      } else if (iequal(p, nlen, "connection")) {
        if (vlen >= 5 && strncasecmp(v, "close", 5) == 0) r->conn_close = true;
      } else if (iequal(p, nlen, "accept-encoding")) {
        if (memmem(v, vlen, "gzip", 4)) r->accept_gzip = true;
      } else if (iequal(p, nlen, "range")) {
        r->range.assign(v, vlen);
      } else if (iequal(p, nlen, "content-type")) {
        r->ctype.assign(v, vlen);
      } else if (iequal(p, nlen, "transfer-encoding")) {
        if (memmem(v, vlen, "chunked", 7)) r->chunked = true;
      } else if (iequal(p, nlen, "expect")) {
        if (memmem(v, vlen, "100-continue", 12)) r->expect_continue = true;
      } else if (iequal(p, nlen, "x-request-id")) {
        r->reqid.assign(v, vlen);
      } else if (iequal(p, nlen, "traceparent")) {
        r->traceparent.assign(v, vlen);
      }
    }
    p = le + 2;
  }
  return false;  // no blank line: head incomplete/malformed
}

struct Fid {
  uint32_t vid = 0;
  uint64_t key = 0;
  uint32_t cookie = 0;
  bool ok = false;
};

// "vid,keyhex+8hexcookie[_N][.ext]" — mirrors server/volume_server.py
// parse_fid including the batch-assign `_N` suffix convention.
Fid parse_fid(const std::string& target) {
  Fid f;
  if (target.size() < 2 || target[0] != '/') return f;
  std::string s = target.substr(1);
  size_t dot = s.find('.');
  if (dot != std::string::npos) s = s.substr(0, dot);
  size_t comma = s.find(',');
  if (comma == std::string::npos || comma == 0) return f;
  uint64_t vid = 0;
  for (size_t i = 0; i < comma; i++) {
    if (!isdigit((unsigned char)s[i])) return f;
    vid = vid * 10 + (s[i] - '0');
    if (vid > 0xFFFFFFFFull) return f;
  }
  std::string rest = s.substr(comma + 1);
  uint64_t add = 0;
  size_t us = rest.find('_');
  if (us != std::string::npos) {
    std::string idx = rest.substr(us + 1);
    rest = rest.substr(0, us);
    if (!idx.empty()) {
      for (char c : idx) {
        if (!isdigit((unsigned char)c)) { add = 0; goto no_index; }
      }
      add = strtoull(idx.c_str(), nullptr, 10);
    }
  no_index:;
  }
  if (rest.size() <= 8 || rest.size() > 24) return f;
  for (char c : rest)
    if (!isxdigit((unsigned char)c)) return f;
  f.vid = (uint32_t)vid;
  f.key = strtoull(rest.substr(0, rest.size() - 8).c_str(), nullptr, 16) + add;
  f.cookie = (uint32_t)strtoull(rest.substr(rest.size() - 8).c_str(), nullptr, 16);
  f.ok = true;
  return f;
}

// Compress-on-write candidate check (storage/compression.py is_gzippable +
// MIN_COMPRESS_SIZE): such uploads forward so Python keeps the gzip
// decision; everything else appends natively as raw bytes.
bool ends_with(const std::string& s, const char* suf) {
  size_t n = strlen(suf);
  return s.size() >= n && s.compare(s.size() - n, n, suf) == 0;
}

bool may_compress_on_write(const std::string& ctype_raw,
                           const std::string& name_raw, int64_t clen) {
  if (clen < 128) return false;  // MIN_COMPRESS_SIZE
  std::string mime = ctype_raw.substr(0, ctype_raw.find(';'));
  size_t a = mime.find_first_not_of(" \t");
  size_t b = mime.find_last_not_of(" \t");
  mime = a == std::string::npos ? "" : mime.substr(a, b - a + 1);
  for (auto& ch : mime) ch = tolower((unsigned char)ch);
  std::string name = name_raw;
  for (auto& ch : name) ch = tolower((unsigned char)ch);
  if (name.find('%') != std::string::npos) return true;  // url-encoded: punt
  static const char* kIncompressible[] = {
      ".gz", ".zst", ".zip", ".jpg", ".jpeg", ".png", ".webp",
      ".mp4", ".mp3", ".7z", ".br"};
  for (const char* suf : kIncompressible)
    if (ends_with(name, suf)) return false;
  if (mime.rfind("text/", 0) == 0) return true;
  static const char* kGzippableMimes[] = {
      "application/json",   "application/xml",  "application/javascript",
      "application/x-javascript", "application/yaml",
      "application/x-ndjson", "image/svg+xml"};
  for (const char* m : kGzippableMimes)
    if (mime == m) return true;
  static const char* kGzippableSuffixes[] = {
      ".txt", ".html", ".htm", ".css", ".js",   ".json", ".xml",
      ".csv", ".md",   ".log", ".yaml", ".yml", ".svg"};
  for (const char* suf : kGzippableSuffixes)
    if (ends_with(name, suf)) return true;
  return false;
}

// Tiny query-string scan: fills found[i] with the value of keys[i] ("" when
// absent); returns false if any *unknown* key is present (caller forwards).
bool scan_query(const std::string& q, const char* const* keys, int nkeys,
                std::string* found) {
  size_t i = 0;
  while (i < q.size()) {
    size_t amp = q.find('&', i);
    if (amp == std::string::npos) amp = q.size();
    std::string pair = q.substr(i, amp - i);
    i = amp + 1;
    if (pair.empty()) continue;
    size_t eq = pair.find('=');
    std::string k = eq == std::string::npos ? pair : pair.substr(0, eq);
    std::string v = eq == std::string::npos ? "" : pair.substr(eq + 1);
    bool known = false;
    for (int j = 0; j < nkeys; j++) {
      if (k == keys[j]) { found[j] = v; known = true; break; }
    }
    if (!known) return false;
  }
  return true;
}

// ------------------------------------------------------------- connection
struct Conn {
  Dp* dp;
  int fd = -1;
  int up_fd = -1;  // lazy upstream connection to the Python server
  // persistent keep-alive connections to replica peers (fan-out)
  std::unordered_map<std::string, int> peer_fds;

  ~Conn() {
    if (fd >= 0) ::close(fd);
    if (up_fd >= 0) ::close(up_fd);
    for (auto& kv : peer_fds)
      if (kv.second >= 0) ::close(kv.second);
  }
};

void set_sock_opts(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  struct timeval tv{kSockTimeoutSec, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
}

// "00-<32hex>-<16hex>-<2hex>" (W3C traceparent): copy the ids out.
// All-zero ids are forbidden by the spec and rejected by the Python
// parser too — accepting them here would file orphan spans under a
// bogus trace while every Python-side server ignored the header.
bool parse_traceparent_ids(const std::string& v, char* trace_id,
                           char* parent_id) {
  if (v.size() != 55 || v[2] != '-' || v[35] != '-' || v[52] != '-')
    return false;
  for (int i = 0; i < 55; i++) {
    if (i == 2 || i == 35 || i == 52) continue;
    if (!isxdigit((unsigned char)v[i])) return false;
  }
  bool trace_zero = true, span_zero = true;
  for (int i = 3; i < 35; i++)
    if (v[i] != '0') { trace_zero = false; break; }
  for (int i = 36; i < 52; i++)
    if (v[i] != '0') { span_zero = false; break; }
  if (trace_zero || span_zero) return false;
  memcpy(trace_id, v.data() + 3, 32);
  memcpy(parent_id, v.data() + 36, 16);
  return true;
}

std::string request_id(Dp* dp, const Req& r) {
  if (!r.reqid.empty() && r.reqid.size() <= 64) {
    bool ok = true;
    for (char c : r.reqid)
      if (!isalnum((unsigned char)c) && c != '.' && c != '_' && c != '-') {
        ok = false;
        break;
      }
    if (ok) return r.reqid;
  }
  char buf[24];
  snprintf(buf, sizeof buf, "n%014llx",
           (unsigned long long)dp->reqid_counter.fetch_add(1));
  return buf;
}

// Send a simple full response; body may be empty.
bool reply(Conn* c, const Req& r, int code, const char* reason,
           const char* ctype, const void* body, size_t blen,
           const char* extra = nullptr) {
  char head[512];
  std::string rid = request_id(c->dp, r);
  int n = snprintf(head, sizeof head,
                   "HTTP/1.1 %d %s\r\n"
                   "Content-Type: %s\r\n"
                   "Content-Length: %zu\r\n"
                   "X-Request-ID: %s\r\n"
                   "%s%s"
                   "\r\n",
                   code, reason, ctype, blen, rid.c_str(),
                   extra ? extra : "", r.conn_close ? "Connection: close\r\n" : "");
  if (n < 0 || n >= (int)sizeof head) return false;
  struct iovec iov[2] = {{head, (size_t)n}, {const_cast<void*>(body), blen}};
  int cnt = (blen && r.method != "HEAD") ? 2 : 1;
  struct msghdr mh{};
  mh.msg_iov = iov;
  mh.msg_iovlen = cnt;
  for (;;) {
    ssize_t sent = ::sendmsg(c->fd, &mh, MSG_NOSIGNAL);
    if (sent < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    size_t s = sent, want = 0;
    for (int i = 0; i < cnt; i++) want += iov[i].iov_len;
    if (s >= want) return true;
    // partial: advance
    for (int i = 0; i < cnt; i++) {
      if (s >= iov[i].iov_len) { s -= iov[i].iov_len; iov[i].iov_len = 0; }
      else { iov[i].iov_base = (char*)iov[i].iov_base + s; iov[i].iov_len -= s; s = 0; }
    }
  }
}

// ------------------------------------------------------------- forwarding
bool up_connect(Conn* c) {
  if (c->up_fd >= 0) return true;
  int fd = ::socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
  if (fd < 0) return false;
  struct sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_port = htons(c->dp->upstream_port);
  sa.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  if (::connect(fd, (struct sockaddr*)&sa, sizeof sa) != 0) {
    ::close(fd);
    return false;
  }
  set_sock_opts(fd);
  c->up_fd = fd;
  return true;
}

void up_close(Conn* c) {
  if (c->up_fd >= 0) ::close(c->up_fd);
  c->up_fd = -1;
}

// Forward a request to the Python server and relay the response back.
// ``head`` is the raw request head plus any body bytes to relay verbatim;
// ``body1`` is an optional already-read body buffer; ``socket_rem`` body
// bytes still stream from the client socket.  Returns false when the client
// connection must close.
bool forward_core(Conn* c, const Req& r, const char* head, size_t head_len,
                  const uint8_t* body1, size_t body1_len, int64_t socket_rem) {
  Dp* dp = c->dp;
  dp->stats[2].fetch_add(1, std::memory_order_relaxed);
  if (r.chunked) {
    // neither our clients nor the Python server speak chunked requests
    reply(c, r, 411, "Length Required", "text/plain", "length required", 15);
    return false;
  }

  // one reconnect attempt: the pooled upstream may have idled out
  bool consumed_socket = false;
  for (int attempt = 0; attempt < 2; attempt++) {
    if (!up_connect(c)) continue;
    if (!send_full(c->up_fd, head, head_len) ||
        (body1_len && !send_full(c->up_fd, body1, body1_len))) {
      up_close(c);
      if (consumed_socket) return false;
      continue;
    }
    // body beyond what we buffered streams socket->socket
    int64_t rem = socket_rem;
    char tmp[65536];
    bool fail = false;
    while (rem > 0) {
      ssize_t n = recv_some(c->fd, tmp, std::min<int64_t>(rem, sizeof tmp));
      if (n <= 0) return false;  // client died mid-body: nothing to salvage
      consumed_socket = true;
      if (!send_full(c->up_fd, tmp, n)) { fail = true; break; }
      rem -= n;
    }
    if (fail) {
      up_close(c);
      if (consumed_socket) return false;  // body partially consumed
      continue;
    }
    // ---- read + relay the upstream response
    std::string head;
    head.reserve(1024);
    size_t hdr_end = std::string::npos;
    for (;;) {
      size_t at = head.find("\r\n\r\n");
      if (at != std::string::npos) {
        // interim 1xx (the upstream's own Expect handshake): handle_conn
        // already sent the client a 100 — swallow it and keep reading,
        // or the 100 head would be relayed as the final response
        if (head.size() > 9 && head.rfind("HTTP/1.", 0) == 0 &&
            head[9] == '1') {
          head.erase(0, at + 4);
          continue;
        }
        hdr_end = at + 4;
        break;
      }
      if (head.size() >= kMaxHeaderBytes) break;
      ssize_t n = recv_some(c->up_fd, tmp, sizeof tmp);
      if (n <= 0) break;
      head.append(tmp, n);
    }
    size_t extra_start = hdr_end;
    if (hdr_end == std::string::npos) {
      up_close(c);
      if (attempt == 0 && !consumed_socket) continue;
      reply(c, r, 502, "Bad Gateway", "text/plain", "upstream failed", 15);
      return false;
    }
    // response content length
    int64_t resp_cl = -1;
    {
      // find a content-length line (case-insensitive)
      const char* h = head.c_str();
      size_t pos = 0;
      while (pos < hdr_end) {
        size_t le = head.find("\r\n", pos);
        if (le == std::string::npos || le > hdr_end) break;
        if (le - pos > 15 && strncasecmp(h + pos, "content-length:", 15) == 0)
          resp_cl = strtoll(h + pos + 15, nullptr, 10);
        pos = le + 2;
      }
    }
    if (!send_full(c->fd, head.data(), head.size())) return false;
    bool is_head = r.method == "HEAD";
    if (resp_cl >= 0 && !is_head) {
      int64_t resp_rem = resp_cl - (int64_t)(head.size() - extra_start);
      while (resp_rem > 0) {
        ssize_t n = recv_some(c->up_fd, tmp, std::min<int64_t>(resp_rem, sizeof tmp));
        if (n <= 0) return false;
        if (!send_full(c->fd, tmp, n)) return false;
        resp_rem -= n;
      }
      return !r.conn_close;
    }
    if (resp_cl < 0 && !is_head) {
      // no CL: relay until upstream closes, then close client too
      for (;;) {
        ssize_t n = recv_some(c->up_fd, tmp, sizeof tmp);
        if (n <= 0) break;
        if (!send_full(c->fd, tmp, n)) break;
      }
      up_close(c);
      return false;
    }
    return !r.conn_close;
  }
  reply(c, r, 502, "Bad Gateway", "text/plain", "upstream unreachable", 20);
  return false;
}

// Forward with the request head + partially-buffered body in buf[0..buf_len).
bool forward(Conn* c, const Req& r, const char* buf, size_t buf_len) {
  int64_t socket_rem = 0;
  // never ship pipelined bytes of the NEXT request upstream: cap what we
  // relay at head + this request's own buffered body
  size_t body_cap = r.has_content_length ? (size_t)r.content_length : 0;
  size_t send_len = r.header_len + std::min(buf_len - r.header_len, body_cap);
  if (r.has_content_length)
    socket_rem =
        r.content_length - (int64_t)(send_len - r.header_len);
  return forward_core(c, r, buf, send_len, nullptr, 0,
                      socket_rem > 0 ? socket_rem : 0);
}

// ------------------------------------------------------------- native GET
// Serve an in-memory needle record (cookie/id/CRC checks, gzip flag,
// Range) — shared by the normal-volume and EC read paths.  Returns true
// when a response was written; false => caller forwards to Python.
bool serve_record(Conn* c, const Req& r, std::vector<uint8_t>& rec,
                  int32_t size, int version, const Fid& f,
                  bool* keep_alive) {
  Dp* dp = c->dp;
  uint32_t cookie = be32(rec.data());
  uint64_t id = be64(rec.data() + 4);
  if (id != f.key) {
    dp->stats[6].fetch_add(1, std::memory_order_relaxed);
    *keep_alive = reply(c, r, 500, "Internal Server Error", "text/plain",
                        "id mismatch", 11) && !r.conn_close;
    return true;
  }
  if (cookie != f.cookie) {
    dp->stats[5].fetch_add(1, std::memory_order_relaxed);
    *keep_alive = reply(c, r, 404, "Not Found", "text/plain",
                        "cookie mismatch", 15) && !r.conn_close;
    return true;
  }
  // locate data within the body
  const uint8_t* data = rec.data() + kNeedleHeaderSize;
  int64_t data_len = size;
  uint8_t flags = 0;
  if (version >= 2) {
    if (size < 4) return false;  // malformed: let Python diagnose
    uint32_t ds = be32(rec.data() + kNeedleHeaderSize);
    if ((int64_t)ds + 4 > size) return false;
    data = rec.data() + kNeedleHeaderSize + 4;
    data_len = ds;
    if ((int64_t)ds + 4 < size) flags = rec[kNeedleHeaderSize + 4 + ds];
  }
  uint32_t stored_crc = be32(rec.data() + kNeedleHeaderSize + size);
  if (version >= 2 && data_len > 0 &&
      sw_crc32c(0, data, data_len) != stored_crc) {
    // forwarded, not answered here: the Python read path answers the same
    // 500 "crc mismatch" and also counts the corruption and flags the
    // needle for the scrubber's repair (the self-healing read path)
    dp->stats[6].fetch_add(1, std::memory_order_relaxed);
    return false;
  }
  const char* enc = nullptr;
  if (flags & kFlagCompressed) {
    if (!r.accept_gzip || !r.range.empty()) return false;  // needs decompress
    enc = "Content-Encoding: gzip\r\n";
  }
  // Range (single, RFC 7233; util/http_range.py semantics)
  int64_t lo = 0, hi = data_len - 1;
  bool ranged = false;
  if (!r.range.empty() && r.range.rfind("bytes=", 0) == 0) {
    std::string spec = r.range.substr(6);
    if (spec.find(',') == std::string::npos) {
      size_t dash = spec.find('-');
      if (dash != std::string::npos) {
        std::string lo_s = spec.substr(0, dash), hi_s = spec.substr(dash + 1);
        bool valid = true;
        for (char ch : lo_s) if (!isdigit((unsigned char)ch)) valid = false;
        for (char ch : hi_s) if (!isdigit((unsigned char)ch)) valid = false;
        if (valid) {
          if (lo_s.empty() && !hi_s.empty()) {
            int64_t suf = strtoll(hi_s.c_str(), nullptr, 10);
            if (suf <= 0 || data_len == 0) {
              char cr[64];
              snprintf(cr, sizeof cr, "Content-Range: bytes */%lld\r\n",
                       (long long)data_len);
              *keep_alive = reply(c, r, 416, "Range Not Satisfiable",
                                  "application/octet-stream", "", 0, cr) &&
                            !r.conn_close;
              return true;
            }
            lo = data_len - suf < 0 ? 0 : data_len - suf;
            ranged = true;
          } else if (!lo_s.empty()) {
            int64_t l = strtoll(lo_s.c_str(), nullptr, 10);
            int64_t h = hi_s.empty() ? data_len - 1
                                     : strtoll(hi_s.c_str(), nullptr, 10);
            if (!hi_s.empty() && h < l) {
              // syntactically invalid: serve full body (parse_range leniency)
            } else if (l >= data_len) {
              char cr[64];
              snprintf(cr, sizeof cr, "Content-Range: bytes */%lld\r\n",
                       (long long)data_len);
              *keep_alive = reply(c, r, 416, "Range Not Satisfiable",
                                  "application/octet-stream", "", 0, cr) &&
                            !r.conn_close;
              return true;
            } else {
              lo = l;
              hi = std::min(h, data_len - 1);
              ranged = true;
            }
          }
        }
      }
    }
  }
  dp->stats[0].fetch_add(1, std::memory_order_relaxed);
  char extra[160];
  extra[0] = 0;
  if (ranged) {
    snprintf(extra, sizeof extra, "%sContent-Range: bytes %lld-%lld/%lld\r\n",
             enc ? enc : "", (long long)lo, (long long)hi, (long long)data_len);
  } else if (enc) {
    snprintf(extra, sizeof extra, "%s", enc);
  }
  int64_t blen = ranged ? hi - lo + 1 : data_len;
  dp->stats[3].fetch_add(blen, std::memory_order_relaxed);
  *keep_alive = reply(c, r, ranged ? 206 : 200, ranged ? "Partial Content" : "OK",
                      "application/octet-stream", data + lo, blen,
                      extra[0] ? extra : nullptr) &&
                !r.conn_close;
  return true;
}

// Returns true when handled natively; false => caller forwards.
// (guards — empty query, no body, parsed fid — hoisted to handle_conn)
bool try_native_get(Conn* c, const Req& r, const Fid& f, bool* keep_alive) {
  Dp* dp = c->dp;
  auto vol = dp->find(f.vid);
  if (!vol) return false;  // EC volume / remote: try_native_ec_get next
  Entry e;
  {
    std::shared_lock lk(vol->map_mu);
    auto it = vol->map.find(f.key);
    if (it == vol->map.end()) {
      lk.unlock();
      dp->stats[5].fetch_add(1, std::memory_order_relaxed);
      *keep_alive = reply(c, r, 404, "Not Found", "text/plain", "not found", 9)
                    && !r.conn_close;
      return true;
    }
    e = it->second;
  }
  int64_t total = record_disk_size(e.size, vol->version);
  std::vector<uint8_t> rec(total);
  if (!pread_full(vol->dat_fd, rec.data(), total, e.off)) {
    dp->stats[6].fetch_add(1, std::memory_order_relaxed);
    *keep_alive = reply(c, r, 500, "Internal Server Error", "text/plain",
                        "read failed", 11) && !r.conn_close;
    return true;
  }
  return serve_record(c, r, rec, e.size, vol->version, f, keep_alive);
}

// --------------------------------------------------------- native EC GET
// One .ecx binary-search entry read.
bool ec_read_entry(EcVol* ev, int64_t index, uint64_t* key, int64_t* off,
                   int32_t* size) {
  uint8_t buf[17];
  if (!pread_full(ev->ecx_fd, buf, ev->entry_size,
                  index * ev->entry_size))
    return false;
  *key = be64(buf);
  uint64_t stored = be32(buf + 8);
  if (ev->offset_width == 5) stored |= (uint64_t)buf[12] << 32;
  *off = (int64_t)(stored * kPad);
  *size = (int32_t)be32(buf + 8 + ev->offset_width);
  return true;
}

// Striped interval read of the .dat byte range [off, off+total) out of
// the LOCAL shard files (ec_locate.py locate_data + to_shard_and_offset
// geometry: n_large_rows rows of k large blocks, then small-block rows).
// False when a needed shard is not local (caller forwards — the Python
// path does remote fetch / TPU reconstruction).
bool ec_read_record(EcVol* ev, int64_t off, int64_t total, uint8_t* out) {
  const int64_t large = ev->large_block, small = ev->small_block;
  const int k = ev->k;
  const int64_t large_row = large * k;
  const int64_t n_large = (ev->locate_shard_size - 1) / large;
  bool is_large;
  int64_t block_index, inner;
  if (off < n_large * large_row) {
    is_large = true;
    block_index = off / large;
    inner = off % large;
  } else {
    is_large = false;
    int64_t rel = off - n_large * large_row;
    block_index = rel / small;
    inner = rel % small;
  }
  int64_t remaining = total;
  uint8_t* w = out;
  // the shared lock spans the preads: a concurrent shard detach takes
  // the unique lock and close()s the old fd only after every in-flight
  // reader drains — otherwise the kernel could recycle the fd number
  // under a reader mid-pread (readers never block each other)
  std::shared_lock lk(ev->shard_mu);
  while (remaining > 0) {
    int64_t blk = is_large ? large : small;
    int64_t take = std::min(remaining, blk - inner);
    int64_t row = block_index / k;
    int sid = (int)(block_index % k);
    int64_t shard_off =
        inner + (is_large ? row * large : n_large * large + row * small);
    int fd = ev->shard_fds[sid];
    if (fd < 0 || !pread_full(fd, w, take, shard_off)) return false;
    w += take;
    remaining -= take;
    if (remaining <= 0) break;
    block_index++;
    if (is_large && block_index == n_large * k) {
      is_large = false;
      block_index = 0;
    }
    inner = 0;
  }
  return true;
}

// Serve a needle from a mounted EC volume's local shards (the Python
// EcVolume.read_needle hot path: .ecx bisect + interval reads).
// Returns true when handled; false => forward (missing shard, absent
// volume, or anything this loop doesn't model).
bool try_native_ec_get(Conn* c, const Req& r, const Fid& f,
                       bool* keep_alive) {
  Dp* dp = c->dp;
  auto ev = dp->find_ec(f.vid);
  if (!ev) return false;
  // binary search the sorted .ecx
  int64_t lo = 0, hi = ev->ecx_entries;
  int64_t found = -1, off = 0;
  int32_t size = 0;
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    uint64_t key;
    if (!ec_read_entry(ev.get(), mid, &key, &off, &size)) return false;
    if (key == f.key) {
      found = mid;
      break;
    }
    if (key < f.key)
      lo = mid + 1;
    else
      hi = mid;
  }
  if (found < 0 || size < 0) {  // absent or tombstoned (deleted)
    dp->stats[5].fetch_add(1, std::memory_order_relaxed);
    *keep_alive = reply(c, r, 404, "Not Found", "text/plain", "not found", 9)
                  && !r.conn_close;
    return true;
  }
  int64_t total = record_disk_size(size, ev->version);
  std::vector<uint8_t> rec(total);
  if (!ec_read_record(ev.get(), off, total, rec.data()))
    return false;  // shard not local / IO issue: Python reconstructs
  return serve_record(c, r, rec, size, ev->version, f, keep_alive);
}

// ------------------------------------------------------ replica fan-out
// Write-all to the other holders' NATIVE planes over persistent
// per-connection peer sockets (the Python path's pooled fan-out,
// topology/store_replicate.go:27, without the interpreter).

int peer_connect(Conn* c, const std::string& addr) {
  auto it = c->peer_fds.find(addr);
  if (it != c->peer_fds.end() && it->second >= 0) return it->second;
  size_t colon = addr.rfind(':');
  if (colon == std::string::npos) return -1;
  int fd = ::socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
  if (fd < 0) return -1;
  struct sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_port = htons((uint16_t)atoi(addr.c_str() + colon + 1));
  if (inet_pton(AF_INET, addr.substr(0, colon).c_str(), &sa.sin_addr) != 1 ||
      ::connect(fd, (struct sockaddr*)&sa, sizeof sa) != 0) {
    ::close(fd);
    return -1;
  }
  set_sock_opts(fd);
  c->peer_fds[addr] = fd;
  return fd;
}

void peer_close(Conn* c, const std::string& addr) {
  auto it = c->peer_fds.find(addr);
  if (it != c->peer_fds.end()) {
    if (it->second >= 0) ::close(it->second);
    c->peer_fds.erase(it);
  }
}

// Send one replicate request head+body on an already-connected peer fd.
bool replicate_send(int fd, const std::string& addr, const char* method,
                    const std::string& target, const uint8_t* body,
                    size_t blen) {
  char head[512];
  int n = snprintf(head, sizeof head,
                   "%s %s?type=replicate HTTP/1.1\r\n"
                   "Host: %s\r\nContent-Length: %zu\r\n\r\n",
                   method, target.c_str(), addr.c_str(), blen);
  if (n < 0 || n >= (int)sizeof head) return false;
  return send_full(fd, head, n) && (!blen || send_full(fd, body, blen));
}

// Read + fully drain one response off a peer fd.  Returns:
//   1  peer answered 2xx
//   0  peer answered non-2xx (a real rejection — do not retry)
//  -1  connection-level failure (stale keep-alive / reset — retriable)
int replicate_recv(Conn* c, const std::string& addr) {
  auto it = c->peer_fds.find(addr);
  if (it == c->peer_fds.end() || it->second < 0) return -1;
  int fd = it->second;
  char buf[4096];
  std::string resp;
  size_t hdr_end = std::string::npos;
  while (resp.size() < kMaxHeaderBytes) {
    ssize_t got = recv_some(fd, buf, sizeof buf);
    if (got <= 0) break;
    resp.append(buf, got);
    size_t at = resp.find("\r\n\r\n");
    if (at != std::string::npos) {
      hdr_end = at + 4;
      break;
    }
  }
  if (hdr_end == std::string::npos) {
    peer_close(c, addr);
    return -1;
  }
  int64_t cl = 0;
  {
    size_t pos = 0;
    while (pos < hdr_end) {
      size_t le = resp.find("\r\n", pos);
      if (le == std::string::npos || le > hdr_end) break;
      if (le - pos > 15 &&
          strncasecmp(resp.c_str() + pos, "content-length:", 15) == 0)
        cl = strtoll(resp.c_str() + pos + 15, nullptr, 10);
      pos = le + 2;
    }
  }
  int64_t rem = cl - (int64_t)(resp.size() - hdr_end);
  while (rem > 0) {
    ssize_t got = recv_some(fd, buf, std::min<int64_t>(rem, sizeof buf));
    if (got <= 0) {
      peer_close(c, addr);
      return -1;
    }
    rem -= got;
  }
  return (resp.size() > 9 && resp[9] == '2') ? 1 : 0;
}

// Write-all fan-out to every replica holder, pipelined: all request bodies
// go out before any response is read, so the peers append concurrently
// (the Python path's thread-pool fan-out without threads — each peer's
// latency overlaps on its own keep-alive socket).  A connection-level
// failure retries once on a fresh connection; a 4xx/5xx is final.
// Returns nullptr on success or the first failing peer's address.
const std::string* fanout_replicate(Conn* c,
                                    const std::vector<std::string>& reps,
                                    const char* method,
                                    const std::string& target,
                                    const uint8_t* body, size_t blen) {
  std::vector<int8_t> state(reps.size(), 0);  // 0=inflight -1=retry 1=ok
  for (size_t i = 0; i < reps.size(); i++) {
    int fd = peer_connect(c, reps[i]);
    if (fd < 0 || !replicate_send(fd, reps[i], method, target, body, blen)) {
      peer_close(c, reps[i]);
      state[i] = -1;
    }
  }
  for (size_t i = 0; i < reps.size(); i++) {
    if (state[i] != 0) continue;
    int rc = replicate_recv(c, reps[i]);
    if (rc == 0) {
      // a real rejection ends the fan-out — but peers j>i still have an
      // unread pipelined response in flight; leaving those sockets in
      // the pool would desynchronize every later request/response pair
      // (a failed write could read a stale 201 as its ack)
      for (size_t j = i + 1; j < reps.size(); j++)
        if (state[j] == 0) peer_close(c, reps[j]);
      return &reps[i];
    }
    state[i] = (int8_t)rc;
  }
  for (size_t i = 0; i < reps.size(); i++) {  // sequential second chance
    if (state[i] != -1) continue;
    int fd = peer_connect(c, reps[i]);
    if (fd < 0 || !replicate_send(fd, reps[i], method, target, body, blen) ||
        replicate_recv(c, reps[i]) != 1)
      return &reps[i];  // remaining retry peers have no request in flight
  }
  return nullptr;
}

// A non-replicate write/delete on ``vol`` may run natively iff it is
// single-copy or the replica fan-out addresses are known (shared gate of
// the POST and DELETE routing branches).
bool fanout_ready(Vol* vol, bool is_replicate) {
  if (is_replicate) return true;
  if (vol->copy_count.load(std::memory_order_relaxed) <= 1) return true;
  std::shared_lock lk(vol->rep_mu);
  return !vol->replicas.empty();
}

// ------------------------------------------------------- guarded appends
// The ONE implementation of the append invariants shared by native POST,
// native DELETE, and the Python-side sw_dp_append: closed fence, 8-byte
// alignment, monotonic append clock, .dat+.idx both landing before `end`
// advances, map update and event push under the same lock.
//
// map_size >= 0 installs/overwrites the key (size-0 put: indexed, not
// servable); map_size < 0 is a tombstone.  stamp_ts: compute a fresh
// timestamp and write it into the v3 record (callers building records
// natively); otherwise the record carries its own and only bumps the
// clock.  skip_if_absent: tombstones for missing keys become no-ops
// (delete_needle semantics) instead of appending dead bytes.
//
// Returns the append offset; -1 closed/unavailable; -2 IO failure or
// misaligned end (partial bytes may sit past end — only this appender's
// end-tracking overwrites them); -3 skipped (absent key no-op).
int64_t locked_append(Dp* dp, Vol* vol, uint64_t key, int32_t map_size,
                      uint8_t* record, size_t len, bool stamp_ts,
                      bool emit_event) {
  std::lock_guard lk(vol->append_mu);
  if (vol->closed) return -1;
  if (vol->end % kPad) return -2;
  int64_t old_size = -1;
  size_t ts_at = kNeedleHeaderSize + (map_size > 0 ? map_size : 0) +
                 kChecksumSize;
  {
    std::unique_lock mlk(vol->map_mu);
    auto it = vol->map.find(key);
    if (it != vol->map.end()) old_size = it->second.size;
  }
  if (map_size < 0 && old_size < 0)
    return -3;  // deleting a key we don't have: Python replies 202 no-op
  uint64_t ns = 0;
  if (stamp_ts) {
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    ns = (uint64_t)ts.tv_sec * 1000000000ull + ts.tv_nsec;
    if (ns <= vol->last_ns) ns = vol->last_ns + 1;
    vol->last_ns = ns;
    if (vol->version == 3 && len >= ts_at + 8) put_be64(record + ts_at, ns);
  } else if (vol->version == 3 && map_size > 0 && len >= ts_at + 8) {
    ns = be64(record + ts_at);
    if (ns > vol->last_ns) vol->last_ns = ns;
  }
  int64_t off = vol->end;
  // .idx entry: key(8BE) + stored offset (4BE of the low 32 bits, then
  // the high byte at width 5 — types.py offset_to_bytes) + size(4BE)
  uint8_t ie[17];
  size_t ie_len = 8 + vol->offset_width + 4;
  put_be64(ie, key);
  uint64_t stored = map_size >= 0 ? (uint64_t)(off / kPad) : 0;
  put_be32(ie + 8, (uint32_t)(stored & 0xFFFFFFFF));
  if (vol->offset_width == 5) ie[12] = (uint8_t)(stored >> 32);
  put_be32(ie + 8 + vol->offset_width,
           map_size >= 0 ? (uint32_t)map_size : (uint32_t)-1);
  if (!pwrite_full(vol->dat_fd, record, len, off) ||
      !write_full(vol->idx_fd, ie, ie_len))
    return -2;  // end unchanged: the partial bytes get overwritten
  vol->end += (int64_t)len;
  {
    std::unique_lock mlk(vol->map_mu);
    if (map_size > 0)
      vol->map[key] = Entry{off, map_size};
    else
      vol->map.erase(key);
  }
  if (emit_event)
    dp->push_event(Event{vol->vid, map_size < 0 ? -1 : map_size, key,
                         (uint64_t)off, ns, old_size});
  return off;
}

// ------------------------------------------------------------ native POST
// Append the needle natively.  Caller has validated routing conditions.
// Returns whether the connection stays alive.
bool native_post(Conn* c, const Req& r, std::shared_ptr<Vol> vol, const Fid& f,
                 bool compressed_marker, bool is_replicate, const char* buf,
                 size_t buf_len) {
  Dp* dp = c->dp;
  int64_t clen = r.content_length;
  dp->upload_inflight.fetch_add(clen, std::memory_order_relaxed);
  struct Sub {  // release the budget on every exit path
    Dp* dp;
    int64_t n;
    ~Sub() { dp->upload_inflight.fetch_sub(n, std::memory_order_relaxed); }
  } sub{dp, clen};
  // build the v2/v3 record in place: header + data_size + data + flags +
  // last_modified(5BE) + crc + [ts] + pad (needle.py to_bytes).  The body
  // is received STRAIGHT into its slot in the record buffer — the old
  // stage-then-memcpy cost a full extra pass over every uploaded byte,
  // which at multi-hundred-MB/s on one core was real throughput.
  int version = vol->version;
  uint8_t flags = kFlagHasLastModified | (compressed_marker ? kFlagCompressed : 0);
  int32_t size_field = clen ? (int32_t)(4 + clen + 1 + 5) : 0;
  int64_t total = record_disk_size(size_field, version);
  std::vector<uint8_t> rec(total, 0);
  uint8_t* p = rec.data();
  uint8_t* body_at = p + kNeedleHeaderSize + (clen ? 4 : 0);
  size_t have = buf_len - r.header_len;
  if ((int64_t)have > clen) have = clen;
  memcpy(body_at, buf + r.header_len, have);
  int64_t rem = clen - have;
  uint8_t* w = body_at + have;
  while (rem > 0) {
    ssize_t n = recv_some(c->fd, w, rem);
    if (n <= 0) return false;
    w += n; rem -= n;
  }
  put_be32(p, f.cookie);
  put_be64(p + 4, f.key);
  put_be32(p + 12, (uint32_t)size_field);
  uint32_t crc = sw_crc32c(0, body_at, (size_t)clen);
  size_t pos = kNeedleHeaderSize;
  if (clen) {
    put_be32(p + pos, (uint32_t)clen);
    pos += 4 + clen;
    p[pos++] = flags;
    uint64_t now_s = (uint64_t)time(nullptr);
    p[pos++] = (now_s >> 32) & 0xFF;
    p[pos++] = (now_s >> 24) & 0xFF;
    p[pos++] = (now_s >> 16) & 0xFF;
    p[pos++] = (now_s >> 8) & 0xFF;
    p[pos++] = now_s & 0xFF;
  }
  put_be32(p + pos, crc);
  pos += 4;
  // one shared guarded append (locked_append); error replies go out after
  // the lock is released so a slow client never blocks other writers.
  // A full volume is checked here (the only native path that grows data);
  // the 500 is sent only once append_mu is dropped — a slow client
  // draining it must never stall the volume's other writers (N004).
  bool vol_full;
  {
    std::lock_guard lk(vol->append_mu);
    vol_full = !vol->closed && vol->end >= max_volume_size(vol->offset_width);
  }
  if (vol_full) {
    return reply(c, r, 500, "Internal Server Error", "text/plain",
                 "volume exceeded max size", 24) &&
           !r.conn_close;
  }
  int64_t off = locked_append(dp, vol.get(), f.key, size_field, rec.data(),
                              total, /*stamp_ts=*/true, /*emit_event=*/true);
  if (off == -1)  // unregistered mid-request (vacuum): hand the buffered
                  // body to the Python server instead
    return forward_core(c, r, buf, r.header_len, body_at, (size_t)clen, 0);
  if (off < 0) {
    dp->stats[6].fetch_add(1, std::memory_order_relaxed);
    return reply(c, r, 500, "Internal Server Error", "text/plain",
                 "write failed", 12) &&
           !r.conn_close;
  }
  // primary on a replicated volume: write-all fan-out to the peer
  // native planes before acking (store_replicate.go ReplicatedWrite)
  int copies = vol->copy_count.load(std::memory_order_relaxed);
  if (!is_replicate && copies > 1) {
    std::vector<std::string> reps;
    {
      std::shared_lock lk(vol->rep_mu);
      reps = vol->replicas;
    }
    const char* err = nullptr;
    std::string msg;
    if ((int)reps.size() < copies - 1) {
      // failing loudly beats a 201 with missing copies (write-all)
      msg = "replication short: " + std::to_string(reps.size()) +
            " replica holders known";
      err = msg.c_str();
    } else if (const std::string* bad = fanout_replicate(
                   c, reps, "POST", r.target, body_at, (size_t)clen)) {
      msg = "replica " + *bad + " write failed";
      err = msg.c_str();
    }
    if (err) {
      dp->stats[6].fetch_add(1, std::memory_order_relaxed);
      return reply(c, r, 500, "Internal Server Error", "text/plain", err,
                   strlen(err)) &&
             !r.conn_close;
    }
  }
  dp->stats[1].fetch_add(1, std::memory_order_relaxed);
  dp->stats[4].fetch_add(clen, std::memory_order_relaxed);
  char bodybuf[48];
  int blen = snprintf(bodybuf, sizeof bodybuf, "{\"size\": %d}", size_field);
  return reply(c, r, 201, "Created", "application/json", bodybuf, blen) &&
         !r.conn_close;
}

// ----------------------------------------------------------- native DELETE
// Append a tombstone for the needle (volume.py delete_needle semantics:
// absent keys are a 202 no-op, never an error).  Returns keep-alive.
bool native_delete(Conn* c, const Req& r, std::shared_ptr<Vol> vol,
                   const Fid& f, bool is_replicate, const char* buf,
                   size_t buf_len) {
  Dp* dp = c->dp;
  // tombstone record: header(cookie=0, id, size=0) + crc(0) [+ ts] + pad;
  // locked_append stamps the v3 timestamp and skips absent keys (a racing
  // duplicate DELETE must not append a second tombstone)
  int64_t total = record_disk_size(0, vol->version);
  std::vector<uint8_t> rec(total, 0);
  put_be64(rec.data() + 4, f.key);
  int64_t off = locked_append(dp, vol.get(), f.key, -1, rec.data(), total,
                              /*stamp_ts=*/true, /*emit_event=*/true);
  if (off == -1)  // unregistered mid-request (vacuum)
    return forward(c, r, buf, buf_len);
  if (off == -2) {
    dp->stats[6].fetch_add(1, std::memory_order_relaxed);
    return reply(c, r, 500, "Internal Server Error", "text/plain",
                 "write failed", 12) &&
           !r.conn_close;
  }
  // off >= 0 (tombstoned) or -3 (absent no-op); a primary tombstone fans
  // out either way — a replica may hold a copy this holder never saw.
  // Best-effort like the Python handler (its replicate() return is
  // dropped for deletes): an unreachable replica never fails the 202.
  if (!is_replicate &&
      vol->copy_count.load(std::memory_order_relaxed) > 1) {
    std::vector<std::string> reps;
    {
      std::shared_lock lk(vol->rep_mu);
      reps = vol->replicas;
    }
    fanout_replicate(c, reps, "DELETE", r.target, nullptr, 0);
  }
  dp->stats[1].fetch_add(1, std::memory_order_relaxed);
  return reply(c, r, 202, "Accepted", "application/json", "{}", 2) &&
         !r.conn_close;
}

// ------------------------------------------------------- gateway splice (px)
// The S3/filer gateway's data verbs without CPython body copies: Python
// keeps auth, entry lookup and range math, then hands this section a
// client socket + volume address + fid path + byte range.  sw_px_get
// relays the chunk body volume->client (and sw_px_put client->volume,
// MD5'd on the fly for the ETag) over a process-global pool of
// keep-alive upstream connections.  Distinct from the Dp listener above: these calls run on the
// *gateway* process's request threads, not the volume server's loop.

// px-abi-begin: splice ABI, mirrored in native/dataplane.py (tests/test_torch_dataplane.py
// holds every `// py:` marker against it)
constexpr int64_t kPxNoSend = -1;       // py: _PX_NO_SEND
constexpr int64_t kPxBadUpstream = -2;  // py: _PX_BAD_UPSTREAM
constexpr int64_t kPxClientGone = -3;   // py: _PX_CLIENT_GONE
constexpr int64_t kPxMidStream = -4;    // py: _PX_MID_STREAM
// fan-out only: the client body was fully consumed AND retained in the
// caller's buffer — a peer failed mid-fan-out, the write is NOT acked, and
// Python replays the retained bytes through its own replication ladder
constexpr int64_t kPxRetained = -5;     // py: _PX_RETAINED
// fan-out with deferred acks: the body is streamed and retained, the peer
// sockets are handed back to the caller — the NEXT chunk streams while
// these acks ride the wire; sw_px_fanout_collect settles them
constexpr int64_t kPxAcksDeferred = -6; // py: _PX_ACKS_DEFERRED
constexpr int kPxStatsSlots = 20;       // py: _PX_STATS_SLOTS
constexpr int kPxMaxReplicas = 8;       // py: _PX_MAX_REPLICAS
// px loop modes (sw_px_loop_mode): which readiness engine drives the
// body relays — 0 = none (per-call blocking relay on the handler thread)
constexpr int kPxLoopOff = 0;           // py: _PX_LOOP_OFF
constexpr int kPxLoopEpoll = 1;         // py: _PX_LOOP_EPOLL
constexpr int kPxLoopUring = 2;         // py: _PX_LOOP_URING
// px-abi-end
constexpr size_t kPxBufSize = 256 * 1024;
constexpr size_t kPxMaxIdlePerHost = 8;
// how long a slow client may stall the relay before it counts as gone —
// matches the gateway's own per-connection timeout order of magnitude
constexpr int kPxClientStallMs = 30000;
// upstream connect/recv bound for the gateway splice: failover across
// replicas must match the ~10s the Python pool path fails over in, not
// the volume plane's 120s kSockTimeoutSec (a blackholed holder would
// otherwise pin a handler thread for minutes per replica)
constexpr int kPxUpstreamTimeoutSec = 10;

// The gateway's client fd is NOT px's socket: Python owns it, and a
// CPython socket with a timeout set runs in non-blocking mode, so
// send/recv/splice against it return EAGAIN whenever the socket buffer
// fills (a 10MB body trips this on every GET — the buffer holds ~1.5MB).
// EAGAIN from the client fd means "slow", not "gone": poll through it
// with a stall deadline.  Upstream sockets stay on the plain blocking
// send_full/recv_some so their SO_RCVTIMEO keeps bounding dead-holder
// detection.
bool px_wait_fd(int fd, short ev) {
  struct pollfd p{fd, ev, 0};
  for (;;) {
    int r = poll(&p, 1, kPxClientStallMs);
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) return false;  // stall deadline or poll error
    return (p.revents & (POLLERR | POLLNVAL)) == 0;
  }
}

bool px_send_client(int fd, const void* p, size_t len) {
  const uint8_t* buf = (const uint8_t*)p;
  while (len) {
    ssize_t n = ::send(fd, buf, len, MSG_NOSIGNAL);
    if (n < 0) {
      if (errno == EINTR) continue;
      if ((errno == EAGAIN || errno == EWOULDBLOCK) &&
          px_wait_fd(fd, POLLOUT))
        continue;
      return false;
    }
    buf += n;
    len -= n;
  }
  return true;
}

// recv from the client fd; 0 on orderly close, -1 on error/stall.
ssize_t px_recv_client(int fd, void* buf, size_t len) {
  for (;;) {
    ssize_t n = ::recv(fd, buf, len, 0);
    if (n >= 0) return n;
    if (errno == EINTR) continue;
    if ((errno == EAGAIN || errno == EWOULDBLOCK) && px_wait_fd(fd, POLLIN))
      continue;
    return -1;
  }
}

// ---- MD5 (RFC 1321) — the PUT splice computes the S3 ETag in-stream so
// the body never has to surface into CPython for hashing.
struct Md5 {
  uint32_t a = 0x67452301, b = 0xefcdab89, c = 0x98badcfe, d = 0x10325476;
  uint64_t total = 0;
  uint8_t tail[64];
  size_t tail_len = 0;

  static uint32_t rol(uint32_t x, int s) { return (x << s) | (x >> (32 - s)); }

  void block(const uint8_t* p) {
    static const uint32_t K[64] = {
        0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf,
        0x4787c62a, 0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af,
        0xffff5bb1, 0x895cd7be, 0x6b901122, 0xfd987193, 0xa679438e,
        0x49b40821, 0xf61e2562, 0xc040b340, 0x265e5a51, 0xe9b6c7aa,
        0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8, 0x21e1cde6,
        0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
        0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122,
        0xfde5380c, 0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70,
        0x289b7ec6, 0xeaa127fa, 0xd4ef3085, 0x04881d05, 0xd9d4d039,
        0xe6db99e5, 0x1fa27cf8, 0xc4ac5665, 0xf4292244, 0x432aff97,
        0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92, 0xffeff47d,
        0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
        0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};
    static const int S[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
                              7, 12, 17, 22, 5, 9,  14, 20, 5, 9,  14, 20,
                              5, 9,  14, 20, 5, 9,  14, 20, 4, 11, 16, 23,
                              4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                              6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21,
                              6, 10, 15, 21};
    uint32_t m[16];
    for (int i = 0; i < 16; i++)
      m[i] = (uint32_t)p[i * 4] | ((uint32_t)p[i * 4 + 1] << 8) |
             ((uint32_t)p[i * 4 + 2] << 16) | ((uint32_t)p[i * 4 + 3] << 24);
    uint32_t A = a, B = b, C = c, D = d;
    for (int i = 0; i < 64; i++) {
      uint32_t f;
      int g;
      if (i < 16) {
        f = (B & C) | (~B & D);
        g = i;
      } else if (i < 32) {
        f = (D & B) | (~D & C);
        g = (5 * i + 1) % 16;
      } else if (i < 48) {
        f = B ^ C ^ D;
        g = (3 * i + 5) % 16;
      } else {
        f = C ^ (B | ~D);
        g = (7 * i) % 16;
      }
      uint32_t tmp = D;
      D = C;
      C = B;
      B = B + rol(A + f + K[i] + m[g], S[i]);
      A = tmp;
    }
    a += A; b += B; c += C; d += D;
  }

  void update(const uint8_t* p, size_t len) {
    total += len;
    if (tail_len) {
      size_t take = std::min(len, 64 - tail_len);
      memcpy(tail + tail_len, p, take);
      tail_len += take;
      p += take;
      len -= take;
      if (tail_len < 64) return;
      block(tail);
      tail_len = 0;
    }
    while (len >= 64) {
      block(p);
      p += 64;
      len -= 64;
    }
    if (len) {
      memcpy(tail, p, len);
      tail_len = len;
    }
  }

  void final(uint8_t out[16]) {
    uint64_t bits = total * 8;
    uint8_t pad[72];
    size_t pad_len = (tail_len < 56) ? 56 - tail_len : 120 - tail_len;
    memset(pad, 0, sizeof pad);
    pad[0] = 0x80;
    update(pad, pad_len);
    total -= pad_len;  // length padding isn't message bytes
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = (uint8_t)(bits >> (8 * i));
    update(lenb, 8);
    uint32_t h[4] = {a, b, c, d};
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) out[i * 4 + j] = (uint8_t)(h[i] >> (8 * j));
  }
};

// Portable MD5 midstate: lets Python carry one object-wide digest across
// the per-chunk fan-out calls of a multi-chunk PUT (the S3 ETag is the md5
// of the WHOLE body; chunk digests cannot be composed after the fact).
// Little-endian memcpy of the host state — pinned against the Python
// mirror by nativelint N005.
struct Md5State {
  uint32_t a;
  uint32_t b;
  uint32_t c;
  uint32_t d;
  uint64_t total;
  uint8_t tail[64];
  uint32_t tail_len;
  uint32_t _pad0;
};
static_assert(sizeof(Md5State) == 96, "md5 midstate wire size");  // py: _MD5_STATE

Md5 md5_from_state(const uint8_t* st) {
  Md5 m;
  if (st == nullptr) return m;
  Md5State s;
  memcpy(&s, st, sizeof s);
  if (s.total == 0)
    return m;  // zero bytes hashed so far (incl. an all-zero fresh buffer)
  m.a = s.a; m.b = s.b; m.c = s.c; m.d = s.d;
  m.total = s.total;
  if (s.tail_len > 63) s.tail_len = 63;  // corrupt state must not overrun
  memcpy(m.tail, s.tail, sizeof m.tail);
  m.tail_len = s.tail_len;
  return m;
}

void md5_to_state(const Md5& m, uint8_t* st) {
  if (st == nullptr) return;
  Md5State s{};
  s.a = m.a; s.b = m.b; s.c = m.c; s.d = m.d;
  s.total = m.total;
  memcpy(s.tail, m.tail, sizeof s.tail);
  s.tail_len = (uint32_t)m.tail_len;
  memcpy(st, &s, sizeof s);
}

// ---- process-global upstream connection pool (keyed by "ip:port").
// Gateway request threads check connections out per splice; stale
// keep-alives surface as an immediate send/recv failure and retry once
// on a fresh connect, the same policy as util/http_pool.py.
std::mutex px_mu;
std::unordered_map<std::string, std::vector<int>> px_idle;
std::atomic<uint64_t> px_stats[kPxStatsSlots]{};
// slots: 0 get_ok, 1 get_bytes, 2 get_midstream, 3 get_fallback,
//        4-6 legacy single-upstream PUT verb (retired — the
//        fan-out path reports via 8+; kept zeroed for mirror/record
//        stability), 7 conns_opened,
//        8 fanout_ok, 9 fanout_bytes, 10 fanout_fail,
//        11 fanout_replica_acks, 12 fanout_ack_wait_ns,
//        13 loop_get_jobs, 14 loop_put_jobs, 15 loop_arm_fail,
//        16 cache_send_ok, 17 cache_send_bytes, 18 cache_send_fail,
//        19 loop_cache_jobs

int px_connect(const char* addr, bool* reused) {
  {
    std::lock_guard lk(px_mu);
    auto it = px_idle.find(addr);
    while (it != px_idle.end() && !it->second.empty()) {
      int fd = it->second.back();
      it->second.pop_back();
      // a healthy idle keep-alive has nothing pending; readable/HUP/ERR
      // means the peer closed it while pooled.  Catching that here —
      // before any request bytes go out — matters most for the PUT
      // splice, where a stale socket that swallows the first sends
      // fails only after client body bytes are consumed and thus
      // unreplayable (kernel send buffering defeats the reused-retry).
      struct pollfd pfd{fd, POLLIN, 0};
      if (::poll(&pfd, 1, 0) == 0) {
        *reused = true;
        return fd;
      }
      ::close(fd);
    }
  }
  *reused = false;
  const char* colon = strrchr(addr, ':');
  if (!colon) return -1;
  std::string host(addr, colon - addr);
  int fd = ::socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
  if (fd < 0) return -1;
  // SO_SNDTIMEO before connect: Linux bounds a blocking connect() by the
  // send timeout, so a blackholed volume host costs the px bound, not
  // the ~2min kernel SYN-retry window with a handler thread pinned
  struct timeval tv{kPxUpstreamTimeoutSec, 0};
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
  struct sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_port = htons((uint16_t)atoi(colon + 1));
  if (inet_pton(AF_INET, host.c_str(), &sa.sin_addr) != 1 ||
      ::connect(fd, (struct sockaddr*)&sa, sizeof sa) != 0) {
    ::close(fd);
    return -1;
  }
  set_sock_opts(fd);
  // override set_sock_opts' volume-plane 120s with the px failover bound
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
  px_stats[7].fetch_add(1, std::memory_order_relaxed);
  return fd;
}

void px_checkin(const char* addr, int fd) {
  std::lock_guard lk(px_mu);
  auto& v = px_idle[addr];
  if (v.size() < kPxMaxIdlePerHost) {
    v.push_back(fd);
    return;
  }
  ::close(fd);
}

// Read an upstream response head into ``head``; returns the offset one
// past CRLFCRLF or npos.  Leading 1xx interim responses are swallowed.
size_t px_read_head(int fd, std::string& head) {
  char tmp[8192];
  for (;;) {
    size_t at = head.find("\r\n\r\n");
    if (at != std::string::npos) {
      if (head.size() > 9 && head.rfind("HTTP/1.", 0) == 0 && head[9] == '1') {
        head.erase(0, at + 4);
        continue;
      }
      return at + 4;
    }
    if (head.size() >= kMaxHeaderBytes) return std::string::npos;
    ssize_t n = recv_some(fd, tmp, sizeof tmp);
    if (n <= 0) return std::string::npos;
    head.append(tmp, n);
  }
}

int px_head_status(const std::string& head) {
  if (head.size() < 12 || head.rfind("HTTP/1.", 0) != 0) return -1;
  return atoi(head.c_str() + 9);
}

int64_t px_head_content_length(const std::string& head, size_t hdr_end) {
  size_t pos = 0;
  int64_t cl = -1;
  while (pos < hdr_end) {
    size_t le = head.find("\r\n", pos);
    if (le == std::string::npos || le > hdr_end) break;
    if (le - pos > 15 &&
        strncasecmp(head.c_str() + pos, "content-length:", 15) == 0)
      cl = strtoll(head.c_str() + pos + 15, nullptr, 10);
    pos = le + 2;
  }
  return cl;
}

// Relay ``want`` upstream body bytes to the client through a pipe with
// splice(2): the bytes move socket->pipe->socket inside the kernel and
// never enter userspace — the actual zero-copy half of the GET splice
// (the recv/send loop below is the fallback for kernels/fd types where
// splice is refused).  Returns:
//   0  full relay (*relayed == want)
//   1  upstream died mid-body (*relayed = bytes delivered to the client)
//   2  client write failed
//   3  splice unsupported, nothing moved (caller uses the copy loop)

// SEAWEEDFS_TPU_PX_KSPLICE=0 forces the userspace copy loop everywhere
// (A/B attribution + parity tests for the fallback path); checked once.
bool px_ksplice_enabled() {
  static const bool enabled = [] {
    const char* v = getenv("SEAWEEDFS_TPU_PX_KSPLICE");
    return v == nullptr || strcmp(v, "0") != 0;
  }();
  return enabled;
}

int px_splice_body(int up, int client_fd, int64_t want, int64_t* relayed) {
  *relayed = 0;
  if (!px_ksplice_enabled()) return 3;
  int pipefd[2];
  if (pipe2(pipefd, O_CLOEXEC) != 0) return 3;
  (void)fcntl(pipefd[1], F_SETPIPE_SZ, 1 << 20);  // best effort
  int rc = 0;
  int64_t sent = 0;
  while (sent < want) {
    ssize_t n = splice(up, nullptr, pipefd[1], nullptr,
                       (size_t)std::min<int64_t>(want - sent, 1 << 20),
                       SPLICE_F_MOVE | SPLICE_F_MORE);
    if (n < 0 && errno == EINTR) continue;
    if (n < 0 && (errno == EINVAL || errno == ENOSYS) && sent == 0) {
      rc = 3;  // fd type without splice support: copy loop takes over
      break;
    }
    if (n <= 0) {
      rc = 1;  // EOF / error / RCVTIMEO: same contract as recv_some
      break;
    }
    int64_t inpipe = n;
    while (inpipe > 0) {
      // SPLICE_F_MORE only while more body follows: corking the final
      // piece stalls the response until the kernel gives up (~200ms)
      unsigned out_flags = SPLICE_F_MOVE;
      if (sent + inpipe < want) out_flags |= SPLICE_F_MORE;
      ssize_t m = splice(pipefd[0], nullptr, client_fd, nullptr,
                         (size_t)inpipe, out_flags);
      if (m < 0 && errno == EINTR) continue;
      if (m < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        // the client fd is non-blocking (Python timeout semantics):
        // a full socket buffer is a slow client, not a dead one
        if (px_wait_fd(client_fd, POLLOUT)) continue;
        rc = 2;
        break;
      }
      if (m <= 0) {
        rc = 2;
        break;
      }
      inpipe -= m;
      sent += m;
    }
    if (rc) break;
  }
  ::close(pipefd[0]);
  ::close(pipefd[1]);
  *relayed = sent;
  return rc;
}

bool px_head_keepalive(const std::string& head, size_t hdr_end) {
  size_t pos = 0;
  while (pos < hdr_end) {
    size_t le = head.find("\r\n", pos);
    if (le == std::string::npos || le > hdr_end) break;
    if (le - pos > 11 &&
        strncasecmp(head.c_str() + pos, "connection:", 11) == 0 &&
        memmem(head.c_str() + pos, le - pos, "close", 5))
      return false;
    pos = le + 2;
  }
  return true;
}

uint64_t mono_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

void set_nonblock(int fd, bool on) {
  int fl = fcntl(fd, F_GETFL, 0);
  if (fl < 0) return;
  (void)fcntl(fd, F_SETFL, on ? (fl | O_NONBLOCK) : (fl & ~O_NONBLOCK));
}

// --------------------------------------------------------------- px loop
// One background thread drives the BODY phase of every in-flight relay as
// a readiness-driven state machine: instead of parking one handler thread
// in poll() per body, a single worker multiplexes thousands of
// in-flight splices.  Readiness comes from io_uring (IORING_OP_POLL_ADD,
// oneshot) when the kernel has it, or epoll (EPOLLONESHOT) as the
// fallback — the state machines are IDENTICAL either way, so the two
// modes are byte-exact by construction and the parity suite pins it.
// SEAWEEDFS_TPU_PX_URING=0 forces epoll; SEAWEEDFS_TPU_PX_LOOP=0 disables
// the loop entirely (per-call blocking relays) for A/B.

// Raw io_uring (no liburing in the image): setup + mmap + POLL_ADD only.
int io_uring_setup(unsigned entries, struct io_uring_params* p) {
  return (int)syscall(__NR_io_uring_setup, entries, p);
}
int io_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                   unsigned flags, const void* arg, size_t argsz) {
  return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete,
                      flags, arg, argsz);
}

struct PxRing {
  int fd = -1;
  uint32_t entries = 0;
  uint32_t *sq_head = nullptr, *sq_tail = nullptr, *sq_mask = nullptr;
  uint32_t *sq_array = nullptr;
  uint32_t *cq_head = nullptr, *cq_tail = nullptr, *cq_mask = nullptr;
  struct io_uring_sqe* sqes = nullptr;
  struct io_uring_cqe* cqes = nullptr;
  void* ring_mm = nullptr;
  size_t ring_mm_len = 0;
  void* sqe_mm = nullptr;
  size_t sqe_mm_len = 0;
};

bool uring_init(PxRing* r, uint32_t entries) {
  struct io_uring_params p;
  memset(&p, 0, sizeof p);
  int fd = io_uring_setup(entries, &p);
  if (fd < 0) return false;
  // SINGLE_MMAP (5.4) keeps the mapping simple; EXT_ARG (5.11) gives
  // io_uring_enter a timeout without a timeout SQE; NODROP (5.5) means a
  // full CQ overflows to a kernel list instead of losing completions
  if (!(p.features & IORING_FEAT_SINGLE_MMAP) ||
      !(p.features & IORING_FEAT_EXT_ARG) ||
      !(p.features & IORING_FEAT_NODROP)) {
    ::close(fd);
    return false;
  }
  size_t sq_sz = p.sq_off.array + p.sq_entries * sizeof(uint32_t);
  size_t cq_sz = p.cq_off.cqes + p.cq_entries * sizeof(struct io_uring_cqe);
  size_t ring_sz = sq_sz > cq_sz ? sq_sz : cq_sz;
  void* mm = mmap(nullptr, ring_sz, PROT_READ | PROT_WRITE,
                  MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING);
  if (mm == MAP_FAILED) {
    ::close(fd);
    return false;
  }
  size_t sqe_sz = p.sq_entries * sizeof(struct io_uring_sqe);
  void* sqe_mm = mmap(nullptr, sqe_sz, PROT_READ | PROT_WRITE,
                      MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQES);
  if (sqe_mm == MAP_FAILED) {
    munmap(mm, ring_sz);
    ::close(fd);
    return false;
  }
  uint8_t* base = (uint8_t*)mm;
  r->fd = fd;
  r->entries = p.sq_entries;
  r->sq_head = (uint32_t*)(base + p.sq_off.head);
  r->sq_tail = (uint32_t*)(base + p.sq_off.tail);
  r->sq_mask = (uint32_t*)(base + p.sq_off.ring_mask);
  r->sq_array = (uint32_t*)(base + p.sq_off.array);
  r->cq_head = (uint32_t*)(base + p.cq_off.head);
  r->cq_tail = (uint32_t*)(base + p.cq_off.tail);
  r->cq_mask = (uint32_t*)(base + p.cq_off.ring_mask);
  r->cqes = (struct io_uring_cqe*)(base + p.cq_off.cqes);
  r->sqes = (struct io_uring_sqe*)sqe_mm;
  r->ring_mm = mm;
  r->ring_mm_len = ring_sz;
  r->sqe_mm = sqe_mm;
  r->sqe_mm_len = sqe_sz;
  return true;
}

void uring_close(PxRing* r) {
  if (r->sqe_mm != nullptr) munmap(r->sqe_mm, r->sqe_mm_len);
  if (r->ring_mm != nullptr) munmap(r->ring_mm, r->ring_mm_len);
  if (r->fd >= 0) ::close(r->fd);
  r->fd = -1;
  r->ring_mm = r->sqe_mm = nullptr;
}

// Queue one oneshot POLL_ADD.  A full SQ is flushed with io_uring_enter
// and retried a BOUNDED number of times (nativelint N002's SQ-full class)
// — on exhaustion the caller fails the job instead of spinning.
bool uring_poll_add(PxRing* r, int fd, uint32_t poll_events, uint64_t ud) {
  for (int attempt = 0; attempt < 3; attempt++) {
    uint32_t head = __atomic_load_n(r->sq_head, __ATOMIC_ACQUIRE);
    uint32_t tail = *r->sq_tail;
    if (tail - head < r->entries) {
      uint32_t idx = tail & *r->sq_mask;
      struct io_uring_sqe* sqe = &r->sqes[idx];
      memset(sqe, 0, sizeof *sqe);
      sqe->opcode = IORING_OP_POLL_ADD;
      sqe->fd = fd;
      sqe->poll32_events = poll_events;
      sqe->user_data = ud;
      r->sq_array[idx] = idx;
      __atomic_store_n(r->sq_tail, tail + 1, __ATOMIC_RELEASE);
      return true;
    }
    if (io_uring_enter(r->fd, tail - head, 0, 0, nullptr, 0) < 0 &&
        errno != EINTR && errno != EBUSY)
      return false;
  }
  return false;
}

// Cancel a pending oneshot POLL_ADD by its user_data.  Without this, a
// timed-out job's poll would keep a kernel reference to the socket's
// struct file: the caller's close() then never sends FIN and a wedged
// peer pins the connection (and its memory) forever.  The cancellation
// CQE (and the cancelled poll's -ECANCELED CQE) carry reserved/stale
// user_data and are ignored by the dispatcher.
constexpr uint64_t kUringWakeUd = 0;    // the submission wake channel
constexpr uint64_t kUringCancelUd = 1;  // POLL_REMOVE completions
bool uring_poll_remove(PxRing* r, uint64_t target_ud) {
  for (int attempt = 0; attempt < 3; attempt++) {
    uint32_t head = __atomic_load_n(r->sq_head, __ATOMIC_ACQUIRE);
    uint32_t tail = *r->sq_tail;
    if (tail - head < r->entries) {
      uint32_t idx = tail & *r->sq_mask;
      struct io_uring_sqe* sqe = &r->sqes[idx];
      memset(sqe, 0, sizeof *sqe);
      sqe->opcode = IORING_OP_POLL_REMOVE;
      sqe->fd = -1;
      sqe->addr = target_ud;
      sqe->user_data = kUringCancelUd;
      r->sq_array[idx] = idx;
      __atomic_store_n(r->sq_tail, tail + 1, __ATOMIC_RELEASE);
      return true;
    }
    if (io_uring_enter(r->fd, tail - head, 0, 0, nullptr, 0) < 0 &&
        errno != EINTR && errno != EBUSY)
      return false;
  }
  return false;
}

// Submit anything pending and wait up to timeout_ms for one completion.
void uring_wait(PxRing* r, int timeout_ms) {
  struct __kernel_timespec ts;
  ts.tv_sec = timeout_ms / 1000;
  ts.tv_nsec = (long long)(timeout_ms % 1000) * 1000000ll;
  struct io_uring_getevents_arg arg;
  memset(&arg, 0, sizeof arg);
  arg.ts = (uint64_t)(uintptr_t)&ts;
  uint32_t head = __atomic_load_n(r->sq_head, __ATOMIC_ACQUIRE);
  uint32_t tail = *r->sq_tail;
  (void)io_uring_enter(r->fd, tail - head, 1,
                       IORING_ENTER_GETEVENTS | IORING_ENTER_EXT_ARG, &arg,
                       sizeof arg);
}

template <typename F>
void uring_drain_cqes(PxRing* r, F&& fn) {
  uint32_t head = *r->cq_head;
  uint32_t tail = __atomic_load_n(r->cq_tail, __ATOMIC_ACQUIRE);
  while (head != tail) {
    struct io_uring_cqe* cqe = &r->cqes[head & *r->cq_mask];
    fn(cqe->user_data);
    head++;
  }
  __atomic_store_n(r->cq_head, head, __ATOMIC_RELEASE);
}

// One in-flight relay's state.  A job waits on exactly ONE fd at a time;
// the loop steps it when that fd is ready (or its deadline expires) and
// the step runs nonblocking syscalls until the next EAGAIN.
struct PxJob {
  // 0 = GET relay (upstream->client), 1 = PUT fan-out stream,
  // 2 = cache send (segment file -> client via sendfile; `up` is the
  //     cache file fd, which is always ready — parks only on the client)
  int kind = 0;
  // parking state (valid when the job is in `active`)
  int wait_fd = -1;
  uint32_t wait_ev = 0;
  uint64_t deadline_ns = 0;
  uint64_t id = 0;
  bool timed_out = false;
  // completion handshake with the submitting thread
  std::mutex mu;
  std::condition_variable cv;
  bool done = false;
  // GET: rc 0 ok, 1 upstream died mid-body, 2 client gone
  // PUT: rc 0 ok, 1 client gone, 2 peer died (body drained + retained)
  int rc = 0;
  // GET relay state
  int up = -1;
  int client = -1;
  int64_t want = 0, sent = 0, inpipe = 0;
  int64_t file_off = 0;  // cache send: body start inside the segment file
  int pipefd[2] = {-1, -1};
  bool copy_mode = false;
  std::unique_ptr<uint8_t[]> buf;
  size_t buf_have = 0, buf_sent = 0;
  // PUT fan-out state
  int socks[kPxMaxReplicas] = {};
  int nsock = 0;
  uint8_t* body = nullptr;  // retention buffer (submitter-owned)
  int64_t body_rem = 0, consumed = 0;
  int64_t block_lo = 0, block_len = 0;
  int64_t peer_sent[kPxMaxReplicas] = {};
  int cur_peer = 0;
  bool draining = false;
  int dead_peer = -1;
  Md5* md5 = nullptr;
};

// Per-step byte budget: a relay with both sides ready could otherwise move
// its whole body in one step and starve every other in-flight job.
constexpr int64_t kPxStepBudget = 8 << 20;

// step result: 0 = parked on (wait_fd, wait_ev, deadline), 1 = done,
// 2 = budget exhausted (requeue after the other runnable jobs)
int step_get(PxJob* j, uint64_t now) {
  if (j->timed_out) {
    j->timed_out = false;
    j->rc = (j->wait_fd == j->client) ? 2 : 1;  // stalled side decides
    return 1;
  }
  int64_t budget = kPxStepBudget;
  for (;;) {
    if (budget <= 0) return 2;
    if (!j->copy_mode) {
      if (j->inpipe > 0) {
        unsigned fl = SPLICE_F_MOVE | SPLICE_F_NONBLOCK;
        if (j->sent + j->inpipe < j->want) fl |= SPLICE_F_MORE;
        ssize_t m = splice(j->pipefd[0], nullptr, j->client, nullptr,
                           (size_t)j->inpipe, fl);
        if (m < 0 && errno == EINTR) continue;
        if (m < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
          j->wait_fd = j->client;
          j->wait_ev = POLLOUT;
          j->deadline_ns = now + (uint64_t)kPxClientStallMs * 1000000ull;
          return 0;
        }
        if (m <= 0) {
          j->rc = 2;
          return 1;
        }
        j->inpipe -= m;
        j->sent += m;
        budget -= m;
        continue;
      }
      if (j->sent >= j->want) {
        j->rc = 0;
        return 1;
      }
      ssize_t n = splice(j->up, nullptr, j->pipefd[1], nullptr,
                         (size_t)std::min<int64_t>(j->want - j->sent, 1 << 20),
                         SPLICE_F_MOVE | SPLICE_F_NONBLOCK);
      if (n < 0 && errno == EINTR) continue;
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        j->wait_fd = j->up;
        j->wait_ev = POLLIN;
        j->deadline_ns = now + (uint64_t)kPxUpstreamTimeoutSec * 1000000000ull;
        return 0;
      }
      if (n < 0 && (errno == EINVAL || errno == ENOSYS) && j->sent == 0) {
        // fd type without splice support: buffered relay takes over
        j->copy_mode = true;
        j->buf.reset(new uint8_t[kPxBufSize]);
        continue;
      }
      if (n <= 0) {
        j->rc = 1;
        return 1;
      }
      j->inpipe = n;
      continue;
    }
    // buffered relay (no-splice fd types / SEAWEEDFS_TPU_PX_KSPLICE=0)
    if (j->buf_sent < j->buf_have) {
      ssize_t m = ::send(j->client, j->buf.get() + j->buf_sent,
                         j->buf_have - j->buf_sent, MSG_NOSIGNAL);
      if (m < 0 && errno == EINTR) continue;
      if (m < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        j->wait_fd = j->client;
        j->wait_ev = POLLOUT;
        j->deadline_ns = now + (uint64_t)kPxClientStallMs * 1000000ull;
        return 0;
      }
      if (m <= 0) {
        j->rc = 2;
        return 1;
      }
      j->buf_sent += m;
      j->sent += m;
      budget -= m;
      continue;
    }
    if (j->sent >= j->want) {
      j->rc = 0;
      return 1;
    }
    ssize_t n = ::recv(j->up, j->buf.get(),
                       (size_t)std::min<int64_t>(j->want - j->sent,
                                                 (int64_t)kPxBufSize), 0);
    if (n < 0 && errno == EINTR) continue;
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      j->wait_fd = j->up;
      j->wait_ev = POLLIN;
      j->deadline_ns = now + (uint64_t)kPxUpstreamTimeoutSec * 1000000000ull;
      return 0;
    }
    if (n <= 0) {
      j->rc = 1;
      return 1;
    }
    j->buf_have = (size_t)n;
    j->buf_sent = 0;
  }
}

int step_put(PxJob* j, uint64_t now) {
  if (j->timed_out) {
    j->timed_out = false;
    if (j->wait_fd == j->client) {
      j->rc = 1;
      return 1;
    }
    // a peer stalled past its deadline: mark it dead, keep draining the
    // client so the body stays replayable through the Python ladder
    j->dead_peer = j->cur_peer;
    j->draining = true;
  }
  int64_t budget = kPxStepBudget;
  for (;;) {
    if (budget <= 0) return 2;
    if (!j->draining && j->cur_peer < j->nsock) {
      int64_t off = j->peer_sent[j->cur_peer];
      if (off >= j->block_len) {
        j->cur_peer++;
        continue;
      }
      ssize_t m = ::send(j->socks[j->cur_peer], j->body + j->block_lo + off,
                         (size_t)(j->block_len - off), MSG_NOSIGNAL);
      if (m < 0 && errno == EINTR) continue;
      if (m < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        j->wait_fd = j->socks[j->cur_peer];
        j->wait_ev = POLLOUT;
        j->deadline_ns = now + (uint64_t)kPxUpstreamTimeoutSec * 1000000000ull;
        return 0;
      }
      if (m <= 0) {
        j->dead_peer = j->cur_peer;
        j->draining = true;
        continue;
      }
      j->peer_sent[j->cur_peer] += m;
      budget -= m;
      continue;
    }
    if (j->body_rem <= 0) {
      j->rc = j->draining ? 2 : 0;
      return 1;
    }
    ssize_t r = ::recv(j->client, j->body + j->consumed,
                       (size_t)std::min<int64_t>(j->body_rem,
                                                 (int64_t)kPxBufSize), 0);
    if (r < 0 && errno == EINTR) continue;
    if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      j->wait_fd = j->client;
      j->wait_ev = POLLIN;
      j->deadline_ns = now + (uint64_t)kPxClientStallMs * 1000000ull;
      return 0;
    }
    if (r <= 0) {
      j->rc = 1;
      return 1;
    }
    j->md5->update(j->body + j->consumed, (size_t)r);
    j->block_lo = j->consumed;
    j->block_len = r;
    j->consumed += r;
    j->body_rem -= r;
    budget -= r;
    if (!j->draining) {
      j->cur_peer = 0;
      for (int i = 0; i < j->nsock; i++) j->peer_sent[i] = 0;
    }
  }
}

// kind 2: cache segment file -> client.  sendfile(2) moves the bytes
// file->socket inside the kernel; the file side is a regular (unlinked)
// segment file and never blocks, so the job only ever parks on the
// client socket.  rc: 0 ok, 2 client gone/stalled.  A pread short of the
// recorded entry size (truncated cache file) aborts as client-gone —
// cutting the connection short of Content-Length is the honest signal,
// the same contract the GET relay uses for a dead upstream.
int step_cache(PxJob* j, uint64_t now) {
  if (j->timed_out) {
    j->timed_out = false;
    j->rc = 2;
    return 1;
  }
  int64_t budget = kPxStepBudget;
  for (;;) {
    if (budget <= 0) return 2;
    if (j->buf_sent < j->buf_have) {  // copy-mode tail pending
      ssize_t m = ::send(j->client, j->buf.get() + j->buf_sent,
                         j->buf_have - j->buf_sent, MSG_NOSIGNAL);
      if (m < 0 && errno == EINTR) continue;
      if (m < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        j->wait_fd = j->client;
        j->wait_ev = POLLOUT;
        j->deadline_ns = now + (uint64_t)kPxClientStallMs * 1000000ull;
        return 0;
      }
      if (m <= 0) {
        j->rc = 2;
        return 1;
      }
      j->buf_sent += m;
      j->sent += m;
      budget -= m;
      continue;
    }
    if (j->sent >= j->want) {
      j->rc = 0;
      return 1;
    }
    if (!j->copy_mode) {
      off_t off = (off_t)(j->file_off + j->sent);
      ssize_t n = sendfile(j->client, j->up, &off,
                           (size_t)std::min<int64_t>(j->want - j->sent,
                                                     1 << 20));
      if (n < 0 && errno == EINTR) continue;
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        j->wait_fd = j->client;
        j->wait_ev = POLLOUT;
        j->deadline_ns = now + (uint64_t)kPxClientStallMs * 1000000ull;
        return 0;
      }
      if (n < 0 && (errno == EINVAL || errno == ENOSYS) && j->sent == 0) {
        // fd type without sendfile support: pread+send takes over
        j->copy_mode = true;
        j->buf.reset(new uint8_t[kPxBufSize]);
        continue;
      }
      if (n <= 0) {
        j->rc = 2;
        return 1;
      }
      j->sent += n;
      budget -= n;
      continue;
    }
    ssize_t n = pread(j->up, j->buf.get(),
                      (size_t)std::min<int64_t>(j->want - j->sent,
                                                (int64_t)kPxBufSize),
                      (off_t)(j->file_off + j->sent));
    if (n < 0 && errno == EINTR) continue;
    if (n <= 0) {
      j->rc = 2;
      return 1;
    }
    j->buf_have = (size_t)n;
    j->buf_sent = 0;
  }
}

int px_step(PxJob* j, uint64_t now) {
  switch (j->kind) {
    case 0:
      return step_get(j, now);
    case 1:
      return step_put(j, now);
    default:
      return step_cache(j, now);
  }
}

void px_job_finish(PxJob* j) {
  std::lock_guard lk(j->mu);
  j->done = true;
  j->cv.notify_one();
}

void px_job_force_fail(PxJob* j, uint64_t now) {
  // arm failure / shutdown: fail through the timeout path; a PUT that
  // parks again mid-drain is cut off as a client-gone abort
  j->timed_out = true;
  int st = px_step(j, now);
  if (st != 1) j->rc = j->kind == 1 ? 1 : 2;
  px_job_finish(j);
}

struct PxLoop {
  int mode = kPxLoopOff;
  PxRing ring;
  int epfd = -1;
  int wake_fd = -1;
  std::atomic<bool> stop{false};
  std::thread thr;
  std::mutex in_mu;
  std::vector<PxJob*> incoming;
};

bool loop_arm(PxLoop* lp, int fd, uint32_t ev, uint64_t id) {
  if (lp->mode == kPxLoopUring) return uring_poll_add(&lp->ring, fd, ev, id);
  struct epoll_event e {};
  e.events = ((ev & POLLIN) ? EPOLLIN : 0u) | ((ev & POLLOUT) ? EPOLLOUT : 0u) |
             EPOLLONESHOT;
  e.data.u64 = id;
  if (epoll_ctl(lp->epfd, EPOLL_CTL_ADD, fd, &e) == 0) return true;
  return errno == EEXIST && epoll_ctl(lp->epfd, EPOLL_CTL_MOD, fd, &e) == 0;
}

void px_loop_main(PxLoop* lp) {
  std::unordered_map<uint64_t, PxJob*> active;  // parked, by id
  std::vector<PxJob*> runnable, deferred;
  uint64_t next_id = 2;  // 0 = wake channel, 1 = cancellation CQEs
  bool wake_armed = false;
  for (;;) {
    if (lp->mode == kPxLoopUring && !wake_armed)
      wake_armed = uring_poll_add(&lp->ring, lp->wake_fd, POLLIN, 0);
    {
      std::lock_guard lk(lp->in_mu);
      runnable.insert(runnable.end(), lp->incoming.begin(),
                      lp->incoming.end());
      lp->incoming.clear();
    }
    if (lp->stop.load(std::memory_order_relaxed)) break;
    uint64_t now = mono_ns();
    for (size_t i = 0; i < runnable.size(); i++) {
      PxJob* j = runnable[i];
      int st = px_step(j, now);
      if (st == 1) {
        px_job_finish(j);
      } else if (st == 2) {
        deferred.push_back(j);  // fair share: rerun after the others
      } else {
        if (j->id == 0) j->id = next_id++;
        if (loop_arm(lp, j->wait_fd, j->wait_ev, j->id)) {
          active[j->id] = j;
        } else {
          px_stats[15].fetch_add(1, std::memory_order_relaxed);
          px_job_force_fail(j, now);
        }
      }
    }
    runnable.clear();
    // wait: next readiness event, nearest deadline, or a submission wake
    int timeout_ms = deferred.empty() ? 500 : 0;
    now = mono_ns();
    for (auto& kv : active) {
      int64_t left = ((int64_t)(kv.second->deadline_ns - now)) / 1000000;
      if (left < 0) left = 0;
      if (left < timeout_ms) timeout_ms = (int)left;
    }
    bool wake_fired = false;
    auto dispatch = [&](uint64_t ud) {
      if (ud == kUringWakeUd) {
        wake_fired = true;
        return;
      }
      if (ud == kUringCancelUd) return;  // a POLL_REMOVE completed
      auto it = active.find(ud);
      if (it == active.end()) return;  // already expired: stale completion
      runnable.push_back(it->second);
      active.erase(it);
    };
    if (lp->mode == kPxLoopUring) {
      uring_wait(&lp->ring, timeout_ms);
      uring_drain_cqes(&lp->ring, dispatch);
    } else {
      struct epoll_event evs[64];
      int nev = epoll_wait(lp->epfd, evs, 64, timeout_ms);
      for (int i = 0; i < nev; i++) dispatch(evs[i].data.u64);
    }
    if (wake_fired) {
      uint64_t cnt = 0;
      (void)::read(lp->wake_fd, &cnt, sizeof cnt);  // reset the eventfd
      if (lp->mode == kPxLoopUring) wake_armed = false;
    }
    now = mono_ns();
    for (auto it = active.begin(); it != active.end();) {
      PxJob* j = it->second;
      if (j->deadline_ns <= now) {
        // cancel the pending poll: it holds a kernel reference to the
        // fd's file, and the caller is about to close() that fd
        if (lp->mode == kPxLoopUring)
          (void)uring_poll_remove(&lp->ring, j->id);
        j->timed_out = true;  // its step decides what the stall means
        runnable.push_back(j);
        it = active.erase(it);
      } else {
        ++it;
      }
    }
    runnable.insert(runnable.end(), deferred.begin(), deferred.end());
    deferred.clear();
  }
  // shutdown: every queued/parked job fails loudly — a submitter blocked
  // on its condvar with the loop gone would hang forever.  The incoming
  // list is swapped out first so no force-fail step runs under in_mu.
  {
    std::lock_guard lk(lp->in_mu);
    runnable.insert(runnable.end(), lp->incoming.begin(),
                    lp->incoming.end());
    lp->incoming.clear();
  }
  uint64_t now = mono_ns();
  for (PxJob* j : runnable) px_job_force_fail(j, now);
  for (PxJob* j : deferred) px_job_force_fail(j, now);
  for (auto& kv : active) {
    if (lp->mode == kPxLoopUring)
      (void)uring_poll_remove(&lp->ring, kv.first);
    px_job_force_fail(kv.second, now);
  }
  if (lp->mode == kPxLoopUring) {
    // flush the cancellations so the polls drop their file references
    // before the callers close the fds
    uint32_t head = __atomic_load_n(lp->ring.sq_head, __ATOMIC_ACQUIRE);
    uint32_t tail = *lp->ring.sq_tail;
    if (tail != head)
      (void)io_uring_enter(lp->ring.fd, tail - head, 0, 0, nullptr, 0);
  }
}

std::mutex px_loop_mu;
PxLoop* px_loop_inst = nullptr;
bool px_loop_inited = false;

PxLoop* px_loop_get() {
  std::lock_guard lk(px_loop_mu);
  if (px_loop_inited) return px_loop_inst;
  px_loop_inited = true;
  const char* lv = getenv("SEAWEEDFS_TPU_PX_LOOP");
  if (lv != nullptr && strcmp(lv, "0") == 0) return nullptr;
  auto* lp = new PxLoop();
  int wfd = eventfd(0, EFD_CLOEXEC | EFD_NONBLOCK);
  if (wfd < 0) {
    delete lp;
    return nullptr;
  }
  const char* uv = getenv("SEAWEEDFS_TPU_PX_URING");
  bool want_uring = uv == nullptr || strcmp(uv, "0") != 0;
  if (want_uring && uring_init(&lp->ring, 1024)) {
    lp->mode = kPxLoopUring;
  } else {
    int efd = epoll_create1(EPOLL_CLOEXEC);
    if (efd < 0) {
      ::close(wfd);
      delete lp;
      return nullptr;
    }
    struct epoll_event e {};
    e.events = EPOLLIN;  // persistent: the wake channel re-arms itself
    e.data.u64 = 0;
    if (epoll_ctl(efd, EPOLL_CTL_ADD, wfd, &e) != 0) {
      ::close(efd);
      ::close(wfd);
      delete lp;
      return nullptr;
    }
    lp->epfd = efd;
    lp->mode = kPxLoopEpoll;
  }
  lp->wake_fd = wfd;
  lp->thr = std::thread(px_loop_main, lp);
  px_loop_inst = lp;
  return lp;
}

void px_loop_submit(PxLoop* lp, PxJob* j) {
  bool stopped = false;
  {
    std::lock_guard lk(lp->in_mu);
    if (lp->stop.load(std::memory_order_relaxed))
      stopped = true;  // raced sw_px_loop_reset past its final drain
    else
      lp->incoming.push_back(j);
  }
  if (stopped) {
    // nobody will ever step this job — fail it on the submitting thread
    // (stop flips under in_mu, so this check cannot miss the drain)
    px_job_force_fail(j, mono_ns());
    return;
  }
  uint64_t one = 1;
  // an eventfd write only fails at counter overflow (never at 1/job);
  // even then the loop's 500ms tick picks the submission up
  (void)::write(lp->wake_fd, &one, sizeof one);
}

void px_job_wait(PxJob* j) {
  std::unique_lock lk(j->mu);
  j->cv.wait(lk, [j] { return j->done; });
}

// Loop-driven GET body relay; same return contract as px_splice_body
// minus code 3 (the job falls back to its buffered mode internally).
int px_loop_get_relay(PxLoop* lp, int up, int client_fd, int64_t want,
                      int64_t* relayed) {
  PxJob j;
  j.kind = 0;
  j.up = up;
  j.client = client_fd;
  j.want = want;
  if (!px_ksplice_enabled() ||
      pipe2(j.pipefd, O_CLOEXEC | O_NONBLOCK) != 0) {
    j.pipefd[0] = j.pipefd[1] = -1;
    j.copy_mode = true;
    j.buf.reset(new uint8_t[kPxBufSize]);
  } else {
    (void)fcntl(j.pipefd[1], F_SETPIPE_SZ, 1 << 20);  // best effort
  }
  set_nonblock(up, true);  // the loop thread must never block on a peer
  px_stats[13].fetch_add(1, std::memory_order_relaxed);
  px_loop_submit(lp, &j);
  px_job_wait(&j);
  set_nonblock(up, false);  // pool reuse expects blocking + SO_RCVTIMEO
  if (j.pipefd[0] >= 0) ::close(j.pipefd[0]);
  if (j.pipefd[1] >= 0) ::close(j.pipefd[1]);
  *relayed = j.sent;
  return j.rc;
}

// Loop-driven cache-send relay: segment file -> client sendfile as a
// state machine on the shared readiness thread.  rc as step_cache.
int px_loop_cache_relay(PxLoop* lp, int cache_fd, int client_fd,
                        int64_t file_off, int64_t want, int64_t* relayed) {
  PxJob j;
  j.kind = 2;
  j.up = cache_fd;
  j.client = client_fd;
  j.want = want;
  j.file_off = file_off;
  px_stats[19].fetch_add(1, std::memory_order_relaxed);
  px_loop_submit(lp, &j);
  px_job_wait(&j);
  *relayed = j.sent;
  return j.rc;
}

// Blocking cache-send relay (loop disabled): same contract, parked on
// the handler thread with the client-stall deadline.
int px_cache_send_sync(int cache_fd, int64_t file_off, int64_t want,
                       int client_fd, int64_t* sent_out) {
  int64_t sent = 0;
  bool copy_mode = false;
  std::unique_ptr<uint8_t[]> buf;
  while (sent < want) {
    if (!copy_mode) {
      off_t off = (off_t)(file_off + sent);
      ssize_t n = sendfile(client_fd, cache_fd, &off,
                           (size_t)std::min<int64_t>(want - sent, 1 << 20));
      if (n < 0 && errno == EINTR) continue;
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        if (px_wait_fd(client_fd, POLLOUT)) continue;
        break;  // client stalled past the deadline
      }
      if (n < 0 && (errno == EINVAL || errno == ENOSYS) && sent == 0) {
        copy_mode = true;
        buf.reset(new uint8_t[kPxBufSize]);
        continue;
      }
      if (n <= 0) break;
      sent += n;
      continue;
    }
    ssize_t n = pread(cache_fd, buf.get(),
                      (size_t)std::min<int64_t>(want - sent,
                                                (int64_t)kPxBufSize),
                      (off_t)(file_off + sent));
    if (n < 0 && errno == EINTR) continue;
    if (n <= 0) break;  // truncated cache file: abort short of CL
    if (!px_send_client(client_fd, buf.get(), (size_t)n)) break;
    sent += n;
  }
  *sent_out = sent;
  return sent == want ? 0 : 2;
}

// Loop-driven PUT fan-out stream (client -> n peers, MD5 + retention in
// one pass).  rc: 0 ok, 1 client gone, 2 peer died (body fully drained
// into body_out so the Python ladder can replay it).
int px_loop_put_stream(PxLoop* lp, int client_fd, const int* socks, int n,
                       int64_t sock_rem, Md5* md5, uint8_t* body_out,
                       int64_t* consumed_out, int* dead_peer) {
  PxJob j;
  j.kind = 1;
  j.client = client_fd;
  j.nsock = n;
  for (int i = 0; i < n; i++) {
    j.socks[i] = socks[i];
    set_nonblock(socks[i], true);
  }
  j.body = body_out;
  j.body_rem = sock_rem;
  j.md5 = md5;
  j.cur_peer = n;  // no block pending until the first client read
  px_stats[14].fetch_add(1, std::memory_order_relaxed);
  px_loop_submit(lp, &j);
  px_job_wait(&j);
  for (int i = 0; i < n; i++) set_nonblock(socks[i], false);
  *consumed_out = j.consumed;
  *dead_peer = j.dead_peer;
  return j.rc;
}

// ------------------------------------------------------ px PUT fan-out
// One client PUT body streamed to every replica holder at once from the
// GATEWAY (the reference writes through a primary which re-replicates;
// arXiv:1309.0186's point is that replication traffic makes the network
// the scarce resource — fanning out from the edge halves the hops).  The
// body is retained in the caller's buffer as it streams, so a replica
// dying mid-fan-out degrades to the Python replication ladder with zero
// acked-write loss: nothing is acked unless every peer acked.

// a round must fit an empty default pipe (64KB) so every tee lands whole
constexpr int64_t kFanRoundBytes = 60 * 1024;

std::vector<std::string> split_csv(const char* csv) {
  std::vector<std::string> out;
  std::string s = csv ? csv : "";
  size_t pos = 0;
  while (pos < s.size()) {
    size_t comma = s.find(',', pos);
    if (comma == std::string::npos) comma = s.size();
    if (comma > pos) out.push_back(s.substr(pos, comma - pos));
    pos = comma + 1;
  }
  return out;
}

void fan_close_pipes(int (*pairs)[2], int count) {
  for (int i = 0; i < count; i++) {
    if (pairs[i][0] >= 0) ::close(pairs[i][0]);
    if (pairs[i][1] >= 0) ::close(pairs[i][1]);
  }
}

// Connect + send head+initial to one peer, retrying stale keep-alives
// (bounded by the pool depth; runs before any client byte is consumed,
// so a total failure is still replayable).  Returns the fd or -1.
int fan_connect_send(const char* addr, const std::string& head,
                     const uint8_t* initial, size_t initial_len) {
  for (int attempt = 0; attempt < (int)kPxMaxIdlePerHost + 1; attempt++) {
    bool reused = false;
    int fd = px_connect(addr, &reused);
    if (fd < 0) return -1;
    if (send_full(fd, head.data(), head.size()) &&
        (initial_len == 0 || send_full(fd, initial, initial_len)))
      return fd;
    ::close(fd);
    if (!reused) return -1;  // fresh connect failed: peer is down
  }
  // nativelint: disable=N001 — fd is loop-scoped: every iteration exits via return fd / close+return / close+retry, nothing reaches here holding one
  return -1;
}

// Blocking fan-out stream (loop disabled): client -> n peers.  With
// kernel splice available and n > 1, the body forks in the kernel —
// splice(client -> pipe), tee(pipe -> per-secondary pipes), one read()
// into the retention buffer (MD5 needs the bytes in userspace anyway;
// the primary is fed from it), splice(pipe_i -> sock_i) for the rest —
// so userspace touches the body ONCE regardless of replica count.
// rc: 0 ok, 1 client gone, 2 peer died (body fully drained + retained).
int fan_stream_sync(const int* socks, int n, int client_fd,
                    int64_t sock_rem, Md5* md5, uint8_t* body_out,
                    int64_t* consumed_out, int* dead_peer) {
  int64_t consumed = 0;
  int64_t rem = sock_rem;
  int dead = -1;
  int rc = -1;  // still streaming
  int mainp[2] = {-1, -1};
  int secp[kPxMaxReplicas][2];
  for (int i = 0; i < kPxMaxReplicas; i++) secp[i][0] = secp[i][1] = -1;
  bool tee_mode = px_ksplice_enabled() && n > 1;
  if (tee_mode && pipe2(mainp, O_CLOEXEC | O_NONBLOCK) != 0) {
    mainp[0] = mainp[1] = -1;
    tee_mode = false;
  }
  for (int i = 1; tee_mode && i < n; i++) {
    if (pipe2(secp[i], O_CLOEXEC) != 0) {
      secp[i][0] = secp[i][1] = -1;
      tee_mode = false;
    }
  }
  while (rc < 0) {
    if (rem <= 0) {
      rc = dead >= 0 ? 2 : 0;
      continue;
    }
    if (dead >= 0 || !tee_mode) {
      // plain buffered round (also the post-death client drain: the
      // retention buffer must hold the WHOLE body for the ladder replay)
      ssize_t r = px_recv_client(
          client_fd, body_out + consumed,
          (size_t)std::min<int64_t>(rem, (int64_t)kPxBufSize));
      if (r <= 0) {
        rc = 1;
        continue;
      }
      md5->update(body_out + consumed, (size_t)r);
      for (int i = 0; dead < 0 && i < n; i++) {
        if (!send_full(socks[i], body_out + consumed, (size_t)r)) dead = i;
      }
      consumed += r;
      rem -= r;
      continue;
    }
    // one tee round
    ssize_t r = splice(client_fd, nullptr, mainp[1], nullptr,
                       (size_t)std::min<int64_t>(rem, kFanRoundBytes),
                       SPLICE_F_MOVE | SPLICE_F_NONBLOCK);
    if (r < 0 && errno == EINTR) continue;
    if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      if (px_wait_fd(client_fd, POLLIN)) continue;
      rc = 1;  // client stalled past the deadline
      continue;
    }
    if (r < 0 && consumed == 0 && (errno == EINVAL || errno == ENOSYS)) {
      tee_mode = false;  // fd type without splice: buffered rounds
      continue;
    }
    if (r <= 0) {
      rc = 1;
      continue;
    }
    // fork the round into each secondary's pipe (tee duplicates without
    // consuming); a short tee is topped up from the buffer below
    int64_t teed[kPxMaxReplicas] = {};
    for (int i = 1; i < n; i++) {
      while (teed[i] < r) {
        ssize_t t = tee(mainp[0], secp[i][1], (size_t)(r - teed[i]), 0);
        if (t < 0 && errno == EINTR) continue;
        if (t <= 0) break;
        teed[i] += t;
      }
    }
    // drain the main pipe into the retention buffer (consumes the round)
    int64_t got = 0;
    while (got < r) {
      ssize_t g = ::read(mainp[0], body_out + consumed + got,
                         (size_t)(r - got));
      if (g < 0 && errno == EINTR) continue;
      if (g <= 0) break;
      got += g;
    }
    if (got < r) {
      rc = 1;  // pipe anomaly: bytes unaccounted, abort the request
      continue;
    }
    md5->update(body_out + consumed, (size_t)r);
    if (!send_full(socks[0], body_out + consumed, (size_t)r)) dead = 0;
    for (int i = 1; dead < 0 && i < n; i++) {
      int64_t left = teed[i];
      while (left > 0) {
        ssize_t s = splice(secp[i][0], nullptr, socks[i], nullptr,
                           (size_t)left, SPLICE_F_MOVE);
        if (s < 0 && errno == EINTR) continue;
        if (s <= 0) {
          dead = i;
          break;
        }
        left -= s;
      }
      if (dead < 0 && teed[i] < r &&
          !send_full(socks[i], body_out + consumed + teed[i],
                     (size_t)(r - teed[i])))
        dead = i;
    }
    consumed += r;
    rem -= r;
  }
  if (mainp[0] >= 0) ::close(mainp[0]);
  if (mainp[1] >= 0) ::close(mainp[1]);
  fan_close_pipes(secp, kPxMaxReplicas);
  *consumed_out = consumed;
  *dead_peer = dead;
  return rc;
}

// Phase 3 of the PUT fan-out, shared with the deferred-ack path: read
// one response per peer (the kernel buffered the early acks while later
// bytes streamed, so this costs max(latency), not sum), drain + pool
// healthy keep-alives, fill per-peer statuses.  Returns the primary's
// HTTP status iff every peer acked 2xx, else kPxRetained.  Every fd in
// ``fds`` is consumed (pooled or closed) either way.
int64_t fan_collect(const std::vector<std::string>& addrs,
                    std::vector<int>& fds, uint8_t* resp_out,
                    size_t resp_cap, int64_t* resp_len_out,
                    int64_t* statuses_out, int64_t* ack_wait_ns_out) {
  int n = (int)addrs.size();
  uint64_t t0 = mono_ns();
  bool all_ok = true;
  int64_t primary_status = 0;
  for (int i = 0; i < n; i++) {
    std::string resp;
    size_t hdr_end = px_read_head(fds[i], resp);
    if (hdr_end == std::string::npos) {
      ::close(fds[i]);
      fds[i] = -1;
      if (statuses_out && i < kPxMaxReplicas) statuses_out[i] = kPxMidStream;
      all_ok = false;
      continue;
    }
    int status = px_head_status(resp);
    int64_t cl = px_head_content_length(resp, hdr_end);
    int64_t body_rem = cl < 0 ? 0 : cl - (int64_t)(resp.size() - hdr_end);
    bool drained = true;
    while (body_rem > 0) {
      char tmp[8192];
      ssize_t got = recv_some(
          fds[i], tmp, (size_t)std::min<int64_t>(body_rem, sizeof tmp));
      if (got <= 0) {
        drained = false;
        break;
      }
      resp.append(tmp, got);
      body_rem -= got;
    }
    if (statuses_out && i < kPxMaxReplicas) statuses_out[i] = status;
    if (i == 0) {
      primary_status = status;
      if (resp_out && resp_cap) {
        size_t blen = std::min(resp.size() - hdr_end, resp_cap);
        memcpy(resp_out, resp.data() + hdr_end, blen);
        if (resp_len_out) *resp_len_out = (int64_t)blen;
      }
    }
    if (status >= 200 && status < 300)
      px_stats[11].fetch_add(1, std::memory_order_relaxed);
    else
      all_ok = false;
    if (cl >= 0 && drained && px_head_keepalive(resp, hdr_end))
      px_checkin(addrs[i].c_str(), fds[i]);
    else
      ::close(fds[i]);
    fds[i] = -1;
  }
  uint64_t ack_ns = mono_ns() - t0;
  if (ack_wait_ns_out) *ack_wait_ns_out = (int64_t)ack_ns;
  px_stats[12].fetch_add(ack_ns, std::memory_order_relaxed);
  if (!all_ok) {
    px_stats[10].fetch_add(1, std::memory_order_relaxed);
    return kPxRetained;
  }
  px_stats[8].fetch_add(1, std::memory_order_relaxed);
  return primary_status;
}

// ------------------------------------------------------- px fid stash
// FidPool pre-assignment parked in the native plane: Python refills
// batches of (fid, replica set, auth) off the hot path; the PUT path
// draws one with a single native call — no interpreter lock, no master
// round trip, striped round-robin across volumes exactly like the
// Python FidPool (each batch lands on one volume; FIFO draining one
// batch would serialize every writer behind one append mutex).
struct PxStashEntry {
  std::string fid, addrs, auth;
  uint64_t expiry_ns;
};
struct PxStashBucket {
  std::deque<PxStashEntry> stripes[kPxMaxReplicas * 2];  // 16 stripes
  size_t rr = 0;
};
constexpr size_t kPxStashStripes = kPxMaxReplicas * 2;
constexpr size_t kPxStashMaxPerStripe = 64;
std::mutex px_stash_mu;
std::unordered_map<uint64_t, PxStashBucket> px_stash;

}  // namespace

// px entry points live in extern "C" directly (no Dp handle: the pool is
// process-global, shared by every gateway thread in this process).
extern "C" {

// GET splice: fetch ``path`` bytes [range_lo, range_hi] (inclusive; -1/-1
// = whole body) from the volume server at ``addr`` (numeric ip:port) and
// relay exactly ``want`` body bytes to ``client_fd``, preceded by
// ``head`` (the response head Python built — status line, headers,
// CRLFCRLF; len 0 when the head is already out from an earlier piece).
//
// Returns ``want`` when the full body was relayed.  Negative returns are
// the px-abi codes above:
//   kPxNoSend       upstream unreachable / stale socket exhausted;
//                   NOTHING was sent to the client (caller may fall back
//                   to the Python path or try another replica)
//   kPxBadUpstream  upstream answered but with the wrong status or
//                   length; nothing sent (*detail_out = HTTP status)
//   kPxClientGone   the client write failed (*detail_out = body bytes
//                   that went out); abort the request
//   kPxMidStream    upstream died mid-body (*detail_out = body bytes
//                   already relayed); caller resumes the remainder
//                   through the Python failover path
int64_t sw_px_get(const char* addr, const char* path, int64_t range_lo,
                  int64_t range_hi, const uint8_t* head, size_t head_len,
                  int client_fd, int64_t want, int64_t* detail_out) {
  if (detail_out) *detail_out = 0;
  // every pooled keep-alive to this host may be stale at once (volume
  // server restarted under up to kPxMaxIdlePerHost idle sockets), and a
  // kPxNoSend makes Python forget the replica location — so the retry
  // budget must outlast the whole pool and still leave one fresh connect
  for (int attempt = 0; attempt < (int)kPxMaxIdlePerHost + 1; attempt++) {
    bool reused = false;
    int up = px_connect(addr, &reused);
    if (up < 0) {
      if (reused) continue;  // defensive; px_connect never reports both
      px_stats[3].fetch_add(1, std::memory_order_relaxed);
      return kPxNoSend;
    }
    char req[512];
    int n;
    if (range_lo >= 0) {
      n = snprintf(req, sizeof req,
                   "GET %s HTTP/1.1\r\nHost: %s\r\n"
                   "Range: bytes=%lld-%lld\r\n\r\n",
                   path, addr, (long long)range_lo, (long long)range_hi);
    } else {
      n = snprintf(req, sizeof req, "GET %s HTTP/1.1\r\nHost: %s\r\n\r\n",
                   path, addr);
    }
    if (n < 0 || n >= (int)sizeof req) {
      ::close(up);
      return kPxNoSend;
    }
    std::string resp;
    size_t hdr_end = std::string::npos;
    if (send_full(up, req, n)) hdr_end = px_read_head(up, resp);
    if (hdr_end == std::string::npos) {
      ::close(up);
      if (reused) continue;  // idled-out keep-alive: one fresh retry
      px_stats[3].fetch_add(1, std::memory_order_relaxed);
      return kPxNoSend;
    }
    int status = px_head_status(resp);
    int64_t cl = px_head_content_length(resp, hdr_end);
    bool ok = (status == 206 || (status == 200 && range_lo <= 0)) && cl == want;
    if (!ok) {
      // a real answer, wrong shape (error status, compressed body,
      // ignored Range): nothing sent — Python decides what it means.
      // The body is unread, so the connection cannot be pooled.
      ::close(up);
      px_stats[3].fetch_add(1, std::memory_order_relaxed);
      if (detail_out) *detail_out = status;
      return kPxBadUpstream;
    }
    if (head_len && !px_send_client(client_fd, head, head_len)) {
      ::close(up);
      return kPxClientGone;
    }
    int64_t body_have = (int64_t)(resp.size() - hdr_end);
    if (body_have > want) body_have = want;  // pipelined overshoot: impossible
                                             // with CL framing, but cap anyway
    int64_t sent = 0;
    if (body_have &&
        !px_send_client(client_fd, resp.data() + hdr_end, (size_t)body_have)) {
      ::close(up);
      if (detail_out) *detail_out = 0;
      return kPxClientGone;
    }
    sent += body_have;
    if (sent < want) {
      // kernel splice first: body bytes move socket->pipe->socket
      // without ever entering userspace.  With the px loop up, the relay
      // runs as a state machine on the shared readiness thread (io_uring
      // or epoll) instead of blocking this thread in poll() per body.
      int64_t relayed = 0;
      PxLoop* lp = px_loop_get();
      int src = lp != nullptr
                    ? px_loop_get_relay(lp, up, client_fd, want - sent,
                                        &relayed)
                    : px_splice_body(up, client_fd, want - sent, &relayed);
      sent += relayed;
      if (src == 1) {
        ::close(up);
        px_stats[2].fetch_add(1, std::memory_order_relaxed);
        if (detail_out) *detail_out = sent;
        return kPxMidStream;
      }
      if (src == 2) {
        ::close(up);
        if (detail_out) *detail_out = sent;
        return kPxClientGone;
      }
      if (src == 3) {
        // no splice support here: the userspace copy loop
        std::unique_ptr<uint8_t[]> buf(new uint8_t[kPxBufSize]);
        while (sent < want) {
          ssize_t got = recv_some(
              up, buf.get(),
              (size_t)std::min<int64_t>(want - sent, kPxBufSize));
          if (got <= 0) {
            ::close(up);
            px_stats[2].fetch_add(1, std::memory_order_relaxed);
            if (detail_out) *detail_out = sent;
            return kPxMidStream;
          }
          if (!px_send_client(client_fd, buf.get(), got)) {
            ::close(up);
            if (detail_out) *detail_out = sent;
            return kPxClientGone;
          }
          sent += got;
        }
      }
    }
    if (px_head_keepalive(resp, hdr_end))
      px_checkin(addr, up);
    else
      ::close(up);
    px_stats[0].fetch_add(1, std::memory_order_relaxed);
    px_stats[1].fetch_add((uint64_t)sent, std::memory_order_relaxed);
    return want;
  }
  px_stats[3].fetch_add(1, std::memory_order_relaxed);
  return kPxNoSend;
}

// Cache-tier GET send: relay ``want`` bytes of the (unlinked) chunk-cache
// segment file at ``cache_fd``, starting at ``file_off``, straight to
// ``client_fd`` via sendfile(2), preceded by ``head`` (the response head
// Python built, x-weed-cache marker included).  A warm GET thus never
// copies a byte through CPython and never opens an upstream connection —
// the file side is always ready, so the relay parks only on the client
// socket (a px-loop state machine when the loop is up, a blocking
// sendfile loop otherwise).  Returns ``want`` on success, else
// kPxClientGone with *detail_out = body bytes already out (the caller
// cuts the connection short of Content-Length — same contract as the
// volume-backed GET relay).
int64_t sw_px_cache_send(int cache_fd, int64_t file_off, int64_t want,
                         const uint8_t* head, size_t head_len,
                         int client_fd, int64_t* detail_out) {
  if (detail_out) *detail_out = 0;
  if (head_len && !px_send_client(client_fd, head, head_len)) {
    px_stats[18].fetch_add(1, std::memory_order_relaxed);
    return kPxClientGone;
  }
  int64_t sent = 0;
  PxLoop* lp = px_loop_get();
  int rc = lp != nullptr
               ? px_loop_cache_relay(lp, cache_fd, client_fd, file_off,
                                     want, &sent)
               : px_cache_send_sync(cache_fd, file_off, want, client_fd,
                                    &sent);
  if (rc != 0) {
    if (detail_out) *detail_out = sent;
    px_stats[18].fetch_add(1, std::memory_order_relaxed);
    return kPxClientGone;
  }
  px_stats[16].fetch_add(1, std::memory_order_relaxed);
  px_stats[17].fetch_add((uint64_t)sent, std::memory_order_relaxed);
  return want;
}

// Splice counters: [0] get_ok [1] get_bytes [2] get_midstream
// [3] get_fallback [4-6] legacy (retired sw_px_put) [7] conns_opened
// [8] fanout_ok [9] fanout_bytes [10] fanout_fail [11] fanout_replica_acks
// [12] fanout_ack_wait_ns [13] loop_get_jobs [14] loop_put_jobs
// [15] loop_arm_fail [16] cache_send_ok [17] cache_send_bytes
// [18] cache_send_fail [19] loop_cache_jobs
void sw_px_stats(uint64_t* out) {
  for (int i = 0; i < kPxStatsSlots; i++)
    out[i] = px_stats[i].load(std::memory_order_relaxed);
}

// Close every pooled upstream connection (tests / gateway shutdown).
void sw_px_reset(void) {
  std::lock_guard lk(px_mu);
  for (auto& kv : px_idle)
    for (int fd : kv.second) ::close(fd);
  px_idle.clear();
}

// Which readiness engine drives the body relays (lazy-initializes it):
// kPxLoopUring, kPxLoopEpoll, or kPxLoopOff (per-call blocking relays).
int sw_px_loop_mode(void) {
  PxLoop* lp = px_loop_get();
  return lp != nullptr ? lp->mode : kPxLoopOff;
}

// Stop the loop and forget the cached env decision so the next relay
// re-reads SEAWEEDFS_TPU_PX_LOOP / SEAWEEDFS_TPU_PX_URING — the seam the
// uring-vs-epoll parity tests flip modes through in one process.
//
// The stopped PxLoop (struct, wake/epoll/ring fds, mmaps) is leaked
// INTENTIONALLY, like sw_dp_stop's handle: a relay thread that fetched
// the pointer just before the reset may still touch it (px_loop_submit
// then fails its job against the stop flag instead of dangling), and
// closing the wake fd could hand its recycled number to an unrelated
// socket that the stale submitter would then write into.  Resets happen
// only in tests/gate probes, so the leak is a few fds per process life.
void sw_px_loop_reset(void) {
  PxLoop* lp = nullptr;
  {
    std::lock_guard lk(px_loop_mu);
    lp = px_loop_inst;
    px_loop_inst = nullptr;
    px_loop_inited = false;
  }
  if (lp == nullptr) return;
  {
    // under in_mu: a submitter holding the stale pointer either enqueued
    // before this flip (the final drain below fails its job) or observes
    // stop afterwards and fails it on its own thread
    std::lock_guard lk(lp->in_mu);
    lp->stop.store(true);
  }
  uint64_t one = 1;
  (void)::write(lp->wake_fd, &one, sizeof one);
  if (lp->thr.joinable()) lp->thr.join();
}

// Finalize a carried MD5 midstate copy into a 16-byte digest (the object
// ETag after the last chunk; the state itself stays usable).
void sw_px_md5_digest(const uint8_t* state, uint8_t* out16) {
  Md5 m = md5_from_state(state);
  m.final(out16);
}

// Fold caller-side bytes into a carried midstate: the Python ladder
// replays a chunk the fan-out never consumed, and the object ETag must
// still cover those bytes.
void sw_px_md5_update(uint8_t* state, const uint8_t* data, size_t len) {
  Md5 m = md5_from_state(state);
  m.update(data, len);
  md5_to_state(m, state);
}

// PUT fan-out: stream one client body to every replica holder at once
// and batch their acks into this single native completion.
//
// ``addrs_csv`` is the comma-separated numeric holder list, primary
// first (1..kPxMaxReplicas entries); every peer receives the same
// ``path`` (the caller appends ?type=replicate when fanning to >1 holder
// so no peer re-replicates).  ``initial`` holds body bytes Python's
// buffered reader already consumed; ``sock_rem`` more stream from
// ``client_fd``.  ``md5_state_io`` (Md5State, zeroed = fresh) carries
// the OBJECT-wide digest across the per-chunk calls of a multi-chunk
// PUT; ``md5_out`` gets the finalized cumulative digest.  ``body_out``
// (cap >= sock_rem) retains the socket bytes this call consumed.
//
// Returns the primary's HTTP status (>=100) iff EVERY peer acked 2xx.
// Negative returns:
//   kPxNoSend     no peer reachable / send failed before any client
//                 byte was consumed — fully replayable (pushback)
//   kPxClientGone the client died mid-body (consumed_out set)
//   kPxRetained   the body was FULLY consumed and retained in body_out
//                 but a peer failed or rejected (statuses_out per peer:
//                 HTTP status, kPxMidStream for a mid-stream death, or
//                 kPxNoSend) — the caller replays via the Python ladder,
//                 so an acked write is never lost
// With ``defer_acks`` non-zero a fully-streamed body returns
// kPxAcksDeferred instead of reading the acks: the live peer sockets
// land in ``fds_out`` (kPxMaxReplicas slots, -1 padded) and the caller
// streams its NEXT chunk while these acks ride the wire, settling them
// with sw_px_fanout_collect.  Failures never defer.
int64_t sw_px_put_fanout(const char* addrs_csv, const char* path,
                         const char* extra_headers, const uint8_t* initial,
                         size_t initial_len, int client_fd, int64_t sock_rem,
                         uint8_t* md5_state_io, uint8_t* md5_out,
                         uint8_t* body_out, int64_t body_cap,
                         uint8_t* resp_out, size_t resp_cap,
                         int64_t* resp_len_out, int64_t* statuses_out,
                         int64_t* ack_wait_ns_out, int64_t* consumed_out,
                         int defer_acks, int64_t* fds_out) {
  if (resp_len_out) *resp_len_out = 0;
  if (consumed_out) *consumed_out = 0;
  if (ack_wait_ns_out) *ack_wait_ns_out = 0;
  if (statuses_out)
    for (int i = 0; i < kPxMaxReplicas; i++) statuses_out[i] = kPxNoSend;
  std::vector<std::string> addrs = split_csv(addrs_csv);
  int n = (int)addrs.size();
  int64_t clen = (int64_t)initial_len + sock_rem;
  if (n < 1 || n > kPxMaxReplicas || (sock_rem > 0 && body_cap < sock_rem)) {
    px_stats[10].fetch_add(1, std::memory_order_relaxed);
    return kPxNoSend;  // nothing consumed: the caller falls back whole
  }
  // ---- phase 1: connect + head + initial to every peer (the client
  // socket is untouched, so any failure here is fully replayable)
  std::vector<int> fds(n, -1);
  for (int i = 0; i < n; i++) {
    char req[1024];
    int hl = snprintf(req, sizeof req,
                      "POST %s HTTP/1.1\r\nHost: %s\r\n"
                      "Content-Length: %lld\r\n%s\r\n",
                      path, addrs[i].c_str(), (long long)clen,
                      extra_headers ? extra_headers : "");
    int fd = -1;
    if (hl > 0 && hl < (int)sizeof req)
      fd = fan_connect_send(addrs[i].c_str(), std::string(req, hl), initial,
                            initial_len);
    if (fd < 0) {
      for (int k = 0; k < i; k++) ::close(fds[k]);
      px_stats[10].fetch_add(1, std::memory_order_relaxed);
      if (statuses_out) statuses_out[i] = kPxNoSend;
      return kPxNoSend;
    }
    fds[i] = fd;
  }
  Md5 md5 = md5_from_state(md5_state_io);
  if (initial_len) md5.update(initial, initial_len);
  // ---- phase 2: stream the body client -> every peer
  int64_t consumed = 0;
  int dead_peer = -1;
  int src = 0;
  if (sock_rem > 0) {
    PxLoop* lp = px_loop_get();
    src = lp != nullptr
              ? px_loop_put_stream(lp, client_fd, fds.data(), n, sock_rem,
                                   &md5, body_out, &consumed, &dead_peer)
              : fan_stream_sync(fds.data(), n, client_fd, sock_rem, &md5,
                                body_out, &consumed, &dead_peer);
  }
  if (consumed_out) *consumed_out = consumed;
  if (src == 1) {  // client died: the request is unfulfillable, not retried
    for (int fd : fds) ::close(fd);
    px_stats[10].fetch_add(1, std::memory_order_relaxed);
    return kPxClientGone;
  }
  md5_to_state(md5, md5_state_io);
  if (md5_out) {
    Md5 fin = md5;
    fin.final(md5_out);
  }
  if (src == 2) {  // peer died mid-stream; body retained for the ladder
    if (statuses_out && dead_peer >= 0 && dead_peer < kPxMaxReplicas)
      statuses_out[dead_peer] = kPxMidStream;
    for (int fd : fds) ::close(fd);
    px_stats[10].fetch_add(1, std::memory_order_relaxed);
    return kPxRetained;
  }
  px_stats[9].fetch_add((uint64_t)clen, std::memory_order_relaxed);
  if (defer_acks != 0 && fds_out != nullptr) {
    // the acks pipeline under the NEXT chunk's stream time; the caller
    // owns these sockets until sw_px_fanout_collect settles them
    for (int i = 0; i < kPxMaxReplicas; i++)
      fds_out[i] = i < n ? fds[i] : -1;
    return kPxAcksDeferred;
  }
  // ---- phase 3: batch the replica acks into one completion
  return fan_collect(addrs, fds, resp_out, resp_cap, resp_len_out,
                     statuses_out, ack_wait_ns_out);
}

// Settle a deferred fan-out's acks (fds from sw_px_put_fanout's
// fds_out, -1 padded; addrs_csv must be the SAME holder list).  Returns
// the primary's status iff every peer acked 2xx, else kPxRetained — the
// caller then replays its retained copy of that chunk via the ladder.
int64_t sw_px_fanout_collect(const char* addrs_csv, const int64_t* fds_in,
                             uint8_t* resp_out, size_t resp_cap,
                             int64_t* resp_len_out, int64_t* statuses_out,
                             int64_t* ack_wait_ns_out) {
  if (resp_len_out) *resp_len_out = 0;
  if (ack_wait_ns_out) *ack_wait_ns_out = 0;
  if (statuses_out)
    for (int i = 0; i < kPxMaxReplicas; i++) statuses_out[i] = kPxNoSend;
  std::vector<std::string> addrs = split_csv(addrs_csv);
  std::vector<int> fds;
  for (size_t i = 0; i < addrs.size() && i < (size_t)kPxMaxReplicas; i++)
    fds.push_back((int)fds_in[i]);
  if (fds.size() != addrs.size() || addrs.empty()) {
    for (int fd : fds)
      if (fd >= 0) ::close(fd);
    px_stats[10].fetch_add(1, std::memory_order_relaxed);
    return kPxRetained;
  }
  return fan_collect(addrs, fds, resp_out, resp_cap, resp_len_out,
                     statuses_out, ack_wait_ns_out);
}

// ---- native fid stash: pre-assigned (fid, replica set, auth) entries.
// Push returns 0, or -1 when the stripe is full / inputs oversized (the
// caller keeps its reservation Python-side).  Take returns 0 and fills
// the buffers, or -1 when the bucket is empty (caller assigns anew).
int sw_px_stash_push(uint64_t key, uint32_t stripe, const char* fid,
                     const char* addrs, const char* auth, int64_t ttl_ms) {
  if (fid == nullptr || addrs == nullptr || ttl_ms <= 0) return -1;
  PxStashEntry e;
  e.fid = fid;
  e.addrs = addrs;
  e.auth = auth ? auth : "";
  if (e.fid.size() > 96 || e.addrs.size() > 512 || e.auth.size() > 1024)
    return -1;
  e.expiry_ns = mono_ns() + (uint64_t)ttl_ms * 1000000ull;
  std::lock_guard lk(px_stash_mu);
  auto& bucket = px_stash[key];
  auto& stripe_q = bucket.stripes[stripe % kPxStashStripes];
  if (stripe_q.size() >= kPxStashMaxPerStripe) return -1;
  stripe_q.push_back(std::move(e));
  return 0;
}

int sw_px_stash_take(uint64_t key, char* fid_out, size_t fid_cap,
                     char* addrs_out, size_t addrs_cap, char* auth_out,
                     size_t auth_cap, int64_t* depth_out) {
  if (depth_out) *depth_out = 0;
  uint64_t now = mono_ns();
  std::lock_guard lk(px_stash_mu);
  auto it = px_stash.find(key);
  if (it == px_stash.end()) return -1;
  PxStashBucket& bucket = it->second;
  // round-robin the stripes (each batch = one volume; FIFO would funnel
  // every writer through one volume's serialized appender)
  for (size_t scan = 0; scan < kPxStashStripes; scan++) {
    bucket.rr = (bucket.rr + 1) % kPxStashStripes;
    auto& q = bucket.stripes[bucket.rr];
    while (!q.empty()) {
      PxStashEntry& e = q.front();
      if (e.expiry_ns <= now) {  // expired fids are just unused sequence
        q.pop_front();           // numbers — the volume never saw them
        continue;
      }
      if (e.fid.size() >= fid_cap || e.addrs.size() >= addrs_cap ||
          e.auth.size() >= auth_cap)
        return -1;
      memcpy(fid_out, e.fid.c_str(), e.fid.size() + 1);
      memcpy(addrs_out, e.addrs.c_str(), e.addrs.size() + 1);
      memcpy(auth_out, e.auth.c_str(), e.auth.size() + 1);
      q.pop_front();
      if (depth_out) {
        // approximate remaining (sizes may include not-yet-swept expired
        // entries): O(stripes), cheap enough for the per-take low-water
        // check — the exact walk stays in sw_px_stash_depth for tests
        int64_t remaining = 0;
        for (auto& sq : bucket.stripes) remaining += (int64_t)sq.size();
        *depth_out = remaining;
      }
      return 0;
    }
  }
  return -1;
}

int64_t sw_px_stash_depth(uint64_t key) {
  uint64_t now = mono_ns();
  std::lock_guard lk(px_stash_mu);
  auto it = px_stash.find(key);
  if (it == px_stash.end()) return 0;
  int64_t depth = 0;
  for (auto& q : it->second.stripes)
    for (auto& e : q)
      if (e.expiry_ns > now) depth++;
  return depth;
}

void sw_px_stash_clear(void) {
  std::lock_guard lk(px_stash_mu);
  px_stash.clear();
}

}  // extern "C"

namespace {

// --------------------------------------------------------------- conn loop
void handle_conn(Dp* dp, int cfd) {
  Conn c;
  c.dp = dp;
  c.fd = cfd;
  set_sock_opts(cfd);
  dp->stats[7].fetch_add(1, std::memory_order_relaxed);
  std::vector<char> buf(kMaxHeaderBytes);
  size_t have = 0;
  for (;;) {
    // read until a full request head is buffered
    Req r;
    for (;;) {
      if (have >= 4 &&
          memmem(buf.data(), have, "\r\n\r\n", 4) != nullptr &&
          parse_request(buf.data(), have, &r))
        break;
      if (have >= kMaxHeaderBytes) return;
      ssize_t n = recv_some(cfd, buf.data() + have, kMaxHeaderBytes - have);
      if (n <= 0) return;  // idle close / timeout / reset
      have += n;
    }
    if (r.expect_continue) {
      if (!send_full(cfd, "HTTP/1.1 100 Continue\r\n\r\n", 25)) return;
    }
    // service-time clock starts once the full head is buffered (client
    // dribble is not this loop's latency); wall time seeds trace spans
    struct timespec mono0, wall0;
    clock_gettime(CLOCK_MONOTONIC, &mono0);
    clock_gettime(CLOCK_REALTIME, &wall0);
    int verb = kVerbForward;
    uint32_t trace_vid = 0;
    bool keep = false;
    if (r.method == "GET" || r.method == "HEAD") {
      // shared read guards: no query (resize/readDeleted are Python's),
      // no body (forward so it gets drained), parseable fid — parsed ONCE
      bool handled = false;
      if (r.query.empty() &&
          !(r.has_content_length && r.content_length > 0)) {
        Fid f = parse_fid(r.target);
        if (f.ok) {
          handled = try_native_get(&c, r, f, &keep) ||
                    try_native_ec_get(&c, r, f, &keep);
          if (handled) { verb = kVerbGet; trace_vid = f.vid; }
        }
      }
      if (!handled)
        keep = forward(&c, r, buf.data(), have);
    } else if (r.method == "POST" || r.method == "PUT") {
      // native iff: fid parses, volume registered+writable, no JWT needed,
      // single-copy or an incoming replica write, understood query params
      Fid f = parse_fid(r.target);
      bool native = false;
      bool compressed_marker = false;
      bool is_replicate = false;
      std::shared_ptr<Vol> vol;
      if (f.ok && !dp->jwt_required && r.has_content_length && !r.chunked &&
          r.content_length <= kMaxNativeBody &&
          dp->upload_inflight.load(std::memory_order_relaxed) +
                  r.content_length <=
              kMaxNativeBody) {
        vol = dp->find(f.vid);
        if (vol && !vol->read_only.load(std::memory_order_relaxed)) {
          static const char* kKeys[] = {"type", "compressed", "compress", "name"};
          std::string vals[4];
          if (scan_query(r.query, kKeys, 4, vals)) {
            bool repl = vals[0] == "replicate";
            if ((vals[0].empty() || repl) && fanout_ready(vol.get(), repl)) {
              // compress-on-write candidates go to Python, which owns
              // the gzip heuristic (needle_parse_upload.go:76-81 parity)
              bool compressible =
                  !repl && vals[2] != "false" &&
                  may_compress_on_write(r.ctype, vals[3],
                                        r.content_length);
              if (!compressible) {
                native = true;
                is_replicate = repl;
                compressed_marker = repl && vals[1] == "true";
              }
            }
          }
        }
      }
      if (native) {
        verb = kVerbPost;
        trace_vid = f.vid;
        keep = native_post(&c, r, vol, f, compressed_marker, is_replicate,
                           buf.data(), have);
      } else {
        keep = forward(&c, r, buf.data(), have);
      }
    } else if (r.method == "DELETE") {
      // same routing contract as POST: single-copy or replica-side,
      // no JWT, understood query, no body
      Fid f = parse_fid(r.target);
      std::shared_ptr<Vol> vol;
      bool native = false;
      bool is_replicate = false;
      if (f.ok && !dp->jwt_required && !r.chunked &&
          (!r.has_content_length || r.content_length == 0)) {
        vol = dp->find(f.vid);
        if (vol && !vol->read_only.load(std::memory_order_relaxed)) {
          static const char* kKeys[] = {"type"};
          std::string vals[1];
          if (scan_query(r.query, kKeys, 1, vals)) {
            is_replicate = vals[0] == "replicate";
            if ((vals[0].empty() || is_replicate) &&
                fanout_ready(vol.get(), is_replicate))
              native = true;
          }
        }
      }
      if (native) {
        verb = kVerbDelete;
        trace_vid = f.vid;
        keep = native_delete(&c, r, vol, f, is_replicate, buf.data(), have);
      } else {
        keep = forward(&c, r, buf.data(), have);
      }
    } else {
      keep = forward(&c, r, buf.data(), have);
    }
    {
      struct timespec mono1;
      clock_gettime(CLOCK_MONOTONIC, &mono1);
      uint64_t dur_ns =
          (uint64_t)(mono1.tv_sec - mono0.tv_sec) * 1000000000ull +
          (uint64_t)(mono1.tv_nsec - mono0.tv_nsec);
      dp->observe(verb, dur_ns);
      if (verb != kVerbForward && !r.traceparent.empty()) {
        // natively-served traced request: record a span for Python to
        // fold (forwards carry their header to the Python server, which
        // spans them itself)
        TraceRec t{};
        if (parse_traceparent_ids(r.traceparent, t.trace_id, t.parent_id)) {
          t.verb = (uint8_t)verb;
          t.vid = trace_vid;
          t.start_unix_ns =
              (uint64_t)wall0.tv_sec * 1000000000ull + wall0.tv_nsec;
          t.dur_ns = dur_ns;
          dp->push_trace(t);
        }
      }
    }
    if (!keep) return;
    // slide any pipelined bytes of the next request to the front
    size_t consumed = r.header_len;
    if (r.has_content_length && r.content_length > 0) {
      size_t body_buffered = have - r.header_len;
      consumed += std::min<size_t>(body_buffered, (size_t)r.content_length);
    }
    memmove(buf.data(), buf.data() + consumed, have - consumed);
    have -= consumed;
  }
}

void accept_loop(Dp* dp) {
  for (;;) {
    struct sockaddr_in peer;
    socklen_t plen = sizeof peer;
    int cfd = ::accept4(dp->listen_fd, (struct sockaddr*)&peer, &plen,
                        SOCK_CLOEXEC);
    if (cfd < 0) {
      if (errno == EINTR) continue;
      return;  // listener closed: shutting down
    }
    if (dp->stopping.load(std::memory_order_relaxed)) {
      ::close(cfd);
      return;
    }
    try {
      std::thread(handle_conn, dp, cfd).detach();
    } catch (const std::system_error&) {
      // thread exhaustion (EAGAIN) must shed the connection, not
      // std::terminate the whole process
      ::close(cfd);
    }
  }
}

}  // namespace

// ------------------------------------------------------------------ C API
extern "C" {

void* sw_dp_create(const char* bind_ip, int port, int jwt_required) {
  int fd = ::socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  struct sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_port = htons(port);
  if (inet_pton(AF_INET, bind_ip, &sa.sin_addr) != 1) {
    ::close(fd);
    return nullptr;
  }
  if (::bind(fd, (struct sockaddr*)&sa, sizeof sa) != 0 ||
      ::listen(fd, 512) != 0) {
    ::close(fd);
    return nullptr;
  }
  auto* dp = new Dp();
  dp->listen_fd = fd;
  dp->jwt_required = jwt_required != 0;
  socklen_t slen = sizeof sa;
  getsockname(fd, (struct sockaddr*)&sa, &slen);
  dp->port = ntohs(sa.sin_port);
  return dp;
}

int sw_dp_port(void* h) { return ((Dp*)h)->port; }

int sw_dp_start(void* h, int upstream_port) {
  Dp* dp = (Dp*)h;
  dp->upstream_port = upstream_port;
  dp->accept_thread = std::thread(accept_loop, dp);
  return 0;
}

// Stop accepting.  Existing connection threads drain on their own (socket
// timeouts bound their life); the handle itself is leaked intentionally —
// volume fds are refcounted by shared_ptr so unregister is still safe.
void sw_dp_stop(void* h) {
  Dp* dp = (Dp*)h;
  dp->stopping.store(true);
  ::shutdown(dp->listen_fd, SHUT_RDWR);
  ::close(dp->listen_fd);
  if (dp->accept_thread.joinable()) dp->accept_thread.join();
  {
    std::unique_lock lk(dp->vols_mu);
    dp->vols.clear();
  }
  std::unique_lock elk(dp->ec_mu);
  dp->ec_vols.clear();
}

int sw_dp_register_volume(void* h, uint32_t vid, const char* dat_path,
                          const char* idx_path, int version, int copy_count,
                          int read_only, int offset_width) {
  if (version < 2 || version > 3) return -1;
  if (offset_width != 4 && offset_width != 5) return -1;
  Dp* dp = (Dp*)h;
  int dat_fd = ::open(dat_path, O_RDWR | O_CLOEXEC);
  if (dat_fd < 0) return -1;
  int idx_fd = ::open(idx_path, O_WRONLY | O_APPEND | O_CREAT | O_CLOEXEC, 0644);
  if (idx_fd < 0) {
    ::close(dat_fd);
    return -1;
  }
  struct stat st;
  if (fstat(dat_fd, &st) != 0 || (st.st_size % kPad) != 0) {
    ::close(dat_fd);
    ::close(idx_fd);
    return -1;
  }
  auto vol = std::make_shared<Vol>();
  vol->vid = vid;
  vol->dat_fd = dat_fd;
  vol->idx_fd = idx_fd;
  vol->version = version;
  vol->offset_width = offset_width;
  vol->copy_count = copy_count;
  vol->read_only = read_only != 0;
  vol->end = st.st_size;
  vol->last_ns = (uint64_t)st.st_mtim.tv_sec * 1000000000ull + st.st_mtim.tv_nsec;
  std::unique_lock lk(dp->vols_mu);
  dp->vols[vid] = vol;  // replaces (re-register after vacuum); stays
                        // unroutable until sw_dp_activate_volume
  return 0;
}

// Flip a staged registration live once its key map is fully loaded — before
// this, a GET would 404 on data that exists and a racing native POST could
// be overwritten by the stale bulk load.
void sw_dp_activate_volume(void* h, uint32_t vid) {
  Dp* dp = (Dp*)h;
  auto vol = dp->find_any(vid);
  if (vol) vol->active.store(true, std::memory_order_release);
}

void sw_dp_unregister_volume(void* h, uint32_t vid) {
  Dp* dp = (Dp*)h;
  std::shared_ptr<Vol> vol;
  {
    std::unique_lock lk(dp->vols_mu);
    auto it = dp->vols.find(vid);
    if (it == dp->vols.end()) return;
    vol = it->second;
    dp->vols.erase(it);
  }
  // fence: any append that already held a reference either finished before
  // this lock or observes closed and falls back to the Python server
  std::lock_guard lk(vol->append_mu);
  vol->closed = true;
}

void sw_dp_set_volume_flags(void* h, uint32_t vid, int read_only,
                            int copy_count) {
  Dp* dp = (Dp*)h;
  auto vol = dp->find_any(vid);
  if (!vol) return;
  vol->read_only.store(read_only != 0);
  vol->copy_count.store(copy_count);
}

// Comma-separated peer public addresses holding the other copies of a
// replicated volume (Python resolves via the master and refreshes with a
// TTL); empty clears — primary writes then forward until re-resolved.
void sw_dp_set_replicas(void* h, uint32_t vid, const char* csv) {
  Dp* dp = (Dp*)h;
  auto vol = dp->find_any(vid);
  if (!vol) return;
  std::vector<std::string> reps = split_csv(csv);
  std::unique_lock lk(vol->rep_mu);
  vol->replicas = std::move(reps);
}

int sw_dp_put_many(void* h, uint32_t vid, const uint64_t* keys,
                   const uint64_t* offsets, const int32_t* sizes, size_t n) {
  Dp* dp = (Dp*)h;
  auto vol = dp->find_any(vid);  // bulk load happens pre-activation
  if (!vol) return -1;
  std::unique_lock lk(vol->map_mu);
  vol->map.reserve(vol->map.size() + n);
  for (size_t i = 0; i < n; i++) {
    if (sizes[i] > 0)  // size-0/tombstoned entries are not servable
      vol->map[keys[i]] = Entry{(int64_t)offsets[i], sizes[i]};
  }
  return 0;
}

// Append a prebuilt record from Python (one shared implementation:
// locked_append).  map_size >= 0 is a put (a size-0 put — empty-data
// needle — gets its idx entry but is NOT servable, so it leaves the
// native map); map_size < 0 is a tombstone.  Emits an event like every
// other append: for dp-attached volumes ALL Python-side map state is
// folded from the single event stream, whose order (guarded by
// append_mu) matches .dat order.  Returns the offset; -1 when the
// volume is unavailable here (unregistered/closed — the caller may
// safely append through its own fd instead, nothing was written); -2 on
// an IO failure or misaligned end (partial bytes may sit past end — the
// caller must NOT append elsewhere); -3 when a tombstone's key is
// already absent (a concurrent delete won; nothing was written).
int64_t sw_dp_append(void* h, uint32_t vid, uint64_t key, int32_t map_size,
                     const uint8_t* record, size_t len) {
  Dp* dp = (Dp*)h;
  auto vol = dp->find(vid);
  if (!vol) return -1;
  return locked_append(dp, vol.get(), key, map_size,
                       const_cast<uint8_t*>(record), len,
                       /*stamp_ts=*/false, /*emit_event=*/true);
}

// Register a mounted EC volume for native local-shard reads.
// ``locate_shard_size`` is the geometry input the Python EcVolume uses
// (dat_file_size / k when the .vif is present, else shard size - 1).
int sw_dp_register_ec_volume(void* h, uint32_t vid, const char* ecx_path,
                             int version, int offset_width, int data_shards,
                             int parity_shards, int64_t large_block,
                             int64_t small_block,
                             int64_t locate_shard_size) {
  if (version < 2 || version > 3) return -1;
  if (offset_width != 4 && offset_width != 5) return -1;
  if (data_shards <= 0 || parity_shards <= 0 || locate_shard_size <= 0)
    return -1;
  Dp* dp = (Dp*)h;
  int fd = ::open(ecx_path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return -1;
  }
  auto ev = std::make_shared<EcVol>();
  ev->vid = vid;
  ev->ecx_fd = fd;
  ev->version = version;
  ev->offset_width = offset_width;
  ev->entry_size = 8 + offset_width + 4;
  ev->k = data_shards;
  ev->total = data_shards + parity_shards;
  ev->large_block = large_block;
  ev->small_block = small_block;
  ev->locate_shard_size = locate_shard_size;
  ev->ecx_entries = st.st_size / ev->entry_size;
  ev->shard_fds.assign(ev->total, -1);
  std::unique_lock lk(dp->ec_mu);
  dp->ec_vols[vid] = ev;  // replaces on re-mount
  return 0;
}

// Attach/detach one LOCAL shard file (path == "" or NULL detaches).
int sw_dp_ec_set_shard(void* h, uint32_t vid, int shard_id,
                       const char* path) {
  Dp* dp = (Dp*)h;
  auto ev = dp->find_ec(vid);
  if (!ev || shard_id < 0 || shard_id >= ev->total) return -1;
  int fd = -1;
  if (path != nullptr && path[0] != '\0') {
    fd = ::open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return -1;
  }
  {
    // unique lock waits out in-flight readers (they hold the shared
    // lock across their preads); closing inside it is then safe
    std::unique_lock lk(ev->shard_mu);
    int old = ev->shard_fds[shard_id];
    ev->shard_fds[shard_id] = fd;
    if (old >= 0) ::close(old);
  }
  return 0;
}

void sw_dp_unregister_ec_volume(void* h, uint32_t vid) {
  Dp* dp = (Dp*)h;
  std::unique_lock lk(dp->ec_mu);
  dp->ec_vols.erase(vid);  // shared_ptr keeps fds alive for in-flight reads
}

size_t sw_dp_drain_events(void* h, uint8_t* out, size_t cap_bytes) {
  Dp* dp = (Dp*)h;
  size_t cap = cap_bytes / sizeof(Event);
  std::lock_guard lk(dp->ev_mu);
  size_t n = std::min(cap, dp->events.size());
  for (size_t i = 0; i < n; i++) {
    memcpy(out + i * sizeof(Event), &dp->events.front(), sizeof(Event));
    dp->events.pop_front();
  }
  return n;
}

uint64_t sw_dp_events_lost(void* h) { return ((Dp*)h)->events_lost.load(); }

// out must hold 9 u64s: the 8 aggregate slots plus [8] = trace records
// dropped on ring overflow (operators must be able to see that a trace
// is incomplete because spans were shed, not because hops went dark).
void sw_dp_stats(void* h, uint64_t* out8) {
  Dp* dp = (Dp*)h;
  for (int i = 0; i < 8; i++) out8[i] = dp->stats[i].load();
  out8[8] = dp->traces_lost.load(std::memory_order_relaxed);
}

// Per-verb request metrics snapshot.  Layout (u64s), per verb in order
// get/post/delete/forward: [count, sum_ns, bucket_0 .. bucket_13] where
// buckets are NON-cumulative counts over kLatencyBoundsNs + overflow —
// kNVerbs * kMetricsPerVerb (= 64) u64 total.  Python renders these as
// Prometheus cumulative-le histograms (dataplane.metrics_snapshot).
void sw_dp_metrics(void* h, uint64_t* out) {
  Dp* dp = (Dp*)h;
  size_t at = 0;
  for (int v = 0; v < kNVerbs; v++) {
    VerbMetrics& m = dp->verb_metrics[v];
    out[at++] = m.count.load(std::memory_order_relaxed);
    out[at++] = m.sum_ns.load(std::memory_order_relaxed);
    for (int b = 0; b <= kNLatencyBounds; b++)
      out[at++] = m.buckets[b].load(std::memory_order_relaxed);
  }
}

// Drain up to cap_bytes/sizeof(TraceRec) native span records; returns
// the record count (dataplane.py drains on the event-drainer cadence).
size_t sw_dp_trace_drain(void* h, uint8_t* out, size_t cap_bytes) {
  Dp* dp = (Dp*)h;
  size_t cap = cap_bytes / sizeof(TraceRec);
  std::lock_guard lk(dp->tr_mu);
  size_t n = std::min(cap, dp->trace_recs.size());
  for (size_t i = 0; i < n; i++) {
    memcpy(out + i * sizeof(TraceRec), &dp->trace_recs.front(),
           sizeof(TraceRec));
    dp->trace_recs.pop_front();
  }
  return n;
}

}  // extern "C"
