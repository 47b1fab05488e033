// veneur_tpu native ingest data plane.
//
// The TPU-native counterpart of the reference's edge hot path — the
// SO_REUSEPORT multi-reader socket loop (networking.go:54-107,
// socket_linux.go:12-73), the zero-alloc DogStatsD byte parser
// (samplers/parser.go:349-503), and the fnv1a-sharded worker channels
// (server.go:997-1011, worker.go:34-50).  Where the reference fans parsed
// metrics out to per-key Go objects, this engine *stages batches*: the
// parser interns each (name, type, raw-tags) identity to a dense u32 id and
// appends (id, value) records to per-thread columnar buffers.  Python
// drains the buffers on a coarse cadence and applies them to the arenas
// with a handful of vectorized numpy/XLA calls — no per-metric Python, no
// per-metric lock.
//
// Layout:
//   * Engine        — intern table (sharded), thread buffers, reader threads
//   * tokenizer     — delimiter scan: memchr (scalar) or one SSE2/AVX2
//                     wide-compare pass per datagram (runtime-selected)
//   * parse_line    — DogStatsD metric lines (events/service checks and
//                     anything malformed are punted/counted; the Python
//                     parser remains the semantic reference)
//   * metro64       — MetroHash64 (public domain algorithm, J. A. Mettes) so
//                     set members land on the same HLL registers as
//                     axiomhq/hyperloglog (wire + register interop)
//   * SPSC rings    — per-reader staging handoff; a drain tick pops
//                     published batches lock-free and never stalls a
//                     reader mid-burst (only the rare intern-GC quiesces)
//   * receive       — recvmmsg loop, or io_uring multishot receive where
//                     the kernel/seccomp profile permits (runtime-probed)
//   * drain ABI     — consolidation into contiguous arrays for ctypes
//   * vn_blast_udp  — sendmmsg packet generator for the ingest benchmark
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread -o libvningest.so
//
// C ABI only; Python binds with ctypes (no pybind11 in the image).

#include <atomic>
#include <algorithm>
#include <cerrno>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <poll.h>
#include <pthread.h>
#include <sched.h>
#include <sys/socket.h>
#include <sys/types.h>
#include <unistd.h>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

// io_uring multishot-receive backend: raw syscalls against the uapi
// header (no liburing in the image).  Multishot recv + provided buffer
// rings need kernel >= 6.0 at RUNTIME (probed; seccomp-blocked or old
// kernels fall back to recvmmsg), and the uapi header in the image may
// predate them — those constants/structs are ABI-frozen, so the missing
// ones are self-defined below rather than compiled out.
#if defined(__linux__) && __has_include(<linux/io_uring.h>)
#include <linux/io_uring.h>
#if __has_include(<linux/time_types.h>)
#include <linux/time_types.h>
#endif
#include <sys/mman.h>
#include <sys/syscall.h>
#include <csignal>
#if defined(IOSQE_BUFFER_SELECT) && defined(IORING_FEAT_EXT_ARG) && \
    defined(IORING_ENTER_EXT_ARG) && defined(IORING_CQE_F_MORE)
#define VN_HAVE_IOURING 1
// uapi additions newer than the image's header (values are kernel ABI)
#ifndef IORING_RECV_MULTISHOT
#define IORING_RECV_MULTISHOT (1U << 1)  // sqe->ioprio flag, 6.0+
#endif
// VN_UAPI_HAS_PBUF_RING: 1 when the header declares the provided-buffer
// ring ABI below, as macros or as enum constants (which #ifndef cannot
// see); the build's probe passes it, else the macro test decides
#ifndef VN_UAPI_HAS_PBUF_RING
#ifdef IORING_REGISTER_PBUF_RING
#define VN_UAPI_HAS_PBUF_RING 1
#else
#define VN_UAPI_HAS_PBUF_RING 0
#endif
#endif
#if !VN_UAPI_HAS_PBUF_RING
#define IORING_REGISTER_PBUF_RING 22     // 5.19+
#define IORING_UNREGISTER_PBUF_RING 23
struct io_uring_buf {
  __u64 addr;
  __u32 len;
  __u16 bid;
  __u16 resv;
};
struct io_uring_buf_ring {
  union {
    struct {
      __u64 resv1;
      __u32 resv2;
      __u16 resv3;
      __u16 tail;
    };
    struct io_uring_buf bufs[0];
  };
};
struct io_uring_buf_reg {
  __u64 ring_addr;
  __u32 ring_entries;
  __u16 bgid;
  __u16 flags;
  __u64 resv[3];
};
#else
// The header's own io_uring_buf_ring declares `bufs` with
// __DECLARE_FLEX_ARRAY, which headers before linux 6.x expand, in C++,
// behind a one-byte empty struct: `bufs` would start at offset 8 where
// the kernel reads the ring at offset 0.  Use the ABI's layout under a
// name of the engine's own.
struct vn_io_uring_buf_ring {
  union {
    struct {
      __u64 resv1;
      __u32 resv2;
      __u16 resv3;
      __u16 tail;
    };
    struct io_uring_buf bufs[0];
  };
};
#define io_uring_buf_ring vn_io_uring_buf_ring
#endif  // !VN_UAPI_HAS_PBUF_RING
static_assert(offsetof(io_uring_buf_ring, bufs) == 0,
              "the kernel reads the buffer ring's bufs[0] at offset 0");
#endif
#endif

namespace {

// ---------------------------------------------------------------------------
// Hashing
// ---------------------------------------------------------------------------

static inline uint64_t rotr64(uint64_t x, int r) {
  return (x >> r) | (x << (64 - r));
}

static inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86/arm LE), same as go-metro
}
static inline uint64_t rd32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
static inline uint64_t rd16(const uint8_t* p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}

// MetroHash64 with axiomhq's member seed (1337): a set member hashed here
// hits the same register/rank as one hashed by a real veneur
// (veneur_tpu/sketches/hll.py hash64 is the scalar twin).
static uint64_t metro64(const uint8_t* ptr, size_t len, uint64_t seed) {
  static const uint64_t k0 = 0xD6D018F5, k1 = 0xA2AA033B, k2 = 0x62992FC1,
                        k3 = 0x30BC5B29;
  const uint8_t* end = ptr + len;
  uint64_t h = (seed + k2) * k0;
  if (len >= 32) {
    uint64_t v0 = h, v1 = h, v2 = h, v3 = h;
    while (end - ptr >= 32) {
      v0 += rd64(ptr) * k0;      v0 = rotr64(v0, 29) + v2;
      v1 += rd64(ptr + 8) * k1;  v1 = rotr64(v1, 29) + v3;
      v2 += rd64(ptr + 16) * k2; v2 = rotr64(v2, 29) + v0;
      v3 += rd64(ptr + 24) * k3; v3 = rotr64(v3, 29) + v1;
      ptr += 32;
    }
    v2 ^= rotr64((v0 + v3) * k0 + v1, 37) * k1;
    v3 ^= rotr64((v1 + v2) * k1 + v0, 37) * k0;
    v0 ^= rotr64((v0 + v2) * k0 + v3, 37) * k1;
    v1 ^= rotr64((v1 + v3) * k1 + v2, 37) * k0;
    h += v0 ^ v1;
  }
  if (end - ptr >= 16) {
    uint64_t v0 = h + rd64(ptr) * k2;     v0 = rotr64(v0, 29) * k3;
    uint64_t v1 = h + rd64(ptr + 8) * k2; v1 = rotr64(v1, 29) * k3;
    ptr += 16;
    v0 ^= rotr64(v0 * k0, 21) + v1;
    v1 ^= rotr64(v1 * k3, 21) + v0;
    h += v1;
  }
  if (end - ptr >= 8) { h += rd64(ptr) * k3; ptr += 8; h ^= rotr64(h, 55) * k1; }
  if (end - ptr >= 4) { h += rd32(ptr) * k3; ptr += 4; h ^= rotr64(h, 26) * k1; }
  if (end - ptr >= 2) { h += rd16(ptr) * k3; ptr += 2; h ^= rotr64(h, 48) * k1; }
  if (end - ptr >= 1) { h += *ptr * k3; h ^= rotr64(h, 37) * k1; }
  h ^= rotr64(h, 28);
  h *= k0;
  h ^= rotr64(h, 29);
  return h;
}

// ---------------------------------------------------------------------------
// Intern-key hash (internal only): lane-structured so it vectorizes.
//
// Four independent u64 lanes consume 32-byte blocks with add/rotate/xor
// only — SSE2 has no 64-bit multiply, so all multiplicative diffusion is
// deferred to the scalar finalizer.  The scalar, SSE2 and AVX2 bodies
// compute the IDENTICAL function: an engine resolves ONE mode at
// creation, but identities hashed under different modes (parity tests,
// a fleet mid-rollout of a simd override) must intern to the same shard
// and thread-cache slot, so mode must never be observable in the value.
// ---------------------------------------------------------------------------

static const uint64_t kKH0 = 0x9E3779B97F4A7C15ull;  // golden-ratio odd mixers
static const uint64_t kKH1 = 0xC2B2AE3D27D4EB4Full;
static const uint64_t kKH2 = 0x165667B19E3779F9ull;
static const uint64_t kKH3 = 0x27D4EB2F165667C5ull;

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t kh_finish(uint64_t l0, uint64_t l1, uint64_t l2,
                                 uint64_t l3, size_t n) {
  uint64_t h = (uint64_t)n * kKH0;
  h = (h ^ l0) * kKH1; h ^= h >> 29;
  h = (h ^ l1) * kKH2; h ^= h >> 31;
  h = (h ^ l2) * kKH3; h ^= h >> 30;
  h = (h ^ l3) * kKH0; h ^= h >> 32;
  h *= kKH1;
  h ^= h >> 29;
  return h;
}

// One block step per lane; the trailing partial block is zero-padded
// (length is folded into the finalizer, so padding cannot alias).
static inline void kh_lane(uint64_t& l, uint64_t x) {
  l += x;
  l ^= rotl64(l, 13);
  l += rotl64(l, 31);
}

static uint64_t key_hash_scalar(const char* p, size_t n) {
  uint64_t l0 = kKH0, l1 = kKH1, l2 = kKH2, l3 = kKH3;
  const uint8_t* q = (const uint8_t*)p;
  size_t nb = n / 32;
  for (size_t b = 0; b < nb; b++, q += 32) {
    kh_lane(l0, rd64(q));
    kh_lane(l1, rd64(q + 8));
    kh_lane(l2, rd64(q + 16));
    kh_lane(l3, rd64(q + 24));
  }
  if (n % 32) {
    uint8_t tail[32] = {0};
    memcpy(tail, q, n % 32);
    kh_lane(l0, rd64(tail));
    kh_lane(l1, rd64(tail + 8));
    kh_lane(l2, rd64(tail + 16));
    kh_lane(l3, rd64(tail + 24));
  }
  return kh_finish(l0, l1, l2, l3, n);
}

#if defined(__x86_64__)

static inline __m128i kh_rot128(__m128i v, int r) {
  return _mm_or_si128(_mm_slli_epi64(v, r), _mm_srli_epi64(v, 64 - r));
}

static inline void kh_lane128(__m128i& l, __m128i x) {
  l = _mm_add_epi64(l, x);
  l = _mm_xor_si128(l, kh_rot128(l, 13));
  l = _mm_add_epi64(l, kh_rot128(l, 31));
}

static uint64_t key_hash_sse2(const char* p, size_t n) {
  __m128i a = _mm_set_epi64x((long long)kKH1, (long long)kKH0);  // l1:l0
  __m128i b = _mm_set_epi64x((long long)kKH3, (long long)kKH2);  // l3:l2
  const uint8_t* q = (const uint8_t*)p;
  size_t nb = n / 32;
  for (size_t blk = 0; blk < nb; blk++, q += 32) {
    kh_lane128(a, _mm_loadu_si128((const __m128i*)q));
    kh_lane128(b, _mm_loadu_si128((const __m128i*)(q + 16)));
  }
  if (n % 32) {
    uint8_t tail[32] = {0};
    memcpy(tail, q, n % 32);
    kh_lane128(a, _mm_loadu_si128((const __m128i*)tail));
    kh_lane128(b, _mm_loadu_si128((const __m128i*)(tail + 16)));
  }
  uint64_t l0 = (uint64_t)_mm_cvtsi128_si64(a);
  uint64_t l1 = (uint64_t)_mm_cvtsi128_si64(_mm_srli_si128(a, 8));
  uint64_t l2 = (uint64_t)_mm_cvtsi128_si64(b);
  uint64_t l3 = (uint64_t)_mm_cvtsi128_si64(_mm_srli_si128(b, 8));
  return kh_finish(l0, l1, l2, l3, n);
}

__attribute__((target("avx2")))
static inline __m256i kh_step256(__m256i l, const uint8_t* src) {
  __m256i x = _mm256_loadu_si256((const __m256i*)src);
  l = _mm256_add_epi64(l, x);
  __m256i r13 = _mm256_or_si256(_mm256_slli_epi64(l, 13),
                                _mm256_srli_epi64(l, 51));
  l = _mm256_xor_si256(l, r13);
  __m256i r31 = _mm256_or_si256(_mm256_slli_epi64(l, 31),
                                _mm256_srli_epi64(l, 33));
  return _mm256_add_epi64(l, r31);
}

__attribute__((target("avx2")))
static uint64_t key_hash_avx2(const char* p, size_t n) {
  __m256i l = _mm256_set_epi64x((long long)kKH3, (long long)kKH2,
                                (long long)kKH1, (long long)kKH0);
  const uint8_t* q = (const uint8_t*)p;
  size_t nb = n / 32;
  for (size_t blk = 0; blk < nb; blk++, q += 32) l = kh_step256(l, q);
  if (n % 32) {
    uint8_t tail[32] = {0};
    memcpy(tail, q, n % 32);
    l = kh_step256(l, tail);
  }
  alignas(32) uint64_t lanes[4];
  _mm256_store_si256((__m256i*)lanes, l);
  return kh_finish(lanes[0], lanes[1], lanes[2], lanes[3], n);
}

#endif  // __x86_64__

typedef uint64_t (*key_hash_fn)(const char*, size_t);

// ---------------------------------------------------------------------------
// Vectorized DogStatsD tokenizer
// ---------------------------------------------------------------------------
//
// One wide-compare pass per datagram records the positions of the three
// structural delimiters the parser queries ('\n' line split, ':' name/
// value split, '|' chunk split) into per-class sorted arrays; the parser
// then consumes positions through monotone cursors instead of re-running
// memchr over the same bytes.  The ',' tag split and '#'/'@' chunk leads
// stay byte-compares in the parser: ',' is only walked on an intern MISS
// (cold), and the leads are single-byte tests.

struct TokenIndex {
  std::vector<uint32_t> nl, co, pi;  // '\n', ':', '|' positions (ascending)
  size_t inl = 0, ico = 0, ipi = 0;  // per-class cursors

  void reset() {
    nl.clear(); co.clear(); pi.clear();
    inl = ico = ipi = 0;
  }
};

typedef void (*scan_tokens_fn)(const uint8_t*, size_t, TokenIndex&);

static inline void scan_byte(uint8_t c, uint32_t i, TokenIndex& ti) {
  if (c == '\n') ti.nl.push_back(i);
  else if (c == ':') ti.co.push_back(i);
  else if (c == '|') ti.pi.push_back(i);
}

// Scalar twin of the SIMD scanners (parity reference + non-x86 hosts).
static void scan_tokens_scalar(const uint8_t* p, size_t n, TokenIndex& ti) {
  for (size_t i = 0; i < n; i++) scan_byte(p[i], (uint32_t)i, ti);
}

#if defined(__x86_64__)

static void scan_tokens_sse2(const uint8_t* p, size_t n, TokenIndex& ti) {
  const __m128i vnl = _mm_set1_epi8('\n');
  const __m128i vco = _mm_set1_epi8(':');
  const __m128i vpi = _mm_set1_epi8('|');
  size_t i = 0;
  for (; i + 16 <= n; i += 16) {
    __m128i x = _mm_loadu_si128((const __m128i*)(p + i));
    uint32_t mnl = (uint32_t)_mm_movemask_epi8(_mm_cmpeq_epi8(x, vnl));
    uint32_t mco = (uint32_t)_mm_movemask_epi8(_mm_cmpeq_epi8(x, vco));
    uint32_t mpi = (uint32_t)_mm_movemask_epi8(_mm_cmpeq_epi8(x, vpi));
    while (mnl) { ti.nl.push_back((uint32_t)(i + __builtin_ctz(mnl))); mnl &= mnl - 1; }
    while (mco) { ti.co.push_back((uint32_t)(i + __builtin_ctz(mco))); mco &= mco - 1; }
    while (mpi) { ti.pi.push_back((uint32_t)(i + __builtin_ctz(mpi))); mpi &= mpi - 1; }
  }
  for (; i < n; i++) scan_byte(p[i], (uint32_t)i, ti);
}

__attribute__((target("avx2")))
static void scan_tokens_avx2(const uint8_t* p, size_t n, TokenIndex& ti) {
  const __m256i vnl = _mm256_set1_epi8('\n');
  const __m256i vco = _mm256_set1_epi8(':');
  const __m256i vpi = _mm256_set1_epi8('|');
  size_t i = 0;
  for (; i + 32 <= n; i += 32) {
    __m256i x = _mm256_loadu_si256((const __m256i*)(p + i));
    uint32_t mnl = (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(x, vnl));
    uint32_t mco = (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(x, vco));
    uint32_t mpi = (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(x, vpi));
    while (mnl) { ti.nl.push_back((uint32_t)(i + __builtin_ctz(mnl))); mnl &= mnl - 1; }
    while (mco) { ti.co.push_back((uint32_t)(i + __builtin_ctz(mco))); mco &= mco - 1; }
    while (mpi) { ti.pi.push_back((uint32_t)(i + __builtin_ctz(mpi))); mpi &= mpi - 1; }
  }
  for (; i < n; i++) scan_byte(p[i], (uint32_t)i, ti);
}

#endif  // __x86_64__

// Token sources: parse_line/ingest_datagram are templated over one of
// these, so the scalar (memchr) and SIMD (index) tokenizers drive the
// SAME parser body — byte-equivalence reduces to boundary equivalence,
// which the fuzz corpus asserts end to end.
struct MemchrTok {
  const char* find(const char* from, const char* to, char c) {
    return (const char*)memchr(from, c, (size_t)(to - from));
  }
};

struct IndexTok {
  const char* base;
  TokenIndex* ti;

  const char* find(const char* from, const char* to, char c) {
    std::vector<uint32_t>* a;
    size_t* cur;
    if (c == '|') { a = &ti->pi; cur = &ti->ipi; }
    else if (c == ':') { a = &ti->co; cur = &ti->ico; }
    else { a = &ti->nl; cur = &ti->inl; }
    uint32_t f = (uint32_t)(from - base);
    uint32_t t = (uint32_t)(to - base);
    size_t i = *cur;
    // queries are monotone in `from` along a datagram (the parser only
    // moves forward); a backwards query would mean a skipped candidate,
    // so rewind by binary search if one ever appears (defensive)
    if (i > 0 && i <= a->size() && (*a)[i - 1] >= f)
      i = (size_t)(std::lower_bound(a->begin(), a->end(), f) - a->begin());
    while (i < a->size() && (*a)[i] < f) i++;
    *cur = i;
    return (i < a->size() && (*a)[i] < t) ? base + (*a)[i] : nullptr;
  }
};

// ---------------------------------------------------------------------------
// Stage accounting clock
// ---------------------------------------------------------------------------
//
// Per-thread, per-stage counters over the data-plane pipeline
// (recvmmsg -> parse -> intern -> stage, plus the engine-level drain).
// The hot path records raw TSC ticks (~6 ns/read on x86_64, vs ~20-25 ns
// for clock_gettime) and the stats reader converts ticks to nanoseconds
// with a ratio measured over the engine's whole lifetime — two
// (steady_clock, tick) sample pairs, one at engine creation and one at
// read time — so the hot path never pays a calibration.

static inline uint64_t wall_ns() {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

#if defined(__x86_64__)
static inline uint64_t tick_now() {
  uint32_t lo, hi;
  __asm__ __volatile__("rdtsc" : "=a"(lo), "=d"(hi));
  return ((uint64_t)hi << 32) | lo;
}
#else
static inline uint64_t tick_now() { return wall_ns(); }
#endif

// Elapsed ticks since t0, clamped at 0: on hosts without an invariant/
// cross-core-synchronized TSC a thread migrating cores mid-window can
// read a SMALLER counter, and the unsigned underflow (~1.8e19) would be
// fetch_add'ed into a stage counter and locked in forever by the
// monotonic report latch.  A clamped window undercounts by one burst;
// an underflow poisons the subsystem for the process lifetime.
static inline uint64_t ticks_since(uint64_t t0) {
  uint64_t t1 = tick_now();
  return t1 > t0 ? t1 - t0 : 0;
}

// Per-reader-thread stage counters (ticks, converted at read time).
// recvmmsg covers poll+recvmmsg syscall time INCLUDING the wait for
// packets — at saturation that wait is the kernel handing datagrams
// over (the socket-bound share); at idle it is simply idle time.
struct StageCounters {
  std::atomic<uint64_t> recv_pkts{0}, recv_ticks{0};
  std::atomic<uint64_t> parse_pkts{0}, parse_ticks{0};
  std::atomic<uint64_t> intern_calls{0}, intern_ticks{0};
  std::atomic<uint64_t> stage_vals{0}, stage_ticks{0};
  // reported-ns latches: the tick->ns ratio is re-measured per stats
  // read, so a raw conversion can jitter a few ns BACKWARDS between two
  // reads whose tick counter didn't grow; reported values latch to
  // their maximum so the exported counters are strictly monotonic (the
  // documented contract; /debug/vars scrapers take rate() over them)
  std::atomic<uint64_t> rep_recv_ns{0}, rep_parse_ns{0},
      rep_intern_ns{0}, rep_stage_ns{0};
};

// Raise `latch` to v if higher; return the latched (monotonic) value.
static uint64_t mono_latch(std::atomic<uint64_t>& latch, uint64_t v) {
  uint64_t cur = latch.load(std::memory_order_relaxed);
  while (cur < v && !latch.compare_exchange_weak(
                        cur, v, std::memory_order_relaxed)) {
  }
  return cur < v ? v : cur;
}

// ---------------------------------------------------------------------------
// Strict float parsing (match veneur_tpu.samplers.parser._strict_float:
// no whitespace, no underscores, no hex — Python float() rejects 0x forms)
// ---------------------------------------------------------------------------

static bool strict_double(const char* p, size_t n, double* out) {
  if (n == 0) return false;
  char stackbuf[64];
  std::string heapbuf;  // Python's float() has no length cap; neither here
  char* buf;
  if (n < sizeof(stackbuf)) {
    buf = stackbuf;
  } else {
    heapbuf.resize(n + 1);
    buf = &heapbuf[0];
  }
  for (size_t i = 0; i < n; i++) {
    char c = p[i];
    if (c == '_' || c == 'x' || c == 'X' || isspace((unsigned char)c))
      return false;
    buf[i] = c;
  }
  buf[n] = 0;
  errno = 0;
  char* endp;
  double v = strtod(buf, &endp);
  if (endp != buf + n) return false;
  *out = v;
  return true;
}

// ---------------------------------------------------------------------------
// Engine
// ---------------------------------------------------------------------------

enum MType : uint8_t {
  MT_COUNTER = 0,
  MT_GAUGE = 1,
  MT_HISTO = 2,
  MT_TIMER = 3,
  MT_SET = 4,
};

// MetricScope values (veneur_tpu.samplers.metric_key.MetricScope)
enum Scope : uint8_t { SC_MIXED = 0, SC_LOCAL = 1, SC_GLOBAL = 2 };

struct NewKeyRec {
  uint32_t id;
  uint8_t mtype;
  uint8_t scope;
  std::string name;
  std::string joined_tags;
};

struct Batch {
  std::vector<uint32_t> c_ids;
  std::vector<double> c_vals;
  std::vector<uint32_t> g_ids;
  std::vector<double> g_vals;
  std::vector<uint32_t> h_ids;
  std::vector<double> h_vals;
  std::vector<double> h_wts;
  std::vector<uint32_t> s_ids;
  std::vector<uint64_t> s_hashes;
  std::vector<std::string> other;  // _e{ events, _sc service checks
  uint64_t processed = 0;          // metric values staged
  uint64_t malformed = 0;          // lines rejected
  uint64_t packets = 0;            // datagrams ingested
  uint64_t too_long = 0;           // datagrams over max length

  // Consumes `o` COMPLETELY: the non-move (insert) branch must clear the
  // source, or a clear-drain that appends a still-live thread buffer
  // leaves its samples behind to be re-collected next drain under dead
  // (pre-GC) ids — double counts + unknown-id crashes.
  void append(Batch&& o) {
    auto cat = [](auto& a, auto& b) {
      if (a.empty()) {
        a = std::move(b);
      } else {
        a.insert(a.end(), b.begin(), b.end());
      }
      b.clear();
    };
    cat(c_ids, o.c_ids); cat(c_vals, o.c_vals);
    cat(g_ids, o.g_ids); cat(g_vals, o.g_vals);
    cat(h_ids, o.h_ids); cat(h_vals, o.h_vals); cat(h_wts, o.h_wts);
    cat(s_ids, o.s_ids); cat(s_hashes, o.s_hashes);
    for (auto& s : o.other) other.emplace_back(std::move(s));
    o.other.clear();
    processed += o.processed;
    malformed += o.malformed;
    packets += o.packets;
    too_long += o.too_long;
    o.processed = o.malformed = o.packets = o.too_long = 0;
  }
};

// ---------------------------------------------------------------------------
// SPSC staging ring
// ---------------------------------------------------------------------------
//
// Each producer thread publishes finished batches into its own
// single-producer/single-consumer ring; the drainer pops them without
// ever blocking the producer.  Single-consumer holds because drains are
// serialized under Engine::drain_mu; single-producer holds because a
// thread id has one feeding thread (same-tid misuse degrades to the
// owner-token spin below, never to a data race).

struct BatchRing {
  std::vector<Batch> slots;
  size_t mask;
  alignas(64) std::atomic<uint64_t> head{0};  // consumer cursor
  alignas(64) std::atomic<uint64_t> tail{0};  // producer cursor

  explicit BatchRing(size_t n) : slots(n), mask(n - 1) {}

  bool try_push(Batch& b) {
    uint64_t t = tail.load(std::memory_order_relaxed);
    if (t - head.load(std::memory_order_acquire) >= slots.size())
      return false;
    slots[t & mask] = std::move(b);
    b = Batch();  // move leaves POD counters behind; reset wholesale
    tail.store(t + 1, std::memory_order_release);
    return true;
  }

  bool try_pop(Batch& out) {
    uint64_t h = head.load(std::memory_order_relaxed);
    if (h == tail.load(std::memory_order_acquire)) return false;
    out = std::move(slots[h & mask]);
    head.store(h + 1, std::memory_order_release);
    return true;
  }
};

// Receive backends a reader thread can resolve to (reported at
// /debug/vars -> ingest_stages.readers).
enum VnBackend {
  VN_BACKEND_NONE = 0,      // not a UDP reader (vn_ingest-fed thread)
  VN_BACKEND_RECVMMSG = 1,
  VN_BACKEND_IOURING = 2,
};

// owner-token states for ThreadBuf::owner
enum { OWN_FREE = 0, OWN_PRODUCER = 1, OWN_DRAINER = 2 };

struct ThreadBuf {
  BatchRing ring;
  // private to whoever holds `owner`; non-empty outside a producer
  // critical section only while the ring is full (backpressure), in
  // which case the drainer steals it with the owner token
  Batch cur;
  alignas(64) std::atomic<uint32_t> owner{OWN_FREE};
  std::atomic<int> backend{VN_BACKEND_NONE};
  StageCounters stages;

  explicit ThreadBuf(size_t ring_slots) : ring(ring_slots) {}
};

struct InternSlot {
  uint64_t h = 0;
  uint32_t id = UINT32_MAX;  // UINT32_MAX == empty
  std::string key;
};

struct InternShard {
  std::mutex mu;
  std::vector<InternSlot> slots;
  size_t count = 0;
  std::vector<NewKeyRec> fresh;

  InternShard() : slots(256) {}

  void grow() {
    std::vector<InternSlot> ns(slots.size() * 2);
    size_t mask = ns.size() - 1;
    for (auto& s : slots) {
      if (s.id == UINT32_MAX) continue;
      size_t i = s.h & mask;
      while (ns[i].id != UINT32_MAX) i = (i + 1) & mask;
      ns[i] = std::move(s);
    }
    slots.swap(ns);
  }
};

static const int NSHARDS = 16;

// tuning knob resolution (vn_engine_opt; Python routes config values here)
enum VnSimd {
  VN_SIMD_AUTO = 0,
  VN_SIMD_SCALAR = 1,
  VN_SIMD_SSE2 = 2,
  VN_SIMD_AVX2 = 3,
};

static const int kDefaultBatch = 64;        // recv burst size (packets)
static const int kMaxBatch = 1024;
static const int kDefaultRingSlots = 1024;  // SPSC slots per reader
static const int kMaxRingSlots = 65536;

static size_t round_pow2(size_t v, size_t lo, size_t hi) {
  size_t p = lo;
  while (p < v && p < hi) p <<= 1;
  return p;
}

static bool simd_supported(int mode) {
  switch (mode) {
    case VN_SIMD_SCALAR: return true;
#if defined(__x86_64__)
    case VN_SIMD_SSE2: return true;  // x86_64 baseline
    case VN_SIMD_AVX2: return __builtin_cpu_supports("avx2") != 0;
#endif
    default: return false;
  }
}

static int resolve_simd(int requested) {
  if (requested != VN_SIMD_AUTO && simd_supported(requested))
    return requested;
#if defined(__x86_64__)
  if (__builtin_cpu_supports("avx2")) return VN_SIMD_AVX2;
  return VN_SIMD_SSE2;
#else
  return VN_SIMD_SCALAR;
#endif
}

static scan_tokens_fn scan_fn_for(int mode) {
  switch (mode) {
#if defined(__x86_64__)
    case VN_SIMD_SSE2: return scan_tokens_sse2;
    case VN_SIMD_AVX2: return scan_tokens_avx2;
#endif
    default: return nullptr;  // scalar: parser memchrs directly, no index
  }
}

static key_hash_fn hash_fn_for(int mode) {
  switch (mode) {
#if defined(__x86_64__)
    case VN_SIMD_SSE2: return key_hash_sse2;
    case VN_SIMD_AVX2: return key_hash_avx2;
#endif
    default: return key_hash_scalar;
  }
}

struct Engine {
  int max_packet;
  // implicit tags (tagging.ExtendTags): pre-sorted tag strings + the key
  // prefixes they override (extend_tags.go:90-147)
  std::vector<std::string> implicit_tags;
  std::vector<std::string> implicit_prefixes;

  InternShard shards[NSHARDS];
  std::atomic<uint32_t> next_id{0};
  // bumped on intern clear; per-thread caches compare against it
  std::atomic<uint32_t> intern_gen{0};
  // process-unique engine identity (thread_local caches outlive engines)
  uint64_t nonce;

  std::mutex bufs_mu;
  std::vector<std::unique_ptr<ThreadBuf>> bufs;

  std::atomic<bool> stop{false};
  std::vector<std::thread> readers;

  // knobs (vn_engine_opt, set before threads exist) + resolved dispatch
  int opt_simd = VN_SIMD_AUTO;
  int opt_backend = VN_BACKEND_NONE;  // NONE == auto-probe
  int opt_batch = kDefaultBatch;
  int opt_ring_slots = kDefaultRingSlots;
  int simd_mode = VN_SIMD_SCALAR;
  scan_tokens_fn scan_fn = nullptr;
  key_hash_fn hash_fn = key_hash_scalar;

  // set for the duration of an intern-clearing drain; producers back off
  // at burst boundaries so the GC's owner-token claim makes progress
  std::atomic<bool> gc_active{false};
  // serializes drains: the SPSC rings have exactly one consumer at a time
  std::mutex drain_mu;

  // cumulative totals, updated at drain (for the benchmark / self-metrics)
  std::atomic<uint64_t> tot_processed{0}, tot_malformed{0}, tot_packets{0},
      tot_too_long{0};

  // stage-clock calibration baseline (ticks -> ns at stats-read time)
  // and the engine-level drain stage (runs on the Python drainer thread)
  uint64_t cal_ticks0 = 0, cal_ns0 = 0;
  std::atomic<uint64_t> drain_calls{0}, drain_pkts{0}, drain_ticks{0};
  std::atomic<uint64_t> rep_drain_ns{0};  // see StageCounters latches

  double ns_per_tick() const {
    uint64_t t1 = tick_now();
    uint64_t n1 = wall_ns();
    if (t1 <= cal_ticks0 || n1 <= cal_ns0) return 1.0;
    return (double)(n1 - cal_ns0) / (double)(t1 - cal_ticks0);
  }

  void resolve_dispatch() {
    simd_mode = resolve_simd(opt_simd);
    scan_fn = scan_fn_for(simd_mode);
    hash_fn = hash_fn_for(simd_mode);
  }

  int new_thread() {
    std::lock_guard<std::mutex> l(bufs_mu);
    bufs.emplace_back(new ThreadBuf((size_t)opt_ring_slots));
    return (int)bufs.size() - 1;
  }

  // The bufs vector's backing array moves on growth; never index it off
  // the lock (the ThreadBuf objects themselves are pointer-stable).
  ThreadBuf* buf_for(int tid) {
    std::lock_guard<std::mutex> l(bufs_mu);
    return bufs[tid].get();
  }
};

// ---------------------------------------------------------------------------
// Producer protocol
// ---------------------------------------------------------------------------
//
// A producer claims its thread buffer with an owner-token CAS for the
// span of one burst (parse + publish), backing off while an intern-GC
// is pending.  A normal drain never takes this token from a running
// producer — it only steals `cur` when the token is FREE — so a drain
// tick cannot stall a reader mid-burst; only the rare intern-clearing
// drain waits for every producer to reach a burst boundary.

static inline void cpu_pause() {
#if defined(__x86_64__)
  _mm_pause();
#endif
}

static void producer_acquire(Engine* e, ThreadBuf* tb) {
  int spins = 0;
  for (;;) {
    if (!e->gc_active.load(std::memory_order_acquire)) {
      uint32_t exp = OWN_FREE;
      if (tb->owner.compare_exchange_weak(exp, OWN_PRODUCER,
                                          std::memory_order_acquire,
                                          std::memory_order_relaxed))
        return;
    }
    if (++spins < 64) cpu_pause();
    else std::this_thread::yield();
  }
}

static inline void producer_release(ThreadBuf* tb) {
  tb->owner.store(OWN_FREE, std::memory_order_release);
}

// Publish the producer's private batch into its ring.  On a full ring the
// batch simply stays in `cur` (accumulating across bursts) until a drain
// frees slots or steals it — the producer never blocks on the drainer.
static inline void publish(ThreadBuf* tb) {
  if (tb->cur.packets == 0) return;
  tb->ring.try_push(tb->cur);
}

struct ThreadScratch {
  std::string key;                 // composite intern key
  std::vector<std::string> tags;   // canonicalization scratch
  TokenIndex tokens;               // per-datagram delimiter index (SIMD path)
  // direct-mapped per-thread intern cache: most lines repeat a recent
  // identity, so the common case skips the shard mutex + probe entirely.
  // Entries are invalidated wholesale by the engine's intern generation
  // (bumped on drain_clear while every thread is quiesced).
  struct CacheEntry {
    uint64_t h = 0;
    uint64_t engine = 0;   // engine nonce: thread_local outlives engines
    uint32_t id = UINT32_MAX;
    uint32_t gen = UINT32_MAX;
    std::string key;
  };
  static const int kCacheSlots = 4096;
  std::vector<CacheEntry> cache{kCacheSlots};

  // per-burst stage-tick accumulators, flushed into the thread's
  // StageCounters by account_burst (keeps the hot path at plain adds;
  // the atomics are touched a handful of times per burst, not per line)
  uint64_t acc_intern_ticks = 0, acc_intern_calls = 0;
  uint64_t acc_stage_ticks = 0, acc_stage_vals = 0;
};

// Fold one burst's accumulated stage ticks into the thread counters.
// `total_ticks` spans the whole parse burst; the parse stage is what
// remains after intern + stage are carved out.
static void account_burst(StageCounters& st, ThreadScratch& sc,
                          uint64_t pkts, uint64_t total_ticks) {
  uint64_t it = sc.acc_intern_ticks, ic = sc.acc_intern_calls;
  uint64_t stt = sc.acc_stage_ticks, sv = sc.acc_stage_vals;
  sc.acc_intern_ticks = sc.acc_intern_calls = 0;
  sc.acc_stage_ticks = sc.acc_stage_vals = 0;
  uint64_t carved = it + stt;
  uint64_t pt = total_ticks > carved ? total_ticks - carved : 0;
  auto add = [](std::atomic<uint64_t>& a, uint64_t v) {
    if (v) a.fetch_add(v, std::memory_order_relaxed);
  };
  add(st.parse_pkts, pkts);
  add(st.parse_ticks, pt);
  add(st.intern_calls, ic);
  add(st.intern_ticks, it);
  add(st.stage_vals, sv);
  add(st.stage_ticks, stt);
}

// Canonicalize a raw tag chunk: magic scope tags (first match wins,
// parser.go:444-456), implicit-tag override (extend_tags.go:90-147), sort,
// join.  Returns scope.
static uint8_t canonical_tags(Engine* e, ThreadScratch& sc,
                              const char* raw, size_t rawlen, bool has_tags,
                              std::string* joined) {
  uint8_t scope = SC_MIXED;
  auto& tags = sc.tags;
  tags.clear();
  if (has_tags) {
    const char* p = raw;
    const char* end = raw + rawlen;
    for (;;) {
      const char* c = (const char*)memchr(p, ',', end - p);
      const char* te = c ? c : end;
      tags.emplace_back(p, te - p);
      if (!c) break;
      p = c + 1;
    }
    static const char kLocal[] = "veneurlocalonly";
    static const char kGlobal[] = "veneurglobalonly";
    for (size_t i = 0; i < tags.size(); i++) {
      const std::string& t = tags[i];
      if (t.compare(0, sizeof(kLocal) - 1, kLocal) == 0) {
        scope = SC_LOCAL;
        tags.erase(tags.begin() + i);
        break;
      }
      if (t.compare(0, sizeof(kGlobal) - 1, kGlobal) == 0) {
        scope = SC_GLOBAL;
        tags.erase(tags.begin() + i);
        break;
      }
    }
  }
  if (!e->implicit_tags.empty()) {
    auto dropped = std::remove_if(
        tags.begin(), tags.end(), [e](const std::string& t) {
          size_t k = t.find(':');
          std::string key = t.substr(0, k == std::string::npos ? t.size() : k);
          for (auto& p : e->implicit_prefixes)
            if (p == key) return true;
          return false;
        });
    tags.erase(dropped, tags.end());
    for (auto& t : e->implicit_tags) tags.push_back(t);
  }
  std::sort(tags.begin(), tags.end());
  joined->clear();
  for (size_t i = 0; i < tags.size(); i++) {
    if (i) joined->push_back(',');
    joined->append(tags[i]);
  }
  return scope;
}

static uint32_t intern(Engine* e, ThreadScratch& sc, const char* name,
                       size_t nlen, uint8_t mt, const char* raw_tags,
                       size_t rtlen, bool has_tags) {
  struct Timed {  // attribute this whole call to the intern stage
    ThreadScratch& sc;
    uint64_t t0 = tick_now();
    explicit Timed(ThreadScratch& s) : sc(s) { sc.acc_intern_calls++; }
    ~Timed() { sc.acc_intern_ticks += ticks_since(t0); }
  } timed(sc);
  // Length-prefix the name so a 0x1F (or any byte) inside a name or tag
  // can never alias two distinct identities onto one intern key.
  std::string& key = sc.key;
  key.clear();
  uint32_t nl32 = (uint32_t)nlen;
  key.append((const char*)&nl32, 4);
  key.append(name, nlen);
  key.push_back((char)('0' + mt));
  if (has_tags) key.append(raw_tags, rtlen);
  uint64_t h = e->hash_fn(key.data(), key.size());
  uint32_t gen = e->intern_gen.load(std::memory_order_relaxed);
  auto& ce = sc.cache[h & (ThreadScratch::kCacheSlots - 1)];
  if (ce.engine == e->nonce && ce.gen == gen && ce.h == h
      && ce.id != UINT32_MAX && ce.key == key)
    return ce.id;

  InternShard& sh = e->shards[h & (NSHARDS - 1)];
  uint32_t id;
  {
    std::lock_guard<std::mutex> l(sh.mu);
    size_t mask = sh.slots.size() - 1;
    size_t i = h & mask;
    for (;;) {
      if (sh.slots[i].id == UINT32_MAX) {
        // miss: canonicalize and record
        std::string joined;
        uint8_t scope =
            canonical_tags(e, sc, raw_tags, rtlen, has_tags, &joined);
        id = e->next_id.fetch_add(1);
        sh.fresh.push_back(NewKeyRec{id, mt, scope,
                                     std::string(name, nlen),
                                     std::move(joined)});
        sh.slots[i] = InternSlot{h, id, key};
        if (++sh.count * 10 > sh.slots.size() * 7) sh.grow();
        break;
      }
      if (sh.slots[i].h == h && sh.slots[i].key == key) {
        id = sh.slots[i].id;
        break;
      }
      i = (i + 1) & mask;
    }
  }
  if (key.size() <= 512) {
    // don't pin oversized keys in the thread_local cache (it outlives
    // the engine; rare giant tag sets would be retained indefinitely)
    ce.h = h;
    ce.engine = e->nonce;
    ce.id = id;
    ce.gen = gen;
    ce.key = key;
  }
  return id;
}

// Fast path for the overwhelmingly common value shapes [-]ddd[.ddd]:
// with <= 15 digits both the integer mantissa and the power of ten are
// exactly representable, so the single divide is correctly rounded —
// the same result the strtod in strict_double produces.  Anything else
// (exponents, long digit runs, inf/nan spellings, and the characters
// strict_double rejects outright) falls back.
static inline bool parse_value(const char* p, size_t n, double* out) {
  static const double kPow10[16] = {1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6,
                                    1e7, 1e8, 1e9, 1e10, 1e11, 1e12,
                                    1e13, 1e14, 1e15};
  if (n == 0 || n > 16) return strict_double(p, n, out);
  const char* q = p;
  const char* end = p + n;
  bool neg = (*q == '-');
  if (neg) q++;
  uint64_t mant = 0;
  int digs = 0, frac = 0;
  bool dot = false;
  for (; q < end; q++) {
    char c = *q;
    if (c >= '0' && c <= '9') {
      mant = mant * 10 + (uint64_t)(c - '0');
      digs++;
      if (dot) frac++;
    } else if (c == '.' && !dot) {
      dot = true;
    } else {
      return strict_double(p, n, out);
    }
  }
  if (digs == 0 || digs > 15) return strict_double(p, n, out);
  double v = (double)mant;
  if (frac) v /= kPow10[frac];
  *out = neg ? -v : v;
  return true;
}

// Parse one DogStatsD metric line into the batch.  Mirrors
// Parser.parse_metric (veneur_tpu/samplers/parser.py, itself mirroring
// parser.go:349-503) — including the partial-emit semantics of multi-value
// packets (values before a malformed one are kept).  Templated over the
// token source (MemchrTok scalar / IndexTok SIMD) so both tokenizers
// drive one parser body.
template <class Tok>
static void parse_line(Engine* e, ThreadScratch& sc, const char* p, size_t n,
                       Batch& b, Tok& tok) {
  if (n == 0) return;
  if (p[0] == '_' && n >= 3 &&
      (memcmp(p, "_e{", 3) == 0 || memcmp(p, "_sc", 3) == 0)) {
    // events and service checks take the Python slow path at drain
    b.other.emplace_back(p, n);
    return;
  }
  const char* end = p + n;
  const char* type_pipe = tok.find(p, end, '|');
  if (!type_pipe) { b.malformed++; return; }
  const char* colon = tok.find(p, type_pipe, ':');
  if (!colon) { b.malformed++; return; }
  size_t name_len = colon - p;
  if (name_len == 0) { b.malformed++; return; }
  const char* val_begin = colon + 1;
  const char* val_end = type_pipe;

  const char* rest = type_pipe + 1;
  const char* tags_pipe = tok.find(rest, end, '|');
  const char* type_end = tags_pipe ? tags_pipe : end;
  if (type_end == rest) { b.malformed++; return; }
  uint8_t mt;
  switch (*rest) {
    case 'c': mt = MT_COUNTER; break;
    case 'g': mt = MT_GAUGE; break;
    case 'd': case 'h': mt = MT_HISTO; break;
    case 'm': mt = MT_TIMER; break;  // "ms" (lead-byte dispatch, parser.py)
    case 's': mt = MT_SET; break;
    default: b.malformed++; return;
  }

  double rate = 1.0;
  bool found_rate = false, found_tags = false;
  const char* raw_tags = nullptr;
  size_t raw_tags_len = 0;
  const char* cur = type_end;
  while (cur < end) {
    const char* nxt = tok.find(cur + 1, end, '|');
    const char* cend = nxt ? nxt : end;
    const char* chunk = cur + 1;
    size_t clen = cend - chunk;
    cur = cend;
    if (clen == 0) { b.malformed++; return; }
    if (*chunk == '@') {
      if (found_rate) { b.malformed++; return; }
      if (!strict_double(chunk + 1, clen - 1, &rate) || std::isnan(rate) ||
          !(rate > 0.0) || rate > 1.0) {
        b.malformed++;
        return;
      }
      found_rate = true;
    } else if (*chunk == '#') {
      if (found_tags) { b.malformed++; return; }
      raw_tags = chunk + 1;
      raw_tags_len = clen - 1;
      found_tags = true;
    } else {
      b.malformed++;
      return;
    }
  }

  uint32_t id =
      intern(e, sc, p, name_len, mt, raw_tags, raw_tags_len, found_tags);

  // value loop = the stage stage: float-parse each value and append it
  // to the per-thread columnar buffers (RAII so the malformed-value
  // early return is accounted too)
  struct StageTimed {
    ThreadScratch& sc;
    const Batch& b;
    uint64_t t0, v0;
    StageTimed(ThreadScratch& s, const Batch& bb)
        : sc(s), b(bb), t0(tick_now()), v0(bb.processed) {}
    ~StageTimed() {
      sc.acc_stage_ticks += ticks_since(t0);
      sc.acc_stage_vals += b.processed - v0;
    }
  } stage_timed(sc, b);
  const char* v = val_begin;
  for (;;) {
    const char* vc = tok.find(v, val_end, ':');
    const char* ve = vc ? vc : val_end;
    if (mt == MT_SET) {
      b.s_ids.push_back(id);
      b.s_hashes.push_back(metro64((const uint8_t*)v, ve - v, 1337));
      b.processed++;
    } else {
      double x;
      if (!parse_value(v, ve - v, &x) || !std::isfinite(x)) {
        b.malformed++;
        return;  // earlier values stay staged (parser.py multi-value loop)
      }
      switch (mt) {
        case MT_COUNTER:
          b.c_ids.push_back(id);
          // Sample divides by rate at ingest, truncating (samplers.go:109)
          b.c_vals.push_back(std::trunc(x / rate));
          break;
        case MT_GAUGE:
          b.g_ids.push_back(id);
          b.g_vals.push_back(x);
          break;
        default:  // histogram / timer
          b.h_ids.push_back(id);
          b.h_vals.push_back(x);
          b.h_wts.push_back(1.0 / rate);
      }
      b.processed++;
    }
    if (!vc) break;
    v = vc + 1;
  }
}

template <class Tok>
static void ingest_datagram_t(Engine* e, ThreadScratch& sc, const char* data,
                              size_t len, Batch& b, Tok& tok) {
  // count BEFORE the length guard: the Python path tallies proto_received
  // on receipt, then drops oversized datagrams (server.py _read_udp ->
  // process_packet_buffer), and received_per_protocol_total must agree
  // whichever data plane is active
  b.packets++;
  if ((int)len > e->max_packet) {
    b.too_long++;
    return;
  }
  const char* p = data;
  const char* end = data + len;
  while (p < end) {
    const char* nl = tok.find(p, end, '\n');
    const char* le = nl ? nl : end;
    if (le > p) parse_line(e, sc, p, le - p, b, tok);
    if (!nl) break;
    p = nl + 1;
  }
}

static void ingest_datagram(Engine* e, ThreadScratch& sc, const char* data,
                            size_t len, Batch& b) {
  if (e->scan_fn && (int)len <= e->max_packet) {
    // SIMD path: one wide-compare pass builds the delimiter index; the
    // parser consumes positions instead of re-scanning bytes
    sc.tokens.reset();
    e->scan_fn((const uint8_t*)data, len, sc.tokens);
    IndexTok tok{data, &sc.tokens};
    ingest_datagram_t(e, sc, data, len, b, tok);
  } else {
    MemchrTok tok;
    ingest_datagram_t(e, sc, data, len, b, tok);
  }
}

// UDP reader loops.  The multi-reader SO_REUSEPORT fan-out is composed
// Python-side by attaching one reader per socket (networking.go:54-107
// equivalent); each reader owns one ThreadBuf and parses a whole burst
// under one producer-token acquisition, then publishes into its SPSC
// ring so a drain tick never blocks it.

// recvmmsg backend: poll(100ms) + recvmmsg bursts.  Portable fallback —
// works on any Linux and under restrictive seccomp profiles.
static void reader_loop_recvmmsg(Engine* e, int fd, ThreadBuf* tb) {
  const int vlen = e->opt_batch;
  ThreadScratch sc;
  size_t bufsz = (size_t)e->max_packet + 1;
  std::vector<char> store(bufsz * (size_t)vlen);
  std::vector<iovec> iov(vlen);
  std::vector<mmsghdr> msgs(vlen);
  for (int i = 0; i < vlen; i++) {
    iov[i] = {store.data() + (size_t)i * bufsz, bufsz};
    memset(&msgs[i], 0, sizeof(mmsghdr));
    msgs[i].msg_hdr.msg_iov = &iov[i];
    msgs[i].msg_hdr.msg_iovlen = 1;
  }
  tb->backend.store(VN_BACKEND_RECVMMSG, std::memory_order_relaxed);
  StageCounters& st = tb->stages;
  while (!e->stop.load(std::memory_order_relaxed)) {
    uint64_t recv_t0 = tick_now();
    pollfd pfd{fd, POLLIN, 0};
    int pr = poll(&pfd, 1, 100);
    if (pr < 0 && errno != EINTR) return;
    if (pr <= 0 || !(pfd.revents & POLLIN)) {
      if (pfd.revents & (POLLERR | POLLNVAL | POLLHUP)) return;
      st.recv_ticks.fetch_add(ticks_since(recv_t0),
                              std::memory_order_relaxed);
      continue;
    }
    int r = recvmmsg(fd, msgs.data(), vlen, MSG_DONTWAIT, nullptr);
    if (r <= 0) {
      if (r < 0 && (errno == EAGAIN || errno == EINTR)) continue;
      return;
    }
    st.recv_ticks.fetch_add(ticks_since(recv_t0),
                            std::memory_order_relaxed);
    st.recv_pkts.fetch_add((uint64_t)r, std::memory_order_relaxed);
    uint64_t parse_t0 = tick_now();
    producer_acquire(e, tb);
    for (int i = 0; i < r; i++)
      ingest_datagram(e, sc, (const char*)iov[i].iov_base, msgs[i].msg_len,
                      tb->cur);
    publish(tb);
    producer_release(tb);
    account_burst(st, sc, (uint64_t)r, ticks_since(parse_t0));
  }
}

#ifdef VN_HAVE_IOURING

// io_uring multishot-receive backend: one armed IORING_OP_RECV with
// IORING_RECV_MULTISHOT keeps posting a CQE per datagram into a provided
// buffer ring — zero syscalls on the receive path while buffers last.
// Raw syscalls (no liburing in the image); every setup step can fail on
// older kernels or seccomp, in which case the caller falls back to
// recvmmsg.
struct UringRx {
  int ring_fd = -1;
  int sock_fd = -1;
  void* sq_ptr = nullptr;
  size_t sq_len = 0;
  void* cq_ptr = nullptr;
  size_t cq_len = 0;
  io_uring_sqe* sqes = nullptr;
  size_t sqes_len = 0;
  io_uring_buf_ring* br = nullptr;
  size_t br_len = 0;
  std::vector<char> pktmem;
  size_t bufsz = 0;
  unsigned nbufs = 0;

  unsigned* sq_tail = nullptr;
  unsigned* sq_mask = nullptr;
  unsigned* sq_array = nullptr;
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  unsigned* cq_mask = nullptr;
  io_uring_cqe* cqes = nullptr;
  unsigned short br_tail = 0;

  ~UringRx() { destroy(); }

  void destroy() {
    if (br) {
      if (ring_fd >= 0) {
        io_uring_buf_reg reg{};
        reg.bgid = 0;
        syscall(__NR_io_uring_register, ring_fd, IORING_UNREGISTER_PBUF_RING,
                &reg, 1);
      }
      munmap(br, br_len);
      br = nullptr;
    }
    if (sqes) munmap(sqes, sqes_len), sqes = nullptr;
    if (cq_ptr && cq_ptr != sq_ptr) munmap(cq_ptr, cq_len);
    cq_ptr = nullptr;
    if (sq_ptr) munmap(sq_ptr, sq_len), sq_ptr = nullptr;
    if (ring_fd >= 0) close(ring_fd), ring_fd = -1;
  }

  const char* buf_at(unsigned bid) const {
    return pktmem.data() + (size_t)bid * bufsz;
  }

  // Return a consumed buffer to the kernel's provided-buffer ring.
  void recycle(unsigned bid) {
    io_uring_buf* b = &br->bufs[br_tail & (nbufs - 1)];
    b->addr = (__u64)(uintptr_t)buf_at(bid);
    b->len = (__u32)bufsz;
    b->bid = (__u16)bid;
    br_tail++;
  }
  void recycle_commit() {
    __atomic_store_n(&br->tail, br_tail, __ATOMIC_RELEASE);
  }

  // Push + submit one multishot recv SQE.  The kernel re-posts CQEs off
  // this single submission until it runs out of buffers or errors.
  bool arm() {
    unsigned t = *sq_tail;
    unsigned idx = t & *sq_mask;
    io_uring_sqe* s = &sqes[idx];
    memset(s, 0, sizeof(*s));
    s->opcode = IORING_OP_RECV;
    s->fd = sock_fd;
    s->ioprio = IORING_RECV_MULTISHOT;
    s->flags = IOSQE_BUFFER_SELECT;
    s->buf_group = 0;
    sq_array[idx] = idx;
    __atomic_store_n(sq_tail, t + 1, __ATOMIC_RELEASE);
    int r =
        (int)syscall(__NR_io_uring_enter, ring_fd, 1, 0, 0u, nullptr, 0);
    return r >= 0;
  }

  // Block for >= 1 CQE with a timeout so the reader can notice stop.
  // Returns false on fatal enter() failure.
  bool wait(long timeout_ms) {
    struct __kernel_timespec ts {};
    ts.tv_nsec = timeout_ms * 1000000L;
    io_uring_getevents_arg arg{};
    arg.ts = (__u64)(uintptr_t)&ts;
    arg.sigmask_sz = _NSIG / 8;
    int r = (int)syscall(__NR_io_uring_enter, ring_fd, 0, 1,
                         IORING_ENTER_GETEVENTS | IORING_ENTER_EXT_ARG, &arg,
                         sizeof(arg));
    return r >= 0 || errno == ETIME || errno == EINTR;
  }

  bool init(int fd, size_t bufsz_, unsigned nbufs_) {
    sock_fd = fd;
    bufsz = bufsz_;
    nbufs = nbufs_;  // caller guarantees a power of two
    io_uring_params p{};
    p.flags = IORING_SETUP_CQSIZE;
    p.cq_entries = nbufs * 2;
    ring_fd = (int)syscall(__NR_io_uring_setup, 8, &p);
    if (ring_fd < 0) return false;
    if (!(p.features & IORING_FEAT_EXT_ARG)) return false;
    sq_len = p.sq_off.array + p.sq_entries * sizeof(__u32);
    cq_len = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
    if (p.features & IORING_FEAT_SINGLE_MMAP)
      sq_len = cq_len = std::max(sq_len, cq_len);
    sq_ptr = mmap(nullptr, sq_len, PROT_READ | PROT_WRITE,
                  MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_SQ_RING);
    if (sq_ptr == MAP_FAILED) return sq_ptr = nullptr, false;
    if (p.features & IORING_FEAT_SINGLE_MMAP) {
      cq_ptr = sq_ptr;
    } else {
      cq_ptr = mmap(nullptr, cq_len, PROT_READ | PROT_WRITE,
                    MAP_SHARED | MAP_POPULATE, ring_fd, IORING_OFF_CQ_RING);
      if (cq_ptr == MAP_FAILED) return cq_ptr = nullptr, false;
    }
    sqes_len = p.sq_entries * sizeof(io_uring_sqe);
    sqes = (io_uring_sqe*)mmap(nullptr, sqes_len, PROT_READ | PROT_WRITE,
                               MAP_SHARED | MAP_POPULATE, ring_fd,
                               IORING_OFF_SQES);
    if (sqes == MAP_FAILED) return sqes = nullptr, false;
    char* sqb = (char*)sq_ptr;
    sq_tail = (unsigned*)(sqb + p.sq_off.tail);
    sq_mask = (unsigned*)(sqb + p.sq_off.ring_mask);
    sq_array = (unsigned*)(sqb + p.sq_off.array);
    char* cqb = (char*)cq_ptr;
    cq_head = (unsigned*)(cqb + p.cq_off.head);
    cq_tail = (unsigned*)(cqb + p.cq_off.tail);
    cq_mask = (unsigned*)(cqb + p.cq_off.ring_mask);
    cqes = (io_uring_cqe*)(cqb + p.cq_off.cqes);

    pktmem.resize((size_t)nbufs * bufsz);
    br_len = (size_t)nbufs * sizeof(io_uring_buf);
    br = (io_uring_buf_ring*)mmap(nullptr, br_len, PROT_READ | PROT_WRITE,
                                  MAP_ANONYMOUS | MAP_PRIVATE, -1, 0);
    if (br == MAP_FAILED) return br = nullptr, false;
    io_uring_buf_reg reg{};
    reg.ring_addr = (__u64)(uintptr_t)br;
    reg.ring_entries = nbufs;
    reg.bgid = 0;
    if (syscall(__NR_io_uring_register, ring_fd, IORING_REGISTER_PBUF_RING,
                &reg, 1) < 0)
      return false;
    for (unsigned i = 0; i < nbufs; i++) recycle(i);
    recycle_commit();
    return true;
  }

  // Probe the armed multishot recv: an unsupported opcode/flag posts a
  // synchronous error CQE at submit time.  A CQE with res >= 0 is a real
  // packet that raced in — leave it for the reader loop.
  bool probe_ok() {
    unsigned h = *cq_head;
    unsigned t = __atomic_load_n(cq_tail, __ATOMIC_ACQUIRE);
    if (h == t) return true;
    io_uring_cqe* c = &cqes[h & *cq_mask];
    if (c->res >= 0) return true;
    __atomic_store_n(cq_head, h + 1, __ATOMIC_RELEASE);
    return false;
  }
};

// io_uring reader loop.  Returns true if the backend ran (even if it later
// hit a fatal error); false if the probe failed and the caller should fall
// back to recvmmsg with the socket untouched.
static bool reader_loop_iouring(Engine* e, int fd, ThreadBuf* tb) {
  const int batch = e->opt_batch;
  size_t bufsz = (size_t)e->max_packet + 1;
  // enough provided buffers to ride out several bursts between reaps
  unsigned nbufs =
      (unsigned)round_pow2((size_t)batch * 8, 256, (size_t)kMaxBatch);
  UringRx rx;
  if (!rx.init(fd, bufsz, nbufs)) return false;
  if (!rx.arm()) return false;
  if (!rx.probe_ok()) return false;
  tb->backend.store(VN_BACKEND_IOURING, std::memory_order_relaxed);
  ThreadScratch sc;
  StageCounters& st = tb->stages;
  std::vector<unsigned> bids((size_t)batch);
  std::vector<int> lens((size_t)batch);
  bool rearm = false;
  while (!e->stop.load(std::memory_order_relaxed)) {
    uint64_t recv_t0 = tick_now();
    unsigned head = *rx.cq_head;
    unsigned tail = __atomic_load_n(rx.cq_tail, __ATOMIC_ACQUIRE);
    if (head == tail) {
      if (rearm) {
        if (!rx.arm()) return true;
        rearm = false;
      }
      if (!rx.wait(100)) return true;
      st.recv_ticks.fetch_add(ticks_since(recv_t0),
                              std::memory_order_relaxed);
      continue;
    }
    int n = 0;
    bool fatal = false;
    while (head != tail && n < batch) {
      io_uring_cqe* c = &rx.cqes[head & *rx.cq_mask];
      if (c->res >= 0 && (c->flags & IORING_CQE_F_BUFFER)) {
        bids[(size_t)n] = (unsigned)(c->flags >> IORING_CQE_BUFFER_SHIFT);
        lens[(size_t)n] = c->res;
        n++;
      } else if (c->res < 0 && c->res != -ENOBUFS && c->res != -EINTR) {
        fatal = true;
      }
      if (!(c->flags & IORING_CQE_F_MORE)) rearm = true;
      head++;
    }
    __atomic_store_n(rx.cq_head, head, __ATOMIC_RELEASE);
    st.recv_ticks.fetch_add(ticks_since(recv_t0), std::memory_order_relaxed);
    if (n > 0) {
      st.recv_pkts.fetch_add((uint64_t)n, std::memory_order_relaxed);
      uint64_t parse_t0 = tick_now();
      producer_acquire(e, tb);
      for (int i = 0; i < n; i++)
        ingest_datagram(e, sc, rx.buf_at(bids[(size_t)i]),
                        (size_t)lens[(size_t)i], tb->cur);
      publish(tb);
      producer_release(tb);
      account_burst(st, sc, (uint64_t)n, ticks_since(parse_t0));
      for (int i = 0; i < n; i++) rx.recycle(bids[(size_t)i]);
      rx.recycle_commit();
    }
    if (fatal) return true;
    // re-arm as soon as recycled buffers exist: the terminated multishot's
    // leftover CQEs still reap fine alongside the new submission's
    if (rearm) {
      if (!rx.arm()) return true;
      rearm = false;
    }
  }
  return true;
}

#endif  // VN_HAVE_IOURING

// Reader entry: resolve the receive backend (auto = probe io_uring, fall
// back to recvmmsg), then run the loop until stop.
static void reader_loop(Engine* e, int fd, ThreadBuf* tb) {
#ifdef VN_HAVE_IOURING
  // an explicit io_uring request the kernel can't honor still falls back
  // (dropping packets would be worse); the reported backend shows what ran
  if (e->opt_backend != VN_BACKEND_RECVMMSG &&
      reader_loop_iouring(e, fd, tb))
    return;
#endif
  if (!e->stop.load(std::memory_order_relaxed))
    reader_loop_recvmmsg(e, fd, tb);
}

// ---------------------------------------------------------------------------
// Drain
// ---------------------------------------------------------------------------

struct DrainResult {
  Batch b;
  std::string keys_blob;   // [u32 id][u8 type][u8 scope][u32 nlen][u32 tlen]
                           // [name][tags] ...
  std::string other_blob;  // [u32 len][bytes] ...
  uint32_t n_keys = 0;
};

static DrainResult* drain(Engine* e, bool clear_intern) {
  uint64_t drain_t0 = tick_now();
  auto* d = new DrainResult();
  std::vector<NewKeyRec> keys;
  // Serialize drains: each SPSC ring has exactly one consumer at a time.
  std::lock_guard<std::mutex> dl(e->drain_mu);
  if (!clear_intern) {
    // Lock-free tick: pop every published batch, then steal each idle
    // producer's private `cur` with the owner token.  A producer that is
    // mid-burst keeps its token and is simply skipped — its in-flight
    // batch lands on the next tick, and the drain never stalls it.
    std::vector<ThreadBuf*> tbs;
    {
      std::lock_guard<std::mutex> l(e->bufs_mu);
      for (auto& tb : e->bufs) tbs.push_back(tb.get());
    }
    for (ThreadBuf* tb : tbs) {
      Batch tmp;
      while (tb->ring.try_pop(tmp)) d->b.append(std::move(tmp));
      uint32_t exp = OWN_FREE;
      if (tb->owner.compare_exchange_strong(exp, OWN_DRAINER,
                                            std::memory_order_acquire)) {
        if (tb->cur.packets != 0) {
          // tmp is empty here: append() consumes its source completely
          std::swap(tmp, tb->cur);
          d->b.append(std::move(tmp));
        }
        tb->owner.store(OWN_FREE, std::memory_order_release);
      }
    }
    // Shards AFTER buffers: a staged sample's intern happened before the
    // sample was published (program order inside the producer's critical
    // section), so collecting fresh keys afterwards can only over-collect
    // (a key whose samples arrive next drain — harmless), never
    // under-collect.
    for (auto& sh : e->shards) {
      std::lock_guard<std::mutex> sl(sh.mu);
      for (auto& k : sh.fresh) keys.emplace_back(std::move(k));
      sh.fresh.clear();
    }
  } else {
    // Intern-GC drain: the one path that still quiesces.  Holding bufs_mu
    // for the whole wipe blocks vn_thread_new/buf_for, so no thread the
    // claim loop hasn't seen can start interning; gc_active parks every
    // producer at its next burst boundary, and claiming every owner token
    // makes {consolidate + clear} atomic — no sample can be staged against
    // an id whose key record was dropped.
    std::lock_guard<std::mutex> l(e->bufs_mu);
    e->gc_active.store(true);
    for (auto& tb : e->bufs) {
      uint32_t exp = OWN_FREE;
      while (!tb->owner.compare_exchange_weak(exp, OWN_DRAINER,
                                              std::memory_order_acquire,
                                              std::memory_order_relaxed)) {
        exp = OWN_FREE;
        // keep popping while we wait: a producer backed up on a full ring
        // finishes its burst once slots free, then parks on gc_active
        Batch tmp;
        while (tb->ring.try_pop(tmp)) d->b.append(std::move(tmp));
        std::this_thread::yield();
      }
    }
    for (auto& tb : e->bufs) {
      Batch tmp;
      while (tb->ring.try_pop(tmp)) d->b.append(std::move(tmp));
      if (tb->cur.packets != 0) {
        std::swap(tmp, tb->cur);
        d->b.append(std::move(tmp));
      }
    }
    for (auto& sh : e->shards) {
      std::lock_guard<std::mutex> sl(sh.mu);
      for (auto& k : sh.fresh) keys.emplace_back(std::move(k));
      sh.fresh.clear();
      sh.slots.assign(256, InternSlot{});
      sh.count = 0;
    }
    // all old ids are dead (buffers drained, table wiped) — restart the
    // id space so the Python id cache stays bounded by live cardinality,
    // and invalidate every per-thread intern cache (threads are parked:
    // the drainer holds every owner token)
    e->next_id.store(0);
    e->intern_gen.fetch_add(1);
    for (auto& tb : e->bufs) tb->owner.store(OWN_FREE, std::memory_order_release);
    e->gc_active.store(false);
  }
  // ids ascend so Python can grow its id->row table append-only
  std::sort(keys.begin(), keys.end(),
            [](const NewKeyRec& a, const NewKeyRec& b) { return a.id < b.id; });
  d->n_keys = (uint32_t)keys.size();
  auto put_u32 = [](std::string& s, uint32_t v) {
    s.append((const char*)&v, 4);
  };
  for (auto& k : keys) {
    put_u32(d->keys_blob, k.id);
    d->keys_blob.push_back((char)k.mtype);
    d->keys_blob.push_back((char)k.scope);
    put_u32(d->keys_blob, (uint32_t)k.name.size());
    put_u32(d->keys_blob, (uint32_t)k.joined_tags.size());
    d->keys_blob.append(k.name);
    d->keys_blob.append(k.joined_tags);
  }
  for (auto& s : d->b.other) {
    put_u32(d->other_blob, (uint32_t)s.size());
    d->other_blob.append(s);
  }
  e->tot_processed += d->b.processed;
  e->tot_malformed += d->b.malformed;
  e->tot_packets += d->b.packets;
  e->tot_too_long += d->b.too_long;
  e->drain_calls.fetch_add(1, std::memory_order_relaxed);
  e->drain_pkts.fetch_add(d->b.packets, std::memory_order_relaxed);
  e->drain_ticks.fetch_add(ticks_since(drain_t0),
                           std::memory_order_relaxed);
  return d;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* vn_engine_new(int max_packet_len, const char* implicit_tags_nl) {
  static std::atomic<uint64_t> g_engine_nonce{1};
  auto* e = new Engine();
  e->nonce = g_engine_nonce.fetch_add(1);
  e->max_packet = max_packet_len;
  e->cal_ns0 = wall_ns();
  e->cal_ticks0 = tick_now();
  if (implicit_tags_nl && *implicit_tags_nl) {
    const char* p = implicit_tags_nl;
    while (*p) {
      const char* nl = strchr(p, '\n');
      size_t len = nl ? (size_t)(nl - p) : strlen(p);
      if (len) {
        std::string t(p, len);
        const char* c = (const char*)memchr(t.data(), ':', t.size());
        e->implicit_prefixes.emplace_back(
            t.substr(0, c ? (size_t)(c - t.data()) : t.size()));
        e->implicit_tags.emplace_back(std::move(t));
      }
      if (!nl) break;
      p = nl + 1;
    }
    std::sort(e->implicit_tags.begin(), e->implicit_tags.end());
  }
  e->resolve_dispatch();
  return e;
}

// Tune engine knobs (call before threads are created; ring_slots only
// affects threads created after the call).  Returns 0, or -1 for an
// unknown key / unsupported value.
//   "simd"       0=auto 1=scalar 2=sse2 3=avx2 (rejected if unsupported)
//   "backend"    0=auto 1=recvmmsg 2=io_uring
//   "batch"      recv burst size, clamped to [1, kMaxBatch]
//   "ring_slots" SPSC slots per reader, rounded to a power of two
int vn_engine_opt(void* ep, const char* key, long long val) {
  auto* e = (Engine*)ep;
  if (!key) return -1;
  if (strcmp(key, "simd") == 0) {
    if (val < VN_SIMD_AUTO || val > VN_SIMD_AVX2) return -1;
    if (val != VN_SIMD_AUTO && !simd_supported((int)val)) return -1;
    e->opt_simd = (int)val;
    e->resolve_dispatch();
    return 0;
  }
  if (strcmp(key, "backend") == 0) {
    if (val < VN_BACKEND_NONE || val > VN_BACKEND_IOURING) return -1;
    e->opt_backend = (int)val;
    return 0;
  }
  if (strcmp(key, "batch") == 0) {
    if (val < 1) return -1;
    e->opt_batch = (int)std::min<long long>(val, kMaxBatch);
    return 0;
  }
  if (strcmp(key, "ring_slots") == 0) {
    if (val < 1) return -1;
    e->opt_ring_slots =
        (int)round_pow2((size_t)val, 2, (size_t)kMaxRingSlots);
    return 0;
  }
  return -1;
}

// Resolved dispatch / backend introspection (debug vars + tests).
int vn_simd_mode(void* ep) { return ((Engine*)ep)->simd_mode; }

int vn_simd_supported(int mode) { return simd_supported(mode) ? 1 : 0; }

int vn_reader_backend(void* ep, int tid) {
  auto* e = (Engine*)ep;
  std::lock_guard<std::mutex> l(e->bufs_mu);
  if (tid < 0 || (size_t)tid >= e->bufs.size()) return -1;
  return e->bufs[(size_t)tid]->backend.load(std::memory_order_relaxed);
}

// Test hook: intern-key hash under an explicit SIMD mode (parity checks).
// Returns 0 for an unsupported mode (0 is not a reachable hash of any
// input: kh_finish always multiplies in a nonzero odd constant — callers
// compare modes against each other, not against 0).
unsigned long long vn_key_hash(const char* data, long n, int mode) {
  if (mode == VN_SIMD_AUTO || !simd_supported(mode)) return 0;
  return hash_fn_for(mode)(data, (size_t)n);
}

// Test hook: run one tokenizer pass under an explicit SIMD mode and flatten
// the per-class index into (position, class) pairs, class 0='\n' 1=':'
// 2='|'.  Returns the total token count (callers re-call with a bigger
// buffer if it exceeds cap), or -1 for an unsupported mode.
long long vn_scan_tokens(const char* data, long n, int mode,
                         long long* out_pos, unsigned char* out_cls,
                         long long cap) {
  if (mode == VN_SIMD_AUTO || !simd_supported(mode)) return -1;
  TokenIndex ti;
  scan_tokens_fn f = scan_fn_for(mode);
  if (!f) f = scan_tokens_scalar;
  f((const uint8_t*)data, (size_t)n, ti);
  long long total = (long long)(ti.nl.size() + ti.co.size() + ti.pi.size());
  if (out_pos && out_cls && cap > 0) {
    // three-way merge by position (each class array is ascending)
    size_t a = 0, b = 0, c = 0;
    long long w = 0;
    while (w < cap) {
      uint32_t pn = a < ti.nl.size() ? ti.nl[a] : UINT32_MAX;
      uint32_t pc = b < ti.co.size() ? ti.co[b] : UINT32_MAX;
      uint32_t pp = c < ti.pi.size() ? ti.pi[c] : UINT32_MAX;
      if (pn == UINT32_MAX && pc == UINT32_MAX && pp == UINT32_MAX) break;
      if (pn <= pc && pn <= pp) {
        out_pos[w] = (long long)pn;
        out_cls[w] = 0;
        a++;
      } else if (pc <= pp) {
        out_pos[w] = (long long)pc;
        out_cls[w] = 1;
        b++;
      } else {
        out_pos[w] = (long long)pp;
        out_cls[w] = 2;
        c++;
      }
      w++;
    }
  }
  return total;
}

void vn_engine_free(void* ep) {
  auto* e = (Engine*)ep;
  e->stop.store(true);
  for (auto& t : e->readers)
    if (t.joinable()) t.join();
  delete e;
}

int vn_thread_new(void* ep) { return ((Engine*)ep)->new_thread(); }

// Ingest one datagram buffer on a registered thread id (ctypes releases the
// GIL around this call, so Python reader threads get real parallelism).
// Batches accumulate in the thread's private `cur` and publish to its ring
// once they reach the burst size; a drain steals whatever is pending.
void vn_ingest(void* ep, int tid, const char* data, long len) {
  auto* e = (Engine*)ep;
  thread_local ThreadScratch sc;
  ThreadBuf* tb = e->buf_for(tid);
  uint64_t t0 = tick_now();
  producer_acquire(e, tb);
  ingest_datagram(e, sc, data, (size_t)len, tb->cur);
  if (tb->cur.packets >= (uint64_t)e->opt_batch) publish(tb);
  producer_release(tb);
  account_burst(tb->stages, sc, 1, ticks_since(t0));
}

// Spawn a native reader thread on an already-bound UDP socket fd,
// optionally pinned to a CPU (cpu < 0 = unpinned; pinning is best-effort,
// an invalid cpu just leaves the thread floating).
int vn_add_udp_reader_pinned(void* ep, int fd, int cpu) {
  auto* e = (Engine*)ep;
  int tid = e->new_thread();
  e->readers.emplace_back(reader_loop, e, fd, e->buf_for(tid));
  if (cpu >= 0) {
    cpu_set_t set;
    CPU_ZERO(&set);
    CPU_SET(cpu, &set);
    pthread_setaffinity_np(e->readers.back().native_handle(), sizeof(set),
                           &set);
  }
  return tid;
}

int vn_add_udp_reader(void* ep, int fd) {
  return vn_add_udp_reader_pinned(ep, fd, -1);
}

void vn_stop(void* ep) {
  auto* e = (Engine*)ep;
  e->stop.store(true);
  for (auto& t : e->readers)
    if (t.joinable()) t.join();
  e->readers.clear();
}

void* vn_drain(void* ep) { return drain((Engine*)ep, false); }

// Drain + atomically clear the intern table (cardinality-churn GC).  The
// caller MUST invalidate its id cache: the id space restarts at 0, so old
// ids are reassigned to whatever identities intern next.
void* vn_drain_clear(void* ep) { return drain((Engine*)ep, true); }

// which: 0=counters(ids,vals) 1=gauges(ids,vals) 2=histos(ids,vals,wts)
//        3=sets(ids,hashes) 4=keys blob (ptr, n=keys count, b=byte length)
//        5=other blob (ptr, b=byte length)
long long vn_drain_section(void* dp, int which, const void** a,
                           const void** b, const void** c) {
  auto* d = (DrainResult*)dp;
  switch (which) {
    case 0:
      *a = d->b.c_ids.data();
      *b = d->b.c_vals.data();
      return (long long)d->b.c_ids.size();
    case 1:
      *a = d->b.g_ids.data();
      *b = d->b.g_vals.data();
      return (long long)d->b.g_ids.size();
    case 2:
      *a = d->b.h_ids.data();
      *b = d->b.h_vals.data();
      *c = d->b.h_wts.data();
      return (long long)d->b.h_ids.size();
    case 3:
      *a = d->b.s_ids.data();
      *b = d->b.s_hashes.data();
      return (long long)d->b.s_ids.size();
    case 4:
      *a = d->keys_blob.data();
      *b = (const void*)(uintptr_t)d->keys_blob.size();
      return (long long)d->n_keys;
    case 5:
      *a = d->other_blob.data();
      return (long long)d->other_blob.size();
  }
  return -1;
}

void vn_drain_stats(void* dp, unsigned long long* out4) {
  auto* d = (DrainResult*)dp;
  out4[0] = d->b.processed;
  out4[1] = d->b.malformed;
  out4[2] = d->b.packets;
  out4[3] = d->b.too_long;
}

void vn_drain_free(void* dp) { delete (DrainResult*)dp; }

void vn_totals(void* ep, unsigned long long* out4) {
  auto* e = (Engine*)ep;
  out4[0] = e->tot_processed.load();
  out4[1] = e->tot_malformed.load();
  out4[2] = e->tot_packets.load();
  out4[3] = e->tot_too_long.load();
}

// -- stage accounting (profiling subsystem; roadmap #4) ---------------------

long long vn_stage_thread_count(void* ep) {
  auto* e = (Engine*)ep;
  std::lock_guard<std::mutex> l(e->bufs_mu);
  return (long long)e->bufs.size();
}

// Per-thread stage counters, nanoseconds already converted: writes up to
// cap_threads rows of 8 u64 each — {recv_pkts, recv_ns, parse_pkts,
// parse_ns, intern_calls, intern_ns, stage_vals, stage_ns} — and returns
// the number of rows written.  Monotonic (counters only ever grow).
long long vn_stage_stats(void* ep, unsigned long long* out,
                         long long cap_threads) {
  auto* e = (Engine*)ep;
  double r = e->ns_per_tick();
  std::vector<ThreadBuf*> tbs;
  {
    std::lock_guard<std::mutex> l(e->bufs_mu);
    for (auto& tb : e->bufs) tbs.push_back(tb.get());
  }
  long long n = 0;
  auto ns = [r](const std::atomic<uint64_t>& t) {
    return (unsigned long long)((double)t.load(std::memory_order_relaxed)
                                * r);
  };
  auto raw = [](const std::atomic<uint64_t>& c) {
    return (unsigned long long)c.load(std::memory_order_relaxed);
  };
  for (ThreadBuf* tb : tbs) {
    if (n >= cap_threads) break;
    StageCounters& st = tb->stages;
    unsigned long long* row = out + n * 8;
    row[0] = raw(st.recv_pkts);
    row[1] = mono_latch(st.rep_recv_ns, ns(st.recv_ticks));
    row[2] = raw(st.parse_pkts);
    row[3] = mono_latch(st.rep_parse_ns, ns(st.parse_ticks));
    row[4] = raw(st.intern_calls);
    row[5] = mono_latch(st.rep_intern_ns, ns(st.intern_ticks));
    row[6] = raw(st.stage_vals);
    row[7] = mono_latch(st.rep_stage_ns, ns(st.stage_ticks));
    n++;
  }
  return n;
}

// Engine-level drain stage: {calls, packets drained, ns}.
void vn_stage_drain(void* ep, unsigned long long* out3) {
  auto* e = (Engine*)ep;
  double r = e->ns_per_tick();
  out3[0] = e->drain_calls.load(std::memory_order_relaxed);
  out3[1] = e->drain_pkts.load(std::memory_order_relaxed);
  out3[2] = mono_latch(
      e->rep_drain_ns,
      (unsigned long long)(
          (double)e->drain_ticks.load(std::memory_order_relaxed) * r));
}

unsigned long long vn_intern_count(void* ep) {
  auto* e = (Engine*)ep;
  unsigned long long n = 0;
  for (auto& sh : e->shards) {
    std::lock_guard<std::mutex> l(sh.mu);
    n += sh.count;
  }
  return n;
}

unsigned long long vn_metro64(const char* data, long n) {
  return metro64((const uint8_t*)data, (size_t)n, 1337);
}

// Benchmark helper: blast prebuilt payloads at a UDP address with sendmmsg.
// blob holds payloads back to back; offs has n_payloads+1 offsets.  Returns
// packets handed to the kernel (loopback drops are the receiver's story).
long long vn_blast_udp(const char* ip, int port, long long n_packets,
                       const char* blob, const long long* offs,
                       int n_payloads) {
  if (n_payloads <= 0 || n_packets <= 0) return 0;
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  inet_pton(AF_INET, ip, &addr.sin_addr);
  if (connect(fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
    close(fd);
    return -1;
  }
  constexpr int VLEN = 64;
  std::vector<iovec> iov(VLEN);
  std::vector<mmsghdr> msgs(VLEN);
  long long sent = 0;
  int pi = 0;
  while (sent < n_packets) {
    int batch = (int)std::min<long long>(VLEN, n_packets - sent);
    for (int i = 0; i < batch; i++) {
      iov[i] = {(void*)(blob + offs[pi]), (size_t)(offs[pi + 1] - offs[pi])};
      memset(&msgs[i], 0, sizeof(mmsghdr));
      msgs[i].msg_hdr.msg_iov = &iov[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
      pi = (pi + 1) % n_payloads;
    }
    int r = sendmmsg(fd, msgs.data(), batch, 0);
    if (r < 0) {
      if (errno == EINTR || errno == EAGAIN || errno == ENOBUFS) continue;
      break;
    }
    sent += r;
  }
  close(fd);
  return sent;
}

// COO -> dense fill for the flush's dense build (the aggregator's
// host-side hot loop at 1M keys; VERDICT r4 item 4).  Single pass with
// per-dense-row write cursors; threads partition the DENSE ROW space
// into disjoint ranges (each scans the whole COO input and fills only
// its rows), so there are no races and no atomics on the fill path.
// Within-row ordering is arrival order per thread — quantile evaluation
// is order-invariant, so any bijection (row, position) is valid.
//
// rows:  int64[n] arena row ids
// vals:  float64[n] staged values
// wts:   float64[n] staged weights, or null for the uniform (all-1) path
// dense_id: int64[capacity] arena row -> dense row (-1 = untouched)
// capacity: length of dense_id — rows[i] outside [0, capacity) is a
//   CORRUPT staged row id and is dropped (never indexed: NumPy-side
//   negative indices would wrap, and here they would read out of
//   bounds, so the guard lives on both sides of the FFI)
// dv/dw: float32[u_pad*d_pad] outputs (dw null on the uniform path)
// depths: int16[u_pad] per-dense-row fill counts (may be null)
// Returns the number of DROPPED elements (row id out of bounds,
// rid < 0, or row overflow past d_pad); the caller falls back to the
// numpy builder when nonzero.
long long vn_fill_dense(const long long* rows, const double* vals,
                        const double* wts, long long n,
                        const long long* dense_id, long long capacity,
                        float* dv, float* dw, short* depths,
                        long long u_pad, long long d_pad,
                        int n_threads) {
  std::vector<int> cursor((size_t)u_pad, 0);
  std::atomic<long long> dropped{0};
  auto work = [&](long long lo, long long hi) {
    long long local_dropped = 0;
    for (long long i = 0; i < n; i++) {
      long long row = rows[i];
      if (row < 0 || row >= capacity) {
        if (lo == 0) local_dropped++;  // count once, thread 0
        continue;
      }
      long long rid = dense_id[row];
      if (rid < lo || rid >= hi) {
        if (rid < 0 && lo == 0) local_dropped++;  // count once, thread 0
        continue;
      }
      int p = cursor[(size_t)rid]++;
      if (p >= d_pad) {
        local_dropped++;
        continue;
      }
      dv[rid * d_pad + p] = (float)vals[i];
      if (dw) dw[rid * d_pad + p] = (float)wts[i];
    }
    if (local_dropped) dropped.fetch_add(local_dropped);
  };
  if (n_threads <= 1) {
    work(0, u_pad);
  } else {
    std::vector<std::thread> ts;
    long long per = (u_pad + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      long long lo = t * per;
      long long hi = std::min<long long>(u_pad, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
  if (depths) {
    for (long long r = 0; r < u_pad; r++)
      depths[r] = (short)std::min<int>(cursor[(size_t)r], (int)d_pad);
  }
  return dropped.load();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Proxy wire router (VERDICT r4 item 5): parse-free consistent-hash
// routing of a serialized forwardrpc.MetricList.  A MetricList body is
// `repeated Metric metrics = 1` — a sequence of (tag 0x0A, varint len,
// Metric bytes) records — and protobuf messages concatenate, so
// splitting the input at record boundaries and regrouping the raw
// records per destination yields VALID MetricList bodies with zero
// (de)serialization.  Only the three routing fields are scanned per
// metric (name=1, tags=2, type=3; `metricpb/metric.proto`), the key is
// name + typename + ",".join(tags) (proxy routing contract,
// `handlers.go:111-112`), hashed with zlib-compatible CRC32 onto the
// caller's consistent ring.
// ---------------------------------------------------------------------------

namespace {

uint32_t crc32_zlib(const uint8_t* p, size_t n, uint32_t seed) {
  static uint32_t table[256];
  static std::once_flag once;
  std::call_once(once, [] {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : (c >> 1);
      table[i] = c;
    }
  });
  uint32_t c = seed ^ 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

inline bool read_varint(const uint8_t*& p, const uint8_t* end,
                        uint64_t& out) {
  uint64_t v = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    v |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      out = v;
      return true;
    }
    shift += 7;
  }
  return false;
}

static const char* kTypeNames[5] = {"counter", "gauge", "histogram",
                                    "set", "timer"};

struct RouteResult {
  std::vector<uint8_t> blob;                 // dest regions, concatenated
  std::vector<long long> dest_off;           // n_dests+1 prefix offsets
  std::vector<long long> dest_count;         // metrics per dest
  std::vector<std::vector<long long>> chunk_off;  // per dest, relative
};

}  // namespace

extern "C" {

// Returns an opaque RouteResult*, or null on malformed input (caller
// falls back to the Python protobuf path).
void* vn_route(const uint8_t* data, long long len,
               const uint32_t* ring_hashes, const int32_t* ring_dests,
               long long ring_len, int n_dests, int chunk_max) {
  // chunk_max <= 0 would divide-by-zero in the chunking loop (UBSan)
  if (n_dests <= 0 || ring_len <= 0 || chunk_max <= 0) return nullptr;
  struct Rec {
    const uint8_t* start;   // record start (incl. tag+len prefix)
    long long size;
    int dest;
  };
  std::vector<Rec> recs;
  std::vector<uint8_t> key;
  key.reserve(256);
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  while (p < end) {
    uint64_t tag;
    const uint8_t* rec_start = p;
    if (!read_varint(p, end, tag)) return nullptr;
    int field = (int)(tag >> 3), wt = (int)(tag & 7);
    if (field != 1 || wt != 2) {
      // non-metrics field in the list: unexpected; skip by wire type
      uint64_t tmp;
      switch (wt) {
        case 0: if (!read_varint(p, end, tmp)) return nullptr; break;
        case 1: if (end - p < 8) return nullptr; p += 8; break;
        case 2: if (!read_varint(p, end, tmp) ||
                    (uint64_t)(end - p) < tmp) return nullptr;
                p += tmp; break;
        case 5: if (end - p < 4) return nullptr; p += 4; break;
        default: return nullptr;
      }
      continue;
    }
    uint64_t mlen;
    if (!read_varint(p, end, mlen) || (uint64_t)(end - p) < mlen)
      return nullptr;
    const uint8_t* m = p;
    const uint8_t* mend = p + mlen;
    p = mend;
    // scan the Metric for name/tags/type
    const uint8_t* name = nullptr;
    uint64_t name_len = 0;
    uint64_t type_val = 0;
    key.clear();
    std::vector<std::pair<const uint8_t*, uint64_t>> tags;
    const uint8_t* q = m;
    while (q < mend) {
      uint64_t mtag;
      if (!read_varint(q, mend, mtag)) return nullptr;
      int mf = (int)(mtag >> 3), mwt = (int)(mtag & 7);
      if (mf == 1 && mwt == 2) {
        if (!read_varint(q, mend, name_len) ||
            (uint64_t)(mend - q) < name_len) return nullptr;
        name = q;
        q += name_len;
      } else if (mf == 2 && mwt == 2) {
        uint64_t tl;
        if (!read_varint(q, mend, tl) ||
            (uint64_t)(mend - q) < tl) return nullptr;
        tags.emplace_back(q, tl);
        q += tl;
      } else if (mf == 3 && mwt == 0) {
        if (!read_varint(q, mend, type_val)) return nullptr;
      } else {
        uint64_t tmp;
        switch (mwt) {
          case 0: if (!read_varint(q, mend, tmp)) return nullptr; break;
          case 1: if (mend - q < 8) return nullptr; q += 8; break;
          case 2: if (!read_varint(q, mend, tmp) ||
                      (uint64_t)(mend - q) < tmp) return nullptr;
                  q += tmp; break;
          case 5: if (mend - q < 4) return nullptr; q += 4; break;
          default: return nullptr;
        }
      }
    }
    // routing key: name + typename + ",".join(tags)
    if (name) key.insert(key.end(), name, name + name_len);
    if (type_val < 5) {
      const char* tn = kTypeNames[type_val];
      key.insert(key.end(), (const uint8_t*)tn,
                 (const uint8_t*)tn + strlen(tn));
    }
    for (size_t t = 0; t < tags.size(); t++) {
      if (t) key.push_back(',');
      key.insert(key.end(), tags[t].first, tags[t].first + tags[t].second);
    }
    uint32_t h = crc32_zlib(key.data(), key.size(), 0);
    // bisect_right(ring_hashes, h), wrapping to 0 (consistent.py)
    long long lo = 0, hi = ring_len;
    while (lo < hi) {
      long long mid = (lo + hi) >> 1;
      if (ring_hashes[mid] <= h) lo = mid + 1;
      else hi = mid;
    }
    int dest = ring_dests[lo == ring_len ? 0 : lo];
    if (dest < 0 || dest >= n_dests) return nullptr;
    recs.push_back({rec_start, (long long)(p - rec_start), dest});
  }

  auto* res = new RouteResult();
  res->dest_off.assign(n_dests + 1, 0);
  res->dest_count.assign(n_dests, 0);
  res->chunk_off.resize(n_dests);
  for (auto& r : recs) {
    res->dest_off[r.dest + 1] += r.size;
    res->dest_count[r.dest]++;
  }
  for (int d = 0; d < n_dests; d++)
    res->dest_off[d + 1] += res->dest_off[d];
  res->blob.resize((size_t)res->dest_off[n_dests]);
  std::vector<long long> cursor(res->dest_off.begin(),
                                res->dest_off.end() - 1);
  std::vector<long long> cnt(n_dests, 0);
  for (auto& r : recs) {
    if (cnt[r.dest] % chunk_max == 0)
      res->chunk_off[r.dest].push_back(
          cursor[r.dest] - res->dest_off[r.dest]);
    memcpy(res->blob.data() + cursor[r.dest], r.start, (size_t)r.size);
    cursor[r.dest] += r.size;
    cnt[r.dest]++;
  }
  for (int d = 0; d < n_dests; d++)
    res->chunk_off[d].push_back(
        res->dest_off[d + 1] - res->dest_off[d]);   // end sentinel
  return res;
}

void vn_route_dest(void* handle, int d, const uint8_t** ptr,
                   long long* nbytes, long long* count) {
  auto* res = (RouteResult*)handle;
  *ptr = res->blob.data() + res->dest_off[d];
  *nbytes = res->dest_off[d + 1] - res->dest_off[d];
  *count = res->dest_count[d];
}

void vn_route_chunks(void* handle, int d, const long long** offs,
                     long long* n_bounds) {
  auto* res = (RouteResult*)handle;
  *offs = res->chunk_off[d].data();
  *n_bounds = (long long)res->chunk_off[d].size();
}

void vn_route_free(void* handle) { delete (RouteResult*)handle; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Global-tier V1 import scanner: one pass over a serialized MetricList
// producing columnar (identity hash, kind, value, record range) arrays,
// so the importing aggregator's python does only dict lookups + one
// vectorized merge per family — the per-metric python attribute reads
// (tuple(pb.tags) alone is ~2 us) were the fleet-rate inbound ceiling.
// Identity = metro64 of (name \0 type \x1F tag \x1E tag ...) under two
// seeds (128 bits: collisions are ~1e-20 at 1M identities); set and
// histogram records are handed back as byte ranges for the python slow
// path (they carry sketches that python merges anyway).
// ---------------------------------------------------------------------------

namespace {

struct ImportScan {
  std::vector<uint64_t> h_lo, h_hi;
  std::vector<uint8_t> which;   // 0 none/unknown, 1 counter, 2 gauge,
                                // 3 set, 4 histogram
  std::vector<uint8_t> mtype;   // metricpb Type enum
  std::vector<uint8_t> scope;   // metricpb Scope enum
  std::vector<double> value;    // counter/gauge payload
  std::vector<long long> rec_off, rec_len;  // Metric submessage range
};

}  // namespace

extern "C" {

void* vn_import_scan(const uint8_t* data, long long len) {
  auto* res = new ImportScan();
  std::vector<uint8_t> key;
  key.reserve(256);
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, tag)) { delete res; return nullptr; }
    int field = (int)(tag >> 3), wt = (int)(tag & 7);
    if (field != 1 || wt != 2) {
      uint64_t tmp;
      switch (wt) {
        case 0: if (!read_varint(p, end, tmp)) { delete res; return nullptr; } break;
        case 1: if (end - p < 8) { delete res; return nullptr; } p += 8; break;
        case 2: if (!read_varint(p, end, tmp) ||
                    (uint64_t)(end - p) < tmp) { delete res; return nullptr; }
                p += tmp; break;
        case 5: if (end - p < 4) { delete res; return nullptr; } p += 4; break;
        default: delete res; return nullptr;
      }
      continue;
    }
    uint64_t mlen;
    if (!read_varint(p, end, mlen) || (uint64_t)(end - p) < mlen) {
      delete res; return nullptr;
    }
    const uint8_t* m = p;
    const uint8_t* mend = p + mlen;
    p = mend;

    const uint8_t* name = nullptr;
    uint64_t name_len = 0;
    uint64_t type_val = 0, scope_val = 0;
    uint8_t which = 0;
    double value = 0.0;
    std::vector<std::pair<const uint8_t*, uint64_t>> tags;
    const uint8_t* q = m;
    bool ok = true;
    while (q < mend && ok) {
      uint64_t mtag;
      if (!read_varint(q, mend, mtag)) { ok = false; break; }
      int mf = (int)(mtag >> 3), mwt = (int)(mtag & 7);
      if (mf == 1 && mwt == 2) {
        if (!read_varint(q, mend, name_len) ||
            (uint64_t)(mend - q) < name_len) { ok = false; break; }
        name = q; q += name_len;
      } else if (mf == 2 && mwt == 2) {
        uint64_t tl;
        if (!read_varint(q, mend, tl) ||
            (uint64_t)(mend - q) < tl) { ok = false; break; }
        tags.emplace_back(q, tl); q += tl;
      } else if (mf == 3 && mwt == 0) {
        if (!read_varint(q, mend, type_val)) { ok = false; break; }
      } else if (mf == 9 && mwt == 0) {
        if (!read_varint(q, mend, scope_val)) { ok = false; break; }
      } else if (mf == 5 && mwt == 2) {          // CounterValue
        uint64_t sl;
        if (!read_varint(q, mend, sl) ||
            (uint64_t)(mend - q) < sl) { ok = false; break; }
        const uint8_t* s = q;
        const uint8_t* send_ = q + sl;
        q = send_;
        which = 1;
        while (s < send_) {
          uint64_t st;
          if (!read_varint(s, send_, st)) { ok = false; break; }
          if ((st >> 3) == 1 && (st & 7) == 0) {  // int64 value
            uint64_t v;
            if (!read_varint(s, send_, v)) { ok = false; break; }
            value = (double)(int64_t)v;
          } else { ok = false; break; }
        }
      } else if (mf == 6 && mwt == 2) {          // GaugeValue
        uint64_t sl;
        if (!read_varint(q, mend, sl) ||
            (uint64_t)(mend - q) < sl) { ok = false; break; }
        const uint8_t* s = q;
        const uint8_t* send_ = q + sl;
        q = send_;
        which = 2;
        while (s < send_) {
          uint64_t st;
          if (!read_varint(s, send_, st)) { ok = false; break; }
          if ((st >> 3) == 1 && (st & 7) == 1) {  // double value
            if (send_ - s < 8) { ok = false; break; }
            memcpy(&value, s, 8); s += 8;
          } else { ok = false; break; }
        }
      } else if (mf == 7 && mwt == 2) {          // HistogramValue
        uint64_t sl;
        if (!read_varint(q, mend, sl) ||
            (uint64_t)(mend - q) < sl) { ok = false; break; }
        q += sl; which = 4;
      } else if (mf == 8 && mwt == 2) {          // SetValue
        uint64_t sl;
        if (!read_varint(q, mend, sl) ||
            (uint64_t)(mend - q) < sl) { ok = false; break; }
        q += sl; which = 3;
      } else {
        uint64_t tmp;
        switch (mwt) {
          case 0: if (!read_varint(q, mend, tmp)) ok = false; break;
          case 1: if (mend - q < 8) { ok = false; } else q += 8; break;
          case 2:
            if (!read_varint(q, mend, tmp) ||
                (uint64_t)(mend - q) < tmp) {
              ok = false;
            } else {
              q += tmp;
            }
            break;
          case 5: if (mend - q < 4) { ok = false; } else q += 4; break;
          default: ok = false;
        }
      }
    }
    if (!ok) { delete res; return nullptr; }
    key.clear();
    if (name) key.insert(key.end(), name, name + name_len);
    key.push_back(0);
    key.push_back((uint8_t)type_val);
    for (auto& t : tags) {
      key.push_back(0x1E);
      key.insert(key.end(), t.first, t.first + t.second);
    }
    res->h_lo.push_back(metro64(key.data(), key.size(), 1337));
    res->h_hi.push_back(metro64(key.data(), key.size(), 7331));
    res->which.push_back(which);
    res->mtype.push_back((uint8_t)type_val);
    res->scope.push_back((uint8_t)scope_val);
    res->value.push_back(value);
    res->rec_off.push_back((long long)(m - data));
    res->rec_len.push_back((long long)mlen);
  }
  return res;
}

long long vn_import_scan_n(void* handle) {
  return (long long)((ImportScan*)handle)->h_lo.size();
}

void vn_import_scan_arrays(void* handle, const uint64_t** h_lo,
                           const uint64_t** h_hi, const uint8_t** which,
                           const uint8_t** mtype, const uint8_t** scope,
                           const double** value,
                           const long long** rec_off,
                           const long long** rec_len) {
  auto* r = (ImportScan*)handle;
  *h_lo = r->h_lo.data(); *h_hi = r->h_hi.data();
  *which = r->which.data(); *mtype = r->mtype.data();
  *scope = r->scope.data(); *value = r->value.data();
  *rec_off = r->rec_off.data(); *rec_len = r->rec_len.data();
}

void vn_import_scan_free(void* handle) { delete (ImportScan*)handle; }

}  // extern "C"
