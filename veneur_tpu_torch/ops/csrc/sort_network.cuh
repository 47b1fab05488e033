// Device functions of the per-row sort networks, shared by the flush's
// kernels (sorted_eval.cu: B1-B4, and the stage cuts H1/H2 built from
// B1's own pieces) and by the compactor pass (compactor_eval.cu: B6,
// which sorts each level's staged keys with warp_bitonic), so a cut can
// never time a stale copy of a production stage.
//
// The warp functions (stage_chunk, warp_bitonic, sort_word,
// compact_sort_word, sorted_pairs, warp_scan, warp_tree_sum) run every
// flush kernel of sorted_eval.cu (B1, B2, B3, B4) and H1/H2: each warp
// of a CTA works alone on a chunk of 32 E points held in registers (see
// lane_points), with no barrier but __syncwarp.  The formulation bench
// (sort_variants.cu: H3) keeps its block functions (bitonic_rows,
// row_sums, compact_word, compact_network) to itself and takes
// warp_tree_sum from here.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------------------
// The warp functions: B1, B2, B3, B4 and the stage cuts H1/H2
// ---------------------------------------------------------------------------
//
// A warp holds a chunk of 32 E consecutive points of the row-major
// [U, D] operands, whole rows of D points: lane l holds the chunk's
// points l E .. l E + E - 1 in registers.  E divides D (lane_points),
// so a row spans L = D / E <= 32 whole lanes and no lane holds points
// of two rows; strides below E stay inside a lane.  Each warp stages
// its chunk in shared memory of its own and takes one chunk, so the
// warps of a CTA never wait for each other, and as CTAs finish and new
// ones start, the loads of some overlap the sorts of others.

constexpr int kWarps = 4;                     // warps per CTA
constexpr int kWarpThreads = 32 * kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;

// E, the points a lane holds in rows of depth d: the most the registers
// take (32) where a row spans at least two lanes, else a row a lane
// (D <= 8) or two (D = 16, 32), which the card's times favour.
inline int lane_points(int d) {
  return d <= 8 ? d : (d <= 32 ? d / 2 : 32);
}

// The CTAs of kWarps warps whose chunks of 32 e points cover u rows of d.
inline int warp_blocks(int u, int d, int e) {
  const long points = 32L * e * kWarps;
  return static_cast<int>((static_cast<long>(u) * d + points - 1) / points);
}

// A warp's staging in shared memory holds chunk point p at slot(p): one
// pad word after every 32 points, so the points a lane reads in turn
// (l E + r for r < E) and the 32 points of a coalesced step lie in
// different banks.  kStaging<E> words hold a chunk.
__device__ __forceinline__ int slot(int p) { return p + (p >> 5); }
template <int E>
constexpr int kStaging = 33 * E;

// Calls f(std::integral_constant<int, E>) for the E of rows of depth d
// (a power of two in [2, 1024]); cudaErrorInvalidValue for another d.
template <typename F>
int with_lane_points(int d, F&& f) {
  if (d < 2 || d > 1024 || (d & (d - 1)) != 0) return cudaErrorInvalidValue;
  switch (lane_points(d)) {
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return cudaErrorInvalidValue;
  }
}

// The 4 (f32) or 8 (bf16) values of one 16-byte load, widened to f32,
// at dst[0..]: a bf16 widens to the f32 whose top half it is; the value
// at the lower address is the low half of its 32-bit word.
template <typename T>
__device__ __forceinline__ void store_widened(uint4 b, float* dst) {
  if constexpr (sizeof(T) == 4) {
    dst[0] = __uint_as_float(b.x);
    dst[1] = __uint_as_float(b.y);
    dst[2] = __uint_as_float(b.z);
    dst[3] = __uint_as_float(b.w);
  } else {
    const unsigned h[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dst[2 * c] = __uint_as_float(h[c] << 16);
      dst[2 * c + 1] = __uint_as_float(h[c] & 0xFFFF0000u);
    }
  }
}

// Stages a warp's chunk, the points [base, base + 32 E) of the [U, D]
// operands, in its shared memory: sv[slot(i)] the value of point
// base + i widened to f32, sw[slot(i)] its weight, both 0 from `limit`
// (the end of the last row) on.  kWeights false (B3, which has no
// weight operand): the values alone, `weight` and `sw` unread.  A lane
// loads 16 bytes of an operand at a time, the lanes of the warp on
// neighbouring addresses; a chunk that ends past `limit` or does not
// start on a 16-byte boundary loads point by point.  The caller
// __syncwarp()s before a lane reads another lane's points.
template <int E, bool kWeights = true, typename T>
__device__ void stage_chunk(const T* __restrict__ mean,
                            const float* __restrict__ weight, float* sv,
                            float* sw, long base, long limit, int lane) {
  constexpr int kN = 32 * E;                       // points of the chunk
  constexpr int kPerVec = 16 / sizeof(T);          // values a load
  constexpr int kW = (kN / 4 + 31) / 32;           // weight loads a lane
  constexpr int kV = (kN / kPerVec + 31) / 32;     // value loads a lane
  const T* m = mean + base;
  const float* w = nullptr;
  size_t addr = reinterpret_cast<size_t>(m);
  if constexpr (kWeights) {
    w = weight + base;
    addr |= reinterpret_cast<size_t>(w);
  }
  if (base + kN <= limit && (addr & 15) == 0) {
    // loads of global memory and stores to shared memory cannot alias,
    // so the unrolled loops issue every load before the first store;
    // the 4 or 8 points of a load never straddle a pad word
    if constexpr (kWeights) {
      const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        const int i = lane + 32 * k;
        if (i >= kN / 4) continue;
        const float4 x = __ldg(w4 + i);
        float* dst = sw + slot(4 * i);
        dst[0] = x.x;
        dst[1] = x.y;
        dst[2] = x.z;
        dst[3] = x.w;
      }
    }
    const uint4* m4 = reinterpret_cast<const uint4*>(m);
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      const int i = lane + 32 * k;
      if (i >= kN / kPerVec) continue;
      store_widened<T>(__ldg(m4 + i), sv + slot(kPerVec * i));
    }
  } else {
    for (int i = lane; i < kN; i += 32) {
      float v = 0.0f, ww = 0.0f;
      if (base + i < limit) {
        v = widen(m[i]);
        if constexpr (kWeights) ww = w[i];
      }
      sv[slot(i)] = v;
      if constexpr (kWeights) sw[slot(i)] = ww;
    }
  }
}

// One compare-exchange of bitonic_rows' rule: the pair swaps only when
// its lower point is strictly greater (ascending) or strictly less
// (descending), so equal keys never move.
template <typename K>
__device__ __forceinline__ void exchange(K& lo, K& hi, bool asc) {
  const K a = lo;
  const K b = hi;
  const bool swap = asc ? (a > b) : (a < b);
  lo = swap ? b : a;
  hi = swap ? a : b;
}

// Ascending bitonic sort of every D-long row of a warp's chunk, x[r]
// being the lane's point l E + r: strides below E compare inside the
// lane, the others exchange with lane l ^ (j / E) by shuffles.  It makes
// bitonic_rows' exchanges on the same keys (exchange's rule).  The
// merges of runs shorter than E lie inside a lane, with directions
// known at compile time; from k = E on, a merge has one direction for
// all of a lane's points.
template <int E, typename K>
__device__ void warp_bitonic(K (&x)[E], int d, int lane) {
#pragma unroll
  for (int k = 2; k < E; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        if ((r & j) == 0) exchange(x[r], x[r | j], (r & k) == 0);
      }
    }
  }
  const int first = (lane * E) & (d - 1);    // column of x[0] in its row
  for (int k = E; k <= d; k <<= 1) {
    const bool asc = (first & k) == 0;
    for (int j = k >> 1; j >= E; j >>= 1) {
      const bool lower = (lane & (j / E)) == 0;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const K other = __shfl_xor_sync(kFull, x[r], j / E);
        const K lo = lower ? x[r] : other;
        const K hi = lower ? other : x[r];
        if (asc ? (lo > hi) : (lo < hi)) x[r] = other;
      }
    }
#pragma unroll
    for (int j = E >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        if ((r & j) == 0) exchange(x[r], x[r | j], asc);
      }
    }
  }
}

// B1's sort word: the f32 key's bits through the monotone IEEE map
// (negatives flip every bit, positives set the sign bit) in the high 32
// bits and the point's column in the low ones, so the unsigned order of
// the words is (key ascending, column ascending) and the words of a row
// are distinct: sorting them is a stable sort of the keys.  A hole
// (w <= 0) keys +inf; -0 keys as +0 (the plain version's stable sort
// holds them equal, so the column decides); every NaN keys above +inf,
// where torch.sort puts NaN.
__device__ __forceinline__ unsigned long long sort_word(float v, float w,
                                                        int col) {
  unsigned b = w > 0.0f ? __float_as_uint(v) : 0x7F800000u;
  if (b == 0x80000000u) b = 0u;
  if ((b & 0x7FFFFFFFu) > 0x7F800000u) b = 0x7FFFFFFFu;
  const unsigned key = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(key) << 32) |
         static_cast<unsigned>(col);
}

// B4's sort word: sort_word's order in 32 bits, for bf16 values.  v is
// the staged value, a bf16 widened to the f32 whose top half it is, so
// v's top 16 bits are the bf16's: they go through the monotone map into
// the high half, the column (< 64) into the low half.  A hole keys
// +inf, -0 as +0 and every NaN above +inf, as in sort_word (unlike
// compact_word, H3's c0, which keys a negative-signed NaN below -inf).
__device__ __forceinline__ unsigned compact_sort_word(float v, float w,
                                                      int col) {
  unsigned b = w > 0.0f ? (__float_as_uint(v) >> 16) : 0x7F80u;
  if (b == 0x8000u) b = 0u;
  if ((b & 0x7FFFu) > 0x7F80u) b = 0x7FFFu;
  const unsigned m16 = (b & 0x8000u) ? (0xFFFFu - b) : (b | 0x8000u);
  return (m16 << 16) | static_cast<unsigned>(col);
}

// The sort words of sorted_pairs: B1's 64-bit sort_word, or B4's 32-bit
// compact_sort_word (bf16 values, D <= 64), each with its column.
struct WideWord {
  using type = unsigned long long;
  static __device__ __forceinline__ type make(float v, float w, int col) {
    return sort_word(v, w, col);
  }
  static __device__ __forceinline__ int col(type x) {
    return static_cast<int>(static_cast<unsigned>(x));
  }
};
struct CompactWord {
  using type = unsigned;
  static __device__ __forceinline__ type make(float v, float w, int col) {
    return compact_sort_word(v, w, col);
  }
  static __device__ __forceinline__ int col(type x) {
    return static_cast<int>(x & 0xFFFFu);
  }
};

// B1's (and B4's) sort of a staged chunk (stage_chunk, then
// __syncwarp): each lane packs its E words, warp_bitonic sorts them,
// and each sorted word's column gathers its point's staged value and
// weight (the staged value, not the key, so a -0 stays -0).  v[r], w[r]
// are then the lane's points in sorted order.  Ends with a __syncwarp,
// after which the staging may be overwritten.
template <int E, typename Word = WideWord>
__device__ void sorted_pairs(const float* sv, const float* sw, int d,
                             int lane, float (&v)[E], float (&w)[E]) {
  const int p0 = lane * E;
  typename Word::type word[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int at = slot(p0 + r);
    word[r] = Word::make(sv[at], sw[at], (p0 + r) & (d - 1));
  }
  warp_bitonic<E>(word, d, lane);
  const int row = p0 & ~(d - 1);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int src = slot(row + Word::col(word[r]));
    v[r] = sv[src];
    w[r] = sw[src];
  }
  __syncwarp();
}

// Inclusive prefix sums along each row of a warp's chunk, x[r] being the
// lane's point l E + r: each lane adds up its own E points in order,
// a Hillis-Steele scan over the row's L = D / E lanes adds up their
// totals, and every lane but the row's first adds the total of the
// lanes before it to each of its points.  The order of the adds depends
// on D alone; exact for integer weights below 2^24.
template <int E>
__device__ void warp_scan(float (&x)[E], int d, int lane) {
#pragma unroll
  for (int r = 1; r < E; ++r) x[r] = __fadd_rn(x[r - 1], x[r]);
  const int lanes = d / E;
  const int pos = lane & (lanes - 1);
  float run = x[E - 1];
  for (int s = 1; s < lanes; s <<= 1) {
    const float y = __shfl_up_sync(kFull, run, s);
    if (pos >= s) run = __fadd_rn(y, run);
  }
  const float before = __shfl_up_sync(kFull, run, 1);
  if (pos > 0) {
#pragma unroll
    for (int r = 0; r < E; ++r) x[r] = __fadd_rn(before, x[r]);
  }
}

// The sum of x over the `lanes` lanes of a row, in every one of them.
__device__ __forceinline__ int row_lanes_sum(int x, int lanes) {
  for (int s = 1; s < lanes; s <<= 1) x += __shfl_xor_sync(kFull, x, s);
  return x;
}

// The sum of each row of a warp's chunk by row_sums' fixed pairwise
// tree (at step s = D/2, ..., 1 column c < s adds column c + s), left in
// x[0] of the row's first lane.
template <int E>
__device__ void warp_tree_sum(float (&x)[E], int d) {
  for (int s = d >> 1; s >= E; s >>= 1) {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      x[r] = __fadd_rn(x[r], __shfl_down_sync(kFull, x[r], s / E));
    }
  }
  // inner trip counts fixed at E / 2, so both loops unroll and x stays
  // in registers
#pragma unroll
  for (int s = E >> 1; s > 0; s >>= 1) {
#pragma unroll
    for (int r = 0; r < E / 2; ++r) {
      if (r < s) x[r] = __fadd_rn(x[r], x[r + s]);
    }
  }
}

}  // namespace
