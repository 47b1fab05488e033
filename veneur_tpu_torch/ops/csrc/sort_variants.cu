// H3: formulations of the bitonic compare-exchange stage, the Hopper
// counterpart of scripts/sort_variants.py (`run` -> `make_kernel(mode)`,
// pallas_call at :213).  Each sorts every row of [U, D] f32 values
// (keyed +inf where the weight is not positive) with its weights, then
// writes [U, 3] f32: key[0], key[D/2] and the sum over the row of
// key * (key != +inf ? w : 0), the last by the fixed pairwise tree of
// row_sums, so every formulation gives the same bits for the same
// sorted pairs.  On the harness's input (bf16-exact values, weights 1)
// all give the same bits.
//
// The TPU's variants differ in how a stage finds its partner (roll,
// flip, concatenated slices) and in the shape of its masks; none of that
// has a meaning on Hopper.  Each mode keeps the idea it carries:
//   0 (v0)      the paired network in shared memory: one __syncthreads
//               a stage, a conditional swap moving a key and a weight
//               (bitonic_rows<kV0>; B1's formulation before B1 moved to
//               packed words in registers);
//   1 (v1, v2)  the min/max + moved-mask stage of sorted_eval.py:176-195:
//               branch-free selects, every slot written, still in
//               shared memory with one barrier a stage (bitonic_rows<kV1>);
//   2 (v3..v6)  the partner by xor with the points in registers: E =
//               min(D, 16) consecutive points a thread, stages of stride
//               j < E inside the thread, E <= j < 32 E by
//               __shfl_xor_sync with no barrier, and only j >= 32 E
//               through shared memory (one barrier a stage; D = 1024
//               alone has such a stage);
//   3 (c0)      the packed bf16-key|column word network in registers,
//               two points a lane (compact_network, B4's first
//               formulation), D <= 64, then the gather of each point's
//               value and weight: a warp's work (two 64-point chunks at
//               once), with no block barrier;
//   4 (c1)      the key-only network (bitonic_rows<kC1>, B3's first
//               formulation, whose exchanges B3's warp network makes)
//               on the keys rounded to bf16 and widened at load; the
//               weights stay in column order, as the TPU's c1 emits
//               them.
// c0 and c1 round the f32 values to bf16 (round to nearest even) at
// load; on bf16-exact input that changes nothing.
//
// What is shared around the stage.  v0, v1 and c1 sort a tile of
// kTile = 4096 points a CTA (4 to 2048 rows) with 512 threads, four
// compare-exchanges a thread a stage that share one index (the pairs
// lie 1024 points apart), after 16-byte loads of the tile.  Their
// shared arrays are swizzled (tile_slot: the words of every odd 32-word
// block in reverse), so no stage's reads or writes meet a bank
// conflict.  The emit is row_sums: a warp a row (or 32 / D rows), the
// tree's wide steps in place in the lane's own columns and then by
// shuffles, with no barrier.  v3 emits from its registers
// (warp_tree_sum), c0 from each lane's two points a chunk.
//
// Bounded by bytes: 2 U D 4 in, U 12 out, over 3.35 TB/s; the network's
// U D log2(D) (log2(D) + 1) / 4 compare-exchanges take a fraction of
// that at the card's f32 rate.  Formulation floors (shared-memory bytes
// over the card's ~30 TB/s of shared bandwidth) are in PERF.md.

#include "sort_network.cuh"

namespace {

constexpr int kV0 = 0, kV1 = 1, kXor = 2, kC0 = 3, kC1 = 4;
constexpr int kMaxCompactDepth = 64;

// ---------------------------------------------------------------------------
// v0, v1, c1: the network in shared memory
// ---------------------------------------------------------------------------

constexpr int kTile = 4096;                  // points a CTA (whole rows)
constexpr int kSharedThreads = 512;          // pairs 1024 points apart
constexpr int kSharedWarps = kSharedThreads / 32;
constexpr int kSharedBlocks = 4;             // CTAs an SM (32 registers)
constexpr int kPairs = kTile / 2 / kSharedThreads;   // a thread a stage
constexpr int kQuads = kTile / 4 / kSharedThreads;   // 16-byte loads
static_assert(kSharedThreads == 512 && kTile % 2048 == 0);

// A point's term of its row's sum: key * (key != +inf ? w : 0).
__device__ __forceinline__ float weighted(float k, float w) {
  return __fmul_rn(k, k != CUDART_INF_F ? w : 0.0f);
}

// Point i's word in a tile's shared arrays: the words of every odd
// 32-word block in reverse.  Stage j's pairs (i, i + j) with i = 2 g -
// (g & (j - 1)) for the 32 g of a warp cover 32 banks for either point:
// for j < 32 they fill the even block with bit j clear and the odd
// block, reversed, with bit j set after the flip; for j >= 32 each is
// one block.
__device__ __forceinline__ int tile_slot(int i) {
  return i ^ (((i >> 5) & 1) * 31);
}

__device__ __forceinline__ float bf16_key(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Loads the thread's quads of points 4 q .. 4 q + 3 (q = t +
// kSharedThreads n) of tile `tile` into key = the value (c1: rounded to
// bf16) where the weight is positive, else +inf (a hole sorts last), and
// w = the weight: 16-byte loads where the tile is whole and both
// operands 16-byte aligned, else point by point, a point past `limit`
// read as a hole.  Every load is in flight before the first store.
template <int kMode>
__device__ __forceinline__ void load_tile(const float* __restrict__ mean,
                                          const float* __restrict__ weight,
                                          float* key, float* w, long tile,
                                          long limit, bool vec) {
  const long base = tile * kTile;
  float4 v[kQuads], ww[kQuads];
#pragma unroll
  for (int n = 0; n < kQuads; ++n) {
    const int q = threadIdx.x + n * kSharedThreads;
    if (vec && base + kTile <= limit) {
      v[n] = __ldcs(reinterpret_cast<const float4*>(mean + base) + q);
      ww[n] = __ldcs(reinterpret_cast<const float4*>(weight + base) + q);
    } else {
      float a[4], b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long at = base + 4 * q + c;
        a[c] = at < limit ? mean[at] : 0.0f;
        b[c] = at < limit ? weight[at] : 0.0f;
      }
      v[n] = make_float4(a[0], a[1], a[2], a[3]);
      ww[n] = make_float4(b[0], b[1], b[2], b[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < kQuads; ++n) {
    const float vs[4] = {v[n].x, v[n].y, v[n].z, v[n].w};
    const float ws[4] = {ww[n].x, ww[n].y, ww[n].z, ww[n].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int s = tile_slot(4 * (threadIdx.x + n * kSharedThreads) + c);
      const float k = kMode == kC1 ? bf16_key(vs[c]) : vs[c];
      key[s] = ws[c] > 0.0f ? k : CUDART_INF_F;
      w[s] = ws[c];
    }
  }
}

// Ascending bitonic sort of every D-long row of the tile.  The
// direction of a stage comes from the column inside the row, so the
// last merge (k == D) sorts every row ascending.  v0 swaps a pair only
// when its lower key is strictly greater (ascending) or strictly less,
// moving the weights with the keys; v1 writes both slots of every pair,
// the keys by min/max and each weight by whether its key moved; c1
// swaps the keys alone.  One __syncthreads a stage, the last included.
// A thread's pairs g = t + 512 h lie 1024 points apart (D <= 1024, so
// j <= 512 and i + 1024 h keeps i's bits below 1024): one index, slot
// and direction serve all of them.
template <int kMode>
__device__ void bitonic_rows(float* key, float* w, int d) {
  const int g = threadIdx.x;
  for (int k = 2; k <= d; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int i = 2 * g - (g & (j - 1));
      const bool asc = ((i & (d - 1)) & k) == 0;
      // i has bit j clear: below 32 the pair shares i's block and its
      // flip, from 64 on the flip too
      const int si = tile_slot(i);
      const int sp = j < 32 ? (si ^ j) : (j == 32 ? tile_slot(i + j)
                                                  : si + j);
#pragma unroll
      for (int h = 0; h < kPairs; ++h) {
        const int a = si + 2 * kSharedThreads * h;
        const int b = sp + 2 * kSharedThreads * h;
        const float ki = key[a], kp = key[b];
        if constexpr (kMode == kC1) {
          if (asc ? (ki > kp) : (ki < kp)) {
            key[a] = kp;
            key[b] = ki;
          }
        } else {
          const float wi = w[a], wp = w[b];
          if constexpr (kMode == kV1) {
            const float lo = fminf(ki, kp), hi = fmaxf(ki, kp);
            const float ni = asc ? lo : hi;
            const float np = asc ? hi : lo;
            key[a] = ni;
            key[b] = np;
            w[a] = ni != ki ? wp : wi;
            w[b] = np != kp ? wi : wp;
          } else if (asc ? (ki > kp) : (ki < kp)) {
            key[a] = kp;
            key[b] = ki;
            w[a] = wp;
            w[b] = wi;
          }
        }
      }
      __syncthreads();
    }
  }
}

// The [U, 3] emit of a tile's `rows` rows from its sorted shared arrays
// by the fixed pairwise tree of row_sums (at step s = D/2, D/4, ..., 1
// column c < s adds column c + s), with no barrier; the caller's last
// stage ends with one.  D >= 32: a warp a row, lane l owning the
// columns l + 32 r; it writes their products over their weights, runs
// the steps s >= 32 in place (column c and c + s are both the lane's
// own), then the steps below by shuffles, leaving the sum in lane 0.
// D < 32: a warp takes 32 / D rows, a lane a column, every step a
// shuffle.  The order depends on D alone; `tree_row_sums` is the plain
// version's.  The tile's weights are spent.
__device__ void row_sums(const float* key, float* w, float* __restrict__ out,
                         long row0, int rows, int d) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (d >= 32) {
    for (int r = warp; r < rows; r += kSharedWarps) {
      const int base = r * d;
      for (int c = lane; c < d; c += 32) {
        const int at = tile_slot(base + c);
        w[at] = weighted(key[at], w[at]);
      }
      for (int s = d >> 1; s >= 32; s >>= 1) {
        for (int c = lane; c < s; c += 32) {
          const int at = tile_slot(base + c);
          w[at] = __fadd_rn(w[at], w[tile_slot(base + c + s)]);
        }
      }
      float x = w[tile_slot(base + lane)];
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        x = __fadd_rn(x, __shfl_down_sync(kFull, x, s));
      }
      if (lane == 0) {
        float* o = out + (row0 + r) * 3;
        o[0] = key[tile_slot(base)];
        o[1] = key[tile_slot(base + d / 2)];
        o[2] = x;
      }
    }
    return;
  }
  const int per = 32 / d;                    // rows a warp takes at once
  const int col = lane & (d - 1);
  for (int r0 = warp * per; r0 < rows; r0 += kSharedWarps * per) {
    const int r = r0 + lane / d;
    const int at = r * d + col;
    float x = r < rows ? weighted(key[tile_slot(at)], w[tile_slot(at)])
                       : 0.0f;
    for (int s = d >> 1; s > 0; s >>= 1) {
      x = __fadd_rn(x, __shfl_down_sync(kFull, x, s));
    }
    if (r < rows && col == 0) {
      float* o = out + (row0 + r) * 3;
      o[0] = key[tile_slot(at)];
      o[1] = key[tile_slot(at + d / 2)];
      o[2] = x;
    }
  }
}

// Modes 0, 1 and 4: a CTA of kSharedThreads threads a tile.
template <int kMode>
__global__ void __launch_bounds__(kSharedThreads, kSharedBlocks)
shared_variant_kernel(const float* __restrict__ mean,
                      const float* __restrict__ weight,
                      float* __restrict__ out, int u, int d) {
  __shared__ float key[kTile];
  __shared__ float w[kTile];
  const long limit = static_cast<long>(u) * d;
  const bool vec = ((reinterpret_cast<size_t>(mean) |
                     reinterpret_cast<size_t>(weight)) & 15) == 0;
  load_tile<kMode>(mean, weight, key, w, blockIdx.x, limit, vec);
  __syncthreads();
  bitonic_rows<kMode>(key, w, d);
  const long row0 = static_cast<long>(blockIdx.x) * (kTile / d);
  const long left = static_cast<long>(u) - row0;
  row_sums(key, w, out, row0, left < kTile / d ? static_cast<int>(left)
                                               : kTile / d, d);
}

// ---------------------------------------------------------------------------
// v3: the partner by xor, the points in registers
// ---------------------------------------------------------------------------

constexpr int kXorPoints = 1024;             // points a CTA (whole rows)

// v3's compare-exchange of a lower and an upper point: the keys by
// min/max (ascending: the lower takes the min), each weight by whether
// its key moved.
__device__ __forceinline__ void exchange_moved(float& klo, float& wlo,
                                               float& khi, float& whi,
                                               bool asc) {
  const float lo = fminf(klo, khi), hi = fmaxf(klo, khi);
  const float nlo = asc ? lo : hi;
  const float nhi = asc ? hi : lo;
  const float wl = nlo != klo ? whi : wlo;
  whi = nhi != khi ? wlo : whi;
  wlo = wl;
  klo = nlo;
  khi = nhi;
}

// The same for one point against its partner's key and weight: `lower`
// when the point is the pair's lower.
__device__ __forceinline__ void exchange_with(float& k, float& w, float pk,
                                              float pw, bool lower,
                                              bool asc) {
  const float nk = (lower == asc) ? fminf(k, pk) : fmaxf(k, pk);
  w = nk != k ? pw : w;
  k = nk;
}

// Thread t holds the CTA's points t E .. t E + E - 1 (E = min(D, 16), so
// a lane never holds two rows).  Shared memory (dynamic) only where a
// row spans more than one warp (D > 32 E): two exchange buffers of keys
// and weights, then the emit's partial sums.
template <int E>
__global__ void __launch_bounds__(kXorPoints / E)
xor_variant_kernel(const float* __restrict__ mean,
                   const float* __restrict__ weight,
                   float* __restrict__ out, int u, int d) {
  extern __shared__ float xs[];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int p0 = t * E;                      // the CTA's point of key[0]
  const long base = static_cast<long>(blockIdx.x) * kXorPoints;
  const long limit = static_cast<long>(u) * d;
  float key[E], w[E];
  const bool vec = E % 4 == 0 && base + kXorPoints <= limit &&
                   ((reinterpret_cast<size_t>(mean) |
                     reinterpret_cast<size_t>(weight)) & 15) == 0;
  if (vec) {
    const float4* m4 = reinterpret_cast<const float4*>(mean + base + p0);
    const float4* w4 = reinterpret_cast<const float4*>(weight + base + p0);
    float4 mv[E / 4 > 0 ? E / 4 : 1], wv[E / 4 > 0 ? E / 4 : 1];
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      mv[q] = __ldcs(m4 + q);
      wv[q] = __ldcs(w4 + q);
    }
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float vv[4] = {mv[q].x, mv[q].y, mv[q].z, mv[q].w};
      const float ww[4] = {wv[q].x, wv[q].y, wv[q].z, wv[q].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        w[4 * q + c] = ww[c];
        key[4 * q + c] = ww[c] > 0.0f ? vv[c] : CUDART_INF_F;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const long at = base + p0 + r;
      const float ww = at < limit ? weight[at] : 0.0f;
      w[r] = ww;
      key[r] = ww > 0.0f ? mean[at] : CUDART_INF_F;
    }
  }
  const int col0 = p0 & (d - 1);             // column of key[0]
  float* xk = xs;                            // [2][kXorPoints] keys
  float* xw = xs + 2 * kXorPoints;           // [2][kXorPoints] weights
  int buf = 0;
  for (int k = 2; k <= d; k <<= 1) {
    const bool asc = (col0 & k) == 0;        // for every j >= E
    int j = k >> 1;
    for (; j >= 32 * E; j >>= 1) {
      float* bk = xk + buf * kXorPoints;
      float* bw = xw + buf * kXorPoints;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        bk[p0 + r] = key[r];
        bw[p0 + r] = w[r];
      }
      __syncthreads();
      const bool lower = (p0 & j) == 0;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        exchange_with(key[r], w[r], bk[(p0 ^ j) + r], bw[(p0 ^ j) + r],
                      lower, asc);
      }
      buf ^= 1;
    }
    for (; j >= E; j >>= 1) {
      const int m = j / E;
      const bool lower = (lane & m) == 0;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const float pk = __shfl_xor_sync(kFull, key[r], m);
        const float pw = __shfl_xor_sync(kFull, w[r], m);
        exchange_with(key[r], w[r], pk, pw, lower, asc);
      }
    }
#pragma unroll
    for (int jj = E / 2; jj > 0; jj >>= 1) {
      if (jj < k) {
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if ((r & jj) == 0) {
            exchange_moved(key[r], w[r], key[r | jj], w[r | jj],
                           (((col0 + r) & k)) == 0);
          }
        }
      }
    }
  }
  // the emit: column 0's thread writes key[0] and the sum, column D/2's
  // key[D/2]; every thread takes part in the shuffles and barriers
  float x[E];
#pragma unroll
  for (int r = 0; r < E; ++r) x[r] = weighted(key[r], w[r]);
  if (d > 32 * E) {
    // the tree's steps across warps, through shared memory: columns
    // [s, 2s) publish, columns [0, s) add
    float* part = xs + 4 * kXorPoints;
    for (int s = d >> 1; s >= 32 * E; s >>= 1) {
      if (col0 >= s && col0 < 2 * s) {
#pragma unroll
        for (int r = 0; r < E; ++r) part[p0 + r] = x[r];
      }
      __syncthreads();
      if (col0 < s) {
#pragma unroll
        for (int r = 0; r < E; ++r) x[r] = __fadd_rn(x[r], part[p0 + s + r]);
      }
    }
  }
  warp_tree_sum<E>(x, d > 32 * E ? 32 * E : d);
  const long row = (base + p0) / d;
  if (row >= u) return;                      // padding rows
  float* o = out + row * 3;
  if (col0 == 0) {
    o[0] = key[0];
    o[2] = x[0];
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    if (col0 + r == d / 2) o[1] = key[r];
  }
}

// ---------------------------------------------------------------------------
// c0: the packed bf16-key|column word network, a warp's work
// ---------------------------------------------------------------------------

constexpr int kC0Warps = 8;
constexpr int kC0Chunks = 2;               // chunks of 64 points a warp

// H3's c0 word (B4's word before B4 moved to the warp network): the
// bf16 key's bits through the monotone IEEE map (negatives flip every
// bit, positives set the sign bit) in the high half, the column in the
// low half, so the UNSIGNED order of the words is (value ascending,
// column ascending) and every word of a row is distinct: sorting them
// is a stable sort of the values.  (The TPU kernel re-centres the map
// to sort signed words; the order is the same.)  Padding (weight <= 0)
// keys +inf, which maps above every finite key.  -0 keys as +0: the
// stable f32 sort of the plain version holds them equal, so their
// columns decide, as here.  A negative-signed NaN keys below -inf, as
// in the JAX kernel's _pack_compact; B4's compact_sort_word does not.
__device__ __forceinline__ unsigned compact_word(__nv_bfloat16 v, float w,
                                                 int col) {
  unsigned b = w > 0.0f ? __bfloat16_as_ushort(v) : 0x7F80u;
  if (b == 0x8000u) b = 0u;
  const unsigned m16 = (b & 0x8000u) ? (0xFFFFu - b) : (b | 0x8000u);
  return (m16 << 16) | static_cast<unsigned>(col);
}

// H3's c0 network: a row of D <= 64 points lies inside one warp's 64
// (two per lane, lane l holding the chunk's points 2l and 2l + 1), so
// the bitonic network runs on the packed words in registers: the j == 1
// stages compare a lane's own two words, every other stage exchanges
// with lane l ^ (j / 2) through __shfl_xor_sync, with no barrier.  A
// lane runs the network of C chunks at once, word[2 c + s] its point s
// of chunk c, so their shuffles overlap.
template <int C>
__device__ void compact_network(unsigned (&word)[2 * C], int d, int lane) {
  for (int k = 2; k <= d; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 1) {
        // the pair (2l, 2l + 1): ascending where bit k of 2l is clear
        const bool asc = (((2 * lane) & (d - 1)) & k) == 0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const unsigned lo = min(word[2 * c], word[2 * c + 1]);
          const unsigned hi = max(word[2 * c], word[2 * c + 1]);
          word[2 * c] = asc ? lo : hi;
          word[2 * c + 1] = asc ? hi : lo;
        }
      } else {
#pragma unroll
        for (int s = 0; s < 2 * C; ++s) {
          const int i = 2 * lane + (s & 1);
          const unsigned other = __shfl_xor_sync(kFull, word[s], j >> 1);
          const bool asc = ((i & (d - 1)) & k) == 0;
          const bool lower = (i & j) == 0;
          word[s] = (lower == asc) ? min(word[s], other)
                                   : max(word[s], other);
        }
      }
    }
  }
}

// A warp takes kC0Chunks chunks of 64 consecutive points (64 / D whole
// rows each): lane l loads points 2l, 2l + 1 of each (8 bytes of each
// operand, every load before the first is used), stages their bf16
// values and weights in the warp's own shared memory, sorts the words,
// gathers each sorted point's value and weight by its column and emits
// its rows by warp_tree_sum.  No block barrier.
__global__ void __launch_bounds__(32 * kC0Warps)
compact_variant_kernel(const float* __restrict__ mean,
                       const float* __restrict__ weight,
                       float* __restrict__ out, int u, int d) {
  constexpr int C = kC0Chunks;
  __shared__ float stage_v[kC0Warps][64 * C];
  __shared__ float stage_w[kC0Warps][64 * C];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long base =
      (static_cast<long>(blockIdx.x) * kC0Warps + warp) * 64 * C;
  const long limit = static_cast<long>(u) * d;
  if (base >= limit) return;
  float v[2 * C], ww[2 * C];
  if (base + 64 * C <= limit && ((reinterpret_cast<size_t>(mean) |
                                  reinterpret_cast<size_t>(weight)) & 7) ==
                                     0) {
    float2 m2[C], w2[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const long at = base + 64 * c + 2 * lane;
      m2[c] = __ldcs(reinterpret_cast<const float2*>(mean + at));
      w2[c] = __ldcs(reinterpret_cast<const float2*>(weight + at));
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[2 * c] = m2[c].x;
      v[2 * c + 1] = m2[c].y;
      ww[2 * c] = w2[c].x;
      ww[2 * c + 1] = w2[c].y;
    }
  } else {
#pragma unroll
    for (int s = 0; s < 2 * C; ++s) {
      const long at = base + 64 * (s >> 1) + 2 * lane + (s & 1);
      v[s] = at < limit ? mean[at] : 0.0f;
      ww[s] = at < limit ? weight[at] : 0.0f;
    }
  }
  unsigned word[2 * C];
#pragma unroll
  for (int s = 0; s < 2 * C; ++s) {
    const int e = 64 * (s >> 1) + 2 * lane + (s & 1);
    const __nv_bfloat16 b = __float2bfloat16_rn(v[s]);
    stage_v[warp][e] = __bfloat162float(b);
    stage_w[warp][e] = ww[s];
    word[s] = compact_word(b, ww[s], e & (d - 1));
  }
  compact_network<C>(word, d, lane);
  __syncwarp();   // the staged values and weights visible to the gather
  const int col0 = (2 * lane) & (d - 1);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float key[2], x[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int e = 64 * c + 2 * lane + s;
      const int src = (e & ~(d - 1)) |
                      static_cast<int>(word[2 * c + s] & 0xFFFFu);
      const float wt = stage_w[warp][src];
      key[s] = wt > 0.0f ? stage_v[warp][src] : CUDART_INF_F;
      x[s] = weighted(key[s], wt);
    }
    warp_tree_sum<2>(x, d);
    const long row = (base + 64 * c + 2 * lane) / d;
    if (row < u) {
      float* o = out + row * 3;
      if (col0 == 0) {
        o[0] = key[0];
        o[2] = x[0];
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (col0 + s == d / 2) o[1] = key[s];
      }
    }
  }
}

template <int kMode>
int launch_shared(const float* mean, const float* weight, float* out, int u,
                  int d, cudaStream_t stream) {
  const long tiles = (static_cast<long>(u) * d + kTile - 1) / kTile;
  shared_variant_kernel<kMode><<<static_cast<int>(tiles), kSharedThreads, 0,
                                 stream>>>(mean, weight, out, u, d);
  return static_cast<int>(cudaGetLastError());
}

template <int E>
int launch_xor(const float* mean, const float* weight, float* out, int u,
               int d, cudaStream_t stream) {
  const long blocks = (static_cast<long>(u) * d + kXorPoints - 1) /
                      kXorPoints;
  const size_t smem = d > 32 * E ? 5 * kXorPoints * sizeof(float) : 0;
  xor_variant_kernel<E><<<static_cast<int>(blocks), kXorPoints / E, smem,
                          stream>>>(mean, weight, out, u, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 v0, 1 v1, 2 xor (v3), 3 c0 (D <= 64), 4 c1; out is [U, 3].
extern "C" int vn_sort_variant(const float* mean, const float* weight,
                               float* out, int u, int d, int mode,
                               void* stream_ptr) {
  if (u <= 0 || d < 2 || d > 1024 || (d & (d - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (mode) {
    case kV0:
      return launch_shared<kV0>(mean, weight, out, u, d, stream);
    case kV1:
      return launch_shared<kV1>(mean, weight, out, u, d, stream);
    case kXor:
      switch (d < 16 ? d : 16) {
        case 2: return launch_xor<2>(mean, weight, out, u, d, stream);
        case 4: return launch_xor<4>(mean, weight, out, u, d, stream);
        case 8: return launch_xor<8>(mean, weight, out, u, d, stream);
        default: return launch_xor<16>(mean, weight, out, u, d, stream);
      }
    case kC0: {
      if (d > kMaxCompactDepth) return cudaErrorInvalidValue;
      const long warps = (static_cast<long>(u) * d + 64 * kC0Chunks - 1) /
                         (64 * kC0Chunks);
      compact_variant_kernel<<<static_cast<int>((warps + kC0Warps - 1) /
                                                kC0Warps),
                               32 * kC0Warps, 0, stream>>>(mean, weight,
                                                           out, u, d);
      return static_cast<int>(cudaGetLastError());
    }
    case kC1:
      return launch_shared<kC1>(mean, weight, out, u, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
