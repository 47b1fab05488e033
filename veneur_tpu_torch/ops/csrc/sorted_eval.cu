// Sorted evaluation of the interval flush: per-row sort, prefix sums and
// Hazen midpoint quantiles.
//
// The kernels, each the Hopper counterpart of a Pallas TPU kernel in
// veneur_tpu/ops/sorted_eval.py:
//
//   vn_weighted_eval (B1) replaces weighted_eval's general network
//     (_kernel / _kernel_dma -> _tile_general, pallas_call at :699/:722):
//     [U, D] values + [U, D] weights + per-row min/max + P percentiles
//     -> [U, P+2] (P quantiles, total weight, weighted sum), row-major.
//     vn_weighted_eval_bf16 is the same kernel reading bf16 values (the
//     bf16 staging of deep rows, D > 64), widened at load.
//   vn_uniform_eval (B3) replaces uniform_eval's depth-vector network
//     (_kernel_uniform_depth / _dma -> _tile_uniform_depth, pallas_call at
//     :619/:636): [U, D] values + per-row depth (col < depth is occupied,
//     every weight 1) -> [U, P] quantiles, no clamp.  vn_uniform_eval_bf16
//     reads bf16 values, widened at load.
//   vn_weighted_eval_compact (B4) replaces weighted_eval(compact=True)
//     (_compact_sort_tile, :231-281, inside _tile_general(compact=True),
//     :369-395): bf16 values, D <= 64, a STABLE sort; output as B1's.
//     B1's kernel on a 32-bit word (compact_sort_word) in place of
//     B1's 64-bit one.
//   vn_weighted_eval_uniform (B2) replaces weighted_eval(uniform=True)
//     (_kernel_uniform -> _tile_uniform, :397-430, same pallas_call
//     sites as B1), the meshed flush's network for intervals whose every
//     nonzero weight is 1: B1's operands and [U, P+2] output, but the
//     sort moves keys only; occupancy is w > 0 anywhere in the row, a
//     sorted point i sits at cumulative weight i + 1 (cmid i + 0.5), the
//     total is the occupied count, and the tail clamps to [min, max] as
//     B1's does.  float32 values only.
//   vn_stage_slice (H1) replaces stage_slice_kernel (:738), the
//     profiling cuts of B1 that bench.py:560 and
//     scripts/profile_flush_kernel.py:102 launch: [U, D] f32 values +
//     weights -> [U] f32, one per row.  Cut `read`: B1's load and
//     sum(key * w) over the row (key = value where w > 0, else +inf, so
//     a row with a hole gives NaN, as on the TPU); `sort`: the same sum
//     after B1's sort; `cumsum`: the last column of B1's inclusive
//     prefix of the sorted weights (the total weight).  Built from B1's
//     own load, sort and scan (sort_network.cuh), so the cuts cannot
//     time a stale formulation; it exists to split B1's time into load,
//     network, scan and tail.  Bounded by bytes: (2 U D 4 + U 4) /
//     3.35 TB/s.
//   vn_stage_slice_wide (H2) is the definition of the `_variant_kernel`
//     that scripts/profile_kernel_inloop.py:38 imports and no module
//     defines (ROADMAP C7): the `read` (its mode `dma`) or `sort` cut
//     reading every operand B1 reads and writing B1's [U, P+2] output,
//     so its bytes are B1's and B1 minus it is the tail's own cost.
//     Column p < P holds s * q_p (s the cut's row value, q_p percentile
//     p), column P the row's min and column P + 1 its max.
//
// Sorting widened values gives the order of sorting the bf16 values:
// bf16 -> f32 is monotone and injective.
//
// What bounds them.  Bytes: B1, B2 and B4 read U*D*(4 or 2) values +
// U*D*4 weights + U*8 (min, max) and write U*(P+2)*4; B3 reads
// U*D*(4 or 2) + U*2 (int16 depths) and writes U*P*4.  Work: the
// bitonic network is U*D*log2(D)*(log2(D)+1)/4 compare-exchanges, plus
// the tail's rank searches.  At the flush's shapes the bytes bound them
// on paper: 3.35 TB/s moves a 131072 x 64 B1 input in ~20 us, while the
// ~88M compare-exchanges take ~1.3 us at the card's 67 TFLOP/s f32
// rate.  In practice a network in shared memory is bound by its
// barriers and its shared-memory traffic, so every kernel here keeps
// its points in registers (the warp functions of sort_network.cuh; the
// block functions there are H3's formulations only):
//   * each warp works alone on a chunk of 32 E points, whole rows, with
//     no CTA barrier; its loads are 16-byte vectors on neighbouring
//     addresses into a staging of its own (padded against bank
//     conflicts, slot), and many warps a SM (4 a CTA) keep loads in
//     flight while others sort.  The per-row arithmetic does not depend
//     on the chunk or the CTA, so the output bytes are the same for any
//     number of rows a CTA takes (the JAX kernel's tiling-invariance
//     contract);
//   * B1 sorts one 64-bit word a point, key and column (sort_word), so
//     a stage moves 8 bytes a point instead of a key and a weight, and
//     the network is stable: tied values keep their column order, as in
//     the plain version's stable sort, and every quantile is the plain
//     version's bit for bit on tied rows too.  The sorted columns then
//     gather each point's staged value and weight.  B4 is the same
//     kernel on a 32-bit word (the bf16 key's 16 bits over a 16-bit
//     column, compact_sort_word), so a compare-exchange is one unsigned
//     compare and a shuffled stage moves 4 bytes a point;
//   * the prefix sums run in registers (warp_scan), and the tail finds
//     each rank #{cmid < tq} by binary search over the row's cmid in
//     shared memory (log2(D) + 1 reads instead of D).  cmid is
//     non-decreasing along a row whenever its weights are finite and
//     not negative; B1 and B4 check every row and count the rank point
//     by point on a row where it is not, so a negative or NaN weight
//     keeps the plain version's count;
//   * B2 and B3 sort the f32 keys alone (the same compare rule as
//     bitonic_rows, so ±0 keys order as the block network orders them),
//     and their rank has a closed form (rank_uniform): B2 over the
//     occupied count, B3 over the depth.  B3 reads no weight operand.
//
// Numerics match the plain PyTorch version (sketches/tdigest.py
// weighted_eval) bit for bit on data whose sums are exact: the two
// products that version rounds on their own (tq = q * total and
// (m_hi - m_lo) * t) use __fmul_rn here, the division is the IEEE one
// (__fdiv_rn, no fast math), and the library is built with -fmad=false
// so no other add or multiply contracts either.  The rank is the count
// #{cmid < tq} over the whole row, padding included, as the plain
// version computes it.  B1's and B4's networks are stable (their sort
// words carry the column); B3's and B2's move keys alone, where a tie
// is one value.  B2 sorts the keys B1 sorts and adds its sorted values
// with B1's scan, so on weights in {0, 1} it gives B1's bits, the
// contract of _tile_uniform (sorted_eval.py:408-412).

#include "sort_network.cuh"

namespace {

constexpr float kPadCmid = 3.0e38f;           // cmid of B2/B3 padding
constexpr int kMaxCompactDepth = 64;          // B4's deepest row

// max and min with -0 ordered below +0 and NaN propagated, as the plain
// version's clip_signed (torch.maximum / torch.minimum, and XLA) take
// them: between two zeros, a + b is the larger and -(-a - b) the
// smaller, and either of those is NaN where a or b is.
__device__ __forceinline__ bool zeros_or_nan(float a, float b) {
  return (a == 0.0f && b == 0.0f) || a != a || b != b;
}
__device__ __forceinline__ float max_signed(float a, float b) {
  return zeros_or_nan(a, b) ? __fadd_rn(a, b) : fmaxf(a, b);
}
__device__ __forceinline__ float min_signed(float a, float b) {
  return zeros_or_nan(a, b) ? -__fsub_rn(-a, b) : fminf(a, b);
}

// A row of floats in a warp's padded staging (slot), read by column.
struct StagedRow {
  const float* p;
  int base;   // the chunk point of column 0
  __device__ float operator()(int c) const { return p[slot(base + c)]; }
};

// The tail's rank #{c < d : cmid(c) < tq}.  rank_count counts it point
// by point; rank_search finds it by binary search (the first c with
// !(cmid(c) < tq)) in at most log2(d) + 1 reads, the same number
// wherever cmid is non-decreasing along the row.
template <typename C>
__device__ int rank_count(C cmid, int d, float tq) {
  int rank = 0;
  for (int c = 0; c < d; ++c) rank += cmid(c) < tq ? 1 : 0;
  return rank;
}

template <typename C>
__device__ int rank_search(C cmid, int d, float tq) {
  int lo = 0;
  int n = d;
  while (n > 0) {
    const int half = n >> 1;
    if (cmid(lo + half) < tq) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// B2's and B3's cmid of sorted column c in a row of n points, and its
// rank in closed form: the first n cmids are c + 0.5 and the rest
// kPadCmid, so #{c : cmid[c] < tq} = #{c < n : c < tq - 0.5} +
// (kPadCmid < tq ? d - n : 0), the first term ceil(tq - 0.5) clamped to
// [0, n].  tq - 0.5 is exact in double for every f32 tq below 2^52 (and
// a larger one gives n either way), a NaN tq gives 0 as every compare
// fails, so this is the count bit for bit, at half-integer tq too.
__device__ __forceinline__ float uniform_cmid(int c, int n) {
  return c < n ? static_cast<float>(c) + 0.5f : kPadCmid;
}

__device__ int rank_uniform(int n, int d, float tq) {
  const double x = static_cast<double>(tq) - 0.5;
  int rank = !(x > 0.0) ? 0 : (x >= n ? n : static_cast<int>(ceil(x)));
  if (kPadCmid < tq) rank += d - n;
  return rank;
}

// The sorted column the tail interpolates up to, from the rank.
__device__ __forceinline__ int tail_index(int rank, int n_real) {
  const int hi_bound = n_real - 1 > 1 ? n_real - 1 : 1;
  return min(max(rank, 1), hi_bound);
}

// One quantile of one row from its tail_index ii, the rest of the tail
// of td.weighted_eval (tdigest.py:217-233): neighbour read, midpoint
// interpolation, single-point rule, optional clamp, empty-row zero.
// m reads the row's m_clean, c_lo and c_hi are the cmids at ii - 1 and
// ii.  kUnitStep (B3): c_hi - c_lo is 1 wherever the interpolation is
// kept (n_real >= 2, both cmids c + 0.5), so the division by it drops
// out, exactly.
template <bool kUnitStep = false, typename M>
__device__ float tail_value(M m, int ii, float c_lo, float c_hi, float tq,
                            int n_real, float total, bool clamp, float lo,
                            float hi) {
  const float m_hi = m(ii);
  const float m_lo = m(ii - 1);
  float tt = 0.0f;
  if constexpr (kUnitStep) {
    tt = __fsub_rn(tq, c_lo);
  } else if (c_hi > c_lo) {
    tt = __fdiv_rn(__fsub_rn(tq, c_lo), fmaxf(__fsub_rn(c_hi, c_lo), 1e-30f));
  }
  tt = fminf(fmaxf(tt, 0.0f), 1.0f);
  float v = __fadd_rn(m_lo, __fmul_rn(__fsub_rn(m_hi, m_lo), tt));
  if (n_real <= 1) v = m(0);
  if (clamp) v = min_signed(max_signed(v, lo), hi);
  return total > 0.0f ? v : 0.0f;
}

// One quantile of a row whose m_clean and cmid are read by m and cmid.
template <typename M, typename C>
__device__ float quantile_tail(M m, C cmid, int rank, int n_real, float tq,
                               float total, bool clamp, float lo, float hi) {
  const int ii = tail_index(rank, n_real);
  return tail_value(m, ii, cmid(ii - 1), cmid(ii), tq, n_real, total, clamp,
                    lo, hi);
}

// The per-row results of a warp's chunk (at most 32 rows).
struct RowStats {
  int n_real[32];     // occupied points (B1, B4: w > 0; B3: the depth)
  int counted[32];    // 1: cmid falls somewhere, so count the rank
  float total[32];    // total weight
  float sum[32];      // weighted sum
};

// The tails of emit_rows: B1's and B4's (cmid read from the staging,
// rank searched or counted), B2's (cmid in closed form, rank_uniform,
// the [min, max] clamp) and B3's (the same closed form over the depth,
// no clamp, ROADMAP C1; only the P quantile columns).
enum class Tail { kWeighted, kUnit, kDepth };

// The emit of a warp's rows from their m_clean (sv) and cmid (sw) in
// its padded staging: each lane takes (row, column) tasks of the rows'
// [P+2] outputs ([P] for kDepth) in turn, so the warp's stores are
// contiguous.
template <Tail kTail>
__device__ void emit_rows(const float* sv, const float* sw,
                          const RowStats& st,
                          const float* __restrict__ dmin,
                          const float* __restrict__ dmax,
                          const float* __restrict__ pct,
                          float* __restrict__ out, int u, int d, int n_pct,
                          long base, int lane, int chunk) {
  const long row0 = base / d;
  const long left = static_cast<long>(u) - row0;
  const int rows = left < chunk / d ? static_cast<int>(left) : chunk / d;
  const int stride = kTail == Tail::kDepth ? n_pct : n_pct + 2;
  if (stride == 0) return;   // B3 with no percentiles writes nothing
  // task = r * stride + c, stepped by 32 without a division a task
  const int dr = 32 / stride;
  const int dc = 32 - dr * stride;
  int r = lane / stride;
  int c = lane - r * stride;
  for (int task = lane; task < rows * stride; task += 32) {
    const long row = row0 + r;
    const float total = kTail == Tail::kWeighted
                            ? st.total[r]
                            : static_cast<float>(st.n_real[r]);
    float v;
    if (c < n_pct) {
      const StagedRow m{sv, r * d};
      const float tq = __fmul_rn(pct[c], total);
      const int n = st.n_real[r];
      if constexpr (kTail == Tail::kWeighted) {
        const StagedRow cmid{sw, r * d};
        const int rank = st.counted[r] ? rank_count(cmid, d, tq)
                                       : rank_search(cmid, d, tq);
        v = quantile_tail(m, cmid, rank, n, tq, total, true, dmin[row],
                          dmax[row]);
      } else {
        // B2 clamps and divides; B3 (kDepth) does neither
        constexpr bool kClamp = kTail == Tail::kUnit;
        const int ii = tail_index(rank_uniform(n, d, tq), n);
        v = tail_value<!kClamp>(m, ii, uniform_cmid(ii - 1, n),
                                uniform_cmid(ii, n), tq, n, total, kClamp,
                                kClamp ? dmin[row] : 0.0f,
                                kClamp ? dmax[row] : 0.0f);
      }
    } else {
      v = c == n_pct ? total : st.sum[r];
    }
    out[row * stride + c] = v;
    c += dc;
    r += dr;
    if (c >= stride) {
      c -= stride;
      ++r;
    }
  }
}

// B1 (Word = WideWord, f32 or bf16 values) and B4 (Word = CompactWord,
// bf16 values, D <= 64): a warp's chunk staged (stage_chunk), sorted as
// packed words and gathered (sorted_pairs), then m_clean (holes read
// 0), the prefix sums of the weights and of m_clean * w (warp_scan),
// cmid = cum - w / 2, and the tail.  A row whose cmid falls anywhere (a
// negative or NaN weight) counts its ranks; the others search.  B1 and
// B4 differ in the word alone, and both words sort in the same order.
template <int E, typename T, typename Word>
__global__ void __launch_bounds__(kWarpThreads)
weighted_eval_kernel(const T* __restrict__ mean,
                     const float* __restrict__ weight,
                     const float* __restrict__ dmin,
                     const float* __restrict__ dmax,
                     const float* __restrict__ pct,
                     float* __restrict__ out, int u, int d, int n_pct) {
  constexpr int kN = 32 * E;
  __shared__ float s_v[kWarps][kStaging<E>];   // staged values, then m_clean
  __shared__ float s_w[kWarps][kStaging<E>];   // staged weights, then cmid
  __shared__ RowStats s_row[kWarps];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long base = (static_cast<long>(blockIdx.x) * kWarps + warp) * kN;
  const long limit = static_cast<long>(u) * d;
  if (base >= limit) return;
  float* sv = s_v[warp];
  float* sw = s_w[warp];
  stage_chunk<E>(mean, weight, sv, sw, base, limit, lane);
  __syncwarp();
  float v[E], w[E];
  sorted_pairs<E, Word>(sv, sw, d, lane, v, w);

  const int p0 = lane * E;
  float cum[E], ws[E];
  int occ = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const bool o = w[r] > 0.0f;
    const float mc = o ? v[r] : 0.0f;
    sv[slot(p0 + r)] = mc;
    cum[r] = w[r];
    ws[r] = __fmul_rn(mc, w[r]);
    occ += o ? 1 : 0;
  }
  warp_scan<E>(cum, d, lane);
  warp_scan<E>(ws, d, lane);
  int falls = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    w[r] = __fsub_rn(cum[r], __fmul_rn(0.5f, w[r]));   // cmid
    sw[slot(p0 + r)] = w[r];
    if (r > 0) falls |= !(w[r - 1] <= w[r]) ? 1 : 0;
  }
  const int lanes = d / E;
  const int pos = lane & (lanes - 1);
  const float next = __shfl_down_sync(kFull, w[0], 1);
  if (pos + 1 < lanes) falls |= !(w[E - 1] <= next) ? 1 : 0;
  occ = row_lanes_sum(occ, lanes);
  falls = row_lanes_sum(falls, lanes);
  RowStats& st = s_row[warp];
  if (pos == lanes - 1) {
    const int r = p0 / d;
    st.n_real[r] = occ;
    st.counted[r] = falls > 0 ? 1 : 0;
    st.total[r] = cum[E - 1];
    st.sum[r] = ws[E - 1];
  }
  __syncwarp();
  emit_rows<Tail::kWeighted>(sv, sw, st, dmin, dmax, pct, out, u, d, n_pct,
                             base, lane, kN);
}

// B2: the chunk staged as B1's, the keys (value where w > 0, else +inf)
// sorted alone by B1's network in registers, the first n_real sorted
// columns of a row its points (m_clean 0 after them), their sum by B1's
// scan, and the tail with the closed-form rank.  No weight moves and no
// weight prefix is taken.
template <int E>
__global__ void __launch_bounds__(kWarpThreads)
weighted_eval_uniform_kernel(const float* __restrict__ mean,
                             const float* __restrict__ weight,
                             const float* __restrict__ dmin,
                             const float* __restrict__ dmax,
                             const float* __restrict__ pct,
                             float* __restrict__ out, int u, int d,
                             int n_pct) {
  constexpr int kN = 32 * E;
  __shared__ float s_v[kWarps][kStaging<E>];   // staged values, then m_clean
  __shared__ float s_w[kWarps][kStaging<E>];   // staged weights
  __shared__ RowStats s_row[kWarps];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long base = (static_cast<long>(blockIdx.x) * kWarps + warp) * kN;
  const long limit = static_cast<long>(u) * d;
  if (base >= limit) return;
  float* sv = s_v[warp];
  float* sw = s_w[warp];
  stage_chunk<E>(mean, weight, sv, sw, base, limit, lane);
  __syncwarp();

  const int p0 = lane * E;
  float key[E];
  int occ = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int at = slot(p0 + r);
    const bool o = sw[at] > 0.0f;
    key[r] = o ? sv[at] : CUDART_INF_F;
    occ += o ? 1 : 0;
  }
  const int lanes = d / E;
  const int pos = lane & (lanes - 1);
  occ = row_lanes_sum(occ, lanes);
  warp_bitonic<E>(key, d, lane);
  const int col0 = p0 & (d - 1);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    key[r] = col0 + r < occ ? key[r] : 0.0f;
    sv[slot(p0 + r)] = key[r];
  }
  // the weighted sum: B1's scan, so the same adds in the same order
  warp_scan<E>(key, d, lane);
  RowStats& st = s_row[warp];
  if (pos == lanes - 1) {
    st.n_real[p0 / d] = occ;
    st.sum[p0 / d] = key[E - 1];
  }
  __syncwarp();
  emit_rows<Tail::kUnit>(sv, sw, st, dmin, dmax, pct, out, u, d, n_pct,
                         base, lane, kN);
}

// B3: each warp stages its chunk's values alone (stage_chunk without
// weights) and each lane its row's int16 depth n; key = value for
// col < n, else +inf, is sorted alone by the warp network
// (bitonic_rows' exchanges, so the sorted keys are the block network's
// bits); m_clean is 0 from column n on, and the tail takes B2's closed
// form over n with no clamp (ROADMAP C1; so where the plain version
// clamps a zero quantile to a -0 bound this one reads +0, C12).  Writes
// the [P] quantile columns only.
template <int E, typename T>
__global__ void __launch_bounds__(kWarpThreads)
uniform_eval_kernel(const T* __restrict__ mean,
                    const short* __restrict__ depths,
                    const float* __restrict__ pct,
                    float* __restrict__ out, int u, int d, int n_pct) {
  constexpr int kN = 32 * E;
  __shared__ float s_v[kWarps][kStaging<E>];   // staged values, then m_clean
  __shared__ RowStats s_row[kWarps];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long base = (static_cast<long>(blockIdx.x) * kWarps + warp) * kN;
  const long limit = static_cast<long>(u) * d;
  if (base >= limit) return;
  float* sv = s_v[warp];
  stage_chunk<E, false>(mean, nullptr, sv, nullptr, base, limit, lane);
  const int p0 = lane * E;
  const long row = (base + p0) / d;
  const int n = row < u ? min(max(static_cast<int>(__ldg(depths + row)), 0),
                              d)
                        : 0;
  __syncwarp();

  const int col0 = p0 & (d - 1);
  float key[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    key[r] = col0 + r < n ? sv[slot(p0 + r)] : CUDART_INF_F;
  }
  warp_bitonic<E>(key, d, lane);
#pragma unroll
  for (int r = 0; r < E; ++r) {
    sv[slot(p0 + r)] = col0 + r < n ? key[r] : 0.0f;
  }
  const int lanes = d / E;
  RowStats& st = s_row[warp];
  if ((lane & (lanes - 1)) == lanes - 1) st.n_real[p0 / d] = n;
  __syncwarp();
  emit_rows<Tail::kDepth>(sv, nullptr, st, nullptr, nullptr, pct, out, u,
                          d, n_pct, base, lane, kN);
}

// H1 (kWide false) and H2 (kWide true): the cut kCut of B1 on a warp's
// chunk, one value s per row (see the top of the file), from B1's own
// stage_chunk, sorted_pairs and warp_scan.
constexpr int kCutRead = 0;
constexpr int kCutSort = 1;
constexpr int kCutCumsum = 2;

template <int E, int kCut, bool kWide>
__global__ void __launch_bounds__(kWarpThreads)
stage_slice_kernel(const float* __restrict__ mean,
                   const float* __restrict__ weight,
                   const float* __restrict__ dmin,
                   const float* __restrict__ dmax,
                   const float* __restrict__ pct, float* __restrict__ out,
                   int u, int d, int n_pct) {
  constexpr int kN = 32 * E;
  __shared__ float s_v[kWarps][kStaging<E>];
  __shared__ float s_w[kWarps][kStaging<E>];
  __shared__ float s_row[kWarps][32];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long base = (static_cast<long>(blockIdx.x) * kWarps + warp) * kN;
  const long limit = static_cast<long>(u) * d;
  if (base >= limit) return;
  float* sv = s_v[warp];
  float* sw = s_w[warp];
  stage_chunk<E>(mean, weight, sv, sw, base, limit, lane);
  __syncwarp();
  const int p0 = lane * E;
  float v[E], w[E];
  if constexpr (kCut == kCutRead) {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      v[r] = sv[slot(p0 + r)];
      w[r] = sw[slot(p0 + r)];
    }
  } else {
    sorted_pairs<E>(sv, sw, d, lane, v, w);
  }
  // the row value: the last prefix of the weights, or sum(key * w)
  const int lanes = d / E;
  const int pos = lane & (lanes - 1);
  float s;
  if constexpr (kCut == kCutCumsum) {
    warp_scan<E>(w, d, lane);
    s = w[E - 1];
    if (pos == lanes - 1) s_row[warp][p0 / d] = s;
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      v[r] = __fmul_rn(w[r] > 0.0f ? v[r] : CUDART_INF_F, w[r]);
    }
    warp_tree_sum<E>(v, d);
    if (pos == 0) s_row[warp][p0 / d] = v[0];
  }
  __syncwarp();
  const long row0 = base / d;
  const long left = static_cast<long>(u) - row0;
  const int rows = left < kN / d ? static_cast<int>(left) : kN / d;
  if constexpr (!kWide) {
    for (int r = lane; r < rows; r += 32) out[row0 + r] = s_row[warp][r];
  } else {
    const int stride = n_pct + 2;
    for (int task = lane; task < rows * stride; task += 32) {
      const int r = task / stride;
      const int c = task - r * stride;
      const long row = row0 + r;
      out[row * stride + c] =
          c < n_pct ? __fmul_rn(s_row[warp][r], pct[c])
                    : (c == n_pct ? dmin[row] : dmax[row]);
    }
  }
}

template <int kCut, bool kWide>
int launch_slice(const float* mean, const float* weight, const float* dmin,
                 const float* dmax, const float* pct, float* out, int u,
                 int d, int n_pct, void* stream) {
  return with_lane_points(d, [&](auto e) {
    constexpr int E = decltype(e)::value;
    stage_slice_kernel<E, kCut, kWide>
        <<<warp_blocks(u, d, E), kWarpThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(mean, weight, dmin, dmax,
                                                pct, out, u, d, n_pct);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T, typename Word = WideWord>
int launch_weighted(const T* mean, const float* weight, const float* dmin,
                    const float* dmax, const float* pct, float* out, int u,
                    int d, int n_pct, void* stream) {
  return with_lane_points(d, [&](auto e) {
    constexpr int E = decltype(e)::value;
    weighted_eval_kernel<E, T, Word>
        <<<warp_blocks(u, d, E), kWarpThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(mean, weight, dmin, dmax,
                                                pct, out, u, d, n_pct);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T>
int launch_uniform(const T* mean, const short* depths, const float* pct,
                   float* out, int u, int d, int n_pct, void* stream) {
  return with_lane_points(d, [&](auto e) {
    constexpr int E = decltype(e)::value;
    uniform_eval_kernel<E, T>
        <<<warp_blocks(u, d, E), kWarpThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(mean, depths, pct, out, u, d,
                                                n_pct);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" int vn_weighted_eval(const float* mean, const float* weight,
                                const float* dmin, const float* dmax,
                                const float* pct, float* out, int u, int d,
                                int n_pct, void* stream) {
  return launch_weighted(mean, weight, dmin, dmax, pct, out, u, d, n_pct,
                         stream);
}

extern "C" int vn_weighted_eval_bf16(const __nv_bfloat16* mean,
                                     const float* weight, const float* dmin,
                                     const float* dmax, const float* pct,
                                     float* out, int u, int d, int n_pct,
                                     void* stream) {
  return launch_weighted(mean, weight, dmin, dmax, pct, out, u, d, n_pct,
                         stream);
}

// D must be a power of two in [2, 64] (the wrapper checks): the column
// of a 32-bit compact word has 16 bits, and B4 exists for rows this
// shallow (deeper bf16 rows take B1 on bf16).
extern "C" int vn_weighted_eval_compact(const __nv_bfloat16* mean,
                                        const float* weight,
                                        const float* dmin, const float* dmax,
                                        const float* pct, float* out, int u,
                                        int d, int n_pct, void* stream) {
  if (d > kMaxCompactDepth) return cudaErrorInvalidValue;
  return launch_weighted<__nv_bfloat16, CompactWord>(
      mean, weight, dmin, dmax, pct, out, u, d, n_pct, stream);
}

extern "C" int vn_weighted_eval_uniform(const float* mean,
                                        const float* weight,
                                        const float* dmin, const float* dmax,
                                        const float* pct, float* out, int u,
                                        int d, int n_pct, void* stream) {
  return with_lane_points(d, [&](auto e) {
    constexpr int E = decltype(e)::value;
    weighted_eval_uniform_kernel<E>
        <<<warp_blocks(u, d, E), kWarpThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(mean, weight, dmin, dmax,
                                                pct, out, u, d, n_pct);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int vn_uniform_eval(const float* mean, const short* depths,
                               const float* pct, float* out, int u, int d,
                               int n_pct, void* stream) {
  return launch_uniform(mean, depths, pct, out, u, d, n_pct, stream);
}

extern "C" int vn_uniform_eval_bf16(const __nv_bfloat16* mean,
                                    const short* depths, const float* pct,
                                    float* out, int u, int d, int n_pct,
                                    void* stream) {
  return launch_uniform(mean, depths, pct, out, u, d, n_pct, stream);
}

// H1: cut 0 read, 1 sort, 2 cumsum; out is [U] f32.
extern "C" int vn_stage_slice(const float* mean, const float* weight,
                              float* out, int u, int d, int cut,
                              void* stream) {
  switch (cut) {
    case kCutRead:
      return launch_slice<kCutRead, false>(mean, weight, nullptr, nullptr,
                                           nullptr, out, u, d, 0, stream);
    case kCutSort:
      return launch_slice<kCutSort, false>(mean, weight, nullptr, nullptr,
                                           nullptr, out, u, d, 0, stream);
    case kCutCumsum:
      return launch_slice<kCutCumsum, false>(mean, weight, nullptr, nullptr,
                                             nullptr, out, u, d, 0, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// H2: cut 0 read (mode dma) or 1 sort, B1's operands; out is [U, P+2].
extern "C" int vn_stage_slice_wide(const float* mean, const float* weight,
                                   const float* dmin, const float* dmax,
                                   const float* pct, float* out, int u,
                                   int d, int n_pct, int cut,
                                   void* stream) {
  switch (cut) {
    case kCutRead:
      return launch_slice<kCutRead, true>(mean, weight, dmin, dmax, pct,
                                          out, u, d, n_pct, stream);
    case kCutSort:
      return launch_slice<kCutSort, true>(mean, weight, dmin, dmax, pct,
                                          out, u, d, n_pct, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
