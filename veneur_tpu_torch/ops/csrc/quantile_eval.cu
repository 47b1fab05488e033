// Batched t-digest quantiles of stored centroid rows (kernel B9).
//
// The Hopper counterpart of veneur_tpu/ops/quantile_eval.py's quantile
// (pallas_call at :94; _kernel at :32), the vectorized Quantile() of
// merging_digest.go:304-332.  One entry point:
//
//   vn_quantile  mean, weight [K, C] f32 row-major (each row's centroids
//                sorted by mean, empty slots weight 0 at the end), dmin,
//                dmax [K] f32, qs [P] f32
//             -> out [K, P] f32: each quantile interpolated uniformly
//                inside its centroid's bounds (the midpoints to the
//                neighbours, min and max at the ends), NaN for an empty
//                row
//
// Design.  One warp per row, four rows (warps) per block.  The warp
// first issues its row's whole load, means and weights, as cp.async
// copies into its shared memory (16 bytes a copy, neighbouring lanes on
// neighbouring 16 bytes, where every row starts on a 16-byte boundary:
// C % 4 == 0 and aligned pointers; else 4 bytes a column), and waits
// once.  Then one scan a row: lane l owns the m = ceil(C / 32) | 1
// contiguous columns [m*l, m*l + m) (odd m, so the stride-m reads of
// shared memory hit 32 distinct banks; at C = 152 m = 5), sums their
// weights in order into registers (the kernel is instantiated for a
// register run of M >= m columns, M in 1, 3, 5, 9, 17, 33), and one
// shuffle scan of the 32 lane totals gives each lane its offset; column
// j's prefix sum is offset + the lane's running sum at j, kept in the
// lane's registers and stored to shared memory beside the row.  The
// occupied centroids are counted in the same pass.  For each quantile
// every lane counts its own columns whose prefix sum lies below the
// target (q * total, broadcast from the lane that holds it) and the
// warp adds the counts: a count, not a search, as in the JAX kernel, so
// it needs no monotone prefix sum (the new association can break it by
// an ulp at a lane boundary with float weights).  Lane p of each group
// of 32 quantiles keeps quantile p's count and interpolates it, reading
// the chosen centroid's weight, bounds and preceding prefix sum from
// shared memory.  C is at most 1024 (three rows of C floats for each of
// the four warps, 48 KB of shared memory).
//
// Numerics.  The prefix sum is exact for integer weights below 2^24 in
// any order, so the kernel agrees bitwise with the plain version
// (sketches/tdigest.py quantile) on them; the library is built with
// -fmad=false and every add, product and quotient is rounded on its
// own (__fadd_rn, __fmul_rn, __fdiv_rn), as in PyTorch's eager ops, so
// lo + prop * (up - lo) and 0.5 * (a + b) round as the plain version
// rounds them.
//
// What bounds it.  Bytes: means and weights read once, min, max and
// the quantiles read once, the [K, P] output written once,
// K * (8C + 8 + 4P) + 4P.  At 131,072 rows x 152 centroids that is
// 159 MB, 48 us at an H100 SXM's 3.35 TB/s (NVIDIA's data sheet).
// Work: C adds of the scan and P * C compares a row, a few hundred
// operations per row, far below the card's rate.  The copies of every
// warp on an SM are in flight together, so the card's memory, not a
// chain of dependent loads and scans, sets the pace.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxC = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

// upper bound of centroid j (merging_digest.go:355-370): the midpoint
// to centroid j+1, max for the last occupied centroid and beyond
__device__ __forceinline__ float upper_at(const float* mean, int j, int n,
                                          int c, float dmax) {
  if (j >= n - 1) return dmax;
  const float nxt = j + 1 < c ? mean[j + 1] : mean[c - 1];
  return __fmul_rn(0.5f, __fadd_rn(mean[j], nxt));
}

template <bool kVec, int M>
__global__ void __launch_bounds__(kThreads)
    quantile_kernel(const float* __restrict__ mean_g,
                    const float* __restrict__ weight_g,
                    const float* __restrict__ dmin,
                    const float* __restrict__ dmax,
                    const float* __restrict__ qs, float* __restrict__ out,
                    int k, int c, int n_pct) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + warp;
  if (row >= k) return;
  const int cs = (c + 3) & ~3;             // a 16-byte multiple per array
  float* mean = smem + warp * 3 * cs;
  float* weight = mean + cs;
  float* cum = weight + cs;
  const float* mrow = mean_g + row * c;
  const float* wrow = weight_g + row * c;

  // the whole row in flight before any arithmetic
  if (kVec) {
    for (int i = lane; i < (c >> 2); i += 32) {
      __pipeline_memcpy_async(mean + 4 * i, mrow + 4 * i, 16);
      __pipeline_memcpy_async(weight + 4 * i, wrow + 4 * i, 16);
    }
  } else {
    for (int col = lane; col < c; col += 32) {
      __pipeline_memcpy_async(mean + col, mrow + col, 4);
      __pipeline_memcpy_async(weight + col, wrow + col, 4);
    }
  }
  __pipeline_commit();
  const float lo_row = __ldg(dmin + row);
  const float hi_row = __ldg(dmax + row);
  __pipeline_wait_prior(0);
  __syncwarp();

  // one scan: the lane's run of m <= M columns in registers (+inf past
  // the row, so no count takes them), then the lanes' offsets
  const int m = ((c + 31) >> 5) | 1;
  const int c0 = m * lane;
  const int mine_n = min(max(c - c0, 0), m);
  float run = 0.0f;
  int n = 0;
  float lane_cum[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    if (j < mine_n) {
      const float w = weight[c0 + j];
      run = __fadd_rn(run, w);
      n += w > 0.0f;
    }
    lane_cum[j] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = __fadd_rn(incl, y);
  }
  float offset = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) offset = 0.0f;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    if (j < mine_n) {
      lane_cum[j] = __fadd_rn(offset, lane_cum[j]);
      cum[c0 + j] = lane_cum[j];
    } else {
      lane_cum[j] = CUDART_INF_F;
    }
  }
  n = __reduce_add_sync(kFull, n);
  __syncwarp();

  // lane p of each group of 32 quantiles holds quantile p's target and,
  // after the warp's counts, its count
  const float total = cum[c - 1];
  const int last = n - 1 > 0 ? n - 1 : 0;
  for (int base = 0; base < n_pct; base += 32) {
    const int np = min(32, n_pct - base);
    const float my_target =
        lane < np ? __fmul_rn(__ldg(qs + base + lane), total) : 0.0f;
    int mine = 0;
    for (int p = 0; p < np; ++p) {
      const float target = __shfl_sync(kFull, my_target, p);
      int below = 0;
#pragma unroll
      for (int j = 0; j < M; ++j) below += lane_cum[j] < target;
      below = __reduce_add_sync(kFull, below);
      if (lane == p) mine = below;
    }
    if (lane < np) {
      const int i = mine < last ? mine : last;
      const float w_i = weight[i];
      const float before = i == 0 ? 0.0f : cum[i - 1];
      const float lo = i == 0 ? lo_row : upper_at(mean, i - 1, n, c, hi_row);
      const float up = upper_at(mean, i, n, c, hi_row);
      float prop =
          w_i > 0.0f ? __fdiv_rn(__fsub_rn(my_target, before), w_i) : 0.0f;
      prop = fminf(fmaxf(prop, 0.0f), 1.0f);
      const float val = __fadd_rn(lo, __fmul_rn(prop, __fsub_rn(up, lo)));
      out[row * n_pct + base + lane] = n > 0 ? val : CUDART_NAN_F;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

using Launcher = void (*)(const float*, const float*, const float*,
                          const float*, const float*, float*, int, int, int);

// the kernel whose register run holds M >= m columns a lane
template <int M>
Launcher pick(bool vec) {
  return vec ? quantile_kernel<true, M> : quantile_kernel<false, M>;
}

}  // namespace

extern "C" int vn_quantile(const float* mean, const float* weight,
                           const float* dmin, const float* dmax,
                           const float* qs, float* out, int k, int c,
                           int n_pct, void* stream) {
  if (k <= 0 || c <= 0 || c > kMaxC || n_pct <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (k + kWarps - 1) / kWarps;
  const size_t smem =
      static_cast<size_t>(kWarps) * 3 * ((c + 3) & ~3) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = c % 4 == 0 && aligned16(mean) && aligned16(weight);
  const int m = ((c + 31) >> 5) | 1;
  const Launcher fn = m <= 1   ? pick<1>(vec)
                      : m <= 3 ? pick<3>(vec)
                      : m <= 5 ? pick<5>(vec)
                      : m <= 9 ? pick<9>(vec)
                      : m <= 17 ? pick<17>(vec)
                                : pick<33>(vec);
  fn<<<blocks, kThreads, smem, s>>>(mean, weight, dmin, dmax, qs, out, k, c,
                                    n_pct);
  return static_cast<int>(cudaGetLastError());
}
