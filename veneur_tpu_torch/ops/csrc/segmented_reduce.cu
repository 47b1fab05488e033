// Per-group sums over sorted segment ids: the cube sub-rollup (kernel B7).
//
// The Hopper counterpart of veneur_tpu/ops/segmented_reduce.py's
// _segment_sums_pallas (pallas_call at :81; _kernel_segsum at :59).  One
// entry point:
//
//   vn_segment_sums  vals [U, C] f32 row-major, seg [U] i32 sorted
//                    ascending with every id in [0, G)
//                 -> out [G, C] f32, out[g, c] = the sum of vals[r, c]
//                    over the rows r with seg[r] == g, 0 for an empty
//                    group
//
// Order.  Each group's sum starts at 0.0f and adds its rows strictly in
// row order, one f32 add a row: the TPU kernel's order (a sequential
// grid over row tiles, a sequential loop in each tile), so the sums are
// the same bits whatever the tiling, and the plain PyTorch version
// (ops/segmented_reduce.py) adds in the same order.  No atomics, no tree
// reduction and no reassociation; the library builds with -fmad=false
// and there is no product to contract anyway.
//
// Design.  The TPU kernel keeps the whole [G, C] accumulator in VMEM
// and walks the rows once.  Here warps run in parallel, so the work is
// cut by output instead: one warp owns one group g (kWarps groups a
// CTA), and sorted ids make the group's rows one contiguous range
// [lo, hi).  The warp finds both ends in one 32-way search (bounds):
// each round, every lane loads seg at one of 32 evenly spaced points of
// each end's interval, and a ballot of seg[p] < key narrows it 32-fold,
// so U = 4096 takes 3 rounds of dependent loads and U = 131072 takes 4,
// where a binary search takes 12 and 17.  Lanes then run over columns:
// one column a lane in strips of 32, or, where C > 32 and every row
// starts on a 16-byte boundary (C % 4 == 0), four columns a lane with
// 16-byte loads in strips of 128.  A lane loads its column kRows rows
// a batch into registers and issues each batch before it adds the one
// before, in row order (the loads are independent; only the adds are a
// chain), so a group of up to kRows rows costs one round trip after the
// search, and the warp writes its group's C sums once, coalesced.
//
// What bounds it.  Bytes: vals read once, seg read once, out written
// once, (U*C + U + G*C) * 4 bytes; one add per value.  At the cube
// read's shape ([4096, 20] -> 256 groups) that is 0.35 MB (0.1 us at
// 3.35 TB/s): far below a launch, so the kernel is latency: the
// launch, the search's rounds, a round trip for the rows and the store.
// At [131072, 128] -> 1024 it is 68 MB (20 us), fed by the two batches
// of 16-byte loads each lane keeps in flight.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;                 // groups (warps) a CTA
constexpr int kRows = 16;                 // rows a batch of loads covers
constexpr unsigned kFull = 0xFFFFFFFFu;

// The 32-way search for the first r in [lo, hi] (the interval that
// holds it) with seg[r] >= key.  An interval of n <= 32 points is
// probed point by point and closes; a longer one is cut into 32 pieces
// (each of at least one point), lane i probes the last point of piece
// i, and the pieces whose last point is below key (a prefix, seg being
// sorted) are dropped.  probe gives lane i's point (-1: none), narrow
// the interval after t pieces fell below key.
__device__ __forceinline__ int probe(int lo, int hi, int lane) {
  const int n = hi - lo;
  if (n <= 32) return lane < n ? lo + lane : -1;
  return lo + static_cast<int>((static_cast<long long>(lane + 1) * n) >> 5)
         - 1;
}

__device__ __forceinline__ void narrow(int& lo, int& hi, int t) {
  const int n = hi - lo;
  if (n <= 32) {
    lo = hi = lo + t;
  } else if (t == 32) {
    lo = hi;
  } else {
    const int a = lo + static_cast<int>((static_cast<long long>(t) * n) >> 5);
    hi = lo + static_cast<int>((static_cast<long long>(t + 1) * n) >> 5) - 1;
    lo = a;
  }
}

// [lo, hi): the rows of group g, both ends (the first row of g and the
// first of g + 1) searched together, so a round is one load a lane and
// end, both issued before the ballots.
__device__ __forceinline__ void bounds(const int* __restrict__ seg, int u,
                                       int g, int lane, int& lo, int& hi) {
  int a0 = 0, b0 = u, a1 = 0, b1 = u;
  while (a0 < b0 || a1 < b1) {
    const int p0 = a0 < b0 ? probe(a0, b0, lane) : -1;
    const int p1 = a1 < b1 ? probe(a1, b1, lane) : -1;
    const int s0 = p0 >= 0 ? __ldg(seg + p0) : g;
    const int s1 = p1 >= 0 ? __ldg(seg + p1) : g + 1;
    const int t0 = __popc(__ballot_sync(kFull, s0 < g));
    const int t1 = __popc(__ballot_sync(kFull, s1 < g + 1));
    if (a0 < b0) narrow(a0, b0, t0);
    if (a1 < b1) narrow(a1, b1, t1);
  }
  lo = a0;
  hi = a1;
}

// The sum down one column (or, kVec, four neighbouring columns) of
// `rows` rows from p, row by row in order.  The loads go in batches of
// kRows rows, and each batch's loads are issued before the previous
// batch's adds, so two batches are in flight while one chain of adds
// runs.
template <bool kVec>
struct Column {
  using T = typename std::conditional<kVec, float4, float>::type;
  static __device__ __forceinline__ void add(T& acc, const T& x) {
    if constexpr (kVec) {
      acc.x = __fadd_rn(acc.x, x.x);
      acc.y = __fadd_rn(acc.y, x.y);
      acc.z = __fadd_rn(acc.z, x.z);
      acc.w = __fadd_rn(acc.w, x.w);
    } else {
      acc = __fadd_rn(acc, x);
    }
  }
  static __device__ __forceinline__ void load(T (&x)[kRows], const T* p,
                                              size_t stride, int left) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k < left) x[k] = __ldg(p + k * stride);
    }
  }
  static __device__ __forceinline__ T sum(const T* p, size_t stride,
                                          int rows) {
    T acc;
    if constexpr (kVec) {
      acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      acc = 0.0f;
    }
    T cur[kRows];
    load(cur, p, stride, rows);
    for (int r = 0; r < rows; r += kRows) {
      T next[kRows];
      load(next, p + (r + kRows) * stride, stride, rows - r - kRows);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (r + k < rows) add(acc, cur[k]);
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) cur[k] = next[k];
    }
    return acc;
  }
};

template <bool kVec>
__global__ void __launch_bounds__(32 * kWarps)
    segsum_kernel(const float* __restrict__ vals,
                  const int* __restrict__ seg, float* __restrict__ out,
                  int u, int c, int n_groups) {
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= n_groups) return;          // the whole warp
  int lo, hi;
  bounds(seg, u, g, lane, lo, hi);
  constexpr int kLaneCols = kVec ? 4 : 1;
  using T = typename Column<kVec>::T;
  const size_t stride = static_cast<size_t>(c) / kLaneCols;
  for (int c0 = 0; c0 < c; c0 += 32 * kLaneCols) {
    const int col = c0 + lane * kLaneCols;
    if (col >= c) continue;
    const T* p = reinterpret_cast<const T*>(vals + static_cast<size_t>(lo) * c
                                            + col);
    *reinterpret_cast<T*>(out + static_cast<size_t>(g) * c + col) =
        Column<kVec>::sum(p, stride, hi - lo);
  }
}

}  // namespace

extern "C" int vn_segment_sums(const float* vals, const int* seg, float* out,
                               int u, int c, int g, void* stream) {
  if (u <= 0 || c <= 0 || g <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((g + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = c > 32 && c % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(vals) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
    segsum_kernel<true><<<blocks, 32 * kWarps, 0, s>>>(vals, seg, out, u, c,
                                                        g);
  } else {
    segsum_kernel<false><<<blocks, 32 * kWarps, 0, s>>>(vals, seg, out, u, c,
                                                         g);
  }
  return static_cast<int>(cudaGetLastError());
}
