// Chebyshev moment sums of the moments-family flush (kernel B5).
//
// The Hopper counterpart of veneur_tpu/ops/moments_eval.py's
// _moments_sums_pallas (pallas_call at :198 and :218; _kernel_moments,
// _kernel_moments_depth and the DMA-pipelined _kernel_moments_dma, all
// around _tile_moments at :107).  Two entry points:
//
//   vn_moments_sums        [U, D] values + [U, D] f32 weights
//   vn_moments_sums_depth  [U, D] values + [U] int16 depths (column c of
//                          row r is a weight-1 point iff c < depth[r])
//
// both with each row's raw domain ab = [2, U] (a, b) and log domain
// lab = [2, U] (la, lb; lb < la disables the log block), writing
// [U, 2(k+1)] f32 row-major: column 0 the staged weight, 1..k the raw
// sums sum(w * T_j(t)), k+1 the positive mass, k+2..2k+1 the log sums
// sum(lw * T_j(u)).  t maps a value into [-1, 1] over [a, b], u maps its
// natural log over [la, lb]; both are clipped, as _tile_moments clips.
//
// What bounds it.  Bytes: the general variant reads U*D*8 (value and
// weight), the depth variant U*D*4 + U*2, both U*16 of domains, and both
// write U*2(k+1)*4: at the flush's shape (131072 x 64, k = 8) 67 MB and
// 38 MB, 20 us and 11 us at 3.35 TB/s.  Work: every column is computed,
// occupied or not (as the TPU kernel and the plain version do, so a
// non-finite value in the padding poisons its row alike in all three),
// about 110 instructions a point at k = 8 (the scale, clip, full-precision
// logf and clip of both domains, then per order two products, two adds
// and the two recurrences).  Under -fmad=false a multiply and an add are
// two instructions, at 128 a clock an SM, about 33.5e12 a second: 8.4M
// points take about 28 us, as long as the bytes.
//
// Design.  A group of G = min(32, pow2 <= max(1, D / kLanePoints))
// neighbouring lanes owns a row (G depends on D alone), so a lane sums
// about kLanePoints = 16 points in registers and a warp holds 32 / G
// rows.  Columns go to lanes four at a time ("quads"): lane l of the
// group owns quads l, l + G, l + 2G, ... and sums its points in that
// order, quad after quad, column after column.  A lane issues the loads
// of kBatch quads (values and weights; all of its loads up to D = 512)
// before it computes the first point: with 16-byte loads where every
// row starts on a 16-byte boundary (D % 4 == 0 and aligned pointers),
// else with one 4-byte load a column.  Both load paths sum the same
// points in the same order, so a row's bits depend on D, k and its own
// inputs alone, never on U, the grid, the alignment or the batch the
// row sits in (the meshed moments flush, which solves each device's
// slice of rows, is held bitwise to the unmeshed one).  k is a template
// parameter (the launch dispatches 1..16): exactly 2(k+1) accumulators
// live in registers and the recurrence runs to k with nothing
// predicated.  An xor butterfly of warp shuffles then adds the G
// partials of each accumulator in a fixed order (log2 G rounds; no
// atomics), every lane of the group ends with the row's sums, and lane
// l writes the output columns j with j % G == l: straight to the output
// where G >= 4, through a shared staging where a warp holds 16 or 32
// rows, which then leave as one contiguous run (a row is 2(k+1) floats,
// 72 bytes at k = 8; stored a column at a time from 32 rows, each store
// would touch 32 sectors).  The depth variant reads its row's depth
// once and loads no weights.
//
// Numerics match the plain PyTorch version (ops/moments_eval.py
// _tile_moments) term for term: the library builds with -fmad=false and
// without fast math, so 2v - (a+b), the scaling, the clip, logf (full
// precision) and the recurrence 2t*T_j - T_(j-1) round as PyTorch rounds
// them; only the order of the sum over a row differs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kMaxK = 16;                    // sketch_moments_k <= 16
constexpr int kThreads = 256;
constexpr int kLanePoints = 16;              // points a lane sums, about
constexpr int kBatch = 4;                    // quads a lane loads ahead
constexpr unsigned kFull = 0xFFFFFFFFu;

// jnp.clip(x, -1, 1) / torch.clamp: NaN passes through
__device__ __forceinline__ float clip1(float x) {
  return x < -1.0f ? -1.0f : (x > 1.0f ? 1.0f : x);
}

// a row's domain constants, as _tile_moments forms them
struct Domain {
  float apb, inv, lapb, linv;
};

__device__ __forceinline__ Domain domain_of(const float* ab, const float* lab,
                                            long row, int u) {
  const float a = ab[row];
  const float b = ab[u + row];
  const float la = lab[row];
  const float lb = lab[u + row];
  const float span = fmaxf(b - a, 0.0f);
  const float lspan = lb - la;
  Domain m;
  m.apb = a + b;
  m.inv = span > 0.0f ? 1.0f / fmaxf(span, 1e-30f) : 0.0f;
  m.lapb = la + lb;
  m.linv = lspan > 0.0f ? 1.0f / fmaxf(lspan, 1e-30f) : 0.0f;
  return m;
}

// one point into the 2(K+1) sums: acc[0..K] count, raw_1..raw_K;
// acc[K+1..2K+1] positive mass, log_1..log_K
template <int K>
__device__ __forceinline__ void add_point(float v, float w, const Domain& m,
                                          float (&acc)[2 * (K + 1)]) {
  const float t = clip1((2.0f * v - m.apb) * m.inv);
  const bool pos = v > 0.0f && w > 0.0f;
  const float lw = pos ? w : 0.0f;
  const float lv = logf(pos ? v : 1.0f);
  const float s = clip1((2.0f * lv - m.lapb) * m.linv);
  acc[0] += w;
  acc[K + 1] += lw;
  float tp = 1.0f, tj = t, sp = 1.0f, sj = s;
#pragma unroll
  for (int j = 1; j <= K; ++j) {
    acc[j] += w * tj;
    acc[K + 1 + j] += lw * sj;
    const float tn = 2.0f * t * tj - tp;
    const float sn = 2.0f * s * sj - sp;
    tp = tj;
    tj = tn;
    sp = sj;
    sj = sn;
  }
}

__device__ __forceinline__ float lane_of(const float4& q, int e) {
  return e == 0 ? q.x : (e == 1 ? q.y : (e == 2 ? q.z : q.w));
}

// quad q (columns 4q..4q+3, those below d) of a row; the vector path
// needs d % 4 == 0 and a 16-byte aligned row
template <bool kVec>
__device__ __forceinline__ float4 load_quad(const float* __restrict__ row,
                                            int q, int d) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(row) + q);
  const int c = 4 * q;
  float4 r = {0.0f, 0.0f, 0.0f, 0.0f};
  r.x = __ldg(row + c);
  if (c + 1 < d) r.y = __ldg(row + c + 1);
  if (c + 2 < d) r.z = __ldg(row + c + 2);
  if (c + 3 < d) r.w = __ldg(row + c + 3);
  return r;
}

template <int K, bool kDepth, bool kVec>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const float* __restrict__ dv, const float* __restrict__ dw,
               const short* __restrict__ depths,
               const float* __restrict__ ab, const float* __restrict__ lab,
               float* __restrict__ out, int u, int d, int glog) {
  constexpr int kAcc = 2 * (K + 1);
  const int g = 1 << glog;
  const int lane = threadIdx.x & (g - 1);
  const long row =
      (static_cast<long>(blockIdx.x) * kThreads + threadIdx.x) >> glog;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;

  if (row < u) {
    const Domain m = domain_of(ab, lab, row, u);
    const int depth = kDepth ? static_cast<int>(depths[row]) : 0;
    const float* vrow = dv + row * d;
    const float* wrow = kDepth ? nullptr : dw + row * d;
    const int nq = (d + 3) >> 2;
    for (int q0 = lane; q0 < nq; q0 += kBatch * g) {
      float4 vq[kBatch], wq[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int q = q0 + b * g;
        if (q < nq) {
          vq[b] = load_quad<kVec>(vrow, q, d);
          if (!kDepth) wq[b] = load_quad<kVec>(wrow, q, d);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int q = q0 + b * g;
        if (q < nq) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * q + e;
            if (c < d) {
              const float w = kDepth ? (c < depth ? 1.0f : 0.0f)
                                     : lane_of(wq[b], e);
              add_point<K>(lane_of(vq[b], e), w, m, acc);
            }
          }
        }
      }
    }
  }

  // fixed-order butterfly inside the row's group (groups never straddle
  // a warp: g divides 32); every lane of the warp takes part
  for (int off = g >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      acc[i] += __shfl_xor_sync(kFull, acc[i], off);
    }
  }

  if (glog >= 2) {
    // at most 8 rows a warp: lane l stores its row's columns j % g == l
    if (row < u) {
      float* orow = out + row * kAcc;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        if ((j & (g - 1)) == lane) orow[j] = acc[j];
      }
    }
    return;
  }
  // 16 or 32 rows a warp, neighbours in the output: staged in shared
  // memory, they leave as one contiguous run, 128 bytes a store (a
  // column at a time from the lanes, each store would touch a sector a
  // row)
  extern __shared__ float stage[];
  const int rows_warp = 32 >> glog;
  float* wstage = stage + (threadIdx.x >> 5) * rows_warp * kAcc;
  const int slot = (threadIdx.x & 31) >> glog;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    if ((j & (g - 1)) == lane) wstage[slot * kAcc + j] = acc[j];
  }
  __syncwarp();
  const long first = row - slot;
  const long left = static_cast<long>(u) - first;
  const int n = (left < rows_warp ? static_cast<int>(left) : rows_warp) * kAcc;
  float* orun = out + first * kAcc;
  for (int i = threadIdx.x & 31; i < n; i += 32) orun[i] = wstage[i];
}

// log2 of the lanes a row: G = min(32, the largest power of two
// <= max(1, D / kLanePoints)), so a lane sums about kLanePoints points
int group_log2(int d) {
  int glog = 0;
  while (glog < 5 && (kLanePoints << (glog + 1)) <= d) ++glog;
  return glog;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

using Launcher = void (*)(const float*, const float*, const short*,
                          const float*, const float*, float*, int, int, int,
                          int, cudaStream_t);

template <int K, bool kDepth, bool kVec>
void launch_k(const float* dv, const float* dw, const short* depths,
              const float* ab, const float* lab, float* out, int u, int d,
              int glog, int blocks, cudaStream_t stream) {
  const size_t smem = glog >= 2 ? 0
                                 : static_cast<size_t>(kThreads >> glog) *
                                       2 * (K + 1) * sizeof(float);
  moments_kernel<K, kDepth, kVec><<<blocks, kThreads, smem, stream>>>(
      dv, dw, depths, ab, lab, out, u, d, glog);
}

template <bool kDepth, bool kVec, int... Js>
Launcher pick(int k, std::integer_sequence<int, Js...>) {
  static constexpr Launcher table[] = {&launch_k<Js + 1, kDepth, kVec>...};
  return table[k - 1];
}

template <bool kDepth>
int launch(const float* dv, const float* dw, const short* depths,
           const float* ab, const float* lab, float* out, int u, int d,
           int k, void* stream) {
  if (u < 1 || d < 0 || k < 1 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int glog = group_log2(d);
  const long threads = static_cast<long>(u) << glog;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  const bool vec = d % 4 == 0 && aligned16(dv) && (kDepth || aligned16(dw));
  const auto ks = std::make_integer_sequence<int, kMaxK>();
  const Launcher fn =
      vec ? pick<kDepth, true>(k, ks) : pick<kDepth, false>(k, ks);
  fn(dv, dw, depths, ab, lab, out, u, d, glog, blocks,
     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vn_moments_sums(const float* dv, const float* dw,
                               const float* ab, const float* lab, float* out,
                               int u, int d, int k, void* stream) {
  return launch<false>(dv, dw, nullptr, ab, lab, out, u, d, k, stream);
}

extern "C" int vn_moments_sums_depth(const float* dv, const short* depths,
                                     const float* ab, const float* lab,
                                     float* out, int u, int d, int k,
                                     void* stream) {
  return launch<true>(dv, nullptr, depths, ab, lab, out, u, d, k, stream);
}
