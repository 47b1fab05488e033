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
//               (sort_network.cuh bitonic_rows<true>; B1's formulation
//               before B1 moved to packed words in registers);
//   1 (v1, v2)  the min/max + moved-mask stage of sorted_eval.py:176-195:
//               branch-free selects, every slot written, still in
//               shared memory with one barrier a stage;
//   2 (v3..v6)  the partner by xor with the points in registers, one a
//               thread (1024 threads a CTA): stages of stride j < 32
//               exchange by __shfl_xor_sync with no barrier; only
//               stages with j >= 32 go through shared memory (two
//               buffers in turn, so one barrier a stage).  For D = 256
//               that is 6 barrier stages of 36;
//   3 (c0)      the packed bf16-key|column word network in registers,
//               two points a lane (sort_network.cuh compact_network,
//               B4's first formulation), D <= 64, then the gather of
//               each point's value and weight;
//   4 (c1)      the key-only network (bitonic_rows<false>, B3's first
//               formulation, whose exchanges B3's warp network makes)
//               on the keys rounded to bf16 and widened at load; the
//               weights stay in column order, as the TPU's c1 emits
//               them.
// c0 and c1 round the f32 values to bf16 (round to nearest even) at
// load; on bf16-exact input that changes nothing.
//
// Bounded by bytes: 2 U D 4 in, U 12 out, over 3.35 TB/s; the network's
// U D log2(D) (log2(D) + 1) / 4 compare-exchanges take a fraction of
// that at the card's f32 rate.

#include "sort_network.cuh"

namespace {

constexpr int kV0 = 0, kV1 = 1, kXor = 2, kC0 = 3, kC1 = 4;
constexpr int kMaxCompactDepth = 64;

// The [U, 3] emit of the CTA's rows from key[] and w[] in shared
// memory (any thread count; a barrier behind the caller's last write).
__device__ void emit_rows(float* key, const float* w,
                          float* __restrict__ out, int u, int d, long row0) {
  const int rows = kBlockPoints / d;
  const long left = static_cast<long>(u) - row0;
  const int valid = left < rows ? static_cast<int>(left) : rows;
  for (int r = threadIdx.x; r < valid; r += blockDim.x) {
    out[(row0 + r) * 3] = key[r * d];
    out[(row0 + r) * 3 + 1] = key[r * d + d / 2];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kBlockPoints; e += blockDim.x) {
    key[e] = __fmul_rn(key[e], key[e] != CUDART_INF_F ? w[e] : 0.0f);
  }
  __syncthreads();
  row_sums(key, d);
  for (int r = threadIdx.x; r < valid; r += blockDim.x) {
    out[(row0 + r) * 3 + 2] = key[r * d];
  }
}

__device__ __forceinline__ float bf16_key(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v1: every stage reads both slots of its pair and writes both, the
// kept key by min/max and the weight by whether the key moved.
__device__ void bitonic_rows_minmax(float* key, float* w, int d) {
  const int t = threadIdx.x;
  for (int k = 2; k <= d; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int i = 2 * t - (t & (j - 1));
      const int p = i + j;
      const bool asc = ((i & (d - 1)) & k) == 0;
      const float ki = key[i], kp = key[p];
      const float wi = w[i], wp = w[p];
      const float lo = fminf(ki, kp), hi = fmaxf(ki, kp);
      const float ni = asc ? lo : hi;
      const float np = asc ? hi : lo;
      key[i] = ni;
      key[p] = np;
      w[i] = ni != ki ? wp : wi;
      w[p] = np != kp ? wi : wp;
      __syncthreads();
    }
  }
}

// Modes 0, 1, 3 and 4: kThreads threads, the block in shared memory.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
shared_variant_kernel(const float* __restrict__ mean,
                      const float* __restrict__ weight,
                      float* __restrict__ out, int u, int d) {
  __shared__ float key[kBlockPoints];
  __shared__ float w[kBlockPoints];
  __shared__ float stage_v[kBlockPoints];   // c0: staged values
  __shared__ float stage_w[kBlockPoints];   // c0: staged weights

  const int t = threadIdx.x;
  const long row0 = static_cast<long>(blockIdx.x) * (kBlockPoints / d);
  const long base = row0 * d;
  const long limit = static_cast<long>(u) * d;
  if constexpr (kMode == kV0 || kMode == kV1) {
    load_pairs(mean, weight, key, w, base, limit);
    __syncthreads();
    if constexpr (kMode == kV0) {
      bitonic_rows<true>(key, w, d);
    } else {
      bitonic_rows_minmax(key, w, d);
    }
  } else if constexpr (kMode == kC1) {
    for (int e = t; e < kBlockPoints; e += kThreads) {
      float v = CUDART_INF_F, ww = 0.0f;
      if (base + e < limit) {
        ww = weight[base + e];
        v = ww > 0.0f ? bf16_key(mean[base + e]) : CUDART_INF_F;
      }
      key[e] = v;
      w[e] = ww;
    }
    __syncthreads();
    bitonic_rows<false>(key, nullptr, d);
  } else {   // c0
    unsigned word[2];
    for (int s = 0; s < 2; ++s) {
      const int e = 2 * t + s;
      __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
      float ww = 0.0f;
      if (base + e < limit) {
        v = __float2bfloat16_rn(mean[base + e]);
        ww = weight[base + e];
      }
      stage_v[e] = __bfloat162float(v);
      stage_w[e] = ww;
      word[s] = compact_word(v, ww, e & (d - 1));
    }
    compact_network(word, d);
    __syncthreads();   // staged values and weights visible to the gather
    for (int s = 0; s < 2; ++s) {
      const int e = 2 * t + s;
      const int src = (e & ~(d - 1)) | static_cast<int>(word[s] & 0xFFFFu);
      w[e] = stage_w[src];
      key[e] = w[e] > 0.0f ? stage_v[src] : CUDART_INF_F;
    }
    __syncthreads();
  }
  emit_rows(key, w, out, u, d, row0);
}

// Mode 2 (v3): one point a thread, kBlockPoints threads.
__global__ void __launch_bounds__(kBlockPoints)
xor_variant_kernel(const float* __restrict__ mean,
                   const float* __restrict__ weight,
                   float* __restrict__ out, int u, int d) {
  __shared__ float xk[2][kBlockPoints];   // j >= 32 exchanges, in turn
  __shared__ float xw[2][kBlockPoints];
  __shared__ float key_s[kBlockPoints];
  __shared__ float w_s[kBlockPoints];

  const int t = threadIdx.x;
  const long row0 = static_cast<long>(blockIdx.x) * (kBlockPoints / d);
  const long at = row0 * d + t;
  float key = CUDART_INF_F, w = 0.0f;
  if (at < static_cast<long>(u) * d) {
    w = weight[at];
    key = w > 0.0f ? mean[at] : CUDART_INF_F;
  }
  int buf = 0;
  for (int k = 2; k <= d; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      float pk, pw;
      if (j < 32) {
        pk = __shfl_xor_sync(0xFFFFFFFFu, key, j);
        pw = __shfl_xor_sync(0xFFFFFFFFu, w, j);
      } else {
        xk[buf][t] = key;
        xw[buf][t] = w;
        __syncthreads();
        pk = xk[buf][t ^ j];
        pw = xw[buf][t ^ j];
        buf ^= 1;
      }
      const bool lower = (t & j) == 0;
      const bool asc = ((t & (d - 1)) & k) == 0;
      const float nk = (lower == asc) ? fminf(key, pk) : fmaxf(key, pk);
      w = nk != key ? pw : w;
      key = nk;
    }
  }
  key_s[t] = key;
  w_s[t] = w;
  __syncthreads();
  emit_rows(key_s, w_s, out, u, d, row0);
}

template <int kMode>
int launch_shared(const float* mean, const float* weight, float* out, int u,
                  int d, void* stream) {
  shared_variant_kernel<kMode><<<blocks_for(u, d), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      mean, weight, out, u, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 v0, 1 v1, 2 xor (v3), 3 c0 (D <= 64), 4 c1; out is [U, 3].
extern "C" int vn_sort_variant(const float* mean, const float* weight,
                               float* out, int u, int d, int mode,
                               void* stream) {
  switch (mode) {
    case kV0:
      return launch_shared<kV0>(mean, weight, out, u, d, stream);
    case kV1:
      return launch_shared<kV1>(mean, weight, out, u, d, stream);
    case kXor:
      xor_variant_kernel<<<blocks_for(u, d), kBlockPoints, 0,
                           static_cast<cudaStream_t>(stream)>>>(
          mean, weight, out, u, d);
      return static_cast<int>(cudaGetLastError());
    case kC0:
      if (d > kMaxCompactDepth) return cudaErrorInvalidValue;
      return launch_shared<kC0>(mean, weight, out, u, d, stream);
    case kC1:
      return launch_shared<kC1>(mean, weight, out, u, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
