// HLL register moments: the per-row reduction of the cardinality
// estimate (kernel B8).
//
// The Hopper counterpart of veneur_tpu/ops/hll_estimate.py's
// register_moments (pallas_call at :48; _reduce_kernel at :31).  One
// entry point:
//
//   vn_register_moments  regs [S, m] u8 row-major (m = 2^p registers,
//                        16384 at the default precision 14)
//                     -> out [S, 2] f32: the count of zero registers and
//                        the sum of 2^-r over the row
//
// The estimator tail (LogLog-Beta) runs after it on the [S, 2] moments,
// in plain PyTorch (sketches/hll.py estimate_from_moments).
//
// Design.  A warp a row, kWarps rows a block, no block barrier.  The
// row is read as 16-byte quads: lane l takes quads l, l + 32, l + 64,
// ... (a warp's load covers 512 contiguous bytes), kBatch of them in
// flight before the first is used.  Per 32-bit word of a quad:
//   * zeros: the exact zero-byte mask (((w & 0x7F7F7F7F) + 0x7F7F7F7F)
//     | w | 0x7F7F7F7F, inverted, has bit 7 of each zero byte), counted
//     by __popc;
//   * 2^-r from the exponent bits: for r <= 126 the f32 2^-r has the
//     biased exponent 127 - r = r ^ 127 and no mantissa, one shift and
//     one LOP3 a byte.  A quad holding a byte >= 127 (flagged by
//     ((w + 0x01010101) | w) & 0x80808080, which may also flag some
//     smaller bytes, never misses one) takes every byte through
//     exp2_neg: the denormal 2^-r for 127 <= r <= 149, 0 from r = 150,
//     as f32 exp2 rounds them;
//   * the word's four terms add as (t0 + t1) + (t2 + t3) into the
//     lane's accumulator of that word position (four independent
//     chains), quad after quad.
// The lane's total is (a0 + a1) + (a2 + a3), then an xor butterfly
// over the 32 lanes; the zero counts add by __reduce_add_sync.  Every
// step's order depends on m alone, so a row's bits are the same in any
// batch, at any row index and on either load path.  A row whose length
// is not a multiple of 16, or whose start is not 16-byte aligned, reads
// byte by byte in that same order (a byte past the row adds 0).
//
// Numerics.  The zero count is exact.  The sum adds the same powers of
// two as the plain version (torch.exp2(-r).sum(1)) in another order, so
// it can differ from it in its last bits; chip_smoke.py and the CPU
// tests hold it within rtol 1e-6, and tests/test_torch_hll_estimate.py
// holds a numpy model of this order to the JAX package's kernel.
//
// What bounds it.  Bytes: the registers read once and 8 bytes a row
// written, S * (m + 8).  At 10,000 sets x 16,384 registers that is 164
// MB, 49 us at an H100 SXM's 3.35 TB/s (NVIDIA's data sheet).  Work:
// about 5 integer or f32 instructions a register, about half of that
// time at the card's instruction rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // rows (warps) a block
constexpr int kBatch = 16;                // quads a lane loads at a time
constexpr unsigned kFull = 0xFFFFFFFFu;

// 2^-r in f32 for any byte r, as exp2f(-r) rounds it: normal through
// r = 126, the denormal 2^(149 - r) ulps for 127 <= r <= 149, then 0.
__device__ __forceinline__ float exp2_neg(unsigned r) {
  if (r <= 126u) return __uint_as_float((127u - r) << 23);
  return r <= 149u ? __uint_as_float(1u << (149u - r)) : 0.0f;
}

// The count of zero bytes of w.
__device__ __forceinline__ int zero_bytes(unsigned w) {
  const unsigned y = ((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w | 0x7F7F7F7Fu;
  return __popc(~y);
}

// (t0 + t1) + (t2 + t3) of a word whose bytes are all <= 126: byte b's
// exponent field (b ^ 127) << 23 from one shift and one mask.
__device__ __forceinline__ float word_terms_fast(unsigned w) {
  const unsigned e = 0x7F800000u, one = 0x3F800000u;
  const float t0 = __uint_as_float(((w << 23) & e) ^ one);
  const float t1 = __uint_as_float(((w << 15) & e) ^ one);
  const float t2 = __uint_as_float(((w << 7) & e) ^ one);
  const float t3 = __uint_as_float(((w >> 1) & e) ^ one);
  return __fadd_rn(__fadd_rn(t0, t1), __fadd_rn(t2, t3));
}

// The same sum for any bytes.
__device__ __forceinline__ float word_terms(unsigned w) {
  const float t0 = exp2_neg(w & 0xFFu), t1 = exp2_neg((w >> 8) & 0xFFu);
  const float t2 = exp2_neg((w >> 16) & 0xFFu), t3 = exp2_neg(w >> 24);
  return __fadd_rn(__fadd_rn(t0, t1), __fadd_rn(t2, t3));
}

// Whether a quad may hold a byte >= 127 (never false when it does).
__device__ __forceinline__ bool wide_bytes(uint4 q) {
  const unsigned k = 0x01010101u;
  const unsigned f = ((q.x + k) | q.x) | ((q.y + k) | q.y) |
                     ((q.z + k) | q.z) | ((q.w + k) | q.w);
  return (f & 0x80808080u) != 0u;
}

__device__ __forceinline__ void add_quad(uint4 q, int& zeros,
                                         float (&acc)[4]) {
  zeros += zero_bytes(q.x) + zero_bytes(q.y) + zero_bytes(q.z) +
           zero_bytes(q.w);
  if (wide_bytes(q)) {
    acc[0] = __fadd_rn(acc[0], word_terms(q.x));
    acc[1] = __fadd_rn(acc[1], word_terms(q.y));
    acc[2] = __fadd_rn(acc[2], word_terms(q.z));
    acc[3] = __fadd_rn(acc[3], word_terms(q.w));
  } else {
    acc[0] = __fadd_rn(acc[0], word_terms_fast(q.x));
    acc[1] = __fadd_rn(acc[1], word_terms_fast(q.y));
    acc[2] = __fadd_rn(acc[2], word_terms_fast(q.z));
    acc[3] = __fadd_rn(acc[3], word_terms_fast(q.w));
  }
}

__global__ void __launch_bounds__(32 * kWarps)
    register_moments_kernel(const uint8_t* __restrict__ regs,
                            float* __restrict__ out, int s, int m) {
  const int lane = threadIdx.x & 31;
  const long row_id = static_cast<long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (row_id >= s) return;
  const uint8_t* row = regs + row_id * m;
  const int quads = (m + 15) >> 4;
  int zeros = 0;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if ((m & 15) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
    for (int q0 = lane; q0 < quads; q0 += 32 * kBatch) {
      uint4 b[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int q = q0 + 32 * j;
        b[j] = q < quads ? __ldcs(v + q) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (q0 + 32 * j < quads) add_quad(b[j], zeros, acc);
      }
    }
  } else {
    // the same quads in the same order, a byte at a time; a byte past
    // the row adds 0 to its word's sum
    for (int q = lane; q < quads; q += 32) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float t[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = 16 * q + 4 * k + b;
          t[b] = 0.0f;
          if (i < m) {
            const unsigned r = __ldg(row + i);
            zeros += r == 0u ? 1 : 0;
            t[b] = exp2_neg(r);
          }
        }
        acc[k] = __fadd_rn(acc[k], __fadd_rn(__fadd_rn(t[0], t[1]),
                                             __fadd_rn(t[2], t[3])));
      }
    }
  }
  float sum =
      __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, o));
  }
  const unsigned z = __reduce_add_sync(kFull, static_cast<unsigned>(zeros));
  if (lane == 0) {
    out[2 * row_id] = static_cast<float>(z);
    out[2 * row_id + 1] = sum;
  }
}

}  // namespace

extern "C" int vn_register_moments(const uint8_t* regs, float* out, int s,
                                   int m, void* stream) {
  if (s <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (s + kWarps - 1) / kWarps;
  register_moments_kernel<<<blocks, 32 * kWarps, 0,
                            static_cast<cudaStream_t>(stream)>>>(regs, out,
                                                                 s, m);
  return static_cast<int>(cudaGetLastError());
}
