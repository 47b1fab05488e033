// One bottom-up compaction pass of the compactor family (kernel B6).
//
// The Hopper counterpart of veneur_tpu/ops/compactor_eval.py's
// _compact_pallas (pallas_call at :155; _kernel_compact and _pass_tile
// at :79).  One entry point:
//
//   vn_compact_batch  stage [U, levels, 2cap] f32 (each level's staged
//                     items in an occupied prefix, +inf beyond it),
//                     stage_n [U, levels] i32 (the occupancies),
//                     off [U, levels + 2] i32 (the host-planned coin
//                     offsets, compactor.plan_pass: one per level, then
//                     the top level's two clip rounds)
//                  -> out [U, levels, cap] f32 (each level's retained
//                     items as a sorted prefix, +inf beyond)
//
// Per level, bottom-up, because what a level promotes joins the next
// level's buffer: sort the level's staging together with the carry from
// below (4cap values with the +inf padding of both), then promote every
// other item of the lowest m (from offset 0 or 1) as the next carry and
// keep items m .. occ-1 as the level's new state, where occ is the
// level's occupancy with the carry and m = 0 unless occ > cap
// (compactor.apply_pass).  The top level cannot promote: two clip
// rounds halve it in place instead.
//
// Order.  Values sort under the IEEE total order (-0 below +0; the keys
// are the float bits through the monotone map to unsigned integers), so
// equal keys are equal bits and every sort of a row gives the same bits.
// The plain PyTorch version (ops/compactor_eval.py) sorts by the same
// keys.  The JAX package's sorts (np.sort, jnp.sort) leave -0 and +0
// in no fixed order; on rows without zeros all of them agree bitwise.
// The plain version re-sorts each selection with +inf padding, and a
// positive NaN keys above +inf, so it sorts behind the padding: the
// kernel keeps that order too (below, "big" keys), so it is bitwise the
// plain version on every input.
//
// Design.  One warp owns one key (kWarps keys a CTA, from
// sort_network.cuh): the whole bottom-up level loop, the carry and the
// top level's clip rounds, with shared memory of its own and no barrier
// but __syncwarp, so no key waits for another.  Per level:
//   1. load: the n occupied staged values (16-byte loads where the
//      staging allows), keyed, padded to 2cap with the key of +inf (and,
//      at cap 8, to the warp's 32 with a key above every other);
//   2. sort: the 2cap staged keys only, in registers, with
//      sort_network.cuh's warp_bitonic over one row of 32 E keys
//      (E = 2cap / 32, one at cap 8 and 16); a level with nothing
//      staged skips it;
//   3. merge: the carry from below is already sorted (a stride-select
//      of the sorted buffer below), so the buffer is the stable merge
//      of two sorted lists, staged key i at i + #(carry < key) and
//      carry key j at j + #(staged <= key).  Lane l writes positions
//      [l span, (l + 1) span) of the first occ (all any selection
//      reads): a binary search along the merge's diagonal finds how
//      many of the first l span items are staged keys, and a
//      sequential merge writes the span.  With nothing carried the
//      buffer is the sorted staging, with nothing staged the carry;
//   4. select: the next carry (buffer item 2j + offset, read in place
//      by the next level) and the retained items m .. occ-1 are index
//      arithmetic, and so are the top level's clip rounds (clip_buf);
//   5. store: the level's cap outputs with 16-byte stores, +inf beyond
//      the occupancy (an empty level writes +inf the same way).
// Two buffers a warp take turns, so the next level reads its carry
// where this level left it.
//
// What bounds it.  Bytes: the occupied staging in (4 bytes a value),
// the occupancies and offsets, and the whole [U, levels, cap] state out.
// Work: per level that holds anything, one 2cap-key warp network,
// 2cap lg (lg + 1) / 4 compare-exchanges with lg = log2(2cap) (4,608 at
// cap 128, where the plain version's 4cap network makes 11,520), plus a
// lane's search and span of the merge.  At the flush's shape (U 16384,
// cap 128, levels 14) the output alone is 117 MB (35 us at 3.35 TB/s),
// against 0.75G compare-exchanges at most (11 us at 67 T/s): bytes, on
// paper.  On the card the network takes most of the time where many
// levels hold items.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_network.cuh"   // kWarps, kWarpThreads, slot, warp_bitonic

namespace {

constexpr int kClipRounds = 2;              // compactor.CLIP_ROUNDS
constexpr unsigned kPadKey = 0xFF800000u;   // the key of +inf
constexpr unsigned kBeyond = 0xFFFFFFFFu;   // above every key

// float bits -> unsigned key, monotone in the IEEE total order
__device__ __forceinline__ unsigned to_key(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// A positive NaN keys above +inf ("big"); a selection that the plain
// version re-sorts with +inf padding reads +inf in its place.
__device__ __forceinline__ unsigned clamp_key(unsigned k) {
  return min(k, kPadKey);
}

template <int kCap>
struct Geometry {
  static constexpr int kS2 = 2 * kCap;              // staging width
  static constexpr int kD = kS2 < 32 ? 32 : kS2;    // network width
  static constexpr int kE = kD / 32;                // keys a lane
  static constexpr int kBuf = 4 * kCap;             // the plain buffer
  static constexpr int kStagedWords = kS2 + kS2 / 32 + 1;
  static constexpr int kBufWords = kBuf + kBuf / 32 + 1;
};

// The level's staged keys, lane l holding E of the 32 E network points:
// the n occupied values keyed, kPadKey to 2cap, kBeyond past it.
template <int kCap>
__device__ __forceinline__ void load_keys(
    const float* __restrict__ st, int n, int lane,
    unsigned (&x)[Geometry<kCap>::kE]) {
  using G = Geometry<kCap>;
  if constexpr (G::kE >= 4) {
    // point 4 i + c of the float4 i = lane + 32 k is x[4 k + c]: the
    // network sorts any arrangement of its keys
    if ((reinterpret_cast<uintptr_t>(st) & 15) == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(st);
#pragma unroll
      for (int k = 0; k < G::kE / 4; ++k) {
        const int i = lane + 32 * k;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (4 * i < n) v = __ldg(s4 + i);
        x[4 * k] = 4 * i < n ? to_key(v.x) : kPadKey;
        x[4 * k + 1] = 4 * i + 1 < n ? to_key(v.y) : kPadKey;
        x[4 * k + 2] = 4 * i + 2 < n ? to_key(v.z) : kPadKey;
        x[4 * k + 3] = 4 * i + 3 < n ? to_key(v.w) : kPadKey;
      }
      return;
    }
  }
#pragma unroll
  for (int r = 0; r < G::kE; ++r) {
    const int p = lane + 32 * r;
    x[r] = p < n ? to_key(__ldg(st + p))
                 : (p < G::kS2 ? kPadKey : kBeyond);
  }
}

// The carry's key j: the level below's buffer item 2j + o, clamped (the
// plain version re-sorts the carry with +inf padding and cuts it).
__device__ __forceinline__ unsigned carry_at(const unsigned* below, int o,
                                             int j) {
  return clamp_key(below[slot(2 * j + o)]);
}

// The carry as the plain version pads it: its cn keys, then +inf.
__device__ __forceinline__ unsigned padded_carry(const unsigned* below,
                                                 int o, int cn, int j) {
  return j < cn ? carry_at(below, o, j) : kPadKey;
}

// Items [d, end) of the merged buffer: the stable merge of the s2
// sorted staged keys with the padded carry (s2 keys), a staged key
// first among equal ones (so a big staged key sorts behind the carry's
// padding, as in the plain version's sort).  The co-rank of d (how many
// of the first d items are staged) is a binary search along the
// diagonal; the span after it is a sequential merge.
__device__ __forceinline__ void merge_span(const unsigned* staged,
                                           const unsigned* below, int o,
                                           int cn, int s2, int d, int end,
                                           unsigned* buf) {
  int lo = max(0, d - s2), hi = min(d, s2);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (staged[slot(mid)] <= padded_carry(below, o, cn, d - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo, j = d - lo;
  unsigned a = i < s2 ? staged[slot(i)] : 0u;
  unsigned b = j < s2 ? padded_carry(below, o, cn, j) : 0u;
  for (int q = d; q < end; ++q) {
    if (j >= s2 || (i < s2 && a <= b)) {
      buf[slot(q)] = a;
      if (++i < s2) a = staged[slot(i)];
    } else {
      buf[slot(q)] = b;
      if (++j < s2) b = padded_carry(below, o, cn, j);
    }
  }
}

// One clip round of the top level on the buffer T before it (T_0 the
// merged buffer): it keeps K, the `half` survivors T[2t + o] and then
// T[m .. top), and the plain version re-sorts K with +inf padding to
// the 4cap buffer B = K's first `ks` keys (those not big), `pads`
// +inf, then K's big keys.
struct Clip {
  int half, m, o, topn, ks, pads;
};

template <int R>
__device__ unsigned clip_buf(const unsigned* buf, const Clip* c, int q);

template <int R>
__device__ __forceinline__ unsigned clip_kept(const unsigned* buf,
                                              const Clip* c, int t) {
  const Clip& k = c[R - 1];
  return t < k.half ? clip_buf<R - 1>(buf, c, 2 * t + k.o)
                    : clip_buf<R - 1>(buf, c, t - k.half + k.m);
}

// Item q of the buffer after R clip rounds.
template <int R>
__device__ unsigned clip_buf(const unsigned* buf, const Clip* c, int q) {
  if constexpr (R == 0) {
    return buf[slot(q)];
  } else {
    const Clip& k = c[R - 1];
    if (q < k.ks) return clip_kept<R>(buf, c, q);
    if (q < k.ks + k.pads) return kPadKey;
    return clip_kept<R>(buf, c, q - k.pads);
  }
}

// Round R's parameters on a buffer of `top` items (c[R - 1] set).
template <int R>
__device__ __forceinline__ int clip_round(const unsigned* buf, Clip* c,
                                          int top, int cap, int bufn,
                                          int offset) {
  const int m = top > cap ? top - (top & 1) : 0;
  Clip& k = c[R - 1];
  k.half = m >> 1;
  k.m = m;
  k.o = offset & 1;
  k.topn = top - k.half;
  k.pads = bufn - k.topn;
  // K is sorted: its keys that are not big are a prefix
  k.ks = k.topn;
  if (k.topn > 0 && clip_kept<R>(buf, c, k.topn - 1) > kPadKey) {
    int lo = 0, hi = k.topn - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (clip_kept<R>(buf, c, mid) <= kPadKey) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    k.ks = lo;
  }
  return k.topn;
}

// Writes the level's cap outputs, from_key(key_at(j)), 16 bytes a store
// where the row allows.
template <int kCap, typename F>
__device__ __forceinline__ void store_level(float* ol, int lane, F key_at) {
  if ((reinterpret_cast<uintptr_t>(ol) & 15) == 0) {
    float4* o4 = reinterpret_cast<float4*>(ol);
    for (int i = lane; i < kCap / 4; i += 32) {
      o4[i] = make_float4(from_key(key_at(4 * i)), from_key(key_at(4 * i + 1)),
                          from_key(key_at(4 * i + 2)),
                          from_key(key_at(4 * i + 3)));
    }
  } else {
    for (int j = lane; j < kCap; j += 32) ol[j] = from_key(key_at(j));
  }
}

template <int kCap>
__global__ void __launch_bounds__(kWarpThreads)
    compact_kernel(const float* __restrict__ stage,
                   const int* __restrict__ stage_n,
                   const int* __restrict__ off, float* __restrict__ out,
                   int u, int levels) {
  using G = Geometry<kCap>;
  constexpr int kKeep = kCap / 2;
  __shared__ unsigned s_staged[kWarps][G::kStagedWords];
  __shared__ unsigned s_buf[kWarps][2][G::kBufWords];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kWarps + warp;
  if (row >= u) return;                 // the whole warp
  unsigned* staged = s_staged[warp];
  const float* st = stage + row * levels * G::kS2;
  const int* sn = stage_n + row * levels;
  const int* of = off + row * (levels + kClipRounds);
  float* o = out + row * levels * kCap;
  int carry_n = 0, carry_o = 0, cur = 0;
  for (int lvl = 0; lvl < levels; ++lvl) {
    const int n = min(max(sn[lvl], 0), G::kS2);
    const int occ = n + carry_n;
    float* ol = o + lvl * kCap;
    if (occ == 0) {
      // nothing staged and nothing carried: the level stays empty
      store_level<kCap>(ol, lane, [](int) { return kPadKey; });
      continue;
    }
    const unsigned* below = s_buf[warp][cur ^ 1];   // the carry's buffer
    unsigned* buf = s_buf[warp][cur];

    unsigned x[G::kE];
    if (n > 0) {
      load_keys<kCap>(st + lvl * G::kS2, n, lane, x);
      warp_bitonic<G::kE>(x, G::kD, lane);
      // x[r] is now sorted point lane E + r
    }
    if (carry_n == 0) {
      // the buffer is the sorted staging; a big key sorts behind the
      // carry's padding, so +inf reads in its place
#pragma unroll
      for (int r = 0; r < G::kE; ++r) {
        const int p = lane * G::kE + r;
        if (p < n) buf[slot(p)] = clamp_key(x[r]);
      }
    } else if (n == 0) {
      // the buffer is the carry
      for (int q = lane; q < carry_n; q += 32)
        buf[slot(q)] = carry_at(below, carry_o, q);
    } else {
#pragma unroll
      for (int r = 0; r < G::kE; ++r) {
        const int p = lane * G::kE + r;
        if (p < G::kS2) staged[slot(p)] = x[r];
      }
      __syncwarp();
      // lane l merges the buffer's items [l span, (l + 1) span)
      const int span = (occ + 31) >> 5;
      const int d = min(lane * span, occ);
      merge_span(staged, below, carry_o, carry_n, G::kS2, d,
                 min(d + span, occ), buf);
    }
    __syncwarp();

    if (lvl < levels - 1) {
      const int sec = occ - kKeep;
      const int m = occ > kCap ? sec - (sec & 1) : 0;
      store_level<kCap>(ol, lane, [&](int j) {
        return m + j < occ ? clamp_key(buf[slot(m + j)]) : kPadKey;
      });
      carry_n = m >> 1;
      carry_o = of[lvl] & 1;
      cur ^= 1;
    } else {
      static_assert(kClipRounds == 2, "clip rounds are unrolled");
      Clip c[kClipRounds];
      int top = clip_round<1>(buf, c, occ, kCap, G::kBuf, of[levels]);
      clip_round<2>(buf, c, top, kCap, G::kBuf, of[levels + 1]);
      store_level<kCap>(ol, lane,
                        [&](int j) { return clip_buf<2>(buf, c, j); });
    }
  }
}

template <int kCap>
int launch(const float* stage, const int* stage_n, const int* off,
           float* out, int u, int levels, void* stream) {
  const unsigned blocks = static_cast<unsigned>((u + kWarps - 1) / kWarps);
  compact_kernel<kCap><<<blocks, kWarpThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      stage, stage_n, off, out, u, levels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vn_compact_batch(const float* stage, const int* stage_n,
                                const int* off, float* out, int u,
                                int levels, int cap, void* stream) {
  if (u <= 0) return 0;
  if (levels < 2 || levels > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (cap) {
    case 8: return launch<8>(stage, stage_n, off, out, u, levels, stream);
    case 16: return launch<16>(stage, stage_n, off, out, u, levels, stream);
    case 32: return launch<32>(stage, stage_n, off, out, u, levels, stream);
    case 64: return launch<64>(stage, stage_n, off, out, u, levels, stream);
    case 128:
      return launch<128>(stage, stage_n, off, out, u, levels, stream);
    case 256:
      return launch<256>(stage, stage_n, off, out, u, levels, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
