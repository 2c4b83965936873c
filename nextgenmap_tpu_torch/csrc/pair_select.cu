// Pair select: the paired tail's pair resolution for Hopper (sm_90a).
//
// Replaces the pair resolution of nextgenmap_tpu/models/mapper.py::
// _paired_tail (XLA-fused under jax.jit), whose port in plain torch
// (ops/pair_kernel.py::pair_select_plain) builds some twenty [P, C, C]
// tensors a step.  For pair i, mates in rows 2i and 2i + 1 of the [B, C]
// candidate arrays, with p = corr_start + slack:
//   valid(c1, c2) = strand1 != strand2
//                 & (strand1 == 0 ? p1 <= p2 + margin : p2 <= p1 + margin)
//                 & min_insert - margin <= |p2 - p1| + L <= max_insert + margin
//                 & exist1 & exist2 & s1 > 0 & s2 > 0,
//   value(c1, c2) = valid ? s1 + s2 : -1,
// pair_best and (c1, c2) the first maximum of value over the flat index
// c1 x C + c2 (torch.argmax's rule, ROADMAP C5).  A pair where a mate has
// >= 2 candidates is proper iff pair_best > 0 and float(pair_best) >=
// pair_cutoff x float(best1 + best2), one float32 product, unfused (C6);
// a pair of singles iff the (0, 0) geometry holds and both mates have a
// candidate.  A proper pair takes (c1, c2) ((0, 0) for singles), any
// other pair each mate's first best column of sw.  Every integer sum,
// difference and abs wraps as torch's int32 does: computed on unsigned,
// so no signed overflow is undefined.
//
// What bounds it on the card: nothing but latency.  The inputs are 13
// bytes a candidate and 4 a read (1.7 MB at 4096 x 32; 0.5 us at 3.35
// TB/s) and the grid 15-odd int ops a combination (2.1M at P 2048, C 32;
// 2 us at 16.7 Tops/s).  So one short launch, no tensor cores, no TMA.
//
// Design: a warp a pair, kWarps pairs a block.  Lane l holds the columns
// c = l, l + 32, ... of both mates (coalesced loads).  The grid runs only
// for a pair with a mate of >= 2 candidates (the other pairs never read
// it): for each 32-column chunk of mate 1 (lane l's c1) and each chunk of
// mate 2, mate 2's columns are broadcast one by one by __shfl_sync, so a
// lane visits its c1 values in ascending order, and for each c1 every c2
// in ascending order.  Lane-local (value desc, flat index asc) maxima meet
// in a butterfly reduction, which gives the first maximum over the whole
// row whatever C is; all -1 gives flat index 0, as torch does.  The
// singletons (best score and first best column of each mate) reduce the
// same way.  Lane 0 writes a1 and proper for both mates.  With a counter
// pointer (tracing on) each block adds its gridded and broken pairs with
// one atomic each; without one the kernel runs no atomic.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                 // pairs a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int wabs(int a) {   // abs(INT_MIN) is INT_MIN
  return a < 0 ? static_cast<int>(0u - static_cast<unsigned>(a)) : a;
}

// The mask of one combination but the existence and score terms.
__device__ __forceinline__ bool geometry(int p1, int t1, int p2, int t2,
                                         int L, int margin, int lo, int hi) {
  const bool fwd_left = t1 == 0 ? p1 <= wadd(p2, margin)
                                : p2 <= wadd(p1, margin);
  const int span = wadd(wabs(wsub(p2, p1)), L);
  return t1 != t2 && fwd_left && span >= lo && span <= hi;
}

// (value desc, index asc): whether (v, i) comes before (bv, bi).
__device__ __forceinline__ bool before(int v, int i, int bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The warp's first maximum of (v, i), in every lane.
__device__ __forceinline__ void warp_first_max(int& v, int& i) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int ov = __shfl_xor_sync(kFull, v, d);
    const int oi = __shfl_xor_sync(kFull, i, d);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
pair_select_kernel(const int32_t* __restrict__ sw,
                   const int32_t* __restrict__ corr,
                   const int32_t* __restrict__ strand,
                   const uint8_t* __restrict__ valid,
                   const int32_t* __restrict__ n_cands,
                   const int32_t* __restrict__ min_insert,
                   const int32_t* __restrict__ max_insert,
                   const float* __restrict__ pair_cutoff, int P, int C,
                   int L, int slack, int margin,
                   unsigned long long* __restrict__ counters,
                   int64_t* __restrict__ a1, uint8_t* __restrict__ proper) {
  __shared__ int s_count[kWarps][2];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int pair = blockIdx.x * kWarps + warp;
  int gridded = 0, broken = 0;
  if (pair < P) {
    const long long r1 = 2LL * pair * C;
    const long long r2 = r1 + C;
    const int n1 = n_cands[2 * pair];
    const int n2 = n_cands[2 * pair + 1];
    const bool multi = max(n1, n2) >= 2;
    const int lo = wsub(*min_insert, margin);
    const int hi = wadd(*max_insert, margin);

    // each mate's best score and its first column
    int b1 = INT_MIN, i1 = INT_MAX, b2 = INT_MIN, i2 = INT_MAX;
    for (int c = lane; c < C; c += 32) {
      const int s1 = sw[r1 + c];
      const int s2 = sw[r2 + c];
      if (before(s1, c, b1, i1)) { b1 = s1; i1 = c; }
      if (before(s2, c, b2, i2)) { b2 = s2; i2 = c; }
    }
    warp_first_max(b1, i1);
    warp_first_max(b2, i2);

    bool ok;
    int c1 = 0, c2 = 0;
    if (multi) {
      int best = INT_MIN, arg = INT_MAX;
      for (int k1 = 0; k1 < C; k1 += 32) {
        const int m1 = k1 + lane;
        // a score that cannot pass (no candidate, or <= 0) reads as 0
        int s1 = 0, p1 = 0, t1 = 0;
        if (m1 < C) {
          const int s = sw[r1 + m1];
          s1 = valid[r1 + m1] && s > 0 ? s : 0;
          p1 = wadd(corr[r1 + m1], slack);
          t1 = strand[r1 + m1];
        }
        for (int k2 = 0; k2 < C; k2 += 32) {
          const int m2 = k2 + lane;
          int s2own = 0, p2own = 0, t2own = 0;
          if (m2 < C) {
            const int s = sw[r2 + m2];
            s2own = valid[r2 + m2] && s > 0 ? s : 0;
            p2own = wadd(corr[r2 + m2], slack);
            t2own = strand[r2 + m2];
          }
          const int n = min(32, C - k2);
          for (int j = 0; j < n; ++j) {
            const int s2 = __shfl_sync(kFull, s2own, j);
            const int p2 = __shfl_sync(kFull, p2own, j);
            const int t2 = __shfl_sync(kFull, t2own, j);
            if (m1 < C) {
              const int v = s1 > 0 && s2 > 0 &&
                                    geometry(p1, t1, p2, t2, L, margin, lo,
                                             hi)
                                ? wadd(s1, s2)
                                : -1;
              const int flat = m1 * C + k2 + j;
              if (before(v, flat, best, arg)) {
                best = v;
                arg = flat;
              }
            }
          }
        }
      }
      warp_first_max(best, arg);
      c1 = arg / C;
      c2 = arg % C;
      const float want = __fmul_rn(*pair_cutoff,
                                   __int2float_rn(wadd(b1, b2)));
      ok = best > 0 && __int2float_rn(best) >= want;
      gridded = 1;
      broken = ok ? 0 : 1;
    } else {
      // a pair of singles: the geometry of (0, 0) alone
      ok = n1 >= 1 && n2 >= 1 && valid[r1] && valid[r2] &&
           geometry(wadd(corr[r1], slack), strand[r1],
                    wadd(corr[r2], slack), strand[r2], L, margin, lo, hi);
    }
    if (lane == 0) {
      a1[2 * pair] = ok ? c1 : i1;
      a1[2 * pair + 1] = ok ? c2 : i2;
      proper[2 * pair] = ok;
      proper[2 * pair + 1] = ok;
    }
  }
  if (counters == nullptr) return;      // the same for the whole launch
  if (lane == 0) {
    s_count[warp][0] = gridded;
    s_count[warp][1] = broken;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int g = 0, b = 0;
    for (int w = 0; w < kWarps; ++w) {
      g += s_count[w][0];
      b += s_count[w][1];
    }
    if (g > 0) atomicAdd(counters, static_cast<unsigned long long>(g));
    if (b > 0) atomicAdd(counters + 1, static_cast<unsigned long long>(b));
  }
}

}  // namespace

extern "C" int ngm_pair_select(const void* sw, const void* corr,
                               const void* strand, const void* valid,
                               const void* n_cands, const void* min_insert,
                               const void* max_insert,
                               const void* pair_cutoff, int P, int C, int L,
                               int slack, int margin, void* counters,
                               void* a1, void* proper, void* stream) {
  if (P > 0 && C > 0) {
    const unsigned blocks = static_cast<unsigned>((P + kWarps - 1) / kWarps);
    pair_select_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(sw), static_cast<const int32_t*>(corr),
        static_cast<const int32_t*>(strand),
        static_cast<const uint8_t*>(valid),
        static_cast<const int32_t*>(n_cands),
        static_cast<const int32_t*>(min_insert),
        static_cast<const int32_t*>(max_insert),
        static_cast<const float*>(pair_cutoff), P, C, L, slack, margin,
        static_cast<unsigned long long*>(counters),
        static_cast<int64_t*>(a1), static_cast<uint8_t*>(proper));
  }
  return static_cast<int>(cudaGetLastError());
}
