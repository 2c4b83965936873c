// K1: score-only local banded Smith-Waterman for Hopper (sm_90a).
//
// Replaces the TPU kernel nextgenmap_tpu/ops/sw_pallas.py::
// banded_sw_score_pallas (_kernel), and is bit-identical to its plain
// version nextgenmap_tpu_torch/ops/sw_ref.py::banded_sw_score in local mode:
// int32 DP in band coordinates (ref j = i + o), affine gaps with
// gopen >= gext, lazy F, best cell = first strict maximum over rows i < qlen
// (smallest i), and within a row the smallest o.  Returns (score, end_i,
// end_o); an alignment with no positive cell keeps (0, 0, 0).
//
// What bounds it on the card: integer ALU work and the latency of the row
// recurrence.  Each of the L rows of one alignment depends on the previous
// one, and a row is ~12 int ops per cell plus a handful of warp shuffles;
// there are no floating-point or memory-bandwidth limits to speak of
// (queries, corridors and matrices are a few hundred bytes per alignment).
//
// Design: one warp per alignment, band offsets spread over the lanes in
// contiguous chunks of NPL cells (lane l owns o = l*NPL .. l*NPL+NPL-1), so
// W may be any value from 1 to kMaxBand; the TPU's multiple-of-8 rule came
// from its sublanes and is gone.  Per row:
//   - E[o] needs H and E of the previous row at o+1: in-lane, or one
//     shuffle from the next lane; NEG past the band;
//   - F uses the sequential form F[o] = max_{t<o} Htmp[t] + t*gext
//     - gopen_r - (o-1)*gext: an inclusive max within the lane, then an
//     exclusive max-scan of the lane totals across the warp (5 shuffles);
//   - the row maximum is a 5-shuffle warp max; only when it beats the best
//     so far does a second reduction find its smallest o.
// Substitution scores come straight from the [M, 8, 8] matrices held in
// shared memory, S[msel][q][r]; that covers the simple and the general
// matrices alike, so the `simple` flag of the TPU kernel (an op-count
// trick) is not needed here.  The kernel stops at row qlen, since later
// rows cannot change the result.  An invalid slot arrives as an all-4
// corridor and scores 0.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 30);
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxMats = 8;
constexpr int kMaxBand = 256;
constexpr unsigned kFull = 0xffffffffu;

template <int NPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sw_score_kernel(const uint8_t* __restrict__ query,
                const int32_t* __restrict__ qlen,
                const uint8_t* __restrict__ corr,
                const int32_t* __restrict__ mats,
                const int32_t* __restrict__ msel,
                int S, int L, int W, int n_mats, int gq, int gr, int ge,
                int32_t* __restrict__ out_score,
                int32_t* __restrict__ out_i,
                int32_t* __restrict__ out_o) {
  __shared__ int32_t smat[kMaxMats * 64];
  for (int t = threadIdx.x; t < n_mats * 64; t += blockDim.x) {
    smat[t] = mats[t];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= S) return;  // the whole warp leaves together

  const int T = L + W;
  const uint8_t* q = query + static_cast<long long>(s) * L;
  const uint8_t* r = corr + static_cast<long long>(s) * T;
  int m = n_mats == 1 ? 0 : msel[s];
  m = m < 0 ? 0 : (m >= n_mats ? n_mats - 1 : m);
  const int32_t* sm = smat + m * 64;
  int rows = qlen[s];
  rows = rows < 0 ? 0 : (rows > L ? L : rows);
  const int o0 = lane * NPL;

  // cells past the band (o >= W) hold NEG, so they act as "outside"
  int h[NPL], e[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    h[k] = o0 + k < W ? 0 : NEG;
    e[k] = NEG;
  }
  int best = 0, bi = 0, bo = 0;

  for (int i = 0; i < rows; ++i) {
    const int qi = q[i];
    int h_next = __shfl_down_sync(kFull, h[0], 1);
    int e_next = __shfl_down_sync(kFull, e[0], 1);
    if (lane == 31) {
      h_next = NEG;
      e_next = NEG;
    }

    int ht[NPL], en[NPL], incl[NPL];
    int run = NEG;
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int o = o0 + k;
      const int hu = k + 1 < NPL ? h[k + 1] : h_next;
      const int eu = k + 1 < NPL ? e[k + 1] : e_next;
      if (o < W) {
        const int rc = r[i + o];
        const int sub = (qi < 5 && rc < 5) ? sm[qi * 8 + rc] : 0;
        const int hd = h[k] + sub;
        en[k] = max(hu - gq, eu - ge);
        ht[k] = max(max(hd, 0), en[k]);
        run = max(run, ht[k] + o * ge);
      } else {
        en[k] = NEG;
        ht[k] = NEG;
      }
      incl[k] = run;
    }

    // exclusive max-scan of the lane totals across the warp
    int v = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v = max(v, t);
    }
    int excl = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) excl = NEG;

    int lmax = NEG, larg = INT_MAX;
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int o = o0 + k;
      if (o < W) {
        const int cm = k == 0 ? excl : max(excl, incl[k - 1]);
        const int f = cm - gr - (o - 1) * ge;
        h[k] = max(ht[k], f);
        e[k] = en[k];
        if (h[k] > lmax) {
          lmax = h[k];
          larg = o;
        }
      }
    }

    int rowmax = lmax;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      rowmax = max(rowmax, __shfl_xor_sync(kFull, rowmax, d));
    }
    if (rowmax > best) {  // warp-uniform
      int arg = lmax == rowmax ? larg : INT_MAX;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        arg = min(arg, __shfl_xor_sync(kFull, arg, d));
      }
      best = rowmax;
      bi = i;
      bo = arg;
    }
  }

  if (lane == 0) {
    out_score[s] = best;
    out_i[s] = bi;
    out_o[s] = bo;
  }
}

template <int NPL>
void launch(const void* query, const void* qlen, const void* corr,
            const void* mats, const void* msel, int S, int L, int W,
            int n_mats, int gq, int gr, int ge, void* score, void* end_i,
            void* end_o, cudaStream_t stream) {
  const int blocks = (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sw_score_kernel<NPL><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const uint8_t*>(query), static_cast<const int32_t*>(qlen),
      static_cast<const uint8_t*>(corr), static_cast<const int32_t*>(mats),
      static_cast<const int32_t*>(msel), S, L, W, n_mats, gq, gr, ge,
      static_cast<int32_t*>(score), static_cast<int32_t*>(end_i),
      static_cast<int32_t*>(end_o));
}

}  // namespace

// query [S, L] uint8, qlen [S] int32, corr [S, L + W] uint8,
// mats [n_mats, 8, 8] int32, msel [S] int32 in [0, n_mats);
// outputs three [S] int32.  1 <= W <= 256, 1 <= n_mats <= 8.
extern "C" int ngm_sw_score(const void* query, const void* qlen,
                            const void* corr, const void* mats,
                            const void* msel, int S, int L, int W, int n_mats,
                            int gq, int gr, int ge, void* score, void* end_i,
                            void* end_o, void* stream) {
  if (W < 1 || W > kMaxBand || n_mats < 1 || n_mats > kMaxMats || L < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S > 0) {
    auto st = static_cast<cudaStream_t>(stream);
    if (W <= 32) {
      launch<1>(query, qlen, corr, mats, msel, S, L, W, n_mats, gq, gr, ge,
                score, end_i, end_o, st);
    } else if (W <= 64) {
      launch<2>(query, qlen, corr, mats, msel, S, L, W, n_mats, gq, gr, ge,
                score, end_i, end_o, st);
    } else if (W <= 128) {
      launch<4>(query, qlen, corr, mats, msel, S, L, W, n_mats, gq, gr, ge,
                score, end_i, end_o, st);
    } else {
      launch<8>(query, qlen, corr, mats, msel, S, L, W, n_mats, gq, gr, ge,
                score, end_i, end_o, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
