// K1: score-only banded Smith-Waterman for Hopper (sm_90a), local or glocal.
//
// Replaces the TPU kernel nextgenmap_tpu/ops/sw_pallas.py::
// banded_sw_score_pallas (_kernel), and is bit-identical to its plain
// version nextgenmap_tpu_torch/ops/sw_ref.py::banded_sw_score in both of its
// modes: int32 DP in band coordinates (ref j = i + o), affine gaps with
// gopen >= gext, lazy F.  Local mode (LOCAL = true): a 0 floor on every
// cell, best cell = first strict maximum over rows i < qlen (smallest i),
// and within a row the smallest o.  Glocal mode (--end-to-end, LOCAL =
// false): no floor, and only the read's last row i == qlen - 1 competes.
// Returns (score, end_i, end_o); an alignment with no positive cell, and a
// slot of length 0 (the mapper's invalid slots), keeps (0, 0, 0).
//
// What bounds it on the card: integer instructions, and in practice the
// latency of the row recurrence.  One cell of the recurrence needs at least
// OPS_PER_CELL = 6 32-bit integer instructions on sm_90 (a DPX instruction
// counts as one):
//   E  = max(H[o+1] - gq, E[o+1] - ge)                   2  IADD + VIADDMAX
//   Ht = max(H[o] + S[q_i, r_{i+o}], E, 0)               1  VIADDMAX.RELU
//        (glocal: max(H[o] + S, E))                         (VIADDMAX)
//   scan: run = max(run, Ht + o*ge) within the lane      1  VIADDMAX
//   F/H: H = max(max(excl, incl[o-1]) - c_o, Ht)         2  IMNMX + VIADDMAX
// (the substitution lookup is two shared-memory loads, and the argmax adds
// a compare and three selects per cell: both are left out of the bound,
// which is a floor).  Each
// of the L rows of one alignment depends on the row before, so a row's
// dependency chain (shuffles across lanes, the in-lane scan) sets the pace
// whenever the alignments in flight do not fill the card.
//
// Design, against the parent kernel (one warp per alignment):
//   - a group of LPA = 8, 16 or 32 lanes owns one alignment, NPL cells per
//     lane (lane l owns o = l*NPL .. l*NPL+NPL-1); a template on (LPA, NPL)
//     is picked from W, so a short band (W = 48: 16 lanes x 3 cells) puts 2
//     alignments in one warp and needs 4+1 shuffles for the F scan and 1 for
//     the E neighbour, where the parent needed 5+1 and 2 (and 5-10 more
//     for the row maximum).  Segmented shuffles (the `width` argument) keep
//     the groups of a warp apart;
//   - each group stages its query and corridor in shared memory before the
//     row loop (aligned 4-byte loads, codes clamped to 5 on the way: code 5
//     scores 0 against anything, as codes >= 5 do in the plain version), and
//     the substitution scores of row i+1 are loaded while row i computes, so
//     no global load and no dependent shared load sits in the row chain;
//   - the argmax is deferred: each lane keeps its own first maximum in
//     (i, o) order (value, i, o), updated with a strict > as the rows and,
//     within a row, its cells go up, and one lexicographic reduction after
//     the last row takes the largest value, then the smallest i, then the
//     smallest o: the global first maximum the plain version defines.  (A
//     key packing h and o into one int took 4-7% longer at W = 48 and 56
//     and 4% less at W = 184 on an H100, tools/kernel_ab.py; the plain
//     compare stays);
//   - Hopper's DPX instructions do the max-plus steps (__viaddmax_s32,
//     __viaddmax_s32_relu);
//   - cells past W (the template rounds W up to LPA*NPL) are inert: their
//     gap-open constant is 2^29, so the E they hand down to cell W-1 stays
//     ~-2^29 (the plain version's NEG plays that role), and the argmax
//     skips them; exact while |H| < 2^27, far beyond any read;
//   - a group stops updating its best past its own qlen; a warp whose groups
//     all have length 0 exits at once.
//   - bands past 256 (--corridor 225 and more, reads of ~1500 bp and more):
//     32 lanes x 12 or 16 cells up to W = 512, then a block of
//     32 * ceil(W / 256) threads per alignment, 8 cells each (see
//     sw_score_block_kernel), up to kMaxBand.
// Exact int32 arithmetic throughout; no narrower type.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// one warp per block: a short batch spreads over as many SMs as it has
// warps, and a block needs no barrier after its matrices are loaded
constexpr int kWarpsPerBlock = 1;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxMats = 8;
// 1024 threads x kBlockNPL cells.  The band could go further, but past it
// the traceback's (K4, csrc/sw_align.cu) [L, B, W] bytes exhaust the card
constexpr int kBlockNPL = 8;
constexpr int kMaxBlockThreads = 1024;
constexpr int kMaxBand = kMaxBlockThreads * kBlockNPL;
constexpr int kMaxWarpBand = 512;      // one warp per alignment up to here
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPadCode = 5;            // staged N/pad: scores 0 against all
constexpr int kNeg = -(1 << 29);       // E and F from outside the band
constexpr int kInert = 1 << 29;        // gap open of the cells past W
constexpr int kFar = 1 << 30;          // F offset and argmax mask past W
constexpr int kMaxDynSmem = 200 * 1024;

// dst[t] = min(src[t], 5) for t < n, kPadCode for n <= t < n_pad, by the
// `lpa` lanes of one group (sub-lane sl).  src is read as aligned 32-bit
// words: a word may reach up to 3 bytes before or after the row, never
// outside the 512-byte-aligned allocation that holds it.
__device__ __forceinline__ void stage_codes(const uint8_t* src, int n,
                                            uint8_t* dst, int n_pad, int sl,
                                            int lpa) {
  if (n > 0) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    const int lead = static_cast<int>(a & 3);
    const int nw = (lead + n + 3) >> 2;
#pragma unroll 4
    for (int j = sl; j < nw; j += lpa) {
      const uint32_t v = __ldg(w + j);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int t = 4 * j + b - lead;
        if (t >= 0 && t < n) {
          dst[t] = static_cast<uint8_t>(
              min((v >> (8 * b)) & 0xffu, static_cast<uint32_t>(kPadCode)));
        }
      }
    }
  }
  for (int t = (n > 0 ? n : 0) + sl; t < n_pad; t += lpa) dst[t] = kPadCode;
}

template <int NPL>
__device__ __forceinline__ void load_subs(const int32_t* sm, const uint8_t* qs,
                                          const uint8_t* rs, int i, int o0,
                                          int (&out)[NPL]) {
  const int32_t* row = sm + 8 * qs[i];
  const uint8_t* rr = rs + i + o0;
#pragma unroll
  for (int k = 0; k < NPL; ++k) out[k] = row[rr[k]];
}

template <int LPA, int NPL, bool LOCAL>
__global__ void __launch_bounds__(kThreads)
sw_score_kernel(const uint8_t* __restrict__ query,
                const int32_t* __restrict__ qlen,
                const uint8_t* __restrict__ corr,
                const int32_t* __restrict__ mats,
                const int32_t* __restrict__ msel,
                int S, int L, int W, int n_mats, int gq, int gr, int ge,
                int stage_q, int stage_bytes,
                int32_t* __restrict__ out_score,
                int32_t* __restrict__ out_i,
                int32_t* __restrict__ out_o) {
  constexpr int APW = 32 / LPA;   // alignments per warp
  constexpr int WP = LPA * NPL;   // cells per alignment, >= W
  __shared__ int32_t smat[kMaxMats * 64];
  extern __shared__ __align__(16) uint8_t stage[];

  // matrices with every entry of a code >= 5 zeroed (codes are staged
  // clamped to 5)
  for (int t = threadIdx.x; t < n_mats * 64; t += kThreads) {
    const bool in = ((t >> 3) & 7) < kPadCode && (t & 7) < kPadCode;
    smat[t] = in ? mats[t] : 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / LPA;
  const int sl = lane % LPA;
  const int slot = (blockIdx.x * kWarpsPerBlock + warp) * APW + g;
  const bool real = slot < S;
  const int len = real ? qlen[slot] : 0;
  const int last = len - 1;   // glocal: the one row that competes
  const int rows = len < 0 ? 0 : (len > L ? L : len);
  int warp_rows = rows;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    warp_rows = max(warp_rows, __shfl_xor_sync(kFull, warp_rows, d));
  }
  if (warp_rows == 0) {   // warp-uniform: nothing to score
    if (real && sl == 0) {
      out_score[slot] = 0;
      out_i[slot] = 0;
      out_o[slot] = 0;
    }
    return;
  }

  // stage the rows and corridor bytes this warp's loop reads
  uint8_t* qs = stage + (warp * APW + g) * stage_bytes;
  uint8_t* rs = qs + stage_q;
  const int nr = warp_rows + WP - 1;
  if (rows > 0) {
    stage_codes(query + static_cast<long long>(slot) * L, warp_rows, qs,
                warp_rows, sl, LPA);
    stage_codes(corr + static_cast<long long>(slot) * (L + W),
                min(nr, L + W), rs, nr, sl, LPA);
  } else {
    stage_codes(query, 0, qs, warp_rows, sl, LPA);
    stage_codes(corr, 0, rs, nr, sl, LPA);
  }
  __syncwarp();

  int m = (n_mats == 1 || !real) ? 0 : msel[slot];
  m = m < 0 ? 0 : (m >= n_mats ? n_mats - 1 : m);
  const int32_t* sm = smat + m * 64;

  const int o0 = sl * NPL;
  int h[NPL], e[NPL], ngq[NPL], nck[NPL], oge[NPL], kk[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int o = o0 + k;
    const bool valid = o < W;
    h[k] = 0;
    e[k] = kNeg;
    ngq[k] = valid ? -gq : -kInert;
    nck[k] = valid ? -(gr + (o - 1) * ge) : -kFar;
    oge[k] = o * ge;
    // >= 0 exactly for the valid cells, whatever W; an int per cell tested
    // in the loop timed ~8% faster on an H100 than testing o < W there
    kk[k] = valid ? W - 1 - o : -kFar;
  }
  // the lane's first maximum (value, row, o); none while the value is 0
  int lb = 0, li = 0, lo = 0;

  int sub[NPL];
  load_subs<NPL>(sm, qs, rs, 0, o0, sub);
  // two rows per trip: the compiler overlaps one row's argmax and loads
  // with the next row's chain (timed faster at W = 48 and W = 184)
#pragma unroll 2
  for (int i = 0; i < warp_rows; ++i) {
    int nsub[NPL];
    load_subs<NPL>(sm, qs, rs, min(i + 1, warp_rows - 1), o0, nsub);

    // E that each cell hands down to the cell below it (o - 1)
    int eo[NPL];
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      eo[k] = __viaddmax_s32(h[k], ngq[k], e[k] - ge);
    }
    int feed = __shfl_down_sync(kFull, eo[0], 1, LPA);
    if (sl == LPA - 1) feed = kNeg;

    int ht[NPL], incl[NPL];
    int run = kNeg;
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int en = k + 1 < NPL ? eo[k + 1] : feed;
      ht[k] = LOCAL ? __viaddmax_s32_relu(h[k], sub[k], en)
                    : __viaddmax_s32(h[k], sub[k], en);
      run = __viaddmax_s32(ht[k], oge[k], run);
      incl[k] = run;
      e[k] = en;
    }
    // exclusive max-scan of the lane totals across the group
    int v = run;
#pragma unroll
    for (int d = 1; d < LPA; d <<= 1) {
      const int t = __shfl_up_sync(kFull, v, d, LPA);
      if (sl >= d) v = max(v, t);
    }
    int excl = __shfl_up_sync(kFull, v, 1, LPA);
    if (sl == 0) excl = kNeg;
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int cm = k == 0 ? excl : max(excl, incl[k - 1]);
      h[k] = __viaddmax_s32(cm, nck[k], ht[k]);
    }

    if (LOCAL ? i < rows : i == last) {
#pragma unroll
      for (int k = 0; k < NPL; ++k) {   // strict >: ties keep the earlier
        if (kk[k] >= 0 && h[k] > lb) {
          lb = h[k];
          lo = o0 + k;
          li = i;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NPL; ++k) sub[k] = nsub[k];
  }

  // lexicographic reduction over the group: largest value, then smallest
  // i, then smallest o
  int bv = lb, bi = li, bo = lo;
#pragma unroll
  for (int d = LPA / 2; d > 0; d >>= 1) {
    const int ov = __shfl_xor_sync(kFull, bv, d, LPA);
    const int oi = __shfl_xor_sync(kFull, bi, d, LPA);
    const int oo = __shfl_xor_sync(kFull, bo, d, LPA);
    if (ov > bv || (ov == bv && (oi < bi || (oi == bi && oo < bo)))) {
      bv = ov;
      bi = oi;
      bo = oo;
    }
  }
  if (real && sl == 0) {
    out_score[slot] = bv;
    out_i[slot] = bi;
    out_o[slot] = bo;
  }
}

// One alignment per block, for W > kMaxWarpBand: blockDim.x = 32 * nw
// threads, thread t owning cells o = 8t .. 8t+7; the cells past W are inert
// as above.  A row crosses warps at two places, both through shared memory
// behind ONE barrier per row (double-buffered, so a row's writes never race
// the previous row's reads):
//   - E: the last lane of warp w takes the E that lane 0 of warp w+1 hands
//     down.  It scores its last cell without it first, and adds it after
//     the barrier: max(a, b, E) = max(max(a, b), E), in both modes;
//   - the exclusive F max-scan: each warp scans its lane totals with
//     shuffles (the last lane's total still without that E) and publishes
//     the warp total; after the barrier, warp w takes the max of the totals
//     of warps < w, each raised by its last cell's missing term E + o*ge.
// Per thread two [8] int arrays stay live (H, E), so that 1024 threads fit
// the 64 registers a thread has at that size; the per-cell constants are
// computed where used.  The argmax is the warp kernel's: each thread keeps
// its first maximum, then a lexicographic reduction within each warp and
// across the warps (largest value, smallest i, smallest o).
template <bool LOCAL>
__global__ void __launch_bounds__(kMaxBlockThreads)
sw_score_block_kernel(const uint8_t* __restrict__ query,
                      const int32_t* __restrict__ qlen,
                      const uint8_t* __restrict__ corr,
                      const int32_t* __restrict__ mats,
                      const int32_t* __restrict__ msel,
                      int L, int W, int n_mats, int gq, int gr, int ge,
                      int stage_q, int32_t* __restrict__ out_score,
                      int32_t* __restrict__ out_i,
                      int32_t* __restrict__ out_o) {
  constexpr int NPL = kBlockNPL;
  __shared__ int32_t smat[kMaxMats * 64];
  __shared__ int32_t wtot[2][32];     // warp totals of the F scan
  __shared__ int32_t efirst[2][32];   // E handed down by each warp's lane 0
  __shared__ int32_t red[3][32];      // the argmax across warps
  extern __shared__ __align__(16) uint8_t stage[];

  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const int slot = blockIdx.x;
  const int len = qlen[slot];
  const int rows = len < 0 ? 0 : (len > L ? L : len);
  if (rows == 0) {   // block-uniform, before any barrier
    if (tid == 0) {
      out_score[slot] = 0;
      out_i[slot] = 0;
      out_o[slot] = 0;
    }
    return;
  }
  for (int t = tid; t < n_mats * 64; t += nt) {
    const bool in = ((t >> 3) & 7) < kPadCode && (t & 7) < kPadCode;
    smat[t] = in ? mats[t] : 0;
  }
  uint8_t* qs = stage;
  uint8_t* rs = stage + stage_q;
  const int nr = rows + nt * NPL - 1;
  stage_codes(query + static_cast<long long>(slot) * L, rows, qs, rows, tid,
              nt);
  stage_codes(corr + static_cast<long long>(slot) * (L + W), min(nr, L + W),
              rs, nr, tid, nt);
  __syncthreads();

  int m = n_mats == 1 ? 0 : msel[slot];
  m = m < 0 ? 0 : (m >= n_mats ? n_mats - 1 : m);
  const int32_t* sm = smat + m * 64;
  const int o0 = tid * NPL;
  const int last = len - 1;   // glocal: the one row that competes
  int h[NPL], e[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    h[k] = 0;
    e[k] = kNeg;
  }
  int lb = 0, li = 0, lo = 0;

  for (int i = 0; i < rows; ++i) {
    const int buf = i & 1;
    const int32_t* srow = sm + 8 * qs[i];
    const uint8_t* rr = rs + i + o0;
    const int eo0 = __viaddmax_s32(h[0], o0 < W ? -gq : -kInert, e[0] - ge);
    if (lane == 0) efirst[buf][warp] = eo0;
    int feed = __shfl_down_sync(kFull, eo0, 1);
    if (lane == 31) feed = kNeg;   // from the next warp, after the barrier
    int run = kNeg;
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int o = o0 + k;
      const int en = k + 1 < NPL
          ? __viaddmax_s32(h[k + 1], o + 1 < W ? -gq : -kInert, e[k + 1] - ge)
          : feed;
      const int s = srow[rr[k]];
      const int ht = LOCAL ? __viaddmax_s32_relu(h[k], s, en)
                           : __viaddmax_s32(h[k], s, en);
      run = __viaddmax_s32(ht, o * ge, run);
      h[k] = ht;   // H before F, until the scan below
      e[k] = en;
    }
    int v = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v = max(v, t);
    }
    int excl = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) excl = kNeg;
    if (lane == 31) wtot[buf][warp] = v;
    __syncthreads();

    if (lane == 31) {
      const int f = warp + 1 < nw ? efirst[buf][warp + 1] : kNeg;
      h[NPL - 1] = max(h[NPL - 1], f);
      e[NPL - 1] = f;
    }
    // the max over the totals of warps < this one
    int c = kNeg;
    if (lane < nw) {
      const int f = lane + 1 < nw ? efirst[buf][lane + 1] : kNeg;
      c = max(wtot[buf][lane], f + ((lane + 1) * 32 * NPL - 1) * ge);
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, c, d);
      if (lane >= d) c = max(c, t);
    }
    const int carry = __shfl_sync(kFull, c, (warp + 31) & 31);
    if (warp > 0) excl = max(excl, carry);

    int cm = excl;
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      const int o = o0 + k;
      const int ht = h[k];
      h[k] = __viaddmax_s32(cm, o < W ? -(gr + (o - 1) * ge) : -kFar, ht);
      cm = __viaddmax_s32(ht, o * ge, cm);
    }
    if (LOCAL || i == last) {
#pragma unroll
      for (int k = 0; k < NPL; ++k) {   // strict >: ties keep the earlier
        if (o0 + k < W && h[k] > lb) {
          lb = h[k];
          lo = o0 + k;
          li = i;
        }
      }
    }
  }

  int bv = lb, bi = li, bo = lo;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int ov = __shfl_xor_sync(kFull, bv, d);
    const int oi = __shfl_xor_sync(kFull, bi, d);
    const int oo = __shfl_xor_sync(kFull, bo, d);
    if (ov > bv || (ov == bv && (oi < bi || (oi == bi && oo < bo)))) {
      bv = ov;
      bi = oi;
      bo = oo;
    }
  }
  if (lane == 0) {
    red[0][warp] = bv;
    red[1][warp] = bi;
    red[2][warp] = bo;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < nw ? red[0][lane] : 0;
    bi = lane < nw ? red[1][lane] : 0;
    bo = lane < nw ? red[2][lane] : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const int ov = __shfl_xor_sync(kFull, bv, d);
      const int oi = __shfl_xor_sync(kFull, bi, d);
      const int oo = __shfl_xor_sync(kFull, bo, d);
      if (ov > bv || (ov == bv && (oi < bi || (oi == bi && oo < bo)))) {
        bv = ov;
        bi = oi;
        bo = oo;
      }
    }
    if (lane == 0) {
      out_score[slot] = bv;
      out_i[slot] = bi;
      out_o[slot] = bo;
    }
  }
}

template <bool LOCAL>
cudaError_t launch_block(const void* query, const void* qlen, const void* corr,
                         const void* mats, const void* msel, int S, int L,
                         int W, int n_mats, int gq, int gr, int ge,
                         void* score, void* end_i, void* end_o,
                         cudaStream_t stream) {
  const int threads = 32 * ((W + 32 * kBlockNPL - 1) / (32 * kBlockNPL));
  const int stage_q = (L + 3) & ~3;
  const long long smem =
      stage_q + ((static_cast<long long>(L) + threads * kBlockNPL + 3) & ~3);
  if (smem > kMaxDynSmem) return cudaErrorInvalidValue;
  auto kern = sw_score_block_kernel<LOCAL>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<S, threads, static_cast<size_t>(smem), stream>>>(
      static_cast<const uint8_t*>(query), static_cast<const int32_t*>(qlen),
      static_cast<const uint8_t*>(corr), static_cast<const int32_t*>(mats),
      static_cast<const int32_t*>(msel), L, W, n_mats, gq, gr, ge, stage_q,
      static_cast<int32_t*>(score), static_cast<int32_t*>(end_i),
      static_cast<int32_t*>(end_o));
  return cudaGetLastError();
}

template <int LPA, int NPL, bool LOCAL>
cudaError_t launch(const void* query, const void* qlen, const void* corr,
                   const void* mats, const void* msel, int S, int L, int W,
                   int n_mats, int gq, int gr, int ge, void* score,
                   void* end_i, void* end_o, cudaStream_t stream) {
  constexpr int APB = kThreads / LPA;   // alignments per block
  const int stage_q = (L + 3) & ~3;
  const int stage_bytes = stage_q + ((L + LPA * NPL + 3) & ~3);
  const long long smem = static_cast<long long>(APB) * stage_bytes;
  if (smem > kMaxDynSmem) return cudaErrorInvalidValue;
  auto kern = sw_score_kernel<LPA, NPL, LOCAL>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (S + APB - 1) / APB;
  kern<<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const uint8_t*>(query), static_cast<const int32_t*>(qlen),
      static_cast<const uint8_t*>(corr), static_cast<const int32_t*>(mats),
      static_cast<const int32_t*>(msel), S, L, W, n_mats, gq, gr, ge,
      stage_q, stage_bytes, static_cast<int32_t*>(score),
      static_cast<int32_t*>(end_i), static_cast<int32_t*>(end_o));
  return cudaGetLastError();
}

template <bool LOCAL>
cudaError_t launch_band(const void* query, const void* qlen, const void* corr,
                        const void* mats, const void* msel, int S, int L,
                        int W, int n_mats, int gq, int gr, int ge, void* score,
                        void* end_i, void* end_o, cudaStream_t st) {
#define NGM_SW_LAUNCH(LPA, NPL)                                             \
  return launch<LPA, NPL, LOCAL>(query, qlen, corr, mats, msel, S, L, W,    \
                                 n_mats, gq, gr, ge, score, end_i, end_o, st)
  // (lanes per alignment, cells per lane): at W = 48, 16 lanes x 3 cells
  // timed faster than 8 x 6, and 4 x 12 slower, in a side-by-side build on
  // the card (a shorter in-lane chain against one shuffle more); a warp per
  // alignment from W = 129 to 512, a block of warps past it
  if (W <= 16) NGM_SW_LAUNCH(8, 2);
  if (W <= 32) NGM_SW_LAUNCH(8, 4);
  if (W <= 48) NGM_SW_LAUNCH(16, 3);
  if (W <= 64) NGM_SW_LAUNCH(16, 4);
  if (W <= 96) NGM_SW_LAUNCH(16, 6);
  if (W <= 128) NGM_SW_LAUNCH(16, 8);
  if (W <= 192) NGM_SW_LAUNCH(32, 6);
  if (W <= 256) NGM_SW_LAUNCH(32, 8);
  if (W <= 384) NGM_SW_LAUNCH(32, 12);
  if (W <= kMaxWarpBand) NGM_SW_LAUNCH(32, 16);
#undef NGM_SW_LAUNCH
  return launch_block<LOCAL>(query, qlen, corr, mats, msel, S, L, W, n_mats,
                             gq, gr, ge, score, end_i, end_o, st);
}

}  // namespace

// query [S, L] uint8, qlen [S] int32, corr [S, L + W] uint8,
// mats [n_mats, 8, 8] int32, msel [S] int32 (clamped to [0, n_mats)); local
// != 0 for local mode, 0 for glocal; outputs three [S] int32.
// 1 <= W <= kMaxBand (8192), 1 <= n_mats <= 8.
extern "C" int ngm_sw_score(const void* query, const void* qlen,
                            const void* corr, const void* mats,
                            const void* msel, int S, int L, int W, int n_mats,
                            int gq, int gr, int ge, int local, void* score,
                            void* end_i, void* end_o, void* stream) {
  if (W < 1 || W > kMaxBand || n_mats < 1 || n_mats > kMaxMats || L < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      local != 0
          ? launch_band<true>(query, qlen, corr, mats, msel, S, L, W, n_mats,
                              gq, gr, ge, score, end_i, end_o, st)
          : launch_band<false>(query, qlen, corr, mats, msel, S, L, W, n_mats,
                               gq, gr, ge, score, end_i, end_o, st);
  return static_cast<int>(err);
}
