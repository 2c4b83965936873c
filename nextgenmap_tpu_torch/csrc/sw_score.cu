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
#include <type_traits>

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

// The row loop of one group's alignment and its argmax, run by K1 and by
// the fused score pass alike: qs and rs the group's staged query and
// corridor, sm its matrix, `rows` its own rows (its length clamped to L),
// `last` the row that competes in glocal mode, `warp_rows` the most rows of
// any group of the warp (every lane runs them: the shuffles span the warp).
// Leaves the group's first maximum (value, i, o) on every lane of it.
template <int LPA, int NPL, bool LOCAL>
__device__ __forceinline__ void band_rows(const int32_t* sm, const uint8_t* qs,
                                          const uint8_t* rs, int sl, int rows,
                                          int last, int warp_rows, int W,
                                          int gq, int gr, int ge, int& bv,
                                          int& bi, int& bo) {
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
  bv = lb;
  bi = li;
  bo = lo;
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

  int bv, bi, bo;
  band_rows<LPA, NPL, LOCAL>(sm, qs, rs, sl, rows, last, warp_rows, W, gq, gr,
                             ge, bv, bi, bo);
  if (real && sl == 0) {
    out_score[slot] = bv;
    out_i[slot] = bi;
    out_o[slot] = bo;
  }
}


// The row loop of one alignment by a whole block (blockDim.x = 32 * nw
// threads; see sw_score_block_kernel) and its argmax, run by K1 and by the
// fused score pass alike.  wtot, efirst and red are the block's shared
// arrays.  Leaves the first maximum (value, i, o) on thread 0.
template <bool LOCAL>
__device__ __forceinline__ void block_rows(const int32_t* sm, const uint8_t* qs,
                                           const uint8_t* rs, int rows,
                                           int last, int W, int gq, int gr,
                                           int ge, int32_t (*wtot)[32],
                                           int32_t (*efirst)[32],
                                           int32_t (*red)[32], int& bv,
                                           int& bi, int& bo) {
  constexpr int NPL = kBlockNPL;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const int o0 = tid * NPL;
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

  bv = lb;
  bi = li;
  bo = lo;
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
  int bv, bi, bo;
  block_rows<LOCAL>(sm, qs, rs, rows, len - 1, W, gq, gr, ge, wtot, efirst,
                    red, bv, bi, bo);
  if (tid == 0) {
    out_score[slot] = bv;
    out_i[slot] = bi;
    out_o[slot] = bo;
  }
}

// Allow `smem` bytes of dynamic shared memory to `kern`.
template <class K>
cudaError_t allow_smem(K kern, long long smem) {
  if (smem > kMaxDynSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
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
  auto kern = sw_score_block_kernel<LOCAL>;
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
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
  auto kern = sw_score_kernel<LPA, NPL, LOCAL>;
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (S + APB - 1) / APB;
  kern<<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const uint8_t*>(query), static_cast<const int32_t*>(qlen),
      static_cast<const uint8_t*>(corr), static_cast<const int32_t*>(mats),
      static_cast<const int32_t*>(msel), S, L, W, n_mats, gq, gr, ge,
      stage_q, stage_bytes, static_cast<int32_t*>(score),
      static_cast<int32_t*>(end_i), static_cast<int32_t*>(end_o));
  return cudaGetLastError();
}

// The (lanes per alignment, cells per lane) template for a band W, which K1
// and the fused score pass share: f(LPA, NPL) as integral constants, (0, 0)
// for the block form.  At W = 48, 16 lanes x 3 cells timed faster than
// 8 x 6, and 4 x 12 slower, in a side-by-side build on the card (a shorter
// in-lane chain against one shuffle more); a warp per alignment from W = 129
// to 512, a block of warps past it
template <class F>
cudaError_t by_band(int W, F f) {
  using std::integral_constant;
#define NGM_BAND(LPA, NPL) \
  return f(integral_constant<int, LPA>(), integral_constant<int, NPL>())
  if (W <= 16) NGM_BAND(8, 2);
  if (W <= 32) NGM_BAND(8, 4);
  if (W <= 48) NGM_BAND(16, 3);
  if (W <= 64) NGM_BAND(16, 4);
  if (W <= 96) NGM_BAND(16, 6);
  if (W <= 128) NGM_BAND(16, 8);
  if (W <= 192) NGM_BAND(32, 6);
  if (W <= 256) NGM_BAND(32, 8);
  if (W <= 384) NGM_BAND(32, 12);
  if (W <= kMaxWarpBand) NGM_BAND(32, 16);
  NGM_BAND(0, 0);
#undef NGM_BAND
}

template <bool LOCAL>
cudaError_t launch_band(const void* query, const void* qlen, const void* corr,
                        const void* mats, const void* msel, int S, int L,
                        int W, int n_mats, int gq, int gr, int ge, void* score,
                        void* end_i, void* end_o, cudaStream_t st) {
  return by_band(W, [&](auto lpa, auto npl) {
    constexpr int A = decltype(lpa)::value;
    constexpr int N = decltype(npl)::value;
    if constexpr (A == 0) {
      return launch_block<LOCAL>(query, qlen, corr, mats, msel, S, L, W,
                                 n_mats, gq, gr, ge, score, end_i, end_o, st);
    } else {
      return launch<A, N, LOCAL>(query, qlen, corr, mats, msel, S, L, W,
                                 n_mats, gq, gr, ge, score, end_i, end_o, st);
    }
  });
}

// ---------------------------------------------------------------------------
// The score pass of the mapping steps, fused: score_plan_kernel, then
// score_pass_kernel (score_pass_block_kernel past W = 512), two launches.
//
// Replaces, on a card, the body of the port's models/mapper.py::
// _score_candidates, about 30 torch nodes (the mask and its row sums, a
// cumsum, a searchsorted over the slots, index and where passes, the
// [S, L] query gather, K2 (csrc/gather_windows.cu) into an [S, L + W] window
// buffer, K1, a zero fill, an index_put and a final where), itself the port
// of the reference's XLA-fused nextgenmap_tpu/models/mapper.py:214
// _score_candidates; K2 no longer runs on this path.  Bit-identical to its
// plain version, ops/score_pass_kernel.py::score_pass_plain: the masked
// (read, candidate) pairs are compacted batch-wide into S slots in read
// order, slot s belonging to the last read b with base[b] <= s and scoring
// its candidate j = s - base[b]; the score lands in the dense [B, C] grid
// where that candidate is valid, 0 elsewhere, so a read that straddles the
// cap keeps its first S - base[b] candidates scored and the rest 0.
//
// What bounds it: K1's row chain (the L dependent rows of one alignment, see
// the note at the top), plus (L + T) bytes a slot read from the reads and
// the genome, T = L + W; the plan reads B x C mask bytes and writes B x C x 4
// bytes of zeros (6.8 us at 4096 x 32 on an H100, its single block's scan).
//
// Design:
//   - nothing is materialised: a group stages its query straight from the
//     read or its reverse complement (by the candidate's strand) and its
//     corridor straight from the genome at the clamped corridor start, any
//     byte offset, 64-bit genome offsets, 4 (the pad code) past the
//     genome's end, as K2 gives them; no [S, L] or [S, T] buffer exists;
//   - one plan: one block scans the B reads (the slots each asks for, n_sc,
//     and their exclusive sum, base, both kept for utils/trace.py's
//     counters), writes the slot map and the total; the plan's other blocks
//     zero the dense grid meanwhile;
//   - a strided grid: at most the blocks the card holds resident at once,
//     each reading the total once and striding over the real slots, so a
//     pass with no real slot is one launch whose blocks exit at once, and a
//     full pass launches as many groups as K1 did.
// The row loops are K1's own (band_rows, block_rows), picked from W by the
// same table (by_band).

constexpr int kPlanThreads = 1024;         // also the reads a plan round
constexpr int kFill = kPlanThreads * 16;   // int32 a zeroing block clears

// Everything the fused kernels read and write; see ngm_score_pass.
struct Pass {
  const uint8_t* reads;        // [B, L]
  const uint8_t* rc;           // [B, L]
  const int32_t* lengths;      // [B]
  const uint8_t* genome;       // [G]
  long long G;
  const int32_t* corr_start;   // [B, C]
  const int32_t* strand;       // [B, C]
  const uint8_t* cand_valid;   // [B, C] bool
  const int32_t* slot_flat;    // [S] b * C + j of each real slot
  const int32_t* meta;         // [2] total, slot_overflow
  const int32_t* mats;         // [n_mats, 8, 8]
  int n_mats, gq, gr, ge;
  int S, L, W, C;
  int32_t* sw;                 // [B, C]
};

// dst[t] = min(genome[s + t], 5) while s + t < G and 4 past the genome's
// end for t < n, kPadCode for n <= t < n_pad; s in [0, G].
__device__ __forceinline__ void stage_window(const uint8_t* genome,
                                             long long G, long long s, int n,
                                             uint8_t* dst, int n_pad, int sl,
                                             int lpa) {
  const int in = static_cast<int>(min(static_cast<long long>(n), G - s));
  stage_codes(genome + s, in, dst, in, sl, lpa);
  for (int t = in + sl; t < n_pad; t += lpa) dst[t] = t < n ? 4 : kPadCode;
}

// The valid (nonzero) bytes of one row of C candidate flags; vec: 16 or 4
// when the row may be read in 16- or 4-byte words, else 1.
__device__ __forceinline__ int valid_in_row(const uint8_t* row, int C,
                                            int vec) {
  int c = 0;
  if (vec == 16) {
    const uint4* w = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
    for (int k = 0; k < (C >> 4); ++k) {
      const uint4 v = __ldg(w + k);
      c += __popc(__vcmpne4(v.x, 0u)) + __popc(__vcmpne4(v.y, 0u)) +
           __popc(__vcmpne4(v.z, 0u)) + __popc(__vcmpne4(v.w, 0u));
    }
    return c >> 3;
  }
  if (vec == 4) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
#pragma unroll 8
    for (int k = 0; k < (C >> 2); ++k) c += __popc(__vcmpne4(__ldg(w + k), 0u));
    return c >> 3;
  }
  for (int j = 0; j < C; ++j) c += row[j] != 0;
  return c;
}

// Block 0: n_sc[b] = the valid candidates of read b if
// score_mask[b >> mask_shift], else 0 (mask_shift 1: a pair's two rows
// share one entry); base = their exclusive sum; meta = (total, total > S);
// slot_flat[s] = b * C + (s - base[b]) for s < min(total, S).  In rounds of
// kPlanThreads reads, read r0 + t to thread t, then one block-wide scan.
// (Four consecutive reads a thread, their rows 128 bytes apart across a
// warp, took 10.2 us at 4096 x 32 on an H100, this 7.5 us; counting the
// rows by coalesced words into shared memory first took 12.5 us.)  Blocks
// 1..: zero sw meanwhile.
__global__ void __launch_bounds__(kPlanThreads)
score_plan_kernel(const uint8_t* __restrict__ cand_valid,
                  const uint8_t* __restrict__ score_mask, int mask_shift,
                  int B, int C, int S,
                  int32_t* __restrict__ n_sc, int32_t* __restrict__ base,
                  int32_t* __restrict__ meta, int32_t* __restrict__ slot_flat,
                  int32_t* __restrict__ sw, long long n_sw) {
  if (blockIdx.x > 0) {   // sw is 16-byte aligned, and so is each share
    const long long begin = static_cast<long long>(blockIdx.x - 1) * kFill;
    const long long end = min(begin + kFill, n_sw);
    int4* q = reinterpret_cast<int4*>(sw + begin);
    const int nq = static_cast<int>((end - begin) >> 2);
    for (int t = threadIdx.x; t < nq; t += kPlanThreads) {
      q[t] = make_int4(0, 0, 0, 0);
    }
    for (long long t = begin + 4LL * nq + threadIdx.x; t < end;
         t += kPlanThreads) {
      sw[t] = 0;
    }
    return;
  }
  __shared__ int32_t wsum[kPlanThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(cand_valid);
  const int vec = (C & 15) == 0 && (addr & 15) == 0 ? 16
                  : (C & 3) == 0 && (addr & 3) == 0 ? 4 : 1;
  int carry = 0;   // the slots of the rounds before
  for (int r0 = 0; r0 < B; r0 += kPlanThreads) {
    const int b = r0 + tid;
    int c = 0;
    if (b < B) {
      const bool on = score_mask[b >> mask_shift];
      c = valid_in_row(cand_valid + static_cast<long long>(b) * C, C, vec);
      c = on ? c : 0;
    }
    // exclusive scan across the block
    int v = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += t;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      constexpr int kWarps = kPlanThreads / 32;
      int w = lane < kWarps ? wsum[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w += t;
      }
      if (lane < kWarps) wsum[lane] = w;
    }
    __syncthreads();
    const int run = carry + v - c + (warp > 0 ? wsum[warp - 1] : 0);
    if (b < B) {
      n_sc[b] = c;
      base[b] = run;
      for (int r = 0; r < c && run + r < S; ++r) slot_flat[run + r] = b * C + r;
    }
    carry += wsum[kPlanThreads / 32 - 1];
    __syncthreads();   // wsum is read above before the next round writes it
  }
  if (tid == 0) {
    meta[0] = carry;
    meta[1] = carry > S ? 1 : 0;
  }
}

// The fused pass, warp form: K1's groups of LPA lanes, one slot each,
// kWarpsPerBlock warps a block, striding over the real slots.
template <int LPA, int NPL, bool LOCAL>
__global__ void __launch_bounds__(kThreads)
score_pass_kernel(const Pass p, int stage_q, int stage_bytes) {
  constexpr int APW = 32 / LPA;   // alignments per warp
  constexpr int WP = LPA * NPL;   // cells per alignment, >= W
  __shared__ int32_t smat[kMaxMats * 64];
  extern __shared__ __align__(16) uint8_t stage[];

  const int n = min(p.meta[0], p.S);   // the real slots
  const int n_warps = (n + APW - 1) / APW;
  const int w0 = static_cast<int>(blockIdx.x) * kWarpsPerBlock;
  if (w0 >= n_warps) return;   // block-uniform
  for (int t = threadIdx.x; t < p.n_mats * 64; t += kThreads) {
    const bool in = ((t >> 3) & 7) < kPadCode && (t & 7) < kPadCode;
    smat[t] = in ? p.mats[t] : 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / LPA;
  const int sl = lane % LPA;
  uint8_t* qs = stage + (warp * APW + g) * stage_bytes;
  uint8_t* rs = qs + stage_q;
  const int T = p.L + p.W;
  for (int wi = w0 + warp; wi < n_warps; wi += gridDim.x * kWarpsPerBlock) {
    const int slot = wi * APW + g;
    const bool real = slot < n;
    const int flat = real ? p.slot_flat[slot] : 0;
    const int b = flat / p.C;
    const int len = real ? p.lengths[b] : 0;
    const int last = len - 1;   // glocal: the one row that competes
    const int rows = len < 0 ? 0 : (len > p.L ? p.L : len);
    int warp_rows = rows;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      warp_rows = max(warp_rows, __shfl_xor_sync(kFull, warp_rows, d));
    }
    if (warp_rows == 0) continue;   // warp-uniform: nothing to score
    const int st = real ? p.strand[flat] : 0;
    const int nr = warp_rows + WP - 1;
    __syncwarp();   // the previous slot's rows have read the stage
    if (rows > 0) {
      long long s = p.corr_start[flat];
      s = s < 0 ? 0 : (s > p.G ? p.G : s);
      stage_codes((st == 1 ? p.rc : p.reads) + static_cast<long long>(b) * p.L,
                  warp_rows, qs, warp_rows, sl, LPA);
      stage_window(p.genome, p.G, s, min(nr, T), rs, nr, sl, LPA);
    } else {
      stage_codes(p.reads, 0, qs, warp_rows, sl, LPA);
      stage_codes(p.reads, 0, rs, nr, sl, LPA);
    }
    __syncwarp();
    int m = (p.n_mats == 1 || !real) ? 0 : st;
    m = m < 0 ? 0 : (m >= p.n_mats ? p.n_mats - 1 : m);
    int bv, bi, bo;
    band_rows<LPA, NPL, LOCAL>(smat + m * 64, qs, rs, sl, rows, last,
                               warp_rows, p.W, p.gq, p.gr, p.ge, bv, bi, bo);
    if (real && sl == 0 && p.cand_valid[flat]) p.sw[flat] = bv;
  }
}

// The fused pass, block form (W > kMaxWarpBand): one slot a block at a time,
// striding over the real slots.
template <bool LOCAL>
__global__ void __launch_bounds__(kMaxBlockThreads)
score_pass_block_kernel(const Pass p, int stage_q) {
  constexpr int NPL = kBlockNPL;
  __shared__ int32_t smat[kMaxMats * 64];
  __shared__ int32_t wtot[2][32];
  __shared__ int32_t efirst[2][32];
  __shared__ int32_t red[3][32];
  extern __shared__ __align__(16) uint8_t stage[];

  const int n = min(p.meta[0], p.S);
  if (static_cast<int>(blockIdx.x) >= n) return;   // block-uniform
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  for (int t = tid; t < p.n_mats * 64; t += nt) {
    const bool in = ((t >> 3) & 7) < kPadCode && (t & 7) < kPadCode;
    smat[t] = in ? p.mats[t] : 0;
  }
  uint8_t* qs = stage;
  uint8_t* rs = stage + stage_q;
  const int T = p.L + p.W;
  for (int slot = blockIdx.x; slot < n; slot += gridDim.x) {
    const int flat = p.slot_flat[slot];
    const int b = flat / p.C;
    const int len = p.lengths[b];
    const int rows = len < 0 ? 0 : (len > p.L ? p.L : len);
    if (rows == 0) continue;   // block-uniform
    const int st = p.strand[flat];
    long long s = p.corr_start[flat];
    s = s < 0 ? 0 : (s > p.G ? p.G : s);
    const int nr = rows + nt * NPL - 1;
    __syncthreads();   // the previous slot's rows have read the stage
    stage_codes((st == 1 ? p.rc : p.reads) + static_cast<long long>(b) * p.L,
                rows, qs, rows, tid, nt);
    stage_window(p.genome, p.G, s, min(nr, T), rs, nr, tid, nt);
    __syncthreads();
    int m = p.n_mats == 1 ? 0 : st;
    m = m < 0 ? 0 : (m >= p.n_mats ? p.n_mats - 1 : m);
    int bv, bi, bo;
    block_rows<LOCAL>(smat + m * 64, qs, rs, rows, len - 1, p.W, p.gq, p.gr,
                      p.ge, wtot, efirst, red, bv, bi, bo);
    if (tid == 0 && p.cand_valid[flat]) p.sw[flat] = bv;
  }
}

// The blocks of `kern` the card holds resident at once, in *out.
template <class K>
cudaError_t resident_blocks(K kern, int threads, size_t smem, int* out) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, threads,
                                                        smem);
  }
  *out = max(per, 1) * max(sms, 1);
  return err;
}

template <int LPA, int NPL, bool LOCAL>
cudaError_t launch_pass(const Pass& p, cudaStream_t stream) {
  constexpr int APB = kThreads / LPA;   // alignments per block
  const int stage_q = (p.L + 3) & ~3;
  const int stage_bytes = stage_q + ((p.L + LPA * NPL + 3) & ~3);
  const long long smem = static_cast<long long>(APB) * stage_bytes;
  auto kern = score_pass_kernel<LPA, NPL, LOCAL>;
  cudaError_t err = allow_smem(kern, smem);
  int cap = 0;
  if (err == cudaSuccess) {
    err = resident_blocks(kern, kThreads, static_cast<size_t>(smem), &cap);
  }
  if (err != cudaSuccess) return err;
  const int blocks = min((p.S + APB - 1) / APB, cap);
  kern<<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(p, stage_q,
                                                               stage_bytes);
  return cudaGetLastError();
}

template <bool LOCAL>
cudaError_t launch_pass_block(const Pass& p, cudaStream_t stream) {
  const int threads = 32 * ((p.W + 32 * kBlockNPL - 1) / (32 * kBlockNPL));
  const int stage_q = (p.L + 3) & ~3;
  const long long smem =
      stage_q + ((static_cast<long long>(p.L) + threads * kBlockNPL + 3) & ~3);
  auto kern = score_pass_block_kernel<LOCAL>;
  cudaError_t err = allow_smem(kern, smem);
  int cap = 0;
  if (err == cudaSuccess) {
    err = resident_blocks(kern, threads, static_cast<size_t>(smem), &cap);
  }
  if (err != cudaSuccess) return err;
  kern<<<min(p.S, cap), threads, static_cast<size_t>(smem), stream>>>(
      p, stage_q);
  return cudaGetLastError();
}

template <bool LOCAL>
cudaError_t launch_pass_band(const Pass& p, cudaStream_t st) {
  return by_band(p.W, [&](auto lpa, auto npl) {
    constexpr int A = decltype(lpa)::value;
    constexpr int N = decltype(npl)::value;
    if constexpr (A == 0) {
      return launch_pass_block<LOCAL>(p, st);
    } else {
      return launch_pass<A, N, LOCAL>(p, st);
    }
  });
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

// The fused score pass (see its note above): reads and rc [B, L] uint8,
// lengths [B] int32, genome [G] uint8, corr_start and strand [B, C] int32,
// cand_valid [B, C] bool and score_mask [B >> mask_shift] bool (a byte
// each; mask_shift 1: rows 2i and 2i + 1 share entry i), mats
// [n_mats, 8, 8] int32; local != 0 for local mode, 0 for glocal; S the
// slots.  Writes sw [B, C] int32 (16-byte aligned), n_sc and base [B]
// int32, meta [2] int32 (total, slot_overflow) and the scratch slot_flat
// [S] int32.  1 <= W <= kMaxBand (8192), 1 <= n_mats <= 8, B x C < 2^31.
extern "C" int ngm_score_pass(const void* reads, const void* rc,
                              const void* lengths, const void* genome,
                              long long G, const void* corr_start,
                              const void* strand, const void* cand_valid,
                              const void* score_mask, int mask_shift,
                              const void* mats, int B,
                              int L, int C, int W, int S, int n_mats, int gq,
                              int gr, int ge, int local, void* sw, void* n_sc,
                              void* base, void* meta, void* slot_flat,
                              void* stream) {
  const long long n_sw = static_cast<long long>(B) * C;
  if (W < 1 || W > kMaxBand || n_mats < 1 || n_mats > kMaxMats || L < 0 ||
      B < 0 || C < 1 || S < 0 || G < 0 || n_sw >= (1LL << 31) ||
      mask_shift < 0 || mask_shift > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(sw) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const long long blocks = 1 + (n_sw + kFill - 1) / kFill;
  score_plan_kernel<<<static_cast<unsigned>(blocks), kPlanThreads, 0, st>>>(
      static_cast<const uint8_t*>(cand_valid),
      static_cast<const uint8_t*>(score_mask), mask_shift, B, C, S,
      static_cast<int32_t*>(n_sc), static_cast<int32_t*>(base),
      static_cast<int32_t*>(meta), static_cast<int32_t*>(slot_flat),
      static_cast<int32_t*>(sw), n_sw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 0 || B == 0) return static_cast<int>(err);
  const Pass p{static_cast<const uint8_t*>(reads),
               static_cast<const uint8_t*>(rc),
               static_cast<const int32_t*>(lengths),
               static_cast<const uint8_t*>(genome), G,
               static_cast<const int32_t*>(corr_start),
               static_cast<const int32_t*>(strand),
               static_cast<const uint8_t*>(cand_valid),
               static_cast<const int32_t*>(slot_flat),
               static_cast<const int32_t*>(meta),
               static_cast<const int32_t*>(mats), n_mats, gq, gr, ge,
               S, L, W, C, static_cast<int32_t*>(sw)};
  err = local != 0 ? launch_pass_band<true>(p, st)
                   : launch_pass_band<false>(p, st);
  return static_cast<int>(err);
}
