// K4: banded Smith-Waterman with traceback for Hopper (sm_90a), local or
// glocal, one launch per call.
//
// Replaces nextgenmap_tpu/ops/sw_ref.py:209 banded_sw_align: the lax.scan
// over the query rows that writes the direction bytes (sw_ref.py:289) and
// the row-synchronised backwalk _backwalk_rows (its lax.scan at :451).
// That is not a Pallas kernel: the reference leaves it to XLA as one jitted
// program, which the port's plain version runs as two Python loops of small
// torch calls.  Bit-identical to that plain version,
// nextgenmap_tpu_torch/ops/sw_ref.py::banded_sw_align (banded_sw_forward,
// then _backwalk_rows), in every AlignResult field and in the [L, S, W]
// direction bytes, which it writes in the plain version's layout.
//
// Forward pass: the int32 DP of K1 (csrc/sw_score.cu) in band coordinates
// (ref j = i + o), with the plain version's sentinels (NEG = -2^30 past the
// band's edges, so that f[0] = NEG - gr + ge, and at o = W-1 the E terms
// are NEG - gq and NEG - ge) rather than K1's inert cells, because the
// direction bits at the band's edges depend on them.  Every cell of every
// one of the L rows gets its byte (rows past qlen too, as in the plain
// version):
//   bits 0-1  H source: 0 stop (local, h <= 0), 1 h == hd, 2 h == e, 3 F
//   bit 2     E extends: e_ext > e_open, which is e != e_open since
//             e = max(e_open, e_ext)
//   bit 3     F extends: f[o-1] - ge > htmp[o-1] - gr.  Since
//             f[o] = max(f[o-1] - ge, htmp[o-1] - gr) exactly (o >= 1), the
//             bit is f[o] != htmp[o-1] - gr, which needs only htmp of the
//             cell to the left (known before the F scan); at o = 0 it is
//             (NEG - ge > NEG - gr)
//   bit 4     sub > 0
// The best cell is K1's: the first strict maximum over rows i < qlen (local)
// or the row i == qlen - 1 (glocal), smallest i, then smallest o.
//
// Backwalk: one thread per alignment walks its own direction bytes cell by
// cell from (bi, bo) while best > 0: the walk of tests/oracle_sw.py, which
// equals the row-synchronised walk of _backwalk_rows field for field (a D
// run continues from cell c to c-1 while f_bit(c) or hsrc(c-1) == 3; ops
// past max_ops are dropped while the counters go on, and raise trunc).
//
// What bounds it on the card.  The forward pass's 32-bit integer
// instructions, counted from the code below as K1's note counts its 6 (a
// DPX instruction counts as one): OPS_PER_CELL = 21 a cell in local mode,
// 19 in glocal mode (no floor):
//   E     e_open = h - gq, e = max(e_open, e_ext) (IADD + VIADDMAX),
//         the E bit e != e_open                                  3
//   H     hd = h + sub, htmp = max(hd, e[, 0])                   2
//   scan  run = max(run, htmp + o*ge)                            1
//   F/H   cm = max(excl, incl), f = cm - c_o, h = max(htmp, f)   3
//   byte  h == hd, h == e, two selects                           4
//         (local only: h <= 0, select                            2)
//         htmp[o-1] - gr, f != it                                2
//         sub > 0                                                1
//         three to pack the bits                                 3
// K1's 6 less its two fused forms (K4 keeps hd and f for the byte), plus
// the byte.  The two shared-memory loads of the substitution score, the
// byte's store (both on the load/store pipe) and the argmax's compare and
// selects are left out, as in K1's count.  Only the cells of the rows
// i < qlen of each slot count: no field of the result depends on the rest.
// Bytes: those cells' direction bytes written once and the bytes the walk
// reads back, the inputs, and the ops buffer and the fields written once.
// At the main path's [4096, 100] x W48 the integer bound is ~4x the byte
// bound (chip_smoke.py phase 4b).  On an H100 the forward pass takes most
// of K4's time at the main path's shapes (phase 4b times it alone; PERF.md
// has the figures), the walk the rest: its steps are loads that each
// depend on the one before (L2 hits), ~qlen + indels of them an alignment.
//
// Design (the simple one: keeping the bytes in shared memory, cp.async and
// a faster walk are later work):
//   - the forward pass uses K1's layout: a group of LPA = 8, 16 or 32 lanes
//     per alignment, NPL cells per lane, picked from W by K1's table, up to
//     W = 512; past it a block of 32 * ceil(W / 256) threads, 8 cells each,
//     with two barriers a row (the E neighbour and the F scan cross warps
//     through shared memory);
//   - the query and corridor are staged in shared memory, codes clamped to
//     5, and the matrices with every entry of a code >= 5 zeroed (a code
//     >= 5 scores 0, as in the plain version);
//   - the direction bytes go to a scratch [L, S, W] uint8 tensor that the
//     wrapper allocates, the plain version's layout; after a __syncwarp
//     (a barrier in the block form) the group's first lane walks back
//     through its own bytes, which were just written and sit in L2;
//   - the group's lanes then fill the rest of the op buffer with OP_NONE.
// Exact int32 arithmetic throughout.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// one warp per block in the warp form, as in K1
constexpr int kThreads = 32;
constexpr int kMaxMats = 8;
constexpr int kBlockNPL = 8;
constexpr int kMaxBlockThreads = 1024;
// 1024 threads x 8 cells, K1's limit: past it the [L, S, W] direction
// bytes exhaust the card
constexpr int kMaxBand = kMaxBlockThreads * kBlockNPL;
constexpr int kMaxWarpBand = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPadCode = 5;
constexpr int kNeg = -(1 << 30);      // the plain version's NEG
constexpr int kMaxDynSmem = 200 * 1024;
constexpr uint8_t kOpM = 0, kOpI = 1, kOpD = 2, kOpNone = 255;
constexpr int kPhH = 0, kPhE = 1, kPhF = 2;
// int32 outputs, one [S] row each: score, q_start, q_end, r_start, r_end,
// n_ops, matches, mismatches, indels
constexpr int kFields = 9;

// dst[t] = min(src[t], 5) for t < n, kPadCode for n <= t < n_pad, by the
// `lpa` threads of one group (index sl); K1's staging.  src is read as
// aligned 32-bit words: a word may reach up to 3 bytes before or after the
// row, never outside the 512-byte-aligned allocation that holds it.
__device__ __forceinline__ void stage_codes(const uint8_t* src, int n,
                                            uint8_t* dst, int n_pad, int sl,
                                            int lpa) {
  if (n > 0) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    const int lead = static_cast<int>(a & 3);
    const int nw = (lead + n + 3) >> 2;
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

// the matrices, every entry of a code >= 5 zeroed
__device__ __forceinline__ void load_mats(int32_t* smat, const int32_t* mats,
                                          int n_mats, int tid, int nt) {
  for (int t = tid; t < n_mats * 64; t += nt) {
    const bool in = ((t >> 3) & 7) < kPadCode && (t & 7) < kPadCode;
    smat[t] = in ? mats[t] : 0;
  }
}

// First half of a row, from the previous row's h and e of this thread's
// cells (and hn, en of the cell right of its last): writes the new E into
// e, and hd, htmp, the inclusive in-thread scan of htmp + o*ge, and the
// byte's E and match bits of each cell; returns the thread's scan total.
template <int NPL, bool LOCAL>
__device__ __forceinline__ int row_first(const int32_t* srow,
                                         const uint8_t* rr, const int (&h)[NPL],
                                         int (&e)[NPL], int hn, int en, int gq,
                                         int ge, int o0, int (&hd)[NPL],
                                         int (&ht)[NPL], int (&incl)[NPL],
                                         int (&bits)[NPL]) {
  int run = kNeg;
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int hup = k + 1 < NPL ? h[k + 1] : hn;
    const int eup = k + 1 < NPL ? e[k + 1] : en;
    const int e_open = hup - gq;
    const int e_ext = eup - ge;
    const int ec = max(e_open, e_ext);
    const int s = srow[rr[k]];
    hd[k] = h[k] + s;
    ht[k] = LOCAL ? max(max(hd[k], 0), ec) : max(hd[k], ec);
    run = max(run, ht[k] + (o0 + k) * ge);
    incl[k] = run;
    bits[k] = (ec != e_open ? 4 : 0) | (s > 0 ? 16 : 0);
    e[k] = ec;   // e[k + 1] is read before it is written
  }
  return run;
}

// Second half: F from the exclusive scan `excl` of the cells left of this
// thread, the new H, and each cell's direction byte (stored to drow, null
// for a slot past S); htl = htmp of the cell left of o0, fb0 = bit 3 at
// o = 0.  Cells past W are reset to NEG: the cell W-1 must see NEG above
// its right neighbour, as the plain version's shift fills it.  Folds the
// row into the thread's first maximum (lb, li, lo) when `counts`.
template <int NPL, bool LOCAL>
__device__ __forceinline__ void row_second(
    int excl, int htl, int fb0, int (&h)[NPL], int (&e)[NPL],
    const int (&hd)[NPL], const int (&ht)[NPL], const int (&incl)[NPL],
    const int (&bits)[NPL], int o0, int W, int gr, int ge, uint8_t* drow,
    bool counts, int i, int& lb, int& li, int& lo) {
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int o = o0 + k;
    const int cm = k == 0 ? excl : max(excl, incl[k - 1]);
    const int f = cm - gr - (o - 1) * ge;
    const int hn = max(ht[k], f);
    int src = hn == hd[k] ? 1 : (hn == e[k] ? 2 : 3);
    if (LOCAL && hn <= 0) src = 0;
    const int hl = k == 0 ? htl : ht[k - 1];
    const int fbit = o == 0 ? fb0 : (f != hl - gr ? 8 : 0);
    if (o < W) {
      if (drow != nullptr) {
        drow[k] = static_cast<uint8_t>(src | fbit | bits[k]);
      }
      if (counts && hn > lb) {   // strict >: ties keep the earlier
        lb = hn;
        li = i;
        lo = o;
      }
      h[k] = hn;
    } else {
      h[k] = kNeg;
      e[k] = kNeg;
    }
  }
}

// (value, i, o) of two first maxima: the larger value, then smaller i, o
__device__ __forceinline__ void take_first_max(int ov, int oi, int oo, int& bv,
                                               int& bi, int& bo) {
  if (ov > bv || (ov == bv && (oi < bi || (oi == bi && oo < bo)))) {
    bv = ov;
    bi = oi;
    bo = oo;
  }
}

// The backwalk of one alignment by one thread, cell by cell; d points at
// its row 0 (dirs + slot * W), row i at d + i * row_stride.  Writes the
// fields and the first n_ops ops; returns n_ops.
__device__ int walk_back(const uint8_t* d, long long row_stride, int W,
                         int max_ops, int best, int bi, int bo, uint8_t* ops,
                         int32_t* out, uint8_t* trunc, int slot, int S) {
  int i = bi, o = bo, ph = kPhH, c = 0;
  int qs = bi, rs = bi + bo, nm = 0, nmm = 0, nid = 0;
  bool tr = false;
  if (best > 0) {
    while (i >= 0 && o >= 0 && o < W) {
      const int v = d[i * row_stride + o];
      // in the E (F) phase the cell emits I (D) whatever its H source
      const int src = ph == kPhH ? (v & 3) : (ph == kPhE ? 2 : 3);
      uint8_t op;
      if (src == 0) break;
      if (src == 1) {
        op = kOpM;
        if (v & 16) {
          ++nm;
        } else {
          ++nmm;
        }
        qs = i;
        rs = i + o;
        --i;
      } else if (src == 2) {
        op = kOpI;
        ++nid;
        qs = i;
        ph = (v & 4) ? kPhE : kPhH;
        --i;
        ++o;
      } else {
        op = kOpD;
        ++nid;
        rs = i + o;
        ph = (v & 8) ? kPhF : kPhH;
        --o;
      }
      if (c < max_ops) {
        ops[c++] = op;
      } else {
        tr = true;
      }
    }
  }
  const int vals[kFields] = {best, qs, bi, rs, bi + bo, c, nm, nmm, nid};
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    out[f * static_cast<long long>(S) + slot] = vals[f];
  }
  trunc[slot] = tr ? 1 : 0;
  return c;
}

template <int NPL>
__device__ __forceinline__ void init_cells(int o0, int W, int (&h)[NPL],
                                           int (&e)[NPL]) {
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    h[k] = o0 + k < W ? 0 : kNeg;
    e[k] = kNeg;
  }
}

// Groups of LPA lanes, one alignment each, APW = 32 / LPA alignments a
// warp, one warp a block.
template <int LPA, int NPL, bool LOCAL>
__global__ void __launch_bounds__(kThreads)
sw_align_kernel(const uint8_t* __restrict__ query,
                const int32_t* __restrict__ qlen,
                const uint8_t* __restrict__ corr,
                const int32_t* __restrict__ mats,
                const int32_t* __restrict__ msel, int S, int L, int W,
                int n_mats, int gq, int gr, int ge, int max_ops, int stage_q,
                int stage_bytes, uint8_t* dirs, int32_t* __restrict__ out,
                uint8_t* __restrict__ ops, uint8_t* __restrict__ trunc) {
  constexpr int APW = 32 / LPA;
  constexpr int WP = LPA * NPL;
  __shared__ int32_t smat[kMaxMats * 64];
  extern __shared__ __align__(16) uint8_t stage[];

  load_mats(smat, mats, n_mats, threadIdx.x, kThreads);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane / LPA;
  const int sl = lane % LPA;
  const int slot = blockIdx.x * APW + g;
  const bool real = slot < S;
  const int len = real ? qlen[slot] : 0;
  const int rows = len < 0 ? 0 : (len > L ? L : len);
  const int last = len - 1;   // glocal: the one row that competes

  uint8_t* qs = stage + g * stage_bytes;
  uint8_t* rs = qs + stage_q;
  const int nr = L + WP - 1;
  if (real) {
    stage_codes(query + static_cast<long long>(slot) * L, L, qs, L, sl, LPA);
    stage_codes(corr + static_cast<long long>(slot) * (L + W), min(nr, L + W),
                rs, nr, sl, LPA);
  } else {
    stage_codes(query, 0, qs, L, sl, LPA);
    stage_codes(corr, 0, rs, nr, sl, LPA);
  }
  __syncwarp();

  int m = (n_mats == 1 || !real) ? 0 : msel[slot];
  m = m < 0 ? 0 : (m >= n_mats ? n_mats - 1 : m);
  const int32_t* sm = smat + m * 64;

  const int o0 = sl * NPL;
  const int fb0 = (kNeg - ge) > (kNeg - gr) ? 8 : 0;
  const long long row_stride = static_cast<long long>(S) * W;
  uint8_t* dcell = real ? dirs + static_cast<long long>(slot) * W + o0 : nullptr;
  int h[NPL], e[NPL];
  init_cells<NPL>(o0, W, h, e);
  int lb = 0, li = 0, lo = 0;

  for (int i = 0; i < L; ++i) {
    // the previous row's h and e of the cell right of this lane's last
    int hn = __shfl_down_sync(kFull, h[0], 1, LPA);
    int en = __shfl_down_sync(kFull, e[0], 1, LPA);
    if (sl == LPA - 1) {
      hn = kNeg;
      en = kNeg;
    }
    int hd[NPL], ht[NPL], incl[NPL], bits[NPL];
    const int run = row_first<NPL, LOCAL>(sm + 8 * qs[i], rs + i + o0, h, e,
                                          hn, en, gq, ge, o0, hd, ht, incl,
                                          bits);
    const int htl = __shfl_up_sync(kFull, ht[NPL - 1], 1, LPA);
    // exclusive max-scan of the lane totals across the group
    int v = run;
#pragma unroll
    for (int d = 1; d < LPA; d <<= 1) {
      const int t = __shfl_up_sync(kFull, v, d, LPA);
      if (sl >= d) v = max(v, t);
    }
    int excl = __shfl_up_sync(kFull, v, 1, LPA);
    if (sl == 0) excl = kNeg;
    row_second<NPL, LOCAL>(excl, htl, fb0, h, e, hd, ht, incl, bits, o0, W,
                           gr, ge, real ? dcell + i * row_stride : nullptr,
                           LOCAL ? i < rows : i == last, i, lb, li, lo);
  }

  int bv = lb, bi = li, bo = lo;
#pragma unroll
  for (int d = LPA / 2; d > 0; d >>= 1) {
    take_first_max(__shfl_xor_sync(kFull, bv, d, LPA),
                   __shfl_xor_sync(kFull, bi, d, LPA),
                   __shfl_xor_sync(kFull, bo, d, LPA), bv, bi, bo);
  }
  __syncwarp();   // the group's bytes, visible to its walking lane
  int c = 0;
  uint8_t* slot_ops = ops + static_cast<long long>(slot) * max_ops;
  if (real && sl == 0) {
    c = walk_back(dirs + static_cast<long long>(slot) * W, row_stride, W,
                  max_ops, bv, bi, bo, slot_ops, out, trunc, slot, S);
  }
  c = __shfl_sync(kFull, c, 0, LPA);
  if (real) {
    for (int t = c + sl; t < max_ops; t += LPA) slot_ops[t] = kOpNone;
  }
}

// One alignment a block, for W > kMaxWarpBand: 32 * nw threads, thread t
// owning cells 8t .. 8t+7.  Two barriers a row: (A) after each warp's lane
// 0 publishes the previous row's h and e of its first cell, which lane 31
// of the warp before needs for its last cell's E; (B) after each warp's
// lane 31 publishes its scan total and its last cell's htmp, which the
// warps after need for the F scan and for bit 3 of their first cell.
template <bool LOCAL>
__global__ void __launch_bounds__(kMaxBlockThreads)
sw_align_block_kernel(const uint8_t* __restrict__ query,
                      const int32_t* __restrict__ qlen,
                      const uint8_t* __restrict__ corr,
                      const int32_t* __restrict__ mats,
                      const int32_t* __restrict__ msel, int S, int L, int W,
                      int n_mats, int gq, int gr, int ge, int max_ops,
                      int stage_q, uint8_t* dirs, int32_t* __restrict__ out,
                      uint8_t* __restrict__ ops, uint8_t* __restrict__ trunc) {
  constexpr int NPL = kBlockNPL;
  __shared__ int32_t smat[kMaxMats * 64];
  __shared__ int32_t s_h0[32], s_e0[32];    // previous row, first cell
  __shared__ int32_t s_tot[32], s_ht[32];   // scan total, last htmp
  __shared__ int32_t red[3][32];            // the argmax across warps
  __shared__ int32_t s_c;
  extern __shared__ __align__(16) uint8_t stage[];

  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const int slot = blockIdx.x;
  const int len = qlen[slot];
  const int rows = len < 0 ? 0 : (len > L ? L : len);
  const int last = len - 1;

  load_mats(smat, mats, n_mats, tid, nt);
  uint8_t* qs = stage;
  uint8_t* rs = stage + stage_q;
  const int nr = L + nt * NPL - 1;
  stage_codes(query + static_cast<long long>(slot) * L, L, qs, L, tid, nt);
  stage_codes(corr + static_cast<long long>(slot) * (L + W), min(nr, L + W),
              rs, nr, tid, nt);
  __syncthreads();

  int m = n_mats == 1 ? 0 : msel[slot];
  m = m < 0 ? 0 : (m >= n_mats ? n_mats - 1 : m);
  const int32_t* sm = smat + m * 64;
  const int o0 = tid * NPL;
  const int fb0 = (kNeg - ge) > (kNeg - gr) ? 8 : 0;
  const long long row_stride = static_cast<long long>(S) * W;
  uint8_t* dcell = dirs + static_cast<long long>(slot) * W + o0;
  int h[NPL], e[NPL];
  init_cells<NPL>(o0, W, h, e);
  int lb = 0, li = 0, lo = 0;

  for (int i = 0; i < L; ++i) {
    if (lane == 0) {
      s_h0[warp] = h[0];
      s_e0[warp] = e[0];
    }
    __syncthreads();   // A
    int hn = __shfl_down_sync(kFull, h[0], 1);
    int en = __shfl_down_sync(kFull, e[0], 1);
    if (lane == 31) {
      hn = warp + 1 < nw ? s_h0[warp + 1] : kNeg;
      en = warp + 1 < nw ? s_e0[warp + 1] : kNeg;
    }
    int hd[NPL], ht[NPL], incl[NPL], bits[NPL];
    const int run = row_first<NPL, LOCAL>(sm + 8 * qs[i], rs + i + o0, h, e,
                                          hn, en, gq, ge, o0, hd, ht, incl,
                                          bits);
    int htl = __shfl_up_sync(kFull, ht[NPL - 1], 1);
    int v = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v = max(v, t);
    }
    int excl = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) excl = kNeg;
    if (lane == 31) {
      s_tot[warp] = v;
      s_ht[warp] = ht[NPL - 1];
    }
    __syncthreads();   // B
    if (lane == 0 && warp > 0) htl = s_ht[warp - 1];
    // the max of the totals of the warps before this one
    int carry = lane < warp ? s_tot[lane] : kNeg;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      carry = max(carry, __shfl_xor_sync(kFull, carry, d));
    }
    excl = max(excl, carry);
    row_second<NPL, LOCAL>(excl, htl, fb0, h, e, hd, ht, incl, bits, o0, W,
                           gr, ge, dcell + i * row_stride,
                           LOCAL ? i < rows : i == last, i, lb, li, lo);
  }

  int bv = lb, bi = li, bo = lo;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    take_first_max(__shfl_xor_sync(kFull, bv, d),
                   __shfl_xor_sync(kFull, bi, d),
                   __shfl_xor_sync(kFull, bo, d), bv, bi, bo);
  }
  if (lane == 0) {
    red[0][warp] = bv;
    red[1][warp] = bi;
    red[2][warp] = bo;
  }
  __syncthreads();   // also makes every thread's bytes visible to thread 0
  uint8_t* slot_ops = ops + static_cast<long long>(slot) * max_ops;
  if (warp == 0) {
    bv = lane < nw ? red[0][lane] : 0;
    bi = lane < nw ? red[1][lane] : 0;
    bo = lane < nw ? red[2][lane] : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      take_first_max(__shfl_xor_sync(kFull, bv, d),
                     __shfl_xor_sync(kFull, bi, d),
                     __shfl_xor_sync(kFull, bo, d), bv, bi, bo);
    }
    if (lane == 0) {
      s_c = walk_back(dirs + static_cast<long long>(slot) * W, row_stride, W,
                      max_ops, bv, bi, bo, slot_ops, out, trunc, slot, S);
    }
  }
  __syncthreads();
  for (int t = s_c + tid; t < max_ops; t += nt) slot_ops[t] = kOpNone;
}

struct Args {
  const void *query, *qlen, *corr, *mats, *msel;
  int S, L, W, n_mats, gq, gr, ge, max_ops;
  void *dirs, *out, *ops, *trunc;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kern, long long smem) {
  if (smem > kMaxDynSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool LOCAL>
cudaError_t launch_block(const Args& a, cudaStream_t stream) {
  const int threads = 32 * ((a.W + 32 * kBlockNPL - 1) / (32 * kBlockNPL));
  const int stage_q = (a.L + 3) & ~3;
  const long long smem =
      stage_q + ((static_cast<long long>(a.L) + threads * kBlockNPL + 3) & ~3);
  auto kern = sw_align_block_kernel<LOCAL>;
  const cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<a.S, threads, static_cast<size_t>(smem), stream>>>(
      static_cast<const uint8_t*>(a.query), static_cast<const int32_t*>(a.qlen),
      static_cast<const uint8_t*>(a.corr), static_cast<const int32_t*>(a.mats),
      static_cast<const int32_t*>(a.msel), a.S, a.L, a.W, a.n_mats, a.gq, a.gr,
      a.ge, a.max_ops, stage_q, static_cast<uint8_t*>(a.dirs),
      static_cast<int32_t*>(a.out), static_cast<uint8_t*>(a.ops),
      static_cast<uint8_t*>(a.trunc));
  return cudaGetLastError();
}

template <int LPA, int NPL, bool LOCAL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int APB = kThreads / LPA;   // alignments per block
  const int stage_q = (a.L + 3) & ~3;
  const int stage_bytes = stage_q + ((a.L + LPA * NPL + 3) & ~3);
  const long long smem = static_cast<long long>(APB) * stage_bytes;
  auto kern = sw_align_kernel<LPA, NPL, LOCAL>;
  const cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.S + APB - 1) / APB;
  kern<<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const uint8_t*>(a.query), static_cast<const int32_t*>(a.qlen),
      static_cast<const uint8_t*>(a.corr), static_cast<const int32_t*>(a.mats),
      static_cast<const int32_t*>(a.msel), a.S, a.L, a.W, a.n_mats, a.gq, a.gr,
      a.ge, a.max_ops, stage_q, stage_bytes, static_cast<uint8_t*>(a.dirs),
      static_cast<int32_t*>(a.out), static_cast<uint8_t*>(a.ops),
      static_cast<uint8_t*>(a.trunc));
  return cudaGetLastError();
}

template <bool LOCAL>
cudaError_t launch_band(const Args& a, cudaStream_t st) {
  // K1's (lanes per alignment, cells per lane) table
  if (a.W <= 16) return launch<8, 2, LOCAL>(a, st);
  if (a.W <= 32) return launch<8, 4, LOCAL>(a, st);
  if (a.W <= 48) return launch<16, 3, LOCAL>(a, st);
  if (a.W <= 64) return launch<16, 4, LOCAL>(a, st);
  if (a.W <= 96) return launch<16, 6, LOCAL>(a, st);
  if (a.W <= 128) return launch<16, 8, LOCAL>(a, st);
  if (a.W <= 192) return launch<32, 6, LOCAL>(a, st);
  if (a.W <= 256) return launch<32, 8, LOCAL>(a, st);
  if (a.W <= 384) return launch<32, 12, LOCAL>(a, st);
  if (a.W <= kMaxWarpBand) return launch<32, 16, LOCAL>(a, st);
  return launch_block<LOCAL>(a, st);
}

}  // namespace

// query [S, L] uint8, qlen [S] int32, corr [S, L + W] uint8,
// mats [n_mats, 8, 8] int32, msel [S] int32 (clamped to [0, n_mats)); local
// != 0 for local mode, 0 for glocal.  Writes dirs [L, S, W] uint8 (scratch,
// the plain version's direction bytes), out [9, S] int32 (score, q_start,
// q_end, r_start, r_end, n_ops, matches, mismatches, indels), ops
// [S, max_ops] uint8 and trunc [S] bool.  1 <= W <= 8192, 1 <= n_mats <= 8,
// max_ops >= 1.
extern "C" int ngm_sw_align(const void* query, const void* qlen,
                            const void* corr, const void* mats,
                            const void* msel, int S, int L, int W, int n_mats,
                            int gq, int gr, int ge, int local, int max_ops,
                            void* dirs, void* out, void* ops, void* trunc,
                            void* stream) {
  if (W < 1 || W > kMaxBand || n_mats < 1 || n_mats > kMaxMats || L < 0 ||
      max_ops < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{query, qlen, corr, mats, msel, S, L, W, n_mats, gq, gr, ge,
               max_ops, dirs, out, ops, trunc};
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      local != 0 ? launch_band<true>(a, st) : launch_band<false>(a, st);
  return static_cast<int>(err);
}
