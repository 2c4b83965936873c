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
// then _backwalk_rows), in every AlignResult field; when the caller asks
// for them (a non-null `dirs`), also in the [L, S, W] direction bytes, in
// the plain version's layout.
//
// Forward pass: the int32 DP of K1 (csrc/sw_score.cu) in band coordinates
// (ref j = i + o), with the plain version's sentinels (NEG = -2^30 past the
// band's edges, so that f[0] = NEG - gr + ge, and at o = W-1 the E terms
// are NEG - gq and NEG - ge) rather than K1's inert cells, because the
// direction bits at the band's edges depend on them.  The plain version's
// direction byte of a cell:
//   bits 0-1  H source: 0 stop (local, h <= 0), 1 h == hd, 2 h == e, 3 F
//   bit 2     E extends: e_ext > e_open, which is e != e_open since
//             e = max(e_open, e_ext)
//   bit 3     F extends: f[o-1] - ge > htmp[o-1] - gr.  Since
//             f[o] = max(f[o-1] - ge, htmp[o-1] - gr) exactly (o >= 1), the
//             bit is f[o] != htmp[o-1] - gr, which needs only htmp of the
//             cell to the left (known before the F scan); at o = 0 it is
//             (NEG - ge > NEG - gr)
//   bit 4     sub > 0
// The walk needs bits 0-3 only: the cell's 4-bit code.  Bit 4 splits M
// columns into matches and mismatches; the walk recomputes it from what
// the block holds (the staged codes, clamped to 5, and a 64-bit mask of the
// slot's matrix entries > 0).  The best cell is K1's: the first strict
// maximum over rows i < qlen (local) or the row i == qlen - 1 (glocal),
// smallest i, then smallest o.
//
// Backwalk: the walk of tests/oracle_sw.py cell by cell from (bi, bo) while
// best > 0, which equals the row-synchronised walk of _backwalk_rows field
// for field (a D run continues from cell c to c-1 while f_bit(c) or
// hsrc(c-1) == 3; ops past max_ops are dropped while the counters go on,
// and raise trunc).
//
// What bounds it on the card.  The forward pass's 32-bit integer
// instructions, counted as K1's note counts its 6 (a DPX instruction counts
// as one): OPS_PER_CELL = 20 a cell in local mode, 18 in glocal mode (no
// floor):
//   E     e_open = h - gq, e = max(e_open, e_ext) (IADD + VIADDMAX),
//         the E bit e != e_open                                  3
//   H     hd = h + sub, htmp = max(hd, e[, 0])                   2
//   scan  run = max(run, htmp + o*ge)                            1
//   F/H   cm = max(excl, incl), f = cm - c_o, h = max(htmp, f)   3
//   bits  h == hd, h == e, two selects                           4
//         (local only: h <= 0, select                            2)
//         htmp[o-1] - gr, f != it                                2
//         three ORs: the H source, the E bit and the F bit into
//         the row's word (a select can give its value already at
//         the cell's nibble)                                     3
// K1's 6 less its two fused forms (K4 keeps hd and f for the bits), plus
// the four direction bits the walk reads.  Bit 4 (sub > 0) is not a cell's
// work: the walk computes it for the M cells it passes, about one a row
// where a row has W cells, as it does its other few instructions a step,
// which the count leaves out like K1's argmax.  The substitution
// score's shared-memory loads, the words' stores and the argmax's compare
// and selects are left out, as in K1's count.  Only the cells of the rows
// i < qlen of each slot count: no field of the result depends on the rest.
// Bytes: the inputs, the ops buffer and the fields written once (the
// direction bits never leave the chip on the smem route, and the [L, S, W]
// bytes are not written on the mapping path).  At the main path's
// [4096, 100] x W48 the integer bound is ~40x the byte bound (chip_smoke.py
// phase 4b).
//
// Design:
//   - the forward pass: blocks of up to kWarps warps, the matrices staged
//     once a block (every entry of a code >= 5 zeroed: such a code scores
//     0, as in the plain version), then groups of LPA lanes, one alignment
//     each, NPL cells a lane, from K4's own table (by_band; fixed by a
//     sweep on the card); the query and corridor staged in shared
//     memory, codes clamped to 5.  Without the bytes, the rows stop at the
//     longest qlen of the warp.  The row loop is compiled twice, with and
//     without the bytes, so the mapping path's has no test for them; the
//     plan halves the warps a block while that spreads them over the SMs
//     more evenly (a few hundred alignments of one warp each).
//   - each lane packs its NPL cells' 4-bit codes into one word a row
//     (16 bits up to NPL 4, 32 up to 8, 64 up to 16) and stores it once a
//     row at [row][lane]: cell (i, o) is row i, lane o / NPL, nibble o % NPL.
//     Cells past W are packed but never read (the walk stops at o >= W).
//   - two routes, by shape (ngm_sw_align_plan, which also fixes the block;
//     ngm_sw_align launches what it planned, with no runtime call but the
//     launch):
//       smem   every row of the group's words in dynamic shared memory;
//              the walk reads them there.  Shared memory sets how many
//              warps an SM holds, so the route runs where at least
//              kMinSmemWarps warps of it fit on an SM.
//       global the words to a scratch [S, L, LPA] laid out alignment-major,
//              so an alignment's rows are contiguous; the walk reads them
//              in chunks of kChunk rows that the group copies into shared
//              memory together (coalesced, independent loads), then walks
//              there.  Past W = 512 (one alignment a block of 32 *
//              ceil(W / 256) threads, 8 cells each, two barriers a row: the
//              E neighbour and the F scan cross warps through shared
//              memory) only this route runs, and thread 0 walks the
//              scratch directly.
//     Neither route is a fallback of the other: a route that cannot take
//     a shape is refused (the plan reports it), never replaced.
//   - the walk: every lane of the group runs the same walk (broadcast
//     reads from shared memory), so the group can refill a chunk together;
//     the group's first lane writes the ops and fields; the group then
//     fills the rest of the op buffer with OP_NONE.
// Exact int32 arithmetic throughout.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

// warps a block in the warp form (fewer where their shared memory needs
// it: the smem route's rows, or long reads' codes)
constexpr int kWarps = 4;
constexpr int kMaxMats = 8;
constexpr int kBlockNPL = 8;
constexpr int kMaxBlockThreads = 1024;
// 1024 threads x 8 cells, K1's limit
constexpr int kMaxBand = kMaxBlockThreads * kBlockNPL;
constexpr int kMaxWarpBand = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPadCode = 5;
constexpr int kNeg = -(1 << 30);      // the plain version's NEG
constexpr uint8_t kOpM = 0, kOpI = 1, kOpD = 2, kOpNone = 255;
constexpr int kPhH = 0, kPhE = 1, kPhF = 2;
// the walk's step computes an op as its H source - 1, the source of the
// E (F) phase as the phase + 1, and the phases from bits 2 and 3
static_assert(kOpM == 0 && kOpI == 1 && kOpD == 2, "op = source - 1");
static_assert(kPhH == 0 && kPhE == 1 && kPhF == 2, "E: bit 2, F: bit 3");
// int32 outputs, one [S] row each: score, q_start, q_end, r_start, r_end,
// n_ops, matches, mismatches, indels
constexpr int kFields = 9;
// the global route's walk: rows a chunk, copied to shared memory at once
constexpr int kChunk = 32;
// the shape rule: the smem route where at least this many of its warps fit
// on an SM.  Measured on an H100 (tools/kernel_ab.py, PERF.md): the smem
// route won with 28 and 20 warps an SM ([4096,100]xW48, [2048,150]xW56),
// the global route against 8 and 1 ([2048,100]xW264, [614,1000]xW184)
constexpr int kMinSmemWarps = 12;
constexpr int kRouteSmem = 0, kRouteGlobal = 1;

// one packed row of a lane: NPL 4-bit codes
template <int NPL>
using Word = typename std::conditional<
    (NPL <= 4), uint16_t,
    typename std::conditional<(NPL <= 8), uint32_t, uint64_t>::type>::type;

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

// bit 8q + r set where the matrix scores (q, r) > 0: the plain version's
// bit 4 (sub > 0) of a cell whose clamped codes are q, r
__device__ __forceinline__ uint64_t positive_mask(const int32_t* sm) {
  uint64_t pos = 0;
#pragma unroll
  for (int q = 0; q < kPadCode; ++q) {
#pragma unroll
    for (int r = 0; r < kPadCode; ++r) {
      if (sm[8 * q + r] > 0) pos |= uint64_t{1} << (8 * q + r);
    }
  }
  return pos;
}

// First half of a row, from the previous row's h and e of this thread's
// cells (and hn, en of the cell right of its last): writes the new E into
// e, and hd, htmp, the inclusive in-thread scan of htmp + o*ge, and each
// cell's E bit; returns the thread's scan total.
template <int NPL, bool LOCAL>
__device__ __forceinline__ int row_first(const int32_t* srow,
                                         const uint8_t* rr, const int (&h)[NPL],
                                         int (&e)[NPL], int hn, int en, int gq,
                                         int ge, int o0, int (&hd)[NPL],
                                         int (&ht)[NPL], int (&incl)[NPL],
                                         int (&eb)[NPL]) {
  int run = kNeg;
#pragma unroll
  for (int k = 0; k < NPL; ++k) {
    const int hup = k + 1 < NPL ? h[k + 1] : hn;
    const int eup = k + 1 < NPL ? e[k + 1] : en;
    const int e_open = hup - gq;
    const int e_ext = eup - ge;
    const int ec = max(e_open, e_ext);
    hd[k] = h[k] + srow[rr[k]];
    ht[k] = LOCAL ? max(max(hd[k], 0), ec) : max(hd[k], ec);
    run = max(run, ht[k] + (o0 + k) * ge);
    incl[k] = run;
    eb[k] = ec != e_open ? 4 : 0;
    e[k] = ec;   // e[k + 1] is read before it is written
  }
  return run;
}

// Second half: F from the exclusive scan `excl` of the cells left of this
// thread, the new H, and each cell's 4-bit code, packed into the returned
// word (cell k at bits 4k..4k+3); htl = htmp of the cell left of o0, fb0 =
// bit 3 at o = 0.  With `drow` (the plain version's bytes asked for) each
// cell's byte goes there too, with bit 4 (sub = hd - the previous h).
// Cells past W are reset to NEG: the cell W-1 must see NEG above its right
// neighbour, as the plain version's shift fills it.  Folds the row into the
// thread's first maximum (lb, li, lo) when `counts`.
template <int NPL, bool LOCAL, bool BYTES, typename Wd>
__device__ __forceinline__ Wd row_second(
    int excl, int htl, int fb0, int (&h)[NPL], int (&e)[NPL],
    const int (&hd)[NPL], const int (&ht)[NPL], const int (&incl)[NPL],
    const int (&eb)[NPL], int o0, int W, int gr, int ge, uint8_t* drow,
    bool counts, int i, int& lb, int& li, int& lo) {
  Wd w = 0;
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
    const int code = src | fbit | eb[k];
    w |= static_cast<Wd>(static_cast<Wd>(code) << (4 * k));
    const bool in = o < W;
    if (BYTES && in && drow != nullptr) {
      drow[k] = static_cast<uint8_t>(code | (hd[k] - h[k] > 0 ? 16 : 0));
    }
    if (counts && in && hn > lb) {   // strict >: ties keep the earlier
      lb = hn;
      li = i;
      lo = o;
    }
    h[k] = in ? hn : kNeg;
    e[k] = in ? e[k] : kNeg;
  }
  return w;
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

// One alignment's fields as the walk leaves them: AlignResult's int32
// fields in kFields order, and trunc.
struct Aln {
  int score, q_start, q_end, r_start, r_end, n_ops, matches, mismatches,
      indels;
  bool trunc;
};

// K4's outputs of one alignment: out [kFields, S] int32 and trunc [S]
__device__ __forceinline__ void store_aln(const Aln& a, int32_t* out,
                                          uint8_t* trunc, int slot, int S) {
  const int vals[kFields] = {a.score,   a.q_start, a.q_end,
                             a.r_start, a.r_end,   a.n_ops,
                             a.matches, a.mismatches, a.indels};
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    out[f * static_cast<long long>(S) + slot] = vals[f];
  }
  trunc[slot] = a.trunc ? 1 : 0;
}

// The backwalk of one alignment, cell by cell from (bi, bo), over its
// packed rows `bits` (row i at bits + i * row_words).  CHUNKED (the global
// route's warp form): the `lpa` lanes of the group (mask gmask, this one
// sl) all run this walk and copy kChunk rows at a time into `buf` (shared
// memory) before reading them there; otherwise the reads go to `bits`
// directly.  qs, rs: the staged codes; pos: positive_mask of the slot's
// matrix.  The `writer` writes the first n_ops ops; every lane that walks
// returns the fields.
template <int NPL, bool CHUNKED, typename Wd>
__device__ __forceinline__ Aln walk_back(
    const Wd* bits, int row_words, Wd* buf, unsigned gmask, int sl, int lpa,
    const uint8_t* qs, const uint8_t* rs, uint64_t pos, int W, int max_ops,
    int best, int bi, int bo, bool writer, uint8_t* ops) {
  int i = bi, o = bo, ph = kPhH, c = 0;
  int q0 = bi, r0 = bi + bo, nm = 0, nmm = 0, nid = 0;
  bool tr = false;
  int lo = CHUNKED ? bi + 1 : 0;            // the first row `held` holds
  const Wd* held = CHUNKED ? buf : bits;
  if (best > 0) {
    while (i >= 0 && o >= 0 && o < W) {
      if (CHUNKED && i < lo) {
        lo = max(0, i - kChunk + 1);
        __syncwarp(gmask);                  // the last chunk's reads done
        const Wd* src = bits + static_cast<long long>(lo) * row_words;
        const int n = (i - lo + 1) * row_words;
        for (int t = sl; t < n; t += lpa) buf[t] = src[t];
        __syncwarp(gmask);
      }
      const int ow = o / NPL;
      const int v = static_cast<int>(
          (held[static_cast<long long>(i - lo) * row_words + ow] >>
           (4 * (o - ow * NPL))) & 15);
      const int qc = qs[i], rc = rs[i + o];
      // in the E (F) phase the cell emits I (D) whatever its H source
      const int src = ph == kPhH ? (v & 3) : ph + 1;
      if (src == 0) break;
      // one step without branches, so that the groups of a warp walk in
      // step: M (src 1) moves up-left, I (2) up, D (3) left
      const bool m = src == 1, ins = src == 2, del = src == 3;
      const int hit = m ? static_cast<int>((pos >> (8 * qc + rc)) & 1) : 0;
      nm += hit;
      nmm += static_cast<int>(m) - hit;
      nid += static_cast<int>(!m);
      q0 = del ? q0 : i;
      r0 = ins ? r0 : i + o;
      ph = ins ? (v >> 2) & 1 : (del ? (v >> 2) & 2 : kPhH);
      i -= static_cast<int>(!del);
      o += static_cast<int>(ins) - static_cast<int>(del);
      if (writer && c < max_ops) ops[c] = static_cast<uint8_t>(src - 1);
      tr = tr || c >= max_ops;
      c += static_cast<int>(c < max_ops);
    }
  }
  return Aln{best, q0, bi, r0, bi + bo, c, nm, nmm, nid, tr};
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

// The forward pass of one group of LPA lanes (the warp form), lane sl,
// over its staged codes qs, rs with the slot's matrix sm: rows 0 .. nrows
// - 1, each row's packed words to rowbits (row i at rowbits + i * LPA)
// where `real`, and with `bytes` each in-band cell's byte at dcell + i *
// row_stride.  Leaves the group's first maximum over the rows that compete
// (local: i < rows; glocal: i == last) in (bv, bi, bo) of every lane.  The
// rows are compiled twice, with and without the bytes, so the mapping path's
// have no test for them.
template <int LPA, int NPL, bool LOCAL>
__device__ __forceinline__ void warp_forward(
    const int32_t* sm, const uint8_t* qs, const uint8_t* rs, int sl,
    bool real, int rows, int last, int nrows, int W, int gq, int gr, int ge,
    Word<NPL>* rowbits, bool bytes, uint8_t* dcell, long long row_stride,
    int& bv, int& bi, int& bo) {
  using Wd = Word<NPL>;
  const int o0 = sl * NPL;
  const int fb0 = (kNeg - ge) > (kNeg - gr) ? 8 : 0;
  int h[NPL], e[NPL];
  init_cells<NPL>(o0, W, h, e);
  int lb = 0, li = 0, lo = 0;

  auto forward = [&](auto with_bytes) {
    constexpr bool BYTES = decltype(with_bytes)::value;
    for (int i = 0; i < nrows; ++i) {
      // the previous row's h and e of the cell right of this lane's last
      int hn = __shfl_down_sync(kFull, h[0], 1, LPA);
      int en = __shfl_down_sync(kFull, e[0], 1, LPA);
      if (sl == LPA - 1) {
        hn = kNeg;
        en = kNeg;
      }
      int hd[NPL], ht[NPL], incl[NPL], eb[NPL];
      const int run = row_first<NPL, LOCAL>(sm + 8 * qs[i], rs + i + o0, h,
                                            e, hn, en, gq, ge, o0, hd, ht,
                                            incl, eb);
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
      const Wd w = row_second<NPL, LOCAL, BYTES, Wd>(
          excl, htl, fb0, h, e, hd, ht, incl, eb, o0, W, gr, ge,
          BYTES && dcell != nullptr ? dcell + i * row_stride : nullptr,
          LOCAL ? i < rows : i == last, i, lb, li, lo);
      if (real) rowbits[i * LPA + sl] = w;
    }
  };
  if (bytes) {
    forward(std::true_type{});
  } else {
    forward(std::false_type{});
  }

  bv = lb;
  bi = li;
  bo = lo;
#pragma unroll
  for (int d = LPA / 2; d > 0; d >>= 1) {
    take_first_max(__shfl_xor_sync(kFull, bv, d, LPA),
                   __shfl_xor_sync(kFull, bi, d, LPA),
                   __shfl_xor_sync(kFull, bo, d, LPA), bv, bi, bo);
  }
}

// The block form's shared memory besides the matrices and the codes
struct BlockShared {
  int32_t h0[32], e0[32];     // previous row, first cell
  int32_t tot[32], ht[32];    // scan total, last htmp
  int32_t red[3][32];         // the argmax across warps
  int32_t c;                  // the walk's n_ops
};

// The forward pass of one alignment a block (the block form): thread tid
// (lane of warp, nw warps, nt threads) owns cells 8 tid .. 8 tid + 7 and
// word tid of each row of rowbits (row i at rowbits + i * nt); with `dcell`
// each in-band cell's byte at dcell + i * row_stride.  Two barriers a row:
// (A) after each warp's lane 0 publishes the previous row's h and e of its
// first cell, which lane 31 of the warp before needs for its last cell's E;
// (B) after each warp's lane 31 publishes its scan total and its last
// cell's htmp, which the warps after need for the F scan and for bit 3 of
// their first cell.  Leaves each warp's first maximum in s.red, after a
// barrier that also makes every thread's words visible to the block
// (block_first_max reduces them).
template <bool LOCAL>
__device__ __forceinline__ void block_forward(
    const int32_t* sm, const uint8_t* qs, const uint8_t* rs, int tid,
    int lane, int warp, int nw, int nt, int rows, int last, int nrows, int W,
    int gq, int gr, int ge, uint32_t* rowbits, uint8_t* dcell,
    long long row_stride, BlockShared& s) {
  constexpr int NPL = kBlockNPL;
  const int o0 = tid * NPL;
  const int fb0 = (kNeg - ge) > (kNeg - gr) ? 8 : 0;
  int h[NPL], e[NPL];
  init_cells<NPL>(o0, W, h, e);
  int lb = 0, li = 0, lo = 0;

  for (int i = 0; i < nrows; ++i) {
    if (lane == 0) {
      s.h0[warp] = h[0];
      s.e0[warp] = e[0];
    }
    __syncthreads();   // A
    int hn = __shfl_down_sync(kFull, h[0], 1);
    int en = __shfl_down_sync(kFull, e[0], 1);
    if (lane == 31) {
      hn = warp + 1 < nw ? s.h0[warp + 1] : kNeg;
      en = warp + 1 < nw ? s.e0[warp + 1] : kNeg;
    }
    int hd[NPL], ht[NPL], incl[NPL], eb[NPL];
    const int run = row_first<NPL, LOCAL>(sm + 8 * qs[i], rs + i + o0, h, e,
                                          hn, en, gq, ge, o0, hd, ht, incl,
                                          eb);
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
      s.tot[warp] = v;
      s.ht[warp] = ht[NPL - 1];
    }
    __syncthreads();   // B
    if (lane == 0 && warp > 0) htl = s.ht[warp - 1];
    // the max of the totals of the warps before this one
    int carry = lane < warp ? s.tot[lane] : kNeg;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      carry = max(carry, __shfl_xor_sync(kFull, carry, d));
    }
    excl = max(excl, carry);
    rowbits[static_cast<long long>(i) * nt + tid] =
        row_second<NPL, LOCAL, true, uint32_t>(
            excl, htl, fb0, h, e, hd, ht, incl, eb, o0, W, gr, ge,
            dcell != nullptr ? dcell + i * row_stride : nullptr,
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
    s.red[0][warp] = bv;
    s.red[1][warp] = bi;
    s.red[2][warp] = bo;
  }
  __syncthreads();   // also makes every thread's words visible to thread 0
}

// The block's first maximum from the warps' in s.red, in every lane of
// warp 0, which calls this
__device__ __forceinline__ void block_first_max(const BlockShared& s,
                                                int lane, int nw, int& bv,
                                                int& bi, int& bo) {
  bv = lane < nw ? s.red[0][lane] : 0;
  bi = lane < nw ? s.red[1][lane] : 0;
  bo = lane < nw ? s.red[2][lane] : 0;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    take_first_max(__shfl_xor_sync(kFull, bv, d),
                   __shfl_xor_sync(kFull, bi, d),
                   __shfl_xor_sync(kFull, bo, d), bv, bi, bo);
  }
}

// Groups of LPA lanes, one alignment each, 32 / LPA a warp, blockDim.x / 32
// warps a block.  Each group's shared memory (group_bytes from `stage`):
// its query codes (stage_q bytes), its corridor codes, then at codes_bytes
// its packed rows: all L (SMEM) or a chunk of kChunk (the global route,
// whose rows go to gbits [S, L, LPA]).
template <int LPA, int NPL, bool LOCAL, bool SMEM>
__global__ void __launch_bounds__(kWarps * 32)
sw_align_kernel(const uint8_t* __restrict__ query,
                const int32_t* __restrict__ qlen,
                const uint8_t* __restrict__ corr,
                const int32_t* __restrict__ mats,
                const int32_t* __restrict__ msel, int S, int L, int W,
                int n_mats, int gq, int gr, int ge, int max_ops, int stage_q,
                int codes_bytes, int group_bytes, Word<NPL>* gbits,
                uint8_t* dirs, int32_t* __restrict__ out,
                uint8_t* __restrict__ ops, uint8_t* __restrict__ trunc) {
  using Wd = Word<NPL>;
  constexpr int WP = LPA * NPL;
  __shared__ int32_t smat[kMaxMats * 64];
  extern __shared__ __align__(16) uint8_t stage[];

  load_mats(smat, mats, n_mats, threadIdx.x, blockDim.x);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x / LPA;
  const int sl = lane % LPA;
  const int slot = blockIdx.x * (blockDim.x / LPA) + g;
  const bool real = slot < S;
  const int len = real ? qlen[slot] : 0;
  const int rows = len < 0 ? 0 : (len > L ? L : len);
  const int last = len - 1;   // glocal: the one row that competes
  const unsigned gmask =
      LPA == 32 ? kFull : (((1u << (LPA & 31)) - 1u) << (lane - sl));

  uint8_t* qs = stage + static_cast<long long>(g) * group_bytes;
  uint8_t* rs = qs + stage_q;
  Wd* buf = reinterpret_cast<Wd*>(qs + codes_bytes);
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

  const long long row_stride = static_cast<long long>(S) * W;
  uint8_t* dcell = (dirs != nullptr && real)
                       ? dirs + static_cast<long long>(slot) * W + sl * NPL
                       : nullptr;
  Wd* rowbits = SMEM ? buf
                     : (real ? gbits + static_cast<long long>(slot) * L * LPA
                             : nullptr);
  // every row when the bytes are asked for; else the warp's longest read
  const int nrows = dirs != nullptr ? L : __reduce_max_sync(kFull, rows);
  int bv, bi, bo;
  warp_forward<LPA, NPL, LOCAL>(sm, qs, rs, sl, real, rows, last, nrows, W,
                                gq, gr, ge, rowbits, dirs != nullptr, dcell,
                                row_stride, bv, bi, bo);
  __syncwarp();   // the group's words, visible to all its lanes
  if (!real) return;
  uint8_t* slot_ops = ops + static_cast<long long>(slot) * max_ops;
  const Aln a = walk_back<NPL, !SMEM, Wd>(
      rowbits, LPA, buf, gmask, sl, LPA, qs, rs, positive_mask(sm), W,
      max_ops, bv, bi, bo, sl == 0, slot_ops);
  if (sl == 0) store_aln(a, out, trunc, slot, S);
  for (int t = a.n_ops + sl; t < max_ops; t += LPA) slot_ops[t] = kOpNone;
}

// One alignment a block, for W > kMaxWarpBand (the global route): 32 * nw
// threads, thread t owning cells 8t .. 8t+7 and word t of each row of
// gbits [S, L, 32 * nw] (block_forward).
template <bool LOCAL>
__global__ void __launch_bounds__(kMaxBlockThreads)
sw_align_block_kernel(const uint8_t* __restrict__ query,
                      const int32_t* __restrict__ qlen,
                      const uint8_t* __restrict__ corr,
                      const int32_t* __restrict__ mats,
                      const int32_t* __restrict__ msel, int S, int L, int W,
                      int n_mats, int gq, int gr, int ge, int max_ops,
                      int stage_q, uint32_t* gbits, uint8_t* dirs,
                      int32_t* __restrict__ out, uint8_t* __restrict__ ops,
                      uint8_t* __restrict__ trunc) {
  constexpr int NPL = kBlockNPL;
  __shared__ int32_t smat[kMaxMats * 64];
  __shared__ BlockShared s;
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
  const long long row_stride = static_cast<long long>(S) * W;
  uint8_t* dcell = dirs != nullptr
                       ? dirs + static_cast<long long>(slot) * W + tid * NPL
                       : nullptr;
  uint32_t* rowbits = gbits + static_cast<long long>(slot) * L * nt;
  const int nrows = dirs != nullptr ? L : rows;
  block_forward<LOCAL>(sm, qs, rs, tid, lane, warp, nw, nt, rows, last,
                       nrows, W, gq, gr, ge, rowbits, dcell, row_stride, s);
  uint8_t* slot_ops = ops + static_cast<long long>(slot) * max_ops;
  if (warp == 0) {
    int bv, bi, bo;
    block_first_max(s, lane, nw, bv, bi, bo);
    if (lane == 0) {
      const Aln a = walk_back<NPL, false, uint32_t>(
          rowbits, nt, nullptr, 1u, 0, 1, qs, rs, positive_mask(sm), W,
          max_ops, bv, bi, bo, true, slot_ops);
      store_aln(a, out, trunc, slot, S);
      s.c = a.n_ops;
    }
  }
  __syncthreads();
  for (int t = s.c + tid; t < max_ops; t += nt) slot_ops[t] = kOpNone;
}

// ---------------------------------------------------------------------------
// The finish pass of the mapping steps: K4 with a prologue that reads the
// winner of each read straight from the step's tensors and an epilogue that
// writes MapResult's fields, one launch (after a 4-byte memset of the
// batch's overflow counter).
//
// Replaces, on a card, the body of the port's models/mapper.py::_finish,
// about 47 graph nodes around one K4 launch (three gathers of the winner,
// the second best's sub, abs, compare, select and reduction, the start's
// select and clamp, K2 (csrc/gather_windows.cu) into a [B, L + W] window
// buffer, the query's strand select over [B, L], then ~30 elementwise
// kernels of the filters, MAPQ, pos and proper), itself the port of the
// reference's XLA-fused nextgenmap_tpu/models/mapper.py:304 _finish.
// Bit-identical to its plain version, ops/finish_kernel.py::finish_plain,
// in every MapResult field.
//
// What bounds it: K4's (the note at the top); besides, a read's C
// candidates (4 + 4 + 1 bytes each, for the second best) and its [B]
// fields, about 2 MB at B 4096, under 1 us at 3.35 TB/s.
//
// Design: K4's own forward pass and walk (warp_forward, block_forward,
// walk_back), on K4's routes by the same shape rule (ngm_finish_plan), in
// kernels named sw_align_finish_*:
//   - prologue, one group a read (a block in the block form): the winner
//     a1[b]'s validity, corridor start and strand; the query staged from
//     the read or its reverse complement by the winner's strand; the
//     corridor staged straight from the genome at the start clamped to
//     [0, max(0, G - T)], 64-bit genome offsets, 4 past the genome's end,
//     as K2 gives them (the flattened [S x Gs] genome of the pooled shard
//     tail included); the winner's strand picks the matrix (bisulfite);
//   - after the rows, the second best: a max over the C candidates shared
//     by the group's lanes and reduced by shuffles;
//   - epilogue, the group's first lane after the walk: the winner read
//     again, the filters and MAPQ in float32 with round-to-nearest
//     operations and no contraction (__fdiv_rn, __fmul_rn, rintf: round
//     half to even, as the plain version's torch ops round), pos from the
//     raw (unclamped) start, and proper gated by mapped.  Nothing of the
//     prologue stays live through the row loop: kept in registers, the
//     winner's fields and the second best cost the loop ~10% more
//     instructions at [4096, 150] x W 56 (predicate spills, the shared
//     window's base recomputed every row), measured on an H100;
//   - the overflow counter: block 0 adds the step's count so far
//     (overflow[1]) and each truncated walk adds 1, integer atomics, exact
//     in any order.

constexpr int kOutFields = 11;   // strand, pos, mapq, score, second,
                                 // q_start, q_end, n_ops, matches,
                                 // mismatches, indels

// Everything the finish kernels read and write; see ngm_finish.
struct Finish {
  const int64_t* a1;           // [B] the chosen candidate of each read
  const int32_t* sw;           // [B, C]
  const int32_t* corr_start;   // [B, C]
  const int32_t* strand;       // [B, C]
  const uint8_t* cand_valid;   // [B, C] bool
  const uint8_t* genome;       // [G]
  long long G;
  const uint8_t* reads;        // [B, L]
  const uint8_t* rc;           // [B, L]
  const int32_t* lengths;      // [B]
  const int32_t* mats;         // [n_mats, 8, 8]
  const float* min_identity;   // []
  const float* min_residues;   // []
  const uint8_t* proper;       // [B] bool
  const int32_t* cmr_in;       // [] the step's cmr overflow so far
  int B, L, C, W, n_mats, gq, gr, ge, max_ops;
  int32_t* fields;             // [kOutFields, B]
  uint8_t* flags;              // [2, B] bool: mapped, proper
  uint8_t* ops;                // [B, max_ops]
  int32_t* cmr;                // [] zeroed before the launch
};

// dst[t] = min(genome[s + t], 5) while s + t < G and 4 past the genome's
// end for t < n, kPadCode for n <= t < n_pad; s in [0, G]: K2's window,
// staged as K4 stages it (csrc/sw_score.cu's score pass has the same).
__device__ __forceinline__ void stage_window(const uint8_t* genome,
                                             long long G, long long s, int n,
                                             uint8_t* dst, int n_pad, int sl,
                                             int lpa) {
  const int in = static_cast<int>(min(static_cast<long long>(n), G - s));
  stage_codes(genome + s, in, dst, in, sl, lpa);
  for (int t = in + sl; t < n_pad; t += lpa) dst[t] = t < n ? 4 : kPadCode;
}

// Read b's winner, candidate a1[b]: its validity, corridor start and
// strand.  The kernels read it twice, to stage the winner's query and
// corridor before the rows and again for the epilogue after them, so that
// nothing of it stays live through K4's row loop.
struct Winner {
  int start, strand;
  bool valid;
};

__device__ __forceinline__ Winner winner_of(const Finish& p, int b) {
  const long long a = static_cast<long long>(b) * p.C + p.a1[b];
  return Winner{p.corr_start[a], p.strand[a], p.cand_valid[a] != 0};
}

// The winner's corridor start: 0 for an invalid winner, clamped to
// [0, max(0, G - T)]
__device__ __forceinline__ long long corridor_start(const Finish& p,
                                                    const Winner& w) {
  const long long hi = max(0LL, p.G - (p.L + p.W));
  const long long s = w.valid ? w.start : 0;
  return s < 0 ? 0 : (s > hi ? hi : s);
}

// Read b's second best score: the max over all C candidates of sw[b, c]
// where |corr_start[b, c] - start| > L, and of 0 elsewhere.  The WIDTH
// lanes of a segment (lane sl in it) share the candidates; every lane of
// the warp calls this (the shuffles), only those of a real read read.
template <int WIDTH>
__device__ __forceinline__ int second_best(const Finish& p, int b, int sl,
                                           bool real) {
  int s2 = INT_MIN;
  if (real) {
    const long long row = static_cast<long long>(b) * p.C;
    const int start = p.corr_start[row + p.a1[b]];
    for (int c = sl; c < p.C; c += WIDTH) {
      const bool far = abs(p.corr_start[row + c] - start) > p.L;
      s2 = max(s2, far ? p.sw[row + c] : 0);
    }
  }
#pragma unroll
  for (int d = WIDTH / 2; d > 0; d >>= 1) {
    s2 = max(s2, __shfl_xor_sync(kFull, s2, d, WIDTH));
  }
  return s2;
}

// The filters, MAPQ and read b's MapResult fields, from its winner, its
// second best s2, its length and its alignment (one thread)
__device__ __forceinline__ void finish_read(const Finish& p, int b, int len,
                                            int s2, const Aln& a) {
  const Winner w = winner_of(p, b);
  const int s1 = w.valid ? a.score : 0;
  const float identity = __fdiv_rn(__int2float_rn(a.matches),
                                   __int2float_rn(max(a.n_ops, 1)));
  const float residues = __int2float_rn(a.q_end - a.q_start + 1);
  const float min_res_abs = __fmul_rn(*p.min_residues, __int2float_rn(len));
  const bool mapped = s1 > 0 && len > 0 && identity >= *p.min_identity &&
                      residues >= min_res_abs && !a.trunc;
  const float q = rintf(__fdiv_rn(__fmul_rn(60.0f, __int2float_rn(s1 - s2)),
                                  __int2float_rn(max(s1, 1))));
  const int mapq = mapped ? static_cast<int>(fminf(fmaxf(q, 0.0f), 60.0f)) : 0;
  // pos from the raw start, even when unmapped (consumers gate on mapped)
  const int vals[kOutFields] = {w.strand,  w.start + a.r_start, mapq,
                                s1,        s2,        a.q_start,
                                a.q_end,   a.n_ops,   a.matches,
                                a.mismatches, a.indels};
#pragma unroll
  for (int f = 0; f < kOutFields; ++f) {
    p.fields[f * static_cast<long long>(p.B) + b] = vals[f];
  }
  p.flags[b] = mapped ? 1 : 0;
  p.flags[p.B + b] = (mapped && p.proper[b] != 0) ? 1 : 0;
  if (a.trunc) atomicAdd(p.cmr, 1);
}

// The finish pass, warp form: K4's groups, one read each (sw_align_kernel's
// layout of shared memory and of gbits [B, L, LPA]).
template <int LPA, int NPL, bool LOCAL, bool SMEM>
__global__ void __launch_bounds__(kWarps * 32)
sw_align_finish_kernel(const Finish p, int stage_q, int codes_bytes,
                       int group_bytes, Word<NPL>* gbits) {
  using Wd = Word<NPL>;
  constexpr int WP = LPA * NPL;
  __shared__ int32_t smat[kMaxMats * 64];
  extern __shared__ __align__(16) uint8_t stage[];

  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(p.cmr, *p.cmr_in);
  load_mats(smat, p.mats, p.n_mats, threadIdx.x, blockDim.x);
  __syncthreads();

  const int L = p.L, W = p.W;
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x / LPA;
  const int sl = lane % LPA;
  const int b = blockIdx.x * (blockDim.x / LPA) + g;
  const bool real = b < p.B;
  const int len = real ? p.lengths[b] : 0;
  const int rows = len < 0 ? 0 : (len > L ? L : len);
  const int last = len - 1;   // glocal: the one row that competes
  const unsigned gmask =
      LPA == 32 ? kFull : (((1u << (LPA & 31)) - 1u) << (lane - sl));

  uint8_t* qs = stage + static_cast<long long>(g) * group_bytes;
  uint8_t* rs = qs + stage_q;
  Wd* buf = reinterpret_cast<Wd*>(qs + codes_bytes);
  const int nr = L + WP - 1;
  int st = 0;
  if (real) {
    const Winner w = winner_of(p, b);
    st = w.strand;
    stage_codes((st == 1 ? p.rc : p.reads) + static_cast<long long>(b) * L,
                L, qs, L, sl, LPA);
    stage_window(p.genome, p.G, corridor_start(p, w), min(nr, L + W), rs, nr,
                 sl, LPA);
  } else {
    stage_codes(p.reads, 0, qs, L, sl, LPA);
    stage_codes(p.reads, 0, rs, nr, sl, LPA);
  }
  __syncwarp();

  int m = (p.n_mats == 1 || !real) ? 0 : st;
  m = m < 0 ? 0 : (m >= p.n_mats ? p.n_mats - 1 : m);
  const int32_t* sm = smat + m * 64;
  Wd* rowbits = SMEM ? buf
                     : (real ? gbits + static_cast<long long>(b) * L * LPA
                             : nullptr);
  int bv, bi, bo;
  warp_forward<LPA, NPL, LOCAL>(sm, qs, rs, sl, real, rows, last,
                                __reduce_max_sync(kFull, rows), W, p.gq,
                                p.gr, p.ge, rowbits, false, nullptr, 0, bv,
                                bi, bo);
  __syncwarp();   // the group's words, visible to all its lanes
  const int s2 = second_best<LPA>(p, b, sl, real);
  if (!real) return;
  uint8_t* read_ops = p.ops + static_cast<long long>(b) * p.max_ops;
  const Aln a = walk_back<NPL, !SMEM, Wd>(
      rowbits, LPA, buf, gmask, sl, LPA, qs, rs, positive_mask(sm), W,
      p.max_ops, bv, bi, bo, sl == 0, read_ops);
  if (sl == 0) finish_read(p, b, len, s2, a);
  for (int t = a.n_ops + sl; t < p.max_ops; t += LPA) read_ops[t] = kOpNone;
}

// The finish pass, block form (W > kMaxWarpBand): one read a block
// (sw_align_block_kernel's layout, gbits [B, L, blockDim.x]); a launch of
// one block for B = 0 only adds the count.
template <bool LOCAL>
__global__ void __launch_bounds__(kMaxBlockThreads)
sw_align_finish_block_kernel(const Finish p, int stage_q, uint32_t* gbits) {
  constexpr int NPL = kBlockNPL;
  __shared__ int32_t smat[kMaxMats * 64];
  __shared__ BlockShared s;
  extern __shared__ __align__(16) uint8_t stage[];

  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nt >> 5;
  const int b = blockIdx.x;
  if (b == 0 && tid == 0) atomicAdd(p.cmr, *p.cmr_in);
  if (b >= p.B) return;   // block-uniform
  const int L = p.L, W = p.W;
  const int len = p.lengths[b];
  const int rows = len < 0 ? 0 : (len > L ? L : len);

  load_mats(smat, p.mats, p.n_mats, tid, nt);
  uint8_t* qs = stage;
  uint8_t* rs = stage + stage_q;
  const int nr = L + nt * NPL - 1;
  const Winner w = winner_of(p, b);
  stage_codes((w.strand == 1 ? p.rc : p.reads) + static_cast<long long>(b) * L,
              L, qs, L, tid, nt);
  stage_window(p.genome, p.G, corridor_start(p, w), min(nr, L + W), rs, nr,
               tid, nt);
  __syncthreads();

  int m = p.n_mats == 1 ? 0 : w.strand;
  m = m < 0 ? 0 : (m >= p.n_mats ? p.n_mats - 1 : m);
  const int32_t* sm = smat + m * 64;
  uint32_t* rowbits = gbits + static_cast<long long>(b) * L * nt;
  block_forward<LOCAL>(sm, qs, rs, tid, lane, warp, nw, nt, rows, len - 1,
                       rows, W, p.gq, p.gr, p.ge, rowbits, nullptr, 0, s);
  uint8_t* read_ops = p.ops + static_cast<long long>(b) * p.max_ops;
  if (warp == 0) {
    int bv, bi, bo;
    block_first_max(s, lane, nw, bv, bi, bo);
    const int s2 = second_best<32>(p, b, lane, true);
    if (lane == 0) {
      const Aln a = walk_back<NPL, false, uint32_t>(
          rowbits, nt, nullptr, 1u, 0, 1, qs, rs, positive_mask(sm), W,
          p.max_ops, bv, bi, bo, true, read_ops);
      finish_read(p, b, len, s2, a);
      s.c = a.n_ops;
    }
  }
  __syncthreads();
  for (int t = s.c + tid; t < p.max_ops; t += nt) read_ops[t] = kOpNone;
}

struct Args {
  const void *query, *qlen, *corr, *mats, *msel;
  int S, L, W, n_mats, gq, gr, ge, max_ops;
  void *scratch, *dirs, *out, *ops, *trunc;
};

// What a launch takes: the route, the layout, the block and its dynamic
// shared memory, how many such blocks an SM holds (0: the route cannot
// take the shape), and the route's capacity, the warps an SM holds at
// blocks of as many warps (up to kWarps) as fit: what the shape rule reads.
struct Plan {
  int route, lpa, npl, row_bytes, threads;
  long long smem;
  int blocks_per_sm, route_warps_per_sm;
};

struct Device {
  int id, n_sm;
};

// (lanes per alignment, cells per lane); LPA 0 is the block form
template <int LPA_, int NPL_>
struct Layout {
  static constexpr int LPA = LPA_, NPL = NPL_;
};

// f(K4's layout at W).  K4's (lanes per alignment, cells per lane) table:
// a sweep on an H100 (tools/kernel_ab.py, PERF.md) kept K1's values against
// half the lanes with twice the cells: those took 0.98x and 1.12x the time
// at [4096,100]xW48 and [2048,150]xW56 (smem), and 0.90-0.95x at
// [614,1000]xW184 (global), where their 64-bit rows (256 KB a warp) leave
// the smem route no room
template <typename F>
cudaError_t by_band(int W, F&& f) {
  if (W <= 16) return f(Layout<8, 2>{});
  if (W <= 32) return f(Layout<8, 4>{});
  if (W <= 48) return f(Layout<16, 3>{});
  if (W <= 64) return f(Layout<16, 4>{});
  if (W <= 96) return f(Layout<16, 6>{});
  if (W <= 128) return f(Layout<16, 8>{});
  if (W <= 192) return f(Layout<32, 6>{});
  if (W <= 256) return f(Layout<32, 8>{});
  if (W <= 384) return f(Layout<32, 12>{});
  if (W <= kMaxWarpBand) return f(Layout<32, 16>{});
  return f(Layout<0, kBlockNPL>{});
}

long long align_up(long long x, long long a) { return (x + a - 1) / a * a; }

int stage_q_bytes(int L) { return (L + 3) & ~3; }

// the shared memory of one group of the warp form at [*, L]: its query
// codes, its corridor codes, then at codes_bytes its packed rows, all L of
// them (the smem route) or a chunk of kChunk (the global route)
template <int LPA, int NPL>
struct WarpBytes {
  int L, codes_bytes, row_bytes;
  explicit WarpBytes(int L_)
      : L(L_),
        codes_bytes(static_cast<int>(align_up(
            stage_q_bytes(L_) + ((L_ + LPA * NPL + 3) & ~3), 16))),
        row_bytes(LPA * static_cast<int>(sizeof(Word<NPL>))) {}
  long long group(bool smem) const {
    return align_up(
        codes_bytes + static_cast<long long>(smem ? L : kChunk) * row_bytes,
        16);
  }
};

// the block form at W: 32 * ceil(W / 256) threads, its codes staged
int block_threads(int W) {
  return 32 * ((W + 32 * kBlockNPL - 1) / (32 * kBlockNPL));
}
long long block_smem(int L, int threads) {
  return stage_q_bytes(L) +
         align_up(static_cast<long long>(L) + threads * kBlockNPL, 4);
}

// The dynamic shared memory a block of `kern` may take on device `dev`:
// what the card grants a block past the kernel's static share.  Raises the
// kernel's own ceiling to it (above 48 KB), so that every launch a plan
// allows runs with no further attribute call.
template <typename Kernel>
cudaError_t smem_limit(Kernel kern, int dev, long long* limit) {
  int optin = 0;
  cudaFuncAttributes attr;
  *limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  *limit = optin - static_cast<long long>(attr.sharedSizeBytes);
  if (*limit <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*limit));
}

// blocks of `kern` an SM holds at `threads` threads and `smem` bytes of
// dynamic shared memory (0 where those do not fit one block)
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kern, int threads, long long smem,
                          long long limit, int* blocks) {
  *blocks = 0;
  if (threads < 32 || smem > limit) return cudaSuccess;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, threads, static_cast<size_t>(smem));
}

// The warp form's launch of `kern` for S alignments, `apw` a warp, at
// `per_warp` bytes of shared memory a warp: the route's capacity at as
// many warps a block as fit (up to kWarps); the launch then halves the
// warps a block while that spreads the warps over the SMs more evenly (614
// alignments of one warp: blocks of 4 leave 8 warps on some SMs, blocks of
// 1 at most 5).
template <typename Kernel>
cudaError_t plan_warps(Kernel kern, const Device& d, int S, int apw,
                       long long per_warp, Plan* p) {
  long long limit = 0;
  cudaError_t err = smem_limit(kern, d.id, &limit);
  if (err != cudaSuccess) return err;
  int nw = static_cast<int>(std::min<long long>(kWarps, limit / per_warp));
  if (nw < 1) {   // one warp's bytes; p->blocks_per_sm stays 0
    p->threads = 32;
    p->smem = per_warp;
    return cudaSuccess;
  }
  int cap = 0;
  err = blocks_per_sm(kern, 32 * nw, nw * per_warp, limit, &cap);
  if (err != cudaSuccess) return err;
  p->route_warps_per_sm = cap * nw;
  const long long warps = (static_cast<long long>(S) + apw - 1) / apw;
  const auto most = [&](int w) {   // warps on the fullest SM, in one wave
    return (((warps + w - 1) / w) + d.n_sm - 1) / d.n_sm * w;
  };
  while (nw > 1 && most(nw) > most(1)) nw /= 2;
  p->threads = 32 * nw;
  p->smem = nw * per_warp;
  return blocks_per_sm(kern, p->threads, p->smem, limit, &p->blocks_per_sm);
}

// The kernels of one layout: K4's (FINISH false) or the finish pass's
template <bool FINISH, int LPA, int NPL, bool LOCAL, bool SMEM>
auto warp_kernel() {
  if constexpr (FINISH) {
    return sw_align_finish_kernel<LPA, NPL, LOCAL, SMEM>;
  } else {
    return sw_align_kernel<LPA, NPL, LOCAL, SMEM>;
  }
}

template <bool FINISH, bool LOCAL>
auto block_kernel() {
  if constexpr (FINISH) {
    return sw_align_finish_block_kernel<LOCAL>;
  } else {
    return sw_align_block_kernel<LOCAL>;
  }
}

// The plan at one layout: the named route, or for route < 0 the shape
// rule's (the smem route where at least kMinSmemWarps of its warps fit on
// an SM), of K4's kernels or the finish pass's
template <bool FINISH, bool LOCAL, int LPA, int NPL>
cudaError_t plan_at(Layout<LPA, NPL>, const Device& d, int S, int L, int W,
                    int route, Plan* p) {
  if constexpr (LPA == 0) {
    const int threads = block_threads(W);
    *p = Plan{kRouteGlobal, threads, kBlockNPL, threads * 4, threads,
              block_smem(L, threads), 0, 0};
    // the block form's rows stay in global memory: no smem route
    if (route == kRouteSmem) return cudaSuccess;
    auto kern = block_kernel<FINISH, LOCAL>();
    long long limit = 0;
    cudaError_t err = smem_limit(kern, d.id, &limit);
    if (err == cudaSuccess) {
      err = blocks_per_sm(kern, threads, p->smem, limit, &p->blocks_per_sm);
    }
    p->route_warps_per_sm = p->blocks_per_sm * threads / 32;
    return err;
  } else {
    constexpr int APW = 32 / LPA;
    const WarpBytes<LPA, NPL> b(L);
    Plan ps{kRouteSmem, LPA, NPL, b.row_bytes, 0, 0, 0, 0};
    Plan pg{kRouteGlobal, LPA, NPL, b.row_bytes, 0, 0, 0, 0};
    cudaError_t err = cudaSuccess;
    if (route != kRouteGlobal) {
      err = plan_warps(warp_kernel<FINISH, LPA, NPL, LOCAL, true>(), d, S,
                       APW, APW * b.group(true), &ps);
      if (err != cudaSuccess) return err;
    }
    if (route < 0) {
      route = ps.route_warps_per_sm >= kMinSmemWarps ? kRouteSmem
                                                     : kRouteGlobal;
    }
    if (route == kRouteGlobal) {
      err = plan_warps(warp_kernel<FINISH, LPA, NPL, LOCAL, false>(), d, S,
                       APW, APW * b.group(false), &pg);
    }
    *p = route == kRouteSmem ? ps : pg;
    return err;
  }
}

// The launch at one layout, on the route and at the threads a block that
// the plan gave; grid and shared memory follow from them and the shape
template <bool LOCAL, int LPA, int NPL>
cudaError_t launch_at(Layout<LPA, NPL>, const Args& a, int route,
                      int threads, cudaStream_t st) {
  if (route == kRouteGlobal && a.scratch == nullptr) {
    return cudaErrorInvalidValue;
  }
  const int stage_q = stage_q_bytes(a.L);
  if constexpr (LPA == 0) {
    if (route != kRouteGlobal || threads != block_threads(a.W)) {
      return cudaErrorInvalidValue;
    }
    sw_align_block_kernel<LOCAL>
        <<<a.S, threads, static_cast<size_t>(block_smem(a.L, threads)), st>>>(
            static_cast<const uint8_t*>(a.query),
            static_cast<const int32_t*>(a.qlen),
            static_cast<const uint8_t*>(a.corr),
            static_cast<const int32_t*>(a.mats),
            static_cast<const int32_t*>(a.msel), a.S, a.L, a.W, a.n_mats,
            a.gq, a.gr, a.ge, a.max_ops, stage_q,
            static_cast<uint32_t*>(a.scratch), static_cast<uint8_t*>(a.dirs),
            static_cast<int32_t*>(a.out), static_cast<uint8_t*>(a.ops),
            static_cast<uint8_t*>(a.trunc));
  } else {
    constexpr int APW = 32 / LPA;
    const int nw = threads / 32;
    if (threads != 32 * nw || nw < 1 || nw > kWarps) {
      return cudaErrorInvalidValue;
    }
    const WarpBytes<LPA, NPL> b(a.L);
    const bool smem = route == kRouteSmem;
    const long long group = b.group(smem);
    const int apb = nw * APW;
    auto kern = smem ? sw_align_kernel<LPA, NPL, LOCAL, true>
                     : sw_align_kernel<LPA, NPL, LOCAL, false>;
    kern<<<(a.S + apb - 1) / apb, threads,
           static_cast<size_t>(apb * group), st>>>(
        static_cast<const uint8_t*>(a.query),
        static_cast<const int32_t*>(a.qlen),
        static_cast<const uint8_t*>(a.corr),
        static_cast<const int32_t*>(a.mats),
        static_cast<const int32_t*>(a.msel), a.S, a.L, a.W, a.n_mats, a.gq,
        a.gr, a.ge, a.max_ops, stage_q, b.codes_bytes,
        static_cast<int>(group), static_cast<Word<NPL>*>(a.scratch),
        static_cast<uint8_t*>(a.dirs), static_cast<int32_t*>(a.out),
        static_cast<uint8_t*>(a.ops), static_cast<uint8_t*>(a.trunc));
  }
  return cudaGetLastError();
}

// The finish pass's launch at one layout, as launch_at: a grid of at
// least one block, so that block 0 adds the count for B = 0 too
template <bool LOCAL, int LPA, int NPL>
cudaError_t launch_finish_at(Layout<LPA, NPL>, const Finish& p, int route,
                             int threads, void* scratch, cudaStream_t st) {
  if (route == kRouteGlobal && scratch == nullptr) {
    return cudaErrorInvalidValue;
  }
  const int stage_q = stage_q_bytes(p.L);
  if constexpr (LPA == 0) {
    if (route != kRouteGlobal || threads != block_threads(p.W)) {
      return cudaErrorInvalidValue;
    }
    sw_align_finish_block_kernel<LOCAL>
        <<<std::max(p.B, 1), threads,
           static_cast<size_t>(block_smem(p.L, threads)), st>>>(
            p, stage_q, static_cast<uint32_t*>(scratch));
  } else {
    constexpr int APW = 32 / LPA;
    const int nw = threads / 32;
    if (threads != 32 * nw || nw < 1 || nw > kWarps) {
      return cudaErrorInvalidValue;
    }
    const WarpBytes<LPA, NPL> b(p.L);
    const bool smem = route == kRouteSmem;
    const long long group = b.group(smem);
    const int apb = nw * APW;
    auto kern = smem ? sw_align_finish_kernel<LPA, NPL, LOCAL, true>
                     : sw_align_finish_kernel<LPA, NPL, LOCAL, false>;
    kern<<<std::max((p.B + apb - 1) / apb, 1), threads,
           static_cast<size_t>(apb * group), st>>>(
        p, stage_q, b.codes_bytes, static_cast<int>(group),
        static_cast<Word<NPL>*>(scratch));
  }
  return cudaGetLastError();
}

bool valid(int L, int W) { return W >= 1 && W <= kMaxBand && L >= 0; }

// ngm_sw_align_plan and ngm_finish_plan: the plan of K4's kernels or the
// finish pass's on the current device
template <bool FINISH>
int plan_entry(int S, int L, int W, int local, int route, int* out) {
  if (!valid(L, W) || S < 0 || route > kRouteGlobal) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Device d{0, 1};
  Plan p{};
  cudaError_t err = cudaGetDevice(&d.id);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&d.n_sm, cudaDevAttrMultiProcessorCount,
                                 d.id);
  }
  if (err == cudaSuccess) {
    err = by_band(W, [&](auto lay) {
      return local != 0 ? plan_at<FINISH, true>(lay, d, S, L, W, route, &p)
                        : plan_at<FINISH, false>(lay, d, S, L, W, route, &p);
    });
  }
  const int vals[8] = {p.route, p.lpa, p.npl, p.row_bytes, p.threads,
                       static_cast<int>(p.smem), p.blocks_per_sm,
                       p.route_warps_per_sm};
  for (int f = 0; f < 8; ++f) out[f] = vals[f];
  return static_cast<int>(err);
}

}  // namespace

// The plan of a call of S alignments at [S, L] x W on the current device,
// the one place that decides a launch: route < 0 for the shape rule's pick,
// 0 to force the smem route, 1 the global route.  out[8] = route (0 smem,
// 1 global), lanes per alignment (threads in the block form), cells per
// lane, bytes of one alignment's packed row (the global route's scratch is
// S * L of them), threads a block, dynamic shared memory a block, blocks
// of that size an SM holds (0: the route cannot take the shape), and the
// route's capacity in warps an SM (the shape rule's measure).  Raises the
// kernel's shared-memory ceiling on this device, which ngm_sw_align needs.
extern "C" int ngm_sw_align_plan(int S, int L, int W, int local, int route,
                                 int* out) {
  return plan_entry<false>(S, L, W, local, route, out);
}

// query [S, L] uint8, qlen [S] int32, corr [S, L + W] uint8,
// mats [n_mats, 8, 8] int32, msel [S] int32 (clamped to [0, n_mats)); local
// != 0 for local mode, 0 for glocal; route 0 (smem) or 1 (global) and
// `threads` a block, as ngm_sw_align_plan gave them on this device for S,
// L, W and the mode.  scratch: the global route's packed rows,
// S * L * row_bytes (plan) bytes, else unused; dirs: null, or [L, S, W]
// uint8 for the plain version's direction bytes.  Writes out [9, S] int32
// (score, q_start, q_end, r_start, r_end, n_ops, matches, mismatches,
// indels), ops [S, max_ops] uint8 and trunc [S] bool.  1 <= W <= 8192,
// 1 <= n_mats <= 8, max_ops >= 1.  A route or block the plan would not
// give returns an error and runs nothing.
extern "C" int ngm_sw_align(const void* query, const void* qlen,
                            const void* corr, const void* mats,
                            const void* msel, int S, int L, int W, int n_mats,
                            int gq, int gr, int ge, int local, int max_ops,
                            int route, int threads, void* scratch, void* dirs,
                            void* out, void* ops, void* trunc, void* stream) {
  if (!valid(L, W) || n_mats < 1 || n_mats > kMaxMats || max_ops < 1 ||
      (route != kRouteSmem && route != kRouteGlobal)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{query, qlen, corr, mats, msel, S, L, W, n_mats, gq, gr, ge,
               max_ops, scratch, dirs, out, ops, trunc};
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_band(W, [&](auto lay) {
    return local != 0 ? launch_at<true>(lay, a, route, threads, st)
                      : launch_at<false>(lay, a, route, threads, st);
  }));
}

// The finish pass's plan for B reads at [B, L] x W on the current device:
// the shape rule's route for its kernels, out[8] as ngm_sw_align_plan's.
extern "C" int ngm_finish_plan(int B, int L, int W, int local, int* out) {
  return plan_entry<true>(B, L, W, local, -1, out);
}

// The finish pass (see its note above): a1 [B] int64 in [0, C); sw,
// corr_start and strand [B, C] int32, cand_valid [B, C] bool; genome [G]
// uint8; reads and rc [B, L] uint8; lengths [B] int32; mats [n_mats, 8, 8]
// int32 (the winner's strand picks one, clamped to [0, n_mats));
// min_identity and min_residues [] float32; proper [B] bool; cmr_in []
// int32; local != 0 for local mode, 0 for glocal; route and threads as
// ngm_finish_plan gave them; scratch: the global route's packed rows, B * L
// * row_bytes bytes, else unused.  Zeroes cmr, then one launch writes
// fields [11, B] int32 (strand, pos, mapq, score, second, q_start, q_end,
// n_ops, matches, mismatches, indels), flags [2, B] bool (mapped, proper),
// ops [B, L + W] uint8 and cmr [] int32 = cmr_in + the truncated walks.
// 1 <= W <= 8192, 1 <= n_mats <= 8, C >= 1.  A route or block the plan would
// not give returns an error and runs nothing.
extern "C" int ngm_finish(const void* a1, const void* sw,
                          const void* corr_start, const void* strand,
                          const void* cand_valid, const void* genome,
                          long long G, const void* reads, const void* rc,
                          const void* lengths, const void* mats,
                          const void* min_identity, const void* min_residues,
                          const void* proper, const void* cmr_in, int B,
                          int L, int C, int W, int n_mats, int gq, int gr,
                          int ge, int local, int route, int threads,
                          void* scratch, void* fields, void* flags, void* ops,
                          void* cmr, void* stream) {
  if (!valid(L, W) || n_mats < 1 || n_mats > kMaxMats || B < 0 || C < 1 ||
      G < 0 || (route != kRouteSmem && route != kRouteGlobal)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(cmr, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Finish p{static_cast<const int64_t*>(a1),
                 static_cast<const int32_t*>(sw),
                 static_cast<const int32_t*>(corr_start),
                 static_cast<const int32_t*>(strand),
                 static_cast<const uint8_t*>(cand_valid),
                 static_cast<const uint8_t*>(genome), G,
                 static_cast<const uint8_t*>(reads),
                 static_cast<const uint8_t*>(rc),
                 static_cast<const int32_t*>(lengths),
                 static_cast<const int32_t*>(mats),
                 static_cast<const float*>(min_identity),
                 static_cast<const float*>(min_residues),
                 static_cast<const uint8_t*>(proper),
                 static_cast<const int32_t*>(cmr_in), B, L, C, W, n_mats, gq,
                 gr, ge, L + W, static_cast<int32_t*>(fields),
                 static_cast<uint8_t*>(flags), static_cast<uint8_t*>(ops),
                 static_cast<int32_t*>(cmr)};
  return static_cast<int>(by_band(W, [&](auto lay) {
    return local != 0
               ? launch_finish_at<true>(lay, p, route, threads, scratch, st)
               : launch_finish_at<false>(lay, p, route, threads, scratch, st);
  }));
}
