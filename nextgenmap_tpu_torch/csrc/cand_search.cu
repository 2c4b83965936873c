// K6: candidate search for Hopper (sm_90a), one launch per call: from the
// read k-mers to the candidate buckets of every read.
//
// Replaces nextgenmap_tpu/ops/candidate.py:359 _compact_hits, :487
// _select_candidates and the bodies of :560 candidate_search_dual and :642
// candidate_search_canonical.  Those are not Pallas kernels: under jax.jit
// XLA fuses them into a few programs, which the port's plain version
// (nextgenmap_tpu_torch/ops/candidate.py) runs as about a hundred torch
// calls with two segmented sorts over [B, 2H].  Bit-identical to that plain
// version in every output, for each read b:
//   1. look every k-mer column up: packed (int64 entry pw, o0 = pw >> 6,
//      cnt = pw & 63) or plain CSR (int32, cnt = off[km + 1] - off[km], 0
//      above max_freq); cnt = 0 where !ok.  In the dual form the columns
//      interleave (even: forward k-mer q = c / 2, odd: the rc's), and with
//      table_split the odd columns look up the second half of the table
//   2. fanout_overflow += (cnt > K); cnt = min(cnt, K)
//   3. the first H hits in column order: slot h < min(total, H) belongs to
//      the last column q with cum[q] <= h (cum the exclusive prefix sum of
//      the counts), its position positions[o0[q] - cum[q] + h];
//      hit_overflow counts the reads with total > H
//   4. strand and diagonal: canonical strand = flip[q] ^ (pos & 1), p =
//      pos >> 1, diag = p - q * stride, or p - (len - k - q * stride) on
//      the reverse strand; dual strand = q & 1, diag = pos - (q >> 1) *
//      stride
//   5. vote = strand * 2^28 + (diag >> diag_bin_log2) + 2^16; a hit votes
//      2 vote + 1 (direct) and 2 (vote - 1) (merge); an empty slot
//      SENTINEL twice (2H votes)
//   6. the votes sorted ascending; a run of equal v >> 1 whose last element
//      is odd scores its length there (key), every other position 0; best
//      = the largest key
//   7. thresh = max(1, ceil(float(best) * sensitivity)) in float32, the
//      sensitivity read from the device; cmr_overflow counts the reads with
//      more than C keys >= thresh
//   8. the first C + 1 eligible keys by key descending, ties to the lower
//      position in the sorted votes (torch.sort(stable=True), lax.top_k):
//      bucket, strand and score of ranks < min(C, 2H), SENTINEL / 0 / 0
//      where there is none; best_score; extra_score = the (C + 1)-th key
//      (0 when there is none)
// The three counters are int32 atomics into a buffer the launch zeroes
// (a memset node under graph capture), exact in any order.  All 32-bit
// arithmetic of the votes is done in uint32, the bits of the plain
// version's wrapping int32.
//
// What bounds it on the card: bytes moved, as random 8-byte (packed) or
// 4-byte (CSR) loads of the offsets table (one per k-mer column, B x Q or
// B x 2Q) and 4-byte loads of the hit positions (up to H a read), beside
// the k-mers in and the candidates out: at the main path's 4096 x 44
// packed, H 128, under 4 MB, ~1 us at 3.35 TB/s.  A random load is a 32-byte
// sector, so the real floor is sectors, and before that the latency of two
// dependent random loads a read (the offsets entry, then the positions).
// The integer work (a sort of 2 x min(total, H) votes, the run keys, the
// selection) is small beside it at the main path's sizes.
//
// Design: one read per group of T threads, its whole search in one pass:
//   - T = 32 (a warp; 4 reads a block) while the padded vote array Np =
//     next_pow2(2H) <= 1024, T = 128 up to 4096, else 256; the group
//     synchronises with __syncwarp or __syncthreads;
//   - the lookups: thread t takes columns t, t + T, ...: each issues all
//     its offsets loads before the scan uses any; the counts and o0 go to
//     shared memory;
//   - the exclusive scan: each thread sums a contiguous chunk of columns,
//     a warp (and block) scan of the chunk sums, then each rewrites its
//     chunk; base[q] = o0[q] - cum[q];
//   - the votes of the 2 min(total, H) real slots, a binary search over
//     cum for each slot's owner, then a bitonic sort over the next power of
//     two above them only (empty slots are SENTINEL, already last in the
//     order, so the sorted prefix is the plain version's);
//   - each run's key at its last element, its start from a binary search
//     for the first element of its v >> 1 (the plain version's cummax of
//     run starts);
//   - the top C + 1 by repeated argmax of (key << 32 | ~position) over the
//     eligible keys, min(eligible, C + 1) rounds (typically 1 to 5), each
//     taken key zeroed by the thread that owns its position.
// Two routes, from one rule (ngm_cand_search_plan): "smem" keeps the Np
// votes and keys in shared memory (8 Np bytes a read, up to what a block
// can hold: H <= 8192 with short reads); "global" keeps them in a scratch
// of 2 Np int32 a block that the caller allocates, for any larger H, with
// a grid of at most 4 blocks an SM that strides over the reads.  The
// per-column arrays (12 bytes a column) are in shared memory on both.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

using ull = unsigned long long;

constexpr int kSentinel = 0x7fffffff;
constexpr uint32_t kBias = 1u << 16;
constexpr int kStrandShift = 28;
constexpr int kPackCntBits = 6;
constexpr int kRouteSmem = 0, kRouteGlobal = 1;
constexpr int kMaxWarps = 8;      // warps a read at most (T <= 256)
constexpr int kWarpReads = 4;     // reads a block at T = 32
constexpr int kBlocksPerSm = 4;   // the global route's grid
constexpr int kPlanFields = 8;

struct Args {
  const int32_t* km0;     // canon, or the forward k-mers [B, Q]
  const int32_t* km1;     // flip, or the rc's k-mers [B, Q]
  const uint8_t* ok0;     // [B, Q]
  const uint8_t* ok1;     // the rc's [B, Q] (dual), else unused
  const int32_t* lengths; // [B] (canonical)
  const void* offsets;    // int64 packed or int32 CSR, n_off entries
  long long n_off;
  const int32_t* positions;
  long long n_pos;
  const float* sens;      // device scalar
  int B, Q, Qt, k, stride, K, H, C, Cw, Np, dbl, max_freq;
  bool dual, packed, table_split;
  int32_t* bucket;        // [B, Cw]
  int32_t* score;         // [B, Cw]
  int32_t* strand;        // [B, Cw]
  int32_t* best;          // [B]
  int32_t* extra;         // [B]
  int32_t* counters;      // [3] fanout, hit, cmr overflow
  int32_t* scratch;       // global route: [grid, 2 Np]
};

long long align16(long long n) { return (n + 15) / 16 * 16; }

// one read's shared memory: base (int64 [Qt]), the reduction words
// (uint64 [kMaxWarps]), cum (int32 [Qt + 1]), then on the smem route the
// votes and keys (int32 [Np] each)
long long read_bytes(int Qt, int Np, bool smem) {
  return align16(8LL * Qt + 8LL * kMaxWarps + 4LL * (Qt + 1) +
                 (smem ? 8LL * Np : 0));
}

int threads_for(int Np) { return Np <= 1024 ? 32 : (Np <= 4096 ? 128 : 256); }

__host__ __device__ int pow2_at_least(long long n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <int T>
__device__ __forceinline__ void group_sync() {
  if constexpr (T == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

struct Max {
  __device__ ull operator()(ull a, ull b) const { return a > b ? a : b; }
};
struct Sum {
  __device__ ull operator()(ull a, ull b) const { return a + b; }
};

// the group's reduction of x (every thread gets it)
template <int T, typename Op>
__device__ ull group_reduce(ull x, ull* red, Op op) {
  for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(~0u, x, o));
  if constexpr (T == 32) {
    return x;
  } else {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    __syncthreads();    // the words of an earlier reduction are read
    if (lane == 0) red[w] = x;
    __syncthreads();
    x = red[0];
    for (int i = 1; i < T / 32; ++i) x = op(x, red[i]);
    return x;
  }
}

// the group's exclusive prefix sum of x in thread order, and its total
template <int T>
__device__ int group_excl_scan(int x, int* total, ull* red) {
  const int lane = threadIdx.x & 31;
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(~0u, inc, o);
    if (lane >= o) inc += y;
  }
  if constexpr (T == 32) {
    *total = __shfl_sync(~0u, inc, 31);
    return inc - x;
  } else {
    const int w = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 31) red[w] = static_cast<ull>(static_cast<uint32_t>(inc));
    __syncthreads();
    int off = 0, tot = 0;
    for (int i = 0; i < T / 32; ++i) {
      const int s = static_cast<int>(red[i]);
      if (i < w) off += s;
      tot += s;
    }
    *total = tot;
    return off + inc - x;
  }
}

template <int T>
__device__ void search_read(const Args& a, int b, long long* base, ull* red,
                            int* cum, int* votes, int* keys) {
  const int t = threadIdx.x;
  const int Qt = a.Qt;
  const long long row = static_cast<long long>(b) * a.Q;

  // 1-2. every column's lookup, issued before any is used
  int over = 0;
  for (int c = t; c < Qt; c += T) {
    const int q = a.dual ? c >> 1 : c;
    const bool rc = a.dual && (c & 1);
    const bool ok = __ldg((rc ? a.ok1 : a.ok0) + row + q) != 0;
    long long kw = ok ? __ldg((rc ? a.km1 : a.km0) + row + q) : 0;
    if (a.table_split && (c & 1)) kw += a.n_off / 2;
    long long o0 = 0;
    int cnt = 0;
    // an index outside the table (never from K5's k-mers) looks nothing
    // up; the plain version raises there
    if (a.packed) {
      if (kw >= 0 && kw < a.n_off) {
        const long long pw =
            __ldg(static_cast<const long long*>(a.offsets) + kw);
        o0 = static_cast<int>(pw >> kPackCntBits);
        cnt = ok ? static_cast<int>(pw & ((1 << kPackCntBits) - 1)) : 0;
      }
    } else if (kw >= 0 && kw + 1 < a.n_off) {
      const int32_t* off = static_cast<const int32_t*>(a.offsets) + kw;
      const int lo = __ldg(off), hi = __ldg(off + 1);
      o0 = lo;
      cnt = ok ? hi - lo : 0;
      if (cnt > a.max_freq) cnt = 0;     // repeat masking
    }
    over += cnt > a.K;
    cum[c] = min(cnt, a.K);
    base[c] = o0;
  }
  if (over > 0) atomicAdd(a.counters, over);
  group_sync<T>();

  // 3. exclusive prefix sum of the clamped counts: a chunk a thread
  const int ch = (Qt + T - 1) / T;
  const int c0 = min(t * ch, Qt), c1 = min(c0 + ch, Qt);
  int part = 0;
  for (int c = c0; c < c1; ++c) part += cum[c];
  int total = 0;
  int run = group_excl_scan<T>(part, &total, red);
  for (int c = c0; c < c1; ++c) {
    const int n = cum[c];
    cum[c] = run;
    base[c] -= run;
    run += n;
  }
  if (t == 0 && total > a.H) atomicAdd(a.counters + 1, 1);
  group_sync<T>();

  // 4-5. the votes of the real slots, then SENTINEL up to a power of two
  const int nv = min(total, a.H);
  const int M = 2 * nv;
  const int Mp = pow2_at_least(M);
  for (int h = t; h < nv; h += T) {
    int lo = 0, hi = Qt - 1;           // the last q with cum[q] <= h
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (cum[mid] <= h) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int q = lo;
    const long long pidx = base[q] + h;
    const int pe = pidx >= 0 && pidx < a.n_pos ? __ldg(a.positions + pidx) : 0;
    int strand, diag;
    if (a.dual) {
      strand = q & 1;
      diag = pe - (q >> 1) * a.stride;
    } else {
      strand = __ldg(a.km1 + row + q) ^ (pe & 1);
      const int p = pe >> 1, qoff = q * a.stride;
      diag = strand == 0 ? p - qoff : p - (__ldg(a.lengths + b) - a.k - qoff);
    }
    const uint32_t vote = static_cast<uint32_t>(strand) << kStrandShift;
    const uint32_t v = vote + static_cast<uint32_t>(diag >> a.dbl) + kBias;
    votes[2 * h] = static_cast<int>(2u * v + 1u);
    votes[2 * h + 1] = static_cast<int>(2u * (v - 1u));
  }
  for (int i = M + t; i < Mp; i += T) votes[i] = kSentinel;
  group_sync<T>();

  // 6. bitonic sort of votes[0, Mp), ascending
  for (int size = 2; size <= Mp; size <<= 1) {
    for (int st = size >> 1; st > 0; st >>= 1) {
      for (int i = t; i < (Mp >> 1); i += T) {
        const int lo = 2 * i - (i & (st - 1));
        const int hi = lo + st;
        const int x = votes[lo], y = votes[hi];
        if ((x > y) == ((lo & size) == 0)) {
          votes[lo] = y;
          votes[hi] = x;
        }
      }
      group_sync<T>();
    }
  }

  // the run keys: a run of equal v >> 1 ending in a direct vote scores its
  // length at its last element
  int kmax = 0;
  for (int i = t; i < M; i += T) {
    const int s = votes[i];
    const int sb = s >> 1;
    const bool end = i + 1 == Mp || (votes[i + 1] >> 1) != sb;
    int key = 0;
    if (end && sb != (kSentinel >> 1) && (s & 1)) {
      int lo = 0, hi = i;               // the run's first element
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((votes[mid] >> 1) < sb) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      key = i - lo + 1;
    }
    keys[i] = key;
    kmax = max(kmax, key);
  }
  const int best = static_cast<int>(group_reduce<T>(kmax, red, Max()));

  // 7. the threshold, in float32 as the plain version computes it
  const float th = ceilf(__fmul_rn(static_cast<float>(best), __ldg(a.sens)));
  const int thresh = static_cast<int>(fmaxf(th, 1.0f));
  int eligible = 0;
  for (int i = t; i < M; i += T) eligible += keys[i] >= thresh;
  const int n_cands =
      static_cast<int>(group_reduce<T>(eligible, red, Sum()));
  if (t == 0 && n_cands > a.C) atomicAdd(a.counters + 2, 1);

  // 8. the first C + 1 by key descending, ties to the lower position
  const long long out = static_cast<long long>(b) * a.Cw;
  const int rounds = min(n_cands, a.C + 1);
  int extra = 0;
  for (int r = 0; r < rounds; ++r) {
    ull mine = 0;
    for (int i = t; i < M; i += T) {
      const int key = keys[i];
      if (key >= thresh) {
        const ull v = (static_cast<ull>(key) << 32) |
                      (0xffffffffu - static_cast<uint32_t>(i));
        mine = v > mine ? v : mine;
      }
    }
    const ull win = group_reduce<T>(mine, red, Max());
    const int key = static_cast<int>(win >> 32);
    const int idx = static_cast<int>(0xffffffffu -
                                     static_cast<uint32_t>(win & 0xffffffffu));
    if (idx % T == t) keys[idx] = 0;    // taken: below any threshold
    if (r == a.C) {
      extra = key;
    } else if (t == 0) {
      const int tv = votes[idx] >> 1;
      const int st = tv >> kStrandShift;   // floor division by 2^28
      a.bucket[out + r] = static_cast<int>(
          static_cast<uint32_t>(tv) - (static_cast<uint32_t>(st) << kStrandShift) -
          kBias);
      a.strand[out + r] = st;
      a.score[out + r] = key;
    }
  }
  for (int r = rounds + t; r < a.Cw; r += T) {
    a.bucket[out + r] = kSentinel;
    a.strand[out + r] = 0;
    a.score[out + r] = 0;
  }
  if (t == 0) {
    a.best[b] = best;
    a.extra[b] = extra;
  }
  group_sync<T>();    // the next read reuses the arrays
}

template <int T, bool kSmem>
__global__ void __launch_bounds__(T == 32 ? 32 * kWarpReads : T)
cand_search_kernel(Args a, int per_read) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* mine = smem + static_cast<long long>(threadIdx.y) * per_read;
  long long* base = reinterpret_cast<long long*>(mine);
  ull* red = reinterpret_cast<ull*>(base + a.Qt);
  int* cum = reinterpret_cast<int*>(red + kMaxWarps);
  int* votes;
  if constexpr (kSmem) {
    votes = cum + a.Qt + 1;
  } else {
    votes = a.scratch + static_cast<long long>(blockIdx.x) * 2 * a.Np;
  }
  int* keys = votes + a.Np;
  const int R = blockDim.y;
  for (int b = blockIdx.x * R + threadIdx.y; b < a.B; b += gridDim.x * R) {
    search_read<T>(a, b, base, red, cum, votes, keys);
  }
}

using Kernel = void (*)(Args, int);

Kernel kernel_for(int T, bool smem) {
  switch (T) {
    case 32:
      return smem ? cand_search_kernel<32, true> : cand_search_kernel<32, false>;
    case 128:
      return smem ? cand_search_kernel<128, true>
                  : cand_search_kernel<128, false>;
    default:
      return smem ? cand_search_kernel<256, true>
                  : cand_search_kernel<256, false>;
  }
}

struct Plan {
  int route = kRouteSmem;
  int threads = 0;        // T, the threads of one read
  int reads = 0;          // reads a block (blockDim.y)
  int smem = 0;           // dynamic shared memory a block
  int blocks = 0;         // the grid
  int np = 0;             // the padded vote array of one read
  long long scratch = 0;  // int32 of the global route's scratch
  int limit = 0;          // the card's shared memory a block
};

// The one rule of a launch: route < 0 picks smem where a read's arrays fit
// a block, else global; 0 or 1 asks for that route.  With set_attr, raises
// the kernel's shared-memory ceiling where the launch takes over 48 KB.
cudaError_t make_plan(int B, int Q, int dual, int H, int route, bool set_attr,
                      Plan* p) {
  if (B < 0 || Q < 1 || H < 1 || H > (1 << 28) || route > kRouteGlobal) {
    return cudaErrorInvalidValue;
  }
  int dev = 0, n_sm = 1;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&p->limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const int Qt = dual ? 2 * Q : Q;
  p->np = pow2_at_least(2LL * H);
  p->threads = threads_for(p->np);
  const long long smem_read = read_bytes(Qt, p->np, true);
  const bool fits = smem_read <= p->limit;
  p->route = route < 0 ? (fits ? kRouteSmem : kRouteGlobal) : route;
  if (p->route == kRouteSmem) {
    if (!fits) return cudaErrorInvalidValue;
    p->reads = 1;
    if (p->threads == 32) {
      while (p->reads < kWarpReads && (p->reads + 1) * smem_read <= p->limit) {
        ++p->reads;
      }
    }
    p->smem = static_cast<int>(p->reads * smem_read);
    p->blocks = (B + p->reads - 1) / p->reads;
  } else {
    const long long cols = read_bytes(Qt, p->np, false);
    if (cols > p->limit) return cudaErrorInvalidValue;
    p->reads = 1;
    p->smem = static_cast<int>(cols);
    p->blocks = B < kBlocksPerSm * n_sm ? B : kBlocksPerSm * n_sm;
    p->scratch = 2LL * p->np * p->blocks;
  }
  // the ceiling goes to all the card grants, not to this launch's bytes: a
  // plan made earlier for a larger H stays launchable
  if (set_attr && p->smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel_for(p->threads, p->route == kRouteSmem),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p->limit);
  }
  return err;
}

}  // namespace

// The plan of a call on the current device for B reads of Q k-mer windows
// (dual: two strands, 2Q columns) at hit cap H: route < 0 for the rule's
// pick, 0 for smem, 1 for global.  out[8] = route, threads a read, reads a
// block, dynamic shared memory a block, blocks of the grid, the padded
// vote array Np, the global route's scratch (int32 elements: 2 Np a
// block) and the card's shared memory a block.  A route that cannot take
// the shape returns cudaErrorInvalidValue (out still filled).  Raises the
// kernel's shared-memory ceiling, which ngm_cand_search needs.
extern "C" int ngm_cand_search_plan(int B, int Q, int dual, int H, int route,
                                    long long* out) {
  Plan p;
  const cudaError_t err = make_plan(B, Q, dual, H, route, true, &p);
  const long long vals[kPlanFields] = {p.route, p.threads, p.reads, p.smem,
                                       p.blocks, p.np, p.scratch, p.limit};
  for (int f = 0; f < kPlanFields; ++f) out[f] = vals[f];
  return static_cast<int>(err);
}

// km0 [B, Q] int32 (canonical: canon; dual: the forward k-mers), km1 [B, Q]
// int32 (flip; dual: the rc's k-mers), ok0 / ok1 [B, Q] bool (ok1 dual
// only), lengths [B] int32 (canonical), offsets n_off entries (packed:
// int64; else int32 CSR), positions [n_pos] int32, sens a float32 on the
// device.  Writes bucket / score / strand [B, Cw] int32 with Cw = min(C,
// 2H), best / extra [B] int32 and counters [3] int32 (zeroed here).
// `route` and `threads` as ngm_cand_search_plan gave them for (B, Q,
// dual, H); scratch: the global route's, at least the plan's int32.  A
// launch the plan would not give returns an error and runs nothing.
extern "C" int ngm_cand_search(
    const void* km0, const void* km1, const void* ok0, const void* ok1,
    const void* lengths, const void* offsets, long long n_off,
    const void* positions, long long n_pos, const void* sens, int B, int Q,
    int dual, int k, int stride, int K, int H, int C, int dbl, int max_freq,
    int packed, int table_split, int route, int threads, void* scratch,
    long long scratch_ints, void* bucket, void* score, void* strand,
    void* best, void* extra, void* counters, void* stream) {
  if (route != kRouteSmem && route != kRouteGlobal) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  cudaError_t err = make_plan(B, Q, dual, H, route, false, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (threads != p.threads || C < 1 || K < 0 || stride < 1 || dbl < 0 ||
      dbl > 31 || n_off < 1 || (table_split && !dual) ||
      (route == kRouteGlobal && (scratch == nullptr ||
                                 scratch_ints < p.scratch))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(counters, 0, 3 * sizeof(int32_t), st);
  if (err != cudaSuccess || B == 0) return static_cast<int>(err);
  Args a;
  a.km0 = static_cast<const int32_t*>(km0);
  a.km1 = static_cast<const int32_t*>(km1);
  a.ok0 = static_cast<const uint8_t*>(ok0);
  a.ok1 = static_cast<const uint8_t*>(ok1);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.offsets = offsets;
  a.n_off = n_off;
  a.positions = static_cast<const int32_t*>(positions);
  a.n_pos = n_pos;
  a.sens = static_cast<const float*>(sens);
  a.B = B;
  a.Q = Q;
  a.Qt = dual ? 2 * Q : Q;
  a.k = k;
  a.stride = stride;
  a.K = K;
  a.H = H;
  a.C = C;
  a.Cw = C < 2LL * H ? C : 2 * H;
  a.Np = p.np;
  a.dbl = dbl;
  a.max_freq = max_freq;
  a.dual = dual != 0;
  a.packed = packed != 0;
  a.table_split = table_split != 0;
  a.bucket = static_cast<int32_t*>(bucket);
  a.score = static_cast<int32_t*>(score);
  a.strand = static_cast<int32_t*>(strand);
  a.best = static_cast<int32_t*>(best);
  a.extra = static_cast<int32_t*>(extra);
  a.counters = static_cast<int32_t*>(counters);
  a.scratch = static_cast<int32_t*>(scratch);
  const Kernel kern = kernel_for(p.threads, p.route == kRouteSmem);
  kern<<<p.blocks, dim3(p.threads, p.reads), static_cast<size_t>(p.smem),
         st>>>(a, p.smem / p.reads);
  return static_cast<int>(cudaGetLastError());
}
