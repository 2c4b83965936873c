// K3: same-shape gather-accumulate along a row or a column, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of tools/probe_dyngather.py (`kern`, reached
// through pl.pallas_call at :51), a capability probe of Mosaic's
// tpu.dynamic_gather.  On int32 [R, W] arrays x and idx it computes
//   out[r, j] = sum_{i < rep} x[r, g_i]   (dim 1)   or   x[g_i, j]   (dim 0),
//   g_i = (idx[r, j] + 7 i) mod extent,  extent = W (dim 1) or R (dim 0),
// with the sum wrapping in int32 as the TPU's does (a uint32 accumulator).
// The modulo is floored, so any index is served.
//
// What bounds it on the card.  Device memory sees x, idx and out once:
// 12 R W bytes over 3.35 TB/s (30.0 us at 4096 x 2048).  The gathers are
// rep R W loads; from shared memory without bank conflicts, one warp-wide
// load a clock on each SM, rep R W / (132 x 32 x 1.98 GHz) (32.1 us at
// 4096 x 2048, rep 32).  The two floors are close, so every variant but
// the last keeps the gathered loads in shared memory and its warps free of
// bank conflicts; the parent kernel gathered dim 0 from L2 (32 sectors a
// warp-wide load) and dim 1 from shared memory on random banks.
//
//   dim 1, "rotated" (W <= 56,615): a block serves a row, or a part of it
//     where rows are fewer than 4 x 132 (four blocks of 512 threads are
//     resident on an SM).  One thread starts two bulk asynchronous copies
//     (cp.async.bulk, completing on one mbarrier): the row and the block's
//     indices into shared memory.  The row is extended by 7 x 31 words, a
//     copy of its head, so the 32 gathers h + 7 v (v < 32) of a run never
//     wrap.  Their banks (h + 7 v) mod 32 are the 32 banks, each once,
//     because 7 is odd; a lane takes them in the order v = (s + u) mod 32,
//     u = 0, 1, ..., with s chosen so that h + 7 s falls on the lane's own
//     bank (s = 23 (lane - h) mod 32, as 7 x 23 = 1 mod 32).  At step u
//     lane L then reads bank L + 7 u: a warp is conflict-free at every
//     step, whatever its indices and whatever W, with no sort of the
//     outputs.  Integer addition mod 2^32 is order-free, so the sum is
//     exact.  Between runs h = (h + 224) mod W; the last rep mod 32
//     gathers go in index order.
//   dim 1, "staged" (56,615 < W <= 58,112): the extension and a chunk of
//     indices no longer fit beside the row, so the parent's kernel serves:
//     the row in shared memory, a thread per output, gathers in index
//     order.
//   dim 0, "strip" (R <= 56,544): a block stages a strip x[:, c0 : c0 + C]
//     in shared memory (cp.async, every load in flight at once), C the
//     widest of 32, 16, ..., 1 that fits with its extension: C = 32 to R
//     1,767, 16 to 3,534, 8 to 7,068, 4 to 14,136, 2 to 28,272, 1 to
//     56,544.  A warp serves Q = 32 / C output rows at a time: lane (q, j)
//     loads the index of row q's column j and stores its sum, so one
//     warp-wide load moves Q rows; for each of the Q rows, lane group q
//     sums the gathers i = q, q + Q, ... of column j, and a shuffle adds the
//     groups.  Strip row g lies on banks C (g mod Q) + j, and group q reads
//     rows g_0 + 7 q + 7 Q m: distinct banks across groups (7 is odd), and
//     they stay distinct through a wrap where R is a multiple of Q.  The
//     strip is extended by 7 Q x 7 rows, so 8 gathers run at fixed offsets
//     (224 words apart) without a wrap.  Each strip's output rows are split
//     over blocks only as far as the SMs have room for them.
//   dim 0, "walk" (R > 56,544, where one column and its extension no
//     longer fit): the parent's kernel, a thread per output walking its
//     column through L2.  This is a shape rule, not a fallback.
//
// The wrapper (ops/row_gather.py::plan) states the same rule in Python,
// where the CPU tests reach it; ngm_row_gather_plan returns this file's
// plan so that a card test holds the two equal.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxShared = 232448;   // the most a block may use
constexpr int kSMShared = 233472;    // an SM's shared memory; the runtime
constexpr int kCardSMs = 132;        // reserves 1 KB of it for each block

constexpr int kRun = 32;                 // gathers of a run, dim 1
constexpr int kExt = 7 * (kRun - 1);     // words a row is extended by
// dim 1, rotated
constexpr int kRotThreads = 512;
constexpr int kRotChunk = 2 * kRotThreads;   // outputs a block serves,
                                             // at the least
constexpr int kRotFixed = 1024;          // static shared memory, bounded
constexpr int kRotBlocks = 4 * kCardSMs;   // four resident an SM
// dim 0, strip
constexpr int kStripThreads = 1024;
constexpr int kStripRun = 8;             // gathers a lane group runs
constexpr int kStripExtWords = 7 * 32 * (kStripRun - 1);   // 7 Q (run-1) C
constexpr int kAhead = 8;                // row groups whose indices are in
                                         // flight
// the parent's kernels: dim 1 staged, dim 0 walk
constexpr int kRowThreads = 1024;
constexpr int kWalkThreads = 256;

enum Variant { kRotated = 0, kStaged = 1, kStrip = 2, kWalk = 3 };

// per_block: outputs of a row (rotated) or output rows (strip) that a block
// serves
struct Plan {
  int variant, strip, grid_x, grid_y, threads, shared, per_block;
};

int ceil_div(int a, int b) { return a / b + (a % b != 0); }

// -1 where the wrapper refuses the shape: dim 1 with a row past the shared
// memory, dim 0 with more rows than the grid's y axis takes.
int make_plan(int R, int W, int dim, Plan* p) {
  const int r1 = R > 1 ? R : 1, w1 = W > 1 ? W : 1;
  if (dim == 1) {
    if (W > kMaxShared / 4) return -1;
    const int stride = (W + kExt + 3) / 4 * 4;   // the row, 16-byte aligned
    const int room = (kMaxShared - kRotFixed) / 4 - stride;   // for indices
    if (room >= kRotChunk) {
      // a block serves `per` chunks of a row: all of it where rows fill
      // the card and the indices fit, else a part
      const int chunks = ceil_div(w1, kRotChunk);
      int parts = ceil_div(kRotBlocks, r1);
      parts = parts < chunks ? parts : chunks;
      const int least = ceil_div(chunks, room / kRotChunk);
      parts = parts > least ? parts : least;
      const int per = ceil_div(chunks, parts);
      const int span = per * kRotChunk;
      const int ids = span < (W + 3) / 4 * 4 ? span : (W + 3) / 4 * 4;
      *p = {kRotated, 0, R, ceil_div(chunks, per), kRotThreads,
            4 * (stride + ids), span};
    } else {
      *p = {kStaged, 0, R, 1, kRowThreads, 4 * W, 0};
    }
    return 0;
  }
  if (R > 65535) return -1;
  int C = 32;
  while (C > 1 && 4 * R * C + 4 * kStripExtWords > kMaxShared) C /= 2;
  const int shared = 4 * R * C + 4 * kStripExtWords;
  if (shared > kMaxShared) {
    *p = {kWalk, 0, ceil_div(w1, kWalkThreads), R, kWalkThreads, 0, 0};
    return 0;
  }
  const int strips = ceil_div(w1, C);
  int resident = kSMShared / (shared + 1024);
  resident = resident < 2 ? resident : 2;   // 2048 threads an SM
  int parts = ceil_div(kCardSMs * resident, strips);
  parts = parts < r1 ? parts : r1;
  const int rows = ceil_div(r1, parts);
  *p = {kStrip, C, strips, ceil_div(R, rows), kStripThreads, shared, rows};
  return 0;
}

__device__ __forceinline__ int floor_mod(int v, int m) {
  if (static_cast<unsigned>(v) < static_cast<unsigned>(m)) return v;
  const int r = v % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__global__ void __launch_bounds__(kRotThreads)
row_gather_dim1_rotated(const int32_t* __restrict__ x,
                        const int32_t* __restrict__ idx, int W, int rep,
                        int span, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];   // row, then indices
  __shared__ uint64_t bar;
  const int stride = (W + kExt + 3) / 4 * 4;
  int32_t* row = smem;
  int32_t* ids = smem + stride;
  const int t = threadIdx.x, lane = t & 31;
  const long long base = static_cast<long long>(blockIdx.x) * W;
  const int j_begin = static_cast<int>(blockIdx.y) * span;
  const int n = min(span, W - j_begin);   // outputs of this block
  const bool bulk = W % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(idx)) &
       15) == 0;
  if (bulk) {   // one thread starts both copies; the block waits on bar
    const uint32_t b = smem_addr(&bar);
    if (t == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(b) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(b), "r"(4 * (W + n)) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(smem_addr(row)), "l"(x + base), "r"(4 * W), "r"(b)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n"
          :: "r"(smem_addr(ids)), "l"(idx + base + j_begin), "r"(4 * n),
             "r"(b)
          : "memory");
    }
    __syncthreads();   // the barrier is initialised before anyone waits
    mbar_wait(b, 0);
  } else {
    for (int j = t; j < W; j += kRotThreads) row[j] = x[base + j];
    for (int j = t; j < n; j += kRotThreads) ids[j] = idx[base + j_begin + j];
    __syncthreads();
  }
  for (int e = t; e < kExt; e += kRotThreads) row[W + e] = row[e % W];
  __syncthreads();

  const int run_step = (7 * kRun) % W;   // h advances by 224 between runs
  for (int j = t; j < n; j += kRotThreads) {
    int h = floor_mod(ids[j], W);
    uint32_t acc = 0;   // unsigned: the int32 wrap without undefined behaviour
    int i = 0;
    for (; i + kRun <= rep; i += kRun) {
      const int s = (23 * (lane - h)) & 31;   // bank of h + 7 s = lane
      const int32_t* p = row + h;
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        acc += static_cast<uint32_t>(p[7 * ((s + u) & 31)]);
      }
      h += run_step;
      if (h >= W) h -= W;
    }
    const int32_t* p = row + h;
    for (int u = 0; u < rep - i; ++u) acc += static_cast<uint32_t>(p[7 * u]);
    out[base + j_begin + j] = static_cast<int32_t>(acc);
  }
}

template <int C>
__global__ void __launch_bounds__(kStripThreads)
row_gather_dim0_strip(const int32_t* __restrict__ x,
                      const int32_t* __restrict__ idx, int R, int W, int rep,
                      int rows_per_block, int32_t* __restrict__ out) {
  constexpr int Q = 32 / C;               // lane groups a warp
  constexpr int kGap = 7 * Q * C;         // words between a group's gathers
  constexpr int kExtRows = kStripExtWords / C;
  constexpr int kWarps = kStripThreads / 32;
  extern __shared__ __align__(16) int32_t strip[];   // (R + kExtRows) x C
  const int c0 = static_cast<int>(blockIdx.x) * C;
  const int cols = min(C, W - c0);
  for (int e = threadIdx.x; e < (R + kExtRows) * C; e += kStripThreads) {
    const int g = e / C, j = e % C;   // rows past R repeat the head
    if (j < cols) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(smem_addr(strip + e)),
                      "l"(x + static_cast<long long>(g < R ? g : g % R) * W
                          + c0 + j)
                   : "memory");
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int lane = threadIdx.x & 31, q = lane / C, j = lane % C;
  const int n = rep > q ? (rep - q + Q - 1) / Q : 0;   // this group's gathers
  const int first = 7 * q % R;
  const int run_rows = 7 * Q * kStripRun % R;   // a run's advance
  const int r0 = static_cast<int>(blockIdx.y) * rows_per_block;
  const int r1 = min(R, r0 + rows_per_block);
  // A warp serves the row groups rw, rw + stride, ...; the indices of its
  // next kAhead groups are in flight while it gathers.
  const int stride = kWarps * Q;
  const int rw = r0 + static_cast<int>(threadIdx.x) / 32 * Q;
  int fetch_rb = rw;
  auto fetch = [&]() {
    const int r = fetch_rb + q;
    fetch_rb += stride;
    return r < r1 && j < cols ? idx[static_cast<long long>(r) * W + c0 + j]
                              : 0;
  };
  int ahead[kAhead];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) ahead[a] = fetch();
  for (int rb = rw; rb < r1; rb += stride) {
    const int own = floor_mod(ahead[0], R);   // row rb + q, column j
#pragma unroll
    for (int a = 0; a + 1 < kAhead; ++a) ahead[a] = ahead[a + 1];
    ahead[kAhead - 1] = fetch();
    uint32_t kept = 0;
#pragma unroll 4
    for (int k = 0; k < Q; ++k) {   // row rb + k
      int g = __shfl_sync(~0u, own, k * C + j) + first;
      if (g >= R) g -= R;
      uint32_t acc = 0;
      int m = 0;
      for (; m + kStripRun <= n; m += kStripRun) {
        const int32_t* p = strip + g * C + j;
#pragma unroll
        for (int u = 0; u < kStripRun; ++u) {
          acc += static_cast<uint32_t>(p[u * kGap]);
        }
        g += run_rows;
        if (g >= R) g -= R;
      }
      const int32_t* p = strip + g * C + j;
      for (int u = 0; u < n - m; ++u) acc += static_cast<uint32_t>(p[u * kGap]);
#pragma unroll
      for (int d = C; d < 32; d <<= 1) acc += __shfl_xor_sync(~0u, acc, d);
      if (q == k) kept = acc;
    }
    if (rb + q < r1 && j < cols) {
      out[static_cast<long long>(rb + q) * W + c0 + j] =
          static_cast<int32_t>(kept);
    }
  }
}

// The parent's kernels, kept for the shapes the new ones cannot stage.
__global__ void __launch_bounds__(kRowThreads)
row_gather_dim1_staged(const int32_t* __restrict__ x,
                       const int32_t* __restrict__ idx, int W, int rep,
                       int32_t* __restrict__ out) {
  extern __shared__ int32_t row[];
  const long long base = static_cast<long long>(blockIdx.x) * W;
  for (int j = threadIdx.x; j < W; j += kRowThreads) row[j] = x[base + j];
  __syncthreads();
  const int step = 7 % W;
  for (int j = threadIdx.x; j < W; j += kRowThreads) {
    int g = floor_mod(idx[base + j], W);
    uint32_t acc = 0;
    for (int i = 0; i < rep; ++i) {
      acc += static_cast<uint32_t>(row[g]);
      g += step;
      if (g >= W) g -= W;
    }
    out[base + j] = static_cast<int32_t>(acc);
  }
}

__global__ void __launch_bounds__(kWalkThreads)
row_gather_dim0_walk(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ idx, int R, int W, int rep,
                     int32_t* __restrict__ out) {
  const int j = blockIdx.x * kWalkThreads + threadIdx.x;
  if (j >= W) return;
  const long long e = static_cast<long long>(blockIdx.y) * W + j;
  int g = floor_mod(idx[e], R);
  const int step = 7 % R;
  uint32_t acc = 0;
  for (int i = 0; i < rep; ++i) {
    acc += static_cast<uint32_t>(__ldg(x + static_cast<long long>(g) * W + j));
    g += step;
    if (g >= R) g -= R;
  }
  out[e] = static_cast<int32_t>(acc);
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int C>
cudaError_t launch_strip(const Plan& p, const int32_t* x, const int32_t* idx,
                         int R, int W, int rep, int32_t* out, cudaStream_t s) {
  const cudaError_t e = allow_shared(row_gather_dim0_strip<C>, p.shared);
  if (e != cudaSuccess) return e;
  row_gather_dim0_strip<C><<<dim3(p.grid_x, p.grid_y), p.threads, p.shared,
                             s>>>(x, idx, R, W, rep, p.per_block, out);
  return cudaSuccess;
}

}  // namespace

// The launch plan of an [R, W] call along dim: (variant, strip width, grid
// x, grid y, threads, dynamic shared bytes, per block), variants
// numbered rotated, staged, strip, walk.  Returns 0, or -1 for a shape
// ngm_row_gather refuses.
extern "C" int ngm_row_gather_plan(int R, int W, int dim, int* out) {
  Plan p;
  if (make_plan(R, W, dim, &p) != 0) return -1;
  const int v[7] = {p.variant, p.strip, p.grid_x, p.grid_y, p.threads,
                    p.shared, p.per_block};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// x, idx, out: int32 [R, W] device pointers; dim 0 or 1.  The wrapper
// (ops/row_gather.py) checks the shapes before it calls.
extern "C" int ngm_row_gather(const void* x, const void* idx, int R, int W,
                              int rep, int dim, void* out, void* stream) {
  Plan p;
  if (R <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  if (make_plan(R, W, dim, &p) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* xp = static_cast<const int32_t*>(x);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  int32_t* op = static_cast<int32_t*>(out);
  cudaError_t e = cudaSuccess;
  switch (p.variant) {
    case kRotated:
      e = allow_shared(row_gather_dim1_rotated, p.shared);
      if (e != cudaSuccess) return static_cast<int>(e);
      row_gather_dim1_rotated<<<dim3(p.grid_x, p.grid_y), p.threads,
                                p.shared, s>>>(xp, ip, W, rep, p.per_block,
                                               op);
      break;
    case kStaged:
      e = allow_shared(row_gather_dim1_staged, p.shared);
      if (e != cudaSuccess) return static_cast<int>(e);
      row_gather_dim1_staged<<<p.grid_x, p.threads, p.shared, s>>>(
          xp, ip, W, rep, op);
      break;
    case kWalk:
      row_gather_dim0_walk<<<dim3(p.grid_x, p.grid_y), p.threads, 0, s>>>(
          xp, ip, R, W, rep, op);
      break;
    default:
      switch (p.strip) {
        case 32: e = launch_strip<32>(p, xp, ip, R, W, rep, op, s); break;
        case 16: e = launch_strip<16>(p, xp, ip, R, W, rep, op, s); break;
        case 8: e = launch_strip<8>(p, xp, ip, R, W, rep, op, s); break;
        case 4: e = launch_strip<4>(p, xp, ip, R, W, rep, op, s); break;
        case 2: e = launch_strip<2>(p, xp, ip, R, W, rep, op, s); break;
        default: e = launch_strip<1>(p, xp, ip, R, W, rep, op, s); break;
      }
      if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
