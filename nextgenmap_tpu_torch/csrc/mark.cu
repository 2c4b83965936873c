// Phase marks and score-pass counters of the port's tracing
// (utils/trace.py), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no tracing inside its jitted
// steps.  They exist so that a captured step graph can say, on the device's
// own clock, where its time goes, and how much work the score pass's slot
// cap and candidate search's hit cap left undone, without a host read
// inside the graph.
//
// ngm_mark_kernel<p>: one thread reads %globaltimer (ns) and folds it into
// an int64 accumulator buffer
//   acc[0]          the time of the last mark,
//   acc[1 + 2 p]    ns from the previous mark to this one, summed,
//   acc[2 + 2 p]    marks of phase p,
// for phase 0 (a step's start) only the time and the count.  The marks of
// one stream run one after the other, so a plain read-modify-write is
// safe.  The phase is a template argument, so a profiler's record names
// it: "ngm_mark_kernel<2>" is the end of the score pass.
//
// ngm_inner_mark_kernel<c>: the open (c 0) and close (c 1) marks of a phase
// inside another (the traceback inside the finish), on a chain of its own
// that the marks above never read or write:
//   chain[0]  the time of its last open mark,
//   chain[1]  ns from open to close, summed,
//   chain[2]  close marks.
// Its records never name a phase of ngm_mark_kernel.
//
// ngm_hit_counts_kernel: one thread adds candidate search's count of the
// reads whose hits passed the per-read cap H (an int32 on the device) to
// an int64 counter.
//
// ngm_score_counts_kernel: one block over a batch's reads; from n_sc (the
// real slots each read asks of the score pass) and base (their exclusive
// prefix sum) it adds to out[3]
//   out[0]  the slots asked for,       sum n_sc,
//   out[1]  the slots scored,          min(sum n_sc, S),
//   out[2]  reads left (partly) unscored: n_sc > 0 and base + n_sc > S.
//
// What bounds them: launch latency, a few microseconds each; the score
// counter kernel reads 8 bytes a read.  They run only in a graph captured while
// tracing is on.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kPhases = 5;
constexpr int kCountThreads = 256;

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

template <int kPhase>
__global__ void ngm_mark_kernel(long long* acc) {
  const long long t = global_ns();
  if (kPhase > 0) acc[1 + 2 * kPhase] += t - acc[0];
  acc[2 + 2 * kPhase] += 1;
  acc[0] = t;
}

template <int kClose>
__global__ void ngm_inner_mark_kernel(long long* chain) {
  const long long t = global_ns();
  if (kClose) {
    chain[1] += t - chain[0];
    chain[2] += 1;
  } else {
    chain[0] = t;
  }
}

__global__ void ngm_hit_counts_kernel(const int32_t* capped,
                                      long long* out) {
  *out += *capped;
}

__global__ void __launch_bounds__(kCountThreads)
ngm_score_counts_kernel(const int32_t* __restrict__ n_sc,
                        const int32_t* __restrict__ base, int B, int S,
                        long long* out) {
  __shared__ long long s_sum[kCountThreads / 32][2];
  long long asked = 0, late = 0;
  for (int b = threadIdx.x; b < B; b += kCountThreads) {
    const long long n = n_sc[b];
    asked += n;
    late += (n > 0 && base[b] + n > S) ? 1 : 0;
  }
  for (int d = 16; d > 0; d >>= 1) {
    asked += __shfl_down_sync(0xffffffffu, asked, d);
    late += __shfl_down_sync(0xffffffffu, late, d);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    s_sum[warp][0] = asked;
    s_sum[warp][1] = late;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asked = late = 0;
    for (int w = 0; w < kCountThreads / 32; ++w) {
      asked += s_sum[w][0];
      late += s_sum[w][1];
    }
    out[0] += asked;
    out[1] += asked < S ? asked : S;
    out[2] += late;
  }
}

}  // namespace

extern "C" int ngm_mark(void* acc, int phase, void* stream) {
  auto* a = static_cast<long long*>(acc);
  auto s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0: ngm_mark_kernel<0><<<1, 1, 0, s>>>(a); break;
    case 1: ngm_mark_kernel<1><<<1, 1, 0, s>>>(a); break;
    case 2: ngm_mark_kernel<2><<<1, 1, 0, s>>>(a); break;
    case 3: ngm_mark_kernel<3><<<1, 1, 0, s>>>(a); break;
    case 4: ngm_mark_kernel<4><<<1, 1, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kPhases == 5, "one case per phase");
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ngm_inner_mark(void* chain, int close, void* stream) {
  auto* c = static_cast<long long*>(chain);
  auto s = static_cast<cudaStream_t>(stream);
  if (close) {
    ngm_inner_mark_kernel<1><<<1, 1, 0, s>>>(c);
  } else {
    ngm_inner_mark_kernel<0><<<1, 1, 0, s>>>(c);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ngm_hit_counts(const void* capped, void* out, void* stream) {
  ngm_hit_counts_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(capped), static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ngm_score_counts(const void* n_sc, const void* base, int B,
                                int S, void* out, void* stream) {
  ngm_score_counts_kernel<<<1, kCountThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(n_sc), static_cast<const int32_t*>(base),
      B, S, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
