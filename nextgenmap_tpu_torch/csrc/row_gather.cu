// K3: same-shape gather-accumulate along a row or a column, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of tools/probe_dyngather.py (`kern`, reached
// through pl.pallas_call at :51), a capability probe of Mosaic's
// tpu.dynamic_gather.  On int32 [R, W] arrays x and idx it computes
//   out[r, j] = sum_{i < rep} x[r, g_i]   (dim 1)   or   x[g_i, j]   (dim 0),
//   g_i = (idx[r, j] + 7 i) mod extent,  extent = W (dim 1) or R (dim 0),
// with the sum wrapping in int32 as the TPU's does.  The modulo is floored,
// so any index is served; the probe's indices lie in [0, extent).
//
// What bounds it on the card: the gathered loads, rep of them per output
// element.  The TPU probe asked whether a dynamic gather ran at vector
// rate; on the card a gather is an ordinary load, so the design keeps the
// gathered loads off device memory:
//   dim 1: one block per row stages the row of x in shared memory (W * 4
//          bytes, dynamic shared memory above 48 KB, at most 227 KB), so
//          every gathered load is a shared-memory load whose bank conflicts
//          the indices decide; device memory sees x, idx and out once.  A
//          block has 1024 threads, one per output element up to W = 1024,
//          so two blocks fill an SM's 64 warps to hide the loads' latency.
//   dim 0: one thread per output element walks a column of x through the
//          read-only cache; x (1 MB at the probe's default 256 x 1024)
//          stays in the 50 MB L2.
// The index steps by 7 and wraps by subtraction, so no division is left in
// the inner loop.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // dim 0
constexpr int kRowThreads = 1024;  // dim 1

__device__ __forceinline__ long long floor_mod(long long v, long long m) {
  const long long r = v % m;
  return r < 0 ? r + m : r;
}

__global__ void __launch_bounds__(kRowThreads)
row_gather_dim1(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
                int W, int rep, int32_t* __restrict__ out) {
  extern __shared__ int32_t row[];
  const long long base = static_cast<long long>(blockIdx.x) * W;
  for (int j = threadIdx.x; j < W; j += kRowThreads) row[j] = x[base + j];
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += kRowThreads) {
    int g = static_cast<int>(floor_mod(idx[base + j], W));
    uint32_t acc = 0;  // unsigned: the int32 wrap without undefined behaviour
    for (int i = 0; i < rep; ++i) {
      acc += static_cast<uint32_t>(row[g]);
      g += 7;
      while (g >= W) g -= W;
    }
    out[base + j] = static_cast<int32_t>(acc);
  }
}

__global__ void __launch_bounds__(kThreads)
row_gather_dim0(const int32_t* __restrict__ x, const int32_t* __restrict__ idx,
                int R, int W, int rep, int32_t* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= W) return;
  const long long e = static_cast<long long>(blockIdx.y) * W + j;
  int g = static_cast<int>(floor_mod(idx[e], R));
  uint32_t acc = 0;
  for (int i = 0; i < rep; ++i) {
    acc += static_cast<uint32_t>(__ldg(x + static_cast<long long>(g) * W + j));
    g += 7;
    while (g >= R) g -= R;
  }
  out[e] = static_cast<int32_t>(acc);
}

}  // namespace

// x, idx, out: int32 [R, W] device pointers; dim 0 or 1.  The wrapper
// (ops/row_gather.py) checks the shapes: dim 1 needs W * 4 bytes of shared
// memory (<= 232448), dim 0 needs R <= 65535 (grid y).
extern "C" int ngm_row_gather(const void* x, const void* idx, int R, int W,
                              int rep, int dim, void* out, void* stream) {
  if (R > 0 && W > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* xp = static_cast<const int32_t*>(x);
    const int32_t* ip = static_cast<const int32_t*>(idx);
    int32_t* op = static_cast<int32_t*>(out);
    if (dim == 1) {
      const int smem = W * static_cast<int>(sizeof(int32_t));
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            row_gather_dim1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
      }
      row_gather_dim1<<<R, kRowThreads, smem, s>>>(xp, ip, W, rep, op);
    } else {
      const dim3 grid((W + kThreads - 1) / kThreads, R);
      row_gather_dim0<<<grid, kThreads, 0, s>>>(xp, ip, R, W, rep, op);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
