// K2: corridor window gather for Hopper (sm_90a).
//
// Replaces the TPU kernel nextgenmap_tpu/ops/gather_pallas.py::
// dma_gather_windows (_dma_gather, _kernel): for every start s,
//   out[w, j] = genome[s + j]  if s + j < G,  else 4 (pad code),
// with s clamped to [0, G] exactly as the plain version
// gather_windows(pad_table(genome, T, 4), starts, T) clamps it.
//
// What bounds it on the card: bytes.  Each window moves T bytes in and T
// bytes out and does no arithmetic; at the main path's sizes (2048-4096
// windows of T = 148) the whole gather is ~1.2 MB, so a single launch is
// bound by launch latency, and at larger sizes by device-memory bandwidth.
//
// Design: the TPU kernel needed a per-window DMA of a 32-row-aligned slab
// and two rotates because its loads had to follow the (32, 128) uint8 tile;
// the card has byte-addressable loads, so none of that survives, and the
// TPU's 897-byte window limit is gone too (any T).  Each block owns the
// contiguous output span of kWindowsPerBlock windows and its threads walk
// that span linearly: stores are fully coalesced, and the loads of
// neighbouring threads hit neighbouring genome bytes of the same window.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindowsPerBlock = 8;

__global__ void __launch_bounds__(kThreads)
gather_windows_kernel(const uint8_t* __restrict__ genome, long long G,
                      const int32_t* __restrict__ starts, long long n, int T,
                      uint8_t* __restrict__ out) {
  const long long w0 = static_cast<long long>(blockIdx.x) * kWindowsPerBlock;
  const long long nw = min(static_cast<long long>(kWindowsPerBlock), n - w0);
  const long long span = nw * T;
  uint8_t* dst = out + w0 * T;
  for (long long e = threadIdx.x; e < span; e += kThreads) {
    const long long w = e / T;
    const long long j = e - w * T;
    long long s = starts[w0 + w];
    s = s < 0 ? 0 : (s > G ? G : s);
    const long long g = s + j;
    dst[e] = g < G ? __ldg(genome + g) : static_cast<uint8_t>(4);
  }
}

}  // namespace

extern "C" int ngm_gather_windows(const void* genome, long long G,
                                  const void* starts, long long n, int T,
                                  void* out, void* stream) {
  if (n > 0 && T > 0) {
    const long long blocks = (n + kWindowsPerBlock - 1) / kWindowsPerBlock;
    gather_windows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(genome), G,
        static_cast<const int32_t*>(starts), n, T,
        static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ngm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
