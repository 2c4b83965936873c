// K2: corridor window gather for Hopper (sm_90a).
//
// Replaces the TPU kernel nextgenmap_tpu/ops/gather_pallas.py::
// dma_gather_windows (_dma_gather, _kernel): for every start s,
//   out[w, j] = genome[s + j]  if s + j < G,  else 4 (pad code),
// with s clamped to [0, G] exactly as the plain version
// gather_windows(pad_table(genome, T, 4), starts, T) clamps it.  Any T >= 1.
//
// What bounds it on the card: bytes.  Each window reads T genome bytes and
// 4 bytes of its start and writes T bytes, with no arithmetic to speak of:
// the least time is (2 N T + 4 N) bytes over 3.35 TB/s, 0.18 us at the main
// path's 2048 x 148.  At that size a launch is far from any bandwidth limit:
// what the design can win is the latency chain of one block (a load of the
// starts, then the genome loads, then the stores), instructions per byte,
// and parallelism.
//
// Design: the output [N, T] is one flat byte array, cut into chunks of
// kChunk = 1024 bytes, one block of 128 threads each (296 blocks at
// 2048 x 148: more than two per SM).  A chunk starts at a multiple of 1024,
// so it is aligned whatever T is, and it touches at most kChunk / T + 2
// windows.
//   1. The block reads the starts of its windows once, clamps them and
//      keeps them in shared memory.
//   2. Thread t owns output bytes [8 t, 8 t + 8) of the chunk.  Its
//      (window, offset) pair costs one 32-bit division, then steps byte by
//      byte; its 8 genome loads are independent and in flight together (the
//      parent kernel did a 64-bit division, a reload and clamp of the start,
//      and one dependent load-store trip per byte).  Only the genome address
//      is 64-bit: G passes 2^31 for a human genome.
//   3. The 8 bytes leave in one 8-byte store (uint2); the last chunk's
//      ragged tail bytewise.  16 bytes a thread with one uint4 store timed
//      slower at every main-path shape in a side-by-side build on the card,
//      whether its 16 loads hung on one stepping chain or on two or four
//      independent ones, and 4 bytes a thread slower at T = 206 and 1184.
// The one 64-bit division left is the block's first window, b0 / T.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBytesPerThread = 8;                   // one 8-byte store
constexpr int kChunk = kThreads * kBytesPerThread;   // output bytes a block
constexpr int kMaxWindows = kChunk + 1;              // windows a chunk touches

__global__ void __launch_bounds__(kThreads)
gather_windows_kernel(const uint8_t* __restrict__ genome, long long G,
                      const int32_t* __restrict__ starts, int T,
                      long long total, uint8_t* __restrict__ out) {
  __shared__ long long s_start[kMaxWindows];

  const long long b0 = static_cast<long long>(blockIdx.x) * kChunk;
  const int span = static_cast<int>(min(static_cast<long long>(kChunk),
                                        total - b0));
  const long long w0 = b0 / T;
  const int j0 = static_cast<int>(b0 - w0 * T);
  const int n_win = (j0 + span + T - 1) / T;
  for (int t = threadIdx.x; t < n_win; t += kThreads) {
    const long long s = starts[w0 + t];
    s_start[t] = s < 0 ? 0 : (s > G ? G : s);
  }
  __syncthreads();

  const int e0 = threadIdx.x * kBytesPerThread;
  if (e0 >= span) return;
  int j = j0 + e0;
  int w = j / T;
  j -= w * T;
  long long s = s_start[w];
  uint32_t word[kBytesPerThread / 4] = {};
#pragma unroll
  for (int k = 0; k < kBytesPerThread; ++k) {
    if (e0 + k < span) {
      const long long g = s + j;
      const uint32_t b = g < G ? __ldg(genome + g) : 4u;
      word[k / 4] |= b << (8 * (k % 4));
      if (++j == T) {
        j = 0;
        ++w;
        if (e0 + k + 1 < span) s = s_start[w];
      }
    }
  }
  uint8_t* dst = out + b0 + e0;
  if (e0 + kBytesPerThread <= span) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(word[0], word[1]);
  } else {
    for (int k = 0; k < span - e0; ++k) {
      dst[k] = static_cast<uint8_t>(word[k / 4] >> (8 * (k % 4)));
    }
  }
}

}  // namespace

// genome [G] uint8, starts [n] int32, out [n, T] uint8 (8-byte aligned).
extern "C" int ngm_gather_windows(const void* genome, long long G,
                                  const void* starts, long long n, int T,
                                  void* out, void* stream) {
  if (n > 0 && T > 0) {
    if (reinterpret_cast<uintptr_t>(out) % 8 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    const long long total = n * T;
    const long long blocks = (total + kChunk - 1) / kChunk;
    gather_windows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(genome), G,
        static_cast<const int32_t*>(starts), T, total,
        static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ngm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
