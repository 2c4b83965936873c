// K5: the read front end for Hopper (sm_90a), one launch per call: the
// left-shifted reverse complement of every read and its k-mers.
//
// Replaces nextgenmap_tpu/models/mapper.py:85 _pre_extract with
// nextgenmap_tpu/ops/kmer.py:149 extract_kmers_canonical and :88
// extract_kmers.  That is not a Pallas kernel: under jax.jit XLA fuses it
// into a few programs, which the port's plain version
// (nextgenmap_tpu_torch/ops/kmer_kernel.py::read_kmers_plain) runs as some
// 140 small torch calls (a k-step Python loop of elementwise ops).
// Bit-identical to that plain version in every output element, the
// invalid windows too:
//   rc[b, p]   = 3 - c (c < 4) or c, for c = reads[b, len - 1 - p], p < len;
//                4 (PAD) for p >= len: the reverse complement shifted left
//                by L - len
//   canonical  (form 0): v = the k codes & 3 as a 2-bit word, r = its
//                reverse complement; canon = min(v, r), flip = r < v (as
//                int32), ok = every code < 4 and q * stride + k <= len
//   two strands (form 1, or 2 for bisulfite): the forward read's k-mers
//                and the shifted rc's, each with its own ok; form 2
//                collapses C as T in the forward and G as A in the rc
//                windows and, with a --bs-cutoff `cut` > 0, drops a window
//                with more than `cut` collapsed bases, counted in the
//                UNCOLLAPSED codes
// with Q = max(1, (L - k) / stride + 1) windows a read.  The 2-bit words
// are built in uint32 and stored as int32, the bits of the plain version's
// wrapping int32 shifts (k <= 16).
//
// What bounds it on the card: bytes.  It reads the B x L codes and the
// lengths once and writes B x L rc bytes and its k-mer arrays (canonical
// 9 bytes a window, two strands 10), about 3 MB at 4096 x 100: ~1 us at
// 3.35 TB/s.  Its integer work (k shifts, masks and compares a window) is
// a few hundred instructions a read, far below the card's rate.
//
// Design: one thread per (read, column), 256 a block over the flat
// [B, L]: thread p writes rc[b, p] and, for p < Q, window p's outputs.  A
// window reads its k codes straight from the read's row (L1 holds the
// row; the threads of one read share it), and the rc codes of a
// two-strand window are computed from the forward row, so the rc is never
// read back.  No shared memory, no synchronisation.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 4;
constexpr int kA = 0, kC = 1, kG = 2, kT = 3;
constexpr int kFormCanonical = 0, kFormStrands = 1, kFormBisulfite = 2;

// column p of the reverse complement shifted left by L - len
__device__ __forceinline__ int rc_code(const uint8_t* __restrict__ read,
                                       int L, int len, int p) {
  const int j = len - 1 - p;
  if (p >= len || j >= L) return kPad;
  const int c = __ldg(read + j);
  return c < 4 ? 3 - c : c;
}

template <int kForm>
__global__ void __launch_bounds__(kThreads)
read_kmers_kernel(const uint8_t* __restrict__ reads,
                  const int32_t* __restrict__ lengths, int L, int Q, int k,
                  int stride, int cut, long long total,
                  uint8_t* __restrict__ rc, int32_t* __restrict__ km0,
                  int32_t* __restrict__ aux, uint8_t* __restrict__ ok0,
                  int32_t* __restrict__ km1, uint8_t* __restrict__ ok1) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= total) return;
  const int b = static_cast<int>(e / L);
  const int p = static_cast<int>(e - static_cast<long long>(b) * L);
  const uint8_t* read = reads + static_cast<long long>(b) * L;
  const int len = __ldg(lengths + b);
  rc[e] = static_cast<uint8_t>(rc_code(read, L, len, p));
  if (p >= Q) return;
  const int q0 = p * stride;
  const bool fits = q0 + k <= len;
  const long long o = static_cast<long long>(b) * Q + p;
  if constexpr (kForm == kFormCanonical) {
    uint32_t v = 0, r = 0;
    bool ok = true;
    for (int j = 0; j < k; ++j) {
      const int w = __ldg(read + q0 + j);
      v = (v << 2) | static_cast<uint32_t>(w & 3);
      r |= static_cast<uint32_t>(3 - (w & 3)) << (2 * j);
      ok &= w < 4;
    }
    const int vi = static_cast<int>(v), ri = static_cast<int>(r);
    km0[o] = min(vi, ri);
    aux[o] = ri < vi ? 1 : 0;
    ok0[o] = ok && fits;
  } else {
    uint32_t vf = 0, vr = 0;
    bool okf = true, okr = true;
    int nf = 0, nr = 0;
    for (int j = 0; j < k; ++j) {
      const int cf = __ldg(read + q0 + j);
      const int cr = rc_code(read, L, len, q0 + j);
      int xf = cf, xr = cr;
      if constexpr (kForm == kFormBisulfite) {
        xf = cf == kC ? kT : cf;
        xr = cr == kG ? kA : cr;
        nf += cf == kC;
        nr += cr == kG;
      }
      vf = (vf << 2) | static_cast<uint32_t>(xf & 3);
      vr = (vr << 2) | static_cast<uint32_t>(xr & 3);
      okf &= xf < 4;
      okr &= xr < 4;
    }
    if (kForm == kFormBisulfite && cut > 0) {
      okf &= nf <= cut;
      okr &= nr <= cut;
    }
    km0[o] = static_cast<int>(vf);
    ok0[o] = okf && fits;
    km1[o] = static_cast<int>(vr);
    ok1[o] = okr && fits;
  }
}

}  // namespace

// reads [B, L] uint8 codes, lengths [B] int32 (0 <= len <= L).  Writes rc
// [B, L] uint8 and, with Q = max(1, (L - k) / stride + 1): form 0
// (canonical) km0 = canon [B, Q] int32, aux = flip [B, Q] int32, ok0 [B, Q]
// bool; form 1 (two strands) or 2 (two strands, bisulfite-collapsed, `cut`
// the --bs-cutoff or 0) km0/ok0 of the forward read and km1/ok1 of the
// shifted rc.  1 <= k <= 16, k <= L, stride >= 1.
extern "C" int ngm_read_kmers(const void* reads, const void* lengths, int B,
                              int L, int Q, int k, int stride, int form,
                              int cut, void* rc, void* km0, void* aux,
                              void* ok0, void* km1, void* ok1,
                              void* stream) {
  if (B < 0 || k < 1 || k > 16 || k > L || stride < 1 ||
      Q != max(1, (L - k) / stride + 1) || form < kFormCanonical ||
      form > kFormBisulfite) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(B) * L;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const auto blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  auto st = static_cast<cudaStream_t>(stream);
  auto kern = form == kFormCanonical ? read_kmers_kernel<kFormCanonical>
              : form == kFormStrands ? read_kmers_kernel<kFormStrands>
                                     : read_kmers_kernel<kFormBisulfite>;
  kern<<<blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(reads),
      static_cast<const int32_t*>(lengths), L, Q, k, stride, cut, total,
      static_cast<uint8_t*>(rc), static_cast<int32_t*>(km0),
      static_cast<int32_t*>(aux), static_cast<uint8_t*>(ok0),
      static_cast<int32_t*>(km1), static_cast<uint8_t*>(ok1));
  return static_cast<int>(cudaGetLastError());
}
