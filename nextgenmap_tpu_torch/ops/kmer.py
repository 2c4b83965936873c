"""Read-side k-mer extraction.

Port of ``nextgenmap_tpu/ops/kmer.py::extract_kmers_canonical`` (its slice
branch; the TPU's banded-matmul backend computes the same values and is not
ported).  Read k-mers are enumerated at stride ``read_kmer_skip``.
"""

from __future__ import annotations

import torch


def extract_kmers_canonical(codes: torch.Tensor, lengths: torch.Tensor,
                            k: int, stride: int = 1):
    """Canonical k-mers of the FORWARD read.

    canonical = min(kmer, revcomp(kmer)), so one index lookup covers both
    strands.  Returns (canon [B, Q] int32, flip [B, Q] int32 1 where
    revcomp(kmer) < kmer, valid [B, Q] bool) with Q = (L - k)//stride + 1.
    A window is invalid when it holds a non-ACGT code or runs past the
    read's true length.
    """
    B, L = codes.shape
    Q = max(1, (L - k) // stride + 1)
    c = codes.to(torch.int32)
    vals = torch.zeros((B, Q), dtype=torch.int32, device=c.device)
    rvals = torch.zeros_like(vals)
    ok = torch.ones((B, Q), dtype=torch.bool, device=c.device)
    for j in range(k):
        w = c[:, j:j + (Q - 1) * stride + 1:stride]
        vals = (vals << 2) | (w & 3)
        rvals = rvals | ((3 - (w & 3)) << (2 * j))
        ok &= w < 4
    qpos = torch.arange(Q, dtype=torch.int32, device=c.device)[None, :] * stride
    ok &= qpos + k <= lengths[:, None]
    flip = (rvals < vals).to(torch.int32)
    canon = torch.minimum(vals, rvals)
    return canon, flip, ok
