"""Read-side k-mer extraction.

Port of ``nextgenmap_tpu/ops/kmer.py``: ``collapse_codes``,
``extract_kmers`` (one strand, optionally bisulfite-collapsed) and
``extract_kmers_canonical`` (their slice branches; the TPU's banded-matmul
backend computes the same values and is not ported).  Read k-mers are
enumerated at stride ``read_kmer_skip``.

Bisulfite collapse modes: "ct" hashes C as T (the forward pass: a
C->T-converted read still hits its locus in the CT-collapsed index); "ga"
hashes G as A (the reverse-complement pass: the rc of an original-bottom
read shows G->A against the forward genome).
"""

from __future__ import annotations

import torch

from nextgenmap_tpu_torch.io.encode import CODE_A, CODE_C, CODE_G, CODE_T

_COLLAPSED_FROM = {"ct": CODE_C, "ga": CODE_G}


def collapse_codes(c: torch.Tensor, collapse: str) -> torch.Tensor:
    """C as T ("ct"), G as A ("ga"), or the codes as they are ("none")."""
    if collapse == "ct":
        return torch.where(c == CODE_C, CODE_T, c)
    if collapse == "ga":
        return torch.where(c == CODE_G, CODE_A, c)
    if collapse != "none":
        raise ValueError(f"collapse must be none, ct or ga, got {collapse!r}")
    return c


def _windows(c: torch.Tensor, j: int, Q: int, stride: int) -> torch.Tensor:
    """Column j of every k-mer window: c[:, j + q*stride] for q < Q."""
    return c[:, j:j + (Q - 1) * stride + 1:stride]


def extract_kmers(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                  stride: int = 1, collapse: str = "none",
                  max_collapsed: int = 0):
    """Rolling k-mer values of one strand of a read batch.

    collapse: "none" | "ct" | "ga".  max_collapsed (bisulfite --bs-cutoff):
    drop k-mers with more than this many collapsed bases (C for "ct", G for
    "ga"); 0 = no limit.  Returns (kmers [B, Q] int32, valid [B, Q] bool)
    with Q = (L - k)//stride + 1; a window is invalid when it holds a
    non-ACGT code or runs past the read's true length.
    """
    B, L = codes.shape
    Q = max(1, (L - k) // stride + 1)
    c0 = codes.to(torch.int32)
    c = collapse_codes(c0, collapse)
    frm = _COLLAPSED_FROM.get(collapse) if max_collapsed > 0 else None
    vals = torch.zeros((B, Q), dtype=torch.int32, device=c.device)
    ok = torch.ones((B, Q), dtype=torch.bool, device=c.device)
    ncoll = torch.zeros_like(vals)
    for j in range(k):
        w = _windows(c, j, Q, stride)
        vals = (vals << 2) | (w & 3)
        ok &= w < 4
        if frm is not None:
            ncoll += (_windows(c0, j, Q, stride) == frm).to(torch.int32)
    if frm is not None:
        ok &= ncoll <= max_collapsed
    qpos = torch.arange(Q, dtype=torch.int32, device=c.device)[None, :] * stride
    ok &= qpos + k <= lengths[:, None]
    return vals, ok


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
        w = _windows(c, j, Q, stride)
        vals = (vals << 2) | (w & 3)
        rvals = rvals | ((3 - (w & 3)) << (2 * j))
        ok &= w < 4
    qpos = torch.arange(Q, dtype=torch.int32, device=c.device)[None, :] * stride
    ok &= qpos + k <= lengths[:, None]
    flip = (rvals < vals).to(torch.int32)
    canon = torch.minimum(vals, rvals)
    return canon, flip, ok
