"""Wrapper of K5, the read front end (``csrc/read_kmers.cu``).

Replaces ``nextgenmap_tpu/models/mapper.py::_pre_extract`` with
``nextgenmap_tpu/ops/kmer.py``'s ``extract_kmers_canonical`` and
``extract_kmers`` (XLA-fused code under jax.jit, not a Pallas kernel): the
left-shifted reverse complement of every read, and its canonical k-mers or
the k-mers of its two strands.  A CPU tensor goes to the plain version
(``read_kmers_plain``, the ops of ``ops/kmer.py``); a CUDA tensor goes to
the kernel, or the wrapper raises.  ``read_kmers.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from nextgenmap_tpu_torch.native import build
from nextgenmap_tpu_torch.ops.kmer import (
    extract_kmers, extract_kmers_canonical,
)

MAX_K = 16   # the 2-bit words fill 32 bits
# csrc/read_kmers.cu's forms
FORM_CANONICAL, FORM_STRANDS, FORM_BISULFITE = 0, 1, 2


def revcomp_batch(codes: torch.Tensor) -> torch.Tensor:
    """[B, L] reverse complement (PAD stays PAD)."""
    flipped = codes.flip(1)
    return torch.where(flipped < 4, 3 - flipped, flipped).to(codes.dtype)


def n_windows(L: int, k: int, stride: int) -> int:
    """Q, the k-mer windows of a read of L columns."""
    return max(1, (L - k) // stride + 1)


def read_kmers_plain(reads, lengths, *, k, stride=1, bs=False, bs_cutoff=0,
                     canonical=True):
    """The plain version: (rc, kms), rc the reverse complements shifted
    left by L - length, kms canonical (canon, flip, ok) or the two strands'
    (km_f, ok_f, km_r, ok_r), which bisulfite collapses C->T (forward) and
    G->A (reverse complement) with the --bs-cutoff drop."""
    B, L = reads.shape
    rc = revcomp_batch(reads)
    # the flip moves right-padding to the front of short reads: shift each
    # rc row left by (L - length) so it starts at column 0
    idx = torch.arange(L, device=reads.device)[None, :] + (L - lengths)[:, None]
    rc = torch.gather(torch.nn.functional.pad(rc, (0, L), value=4), 1, idx.long())
    if canonical and not bs:
        return rc, extract_kmers_canonical(reads, lengths, k, stride=stride)
    cut = bs_cutoff if bs else 0
    km_f, ok_f = extract_kmers(reads, lengths, k, stride=stride,
                               collapse="ct" if bs else "none",
                               max_collapsed=cut)
    km_r, ok_r = extract_kmers(rc, lengths, k, stride=stride,
                               collapse="ga" if bs else "none",
                               max_collapsed=cut)
    return rc, (km_f, ok_f, km_r, ok_r)


def _check(reads, lengths, k, stride) -> None:
    if reads.device.type not in ("cpu", "cuda"):
        raise ValueError(f"read_kmers: unsupported device {reads.device}")
    if lengths.device != reads.device:
        raise ValueError(f"read_kmers: lengths on {lengths.device}, reads "
                         f"on {reads.device}")
    if reads.dtype != torch.uint8 or reads.dim() != 2:
        raise ValueError(f"read_kmers: reads must be [B, L] uint8, got "
                         f"{reads.dtype} {tuple(reads.shape)}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != reads.shape[:1]:
        raise ValueError(f"read_kmers: lengths must be [{reads.shape[0]}] "
                         f"int32, got {lengths.dtype} {tuple(lengths.shape)}")
    if not (reads.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("read_kmers: reads and lengths must be contiguous")
    if not 1 <= k <= min(MAX_K, reads.shape[1]):
        raise ValueError(f"read_kmers: k {k} outside [1, min({MAX_K}, L = "
                         f"{reads.shape[1]})]")
    if stride < 1:
        raise ValueError(f"read_kmers: stride {stride} must be >= 1")


def read_kmers(reads: torch.Tensor, lengths: torch.Tensor, *, k: int,
               stride: int = 1, bs: bool = False, bs_cutoff: int = 0,
               canonical: bool = True):
    """(rc [B, L] uint8, kms) of reads [B, L] uint8 and lengths [B] int32
    (0 <= length <= L): kms canonical (canon, flip [B, Q] int32, ok [B, Q]
    bool) or, with `bs` or not `canonical`, (km_f, ok_f, km_r, ok_r) of the
    forward read and of the shifted rc, Q = max(1, (L - k) // stride + 1).
    Equal to ``read_kmers_plain`` in every element."""
    _check(reads, lengths, k, stride)
    if reads.device.type == "cpu":
        return read_kmers_plain(reads, lengths, k=k, stride=stride, bs=bs,
                                bs_cutoff=bs_cutoff, canonical=canonical)
    B, L = reads.shape
    Q = n_windows(L, k, stride)
    dev = reads.device
    rc = torch.empty((B, L), dtype=torch.uint8, device=dev)

    def i32():
        return torch.empty((B, Q), dtype=torch.int32, device=dev)

    def flag():
        return torch.empty((B, Q), dtype=torch.bool, device=dev)

    if canonical and not bs:
        form = FORM_CANONICAL
        kms = (i32(), i32(), flag())
        km0, aux, ok0 = kms
        km1 = ok1 = None
    else:
        form = FORM_BISULFITE if bs else FORM_STRANDS
        kms = (i32(), flag(), i32(), flag())
        km0, ok0, km1, ok1 = kms
        aux = None
    if B == 0:
        return rc, kms
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ngm_read_kmers(
            reads.data_ptr(), lengths.data_ptr(), B, L, Q, k, stride, form,
            bs_cutoff if bs else 0, rc.data_ptr(), km0.data_ptr(),
            None if aux is None else aux.data_ptr(), ok0.data_ptr(),
            None if km1 is None else km1.data_ptr(),
            None if ok1 is None else ok1.data_ptr(), stream)
    build.check(code, "read_kmers")
    read_kmers.launches += 1
    return rc, kms


read_kmers.launches = 0
