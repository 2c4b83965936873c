"""Wrapper of the finish pass (``csrc/sw_align.cu``:
``sw_align_finish_kernel``, or ``sw_align_finish_block_kernel`` past
W = 512), and the mapping steps' result, ``MapResult``.

Replaces the reference's ``nextgenmap_tpu/models/mapper.py::_finish``
(XLA-fused under jax.jit): the traceback of each read's chosen candidate,
then the filters and MAPQ.  A CPU tensor goes to the plain version
(``finish_plain``: torch gathers, K2's and K4's plain versions, the filters
and MAPQ in torch ops); a CUDA tensor goes to one launch of the kernel,
which reads the winner, stages its query and corridor straight from the
reads and the genome, runs K4's forward pass and walk, and writes every
field, or the wrapper raises.  ``finish_pass.launches`` counts the passes
launched on a card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from nextgenmap_tpu_torch.native import build
from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
from nextgenmap_tpu_torch.ops.sw_align_kernel import ROUTES, Plan, sw_align
from nextgenmap_tpu_torch.ops.sw_kernel import MAX_BAND, MAX_MATS
from nextgenmap_tpu_torch.ops.sw_ref import check_mode

I32 = torch.int32
N_OUT = 11   # kOutFields in csrc/sw_align.cu: the int32 fields, one row each


class MapResult(NamedTuple):
    """Per-read mapping outcome (all tensors [B] unless noted)."""

    mapped: torch.Tensor      # bool
    strand: torch.Tensor      # int32 0 fwd / 1 rev
    pos: torch.Tensor         # int32 absolute genome position of first aligned base
    mapq: torch.Tensor        # int32 0..60
    score: torch.Tensor       # int32 best SW score
    second: torch.Tensor      # int32 second-best (different locus) SW score
    q_start: torch.Tensor     # int32 first aligned base in ALIGNED orientation
    q_end: torch.Tensor       # int32 last aligned base (inclusive)
    ops: torch.Tensor         # [B, MO] uint8 traceback ops END->START
    n_ops: torch.Tensor       # int32
    matches: torch.Tensor     # int32
    mismatches: torch.Tensor  # int32
    indels: torch.Tensor      # int32
    n_candidates: torch.Tensor  # int32 CMRs for this read
    proper: torch.Tensor      # bool, paired runs only (False for single-end)
    fanout_overflow: torch.Tensor  # [] int32
    cmr_overflow: torch.Tensor     # [] int32


def mapq_of(s1, s2, mapped):
    """MAPQ: 60 (s1 - s2) / s1 in float32, rounded half to even as the
    reference, in [0, 60]; 0 where not `mapped`."""
    f32 = torch.float32
    mapq = torch.round(60.0 * (s1 - s2).to(f32) / s1.clamp(min=1).to(f32))
    return torch.where(mapped, mapq.clamp(0, 60).to(I32), 0)


def filters_and_mapq(score, second, matches, n_ops, q_start, q_end, lengths,
                     trunc, min_identity, min_residues):
    """(mapped, mapq) of traced-back alignments: mapped where the score is
    positive, the read not empty, the identity (matches over the
    alignment's columns) at least min_identity, the aligned residues at
    least min_residues of the read, and the op buffer not truncated (an
    overflow leaves the CIGAR incomplete: never emit it)."""
    f32 = torch.float32
    identity = matches.to(f32) / n_ops.clamp(min=1).to(f32)
    residues = (q_end - q_start + 1).to(f32)
    mapped = (
        (score > 0)
        & (lengths > 0)
        & (identity >= min_identity)
        & (residues >= min_residues * lengths.to(f32))
        & ~trunc
    )
    return mapped, mapq_of(score, second, mapped)


def finish_plain(a1, sw, corr_start, strand, cand_valid, genome, reads, rc,
                 lengths, matrices, gopen_q, gopen_r, gext, min_identity,
                 min_residues, n_cands, overflow, proper, *, band,
                 mode="local") -> MapResult:
    """The plain version: the chosen candidate a1 [B] of each read
    traced back (the winner's corridor by K2's plain version, its query by
    its strand, K4's plain version), then the filters and MAPQ; `proper`
    [B] (the pair resolution's verdict) is gated by `mapped`.  On CUDA
    tensors the same ops run K2 and K4, the card path before the finish
    pass."""
    B, C = sw.shape
    L = reads.shape[1]
    T = L + band
    G = genome.shape[0]
    a1c = a1[:, None]

    a1_valid = torch.gather(cand_valid, 1, a1c)[:, 0]
    best_start = torch.gather(corr_start, 1, a1c)[:, 0]
    best_strand = torch.gather(strand, 1, a1c)[:, 0]
    # second best at a DIFFERENT locus (outside +-L of the winner), for MAPQ
    far = (corr_start - best_start[:, None]).abs() > L
    s2 = torch.where(far, sw, 0).max(dim=1).values

    starts = torch.where(a1_valid, best_start, 0).clamp(0, max(0, G - T))
    best_corr = gather_genome_windows(genome, starts.to(I32).contiguous(), T)
    best_query = torch.where((best_strand == 1)[:, None], rc, reads)
    ares = sw_align(
        best_query, lengths, best_corr, matrices, gopen_q, gopen_r, gext,
        best_strand, band=band, mode=mode,
    )
    s1 = torch.where(a1_valid, ares.score, 0)
    mapped, mapq = filters_and_mapq(
        s1, s2, ares.matches, ares.n_ops, ares.q_start, ares.q_end, lengths,
        ares.trunc, min_identity, min_residues)
    cmr_overflow = overflow[1] + ares.trunc.sum(dtype=I32)

    return MapResult(
        mapped=mapped,
        strand=best_strand,
        pos=best_start + ares.r_start,  # raw even when unmapped; gate on `mapped`
        mapq=mapq,
        score=s1,
        second=s2,
        q_start=ares.q_start,
        q_end=ares.q_end,
        ops=ares.ops,
        n_ops=ares.n_ops,
        matches=ares.matches,
        mismatches=ares.mismatches,
        indels=ares.indels,
        n_candidates=n_cands,
        proper=proper & mapped,
        fanout_overflow=overflow[0],
        cmr_overflow=cmr_overflow,
    )


@functools.lru_cache(maxsize=None)
def _plan(device: int, B: int, L: int, W: int, local: bool) -> Plan:
    lib = build.load()
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(device):
        code = lib.ngm_finish_plan(B, L, W, int(local), out)
    build.check(code, "finish plan")
    return Plan(ROUTES[out[0]], *out[1:])


def plan(B: int, L: int, W: int, mode: str = "local",
         device: torch.device | int | None = None) -> Plan:
    """The finish pass's launch for B reads at [B, L] x W on a CUDA card
    (the current one by default): K4's shape rule applied to its kernels
    (``ngm_finish_plan``)."""
    local = check_mode(mode)
    if not 1 <= W <= MAX_BAND:
        raise ValueError(f"finish_pass: band {W} outside [1, {MAX_BAND}]")
    index = None if device is None else torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    p = _plan(index, int(B), int(L), int(W), local)
    if p.blocks_per_sm == 0:
        raise ValueError(
            f"finish_pass: [{L}] x W{W} ({mode}) fits no route: "
            f"{p.smem_bytes} bytes of shared memory a block")
    return p


def finish_pass(a1: torch.Tensor,          # [B] int64 in [0, C)
                sw: torch.Tensor,          # [B, C] int32
                corr_start: torch.Tensor,  # [B, C] int32
                strand: torch.Tensor,      # [B, C] int32
                cand_valid: torch.Tensor,  # [B, C] bool
                genome: torch.Tensor,      # [G] uint8
                reads: torch.Tensor,       # [B, L] uint8
                rc: torch.Tensor,          # [B, L] uint8
                lengths: torch.Tensor,     # [B] int32
                matrices: torch.Tensor,    # [M, 8, 8] or [8, 8] int32
                gopen_q: int, gopen_r: int, gext: int,
                min_identity: torch.Tensor,  # [] float32
                min_residues: torch.Tensor,  # [] float32
                n_cands: torch.Tensor,     # [B] int32, passed through
                overflow: tuple,           # ([] fanout, [] cmr) int32
                proper: torch.Tensor,      # [B] bool
                *, band: int, mode: str = "local") -> MapResult:
    """Trace back each read's chosen candidate a1 and apply the filters
    and MAPQ, local or glocal (`mode`): the MapResult, with ops
    [B, L + band] END->START.  The second best score (for MAPQ) is the
    largest of `sw` at candidates more than L from the winner's corridor
    start, and 0.  `proper` is gated by `mapped`; n_cands and overflow[0]
    pass through, and cmr_overflow is overflow[1] plus the truncated op
    buffers.
    """
    if reads.device.type == "cpu":
        return finish_plain(
            a1, sw, corr_start, strand, cand_valid, genome, reads, rc,
            lengths, matrices, gopen_q, gopen_r, gext, min_identity,
            min_residues, n_cands, overflow, proper, band=band, mode=mode)
    local = check_mode(mode)
    dev = reads.device
    if dev.type != "cuda":
        raise ValueError(f"finish_pass: unsupported device {dev}")
    if genome.dim() != 1 or sw.dim() != 2 or reads.dim() != 2:
        raise ValueError(
            f"finish_pass: genome must be [G], sw [B, C] and reads [B, L], "
            f"got {tuple(genome.shape)}, {tuple(sw.shape)} and "
            f"{tuple(reads.shape)}")
    B, L = reads.shape
    C = sw.shape[1]
    W = band
    mats = matrices.reshape(-1, 8, 8)
    cmr_in = overflow[1]
    checks = (
        (a1, torch.int64, (B,), "a1"),
        (sw, I32, (B, C), "sw"),
        (corr_start, I32, (B, C), "corr_start"),
        (strand, I32, (B, C), "strand"),
        (cand_valid, torch.bool, (B, C), "cand_valid"),
        (genome, torch.uint8, tuple(genome.shape), "genome"),
        (rc, torch.uint8, (B, L), "rc"),
        (lengths, I32, (B,), "lengths"),
        (mats, I32, tuple(mats.shape), "matrices"),
        (min_identity, torch.float32, (), "min_identity"),
        (min_residues, torch.float32, (), "min_residues"),
        (proper, torch.bool, (B,), "proper"),
        (cmr_in, I32, (), "overflow[1]"),
    )
    for t, dtype, shape, name in checks:
        if t.device != dev:
            raise ValueError(
                f"finish_pass: {name} on {t.device}, reads on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"finish_pass: {name} must be {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"finish_pass: {name} must be contiguous")
    if reads.dtype != torch.uint8 or not reads.is_contiguous():
        raise ValueError("finish_pass: reads must be contiguous uint8")
    if C < 1:
        raise ValueError(f"finish_pass: {C} candidates a read, at least 1")
    if not 1 <= mats.shape[0] <= MAX_MATS:
        raise ValueError(
            f"finish_pass: {mats.shape[0]} matrices, at most {MAX_MATS}")
    p = plan(B, L, W, mode, dev)
    fields = torch.empty((N_OUT, B), dtype=I32, device=dev)
    flags = torch.empty((2, B), dtype=torch.bool, device=dev)
    ops = torch.empty((B, L + W), dtype=torch.uint8, device=dev)
    cmr = torch.empty((), dtype=I32, device=dev)
    # the global route's packed rows, [B, L, row_bytes]; never read past
    # what the kernel wrote
    scratch = (torch.empty(max(B * L * p.row_bytes, 16), dtype=torch.uint8,
                           device=dev)
               if p.route == "global" else None)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ngm_finish(
            a1.data_ptr(), sw.data_ptr(), corr_start.data_ptr(),
            strand.data_ptr(), cand_valid.data_ptr(), genome.data_ptr(),
            genome.shape[0], reads.data_ptr(), rc.data_ptr(),
            lengths.data_ptr(), mats.data_ptr(), min_identity.data_ptr(),
            min_residues.data_ptr(), proper.data_ptr(), cmr_in.data_ptr(),
            B, L, C, W, mats.shape[0], int(gopen_q), int(gopen_r), int(gext),
            int(local), ROUTES.index(p.route), p.threads,
            None if scratch is None else scratch.data_ptr(),
            fields.data_ptr(), flags.data_ptr(), ops.data_ptr(),
            cmr.data_ptr(), stream,
        )
    build.check(code, "finish_pass")
    finish_pass.launches += 1
    (b_strand, pos, mapq, score, second, q_start, q_end, n_ops, matches,
     mismatches, indels) = fields
    return MapResult(
        mapped=flags[0], strand=b_strand, pos=pos, mapq=mapq, score=score,
        second=second, q_start=q_start, q_end=q_end, ops=ops, n_ops=n_ops,
        matches=matches, mismatches=mismatches, indels=indels,
        n_candidates=n_cands, proper=flags[1], fanout_overflow=overflow[0],
        cmr_overflow=cmr)


finish_pass.launches = 0
