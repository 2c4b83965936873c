"""The mapping steps in PyTorch, and the Mapper that owns their state.

Port of ``nextgenmap_tpu/models/mapper.py``'s one-device steps.  All three
share the front:

  revcomp -> k-mers -> candidate search (both strands) ->
  deterministic candidate order

with canonical k-mers and one lookup for both strands by default, or
(bisulfite, or a non-canonical host index) the two strands' k-mers looked
up apart: the forward read CT-collapsed in the CT table, its reverse
complement GA-collapsed in the GA table (`bs`).

and differ in their tails:

  map_step         lazy scoring of reads with >= 2 candidates (slot
                   compaction, corridor gather K2, SW score K1) -> argmax ->
                   winner corridor (K2) -> traceback -> filters + MAPQ
  map_step_paired  lazy scoring of pairs where a mate has >= 2 candidates ->
                   CxC insert-window pair resolution -> as above
  map_step_topn    eager scoring of every candidate -> stable top-R ranks ->
                   one compacted traceback of all ranks (K2 fetch)

`end_to_end` (--end-to-end) scores and aligns in glocal mode: the whole
read is aligned, with no clipping.

On a CUDA device every corridor fetch goes through the hand-written gather
kernel and every score pass, local or glocal, through the hand-written SW
kernel; on the CPU their wrappers run the plain PyTorch versions.  Every
output equals the reference's steps exactly (tests/test_torch_mapper.py,
tests/test_torch_paired.py, tests/test_torch_topn.py,
tests/test_torch_glocal.py, tests/test_torch_bisulfite.py,
tests/test_torch_long_reads.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.convert import MapperState, state_from_numpy
from nextgenmap_tpu_torch.device import resolve_device
from nextgenmap_tpu_torch.index.device_build import (
    build_index_device, concat_tables,
)
from nextgenmap_tpu_torch.index.kmer_index import KmerIndex
from nextgenmap_tpu_torch.ops.candidate import (
    candidate_search_canonical, candidate_search_dual, pack_offsets,
)
from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
from nextgenmap_tpu_torch.ops.kmer import (
    extract_kmers, extract_kmers_canonical,
)
from nextgenmap_tpu_torch.ops.scoring import matrices_are_simple, score_matrix
from nextgenmap_tpu_torch.ops.sw_kernel import sw_score
from nextgenmap_tpu_torch.ops.sw_ref import banded_sw_align

I32 = torch.int32


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


def revcomp_batch(codes: torch.Tensor) -> torch.Tensor:
    """[B, L] reverse complement (PAD stays PAD)."""
    flipped = codes.flip(1)
    return torch.where(flipped < 4, 3 - flipped, flipped).to(codes.dtype)


def _pre_extract(reads, lengths, *, k, read_stride=1, bs=False, bs_cutoff=0,
                 canonical=True):
    """Left-shifted reverse complements and the read k-mers: canonical
    (canon, flip, ok), or (km_f, ok_f, km_r, ok_r) of the two strands, which
    bisulfite collapses C->T (forward) and G->A (reverse complement) with
    the --bs-cutoff drop."""
    B, L = reads.shape
    rc = revcomp_batch(reads)
    # the flip moves right-padding to the front of short reads: shift each
    # rc row left by (L - length) so it starts at column 0
    idx = torch.arange(L, device=reads.device)[None, :] + (L - lengths)[:, None]
    rc = torch.gather(torch.nn.functional.pad(rc, (0, L), value=4), 1, idx.long())
    if canonical and not bs:
        return rc, extract_kmers_canonical(reads, lengths, k,
                                           stride=read_stride)
    cut = bs_cutoff if bs else 0
    km_f, ok_f = extract_kmers(reads, lengths, k, stride=read_stride,
                               collapse="ct" if bs else "none",
                               max_collapsed=cut)
    km_r, ok_r = extract_kmers(rc, lengths, k, stride=read_stride,
                               collapse="ga" if bs else "none",
                               max_collapsed=cut)
    return rc, (km_f, ok_f, km_r, ok_r)


def _candidates(genome, offsets, positions, reads, lengths, sensitivity,
                max_freq, *, k, fanout_cap, hit_cap, max_cmrs, diag_bin_log2,
                band, min_kmer_hits, read_stride=1, packed_offsets=False,
                bs=False, bs_cutoff=0, canonical=True):
    """CS on both strands -> candidates ordered by (strand, corridor start).

    Valid candidates form a per-read prefix after the ordering (DESIGN.md
    rule 11).  Returns (corr_start, strand, cand_valid, n_cands, rc,
    (fanout + hit overflow, cmr overflow)).
    """
    B, L = reads.shape
    W = band
    T = L + W
    G = genome.shape[0]
    bin_w = 1 << diag_bin_log2

    rc, kms = _pre_extract(reads, lengths, k=k, read_stride=read_stride,
                           bs=bs, bs_cutoff=bs_cutoff, canonical=canonical)
    common = dict(fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
                  diag_bin_log2=diag_bin_log2, stride=read_stride,
                  packed_offsets=packed_offsets)
    if canonical and not bs:
        cand = candidate_search_canonical(
            *kms, lengths, offsets, positions, sensitivity, max_freq, k=k,
            **common,
        )
    else:
        cand = candidate_search_dual(
            *kms, offsets, positions, sensitivity, max_freq, dual_tables=bs,
            **common,
        )
    cs_score, strand = cand.score, cand.strand
    cand_valid = cs_score >= max(1, min_kmer_hits)
    if min_kmer_hits > 1:
        # zero-CMR retry: a read whose every bucket is below kmer_min gets
        # a second chance at threshold 1
        none = cand.best_score < min_kmer_hits
        cand_valid = torch.where(none[:, None], cs_score >= 1, cand_valid)

    slack = (W - 2 * bin_w) // 2
    bucket = torch.where(cand_valid, cand.bucket, 0)
    corr_start = torch.where(cand_valid, (bucket << diag_bin_log2) - slack, 0)
    corr_start = corr_start.clamp(0, max(0, G - T)).to(I32)
    order_key = torch.where(cand_valid, strand * (2**30) + corr_start, 2**31 - 1)
    order = torch.sort(order_key, dim=1, stable=True).indices
    corr_start = torch.gather(corr_start, 1, order)
    strand = torch.gather(strand, 1, order)
    cand_valid = torch.gather(cand_valid, 1, order)

    n_cands = cand_valid.sum(dim=1, dtype=I32)
    overflow = (cand.fanout_overflow + cand.hit_overflow, cand.cmr_overflow)
    return corr_start, strand, cand_valid, n_cands, rc, overflow


def _sw_mode(end_to_end: bool) -> str:
    return "glocal" if end_to_end else "local"


def _score_candidates(genome, reads, rc, lengths, corr_start, strand,
                      cand_valid, score_mask, matrices, gopen_q, gopen_r, gext,
                      *, band, slot_cap, end_to_end=False, simple_matrix=False):
    """Banded-SW score the candidates of the reads selected by `score_mask`.

    Lazy scoring: a read with one candidate needs no comparison and skips
    this pass (its score comes from the traceback).  The (read, candidate)
    pairs of the masked reads are compacted batch-wide into `slot_cap`
    slots, gathered and scored once each, and the scores are scattered back
    to a dense [B, C] grid (0 where unscored).  The slots past the real
    ones are scored at length 0, so the kernel does no work for them.
    Returns (sw, slot_overflow).
    """
    B, L = reads.shape
    C = corr_start.shape[1]
    W = band
    T = L + W
    S = slot_cap
    dev = reads.device

    eff_valid = cand_valid & score_mask[:, None]
    n_sc = eff_valid.sum(dim=1, dtype=I32)
    base = torch.cumsum(n_sc, dim=0, dtype=I32) - n_sc       # exclusive [B]
    total = base[-1] + n_sc[-1]
    slot_overflow = (total > S).to(I32)

    # slot s belongs to the last read b with base[b] <= s
    sar = torch.arange(S, dtype=I32, device=dev)
    b_of = torch.searchsorted(base, sar, right=True, out_int32=True) - 1
    slot_valid = sar < total.clamp(max=S)
    j_of = sar - base[b_of.long()]
    flat_idx = torch.where(slot_valid, b_of * C + j_of, 0).long()
    b_s = torch.where(slot_valid, b_of, 0).long()

    corr_starts = torch.where(slot_valid, corr_start.reshape(-1)[flat_idx], 0)
    strand_s = strand.reshape(-1)[flat_idx]
    # an invalid slot has length 0: it runs no DP row and scores (0, 0, 0)
    len_s = torch.where(slot_valid, lengths[b_s], 0)
    # one contiguous window per real candidate (kernel K2 on the card)
    corr_s = gather_genome_windows(genome, corr_starts.contiguous(), T)
    q_s = torch.where((strand_s == 1)[:, None], rc[b_s], reads[b_s])

    # (kernel K1 on the card)
    sres = sw_score(q_s, len_s, corr_s, matrices, gopen_q, gopen_r, gext,
                    strand_s.contiguous(), band=W, mode=_sw_mode(end_to_end),
                    simple=simple_matrix)
    score_s = torch.where(slot_valid, sres.score, 0)

    # scatter back; every invalid slot writes the one discarded dump index
    sw = torch.zeros(B * C + 1, dtype=I32, device=dev)
    sw[torch.where(slot_valid, flat_idx, B * C)] = score_s
    sw = torch.where(eff_valid, sw[:B * C].reshape(B, C), 0)
    return sw, slot_overflow


def _finish(a1, sw, corr_start, strand, cand_valid, genome, reads, rc,
            lengths, matrices, gopen_q, gopen_r, gext, min_identity,
            min_residues, n_cands, overflow, proper, *, band,
            end_to_end=False, simple_matrix=False):
    """Traceback the chosen candidate a1 [B] and apply filters + MAPQ;
    `proper` [B] (the pair resolution's verdict) is gated by `mapped`."""
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
    ares = banded_sw_align(
        best_query, lengths, best_corr, matrices, gopen_q, gopen_r, gext,
        best_strand, band=band, mode=_sw_mode(end_to_end),
        simple=simple_matrix,
    )
    s1 = torch.where(a1_valid, ares.score, 0)

    f32 = torch.float32
    aln_cols = ares.n_ops.clamp(min=1)
    identity = ares.matches.to(f32) / aln_cols.to(f32)
    residues = (ares.q_end - ares.q_start + 1).to(f32)
    min_res_abs = min_residues * lengths.to(f32)
    mapped = (
        (s1 > 0)
        & (lengths > 0)
        & (identity >= min_identity)
        & (residues >= min_res_abs)
        # an op-buffer overflow leaves the CIGAR incomplete: never emit it
        & ~ares.trunc
    )
    cmr_overflow = overflow[1] + ares.trunc.sum(dtype=I32)
    s1f = s1.clamp(min=1).to(f32)
    # float32, round half to even, as the reference
    mapq = torch.round(60.0 * (s1 - s2).to(f32) / s1f).clamp(0, 60).to(I32)
    mapq = torch.where(mapped, mapq, 0)

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


def _single_tail(genome, reads, rc, lengths, matrices, gopen_q, gopen_r,
                 gext, min_identity, min_residues, corr_start, strand,
                 cand_valid, n_cands, overflow, *, band, slot_cap,
                 end_to_end=False, simple_matrix=False):
    """Lazy scoring, rule-11 argmax selection, traceback + filters."""
    sw, slot_ovf = _score_candidates(
        genome, reads, rc, lengths, corr_start, strand, cand_valid,
        n_cands >= 2, matrices, gopen_q, gopen_r, gext,
        band=band, slot_cap=slot_cap, end_to_end=end_to_end,
        simple_matrix=simple_matrix,
    )
    overflow = (overflow[0], overflow[1] + slot_ovf)
    # first max = score DESC, fwd first, pos ASC; an all-zero (lazy) row
    # picks candidate 0, the read's only candidate after prefix ordering
    a1 = torch.argmax(sw, dim=1)
    proper = torch.zeros(reads.shape[0], dtype=torch.bool, device=reads.device)
    return _finish(
        a1, sw, corr_start, strand, cand_valid, genome, reads, rc, lengths,
        matrices, gopen_q, gopen_r, gext, min_identity, min_residues,
        n_cands, overflow, proper, band=band, end_to_end=end_to_end,
        simple_matrix=simple_matrix,
    )


def default_slot_cap(batch: int) -> int:
    """Score-pass slots: most reads have one candidate and need none;
    overflow is counted, so a repeat-dense genome is visible, not silent."""
    return max(512, batch // 2)


def _f32(x, device) -> torch.Tensor:
    """A float32 scalar tensor, like the reference's jnp.float32 arguments,
    so that comparisons against it round as the reference's do."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _front(genome, offsets, positions, reads, lengths, sensitivity, max_freq,
           **cand_statics):
    """What every step shares: (int32 lengths, rc, (corr_start, strand,
    cand_valid, n_cands, overflow)), the ordered candidates of both strands."""
    lengths = lengths.to(I32)
    corr_start, strand, cand_valid, n_cands, rc, overflow = _candidates(
        genome, offsets, positions, reads, lengths,
        _f32(sensitivity, reads.device), int(max_freq), **cand_statics,
    )
    return lengths, rc, (corr_start, strand, cand_valid, n_cands, overflow)


def map_step(
    genome, offsets, positions, reads, lengths, matrices,
    gopen_q, gopen_r, gext, sensitivity, max_freq, min_identity, min_residues,
    *, k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, packed_offsets=False,
    simple_matrix=False, bs=False, bs_cutoff=0, end_to_end=False,
    canonical=True,
) -> MapResult:
    """Single-end mapping step (DESIGN.md rule 11 selection) on the device
    that holds `reads`.  sensitivity, min_identity and min_residues are
    taken as float32, like the reference's jnp.float32 arguments."""
    dev = reads.device
    lengths, rc, cands = _front(
        genome, offsets, positions, reads, lengths, sensitivity, max_freq,
        k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, band=band, min_kmer_hits=min_kmer_hits,
        read_stride=read_stride, packed_offsets=packed_offsets, bs=bs,
        bs_cutoff=bs_cutoff, canonical=canonical,
    )
    return _single_tail(
        genome, reads, rc, lengths, matrices,
        int(gopen_q), int(gopen_r), int(gext),
        _f32(min_identity, dev), _f32(min_residues, dev), *cands, band=band,
        slot_cap=slot_cap or default_slot_cap(reads.shape[0]),
        end_to_end=end_to_end, simple_matrix=simple_matrix,
    )


def _paired_tail(genome, reads, rc, lengths, matrices, gopen_q, gopen_r,
                 gext, min_identity, min_residues, min_insert, max_insert,
                 pair_cutoff, corr_start, strand, cand_valid, n_cands,
                 overflow, *, band, slot_cap, diag_bin_log2,
                 end_to_end=False, simple_matrix=False):
    """Lazy scoring of multi-candidate pairs, CxC insert-window pair
    resolution, traceback + filters.  Rows 2i / 2i+1 are the mates of pair i."""
    B, L = reads.shape
    C = corr_start.shape[1]
    P = B // 2
    bin_w = 1 << diag_bin_log2

    np_ = n_cands.reshape(P, 2)
    pair_multi = (np_[:, 0] >= 2) | (np_[:, 1] >= 2)
    sw, slot_ovf = _score_candidates(
        genome, reads, rc, lengths, corr_start, strand, cand_valid,
        pair_multi.repeat_interleave(2), matrices, gopen_q, gopen_r, gext,
        band=band, slot_cap=slot_cap, end_to_end=end_to_end,
        simple_matrix=simple_matrix,
    )
    overflow = (overflow[0], overflow[1] + slot_ovf)

    s = sw.reshape(P, 2, C)
    # approximate alignment start = corridor start + slack (the diagonal)
    slack = (band - 2 * bin_w) // 2
    pos = (corr_start + slack).reshape(P, 2, C)
    st = strand.reshape(P, 2, C)
    exist = cand_valid.reshape(P, 2, C)
    s1m, s2m = s[:, 0, :, None], s[:, 1, None, :]          # [P, C, 1], [P, 1, C]
    p1, p2 = pos[:, 0, :, None], pos[:, 1, None, :]
    st1, st2 = st[:, 0, :, None], st[:, 1, None, :]

    # FR orientation: strands differ and the forward mate lies leftmost
    margin = 2 * bin_w
    fwd_left = torch.where(st1 == 0, p1 <= p2 + margin, p2 <= p1 + margin)
    span = (p2 - p1).abs() + L                  # approximate outer distance
    ok_ins = (span >= min_insert - margin) & (span <= max_insert + margin)
    geo = ((st1 != st2) & fwd_left & ok_ins
           & exist[:, 0, :, None] & exist[:, 1, None, :])
    valid = geo & (s1m > 0) & (s2m > 0)
    flat = torch.where(valid, s1m + s2m, -1).reshape(P, C * C)
    pair_best = flat.max(dim=1).values
    pair_arg = torch.argmax(flat, dim=1)        # first max: c1 ASC, then c2 ASC
    c1s, c2s = pair_arg // C, pair_arg % C

    best1 = s[:, 0].max(dim=1).values
    best2 = s[:, 1].max(dim=1).values
    f32 = torch.float32
    proper_scored = (pair_best > 0) & (
        pair_best.to(f32) >= pair_cutoff * (best1 + best2).to(f32)
    )
    # single x single: the only combination is (0, 0), and its propriety is
    # pure geometry (the final `proper` is still gated by both mates mapping)
    proper_single = geo[:, 0, 0] & (np_[:, 0] >= 1) & (np_[:, 1] >= 1)
    proper_pair = torch.where(pair_multi, proper_scored, proper_single)

    c1 = torch.where(pair_multi, c1s, 0)
    c2 = torch.where(pair_multi, c2s, 0)

    a_single = torch.argmax(sw, dim=1).reshape(P, 2)
    sel1 = torch.where(proper_pair, c1, a_single[:, 0])
    sel2 = torch.where(proper_pair, c2, a_single[:, 1])
    a1 = torch.stack([sel1, sel2], dim=1).reshape(B)
    return _finish(
        a1, sw, corr_start, strand, cand_valid, genome, reads, rc, lengths,
        matrices, gopen_q, gopen_r, gext, min_identity, min_residues,
        n_cands, overflow, proper_pair.repeat_interleave(2), band=band,
        end_to_end=end_to_end, simple_matrix=simple_matrix,
    )


def map_step_paired(
    genome, offsets, positions, reads, lengths, matrices,
    gopen_q, gopen_r, gext, sensitivity, max_freq, min_identity, min_residues,
    min_insert, max_insert, pair_cutoff,
    *, k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, packed_offsets=False,
    simple_matrix=False, bs=False, bs_cutoff=0, end_to_end=False,
    canonical=True,
) -> MapResult:
    """Paired-end step: rows 2i / 2i+1 are mates (DESIGN.md rule 13).

    Pairs resolve on candidate scores before the traceback: a CxC
    combined-score argmax over an FR-orientation + insert-window mask,
    falling back to the best singletons when no pair clears
    pair_cutoff * (best1 + best2) (a broken pair).  A pair whose mates both
    have one candidate is not scored.  min_insert / max_insert are taken as
    int32 and pair_cutoff as float32, like the reference's arguments.
    """
    dev = reads.device
    lengths, rc, cands = _front(
        genome, offsets, positions, reads, lengths, sensitivity, max_freq,
        k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, band=band, min_kmer_hits=min_kmer_hits,
        read_stride=read_stride, packed_offsets=packed_offsets, bs=bs,
        bs_cutoff=bs_cutoff, canonical=canonical,
    )
    i32 = lambda x: torch.as_tensor(x, dtype=I32, device=dev)  # noqa: E731
    return _paired_tail(
        genome, reads, rc, lengths, matrices,
        int(gopen_q), int(gopen_r), int(gext),
        _f32(min_identity, dev), _f32(min_residues, dev),
        i32(min_insert), i32(max_insert), _f32(pair_cutoff, dev), *cands,
        band=band, slot_cap=slot_cap or default_slot_cap(reads.shape[0]),
        diag_bin_log2=diag_bin_log2, end_to_end=end_to_end,
        simple_matrix=simple_matrix,
    )


def top_ranks(sw: torch.Tensor, r: int) -> torch.Tensor:
    """[B, r] column indices of each row's r largest scores, ties to the
    lower index (rule 11 order): the order of jax.lax.top_k, which is
    stable.  torch.topk promises no order of ties, so this is the head of a
    stable descending sort."""
    return torch.sort(sw, dim=1, descending=True, stable=True).indices[:, :r]


def _topn_tail(genome, reads, rc, lengths, matrices, gopen_q, gopen_r, gext,
               min_identity, min_residues, corr_start, strand, cand_valid,
               n_cands, overflow, *, band, slot_cap, topn,
               end_to_end=False, simple_matrix=False):
    """Eager scoring, stable rank selection, ONE compacted traceback of all
    ranks.  Returns `topn` MapResults, rank 0 first."""
    B, L = reads.shape
    dev = reads.device
    T = L + band
    G = genome.shape[0]
    R = topn
    sw, slot_ovf = _score_candidates(
        genome, reads, rc, lengths, corr_start, strand, cand_valid,
        torch.ones(B, dtype=torch.bool, device=dev), matrices, gopen_q,
        gopen_r, gext, band=band, slot_cap=slot_cap, end_to_end=end_to_end,
        simple_matrix=simple_matrix,
    )
    overflow = (overflow[0], overflow[1] + slot_ovf)
    proper = torch.zeros(B, dtype=torch.bool, device=dev)
    top_idx = top_ranks(sw, R)
    # entries past a read's candidates land on zero-score cells: gate them
    # so they cannot alias candidate 0.  Validity is a prefix along ranks
    tv = torch.gather(cand_valid, 1, top_idx)                     # [B, R]
    ts = torch.gather(sw, 1, top_idx)
    jr = torch.arange(R, device=dev)[None, :]
    rvalid = tv & ((jr == 0) | (ts > 0))
    t_start = torch.gather(corr_start, 1, top_idx)
    t_strand = torch.gather(strand, 1, top_idx)

    # compact the valid (read, rank) pairs into slot_cap slots, owned as in
    # _score_candidates: slot s belongs to the last read b with base[b] <= s
    S2 = slot_cap
    n_r = rvalid.sum(dim=1, dtype=I32)
    base = torch.cumsum(n_r, dim=0, dtype=I32) - n_r
    total = base[-1] + n_r[-1]
    slot2_ovf = (total > S2).to(I32)
    sar = torch.arange(S2, dtype=I32, device=dev)
    b_of = torch.searchsorted(base, sar, right=True, out_int32=True) - 1
    slot_valid = sar < total.clamp(max=S2)
    j_of = sar - base[b_of.long()]              # the rank (prefix validity)
    b_safe = torch.where(slot_valid, b_of, 0).long()
    flat_bj = torch.where(slot_valid, b_of * R + j_of, 0).long()

    start_s = t_start.reshape(-1)[flat_bj]
    strand_s = t_strand.reshape(-1)[flat_bj]
    starts = torch.where(slot_valid, start_s, 0).clamp(0, max(0, G - T))
    # the ranks' corridors (kernel K2 on the card)
    corr_s = gather_genome_windows(genome, starts.to(I32).contiguous(), T)
    corr_s = torch.where(slot_valid[:, None], corr_s, 4).to(torch.uint8)
    q_s = torch.where((strand_s == 1)[:, None], rc[b_safe], reads[b_safe])
    ares = banded_sw_align(
        q_s, lengths[b_safe], corr_s, matrices, gopen_q, gopen_r, gext,
        strand_s, band=band, mode=_sw_mode(end_to_end), simple=simple_matrix,
    )
    overflow = (
        overflow[0],
        overflow[1] + slot2_ovf
        + (slot_valid & ares.trunc).sum(dtype=I32),
    )

    # scatter every align field back to the [B, R] rank grid; every invalid
    # slot writes the one discarded dump row
    scat_idx = torch.where(slot_valid, flat_bj, B * R)

    def scat(x):
        flat = torch.zeros((B * R + 1,) + x.shape[1:], dtype=x.dtype,
                           device=dev)
        flat[scat_idx] = x
        return flat[:B * R].reshape((B, R) + x.shape[1:])

    g_score = scat(torch.where(slot_valid, ares.score, 0))
    g_qs, g_qe, g_rs = scat(ares.q_start), scat(ares.q_end), scat(ares.r_start)
    g_ops, g_nops = scat(ares.ops), scat(ares.n_ops)
    g_match, g_mis = scat(ares.matches), scat(ares.mismatches)
    g_ind, g_trunc = scat(ares.indels), scat(ares.trunc)

    # second best at a DIFFERENT locus per rank (the rule of _finish)
    far = (corr_start[:, None, :] - t_start[:, :, None]).abs() > L  # [B, R, C]
    s2 = torch.where(far, sw[:, None, :], 0).max(dim=2).values      # [B, R]

    f32 = torch.float32
    results = []
    for j in range(R):
        s1 = g_score[:, j]
        identity = (g_match[:, j].to(f32)
                    / g_nops[:, j].clamp(min=1).to(f32))
        residues = (g_qe[:, j] - g_qs[:, j] + 1).to(f32)
        mapped = (
            (s1 > 0) & (lengths > 0)
            & (identity >= min_identity)
            & (residues >= min_residues * lengths.to(f32))
            & ~g_trunc[:, j]
        )
        s1f = s1.clamp(min=1).to(f32)
        mapq = torch.round(60.0 * (s1 - s2[:, j]).to(f32) / s1f)
        mapq = mapq.clamp(0, 60).to(I32)
        results.append(MapResult(
            mapped=mapped,
            strand=t_strand[:, j],
            pos=t_start[:, j] + g_rs[:, j],
            mapq=torch.where(mapped, mapq, 0),
            score=s1,
            second=s2[:, j],
            q_start=g_qs[:, j],
            q_end=g_qe[:, j],
            ops=g_ops[:, j],
            n_ops=g_nops[:, j],
            matches=g_match[:, j],
            mismatches=g_mis[:, j],
            indels=g_ind[:, j],
            n_candidates=n_cands,
            proper=proper,
            fanout_overflow=overflow[0],
            cmr_overflow=overflow[1],
        ))
    return tuple(results)


def default_topn_slot_cap(batch: int) -> int:
    """Top-n slots: scoring is eager, so every candidate takes one."""
    return 2 * batch


def map_step_topn(
    genome, offsets, positions, reads, lengths, matrices,
    gopen_q, gopen_r, gext, sensitivity, max_freq, min_identity, min_residues,
    *, k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, packed_offsets=False,
    simple_matrix=False, topn=2, bs=False, bs_cutoff=0, end_to_end=False,
    canonical=True,
) -> tuple:
    """Single-end mapping with up to `topn` alignments per read (-n).

    Returns `topn` MapResults ordered score DESC (DESIGN.md rule 11 ties);
    rank j is valid for a read where its score > 0.  The host emitter
    applies --strata and near-duplicate suppression and marks ranks 1.. as
    SAM secondaries.  Ranking needs every candidate's score, so scoring is
    eager (slot_cap defaults to 2B), and the same slot_cap bounds the
    compacted traceback of the valid ranks.
    """
    dev = reads.device
    lengths, rc, cands = _front(
        genome, offsets, positions, reads, lengths, sensitivity, max_freq,
        k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, band=band, min_kmer_hits=min_kmer_hits,
        read_stride=read_stride, packed_offsets=packed_offsets, bs=bs,
        bs_cutoff=bs_cutoff, canonical=canonical,
    )
    return _topn_tail(
        genome, reads, rc, lengths, matrices,
        int(gopen_q), int(gopen_r), int(gext),
        _f32(min_identity, dev), _f32(min_residues, dev), *cands, band=band,
        slot_cap=slot_cap or default_topn_slot_cap(reads.shape[0]),
        topn=topn, end_to_end=end_to_end, simple_matrix=simple_matrix,
    )


def score_matrices(cfg: NgmConfig) -> np.ndarray:
    """[2, 8, 8] int32 substitution matrices, selected per candidate by
    strand (they differ only in bisulfite mode)."""
    return np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])


def check_slice(cfg: NgmConfig) -> None:
    """Raise NotImplementedError for a configuration outside the ported
    slice, naming the ROADMAP item that will bring it."""
    unported = [
        (cfg.megabatch > 1, "--megabatch waits for ROADMAP A12"),
        (cfg.index_shards > 1, "--index-shards > 1 waits for ROADMAP A13"),
        (cfg.devices != 1, "--devices/-g other than one device waits for "
                           "ROADMAP A13"),
    ]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(f"not in the PyTorch port yet: {what}")


class Mapper:
    """Owns the device-resident genome, index and matrices, and maps batches.

    index=None builds the index on `device`: canonical, or in bisulfite
    mode the CT- and GA-collapsed tables, concatenated.  A host index is
    carried across with convert.state_from_numpy instead: a KmerIndex
    (canonical or not), a (CT, GA) pair of KmerIndexes in bisulfite mode, or
    an (offsets, positions) pair of arrays (in bisulfite mode, the tables
    already concatenated).
    """

    def __init__(self, cfg: NgmConfig, genome, read_len: int,
                 index: KmerIndex | tuple | None = None, *,
                 device: torch.device | str):
        check_slice(cfg)
        self.cfg = cfg
        self.genome = genome
        self.read_len = read_len
        self.device = resolve_device(device)
        codes = np.asarray(genome.codes)
        mats = score_matrices(cfg)
        # canonical k-mers (one lookup serves both strands) unless the
        # strands need tables of their own: bisulfite, or a host index
        # built without canonical entries
        self.canonical = (not cfg.bs_mapping
                          and getattr(index, "canonical", True))
        if index is None:
            if codes.shape[0] >= 2**30:
                raise NotImplementedError(
                    "genomes of 2^30 bases or more need index sharding "
                    "(ROADMAP A13)"
                )
            g = torch.from_numpy(codes).to(self.device)
            build = dict(k=cfg.kmer, skip=cfg.kmer_skip)
            if cfg.bs_mapping:
                off, pos = concat_tables(
                    *build_index_device(g, collapse="ct", canonical=False,
                                        **build),
                    *build_index_device(g, collapse="ga", canonical=False,
                                        **build),
                )
            else:
                off, pos = build_index_device(g, **build)
            self.state = MapperState(
                g, off, pos, torch.from_numpy(mats).to(self.device)
            )
        else:
            off, pos = self._host_tables(index)
            self.state = state_from_numpy(codes, off, pos, mats, self.device)
        # pack (o0, row length) into one table: one offset gather per k-mer
        packed = pack_offsets(self.state.offsets, cfg.max_kmer_freq,
                              cfg.max_kmer_fanout)
        self.packed_offsets = packed is not None
        self._offsets = packed if packed is not None else self.state.offsets
        self.simple_matrix = matrices_are_simple(mats)
        self.band = cfg.corridor_for(read_len)
        # from one table's positions: a bisulfite table is sized by the
        # collapsed 3^k estimate
        n_pos = self.state.positions.shape[0] // (2 if cfg.bs_mapping else 1)
        self.hit_cap = cfg.resolved_read_hits(n_pos, read_len)

    def _host_tables(self, index) -> tuple:
        """(offsets, positions) arrays of a host index (see the class)."""
        if isinstance(index, KmerIndex):
            if self.cfg.bs_mapping:
                raise ValueError("bisulfite mode needs a (CT, GA) index pair")
            return index.device_arrays()
        if self.cfg.bs_mapping and isinstance(index[0], KmerIndex):
            ct, ga = index
            return concat_tables(*(torch.from_numpy(a) for a in
                                   (*ct.device_arrays(), *ga.device_arrays())))
        return index

    def statics(self) -> dict:
        cfg = self.cfg
        return dict(
            k=cfg.kmer, fanout_cap=cfg.max_kmer_fanout, hit_cap=self.hit_cap,
            max_cmrs=cfg.max_cmrs, diag_bin_log2=cfg.diag_bin_log2,
            band=self.band, min_kmer_hits=max(1, cfg.kmer_min),
            read_stride=cfg.read_kmer_skip,
            packed_offsets=self.packed_offsets,
            simple_matrix=self.simple_matrix, bs=cfg.bs_mapping,
            bs_cutoff=cfg.bs_cutoff, end_to_end=cfg.end_to_end,
            canonical=self.canonical,
        )

    def _common_args(self, codes: np.ndarray, lengths: np.ndarray) -> tuple:
        """The positional arguments every step shares, for one [B, L] batch."""
        cfg = self.cfg
        st = self.state
        reads = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(self.device)
        lens = torch.from_numpy(np.ascontiguousarray(lengths, np.int32)).to(self.device)
        return (
            st.genome, self._offsets, st.positions, reads, lens, st.matrices,
            cfg.gap_read_penalty, cfg.gap_ref_penalty, cfg.gap_extend_penalty,
            cfg.sensitivity, cfg.max_kmer_freq, cfg.min_identity,
            cfg.min_residues,
        )

    def map_batch(self, codes: np.ndarray, lengths: np.ndarray) -> MapResult:
        """Map one [B, L] batch; the result stays on the mapper's device."""
        return map_step(*self._common_args(codes, lengths), **self.statics())

    def map_batch_paired(self, codes: np.ndarray,
                         lengths: np.ndarray) -> MapResult:
        """Map one batch of pairs (rows 2i / 2i+1 are mates)."""
        cfg = self.cfg
        return map_step_paired(
            *self._common_args(codes, lengths), cfg.min_insert_size,
            cfg.max_insert_size, cfg.pair_score_cutoff, **self.statics(),
        )

    def topn(self) -> int:
        """Ranks per read of map_batch_topn: -n, at most max_cmrs."""
        return min(self.cfg.topn, self.cfg.max_cmrs)

    def map_batch_topn(self, codes: np.ndarray, lengths: np.ndarray) -> tuple:
        """Map one batch with up to topn() ranked alignments per read."""
        return map_step_topn(*self._common_args(codes, lengths),
                             topn=self.topn(), **self.statics())
