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

The Mapper also runs the reference's several-device steps: the dp step
(each batch in contiguous slices, one per device slot) and the ("dp",
"ish") step of index shards on a grid of slots, within one process or
across processes (tests/test_torch_dp.py,
tests/test_torch_cross_host_shard.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.convert import MapperState, state_from_numpy
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
from nextgenmap_tpu_torch.parallel.dp import (
    SliceRunner, concat_results, split_batch,
)
from nextgenmap_tpu_torch.parallel.index_shard import (
    ShardedIndex, ShardExchange, ShardTables, grid_layout, log_local_shards,
    merge_sharded_results, merge_sharded_topn,
)
from nextgenmap_tpu_torch.parallel.mesh import device_slots, distinct

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
    the --bs-cutoff drop.  They depend on the reads only, so the shard loop
    extracts them once for every shard."""
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
                max_freq, pre=None, *, k, fanout_cap, hit_cap, max_cmrs,
                diag_bin_log2, band, min_kmer_hits, read_stride=1,
                packed_offsets=False, bs=False, bs_cutoff=0, canonical=True):
    """CS on both strands -> candidates ordered by (strand, corridor start).

    Valid candidates form a per-read prefix after the ordering (DESIGN.md
    rule 11).  Returns (corr_start, strand, cand_valid, cs_score [B, C] the
    bucket hit counts in the same order, n_cands, rc, best [B] the best
    bucket count, (fanout + hit overflow, cmr overflow), extra_score [B] the
    (C+1)-th best eligible count).  `pre` is _pre_extract's result when the
    caller already has it.
    """
    B, L = reads.shape
    W = band
    T = L + W
    G = genome.shape[0]
    bin_w = 1 << diag_bin_log2

    if pre is None:
        pre = _pre_extract(reads, lengths, k=k, read_stride=read_stride,
                           bs=bs, bs_cutoff=bs_cutoff, canonical=canonical)
    rc, kms = pre
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
    cs_score = torch.gather(cs_score, 1, order)
    cand_valid = torch.gather(cand_valid, 1, order)

    n_cands = cand_valid.sum(dim=1, dtype=I32)
    overflow = (cand.fanout_overflow + cand.hit_overflow, cand.cmr_overflow)
    return (corr_start, strand, cand_valid, cs_score, n_cands, rc,
            cand.best_score, overflow, cand.extra_score)


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
    corr_start, strand, cand_valid, _, n_cands, rc, _, overflow, _ = _candidates(
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


class CandState(NamedTuple):
    """One shard's candidate lists from one CS pass (the shard loop's
    phase 1).

    cs_score holds the bucket hit counts of the top-C candidates under the
    shard's LOCAL adaptive threshold; _regate_candidates re-derives validity
    from them against the GLOBAL best, which is exact: the global threshold
    is at least the local one, and the globally eligible candidates are the
    list's top scorers, so C clips them only where a one-shot selection at
    the global threshold would clip them too.
    """

    corr_start: torch.Tensor       # [B, C] int32
    strand: torch.Tensor           # [B, C] int32
    cs_score: torch.Tensor         # [B, C] int32
    best: torch.Tensor             # [B] int32 local best bucket count
    fanout_overflow: torch.Tensor  # [] int32
    cmr_overflow: torch.Tensor     # [] int32 at the LOCAL threshold; the
                                   # tails recount it from extra_score
    extra_score: torch.Tensor      # [B] int32 (C+1)-th best eligible count


def cs_cands_step(genome, offsets, positions, reads, lengths, sensitivity,
                  max_freq, pre=None, *, k, fanout_cap, hit_cap=256,
                  max_cmrs, diag_bin_log2, band, min_kmer_hits=1,
                  read_stride=1, packed_offsets=False, bs=False, bs_cutoff=0,
                  canonical=True) -> CandState:
    """Phase 1 of the shard loop: the full CS against one shard's tables,
    keeping its candidate lists for phase 2.  `pre` is the batch's
    _pre_extract result, shared by every shard."""
    corr_start, strand, _, cs_score, _, _, best, overflow, extra = _candidates(
        genome, offsets, positions, reads, lengths.to(I32),
        _f32(sensitivity, reads.device), int(max_freq), pre,
        k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, band=band, min_kmer_hits=min_kmer_hits,
        read_stride=read_stride, packed_offsets=packed_offsets, bs=bs,
        bs_cutoff=bs_cutoff, canonical=canonical,
    )
    return CandState(corr_start, strand, cs_score, best, overflow[0],
                     overflow[1], extra)


def _regate_candidates(cand: CandState, best_g, sensitivity, min_kmer_hits):
    """Validity against the GLOBAL best bucket count best_g [B], and the
    valid-prefix order of _candidates again.  Returns (corr_start, strand,
    cand_valid, n_cands, cmr_overflow)."""
    thresh = torch.ceil(best_g.to(torch.float32) * sensitivity).clamp(min=1)
    thresh = thresh.to(I32)
    if min_kmer_hits > 1:
        # the zero-CMR retry, gated on the GLOBAL best (DESIGN.md rule 15)
        need = torch.where(best_g < min_kmer_hits, 1, min_kmer_hits)
        thresh = torch.maximum(thresh, need.to(I32))
    valid = cand.cs_score >= thresh[:, None]
    order_key = torch.where(valid, cand.strand * (2**30) + cand.corr_start,
                            2**31 - 1)
    order = torch.sort(order_key, dim=1, stable=True).indices
    corr_start = torch.gather(cand.corr_start, 1, order)
    strand = torch.gather(cand.strand, 1, order)
    valid = torch.gather(valid, 1, order)
    n_cands = valid.sum(dim=1, dtype=I32)
    # a read lost an eligible candidate to C iff its (C+1)-th best local
    # count still clears the global threshold (eligibility is count >= thr)
    cmr_overflow = (cand.extra_score >= thresh).sum(dtype=I32)
    return corr_start, strand, valid, n_cands, cmr_overflow


def _scalars(dev, gopen_q, gopen_r, gext, sensitivity, min_identity,
             min_residues):
    """The steps' scalar arguments as their tails take them: int gap costs,
    float32 tensors for the rest (the reference's jnp.float32 arguments)."""
    return (int(gopen_q), int(gopen_r), int(gext), _f32(sensitivity, dev),
            _f32(min_identity, dev), _f32(min_residues, dev))


def _pair_args(dev, min_insert, max_insert, pair_cutoff):
    i32 = lambda x: torch.as_tensor(x, dtype=I32, device=dev)  # noqa: E731
    return i32(min_insert), i32(max_insert), _f32(pair_cutoff, dev)


def map_step_from_cands(genome, reads, lengths, matrices, gopen_q, gopen_r,
                        gext, sensitivity, min_identity, min_residues,
                        cand: CandState, best_g, rc, *, band,
                        min_kmer_hits=1, slot_cap=0, end_to_end=False,
                        simple_matrix=False) -> MapResult:
    """Phase 2 of the shard loop for one shard: the full single-end tail on
    the shard's candidates, re-gated by the cross-shard best best_g; rc is
    the batch's left-shifted reverse complement (_pre_extract's).  Equal to
    map_step with the global threshold, by the CandState invariant."""
    dev = reads.device
    lengths = lengths.to(I32)
    go_q, go_r, ge, sens, min_id, min_res = _scalars(
        dev, gopen_q, gopen_r, gext, sensitivity, min_identity, min_residues)
    corr_start, strand, cand_valid, n_cands, cmr_ovf = _regate_candidates(
        cand, best_g, sens, min_kmer_hits)
    return _single_tail(
        genome, reads, rc, lengths, matrices, go_q, go_r, ge, min_id,
        min_res, corr_start, strand, cand_valid, n_cands,
        (cand.fanout_overflow, cmr_ovf), band=band,
        slot_cap=slot_cap or default_slot_cap(reads.shape[0]),
        end_to_end=end_to_end, simple_matrix=simple_matrix,
    )


def map_step_paired_from_cands(genome, reads, lengths, matrices, gopen_q,
                               gopen_r, gext, sensitivity, min_identity,
                               min_residues, min_insert, max_insert,
                               pair_cutoff, cand: CandState, best_g, rc,
                               *, band, diag_bin_log2,
                               min_kmer_hits=1, slot_cap=0, end_to_end=False,
                               simple_matrix=False) -> MapResult:
    """Paired phase 2 of the shard loop for one shard."""
    dev = reads.device
    lengths = lengths.to(I32)
    go_q, go_r, ge, sens, min_id, min_res = _scalars(
        dev, gopen_q, gopen_r, gext, sensitivity, min_identity, min_residues)
    corr_start, strand, cand_valid, n_cands, cmr_ovf = _regate_candidates(
        cand, best_g, sens, min_kmer_hits)
    return _paired_tail(
        genome, reads, rc, lengths, matrices, go_q, go_r, ge, min_id,
        min_res, *_pair_args(dev, min_insert, max_insert, pair_cutoff),
        corr_start, strand, cand_valid, n_cands,
        (cand.fanout_overflow, cmr_ovf), band=band,
        slot_cap=slot_cap or default_slot_cap(reads.shape[0]),
        diag_bin_log2=diag_bin_log2, end_to_end=end_to_end,
        simple_matrix=simple_matrix,
    )


def map_step_topn_from_cands(genome, reads, lengths, matrices, gopen_q,
                             gopen_r, gext, sensitivity, min_identity,
                             min_residues, cand: CandState, best_g, rc,
                             *, band, topn=2, min_kmer_hits=1,
                             slot_cap=0, end_to_end=False,
                             simple_matrix=False) -> tuple:
    """Top-n phase 2 of the shard loop for one shard: the shard's own top
    ranks, which merge_sharded_topn interleaves (exact, because a global
    top-R entry is within its own shard's top R)."""
    dev = reads.device
    lengths = lengths.to(I32)
    go_q, go_r, ge, sens, min_id, min_res = _scalars(
        dev, gopen_q, gopen_r, gext, sensitivity, min_identity, min_residues)
    corr_start, strand, cand_valid, n_cands, cmr_ovf = _regate_candidates(
        cand, best_g, sens, min_kmer_hits)
    return _topn_tail(
        genome, reads, rc, lengths, matrices, go_q, go_r, ge, min_id,
        min_res, corr_start, strand, cand_valid, n_cands,
        (cand.fanout_overflow, cmr_ovf), band=band,
        slot_cap=slot_cap or default_topn_slot_cap(reads.shape[0]),
        topn=topn, end_to_end=end_to_end, simple_matrix=simple_matrix,
    )


def _global_shard_tail(genome_s, reads, rc, lengths, matrices, gopen_q,
                       gopen_r, gext, min_identity, min_residues,
                       cands: CandState, best_g, pair_args=None, *,
                       sensitivity, min_kmer_hits, band, slot_cap,
                       diag_bin_log2, end_to_end, simple_matrix, compact_cap):
    """The tails of all shards as ONE pool of `compact_cap` rows.

    Every (read, shard) group (a pair in paired mode) with re-gated
    candidates in that shard takes a row, shard-major then in read order,
    whichever shards the reads fall in: a position-sorted batch whose reads
    all lie in one shard needs B rows there, which per-shard budgets would
    starve.  The tail runs once over the pool with corridors gathered from
    the flattened [S * Gs] genome (a view of the stacked one; each shard's
    corr_start is already clipped to its own row, so no window crosses
    rows), and the rows scatter back to the [S, B] layout of the merge.
    Groups past the cap are counted in cmr_overflow.  Equal to the full
    per-shard tails whenever nothing overflows (the compaction is stable
    and every tail row is independent of the others).  The caller keeps
    S * Gs < 2^31, so corridor starts stay int32.
    """
    S, B, C = cands.corr_start.shape
    Gs = genome_s.shape[1]
    dev = reads.device
    best_t = best_g.repeat(S)
    corr_f, strand_f, valid_f, n_cands_f, cmr_total = _regate_candidates(
        CandState(cands.corr_start.reshape(S * B, C),
                  cands.strand.reshape(S * B, C),
                  cands.cs_score.reshape(S * B, C), best_t,
                  cands.fanout_overflow, cands.cmr_overflow,
                  cands.extra_score.reshape(S * B)),
        best_t, sensitivity, min_kmer_hits)
    keep = n_cands_f > 0                                   # [S*B]
    paired = pair_args is not None
    if paired:
        keep_g = keep.reshape(S * B // 2, 2).any(dim=1)
        cap_g, Bg = compact_cap // 2, B // 2
    else:
        keep_g, cap_g, Bg = keep, compact_cap, B
    # stable: kept groups first, shard-major then in read order (the order
    # the per-shard tails would process them in)
    order = torch.sort((~keep_g).to(I32), stable=True).indices
    n_keep = keep_g.sum(dtype=I32)
    sel_g = order[:cap_g]
    valid_g = torch.arange(cap_g, device=dev) < n_keep.clamp(max=cap_g)
    n_lost = (n_keep - cap_g).clamp(min=0)
    sid_g, row_g = sel_g // Bg, sel_g % Bg
    if paired:
        rows_b = torch.stack([row_g * 2, row_g * 2 + 1], dim=1).reshape(-1)
        sid = sid_g.repeat_interleave(2)
        row_valid = valid_g.repeat_interleave(2)
    else:
        rows_b, sid, row_valid = row_g, sid_g, valid_g
    rows_safe = torch.where(row_valid, rows_b, 0)
    sid_safe = torch.where(row_valid, sid, 0)
    flat_row = sid_safe * B + rows_safe

    reads_c = reads[rows_safe]
    rc_c = rc[rows_safe]
    lengths_c = torch.where(row_valid, lengths[rows_safe], 0)
    strand_c = strand_f[flat_row]
    valid_c = valid_f[flat_row] & row_valid[:, None]
    n_cands_c = torch.where(row_valid, n_cands_f[flat_row], 0)
    # shard-local corridor starts -> flattened stacked-genome coordinates
    row_base = (sid_safe * Gs).to(I32)
    corr_c = corr_f[flat_row] + row_base[:, None]
    genome_flat = genome_s.reshape(-1)
    ovf = (cands.fanout_overflow.sum(dtype=I32),
           cmr_total + n_lost * (2 if paired else 1))
    if paired:
        res_c = _paired_tail(
            genome_flat, reads_c, rc_c, lengths_c, matrices, gopen_q,
            gopen_r, gext, min_identity, min_residues, *pair_args,
            corr_c, strand_c, valid_c, n_cands_c, ovf, band=band,
            slot_cap=slot_cap, diag_bin_log2=diag_bin_log2,
            end_to_end=end_to_end, simple_matrix=simple_matrix,
        )
    else:
        res_c = _single_tail(
            genome_flat, reads_c, rc_c, lengths_c, matrices, gopen_q,
            gopen_r, gext, min_identity, min_residues, corr_c, strand_c,
            valid_c, n_cands_c, ovf, band=band, slot_cap=slot_cap,
            end_to_end=end_to_end, simple_matrix=simple_matrix,
        )
    # back to shard-local positions (the merge adds each shard's base)
    res_c = res_c._replace(
        pos=torch.where(row_valid, res_c.pos - row_base, 0))

    # scatter the rows back to [S, B]; rows no group filled keep zeroed
    # fields (score 0: the merge never takes them)
    scat_idx = torch.where(row_valid, sid * B + rows_b, S * B)

    def scat(x):
        buf = torch.zeros((S * B + 1,) + x.shape[1:], dtype=x.dtype,
                          device=dev)
        buf[scat_idx] = x
        return buf[:S * B].reshape((S, B) + x.shape[1:])

    fields = {}
    for name in MapResult._fields:
        v = getattr(res_c, name)
        if name in ("fanout_overflow", "cmr_overflow"):
            # the merge sums over the shard axis: totals ride shard 0
            fields[name] = torch.zeros(S, dtype=v.dtype, device=dev)
            fields[name][0] = v
        else:
            fields[name] = scat(v)
    return MapResult(**fields)


def _stack(items, cls):
    """A list of NamedTuples -> one of the same type, fields stacked on a
    new leading axis."""
    return cls(*(torch.stack([getattr(x, f) for x in items])
                 for f in cls._fields))


def shard_tail_cap(batch: int, n_shards: int) -> int:
    """Rows of the cross-shard tail pool (_global_shard_tail), 0 = full
    per-shard tails: 2B rows, at least 1024, rounded up to 256, and 0 once
    that reaches S * B.  Under the global threshold a read has candidates
    in about one shard, so 2B rows give 2x headroom whatever the reads'
    spread over the shards."""
    cap = -(-max(1024, 2 * batch) // 256) * 256
    return 0 if cap >= n_shards * batch else cap


def _shard_phase1(genome_s, off_s, pos_s, reads, lengths, sensitivity,
                  max_freq, cand_statics):
    """(stacked CandState [S, ...], global best [B], the batch's rc): the
    reads' k-mers are extracted once and every shard's CS runs on them."""
    pre = _pre_extract(reads, lengths, k=cand_statics["k"],
                       read_stride=cand_statics["read_stride"],
                       bs=cand_statics["bs"],
                       bs_cutoff=cand_statics["bs_cutoff"],
                       canonical=cand_statics["canonical"])
    cands = _stack([
        cs_cands_step(genome_s[s], off_s[s], pos_s[s], reads, lengths,
                      sensitivity, max_freq, pre, **cand_statics)
        for s in range(genome_s.shape[0])
    ], CandState)
    return cands, cands.best.max(dim=0).values, pre[0]


def map_step_sharded(
    genome_s, off_s, pos_s, base, core_lo, core_hi,
    reads, lengths, matrices, gopen_q, gopen_r, gext,
    sensitivity, max_freq, min_identity, min_residues,
    min_insert=None, max_insert=None, pair_cutoff=None,
    *, paired=False, read_len=0, compact_cap=0,
    k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, packed_offsets=False,
    simple_matrix=False, bs=False, bs_cutoff=0, end_to_end=False,
    canonical=True,
) -> MapResult:
    """The shard loop on one device (--index-shards S): phase 1 runs the CS
    of every shard (the stacked tables [S, ...] of parallel/index_shard.py's
    ShardTables), the cross-shard maximum of the best bucket counts sets the
    global adaptive threshold, phase 2 runs the tails, and the merge
    (parallel/index_shard.py::merge_sharded_results) picks each read's (or
    pair's) winner.  The merged `pos` is the int64 global position.

    Phase 2 is one cross-shard pool (_global_shard_tail) when
    0 < compact_cap < S * B and S * Gs < 2^31, else the full tail of each
    shard.  The two agree unless a cap overflows: the pool's lazy slot cap
    is max(512, compact_cap // 2) over the pool, a shard tail's
    max(512, B // 2) per shard.
    """
    dev = reads.device
    lengths = lengths.to(I32)
    go_q, go_r, ge, sens, min_id, min_res = _scalars(
        dev, gopen_q, gopen_r, gext, sensitivity, min_identity, min_residues)
    cand_statics = dict(
        k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, band=band, min_kmer_hits=min_kmer_hits,
        read_stride=read_stride, packed_offsets=packed_offsets, bs=bs,
        bs_cutoff=bs_cutoff, canonical=canonical,
    )
    tail = dict(band=band, min_kmer_hits=min_kmer_hits, slot_cap=slot_cap,
                end_to_end=end_to_end, simple_matrix=simple_matrix)
    cands, best_g, rc = _shard_phase1(genome_s, off_s, pos_s, reads, lengths,
                                      sens, max_freq, cand_statics)
    S, B = genome_s.shape[0], reads.shape[0]
    pair_args = (_pair_args(dev, min_insert, max_insert, pair_cutoff)
                 if paired else None)
    if compact_cap and compact_cap < S * B and S * genome_s.shape[1] < 2**31:
        stk = _global_shard_tail(
            genome_s, reads, rc, lengths, matrices, go_q, go_r, ge, min_id,
            min_res, cands, best_g, pair_args, sensitivity=sens,
            min_kmer_hits=min_kmer_hits, band=band,
            slot_cap=slot_cap or max(512, compact_cap // 2),
            diag_bin_log2=diag_bin_log2, end_to_end=end_to_end,
            simple_matrix=simple_matrix, compact_cap=compact_cap,
        )
    else:
        per_shard = []
        for s in range(S):
            c = CandState(*(f[s] for f in cands))
            if paired:
                r = map_step_paired_from_cands(
                    genome_s[s], reads, lengths, matrices, go_q, go_r, ge,
                    sens, min_id, min_res, *pair_args, c, best_g, rc,
                    diag_bin_log2=diag_bin_log2, **tail)
            else:
                r = map_step_from_cands(
                    genome_s[s], reads, lengths, matrices, go_q, go_r, ge,
                    sens, min_id, min_res, c, best_g, rc, **tail)
            per_shard.append(r)
        stk = _stack(per_shard, MapResult)
    return merge_sharded_results(stk, base, core_lo, core_hi, paired=paired,
                                 read_len=read_len)


def map_step_sharded_topn(
    genome_s, off_s, pos_s, base, core_lo, core_hi,
    reads, lengths, matrices, gopen_q, gopen_r, gext,
    sensitivity, max_freq, min_identity, min_residues,
    *, read_len=0, topn=2,
    k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, packed_offsets=False,
    simple_matrix=False, bs=False, bs_cutoff=0, end_to_end=False,
    canonical=True,
) -> tuple:
    """-n with --index-shards: the shard loop of map_step_sharded with each
    shard's top-n tail, then the rank merge
    (parallel/index_shard.py::merge_sharded_topn).  Returns `topn`
    MapResults, rank 0 first."""
    dev = reads.device
    lengths = lengths.to(I32)
    go_q, go_r, ge, sens, min_id, min_res = _scalars(
        dev, gopen_q, gopen_r, gext, sensitivity, min_identity, min_residues)
    cands, best_g, rc = _shard_phase1(
        genome_s, off_s, pos_s, reads, lengths, sens, max_freq,
        dict(k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
             diag_bin_log2=diag_bin_log2, band=band,
             min_kmer_hits=min_kmer_hits, read_stride=read_stride,
             packed_offsets=packed_offsets, bs=bs, bs_cutoff=bs_cutoff,
             canonical=canonical))
    per_shard = [
        _stack(map_step_topn_from_cands(
            genome_s[s], reads, lengths, matrices, go_q, go_r, ge, sens,
            min_id, min_res, CandState(*(f[s] for f in cands)), best_g, rc,
            band=band, topn=topn, min_kmer_hits=min_kmer_hits,
            slot_cap=slot_cap, end_to_end=end_to_end,
            simple_matrix=simple_matrix), MapResult)
        for s in range(genome_s.shape[0])
    ]                                       # [S] of MapResult fields [R, ...]
    return merge_sharded_topn(_stack(per_shard, MapResult), base, core_lo,
                              core_hi, topn=topn, read_len=read_len)


def score_matrices(cfg: NgmConfig) -> np.ndarray:
    """[2, 8, 8] int32 substitution matrices, selected per candidate by
    strand (they differ only in bisulfite mode)."""
    return np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])


def _on(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


class ShardColumn(NamedTuple):
    """One index shard's tables on one device of the ("dp", "ish") grid."""

    genome: torch.Tensor      # [Gs] uint8
    offsets: torch.Tensor     # [nb + 1] int32 (dual: [2 (nb + 1)])
    positions: torch.Tensor   # [Pmax] int32
    matrices: torch.Tensor    # [2, 8, 8] int32


# the statics of the candidate search (phase 1 of a shard step)
_CAND_STATICS = ("k", "fanout_cap", "hit_cap", "max_cmrs", "diag_bin_log2",
                 "band", "min_kmer_hits", "read_stride", "packed_offsets",
                 "bs", "bs_cutoff", "canonical")


class Mapper:
    """Owns the device-resident genome, index and matrices, and maps batches.

    index=None builds the index on `device`: canonical, or in bisulfite
    mode the CT- and GA-collapsed tables, concatenated.  A host index is
    carried across with convert.state_from_numpy instead: a KmerIndex
    (canonical or not), a (CT, GA) pair of KmerIndexes in bisulfite mode, or
    an (offsets, positions) pair of arrays (in bisulfite mode, the tables
    already concatenated).

    With cfg.index_shards = S > 1 the index is position-range sharded
    (parallel/index_shard.py): `index` is then a ShardedIndex, or the host
    KmerIndex (bisulfite: the (CT, GA) pair) to split.  On one device it
    holds one stacked copy of the shards (`shards`, a ShardTables; `state`
    is None), and every batch runs the shard loop of map_step_sharded.

    `device` is one device, with cfg.devices slots of it (``--devices``:
    that many cards, or CPU slots), or an explicit list of slots
    (parallel/mesh.py).  With several slots each batch splits into
    contiguous slices, one per slot, mapped in turn (parallel/dp.py)
    from a replica of the tables on each device; with S > 1 as well, the
    slots form the ("dp", "ish") grid [slots / S, S], each shard's tables
    on the devices of its column.  --shard-across-hosts places the grid
    across cfg.dist_nprocs processes, this one holding only its own
    columns' shards (`index` is then its ShardedIndex subset).
    """

    def __init__(self, cfg: NgmConfig, genome, read_len: int,
                 index: KmerIndex | ShardedIndex | tuple | None = None, *,
                 device: torch.device | str | list):
        self.cfg = cfg
        self.genome = genome
        self.read_len = read_len
        self.slots = device_slots(device, cfg.devices)
        self.devices = distinct(self.slots)
        self.device = self.slots[0]
        mats = score_matrices(cfg)
        self.simple_matrix = matrices_are_simple(mats)
        self.band = cfg.corridor_for(read_len)
        self.shards = None
        self._grid = None       # [dp][S'] ShardColumns of the grid step
        self._runner = None     # SliceRunner of the dp slices
        if cfg.index_shards > 1:
            self._init_sharded(index, mats)
            return
        codes = np.asarray(genome.codes)
        # canonical k-mers (one lookup serves both strands) unless the
        # strands need tables of their own: bisulfite, or a host index
        # built without canonical entries
        self.canonical = (not cfg.bs_mapping
                          and getattr(index, "canonical", True))
        if index is None:
            if codes.shape[0] >= 2**30:
                raise NotImplementedError(
                    "a genome of 2^30 bases or more maps with "
                    "--index-shards N (a host index split into N shards)"
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
        # from one table's positions: a bisulfite table is sized by the
        # collapsed 3^k estimate
        n_pos = self.state.positions.shape[0] // (2 if cfg.bs_mapping else 1)
        self.hit_cap = cfg.resolved_read_hits(n_pos, read_len)
        # one replica of the tables per device (the reference replicates
        # them over "dp")
        self._replicas = {self.device: (self.state, self._offsets)}
        for dev in self.devices[1:]:
            self._replicas[dev] = (
                MapperState(*(t.to(dev) for t in self.state)),
                self._offsets.to(dev))
        if len(self.slots) > 1:
            self._runner = SliceRunner([[d] for d in self.slots])

    def _init_sharded(self, index, mats) -> None:
        """Split (or take) the ShardedIndex and place one stacked copy of it
        on the device, or its shards on the grid's columns.  Offsets stay
        unpacked, as in the reference."""
        cfg = self.cfg
        S = cfg.index_shards
        layout = grid_layout(cfg, self.slots)
        codes = np.asarray(self.genome.codes)
        halo = ShardedIndex.halo_for(cfg)
        if isinstance(index, ShardedIndex):
            sidx = index
            if sidx.n_shards != S:
                raise ValueError(
                    f"sharded index has {sidx.n_shards} shards, want {S}")
            if sidx.dual != cfg.bs_mapping:
                raise ValueError("sharded index dual-table layout does not "
                                 "match --bs-mapping")
        elif cfg.bs_mapping:
            if not (isinstance(index, tuple) and len(index) == 2
                    and all(isinstance(x, KmerIndex) for x in index)):
                raise ValueError("bisulfite index sharding requires a "
                                 "(CT, GA) host-built KmerIndex pair")
            sidx = ShardedIndex.build_dual(*index, codes, S, halo)
        elif isinstance(index, KmerIndex):
            sidx = ShardedIndex.build(index, codes, S, halo)
        else:
            raise ValueError("index sharding requires a host-built KmerIndex")
        self.state = None
        self.canonical = sidx.canonical
        self.packed_offsets = False
        # the reference sizes the per-shard hit cap from the positions width
        # rounded up to whole 8-entry words (its TPU word-gather layout); a
        # dual table's width spans both collapsed tables.  The width is the
        # global one even in a subset, so every process takes the same cap
        width = -(-sidx.positions.shape[1] // 8) * 8
        self.hit_cap = cfg.resolved_read_hits(
            width // (2 if sidx.dual else 1), self.read_len)
        if layout is not None:
            self._init_grid(sidx, mats, *layout)
            return
        self.shards = ShardTables.from_index(sidx, self.device)
        self.matrices = torch.from_numpy(mats).to(self.device)

    def _init_grid(self, sidx, mats, rows, own) -> None:
        """Place shard s's tables on the devices of its column (once per
        device), and the merge's range metadata where the merge runs: the
        first device, or the host when the shards are gathered across
        processes."""
        cfg = self.cfg
        have = sidx.own_ids()
        if not set(own) <= set(have):
            raise ValueError(
                f"this host's devices need shards {own} but the local index "
                f"subset holds {have}")
        if cfg.shard_hosts:
            log_local_shards(sidx)
        cols: dict = {}

        def column(dev, s):
            if (dev, s) not in cols:
                i = have.index(s)
                cols[dev, s] = ShardColumn(*(
                    torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
                    for a, dt in ((sidx.genome[i], np.uint8),
                                  (sidx.offsets[i], np.int32),
                                  (sidx.positions[i], np.int32),
                                  (mats, np.int32))))
            return cols[dev, s]

        self._grid = [[column(dev, s) for dev, s in zip(row, own)]
                      for row in rows]
        self._exchange = ShardExchange(cfg.dist_nprocs if cfg.shard_hosts
                                       else 1)
        self._home = (torch.device("cpu") if self._exchange.nprocs > 1
                      else self.device)
        self._grid_meta = tuple(
            torch.from_numpy(np.asarray(a, np.int64)).to(self._home)
            for a in (sidx.base, sidx.core_lo, sidx.core_hi))
        self._runner = SliceRunner(rows)

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

    def _common_args(self, codes: np.ndarray, lengths: np.ndarray,
                     device: torch.device | None = None) -> tuple:
        """The positional arguments every step shares, for one [B, L] batch
        on `device` (default: the first): the tables (the six stacked ones
        when sharded), the reads, the matrices and the scalars."""
        cfg = self.cfg
        dev = device or self.device
        reads = _on(codes, np.uint8, dev)
        lens = _on(lengths, np.int32, dev)
        if self.shards is not None:
            tables, mats = tuple(self.shards), self.matrices
        else:
            st, off = self._replicas[dev]
            tables = (st.genome, off, st.positions)
            mats = st.matrices
        return (
            *tables, reads, lens, mats,
            cfg.gap_read_penalty, cfg.gap_ref_penalty, cfg.gap_extend_penalty,
            cfg.sensitivity, cfg.max_kmer_freq, cfg.min_identity,
            cfg.min_residues,
        )

    def tail_cap(self, batch: int) -> int:
        """Rows of the cross-shard tail pool for a batch (0: full per-shard
        tails).  Without --bs-mapping the reference's default shard loop
        takes shard_tail_cap's pool; with it, the reference's default loop
        runs full per-shard tails."""
        if self.cfg.bs_mapping:
            return 0
        return shard_tail_cap(batch, self.cfg.index_shards)

    def _map_sharded(self, codes, lengths, paired: bool) -> MapResult:
        cfg = self.cfg
        pair_args = ((cfg.min_insert_size, cfg.max_insert_size,
                      cfg.pair_score_cutoff) if paired else ())
        return map_step_sharded(
            *self._common_args(codes, lengths), *pair_args, paired=paired,
            read_len=self.read_len, compact_cap=self.tail_cap(codes.shape[0]),
            **self.statics(),
        )

    def _step(self, codes, lengths, paired: bool, device=None) -> MapResult:
        """The unsharded step on one device's replica."""
        args = self._common_args(codes, lengths, device)
        if not paired:
            return map_step(*args, **self.statics())
        cfg = self.cfg
        return map_step_paired(*args, cfg.min_insert_size,
                               cfg.max_insert_size, cfg.pair_score_cutoff,
                               **self.statics())

    def _map_dp(self, codes, lengths, paired: bool) -> MapResult:
        """The reference's dp step: one contiguous slice per slot, each
        mapped on its slot's device (its own slot caps, as under the
        reference's shard_map), concatenated in slice order on the first
        device with the overflow counters summed."""
        parts = split_batch(codes, lengths, len(self.slots), paired)
        outs = self._runner.run(
            lambda i: self._step(*parts[i], paired, self.slots[i]))
        return concat_results(outs, self.device)

    def _grid_phase1(self, d: int, codes, lengths):
        """Phase 1 of grid row d's slice: the CS of each of its shards on
        the shard's device, k-mers extracted once per device.  Returns
        ({device: (reads, lengths, _pre_extract)}, [CandState] per shard,
        the best bucket count over these shards on the row's first device)."""
        cfg = self.cfg
        st = self.statics()
        cand_statics = {k: st[k] for k in _CAND_STATICS}
        inputs, cands = {}, []
        for col in self._grid[d]:
            dev = col.genome.device
            if dev not in inputs:
                reads = _on(codes, np.uint8, dev)
                lens = _on(lengths, np.int32, dev)
                inputs[dev] = (reads, lens, _pre_extract(
                    reads, lens, k=cfg.kmer, read_stride=st["read_stride"],
                    bs=cfg.bs_mapping, bs_cutoff=cfg.bs_cutoff,
                    canonical=self.canonical))
            reads, lens, pre = inputs[dev]
            cands.append(cs_cands_step(
                col.genome, col.offsets, col.positions, reads, lens,
                cfg.sensitivity, cfg.max_kmer_freq, pre, **cand_statics))
        row_dev = self._grid[d][0].genome.device
        best = torch.stack([c.best.to(row_dev) for c in cands])
        return inputs, cands, best.max(dim=0).values

    def _grid_tails(self, d: int, inputs, cands, best, paired: bool):
        """Phase 2 of grid row d: each shard's FULL tail (the reference's
        mesh step runs map_step per shard, never a pool) re-gated by the
        cross-shard best, with slot caps from the slice; the per-shard
        results stacked [S', B_d] on the row's first device."""
        cfg = self.cfg
        row_dev = self._grid[d][0].genome.device
        tail = dict(band=self.band, min_kmer_hits=max(1, cfg.kmer_min),
                    end_to_end=cfg.end_to_end,
                    simple_matrix=self.simple_matrix)
        scalars = (cfg.gap_read_penalty, cfg.gap_ref_penalty,
                   cfg.gap_extend_penalty, cfg.sensitivity, cfg.min_identity,
                   cfg.min_residues)
        per_shard = []
        for col, cand in zip(self._grid[d], cands):
            dev = col.genome.device
            reads, lens, pre = inputs[dev]
            if paired:
                r = map_step_paired_from_cands(
                    col.genome, reads, lens, col.matrices, *scalars,
                    cfg.min_insert_size, cfg.max_insert_size,
                    cfg.pair_score_cutoff, cand, best.to(dev), pre[0],
                    diag_bin_log2=cfg.diag_bin_log2, **tail)
            else:
                r = map_step_from_cands(
                    col.genome, reads, lens, col.matrices, *scalars, cand,
                    best.to(dev), pre[0], **tail)
            per_shard.append(MapResult(*(t.to(row_dev) for t in r)))
        return _stack(per_shard, MapResult)

    def _map_grid(self, codes, lengths, paired: bool) -> MapResult:
        """The ("dp", "ish") step (the reference's
        make_index_sharded_map_step): phase 1 on each shard column of each
        row's slice; the per-read best counts maxed over every shard (a
        row's columns here, the other processes' shards through
        ShardExchange); each shard's full tail; the rows' per-shard results
        joined and gathered over the processes; merge_sharded_results over
        the whole batch.  In one process this runs on the first device;
        across processes on the host, where every process merges the same
        batch."""
        home = self._home
        parts = split_batch(codes, lengths, len(self._grid), paired)
        p1 = self._runner.run(lambda d: self._grid_phase1(d, *parts[d]))
        best = self._exchange.max_best(
            torch.cat([b.to(home) for *_, b in p1]))
        bests = torch.split(best, [c.shape[0] for c, _ in parts])
        stks = self._runner.run(lambda d: self._grid_tails(
            d, p1[d][0], p1[d][1], bests[d], paired))
        local = MapResult(*(
            torch.stack([getattr(s, f).to(home) for s in stks]).sum(
                dim=0, dtype=torch.int32) if f.endswith("overflow")
            else torch.cat([getattr(s, f).to(home) for s in stks], dim=1)
            for f in MapResult._fields))
        return merge_sharded_results(self._exchange.gather_shards(local),
                                     *self._grid_meta, paired=paired,
                                     read_len=self.read_len)

    def _map(self, codes, lengths, paired: bool) -> MapResult:
        if self._grid is not None:
            return self._map_grid(codes, lengths, paired)
        if self.shards is not None:
            return self._map_sharded(codes, lengths, paired)
        if self._runner is not None:
            return self._map_dp(codes, lengths, paired)
        return self._step(codes, lengths, paired)

    def map_batch(self, codes: np.ndarray, lengths: np.ndarray) -> MapResult:
        """Map one [B, L] batch; the result stays on the mapper's (first)
        device, or on the host after a cross-process merge."""
        return self._map(codes, lengths, paired=False)

    def map_batch_paired(self, codes: np.ndarray,
                         lengths: np.ndarray) -> MapResult:
        """Map one batch of pairs (rows 2i / 2i+1 are mates)."""
        return self._map(codes, lengths, paired=True)

    def supports_megabatch(self) -> bool:
        """--megabatch applies where the reference's does: on one device,
        unsharded or on the shard loop without --bs-mapping (the runner also
        leaves -n > 1 out).  The port dispatches a group's batches back to
        back with map_batch / map_batch_paired, so the results are the
        per-batch ones."""
        return (len(self.slots) == 1 and self._grid is None
                and (self.shards is None or not self.cfg.bs_mapping))

    def topn(self) -> int:
        """Ranks per read of map_batch_topn: -n, at most max_cmrs."""
        return min(self.cfg.topn, self.cfg.max_cmrs)

    def map_batch_topn(self, codes: np.ndarray, lengths: np.ndarray) -> tuple:
        """Map one batch with up to topn() ranked alignments per read, on
        the first device (the reference's, with several devices too)."""
        if self._grid is not None:
            raise ValueError(
                "--index-shards with -n/--topn > 1 runs on a single device "
                "(sequential shard loop); drop --devices")
        if self.shards is not None:
            return map_step_sharded_topn(
                *self._common_args(codes, lengths), read_len=self.read_len,
                topn=self.topn(), **self.statics())
        return map_step_topn(*self._common_args(codes, lengths),
                             topn=self.topn(), **self.statics())
