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
                   compaction, corridor fetch, SW score) -> argmax ->
                   the finish: winner corridor -> traceback -> filters +
                   MAPQ
  map_step_paired  lazy scoring of pairs where a mate has >= 2 candidates ->
                   CxC insert-window pair resolution (the pair select)
                   -> as above
  map_step_topn    eager scoring of every candidate -> stable top-R ranks ->
                   one compacted traceback of all ranks (K2 fetch)

`end_to_end` (--end-to-end) scores and aligns in glocal mode: the whole
read is aligned, with no clipping.

On a CUDA device the read front end (the rc and the k-mers) is the
hand-written kernel K5, the candidate search K6, every score pass, local or
glocal, the fused score pass (a plan kernel, then K1's row loops fed
straight from the reads and the genome), the paired step's pair
resolution the pair-select kernel, the single and paired steps'
finish the finish pass (K4's forward pass and walk, fed straight from the
step's tensors, the reads and the genome, with the filters and MAPQ in
one launch), and the top-n traceback the gather kernel K2 and K4; on the
CPU their wrappers run the plain PyTorch versions.  Every output equals
the reference's steps exactly (tests/test_torch_mapper.py,
tests/test_torch_paired.py, tests/test_torch_topn.py,
tests/test_torch_glocal.py, tests/test_torch_bisulfite.py,
tests/test_torch_long_reads.py).

The Mapper also runs the reference's several-device steps: the dp step
(each batch in contiguous slices, one per device slot) and the ("dp",
"ish") step of index shards on a grid of slots, within one process or
across processes (tests/test_torch_dp.py, tests/test_torch_dp_graphs.py,
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
from nextgenmap_tpu_torch.models.step_graph import (
    StepGraphs, leaves, rebuild, take,
)
from nextgenmap_tpu_torch.ops.candidate import pack_offsets
from nextgenmap_tpu_torch.ops.candidate_kernel import candidate_search
from nextgenmap_tpu_torch.ops.finish_kernel import (
    MapResult, filters_and_mapq, finish_pass,
)
from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
from nextgenmap_tpu_torch.ops.kmer_kernel import read_kmers
from nextgenmap_tpu_torch.ops.pair_kernel import pair_select
from nextgenmap_tpu_torch.ops.score_pass_kernel import (
    compact_slots, score_pass,
)
from nextgenmap_tpu_torch.ops.scoring import score_matrix
from nextgenmap_tpu_torch.ops.sw_align_kernel import sw_align
from nextgenmap_tpu_torch.parallel.dp import (
    join_slices, pick, slices_by_device, split_batch,
)
from nextgenmap_tpu_torch.parallel.index_shard import (
    ShardedIndex, ShardExchange, ShardTables, grid_layout, log_local_shards,
    merge_sharded_results, merge_sharded_topn,
)
from nextgenmap_tpu_torch.parallel.mesh import device_slots, distinct
from nextgenmap_tpu_torch.utils import trace

I32 = torch.int32


def _pre_extract(reads, lengths, *, k, read_stride=1, bs=False, bs_cutoff=0,
                 canonical=True):
    """Left-shifted reverse complements and the read k-mers: canonical
    (canon, flip, ok), or (km_f, ok_f, km_r, ok_r) of the two strands, which
    bisulfite collapses C->T (forward) and G->A (reverse complement) with
    the --bs-cutoff drop (kernel K5 on the card).  They depend on the reads
    only, so the shard loop extracts them once for every shard."""
    return read_kmers(reads.contiguous(), lengths.to(I32).contiguous(), k=k,
                      stride=read_stride, bs=bs, bs_cutoff=bs_cutoff,
                      canonical=canonical)


def _candidates(genome, offsets, positions, reads, lengths, sensitivity,
                max_freq, pre=None, *, k, fanout_cap, hit_cap, max_cmrs,
                diag_bin_log2, band, min_kmer_hits, read_stride=1,
                packed_offsets=False, bs=False, bs_cutoff=0, canonical=True,
                traced=False):
    """CS on both strands -> candidates ordered by (strand, corridor start).

    Valid candidates form a per-read prefix after the ordering (DESIGN.md
    rule 11).  Returns (corr_start, strand, cand_valid, cs_score [B, C] the
    bucket hit counts in the same order, n_cands, rc, best [B] the best
    bucket count, (fanout + hit overflow, cmr overflow), extra_score [B] the
    (C+1)-th best eligible count).  `pre` is _pre_extract's result when the
    caller already has it.  `traced`: add the search's hit-capped reads to
    utils/trace.py's counters.
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
    # (kernel K6 on the card)
    cand = candidate_search(
        kms, lengths, offsets, positions, sensitivity, max_freq, k=k,
        fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, stride=read_stride,
        packed_offsets=packed_offsets, dual_tables=bs,
    )
    if traced:
        trace.count_hits(cand.hit_overflow)
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
                      *, band, slot_cap, end_to_end=False, pairs=False,
                      traced=False):
    """Banded-SW score the candidates of the reads selected by `score_mask`
    ([B], or with `pairs` [B / 2]: rows 2i and 2i + 1 share entry i).

    Lazy scoring: a read with one candidate needs no comparison and skips
    this pass (its score comes from the traceback).  The (read, candidate)
    pairs of the masked reads are compacted batch-wide into `slot_cap`
    slots, scored once each, and the scores land in a dense [B, C] grid (0
    where unscored): the fused score pass on the card (two kernels), its
    plain version on the CPU (ops/score_pass_kernel.py).
    `traced`: add the pass to utils/trace.py's score counters.
    Returns (sw, slot_overflow).
    """
    res = score_pass(
        genome, reads.contiguous(), rc.contiguous(), lengths.contiguous(),
        corr_start.contiguous(), strand.contiguous(), cand_valid.contiguous(),
        score_mask.contiguous(), matrices, gopen_q, gopen_r, gext, band=band,
        slot_cap=slot_cap, mode=_sw_mode(end_to_end), pairs=pairs,
    )
    if traced:
        trace.count_scores(res.n_sc, res.base, slot_cap)
    return res.sw, res.slot_overflow


def _finish(a1, sw, corr_start, strand, cand_valid, genome, reads, rc,
            lengths, matrices, gopen_q, gopen_r, gext, min_identity,
            min_residues, n_cands, overflow, proper, *, band,
            end_to_end=False, traced=False):
    """Traceback the chosen candidate a1 [B] and apply filters + MAPQ;
    `proper` [B] (the pair resolution's verdict) is gated by `mapped`: the
    finish pass on the card (one launch), its plain version on the CPU
    (ops/finish_kernel.py).  `traced`: the inner phase ``align``
    (utils/trace.py) spans the pass."""
    if traced:
        trace.mark_inner("align", reads.device, close=False)
    res = finish_pass(
        a1, sw.contiguous(), corr_start.contiguous(), strand.contiguous(),
        cand_valid.contiguous(), genome, reads.contiguous(), rc.contiguous(),
        lengths.contiguous(), matrices, gopen_q, gopen_r, gext, min_identity,
        min_residues, n_cands, overflow, proper.contiguous(), band=band,
        mode=_sw_mode(end_to_end),
    )
    if traced:
        trace.mark_inner("align", reads.device, close=True)
    return res


def _single_tail(genome, reads, rc, lengths, matrices, gopen_q, gopen_r,
                 gext, min_identity, min_residues, corr_start, strand,
                 cand_valid, n_cands, overflow, *, band, slot_cap,
                 end_to_end=False, traced=False):
    """Lazy scoring, rule-11 argmax selection, traceback + filters;
    `traced`: count the score pass and mark the ends of its phases
    (utils/trace.py)."""
    dev = reads.device
    sw, slot_ovf = _score_candidates(
        genome, reads, rc, lengths, corr_start, strand, cand_valid,
        n_cands >= 2, matrices, gopen_q, gopen_r, gext,
        band=band, slot_cap=slot_cap, end_to_end=end_to_end,
        traced=traced,
    )
    if traced:
        trace.mark("score", dev)
    overflow = (overflow[0], overflow[1] + slot_ovf)
    # first max = score DESC, fwd first, pos ASC; an all-zero (lazy) row
    # picks candidate 0, the read's only candidate after prefix ordering
    a1 = torch.argmax(sw, dim=1)
    proper = torch.zeros(reads.shape[0], dtype=torch.bool, device=dev)
    if traced:
        trace.mark("select", dev)
    res = _finish(
        a1, sw, corr_start, strand, cand_valid, genome, reads, rc, lengths,
        matrices, gopen_q, gopen_r, gext, min_identity, min_residues,
        n_cands, overflow, proper, band=band, end_to_end=end_to_end,
        traced=traced,
    )
    if traced:
        trace.mark("finish", dev)
    return res


def default_slot_cap(batch: int) -> int:
    """Score-pass slots: most reads have one candidate and need none;
    overflow is counted, so a repeat-dense genome is visible, not silent."""
    return max(512, batch // 2)


def _f32(x, device) -> torch.Tensor:
    """A float32 scalar tensor, like the reference's jnp.float32 arguments,
    so that comparisons against it round as the reference's do.  A float32
    tensor on `device` is taken as it is; a Python number is copied there,
    a synchronising copy on a card (the Mapper passes its `Scalars`)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _front(genome, offsets, positions, reads, lengths, sensitivity, max_freq,
           traced=False, **cand_statics):
    """What every step shares: (int32 lengths, rc, (corr_start, strand,
    cand_valid, n_cands, overflow)), the ordered candidates of both strands.
    `traced`: count the search's hit-capped reads (utils/trace.py)."""
    lengths = lengths.to(I32)
    corr_start, strand, cand_valid, _, n_cands, rc, _, overflow, _ = _candidates(
        genome, offsets, positions, reads, lengths,
        _f32(sensitivity, reads.device), int(max_freq), traced=traced,
        **cand_statics,
    )
    return lengths, rc, (corr_start, strand, cand_valid, n_cands, overflow)


def map_step(
    genome, offsets, positions, reads, lengths, matrices,
    gopen_q, gopen_r, gext, sensitivity, max_freq, min_identity, min_residues,
    *, k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, packed_offsets=False,
    bs=False, bs_cutoff=0, end_to_end=False, canonical=True,
) -> MapResult:
    """Single-end mapping step (DESIGN.md rule 11 selection) on the device
    that holds `reads`.  sensitivity, min_identity and min_residues are
    taken as float32, like the reference's jnp.float32 arguments.  While
    `reads`' device is traced (utils/trace.py) the step marks its phases
    and its traceback and counts its score pass and hit-capped reads."""
    dev = reads.device
    traced = trace.on(dev)
    if traced:
        trace.mark("start", dev)
    go_q, go_r, ge, sens, min_id, min_res = _scalars(
        dev, gopen_q, gopen_r, gext, sensitivity, min_identity, min_residues)
    lengths, rc, cands = _front(
        genome, offsets, positions, reads, lengths, sens, max_freq,
        traced, k=k, fanout_cap=fanout_cap, hit_cap=hit_cap,
        max_cmrs=max_cmrs, diag_bin_log2=diag_bin_log2, band=band,
        min_kmer_hits=min_kmer_hits, read_stride=read_stride,
        packed_offsets=packed_offsets, bs=bs, bs_cutoff=bs_cutoff,
        canonical=canonical,
    )
    if traced:
        trace.mark("front", dev)
    return _single_tail(
        genome, reads, rc, lengths, matrices, go_q, go_r, ge, min_id,
        min_res, *cands, band=band,
        slot_cap=slot_cap or default_slot_cap(reads.shape[0]),
        end_to_end=end_to_end, traced=traced,
    )


def _paired_tail(genome, reads, rc, lengths, matrices, gopen_q, gopen_r,
                 gext, min_identity, min_residues, min_insert, max_insert,
                 pair_cutoff, corr_start, strand, cand_valid, n_cands,
                 overflow, *, band, slot_cap, diag_bin_log2,
                 end_to_end=False, traced=False):
    """Lazy scoring of multi-candidate pairs, CxC insert-window pair
    resolution, traceback + filters.  Rows 2i / 2i+1 are the mates of pair i.
    `traced`: count the score pass and the pair select and mark the ends of
    its phases (utils/trace.py)."""
    B, L = reads.shape
    bin_w = 1 << diag_bin_log2

    pair_multi = n_cands.reshape(B // 2, 2).amax(dim=1) >= 2  # a mate has >= 2
    sw, slot_ovf = _score_candidates(
        genome, reads, rc, lengths, corr_start, strand, cand_valid,
        pair_multi, matrices, gopen_q, gopen_r, gext,
        band=band, slot_cap=slot_cap, end_to_end=end_to_end,
        pairs=True, traced=traced,
    )
    if traced:
        trace.mark("score", reads.device)

    # the C x C grid, the resolution and the fallback (ops/pair_kernel.py);
    # a candidate's approximate alignment start is corr_start + slack
    pairing = pair_select(
        sw, corr_start.contiguous(), strand.contiguous(),
        cand_valid.contiguous(), n_cands.contiguous(), min_insert,
        max_insert, pair_cutoff, read_len=L, slack=(band - 2 * bin_w) // 2,
        margin=2 * bin_w,
        counters=trace.pair_counters(reads.device) if traced else None,
    )
    if traced:
        trace.mark("select", reads.device)
    # the slot overflow's add runs after the mark: `select` is one kernel
    overflow = (overflow[0], overflow[1] + slot_ovf)
    res = _finish(
        pairing.a1, sw, corr_start, strand, cand_valid, genome, reads, rc,
        lengths, matrices, gopen_q, gopen_r, gext, min_identity,
        min_residues, n_cands, overflow, pairing.proper, band=band,
        end_to_end=end_to_end, traced=traced,
    )
    if traced:
        trace.mark("finish", reads.device)
    return res


def map_step_paired(
    genome, offsets, positions, reads, lengths, matrices,
    gopen_q, gopen_r, gext, sensitivity, max_freq, min_identity, min_residues,
    min_insert, max_insert, pair_cutoff,
    *, k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, packed_offsets=False,
    bs=False, bs_cutoff=0, end_to_end=False, canonical=True,
) -> MapResult:
    """Paired-end step: rows 2i / 2i+1 are mates (DESIGN.md rule 13).

    Pairs resolve on candidate scores before the traceback: a CxC
    combined-score argmax over an FR-orientation + insert-window mask,
    falling back to the best singletons when no pair clears
    pair_cutoff * (best1 + best2) (a broken pair).  A pair whose mates both
    have one candidate is not scored.  min_insert / max_insert are taken as
    int32 and pair_cutoff as float32, like the reference's arguments.
    Traced as map_step is.
    """
    dev = reads.device
    traced = trace.on(dev)
    if traced:
        trace.mark("start", dev)
    go_q, go_r, ge, sens, min_id, min_res = _scalars(
        dev, gopen_q, gopen_r, gext, sensitivity, min_identity, min_residues)
    lengths, rc, cands = _front(
        genome, offsets, positions, reads, lengths, sens, max_freq,
        traced, k=k, fanout_cap=fanout_cap, hit_cap=hit_cap,
        max_cmrs=max_cmrs, diag_bin_log2=diag_bin_log2, band=band,
        min_kmer_hits=min_kmer_hits, read_stride=read_stride,
        packed_offsets=packed_offsets, bs=bs, bs_cutoff=bs_cutoff,
        canonical=canonical,
    )
    if traced:
        trace.mark("front", dev)
    return _paired_tail(
        genome, reads, rc, lengths, matrices, go_q, go_r, ge, min_id,
        min_res, *_pair_args(dev, min_insert, max_insert, pair_cutoff),
        *cands, band=band,
        slot_cap=slot_cap or default_slot_cap(reads.shape[0]),
        diag_bin_log2=diag_bin_log2, end_to_end=end_to_end,
        traced=traced,
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
               end_to_end=False):
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

    # compact the valid (read, rank) pairs into slot_cap slots as the score
    # pass compacts its pairs; j_of is the rank (validity is a prefix)
    n_r = rvalid.sum(dim=1, dtype=I32)
    _, total, slot_valid, b_of, j_of = compact_slots(n_r, slot_cap)
    slot2_ovf = (total > slot_cap).to(I32)
    b_safe = torch.where(slot_valid, b_of, 0).long()
    flat_bj = torch.where(slot_valid, b_of * R + j_of, 0).long()

    start_s = t_start.reshape(-1)[flat_bj]
    strand_s = t_strand.reshape(-1)[flat_bj]
    starts = torch.where(slot_valid, start_s, 0).clamp(0, max(0, G - T))
    # the ranks' corridors (kernel K2 on the card)
    corr_s = gather_genome_windows(genome, starts.to(I32).contiguous(), T)
    corr_s = torch.where(slot_valid[:, None], corr_s, 4).to(torch.uint8)
    q_s = torch.where((strand_s == 1)[:, None], rc[b_safe], reads[b_safe])
    # (kernel K4 on the card)
    ares = sw_align(
        q_s, lengths[b_safe], corr_s, matrices, gopen_q, gopen_r, gext,
        strand_s, band=band, mode=_sw_mode(end_to_end),
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

    results = []
    for j in range(R):
        s1 = g_score[:, j]
        mapped, mapq = filters_and_mapq(
            s1, s2[:, j], g_match[:, j], g_nops[:, j], g_qs[:, j],
            g_qe[:, j], lengths, g_trunc[:, j], min_identity, min_residues)
        results.append(MapResult(
            mapped=mapped,
            strand=t_strand[:, j],
            pos=t_start[:, j] + g_rs[:, j],
            mapq=mapq,
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
    topn=2, bs=False, bs_cutoff=0, end_to_end=False, canonical=True,
) -> tuple:
    """Single-end mapping with up to `topn` alignments per read (-n).

    Returns `topn` MapResults ordered score DESC (DESIGN.md rule 11 ties);
    rank j is valid for a read where its score > 0.  The host emitter
    applies --strata and near-duplicate suppression and marks ranks 1.. as
    SAM secondaries.  Ranking needs every candidate's score, so scoring is
    eager (slot_cap defaults to 2B), and the same slot_cap bounds the
    compacted traceback of the valid ranks.
    """
    go_q, go_r, ge, sens, min_id, min_res = _scalars(
        reads.device, gopen_q, gopen_r, gext, sensitivity, min_identity,
        min_residues)
    lengths, rc, cands = _front(
        genome, offsets, positions, reads, lengths, sens, max_freq,
        k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, band=band, min_kmer_hits=min_kmer_hits,
        read_stride=read_stride, packed_offsets=packed_offsets, bs=bs,
        bs_cutoff=bs_cutoff, canonical=canonical,
    )
    return _topn_tail(
        genome, reads, rc, lengths, matrices, go_q, go_r, ge, min_id,
        min_res, *cands, band=band,
        slot_cap=slot_cap or default_topn_slot_cap(reads.shape[0]),
        topn=topn, end_to_end=end_to_end,
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
                        min_kmer_hits=1, slot_cap=0,
                        end_to_end=False) -> MapResult:
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
        end_to_end=end_to_end,
    )


def map_step_paired_from_cands(genome, reads, lengths, matrices, gopen_q,
                               gopen_r, gext, sensitivity, min_identity,
                               min_residues, min_insert, max_insert,
                               pair_cutoff, cand: CandState, best_g, rc,
                               *, band, diag_bin_log2,
                               min_kmer_hits=1, slot_cap=0,
                               end_to_end=False) -> MapResult:
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
    )


def map_step_topn_from_cands(genome, reads, lengths, matrices, gopen_q,
                             gopen_r, gext, sensitivity, min_identity,
                             min_residues, cand: CandState, best_g, rc,
                             *, band, topn=2, min_kmer_hits=1,
                             slot_cap=0, end_to_end=False) -> tuple:
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
        topn=topn, end_to_end=end_to_end,
    )


def _global_shard_tail(genome_s, reads, rc, lengths, matrices, gopen_q,
                       gopen_r, gext, min_identity, min_residues,
                       cands: CandState, best_g, pair_args=None, *,
                       sensitivity, min_kmer_hits, band, slot_cap,
                       diag_bin_log2, end_to_end, compact_cap):
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
            end_to_end=end_to_end,
        )
    else:
        res_c = _single_tail(
            genome_flat, reads_c, rc_c, lengths_c, matrices, gopen_q,
            gopen_r, gext, min_identity, min_residues, corr_c, strand_c,
            valid_c, n_cands_c, ovf, band=band, slot_cap=slot_cap,
            end_to_end=end_to_end,
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
    bs=False, bs_cutoff=0, end_to_end=False, canonical=True,
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
                end_to_end=end_to_end)
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
            compact_cap=compact_cap,
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
    bs=False, bs_cutoff=0, end_to_end=False, canonical=True,
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
            slot_cap=slot_cap, end_to_end=end_to_end), MapResult)
        for s in range(genome_s.shape[0])
    ]                                       # [S] of MapResult fields [R, ...]
    return merge_sharded_topn(_stack(per_shard, MapResult), base, core_lo,
                              core_hi, topn=topn, read_len=read_len)


class Scalars(NamedTuple):
    """The steps' float scalars as float32 and the insert bounds as int32
    tensors on one device, made once (the reference's jnp.float32 and
    jnp.int32 arguments): from a Python number each step call would copy
    them to the card, a synchronising copy that no graph can capture."""

    sensitivity: torch.Tensor
    min_identity: torch.Tensor
    min_residues: torch.Tensor
    pair_cutoff: torch.Tensor
    min_insert: torch.Tensor
    max_insert: torch.Tensor

    @classmethod
    def of(cls, cfg: NgmConfig, device) -> "Scalars":
        return cls(*(_f32(x, device) for x in (
            cfg.sensitivity, cfg.min_identity, cfg.min_residues,
            cfg.pair_score_cutoff)), *(
            torch.tensor(x, dtype=I32, device=device)
            for x in (cfg.min_insert_size, cfg.max_insert_size)))


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
    contiguous slices, one per slot (parallel/dp.py), mapped from a replica
    of the tables on each device; with S > 1 as well, the slots form the
    ("dp", "ish") grid [slots / S, S] (`_grid`, its rows of devices), each
    shard's tables on the devices of its column.  --shard-across-hosts
    places the grid across cfg.dist_nprocs processes, this one holding only
    its own columns' shards (`index` is then its ShardedIndex subset).

    Every step runs through `graphs` (models/step_graph.py): on a card one
    captured CUDA graph per step and device, on the CPU the eager step.
    On one slot that is each step (map_batch, map_batch_paired,
    map_batch_topn, the shard loop, map_batch_scan); the dp step is one
    graph per distinct device, its slices stacked K; a grid on one device
    in one process is one graph of its rows, each row the shard loop with
    full per-shard tails on the row's slice; a grid across devices or
    processes is a phase-1 graph per device, the cross-shard best maxed
    on the host, and a phase-2 graph per device.  The tools and the tests
    that want the eager step on a card replace `graphs` with
    ``StepGraphs(device, eager=True)``; that makes every step eager.
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
        self.graphs = StepGraphs(self.device)
        self._scalars = {d: Scalars.of(cfg, d) for d in self.devices}
        mats = score_matrices(cfg)
        self.band = cfg.corridor_for(read_len)
        self.shards = None
        self._grid = None       # [dp][S'] devices of the grid's rows
        # {device: its slices} of a batch split over slots: the dp slots,
        # or a one-device grid's rows
        self._groups = None
        self._plan = None       # {device: its share} of a phased grid
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
            self._groups = slices_by_device(self.slots)

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
        if layout is not None and self._init_grid(sidx, mats, *layout):
            return
        self.shards = ShardTables.from_index(sidx, self.device)
        self.matrices = torch.from_numpy(mats).to(self.device)

    def _init_grid(self, sidx, mats, rows, own) -> bool:
        """The ("dp", "ish") grid of `rows` [dp][S'] (devices) over the
        shards `own`.  On one device in one process the rows are the
        batch's slices, and False: the grid takes the shard loop's one
        stacked copy of the shards.  Else True, with shard s's tables on
        the devices of its column (once per device), each device's share
        of the grid (`_plan`: {device: [(row, [(column, ShardColumn)])]},
        rows in order), and the merge's range metadata where the merge
        runs: the first device, or the host when the shards are gathered
        across processes."""
        cfg = self.cfg
        have = sidx.own_ids()
        if not set(own) <= set(have):
            raise ValueError(
                f"this host's devices need shards {own} but the local index "
                f"subset holds {have}")
        if cfg.shard_hosts:
            log_local_shards(sidx)
        self._grid = rows
        self._exchange = ShardExchange(cfg.dist_nprocs if cfg.shard_hosts
                                       else 1)
        devices = distinct([d for row in rows for d in row])
        if len(devices) == 1 and self._exchange.nprocs == 1:
            self._groups = {self.device: list(range(len(rows)))}
            return False
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

        plan: dict = {}
        for d, row in enumerate(rows):
            for j, (dev, s) in enumerate(zip(row, own)):
                plan.setdefault(dev, {}).setdefault(d, []).append(
                    (j, column(dev, s)))
        self._plan = {dev: list(share.items()) for dev, share in plan.items()}
        self._home = (torch.device("cpu") if self._exchange.nprocs > 1
                      else self.device)
        self._grid_meta = tuple(
            torch.from_numpy(np.asarray(a, np.int64)).to(self._home)
            for a in (sidx.base, sidx.core_lo, sidx.core_hi))
        return True

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
            packed_offsets=self.packed_offsets, bs=cfg.bs_mapping,
            bs_cutoff=cfg.bs_cutoff, end_to_end=cfg.end_to_end,
            canonical=self.canonical,
        )

    def _tables(self, dev) -> tuple:
        """(the tables a step takes before the reads: the six stacked ones
        when sharded, the matrices) on `dev`."""
        if self.shards is not None:
            return tuple(self.shards), self.matrices
        st, off = self._replicas[dev]
        return (st.genome, off, st.positions), st.matrices

    def _scalar_args(self, dev, paired: bool = False) -> tuple:
        """The positional arguments a step takes after the matrices: the
        integer gap costs and max_freq as Python ints (statics of a graph),
        the float scalars (and the paired step's insert bounds and cutoff)
        as this device's tensors."""
        cfg = self.cfg
        s = self._scalars[dev]
        args = (cfg.gap_read_penalty, cfg.gap_ref_penalty,
                cfg.gap_extend_penalty, s.sensitivity, cfg.max_kmer_freq,
                s.min_identity, s.min_residues)
        return args + ((s.min_insert, s.max_insert, s.pair_cutoff)
                       if paired else ())

    def _common_args(self, codes: np.ndarray, lengths: np.ndarray,
                     device: torch.device | None = None,
                     paired: bool = False) -> tuple:
        """The positional arguments of a step, for one [B, L] batch on
        `device` (default: the first): the tables, the reads, the matrices
        and the scalars, with the paired step's three more if `paired`."""
        dev = device or self.device
        tables, mats = self._tables(dev)
        return (*tables, _on(codes, np.uint8, dev), _on(lengths, np.int32, dev),
                mats, *self._scalar_args(dev, paired))

    def tail_cap(self, batch: int) -> int:
        """Rows of the cross-shard tail pool for a batch (0: full per-shard
        tails).  Without --bs-mapping the reference's default shard loop
        takes shard_tail_cap's pool; with it, the reference's default loop
        runs full per-shard tails, and so do the grid's rows (the
        reference's mesh step never pools)."""
        if self.cfg.bs_mapping or self._grid is not None:
            return 0
        return shard_tail_cap(batch, self.cfg.index_shards)

    def _run_steps(self, codes_k, lengths_k, paired: bool = False,
                   topn: int = 0, device=None):
        """The one-device step (unsharded, or the shard loop; paired, or
        top-n with `topn` ranks) on each of K batches, codes_k [K, B, L]
        and lengths_k [K, B] (numpy, taken on the host without a copy, or
        tensors on any device), through `graphs`, on `device`'s replica of
        the tables (default: the first device's): the results stacked
        [K, ...] on that device."""
        reads_k = torch.as_tensor(codes_k).to(torch.uint8)
        lens_k = torch.as_tensor(lengths_k).to(I32)
        dev = self.device if device is None else device
        tables, mats = self._tables(dev)
        scalars = self._scalar_args(dev, paired)
        kw = self.statics()
        if self.shards is not None:
            kw["read_len"] = self.read_len
            if topn:
                name, fn = "map_step_sharded_topn", map_step_sharded_topn
                kw["topn"] = topn
            else:
                name, fn = "map_step_sharded", map_step_sharded
                kw.update(paired=paired,
                          compact_cap=self.tail_cap(reads_k.shape[1]))
        elif topn:
            name, fn = "map_step_topn", map_step_topn
            kw["topn"] = topn
        elif paired:
            name, fn = "map_step_paired", map_step_paired
        else:
            name, fn = "map_step", map_step

        def step(reads, lengths):
            return fn(*tables, reads, lengths, mats, *scalars, **kw)

        return self.graphs.run(name, step, reads_k, lens_k, device=dev, **kw)

    def _map_dp(self, codes, lengths, paired: bool) -> MapResult:
        """The reference's dp step, or the rows of a grid on one device:
        one contiguous slice per slot (per row), the K slices of each
        device as one step of K batches (one graph on a card), each slice a
        step with its own slot caps, as under the reference's shard_map;
        joined in slot order on the first device, the overflow counters
        summed."""
        n = sum(len(ix) for ix in self._groups.values())
        reads, lens = split_batch(codes, lengths, n, paired)
        return join_slices({
            dev: self._run_steps(pick(reads, ix), pick(lens, ix), paired,
                                 device=dev)
            for dev, ix in self._groups.items()}, self._groups, self.device)

    def _phase1_step(self, dev, share, b: int):
        """Phase 1 of `dev`'s share of the grid, a step on the slices of its
        rows ([n b, L], row after row): per row, (its columns' CandStates,
        the row's rc), and each read's best bucket count over these
        columns [n b].  The k-mers are extracted once per row."""
        cfg, st = self.cfg, self.statics()
        cand_statics = {k: st[k] for k in _CAND_STATICS}
        sens = self._scalars[dev].sensitivity

        def step(reads, lengths):
            carry, best = [], []
            for i, (_, cols) in enumerate(share):
                r, n = reads[i * b:(i + 1) * b], lengths[i * b:(i + 1) * b]
                pre = _pre_extract(r, n, k=cfg.kmer,
                                   read_stride=st["read_stride"],
                                   bs=cfg.bs_mapping, bs_cutoff=cfg.bs_cutoff,
                                   canonical=self.canonical)
                cands = tuple(cs_cands_step(
                    col.genome, col.offsets, col.positions, r, n, sens,
                    cfg.max_kmer_freq, pre, **cand_statics) for _, col in cols)
                carry.append((cands, pre[0]))
                best.append(torch.stack([c.best for c in cands]).max(
                    dim=0).values)
            return tuple(carry), torch.cat(best)

        return step

    def _phase2_step(self, dev, share, b: int, paired: bool, carry):
        """Phase 2 of `dev`'s share, a step on its rows' slices, the
        cross-shard best [n b] and phase 1's `carry` (flat, in its leaf
        order): each column's FULL tail (the reference's mesh step runs
        map_step per shard, never a pool) re-gated by the best, with slot
        caps from the row's slice; per row its columns' results stacked
        [columns, b]."""
        cfg = self.cfg
        s = self._scalars[dev]
        scalars = (cfg.gap_read_penalty, cfg.gap_ref_penalty,
                   cfg.gap_extend_penalty, s.sensitivity, s.min_identity,
                   s.min_residues)
        tail = dict(band=self.band, min_kmer_hits=max(1, cfg.kmer_min),
                    end_to_end=cfg.end_to_end)

        def step(reads, lengths, best, *flat):
            out = []
            for i, ((_, cols), (cands, rc)) in enumerate(
                    zip(share, rebuild(carry, iter(flat)))):
                r, n = reads[i * b:(i + 1) * b], lengths[i * b:(i + 1) * b]
                bst = best[i * b:(i + 1) * b]
                per_shard = []
                for (_, col), cand in zip(cols, cands):
                    if paired:
                        res = map_step_paired_from_cands(
                            col.genome, r, n, col.matrices, *scalars,
                            s.min_insert, s.max_insert, s.pair_cutoff, cand,
                            bst, rc, diag_bin_log2=cfg.diag_bin_log2, **tail)
                    else:
                        res = map_step_from_cands(
                            col.genome, r, n, col.matrices, *scalars, cand,
                            bst, rc, **tail)
                    per_shard.append(res)
                out.append(_stack(per_shard, MapResult))
            return tuple(out)

        return step

    def _map_grid(self, codes, lengths, paired: bool) -> MapResult:
        """The ("dp", "ish") step (the reference's
        make_index_sharded_map_step, which merges each dp row after its
        all_gather over "ish").  On one device in one process, the rows
        through _map_dp: each row the shard loop (map_step_sharded) with
        full per-shard tails on its slice, merged per row.  Across devices
        or processes, in two steps a device: phase 1 on each of its (row,
        column) pairs; the per-read best counts maxed over every shard on
        the host (this process's devices, then every process's shards
        through ShardExchange); phase 2, each shard's full tail; the rows'
        per-shard results joined, gathered over the processes and merged
        over the whole batch, on the first device or, across processes, on
        the host, where every process merges the same batch."""
        if self._plan is None:
            return self._map_dp(codes, lengths, paired)
        home = self._home
        reads, lens = split_batch(torch.as_tensor(codes),
                                  torch.as_tensor(lengths),
                                  len(self._grid), paired)
        dp, b = lens.shape
        ins, p1 = {}, {}
        for dev, share in self._plan.items():
            rows = [d for d, _ in share]
            ins[dev] = (pick(reads, rows).reshape(1, len(rows) * b, -1)
                        .to(torch.uint8),
                        pick(lens, rows).reshape(1, -1).to(I32))
            p1[dev] = take(self.graphs.run(
                "grid_phase1", self._phase1_step(dev, share, b), *ins[dev],
                device=dev), 0)
        best = [None] * dp
        for dev, share in self._plan.items():
            rows_best = p1[dev][1].to(home).reshape(len(share), b)
            for (d, _), bst in zip(share, rows_best):
                best[d] = bst if best[d] is None else torch.maximum(best[d],
                                                                    bst)
        best = self._exchange.max_best(torch.stack(best))      # [dp, b]
        per_row = [[None] * len(row) for row in self._grid]
        for dev, share in self._plan.items():
            carry = p1[dev][0]
            out = self.graphs.run(
                "grid_phase2", self._phase2_step(dev, share, b, paired, carry),
                *ins[dev], pick(best, [d for d, _ in share]).reshape(1, -1),
                *(t[None] for t in leaves(carry)), device=dev, paired=paired)
            out = rebuild(out, (t[0].to(home) for t in leaves(out)))
            for (d, cols), stk in zip(share, out):
                for i, (j, _) in enumerate(cols):
                    per_row[d][j] = MapResult(*(t[i] for t in stk))
        stks = [_stack(row, MapResult) for row in per_row]  # [S', b] each
        local = MapResult(*(
            torch.stack([getattr(r, f) for r in stks]).sum(dim=0, dtype=I32)
            if f.endswith("overflow")
            else torch.cat([getattr(r, f) for r in stks], dim=1)
            for f in MapResult._fields))
        return merge_sharded_results(self._exchange.gather_shards(local),
                                     *self._grid_meta, paired=paired,
                                     read_len=self.read_len)

    def _map(self, codes, lengths, paired: bool) -> MapResult:
        if self._grid is not None:
            return self._map_grid(codes, lengths, paired)
        if self._groups is not None:
            return self._map_dp(codes, lengths, paired)
        return take(self._run_steps(codes[None], lengths[None], paired), 0)

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
        leaves -n > 1 out).  There map_batch_scan runs a group of K batches
        as one dispatch, one graph of K steps on a card."""
        return (len(self.slots) == 1 and self._grid is None
                and (self.shards is None or not self.cfg.bs_mapping))

    def map_batch_scan(self, codes_k: np.ndarray, lengths_k: np.ndarray,
                       paired: bool = False) -> MapResult:
        """K stacked [B, L] batches in ONE dispatch (the reference's
        map_step_scan, or its sharded megascan): fields come back stacked
        [K, ...], each batch's row equal to map_batch's (or
        map_batch_paired's) result."""
        if not self.supports_megabatch():
            raise ValueError("map_batch_scan runs on one device, unsharded "
                             "or on the shard loop without --bs-mapping")
        with trace.span("ngm.map_batch_scan"):
            return self._run_steps(codes_k, lengths_k, paired)

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
        return take(self._run_steps(codes[None], lengths[None],
                                    topn=self.topn()), 0)
