"""The single-end mapping step in PyTorch, and the Mapper that owns its state.

Port of the main path of ``nextgenmap_tpu/models/mapper.py``:

  revcomp -> canonical k-mers -> candidate search (both strands) ->
  deterministic candidate order -> lazy scoring of reads with >= 2
  candidates (slot compaction, corridor gather K2, SW score K1) ->
  argmax selection -> winner corridor (K2) -> traceback -> filters + MAPQ

On a CUDA device both corridor fetches go through the hand-written gather
kernel and the score pass through the hand-written SW kernel; on the CPU
their wrappers run the plain PyTorch versions.  Every output equals the
reference's ``map_step`` exactly (tests/test_torch_mapper.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nextgenmap_tpu.config import NgmConfig
from nextgenmap_tpu.index.kmer_index import KmerIndex
from nextgenmap_tpu.ops.scoring import matrices_are_simple, score_matrix
from nextgenmap_tpu_torch.convert import MapperState, state_from_numpy
from nextgenmap_tpu_torch.device import resolve_device
from nextgenmap_tpu_torch.index.device_build import build_index_device
from nextgenmap_tpu_torch.ops.candidate import (
    candidate_search_canonical, pack_offsets,
)
from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
from nextgenmap_tpu_torch.ops.kmer import extract_kmers_canonical
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


def _pre_extract(reads, lengths, *, k, read_stride=1):
    """Left-shifted reverse complements and the canonical read k-mers."""
    B, L = reads.shape
    rc = revcomp_batch(reads)
    # the flip moves right-padding to the front of short reads: shift each
    # rc row left by (L - length) so it starts at column 0
    idx = torch.arange(L, device=reads.device)[None, :] + (L - lengths)[:, None]
    rc = torch.gather(torch.nn.functional.pad(rc, (0, L), value=4), 1, idx.long())
    return rc, extract_kmers_canonical(reads, lengths, k, stride=read_stride)


def _candidates(genome, offsets, positions, reads, lengths, sensitivity,
                max_freq, *, k, fanout_cap, hit_cap, max_cmrs, diag_bin_log2,
                band, min_kmer_hits, read_stride=1, packed_offsets=False):
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

    rc, (canon, flip, ok) = _pre_extract(reads, lengths, k=k,
                                         read_stride=read_stride)
    cand = candidate_search_canonical(
        canon, flip, ok, lengths, offsets, positions, sensitivity, max_freq,
        k=k, fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
        diag_bin_log2=diag_bin_log2, stride=read_stride,
        packed_offsets=packed_offsets,
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


def _score_candidates(genome, reads, rc, lengths, corr_start, strand,
                      cand_valid, score_mask, matrices, gopen_q, gopen_r, gext,
                      *, band, slot_cap, simple_matrix=False):
    """Banded-SW score the candidates of the reads selected by `score_mask`.

    Lazy scoring: a read with one candidate needs no comparison and skips
    this pass (its score comes from the traceback).  The (read, candidate)
    pairs of the masked reads are compacted batch-wide into `slot_cap`
    slots, gathered and scored once each, and the scores are scattered back
    to a dense [B, C] grid (0 where unscored).  Returns (sw, slot_overflow).
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
    len_s = lengths[b_s]
    # one contiguous window per real candidate (kernel K2 on the card)
    corr_s = gather_genome_windows(genome, corr_starts.contiguous(), T)
    corr_s = torch.where(slot_valid[:, None], corr_s, 4).to(torch.uint8)
    q_s = torch.where((strand_s == 1)[:, None], rc[b_s], reads[b_s])

    # (kernel K1 on the card)
    sres = sw_score(q_s, len_s, corr_s, matrices, gopen_q, gopen_r, gext,
                    strand_s.contiguous(), band=W, simple=simple_matrix)
    score_s = torch.where(slot_valid, sres.score, 0)

    # scatter back; every invalid slot writes the one discarded dump index
    sw = torch.zeros(B * C + 1, dtype=I32, device=dev)
    sw[torch.where(slot_valid, flat_idx, B * C)] = score_s
    sw = torch.where(eff_valid, sw[:B * C].reshape(B, C), 0)
    return sw, slot_overflow


def _finish(a1, sw, corr_start, strand, cand_valid, genome, reads, rc,
            lengths, matrices, gopen_q, gopen_r, gext, min_identity,
            min_residues, n_cands, overflow, *, band, simple_matrix=False):
    """Traceback the chosen candidate a1 [B] and apply filters + MAPQ."""
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
        best_strand, band=band, simple=simple_matrix,
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
        proper=torch.zeros_like(mapped),
        fanout_overflow=overflow[0],
        cmr_overflow=cmr_overflow,
    )


def _single_tail(genome, reads, rc, lengths, matrices, gopen_q, gopen_r,
                 gext, min_identity, min_residues, corr_start, strand,
                 cand_valid, n_cands, overflow, *, band, slot_cap,
                 simple_matrix=False):
    """Lazy scoring, rule-11 argmax selection, traceback + filters."""
    sw, slot_ovf = _score_candidates(
        genome, reads, rc, lengths, corr_start, strand, cand_valid,
        n_cands >= 2, matrices, gopen_q, gopen_r, gext,
        band=band, slot_cap=slot_cap, simple_matrix=simple_matrix,
    )
    overflow = (overflow[0], overflow[1] + slot_ovf)
    # first max = score DESC, fwd first, pos ASC; an all-zero (lazy) row
    # picks candidate 0, the read's only candidate after prefix ordering
    a1 = torch.argmax(sw, dim=1)
    return _finish(
        a1, sw, corr_start, strand, cand_valid, genome, reads, rc, lengths,
        matrices, gopen_q, gopen_r, gext, min_identity, min_residues,
        n_cands, overflow, band=band, simple_matrix=simple_matrix,
    )


def default_slot_cap(batch: int) -> int:
    """Score-pass slots: most reads have one candidate and need none;
    overflow is counted, so a repeat-dense genome is visible, not silent."""
    return max(512, batch // 2)


def map_step(
    genome, offsets, positions, reads, lengths, matrices,
    gopen_q, gopen_r, gext, sensitivity, max_freq, min_identity, min_residues,
    *, k, fanout_cap, hit_cap=256, max_cmrs, diag_bin_log2, band,
    min_kmer_hits=1, slot_cap=0, read_stride=1, packed_offsets=False,
    simple_matrix=False,
) -> MapResult:
    """Single-end mapping step (DESIGN.md rule 11 selection) on the device
    that holds `reads`.  sensitivity, min_identity and min_residues are
    taken as float32, like the reference's jnp.float32 arguments."""
    dev = reads.device
    B = reads.shape[0]
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    gaps = (int(gopen_q), int(gopen_r), int(gext))
    lengths = lengths.to(I32)
    corr_start, strand, cand_valid, n_cands, rc, overflow = _candidates(
        genome, offsets, positions, reads, lengths, f32(sensitivity),
        int(max_freq), k=k, fanout_cap=fanout_cap, hit_cap=hit_cap,
        max_cmrs=max_cmrs, diag_bin_log2=diag_bin_log2, band=band,
        min_kmer_hits=min_kmer_hits, read_stride=read_stride,
        packed_offsets=packed_offsets,
    )
    return _single_tail(
        genome, reads, rc, lengths, matrices, *gaps,
        f32(min_identity), f32(min_residues), corr_start, strand, cand_valid,
        n_cands, overflow, band=band,
        slot_cap=slot_cap or default_slot_cap(B),
        simple_matrix=simple_matrix,
    )


def score_matrices(cfg: NgmConfig) -> np.ndarray:
    """[2, 8, 8] int32 substitution matrices, selected per candidate by
    strand (they differ only in bisulfite mode)."""
    return np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])


def check_slice(cfg: NgmConfig) -> None:
    """Raise NotImplementedError for a configuration outside the ported
    slice, naming the ROADMAP item that will bring it."""
    unported = [
        (cfg.bs_mapping, "--bs-mapping (bisulfite) waits for ROADMAP A11"),
        (cfg.end_to_end, "--end-to-end (glocal SW) waits for ROADMAP A11"),
        (cfg.topn > 1, "-n/--topn > 1 waits for ROADMAP A10"),
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

    index=None builds the canonical CSR index on `device`; a host KmerIndex,
    or an (offsets, positions) pair of arrays, is carried across with
    convert.state_from_numpy instead.
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
        if index is None:
            if codes.shape[0] >= 2**30:
                raise NotImplementedError(
                    "genomes of 2^30 bases or more need index sharding "
                    "(ROADMAP A13)"
                )
            g = torch.from_numpy(codes).to(self.device)
            off, pos = build_index_device(g, k=cfg.kmer, skip=cfg.kmer_skip)
            self.state = MapperState(
                g, off, pos, torch.from_numpy(mats).to(self.device)
            )
        else:
            if isinstance(index, KmerIndex):
                if not index.canonical:
                    raise NotImplementedError(
                        "only canonical k-mer indexes are ported; the "
                        "two-strand lookup waits for ROADMAP A13"
                    )
                off, pos = index.device_arrays()
            else:
                off, pos = index
            self.state = state_from_numpy(codes, off, pos, mats, self.device)
        # pack (o0, row length) into one table: one offset gather per k-mer
        packed = pack_offsets(self.state.offsets, cfg.max_kmer_freq,
                              cfg.max_kmer_fanout)
        self.packed_offsets = packed is not None
        self._offsets = packed if packed is not None else self.state.offsets
        self.simple_matrix = matrices_are_simple(mats)
        self.band = cfg.corridor_for(read_len)
        self.hit_cap = cfg.resolved_read_hits(self.state.positions.shape[0],
                                              read_len)

    def statics(self) -> dict:
        cfg = self.cfg
        return dict(
            k=cfg.kmer, fanout_cap=cfg.max_kmer_fanout, hit_cap=self.hit_cap,
            max_cmrs=cfg.max_cmrs, diag_bin_log2=cfg.diag_bin_log2,
            band=self.band, min_kmer_hits=max(1, cfg.kmer_min),
            read_stride=cfg.read_kmer_skip,
            packed_offsets=self.packed_offsets,
            simple_matrix=self.simple_matrix,
        )

    def map_batch(self, codes: np.ndarray, lengths: np.ndarray) -> MapResult:
        """Map one [B, L] batch; the result stays on the mapper's device."""
        cfg = self.cfg
        st = self.state
        reads = torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(self.device)
        lens = torch.from_numpy(np.ascontiguousarray(lengths, np.int32)).to(self.device)
        return map_step(
            st.genome, self._offsets, st.positions, reads, lens, st.matrices,
            cfg.gap_read_penalty, cfg.gap_ref_penalty, cfg.gap_extend_penalty,
            cfg.sensitivity, cfg.max_kmer_freq, cfg.min_identity,
            cfg.min_residues, **self.statics(),
        )
