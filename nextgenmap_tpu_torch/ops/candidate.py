"""Candidate search (CS): index lookup, hit compaction, diagonal voting.

Port of ``nextgenmap_tpu/ops/candidate.py``: ``Candidates``,
``pack_offsets``, the element path of ``_compact_hits`` (with its
two-table lookup), ``_select_candidates``, ``candidate_search_canonical``
(the main path: one lookup per canonical read k-mer) and
``candidate_search_dual`` (both strands looked up apart: bisulfite, and a
non-canonical index).

Per read: look every k-mer up in the CSR index, compact the ragged fan-out
into [B, H] hit slots, bin the hits by diagonal, count votes per bucket with
the adjacent-bucket pair merge, and keep the buckets that clear an adaptive
threshold (best count x sensitivity), ordered by score DESC, strand ASC,
bucket ASC (DESIGN.md rules 6/7).  Every static cap reports an overflow
count.

Slot ownership (which k-mer owns hit slot h) has one formulation here: a
per-row ``torch.searchsorted`` over the exclusive prefix sum, which gives
the same owners as each of the reference's variants.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SENTINEL = 2**31 - 1   # bucket value for invalid hits; sorts last

_BIAS = 1 << 16        # vote bias so negative diagonals stay sortable
_STRAND_OFF = 1 << 28  # strand tag above any biased bucket

PACK_CNT_BITS = 6      # low bits hold min(row length, 63)
PACK_MAX_POSITIONS = 1 << (32 - PACK_CNT_BITS)


class Candidates(NamedTuple):
    bucket: torch.Tensor           # [B, C] int32 diagonal bucket (SENTINEL = none)
    score: torch.Tensor            # [B, C] int32 pair-merged hit count (0 = none)
    strand: torch.Tensor           # [B, C] int32 0 fwd / 1 rev
    best_score: torch.Tensor       # [B] int32 best bucket score of the read
    fanout_overflow: torch.Tensor  # [] int32 k-mer rows truncated by K
    hit_overflow: torch.Tensor     # [] int32 reads truncated by the H cap
    cmr_overflow: torch.Tensor     # [] int32 reads with > C surviving CMRs
    extra_score: torch.Tensor      # [B] int32 the (C+1)-th best eligible score


def pack_offsets(offsets: torch.Tensor, max_freq: int, fanout_cap: int):
    """Pack CSR (o0, row length) pairs into one table, or None.

    Entry = o0 << 6 | min(len, 63), with rows longer than max_freq packed as
    empty (repeat masking).  Only valid when every o0 < 2^26 and
    fanout_cap < 63.  The packed value can reach 2^32, so it is computed and
    kept in int64 (the reference's uint32).
    """
    if fanout_cap >= (1 << PACK_CNT_BITS) - 1:
        return None
    if int(offsets[-1]) >= PACK_MAX_POSITIONS:
        return None
    off = offsets.to(torch.int64)
    cnt = off[1:] - off[:-1]
    cnt = torch.where(cnt > max_freq, 0,
                      cnt.clamp(max=(1 << PACK_CNT_BITS) - 1))
    packed = (off[:-1] << PACK_CNT_BITS) | cnt
    return torch.cat([packed, packed.new_zeros(1)])


def _compact_hits(km, ok, offsets, positions, max_freq, payload=None,
                  *, fanout_cap, hit_cap, packed_offsets, table_split=False):
    """Compact the CSR fan-out of a k-mer batch into [B, H] hit slots.

    With table_split, `offsets` holds two concatenated tables of equal
    length (bisulfite: CT-collapsed, then GA-collapsed, the second shifted
    into the shared positions array) and the odd k-mer columns look up the
    second one.

    Returns (pos [B, H] index entries, qid [B, H] owning k-mer, valid [B, H],
    fanout_overflow, hit_overflow, payload at each slot or None).
    """
    B, Qt = km.shape
    K, H = fanout_cap, hit_cap
    dev = km.device
    kmw = torch.where(ok, km, 0).long()
    if table_split:
        odd = torch.arange(Qt, device=dev) & 1
        kmw = kmw + odd * (offsets.shape[0] // 2)
    if packed_offsets:
        pw = offsets[kmw]
        o0 = (pw >> PACK_CNT_BITS).to(torch.int32)
        cnt = torch.where(ok, (pw & ((1 << PACK_CNT_BITS) - 1)).to(torch.int32), 0)
    else:
        o0 = offsets[kmw]
        cnt = torch.where(ok, offsets[kmw + 1] - o0, 0)
        cnt = torch.where(cnt > max_freq, 0, cnt)  # repeat masking
    fanout_overflow = (cnt > K).sum(dtype=torch.int32)
    cnt_c = cnt.clamp(max=K)

    cum = torch.cumsum(cnt_c, dim=1, dtype=torch.int32) - cnt_c  # exclusive
    total = cum[:, -1] + cnt_c[:, -1]
    hit_overflow = (total > H).sum(dtype=torch.int32)
    harange = torch.arange(H, dtype=torch.int32, device=dev).expand(B, H)

    # slot h belongs to the last k-mer q with cum[q] <= h
    qid = torch.searchsorted(cum, harange.contiguous(), right=True,
                             out_int32=True) - 1
    qidl = qid.long()
    pidx = torch.gather(o0 - cum, 1, qidl) + harange
    pay_at = None if payload is None else torch.gather(payload, 1, qidl)
    valid = harange < total.clamp(max=H)[:, None]
    pos = positions[torch.where(valid, pidx, 0).long()]
    return pos, qid, valid, fanout_overflow, hit_overflow, pay_at


def _select_candidates(votes, sensitivity, max_cmrs):
    """Sort tagged votes, run-length count, threshold, stable top-C.

    Votes carry a provenance LSB: direct votes are 2v+1, merge votes (from
    the bucket above) 2v.  A bucket is a run of v = vote >> 1; its run-end
    element is direct iff the bucket has a direct hit, and pure-merge
    buckets are suppressed.
    """
    B, N = votes.shape
    C = max_cmrs
    dev = votes.device
    s = torch.sort(votes, dim=1).values
    sb = s >> 1
    ar = torch.arange(N, dtype=torch.int32, device=dev).expand(B, N)
    prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32, device=dev),
                      sb[:, :-1]], dim=1)
    nxt = torch.cat([sb[:, 1:], torch.full((B, 1), SENTINEL,
                                          dtype=torch.int32, device=dev)], dim=1)
    is_start = sb != prev
    is_end = sb != nxt
    start_idx = torch.cummax(torch.where(is_start, ar, 0), dim=1).values
    key = torch.where(
        is_end & (sb != SENTINEL >> 1) & ((s & 1) == 1),
        ar - start_idx + 1,
        0,
    ).to(torch.int32)

    best = key.max(dim=1).values
    # float32 like the reference: ceil(best * sensitivity) with a float32
    # sensitivity tensor, so no float64 enters
    thresh = torch.ceil(best.to(torch.float32) * sensitivity).clamp(min=1)
    thresh = thresh.to(torch.int32)
    eligible = key >= thresh[:, None]
    n_cands = eligible.sum(dim=1, dtype=torch.int32)
    cmr_overflow = (n_cands > C).sum(dtype=torch.int32)

    sel_key = torch.where(eligible, key, 0)
    # stable descending sort = top_k with ties to the lower index
    top = torch.sort(sel_key, dim=1, descending=True, stable=True)
    top_score, top_idx = top.values[:, :C], top.indices[:, :C]
    if C < N:
        extra_score = top.values[:, C]
    else:  # C covers every vote slot: nothing can be clipped
        extra_score = torch.zeros(B, dtype=torch.int32, device=dev)
    top_vote = torch.gather(s, 1, top_idx)
    return top_vote, top_score, best, cmr_overflow, extra_score


def candidate_search_canonical(
    canon: torch.Tensor,      # [B, Q] int32 canonical k-mers of the FWD read
    flip: torch.Tensor,       # [B, Q] int32 1 where the read k-mer was flipped
    ok: torch.Tensor,         # [B, Q] bool
    lengths: torch.Tensor,    # [B] int32
    offsets: torch.Tensor,    # CSR offsets (int32) or the packed table (int64)
    positions: torch.Tensor,  # [P] int32 (pos << 1 | genome-flip) entries
    sensitivity: torch.Tensor,  # float32 scalar tensor
    max_freq: int,
    *,
    k: int,
    fanout_cap: int,
    hit_cap: int,
    max_cmrs: int,
    diag_bin_log2: int,
    stride: int = 1,
    packed_offsets: bool = False,
) -> Candidates:
    """Both strands from one canonical lookup per read k-mer.

    A hit's strand is read-flip XOR stored-flip; the reverse-strand diagonal
    uses the k-mer's offset in the reverse-complemented read,
    len - k - offset.
    """
    pos_e, qid, valid, fo, ho, yflip = _compact_hits(
        canon, ok, offsets, positions, max_freq, flip,
        fanout_cap=fanout_cap, hit_cap=hit_cap,
        packed_offsets=packed_offsets,
    )
    p = pos_e >> 1
    gflip = pos_e & 1
    strand = yflip ^ gflip
    qoff = qid * stride
    rc_off = lengths[:, None] - k - qoff
    diag = torch.where(strand == 0, p - qoff, p - rc_off)
    return _vote(diag, strand, valid, fo, ho, sensitivity,
                 max_cmrs=max_cmrs, diag_bin_log2=diag_bin_log2)


def candidate_search_dual(
    km_f: torch.Tensor,       # [B, Q] int32 k-mers of the forward read
    ok_f: torch.Tensor,       # [B, Q] bool
    km_r: torch.Tensor,       # [B, Q] int32 k-mers of the reverse complement
    ok_r: torch.Tensor,       # [B, Q] bool
    offsets: torch.Tensor,    # CSR offsets (int32) or the packed table (int64)
    positions: torch.Tensor,  # [P] int32 genome positions
    sensitivity: torch.Tensor,  # float32 scalar tensor
    max_freq: int,
    *,
    fanout_cap: int,
    hit_cap: int,
    max_cmrs: int,
    diag_bin_log2: int,
    stride: int = 1,
    dual_tables: bool = False,
    packed_offsets: bool = False,
) -> Candidates:
    """Both strands, looked up apart, in one counting pass.

    The strands are interleaved (even k-mer columns forward, odd ones
    reverse), so the H cap truncates both passes evenly.  With dual_tables
    (bisulfite) the reverse pass looks up the second, GA-collapsed table of
    the concatenated `offsets`.  A hit's diagonal is its position less its
    k-mer's offset in the read of its own strand.
    """
    B, Q = km_f.shape
    km = torch.stack([km_f, km_r], dim=2).reshape(B, 2 * Q)
    ok = torch.stack([ok_f, ok_r], dim=2).reshape(B, 2 * Q)
    pos, qid, valid, fo, ho, _ = _compact_hits(
        km, ok, offsets, positions, max_freq,
        fanout_cap=fanout_cap, hit_cap=hit_cap,
        packed_offsets=packed_offsets, table_split=dual_tables,
    )
    strand = qid & 1
    diag = pos - (qid >> 1) * stride
    return _vote(diag, strand, valid, fo, ho, sensitivity,
                 max_cmrs=max_cmrs, diag_bin_log2=diag_bin_log2)


def _vote(diag, strand, valid, fanout_overflow, hit_overflow, sensitivity,
          *, max_cmrs, diag_bin_log2) -> Candidates:
    """Bin the hits by diagonal and select the candidate buckets.

    Every hit votes for its bucket b (direct) and for b - 1 (merge), so
    the count of b is hits(b) + hits(b + 1), the adjacent-bucket merge.
    """
    bucket = diag >> diag_bin_log2   # arithmetic shift: floors when negative
    vote = strand * _STRAND_OFF + bucket + _BIAS

    vote_hi = torch.where(valid, 2 * vote + 1, SENTINEL)
    vote_lo = torch.where(valid, 2 * (vote - 1), SENTINEL)
    votes = torch.cat([vote_hi, vote_lo], dim=1).to(torch.int32)  # [B, 2H]

    top_vote, top_score, best, co, extra = _select_candidates(
        votes, sensitivity, max_cmrs
    )
    got = top_score > 0
    top_vote = top_vote >> 1
    top_strand = torch.where(got, top_vote // _STRAND_OFF, 0)
    top_bucket = torch.where(
        got, top_vote - top_strand * _STRAND_OFF - _BIAS, SENTINEL
    )
    return Candidates(
        bucket=top_bucket.to(torch.int32),
        score=top_score,
        strand=top_strand.to(torch.int32),
        best_score=best,
        fanout_overflow=fanout_overflow,
        hit_overflow=hit_overflow,
        cmr_overflow=co,
        extra_score=extra,
    )
