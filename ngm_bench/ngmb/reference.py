"""The plain reference mapper that decides ``correct``.

Plain PyTorch, frozen with the benchmark: it imports nothing of the
program.  It builds its own canonical k-mer index from the genome and maps
a batch of reads with NextGenMap's semantics as the port states them (the
single-end step and the paired step of the default configuration: canonical
k-mers, local banded Smith-Waterman, lazy scoring, rule-11 selection, the
CxC pair resolution), and returns the same per-read fields as the program's
``MapResult``.  The algorithms are a frozen copy of the port's plain
versions (``ops/kmer.py``, ``ops/candidate.py``, ``ops/sw_ref.py``, the
steps of ``models/mapper.py``), cut to the one mode the cells run; the
index here uses unpacked CSR offsets, where the program packs them.

Two knobs exist for the controls only (``ngm_bench/control.py``):
``gate_dtype`` computes the float32 steps (the sensitivity threshold, the
identity and residue filters, MAPQ, the pair cutoff) in another float
type, and ``index_skip`` indexes every n-th genome window.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

I32 = torch.int32
NEG = -(2**30)
SENTINEL = 2**31 - 1
_BIAS = 1 << 16
_STRAND_OFF = 1 << 28
OP_NONE = 255
OP_M, OP_I, OP_D = 0, 1, 2

# the fields the comparison reads, in MapResult's order
FIELDS = ("mapped", "strand", "pos", "mapq", "score", "second", "q_start",
          "q_end", "ops", "n_ops", "matches", "mismatches", "indels",
          "n_candidates", "proper", "fanout_overflow", "cmr_overflow")


class Settings(NamedTuple):
    """The mapping settings a configuration file states (its "ngm" group)."""

    kmer: int
    kmer_skip: int
    read_kmer_skip: int
    max_kmer_freq: int
    kmer_min: int
    sensitivity: float
    max_cmrs: int
    max_kmer_fanout: int
    max_read_hits: int
    diag_bin_log2: int
    match_bonus: int
    mismatch_penalty: int
    gap_read_penalty: int
    gap_ref_penalty: int
    gap_extend_penalty: int
    min_identity: float
    min_residues: float
    min_insert_size: int
    max_insert_size: int
    pair_score_cutoff: float
    corridor: int

    @classmethod
    def of(cls, ngm: dict) -> "Settings":
        return cls(**{f: ngm[f] for f in cls._fields})


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def band_for(s: Settings, read_len: int) -> int:
    """The corridor width W of a read length (NextGenMap's diagonal bucket
    span plus indel slack)."""
    span = 2 * (1 << s.diag_bin_log2)
    if s.corridor:
        return span + _round_up(s.corridor, 8)
    return span + max(16, _round_up(int(read_len * 0.15), 8))


def hit_cap_for(s: Settings, n_positions: int, read_len: int) -> int:
    """H, the hits a read keeps: 2 x the read's k-mers x 1.25 x the mean
    row length (at least 1.25, at most the fan-out cap), in [128, 2048]."""
    if s.max_read_hits:
        return s.max_read_hits
    exp_row = n_positions / 4.0 ** s.kmer
    per_row = min(float(s.max_kmer_fanout), max(1.25, 1.25 * exp_row))
    q = max(1, (read_len - s.kmer) // s.read_kmer_skip + 1)
    return max(128, min(2048, _round_up(int(2 * q * per_row), 64)))


def slot_cap_for(batch: int) -> int:
    """Score-pass slots of a batch."""
    return max(512, batch // 2)


# ---------------------------------------------------------------- index


def build_index(genome: torch.Tensor, k: int, skip: int):
    """Canonical CSR index: (offsets int32 [4^k + 2], positions int32 [Q])
    with entries (position << 1) | flip, rows ascending in position; windows
    holding a non-ACGT code go to the overflow row 4^k."""
    G = genome.shape[0]
    nb = 4**k
    Q = (G - k) // skip + 1
    c = genome.to(I32)
    vals = torch.zeros(Q, dtype=I32, device=c.device)
    rvals = torch.zeros_like(vals)
    ok = torch.ones(Q, dtype=torch.bool, device=c.device)
    for j in range(k):
        w = c[j:j + (Q - 1) * skip + 1:skip]
        vals = (vals << 2) | (w & 3)
        rvals = rvals | ((3 - (w & 3)) << (2 * j))
        ok &= w < 4
    del c
    pos = torch.arange(Q, dtype=I32, device=genome.device) * skip
    pos = (pos << 1) | (rvals < vals).to(I32)
    vals = torch.where(ok, torch.minimum(vals, rvals), nb)
    del rvals, ok
    counts = torch.bincount(vals, minlength=nb + 1)
    offsets = torch.zeros(nb + 2, dtype=I32, device=genome.device)
    offsets[1:] = torch.cumsum(counts, dim=0).to(I32)
    order = torch.sort(vals, stable=True).indices
    return offsets, pos[order]


# ---------------------------------------------------------------- front


def revcomp_shifted(reads: torch.Tensor, lengths: torch.Tensor):
    """Reverse complements, each shifted left so it starts at column 0."""
    B, L = reads.shape
    f = reads.flip(1)
    rc = torch.where(f < 4, 3 - f, f).to(reads.dtype)
    idx = torch.arange(L, device=reads.device)[None, :] + (L - lengths)[:, None]
    return torch.gather(torch.nn.functional.pad(rc, (0, L), value=4), 1,
                        idx.long())


def canonical_kmers(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                    stride: int):
    """(canon, flip, ok) [B, Q] of the forward read's k-mers at `stride`."""
    B, L = codes.shape
    Q = max(1, (L - k) // stride + 1)
    c = codes.to(I32)
    vals = torch.zeros((B, Q), dtype=I32, device=c.device)
    rvals = torch.zeros_like(vals)
    ok = torch.ones((B, Q), dtype=torch.bool, device=c.device)
    for j in range(k):
        w = c[:, j:j + (Q - 1) * stride + 1:stride]
        vals = (vals << 2) | (w & 3)
        rvals = rvals | ((3 - (w & 3)) << (2 * j))
        ok &= w < 4
    qpos = torch.arange(Q, dtype=I32, device=c.device)[None, :] * stride
    ok &= qpos + k <= lengths[:, None]
    return torch.minimum(vals, rvals), (rvals < vals).to(I32), ok


def _compact_hits(km, ok, offsets, positions, max_freq, payload, *,
                  fanout_cap, hit_cap):
    """The CSR fan-out of the read k-mers compacted into [B, H] slots."""
    B, Qt = km.shape
    K, H = fanout_cap, hit_cap
    dev = km.device
    kmw = torch.where(ok, km, 0).long()
    o0 = offsets[kmw]
    cnt = torch.where(ok, offsets[kmw + 1] - o0, 0)
    cnt = torch.where(cnt > max_freq, 0, cnt)
    fanout_overflow = (cnt > K).sum(dtype=I32)
    cnt_c = cnt.clamp(max=K)
    cum = torch.cumsum(cnt_c, dim=1, dtype=I32) - cnt_c
    total = cum[:, -1] + cnt_c[:, -1]
    hit_overflow = (total > H).sum(dtype=I32)
    harange = torch.arange(H, dtype=I32, device=dev).expand(B, H)
    qid = torch.searchsorted(cum, harange.contiguous(), right=True,
                             out_int32=True) - 1
    qidl = qid.long()
    pidx = torch.gather(o0 - cum, 1, qidl) + harange
    pay_at = torch.gather(payload, 1, qidl)
    valid = harange < total.clamp(max=H)[:, None]
    pos = positions[torch.where(valid, pidx, 0).long()]
    return pos, qid, valid, fanout_overflow, hit_overflow, pay_at


def _select(votes, sensitivity, max_cmrs, fdt):
    """Sorted tagged votes -> run-length bucket counts -> the adaptive
    threshold -> a stable top C."""
    B, N = votes.shape
    C = max_cmrs
    dev = votes.device
    s = torch.sort(votes, dim=1).values
    sb = s >> 1
    ar = torch.arange(N, dtype=I32, device=dev).expand(B, N)
    prev = torch.cat([torch.full((B, 1), -1, dtype=I32, device=dev),
                      sb[:, :-1]], dim=1)
    nxt = torch.cat([sb[:, 1:], torch.full((B, 1), SENTINEL, dtype=I32,
                                           device=dev)], dim=1)
    start_idx = torch.cummax(torch.where(sb != prev, ar, 0), dim=1).values
    key = torch.where((sb != nxt) & (sb != SENTINEL >> 1) & ((s & 1) == 1),
                      ar - start_idx + 1, 0).to(I32)
    best = key.max(dim=1).values
    thresh = torch.ceil(best.to(fdt) * sensitivity.to(fdt)).clamp(min=1)
    eligible = key >= thresh.to(I32)[:, None]
    n_el = eligible.sum(dim=1, dtype=I32)
    cmr_overflow = (n_el > C).sum(dtype=I32)
    top = torch.sort(torch.where(eligible, key, 0), dim=1, descending=True,
                     stable=True)
    top_score, top_idx = top.values[:, :C], top.indices[:, :C]
    return torch.gather(s, 1, top_idx), top_score, best, cmr_overflow


def candidate_search(canon, flip, ok, lengths, offsets, positions,
                     sensitivity, *, k, max_freq, fanout_cap, hit_cap,
                     max_cmrs, diag_bin_log2, stride, fdt):
    """Both strands from one canonical lookup per read k-mer: (bucket,
    score, strand) [B, C], fanout + hit overflow, cmr overflow."""
    pos_e, qid, valid, fo, ho, yflip = _compact_hits(
        canon, ok, offsets, positions, max_freq, flip,
        fanout_cap=fanout_cap, hit_cap=hit_cap)
    p = pos_e >> 1
    strand = yflip ^ (pos_e & 1)
    qoff = qid * stride
    diag = torch.where(strand == 0, p - qoff, p - (lengths[:, None] - k - qoff))
    vote = strand * _STRAND_OFF + (diag >> diag_bin_log2) + _BIAS
    votes = torch.cat([torch.where(valid, 2 * vote + 1, SENTINEL),
                       torch.where(valid, 2 * (vote - 1), SENTINEL)],
                      dim=1).to(I32)
    top_vote, top_score, _, co = _select(votes, sensitivity, max_cmrs, fdt)
    got = top_score > 0
    top_vote = top_vote >> 1
    top_strand = torch.where(got, top_vote // _STRAND_OFF, 0)
    top_bucket = torch.where(got, top_vote - top_strand * _STRAND_OFF - _BIAS,
                             SENTINEL)
    return (top_bucket.to(I32), top_score, top_strand.to(I32), fo + ho, co)


# ---------------------------------------------------------------- banded SW


def gather_windows(genome_padded: torch.Tensor, starts: torch.Tensor,
                   size: int) -> torch.Tensor:
    """genome[s : s + size] per start; the genome is padded by `size`."""
    P = genome_padded.shape[0]
    idx = starts.to(torch.int64).clamp(0, P - size)
    cols = torch.arange(size, dtype=torch.int64, device=genome_padded.device)
    return genome_padded[idx[..., None] + cols]


def _sub(mat, q_col, r_win):
    ok = (q_col < 5)[:, None] & (r_win < 5)
    idx = q_col[:, None] * 8 + r_win
    return torch.where(ok, mat[torch.where(ok, idx, 0)], 0)


def _shl(x, fill):
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def _shr(x, fill):
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _row(sub, h_prev, e_prev, go_q, go_r, ge, off):
    hd = h_prev + sub
    e_open = _shl(h_prev, NEG) - go_q
    e_ext = _shl(e_prev, NEG) - ge
    e = torch.maximum(e_open, e_ext)
    htmp = torch.maximum(hd.clamp(min=0), e)
    cm = torch.cummax(htmp + off * ge, dim=1).values
    f = _shr(cm, NEG) - go_r - (off - 1) * ge
    return torch.maximum(htmp, f), e, hd, f, e_ext, e_open, htmp


def _fold_best(h, i, qlen, best, bi, bo):
    h_m = torch.where((i < qlen)[:, None], h, NEG)
    rowmax = h_m.max(dim=1).values.clamp(min=0)
    rowarg = torch.argmax(h_m, dim=1).to(I32)
    upd = rowmax > best
    return (torch.where(upd, rowmax, best), torch.where(upd, i, bi),
            torch.where(upd, rowarg, bo))


def sw_score(query, qlen, ref, mat, go_q, go_r, ge, band):
    """Local banded SW score [S] of each query against its corridor."""
    B, L = query.shape
    q, r = query.to(I32), ref.to(I32)
    dev = q.device
    off = torch.arange(band, dtype=I32, device=dev)[None, :]
    h = torch.zeros((B, band), dtype=I32, device=dev)
    e = torch.full((B, band), NEG, dtype=I32, device=dev)
    best = torch.zeros(B, dtype=I32, device=dev)
    bi, bo = torch.zeros_like(best), torch.zeros_like(best)
    for i in range(L):
        h, e, *_ = _row(_sub(mat, q[:, i], r[:, i:i + band]), h, e, go_q, go_r,
                        ge, off)
        best, bi, bo = _fold_best(h, i, qlen, best, bi, bo)
    return best


def sw_align(query, qlen, ref, mat, go_q, go_r, ge, band):
    """Local banded SW with traceback: (score, q_start, q_end, r_start, ops
    [B, L + band] END->START, n_ops, matches, mismatches, indels, trunc)."""
    B, L = query.shape
    q, r = query.to(I32), ref.to(I32)
    dev = q.device
    W = band
    off = torch.arange(W, dtype=I32, device=dev)[None, :]
    h = torch.zeros((B, W), dtype=I32, device=dev)
    e = torch.full((B, W), NEG, dtype=I32, device=dev)
    best = torch.zeros(B, dtype=I32, device=dev)
    bi, bo = torch.zeros_like(best), torch.zeros_like(best)
    dirs = torch.empty((L, B, W), dtype=torch.uint8, device=dev)
    for i in range(L):
        sub = _sub(mat, q[:, i], r[:, i:i + W])
        h, e, hd, f, e_ext, e_open, htmp = _row(sub, h, e, go_q, go_r, ge, off)
        f_prev_ext = _shr(f, NEG) - ge
        f_prev_open = _shr(htmp, NEG) - go_r
        src = torch.where(h == hd, 1, torch.where(h == e, 2, 3))
        d = torch.where(h <= 0, 0, src)
        dirs[i] = (d | ((e_ext > e_open).to(I32) << 2)
                   | ((f_prev_ext > f_prev_open).to(I32) << 3)
                   | ((sub > 0).to(I32) << 4)).to(torch.uint8)
        best, bi, bo = _fold_best(h, i, qlen, best, bi, bo)
    return _backwalk(dirs, best, bi, bo, L + W)


def _at(row, o, W):
    inb = (o >= 0) & (o < W)
    v = torch.gather(row, 1, o.clamp(0, W - 1).long()[:, None])[:, 0]
    return torch.where(inb, v, 0)


def _backwalk(dirs, best, bi, bo, MO):
    """Row-synchronised traceback from the best cell (DESIGN.md rule 10's
    tie-breaks are in the direction bytes)."""
    L, B, W = dirs.shape
    dev = dirs.device
    iota_mo = torch.arange(MO, dtype=I32, device=dev)[None, :]
    colw = torch.arange(W, dtype=I32, device=dev)[None, :]
    cur_i, cur_o = bi.clone(), bo.clone()
    ph = torch.zeros(B, dtype=I32, device=dev)
    active = best > 0
    c = torch.zeros(B, dtype=I32, device=dev)
    trunc = torch.zeros(B, dtype=torch.bool, device=dev)
    ops = torch.full((B, MO), OP_NONE, dtype=torch.uint8, device=dev)
    matches = torch.zeros(B, dtype=I32, device=dev)
    mismatches = torch.zeros_like(matches)
    indels = torch.zeros_like(matches)
    qs, rs = bi.clone(), bi + bo
    for t in range(L):
        i_t = L - 1 - t
        row = dirs[i_t].to(I32)
        o = cur_o
        sel = active & (cur_i == i_t)
        d_entry = _at(row, o, W)
        hsrc = d_entry & 3
        e_bit = (d_entry >> 2) & 1
        m_bit = (d_entry >> 4) & 1
        inb = (o >= 0) & (o < W)
        in_e = sel & inb & (ph == 1)
        at_h = sel & inb & (ph == 0)
        stop0 = at_h & (hsrc == 0)
        is_m1 = at_h & (hsrc == 1)
        is_i1 = at_h & (hsrc == 2)
        is_dr = at_h & (hsrc == 3)
        cont = (((row >> 3) & 1) == 1) | _shr((row & 3) == 3, False)
        last_nc = torch.cummax(torch.where(cont, -1, colw), dim=1).values
        ce = _at(last_nc, o, W)
        k = torch.where(is_dr, torch.where(ce >= 0, o - ce + 1, o + 1), 0)
        o_trail = torch.where(ce >= 0, ce - 1, -1)
        has_trail = is_dr & (o_trail >= 0)
        d_trail = torch.where(has_trail, _at(row, o_trail, W), 0)
        t_hsrc = d_trail & 3
        t_ebit = (d_trail >> 2) & 1
        t_mbit = (d_trail >> 4) & 1
        trail_m = has_trail & (t_hsrc == 1)
        trail_i = has_trail & (t_hsrc == 2)
        emit_i = in_e | is_i1
        emit_m = is_m1
        dmask = (iota_mo >= c[:, None]) & (iota_mo < (c + k)[:, None])
        ops = torch.where(dmask & is_dr[:, None], OP_D, ops)
        single = torch.where(emit_m, OP_M, torch.where(
            emit_i, OP_I, torch.where(trail_m, OP_M, torch.where(
                trail_i, OP_I, OP_NONE))))
        has_single = emit_m | emit_i | trail_m | trail_i
        ops = torch.where((iota_mo == (c + k)[:, None]) & has_single[:, None],
                          single[:, None], ops).to(torch.uint8)
        c_full = c + k + has_single.to(I32)
        trunc = trunc | (c_full > MO)
        c = c_full.clamp(max=MO)
        matches = matches + ((emit_m & (m_bit == 1))
                             | (trail_m & (t_mbit == 1))).to(I32)
        mismatches = mismatches + ((emit_m & (m_bit == 0))
                                   | (trail_m & (t_mbit == 0))).to(I32)
        indels = indels + k + emit_i.to(I32) + trail_i.to(I32)
        qs = torch.where(has_single, i_t, qs)
        rs = torch.where(trail_m, i_t + o_trail, torch.where(
            is_dr & (k > 0), i_t + ce.clamp(min=0),
            torch.where(emit_m, i_t + o, rs))).to(I32)
        ni = torch.where(has_single, i_t - 1, cur_i)
        no = torch.where(emit_i | trail_i,
                         torch.where(trail_i, o_trail + 1, o + 1),
                         torch.where(trail_m, o_trail, o))
        nph = torch.where((emit_i & (e_bit == 1)) | (trail_i & (t_ebit == 1)),
                          1, 0)
        dead = (stop0 | (is_dr & ~has_trail) | (has_trail & (t_hsrc == 0))
                | (sel & ~inb))
        cur_i = torch.where(sel, ni, cur_i).to(I32)
        cur_o = torch.where(sel, no, o).to(I32)
        ph = torch.where(sel, nph, ph).to(I32)
        active = active & ~dead
    return (best, qs.to(I32), bi, rs, ops, c, matches, mismatches, indels,
            trunc)


# ---------------------------------------------------------------- the steps


class Reference:
    """The reference mapper of one genome under one configuration's
    settings; ``map`` maps one batch (single-end, or pairs in rows 2i and
    2i + 1) and returns {field: tensor}."""

    def __init__(self, genome: torch.Tensor, settings: Settings, read_len: int,
                 *, gate_dtype: torch.dtype = torch.float32,
                 index_skip: int | None = None):
        s = self.s = settings
        self.fdt = gate_dtype
        self.read_len = read_len
        self.band = band_for(s, read_len)
        self.T = read_len + self.band
        self.G = genome.shape[0]
        self.offsets, self.positions = build_index(
            genome, s.kmer, index_skip or s.kmer_skip)
        self.hit_cap = hit_cap_for(s, int(self.positions.shape[0]), read_len)
        self.genome_padded = torch.cat(
            [genome, genome.new_full((self.T,), 4)])
        mat = torch.full((8, 8), -s.mismatch_penalty, dtype=I32)
        for c in range(4):
            mat[c, c] = s.match_bonus
        self.mat = mat.reshape(-1).to(genome.device)

    def _f(self, x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32,
                            device=self.mat.device).to(self.fdt)

    def _candidates(self, reads, lengths):
        s = self.s
        W, L = self.band, reads.shape[1]
        canon, flip, ok = canonical_kmers(reads, lengths, s.kmer,
                                          s.read_kmer_skip)
        bucket, score, strand, fo, co = candidate_search(
            canon, flip, ok, lengths, self.offsets, self.positions,
            self._f(s.sensitivity), k=s.kmer, max_freq=s.max_kmer_freq,
            fanout_cap=s.max_kmer_fanout, hit_cap=self.hit_cap,
            max_cmrs=s.max_cmrs, diag_bin_log2=s.diag_bin_log2,
            stride=s.read_kmer_skip, fdt=self.fdt)
        valid = score >= max(1, s.kmer_min)
        slack = (W - 2 * (1 << s.diag_bin_log2)) // 2
        corr = torch.where(valid, (torch.where(valid, bucket, 0)
                                   << s.diag_bin_log2) - slack, 0)
        corr = corr.clamp(0, max(0, self.G - (L + W))).to(I32)
        order = torch.sort(torch.where(valid, strand * (2**30) + corr,
                                       2**31 - 1), dim=1, stable=True).indices
        corr = torch.gather(corr, 1, order)
        strand = torch.gather(strand, 1, order)
        valid = torch.gather(valid, 1, order)
        return corr, strand, valid, valid.sum(dim=1, dtype=I32), (fo, co)

    def _score(self, reads, rc, lengths, corr, strand, valid, mask):
        s = self.s
        B, L = reads.shape
        C = corr.shape[1]
        S = slot_cap_for(B)
        dev = reads.device
        eff = valid & mask[:, None]
        n_sc = eff.sum(dim=1, dtype=I32)
        base = torch.cumsum(n_sc, dim=0, dtype=I32) - n_sc
        total = base[-1] + n_sc[-1]
        sar = torch.arange(S, dtype=I32, device=dev)
        b_of = torch.searchsorted(base, sar, right=True, out_int32=True) - 1
        slot_valid = sar < total.clamp(max=S)
        flat_idx = torch.where(slot_valid, b_of * C + (sar - base[b_of.long()]),
                               0).long()
        b_s = torch.where(slot_valid, b_of, 0).long()
        starts = torch.where(slot_valid, corr.reshape(-1)[flat_idx], 0)
        strand_s = strand.reshape(-1)[flat_idx]
        len_s = torch.where(slot_valid, lengths[b_s], 0)
        q_s = torch.where((strand_s == 1)[:, None], rc[b_s], reads[b_s])
        sc = sw_score(q_s, len_s, gather_windows(self.genome_padded, starts,
                                                 self.T), self.mat,
                      s.gap_read_penalty, s.gap_ref_penalty,
                      s.gap_extend_penalty, self.band)
        sw = torch.zeros(B * C + 1, dtype=I32, device=dev)
        sw[torch.where(slot_valid, flat_idx, B * C)] = torch.where(
            slot_valid, sc, 0)
        return (torch.where(eff, sw[:B * C].reshape(B, C), 0),
                (total > S).to(I32))

    def _finish(self, a1, sw, corr, strand, valid, reads, rc, lengths,
                n_cands, overflow, proper):
        s, fdt = self.s, self.fdt
        L = reads.shape[1]
        a1c = a1[:, None]
        a1_valid = torch.gather(valid, 1, a1c)[:, 0]
        best_start = torch.gather(corr, 1, a1c)[:, 0]
        best_strand = torch.gather(strand, 1, a1c)[:, 0]
        far = (corr - best_start[:, None]).abs() > L
        s2 = torch.where(far, sw, 0).max(dim=1).values
        starts = torch.where(a1_valid, best_start, 0).clamp(
            0, max(0, self.G - self.T))
        (score, q_start, q_end, r_start, ops, n_ops, matches, mismatches,
         indels, trunc) = sw_align(
            torch.where((best_strand == 1)[:, None], rc, reads), lengths,
            gather_windows(self.genome_padded, starts, self.T), self.mat,
            s.gap_read_penalty, s.gap_ref_penalty, s.gap_extend_penalty,
            self.band)
        s1 = torch.where(a1_valid, score, 0)
        identity = matches.to(fdt) / n_ops.clamp(min=1).to(fdt)
        residues = (q_end - q_start + 1).to(fdt)
        mapped = ((s1 > 0) & (lengths > 0)
                  & (identity >= self._f(s.min_identity))
                  & (residues >= self._f(s.min_residues) * lengths.to(fdt))
                  & ~trunc)
        mapq = torch.round(60.0 * (s1 - s2).to(fdt) / s1.clamp(min=1).to(fdt))
        mapq = torch.where(mapped, mapq.clamp(0, 60).to(I32), 0)
        return {
            "mapped": mapped, "strand": best_strand,
            "pos": best_start + r_start, "mapq": mapq, "score": s1,
            "second": s2, "q_start": q_start, "q_end": q_end, "ops": ops,
            "n_ops": n_ops, "matches": matches, "mismatches": mismatches,
            "indels": indels, "n_candidates": n_cands,
            "proper": proper & mapped, "fanout_overflow": overflow[0],
            "cmr_overflow": overflow[1] + trunc.sum(dtype=I32),
        }

    def map(self, reads: torch.Tensor, lengths: torch.Tensor,
            paired: bool = False) -> dict:
        lengths = lengths.to(I32)
        rc = revcomp_shifted(reads, lengths)
        corr, strand, valid, n, (fo, co) = self._candidates(reads, lengths)
        if paired:
            return self._paired_tail(reads, rc, lengths, corr, strand, valid,
                                     n, fo, co)
        sw, so = self._score(reads, rc, lengths, corr, strand, valid, n >= 2)
        proper = torch.zeros(reads.shape[0], dtype=torch.bool,
                             device=reads.device)
        return self._finish(torch.argmax(sw, dim=1), sw, corr, strand, valid,
                            reads, rc, lengths, n, (fo, co + so), proper)

    def _paired_tail(self, reads, rc, lengths, corr, strand, valid, n, fo,
                     co):
        s, fdt = self.s, self.fdt
        B, L = reads.shape
        C = corr.shape[1]
        P = B // 2
        bin_w = 1 << s.diag_bin_log2
        np_ = n.reshape(P, 2)
        multi = (np_[:, 0] >= 2) | (np_[:, 1] >= 2)
        sw, so = self._score(reads, rc, lengths, corr, strand, valid,
                             multi.repeat_interleave(2))
        sc = sw.reshape(P, 2, C)
        pos = (corr + (self.band - 2 * bin_w) // 2).reshape(P, 2, C)
        st = strand.reshape(P, 2, C)
        ex = valid.reshape(P, 2, C)
        s1m, s2m = sc[:, 0, :, None], sc[:, 1, None, :]
        p1, p2 = pos[:, 0, :, None], pos[:, 1, None, :]
        st1, st2 = st[:, 0, :, None], st[:, 1, None, :]
        margin = 2 * bin_w
        fwd_left = torch.where(st1 == 0, p1 <= p2 + margin, p2 <= p1 + margin)
        span = (p2 - p1).abs() + L
        ok_ins = ((span >= s.min_insert_size - margin)
                  & (span <= s.max_insert_size + margin))
        geo = ((st1 != st2) & fwd_left & ok_ins & ex[:, 0, :, None]
               & ex[:, 1, None, :])
        flat = torch.where(geo & (s1m > 0) & (s2m > 0), s1m + s2m,
                           -1).reshape(P, C * C)
        pair_best = flat.max(dim=1).values
        pair_arg = torch.argmax(flat, dim=1)
        best1 = sc[:, 0].max(dim=1).values
        best2 = sc[:, 1].max(dim=1).values
        proper_scored = (pair_best > 0) & (
            pair_best.to(fdt)
            >= self._f(s.pair_score_cutoff) * (best1 + best2).to(fdt))
        proper_single = geo[:, 0, 0] & (np_[:, 0] >= 1) & (np_[:, 1] >= 1)
        proper = torch.where(multi, proper_scored, proper_single)
        c1 = torch.where(multi, pair_arg // C, 0)
        c2 = torch.where(multi, pair_arg % C, 0)
        a_single = torch.argmax(sw, dim=1).reshape(P, 2)
        a1 = torch.stack([torch.where(proper, c1, a_single[:, 0]),
                          torch.where(proper, c2, a_single[:, 1])],
                         dim=1).reshape(B)
        return self._finish(a1, sw, corr, strand, valid, reads, rc, lengths,
                            n, (fo, co + so), proper.repeat_interleave(2))
