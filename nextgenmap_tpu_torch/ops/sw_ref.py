"""Banded Smith-Waterman in plain PyTorch (score + traceback).

Port of ``nextgenmap_tpu/ops/sw_ref.py``; the semantics are identical bit
for bit (int32 DP, exact tie-breaks), and the tests hold this module against
the JAX functions on the same inputs.

Band parametrization: query row i, band offset o in [0, W); the corridor is
laid out so ref index j = i + o, so a corridor of T = L + W covers the band.

  diag  (i-1, j-1) -> same offset o in the previous row
  up    (i-1, j)   -> offset o+1 in the previous row   (gap consuming query, "I")
  left  (i,   j-1) -> offset o-1 in the same row       (gap consuming ref, "D")

The left/F dependency inside a row is an exclusive max-scan ("lazy-F"),
exact whenever gap open >= gap extend (NgmConfig.validate):

  F[o] = max_{t<o}( Htmp[t] + t*gext ) - gopen - (o-1)*gext

``banded_sw_score`` is the plain version of the hand-written CUDA kernel K1,
``csrc/sw_score.cu`` (wrapper: ``ops/sw_kernel.py``); ``banded_sw_align``
(``banded_sw_forward`` then ``_backwalk_rows``) is the plain version of K4,
``csrc/sw_align.cu`` (wrapper: ``ops/sw_align_kernel.py``).

Two modes: ``"local"`` (Smith-Waterman: a 0 floor, the best cell over every
row, the walk stops at a 0 cell) and ``"glocal"`` (--end-to-end: no floor,
the best cell on the read's last row, no cell encodes stop, so the walk runs
until the query is consumed; a score <= 0 reports as 0, unalignable).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -(2**30)

# traceback op codes (match SAM CIGAR semantics)
OP_M, OP_I, OP_D = 0, 1, 2
OP_NONE = 255

# dir byte layout: bits 0-1 H-source (0 stop, 1 diag, 2 E/up, 3 F/left),
# bit 2: E extends (vs opens), bit 3: F extends (vs opens),
# bit 4: positive substitution score at this cell ("match" column)


class ScoreResult(NamedTuple):
    score: torch.Tensor   # [B] int32 best score (0 = no alignment)
    end_i: torch.Tensor   # [B] int32 query index of the best cell
    end_o: torch.Tensor   # [B] int32 band offset of the best cell (ref j = i + o)


class AlignResult(NamedTuple):
    score: torch.Tensor      # [B] int32
    q_start: torch.Tensor    # [B] first aligned query base (soft-clip before)
    q_end: torch.Tensor      # [B] last aligned query base (inclusive)
    r_start: torch.Tensor    # [B] first aligned corridor ref index
    r_end: torch.Tensor      # [B] last aligned corridor ref index (inclusive)
    ops: torch.Tensor        # [B, max_ops] uint8, ops END->START, OP_NONE-filled
    n_ops: torch.Tensor      # [B] int32
    matches: torch.Tensor    # [B] int32 columns with a positive substitution score
    mismatches: torch.Tensor  # [B] int32 other aligned columns
    indels: torch.Tensor     # [B] int32 total gap length
    trunc: torch.Tensor      # [B] bool: op buffer overflowed max_ops


MODES = ("local", "glocal")


def check_mode(mode: str) -> bool:
    """True for local mode, False for glocal; raises for anything else."""
    if mode not in MODES:
        raise ValueError(f"banded SW mode {mode!r}: expected one of {MODES}")
    return mode == "local"


def _matrix_flat(matrix: torch.Tensor) -> torch.Tensor:
    return matrix.reshape(-1).to(torch.int32)


def _sub_scores(flat, moff, qi, rw):
    """S[msel, q, r] for codes 0..4; 0 for codes >= 5 (as the reference's
    general path computes it).  For a match/mismatch matrix this equals the
    reference's `simple` fast path, so one lookup serves both."""
    ok = (qi < 5)[:, None] & (rw < 5)
    idx = moff[:, None] + qi[:, None] * 8 + rw
    return torch.where(ok, flat[torch.where(ok, idx, 0)], 0)


def _shift_left(x, fill):
    """x[:, o+1] with `fill` past the band edge."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def _shift_right(x, fill):
    """x[:, o-1] with `fill` before offset 0."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _row_step(sub, h_prev, e_prev, gopen_q, gopen_r, gext, off, local):
    """One DP row: returns (h, e, hd, f, e_ext, e_open, htmp).  Glocal rows
    have no 0 floor (row 0's zero h_prev still starts anywhere in the
    corridor)."""
    hd = h_prev + sub
    e_open = _shift_left(h_prev, NEG) - gopen_q
    e_ext = _shift_left(e_prev, NEG) - gext
    e = torch.maximum(e_open, e_ext)
    htmp = torch.maximum(hd.clamp(min=0) if local else hd, e)
    cm = torch.cummax(htmp + off * gext, dim=1).values
    f = _shift_right(cm, NEG) - gopen_r - (off - 1) * gext
    h = torch.maximum(htmp, f)
    return h, e, hd, f, e_ext, e_open, htmp


def _dirs(h, hd, e, e_ext, e_open, f_prev_ext, f_prev_open, mbit, local):
    """Pack the direction byte per cell (tie-breaks per DESIGN.md rule 10);
    glocal cells never encode stop."""
    src = torch.where(h == hd, 1, torch.where(h == e, 2, 3))
    d = torch.where(h <= 0, 0, src) if local else src
    e_bit = (e_ext > e_open).to(torch.int32) << 2
    f_bit = (f_prev_ext > f_prev_open).to(torch.int32) << 3
    m_bit = mbit.to(torch.int32) << 4
    return (d | e_bit | f_bit | m_bit).to(torch.uint8)


def _setup(query, ref, matrix, msel):
    B, L = query.shape
    q = query.to(torch.int32)
    r = ref.to(torch.int32)
    flat = _matrix_flat(matrix)
    if msel is None or flat.shape[0] == 64:
        moff = torch.zeros(B, dtype=torch.int32, device=q.device)
    else:
        moff = msel.to(torch.int32) * 64
    return B, L, q, r, flat, moff


def _row_best(h, i, qlen, best, bi, bo, local):
    """Fold row i into the running best: local mode counts rows i < qlen,
    glocal only the last row i == qlen - 1; first max wins, so ties go to
    the smallest i, then the smallest o."""
    valid = ((i < qlen) if local else (i == qlen - 1))[:, None]
    h_m = torch.where(valid, h, NEG)
    rowmax = h_m.max(dim=1).values.clamp(min=0)
    rowarg = torch.argmax(h_m, dim=1).to(torch.int32)
    upd = rowmax > best
    best = torch.where(upd, rowmax, best)
    bi = torch.where(upd, i, bi)
    bo = torch.where(upd, rowarg, bo)
    return best, bi, bo


def banded_sw_score(
    query: torch.Tensor,   # [B, L] uint8/int codes
    qlen: torch.Tensor,    # [B] int32
    ref: torch.Tensor,     # [B, T] codes, T = L + band
    matrix: torch.Tensor,  # [8, 8] or [M, 8, 8] int32
    gopen_q: int,
    gopen_r: int,
    gext: int,
    msel: torch.Tensor | None = None,  # [B] int32 matrix index
    *,
    band: int,
    mode: str = "local",
) -> ScoreResult:
    """Score-only banded SW over a batch: L sequential rows of [B, W] work."""
    local = check_mode(mode)
    B, L, q, r, flat, moff = _setup(query, ref, matrix, msel)
    W = band
    dev = q.device
    qlen = qlen.to(torch.int32)
    off = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    h = torch.zeros((B, W), dtype=torch.int32, device=dev)
    e = torch.full((B, W), NEG, dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    bi = torch.zeros_like(best)
    bo = torch.zeros_like(best)
    for i in range(L):
        sub = _sub_scores(flat, moff, q[:, i], r[:, i:i + W])
        h, e, *_ = _row_step(sub, h, e, gopen_q, gopen_r, gext, off, local)
        best, bi, bo = _row_best(h, i, qlen, best, bi, bo, local)
    return ScoreResult(best, bi, bo)


def banded_sw_forward(
    query: torch.Tensor,
    qlen: torch.Tensor,
    ref: torch.Tensor,
    matrix: torch.Tensor,
    gopen_q: int,
    gopen_r: int,
    gext: int,
    msel: torch.Tensor | None = None,
    *,
    band: int,
    mode: str = "local",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The traceback's forward pass: (dirs [L, B, W] uint8, best, bi, bo),
    the direction byte of every cell and the best cell by `_row_best`'s
    rule.  K4 (``csrc/sw_align.cu``) writes the same bytes."""
    local = check_mode(mode)
    B, L, q, r, flat, moff = _setup(query, ref, matrix, msel)
    W = band
    dev = q.device
    qlen = qlen.to(torch.int32)
    off = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    h = torch.zeros((B, W), dtype=torch.int32, device=dev)
    e = torch.full((B, W), NEG, dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    bi = torch.zeros_like(best)
    bo = torch.zeros_like(best)
    dirs = torch.empty((L, B, W), dtype=torch.uint8, device=dev)
    for i in range(L):
        sub = _sub_scores(flat, moff, q[:, i], r[:, i:i + W])
        h, e, hd, f, e_ext, e_open, htmp = _row_step(
            sub, h, e, gopen_q, gopen_r, gext, off, local
        )
        # F[o] extends F[o-1] vs opens from Htmp[o-1] (prefer open on tie)
        f_prev_ext = _shift_right(f, NEG) - gext
        f_prev_open = _shift_right(htmp, NEG) - gopen_r
        dirs[i] = _dirs(h, hd, e, e_ext, e_open, f_prev_ext, f_prev_open,
                        sub > 0, local)
        best, bi, bo = _row_best(h, i, qlen, best, bi, bo, local)
    return dirs, best, bi, bo


def banded_sw_align(
    query: torch.Tensor,
    qlen: torch.Tensor,
    ref: torch.Tensor,
    matrix: torch.Tensor,
    gopen_q: int,
    gopen_r: int,
    gext: int,
    msel: torch.Tensor | None = None,
    *,
    band: int,
    max_ops: int = 0,
    mode: str = "local",
) -> AlignResult:
    """Banded SW with traceback: [L, B, W] direction bytes, then the
    row-synchronized backwalk (a glocal walk ends when the query is
    consumed)."""
    dirs, best, bi, bo = banded_sw_forward(
        query, qlen, ref, matrix, gopen_q, gopen_r, gext, msel, band=band,
        mode=mode,
    )
    mo = max_ops or (query.shape[1] + band)
    return _backwalk_rows(dirs, best, bi, bo, mo)


def _extract_at(row, o, W):
    """row[b, o[b]], 0 where o is outside [0, W)."""
    inb = (o >= 0) & (o < W)
    v = torch.gather(row, 1, o.clamp(0, W - 1).long()[:, None])[:, 0]
    return torch.where(inb, v, 0)


def _backwalk_rows(dirs, best, bi, bo, MO):
    """Row-synchronized traceback, one iteration per query row from the
    bottom: M/I consume one op and move up a row; a D run stays within the
    row and is resolved at once (run end = the largest c <= o with
    not cont(c), cont(c) = f_bit(c) | hsrc(c-1) == 3), after which the
    trail cell c-1 emits the row's closing M/I or stops."""
    L, B, W = dirs.shape
    dev = dirs.device
    PH_H, PH_E = 0, 1
    i32 = torch.int32
    iota_mo = torch.arange(MO, dtype=i32, device=dev)[None, :]
    colw = torch.arange(W, dtype=i32, device=dev)[None, :]

    cur_i, cur_o = bi.clone(), bo.clone()
    ph = torch.zeros(B, dtype=i32, device=dev)
    active = best > 0
    c = torch.zeros(B, dtype=i32, device=dev)
    trunc = torch.zeros(B, dtype=torch.bool, device=dev)
    ops = torch.full((B, MO), OP_NONE, dtype=torch.uint8, device=dev)
    matches = torch.zeros(B, dtype=i32, device=dev)
    mismatches = torch.zeros_like(matches)
    indels = torch.zeros_like(matches)
    qs, rs = bi.clone(), bi + bo

    for t in range(L):
        i_t = L - 1 - t
        row = dirs[i_t].to(i32)
        o = cur_o
        sel = active & (cur_i == i_t)

        d_entry = _extract_at(row, o, W)
        hsrc = d_entry & 3
        e_bit = (d_entry >> 2) & 1
        m_bit = (d_entry >> 4) & 1

        inb = (o >= 0) & (o < W)
        in_e = sel & inb & (ph == PH_E)
        at_h = sel & inb & (ph == PH_H)
        stop0 = at_h & (hsrc == 0)
        is_m1 = at_h & (hsrc == 1)
        is_i1 = at_h & (hsrc == 2)
        is_dr = at_h & (hsrc == 3)

        # ---- D run resolved in-row ----
        hsrc3 = (row & 3) == 3
        f_bit_row = ((row >> 3) & 1) == 1
        cont = f_bit_row | _shift_right(hsrc3, False)
        last_nc = torch.cummax(torch.where(cont, -1, colw), dim=1).values
        ce = _extract_at(last_nc, o, W)
        k = torch.where(is_dr, torch.where(ce >= 0, o - ce + 1, o + 1), 0)
        o_trail = torch.where(ce >= 0, ce - 1, -1)
        has_trail = is_dr & (o_trail >= 0)
        d_trail = torch.where(has_trail, _extract_at(row, o_trail, W), 0)
        t_hsrc = d_trail & 3
        t_ebit = (d_trail >> 2) & 1
        t_mbit = (d_trail >> 4) & 1
        trail_m = has_trail & (t_hsrc == 1)
        trail_i = has_trail & (t_hsrc == 2)

        # ---- op emission into the END->START buffer at cursor c ----
        emit_i = in_e | is_i1
        emit_m = is_m1
        dmask = (iota_mo >= c[:, None]) & (iota_mo < (c + k)[:, None])
        ops = torch.where(dmask & is_dr[:, None], OP_D, ops)
        single = torch.where(
            emit_m, OP_M,
            torch.where(emit_i, OP_I,
                        torch.where(trail_m, OP_M,
                                    torch.where(trail_i, OP_I, OP_NONE))),
        )
        has_single = emit_m | emit_i | trail_m | trail_i
        spos = c + k
        ops = torch.where(
            (iota_mo == spos[:, None]) & has_single[:, None],
            single[:, None], ops,
        ).to(torch.uint8)
        # a walk longer than MO ops clamps the cursor and flags the read
        c_full = c + k + has_single.to(i32)
        trunc = trunc | (c_full > MO)
        c = c_full.clamp(max=MO)

        # ---- counters ----
        m_hit = (emit_m & (m_bit == 1)) | (trail_m & (t_mbit == 1))
        m_miss = (emit_m & (m_bit == 0)) | (trail_m & (t_mbit == 0))
        matches = matches + m_hit.to(i32)
        mismatches = mismatches + m_miss.to(i32)
        indels = indels + k + emit_i.to(i32) + trail_i.to(i32)

        # ---- coordinates: last consumed cell wins ----
        qs = torch.where(has_single, i_t, qs)
        rs = torch.where(
            trail_m, i_t + o_trail,
            torch.where(is_dr & (k > 0), i_t + ce.clamp(min=0),
                        torch.where(emit_m, i_t + o, rs)),
        ).to(i32)

        # ---- next state ----
        ni = torch.where(has_single, i_t - 1, cur_i)
        no = torch.where(
            emit_i | trail_i,
            torch.where(trail_i, o_trail + 1, o + 1),
            torch.where(trail_m, o_trail, o),
        )
        nph = torch.where(
            (emit_i & (e_bit == 1)) | (trail_i & (t_ebit == 1)), PH_E, PH_H
        )
        dead = (
            stop0 | (is_dr & ~has_trail) | (has_trail & (t_hsrc == 0))
            | (sel & ~inb)
        )
        cur_i = torch.where(sel, ni, cur_i).to(i32)
        cur_o = torch.where(sel, no, o).to(i32)
        ph = torch.where(sel, nph, ph).to(i32)
        active = active & ~dead

    return AlignResult(
        score=best,
        q_start=qs.to(i32), q_end=bi,
        r_start=rs, r_end=bi + bo,
        ops=ops, n_ops=c,
        matches=matches, mismatches=mismatches, indels=indels,
        trunc=trunc,
    )
