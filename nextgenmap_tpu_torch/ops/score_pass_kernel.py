"""Wrapper of the fused score pass (``csrc/sw_score.cu``:
``score_plan_kernel``, then ``score_pass_kernel``, or
``score_pass_block_kernel`` past W = 512).

Replaces the reference's ``nextgenmap_tpu/models/mapper.py::
_score_candidates`` (XLA-fused under jax.jit): the (read, candidate) pairs
of the reads selected by a mask, compacted batch-wide into the slots,
scored by banded SW, the scores scattered back to a dense grid.  A CPU
tensor goes to the plain version (``score_pass_plain``: the slot
compaction in torch ops, K2's and K1's plain versions, the scatter); a
CUDA tensor goes to the two kernels, which stage each slot's query and
corridor straight from the reads and the genome, or the wrapper raises.
``score_pass.launches`` counts the passes launched on a card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nextgenmap_tpu_torch.native import build
from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
from nextgenmap_tpu_torch.ops.sw_kernel import MAX_BAND, MAX_MATS, sw_score
from nextgenmap_tpu_torch.ops.sw_ref import check_mode

I32 = torch.int32


class ScorePass(NamedTuple):
    sw: torch.Tensor             # [B, C] int32, 0 where unscored
    slot_overflow: torch.Tensor  # [] int32, 1 if the pairs outnumber the slots
    n_sc: torch.Tensor           # [B] int32, the slots each read asks for
    base: torch.Tensor           # [B] int32, their exclusive prefix sum


def compact_slots(n: torch.Tensor, slots: int) -> tuple:
    """Batch-wide slot compaction: read b's n[b] entries take the slots
    from base[b] on, in read order, `slots` at most.  Returns (base [B] the
    exclusive prefix sum of n, total [] the entries asked for, slot_valid
    [slots], b_of [slots] the read a slot belongs to, j_of [slots] its
    entry within the read); slot s belongs to the last read b with
    base[b] <= s."""
    base = torch.cumsum(n, dim=0, dtype=I32) - n
    total = base[-1] + n[-1]
    sar = torch.arange(slots, dtype=I32, device=n.device)
    b_of = torch.searchsorted(base, sar, right=True, out_int32=True) - 1
    slot_valid = sar < total.clamp(max=slots)
    j_of = sar - base[b_of.long()]
    return base, total, slot_valid, b_of, j_of


def score_pass_plain(genome, reads, rc, lengths, corr_start, strand,
                     cand_valid, score_mask, matrices, gopen_q, gopen_r, gext,
                     *, band, slot_cap, mode="local"):
    """The plain version.  The pairs of the masked reads are compacted
    batch-wide into `slot_cap` slots, gathered and scored once each, and
    the scores scattered back to a dense [B, C] grid (0 where unscored).
    The slots past the real ones are scored at length 0, so K1 does no
    work for them."""
    B, L = reads.shape
    C = corr_start.shape[1]
    W = band
    T = L + W
    S = slot_cap
    dev = reads.device

    eff_valid = cand_valid & score_mask[:, None]
    n_sc = eff_valid.sum(dim=1, dtype=I32)
    base, total, slot_valid, b_of, j_of = compact_slots(n_sc, S)
    slot_overflow = (total > S).to(I32)
    flat_idx = torch.where(slot_valid, b_of * C + j_of, 0).long()
    b_s = torch.where(slot_valid, b_of, 0).long()

    corr_starts = torch.where(slot_valid, corr_start.reshape(-1)[flat_idx], 0)
    strand_s = strand.reshape(-1)[flat_idx]
    # an invalid slot has length 0: it runs no DP row and scores (0, 0, 0)
    len_s = torch.where(slot_valid, lengths[b_s], 0)
    # one contiguous window per real candidate (K2's plain version)
    corr_s = gather_genome_windows(genome, corr_starts.contiguous(), T)
    q_s = torch.where((strand_s == 1)[:, None], rc[b_s], reads[b_s])

    # (K1's plain version)
    sres = sw_score(q_s, len_s, corr_s, matrices, gopen_q, gopen_r, gext,
                    strand_s.contiguous(), band=W, mode=mode)
    score_s = torch.where(slot_valid, sres.score, 0)

    # scatter back; every invalid slot writes the one discarded dump index
    sw = torch.zeros(B * C + 1, dtype=I32, device=dev)
    sw[torch.where(slot_valid, flat_idx, B * C)] = score_s
    sw = torch.where(eff_valid, sw[:B * C].reshape(B, C), 0)
    return ScorePass(sw, slot_overflow, n_sc, base)


def score_pass(genome: torch.Tensor,      # [G] uint8
               reads: torch.Tensor,       # [B, L] uint8
               rc: torch.Tensor,          # [B, L] uint8
               lengths: torch.Tensor,     # [B] int32
               corr_start: torch.Tensor,  # [B, C] int32
               strand: torch.Tensor,      # [B, C] int32
               cand_valid: torch.Tensor,  # [B, C] bool
               score_mask: torch.Tensor,  # [B] bool, [B // 2] if pairs
               matrices: torch.Tensor,    # [M, 8, 8] or [8, 8] int32
               gopen_q: int, gopen_r: int, gext: int, *, band: int,
               slot_cap: int, mode: str = "local",
               pairs: bool = False) -> ScorePass:
    """Banded-SW score the valid candidates of the reads `score_mask`
    selects, at most `slot_cap` of them in read order, local or glocal
    (`mode`).  With `pairs` the mask has one entry a pair, [B // 2]: rows
    2i and 2i + 1 share its entry i; else one a read, [B].
    Returns ScorePass(sw, slot_overflow, n_sc, base).
    """
    B = reads.shape[0]
    shift = int(pairs)                  # 1: one entry a pair
    if pairs and B % 2:
        raise ValueError(f"score_pass: pairs need an even batch, got {B}")
    if tuple(score_mask.shape) != (B >> shift,):
        raise ValueError(
            f"score_pass: score_mask must be [{B >> shift}] with "
            f"pairs={pairs}, got {tuple(score_mask.shape)}")
    if reads.device.type == "cpu":
        if pairs:
            score_mask = score_mask.repeat_interleave(2)
        return score_pass_plain(
            genome, reads, rc, lengths, corr_start, strand, cand_valid,
            score_mask, matrices, gopen_q, gopen_r, gext, band=band,
            slot_cap=slot_cap, mode=mode)
    local = check_mode(mode)
    dev = reads.device
    if dev.type != "cuda":
        raise ValueError(f"score_pass: unsupported device {dev}")
    if genome.dim() != 1 or corr_start.dim() != 2:
        raise ValueError(
            f"score_pass: genome must be [G] and corr_start [B, C], got "
            f"{tuple(genome.shape)} and {tuple(corr_start.shape)}")
    B, L = reads.shape
    C = corr_start.shape[1]
    W, S = band, slot_cap
    mats = matrices.reshape(-1, 8, 8)
    checks = (
        (genome, torch.uint8, tuple(genome.shape), "genome"),
        (reads, torch.uint8, (B, L), "reads"),
        (rc, torch.uint8, (B, L), "rc"),
        (lengths, I32, (B,), "lengths"),
        (corr_start, I32, (B, C), "corr_start"),
        (strand, I32, (B, C), "strand"),
        (cand_valid, torch.bool, (B, C), "cand_valid"),
        (score_mask, torch.bool, (B >> shift,), "score_mask"),
        (mats, I32, tuple(mats.shape), "matrices"),
    )
    for t, dtype, shape, name in checks:
        if t.device != dev:
            raise ValueError(f"score_pass: {name} on {t.device}, reads on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"score_pass: {name} must be {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"score_pass: {name} must be contiguous")
    if C < 1:
        raise ValueError(f"score_pass: {C} candidates a read, at least 1")
    if not 1 <= W <= MAX_BAND:
        raise ValueError(f"score_pass: band {W} outside [1, {MAX_BAND}]")
    if not 1 <= mats.shape[0] <= MAX_MATS:
        raise ValueError(
            f"score_pass: {mats.shape[0]} matrices, at most {MAX_MATS}")
    if S < 0:
        raise ValueError(f"score_pass: slot_cap {S} must be >= 0")
    sw = torch.empty((B, C), dtype=I32, device=dev)
    n_sc = torch.empty(B, dtype=I32, device=dev)
    base = torch.empty_like(n_sc)
    meta = torch.empty(2, dtype=I32, device=dev)      # total, slot_overflow
    slot_flat = torch.empty(max(S, 1), dtype=I32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ngm_score_pass(
            reads.data_ptr(), rc.data_ptr(), lengths.data_ptr(),
            genome.data_ptr(), genome.shape[0], corr_start.data_ptr(),
            strand.data_ptr(), cand_valid.data_ptr(), score_mask.data_ptr(),
            shift, mats.data_ptr(), B, L, C, W, S, mats.shape[0], int(gopen_q),
            int(gopen_r), int(gext), int(local), sw.data_ptr(),
            n_sc.data_ptr(), base.data_ptr(), meta.data_ptr(),
            slot_flat.data_ptr(), stream,
        )
    build.check(code, "score_pass")
    score_pass.launches += 1
    return ScorePass(sw, meta[1], n_sc, base)


score_pass.launches = 0
