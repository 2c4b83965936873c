"""Wrapper of the pair-select kernel (``csrc/pair_select.cu``:
``pair_select_kernel``).

Replaces the pair resolution of the reference's
``nextgenmap_tpu/models/mapper.py::_paired_tail`` (XLA-fused under
jax.jit): for each pair (rows 2i and 2i + 1) the C x C grid of candidate
combinations under the FR-orientation and insert-window mask, its first
best combined score, the cutoff against the mates' best singletons, and
the fallback to them.  A CPU tensor goes to the plain version
(``pair_select_plain``: the grid in torch ops); a CUDA tensor goes to one
launch of the kernel, a warp a pair, or the wrapper raises.
``pair_select.launches`` counts the launches on a card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nextgenmap_tpu_torch.native import build

I32 = torch.int32
MAX_C = 4096   # c1 x C + c2, the grid's flat index, stays an int32


class Pairing(NamedTuple):
    a1: torch.Tensor       # [B] int64, the chosen candidate of each mate
    proper: torch.Tensor   # [B] bool, the pair's verdict on both mates


def pair_select_plain(sw, corr_start, strand, cand_valid, n_cands,
                      min_insert, max_insert, pair_cutoff, *, read_len,
                      slack, margin, counters=None) -> Pairing:
    """The plain version: the [P, C, C] grid in torch ops, the gridded and
    broken pairs added to `counters` ([2] int64) unless it is None.  On
    CUDA tensors the same ops run as torch kernels, the card path before
    the kernel."""
    B, C = sw.shape
    L = read_len
    P = B // 2
    np_ = n_cands.reshape(P, 2)
    pair_multi = np_.amax(dim=1) >= 2          # either mate has >= 2

    s = sw.reshape(P, 2, C)
    # approximate alignment start = corridor start + slack (the diagonal)
    pos = (corr_start + slack).reshape(P, 2, C)
    st = strand.reshape(P, 2, C)
    exist = cand_valid.reshape(P, 2, C)
    s1m, s2m = s[:, 0, :, None], s[:, 1, None, :]          # [P, C, 1], [P, 1, C]
    p1, p2 = pos[:, 0, :, None], pos[:, 1, None, :]
    st1, st2 = st[:, 0, :, None], st[:, 1, None, :]

    # FR orientation: strands differ and the forward mate lies leftmost
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
    if counters is not None:
        counters += torch.stack([pair_multi.sum(),
                                 (pair_multi & ~proper_pair).sum()])
    return Pairing(torch.stack([sel1, sel2], dim=1).reshape(B),
                   proper_pair.repeat_interleave(2))


def pair_select(sw: torch.Tensor,          # [B, C] int32
                corr_start: torch.Tensor,  # [B, C] int32
                strand: torch.Tensor,      # [B, C] int32
                cand_valid: torch.Tensor,  # [B, C] bool
                n_cands: torch.Tensor,     # [B] int32
                min_insert: torch.Tensor,  # [] int32
                max_insert: torch.Tensor,  # [] int32
                pair_cutoff: torch.Tensor,  # [] float32
                *, read_len: int, slack: int, margin: int,
                counters: torch.Tensor | None = None) -> Pairing:
    """Resolve each pair of mates (rows 2i / 2i + 1): a pair where a mate
    has >= 2 candidates takes the first best combination (c1, then c2
    ascending) of candidates on opposite strands, the forward one leftmost
    (within `margin`), whose span |p2 - p1| + read_len, p = corr_start +
    slack, lies in [min_insert - margin, max_insert + margin], both
    existing and scored > 0, if its score sum is > 0 and at least
    pair_cutoff x (best1 + best2) in float32; a pair of single candidates
    is proper by the geometry of (0, 0) alone.  A pair that is not proper
    takes each mate's first best column of `sw`.  Integer arithmetic wraps
    as int32.  `counters` ([2] int64 on the same device, or None) adds the
    pairs whose grid was searched (a mate with >= 2 candidates) and those
    of them that were not proper.
    """
    if sw.device.type == "cpu":
        return pair_select_plain(
            sw, corr_start, strand, cand_valid, n_cands, min_insert,
            max_insert, pair_cutoff, read_len=read_len, slack=slack,
            margin=margin, counters=counters)
    dev = sw.device
    if dev.type != "cuda":
        raise ValueError(f"pair_select: unsupported device {dev}")
    if sw.dim() != 2:
        raise ValueError(f"pair_select: sw must be [B, C], got "
                         f"{tuple(sw.shape)}")
    B, C = sw.shape
    if B % 2 or not 1 <= C <= MAX_C:
        raise ValueError(f"pair_select: [{B}, {C}] needs an even B and C in "
                         f"[1, {MAX_C}]")
    checks = [
        (sw, I32, (B, C), "sw"),
        (corr_start, I32, (B, C), "corr_start"),
        (strand, I32, (B, C), "strand"),
        (cand_valid, torch.bool, (B, C), "cand_valid"),
        (n_cands, I32, (B,), "n_cands"),
        (min_insert, I32, (), "min_insert"),
        (max_insert, I32, (), "max_insert"),
        (pair_cutoff, torch.float32, (), "pair_cutoff"),
    ]
    if counters is not None:
        checks.append((counters, torch.int64, (2,), "counters"))
    for t, dtype, shape, name in checks:
        if t.device != dev:
            raise ValueError(f"pair_select: {name} on {t.device}, sw on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"pair_select: {name} must be {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"pair_select: {name} must be contiguous")
    a1 = torch.empty(B, dtype=torch.int64, device=dev)
    proper = torch.empty(B, dtype=torch.bool, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        code = lib.ngm_pair_select(
            sw.data_ptr(), corr_start.data_ptr(), strand.data_ptr(),
            cand_valid.data_ptr(), n_cands.data_ptr(), min_insert.data_ptr(),
            max_insert.data_ptr(), pair_cutoff.data_ptr(), B // 2, C,
            int(read_len), int(slack), int(margin),
            None if counters is None else counters.data_ptr(),
            a1.data_ptr(), proper.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(code, "pair_select")
    pair_select.launches += 1
    return Pairing(a1, proper)


pair_select.launches = 0
