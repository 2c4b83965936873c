"""Wrapper of K1, the score-only banded SW kernel (``csrc/sw_score.cu``).

Replaces ``nextgenmap_tpu/ops/sw_pallas.py::banded_sw_score_pallas`` in
local mode, and scores glocal (--end-to-end) mode too, which the reference
leaves to its plain scan.  A CPU tensor goes to the plain version
(``ops/sw_ref.py::banded_sw_score``); a CUDA tensor goes to the kernel, or
the wrapper raises.
``sw_score.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from nextgenmap_tpu_torch.native import build
from nextgenmap_tpu_torch.ops.sw_ref import (
    ScoreResult, banded_sw_score, check_mode,
)

# kMaxBand in csrc/sw_score.cu and csrc/sw_align.cu: 1024 threads x 8
# cells.  Past it K4's [L, B, W] direction bytes exhaust the card first
MAX_BAND = 8192
MAX_MATS = 8     # kMaxMats in csrc/sw_score.cu


def sw_score(
    query: torch.Tensor,   # [S, L] uint8 codes
    qlen: torch.Tensor,    # [S] int32
    ref: torch.Tensor,     # [S, L + band] uint8 corridors
    matrix: torch.Tensor,  # [M, 8, 8] or [8, 8] int32
    gopen_q: int,
    gopen_r: int,
    gext: int,
    msel: torch.Tensor | None = None,  # [S] int32 in [0, M)
    *,
    band: int,
    mode: str = "local",
) -> ScoreResult:
    """Banded SW score, local or glocal (`mode`): (score, end_i, end_o),
    each [S] int32."""
    if query.device.type == "cpu":
        return banded_sw_score(query, qlen, ref, matrix, gopen_q, gopen_r,
                               gext, msel, band=band, mode=mode)
    local = check_mode(mode)
    dev = query.device
    if dev.type != "cuda":
        raise ValueError(f"sw_score: unsupported device {dev}")
    S, L = query.shape
    W = band
    mats = matrix.reshape(-1, 8, 8)
    if msel is None:
        msel = torch.zeros(S, dtype=torch.int32, device=dev)
    checks = (
        (query, torch.uint8, (S, L), "query"),
        (qlen, torch.int32, (S,), "qlen"),
        (ref, torch.uint8, (S, L + W), "ref"),
        (mats, torch.int32, tuple(mats.shape), "matrix"),
        (msel, torch.int32, (S,), "msel"),
    )
    for t, dtype, shape, name in checks:
        if t.device != dev:
            raise ValueError(f"sw_score: {name} on {t.device}, query on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"sw_score: {name} must be {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"sw_score: {name} must be contiguous")
    if not 1 <= W <= MAX_BAND:
        raise ValueError(f"sw_score: band {W} outside [1, {MAX_BAND}]")
    if not 1 <= mats.shape[0] <= MAX_MATS:
        raise ValueError(f"sw_score: {mats.shape[0]} matrices, at most {MAX_MATS}")
    score = torch.empty(S, dtype=torch.int32, device=dev)
    end_i = torch.empty_like(score)
    end_o = torch.empty_like(score)
    if S == 0:
        return ScoreResult(score, end_i, end_o)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ngm_sw_score(
            query.data_ptr(), qlen.data_ptr(), ref.data_ptr(),
            mats.data_ptr(), msel.data_ptr(), S, L, W, mats.shape[0],
            int(gopen_q), int(gopen_r), int(gext), int(local),
            score.data_ptr(), end_i.data_ptr(), end_o.data_ptr(), stream,
        )
    build.check(code, "sw_score")
    sw_score.launches += 1
    return ScoreResult(score, end_i, end_o)


sw_score.launches = 0
