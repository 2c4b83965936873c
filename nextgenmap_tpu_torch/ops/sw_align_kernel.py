"""Wrapper of K4, banded SW with traceback (``csrc/sw_align.cu``).

Replaces ``nextgenmap_tpu/ops/sw_ref.py::banded_sw_align`` (a ``lax.scan``
over the rows, then the row-synchronised backwalk; not a Pallas kernel) on
every mapping path, in local and glocal mode.  A CPU tensor goes to the
plain version (``ops/sw_ref.py::banded_sw_align``); a CUDA tensor goes to
the kernel, or the wrapper raises.  ``sw_align.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from nextgenmap_tpu_torch.native import build
from nextgenmap_tpu_torch.ops.sw_kernel import MAX_BAND, MAX_MATS
from nextgenmap_tpu_torch.ops.sw_ref import (
    AlignResult, banded_sw_align, check_mode,
)

N_FIELDS = 9   # kFields in csrc/sw_align.cu: the int32 fields, one row each


def sw_align(
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
    max_ops: int = 0,
    mode: str = "local",
    simple: bool = False,
) -> AlignResult:
    """Banded SW with traceback, local or glocal (`mode`): AlignResult with
    ops [S, max_ops or L + band] END->START.

    `simple` is kept for signature parity with the reference; the kernel
    looks substitution scores up directly, which is exact for any matrix.
    """
    if query.device.type == "cpu":
        return banded_sw_align(query, qlen, ref, matrix, gopen_q, gopen_r,
                               gext, msel, band=band, max_ops=max_ops,
                               mode=mode, simple=simple)
    return sw_align_with_dirs(query, qlen, ref, matrix, gopen_q, gopen_r,
                              gext, msel, band=band, max_ops=max_ops,
                              mode=mode)[0]


def sw_align_with_dirs(query, qlen, ref, matrix, gopen_q, gopen_r, gext,
                       msel=None, *, band, max_ops=0, mode="local"):
    """K4 on CUDA tensors: (AlignResult, dirs [L, S, W] uint8), the
    direction bytes being the ones ``sw_ref.banded_sw_forward`` packs."""
    local = check_mode(mode)
    dev = query.device
    if dev.type != "cuda":
        raise ValueError(f"sw_align: unsupported device {dev}")
    S, L = query.shape
    W = band
    MO = max_ops or (L + W)
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
            raise ValueError(f"sw_align: {name} on {t.device}, query on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"sw_align: {name} must be {dtype} {shape}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"sw_align: {name} must be contiguous")
    if not 1 <= W <= MAX_BAND:
        raise ValueError(f"sw_align: band {W} outside [1, {MAX_BAND}]")
    if not 1 <= mats.shape[0] <= MAX_MATS:
        raise ValueError(f"sw_align: {mats.shape[0]} matrices, at most {MAX_MATS}")
    if MO < 1:
        raise ValueError(f"sw_align: max_ops {MO} must be >= 1")
    dirs = torch.empty((L, S, W), dtype=torch.uint8, device=dev)
    out = torch.empty((N_FIELDS, S), dtype=torch.int32, device=dev)
    ops = torch.empty((S, MO), dtype=torch.uint8, device=dev)
    trunc = torch.empty(S, dtype=torch.bool, device=dev)
    score, q_start, q_end, r_start, r_end, n_ops, matches, mism, indels = out
    res = AlignResult(score=score, q_start=q_start, q_end=q_end,
                      r_start=r_start, r_end=r_end, ops=ops, n_ops=n_ops,
                      matches=matches, mismatches=mism, indels=indels,
                      trunc=trunc)
    if S == 0:
        return res, dirs
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ngm_sw_align(
            query.data_ptr(), qlen.data_ptr(), ref.data_ptr(),
            mats.data_ptr(), msel.data_ptr(), S, L, W, mats.shape[0],
            int(gopen_q), int(gopen_r), int(gext), int(local), MO,
            dirs.data_ptr(), out.data_ptr(), ops.data_ptr(),
            trunc.data_ptr(), stream,
        )
    build.check(code, "sw_align")
    sw_align.launches += 1
    return res, dirs


sw_align.launches = 0
