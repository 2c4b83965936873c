"""Wrapper of K4, banded SW with traceback (``csrc/sw_align.cu``).

Replaces ``nextgenmap_tpu/ops/sw_ref.py::banded_sw_align`` (a ``lax.scan``
over the rows, then the row-synchronised backwalk; not a Pallas kernel) on
every mapping path, in local and glocal mode.  A CPU tensor goes to the
plain version (``ops/sw_ref.py::banded_sw_align``); a CUDA tensor goes to
the kernel, or the wrapper raises.  ``sw_align.launches`` counts kernel
launches.

The kernel keeps each cell's 4 direction bits packed, on one of two routes
(``plan``): "smem" holds them in shared memory, "global" in a scratch of
S x L packed rows that the walk reads back in chunks.  ``route=None`` takes
the kernel's shape rule; a named route that cannot take the shape raises
before any launch.  ``sw_align`` (the mapping path) never allocates the
plain version's [L, S, W] direction bytes; ``sw_align_with_dirs`` asks the
kernel for them too, to hold its forward pass against
``sw_ref.banded_sw_forward``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from nextgenmap_tpu_torch.native import build
from nextgenmap_tpu_torch.ops.sw_kernel import MAX_BAND, MAX_MATS
from nextgenmap_tpu_torch.ops.sw_ref import (
    AlignResult, banded_sw_align, check_mode,
)

N_FIELDS = 9   # kFields in csrc/sw_align.cu: the int32 fields, one row each
ROUTES = ("smem", "global")   # csrc/sw_align.cu's kRouteSmem, kRouteGlobal


class Plan(NamedTuple):
    """What K4 launches at a shape (``ngm_sw_align_plan``)."""
    route: str            # "smem" or "global"
    lanes: int            # lanes per alignment (threads a block past W 512)
    cells_per_lane: int
    row_bytes: int        # one alignment's packed row
    threads: int          # a block, as launched
    smem_bytes: int       # dynamic shared memory a block, as launched
    blocks_per_sm: int    # of those resident on one SM (0: the route
                          # cannot take the shape)
    route_warps_per_sm: int   # the route's capacity at blocks of up to 4
                              # warps, which the shape rule reads

    @property
    def warps_per_sm(self) -> int:
        """Warps of the launch's blocks that one SM holds."""
        return self.blocks_per_sm * self.threads // 32


def _check_route(route: str | None) -> None:
    if route is not None and route not in ROUTES:
        raise ValueError(f"sw_align: route {route!r}: expected None or one "
                         f"of {ROUTES}")


@functools.lru_cache(maxsize=None)
def _plan(device: int, S: int, L: int, W: int, local: bool,
          route: str | None):
    lib = build.load()
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(device):
        code = lib.ngm_sw_align_plan(S, L, W, int(local),
                                     -1 if route is None
                                     else ROUTES.index(route), out)
    build.check(code, "sw_align plan")
    return Plan(ROUTES[out[0]], *out[1:])


def plan(S: int, L: int, W: int, mode: str = "local",
         route: str | None = None,
         device: torch.device | int | None = None) -> Plan:
    """K4's launch for S alignments at [S, L] x W on a CUDA card (the
    current one by default): the shape rule's route when `route` is None,
    and the block the kernel is launched with.  Raises ValueError where the
    named route cannot take the shape."""
    _check_route(route)
    local = check_mode(mode)
    if not 1 <= W <= MAX_BAND:
        raise ValueError(f"sw_align: band {W} outside [1, {MAX_BAND}]")
    index = None if device is None else torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    p = _plan(index, int(S), int(L), int(W), local, route)
    if p.blocks_per_sm == 0 or (route is not None and p.route != route):
        raise ValueError(
            f"sw_align: route {route!r} cannot take [{L}]x W{W} ({mode}): "
            f"{p.smem_bytes} bytes of shared memory a block")
    return p


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
    route: str | None = None,
) -> AlignResult:
    """Banded SW with traceback, local or glocal (`mode`): AlignResult with
    ops [S, max_ops or L + band] END->START.

    `route` picks K4's route on a card (None: the shape rule); the plain
    version has none.
    """
    _check_route(route)
    if query.device.type == "cpu":
        return banded_sw_align(query, qlen, ref, matrix, gopen_q, gopen_r,
                               gext, msel, band=band, max_ops=max_ops,
                               mode=mode)
    return _launch(query, qlen, ref, matrix, gopen_q, gopen_r, gext, msel,
                   band, max_ops, mode, route, want_dirs=False)[0]


def sw_align_with_dirs(query, qlen, ref, matrix, gopen_q, gopen_r, gext,
                       msel=None, *, band, max_ops=0, mode="local",
                       route=None):
    """K4 on CUDA tensors: (AlignResult, dirs [L, S, W] uint8), the
    direction bytes being the ones ``sw_ref.banded_sw_forward`` packs."""
    return _launch(query, qlen, ref, matrix, gopen_q, gopen_r, gext, msel,
                   band, max_ops, mode, route, want_dirs=True)


def _launch(query, qlen, ref, matrix, gopen_q, gopen_r, gext, msel, band,
            max_ops, mode, route, want_dirs):
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
    dirs = (torch.empty((L, S, W), dtype=torch.uint8, device=dev)
            if want_dirs else None)
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
    p = plan(S, L, W, mode, route, dev)
    # the global route's packed rows, [S, L, row_bytes]; never read past
    # what the kernel wrote
    scratch = (torch.empty(max(S * L * p.row_bytes, 16), dtype=torch.uint8,
                           device=dev)
               if p.route == "global" else None)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ngm_sw_align(
            query.data_ptr(), qlen.data_ptr(), ref.data_ptr(),
            mats.data_ptr(), msel.data_ptr(), S, L, W, mats.shape[0],
            int(gopen_q), int(gopen_r), int(gext), int(local), MO,
            ROUTES.index(p.route), p.threads,
            None if scratch is None else scratch.data_ptr(),
            None if dirs is None else dirs.data_ptr(), out.data_ptr(),
            ops.data_ptr(), trunc.data_ptr(), stream,
        )
    build.check(code, "sw_align")
    sw_align.launches += 1
    return res, dirs


sw_align.launches = 0
