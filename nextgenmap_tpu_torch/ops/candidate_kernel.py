"""Wrapper of K6, candidate search (``csrc/cand_search.cu``).

Replaces ``nextgenmap_tpu/ops/candidate.py``'s ``_compact_hits``,
``_select_candidates``, ``candidate_search_dual`` and
``candidate_search_canonical`` (XLA-fused code under jax.jit, not a Pallas
kernel): from the read k-mers to the ``Candidates`` of every read.  A CPU
tensor goes to the plain version (``ops/candidate.py``'s
``candidate_search_canonical`` or ``candidate_search_dual``); a CUDA tensor
goes to the kernel, or the wrapper raises.  ``candidate_search.launches``
counts kernel launches.

The kernel keeps a read's votes on one of two routes (``plan``): "smem" in
shared memory, "global" in a scratch of 2 Np int32 a block (Np the next
power of two above 2H).  ``route=None`` takes the kernel's own rule
(``ngm_cand_search_plan``); a named route that cannot take the shape
raises before any launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from nextgenmap_tpu_torch.native import build
from nextgenmap_tpu_torch.ops.candidate import (
    Candidates, candidate_search_canonical, candidate_search_dual,
)

ROUTES = ("smem", "global")   # csrc/cand_search.cu's kRouteSmem, kRouteGlobal


class Plan(NamedTuple):
    """What K6 launches at a shape (``ngm_cand_search_plan``)."""
    route: str
    threads: int        # a read's threads
    reads: int          # reads a block
    smem_bytes: int     # dynamic shared memory a block
    blocks: int         # the grid
    np: int             # a read's padded vote array
    scratch: int        # int32 elements of the global route's scratch
    smem_limit: int     # the card's shared memory a block


def _check_route(route: str | None) -> None:
    if route is not None and route not in ROUTES:
        raise ValueError(f"candidate_search: route {route!r}: expected None "
                         f"or one of {ROUTES}")


@functools.lru_cache(maxsize=None)
def _plan(device: int, B: int, Q: int, dual: bool, H: int,
          route: str | None):
    lib = build.load()
    out = (ctypes.c_longlong * 8)()
    with torch.cuda.device(device):
        code = lib.ngm_cand_search_plan(
            B, Q, int(dual), H, -1 if route is None else ROUTES.index(route),
            out)
    p = Plan(ROUTES[out[0]], *(int(x) for x in out[1:]))
    return code, p


def plan(B: int, Q: int, dual: bool, H: int, route: str | None = None,
         device: torch.device | int | None = None) -> Plan:
    """K6's launch for B reads of Q k-mer windows (`dual`: both strands
    looked up, 2Q columns) at hit cap H on a CUDA card (the current one by
    default): the rule's route when `route` is None.  Raises ValueError
    where the route cannot take the shape."""
    _check_route(route)
    index = None if device is None else torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    code, p = _plan(index, int(B), int(Q), bool(dual), int(H), route)
    if code != 0:
        cols = 2 * Q if dual else Q
        raise ValueError(
            f"candidate_search: route {route!r} cannot take H {H} with "
            f"{cols} k-mer columns: a read needs {12 * cols + 68} bytes of "
            f"shared memory (+ {8 * p.np} on the smem route), the card "
            f"grants {p.smem_limit} a block")
    return p


def _check(tensors, offsets, positions, sensitivity, packed_offsets,
           dual_tables, dual, hit_cap, max_cmrs, stride, diag_bin_log2):
    """Raise on what the kernel does not take; `tensors` are (tensor,
    dtype, shape, name) of the k-mers and lengths.  Returns the device."""
    dev = tensors[0][0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"candidate_search: unsupported device {dev}")
    if tensors[0][0].dim() != 2 or tensors[0][0].shape[1] < 1:
        raise ValueError("candidate_search: k-mers must be [B, Q], Q >= 1")
    tables = [
        (offsets, torch.int64 if packed_offsets else torch.int32,
         tuple(offsets.shape), "offsets"),
        (positions, torch.int32, tuple(positions.shape), "positions"),
        (sensitivity, torch.float32, tuple(sensitivity.shape), "sensitivity"),
    ]
    for t, dtype, shape, name in [*tensors, *tables]:
        if t.device != dev:
            raise ValueError(f"candidate_search: {name} on {t.device}, the "
                             f"k-mers on {dev}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"candidate_search: {name} must be {dtype} "
                             f"{tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"candidate_search: {name} must be contiguous")
    if offsets.dim() != 1 or positions.dim() != 1 or offsets.numel() < 1:
        raise ValueError("candidate_search: offsets and positions must be "
                         "non-empty 1-D tables")
    if sensitivity.numel() != 1:
        raise ValueError("candidate_search: sensitivity must be one float32")
    if dual_tables and not dual:
        raise ValueError("candidate_search: dual_tables needs the two-strand "
                         "k-mers")
    if hit_cap < 1 or max_cmrs < 1 or stride < 1:
        raise ValueError(f"candidate_search: hit_cap {hit_cap}, max_cmrs "
                         f"{max_cmrs} and stride {stride} must be >= 1")
    if not 0 <= diag_bin_log2 <= 31:
        raise ValueError(f"candidate_search: diag_bin_log2 {diag_bin_log2} "
                         "outside [0, 31]")
    return dev


def candidate_search(
    kms: tuple,               # (canon, flip, ok) or (km_f, ok_f, km_r, ok_r)
    lengths: torch.Tensor,    # [B] int32
    offsets: torch.Tensor,    # CSR offsets (int32) or the packed table (int64)
    positions: torch.Tensor,  # [P] int32
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
    dual_tables: bool = False,
    route: str | None = None,
) -> Candidates:
    """Candidate search of the read k-mers `kms` as ``read_kmers`` gives
    them: canonical (3 tensors, one lookup serves both strands) or the two
    strands (4 tensors, looked up apart; `dual_tables`: the rc's in the
    second half of `offsets`).  Equal to the plain
    ``candidate_search_canonical`` / ``candidate_search_dual`` in every
    field.  `route` picks K6's route on a card (None: the rule); the plain
    version has none."""
    _check_route(route)
    dual = len(kms) == 4
    if dual:
        names = ("km_f", "ok_f", "km_r", "ok_r")
        dtypes = (torch.int32, torch.bool, torch.int32, torch.bool)
    elif len(kms) == 3:
        names = ("canon", "flip", "ok")
        dtypes = (torch.int32, torch.int32, torch.bool)
    else:
        raise ValueError(f"candidate_search: {len(kms)} k-mer tensors, "
                         "expected 3 (canonical) or 4 (two strands)")
    shape = tuple(kms[0].shape)
    tensors = [(t, d, shape, n) for t, d, n in zip(kms, dtypes, names)]
    tensors.append((lengths, torch.int32, shape[:1], "lengths"))
    dev = _check(tensors, offsets, positions, sensitivity, packed_offsets,
                 dual_tables, dual, hit_cap, max_cmrs, stride, diag_bin_log2)
    common = dict(fanout_cap=fanout_cap, hit_cap=hit_cap, max_cmrs=max_cmrs,
                  diag_bin_log2=diag_bin_log2, stride=stride,
                  packed_offsets=packed_offsets)
    if dev.type == "cpu":
        if dual:
            return candidate_search_dual(*kms, offsets, positions,
                                         sensitivity, max_freq,
                                         dual_tables=dual_tables, **common)
        return candidate_search_canonical(*kms, lengths, offsets, positions,
                                          sensitivity, max_freq, k=k,
                                          **common)
    B, Q = shape
    H, C = hit_cap, max_cmrs
    Cw = min(C, 2 * H)
    out = torch.empty((3, B, Cw), dtype=torch.int32, device=dev)
    per_read = torch.empty((2, B), dtype=torch.int32, device=dev)
    counters = torch.empty(3, dtype=torch.int32, device=dev)
    bucket, score, strand = out
    cand = Candidates(bucket=bucket, score=score, strand=strand,
                      best_score=per_read[0], fanout_overflow=counters[0],
                      hit_overflow=counters[1], cmr_overflow=counters[2],
                      extra_score=per_read[1])
    p = plan(B, Q, dual, H, route, dev)
    scratch = (torch.empty(max(p.scratch, 1), dtype=torch.int32, device=dev)
               if p.route == "global" else None)
    km0, km1 = (kms[0], kms[2]) if dual else (kms[0], kms[1])
    ok0, ok1 = (kms[1], kms[3]) if dual else (kms[2], None)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ngm_cand_search(
            km0.data_ptr(), km1.data_ptr(), ok0.data_ptr(),
            None if ok1 is None else ok1.data_ptr(), lengths.data_ptr(),
            offsets.data_ptr(), offsets.numel(), positions.data_ptr(),
            positions.numel(), sensitivity.data_ptr(), B, Q, int(dual), k,
            stride, fanout_cap, H, C, diag_bin_log2, int(max_freq),
            int(packed_offsets), int(dual_tables), ROUTES.index(p.route),
            p.threads, None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.numel(), bucket.data_ptr(),
            score.data_ptr(), strand.data_ptr(), per_read[0].data_ptr(),
            per_read[1].data_ptr(), counters.data_ptr(), stream)
    build.check(code, "candidate_search")
    if B > 0:
        candidate_search.launches += 1
    return cand


candidate_search.launches = 0
