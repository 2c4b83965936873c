"""Wrapper of K3, the dynamic-gather probe's kernel (``csrc/row_gather.cu``).

Replaces the Pallas kernel of ``tools/probe_dyngather.py`` (a capability
probe; no path of the mapper runs it).  On int32 [R, W] arrays x and idx:

    out[r, j] = sum_{i < rep} take_along_dim(x, (idx + 7 i) mod extent, dim)[r, j]

with extent = x.shape[dim] and the sum wrapping in int32.  A CPU tensor
goes to the plain version; a CUDA tensor goes to the kernel, or the wrapper
raises.  ``row_gather.launches`` counts kernel launches.

``plan`` is the shape rule: which of the kernel's four variants serves a
shape, with its strip width, grid, threads and shared memory (the source
note of ``row_gather.cu`` says why each).  The kernel library applies the
same rule, and a card test holds the two equal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nextgenmap_tpu_torch.native import build

MAX_SHARED_BYTES = 232_448     # the most a block may use on Hopper
SM_SHARED_BYTES = 233_472      # an SM's; the runtime reserves 1 KB a block
CARD_SMS = 132                 # H100 SXM
MAX_DIM0_ROWS = 65_535         # the dim 0 walk puts rows on the grid's y axis
RUN = 32                       # dim 1: gathers of a run
EXT_WORDS = 7 * (RUN - 1)      # dim 1: words a row is extended by
# dim 1, rotated
ROT_THREADS = 512
ROT_CHUNK = 2 * ROT_THREADS    # outputs a block serves, at the least
ROT_FIXED_BYTES = 1024         # static shared memory, bounded
ROT_BLOCKS = 4 * CARD_SMS      # four resident an SM
# dim 0, strip
STRIP_THREADS = 1024
STRIP_RUN = 8
STRIP_EXT_BYTES = 4 * 7 * 32 * (STRIP_RUN - 1)
STRIP_WIDTHS = (32, 16, 8, 4, 2, 1)
# the parent's kernels, kept for the shapes the new ones cannot stage
STAGED_THREADS = 1024
WALK_THREADS = 256

VARIANTS = ("rotated", "staged", "strip", "walk")   # the C side's codes


class Plan(NamedTuple):
    variant: str
    strip: int            # dim 0 strip width C (0 for the other variants)
    grid: tuple[int, int]
    threads: int
    shared_bytes: int     # dynamic shared memory a block
    per_block: int        # outputs of a row (rotated) or output rows
                          # (strip) that a block serves


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(R: int, W: int, dim: int) -> Plan:
    """The launch of an [R, W] call along `dim` (csrc/row_gather.cu says
    why each variant serves its shapes); ValueError where the kernel takes
    no such shape."""
    r1, w1 = max(R, 1), max(W, 1)
    if dim == 1:
        stride = _cdiv(W + EXT_WORDS, 4) * 4          # the row, 16-byte aligned
        room = (MAX_SHARED_BYTES - ROT_FIXED_BYTES) // 4 - stride
        if room >= ROT_CHUNK:
            # a block serves `per` chunks of a row: all of it where rows
            # fill the card and the indices fit, else a part
            chunks = _cdiv(w1, ROT_CHUNK)
            parts = max(min(chunks, _cdiv(ROT_BLOCKS, r1)),
                        _cdiv(chunks, room // ROT_CHUNK))
            per = _cdiv(chunks, parts)
            span = per * ROT_CHUNK
            ids = min(span, _cdiv(W, 4) * 4)
            return Plan("rotated", 0, (R, _cdiv(chunks, per)), ROT_THREADS,
                        4 * (stride + ids), span)
        if 4 * W <= MAX_SHARED_BYTES:
            return Plan("staged", 0, (R, 1), STAGED_THREADS, 4 * W, 0)
        raise ValueError(f"dim 1 stages a row of {4 * W} bytes in shared "
                         f"memory; at most {MAX_SHARED_BYTES} fit")
    if R > MAX_DIM0_ROWS:
        raise ValueError(f"dim 0 takes at most {MAX_DIM0_ROWS} rows, got {R}")
    fits = [c for c in STRIP_WIDTHS
            if 4 * R * c + STRIP_EXT_BYTES <= MAX_SHARED_BYTES]
    if not fits:
        return Plan("walk", 0, (_cdiv(w1, WALK_THREADS), R), WALK_THREADS,
                    0, 0)
    C = fits[0]
    shared = 4 * R * C + STRIP_EXT_BYTES
    strips = _cdiv(w1, C)
    resident = min(2, SM_SHARED_BYTES // (shared + 1024))
    rows = _cdiv(r1, min(r1, _cdiv(CARD_SMS * resident, strips)))
    return Plan("strip", C, (strips, _cdiv(R, rows)), STRIP_THREADS, shared,
                rows)


def row_gather_plain(x: torch.Tensor, idx: torch.Tensor, rep: int,
                     dim: int) -> torch.Tensor:
    """The plain PyTorch version: torch.take_along_dim summed over rep."""
    extent = x.shape[dim]
    acc = torch.zeros_like(x)
    for i in range(rep):
        acc += torch.take_along_dim(x, (idx.long() + 7 * i) % extent, dim=dim)
    return acc


def row_gather(x: torch.Tensor, idx: torch.Tensor, rep: int,
               dim: int) -> torch.Tensor:
    """out[r, j] = sum over i < rep of x gathered along `dim` at
    (idx + 7 i) mod x.shape[dim]; int32 [R, W] in and out."""
    if dim not in (0, 1):
        raise ValueError(f"dim must be 0 or 1, got {dim}")
    if rep < 0:
        raise ValueError(f"rep must be >= 0, got {rep}")
    if x.shape != idx.shape or x.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} and idx {tuple(idx.shape)} must "
                         "be 2-D and of one shape")
    if x.dtype != torch.int32 or idx.dtype != torch.int32:
        raise ValueError(f"x and idx must be int32, got {x.dtype}, {idx.dtype}")
    if x.device.type == "cpu" and idx.device.type == "cpu":
        return row_gather_plain(x, idx, rep, dim)
    if x.device.type != "cuda" or idx.device != x.device:
        raise ValueError(f"row_gather: x on {x.device}, idx on {idx.device}; "
                         "both must be on the CPU or on one CUDA device")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("x and idx must be contiguous")
    R, W = x.shape
    plan(R, W, dim)       # refuses what the kernel does not take
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ngm_row_gather(x.data_ptr(), idx.data_ptr(), R, W, rep, dim,
                                  out.data_ptr(), stream)
    build.check(code, "row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0
