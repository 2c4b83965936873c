"""Wrapper of K3, the dynamic-gather probe's kernel (``csrc/row_gather.cu``).

Replaces the Pallas kernel of ``tools/probe_dyngather.py`` (a capability
probe; no path of the mapper runs it).  On int32 [R, W] arrays x and idx:

    out[r, j] = sum_{i < rep} take_along_dim(x, (idx + 7 i) mod extent, dim)[r, j]

with extent = x.shape[dim] and the sum wrapping in int32.  A CPU tensor
goes to the plain version; a CUDA tensor goes to the kernel, or the wrapper
raises.  ``row_gather.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from nextgenmap_tpu_torch.native import build

# dim 1 stages a row in shared memory: the most a block may use on Hopper
MAX_SHARED_BYTES = 232_448
MAX_DIM0_ROWS = 65_535          # dim 0 puts rows on the grid's y axis


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
    if dim == 1 and 4 * W > MAX_SHARED_BYTES:
        raise ValueError(f"dim 1 stages a row of {4 * W} bytes in shared "
                         f"memory; at most {MAX_SHARED_BYTES} fit")
    if dim == 0 and R > MAX_DIM0_ROWS:
        raise ValueError(f"dim 0 takes at most {MAX_DIM0_ROWS} rows, got {R}")
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
