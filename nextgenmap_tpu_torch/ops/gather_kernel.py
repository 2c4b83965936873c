"""Wrapper of K2, the corridor window gather (``csrc/gather_windows.cu``).

Replaces ``nextgenmap_tpu/ops/gather_pallas.py::dma_gather_windows``.  A CPU
tensor goes to the plain version (``ops/gather.py``); a CUDA tensor goes to
the kernel, or the wrapper raises.  ``gather_genome_windows.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from nextgenmap_tpu_torch.native import build
from nextgenmap_tpu_torch.ops.gather import gather_windows, pad_table

PAD = 4


def gather_genome_windows(genome: torch.Tensor, starts: torch.Tensor,
                          size: int) -> torch.Tensor:
    """genome[s : s+size] per start (any shape) with PAD past the genome end.

    Starts are clamped to [0, G], exactly as
    gather_windows(pad_table(genome, size, PAD), starts, size) clamps them.
    Returns [..., size] uint8.  Any window length is allowed.
    """
    if genome.device.type == "cpu" and starts.device.type == "cpu":
        return gather_windows(pad_table(genome, size, PAD), starts, size)
    if genome.device.type != "cuda" or starts.device != genome.device:
        raise ValueError(
            f"gather_genome_windows: genome on {genome.device}, starts on "
            f"{starts.device}; both must be on the CPU or on one CUDA device"
        )
    if genome.dtype != torch.uint8 or genome.dim() != 1:
        raise ValueError("genome must be a 1-D uint8 tensor")
    if starts.dtype != torch.int32:
        raise ValueError(f"starts must be int32, got {starts.dtype}")
    if not (genome.is_contiguous() and starts.is_contiguous()):
        raise ValueError("genome and starts must be contiguous")
    if size < 1:
        raise ValueError(f"window size must be >= 1, got {size}")
    out = torch.empty((*starts.shape, size), dtype=torch.uint8,
                      device=genome.device)
    n = starts.numel()
    if n == 0:
        return out
    lib = build.load()
    with torch.cuda.device(genome.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.ngm_gather_windows(
            genome.data_ptr(), genome.shape[0], starts.data_ptr(), n, size,
            out.data_ptr(), stream,
        )
    build.check(code, "gather_windows")
    gather_genome_windows.launches += 1
    return out


gather_genome_windows.launches = 0
