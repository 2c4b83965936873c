"""Contiguous-window gathers in plain PyTorch.

Port of ``nextgenmap_tpu/ops/gather.py``: ``gather_windows`` over a table
padded by ``pad_table`` is the plain version of the hand-written CUDA kernel
in ``csrc/gather_windows.cu`` (wrapper: ``ops/gather_kernel.py``).

The reference's ``permute_small``, ``take_rows_mxu`` and ``select_rows``
exist to avoid element gathers on the TPU; in the port they are plain
indexing or ``torch.gather`` at their call sites.
"""

from __future__ import annotations

import torch


def gather_windows(table: torch.Tensor, starts: torch.Tensor,
                   size: int) -> torch.Tensor:
    """table[s : s+size] for every s in `starts` (any shape) -> [..., size].

    `table` is already padded so that max(starts) + size <= len(table)
    (see pad_table); starts are still clamped to [0, len(table) - size].
    """
    P = table.shape[0]
    idx = starts.to(torch.int64).clamp(0, P - size)
    cols = torch.arange(size, dtype=torch.int64, device=table.device)
    return table[idx[..., None] + cols]


def pad_table(table: torch.Tensor, size: int, fill) -> torch.Tensor:
    """Pad a 1-D table by `size` fill elements so window gathers never clamp."""
    return torch.cat([table, table.new_full((size,), fill)])
