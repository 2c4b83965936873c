"""Carry the reference's state across as the port's tensors.

The JAX package's genome codes, CSR index (from ``build_index_device`` or
``KmerIndex.device_arrays()``) and score matrices are numpy-convertible
arrays; ``state_from_numpy`` turns them into the port's device tensors, so
both packages can run on the identical index.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class MapperState(NamedTuple):
    genome: torch.Tensor     # [G] uint8 base codes
    offsets: torch.Tensor    # [4^k + 1 (+1)] int32 CSR row offsets
    positions: torch.Tensor  # [P] int32 (pos << 1 | flip) entries
    matrices: torch.Tensor   # [M, 8, 8] int32 substitution matrices


def state_from_numpy(genome_codes, offsets, positions, matrices,
                     device: torch.device | str) -> MapperState:
    """numpy (or numpy-convertible) arrays -> MapperState on `device`."""

    def to(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)

    return MapperState(
        genome=to(genome_codes, np.uint8),
        offsets=to(offsets, np.int32),
        positions=to(positions, np.int32),
        matrices=to(matrices, np.int32).reshape(-1, 8, 8),
    )
