"""Carry the reference's state across as the port's own objects.

This module is the one place where state crosses from the JAX package into
the port, without importing it: each function takes the reference's object
as it is and reads only its fields.

- ``state_from_numpy``: genome codes, a CSR index (from
  ``build_index_device`` or ``KmerIndex.device_arrays()``) and score
  matrices, as numpy-convertible arrays, become the port's device tensors,
  so both packages can run on the identical index.  A bisulfite state is the
  concatenated CT and GA tables (``index.device_build.concat_tables``, the
  layout of the reference's Mapper) and the two strand matrices.
- ``config_from_reference``: a reference ``NgmConfig`` as the port's.
- ``index_from_reference``: a reference host ``KmerIndex`` (or a (CT, GA)
  pair of them) as the port's, holding the same arrays.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.index.kmer_index import KmerIndex


class MapperState(NamedTuple):
    genome: torch.Tensor     # [G] uint8 base codes
    offsets: torch.Tensor    # [4^k + 1 (+1)] int32 CSR row offsets, two
                             # tables one after the other in bisulfite mode
    positions: torch.Tensor  # [P] int32 entries: (pos << 1 | flip) of a
                             # canonical index, else genome positions
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


def config_from_reference(cfg) -> NgmConfig:
    """A reference NgmConfig (same fields) as the port's NgmConfig."""
    return NgmConfig(**dataclasses.asdict(cfg))


def index_from_reference(index):
    """A reference host KmerIndex as the port's, on the same arrays; a
    (CT, GA) tuple of them converts element-wise."""
    if isinstance(index, tuple):
        return tuple(index_from_reference(x) for x in index)
    return KmerIndex(
        k=index.k, skip=index.skip, max_freq=index.max_freq,
        collapse=index.collapse, genome_sha1=index.genome_sha1,
        offsets=index.offsets, positions=index.positions,
        canonical=index.canonical,
    )
