"""Device grids: data parallelism over reads, and index sharding.

Port of ``nextgenmap_tpu/parallel/mesh.py``.  A grid is a numpy object
array of ``torch.device``:

- ``[dp]``: the reads of a batch split over dp device slots;
- ``[dp, S]`` (``index_shards=S``): the reads over dp rows, the index's S
  position-range shards over the columns.

A slot is a place a slice of the batch runs, so a device may fill several
(``[cuda:0, cuda:0]`` runs two slices on one card, one after the other:
``parallel/dp.py``).  On the CPU every slot is the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from nextgenmap_tpu_torch.device import resolve_device


def device_slots(device, n_devices: int = 1) -> list[torch.device]:
    """The slots of ``--device`` and ``--devices``/``-g`` (0 = every card):
    n cards from `device`'s index on, or n slots of the CPU.  A list of
    devices is taken as it is."""
    if isinstance(device, (list, tuple)):
        slots = [resolve_device(d) for d in device]
        if not slots:
            raise ValueError("no devices given")
        return slots
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * max(1, n_devices)
    first = dev.index or 0
    have = torch.cuda.device_count() - first
    n = n_devices or have
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    return [torch.device("cuda", first + i) for i in range(n)]


def distinct(slots) -> list[torch.device]:
    """The devices of `slots`, each once, in order of first appearance."""
    out: list[torch.device] = []
    for d in slots:
        if d not in out:
            out.append(d)
    return out


def make_mesh(slots, index_shards: int = 1) -> np.ndarray:
    """The ``[dp]`` grid of the slots, or ``[dp, S]`` with index_shards =
    S > 1, refused as the reference refuses its mesh."""
    n = len(slots)
    grid = np.empty(n, dtype=object)
    grid[:] = list(slots)
    if index_shards <= 1:
        return grid
    if n % index_shards:
        raise ValueError(
            f"{n} devices not divisible by {index_shards} index shards")
    return grid.reshape(n // index_shards, index_shards)
