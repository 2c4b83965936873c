"""Data parallelism over reads: one slice of each batch per device slot.

Port of ``nextgenmap_tpu/parallel/dp.py`` (``make_dp_map_step``: a
shard_map over the "dp" mesh axis).  Each slot holds a contiguous slice of
the batch, and the genome, index and matrices are replicated (one copy per
device, ``models/mapper.py::Mapper``).  The mapping step has no cross-read
communication, so the only reductions are the sums of the two overflow
counters.  Contiguous slices keep mates 2i / 2i+1 together while the slice
is even (the runner rounds the batch to a multiple of 2 x slots).

The reference runs its slices as one program over its devices.  Here the
slices run one after the other (``SliceRunner``), each under its device and
on that device's current stream: the step is bound by the host dispatch of
the traceback, so worker threads only contend for the GIL
(``tools/dp_overlap.py``: on two slots of one H100, slices in worker
threads took 2.28x the loop's time a batch).  Several cards were not
measured.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def split_batch(codes: np.ndarray, lengths: np.ndarray, n: int,
                paired: bool) -> list[tuple[np.ndarray, np.ndarray]]:
    """n contiguous slices of a [B, L] batch, B divisible by n (by 2n when
    paired, so that no pair straddles two slices)."""
    B = codes.shape[0]
    m = 2 * n if paired else n
    if B % m:
        raise ValueError(f"batch of {B} reads does not split over {n} "
                         f"devices{' in pairs' if paired else ''}")
    b = B // n
    return [(codes[i * b:(i + 1) * b], lengths[i * b:(i + 1) * b])
            for i in range(n)]


class SliceRunner:
    """Runs fn(i) for each row i of `rows` (the devices row i touches, its
    first one holding its result), in row order, each under its row's
    first device."""

    def __init__(self, rows: list[list[torch.device]]):
        self.rows = rows

    def run(self, fn) -> list:
        """[fn(0), ..., fn(n-1)]."""
        out = []
        for i, row in enumerate(self.rows):
            with (torch.cuda.device(row[0]) if row[0].type == "cuda"
                  else contextlib.nullcontext()):
                out.append(fn(i))
        return out


def concat_results(results: list, device: torch.device):
    """The slices' MapResults as one, in slice order, on `device`: per-read
    fields concatenated, the two overflow counters summed (the reference's
    psum over "dp")."""
    first = results[0]
    fields = {}
    for name in first._fields:
        vals = [getattr(r, name).to(device) for r in results]
        if name in ("fanout_overflow", "cmr_overflow"):
            fields[name] = torch.stack(vals).sum(dtype=torch.int32)
        else:
            fields[name] = torch.cat(vals)
    return type(first)(**fields)
