"""Data parallelism over reads: one slice of each batch per device slot.

Port of ``nextgenmap_tpu/parallel/dp.py`` (``make_dp_map_step``: a jitted
shard_map over the "dp" mesh axis).  Each slot holds a contiguous slice of
the batch, and the genome, index and matrices are replicated (one copy per
device, ``models/mapper.py::Mapper``).  The mapping step has no cross-read
communication, so the only reductions are the sums of the two overflow
counters.  Contiguous slices keep mates 2i / 2i+1 together while the slice
is even (the runner rounds the batch to a multiple of 2 x slots).

The reference runs its slices as one program over its devices.  Here the
slots are grouped by device (``slices_by_device``): a device's slices run
as one step graph, its K slices stacked as ``--megabatch`` stacks batches
(``models/step_graph.py``), each slice a step of its own with its own slot
caps, as under the reference's shard_map.  The graphs of several devices
are queued from one thread with no host sync between them, so their
slices overlap on their cards; on one card (``[cuda:0, cuda:0]``) the two
slices are one replay.  ``join_slices`` puts the slices back in slot order.
"""

from __future__ import annotations

import torch

from nextgenmap_tpu_torch.parallel.mesh import distinct

OVERFLOW = ("fanout_overflow", "cmr_overflow")


def split_batch(codes, lengths, n: int, paired: bool) -> tuple:
    """n contiguous slices of a [B, L] batch (numpy or a tensor), B
    divisible by n (by 2n when paired, so that no pair straddles two
    slices): (codes [n, B / n, L], lengths [n, B / n]), views."""
    B = codes.shape[0]
    m = 2 * n if paired else n
    if B % m:
        raise ValueError(f"batch of {B} reads does not split over {n} "
                         f"devices{' in pairs' if paired else ''}")
    return codes.reshape(n, B // n, -1), lengths.reshape(n, B // n)


def slices_by_device(slots) -> dict:
    """{device: the indices of its slots, in slot order}, the devices in
    order of first appearance: [cuda:0, cuda:1, cuda:0, cuda:1] ->
    {cuda:0: [0, 2], cuda:1: [1, 3]}."""
    return {d: [i for i, s in enumerate(slots) if s == d]
            for d in distinct(slots)}


def pick(x, ix: list):
    """Rows ix of x (numpy or a tensor): x itself when ix is all of them,
    in order."""
    return x if ix == list(range(x.shape[0])) else x[ix]


def concat_results(results: list, device: torch.device):
    """The slices' MapResults as one, in slice order, on `device`: per-read
    fields concatenated, the two overflow counters summed (the reference's
    psum over "dp")."""
    first = results[0]
    fields = {}
    for name in first._fields:
        vals = [getattr(r, name).to(device) for r in results]
        if name in OVERFLOW:
            fields[name] = torch.stack(vals).sum(dtype=torch.int32)
        else:
            fields[name] = torch.cat(vals)
    return type(first)(**fields)


def join_slices(stacked: dict, groups: dict, device: torch.device):
    """{device: its slices' MapResult stacked [K, ...]} (K = len(groups[d]))
    -> one MapResult on `device`, the slices in slot order, the overflow
    counters summed.  One device holding every slot in order: views of
    its [K, B / K] fields as [B], no copy."""
    if len(groups) == 1:
        (res,) = stacked.values()
        return type(res)(*(
            t.sum(dtype=torch.int32) if f in OVERFLOW else t.flatten(0, 1)
            for f, t in zip(res._fields, res)))
    per_slot = {i: type(res)(*(t[k] for t in res))
                for dev, res in stacked.items()
                for k, i in enumerate(groups[dev])}
    return concat_results([per_slot[i] for i in sorted(per_slot)], device)
