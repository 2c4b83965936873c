"""CSR k-mer index built on the device.

Port of ``nextgenmap_tpu/index/device_build.py::build_index_device`` for the
main path: canonical k-mers, no bisulfite collapse.  The two passes of the
reference's CompactPrefixTable build become a bincount, a cumsum and a
stable sort.

Over-frequent rows stay in the table; candidate search drops them at lookup
time (its max_freq).  Invalid windows (N/pad) go to the overflow bucket 4^k
that no lookup touches.  The stable sort keeps every row ascending in
genome position (DESIGN.md rule 2).
"""

from __future__ import annotations

import torch


def build_index_device(genome: torch.Tensor, *, k: int, skip: int,
                       collapse: str = "none", canonical: bool = True):
    """Returns (offsets int32 [4^k + 2], positions int32 [Q]).

    Keys each window by min(kmer, revcomp(kmer)) and stores
    (position << 1) | flip, where flip = the revcomp form was smaller.
    Requires position < 2^30 so the entries fit int32.
    """
    if collapse != "none" or not canonical:
        raise NotImplementedError(
            "only the canonical, uncollapsed index is ported; bisulfite "
            "(collapsed) tables wait for ROADMAP A11"
        )
    G = genome.shape[0]
    if G >= 2**30:
        raise NotImplementedError(
            "genomes of 2^30 bases or more need index sharding (ROADMAP A13)"
        )
    nb = 4**k
    Q = (G - k) // skip + 1
    c = genome.to(torch.int32)
    vals = torch.zeros(Q, dtype=torch.int32, device=c.device)
    rvals = torch.zeros_like(vals)
    ok = torch.ones(Q, dtype=torch.bool, device=c.device)
    for j in range(k):
        w = c[j:j + (Q - 1) * skip + 1:skip]
        vals = (vals << 2) | (w & 3)
        rvals = rvals | ((3 - (w & 3)) << (2 * j))
        ok &= w < 4
    pos = torch.arange(Q, dtype=torch.int32, device=c.device) * skip
    flip = (rvals < vals).to(torch.int32)
    vals = torch.minimum(vals, rvals)
    pos = (pos << 1) | flip
    vals = torch.where(ok, vals, nb)  # invalid windows -> overflow bucket

    counts = torch.bincount(vals, minlength=nb + 1)
    offsets = torch.zeros(nb + 2, dtype=torch.int32, device=c.device)
    offsets[1:] = torch.cumsum(counts, dim=0).to(torch.int32)
    # stable: rows stay ascending in position ((pos << 1 | flip) order is
    # position order)
    order = torch.sort(vals, stable=True).indices
    return offsets, pos[order]
