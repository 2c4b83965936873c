"""CSR k-mer index built on the device.

Port of ``nextgenmap_tpu/index/device_build.py::build_index_device``: the
canonical index of the main path, the plain two-strand one, and the
bisulfite (CT- or GA-collapsed) tables.  The two passes of the reference's
CompactPrefixTable build become a bincount, a cumsum and a stable sort.

Over-frequent rows stay in the table; candidate search drops them at lookup
time (its max_freq).  Invalid windows (N/pad) go to the overflow bucket 4^k
that no lookup touches.  The stable sort keeps every row ascending in
genome position (DESIGN.md rule 2).
"""

from __future__ import annotations

import torch

from nextgenmap_tpu_torch.ops.kmer import collapse_codes


def build_index_device(genome: torch.Tensor, *, k: int, skip: int,
                       collapse: str = "none", canonical: bool = True):
    """Returns (offsets int32 [4^k + 2], positions int32 [Q]).

    canonical=True keys each window by min(kmer, revcomp(kmer)) and stores
    (position << 1) | flip, where flip = the revcomp form was smaller.
    canonical=False keys each window by its forward k-mer, after the
    bisulfite `collapse` ("none", "ct" or "ga"), and stores the position.
    Requires position < 2^30; canonical excludes a collapse (the CT/GA
    collapses are strand-asymmetric).
    """
    if canonical and collapse != "none":
        raise ValueError("a canonical index excludes a bisulfite collapse")
    G = genome.shape[0]
    if G >= 2**30:
        raise NotImplementedError(
            "a genome of 2^30 bases or more maps with --index-shards N (a "
            "host index split into N shards), not with a device-built index"
        )
    nb = 4**k
    Q = (G - k) // skip + 1
    c = collapse_codes(genome.to(torch.int32), collapse)
    vals = torch.zeros(Q, dtype=torch.int32, device=c.device)
    rvals = torch.zeros_like(vals)
    ok = torch.ones(Q, dtype=torch.bool, device=c.device)
    for j in range(k):
        w = c[j:j + (Q - 1) * skip + 1:skip]
        vals = (vals << 2) | (w & 3)
        if canonical:
            rvals = rvals | ((3 - (w & 3)) << (2 * j))
        ok &= w < 4
    pos = torch.arange(Q, dtype=torch.int32, device=c.device) * skip
    if canonical:
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


def concat_tables(off_ct: torch.Tensor, pos_ct: torch.Tensor,
                  off_ga: torch.Tensor, pos_ga: torch.Tensor):
    """The bisulfite index as one (offsets, positions) pair: the CT table,
    then the GA table with its offsets shifted past the CT positions, as
    the reference's Mapper lays them out.  The forward pass looks up the
    first half of the offsets, the reverse-complement pass the second."""
    offsets = torch.cat([off_ct, off_ga + pos_ct.shape[0]]).to(torch.int32)
    return offsets, torch.cat([pos_ct, pos_ga]).to(torch.int32)
