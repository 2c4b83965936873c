"""The yardstick: published peaks and the least time of each kernel's work.

Every count comes from the cell's inputs and outputs (read lengths, the
band W, the candidates the step reported, the index rows the reads' k-mers
hit), never from what a kernel launches, so it reads the same work
whatever implements it.  A least time is the larger of the operations
over the peak integer rate and the bytes over the peak bandwidth; each
input byte is counted read once and each output byte written once.

Peaks are NVIDIA's published figures for one H100 SXM (the card the
benchmark runs on), not the clock a card reports at run time.
"""

from __future__ import annotations

from typing import NamedTuple

SMS = 132
INT32_LANES = 64          # INT32 lanes an SM
BOOST_HZ = 1.98e9         # the published maximum SM clock
PEAK_INT_OPS = SMS * INT32_LANES * BOOST_HZ   # int32 ops/s
PEAK_BYTES = 3.35e12      # HBM3 bytes/s

K1_OPS_PER_CELL = 6       # SW score: a cell's H, E, F and max, local mode
K4_OPS_PER_CELL = 20      # traceback: the score cell plus its direction
                          # byte, local mode


class Work(NamedTuple):
    """The work of one batch, averaged over the batches of a traced
    window."""

    reads: float          # B
    read_len: int         # L
    band: int             # W
    kmers: int            # Q, k-mer windows a read
    cmrs: int             # C, candidates a read returns
    score_slots: float    # real slots the score pass scores (capped)
    score_cells: float    # their query length x W
    aligned: float        # reads with a candidate, which the traceback needs
    align_cells: float    # their query length x W
    valid_kmers: float    # read k-mers looked up in the index
    hits: float           # index entries those lookups read (capped)


def least_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_INT_OPS, nbytes / PEAK_BYTES)


def k1_s(w: Work) -> float:
    """SW score: 6 int ops a real cell; reads its queries and corridors."""
    T = w.read_len + w.band
    return least_s(K1_OPS_PER_CELL * w.score_cells,
                   w.score_slots * (w.read_len + T + 4 * 3))


def k2_s(w: Work) -> float:
    """Corridor gathers: one window of L + W bases read and written for
    each real score slot and each aligned read."""
    T = w.read_len + w.band
    return least_s(0.0, (w.score_slots + w.aligned) * (2 * T + 4))


def k4_s(w: Work) -> float:
    """Traceback: 20 int ops a real cell; reads query and corridor, writes
    the ops (L + W bytes) and nine int32 fields."""
    T = w.read_len + w.band
    return least_s(K4_OPS_PER_CELL * w.align_cells,
                   w.aligned * (w.read_len + T + T + 9 * 4))


def k5_s(w: Work) -> float:
    """Read front: reads the reads, writes their reverse complements and
    the canonical k-mers (value, flip, ok: 9 bytes a window)."""
    return least_s(0.0, w.reads * (2 * w.read_len + 9 * w.kmers))


def k6_s(w: Work) -> float:
    """Candidate search: reads the k-mers (9 bytes a window) and lengths,
    two CSR offsets a valid k-mer, one 4-byte entry a hit; writes bucket,
    score and strand of C candidates and two int32 a read."""
    return least_s(0.0, (w.reads * (9 * w.kmers + 4) + 8 * w.valid_kmers
                         + 4 * w.hits + w.reads * (12 * w.cmrs + 8)))


def step_s(w: Work) -> float:
    """The step's least time: the sum of its kernels' least times."""
    return k1_s(w) + k2_s(w) + k4_s(w) + k5_s(w) + k6_s(w)
