"""Read simulation with known truth (wgsim-style).

Copy of ``nextgenmap_tpu/io/simulate.py``: the seeded genomes and reads of
the port's bench (``bench.py``) and graft entry (``graft_entry.py``), single
and paired reads with SNPs and 1 bp indels, and their FASTQ.  The same seed
gives the same bytes as the original (tests/test_torch_host_copies.py).
Read names carry the truth: ``<prefix>_<i>_<pos>_<strand>``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from nextgenmap_tpu_torch.io.encode import decode_seq, revcomp_codes


@dataclass
class SimRead:
    name: str
    codes: np.ndarray   # uint8 [len] as sequenced (already reverse-complemented if strand==1)
    chrom: int
    pos: int            # 0-based position of the read's leftmost base on the forward strand
    strand: int         # 0 fwd, 1 rev
    n_snps: int
    n_indels: int


def random_genome(length: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=length, dtype=np.int64).astype(np.uint8)


def mutate(codes: np.ndarray, rng, snp_rate: float, indel_rate: float):
    """Apply SNPs and 1bp indels; returns (mutated, n_snps, n_indels)."""
    out: list[int] = []
    n_snps = n_indels = 0
    for c in codes:
        r = rng.random()
        if r < indel_rate / 2:        # deletion: skip this base
            n_indels += 1
            continue
        if r < indel_rate:            # insertion: random base before this one
            out.append(int(rng.integers(0, 4)))
            n_indels += 1
        if rng.random() < snp_rate and c < 4:
            c = (int(c) + 1 + int(rng.integers(0, 3))) % 4
            n_snps += 1
        out.append(int(c))
    return np.asarray(out, dtype=np.uint8), n_snps, n_indels


def simulate_reads(
    genome_codes: np.ndarray,
    n_reads: int,
    read_len: int = 100,
    snp_rate: float = 0.01,
    indel_rate: float = 0.001,
    seed: int = 0,
    prefix: str = "simread",
) -> list[SimRead]:
    rng = np.random.default_rng(seed)
    G = genome_codes.shape[0]
    reads: list[SimRead] = []
    attempts = 0
    while len(reads) < n_reads and attempts < n_reads * 20:
        attempts += 1
        # sample until the window is all-ACGT (avoids chrom gaps / N runs)
        pos = int(rng.integers(0, G - read_len - 8))
        frag = genome_codes[pos : pos + read_len + 8]  # slack for deletions
        if frag.max() >= 4:
            continue
        mut, n_snps, n_indels = mutate(frag, rng, snp_rate, indel_rate)
        if mut.shape[0] < read_len:
            continue
        mut = mut[:read_len]
        strand = int(rng.integers(0, 2))
        if strand:
            mut = revcomp_codes(mut)
        i = len(reads)
        reads.append(SimRead(f"{prefix}_{i}_{pos}_{strand}", mut, 0, pos, strand, n_snps, n_indels))
    return reads


def simulate_pairs(
    genome_codes: np.ndarray,
    n_pairs: int,
    read_len: int = 100,
    insert_mean: int = 350,
    insert_sd: int = 40,
    snp_rate: float = 0.01,
    indel_rate: float = 0.001,
    seed: int = 0,
    prefix: str = "simpair",
) -> list[tuple[SimRead, SimRead]]:
    """FR-orientation pairs: mate1 forward at p, mate2 reverse at p+insert-len."""
    rng = np.random.default_rng(seed)
    G = genome_codes.shape[0]
    pairs: list[tuple[SimRead, SimRead]] = []
    attempts = 0
    while len(pairs) < n_pairs and attempts < n_pairs * 20:
        attempts += 1
        insert = max(read_len + 10, int(rng.normal(insert_mean, insert_sd)))
        pos = int(rng.integers(0, max(1, G - insert - 8)))
        frag = genome_codes[pos : pos + insert]
        if frag.shape[0] < insert or frag.max() >= 4:
            continue
        m1, s1, i1 = mutate(frag[: read_len + 8], rng, snp_rate, indel_rate)
        m2, s2, i2 = mutate(frag[-(read_len + 8):], rng, snp_rate, indel_rate)
        if m1.shape[0] < read_len or m2.shape[0] < read_len:
            continue
        m1 = m1[:read_len]
        m2 = revcomp_codes(m2[-read_len:])
        pos2 = pos + insert - read_len
        i = len(pairs)
        # randomly swap which mate is "first" like real libraries do not — keep
        # deterministic FR: mate1 fwd, mate2 rev.
        pairs.append((
            SimRead(f"{prefix}_{i}", m1, 0, pos, 0, s1, i1),
            SimRead(f"{prefix}_{i}", m2, 0, pos2, 1, s2, i2),
        ))
    return pairs


def simulate_reads_fast(
    genome_codes: np.ndarray,
    n_reads: int,
    read_len: int = 100,
    snp_rate: float = 0.01,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized SNP-only simulator for benchmark-scale read counts.

    Returns (codes [N, L] uint8, truth_pos [N] int64, truth_strand [N] int8).
    Windows containing N/pad are re-drawn once and then masked out.
    """
    rng = np.random.default_rng(seed)
    G = genome_codes.shape[0]
    pos = rng.integers(0, G - read_len, size=n_reads)
    win = genome_codes[pos[:, None] + np.arange(read_len)[None, :]].astype(np.int64)
    bad = (win >= 4).any(axis=1)
    if bad.any():
        pos2 = rng.integers(0, G - read_len, size=int(bad.sum()))
        pos[bad] = pos2
        win[bad] = genome_codes[pos2[:, None] + np.arange(read_len)[None, :]]
        bad = (win >= 4).any(axis=1)
        if bad.any():  # give up on stragglers: make them all-A reads at pos 0
            pos[bad] = 0
            win[bad] = genome_codes[np.arange(read_len)][None, :]
    snp = rng.random((n_reads, read_len)) < snp_rate
    shift = rng.integers(1, 4, size=(n_reads, read_len))
    win = np.where(snp & (win < 4), (win + shift) % 4, win)
    strand = rng.integers(0, 2, size=n_reads).astype(np.int8)
    rc = np.where(win < 4, 3 - win, win)[:, ::-1]
    codes = np.where(strand[:, None] == 1, rc, win).astype(np.uint8)
    return codes, pos.astype(np.int64), strand


def write_fastq(path: str, reads: list[SimRead]) -> None:
    with open(path, "w") as f:
        for r in reads:
            f.write(f"@{r.name}\n{decode_seq(r.codes)}\n+\n{'I' * len(r.codes)}\n")
