"""Seeded synthetic workloads: genomes with planted repeats, simulated reads.

A random genome gives every read exactly one candidate, so the score pass
(and its kernel) would only ever see empty slots.  ``repeat_genome`` copies
segments of the genome elsewhere, half of them exact and half mutated at
~1%, so reads from those regions have two or more candidates and reach the
banded SW score.  Read names follow the repo's truth convention
``<prefix>_<i>_<pos>_<strand>`` (0-based forward position, strand 0/1).
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)


def repeat_genome(size: int, *, n_repeats: int, min_len: int, max_len: int,
                  mutation_rate: float = 0.01, seed: int = 0) -> np.ndarray:
    """[size] uint8 codes 0..3; odd-numbered copies carry SNPs at
    `mutation_rate`, even-numbered ones are exact."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size, dtype=np.int64).astype(np.uint8)
    for r in range(n_repeats):
        n = int(rng.integers(min_len, max_len + 1))
        src, dst = rng.integers(0, size - n, 2)
        seg = g[src:src + n].copy()
        if r % 2:
            hit = rng.random(n) < mutation_rate
            seg[hit] = (seg[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        g[dst:dst + n] = seg
    return g


def simulate_reads(genome: np.ndarray, n: int, read_len: int,
                   snp_rate: float, seed: int = 0):
    """SNP-only reads from ACGT windows of `genome`, half reverse-complemented.

    Returns (codes [n, read_len] uint8, pos [n] int64, strand [n] int8).
    """
    rng = np.random.default_rng(seed)
    G = genome.shape[0]
    pos = rng.integers(0, G - read_len, n)
    cols = np.arange(read_len)[None, :]
    win = genome[pos[:, None] + cols].astype(np.int64)
    bad = (win >= 4).any(axis=1)
    while bad.any():
        pos[bad] = rng.integers(0, G - read_len, int(bad.sum()))
        win[bad] = genome[pos[bad][:, None] + cols]
        bad = (win >= 4).any(axis=1)
    snp = rng.random(win.shape) < snp_rate
    win = np.where(snp, (win + rng.integers(1, 4, win.shape)) % 4, win)
    strand = rng.integers(0, 2, n).astype(np.int8)
    rc = (3 - win)[:, ::-1]
    codes = np.where(strand[:, None] == 1, rc, win).astype(np.uint8)
    return codes, pos, strand


def write_fasta(path: str, name: str, codes: np.ndarray, width: int = 70) -> None:
    seq = _BASES[codes].tobytes()
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        for i in range(0, len(seq), width):
            f.write(seq[i:i + width] + b"\n")


def write_fastq(path: str, codes: np.ndarray, pos: np.ndarray,
                strand: np.ndarray, prefix: str = "simread") -> None:
    qual = b"I" * codes.shape[1]
    with open(path, "wb") as f:
        for i, row in enumerate(codes):
            f.write(f"@{prefix}_{i}_{pos[i]}_{strand[i]}\n".encode()
                    + _BASES[row].tobytes() + b"\n+\n" + qual + b"\n")


def truth_correct(sam_path: str, tol: int = 5) -> tuple[int, int, int]:
    """(records, mapped, truth-correct) of a single-chromosome SAM whose read
    names carry the truth: POS within `tol` bp and the strand right."""
    n = mapped = correct = 0
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fields = line.split("\t", 4)
            n += 1
            flag = int(fields[1])
            if flag & 4:
                continue
            mapped += 1
            _, _, p, s = fields[0].rsplit("_", 3)
            if ((flag >> 4) & 1) == int(s) and abs(int(fields[3]) - 1 - int(p)) <= tol:
                correct += 1
    return n, mapped, correct
