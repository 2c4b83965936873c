"""Seeded synthetic workloads: genomes with planted repeats, simulated reads.

A random genome gives every read exactly one candidate, so the score pass
(and its kernel) would only ever see empty slots.  ``repeat_genome`` copies
segments of the genome elsewhere, half of them exact and half mutated at
~1%, so reads from those regions have two or more candidates and reach the
banded SW score; ``repeat_genome_large`` does the same at gigabase
sizes.  Reads: SNP-only short reads, FR pairs, bisulfite-converted reads
(original top and bottom strands) and long reads with SNPs and 1 bp
indels.  Read names follow the repo's truth convention
``<prefix>_<i>_<pos>_<strand>`` (0-based forward position, strand 0/1); the
two mates of a pair carry their own truth each.
"""

from __future__ import annotations

import re

import numpy as np

from nextgenmap_tpu_torch.io.encode import CODE_C, CODE_T

_BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _plant_repeats(g: np.ndarray, rng, n_repeats: int, min_len: int,
                   max_len: int, mutation_rate: float) -> np.ndarray:
    """Copy n_repeats random segments of g elsewhere in g, in place; odd-
    numbered copies carry SNPs at `mutation_rate`, even-numbered ones are
    exact."""
    size = g.shape[0]
    for r in range(n_repeats):
        n = int(rng.integers(min_len, max_len + 1))
        src, dst = rng.integers(0, size - n, 2)
        seg = g[src:src + n].copy()
        if r % 2:
            hit = rng.random(n) < mutation_rate
            seg[hit] = (seg[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        g[dst:dst + n] = seg
    return g


def repeat_genome(size: int, *, n_repeats: int, min_len: int, max_len: int,
                  mutation_rate: float = 0.01, seed: int = 0) -> np.ndarray:
    """[size] uint8 codes 0..3 with planted repeats (_plant_repeats)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size, dtype=np.int64).astype(np.uint8)
    return _plant_repeats(g, rng, n_repeats, min_len, max_len, mutation_rate)


def repeat_genome_large(size: int, *, n_repeats: int, min_len: int,
                        max_len: int, mutation_rate: float = 0.01,
                        seed: int = 0) -> np.ndarray:
    """repeat_genome's kind of genome for gigabase sizes: the bases are
    drawn as uint8 in chunks of 2^26, so no int64 temporary of the whole
    genome exists (8 bytes a base).  Other bytes than repeat_genome's for
    the same seed."""
    rng = np.random.default_rng(seed)
    g = np.empty(size, np.uint8)
    chunk = 1 << 26
    for i in range(0, size, chunk):
        g[i:i + chunk] = rng.integers(0, 4, min(chunk, size - i),
                                      dtype=np.uint8)
    return _plant_repeats(g, rng, n_repeats, min_len, max_len, mutation_rate)


def _acgt_windows(genome: np.ndarray, n: int, width: int, rng):
    """n random windows of `width` bases holding no N: (pos, windows)."""
    G = genome.shape[0]
    pos = rng.integers(0, G - width, n)
    cols = np.arange(width)[None, :]
    win = genome[pos[:, None] + cols].astype(np.int64)
    bad = (win >= 4).any(axis=1)
    while bad.any():
        pos[bad] = rng.integers(0, G - width, int(bad.sum()))
        win[bad] = genome[pos[bad][:, None] + cols]
        bad = (win >= 4).any(axis=1)
    return pos, win


def simulate_reads(genome: np.ndarray, n: int, read_len: int,
                   snp_rate: float, seed: int = 0):
    """SNP-only reads from ACGT windows of `genome`, half reverse-complemented.

    Returns (codes [n, read_len] uint8, pos [n] int64, strand [n] int8).
    """
    rng = np.random.default_rng(seed)
    pos, win = _acgt_windows(genome, n, read_len, rng)
    snp = rng.random(win.shape) < snp_rate
    win = np.where(snp, (win + rng.integers(1, 4, win.shape)) % 4, win)
    strand = rng.integers(0, 2, n).astype(np.int8)
    rc = (3 - win)[:, ::-1]
    codes = np.where(strand[:, None] == 1, rc, win).astype(np.uint8)
    return codes, pos, strand


def simulate_pairs(genome: np.ndarray, n_pairs: int, read_len: int,
                   snp_rate: float, *, insert_mean: int = 350,
                   insert_sd: int = 40, seed: int = 0):
    """FR pairs with SNPs: for each fragment of ~N(insert_mean, insert_sd)
    bp, the left read forward and the right read reverse-complemented; which
    of the two is mate 1 is drawn per pair, as in a real library.

    Returns (codes [2n, read_len] uint8, pos [2n] int64, strand [2n] int8)
    with the mates of pair i in rows 2i (mate 1) and 2i+1 (mate 2); pos is
    each mate's own 0-based forward position.
    """
    rng = np.random.default_rng(seed)
    G = genome.shape[0]
    ins = np.rint(rng.normal(insert_mean, insert_sd, n_pairs)).astype(np.int64)
    ins = np.maximum(ins, read_len + 10)
    cols = np.arange(read_len)[None, :]
    left = rng.integers(0, G - ins)
    while True:                     # both reads of a fragment all ACGT
        ends = np.concatenate([left, left + ins - read_len])
        bad = (genome[ends[:, None] + cols] >= 4).any(axis=1)
        bad = bad[:n_pairs] | bad[n_pairs:]
        if not bad.any():
            break
        left[bad] = rng.integers(0, G - ins[bad])
    right = left + ins - read_len
    swap = rng.random(n_pairs) < 0.5              # mate 1 is the right read
    pos = np.where(swap[:, None], np.stack([right, left], 1),
                   np.stack([left, right], 1)).reshape(-1)
    strand = np.where(swap[:, None], [1, 0], [0, 1]).reshape(-1).astype(np.int8)
    win = genome[pos[:, None] + cols].astype(np.int64)
    snp = rng.random(win.shape) < snp_rate
    win = np.where(snp, (win + rng.integers(1, 4, win.shape)) % 4, win)
    rc = (3 - win)[:, ::-1]
    codes = np.where(strand[:, None] == 1, rc, win).astype(np.uint8)
    return codes, pos, strand


def bisulfite_convert(codes: np.ndarray, rate: float, rng) -> np.ndarray:
    """Each C of the reads read as T with probability `rate`."""
    conv = (codes == CODE_C) & (rng.random(codes.shape) < rate)
    return np.where(conv, CODE_T, codes).astype(np.uint8)


def simulate_bisulfite_reads(genome: np.ndarray, n: int, read_len: int,
                             rate: float = 0.8, seed: int = 0):
    """Bisulfite reads of a directional library: even reads come from the
    original top strand (the locus, strand 0), odd ones from the original
    bottom strand (its reverse complement, strand 1), and each C of the
    read is read as T with probability `rate`.

    Returns (codes [n, read_len] uint8, pos [n] int64, strand [n] int8).
    """
    rng = np.random.default_rng(seed)
    pos, win = _acgt_windows(genome, n, read_len, rng)
    strand = (np.arange(n) % 2).astype(np.int8)
    seq = np.where(strand[:, None] == 1, (3 - win)[:, ::-1], win)
    return bisulfite_convert(seq, rate, rng), pos, strand


def simulate_long_reads(genome: np.ndarray, n: int, read_len: int,
                        snp_rate: float, indel_rate: float, seed: int = 0):
    """Reads with SNPs and 1 bp indels (each base deleted, or preceded by an
    inserted base, at indel_rate / 2 each), half reverse-complemented.

    Returns (codes [n, read_len] uint8, pos [n] int64, strand [n] int8);
    pos is the window's first base, which a leading deletion shifts by one.
    """
    rng = np.random.default_rng(seed)
    slack = 8 + int(4 * indel_rate * read_len)   # room for the deletions
    pos, win = _acgt_windows(genome, n, read_len + slack, rng)
    strand = rng.integers(0, 2, n).astype(np.int8)
    codes = np.empty((n, read_len), np.uint8)
    for i in range(n):
        w = win[i]
        snp = rng.random(w.shape[0]) < snp_rate
        w = np.where(snp, (w + rng.integers(1, 4, w.shape[0])) % 4, w)
        r = rng.random(w.shape[0])
        dele = r < indel_rate / 2
        ins = ~dele & (r < indel_rate)
        kept = np.cumsum(~dele) - 1            # index of each base once kept
        seq = np.insert(w[~dele], kept[ins], rng.integers(0, 4, int(ins.sum())))
        seq = seq[:read_len]
        codes[i] = (3 - seq)[::-1] if strand[i] else seq
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


def sam_counts(sam_path: str, tol: int = 5, require: int = 0) -> dict:
    """Counts over the records of a single-chromosome SAM whose read names
    carry the truth, of the records whose FLAG has every bit of `require`
    (0x40: mate 1 only).  A primary record is truth-correct when it is
    mapped, its POS lies within `tol` bp of the truth and its strand is right.

    Keys: records, primary, secondary, mapped and correct (of the primary
    records), proper (primary records flagged 0x2), and names_multi_primary
    (read names with more than one primary record).
    """
    c = dict(records=0, primary=0, secondary=0, mapped=0, correct=0,
             proper=0, names_multi_primary=0)
    seen: set[str] = set()
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fields = line.split("\t", 4)
            flag = int(fields[1])
            if flag & require != require:
                continue
            c["records"] += 1
            if flag & 0x100:
                c["secondary"] += 1
                continue
            c["primary"] += 1
            if fields[0] in seen:
                c["names_multi_primary"] += 1
            seen.add(fields[0])
            c["proper"] += bool(flag & 0x2)
            if flag & 4:
                continue
            c["mapped"] += 1
            _, _, p, s = fields[0].rsplit("_", 3)
            if ((flag >> 4) & 1) == int(s) and abs(int(fields[3]) - 1 - int(p)) <= tol:
                c["correct"] += 1
    return c


def truth_correct(sam_path: str, tol: int = 5) -> tuple[int, int, int]:
    """(primary records, mapped, truth-correct) of sam_counts."""
    c = sam_counts(sam_path, tol)
    return c["primary"], c["mapped"], c["correct"]


_CIGAR_OP = re.compile(r"(\d+)([MIDSH])")


def alignment_counts(sam_path: str, genome: np.ndarray, tol: int = 5) -> dict:
    """What the CIGARs of a single-chromosome SAM (chromosome at genome
    offset 0, read names carrying the truth) say about its primary records.

    Keys: records, mapped, correct (mapped, strand right and POS within
    `tol` bp of the truth), clipped (mapped records with an S or H op),
    seq_mismatch (CIGARs whose query length differs from SEQ's) and
    nm_mismatch (NM:i differing from the edits the CIGAR and the genome
    show: mismatched M columns plus inserted and deleted bases).
    """
    c = dict(records=0, mapped=0, correct=0, clipped=0, seq_mismatch=0,
             nm_mismatch=0)
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            flag = int(fields[1])
            if flag & 0x100:
                continue
            c["records"] += 1
            if flag & 4:
                continue
            c["mapped"] += 1
            _, _, p, s = fields[0].rsplit("_", 3)
            p0 = int(fields[3]) - 1
            if ((flag >> 4) & 1) == int(s) and abs(p0 - int(p)) <= tol:
                c["correct"] += 1
            seq = np.frombuffer(fields[9].encode(), np.uint8)
            qi = ri = edits = 0
            clipped = False
            for num, op in _CIGAR_OP.findall(fields[5]):
                k = int(num)
                if op == "M":
                    ref = _BASES[genome[p0 + ri:p0 + ri + k]]
                    edits += int((seq[qi:qi + k] != ref).sum())
                    qi += k
                    ri += k
                elif op == "I":
                    edits += k
                    qi += k
                elif op == "D":
                    edits += k
                    ri += k
                else:
                    clipped = True
                    qi += k if op == "S" else 0
            c["clipped"] += clipped
            c["seq_mismatch"] += qi != seq.shape[0]
            nm = next(int(t[5:]) for t in fields[11:] if t.startswith("NM:i:"))
            c["nm_mismatch"] += nm != edits
    return c
