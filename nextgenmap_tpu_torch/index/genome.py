"""Genome provider: load, encode, concatenate, coordinate-map, memoize.

Copy of ``nextgenmap_tpu/index/genome.py``: loads the reference FASTA,
encodes it one uint8 code per base, concatenates chromosomes with padding
gaps into one flat coordinate space, provides abs-pos <-> (chrom, offset)
conversion, and memoizes the encoded form next to the FASTA in the same
``.ngmt-enc.v1.npz`` file as ``ngm-tpu`` (the two packages share it).  The
host-side ``extract`` serves SAM emission (MD tags).
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass

import numpy as np

from nextgenmap_tpu_torch.io.encode import PAD
from nextgenmap_tpu_torch.io.fasta import iter_fasta
from nextgenmap_tpu_torch.utils.logging import get_logger

log = get_logger("ngm-torch.genome")

ENC_VERSION = 1
# Gap of PAD codes between concatenated chromosomes so no alignment can
# bridge two chromosomes (reference pads similarly). Must exceed the longest
# read + corridor the pipeline will ever score.
CHROM_GAP = 2048


@dataclass
class Genome:
    codes: np.ndarray       # uint8 [G_total] concatenated, PAD in gaps
    names: list[str]        # chromosome names
    starts: np.ndarray      # int64 [n_chroms] absolute start of each chromosome
    lengths: np.ndarray     # int64 [n_chroms]

    @property
    def size(self) -> int:
        return int(self.codes.shape[0])

    @property
    def n_chroms(self) -> int:
        return len(self.names)

    def sha1(self) -> str:
        return hashlib.sha1(self.codes.tobytes()).hexdigest()[:16]

    # -- coordinate mapping --
    def abs_to_chrom(self, pos: int | np.ndarray):
        """Absolute position(s) -> (chrom_index, offset_in_chrom)."""
        idx = np.searchsorted(self.starts, pos, side="right") - 1
        idx = np.clip(idx, 0, self.n_chroms - 1)
        return idx, pos - self.starts[idx]

    def extract(self, start: int, length: int) -> np.ndarray:
        """Host-side corridor slice, PAD beyond genome bounds."""
        out = np.full(length, PAD, dtype=np.uint8)
        lo = max(0, start)
        hi = min(self.size, start + length)
        if hi > lo:
            out[lo - start : hi - start] = self.codes[lo:hi]
        return out

    # ---------------------------------------------------------------
    @classmethod
    def from_fasta(cls, path: str) -> "Genome":
        names: list[str] = []
        starts: list[int] = []
        lengths: list[int] = []
        parts: list[np.ndarray] = []
        pos = 0
        gap = np.full(CHROM_GAP, PAD, dtype=np.uint8)
        for name, codes in iter_fasta(path):
            if parts:
                parts.append(gap)
                pos += CHROM_GAP
            names.append(name)
            starts.append(pos)
            lengths.append(len(codes))
            parts.append(codes)
            pos += len(codes)
        if not names:
            raise ValueError(f"no sequences in {path}")
        g = cls(
            codes=np.concatenate(parts),
            names=names,
            starts=np.asarray(starts, dtype=np.int64),
            lengths=np.asarray(lengths, dtype=np.int64),
        )
        log.info("loaded %d sequence(s), %d bp total", g.n_chroms, g.size)
        return g

    # -- memoization --
    @staticmethod
    def cache_path(fasta_path: str) -> str:
        return f"{fasta_path}.ngmt-enc.v{ENC_VERSION}.npz"

    def save(self, path: str) -> None:
        meta = {"version": ENC_VERSION, "names": self.names, "sha1": self.sha1()}
        np.savez(
            path,
            codes=self.codes,
            starts=self.starts,
            lengths=self.lengths,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        )

    @classmethod
    def load(cls, path: str) -> "Genome":
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta["version"] != ENC_VERSION:
                raise ValueError("encoded-genome version mismatch")
            return cls(
                codes=z["codes"],
                names=meta["names"],
                starts=z["starts"],
                lengths=z["lengths"],
            )

    @classmethod
    def open(cls, fasta_path: str, skip_save: bool = False) -> "Genome":
        """Load memoized encoding if present, else encode and memoize."""
        cache = cls.cache_path(fasta_path)
        if os.path.exists(cache):
            log.info("loading encoded genome from %s", cache)
            return cls.load(cache)
        g = cls.from_fasta(fasta_path)
        if not skip_save:
            try:
                g.save(cache)
            except OSError as e:  # read-only dir: fall through, just don't memoize
                log.warning("could not memoize encoded genome: %s", e)
        return g
