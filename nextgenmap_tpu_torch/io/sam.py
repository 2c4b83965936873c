"""SAM output.

Port of ``nextgenmap_tpu/io/sam.py`` (SamWriter, cigar_string, md_and_nm,
open_output) and of the reference runner's ``aligned_rows``, taking its op
codes from the port's ``ops/sw_ref.py``.  Records are byte-identical to the
reference's apart from the ``@PG`` line, which names the port.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import IO

import numpy as np

from nextgenmap_tpu_torch import __version__
from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.index.genome import Genome
from nextgenmap_tpu_torch.io.encode import decode_seq
from nextgenmap_tpu_torch.ops.sw_ref import OP_D, OP_I, OP_M

PROGRAM = "ngm-torch"

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST = 0x40
FLAG_SECOND = 0x80
FLAG_SECONDARY = 0x100

_OP_SYM = {OP_M: "M", OP_I: "I", OP_D: "D"}


def cigar_string(ops_end_to_start, n_ops: int, q_start: int, q_end: int,
                 read_len: int, hard_clip: bool = False,
                 silent_clip: bool = False) -> str:
    """Run-length encode the op buffer (END->START order) into a CIGAR with
    clips: soft (S) by default, H with --hard-clip, none with
    --silent-clip."""
    if n_ops == 0:
        return "*"
    ops = ops_end_to_start[:n_ops][::-1]
    clip = "H" if hard_clip else "S"
    parts: list[str] = []
    if q_start > 0 and not silent_clip:
        parts.append(f"{q_start}{clip}")
    i = 0
    while i < n_ops:
        j = i
        while j < n_ops and ops[j] == ops[i]:
            j += 1
        parts.append(f"{j - i}{_OP_SYM[int(ops[i])]}")
        i = j
    tail = read_len - 1 - q_end
    if tail > 0 and not silent_clip:
        parts.append(f"{tail}{clip}")
    return "".join(parts)


def md_and_nm(ops_end_to_start, n_ops: int, query: np.ndarray, q_start: int,
              ref: np.ndarray, r_start: int) -> tuple[str, int]:
    """MD tag and NM from the op walk (query and ref are code arrays; ref
    starts at the alignment's first aligned base)."""
    ops = ops_end_to_start[:n_ops][::-1]
    qi, ri = q_start, 0
    md: list[str] = []
    run = nm = i = 0
    n = len(ops)
    while i < n:
        op = int(ops[i])
        if op == OP_M:
            if qi < len(query) and ri < len(ref) and query[qi] == ref[ri]:
                run += 1
            else:
                md.append(str(run))
                md.append(decode_seq(ref[ri:ri + 1]))
                run = 0
                nm += 1
            qi += 1
            ri += 1
            i += 1
        elif op == OP_I:
            j = i
            while j < n and int(ops[j]) == OP_I:
                j += 1
            nm += j - i
            qi += j - i
            i = j
        else:  # OP_D
            j = i
            while j < n and int(ops[j]) == OP_D:
                j += 1
            md.append(str(run))
            md.append("^" + decode_seq(ref[ri:ri + (j - i)]))
            run = 0
            nm += j - i
            ri += j - i
            i = j
    md.append(str(run))
    return "".join(md), nm


@dataclass
class SamWriter:
    genome: Genome
    cfg: NgmConfig
    out: IO[str]
    cmdline: str = ""

    def write_header(self) -> None:
        w = self.out.write
        w("@HD\tVN:1.6\tSO:unsorted\n")
        for name, length in zip(self.genome.names, self.genome.lengths):
            w(f"@SQ\tSN:{name}\tLN:{int(length)}\n")
        if self.cfg.rg_id:
            tags = [f"ID:{self.cfg.rg_id}"]
            for key, val in (
                ("SM", self.cfg.rg_sm), ("LB", self.cfg.rg_lb),
                ("PL", self.cfg.rg_pl), ("PU", self.cfg.rg_pu),
            ):
                if val:
                    tags.append(f"{key}:{val}")
            w("@RG\t" + "\t".join(tags) + "\n")
        w(
            f"@PG\tID:{PROGRAM}\tPN:{PROGRAM}\tVN:{__version__}"
            + (f"\tCL:{self.cmdline}" if self.cmdline else "")
            + "\n"
        )

    def tags_suffix(self) -> str:
        return f"\tRG:Z:{self.cfg.rg_id}" if self.cfg.rg_id else ""

    def clip_mode(self) -> int:
        """The native formatter's clip mode: 0 soft, 1 hard, 2 silent."""
        return 1 if self.cfg.hard_clip else (2 if self.cfg.silent_clip else 0)

    def write_unmapped(self, name: str, codes: np.ndarray,
                       qual: bytes | None, flag_extra: int = 0) -> None:
        if self.cfg.no_unal:
            return
        seq = decode_seq(codes)
        q = qual.decode("ascii") if qual else "*"
        self.out.write(
            f"{name}\t{FLAG_UNMAPPED | flag_extra}\t*\t0\t0\t*\t*\t0\t0"
            f"\t{seq}\t{q}{self.tags_suffix()}\n"
        )

    def write_unmapped_at(self, name: str, codes: np.ndarray,
                          qual: bytes | None, flag_extra: int, rname: str,
                          pos1: int) -> None:
        """An unmapped mate placed at its mapped partner's coordinates (the
        SAM convention that keeps a pair collatable)."""
        if self.cfg.no_unal:
            return
        seq = decode_seq(codes)
        q = qual.decode("ascii") if qual else "*"
        self.out.write(
            f"{name}\t{FLAG_UNMAPPED | flag_extra}\t{rname}\t{pos1}\t0\t*"
            f"\t=\t{pos1}\t0\t{seq}\t{q}{self.tags_suffix()}\n"
        )

    def write_mapped(
        self,
        name: str,
        aligned_query: np.ndarray,  # codes in ALIGNED orientation (rc'd if reverse)
        qual: bytes | None,         # original orientation qual
        read_len: int,
        strand: int,
        pos_abs: int,
        mapq: int,
        score: int,
        ops: np.ndarray,
        n_ops: int,
        q_start: int,
        q_end: int,
        identity: float,
        flag_extra: int = 0,
        rnext: str = "*",
        pnext: int = 0,
        tlen: int = 0,
    ) -> None:
        chrom_idx, chrom_pos = self.genome.abs_to_chrom(pos_abs)
        rname = self.genome.names[int(chrom_idx)]
        flag = (FLAG_REVERSE if strand else 0) | flag_extra
        cigar = cigar_string(ops, n_ops, q_start, q_end, read_len,
                             self.cfg.hard_clip, self.cfg.silent_clip)
        ref_len = int(np.sum(ops[:n_ops] != OP_I))  # M + D columns
        ref_slice = self.genome.extract(pos_abs, ref_len)
        md, nm = md_and_nm(ops, n_ops, aligned_query, q_start, ref_slice, 0)
        trim = self.cfg.hard_clip or self.cfg.silent_clip
        seq_codes = aligned_query[q_start:q_end + 1] if trim else aligned_query
        seq = decode_seq(seq_codes)
        if qual is not None:
            qs = qual.decode("ascii")
            if strand:
                qs = qs[::-1]
            if trim:
                qs = qs[q_start:q_end + 1]
        else:
            qs = "*"
        self.out.write(
            f"{name}\t{flag}\t{rname}\t{int(chrom_pos) + 1}\t{mapq}\t{cigar}"
            f"\t{rnext}\t{pnext}\t{tlen}\t{seq}\t{qs}"
            f"\tAS:i:{score}\tNM:i:{nm}\tMD:Z:{md}\tXI:f:{identity:.4f}"
            f"{self.tags_suffix()}\n"
        )


def aligned_rows(codes: np.ndarray, lens: np.ndarray, read_len: int,
                 strand: np.ndarray) -> np.ndarray:
    """[n, L] codes in ALIGNED orientation (reverse-complemented where
    strand == 1, short reverse reads shifted back to column 0)."""
    rc = np.where(codes < 4, 3 - codes.astype(np.int16), codes)[:, ::-1]
    aligned = np.where((strand == 1)[:, None], rc, codes).astype(np.uint8)
    short = np.nonzero((lens < read_len) & (strand == 1))[0]
    if short.size:
        sub = aligned[short]
        Ls = lens[short][:, None]
        j = np.arange(read_len)[None, :]
        src = np.minimum(j + (read_len - Ls), read_len - 1)
        shifted = np.take_along_axis(sub, src, axis=1)
        shifted[j >= Ls] = 4
        aligned[short] = shifted
    return aligned


def open_output(path: str | None) -> IO[str]:
    if path is None or path == "-":
        return sys.stdout
    return open(path, "w", buffering=1 << 20)
