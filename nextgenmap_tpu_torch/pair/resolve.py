"""Paired-end SAM emission: FLAGs, RNEXT/PNEXT/TLEN, pair counters.

Port of ``nextgenmap_tpu/pair/resolve.py`` (``_ref_span``,
``_emit_paired_native``, ``emit_paired``), which imports the JAX mapper and
so cannot be reused.  Pair *selection* happens on the device
(``models/mapper.py::map_step_paired``); this module turns the per-mate host
results of one batch into SAM records, with the reference's arithmetic.
"""

from __future__ import annotations

import time

import numpy as np

from nextgenmap_tpu_torch.io.encode import revcomp_codes
from nextgenmap_tpu_torch.io.fastq import ReadBatch
from nextgenmap_tpu_torch.io.sam import (
    FLAG_FIRST, FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED, FLAG_PAIRED,
    FLAG_PROPER, FLAG_REVERSE, FLAG_SECOND, FLAG_UNMAPPED, SamWriter,
    aligned_rows,
)
from nextgenmap_tpu_torch.models.mapper import MapResult
from nextgenmap_tpu_torch.native import hostio as native
from nextgenmap_tpu_torch.ops.sw_ref import OP_I
from nextgenmap_tpu_torch.utils.stats import MappingStats


def _ref_span(ops: np.ndarray, n_ops: int) -> int:
    """Reference bases consumed by the alignment (M + D columns)."""
    return int(np.sum(ops[:n_ops] != OP_I))


def _emit_paired_native(writer: SamWriter, batch: ReadBatch, res: MapResult,
                        stats: MappingStats) -> None:
    """Pair fields for the whole batch in numpy, rendered by ONE native
    format call."""
    t1 = time.perf_counter()
    n = batch.n
    mapped = res.mapped[:n].astype(bool)
    strand = np.where(mapped, res.strand[:n], 0)
    pos = np.where(mapped, res.pos[:n].astype(np.int64), 0)
    mapq = np.where(mapped, res.mapq[:n], 0)
    ops = res.ops[:n]
    n_ops = np.where(mapped, res.n_ops[:n], 0)
    stats.kmer_fanout_overflow += int(res.fanout_overflow)
    stats.cmr_overflow += int(res.cmr_overflow)

    mate = np.arange(n) ^ 1
    stats.reads_in += n
    n_mapped = int(mapped.sum())
    stats.reads_mapped += n_mapped
    stats.reads_unmapped += n - n_mapped

    genome = writer.genome
    ci = np.zeros(n, np.int64)
    cp = np.full(n, -1, np.int64)
    midx = np.nonzero(mapped)[0]
    if midx.size:
        mci, mcp = genome.abs_to_chrom(pos[midx])
        ci[midx] = np.atleast_1d(mci)
        cp[midx] = np.atleast_1d(mcp)
    MO = ops.shape[1]
    span = np.count_nonzero(
        (ops != OP_I) & (np.arange(MO)[None, :] < n_ops[:, None]), axis=1
    )
    m_mapped = mapped[mate]
    m_strand = strand[mate]
    m_ci = ci[mate]
    m_cp = cp[mate]
    m_span = span[mate]
    first = np.arange(n) % 2 == 0

    # exact propriety from the final coordinates (the device's selection
    # geometry is approximate): both mates mapped on one chromosome, FR
    # orientation (strands differ, forward mate leftmost), outer span
    # within [-I, -X]
    both_same = mapped & m_mapped & (ci == m_ci)
    left = np.minimum(cp, m_cp)
    right = np.maximum(cp + span, m_cp + m_span)
    t = right - left
    fwd_pos = np.where(strand == 0, cp, m_cp)
    rev_pos = np.where(strand == 0, m_cp, cp)
    cfg = writer.cfg
    pair_proper = (
        both_same
        & (strand != m_strand)
        & (fwd_pos <= rev_pos)
        & (t >= cfg.min_insert_size)
        & (t <= cfg.max_insert_size)
    )
    stats.pairs_proper += int(pair_proper[0::2].sum())
    stats.pairs_broken += int(((mapped | m_mapped) & ~pair_proper)[0::2].sum())

    flag = (
        FLAG_PAIRED
        + np.where(first, FLAG_FIRST, FLAG_SECOND)
        + np.where(m_mapped & (m_strand == 1), FLAG_MATE_REVERSE, 0)
        + np.where(~m_mapped, FLAG_MATE_UNMAPPED, 0)
        + np.where(~mapped, FLAG_UNMAPPED, 0)
        + np.where(mapped & (strand == 1), FLAG_REVERSE, 0)
        + np.where(pair_proper, FLAG_PROPER, 0)
    ).astype(np.int32)

    names_arr = np.asarray(genome.names + ["*", "="], dtype=object)
    STAR, EQ = len(genome.names), len(genome.names) + 1
    # RNAME/POS: own coordinates; an unmapped mate inherits its partner's
    rname_i = np.where(mapped, ci, np.where(m_mapped, m_ci, STAR))
    chrom_pos = np.where(mapped, cp, np.where(m_mapped, m_cp, -1))
    # RNEXT/PNEXT: '=' on the same chromosome (or inheriting), else the
    # mate's chromosome
    rnext_i = np.where(
        m_mapped & mapped & (m_ci != ci), m_ci, np.where(m_mapped, EQ, STAR)
    )
    pnext = np.where(m_mapped, m_cp + 1, 0)
    tlen = np.where(
        both_same, np.where((cp < m_cp) | ((cp == m_cp) & first), t, -t), 0
    )

    aligned = aligned_rows(batch.codes[:n], batch.lengths[:n], batch.read_len,
                           strand)
    ident = res.matches[:n].astype(np.float32) / np.maximum(1, n_ops)
    if cfg.no_unal and n_mapped < n:
        keep = midx
    else:
        keep = np.arange(n)
    if keep.size == 0:
        return
    sel = lambda a: a[keep]  # noqa: E731
    blob = native.format_sam(
        names=[batch.names[i] for i in keep],
        aligned_codes=sel(aligned),
        read_len=sel(batch.lengths[:n]),
        quals=[batch.quals[i] for i in keep],
        qual_rev=sel(strand.astype(np.uint8)),
        flag=sel(flag),
        chrom_pos=sel(chrom_pos),
        rnames=names_arr[sel(rname_i)].tolist(),
        mapq=sel(mapq),
        score=sel(res.score[:n]),
        ops=sel(ops),
        n_ops=sel(n_ops),
        q_start=sel(res.q_start[:n]),
        q_end=sel(res.q_end[:n]),
        genome_codes=genome.codes,
        gpos_abs=sel(pos),
        rnexts=names_arr[sel(rnext_i)].tolist(),
        pnext=sel(pnext),
        tlen=sel(tlen),
        identity=sel(ident),
        rg_suffix=writer.tags_suffix(),
        clip_mode=writer.clip_mode(),
        is_mapped=sel(mapped.astype(np.uint8)),
    )
    t2 = time.perf_counter()
    stats.add_time("format", t2 - t1)
    writer.out.write(blob.decode("ascii"))
    stats.add_time("write", time.perf_counter() - t2)


def emit_paired(writer: SamWriter, batch: ReadBatch, res: MapResult,
                stats: MappingStats) -> None:
    """Write one paired batch's records (host arrays), mate 1 then mate 2
    of each pair, in input order."""
    if native.lib() is not None:
        return _emit_paired_native(writer, batch, res, stats)
    t0 = time.perf_counter()
    mapped, strand, pos = res.mapped, res.strand, res.pos
    ops, n_ops = res.ops, res.n_ops
    stats.kmer_fanout_overflow += int(res.fanout_overflow)
    stats.cmr_overflow += int(res.cmr_overflow)

    genome = writer.genome
    cfg = writer.cfg
    for p in range(batch.n // 2):
        i, j = 2 * p, 2 * p + 1
        info = {}      # mate -> (chromosome, position on it, reference span)
        for m in (i, j):
            if mapped[m]:
                ci, cp = genome.abs_to_chrom(int(pos[m]))
                info[m] = (int(ci), int(cp), _ref_span(ops[m], int(n_ops[m])))
        # exact propriety from the final coordinates, as the native path
        pair_proper = False
        if mapped[i] and mapped[j] and strand[i] != strand[j]:
            ci_i, cp_i, sp_i = info[i]
            ci_j, cp_j, sp_j = info[j]
            if ci_i == ci_j:
                t = max(cp_i + sp_i, cp_j + sp_j) - min(cp_i, cp_j)
                fwd, rev = (cp_i, cp_j) if strand[i] == 0 else (cp_j, cp_i)
                pair_proper = bool(
                    fwd <= rev
                    and cfg.min_insert_size <= t <= cfg.max_insert_size
                )
        if pair_proper:
            stats.pairs_proper += 1
        elif mapped[i] or mapped[j]:
            stats.pairs_broken += 1
        for m, o, first in ((i, j, True), (j, i, False)):
            stats.reads_in += 1
            L = int(batch.lengths[m])
            flag = FLAG_PAIRED | (FLAG_FIRST if first else FLAG_SECOND)
            if mapped[o]:
                if strand[o]:
                    flag |= FLAG_MATE_REVERSE
            else:
                flag |= FLAG_MATE_UNMAPPED
            if not mapped[m]:
                stats.reads_unmapped += 1
                # an unmapped mate inherits its mapped partner's coordinates
                if mapped[o]:
                    co, cpo, _ = info[o]
                    writer.write_unmapped_at(
                        batch.names[m], batch.codes[m, :L], batch.quals[m],
                        flag, genome.names[co], cpo + 1,
                    )
                else:
                    writer.write_unmapped(batch.names[m], batch.codes[m, :L],
                                          batch.quals[m], flag)
                continue
            stats.reads_mapped += 1
            if pair_proper:
                flag |= FLAG_PROPER
            cm, cpm, span_m = info[m]
            rnext, pnext, tlen = "*", 0, 0
            if mapped[o]:
                co, cpo, span_o = info[o]
                rnext = "=" if co == cm else genome.names[co]
                pnext = cpo + 1
                if co == cm:
                    t = max(cpm + span_m, cpo + span_o) - min(cpm, cpo)
                    # the leftmost mate gets +TLEN; a tie goes to mate 1
                    tlen = t if cpm < cpo or (cpm == cpo and first) else -t
            st = int(strand[m])
            codes = batch.codes[m, :L]
            no = int(n_ops[m])
            writer.write_mapped(
                batch.names[m], revcomp_codes(codes) if st else codes,
                batch.quals[m], L, st, int(pos[m]), int(res.mapq[m]),
                int(res.score[m]), ops[m], no, int(res.q_start[m]),
                int(res.q_end[m]), float(res.matches[m]) / max(1, no),
                flag_extra=flag, rnext=rnext, pnext=pnext, tlen=tlen,
            )
    stats.add_time("format", time.perf_counter() - t0)
