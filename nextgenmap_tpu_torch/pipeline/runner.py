"""Mapping run: reads -> device step -> SAM, in input order.

Port of ``nextgenmap_tpu/pipeline/runner.py`` on one device
(``run_mapping`` with its single-end, top-n and paired branches and its
long-read batch size, ``load_reference`` with its bisulfite and
index-shard branches, ``emit_single``, ``emit_single_topn``).  The loop is
serial: parse a batch, map it on the device, fetch its result to the host,
format and write its records.  Records are formatted by the port's native
formatter (``native/hostio.py::format_sam``) when g++ could build it, else by
the Python SamWriter; both give the same bytes.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.device import resolve_device
from nextgenmap_tpu_torch.index.genome import Genome
from nextgenmap_tpu_torch.index.kmer_index import KmerIndex
from nextgenmap_tpu_torch.io.encode import revcomp_codes
from nextgenmap_tpu_torch.io.fastq import (
    ReadBatch, batch_paired, batch_single, peek_read_len,
)
from nextgenmap_tpu_torch.io.sam import (
    FLAG_SECONDARY, FLAG_UNMAPPED, SamWriter, aligned_rows, open_output,
)
from nextgenmap_tpu_torch.models.mapper import (
    MapResult, Mapper, default_slot_cap, default_topn_slot_cap,
)
from nextgenmap_tpu_torch.native import hostio as native
from nextgenmap_tpu_torch.pair.resolve import emit_paired
from nextgenmap_tpu_torch.parallel.index_shard import open_sharded
from nextgenmap_tpu_torch.utils.logging import get_logger
from nextgenmap_tpu_torch.utils.stats import MappingStats

log = get_logger("ngm-torch.run")


@dataclass
class RunStats(MappingStats):
    # score-pass slots that held a real candidate, summed over batches
    # (see slots_scored())
    slots_scored: int = 0


def load_reference(cfg: NgmConfig, ref_path: str):
    """(genome, index): with --index-shards N > 1 the memoized ShardedIndex
    (parallel/index_shard.py::open_sharded), split from a host KmerIndex
    (in bisulfite mode the (CT, GA) pair), each built or loaded here.
    Unsharded, index is a memoized host KmerIndex when one matches the
    genome (in bisulfite mode a (CT, GA) pair, when both do), a fresh host
    build for genomes over 2^28 bases (not bisulfite), else None (the
    Mapper builds the index on the device)."""
    genome = Genome.open(ref_path, skip_save=cfg.skip_save)

    def try_load(collapse: str) -> KmerIndex | None:
        cache = KmerIndex.cache_path(ref_path, cfg.kmer, cfg.kmer_skip,
                                     collapse, canonical=collapse == "none")
        if os.path.exists(cache):
            index = KmerIndex.load(cache)
            if index.genome_sha1 == genome.sha1():
                log.info("loaded k-mer index from %s", cache)
                return index
        return None

    def host_index(collapse: str = "none", **kw) -> KmerIndex:
        return KmerIndex.open(
            ref_path, genome.codes, genome.sha1(), k=cfg.kmer,
            skip=cfg.kmer_skip, max_freq=cfg.max_kmer_freq, collapse=collapse,
            skip_save=cfg.skip_save, **kw)

    if cfg.index_shards > 1:
        # the shards slice host CSRs by position range.  Canonical entries
        # ((pos << 1) | flip, monotone in pos) slice as well with doubled
        # bounds and rebase into int32 per shard; past 2^31 bases the
        # build falls back to raw positions
        if cfg.bs_mapping:
            index = (host_index("ct"), host_index("ga"))
        else:
            index = host_index(canonical=True, allow_u32=True)
        return genome, open_sharded(cfg, ref_path, genome, index)
    if cfg.bs_mapping:
        ct, ga = try_load("ct"), try_load("ga")
        return genome, (ct, ga) if ct and ga else None
    index = try_load("none")
    if index is not None:
        return genome, index
    if genome.codes.shape[0] > (1 << 28):
        log.info("large genome: building k-mer index on host (one-time)")
        return genome, host_index(canonical=genome.codes.shape[0] < 2**30)
    return genome, None


def to_host(res: MapResult) -> MapResult:
    """The batch's result as numpy arrays (one device-to-host fetch)."""
    return MapResult(*(t.cpu().numpy() for t in res))


def _count(stats: MappingStats, res: MapResult, n: int) -> np.ndarray:
    mapped = res.mapped[:n].astype(bool)
    stats.kmer_fanout_overflow += int(res.fanout_overflow)
    stats.cmr_overflow += int(res.cmr_overflow)
    stats.reads_in += n
    n_mapped = int(mapped.sum())
    stats.reads_mapped += n_mapped
    stats.reads_unmapped += n - n_mapped
    return mapped


def _emit_single_native(writer: SamWriter, batch: ReadBatch, res: MapResult,
                        stats: MappingStats) -> None:
    """Format the whole batch, mapped and unmapped rows, in one C call."""
    t0 = time.perf_counter()
    n = batch.n
    mapped = _count(stats, res, n)
    strand = np.where(mapped, res.strand[:n], 0)
    pos = np.where(mapped, res.pos[:n].astype(np.int64), 0)
    genome = writer.genome
    aligned = aligned_rows(batch.codes[:n], batch.lengths[:n], batch.read_len,
                           strand)
    ci = np.zeros(n, np.int64)
    cp = np.full(n, -1, np.int64)
    midx = np.nonzero(mapped)[0]
    if midx.size:
        mci, mcp = genome.abs_to_chrom(pos[midx])
        ci[midx] = np.atleast_1d(mci)
        cp[midx] = np.atleast_1d(mcp)
    names_arr = np.asarray(genome.names + ["*"], dtype=object)
    rnames = names_arr[np.where(mapped, ci, len(genome.names))].tolist()
    n_ops = np.where(mapped, res.n_ops[:n], 0)
    ident = res.matches[:n].astype(np.float32) / np.maximum(1, n_ops)
    if writer.cfg.no_unal:
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
        flag=sel((strand * 16 + (~mapped) * 4).astype(np.int32)),
        chrom_pos=sel(cp),
        rnames=[rnames[i] for i in keep],
        mapq=sel(np.where(mapped, res.mapq[:n], 0)),
        score=sel(res.score[:n]),
        ops=sel(res.ops[:n]),
        n_ops=sel(n_ops),
        q_start=sel(res.q_start[:n]),
        q_end=sel(res.q_end[:n]),
        genome_codes=genome.codes,
        gpos_abs=sel(pos),
        rnexts=["*"] * keep.size,
        pnext=np.zeros(keep.size, np.int64),
        tlen=np.zeros(keep.size, np.int64),
        identity=sel(ident),
        rg_suffix=writer.tags_suffix(),
        clip_mode=writer.clip_mode(),
        is_mapped=sel(mapped.astype(np.uint8)),
    )
    t1 = time.perf_counter()
    stats.add_time("format", t1 - t0)
    writer.out.write(blob.decode("ascii"))
    stats.add_time("write", time.perf_counter() - t1)


def emit_single(writer: SamWriter, batch: ReadBatch, res: MapResult,
                stats: MappingStats) -> None:
    """Write one single-end batch's records (host arrays) in input order."""
    if native.lib() is not None:
        return _emit_single_native(writer, batch, res, stats)
    t0 = time.perf_counter()
    mapped = _count(stats, res, batch.n)
    for i in range(batch.n):
        L = int(batch.lengths[i])
        if not mapped[i]:
            writer.write_unmapped(batch.names[i], batch.codes[i, :L],
                                  batch.quals[i])
            continue
        st = int(res.strand[i])
        codes = batch.codes[i, :L]
        no = int(res.n_ops[i])
        writer.write_mapped(
            batch.names[i], revcomp_codes(codes) if st else codes,
            batch.quals[i], L, st, int(res.pos[i]), int(res.mapq[i]),
            int(res.score[i]), res.ops[i], no, int(res.q_start[i]),
            int(res.q_end[i]), float(res.matches[i]) / max(1, no),
        )
    stats.add_time("format", time.perf_counter() - t0)


def _emit_single_topn_native(writer: SamWriter, batch: ReadBatch,
                             results: tuple, stats: MappingStats,
                             strata: bool, read_len: int) -> None:
    """Top-n selection masks in numpy, rendered by ONE native call (rows
    read-major, rank ascending: the order of the Python loop)."""
    t0 = time.perf_counter()
    n = batch.n
    F = lambda f: np.stack([getattr(r, f)[:n] for r in results])  # noqa: E731
    mapped = F("mapped").astype(bool)     # [J, n]
    score = F("score")
    pos = F("pos").astype(np.int64)
    _count(stats, results[0], n)

    # eligibility chain of the sequential semantics: rank j emits iff every
    # rank < j kept the chain alive (mapped, score > 0, in the stratum) and j
    # is no near-duplicate (within read_len) of an emitted better hit
    emit = np.zeros(mapped.shape, bool)
    chain = mapped[0].copy()
    for j in range(len(results)):
        chain = chain & mapped[j] & (score[j] > 0)
        if strata and j > 0:
            chain = chain & (score[j] >= score[0])
        dup = np.zeros(n, bool)
        for k in range(j):
            dup |= emit[k] & (np.abs(pos[j] - pos[k]) <= read_len)
        emit[j] = chain & ~dup  # a duplicate skips its rank, the chain goes on
    # row matrix [n, J]: column 0 may also carry the unmapped record
    M = emit.T.copy()
    if not writer.cfg.no_unal:
        M[~mapped[0], 0] = True
    ii, jj = np.nonzero(M)                # read-major, rank-ascending order
    if ii.size == 0:
        return
    row_mapped = mapped[0][ii] & emit[jj, ii]
    r_strand = np.where(row_mapped, F("strand")[jj, ii], 0)
    r_pos = np.where(row_mapped, pos[jj, ii], 0)
    genome = writer.genome
    ci = np.zeros(ii.size, np.int64)
    cp = np.full(ii.size, -1, np.int64)
    ridx = np.nonzero(row_mapped)[0]
    if ridx.size:
        mci, mcp = genome.abs_to_chrom(r_pos[ridx])
        ci[ridx] = np.atleast_1d(mci)
        cp[ridx] = np.atleast_1d(mcp)
    names_arr = np.asarray(genome.names + ["*"], dtype=object)
    lens = batch.lengths[:n][ii]
    r_nops = np.where(row_mapped, F("n_ops")[jj, ii], 0)
    blob = native.format_sam(
        names=[batch.names[i] for i in ii],
        aligned_codes=aligned_rows(batch.codes[:n][ii], lens, batch.read_len,
                                   r_strand),
        read_len=lens,
        quals=[batch.quals[i] for i in ii],
        qual_rev=r_strand.astype(np.uint8),
        flag=(r_strand * 16 + np.where(
            row_mapped, np.where(jj > 0, FLAG_SECONDARY, 0), FLAG_UNMAPPED,
        )).astype(np.int32),
        chrom_pos=cp,
        rnames=names_arr[np.where(row_mapped, ci, len(genome.names))].tolist(),
        mapq=np.where(row_mapped & (jj == 0), F("mapq")[0][ii], 0),
        score=score[jj, ii],
        ops=F("ops")[jj, ii],
        n_ops=r_nops,
        q_start=F("q_start")[jj, ii],
        q_end=F("q_end")[jj, ii],
        genome_codes=genome.codes,
        gpos_abs=r_pos,
        rnexts=["*"] * ii.size,
        pnext=np.zeros(ii.size, np.int64),
        tlen=np.zeros(ii.size, np.int64),
        identity=F("matches")[jj, ii].astype(np.float32) / np.maximum(1, r_nops),
        rg_suffix=writer.tags_suffix(),
        clip_mode=writer.clip_mode(),
        is_mapped=row_mapped.astype(np.uint8),
    )
    t1 = time.perf_counter()
    stats.add_time("format", t1 - t0)
    writer.out.write(blob.decode("ascii"))
    stats.add_time("write", time.perf_counter() - t1)


def emit_single_topn(writer: SamWriter, batch: ReadBatch, results: tuple,
                     stats: MappingStats, strata: bool, read_len: int) -> None:
    """Write up to topn alignments per read (host arrays); ranks past the
    first are SAM secondaries (FLAG 0x100, MAPQ 0).  --strata keeps only
    the top-score stratum; a near-duplicate (within a read length of a
    better hit) is suppressed."""
    if native.lib() is not None:
        return _emit_single_topn_native(writer, batch, results, stats,
                                        strata, read_len)
    t0 = time.perf_counter()
    mapped0 = _count(stats, results[0], batch.n)
    for i in range(batch.n):
        L = int(batch.lengths[i])
        if not mapped0[i]:
            writer.write_unmapped(batch.names[i], batch.codes[i, :L],
                                  batch.quals[i])
            continue
        best_score = int(results[0].score[i])
        emitted_pos: list[int] = []
        for j, r in enumerate(results):
            if not r.mapped[i]:
                break
            score = int(r.score[i])
            if score <= 0 or (strata and score < best_score):
                break
            pos = int(r.pos[i])
            if any(abs(pos - p) <= read_len for p in emitted_pos):
                continue  # the locus of a better alignment
            emitted_pos.append(pos)
            st = int(r.strand[i])
            codes = batch.codes[i, :L]
            no = int(r.n_ops[i])
            writer.write_mapped(
                batch.names[i], revcomp_codes(codes) if st else codes,
                batch.quals[i], L, st, pos, int(r.mapq[i]) if j == 0 else 0,
                score, r.ops[i], no, int(r.q_start[i]), int(r.q_end[i]),
                float(r.matches[i]) / max(1, no),
                flag_extra=0 if j == 0 else FLAG_SECONDARY,
            )
    stats.add_time("format", time.perf_counter() - t0)


def slots_scored(mode: str, n_candidates: np.ndarray, batch_size: int) -> int:
    """Score-pass slots that held a real candidate in one batch: the
    candidates of reads with >= 2 (single), of both mates of pairs where a
    mate has >= 2 (paired), or of every read (topn), up to the slot cap."""
    nc = n_candidates.astype(np.int64)
    if mode == "paired":
        pairs = nc.reshape(-1, 2)
        return min(int(pairs[(pairs >= 2).any(axis=1)].sum()),
                   default_slot_cap(batch_size))
    if mode == "topn":
        return min(int(nc.sum()), default_topn_slot_cap(batch_size))
    return min(int(nc[nc >= 2].sum()), default_slot_cap(batch_size))


def long_read_batch_size(cfg: NgmConfig, read_len: int) -> int:
    """The batch size to map `read_len` reads with: the default one shrinks
    for reads over 250 bp, so that the traceback's [L, B, W] direction
    bytes stay near their 150 bp size (the reference runner's rule on one
    device; a batch of pairs stays even)."""
    if read_len > 250 and cfg.batch_size == NgmConfig().batch_size:
        return max(16, cfg.batch_size * 150 // read_len // 2 * 2)
    return cfg.batch_size


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_mapping(cfg: NgmConfig, ref_path: str, qry: str | None = None,
                out_path: str | None = None, cmdline: str = "", *,
                qry1: str | None = None, qry2: str | None = None,
                paired_interleaved: bool = False,
                device: torch.device | str) -> RunStats:
    """Map reads against `ref_path` into SAM: single-end `qry` (with -n > 1
    up to topn ranked records per read), or pairs from `qry1`/`qry2` or
    from the interleaved `qry` with paired_interleaved.

    Phase seconds land in stats.timing: reference (native formatter and
    genome load), index (device index build), parse, map (device step),
    fetch, format, write.
    stats.start_time is set after the index build, so reads_per_sec() is
    host-inclusive mapping throughput.
    """
    cfg.validate()
    device = resolve_device(device)
    paired = qry1 is not None or paired_interleaved
    skip, count = max(0, cfg.qry_start), max(0, cfg.qry_count)
    if paired and (skip % 2 or count % 2):
        raise ValueError("paired qry-start/qry-count must be even")
    stats = RunStats()
    t0 = time.perf_counter()
    native.lib()   # builds the native formatter on first use: set-up time
    genome, index = load_reference(cfg, ref_path)
    read_len = cfg.read_len or peek_read_len(qry1 or qry)
    log.info("read length (padded): %d", read_len)
    batch = long_read_batch_size(cfg, read_len)
    if batch != cfg.batch_size:
        log.info("long reads (%d bp): batch_size %d -> %d",
                 read_len, cfg.batch_size, batch)
        cfg = cfg.replace(batch_size=batch)
    t1 = time.perf_counter()
    stats.add_time("reference", t1 - t0)
    mapper = Mapper(cfg, genome, read_len, index, device=device)
    _sync(mapper.device)
    stats.add_time("index", time.perf_counter() - t1)
    stats.start_time = time.time()

    if paired:
        mode, step, emit = "paired", mapper.map_batch_paired, emit_paired
        batches = batch_paired(qry1 or qry, qry2, cfg.batch_size, read_len,
                               skip, count)
    else:
        batches = batch_single(qry, cfg.batch_size, read_len, skip, count)
        if cfg.topn > 1:
            mode, step = "topn", mapper.map_batch_topn

            def emit(writer, batch, host, stats):
                emit_single_topn(writer, batch, host, stats, cfg.strata,
                                 read_len)
        else:
            mode, step, emit = "single", mapper.map_batch, emit_single

    out = open_output(out_path)
    try:
        writer = SamWriter(genome, cfg, out, cmdline)
        writer.write_header()
        batches = iter(batches)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            t1 = time.perf_counter()
            stats.add_time("parse", t1 - t0)
            if batch is None:
                break
            res = step(batch.codes, batch.lengths)
            _sync(mapper.device)
            t2 = time.perf_counter()
            stats.add_time("map", t2 - t1)
            host = tuple(map(to_host, res)) if mode == "topn" else to_host(res)
            stats.add_time("fetch", time.perf_counter() - t2)
            first = host[0] if mode == "topn" else host
            stats.slots_scored += slots_scored(mode, first.n_candidates,
                                               batch.batch_size)
            emit(writer, batch, host, stats)
            stats.mark_batch()
            if not cfg.no_progress:
                log.info("processed %d reads (%.0f reads/s)",
                         stats.reads_in, stats.reads_per_sec())
    finally:
        if out_path not in (None, "-"):
            out.close()
    log.info("phase seconds: %s",
             {k: round(v, 3) for k, v in sorted(stats.timing.items())})
    log.info("done: %s", stats.summary())
    return stats
