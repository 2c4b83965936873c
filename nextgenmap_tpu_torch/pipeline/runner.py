"""Single-end mapping run: reads -> device step -> SAM, in input order.

Port of the single-end branch of ``nextgenmap_tpu/pipeline/runner.py``
(``run_mapping``, ``load_reference``, ``aligned_rows``, ``emit_single``).
The loop is serial: parse a batch, map it on the device, fetch its result
to the host, format and write its records.  Records are formatted by the
jax-free native formatter ``nextgenmap_tpu.native.format_sam`` when it is
available, else by the Python SamWriter; both give the same bytes.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from nextgenmap_tpu import native
from nextgenmap_tpu.config import NgmConfig
from nextgenmap_tpu.index.genome import Genome
from nextgenmap_tpu.index.kmer_index import KmerIndex
from nextgenmap_tpu.io.encode import revcomp_codes
from nextgenmap_tpu.io.fastq import ReadBatch, batch_single, peek_read_len
from nextgenmap_tpu.utils.logging import get_logger
from nextgenmap_tpu.utils.stats import MappingStats
from nextgenmap_tpu_torch.device import resolve_device
from nextgenmap_tpu_torch.io.sam import SamWriter, open_output
from nextgenmap_tpu_torch.models.mapper import MapResult, Mapper, default_slot_cap

log = get_logger("ngm-tpu.torch.run")


@dataclass
class RunStats(MappingStats):
    # score-pass slots that held a real candidate, summed over batches
    slots_scored: int = 0


def load_reference(cfg: NgmConfig, ref_path: str):
    """(genome, index): index is a memoized canonical host KmerIndex when
    one matches the genome, a fresh host build for genomes over 2^28 bases,
    else None (the Mapper builds the index on the device)."""
    genome = Genome.open(ref_path, skip_save=cfg.skip_save)
    cache = KmerIndex.cache_path(ref_path, cfg.kmer, cfg.kmer_skip, "none",
                                 canonical=True)
    if os.path.exists(cache):
        index = KmerIndex.load(cache)
        if index.genome_sha1 == genome.sha1():
            log.info("loaded k-mer index from %s", cache)
            return genome, index
    if genome.codes.shape[0] > (1 << 28):
        log.info("large genome: building k-mer index on host (one-time)")
        index = KmerIndex.open(
            ref_path, genome.codes, genome.sha1(),
            k=cfg.kmer, skip=cfg.kmer_skip, max_freq=cfg.max_kmer_freq,
            skip_save=cfg.skip_save, canonical=genome.codes.shape[0] < 2**30,
        )
        return genome, index
    return genome, None


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
        clip_mode=1 if writer.cfg.hard_clip else (2 if writer.cfg.silent_clip else 0),
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_mapping(cfg: NgmConfig, ref_path: str, qry: str,
                out_path: str | None = None, cmdline: str = "", *,
                device: torch.device | str) -> RunStats:
    """Map the single-end reads of `qry` against `ref_path` into SAM.

    Phase seconds land in stats.timing: reference (native formatter and
    genome load), index (device index build), parse, map (device step),
    fetch, format, write.
    stats.start_time is set after the index build, so reads_per_sec() is
    host-inclusive mapping throughput.
    """
    cfg.validate()
    device = resolve_device(device)
    stats = RunStats()
    t0 = time.perf_counter()
    native.lib()   # builds the native formatter on first use: set-up time
    genome, index = load_reference(cfg, ref_path)
    read_len = cfg.read_len or peek_read_len(qry)
    log.info("read length (padded): %d", read_len)
    t1 = time.perf_counter()
    stats.add_time("reference", t1 - t0)
    mapper = Mapper(cfg, genome, read_len, index, device=device)
    _sync(mapper.device)
    stats.add_time("index", time.perf_counter() - t1)
    stats.start_time = time.time()

    out = open_output(out_path)
    try:
        writer = SamWriter(genome, cfg, out, cmdline)
        writer.write_header()
        batches = iter(batch_single(qry, cfg.batch_size, read_len,
                                    max(0, cfg.qry_start),
                                    max(0, cfg.qry_count)))
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            t1 = time.perf_counter()
            stats.add_time("parse", t1 - t0)
            if batch is None:
                break
            res = mapper.map_batch(batch.codes, batch.lengths)
            _sync(mapper.device)
            t2 = time.perf_counter()
            stats.add_time("map", t2 - t1)
            host = to_host(res)
            stats.add_time("fetch", time.perf_counter() - t2)
            multi = host.n_candidates[host.n_candidates >= 2]
            stats.slots_scored += min(int(multi.sum()),
                                      default_slot_cap(batch.batch_size))
            emit_single(writer, batch, host, stats)
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
