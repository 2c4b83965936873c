"""Mapping run: reads -> device step -> SAM, in input order.

Port of ``nextgenmap_tpu/pipeline/runner.py``: ``run_mapping`` with its
single-end, top-n and paired branches, its long-read batch size, its
software pipeline (``_prefetch``, ``_Emitter``, ``_PoolEmitter``),
``--megabatch``, the progress sidecar and ``--resume``, ``--bam`` and
``--profile``; several devices (``--devices``: the batch rounded to a
multiple of 2 x devices); several processes (``--dist-nprocs``: each maps
its round-robin share of the batches into a part file, which process 0
merges, ``parallel/distributed.py``; with ``--shard-across-hosts`` every
process maps every batch against its own index shards and process 0 alone
writes); ``load_reference`` with its bisulfite and index-shard branches;
``emit_single`` and ``emit_single_topn``.  Records are formatted by
the port's native formatter (``native/hostio.py::format_sam``) when g++ could
build it, else by the Python SamWriter; both give the same bytes.

The pipeline is the reference's: a parse thread stays max(2, -t) batches
ahead, and batch i+1 is dispatched to the device before batch i is emitted.
A dispatch is one batch, or with ``--megabatch K`` K batches stacked into
one ``Mapper.map_batch_scan`` call (one graph of K steps on a card; a short
tail group padded with copies of its last batch, as the reference's
``run_megabatched`` pads it).  Each dispatch ends with a ``Fetch``: one
non-blocking copy of every result field into pinned host memory behind one
CUDA event, which the emitter waits on before it reads the fields.  -t 1
emits on the main thread, -t 2 on a thread of its own, -t >= 3 renders in
-t - 1 workers and writes from one committer thread in submit order.  The output bytes are the same for every
-t and --megabatch.

``--profile DIR`` also turns on the program's tracing (``utils/trace.py``)
on the mapper's first device for the mapping loop: the trace carries the
program's spans and phase marks, and the run logs the phases' us a batch
and the score pass's counters with its summary.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import itertools
import json
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.index.genome import Genome
from nextgenmap_tpu_torch.index.kmer_index import KmerIndex
from nextgenmap_tpu_torch.io.bam import BamTextWriter
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
from nextgenmap_tpu_torch.parallel import distributed as dist_mod
from nextgenmap_tpu_torch.parallel.index_shard import (
    grid_layout, open_sharded, open_sharded_local,
)
from nextgenmap_tpu_torch.parallel.mesh import device_slots
from nextgenmap_tpu_torch.utils import trace
from nextgenmap_tpu_torch.utils.logging import get_logger
from nextgenmap_tpu_torch.utils.stats import MappingStats

log = get_logger("ngm-torch.run")


@dataclass
class RunStats(MappingStats):
    # score-pass slots that held a real candidate, summed over batches
    # (see slots_scored())
    slots_scored: int = 0
    # device time of each dispatch (a batch, or a --megabatch group) in ms,
    # from CUDA events around its step; empty on the CPU
    step_device_ms: list = field(default_factory=list)
    # replays of the mapper's step graphs, and the graphs captured (each
    # with its eager warm-up step), in this run (models/step_graph.py)
    graph_replays: int = 0
    graph_captures: int = 0
    # a --dist-nprocs part's ledger: its header's lines, and each emitted
    # batch's lines and bytes (what the merge interleaves by)
    header_lines: int = 0
    batch_lines: list = field(default_factory=list)
    batch_bytes: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def add_time(self, phase: str, dt: float) -> None:
        # phases arrive from the main, parse, emitter and committer threads
        with self._lock:
            super().add_time(phase, dt)


def load_reference(cfg: NgmConfig, ref_path: str, own_shards=None):
    """(genome, index): with --index-shards N > 1 the memoized ShardedIndex
    (parallel/index_shard.py::open_sharded), split from a host KmerIndex
    (in bisulfite mode the (CT, GA) pair), each built or loaded here; with
    --shard-across-hosts only the shards `own_shards` of this process
    (open_sharded_local).
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

    if cfg.shard_hosts:
        return genome, open_sharded_local(cfg, ref_path, genome, own_shards)
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


def long_read_batch_size(cfg: NgmConfig, read_len: int,
                         n_devices: int = 1) -> int:
    """The batch size to map `read_len` reads with: the default one shrinks
    for reads over 250 bp, so that the traceback's [L, B, W] direction
    bytes stay near their 150 bp size (the reference runner's rule; the
    batch stays a multiple of 2 x devices, so pairs never straddle two
    devices' slices)."""
    if read_len > 250 and cfg.batch_size == NgmConfig().batch_size:
        m = 2 * max(1, n_devices)
        return max(m * 8, cfg.batch_size * 150 // read_len // m * m)
    return cfg.batch_size


class Fetch:
    """The results of one dispatch (one batch, or a --megabatch group) on
    their way to the host: `results`, one result a batch, or with `rows` the
    one result of a group, its fields stacked [K, ...], of which the first
    `rows` batches are emitted (the rest pad the tail group).  On the
    cards: one non-blocking copy of every result field (on the first
    device, or already on the host) into pinned host tensors, then one CUDA
    event recorded after the copies; the step is bracketed by a pair of
    timing events on each device.  On the CPU: the fields themselves.
    `wait` is all the emitter calls: it waits on the event (no CUDA work of
    its own) and reads the pinned memory."""

    def __init__(self, results: list, devices: list,
                 starts: list | None, rows: int = 0):
        self.starts = starts
        self.rows = rows
        self.ends = self.done = None
        if devices[0].type != "cuda":
            self.host = results
            return
        self.ends = []
        for d in devices:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(d))
            self.ends.append(ev)
        self.host = [_map_fields(_pinned_copy, r) for r in results]
        self.done = torch.cuda.Event()
        self.done.record(torch.cuda.current_stream(devices[0]))

    def wait(self, stats: MappingStats) -> list:
        """The results of the emitted batches as numpy arrays, once their
        copies have landed (the wait is phase `fetch`)."""
        t0 = time.perf_counter()
        if self.done is not None:
            self.done.synchronize()
        stats.add_time("fetch", time.perf_counter() - t0)
        host = [_map_fields(lambda t: t.numpy(), r) for r in self.host]
        if not self.rows:
            return host
        return [_map_fields(lambda a, i=i: a[i], host[0])
                for i in range(self.rows)]

    def device_ms(self) -> float | None:
        """The step's device time (after `wait`): the longest over the
        devices; None on the CPU."""
        if self.ends is None:
            return None
        return max(s.elapsed_time(e) for s, e in zip(self.starts, self.ends))


def _map_fields(fn, res):
    """fn over the fields of a MapResult, or of each rank of a top-n tuple."""
    if isinstance(res, MapResult):
        return MapResult(*map(fn, res))
    return tuple(_map_fields(fn, r) for r in res)


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    if t.device.type == "cpu":
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    return h


def _mark(devices: list) -> list | None:
    """A timing event per device recorded before a dispatch (None on the
    CPU)."""
    if devices[0].type != "cuda":
        return None
    evs = []
    for d in devices:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(d))
        evs.append(ev)
    return evs


def _prefetch(it, depth: int, stats: MappingStats):
    """Run the batch generator on a parse thread, `depth` batches ahead (the
    reference's ReadProvider analog).  The wait for each batch is phase
    `parse_wait`; an error in the thread is raised here, and closing this
    generator ends the thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
            put(done)
        except BaseException as e:   # raised in the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            stats.add_time("parse_wait", time.perf_counter() - t0)
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


class _Emitter:
    """The emission stage (the reference's writer-thread analog): -t 1
    emits each item on the main thread one dispatch late, so that the next
    dispatch is on the device while this one is formatted; -t 2 emits on a
    thread of its own from a bounded FIFO queue.  Either way items are
    emitted in submit order, and an error in the thread is raised by the
    next submit or by close."""

    def __init__(self, emit, threaded: bool):
        self.emit, self.threaded = emit, threaded
        self.pending = None
        self.err: BaseException | None = None
        self.stopped = False
        if threaded:
            self.q: queue.Queue = queue.Queue(maxsize=3)
            self.t = threading.Thread(target=self._run, daemon=True)
            self.t.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if self.err is not None or self.stopped:
                continue   # drain, so that a producer blocked in put() goes on
            try:
                self.emit(item)
            except BaseException as e:
                self.err = e

    def submit(self, item) -> None:
        if not self.threaded:
            prev, self.pending = self.pending, item
            if prev is not None:
                self.emit(prev)
            return
        if self.err is not None:
            raise self.err
        self.q.put(item)

    def close(self) -> None:
        """Emit what is left; raise the thread's error."""
        if not self.threaded:
            prev, self.pending = self.pending, None
            if prev is not None:
                self.emit(prev)
            return
        if self.t.is_alive():
            self.q.put(None)
            self.t.join()
        if self.err is not None:
            raise self.err

    def abort(self) -> None:
        """End the thread without emitting what is queued (after an error
        elsewhere; nothing to do after close)."""
        self.pending = None
        if self.threaded and self.t.is_alive():
            self.stopped = True
            self.q.put(None)
            self.t.join()


class _PoolEmitter:
    """-t >= 3: `workers` threads render items concurrently (the native
    formatter releases the GIL), and one committer thread applies `commit`
    strictly in submit order, so the output bytes and the progress
    bookkeeping are the serial emitter's.  An error in a worker or in the
    committer is raised by the next submit or by close."""

    def __init__(self, workers: int, render, commit):
        self.pool = ThreadPoolExecutor(max_workers=workers)
        self.q: queue.Queue = queue.Queue(maxsize=workers + 2)
        self.render, self.commit = render, commit
        self.err: BaseException | None = None
        self.stopped = False
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            fut, args = item
            if self.err is not None or self.stopped:
                fut.cancel()
                continue
            try:
                self.commit(fut.result(), args)
            except BaseException as e:
                self.err = e

    def submit(self, item) -> None:
        if self.err is not None:
            raise self.err
        self.q.put((self.pool.submit(self.render, item), item))

    def close(self) -> None:
        if self.t.is_alive():
            self.q.put(None)
            self.t.join()
        self.pool.shutdown(wait=True)
        if self.err is not None:
            raise self.err

    def abort(self) -> None:
        if self.t.is_alive():
            self.stopped = True
            self.q.put(None)
            self.t.join()
        self.pool.shutdown(wait=True, cancel_futures=True)


def config_sha(cfg: NgmConfig) -> str:
    """The progress sidecar's hash of the mapping semantics, the
    reference's: the input window (which resume adjusts) and the flags that
    change no record byte are left out."""
    return hashlib.sha1(cfg.replace(
        qry_start=0, qry_count=0, no_merge=False, no_progress=False,
        threads=1, skip_save=False,
    ).to_json().encode()).hexdigest()


def _resume_point(progress_path: str | None, out_path: str, sha: str,
                  bam: bool) -> tuple[int, dict]:
    """(reads an interrupted run of the same configuration already emitted
    into `out_path`, its sidecar); (0, {}) to start fresh.  Drops the
    partial records past its checkpoint.  BGZF cannot be appended
    record-wise, so --bam never resumes (a part of --dist-nprocs is SAM
    text whatever the output, so the caller passes bam=False for it)."""
    if progress_path is None or bam or not os.path.exists(progress_path):
        return 0, {}
    try:
        with open(progress_path) as f:
            p = json.load(f)
    except (OSError, ValueError):
        return 0, {}
    if (p.get("config_sha") != sha or p.get("complete")
            or not os.path.exists(out_path)):
        return 0, {}
    prior = int(p.get("reads_emitted", 0))
    ob = p.get("out_bytes")
    if prior > 0 and ob is not None and os.path.getsize(out_path) > ob:
        with open(out_path, "r+") as f:
            f.truncate(ob)
        log.info("truncated %s to checkpointed %d bytes", out_path, ob)
    log.info("resuming after %d already-emitted reads", prior)
    return prior, p


def _manifest_stats(stats: MappingStats) -> dict:
    """The counters a part's manifest carries (the reference's keys)."""
    return {f.name: getattr(stats, f.name)
            for f in dataclasses.fields(MappingStats)
            if f.name != "start_time"
            and isinstance(getattr(stats, f.name), (int, float))}


def runs_megabatched(cfg: NgmConfig, mode: str, mapper: Mapper) -> bool:
    """The one predicate for --megabatch K: K batches per dispatch (and K per
    item of the emitter pool) on the single-end and paired paths of a mapper
    that supports it; top-n never."""
    return cfg.megabatch > 1 and mode != "topn" and mapper.supports_megabatch()


def _profiler(device: torch.device):
    """torch.profiler over the mapping loop: CPU activity, and the card's
    kernels on CUDA; no shapes, stacks or memory (a trace of a few 4096-read
    batches is tens of MiB even so)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False)


def run_mapping(cfg: NgmConfig, ref_path: str, qry: str | None = None,
                out_path: str | None = None, cmdline: str = "", *,
                qry1: str | None = None, qry2: str | None = None,
                paired_interleaved: bool = False, resume: bool = False,
                profile_dir: str = "",
                device: torch.device | str | list) -> RunStats:
    """Map reads against `ref_path` into SAM (BAM with cfg.bam): single-end
    `qry` (with -n > 1 up to topn ranked records per read), or pairs from
    `qry1`/`qry2` or from the interleaved `qry` with paired_interleaved.

    `device` is a device, with cfg.devices slots of it, or a list of slots
    (parallel/mesh.py::device_slots); with several, each batch splits over
    them.  With cfg.dist_nprocs > 1 this is one of that many processes:
    it maps batches b with b % nprocs == dist_procid into
    `<out>.part<i>-of-<n>` and its manifest, and process 0 merges the parts
    into `out_path` (unless no_merge); with cfg.shard_hosts every process
    maps every batch against its own index shards, and only process 0
    writes.  A dist_coordinator (host:port) joins the processes in one
    torch.distributed group, which --shard-across-hosts needs.

    After every emitted batch the sidecar `<out>.ngmt-progress.json`
    records the reads emitted, the output's byte count and the config hash
    (not for `-o -`; a part's sidecar also the per-batch line and byte
    ledger the merge needs); with resume=True a matching incomplete sidecar
    skips the reads (a part: its own batches) already emitted, truncates
    the output to its checkpoint and appends.  profile_dir: write a
    torch.profiler trace of the mapping loop there (Perfetto reads it).

    Phase seconds land in stats.timing: reference (native formatter and
    genome load), index (device index build), then from the main thread
    parse_wait, dispatch (the device step's host side, and the fetch's
    start) and emit_wait, and from the emitter fetch (the wait for the
    copies), format and write; process 0's merge of the parts (the wait for
    the others' manifests included) is phase merge.  stats.step_device_ms
    holds each dispatch's device time (CUDA events).  stats.start_time is
    set after the index build, so reads_per_sec() is host-inclusive mapping
    throughput.
    """
    cfg.validate()
    slots = device_slots(device, cfg.devices)
    paired = qry1 is not None or paired_interleaved
    dist = cfg.dist_nprocs > 1 and not cfg.shard_hosts
    hosts = cfg.shard_hosts and cfg.dist_nprocs > 1
    if dist and out_path in (None, "-"):
        raise ValueError("multi-host mapping requires -o <file>")
    if cfg.bam and out_path in (None, "-"):
        raise ValueError("--bam requires -o <file>")
    if hosts and resume:
        # every process must dispatch the same batches (the collectives are
        # lockstep); one process's rewound input would desynchronize them
        raise ValueError("--resume is not supported with "
                         "--shard-across-hosts; rerun the mapping")
    skip, count = max(0, cfg.qry_start), max(0, cfg.qry_count)
    if paired and (skip % 2 or count % 2):
        raise ValueError("paired qry-start/qry-count must be even")
    own = None
    if cfg.shard_hosts:
        # the shards this process loads, by the layout the Mapper places;
        # its refusals come before any process waits for another
        own = grid_layout(cfg, slots)[1]
    if len(slots) > 1:
        # data parallelism: a multiple of 2 x devices, so that no pair
        # straddles two slices; before the config hash, so resume agrees
        m = 2 * len(slots)
        bs = -(-cfg.batch_size // m) * m
        if bs != cfg.batch_size:
            log.info("batch_size %d -> %d (multiple of 2 x %d devices)",
                     cfg.batch_size, bs, len(slots))
            cfg = cfg.replace(batch_size=bs)
    final_out = out_path
    if dist:
        # parts are always SAM text; --bam is applied by process 0's merge
        out_path = dist_mod.part_path(final_out, cfg.dist_procid,
                                      cfg.dist_nprocs)
    elif hosts and cfg.dist_procid != 0:
        # maps every batch (its shards' side of the collectives), writes
        # nothing
        out_path = os.devnull
    joined = hosts or (dist and bool(cfg.dist_coordinator))
    if joined:
        dist_mod.init_distributed(cfg.dist_coordinator, cfg.dist_nprocs,
                                  cfg.dist_procid)
    try:
        stats = _map_reads(cfg, ref_path, qry, qry1, qry2, out_path,
                           cmdline, paired, resume, profile_dir, slots,
                           own, skip, count, dist)
    finally:
        if joined:
            dist_mod.shutdown_distributed()
    if dist:
        dist_mod.write_manifest(
            final_out, cfg.dist_procid, cfg.dist_nprocs, stats.header_lines,
            stats.batch_lines, _manifest_stats(stats), complete=True,
            batch_bytes=stats.batch_bytes)
        if cfg.dist_procid == 0 and not cfg.no_merge:
            t0 = time.perf_counter()   # the wait for the other parts too
            totals = dist_mod.merge_parts(final_out, cfg.dist_nprocs,
                                          bam=cfg.bam)
            stats.add_time("merge", time.perf_counter() - t0)
            log.info("done (all %d hosts): reads: %d  mapped: %d  "
                     "unmapped: %d", cfg.dist_nprocs,
                     totals.get("reads_in", 0), totals.get("reads_mapped", 0),
                     totals.get("reads_unmapped", 0))
    return stats


def _map_reads(cfg, ref_path, qry, qry1, qry2, out_path, cmdline, paired,
               resume, profile_dir, slots, own, skip, count,
               dist) -> RunStats:
    """run_mapping's one process: load, map, write `out_path` (a part of
    a --dist-nprocs run when `dist`, whose ledger the stats carry back)."""
    stats = RunStats()
    t0 = time.perf_counter()
    native.lib()   # builds the native formatter on first use: set-up time
    genome, index = load_reference(cfg, ref_path, own)
    read_len = cfg.read_len or peek_read_len(qry1 or qry)
    log.info("read length (padded): %d", read_len)
    batch = long_read_batch_size(cfg, read_len, len(slots))
    if batch != cfg.batch_size:
        log.info("long reads (%d bp): batch_size %d -> %d",
                 read_len, cfg.batch_size, batch)
        cfg = cfg.replace(batch_size=batch)

    progress_path = (None if out_path in (None, "-", os.devnull)
                     else f"{out_path}.ngmt-progress.json")
    sha = config_sha(cfg)
    prior, saved = (_resume_point(progress_path, out_path, sha,
                                  cfg.bam and not dist)
                    if resume else (0, {}))
    # a part resumes by its own batches (the ledger counts them); a whole
    # run by reads
    ledger_lines = list(saved.get("batch_lines") or []) if dist else []
    ledger_bytes = list(saved.get("batch_bytes") or []) if dist else []
    if not dist:
        skip += prior
        if count:
            count = max(0, count - prior)
    if paired and (skip % 2 or count % 2):
        raise ValueError("paired qry-start/qry-count/resume must be even")
    t1 = time.perf_counter()
    stats.add_time("reference", t1 - t0)
    mapper = Mapper(cfg, genome, read_len, index, device=slots)
    for d in mapper.devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    stats.add_time("index", time.perf_counter() - t1)

    if paired:
        mode, step = "paired", mapper.map_batch_paired
        batches = batch_paired(qry1 or qry, qry2, cfg.batch_size, read_len,
                               skip, count)
    else:
        batches = batch_single(qry, cfg.batch_size, read_len, skip, count)
        mode, step = (("topn", mapper.map_batch_topn) if cfg.topn > 1
                      else ("single", mapper.map_batch))
    if dist:
        batches = dist_mod.shard_batches(batches, cfg.dist_procid,
                                         cfg.dist_nprocs)
        if ledger_lines:
            batches = itertools.islice(batches, len(ledger_lines), None)
    group = cfg.megabatch if runs_megabatched(cfg, mode, mapper) else 1

    if cfg.bam and not dist:
        out = BamTextWriter(out_path)
    elif prior > 0:
        out = open(out_path, "a", buffering=1 << 20)
    else:
        out = open_output(out_path)
    if dist:
        out = dist_mod.CountingWriter(
            out,
            lines=(int(saved.get("header_lines", 0)) + sum(ledger_lines)
                   if prior else 0),
            nbytes=int(saved.get("out_bytes") or 0) if prior else 0)
    writer = SamWriter(genome, cfg, out, cmdline)
    if prior == 0:
        writer.write_header()
    # a part's ledger: its header, then each of its batches' lines and bytes
    stats.header_lines = ((int(saved.get("header_lines", 0)) if prior
                           else out.lines) if dist else 0)
    stats.batch_lines, stats.batch_bytes = ledger_lines, ledger_bytes
    header_bytes = out.nbytes - sum(ledger_bytes) if dist else 0

    def save_progress(complete: bool = False) -> None:
        if progress_path is None:
            return
        # the output is buffered: it must reach the OS before the sidecar
        # counts its records as emitted, or a kill between the two loses
        # records that resume would then skip
        flush = getattr(out, "flush", None)
        if flush is not None:
            flush()
        try:   # the checkpoint's byte offset: resume truncates back to it
            out_bytes = getattr(out, "out", out).tell()
        except (OSError, ValueError, AttributeError):
            out_bytes = None
        doc = {"reads_emitted": prior + stats.reads_in, "config_sha": sha,
               "out_bytes": out_bytes, "complete": complete}
        if dist:
            doc.update(batch_lines=stats.batch_lines,
                       batch_bytes=stats.batch_bytes,
                       header_lines=stats.header_lines)
        tmp = progress_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, progress_path)

    cells_per_aln = read_len * mapper.band   # for the GCUPS counter

    def after_emit(batch: ReadBatch, res: MapResult) -> None:
        """A batch's bookkeeping once its records are written (`res`: the
        first rank's result with -n > 1)."""
        nc = np.asarray(res.n_candidates)
        n_aln = int(nc.sum(dtype=np.int64))
        stats.alignments_computed += n_aln
        stats.cells_computed += (n_aln + batch.n) * cells_per_aln
        stats.slots_scored += slots_scored(mode, nc, batch.batch_size)
        stats.mark_batch()
        if dist:
            stats.batch_lines.append(out.lines - stats.header_lines
                                     - sum(stats.batch_lines))
            stats.batch_bytes.append(out.nbytes - header_bytes
                                     - sum(stats.batch_bytes))
        save_progress()
        if not cfg.no_progress:
            log.info("processed %d reads (%.0f reads/s, %.2f GCUPS)",
                     stats.reads_in, stats.reads_per_sec(), stats.gcups())

    def emit_one(w: SamWriter, batch: ReadBatch, res, st: MappingStats):
        if mode == "paired":
            emit_paired(w, batch, res, st)
        elif mode == "topn":
            emit_single_topn(w, batch, res, st, cfg.strata, read_len)
        else:
            emit_single(w, batch, res, st)

    def first(res) -> MapResult:
        return res[0] if mode == "topn" else res

    def record_device(fetch: Fetch) -> None:
        ms = fetch.device_ms()
        if ms is not None:
            stats.step_device_ms.append(ms)

    def emit_item(item) -> None:
        """-t 1 and 2: wait for an item's copies, then write its batches."""
        group_batches, fetch = item
        results = fetch.wait(stats)
        record_device(fetch)
        for b, res in zip(group_batches, results):
            emit_one(writer, b, res, stats)
            after_emit(b, first(res))

    def render_item(item):
        """-t >= 3, in a pool worker: each batch's text, rendered by a
        writer clone into a buffer, with counters of its own."""
        group_batches, fetch = item
        st = MappingStats()
        results = fetch.wait(st)
        rendered = []
        for b, res in zip(group_batches, results):
            shim = dataclasses.replace(writer, out=io.StringIO())
            dst = MappingStats()
            emit_one(shim, b, res, dst)
            rendered.append((shim.out.getvalue(), dst, first(res)))
        return rendered, st

    def commit_item(rendered, item) -> None:
        """-t >= 3, in the committer: write, fold the counters back, and
        keep the bookkeeping, in submit order."""
        group_batches, fetch = item
        per_batch, st = rendered
        stats.merge_counters(st)
        record_device(fetch)
        for b, (text, dst, res) in zip(group_batches, per_batch):
            t0 = time.perf_counter()
            out.write(text)
            stats.add_time("write", time.perf_counter() - t0)
            stats.merge_counters(dst)
            after_emit(b, res)

    if cfg.threads >= 3:
        log.info("parallel emitter pool (%d render workers)", cfg.threads - 1)
        emitter = _PoolEmitter(cfg.threads - 1, render_item, commit_item)
    else:
        if cfg.threads == 2:
            log.info("emitter thread enabled (-t 2)")
        emitter = _Emitter(emit_item, threaded=cfg.threads == 2)
    if group > 1:
        log.info("megabatch: %d batches per dispatch", group)

    def dispatch(pending: list) -> None:
        """One dispatch: a batch, or a --megabatch group as ONE call of
        map_batch_scan (the reference's run_megabatched: a short tail group
        is padded with copies of its last batch, and the padding is never
        emitted); then its Fetch goes to the emitter."""
        t0 = time.perf_counter()
        start = _mark(mapper.devices)
        if group == 1:
            b, = pending
            fetch = Fetch([step(b.codes, b.lengths)], mapper.devices, start)
        else:
            pad = [pending[-1]] * (group - len(pending))
            res = mapper.map_batch_scan(
                np.stack([b.codes for b in pending + pad]),
                np.stack([b.lengths for b in pending + pad]),
                paired=mode == "paired")
            fetch = Fetch([res], mapper.devices, start, rows=len(pending))
        t1 = time.perf_counter()
        stats.add_time("dispatch", t1 - t0)
        emitter.submit((pending, fetch))
        stats.add_time("emit_wait", time.perf_counter() - t1)

    graphs = mapper.graphs
    replays0, captures0 = graphs.replays, len(graphs.captures)
    prof = _profiler(mapper.device) if profile_dir else None
    program = {}
    stats.start_time = time.time()
    parsed = _prefetch(batches, max(2, cfg.threads), stats)
    try:
        if prof is not None:
            trace.enable(mapper.device)
            prof.start()
        pending = []
        for batch in parsed:
            pending.append(batch)
            if len(pending) == group:
                dispatch(pending)
                pending = []
        if pending:   # the last, short group, padded to `group`
            dispatch(pending)
        emitter.close()
        save_progress(complete=True)
        program = trace.read()
    finally:
        emitter.abort()
        parsed.close()
        stats.graph_replays = graphs.replays - replays0
        stats.graph_captures = len(graphs.captures) - captures0
        if prof is not None:
            prof.stop()
            trace.disable()
        if cfg.bam or out_path not in (None, "-"):
            out.close()
    if prof is not None:
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir,
                            f"ngm-torch.{os.getpid()}.pt.trace.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)
    log.info("phase seconds: %s",
             {k: round(v, 3) for k, v in sorted(stats.timing.items())})
    if program:
        log.info("program trace: step phases us a batch %s; %s",
                 {k: round(v, 1) for k, v in trace.phase_us(program).items()},
                 ", ".join(f"{c} {program[c]}" for c in trace.COUNTERS))
    log.info("done: %s", stats.summary())
    return stats
