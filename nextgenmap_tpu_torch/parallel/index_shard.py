"""Index sharding by genome-position range, and the cross-shard merge.

Port of ``nextgenmap_tpu/parallel/index_shard.py``'s one-device part.  For
genomes too big for one index (GRCh38 and anything past 2^31 bases), the
CSR k-mer table and the genome are split into S contiguous position ranges.
Every shard runs the candidate search and the tails against its own range
(``models/mapper.py::map_step_sharded``, a loop over the shards on one
device), and the per-shard best hits are merged here.

Determinism (DESIGN.md rule 15): each shard has a halo (>= corridor + read
length + max insert) so boundary loci are fully alignable, but a shard only
*owns* results whose position falls in its core range.  Halo duplicates are
masked out before the merge, and the merge key (score DESC, strand fwd
first, position ASC, shard ASC) makes the output independent of S.

Positions inside a shard are local int32, which is what makes genomes past
2^31 bases addressable.  Global positions exist only in the merge, as
int64 (the reference's uint32, whose arithmetic torch lacks), with the
sentinel 2^32 - 1 where a shard has no alignment.

Host part: ``shard_ranges``, ``ShardedIndex`` (build, the bisulfite
``build_dual``, the ``.ngmt-shards`` artifacts that ``ngm-tpu`` writes and
reads, byte for byte) and ``open_sharded``.  Device part: ``ShardTables``
(one stacked copy of the shards on the device), ``merge_sharded_results``
and ``merge_sharded_topn``.

On several devices, ``grid_layout`` places the shards on the columns of a
("dp", "ish") grid.  Across processes (``--shard-across-hosts``):
``global_ish_grid`` and ``local_shard_ids`` make that grid process-major,
``open_sharded_local``
loads (or builds) only a process's own shards from per-shard artifacts,
and ``ShardExchange`` holds the step's two collectives.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.index.kmer_index import KmerIndex
from nextgenmap_tpu_torch.io.encode import PAD
from nextgenmap_tpu_torch.native import hostio as native
from nextgenmap_tpu_torch.parallel.mesh import make_mesh
from nextgenmap_tpu_torch.utils.logging import get_logger

log = get_logger("ngm-torch.index")

UPOS_MAX = 2**32 - 1   # global position of "no alignment in this shard"


def shard_ranges(G: int, n_shards: int, halo: int):
    """Per-shard (lo, hi, core_l, core_h) over the standard contiguous split."""
    span = -(-G // n_shards)
    out = []
    for s in range(n_shards):
        core_l, core_h = s * span, min(G, (s + 1) * span)
        out.append((max(0, core_l - halo), min(G, core_h + halo),
                    core_l, core_h))
    return out


def _shard_pos_counts(positions: np.ndarray, G: int, n_shards: int,
                      halo: int, canonical: bool = False) -> np.ndarray:
    """Exact per-shard CSR entry counts (positions in [lo, hi)) in one
    histogram pass, so that a build of a subset of the shards still pads to
    the width of the widest one.  Canonical entries are (pos << 1) | flip,
    monotone in pos, so doubled bin edges range over the same positions."""
    ranges = shard_ranges(G, n_shards, halo)
    mul = 2 if canonical else 1
    edges = np.unique(
        np.array([b * mul for lo, hi, _, _ in ranges for b in (lo, hi)],
                 np.int64)
    )
    hist, _ = np.histogram(positions, bins=edges)
    cum = np.zeros(edges.shape[0], np.int64)
    np.cumsum(hist, out=cum[1:])
    at = lambda x: cum[np.searchsorted(edges, x * mul)]  # noqa: E731
    return np.array([at(hi) - at(lo) for lo, hi, _, _ in ranges], np.int64)


def _slice_csr_shards(index: KmerIndex, G: int, n_shards: int, halo: int,
                      shard_ids=None):
    """Slice one global CSR into per-shard (offsets int32, local positions
    int32) lists over the standard shard ranges.  Slicing the global CSR
    keeps repeat masking global: a shard never resurrects a k-mer that is
    over-frequent in the whole genome, which would make the output depend
    on S.  shard_ids selects a subset.

    Canonical CSRs slice with doubled bounds, and the rebase
    `entry - (lo << 1)` keeps the flip bit: local canonical entries fit
    int32 even where the global (pos << 1) would not.  The native passes
    stream the CSR once per shard; the numpy route gives the same arrays."""
    mul = 2 if index.canonical else 1
    nb = index.n_buckets
    use_native = native.lib() is not None
    if not use_native:
        row_id = np.repeat(
            np.arange(nb, dtype=np.int64), np.diff(index.offsets)
        )
        pos_all = index.positions.astype(np.int64)

    ranges = shard_ranges(G, n_shards, halo)
    offs, poss = [], []
    for s in (range(n_shards) if shard_ids is None else shard_ids):
        lo, hi, _, _ = ranges[s]
        if use_native:
            off, local = native.shard_csr(index.offsets, index.positions,
                                          lo * mul, hi * mul)
        else:
            m = (pos_all >= lo * mul) & (pos_all < hi * mul)
            counts = np.bincount(row_id[m], minlength=nb)
            off = np.zeros(nb + 1, dtype=np.int64)
            np.cumsum(counts, out=off[1:])
            local = (pos_all[m] - lo * mul).astype(np.int32)
        offs.append(off.astype(np.int32))
        poss.append(local)
    return offs, poss


@dataclass
class ShardedIndex:
    """Host-side per-shard genome slices and CSR tables, stacked along a
    leading shard axis."""

    n_shards: int
    genome: np.ndarray      # [S', Gs] uint8 (PAD-padded slices)
    offsets: np.ndarray     # [S', 4^k+1] int32 (dual: [S', 2*(4^k+1)])
    positions: np.ndarray   # [S', Pmax] int32 (local coords, 0-padded)
    base: np.ndarray        # [S] uint32 global position of slice start
    core_lo: np.ndarray     # [S] uint32 ownership range
    core_hi: np.ndarray     # [S] uint32  (genome must be < 2^32 bases)
    max_freq: int = 0       # repeat-mask cap baked into the shard CSRs
    dual: bool = False      # bisulfite: CT + GA collapsed tables concatenated
                            # per shard (the Mapper's dual-table layout)
    canonical: bool = False  # positions are local (pos << 1) | flip entries
    shard_ids: np.ndarray | None = None
                            # a subset build: the global shard ids the S'
                            # rows hold (base/core_lo/core_hi stay full [S]);
                            # None = all S.  Gs/Pmax are the global maxima.

    @classmethod
    def build(
        cls, index: KmerIndex, genome_codes: np.ndarray, n_shards: int,
        halo: int, shard_ids=None,
    ) -> "ShardedIndex":
        """Split a built global index into position-range shards."""
        G = genome_codes.shape[0]
        offs, poss = _slice_csr_shards(index, G, n_shards, halo, shard_ids)
        pm = None
        if shard_ids is not None:
            pm = int(
                _shard_pos_counts(index.positions, G, n_shards, halo,
                                  canonical=index.canonical).max()
            )
        return cls._assemble(genome_codes, n_shards, halo, offs, poss,
                             index.max_freq, dual=False,
                             shard_ids=shard_ids, pm_global=pm,
                             canonical=index.canonical)

    @classmethod
    def build_dual(
        cls, index_ct: KmerIndex, index_ga: KmerIndex,
        genome_codes: np.ndarray, n_shards: int, halo: int, shard_ids=None,
    ) -> "ShardedIndex":
        """Bisulfite sharding: slice both collapsed CSRs by the same ranges,
        then concatenate per shard as the unsharded dual-table layout does
        (offsets = [ct | ga + n_ct], positions = [ct | ga])."""
        G = genome_codes.shape[0]
        offs_ct, poss_ct = _slice_csr_shards(index_ct, G, n_shards, halo,
                                             shard_ids)
        offs_ga, poss_ga = _slice_csr_shards(index_ga, G, n_shards, halo,
                                             shard_ids)
        offs = [
            np.concatenate([o1, o2 + np.int32(p1.shape[0])])
            for o1, o2, p1 in zip(offs_ct, offs_ga, poss_ct)
        ]
        poss = [
            np.concatenate([p1, p2]) for p1, p2 in zip(poss_ct, poss_ga)
        ]
        pm = None
        if shard_ids is not None:
            pm = int((
                _shard_pos_counts(index_ct.positions, G, n_shards, halo)
                + _shard_pos_counts(index_ga.positions, G, n_shards, halo)
            ).max())
        return cls._assemble(genome_codes, n_shards, halo, offs, poss,
                             index_ct.max_freq, dual=True,
                             shard_ids=shard_ids, pm_global=pm)

    @classmethod
    def _assemble(cls, genome_codes, n_shards, halo, offs, poss, max_freq,
                  dual, shard_ids=None, pm_global=None, canonical=False):
        G = genome_codes.shape[0]
        ranges = shard_ranges(G, n_shards, halo)
        own = list(range(n_shards)) if shard_ids is None else list(shard_ids)
        gs = max(hi - lo for lo, hi, _, _ in ranges)
        pm = max(1, max((x.shape[0] for x in poss), default=1)
                 if pm_global is None else pm_global)
        genome = np.full((len(own), gs), PAD, dtype=np.uint8)
        positions = np.zeros((len(own), pm), dtype=np.int32)
        for i, s in enumerate(own):
            lo, hi = ranges[s][:2]
            genome[i, : hi - lo] = genome_codes[lo:hi]
            positions[i, : poss[i].shape[0]] = poss[i]
        return cls(
            n_shards=n_shards,
            genome=genome,
            offsets=np.stack(offs),
            positions=positions,
            base=np.asarray([r[0] for r in ranges], np.uint32),
            core_lo=np.asarray([r[2] for r in ranges], np.uint32),
            core_hi=np.asarray([r[3] for r in ranges], np.uint32),
            max_freq=max_freq,
            dual=dual,
            canonical=canonical,
            shard_ids=None if shard_ids is None else np.asarray(own, np.int32),
        )

    # the supported read-length ceiling (the reference maps ~36-1000 bp)
    MAX_READ_LEN = 1024

    @staticmethod
    def halo_for(cfg: NgmConfig) -> int:
        """Shard overlap so boundary loci are fully alignable and pairable.

        Sized for MAX_READ_LEN and a pair, not the reads at hand: results
        do not depend on the halo (ownership is by core range), and a fixed
        halo lets `index --index-shards N` build the artifact before any
        read is seen.  The reference's halo_for with its defaults."""
        L = ShardedIndex.MAX_READ_LEN
        return L + cfg.corridor_for(L) + cfg.max_insert_size

    # -- memoization (the shard split of a gigabase CSR is slow next to
    # loading its artifact) --
    SHARDS_VERSION = 2  # v2: dual (bisulfite) flag in meta

    @staticmethod
    def cache_path(fasta_path: str, k: int, skip: int, n_shards: int,
                   halo: int, max_freq: int, dual: bool = False,
                   canonical: bool = False) -> str:
        # every parameter that changes the shard CSR bytes keys the artifact
        bs = "-bs" if dual else ""
        cn = "-c" if canonical else ""
        return (f"{fasta_path}.ngmt-shards-{k}-{skip}-s{n_shards}-h{halo}"
                f"-f{max_freq}{bs}{cn}.v{ShardedIndex.SHARDS_VERSION}.npz")

    def _meta(self, genome_sha1: str) -> np.ndarray:
        meta = (f"{self.n_shards}|{self.max_freq}|{int(self.dual)}|"
                f"{genome_sha1}|{int(self.canonical)}")
        return np.frombuffer(meta.encode(), dtype=np.uint8)

    def save(self, path: str, genome_sha1: str) -> None:
        np.savez(
            path, genome=self.genome, offsets=self.offsets,
            positions=self.positions, base=self.base,
            core_lo=self.core_lo, core_hi=self.core_hi,
            meta=self._meta(genome_sha1),
        )

    @classmethod
    def load(cls, path: str, genome_sha1: str,
             max_freq: int | None = None) -> "ShardedIndex | None":
        """The artifact at `path`, or None when it is stale (another
        genome, another repeat-mask cap, an unknown layout)."""
        with np.load(path) as z:
            meta = bytes(z["meta"]).decode().split("|")
            if len(meta) not in (4, 5):
                return None
            n_shards, mf, dual, sha = meta[:4]
            canon = bool(int(meta[4])) if len(meta) == 5 else False
            if sha != genome_sha1:
                return None
            if max_freq is not None and int(mf) != max_freq:
                return None
            return cls(
                n_shards=int(n_shards), genome=z["genome"],
                offsets=z["offsets"], positions=z["positions"],
                base=z["base"], core_lo=z["core_lo"], core_hi=z["core_hi"],
                max_freq=int(mf), dual=bool(int(dual)), canonical=canon,
            )

    # -- per-shard artifacts (a process that holds one shard loads only its
    # own) --

    @staticmethod
    def shard_cache_path(fasta_path: str, s: int, k: int, skip: int,
                         n_shards: int, halo: int, max_freq: int,
                         dual: bool = False, canonical: bool = False) -> str:
        bs = "-bs" if dual else ""
        cn = "-c" if canonical else ""
        return (f"{fasta_path}.ngmt-shard{s}of{n_shards}-{k}-{skip}-h{halo}"
                f"-f{max_freq}{bs}{cn}.v{ShardedIndex.SHARDS_VERSION}.npz")

    def save_shards(self, path_for, genome_sha1: str) -> None:
        """Write one artifact per owned shard row (path_for(s) -> path),
        each with the full [S] range metadata and the global widths."""
        own = (range(self.n_shards) if self.shard_ids is None
               else self.shard_ids)
        for i, s in enumerate(own):
            np.savez(
                path_for(int(s)),
                genome=self.genome[i], offsets=self.offsets[i],
                positions=self.positions[i], base=self.base,
                core_lo=self.core_lo, core_hi=self.core_hi,
                shard=np.int64(s), meta=self._meta(genome_sha1),
            )

    @classmethod
    def load_shards(cls, paths: list[str], shard_ids, genome_sha1: str,
                    max_freq: int | None = None) -> "ShardedIndex | None":
        """The shards `shard_ids` from their per-shard artifacts (either
        package's), or None unless every one exists and matches."""
        rows = []
        for p in paths:
            if not os.path.exists(p):
                return None
            with np.load(p) as z:
                meta = bytes(z["meta"]).decode().split("|")
                if len(meta) not in (4, 5) or meta[3] != genome_sha1:
                    return None
                if max_freq is not None and int(meta[1]) != max_freq:
                    return None
                rows.append({k: z[k] for k in z.files if k != "meta"}
                            | {"n_shards": int(meta[0]),
                               "max_freq": int(meta[1]),
                               "dual": bool(int(meta[2])),
                               "canonical": (bool(int(meta[4]))
                                             if len(meta) == 5 else False)})
        r0 = rows[0]
        return cls(
            n_shards=r0["n_shards"],
            genome=np.stack([r["genome"] for r in rows]),
            offsets=np.stack([r["offsets"] for r in rows]),
            positions=np.stack([r["positions"] for r in rows]),
            base=r0["base"], core_lo=r0["core_lo"], core_hi=r0["core_hi"],
            max_freq=r0["max_freq"], dual=r0["dual"],
            canonical=r0["canonical"],
            shard_ids=np.asarray(list(shard_ids), np.int32),
        )

    def own_ids(self) -> list[int]:
        """The global shard ids of the rows held here."""
        return (list(range(self.n_shards)) if self.shard_ids is None
                else [int(s) for s in self.shard_ids])


def open_sharded(cfg: NgmConfig, ref_path: str, genome, index) -> ShardedIndex:
    """Build or load the memoized shard artifact (.ngmt-shards).

    `index` is a host KmerIndex or, for bisulfite, a (CT, GA) pair.  Shared
    by `ngm-torch index --index-shards N` and the mapping run."""
    dual = isinstance(index, tuple)
    canonical = (not dual) and index.canonical
    halo = ShardedIndex.halo_for(cfg)
    cache = ShardedIndex.cache_path(
        ref_path, cfg.kmer, cfg.kmer_skip, cfg.index_shards, halo,
        cfg.max_kmer_freq, dual=dual, canonical=canonical,
    )
    if os.path.exists(cache):
        sidx = ShardedIndex.load(cache, genome.sha1(),
                                 max_freq=cfg.max_kmer_freq)
        if sidx is not None:
            log.info("loaded sharded index from %s", cache)
            return sidx
    if dual:
        sidx = ShardedIndex.build_dual(
            *index, genome.codes, cfg.index_shards, halo
        )
    else:
        sidx = ShardedIndex.build(index, genome.codes, cfg.index_shards, halo)
    if not cfg.skip_save:
        try:
            sidx.save(cache, genome.sha1())
            log.info("memoized sharded index to %s", cache)
        except OSError as e:
            log.warning("could not memoize sharded index: %s", e)
    return sidx


def global_ish_grid(n_shards: int, nprocs: int, n_local: int) -> np.ndarray:
    """The ("dp", "ish") grid across processes: [dp, S] global slot ranks
    (process p's local slot i is rank p * n_local + i).

    The shard axis is process-major: a process's slots cover only its own
    S / P shard columns, so it holds only those shards, and its remaining
    slots form the dp rows (reads in parallel).  The reference's
    global_ish_mesh, refusals included; the merged output is the same on
    every process."""
    if n_shards % nprocs:
        raise ValueError(
            f"index_shards={n_shards} must be a multiple of the process "
            f"count {nprocs} (each host holds the same number of shards)")
    sph = n_shards // nprocs                 # shards per process
    if n_local % sph:
        raise ValueError(
            f"local device count {n_local} not divisible by "
            f"shards-per-host {sph}")
    dp = n_local // sph
    ranks = np.arange(nprocs * n_local)
    return ranks.reshape(nprocs, sph, dp).transpose(2, 0, 1).reshape(
        dp, n_shards)


def local_shard_ids(grid: np.ndarray, procid: int, n_local: int) -> list[int]:
    """Global shard ids whose column holds a slot of process `procid`."""
    return sorted({int(s) for d in range(grid.shape[0])
                   for s in range(grid.shape[1])
                   if grid[d, s] // n_local == procid})


def grid_layout(cfg: NgmConfig, slots: list) -> tuple | None:
    """The ("dp", "ish") grid of a sharded run on `slots`: (rows [dp][S']
    of devices, the global shard id of each column), or None for the shard
    loop on one device.  With --shard-across-hosts the process-major grid of
    global_ish_grid, this process's columns only; else make_mesh's [dp, S].
    The reference's refusals, raised before any process joins another."""
    S, n = cfg.index_shards, len(slots)
    if cfg.shard_hosts:
        ranks = global_ish_grid(S, cfg.dist_nprocs, n)
        own = local_shard_ids(ranks, cfg.dist_procid, n)
        return [[slots[ranks[d, s] % n] for s in own]
                for d in range(ranks.shape[0])], own
    if n == 1:
        return None
    if n % S:
        raise ValueError(
            f"index_shards={S} needs 1 device (sequential) or a device "
            f"count divisible by {S}, got {n}")
    return make_mesh(slots, index_shards=S).tolist(), list(range(S))


def open_sharded_local(cfg: NgmConfig, ref_path: str, genome,
                       shard_ids) -> ShardedIndex:
    """Build or load ONLY this process's shards (--shard-across-hosts).

    The per-shard artifacts (`index --index-shards N` of either package
    writes every one) are loaded when they exist, so the process never
    touches the global index.  Otherwise the global host index is built (or
    loaded), this process's shards are sliced from it and memoized as
    per-shard artifacts."""
    dual = cfg.bs_mapping
    halo = ShardedIndex.halo_for(cfg)
    S = cfg.index_shards
    # canonical entries need global (pos << 1) | flip to fit uint32 in the
    # host build; past 2^31 bases it takes raw positions
    canonical = (not dual) and genome.codes.shape[0] < 2**31

    def path_for(s):
        return ShardedIndex.shard_cache_path(
            ref_path, s, cfg.kmer, cfg.kmer_skip, S, halo, cfg.max_kmer_freq,
            dual=dual, canonical=canonical)

    sidx = ShardedIndex.load_shards(
        [path_for(s) for s in shard_ids], shard_ids, genome.sha1(),
        max_freq=cfg.max_kmer_freq)
    if sidx is not None:
        log.info("loaded own index shards %s from per-shard artifacts",
                 list(shard_ids))
        return sidx

    def host_index(collapse="none", **kw):
        return KmerIndex.open(
            ref_path, genome.codes, genome.sha1(), k=cfg.kmer,
            skip=cfg.kmer_skip, max_freq=cfg.max_kmer_freq, collapse=collapse,
            skip_save=cfg.skip_save, **kw)

    if dual:
        sidx = ShardedIndex.build_dual(
            host_index("ct"), host_index("ga"), genome.codes, S, halo,
            shard_ids=shard_ids)
    else:
        sidx = ShardedIndex.build(
            host_index(canonical=True, allow_u32=True), genome.codes, S, halo,
            shard_ids=shard_ids)
    if not cfg.skip_save:
        try:
            sidx.save_shards(path_for, genome.sha1())
            log.info("memoized own index shards %s", list(shard_ids))
        except OSError as e:
            log.warning("could not memoize index shards: %s", e)
    return sidx


def log_local_shards(sidx: ShardedIndex) -> None:
    """The memory account of a process that holds a subset of the shards:
    its bytes against those of all S."""
    own = sidx.own_ids()
    local_bytes = (sidx.genome.nbytes + sidx.offsets.nbytes
                   + sidx.positions.nbytes)
    full_bytes = local_bytes * sidx.n_shards // max(1, len(own))
    log.info(
        "cross-host index shards: this host holds shards %s = %.1f MB of "
        "%.1f MB total (%d/%d shards)",
        own, local_bytes / 1e6, full_bytes / 1e6, len(own), sidx.n_shards)


class ShardExchange:
    """The two collectives of the cross-process ("dp", "ish") step, in one
    place: the MAX of the per-read best bucket counts over every shard, and
    the gather of every process's per-shard results.  They run on host
    tensors in the default torch.distributed group (gloo), one call each
    per batch; with one process both are the identity."""

    def __init__(self, nprocs: int):
        self.nprocs = nprocs

    def max_best(self, best: torch.Tensor) -> torch.Tensor:
        """[B] int32 on the host: the maximum over all processes."""
        if self.nprocs > 1:
            import torch.distributed as dist

            dist.all_reduce(best, op=dist.ReduceOp.MAX)
        return best

    def gather_shards(self, stk):
        """A NamedTuple of host tensors whose leading axis is this
        process's shards -> the same over all S shards, process-major (the
        global shard order).  One all_gather of the fields packed as bytes."""
        if self.nprocs == 1:
            return stk
        import torch.distributed as dist

        fields = [t.contiguous() for t in stk]
        flat = torch.cat([t.reshape(-1).view(torch.uint8) for t in fields])
        got = [torch.empty_like(flat) for _ in range(self.nprocs)]
        dist.all_gather(got, flat)
        out = []
        at = 0
        for t in fields:
            n = t.numel() * t.element_size()
            # a copy starts at offset 0, so any dtype can view it
            parts = [g[at:at + n].clone().view(t.dtype).reshape(t.shape)
                     for g in got]
            out.append(torch.cat(parts))
            at += n
        return type(stk)(*out)


class ShardTables(NamedTuple):
    """A ShardedIndex on the device: one stacked copy, so that a shard's
    tables are row views of it and the stacked genome flattens to one
    [S * Gs] table without a copy."""

    genome: torch.Tensor     # [S, Gs] uint8
    offsets: torch.Tensor    # [S, nb + 1] int32 (dual: [S, 2 (nb + 1)])
    positions: torch.Tensor  # [S, Pmax] int32
    base: torch.Tensor       # [S] int64
    core_lo: torch.Tensor    # [S] int64
    core_hi: torch.Tensor    # [S] int64

    @classmethod
    def from_index(cls, sidx: ShardedIndex, device) -> "ShardTables":
        def to(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        return cls(to(sidx.genome, np.uint8), to(sidx.offsets, np.int32),
                   to(sidx.positions, np.int32), to(sidx.base, np.int64),
                   to(sidx.core_lo, np.int64), to(sidx.core_hi, np.int64))


def _lex_winner(sc, st, gp):
    """Lexicographic argmax over the leading shard axis:
    (score DESC, strand fwd first, global position ASC, shard ASC)."""
    best_sc = sc.max(dim=0).values
    cand = sc == best_sc
    st_m = torch.where(cand, st, 2)
    cand &= st_m == st_m.min(dim=0).values
    gp_m = torch.where(cand, gp, UPOS_MAX)
    cand &= gp_m == gp_m.min(dim=0).values
    return _first_true(cand), best_sc


def _first_true(mask):
    """Index of the first True along dim 0 (the lowest shard)."""
    return torch.argmax(mask.to(torch.uint8), dim=0)


def _take_shard(field_all, winner):
    """field_all [S, B, ...] -> [B, ...], shard winner[b] for read b."""
    return field_all[winner, torch.arange(winner.shape[0],
                                          device=winner.device)]


def _mapq(s1, s2, mapped):
    """MAPQ as _finish computes it: float32, round half to even."""
    f32 = torch.float32
    mapq = torch.round(60.0 * (s1 - s2).to(f32) / s1.clamp(min=1).to(f32))
    return torch.where(mapped, mapq.clamp(0, 60).to(torch.int32), 0)


def _global_positions(stk, base, core_lo, core_hi):
    """(int64 global positions, ownership mask) of per-shard results whose
    leading axis is the shard; `has` = the shard found an alignment."""
    extra = (1,) * (stk.score.dim() - 1)
    has = stk.score > 0
    gpos = torch.where(has, base.view(-1, *extra) + stk.pos.long(), UPOS_MAX)
    own = (has & (gpos >= core_lo.view(-1, *extra))
           & (gpos < core_hi.view(-1, *extra)))
    return gpos, own


def merge_sharded_results(stk, base, core_lo, core_hi, *, paired: bool,
                          read_len: int):
    """Merge per-shard MapResults (fields [S, B, ...]) into the global one.

    Ownership is by the raw score and the core range (not the post-filter
    `mapped`): the unsharded step takes the SW argmax first and filters the
    winner only, and its MAPQ second-best counts unfiltered candidates.
    Merge key: score DESC, strand fwd first, global position ASC, shard
    ASC.  The merged `pos` is the int64 global position; the two overflow
    counters are summed over the shards (int32)."""
    L = read_len
    S, B = stk.score.shape
    gpos, own = _global_positions(stk, base, core_lo, core_hi)
    sc_all = torch.where(own, stk.score, -1)
    st_all = torch.where(own, stk.strand, 2)
    gp_all = torch.where(own, gpos, UPOS_MAX)
    winner, _ = _lex_winner(sc_all, st_all, gp_all)
    # the winner's score and position: its owned ones, or for a pair taken
    # whole from one shard (below) its raw ones
    win_sc_all, win_gp_all = sc_all, gp_all

    if paired:
        # a proper pair is owned through mate 1's position; if any shard
        # resolved the pair properly, both mates come from the (combined
        # DESC, pos1 ASC, shard ASC) winner, else the mates merge apart
        Pn = B // 2
        s_pair = sc_all.reshape(S, Pn, 2)
        prop = stk.proper.reshape(S, Pn, 2)
        own1 = own.reshape(S, Pn, 2)[:, :, 0]
        pair_ok = prop[:, :, 0] & prop[:, :, 1] & own1
        comb_all = torch.where(pair_ok, s_pair[:, :, 0] + s_pair[:, :, 1], -1)
        gp1_all = torch.where(pair_ok, gpos.reshape(S, Pn, 2)[:, :, 0],
                              UPOS_MAX)
        best_comb = comb_all.max(dim=0).values
        candp = comb_all == best_comb
        gp1_m = torch.where(candp, gp1_all, UPOS_MAX)
        candp &= gp1_m == gp1_m.min(dim=0).values
        winner_pair = _first_true(candp)
        whole = (best_comb > 0).repeat_interleave(2)
        winner = torch.where(whole, winner_pair.repeat_interleave(2), winner)
        # mate 2 of a pair taken whole may lie outside the winner shard's
        # core (the pair straddles a core boundary, both mates in the
        # halo): it is the winner's all the same.  The reference reads its
        # score through the ownership mask (-1), so the mate comes out
        # unmapped with MAPQ 0 where the unsharded run maps it (ROADMAP C7);
        # the port keeps the mate, as the unsharded run does
        win_sc_all = torch.where(whole[None], stk.score, sc_all)
        win_gp_all = torch.where(whole[None], gpos, gp_all)

    # global second best for MAPQ: other shards' best at a different locus,
    # or the winner shard's own local second
    win_gp = _take_shard(win_gp_all, winner)
    win_sc = _take_shard(win_sc_all, winner)
    far = (gp_all - win_gp[None]).abs() > L
    s2_other = torch.where(far, sc_all, 0).max(dim=0).values
    s2 = torch.maximum(s2_other, _take_shard(stk.second, winner))

    merged = {}
    for name in stk._fields:
        val = getattr(stk, name)
        if name in ("fanout_overflow", "cmr_overflow"):
            merged[name] = val.sum(dtype=torch.int32)
        else:
            merged[name] = _take_shard(gpos if name == "pos" else val, winner)
    mapped = merged["mapped"] & (win_sc > 0)
    merged["mapped"] = mapped
    merged["second"] = s2
    merged["mapq"] = _mapq(win_sc, s2, mapped)
    merged["proper"] = merged["proper"] & mapped
    return stk._replace(**merged)


def merge_sharded_topn(stk, base, core_lo, core_hi, *, topn: int,
                       read_len: int) -> tuple:
    """Merge per-shard top-n MapResults (fields [S, R, B, ...]) into global
    rank lists: `topn` MapResults, rank 0 first.

    Exact because every owned candidate that belongs in the global top R is
    in its own shard's top R (the shards rank by the same keys):
    interleaving the S*R owned entries by (score DESC, strand fwd first,
    global position ASC, then shard ASC, rank ASC) and keeping the first R
    reproduces the unsharded ranking.  The interleave is three stable sorts
    from the last key to the first, so ties keep the entry order.  MAPQ's
    second best mirrors merge_sharded_results."""
    L = read_len
    S, R, B = stk.score.shape
    E = S * R
    gpos, own = _global_positions(stk, base, core_lo, core_hi)

    def as_be(x):                                   # [S, R, B] -> [B, E]
        return x.reshape(E, B).T

    sc_e = as_be(torch.where(own, stk.score, -1))
    st_e = as_be(torch.where(own, stk.strand, 2))
    gp_e = as_be(torch.where(own, gpos, UPOS_MAX))
    order = torch.arange(E, device=sc_e.device).expand(B, E)
    for key in (gp_e, st_e, -sc_e):
        step = torch.sort(torch.gather(key, 1, order), dim=1,
                          stable=True).indices
        order = torch.gather(order, 1, step)
    sel = order[:, :R]                                           # [B, R]
    brow = torch.arange(B, device=sc_e.device)[:, None]

    def take(x):                     # [S, R, B, ...] -> [B, R, ...]
        return x.reshape((E, B) + x.shape[3:])[sel, brow]

    win_sc = take(torch.where(own, stk.score, 0))
    win_gp = take(gpos)
    far = (gp_e[:, None, :] - win_gp[:, :, None]).abs() > L      # [B, R, E]
    s2_other = torch.where(far & (sc_e[:, None, :] > 0), sc_e[:, None, :],
                           0).max(dim=2).values
    s2 = torch.maximum(s2_other, take(stk.second))               # [B, R]

    fan_ovf = stk.fanout_overflow[:, 0].sum(dtype=torch.int32)
    cmr_ovf = stk.cmr_overflow[:, 0].sum(dtype=torch.int32)
    results = []
    for j in range(R):
        fields = {}
        for name in stk._fields:
            if name in ("fanout_overflow", "cmr_overflow"):
                continue
            val = gpos if name == "pos" else getattr(stk, name)
            fields[name] = take(val)[:, j]
        mapped = fields["mapped"] & (win_sc[:, j] > 0)
        fields["mapped"] = mapped
        fields["second"] = s2[:, j]
        fields["mapq"] = _mapq(win_sc[:, j], s2[:, j], mapped)
        results.append(type(stk)(fanout_overflow=fan_ovf,
                                 cmr_overflow=cmr_ovf, **fields))
    return tuple(results)
