"""``ngm-torch``: the PyTorch port's command line.

``build_parser`` and ``config_from_args`` are the port's copy of
``nextgenmap_tpu/cli.py``'s: the same `map` and `index` flags, mapped onto
the same ``NgmConfig``, plus ``--device`` (default ``cuda``; ``cpu`` runs
the plain PyTorch path).

    python -m nextgenmap_tpu_torch.cli map -r ref.fa -q reads.fq -o out.sam
    python -m nextgenmap_tpu_torch.cli map -r ref.fa -1 r1.fq -2 r2.fq -o pe.sam
    python -m nextgenmap_tpu_torch.cli map -r ref.fa -q reads.fq -n 2 -o top2.sam
    python -m nextgenmap_tpu_torch.cli map -r ref.fa -q r.fq --index-shards 4 -o o.sam
    python -m nextgenmap_tpu_torch.cli index -r ref.fa [--index-shards 4]

Modes, with every one of the above: ``--end-to-end`` (glocal alignment, no
clipping), ``--bs-mapping [--bs-cutoff N]`` (bisulfite: CT/GA-collapsed
tables and conversion-tolerant scoring), ``--slam-seq 1|2``.  Reads up to
1000 bp map with the default batch shrunk as the read length grows.
``--index-shards N`` splits the index into N position ranges mapped one
after the other on the device, which is how a genome of 2^31 bases or more
maps; ``index`` builds the host index and the shard artifacts ahead of a
mapping run.

Runtime, with any of the above: ``-t N`` overlaps parsing, the device step
and SAM formatting (a parse thread; an emitter thread at 2; N - 1 render
threads at 3 or more), ``--megabatch K`` dispatches K batches before
fetching them, ``--bam -o out.bam`` writes BAM, ``-q reads.bam`` reads it,
``--resume`` continues an interrupted run from its
``<out>.ngmt-progress.json`` sidecar, and ``--profile DIR`` writes a
torch.profiler trace of the mapping loop into DIR.

Several devices and processes, with any of the above: ``--devices N`` (or
``-g 0,1,..``; 0 = every card) splits each batch over N cards (with
``--device cpu``, N slots of the CPU), and with ``--index-shards S`` forms
the [N / S, S] grid of reads by shards.  ``--dist-nprocs N --dist-procid
I`` runs process I of N: it maps every N-th batch into
``<out>.partI-of-N``, and process 0 merges the parts into ``-o`` (not with
``--no-merge``).  ``--shard-across-hosts --index-shards S --dist-nprocs N
--dist-coordinator HOST:PORT`` splits the index over the N processes
instead: each holds S / N shards, every process maps every batch, and
process 0 writes the output.

    python -m nextgenmap_tpu_torch.cli map -r ref.fa -q r.fq -o o.sam --devices 2
    python -m nextgenmap_tpu_torch.cli map -r ref.fa -q r.fq -o o.sam \
        --dist-nprocs 2 --dist-procid 0      # and --dist-procid 1 beside it
    python -m nextgenmap_tpu_torch.cli map -r ref.fa -q r.fq -o o.sam \
        --shard-across-hosts --index-shards 2 --dist-nprocs 2 \
        --dist-procid 0 --dist-coordinator 127.0.0.1:29500   # and procid 1
"""

from __future__ import annotations

import argparse
import shlex
import sys

from nextgenmap_tpu_torch.config import NgmConfig


def build_parser() -> tuple[argparse.ArgumentParser, argparse.ArgumentParser]:
    """(parser, its `map` subparser) with ngm-tpu's `map` and `index` flag
    surfaces."""
    D = NgmConfig()  # single source of truth for every default

    p = argparse.ArgumentParser(
        prog="ngm-torch",
        description="NextGenMap-style short-read mapper (PyTorch/CUDA port)",
    )
    sub = p.add_subparsers(dest="verb")
    sp = sub.add_parser("map", help="map reads (default verb)")

    g = sp.add_argument_group("input/output")
    g.add_argument("-r", "--reference", required=True)
    g.add_argument("-q", "--qry")
    g.add_argument("-1", "--qry1", dest="qry1")
    g.add_argument("-2", "--qry2", dest="qry2")
    g.add_argument("-p", "--paired", action="store_true",
                   help="interleaved paired-end input via -q")
    g.add_argument("-o", "--output")
    g.add_argument("--bam", action="store_true")
    g.add_argument("--no-unal", action="store_true")
    g.add_argument("--hard-clip", action="store_true")
    g.add_argument("--silent-clip", action="store_true")
    g.add_argument("--rg-id", default="")
    g.add_argument("--rg-sm", default="")
    g.add_argument("--rg-lb", default="")
    g.add_argument("--rg-pl", default="")
    g.add_argument("--rg-pu", default="")
    g.add_argument("--skip-save", action="store_true")

    g = sp.add_argument_group("index")
    g.add_argument("-k", "--kmer", type=int, default=D.kmer)
    g.add_argument("--kmer-skip", type=int, default=D.kmer_skip)
    g.add_argument("--read-kmer-skip", type=int, default=None,
                   help="read-side k-mer stride (default: config; drops "
                        "to 1 automatically when --kmer-skip > 1)")
    g.add_argument("--kmer-min", type=int, default=D.kmer_min)
    g.add_argument("--max-freq", type=int, default=D.max_kmer_freq)
    g.add_argument("--max-cmrs", type=int, default=D.max_cmrs)
    g.add_argument("--max-read-hits", type=int, default=D.max_read_hits,
                   help="per-read index-hit cap (0 = auto from genome size)")
    g.add_argument("--index-shards", type=int, default=D.index_shards,
                   help="split the index/genome into N position-range shards")

    g = sp.add_argument_group("sensitivity/filters")
    g.add_argument("-s", "--sensitivity", type=float, default=D.sensitivity)
    g.add_argument("-i", "--min-identity", type=float, default=D.min_identity)
    g.add_argument("-R", "--min-residues", type=float, default=D.min_residues)
    g.add_argument("-n", "--topn", type=int, default=D.topn)
    g.add_argument("--strata", action="store_true")

    g = sp.add_argument_group("scoring")
    g.add_argument("--match-bonus", type=int, default=D.match_bonus)
    g.add_argument("--mismatch-penalty", type=int, default=D.mismatch_penalty)
    g.add_argument("--gap-read-penalty", type=int, default=D.gap_read_penalty)
    g.add_argument("--gap-ref-penalty", type=int, default=D.gap_ref_penalty)
    g.add_argument("--gap-extend-penalty", type=int,
                   default=D.gap_extend_penalty)
    g.add_argument("--affine", action="store_true",
                   help="accepted for reference compatibility: the banded "
                        "SW is ALWAYS affine (gap open >= gap extend)")
    g.add_argument("--end-to-end", action="store_true",
                   help="whole-read (glocal) alignment, no soft clipping")
    g.add_argument("--sw-backend", choices=["xla", "pallas"],
                   default=D.sw_backend,
                   help="accepted for ngm-tpu compatibility; the port has "
                        "one SW kernel")

    g = sp.add_argument_group("paired-end")
    g.add_argument("-I", "--min-insert-size", type=int, default=D.min_insert_size)
    g.add_argument("-X", "--max-insert-size", type=int, default=D.max_insert_size)
    g.add_argument("--pair-score-cutoff", type=float,
                   default=D.pair_score_cutoff)

    g = sp.add_argument_group("modes")
    g.add_argument("--bs-mapping", action="store_true")
    g.add_argument("--bs-cutoff", type=int, default=D.bs_cutoff)
    g.add_argument("--slam-seq", type=int, default=0, choices=[0, 1, 2])

    g = sp.add_argument_group("runtime")
    g.add_argument("-t", "--threads", type=int, default=D.threads)
    g.add_argument("--devices", type=int, default=D.devices,
                   help="devices for data-parallel mapping (0 = all)")
    g.add_argument("-g", "--gpu", metavar="IDS", default=None,
                   help="reference-compatible accelerator selector "
                        "(comma-separated ids); only the count is used")
    g.add_argument("--batch-size", type=int, default=D.batch_size)
    g.add_argument("--megabatch", type=int, default=D.megabatch)
    g.add_argument("--read-len", type=int, default=0,
                   help="static padded read length (0 = infer)")
    g.add_argument("--corridor", type=int, default=0)
    g.add_argument("--no-progress", action="store_true")
    g.add_argument("--qry-start", type=int, default=0,
                   help="skip the first N input reads")
    g.add_argument("--qry-count", type=int, default=0,
                   help="map at most N reads (0 = all)")
    g.add_argument("--resume", action="store_true")
    g.add_argument("--profile", metavar="DIR", default="")

    g = sp.add_argument_group("multi-host")
    g.add_argument("--dist-nprocs", type=int, default=D.dist_nprocs)
    g.add_argument("--dist-procid", type=int, default=D.dist_procid)
    g.add_argument("--dist-coordinator", default="")
    g.add_argument("--no-merge", action="store_true")
    g.add_argument("--shard-across-hosts", action="store_true")

    sp.add_argument("--device", default="cuda",
                    help="torch device to map on: cuda (default) or cpu")

    ip = sub.add_parser("index", help="build (and memoize) the index only")
    ip.add_argument("-r", "--reference", required=True)
    ip.add_argument("-k", "--kmer", type=int, default=D.kmer)
    ip.add_argument("--kmer-skip", type=int, default=D.kmer_skip)
    ip.add_argument("--max-freq", type=int, default=D.max_kmer_freq)
    ip.add_argument("--bs-mapping", action="store_true")
    ip.add_argument("--index-shards", type=int, default=D.index_shards,
                    help="also build the .ngmt-shards artifact (and one per "
                         "shard), so that `map --index-shards N` does no "
                         "index work")
    ip.add_argument("-X", "--max-insert-size", type=int,
                    default=D.max_insert_size,
                    help="keys the shard halo; use the same value at map "
                         "time to reuse the artifact")
    return p, sp


def config_from_args(a) -> NgmConfig:
    """The NgmConfig of parsed `map` arguments (ngm-tpu's mapping)."""
    devices = a.devices
    if getattr(a, "gpu", None):
        # -g takes explicit device ids; only the COUNT carries over
        devices = len([x for x in a.gpu.split(",") if x != ""])
    rks = a.read_kmer_skip
    if rks is None:
        # reference-style genome striding (--kmer-skip > 1) implies stride-1
        # read enumeration; otherwise use the read-side default
        rks = 1 if a.kmer_skip > 1 else NgmConfig().read_kmer_skip
    return NgmConfig(
        kmer=a.kmer, kmer_skip=a.kmer_skip, read_kmer_skip=rks,
        kmer_min=a.kmer_min,
        max_kmer_freq=a.max_freq, max_cmrs=a.max_cmrs,
        max_read_hits=a.max_read_hits,
        sensitivity=a.sensitivity, min_identity=a.min_identity,
        min_residues=a.min_residues, topn=a.topn, strata=a.strata,
        match_bonus=a.match_bonus, mismatch_penalty=a.mismatch_penalty,
        gap_read_penalty=a.gap_read_penalty, gap_ref_penalty=a.gap_ref_penalty,
        gap_extend_penalty=a.gap_extend_penalty, affine=a.affine,
        end_to_end=a.end_to_end, sw_backend=a.sw_backend,
        min_insert_size=a.min_insert_size, max_insert_size=a.max_insert_size,
        pair_score_cutoff=a.pair_score_cutoff,
        bs_mapping=a.bs_mapping, bs_cutoff=a.bs_cutoff, slam_seq=a.slam_seq,
        no_unal=a.no_unal, hard_clip=a.hard_clip, silent_clip=a.silent_clip,
        rg_id=a.rg_id, rg_sm=a.rg_sm, rg_lb=a.rg_lb, rg_pl=a.rg_pl,
        rg_pu=a.rg_pu, bam=a.bam,
        batch_size=a.batch_size, megabatch=a.megabatch,
        read_len=a.read_len, corridor=a.corridor,
        skip_save=a.skip_save, no_progress=a.no_progress, threads=a.threads,
        devices=devices,
        qry_start=a.qry_start, qry_count=a.qry_count,
        dist_nprocs=a.dist_nprocs, dist_procid=a.dist_procid,
        dist_coordinator=a.dist_coordinator, no_merge=a.no_merge,
        index_shards=a.index_shards, shard_hosts=a.shard_across_hosts,
    )


def parse(argv: list[str]):
    """(argv with the verb, parsed arguments, NgmConfig or None) of a
    command line: `map` (the verb may be omitted) or `index` (config
    None)."""
    argv = list(argv)
    if argv and argv[0] not in ("map", "index", "-h", "--help"):
        argv = ["map"] + argv
    parser, _ = build_parser()
    a = parser.parse_args(argv)
    if a.verb == "index":
        return argv, a, None
    if a.verb != "map":
        parser.error("the verb is `map` or `index`")
    if not (a.qry or a.qry1):
        parser.error("need -q or -1/-2 query reads")
    if a.paired and a.qry1:
        parser.error("-p (interleaved) conflicts with -1/-2")
    if bool(a.qry1) != bool(a.qry2):
        parser.error("-1 and -2 must be given together")
    return argv, a, config_from_args(a)


def build_indexes(a) -> None:
    """The `index` verb: build and memoize the host KmerIndex (the CT and
    GA ones with --bs-mapping) next to the reference, and with
    --index-shards N > 1 also the .ngmt-shards artifact and one artifact
    per shard, the same files `ngm-tpu index` writes."""
    from nextgenmap_tpu_torch.index.genome import Genome
    from nextgenmap_tpu_torch.index.kmer_index import KmerIndex
    from nextgenmap_tpu_torch.parallel.index_shard import (
        ShardedIndex, open_sharded,
    )

    genome = Genome.open(a.reference)
    sharded = a.index_shards > 1
    built = [
        KmerIndex.open(
            a.reference, genome.codes, genome.sha1(), k=a.kmer,
            skip=a.kmer_skip, max_freq=a.max_freq, collapse=collapse,
            # canonical entries while they fit: int32 unsharded, uint32
            # when the shards rebase them into int32
            canonical=(collapse == "none" and genome.codes.shape[0]
                       < (2**31 if sharded else 2**30)),
            allow_u32=sharded,
        )
        for collapse in (("ct", "ga") if a.bs_mapping else ("none",))
    ]
    if not sharded:
        return
    cfg = NgmConfig(
        kmer=a.kmer, kmer_skip=a.kmer_skip, max_kmer_freq=a.max_freq,
        bs_mapping=a.bs_mapping, index_shards=a.index_shards,
        max_insert_size=a.max_insert_size,
    )
    sidx = open_sharded(cfg, a.reference, genome,
                        tuple(built) if a.bs_mapping else built[0])
    halo = ShardedIndex.halo_for(cfg)
    sidx.save_shards(
        lambda s: ShardedIndex.shard_cache_path(
            a.reference, s, cfg.kmer, cfg.kmer_skip, cfg.index_shards, halo,
            cfg.max_kmer_freq, dual=cfg.bs_mapping, canonical=sidx.canonical),
        genome.sha1())


def run(argv: list[str]):
    """Parse `argv` and run it: `map` returns the run's RunStats, `index`
    None."""
    argv, a, cfg = parse(argv)
    if cfg is None:
        return build_indexes(a)
    from nextgenmap_tpu_torch.pipeline.runner import run_mapping

    return run_mapping(
        cfg, a.reference, a.qry, a.output,
        cmdline=shlex.join(["ngm-torch"] + argv), qry1=a.qry1, qry2=a.qry2,
        paired_interleaved=a.paired, resume=a.resume,
        profile_dir=a.profile, device=a.device,
    )


def main(argv: list[str] | None = None) -> int:
    run(sys.argv[1:] if argv is None else argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
