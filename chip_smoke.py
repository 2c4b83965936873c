#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (nextgenmap_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, and outside a checkout of
the repository).  It only checks; it times nothing: the kernels alone are
timed by nextgenmap_tpu_torch/tools/kernel_ab.py, the mapping step by the
benchmark (ngm_bench/).  Phases, one line of output each:

  1. card     the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    nvcc builds the six hand-written kernels from the checkout,
              and g++ the port's host IO library
  3. K2       gather kernel == its plain PyTorch version on the card (exact),
              at 2048x148, 4096x148, 4096x206 and the long reads' 614x1184,
              with windows past the end
  4. K1       SW score kernel == its plain version on the card (exact) at
              the main path's shapes (all 2048 slots, and 650 real ones with
              the rest at length 0), the long-read bands and a tie-heavy
              periodic input, local and glocal (--end-to-end), and at the
              wide bands: [2048,100]xW264 (--corridor 225), [256,1500]xW264
              and [128,3000]xW488 (long reads), W 512 (one warp, 32 x 16
              cells) and W 520, 1024 and 2048 (a block of warps), each
              local, glocal and tie-heavy; every shape scores something
  4b. K4      SW with traceback == its plain version on the card (exact, in
              all 11 AlignResult fields, and in the [L, S, W] direction
              bytes when they are asked for) on each of its routes (smem,
              global) at the card tests' main shapes: [4096,100]xW48 (what
              the single-end path's traceback takes), [2048,150]xW56,
              [614,1000]xW184 and [2048,100]xW264, local and glocal, with
              the bisulfite matrices, tie-heavy slots, length-0 slots, the
              full op buffer and one that truncates (and does); each route
              aligns something, with a gap
  4c. K5      the read front end == its plain version on the card (exact
              in the rc and every k-mer output) at [4096,100], [4096,150]
              and [614,1000] canonical, two strands and bisulfite with a
              --bs-cutoff, k 13, stride 2, every batch with reads below L,
              N bases, a poly-A and a tandem-repeat read and reads at
              genome positions 1..k
  4d. K6      candidate search == its plain version on the card (exact in
              every Candidates field) on each of its routes that takes the
              shape: the bench's own input (4.6 Mbp random genome, packed,
              H 128), phase 6's repeat genome at the rule's H (canonical
              packed, plain CSR, 1000 bp, bisulfite with two tables),
              bisulfite at the collapsed ceiling H 4608, two strands at H
              8200 (the smem route refuses it), and a tandem-repeat read
              that moves all three overflow counters (C 2); candidates on
              both strands, negative diagonal buckets
  5. K3       the dynamic-gather probe's kernel == its plain version (exact)
              at the probe's default 256 x 1024 and at its use case at the
              mapper's batch, 4096 x 2048, REP 32, along dim 0 and 1; then
              the probe's entry point, which launches it, at both shapes
  6. single   the port's CLI maps 3 x 4096 simulated 100 bp reads (2% SNPs)
              against a 4.6 Mbp genome with planted repeats (E. coli K-12
              scale) on the card; >= 99% mapped, >= 95% truth-correct, the
              score pass and the finish pass launched by that run and no
              K2 or K4, real candidates scored; the score pass on the
              inputs of the run's first step == its plain version on CPU
              copies of them (exact in sw, slot_overflow, n_sc and base);
              the finish pass likewise (exact in all 17 MapResult fields)
  7. paired   the CLI's -1/-2 maps 2 x 4096 reads (2048 FR pairs a batch,
              insert 350 +- 40) on the same genome; >= 99% mapped, >= 95%
              truth-correct per mate, >= 90% of pairs proper, the score
              pass and the finish pass launched, real slots scored; the
              score pass and the finish pass on the first step's inputs
              (its pair mask, its pairs' verdicts) as in phase 6; the
              pair select launched once a step and exact against its
              plain version on the first step's inputs (a1 and proper)
  8. top-n    the CLI's -n 2 maps 2 x 4096 reads; one primary record per
              read, >= 99% mapped and >= 95% truth-correct primaries,
              secondaries present, the score pass, K2 and K4 launched
  9. e2e      the CLI's --end-to-end maps 2 x 4096 reads (2% SNPs) on the
              same genome; >= 99% mapped, >= 95% truth-correct, no S/H op in
              any mapped CIGAR, the score pass and the finish pass (glocal)
              launched
 10. bisulfite the CLI's --bs-mapping maps 2 x 4096 bisulfite reads (original
              top and bottom strands, 80% of C read as T) on the same
              genome; >= 90% truth-correct, the score pass and the finish
              pass launched, real slots scored
 11. long     the CLI maps 1000 bp reads (3% SNPs, 0.5% indels) in 2
              batches of the size the runner picks for them (614); >= 90%
              mapped, >= 90% of the mapped within 16 bp of the truth, every
              CIGAR consumes SEQ and every NM equals the edits, the score
              pass and the finish pass at W 184 launched
 12. cuda=cpu one batch of each path (single, paired, top-n, end-to-end,
              bisulfite single and paired: 4096 reads; 1000 bp: 614 reads;
              single with --index-shards 4) mapped on the card and on the
              CPU from the same state: all 17 MapResult fields equal, every
              rank of top-n
 13. sharded  the CLI with --index-shards 4 (the cross-shard tail pool of
              8192 rows; K1 at 4096 slots) and 2 (full per-shard tails) on
              phase 6's reads, and -1/-2 --index-shards 4 on phase 7's
              pairs: each SAM equal to the unsharded one byte for byte but
              @PG, the score pass and the finish pass launched as the
              shard loop predicts; the score pass and the finish pass as in
              phase 6 at the pool's input, K2 == its plain version at the
              flattened [S*Gs] genome on the windows the pool's finish reads
 14. gigabase a 2^31 + 2^27 base (2.28 Gbp) genome drawn as uint8 from the
              seed with the same 120 planted repeats, past 2^31 so no
              unsharded path can hold it: host KmerIndex (k 13, skip 2,
              native passes; canonical entries fall away), split into 4
              shards, 2 x 4096 reads (2% SNPs) through Mapper.map_batch on
              the card with full per-shard tails; >= 99% mapped, >= 95%
              truth-correct, some global positions past 2^31, K1 and the
              finish pass launched by every shard's tail, K5 once and K6 once a
              shard a step; K6 == its plain version on both routes on the
              arguments the shard loop gave it for shard 0; the peak device
              memory and the process's peak host memory
 15. runtime  the CLI on phase 6's reads with -t 1, -t 2 and -t 4 (SAMs
              equal to phase 6's, the same alignment and cell counters),
              phase 7's pairs with -t 4 (SAM equal to phase 7's), --megabatch
              4 -t 4, --bam (records, decoded by read_bam, equal to the SAM's
              first 11 fields), an interrupted run (one batch, its sidecar
              marked incomplete, a partial record appended) completed by
              --resume, --profile (the trace names K1, the finish pass, K5
              and K6), and --corridor 225 (W 264) on 1,024 reads equal to
              the CPU's SAM
 16. parallel eight CLI processes on the card at once (this script with
              --child: the CLI, run_cli's checks, one JSON line): two of
              --dist-nprocs 2 on phase 6's reads (merged SAM equal to
              phase 6's), two with --bam (records equal to phase 6's SAM),
              two on phase 7's pairs (equal to phase 7's), and two of
              --shard-across-hosts --index-shards 2 --dist-nprocs 2 joined
              by a gloo group on localhost (SAM equal to phase 13's
              sharded-2, each holding only its shard, two graph replays a
              batch in each: the CS, then the tails); K1 and the finish
              pass once a batch in each, and each one's peak device memory
              against phase 13's sharded-2 run.  Then the dp step on the
              slots [cuda:0, cuda:0] (run_mapping; the two slices one graph,
              one replay a batch, K1 and the finish pass once a slice) on
              phases 6 and 7's inputs, SAM equal to theirs; --devices 2
              through the CLI where the machine has two cards, else a line
              saying it has one
 17. bench    the port's bench, python -m nextgenmap_tpu_torch.bench, in a
              fresh process at its full size (root bench.py's workload: a
              4.6 Mbp random genome, 36 batches of 4096 100 bp reads at 2%
              SNPs): exactly one stdout line with bench.py's four keys,
              >= 99% mapped and >= 95% truth-correct of the 147,456 timed
              reads, GCUPS > 0, K1 and the finish pass launched and no K2
              or K4, one graph replay a batch (its stderr's bench-json
              line); then in this process a 2-batch sweep of its step under
              torch.cuda.set_sync_debug_mode("error") (no sync), and batch
              0 mapped on the card and on the CPU from the same state: all
              17 MapResult fields equal
 18. graft    the graft entry (nextgenmap_tpu_torch/graft_entry.py):
              entry()'s step on the card, >= 60 of 64 mapped and equal to
              the CPU's in every field; dryrun_multichip(4) on four slots
              (of cuda:0 on one card): the local ("dp", "ish") grid and
              the --shard-across-hosts layout equal, and each equal to the
              CPU's; K1 and the finish pass launched, on one card as often as
              entry()'s step and each leg's one graph (2 rows of 2 shards)
              and its warm-up row predict
 19. graphs   the one-dispatch step (models/step_graph.py: each step one
              captured CUDA graph, --megabatch K one graph of K steps), for
              single, paired, -n 2, --index-shards 4 (the pool),
              --index-shards 2 (full tails), --megabatch 4 (a graph of 4
              steps), the dp step on [cuda:0, cuda:0] (dp-2: one graph of
              its two slices of 2048) and the grid [2, 2] on four slots of
              cuda:0 (one graph of its two rows, each the shard loop with
              full tails), single and paired, on phase 6's genome: the
              graph's results equal the
              same Mapper state's eager step (StepGraphs(..., eager=True))
              in every field and rank on two successive batches, the first
              unchanged after the second replay; a replay, and the eager
              step, with their inputs on the card under
              torch.cuda.set_sync_debug_mode("error") (no sync); K1, the
              finish pass (-n 2: K2 and K4), K5 and K6 launched by a replay
              as often as by the eager step, and a third replay under
              torch.profiler records each of their kernels as many times as
              the capture counted nodes
              (a profiler window short of records, reported on stderr, is
              run again, at most six windows); the phase runs in a process
              of its own (this script with --graphs): late in this one,
              torch.profiler stopped recording some kernels; each
              capture's graph-pool bytes

Every mapping path from phase 6 on runs its steps through step graphs, as
the CLI does by default, the dp and grid steps included.
The kernel wrappers count a launch where they launch; a graph's replay adds
the launches its capture recorded (phase 19 holds that against the kernel
records of a replay under torch.profiler), and the eager warm-up step before each
capture counts as the step it is, so a run of N batches launches each
kernel per node N + (graphs captured) times (a --megabatch K run: N
rounded up to K); "launches_per_step" divides by those steps.

Every CLI run must launch the fused score pass (K1's row loops fed from
the reads and the genome; its wrapper counts as `score_pass`), the
finish pass (`finish_pass`; top-n runs K2 and K4 in its place, and no
other path launches them), K5 and K6, score real candidates,
count alignments (GCUPS > 0) and time its device steps; where a phase
counts launches exactly, a step launches K5 once and K6 once an index
shard.  From phase 6 on, the plain versions of the traceback, the read
front and the candidate search raise if a CUDA tensor reaches them through
their wrappers, so every mapping phase runs them on the finish pass or K4,
K5 and K6.  After the last phase
the script fails if jax or any module of the JAX package (nextgenmap_tpu)
was imported.

Any failure raises and ends the run without the final line.  The line
before the last is a JSON summary of the kernels: each one's source, the
TPU code it replaces, its launches and its launches per step on each path;
the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Everything is made from fixed seeds; nothing is fetched.
"""

import json
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np

READ_LEN = 100
BATCH = 4096
N_BATCHES = 3          # single-end path
N_BATCHES_NEW = 2      # every later path
GENOME_SIZE = 4_600_000
SEED = 2026
LONG_LEN = 1000
LONG_BATCH = 614       # the runner's batch for 1000 bp reads
# phase 13: (name, input, flags); phase 14: genome size and shard count
SHARDED = (("sharded-4", "single", ("--index-shards", "4")),
           ("sharded-2", "single", ("--index-shards", "2")),
           ("paired-sharded-4", "paired", ("--index-shards", "4")))
GIGA_SIZE = (1 << 31) + (1 << 27)
GIGA_SHARDS = 4
BENCH_TIMEOUT_S = 600   # phase 17's bench process
GRAPH_BATCHES = 4       # phase 19: the batches of a path (one --megabatch 4
                        # group)
PROFILER_WINDOWS = 6    # phase 19: windows of a replay under torch.profiler
                        # before its records are held as they are (CUPTI
                        # now and then hands back a window short of records)


def check(ok, what):
    if not ok:
        raise RuntimeError(what)


# K4: the card tests' main shapes (single-end 100 and 150 bp, 1000 bp,
# --corridor 225), the first what the single-end path's traceback takes
K4_SHAPES = ((4096, 100, 48), (2048, 150, 56), (614, 1000, 184),
             (2048, 100, 264))
# K3: the probe's default shape, and its use case at the mapper's batch
K3_SHAPES = ((256, 1024), (4096, 2048))
K3_REP = 32


def phase_card():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)   # the card's name and power limit, as nvidia-smi gives them
    print(f"[1 card] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return smi


def phase_build():
    from nextgenmap_tpu_torch.native import build, hostio

    repo = os.path.dirname(os.path.abspath(__file__))
    cached = os.path.exists(build.library_path())
    path = build.build()
    build.load()
    host = hostio.lib() is not None      # g++ of the host IO library
    print(f"[2 build] {'cached' if cached else 'nvcc'} -> "
          f"{os.path.relpath(path, repo)}; host IO library "
          f"{'built' if host else 'absent (Python paths)'}")


def phase_gather(genome_dev, rng, card):
    import torch

    from nextgenmap_tpu_torch.ops.gather import gather_windows, pad_table
    from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows

    G = genome_dev.shape[0]
    shapes = ((2048, 148), (4096, 148), (4096, 206), (LONG_BATCH, 1184))
    for n, T in shapes:
        s = rng.integers(0, G + 1, n).astype(np.int32)
        s[:6] = [0, G - T, G - T + 1, G - T // 2, G - 1, G]   # past the end too
        starts = torch.from_numpy(s).cuda()
        got = gather_genome_windows(genome_dev, starts, T)
        ref = gather_windows(pad_table(genome_dev, T, 4), starts, T)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"K2 differs from plain at {n}x{T}")
    print(f"[3 K2 gather] exact at "
          + ", ".join(f"{n}x{T}" for n, T in shapes) + f" ({card})")


def _sw_inputs(rng, S, L, W, real=None):
    """Queries, and corridors holding each query with ~2% SNPs and a short
    indel at a random offset; every 16th slot is an all-4 (invalid) one.
    real: only the first `real` slots hold a candidate, the rest are
    invalid slots as the mapper passes them (length 0, all-4 corridor)."""
    q = rng.integers(0, 4, (S, L)).astype(np.uint8)
    r = rng.integers(0, 4, (S, L + W)).astype(np.uint8)
    for i in range(S):
        o = int(rng.integers(0, W // 2 + 1))
        seg = q[i].copy()
        snp = rng.random(L) < 0.02
        seg[snp] = (seg[snp] + 1) % 4
        cut = int(rng.integers(L // 4, 3 * L // 4))
        gap = int(rng.integers(0, 4))
        seg = np.concatenate([seg[:cut], rng.integers(0, 4, gap), seg[cut:]])
        seg = seg[:L + W - o]
        r[i, o:o + seg.shape[0]] = seg
    r[::16] = 4
    q[3::7, 5] = 4                                    # N in some queries
    lens = np.where(rng.random(S) < 0.1, rng.integers(0, L + 1, S), L)
    if real is not None:
        lens[real:] = 0
        r[real:] = 4
    msel = rng.integers(0, 2, S).astype(np.int32)
    return q, lens.astype(np.int32), r, msel


def _tie_inputs(rng, S, L, W):
    """Tie-heavy input: periodic ACAC... queries over periodic corridors, so
    that many cells share the maximum (the first one in (i, o) must win)."""
    q = np.tile(np.array([0, 1], np.uint8), (S, (L + 1) // 2))[:, :L].copy()
    r = np.tile(np.array([0, 1], np.uint8), (S, (L + W + 1) // 2))[:, :L + W]
    r = r.copy()
    r[1::3, :] = 1 - r[1::3, :]              # out of phase by one base
    lens = np.full(S, L, np.int32)
    lens[2::5] = rng.integers(1, L + 1, len(lens[2::5]))
    return q, lens, r, np.zeros(S, np.int32)


def _general_matrices(rng):
    """Two asymmetric [8, 8] matrices: positive ACGT diagonal, random
    off-diagonal scores, N scored as a mismatch."""
    m = rng.integers(-20, 4, (2, 8, 8)).astype(np.int32)
    for c in range(4):
        m[:, c, c] = rng.integers(6, 13, 2)
    m[:, 4, :] = m[:, :, 4] = -15
    return m


def phase_sw(rng, cfg, card):
    import torch

    from nextgenmap_tpu_torch.models.mapper import score_matrices
    from nextgenmap_tpu_torch.ops.sw_kernel import sw_score
    from nextgenmap_tpu_torch.ops.sw_ref import banded_sw_score

    shapes = [  # (S, L, W, general matrices, mode, real slots or None)
        (2048, 100, 48, False, "local", None),
        (2048, 100, 48, False, "local", 650),
        (2048, 150, 56, False, "local", None),
        (1000, 100, 48, True, "local", None),
        (777, 100, 48, False, "local", None),
        (64, 500, 120, False, "local", None),
        (32, 1000, 184, False, "local", None),
        (512, 1000, 184, False, "local", None),
        (2048, 100, 48, False, "glocal", None),
        (2048, 100, 48, True, "glocal", None),
        (32, 1000, 184, False, "glocal", None),
        (2048, 100, 48, False, "local", "ties"),
        (2048, 100, 48, False, "glocal", "ties"),
    ] + [  # the wide bands: --corridor 225 (W 264), 1500 and 3000 bp
           # reads, and the block kernel (W > 512)
        (S, L, W, False, mode, real)
        for S, L, W in ((2048, 100, 264), (256, 1500, 264), (128, 3000, 488),
                        (64, 200, 512), (64, 200, 520), (32, 500, 1024),
                        (16, 1000, 2048))
        for mode, real in (("local", None), ("glocal", None),
                           ("local", "ties"))
    ]
    rows = []
    for S, L, W, general, mode, real in shapes:
        if real == "ties":
            q, lens, r, msel = _tie_inputs(rng, S, L, W)
        else:
            q, lens, r, msel = _sw_inputs(rng, S, L, W, real)
        mats = _general_matrices(rng) if general else score_matrices(cfg)
        args = [torch.from_numpy(a).cuda() for a in (q, lens, r, mats)]
        gaps = (30, 25, 7) if general else (cfg.gap_read_penalty,
                                            cfg.gap_ref_penalty,
                                            cfg.gap_extend_penalty)
        ms = torch.from_numpy(msel).cuda()
        got = sw_score(*args, *gaps, ms, band=W, mode=mode)
        ref = banded_sw_score(*args, *gaps, ms, band=W, mode=mode)
        torch.cuda.synchronize()
        shape = f"{mode} [{S},{L}]xW{W}" + (" 2 general mats" if general
                                           else "")
        if real is not None:
            shape += " tie-heavy" if real == "ties" else f" ({real} real)"
        for name, a, b in zip(("score", "end_i", "end_o"), got, ref):
            check(torch.equal(a, b), f"K1 {name} differs from plain at {shape}")
        check(int(got.score.max()) > 0, f"K1 scored nothing at {shape}")
        rows.append(shape)
    print(f"[4 K1 sw_score] exact at every shape ({card}): " + "; ".join(rows))


def _align_inputs(rng, S, L, W):
    """K4's input: _sw_inputs's queries and corridors (~2% SNPs and a short
    indel), every fifth slot tie-heavy (ACAC... over ACAC...), every 11th
    of length 0 with an all-4 corridor (the top-n tail's invalid slots)."""
    q, lens, r, msel = _sw_inputs(rng, S, L, W)
    tq, _, tr, _ = _tie_inputs(rng, S, L, W)
    q[1::5], r[1::5] = tq[1::5], tr[1::5]
    lens[::11] = 0
    r[::11] = 4
    return q, lens, r, msel


def phase_align(rng, cfg, card):
    """K4 against its plain version (banded_sw_forward's bytes, then
    _backwalk_rows's fields) on each of its routes, at the card tests'
    main shapes."""
    import torch

    from nextgenmap_tpu_torch.models.mapper import score_matrices
    from nextgenmap_tpu_torch.ops.sw_align_kernel import (
        ROUTES, sw_align, sw_align_with_dirs,
    )
    from nextgenmap_tpu_torch.ops.sw_ref import (
        _backwalk_rows, banded_sw_forward,
    )

    bs_mats = score_matrices(cfg.replace(bs_mapping=True))
    gaps = (cfg.gap_read_penalty, cfg.gap_ref_penalty, cfg.gap_extend_penalty)
    rows = []
    for S, L, W in K4_SHAPES:
        for mode in ("local", "glocal"):
            q, lens, r, msel = _align_inputs(rng, S, L, W)
            main = (S, L, W) == K4_SHAPES[0]
            mats = score_matrices(cfg) if main else bs_mats
            args = [torch.from_numpy(a).cuda() for a in (q, lens, r, mats)]
            ms = torch.from_numpy(msel).cuda()
            shape = f"{mode} [{S},{L}]xW{W}" + ("" if main else " bs mats")
            want_dirs, best, bi, bo = banded_sw_forward(
                *args, *gaps, ms, band=W, mode=mode)
            for route in ROUTES:
                for mo in (0, 12):   # the full op buffer, one that truncates
                    got, dirs = sw_align_with_dirs(*args, *gaps, ms, band=W,
                                                   max_ops=mo, mode=mode,
                                                   route=route)
                    bare = sw_align(*args, *gaps, ms, band=W, max_ops=mo,
                                    mode=mode, route=route)
                    want = _backwalk_rows(want_dirs, best, bi, bo,
                                          mo or L + W)
                    torch.cuda.synchronize()
                    check(torch.equal(dirs, want_dirs),
                          f"K4 {route} direction bytes differ from plain at "
                          f"{shape}")
                    for f in want._fields:
                        for res in (got, bare):
                            check(torch.equal(getattr(res, f),
                                              getattr(want, f)),
                                  f"K4 {route} {f} differs from plain at "
                                  f"{shape} max_ops {mo}")
                check(bool(bare.trunc.any()), f"max_ops 12 truncated nothing "
                      f"at {shape}")
                full = sw_align(*args, *gaps, ms, band=W, mode=mode,
                                route=route)
                check(int(full.score.max()) > 0 and int(full.indels.sum()) > 0,
                      f"K4 {route} aligned nothing, or no gap, at {shape}")
            rows.append(shape)
    print(f"[4b K4 sw_align] exact on both routes in all 11 fields, with and "
          f"without the direction bytes, full and truncating op buffers "
          f"({card}): " + "; ".join(rows))


# K5 (the read front end): (B, L, form, --bs-cutoff); every batch has reads
# with N bases and below L
K5_SHAPES = ((4096, 100, "canonical", 0), (4096, 150, "canonical", 0),
             (LONG_BATCH, 1000, "canonical", 0), (4096, 100, "strands", 0),
             (4096, 100, "bisulfite", 3))


def phase_front(card):
    """Phase 4c: K5 against its plain version (exact in every output) at
    K5_SHAPES."""
    import torch

    from nextgenmap_tpu_torch import synthetic
    from nextgenmap_tpu_torch.ops.kmer_kernel import (
        read_kmers, read_kmers_plain,
    )

    g, runs = synthetic.front_genome(1_000_000, seed=SEED)
    rows = []
    for B, L, form, cut in K5_SHAPES:
        bs = form == "bisulfite"
        codes, lens = synthetic.front_reads(g, B, L, runs=runs, seed=B + L,
                                            bisulfite=bs)
        r, n = torch.from_numpy(codes).cuda(), torch.from_numpy(lens).cuda()
        kw = dict(k=13, stride=2, bs=bs, bs_cutoff=cut,
                  canonical=form == "canonical")
        got, want = read_kmers(r, n, **kw), read_kmers_plain(r, n, **kw)
        torch.cuda.synchronize()
        got, want = [got[0], *got[1]], [want[0], *want[1]]
        shape = (f"{form} [{B},{L}] k13 stride 2"
                 + (f" cutoff {cut}" if cut else ""))
        for i, (a, b) in enumerate(zip(got, want)):
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"K5 output {i} differs from plain at {shape}")
        rows.append(shape)
    print(f"[4c K5 read_kmers] exact in the rc and every k-mer output "
          f"({card}): " + "; ".join(rows))


def cand_plain(kms, lengths, offsets, positions, sens, max_freq, *, k,
               dual_tables, **statics):
    """K6's plain version, as the wrapper calls it on a CPU tensor."""
    from nextgenmap_tpu_torch.ops.candidate import (
        candidate_search_canonical, candidate_search_dual,
    )

    if len(kms) == 4:
        return candidate_search_dual(*kms, offsets, positions, sens,
                                     max_freq, dual_tables=dual_tables,
                                     **statics)
    return candidate_search_canonical(*kms, lengths, offsets, positions,
                                      sens, max_freq, k=k, **statics)


def check_candidates(got, want, what):
    """K6's Candidates equal to the plain version's in every field, dtype
    included."""
    import torch

    torch.cuda.synchronize()
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"K6 {f} differs from plain at {what}")


def shard_cand_search(call):
    """K6 against its plain version, exact on both routes, on the arguments
    the gigabase shard loop gave it for shard 0 (a shard's plain CSR of
    4^13 + 1 int32 offsets and its positions); returns the shape."""
    from nextgenmap_tpu_torch.ops.candidate_kernel import candidate_search

    a, kw = call
    kms, _, off, pos = a[:4]
    want = cand_plain(*a, **kw)
    B, Q = kms[0].shape
    shape = (f"one shard of the 2.28 Gbp layout, [{B},{Q}] k-mers, CSR "
             f"{off.numel()} offsets, {pos.numel()} positions, "
             f"H{kw['hit_cap']}")
    for route in ("smem", "global"):
        check_candidates(candidate_search(*a, route=route, **kw), want,
                         f"{route}, {shape}")
    return shape


def phase_cand_search(card, genome, cfg):
    """Phase 4d: K6 against its plain version (exact in every field) on
    both routes where each takes the shape: the bench's input, phase 6's
    repeat genome at the rule's H (canonical packed and plain CSR, 1000 bp,
    bisulfite with two tables at the rule's H and at the collapsed ceiling
    4608), an H past the smem route, and a batch whose tandem-repeat read
    moves all three overflow counters."""
    import torch

    from nextgenmap_tpu_torch import bench, synthetic
    from nextgenmap_tpu_torch.index.device_build import (
        build_index_device, concat_tables,
    )
    from nextgenmap_tpu_torch.ops.candidate import pack_offsets
    from nextgenmap_tpu_torch.ops.candidate_kernel import (
        candidate_search, plan,
    )
    from nextgenmap_tpu_torch.ops.kmer_kernel import read_kmers

    sens = torch.tensor(cfg.sensitivity, dtype=torch.float32, device="cuda")
    w = bench.workload(bench.GENOME_SIZE, bench.BATCH, "cuda")
    bench_reads = bench.stage_reads(w, 1, bench.READS_SEED)[0][0]
    gd = torch.from_numpy(genome).cuda()
    off, pos = build_index_device(gd, k=cfg.kmer, skip=cfg.kmer_skip)
    tabs = {"bench": (w.tables[1], w.tables[2], True),
            "packed": (pack_offsets(off, cfg.max_kmer_freq,
                                    cfg.max_kmer_fanout), pos, True),
            "csr": (off, pos, False),
            "plain": (*build_index_device(gd, k=cfg.kmer, skip=cfg.kmer_skip,
                                          canonical=False), False)}
    bs_off, bs_pos = concat_tables(
        *build_index_device(gd, k=cfg.kmer, skip=cfg.kmer_skip,
                            collapse="ct", canonical=False),
        *build_index_device(gd, k=cfg.kmer, skip=cfg.kmer_skip,
                            collapse="ga", canonical=False))
    tabs["bisulfite"] = (pack_offsets(bs_off, cfg.max_kmer_freq,
                                      cfg.max_kmer_fanout), bs_pos, True)
    fg, runs = synthetic.front_genome(1_000_000, seed=7)
    f_off, f_pos = build_index_device(torch.from_numpy(fg).cuda(),
                                      k=cfg.kmer, skip=cfg.kmer_skip)
    tabs["tandem"] = (pack_offsets(f_off, cfg.max_kmer_freq,
                                   cfg.max_kmer_fanout), f_pos, True)
    n_pos = int(pos.shape[0])
    h100 = cfg.resolved_read_hits(n_pos, READ_LEN)
    h1000 = cfg.resolved_read_hits(n_pos, LONG_LEN)
    hbs = cfg.replace(bs_mapping=True).resolved_read_hits(
        int(bs_pos.shape[0]) // 2, READ_LEN)

    def reads(B, L, bs=False, g=genome, r=()):
        c, n = synthetic.front_reads(g, B, L, runs=r, seed=B + L, bisulfite=bs)
        return torch.from_numpy(c).cuda(), torch.from_numpy(n).cuda()

    # (label, table, reads, form, H, C)
    check(w.statics["hit_cap"] == 128 and w.statics["packed_offsets"],
          f"the bench's H is {w.statics['hit_cap']}, not 128")
    cases = [
        ("bench canonical packed [4096,100] H128", "bench",
         (bench_reads, w.lens), "canonical", 128, cfg.max_cmrs),
        (f"repeat genome canonical packed [4096,100] H{h100}", "packed",
         reads(BATCH, READ_LEN), "canonical", h100, cfg.max_cmrs),
        (f"repeat genome canonical CSR [4096,100] H{h100}", "csr",
         reads(BATCH, READ_LEN), "canonical", h100, cfg.max_cmrs),
        (f"repeat genome canonical packed [{LONG_BATCH},1000] H{h1000}",
         "packed", reads(LONG_BATCH, LONG_LEN), "canonical", h1000,
         cfg.max_cmrs),
        (f"bisulfite dual two tables [4096,100] H{hbs}", "bisulfite",
         reads(BATCH, READ_LEN, True), "bisulfite", hbs, cfg.max_cmrs),
        ("bisulfite dual two tables [1024,100] H4608", "bisulfite",
         reads(1024, READ_LEN, True), "bisulfite", 4608, cfg.max_cmrs),
        ("two strands CSR [1024,100] H8200 (past the smem route)", "plain",
         reads(1024, READ_LEN), "strands", 8200, cfg.max_cmrs),
        ("tandem read canonical packed [64,100] H128 C2 (all counters)",
         "tandem", reads(64, READ_LEN, g=fg, r=runs), "canonical", 128, 2),
    ]
    rows = []
    for shape, tab, (r, n), form, H, C in cases:
        bs = form == "bisulfite"
        off_t, pos_t, packed = tabs[tab]
        _, kms = read_kmers(r, n, k=cfg.kmer, stride=cfg.read_kmer_skip,
                            bs=bs, bs_cutoff=0, canonical=form == "canonical")
        statics = dict(k=cfg.kmer, fanout_cap=cfg.max_kmer_fanout,
                       hit_cap=H, max_cmrs=C,
                       diag_bin_log2=cfg.diag_bin_log2,
                       stride=cfg.read_kmer_skip, packed_offsets=packed)
        want = cand_plain(kms, n, off_t, pos_t, sens, cfg.max_kmer_freq,
                          dual_tables=bs, **statics)
        B, Q = kms[0].shape
        routes = []
        for route in ("smem", "global"):
            if route == "smem" and H > 8192:
                try:
                    plan(B, Q, len(kms) == 4, H, route)
                except ValueError:
                    continue
                check(False, f"K6's smem route took H {H}")
            got = candidate_search(kms, n, off_t, pos_t, sens,
                                   cfg.max_kmer_freq, dual_tables=bs,
                                   route=route, **statics)
            check_candidates(got, want, f"{route}, {shape}")
            routes.append(route)
        valid = got.score > 0
        check(bool(valid.any()) and set(got.strand[valid].tolist())
              == {0, 1}, f"K6 found no candidate on both strands at {shape}")
        if form == "canonical" and tab != "bench":
            check(bool((got.bucket[valid] < 0).any()),
                  f"no negative diagonal bucket at {shape}")
        counters = [int(x) for x in (got.fanout_overflow, got.hit_overflow,
                                     got.cmr_overflow)]
        if tab == "tandem":
            check(min(counters) > 0, f"the tandem read left a counter at 0: "
                  f"{counters}")
        rows.append(f"{shape}: {' and '.join(routes)}; counters (fanout, "
                    f"hit, cmr) {counters}")
    print(f"[4d K6 cand_search] exact in every Candidates field on each "
          f"route that takes the shape ({card}; sensitivity "
          f"{cfg.sensitivity} on the card): " + "; ".join(rows))


def guard_plain_front():
    """From here on, the plain versions of K5 and K6 raise if a CUDA tensor
    reaches them through their wrappers: the mapping phases must run the
    front on the kernels."""
    import torch

    from nextgenmap_tpu_torch.ops import candidate_kernel, kmer_kernel

    def guard(name, fn):
        def call(*a, **k):
            check(not any(isinstance(x, torch.Tensor) and x.is_cuda
                          for x in a),
                  f"a CUDA tensor reached the plain {name}")
            return fn(*a, **k)
        return call

    for mod, name in ((kmer_kernel, "read_kmers_plain"),
                      (candidate_kernel, "candidate_search_canonical"),
                      (candidate_kernel, "candidate_search_dual")):
        setattr(mod, name, guard(name, getattr(mod, name)))


def guard_plain_traceback():
    """From here on, the traceback's plain version raises if a CUDA tensor
    reaches it: the mapping phases must run every traceback on K4."""
    import torch

    from nextgenmap_tpu_torch.ops import sw_align_kernel, sw_ref

    def guard(name, fn):
        def call(*a, **k):
            check(not any(isinstance(x, torch.Tensor) and x.is_cuda
                          for x in a),
                  f"a CUDA tensor reached the plain {name}")
            return fn(*a, **k)
        return call

    for mod in (sw_ref, sw_align_kernel):
        for name in ("banded_sw_align", "banded_sw_forward",
                     "_backwalk_rows"):
            if hasattr(mod, name):
                setattr(mod, name, guard(name, getattr(mod, name)))


def phase_row_gather(card):
    """Phase 5: K3 against its plain version at K3_SHAPES, then the probe's
    entry point; returns the launches the probe made."""
    import torch

    from nextgenmap_tpu_torch.ops.row_gather import row_gather, row_gather_plain
    from nextgenmap_tpu_torch.tools import probe_dyngather

    rng = np.random.default_rng(3)
    shapes = []
    for R, W in K3_SHAPES:
        x = torch.from_numpy(
            rng.integers(0, 1 << 20, (R, W), dtype=np.int32)).cuda()
        for dim in (0, 1):
            idx = torch.from_numpy(rng.integers(0, (R, W)[dim], (R, W),
                                                dtype=np.int32)).cuda()
            got = row_gather(x, idx, K3_REP, dim)
            ref = row_gather_plain(x, idx, K3_REP, dim)
            torch.cuda.synchronize()
            shape = f"{R}x{W} REP {K3_REP} dim {dim}"
            check(torch.equal(got, ref), f"K3 differs from plain at {shape}")
            shapes.append(shape)
    # the probe's own entry point is the path that launches K3
    row_gather.launches = 0
    for R, W in K3_SHAPES:
        for dim in (0, 1):
            res = probe_dyngather.probe(dim, W, R, K3_REP)
            check(res["ok"] and res["correct"], f"the K3 probe failed: {res}")
    launches = row_gather.launches
    check(launches > 0, "the probe never launched K3")
    print(f"[5 K3 row_gather] exact at {', '.join(shapes)} ({card}); the "
          f"probe correct at every shape, {launches} launches")
    return launches


def map_argv(workdir, device="cuda"):
    """The main path's command line: default settings (k=13, B=4096)."""
    return ["map", "-r", os.path.join(workdir, "ref.fa"),
            "-q", os.path.join(workdir, "reads.fq"),
            "-o", os.path.join(workdir, "out.sam"),
            "--device", device, "--no-progress"]


def run_cli(path, argv):
    """The port's CLI on argv; (stats, {kernel: launches in this run}).
    The launch counts are set to 0 just before the run and read after."""
    from nextgenmap_tpu_torch import cli

    return run_counted(path, lambda: cli.run(argv))


def expected(n_steps, tails=1, shards=1):
    """The launches of n_steps single-end or paired mapping steps: the
    fused score pass (K1's row loops) and the finish pass (K4's) once a
    tail (a step of the shard loop runs a tail per shard, or one pooled
    tail), no K2 and no K4 of their own, K5 once, and K6 once an index
    shard."""
    return {"score_pass": tails * n_steps, "finish_pass": tails * n_steps,
            "gather_windows": 0, "sw_align": 0, "read_kmers": n_steps,
            "cand_search": shards * n_steps}


def path_kernels(topn=False):
    """The kernel wrappers (bench.KERNELS' names) a mapping path launches:
    the score pass, the traceback (the finish pass; top-n: K2 and K4), K5
    and K6."""
    tail = ("gather_windows", "sw_align") if topn else ("finish_pass",)
    return ("score_pass", *tail, "read_kmers", "cand_search")


def check_launched(launches, what, topn=False):
    """Every kernel of the path launched, and no other."""
    need = path_kernels(topn)
    for name, n in launches.items():
        check((n > 0) == (name in need),
              f"{what} launched {name} {n} times")


def run_counted(path, run):
    """run() -> RunStats of one mapping run, with run_cli's checks."""
    from nextgenmap_tpu_torch.bench import KERNELS

    for k in KERNELS.values():
        k.launches = 0
    stats = run()
    launches = {name: k.launches for name, k in KERNELS.items()}
    check_launched(launches, f"the {path} path", topn=path == "top-n")
    check(stats.slots_scored > 0, f"K1 scored no real candidate ({path})")
    check(stats.alignments_computed > 0 and stats.gcups() > 0,
          f"the {path} run counted no alignment (GCUPS {stats.gcups()})")
    check(len(stats.step_device_ms) > 0, f"no device step time ({path})")
    return stats, launches


def summary(stats, launches):
    return (f"launches {launches}; step graph replays {stats.graph_replays}, "
            f"captures {stats.graph_captures}; real slots scored "
            f"{stats.slots_scored}")


def steps(stats, n_batches, k=1):
    """The steps a run ran on the card: its batches (with --megabatch K the
    tail group padded to K), and the eager warm-up step of each step graph
    it captured.  Each launches its path's kernels once per node."""
    return -(-n_batches // k) * k + stats.graph_captures


def on_cpu(x):
    """A CPU copy of a call's argument (of each tensor in a tuple)."""
    import torch

    if isinstance(x, tuple):
        return tuple(map(on_cpu, x))
    return x.cpu() if torch.is_tensor(x) else x


def passes_exact(cap, what):
    """The score pass and the finish pass on the inputs of their first
    calls `cap` recorded, each exact against its plain version on CPU
    copies of them; returns the shapes."""
    import torch

    from nextgenmap_tpu_torch.ops.finish_kernel import finish_pass
    from nextgenmap_tpu_torch.ops.score_pass_kernel import score_pass

    shapes = []
    for fn in (score_pass, finish_pass):
        name = fn.__name__
        a, kw = cap.calls[name][0]
        got = [x.cpu() for x in fn(*a, **kw)]
        want = fn(*map(on_cpu, a), **kw)          # the plain version
        for nm, x, y in zip(want._fields, got, want):
            check(torch.equal(x, y),
                  f"{name} {nm} differs from its plain version at {what}")
        slots = f", {kw['slot_cap']} slots" if "slot_cap" in kw else ""
        shapes.append(f"{name} ({kw.get('mode', 'local')}, "
                      f"{got[0].shape[0]} reads, W {kw['band']}{slots})")
    return f"{' and '.join(shapes)} exact at {what}"


def phase_main_path(genome, workdir, device="cuda"):
    from nextgenmap_tpu_torch import synthetic

    n = N_BATCHES * BATCH
    codes, pos, strand = synthetic.simulate_reads(genome, n, READ_LEN, 0.02,
                                                  seed=SEED + 1)
    synthetic.write_fastq(os.path.join(workdir, "reads.fq"), codes, pos, strand)
    with Capture(first=("score_pass", "finish_pass")) as cap:
        stats, launches = run_cli("single", map_argv(workdir, device))
    exact = passes_exact(cap, "the single-end path")

    records, mapped, correct = synthetic.truth_correct(
        os.path.join(workdir, "out.sam"))
    check(records == n, f"SAM holds {records} records, expected {n}")
    check(mapped >= 0.99 * n, f"only {mapped}/{n} reads mapped")
    check(correct >= 0.95 * n, f"only {correct}/{n} reads truth-correct")
    print(f"[6 single] {n} reads x {READ_LEN} bp, {len(genome)} bp genome: "
          f"mapped {mapped} ({100 * mapped / n:.2f}%), truth-correct {correct} "
          f"({100 * correct / n:.2f}%); " + summary(stats, launches)
          + f"; {exact}")
    return codes, (launches, steps(stats, N_BATCHES))


def phase_paired_path(genome, workdir, device="cuda"):
    import torch

    from nextgenmap_tpu_torch import synthetic

    n = N_BATCHES_NEW * BATCH
    codes, pos, strand = synthetic.simulate_pairs(
        genome, n // 2, READ_LEN, 0.02, insert_mean=350, insert_sd=40,
        seed=SEED + 2)
    fq1, fq2, sam = (os.path.join(workdir, f) for f in ("r1.fq", "r2.fq",
                                                          "pe.sam"))
    for path, m in ((fq1, 0), (fq2, 1)):
        synthetic.write_fastq(path, codes[m::2], pos[m::2], strand[m::2],
                              prefix="simpair")
    from nextgenmap_tpu_torch.ops.pair_kernel import pair_select

    pair_select.launches = 0
    with Capture(first=("score_pass", "finish_pass", "pair_select")) as cap:
        stats, launches = run_cli("paired", [
            "map", "-r", os.path.join(workdir, "ref.fa"), "-1", fq1, "-2",
            fq2, "-o", sam, "--device", device, "--no-progress"])
    exact = passes_exact(cap, "the paired path")
    check(cap.calls["score_pass"][0][1].get("pairs") is True,
          "the paired path's score pass took no pair mask")
    n_steps = steps(stats, N_BATCHES_NEW)
    check(pair_select.launches == n_steps,
          f"the paired path launched the pair select {pair_select.launches} "
          f"times in {n_steps} steps")
    a, kw = cap.calls["pair_select"][0]
    got = pair_select(*a, **kw)
    want = pair_select(*map(on_cpu, a), **kw)      # the plain version
    for nm, x, y in zip(want._fields, got, want):
        check(torch.equal(x.cpu(), y),
              f"pair_select {nm} differs from its plain version")
    exact += (f"; pair_select once a step ({n_steps} steps), exact at "
              f"{a[0].shape[0] // 2} pairs x C {a[0].shape[1]}")

    c = synthetic.sam_counts(sam)
    check(c["records"] == n, f"SAM holds {c['records']} records, expected {n}")
    check(c["mapped"] >= 0.99 * n, f"only {c['mapped']}/{n} mates mapped")
    per_mate = []
    for bit in (0x40, 0x80):
        m = synthetic.sam_counts(sam, require=bit)
        check(m["records"] == n // 2, f"{m['records']} records of mate {bit}")
        check(m["correct"] >= 0.95 * n // 2,
              f"only {m['correct']}/{n // 2} of mate {bit} truth-correct")
        per_mate.append(m["correct"])
    pairs_proper = c["proper"] // 2
    check(pairs_proper >= 0.90 * n // 2,
          f"only {pairs_proper}/{n // 2} pairs proper")
    print(f"[7 paired] {n // 2} pairs x 2 x {READ_LEN} bp: mapped "
          f"{c['mapped']} ({100 * c['mapped'] / n:.2f}%), truth-correct mate 1 "
          f"{per_mate[0]}, mate 2 {per_mate[1]} "
          f"({100 * sum(per_mate) / n:.2f}%), proper pairs {pairs_proper} "
          f"({200 * pairs_proper / n:.2f}%; counted {stats.pairs_proper}, "
          f"broken {stats.pairs_broken}); " + summary(stats, launches)
          + f"; {exact}")
    return codes, (launches, steps(stats, N_BATCHES_NEW))


def phase_topn_path(genome, workdir, device="cuda"):
    from nextgenmap_tpu_torch import synthetic

    n = N_BATCHES_NEW * BATCH
    codes, pos, strand = synthetic.simulate_reads(genome, n, READ_LEN, 0.02,
                                                  seed=SEED + 3)
    fq, sam = (os.path.join(workdir, f) for f in ("top.fq", "top.sam"))
    synthetic.write_fastq(fq, codes, pos, strand)
    stats, launches = run_cli("top-n", [
        "map", "-r", os.path.join(workdir, "ref.fa"), "-q", fq, "-o", sam,
        "-n", "2", "--device", device, "--no-progress"])

    c = synthetic.sam_counts(sam)
    check(c["primary"] == n and c["names_multi_primary"] == 0,
          f"{c['primary']} primary records for {n} reads "
          f"({c['names_multi_primary']} repeated)")
    check(c["mapped"] >= 0.99 * n, f"only {c['mapped']}/{n} reads mapped")
    check(c["correct"] >= 0.95 * n, f"only {c['correct']}/{n} truth-correct")
    check(c["secondary"] > 0, "no secondary record on a repeat genome")
    print(f"[8 top-n] -n 2, {n} reads: primaries {c['primary']}, mapped "
          f"{c['mapped']} ({100 * c['mapped'] / n:.2f}%), truth-correct "
          f"{c['correct']} ({100 * c['correct'] / n:.2f}%), secondaries "
          f"{c['secondary']}; " + summary(stats, launches))
    return codes, (launches, steps(stats, N_BATCHES_NEW))


def phase_e2e_path(genome, workdir, device="cuda"):
    from nextgenmap_tpu_torch import synthetic

    n = N_BATCHES_NEW * BATCH
    codes, pos, strand = synthetic.simulate_reads(genome, n, READ_LEN, 0.02,
                                                  seed=SEED + 4)
    fq, sam = (os.path.join(workdir, f) for f in ("e2e.fq", "e2e.sam"))
    synthetic.write_fastq(fq, codes, pos, strand)
    stats, launches = run_cli("end-to-end", [
        "map", "-r", os.path.join(workdir, "ref.fa"), "-q", fq, "-o", sam,
        "--end-to-end", "--device", device, "--no-progress"])

    c = synthetic.alignment_counts(sam, genome)
    check(c["records"] == n, f"SAM holds {c['records']} records, expected {n}")
    check(c["mapped"] >= 0.99 * n, f"only {c['mapped']}/{n} reads mapped")
    check(c["correct"] >= 0.95 * n, f"only {c['correct']}/{n} truth-correct")
    check(c["clipped"] == 0, f"{c['clipped']} end-to-end CIGARs clip")
    print(f"[9 e2e] --end-to-end, {n} reads: mapped {c['mapped']} "
          f"({100 * c['mapped'] / n:.2f}%), truth-correct {c['correct']} "
          f"({100 * c['correct'] / n:.2f}%), clipped CIGARs {c['clipped']}; "
          + summary(stats, launches))
    return codes, (launches, steps(stats, N_BATCHES_NEW))


def phase_bisulfite_path(genome, workdir, device="cuda"):
    from nextgenmap_tpu_torch import synthetic

    n = N_BATCHES_NEW * BATCH
    codes, pos, strand = synthetic.simulate_bisulfite_reads(
        genome, n, READ_LEN, rate=0.8, seed=SEED + 5)
    fq, sam = (os.path.join(workdir, f) for f in ("bs.fq", "bs.sam"))
    synthetic.write_fastq(fq, codes, pos, strand)
    stats, launches = run_cli("bisulfite", [
        "map", "-r", os.path.join(workdir, "ref.fa"), "-q", fq, "-o", sam,
        "--bs-mapping", "--device", device, "--no-progress"])

    c = synthetic.sam_counts(sam)
    check(c["records"] == n, f"SAM holds {c['records']} records, expected {n}")
    check(c["correct"] >= 0.90 * n, f"only {c['correct']}/{n} truth-correct")
    print(f"[10 bisulfite] --bs-mapping, {n} reads (OT/OB, 80% C->T): "
          f"mapped {c['mapped']} ({100 * c['mapped'] / n:.2f}%), "
          f"truth-correct {c['correct']} ({100 * c['correct'] / n:.2f}%); "
          + summary(stats, launches))
    return codes, (launches, steps(stats, N_BATCHES_NEW))


def phase_long_path(genome, workdir, device="cuda"):
    from nextgenmap_tpu_torch import synthetic

    n = N_BATCHES_NEW * LONG_BATCH
    codes, pos, strand = synthetic.simulate_long_reads(
        genome, n, LONG_LEN, 0.03, 0.005, seed=SEED + 6)
    fq, sam = (os.path.join(workdir, f) for f in ("long.fq", "long.sam"))
    synthetic.write_fastq(fq, codes, pos, strand)
    stats, launches = run_cli("long", [
        "map", "-r", os.path.join(workdir, "ref.fa"), "-q", fq, "-o", sam,
        "--device", device, "--no-progress"])

    check(stats.first_batch_reads == LONG_BATCH,
          f"first batch {stats.first_batch_reads} reads, expected {LONG_BATCH}")
    # the front (K5, K6), one score pass and one finish pass per step
    n_steps = steps(stats, N_BATCHES_NEW)
    check(launches == expected(n_steps),
          f"long-read launches {launches} for {n_steps} steps")
    c = synthetic.alignment_counts(sam, genome, tol=16)
    check(c["records"] == n, f"SAM holds {c['records']} records, expected {n}")
    check(c["mapped"] >= 0.90 * n, f"only {c['mapped']}/{n} reads mapped")
    check(c["correct"] >= 0.90 * c["mapped"],
          f"only {c['correct']}/{c['mapped']} mapped within 16 bp")
    check(c["seq_mismatch"] == 0, f"{c['seq_mismatch']} CIGARs miss SEQ")
    check(c["nm_mismatch"] == 0, f"{c['nm_mismatch']} NM tags are wrong")
    print(f"[11 long] {n} reads x {LONG_LEN} bp (3% SNPs, 0.5% indels), batch "
          f"{stats.first_batch_reads}, W 184: mapped {c['mapped']} "
          f"({100 * c['mapped'] / n:.2f}%), within 16 bp {c['correct']} "
          f"({100 * c['correct'] / c['mapped']:.2f}% of mapped), CIGARs "
          f"consume SEQ and NM = edits on all; " + summary(stats, launches))
    return codes, (launches, steps(stats, N_BATCHES_NEW))


def sam_records(path):
    """The SAM lines of `path` but the @PG one."""
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


def sam_body(records):
    """The first 11 fields of each record (what read_bam gives back)."""
    return [ln.rstrip("\n").split("\t")[:11] for ln in records
            if not ln.startswith("@")]


class Capture:
    """Within `with`, record the arguments of every call the mapper makes
    to the score pass, finish pass, K2, K6 and pair-select wrappers, to rerun
    a kernel on exactly the inputs a path gave it.  Of a name in `first`
    only the first call is kept, its tensors copied: a step graph's eager
    warm-up, whose input buffers later batches overwrite."""

    NAMES = ("score_pass", "finish_pass", "gather_genome_windows",
             "candidate_search", "pair_select")

    def __init__(self, first=()):
        self.first = set(first)

    def __enter__(self):
        from nextgenmap_tpu_torch.models import mapper

        self.mod, self.calls = mapper, {name: [] for name in self.NAMES}
        self.orig = {name: getattr(mapper, name) for name in self.NAMES}

        def rec(name, fn):
            def call(*a, **k):
                if name not in self.first:
                    self.calls[name].append((a, k))
                elif not self.calls[name]:
                    import torch

                    check(not torch.cuda.is_current_stream_capturing(),
                          f"the first {name} call was inside a capture")
                    def copy(x):
                        if isinstance(x, tuple):
                            return tuple(map(copy, x))
                        return x.clone() if torch.is_tensor(x) else x

                    self.calls[name].append((tuple(map(copy, a)), k))
                return fn(*a, **k)
            return call

        for name, fn in self.orig.items():
            setattr(mapper, name, rec(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)


def phase_sharded_cli(genome, workdir, single_codes, cfg, card,
                      device="cuda"):
    """The CLI with --index-shards on phases 6 and 7's inputs, SAM against
    theirs; then the fused score pass and the finish pass on the inputs one
    pooled batch gives them, and K2 on the windows that finish reads from
    the flattened genome.  Returns ({run: (kernel launches, steps)},
    {run: (device memory before it, its peak)})."""
    import torch

    from nextgenmap_tpu_torch.models.mapper import Mapper, shard_tail_cap
    from nextgenmap_tpu_torch.ops.gather import gather_windows, pad_table
    from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
    from nextgenmap_tpu_torch.pipeline.runner import load_reference

    ref = os.path.join(workdir, "ref.fa")
    launches, rows, memory = {}, [], {}
    for name, kind, flags in SHARDED:
        if kind == "paired":
            qry = ["-1", os.path.join(workdir, "r1.fq"),
                   "-2", os.path.join(workdir, "r2.fq")]
            base, n_batches = "pe.sam", N_BATCHES_NEW
        else:
            qry = ["-q", os.path.join(workdir, "reads.fq")]
            base, n_batches = "out.sam", N_BATCHES
        out = os.path.join(workdir, f"{name}.sam")
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        stats, counts = run_cli(name, [
            "map", "-r", ref, *qry, "-o", out, *flags, "--device", device,
            "--no-progress"])
        # this process's device memory before the run, and its peak in it
        memory[name] = (resident, torch.cuda.max_memory_allocated())
        check(sam_records(out) == sam_records(os.path.join(workdir, base)),
              f"{name}: SAM differs from the unsharded run's")
        S = int(flags[-1])
        per = 1 if shard_tail_cap(BATCH, S) else S    # pool, or S tails
        n_steps = steps(stats, n_batches)
        check(counts == expected(n_steps, per, S),
              f"{name}: launches {counts}, expected {per} score passes, "
              f"{per} finish passes, one K5 and {S} K6 per step "
              f"({n_steps} steps)")
        launches[name] = (counts, n_steps)
        rows.append(f"{name} ({'pool' if per == 1 else f'{S} tails'}): "
                    f"SAM equal; " + summary(stats, counts))

    # the fused score pass and the finish pass on the inputs one
    # --index-shards 4 batch gives them
    c4 = cfg.replace(index_shards=4)
    genome_obj, sidx = load_reference(c4, ref)
    mapper = Mapper(c4, genome_obj, READ_LEN, sidx, device=device)
    with Capture(first=("score_pass", "finish_pass")) as cap:
        mapper.map_batch(single_codes[:BATCH],
                         np.full(BATCH, READ_LEN, np.int32))
        torch.cuda.synchronize()
    # the first call is the step graph's eager warm-up, on tensors that
    # hold this batch (the capture's own call follows it)
    (a, kw), = cap.calls["score_pass"]
    S, Gs = sidx.genome.shape
    pool_rows = shard_tail_cap(BATCH, S)
    check(tuple(a[1].shape) == (pool_rows, READ_LEN) and kw["band"] == 48,
          f"the pool handed the score pass {tuple(a[1].shape)}"
          f"xW{kw['band']}, expected {pool_rows} rows")
    (fa, fkw), = cap.calls["finish_pass"]
    exact = passes_exact(cap, "the sharded pool")
    check(not cap.calls["gather_genome_windows"],
          "the pooled tail launched K2")
    # K2 on the windows the pool's finish reads: the winners' corridor
    # starts (0 for an invalid winner), clamped as the finish clamps them
    a1, corr, valid, g_flat = fa[0][:, None], fa[2], fa[4], fa[5]
    T = READ_LEN + fkw["band"]
    check(g_flat.shape[0] == S * Gs, "the finish did not read the "
          "flattened stacked genome")
    starts = torch.where(torch.gather(valid, 1, a1)[:, 0],
                         torch.gather(corr, 1, a1)[:, 0], 0)
    starts = starts.clamp(0, max(0, S * Gs - T)).contiguous()
    gg = gather_genome_windows(g_flat, starts, T)
    gw = gather_windows(pad_table(g_flat, T, 4), starts, T)
    check(torch.equal(gg, gw), "K2 differs from plain at the flat genome")
    print(f"[13 sharded] " + "; ".join(rows) + f"; ({card}) {exact}; K2 "
          f"exact at {starts.numel()}x{T} from the flattened [{S}*{Gs}] "
          f"genome")
    return launches, memory


def phase_gigabase(card, size=GIGA_SIZE, n_shards=GIGA_SHARDS, batch=BATCH,
                   device="cuda"):
    """The 2.28 Gbp genome in 4 shards through Mapper.map_batch; returns
    ({kernel: launches}, number of steps)."""
    import torch

    from nextgenmap_tpu_torch import synthetic
    from nextgenmap_tpu_torch.config import NgmConfig
    from nextgenmap_tpu_torch.index.kmer_index import KmerIndex
    from nextgenmap_tpu_torch.models.mapper import Mapper
    from nextgenmap_tpu_torch.bench import KERNELS
    from nextgenmap_tpu_torch.native import hostio
    from nextgenmap_tpu_torch.parallel.index_shard import ShardedIndex

    check(hostio.lib() is not None,
          "the gigabase phase needs the native index passes (g++)")
    cfg = NgmConfig(kmer_skip=2, read_kmer_skip=1, index_shards=n_shards)
    g = synthetic.repeat_genome_large(size, n_repeats=120, min_len=1000,
                                      max_len=2000, seed=SEED)
    idx = KmerIndex.build(g, k=cfg.kmer, skip=cfg.kmer_skip,
                          max_freq=cfg.max_kmer_freq, canonical=True,
                          allow_u32=True)
    n_pos = idx.positions.shape[0]
    check(idx.canonical == (size < 2**31),
          "canonical entries past 2^31 bases")
    sidx = ShardedIndex.build(idx, g, n_shards, ShardedIndex.halo_for(cfg))
    del idx
    host_gb = (sidx.genome.nbytes + sidx.offsets.nbytes
               + sidx.positions.nbytes) / 1e9
    shape = (tuple(sidx.genome.shape), tuple(sidx.positions.shape))

    class Codes:
        codes = g

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mapper = Mapper(cfg, Codes, READ_LEN, sidx, device=device)
    del sidx

    n = 2 * batch
    codes, pos, strand = synthetic.simulate_reads(g, n, READ_LEN, 0.02,
                                                  seed=SEED + 8)
    lens = np.full(batch, READ_LEN, np.int32)
    for k in KERNELS.values():
        k.launches = 0
    mapped, gpos, gstrand = [], [], []
    with Capture() as cap:
        for b in range(2):
            res = mapper.map_batch(codes[b * batch:(b + 1) * batch], lens)
            mapped.append(res.mapped.cpu().numpy())
            gpos.append(res.pos.cpu().numpy())
            gstrand.append(res.strand.cpu().numpy())
    launches = {name: k.launches for name, k in KERNELS.items()}
    mapped, gpos, gstrand = (np.concatenate(x) for x in
                             (mapped, gpos, gstrand))
    correct = mapped & (np.abs(gpos - pos) <= 5) & (gstrand == strand)
    past = int((mapped & (gpos >= 2**31)).sum())
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else float("nan"))
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    # past S * Gs = 2^31 the tails run per shard: the score pass and the
    # finish pass once each
    per = (1 if mapper.tail_cap(batch)
           and mapper.shards.genome.numel() < 2**31 else n_shards)
    n_steps = 2 + len(mapper.graphs.captures)   # and the graph's warm-up
    check(launches == expected(n_steps, per, n_shards),
          f"gigabase launches {launches}, expected {per} score passes, "
          f"{per} finish passes, one K5 and {n_shards} K6 per step "
          f"({n_steps} steps)")
    k6 = shard_cand_search(cap.calls["candidate_search"][0])
    check(mapped.sum() >= 0.99 * n, f"only {mapped.sum()}/{n} reads mapped")
    check(correct.sum() >= 0.95 * n,
          f"only {correct.sum()}/{n} reads truth-correct")
    check(size < 2**31 or past > 0, "no mapped position past 2^31")
    print(f"[14 gigabase] {size} bp genome ({n_pos} index positions, "
          f"{n_shards} shards {shape[0]} genome / {shape[1]} positions, "
          f"{host_gb:.2f} GB of tables; {card}): {n} reads x {READ_LEN} bp, "
          f"mapped {int(mapped.sum())} ({100 * mapped.mean():.2f}%), "
          f"truth-correct {int(correct.sum())} "
          f"({100 * correct.mean():.2f}%), {past} mapped past 2^31; "
          f"launches {launches}; peak device memory {peak:.3f} GiB, peak "
          f"host memory of the process {host_peak:.3f} GiB; K6 exact at "
          f"{k6} on both routes")
    return launches, n_steps


def phase_runtime(workdir, device="cuda"):
    """The runtime of the CLI (-t, --megabatch, --bam, --resume, --profile,
    a wide --corridor) on phases 6 and 7's inputs; returns {run: (kernel
    launches, steps)}."""
    from nextgenmap_tpu_torch import cli
    from nextgenmap_tpu_torch.io.bam import read_bam

    path = lambda name: os.path.join(workdir, name)  # noqa: E731
    single = sam_records(path("out.sam"))            # phase 6, -t 1
    body = sam_body(single)
    launches, rows = {}, []

    def run(name, out, *flags, n_batches=N_BATCHES,
            qry=("-q", path("reads.fq")), k=1):
        stats, counts = run_cli(name, [
            "map", "-r", path("ref.fa"), *qry, "-o", path(out), "--device",
            device, "--no-progress", *flags])
        launches[name] = (counts, steps(stats, n_batches, k))
        rows.append(f"{name}: " + summary(stats, counts))
        return stats

    counters = set()
    for t in ("1", "2", "4"):
        st = run(f"single -t {t}", f"t{t}.sam", "-t", t)
        check(sam_records(path(f"t{t}.sam")) == single,
              f"-t {t}: SAM differs from phase 6's")
        counters.add((st.reads_in, st.alignments_computed, st.cells_computed))
    check(len(counters) == 1, f"the counters differ across -t: {counters}")
    run("paired -t 4", "pe_t4.sam", "-t", "4", n_batches=N_BATCHES_NEW,
        qry=("-1", path("r1.fq"), "-2", path("r2.fq")))
    check(sam_records(path("pe_t4.sam")) == sam_records(path("pe.sam")),
          "paired -t 4: SAM differs from phase 7's (-t 1)")
    st = run("megabatch 4 -t 4", "mb.sam", "--megabatch", "4", "-t", "4",
             k=4)
    check(st.graph_replays == -(-N_BATCHES // 4),
          f"--megabatch 4: {st.graph_replays} graph replays for "
          f"{N_BATCHES} batches")
    check(sam_records(path("mb.sam")) == single,
          "--megabatch 4 -t 4: SAM differs from -t 1")
    run("bam -t 4", "out.bam", "--bam", "-t", "4")
    check(read_bam(path("out.bam"))[2] == body,
          "--bam records differ from the SAM's first 11 fields")

    # an interrupted run: one batch, its checkpoint marked incomplete and a
    # partial record after it; --resume maps the rest
    run("resume: first batch", "res.sam", "--qry-count", str(BATCH),
        n_batches=1)
    prog = path("res.sam.ngmt-progress.json")
    with open(prog) as f:
        p = json.load(f)
    check(p["reads_emitted"] == BATCH and p["complete"],
          f"the first run's sidecar: {p}")
    p["complete"] = False
    with open(prog, "w") as f:
        json.dump(p, f)
    with open(path("res.sam"), "a") as f:
        f.write("GARBAGE\ttruncated-in-flight-rec")
    run("resume: the rest", "res.sam", "--resume",
        n_batches=N_BATCHES - 1)
    check(sam_records(path("res.sam")) == single,
          "--resume: SAM differs from the uninterrupted run's")

    prof = path("prof")
    run("profile", "prof.sam", "--profile", prof, "--qry-count", str(BATCH),
        n_batches=1)
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    check(len(traces) == 1, f"--profile wrote {traces}")
    with open(os.path.join(prof, traces[0])) as f:
        trace = f.read()
    for kern in ("score_pass_kernel", "sw_align_finish_kernel",
                 "read_kmers_kernel", "cand_search_kernel"):
        check(kern in trace, f"the trace names no {kern}")
    rows[-1] += "; the trace names the score pass, the finish pass, K5 and K6"
    os.remove(os.path.join(prof, traces[0]))

    # W = 264: K1's warp kernel at 32 x 12 cells; the CPU runs its plain
    # version on the same reads
    n = min(1024, N_BATCHES * BATCH)
    run("corridor 225", "w264.sam", "--corridor", "225", "--qry-count",
        str(n), n_batches=1)
    cli.run(["map", "-r", path("ref.fa"), "-q", path("reads.fq"), "-o",
             path("w264_cpu.sam"), "--corridor", "225", "--qry-count",
             str(n), "--device", "cpu", "--no-progress"])
    w264 = sam_records(path("w264.sam"))
    check(w264 == sam_records(path("w264_cpu.sam")),
          "--corridor 225: the card's SAM differs from the CPU's")
    check(sum(1 for ln in w264 if not ln.startswith("@")) == n,
          "--corridor 225: wrong record count")
    print("[15 runtime] every SAM equal to its -t 1 / CPU counterpart but "
          "@PG; " + "; ".join(rows))
    return launches


CHILD_TIMEOUT_S = 420    # one phase-16 process, set-up included


def child(argv):
    """One process of phase 16's multi-process runs: the CLI on argv with
    run_cli's checks, then one JSON line of what the parent reads."""
    import torch

    guard_plain_traceback()
    stats, launches = run_cli("child", argv)
    print(json.dumps({
        "launches": launches, "reads_in": stats.reads_in,
        "graph_captures": stats.graph_captures,
        "graph_replays": stats.graph_replays,
        "peak_bytes": torch.cuda.max_memory_allocated()}))
    return 0


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_children(runs):
    """{name: [argv of each process]}: every process of every run started
    at once (python3 chip_smoke.py --child argv), then waited for; {name:
    [(its JSON line, its stderr)]}.  A process that fails or outlives its
    timeout fails the phase, and every process still running is killed."""
    procs = {name: [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for argv in argvs] for name, argvs in runs.items()}
    out = {}
    try:
        deadline = time.time() + CHILD_TIMEOUT_S
        for name, ps in procs.items():
            out[name] = []
            for i, p in enumerate(ps):
                so, se = p.communicate(
                    timeout=max(1.0, deadline - time.time()))
                check(p.returncode == 0, f"{name}: process {i} exited "
                      f"{p.returncode}: {se[-3000:]}")
                out[name].append((json.loads(so.strip().splitlines()[-1]),
                                  se))
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


def phase_parallel(workdir, sharded_memory, device="cuda"):
    """Phase 16: --dist-nprocs 2 (a) and --shard-across-hosts with 2
    processes (c), each a pair of CLI processes on the card, and the dp step
    on two slots of the card (b); returns {run: (kernel launches,
    steps)}."""
    import torch

    from nextgenmap_tpu_torch import cli
    from nextgenmap_tpu_torch.io.bam import read_bam
    from nextgenmap_tpu_torch.pipeline.runner import run_mapping

    path = lambda name: os.path.join(workdir, name)  # noqa: E731
    se = ("-q", path("reads.fq"))
    pe = ("-1", path("r1.fq"), "-2", path("r2.fq"))

    def argv(qry, out, i, *flags):
        return ["map", "-r", path("ref.fa"), *qry, "-o", path(out),
                "--device", device, "--no-progress", "--dist-nprocs", "2",
                "--dist-procid", str(i), *flags]

    port = free_port()
    runs = {
        "dist single": [argv(se, "dist.sam", i) for i in range(2)],
        "dist bam": [argv(se, "dist.bam", i, "--bam") for i in range(2)],
        "dist paired": [argv(pe, "dist_pe.sam", i) for i in range(2)],
        "shard-across-hosts": [argv(
            se, "xh.sam", i, "--shard-across-hosts", "--index-shards", "2",
            "--dist-coordinator", f"127.0.0.1:{port}") for i in range(2)],
    }
    done = run_children(runs)
    single, paired = sam_records(path("out.sam")), sam_records(path("pe.sam"))
    check(sam_records(path("dist.sam")) == single,
          "--dist-nprocs 2: the merged SAM differs from phase 6's")
    check(read_bam(path("dist.bam"))[2] == sam_body(single),
          "--dist-nprocs 2 --bam: records differ from phase 6's SAM")
    check(sam_records(path("dist_pe.sam")) == paired,
          "--dist-nprocs 2 paired: the merged SAM differs from phase 7's")
    check(sam_records(path("xh.sam")) == sam_records(path("sharded-2.sam")),
          "--shard-across-hosts: SAM differs from phase 13's sharded-2")
    launches, rows = {}, []
    for name, procs in done.items():
        parts = []
        for i, (r, err) in enumerate(procs):
            n_b = -(-r["reads_in"] // BATCH)     # batches it mapped
            caps = r["graph_captures"]
            if name == "shard-across-hosts":
                # two graphs a batch, the exchange of the best between
                # them: phase 1 (K5 and the one shard's K6) and phase 2
                # (the tails: the score pass, the finish pass), each with its
                # warm-up step
                check(r["graph_replays"] == 2 * n_b and caps % 2 == 0,
                      f"{name} process {i}: {r['graph_replays']} graph "
                      f"replays and {caps} captures for {n_b} batches, "
                      f"expected two replays a batch")
                caps //= 2
            n_steps = n_b + caps
            per = r["launches"]
            check(per == expected(n_steps),
                  f"{name} process {i}: launches {per} for {n_b} batches "
                  f"and {caps} graph warm-up step(s)")
            launches[f"{name} p{i}"] = (per, n_steps)
            if name == "shard-across-hosts":
                check(f"this host holds shards [{i}]" in err,
                      f"process {i} does not hold only shard {i}")
            parts.append(
                f"p{i} {r['reads_in']} reads in {n_b} batch(es), "
                f"{r['graph_replays']} graph replays, peak "
                f"{r['peak_bytes'] / 2**30:.3f} GiB")
        rows.append(f"{name}: " + "; ".join(parts))
    resident, peak = sharded_memory["sharded-2"]
    print(f"[16 parallel a+c] 8 CLI processes on {device} at once: "
          f"--dist-nprocs 2 SAM, --bam and paired equal to "
          f"phases 6 and 7, --shard-across-hosts --index-shards 2 equal to "
          f"phase 13's sharded-2 (whose one process held {resident / 2**30:.3f}"
          f" GiB before it and peaked at {peak / 2**30:.3f} GiB); "
          + "; ".join(rows))

    # b: the dp step on two slots of the one card, in this process
    cfg = cli.parse(map_argv(workdir, device))[2]
    slots = [torch.device(device, 0)] * 2
    rows = []
    for name, qry, out, want, n_b in (
            ("dp-2 single", dict(qry=path("reads.fq")), "dp.sam", single,
             N_BATCHES),
            ("dp-2 paired", dict(qry1=path("r1.fq"), qry2=path("r2.fq")),
             "dp_pe.sam", paired, N_BATCHES_NEW)):
        stats, counts = run_counted(name, lambda: run_mapping(
            cfg, path("ref.fa"), out_path=path(out), device=slots, **qry))
        check(sam_records(path(out)) == want,
              f"{name}: SAM differs from the one-slot run's")
        # a slice is a step: two a batch, one in each capture's warm-up
        n_steps = 2 * n_b + stats.graph_captures
        check(counts == expected(n_steps) and stats.graph_replays == n_b,
              f"{name}: launches {counts} and {stats.graph_replays} graph "
              f"replays, expected 1 score pass, 1 finish pass, 1 K5 and 1 "
              f"K6 a slice over {n_b} batches of 2 slices and "
              f"{stats.graph_captures} warm-up slice(s), and one replay a "
              f"batch")
        launches[name] = (counts, n_steps)
        rows.append(f"{name}: " + summary(stats, counts))
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        stats, counts = run_cli("devices 2", [
            "map", "-r", path("ref.fa"), *se, "-o", path("dev2.sam"),
            "--device", device, "--no-progress", "--devices", "2"])
        check(sam_records(path("dev2.sam")) == single,
              "--devices 2: SAM differs from phase 6's")
        launches["devices 2"] = (counts, N_BATCHES)
        rows.append("--devices 2 (CLI): " + summary(stats, counts))
    else:
        rows.append(f"--devices 2 through the CLI not run: this machine has "
                    f"{n_cards} CUDA card (it needs 2)")
    print("[16 parallel b] the dp step on the slots [cuda:0, cuda:0], its "
          "two slices one graph a batch, SAM equal to phases 6 and 7: "
          + "; ".join(rows))
    return launches


def phase_cuda_equals_cpu(genome, codes, cfg, ref_path, device="cuda"):
    """codes: {path: reads}; one batch of each path is mapped on the card
    and on the CPU from the card's state (the sharded one from the same
    ShardedIndex)."""
    import torch

    from nextgenmap_tpu_torch import synthetic
    from nextgenmap_tpu_torch.models.mapper import MapResult, Mapper
    from nextgenmap_tpu_torch.pipeline.runner import load_reference

    class Codes:
        pass

    g = Codes()
    g.codes = genome
    cfg = cfg.replace(topn=2)
    bs_cfg = cfg.replace(bs_mapping=True)
    rng = np.random.default_rng(SEED + 7)
    bs_pairs = synthetic.bisulfite_convert(codes["paired"][:BATCH], 0.8, rng)
    # (path, config, step, reads, read length)
    cases = [
        ("single", cfg, "map_batch", codes["single"][:BATCH], READ_LEN),
        ("paired", cfg, "map_batch_paired", codes["paired"][:BATCH], READ_LEN),
        ("topn", cfg, "map_batch_topn", codes["topn"][:BATCH], READ_LEN),
        ("end-to-end", cfg.replace(end_to_end=True), "map_batch",
         codes["end-to-end"][:BATCH], READ_LEN),
        ("bisulfite", bs_cfg, "map_batch", codes["bisulfite"][:BATCH],
         READ_LEN),
        ("bisulfite paired", bs_cfg, "map_batch_paired", bs_pairs, READ_LEN),
        ("long", cfg, "map_batch", codes["long"][:LONG_BATCH], LONG_LEN),
    ]
    # one sharded batch: both mappers from the runner's memoized
    # ShardedIndex (phase 13's CLI runs load it)
    sh_cfg = cfg.replace(index_shards=4)
    cases.append(("sharded-4", sh_cfg, "map_batch", codes["single"][:BATCH],
                  READ_LEN))
    mappers = {}
    rows = []
    for path, c, step, batch, read_len in cases:
        key = (c.bs_mapping, c.end_to_end, read_len, c.index_shards)
        if key not in mappers and c.index_shards > 1:
            _, sidx = load_reference(c, ref_path)
            mappers[key] = tuple(Mapper(c, g, read_len, sidx, device=d)
                                 for d in (device, "cpu"))
        elif key not in mappers:
            gpu = Mapper(c, g, read_len, device=device)
            index = (gpu.state.offsets.cpu().numpy(),
                     gpu.state.positions.cpu().numpy())
            mappers[key] = (gpu, Mapper(c, g, read_len, index, device="cpu"))
        gpu, cpu = mappers[key]
        lens = np.full(batch.shape[0], read_len, np.int32)
        a = getattr(gpu, step)(batch, lens)
        b = getattr(cpu, step)(batch, lens)
        ranks = (a, b) if step == "map_batch_topn" else ((a,), (b,))
        for j, (ra, rb) in enumerate(zip(*ranks)):
            for f in ra._fields:
                check(torch.equal(getattr(ra, f).cpu(), getattr(rb, f)),
                      f"{path}: cuda and cpu differ in rank {j} field {f}")
        n_multi = int((ranks[1][0].n_candidates >= 2).sum())
        rows.append(f"{path} ({batch.shape[0]} reads, {len(ranks[0])} "
                    f"rank(s), {n_multi} reads with >= 2 candidates)")
    print(f"[12 cuda=cpu] all {len(MapResult._fields)} MapResult fields "
          f"equal on one batch of each path: " + "; ".join(rows))


def phase_bench(card):
    """Phase 17: the port's bench (python -m nextgenmap_tpu_torch.bench) in
    a fresh process at its full size, its one stdout line parsed, its
    accuracy held to PERF.md's limits; no sync inside a sweep of its step;
    batch 0 of its workload mapped on the card and on the CPU from the same
    state.  Returns ({kernel: launches}, batches) of the bench's run."""
    import torch

    from nextgenmap_tpu_torch import bench
    from nextgenmap_tpu_torch.models.step_graph import StepGraphs

    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "nextgenmap_tpu_torch.bench"], cwd=repo,
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    check(proc.returncode == 0,
          f"the bench exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    check(len(lines) == 1, f"the bench printed {len(lines)} stdout lines")
    line = json.loads(lines[0])
    check(list(line) == ["metric", "value", "unit", "vs_baseline"]
          and line["metric"] == "reads_per_sec_per_chip"
          and line["unit"] == "reads/s" and line["value"] > 0,
          f"the bench's line is not bench.py's: {line}")
    tag = "bench-json: "
    r = json.loads(next(ln for ln in proc.stderr.splitlines()
                        if ln.startswith(tag))[len(tag):])
    n = r["n_reads"]
    check(n == bench.BATCH * bench.N_BATCHES, f"the bench mapped {n} reads")
    check(r["mapped"] >= 0.99 * n, f"bench: only {r['mapped']}/{n} mapped")
    check(r["truth_correct"] >= 0.95 * n,
          f"bench: only {r['truth_correct']}/{n} truth-correct")
    check(r["gcups"] > 0, f"bench: GCUPS {r['gcups']}")
    check_launched(r["launches"], "the bench")
    check(r["graph_replays"] == r["batches_run"],
          f"the bench replayed its graph {r['graph_replays']} times for "
          f"{r['batches_run']} batches")

    # the same workload in this process: a sweep makes no sync, and batch
    # 0 maps alike on the card and on the CPU
    w = bench.workload(bench.GENOME_SIZE, bench.BATCH, "cuda")
    staged = bench.stage_reads(w, bench.N_BATCHES, bench.READS_SEED)
    bench.sweep(w, *staged, 2).cpu()            # K4's plan, the allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")     # a sync now raises
    try:
        counters = bench.sweep(w, *staged, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(counters.cpu()[:, 0].min() > 0, "the no-sync sweep mapped nothing")
    w_cpu = w._replace(tables=tuple(map(on_cpu, w.tables)),
                       lens=w.lens.cpu(), matrices=w.matrices.cpu(),
                       scalars=tuple(map(on_cpu, w.scalars)),
                       graphs=StepGraphs("cpu"))
    a = bench.step(w, staged[0][0])
    b = bench.step(w_cpu, staged[0][0].cpu())
    for f in a._fields:
        check(torch.equal(getattr(a, f).cpu(), getattr(b, f)),
              f"bench batch 0: cuda and cpu differ in {f}")
    print(f"[17 bench] python -m nextgenmap_tpu_torch.bench ({card}): one "
          f"stdout line with bench.py's four keys, mapped {r['mapped']}/{n}, "
          f"truth-correct {r['truth_correct']}/{n}; launches "
          f"{r['launches']} over {r['batches_run']} batches, "
          f"{r['graph_replays']} graph replays (graph pool "
          f"{r['graph_captures'][0]['pool_bytes'] / 2**20:.1f} MiB); no sync "
          f"in a 2-batch sweep; batch 0 all {len(a._fields)} fields cuda == "
          f"cpu")
    return r["launches"], r["batches_run"]


def phase_graft(card):
    """Phase 18: the graft entry's entry() on the card against the CPU, then
    dryrun_multichip(4) on four slots (of cuda:0 on one card), both legs,
    against the CPU's.  Returns ({kernel: launches}, steps) of the card's
    calls: entry()'s step, and of each leg on one card the grid's one
    graph: its two rows a batch and the one row of its capture's warm-up,
    each row a step that runs both shards' tails."""
    import torch

    from nextgenmap_tpu_torch import graft_entry
    from nextgenmap_tpu_torch.bench import KERNELS

    for k in KERNELS.values():
        k.launches = 0
    fn, args = graft_entry.entry()
    got = fn(*args)
    legs = graft_entry.dryrun_multichip(4)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in KERNELS.items()}
    check_launched(launches, "the graft entry")
    n_steps = 1 + 2 * (2 + 1)        # entry(); per leg 2 rows + 1 warm-up
    if torch.cuda.device_count() == 1:
        k1 = 1 + 2 * (2 + 1) * 2     # a row runs 2 shard tails and CSs
        check(launches == dict(expected(k1), read_kmers=n_steps),
              f"graft: launches {launches}, expected {k1} score passes, "
              f"finish passes and K6 and {n_steps} K5 (entry()'s step, then "
              f"per leg "
              f"one graph of 2 rows of 2 shards and its warm-up row)")
    mapped = int(got.mapped.sum())
    check(mapped >= 60, f"graft entry: only {mapped}/64 mapped")
    check(legs[1] is not None, "dryrun_multichip(4) ran one leg")
    cfn, cargs = graft_entry.entry(device="cpu")
    pairs = [(got, cfn(*cargs))]
    pairs += zip(legs, graft_entry.dryrun_multichip(4, device="cpu"))
    for what, (a, b) in zip(("entry", "local grid", "cross-host"), pairs):
        for f in a._fields:
            check(torch.equal(getattr(a, f).cpu(), getattr(b, f)),
                  f"graft {what}: cuda and cpu differ in {f}")
    print(f"[18 graft] entry() on the card ({card}): mapped {mapped}/64, all "
          f"{len(got._fields)} fields equal to the CPU's; dryrun_multichip(4)"
          f" on {graft_entry.slots(4)}: both legs equal, and equal to the "
          f"CPU's, proper {int(legs[0].proper.sum())}/64; launches {launches}")
    return launches, n_steps


def _fields(res) -> list:
    """[(rank, field, tensor)] of a MapResult or a top-n tuple of them."""
    ranks = (res,) if hasattr(res, "_fields") else res
    return [(j, f, getattr(r, f)) for j, r in enumerate(ranks)
            for f in r._fields]


def is_kernel_of(name: str, record: str) -> bool:
    """Whether a device record is a kernel of wrapper `name` (bench.KERNELS'
    names): each wrapper's kernels hold its name, but the finish pass's
    hold "sw_align_finish" and K4's "sw_align" without it."""
    if name == "finish_pass":
        return "sw_align_finish" in record
    if name == "sw_align":
        return "sw_align" in record and "sw_align_finish" not in record
    return name in record


def replay_records(fn, want: dict):
    """({name: kernel records of its wrapper (is_kernel_of)} of one fn() under
    torch.profiler, windows run).  A window whose counts differ from
    `want` is reported on stderr, with every device record it holds, and
    run again after a pause, at most PROFILER_WINDOWS times.  The counts of
    the last window are returned whatever they are; the caller holds them
    to `want`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for window in range(1, PROFILER_WINDOWS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        got = {n: sum(e.count for e in kernels if is_kernel_of(n, e.key))
               for n in want}
        if got == want:
            return got, window
        print(f"chip_smoke: profiler window {window}: recorded {got}, want "
              f"{want}; device records "
              f"{[(e.key[:60], e.count) for e in kernels]}", file=sys.stderr)
        time.sleep(0.5)
    return got, PROFILER_WINDOWS


def phase_graphs(genome, cfg, card, device="cuda"):
    """Phase 19: each path through its step graph against the same Mapper
    state's eager step: the one-device paths, the dp step on [cuda:0,
    cuda:0] and the grid [2, 2] on four slots of cuda:0 (each one graph a
    batch).  Returns {path: (kernel launches of one replay, steps in
    it)}."""
    import torch

    from nextgenmap_tpu_torch import synthetic
    from nextgenmap_tpu_torch.bench import KERNELS
    from nextgenmap_tpu_torch.index.kmer_index import KmerIndex
    from nextgenmap_tpu_torch.models.mapper import Mapper
    from nextgenmap_tpu_torch.models.step_graph import StepGraphs
    from nextgenmap_tpu_torch.parallel.index_shard import ShardedIndex

    class Codes:
        codes = genome

    n = GRAPH_BATCHES
    single = synthetic.simulate_reads(genome, n * BATCH, READ_LEN, 0.02,
                                      seed=SEED + 9)[0]
    pairs = synthetic.simulate_pairs(genome, n * BATCH // 2, READ_LEN, 0.02,
                                     insert_mean=350, insert_sd=40,
                                     seed=SEED + 10)[0]
    single, pairs = (x.reshape(n, BATCH, READ_LEN) for x in (single, pairs))
    host = KmerIndex.build(genome, k=cfg.kmer, skip=cfg.kmer_skip,
                           max_freq=cfg.max_kmer_freq, canonical=True,
                           allow_u32=True)
    # (path, config, Mapper method, reads [n, B, L], K batches a call,
    # slots of the card, steps a replay runs: batches, slices or rows)
    # (the first three share one Mapper, so its three graphs share a pool)
    grid = cfg.replace(index_shards=2)
    cases = (("single", cfg, "map_batch", single, 1, 1, 1),
             ("paired", cfg, "map_batch_paired", pairs, 1, 1, 1),
             ("--megabatch 4", cfg, "map_batch_scan", single, n, 1, n),
             ("-n 2", cfg.replace(topn=2), "map_batch_topn", single, 1, 1,
              1),
             ("--index-shards 4 (pool)", cfg.replace(index_shards=4),
              "map_batch", single, 1, 1, 1),
             ("--index-shards 2 (full tails)", grid, "map_batch", single, 1,
              1, 1),
             ("dp-2", cfg, "map_batch", single, 1, 2, 2),
             ("dp-2 paired", cfg, "map_batch_paired", pairs, 1, 2, 2),
             ("grid 2x2", grid, "map_batch", single, 1, 4, 2),
             ("grid 2x2 paired", grid, "map_batch_paired", pairs, 1, 4, 2))
    mappers, kept, launches, rows = {}, [], {}, []

    def counts():
        return {name: k.launches for name, k in KERNELS.items()}

    for path, c, method, reads, k, n_slots, n_steps in cases:
        where = ([torch.device(device, 0)] * n_slots if n_slots > 1
                 else device)
        if (c.topn, c.index_shards, n_slots) not in mappers:
            if c.index_shards > 1:
                index = ShardedIndex.build(host, genome, c.index_shards,
                                           ShardedIndex.halo_for(c))
                graph = Mapper(c, Codes, READ_LEN, index, device=where)
            else:
                graph = Mapper(c, Codes, READ_LEN, device=where)
                index = (graph.state.offsets.cpu().numpy(),
                         graph.state.positions.cpu().numpy())
            mappers.clear()     # one config's pair of mappers at a time
            kept.clear()
            eager = Mapper(c, Codes, READ_LEN, index, device=where)
            eager.graphs = StepGraphs(eager.device, eager=True)
            mappers[c.topn, c.index_shards, n_slots] = (graph, eager)
        graph, eager = mappers[c.topn, c.index_shards, n_slots]
        check(not graph.graphs.eager, f"{path}: the graph mapper is eager")
        lens = np.full(BATCH, READ_LEN, np.int32)
        if k > 1:
            groups = [reads, reads[::-1].copy()]
            lens = np.tile(lens, (k, 1))
        else:
            groups = [reads[0], reads[1]]

        def call(m, codes, lengths):
            if method == "map_batch_scan":
                return m.map_batch_scan(codes, lengths)
            return getattr(m, method)(codes, lengths)

        n_caps = len(graph.graphs.captures)
        first = call(graph, groups[0], lens)
        snap = [t.clone() for _, _, t in _fields(first)]
        kept.append((path, first, snap))
        check(len(graph.graphs.captures) == n_caps + 1,
              f"{path}: the first call captured no graph")
        codes_d = torch.from_numpy(groups[1]).to(device)
        lens_d = torch.from_numpy(lens).to(device)
        torch.cuda.synchronize()
        replays, c0 = graph.graphs.replays, counts()
        torch.cuda.set_sync_debug_mode("error")     # a sync now raises
        try:
            second = call(graph, codes_d, lens_d)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        by_graph = {name: v - c0[name] for name, v in counts().items()}
        check(graph.graphs.replays == replays + 1
              and len(graph.graphs.captures) == n_caps + 1,
              f"{path}: the second call did not replay the first's graph")
        for kp, res, sn in kept:
            for (j, f, t), old in zip(_fields(res), sn):
                check(torch.equal(t, old), f"{kp}: rank {j} field {f} "
                      f"changed after {path}'s replay")
        want = [call(eager, groups[0], lens)]
        torch.cuda.synchronize()
        c1 = counts()
        torch.cuda.set_sync_debug_mode("error")     # the eager step too
        try:
            want.append(call(eager, codes_d, lens_d))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        by_eager = {name: v - c1[name] for name, v in counts().items()}
        need = path_kernels(topn=c.topn > 1)
        check(by_graph == by_eager
              and all((n > 0) == (name in need)
                      for name, n in by_graph.items()),
              f"{path}: a replay launched {by_graph}, the eager step "
              f"{by_eager}")
        for got, ref in zip((first, second), want):
            for (j, f, a), (_, _, b) in zip(_fields(got), _fields(ref)):
                check(torch.equal(a, b),
                      f"{path}: graph and eager differ in rank {j} field {f}")
        recorded, windows = replay_records(
            lambda: call(graph, codes_d, lens_d), by_graph)
        check(recorded == by_graph, f"{path}: a replay under torch.profiler "
              f"recorded kernels {recorded} in each of {windows} windows, "
              f"its capture counted {by_graph}")
        launches[f"graphs {path}"] = (by_graph, n_steps)
        cap = graph.graphs.captures[-1]
        rows.append(
            f"{path}: graph == eager in all fields on 2 "
            f"{'groups' if k > 1 else 'batches'}, replay without sync, "
            f"launches a replay {by_graph} (eager step {by_eager}, "
            f"profiled replay {recorded}, window {windows}); graph pool +"
            f"{cap['pool_bytes'] / 2**20:.1f} MiB")
    mappers.clear()
    kept.clear()
    torch.cuda.empty_cache()
    print(f"[19 graphs] one captured graph per step ({card}): "
          + "; ".join(rows))
    return launches


GRAPHS_TIMEOUT_S = 900   # phase 19's process, set-up included


def graphs_child():
    """Phase 19 in a process of its own (this script with --graphs), on
    phase 6's genome: its line, then one JSON line {"graphs": {path:
    [kernel launches of a replay, steps in it]}}.  Late in this script's
    own process torch.profiler stopped recording some kernels (K5, K6 and
    torch's own spin kernel) in every window while it recorded the rest
    of a replay's nodes; a fresh process records them all (PERF.md §6,
    PR 15), so the phase that counts a replay's records runs in one."""
    import torch

    from nextgenmap_tpu_torch import cli, synthetic

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    check(torch.cuda.is_available(), "phase 19's process sees no card")
    cfg = cli.parse(map_argv("."))[2]
    genome = synthetic.repeat_genome(GENOME_SIZE, n_repeats=120, min_len=1000,
                                     max_len=2000, seed=SEED)
    guard_plain_traceback()
    guard_plain_front()
    launches = phase_graphs(genome, cfg, card)
    check("jax" not in sys.modules and not any(
        m == "nextgenmap_tpu" or m.startswith("nextgenmap_tpu.")
        for m in sys.modules), "phase 19's process imported the JAX package")
    print(json.dumps({"graphs": {path: [counts, n] for path, (counts, n)
                                 in launches.items()}}))
    return 0


def phase_graphs_process():
    """Runs graphs_child; prints its phase line, returns {path: (kernel
    launches of a replay, steps in it)}."""
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--graphs"], cwd=repo,
        capture_output=True, text=True, timeout=GRAPHS_TIMEOUT_S)
    check(proc.returncode == 0, f"phase 19's process exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    for ln in lines:
        if ln.startswith("[19 "):
            print(ln, flush=True)
    return {path: (counts, n) for path, (counts, n)
            in json.loads(lines[-1])["graphs"].items()}


# the summary's kernels: (wrapper, source, the TPU code it replaces, and
# what that code is where it is not a Pallas kernel)
KERNEL_ROWS = (
    ("score_pass", "nextgenmap_tpu_torch/csrc/sw_score.cu",
     "nextgenmap_tpu/ops/sw_pallas.py:150",
     "the Pallas SW score kernel and, around it, the XLA-fused slot "
     "compaction, corridor gather and scatter of "
     "nextgenmap_tpu/models/mapper.py:214 _score_candidates"),
    ("finish_pass", "nextgenmap_tpu_torch/csrc/sw_align.cu",
     "nextgenmap_tpu/models/mapper.py:304",
     "not a Pallas kernel: the reference's XLA-fused _finish (the winner's "
     "corridor gather, the lax.scan traceback banded_sw_align, the filters "
     "and MAPQ)"),
    ("gather_windows", "nextgenmap_tpu_torch/csrc/gather_windows.cu",
     "nextgenmap_tpu/ops/gather_pallas.py:124", None),
    ("row_gather", "nextgenmap_tpu_torch/csrc/row_gather.cu",
     "tools/probe_dyngather.py:51", None),
    ("sw_align", "nextgenmap_tpu_torch/csrc/sw_align.cu",
     "nextgenmap_tpu/ops/sw_ref.py:209",
     "not a Pallas kernel: the reference's lax.scan traceback "
     "(banded_sw_align, scans at :289 and :451)"),
    ("read_kmers", "nextgenmap_tpu_torch/csrc/read_kmers.cu",
     "nextgenmap_tpu/models/mapper.py:85",
     "not a Pallas kernel: XLA-fused code under jax.jit (_pre_extract with "
     "ops/kmer.py:149 extract_kmers_canonical and :88 extract_kmers)"),
    ("cand_search", "nextgenmap_tpu_torch/csrc/cand_search.cu",
     "nextgenmap_tpu/ops/candidate.py:642",
     "not a Pallas kernel: XLA-fused code under jax.jit "
     "(candidate_search_canonical :642 and candidate_search_dual :560, "
     "through _compact_hits :359 and _select_candidates :487)"),
)


def main():
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "nextgenmap_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(nextgenmap_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    if sys.argv[1:2] == ["--child"]:
        return child(sys.argv[2:])
    if sys.argv[1:2] == ["--graphs"]:
        return graphs_child()
    card = phase_card()
    import torch

    from nextgenmap_tpu_torch import cli, synthetic

    phase_build()
    cfg = cli.parse(map_argv("."))[2]
    rng = np.random.default_rng(SEED)
    genome = synthetic.repeat_genome(GENOME_SIZE, n_repeats=120, min_len=1000,
                                     max_len=2000, seed=SEED)
    phase_gather(torch.from_numpy(genome).cuda(), rng, card)
    phase_sw(rng, cfg, card)
    phase_align(rng, cfg, card)
    phase_front(card)
    phase_cand_search(card, genome, cfg)
    torch.cuda.empty_cache()
    k3_launches = phase_row_gather(card)
    guard_plain_traceback()
    guard_plain_front()
    codes, launches = {}, {}     # launches: {path: (counts, steps)}
    with tempfile.TemporaryDirectory() as workdir:
        ref_path = os.path.join(workdir, "ref.fa")
        synthetic.write_fasta(ref_path, "chr", genome)
        for path, phase in (("single", phase_main_path),
                            ("paired", phase_paired_path),
                            ("topn", phase_topn_path),
                            ("end-to-end", phase_e2e_path),
                            ("bisulfite", phase_bisulfite_path),
                            ("long", phase_long_path)):
            codes[path], launches[path] = phase(genome, workdir)
        phase_cuda_equals_cpu(genome, codes, cfg, ref_path)
        sharded, sharded_memory = phase_sharded_cli(
            genome, workdir, codes["single"], cfg, card)
        launches.update(sharded)
        launches["gigabase-4"] = phase_gigabase(card)
        launches.update(phase_runtime(workdir))
        launches.update(phase_parallel(workdir, sharded_memory))
    launches["bench"] = phase_bench(card)
    launches["graft"] = phase_graft(card)
    torch.cuda.empty_cache()
    launches.update(phase_graphs_process())
    check("jax" not in sys.modules, "the port imported jax")
    reference = sorted(m for m in sys.modules if m == "nextgenmap_tpu"
                       or m.startswith("nextgenmap_tpu."))
    check(not reference, f"the port imported the JAX package: {reference}")

    kernels = []
    for name, source, replaces, kind in KERNEL_ROWS:
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces}
        if kind:
            row["replaces_kind"] = kind
        if name == "row_gather":
            row.update(launches=k3_launches,
                       launches_per_step={"probe_dyngather": k3_launches})
        else:
            row.update(launches=sum(n[name] for n, _ in launches.values()),
                       launches_per_step={path: n[name] / s for path, (n, s)
                                          in launches.items()})
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
