#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (nextgenmap_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, and outside a checkout of
the repository).  Phases, one line of output each:

  1. card     the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    nvcc builds the six hand-written kernels from the checkout,
              and g++ the port's host IO library
  3. K2       gather kernel == its plain PyTorch version on the card (exact),
              at 2048x148, 4096x148, 4096x206 and the long reads' 614x1184,
              with windows past the end; device time, call time, bound
              (bytes), share, and the one-call library yardstick
              (index_select on an unfold view of the padded genome)
  4. K1       SW score kernel == its plain version on the card (exact) at
              the main path's shapes (all 2048 slots, and 650 real ones with
              the rest at length 0), the long-read bands and a tie-heavy
              periodic input, local and glocal (--end-to-end), and at the
              wide bands: [2048,100]xW264 (--corridor 225), [256,1500]xW264
              and [128,3000]xW488 (long reads), W 512 (one warp, 32 x 16
              cells) and W 520, 1024 and 2048 (a block of warps), each
              local, glocal and tie-heavy; device time, call time, bound
              (integer operations), share and GCUPS
  4b. K4      SW with traceback == its plain version on the card (exact, in
              all 11 AlignResult fields, and in the [L, S, W] direction
              bytes when they are asked for) on each of its routes (smem,
              global) at the card tests' main shapes: [4096,100]xW48 (what
              the single-end path's traceback takes), [2048,150]xW56,
              [614,1000]xW184 and [2048,100]xW264, local and glocal, with
              the bisulfite matrices, tie-heavy slots, length-0 slots and a
              truncating op buffer; the route the shape rule picks, and per
              route the block it launches, the blocks (warps) of that size
              an SM holds, the route's capacity (warps an SM at blocks of
              up to 4 warps, which the rule reads), the global route's
              scratch bytes, device time, the forward pass's alone (a matrix of negative entries: no walk
              starts) and call time, all as the mapping path calls it (no
              direction bytes); the plain version's call time, bound
              (operations or bytes, the larger) and share
  4c. K5      the read front end == its plain version on the card (exact
              in the rc and every k-mer output) at [4096,100], [4096,150]
              and [614,1000] canonical, two strands and bisulfite with a
              --bs-cutoff, k 13, stride 2, every batch with reads below L,
              N bases, a poly-A and a tandem-repeat read and reads at
              genome positions 1..k; device time, call time, bound
              (bytes), share, the plain version's call time
  4d. K6      candidate search == its plain version on the card (exact in
              every Candidates field) on each of its routes that takes the
              shape: the bench's own input (4.6 Mbp random genome, packed,
              H 128: the main row), phase 6's repeat genome at the rule's
              H (canonical packed, plain CSR, 1000 bp, bisulfite with two
              tables), bisulfite at the collapsed ceiling H 4608, two
              strands at H 8200 (the global route only), and a tandem-
              repeat read that moves all three overflow counters (C 2);
              negative diagonal buckets; the rule's route, each route's
              block, device time, call time, bound (bytes), share, the
              plain version's call time and, as a partial yardstick, one
              torch.sort of [B, 2H] int32 votes
  5. K3       the dynamic-gather probe's kernel == its plain version (exact)
              at the probe's default 256 x 1024 and at its use case at the
              mapper's batch, 4096 x 2048, REP 32, along dim 0 and 1, with
              its bound (bytes), its shared-memory gather floor,
              torch.gather's time at REP 1 and an empty kernel's; then the
              probe's entry point, which launches it, at both shapes
  6. single   the port's CLI maps 3 x 4096 simulated 100 bp reads (2% SNPs)
              against a 4.6 Mbp genome with planted repeats (E. coli K-12
              scale) on the card; >= 99% mapped, >= 95% truth-correct, the
              score pass and the finish pass launched by that run and no
              K2 or K4, real candidates scored; the score pass on the
              inputs of the run's first step == its plain version on CPU
              copies of them (exact in sw, slot_overflow, n_sc and base),
              with its device time (the plan and the pass kernels), call
              time, bound (K1's integer operations over the slots it
              scores), share and the former card path's device time
              (torch's compaction, K2, K1) there; the finish pass likewise
              (exact in all 17 MapResult fields; bound: K4's over every
              read; the former card path: torch's gathers and filters, K2
              and K4)
  7. paired   the CLI's -1/-2 maps 2 x 4096 reads (2048 FR pairs a batch,
              insert 350 +- 40) on the same genome; >= 99% mapped, >= 95%
              truth-correct per mate, >= 90% of pairs proper, the score
              pass and the finish pass launched, real slots scored; the
              score pass and the finish pass on the first step's inputs
              (its pair mask, its pairs' verdicts) as in phase 6
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
              phase 6 at the pool's input, K2 at the flattened [S*Gs]
              genome on the windows the pool's finish reads
 13b. finish  the finish pass timed on the inputs phases 6, 7 and 13 saved,
              in a process of its own (this script with --finish-timing):
              device time, call time, bound, share and the former card
              path's device time and records
 14. gigabase a 2^31 + 2^27 base (2.28 Gbp) genome drawn as uint8 from the
              seed with the same 120 planted repeats, past 2^31 so no
              unsharded path can hold it: host KmerIndex (k 13, skip 2,
              native passes; canonical entries fall away), split into 4
              shards, 2 x 4096 reads (2% SNPs) through Mapper.map_batch on
              the card with full per-shard tails; >= 99% mapped, >= 95%
              truth-correct, some global positions past 2^31, K1 and the
              finish pass launched by every shard's tail, K5 once and K6 once a
              shard a step; K6 == its plain version on both routes on the
              arguments the shard loop gave it for shard 0, timed; seconds
              of each stage, the peak device memory and the process's peak
              host memory
 15. runtime  the CLI on phase 6's reads with -t 1, -t 2 and -t 4 (SAMs
              equal to phase 6's, the same alignment and cell counters),
              phase 7's pairs with -t 4 (SAM equal to phase 7's), --megabatch
              4 -t 4, --bam (records, decoded by read_bam, equal to the SAM's
              first 11 fields), an interrupted run (one batch, its sidecar
              marked incomplete, a partial record appended) completed by
              --resume, --profile (the trace names K1, the finish pass, K5
              and K6), and
              --corridor 225 (W 264) on 1,024 reads equal to the CPU's SAM;
              host-inclusive and streaming reads/s, GCUPS, the device step
              (CUDA events) and phase seconds of each run
 16. parallel eight CLI processes on the card at once (this script with
              --child: the CLI, run_cli's checks, one JSON line): two of
              --dist-nprocs 2 on phase 6's reads (merged SAM equal to
              phase 6's), two with --bam (records equal to phase 6's SAM),
              two on phase 7's pairs (equal to phase 7's), and two of
              --shard-across-hosts --index-shards 2 --dist-nprocs 2 joined
              by a gloo group on localhost (SAM equal to phase 13's
              sharded-2, each holding only its shard, two graph replays a
              batch in each: the CS, then the tails); K1 and the finish
              pass once a batch in each, and each one's peak device memory against
              phase 13's sharded-2 run.  Then the dp step on the slots
              [cuda:0, cuda:0] (run_mapping; the two slices one graph, one
              replay a batch, K1 and the finish pass once a slice) on phases 6 and 7's
              inputs, SAM equal to theirs, reads/s and the device step
              beside phase 15's -t 1; --devices 2 through the CLI where the
              machine has two cards, else a line saying it has one
 17. bench    the port's bench, python -m nextgenmap_tpu_torch.bench, in a
              fresh process at its full size (root bench.py's workload: a
              4.6 Mbp random genome, 36 batches of 4096 100 bp reads at 2%
              SNPs, the fit over 12 and 36 batches): exactly one stdout
              line with bench.py's four keys, >= 99% mapped and >= 95%
              truth-correct of the 147,456 timed reads, GCUPS > 0, K1 and
              the finish pass launched and no K2 or K4 (its stderr's
              bench-json line); then in this
              process a 2-batch sweep of its step under
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
              torch.profiler stopped recording some kernels;
              a bare replay of the graph under torch.profiler (its device
              nodes, its kernels, the device's busy share) and the eager
              step's records and busy share; host ms a batch, eager
              against graph, in alternating rounds over the same batches;
              each capture's seconds and graph-pool bytes

Every mapping path from phase 6 on runs its steps through step graphs, as
the CLI does by default, the dp and grid steps included.
The kernel wrappers count a launch where they launch; a graph's replay adds
the launches its capture recorded (phase 19 holds that against the kernel
records of a replay under torch.profiler), and the eager warm-up step before each
capture counts as the step it is, so a run of N batches launches each
kernel per node N + (graphs captured) times (a --megabatch K run: N
rounded up to K); "launches_per_step" divides by those steps.

A kernel's device time (device_ms, also "ms" in the summary) comes from
torch.profiler (nextgenmap_tpu_torch/tools/timing.py): the device time of
the kernels launched in a window of calls, from the kernels' own rows only,
divided by the launches it recorded.  call_ms is the wrapper's wall time per
call (CUDA events around one call: host checks, allocation, the launch).
The score pass's row ("score_pass": score_plan_kernel and score_pass_kernel
of csrc/sw_score.cu, whose row loops are K1's) is the pass at the inputs
phase 6's first step gave it; the paired path's and the sharded pool's are
under its "other_shapes", and so is K1 launched alone at phase 4's shapes
("K1 alone, ..."), which no mapping path launches; "former_device_ms" and
"former_records" are the device time and records a call of the former card
path (torch's compaction, K2, K1) on the same inputs, from all its device
records over a window of calls (some of its kernels run more than once a
call).  The finish pass's row ("finish_pass": sw_align_finish_kernel of
csrc/sw_align.cu, K4 with its prologue and epilogue) is likewise the pass
at phase 6's first step's inputs, the paired path's and the sharded
pool's under its "other_shapes", timed in phase 13b's process of its own;
its former card path is torch's gathers,
the second best, K2, the strand select, K4, the filters and MAPQ.  K2 and
K4 are launched on the mapping paths only by top-n.  K2's
flattened-genome launch (the windows of the pool's finish) is under
"other_shapes" of K2.  K3's row is dim 0 at the probe's
default shape (the slower dim); dim 1 and the 4096 x 2048 shape are under
its "other_shapes", each with the variant that served it.  K4's row is
the single-end path's traceback input ([4096,100]xW48, local); its other
shapes are under "other_shapes"; "variant" is the route the shape rule
took there, and "routes" the figures of both routes: each with the
block it launched (threads), the blocks and warps of that size an SM holds,
and the route's capacity (warps an SM at blocks of up to 4 warps, which the
shape rule reads).  K5's row is the single-end path's [4096,100] canonical
input; K6's row the bench's input on the rule's route ("variant"), with
both routes under "routes" and its other shapes, one gigabase shard's
among them, under "other_shapes".
bound_ms is the least time the card could take: for K2 and K3 the bytes
moved (each input byte read once, each output byte written once) over
3.35 TB/s; for K1 the integer instructions its cells need (OPS_PER_CELL per
cell of each real slot's qlen x W) over 132 SMs x 64 INT32 lanes x the
card's maximum SM clock (nvidia-smi), and for the score pass the same
over the slots it scores (each read's slots under the cap); for K4 the larger of its integer
instructions (K4_OPS_PER_CELL of its mode per cell of each real slot's
qlen x W, as for K1) at that rate and its bytes (inputs read once, the
op buffer and the fields written once; the mapping path's call writes no
direction bytes) over 3.35 TB/s; for K5 its bytes (the codes and lengths
read once, the rc and the k-mer arrays written once); for K6 the bytes
this run's data needs (an offsets entry of each valid k-mer column, 8
bytes, 4 a hit position kept, the k-mers in, the Candidates out) over
3.35 TB/s.  K5's and K6's library_ms is null: no one PyTorch call computes
either; K6's row carries "sort_ms", one torch.sort of [B, 2H] int32 votes,
as a partial yardstick.
share = bound_ms / device_ms.

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
before the last is a JSON summary of the kernels; the last line is
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
GRAPH_BATCHES = 4       # phase 19: batches a timed round (one --megabatch 4
GRAPH_ROUNDS = 4        # group), and the rounds, eager and graph in turn


def check(ok, what):
    if not ok:
        raise RuntimeError(what)


HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, published peak
INT32_LANES = 132 * 64         # SMs x INT32 lanes per SM per clock (sm_90)
OPS_PER_CELL = 6               # K1: integer instructions per DP cell
                               # (csrc/sw_score.cu's note counts them)
# K4's forward pass, by mode (csrc/sw_align.cu's note counts them)
K4_OPS_PER_CELL = {"local": 20, "glocal": 18}
# K4: the card tests' main shapes (single-end 100 and 150 bp, 1000 bp,
# --corridor 225), the first what the single-end path's traceback takes
K4_SHAPES = ((4096, 100, 48), (2048, 150, 56), (614, 1000, 184),
             (2048, 100, 264))
K4_MAIN = "local [4096,100]xW48"
# K3: the probe's default shape, and its use case at the mapper's batch
K3_SHAPES = ((256, 1024), (4096, 2048))
K3_REP = 32
K3_MAIN = "256x1024 REP 32 dim 0"


def sm_clock_hz():
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def timing_row(dev_ms, c_ms, bound, extra=""):
    return (f"device {dev_ms * 1e3:.2f} us, call {c_ms * 1e3:.2f} us, bound "
            f"{bound * 1e3:.3f} us, share {bound / dev_ms:.3f}{extra}")


def max_abs_err(got, ref):
    return max(int((g.long() - r.long()).abs().max()) if g.numel() else 0
               for g, r in zip(got, ref))


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
    t0 = time.perf_counter()
    cached = os.path.exists(build.library_path())
    path = build.build()
    build.load()
    t1 = time.perf_counter()
    host = hostio.lib() is not None      # g++ of the host IO library
    print(f"[2 build] {t1 - t0:.2f} s ({'cached' if cached else 'nvcc'}) -> "
          f"{os.path.relpath(path, repo)}; host IO library "
          f"{'built' if host else 'absent (Python paths)'} in "
          f"{time.perf_counter() - t1:.2f} s")


def phase_gather(genome_dev, rng, card):
    import torch

    from nextgenmap_tpu_torch.ops.gather import gather_windows, pad_table
    from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
    from nextgenmap_tpu_torch.tools.timing import call_ms, device_ms

    G = genome_dev.shape[0]
    err = 0
    rows, main = [], None
    for n, T in ((2048, 148), (4096, 148), (4096, 206), (LONG_BATCH, 1184)):
        s = rng.integers(0, G + 1, n).astype(np.int32)
        s[:6] = [0, G - T, G - T + 1, G - T // 2, G - 1, G]   # past the end too
        starts = torch.from_numpy(s).cuda()
        padded = pad_table(genome_dev, T, 4)      # the yardstick's table
        k = lambda: gather_genome_windows(genome_dev, starts, T)  # noqa: E731
        p = lambda: gather_windows(pad_table(genome_dev, T, 4), starts, T)  # noqa: E731
        lib = lambda: padded.unfold(0, T, 1).index_select(0, starts)  # noqa: E731
        got, ref, yard = k(), p(), lib()
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"K2 differs from plain at {n}x{T}")
        check(torch.equal(yard, ref), f"the K2 yardstick differs at {n}x{T}")
        err = max(err, max_abs_err([got], [ref]))
        t = {"device_ms": device_ms(k), "call_ms": call_ms(k, 50),
             "plain_ms": call_ms(p, 50), "library_ms": device_ms(lib),
             "bound_ms": 1e3 * (2 * n * T + 4 * n) / HBM_BYTES_PER_S}
        rows.append(f"{n}x{T}: " + timing_row(
            t["device_ms"], t["call_ms"], t["bound_ms"],
            f", library {t['library_ms'] * 1e3:.2f} us, plain call "
            f"{t['plain_ms'] * 1e3:.2f} us"))
        if main is None:
            main = t
    print(f"[3 K2 gather] exact at every shape ({card}; share against "
          f"3.35 TB/s); " + "; ".join(rows))
    return err, main


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
    from nextgenmap_tpu_torch.tools.timing import call_ms, device_ms

    ops_per_s = INT32_LANES * sm_clock_hz()
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
    err = 0
    rows = []
    timings = {}
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
        k = lambda: sw_score(*args, *gaps, ms, band=W, mode=mode)  # noqa: E731
        p = lambda: banded_sw_score(*args, *gaps, ms, band=W, mode=mode)  # noqa: E731
        got, ref = k(), p()
        torch.cuda.synchronize()
        shape = f"{mode} [{S},{L}]xW{W}" + (" 2 general mats" if general
                                           else "")
        if real is not None:
            shape += " tie-heavy" if real == "ties" else f" ({real} real)"
        for name, a, b in zip(("score", "end_i", "end_o"), got, ref):
            check(torch.equal(a, b), f"K1 {name} differs from plain at {shape}")
        check(int(got.score.max()) > 0, f"K1 scored nothing at {shape}")
        err = max(err, max_abs_err(got, ref))
        cells = int(np.clip(lens, 0, L).astype(np.int64).sum()) * W
        # the plain version runs a loop of torch calls per row: one timed
        # call (after the one above) where L rows take seconds
        long = L >= 1000
        t = {"device_ms": device_ms(k), "call_ms": call_ms(k, 20),
             "plain_ms": call_ms(p, 1 if long else 3, warmup=0 if long else 1),
             "bound_ms": 1e3 * OPS_PER_CELL * cells / ops_per_s}
        t["gcups"] = cells / (t["device_ms"] * 1e-3) / 1e9
        rows.append(f"{shape}: " + timing_row(
            t["device_ms"], t["call_ms"], t["bound_ms"],
            f", {t['gcups']:.2f} GCUPS, plain call {t['plain_ms']:.3f} ms"))
        timings.setdefault(shape, t)
    print(f"[4 K1 sw_score] exact at every shape ({card}; bound: "
          f"{OPS_PER_CELL} int ops/cell at {ops_per_s / 1e12:.2f} T/s); "
          + "; ".join(rows))
    return err, timings


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
    _backwalk_rows's fields) and timed on each of its routes, at the card
    tests' main shapes."""
    import torch

    from nextgenmap_tpu_torch.models.mapper import score_matrices
    from nextgenmap_tpu_torch.ops.sw_align_kernel import (
        ROUTES, plan, sw_align, sw_align_with_dirs,
    )
    from nextgenmap_tpu_torch.ops.sw_ref import (
        _backwalk_rows, banded_sw_align, banded_sw_forward,
    )
    from nextgenmap_tpu_torch.tools.timing import call_ms, device_ms

    ops_per_s = INT32_LANES * sm_clock_hz()
    bs_mats = score_matrices(cfg.replace(bs_mapping=True))
    gaps = (cfg.gap_read_penalty, cfg.gap_ref_penalty, cfg.gap_extend_penalty)
    err, rows, timings = 0, [], {}
    for S, L, W in K4_SHAPES:
        for mode in ("local", "glocal"):
            q, lens, r, msel = _align_inputs(rng, S, L, W)
            main = (S, L, W) == K4_SHAPES[0]
            mats = score_matrices(cfg) if main else bs_mats
            args = [torch.from_numpy(a).cuda() for a in (q, lens, r, mats)]
            # every entry below 0: no cell scores above 0, so no walk
            # starts, while the forward pass runs the same rows
            no_walk = args[:3] + [-args[3].abs() - 1]
            ms = torch.from_numpy(msel).cuda()
            shape = f"{mode} [{S},{L}]xW{W}" + ("" if main else " bs mats")
            want_dirs, best, bi, bo = banded_sw_forward(
                *args, *gaps, ms, band=W, mode=mode)
            rule = plan(S, L, W, mode).route
            cells = int(np.clip(lens, 0, L).astype(np.int64).sum()) * W
            by_route = {}
            for route in ROUTES:
                p = plan(S, L, W, mode, route)
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
                    err = max(err, max_abs_err(list(got), list(want)),
                              max_abs_err(list(bare), list(want)),
                              max_abs_err([dirs], [want_dirs]))
                check(bool(bare.trunc.any()), f"max_ops 12 truncated nothing "
                      f"at {shape}")
                full = sw_align(*args, *gaps, ms, band=W, mode=mode,
                                route=route)
                check(int(full.score.max()) > 0 and int(full.indels.sum()) > 0,
                      f"K4 {route} aligned nothing, or no gap, at {shape}")
                k = (lambda route=route: sw_align(  # noqa: E731
                    *args, *gaps, ms, band=W, mode=mode, route=route))
                by_route[route] = {
                    "device_ms": device_ms(k), "call_ms": call_ms(k, 20),
                    # the forward pass alone, on the same rows
                    "forward_ms": device_ms(lambda route=route: sw_align(
                        *no_walk, *gaps, ms, band=W, mode=mode,
                        route=route)),
                    "threads": p.threads,
                    "blocks_per_sm": p.blocks_per_sm,
                    "warps_per_sm": p.warps_per_sm,
                    "route_warps_per_sm": p.route_warps_per_sm,
                    "smem_bytes": p.smem_bytes,
                    # the global route's packed rows, [S, L, row_bytes]
                    "scratch_bytes": (S * L * p.row_bytes
                                      if route == "global" else 0)}
            walked = int(full.n_ops.sum())
            # inputs (query, corridors, qlen, msel) read once, the ops and
            # the fields written once: no direction bytes on this call
            n_bytes = S * L + S * (L + W) + 8 * S + S * (L + W) + 37 * S
            bound_ops = 1e3 * K4_OPS_PER_CELL[mode] * cells / ops_per_s
            bound_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
            long = L >= 1000
            t = dict(by_route[rule])
            t.update({
                "variant": rule, "routes": by_route,
                "plain_ms": call_ms(lambda: banded_sw_align(
                    *args, *gaps, ms, band=W, mode=mode), 1,
                    warmup=0 if long else 1),
                "bound_ms": max(bound_ops, bound_bytes),
                "bound_by": ("operations" if bound_ops >= bound_bytes
                             else "bytes"),
                "walk_steps": walked})
            rows.append(f"{shape}: rule {rule}; " + "; ".join(
                f"{route} device {v['device_ms'] * 1e3:.2f} us, forward pass "
                f"alone {v['forward_ms'] * 1e3:.2f} us, call "
                f"{v['call_ms'] * 1e3:.2f} us, launched {v['threads']} "
                f"threads a block, {v['blocks_per_sm']} blocks "
                f"({v['warps_per_sm']} warps) an SM at {v['smem_bytes']} B, "
                f"route capacity {v['route_warps_per_sm']} warps an SM"
                + (f", scratch {v['scratch_bytes']} B" if route == "global"
                   else "")
                for route, v in by_route.items())
                + f"; [L, S, W] bytes {L * S * W}"
                + f"; bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}; "
                f"ops {bound_ops * 1e3:.3f} us, bytes "
                f"{bound_bytes * 1e3:.3f} us), share "
                f"{t['bound_ms'] / t['device_ms']:.3f}, {walked} ops walked, "
                f"plain call {t['plain_ms']:.3f} ms")
            timings[shape] = t
    print(f"[4b K4 sw_align] exact on both routes in all 11 fields, with and "
          f"without the direction bytes, at every shape, full and truncating "
          f"op buffers ({card}; bound: {K4_OPS_PER_CELL['local']} (local) "
          f"or {K4_OPS_PER_CELL['glocal']} (glocal) int ops per real cell "
          f"at {ops_per_s / 1e12:.2f} T/s, or bytes at 3.35 TB/s); "
          + "; ".join(rows))
    return err, timings


# K5 (the read front end): (B, L, form, --bs-cutoff), the first the main
# path's input; every batch has reads with N bases and below L
K5_SHAPES = ((4096, 100, "canonical", 0), (4096, 150, "canonical", 0),
             (LONG_BATCH, 1000, "canonical", 0), (4096, 100, "strands", 0),
             (4096, 100, "bisulfite", 3))
K5_MAIN = "canonical [4096,100] k13 stride 2"
K6_MAIN = "bench canonical packed [4096,100] H128"


def front_bytes(B, L, Q, canonical):
    """K5's bytes: the codes and lengths read once, the rc and the k-mer
    arrays written once (canonical 9 bytes a window, two strands 10)."""
    return B * L + 4 * B + B * L + B * Q * (9 if canonical else 10)


def phase_front(card):
    """Phase 4c: K5 against its plain version (exact in every output) and
    timed at K5_SHAPES."""
    import torch

    from nextgenmap_tpu_torch import synthetic
    from nextgenmap_tpu_torch.ops.kmer_kernel import (
        n_windows, read_kmers, read_kmers_plain,
    )
    from nextgenmap_tpu_torch.tools.timing import call_ms, device_ms

    g, runs = synthetic.front_genome(1_000_000, seed=SEED)
    err, rows, timings = 0, [], {}
    for B, L, form, cut in K5_SHAPES:
        bs = form == "bisulfite"
        codes, lens = synthetic.front_reads(g, B, L, runs=runs, seed=B + L,
                                            bisulfite=bs)
        r, n = torch.from_numpy(codes).cuda(), torch.from_numpy(lens).cuda()
        kw = dict(k=13, stride=2, bs=bs, bs_cutoff=cut,
                  canonical=form == "canonical")
        k = lambda: read_kmers(r, n, **kw)  # noqa: E731
        p = lambda: read_kmers_plain(r, n, **kw)  # noqa: E731
        got, want = k(), p()
        torch.cuda.synchronize()
        got, want = [got[0], *got[1]], [want[0], *want[1]]
        shape = (f"{form} [{B},{L}] k13 stride 2"
                 + (f" cutoff {cut}" if cut else ""))
        for i, (a, b) in enumerate(zip(got, want)):
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"K5 output {i} differs from plain at {shape}")
        err = max(err, max_abs_err(got, want))
        Q = n_windows(L, 13, 2)
        t = {"device_ms": device_ms(k), "call_ms": call_ms(k, 50),
             "plain_ms": call_ms(p, 20),
             "bound_ms": 1e3 * front_bytes(B, L, Q, form == "canonical")
             / HBM_BYTES_PER_S}
        timings[shape] = t
        rows.append(f"{shape}: " + timing_row(
            t["device_ms"], t["call_ms"], t["bound_ms"],
            f", plain call {t['plain_ms'] * 1e3:.2f} us"))
    print(f"[4c K5 read_kmers] exact in the rc and every k-mer output at "
          f"every shape ({card}; bound: bytes at 3.35 TB/s); "
          + "; ".join(rows))
    return err, timings


def cand_bytes(kms, lengths, offsets, positions, max_freq, *, packed,
               split, fanout_cap, hit_cap, max_cmrs):
    """K6's bytes for this data: an offsets entry of each valid k-mer
    column (8 bytes packed, the CSR pair 8 unpacked), 4 a hit position
    kept (min(total, H) a read), the k-mers and lengths read once, the
    Candidates written once."""
    import torch

    from nextgenmap_tpu_torch.ops.candidate import _compact_hits

    dual = len(kms) == 4
    B, Q = kms[0].shape
    if dual:
        km = torch.stack([kms[0], kms[2]], dim=2).reshape(B, 2 * Q)
        ok = torch.stack([kms[1], kms[3]], dim=2).reshape(B, 2 * Q)
    else:
        km, ok = kms[0], kms[2]
    valid = _compact_hits(km, ok, offsets, positions, max_freq,
                          fanout_cap=fanout_cap, hit_cap=hit_cap,
                          packed_offsets=packed, table_split=split)[2]
    n_in = sum(t.numel() * t.element_size() for t in kms) + 4 * B
    Cw = min(max_cmrs, 2 * hit_cap)
    return (8 * int(ok.sum()) + 4 * int(valid.sum()) + n_in
            + 3 * 4 * B * Cw + 2 * 4 * B + 12)


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


def shard_cand_search(call):
    """K6 against its plain version, exact on both routes, and timed, on
    the arguments the gigabase shard loop gave it for shard 0 (a shard's
    plain CSR of 4^13 + 1 int32 offsets and its positions)."""
    import torch

    from nextgenmap_tpu_torch.ops.candidate_kernel import candidate_search
    from nextgenmap_tpu_torch.tools.timing import call_ms, device_ms

    a, kw = call
    kms, n, off, pos, sens, max_freq = a
    want = cand_plain(*a, **kw)
    out = {}
    for route in ("smem", "global"):
        k = lambda route=route: candidate_search(*a, route=route, **kw)  # noqa: E731
        got = k()
        torch.cuda.synchronize()
        for f in want._fields:
            check(torch.equal(getattr(got, f), getattr(want, f)),
                  f"K6 {route} {f} differs from plain at a gigabase shard")
        out[route] = (device_ms(k), call_ms(k, 50))
    B, Q = kms[0].shape
    return {"shape": f"one shard of the 2.28 Gbp layout, [{B},{Q}] k-mers, "
                     f"CSR {off.numel()} offsets, {pos.numel()} positions, "
                     f"H{kw['hit_cap']}",
            "device_ms": out["smem"][0], "call_ms": out["smem"][1],
            "global_ms": out["global"][0],
            "plain_ms": call_ms(lambda: cand_plain(*a, **kw), 5),
            "bound_ms": 1e3 * cand_bytes(
                kms, n, off, pos, max_freq, packed=kw["packed_offsets"],
                split=kw["dual_tables"], fanout_cap=kw["fanout_cap"],
                hit_cap=kw["hit_cap"], max_cmrs=kw["max_cmrs"])
            / HBM_BYTES_PER_S,
            "err": max_abs_err(list(got), list(want))}


def time_cand_search(call, plain, kms, H, shape, route):
    """K6 on `route` against the plain version (exact in every field) and
    its timing; returns (its Candidates, the timing dict)."""
    import torch

    from nextgenmap_tpu_torch.ops.candidate_kernel import plan
    from nextgenmap_tpu_torch.tools.timing import call_ms, device_ms

    k = lambda: call(route)  # noqa: E731
    got, want = k(), plain()
    torch.cuda.synchronize()
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"K6 {route} {f} differs from plain at {shape}")
    B, Q = kms[0].shape
    p = plan(B, Q, len(kms) == 4, H, route)
    return got, {"device_ms": device_ms(k), "call_ms": call_ms(k, 50),
                 "threads": p.threads, "reads_a_block": p.reads,
                 "smem_bytes": p.smem_bytes, "scratch_bytes": 4 * p.scratch,
                 "err": max_abs_err(list(got), list(want))}


def phase_cand_search(card, genome, cfg):
    """Phase 4d: K6 against its plain version (exact in every field) on
    both routes where each takes the shape, and timed: the bench's input,
    phase 6's repeat genome at the rule's H (canonical packed and plain
    CSR, 1000 bp, bisulfite with two tables at the rule's H and at the
    collapsed ceiling 4608), an H past the smem route, and a batch whose
    tandem-repeat read moves all three overflow counters."""
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
    from nextgenmap_tpu_torch.tools.timing import call_ms, device_ms

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

    # (label, table, reads, form, H, C): the first the main row
    check(w.statics["hit_cap"] == 128 and w.statics["packed_offsets"],
          f"the bench's H is {w.statics['hit_cap']}, not 128")
    cases = [
        (K6_MAIN, "bench", (bench_reads, w.lens), "canonical", 128,
         cfg.max_cmrs),
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
    err, rows, timings = 0, [], {}
    for shape, tab, (r, n), form, H, C in cases:
        bs = form == "bisulfite"
        off_t, pos_t, packed = tabs[tab]
        _, kms = read_kmers(r, n, k=cfg.kmer, stride=cfg.read_kmer_skip,
                            bs=bs, bs_cutoff=0, canonical=form == "canonical")
        statics = dict(k=cfg.kmer, fanout_cap=cfg.max_kmer_fanout,
                       hit_cap=H, max_cmrs=C,
                       diag_bin_log2=cfg.diag_bin_log2,
                       stride=cfg.read_kmer_skip, packed_offsets=packed)

        def call(route, kms=kms, n=n, off_t=off_t, pos_t=pos_t, bs=bs,
                 statics=statics):
            return candidate_search(kms, n, off_t, pos_t, sens,
                                    cfg.max_kmer_freq, dual_tables=bs,
                                    route=route, **statics)

        def plain(kms=kms, n=n, off_t=off_t, pos_t=pos_t, bs=bs,
                  statics=statics):
            return cand_plain(kms, n, off_t, pos_t, sens, cfg.max_kmer_freq,
                              dual_tables=bs, **statics)

        B, Q = kms[0].shape
        rule = plan(B, Q, len(kms) == 4, H).route
        by_route = {}
        for route in ("smem", "global"):
            if route == "smem" and H > 8192:
                try:
                    plan(B, Q, len(kms) == 4, H, route)
                except ValueError:
                    continue
                check(False, f"K6's smem route took H {H}")
            got, by_route[route] = time_cand_search(
                call, plain, kms, H, shape, route)
            err = max(err, by_route[route].pop("err"))
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
        t = dict(by_route[rule])
        votes = torch.randint(-2**30, 2**30, (B, 2 * H), dtype=torch.int32,
                              device="cuda")
        t.update({
            "variant": rule, "routes": by_route,
            "plain_ms": call_ms(plain, 10),
            "bound_ms": 1e3 * cand_bytes(
                kms, n, off_t, pos_t, cfg.max_kmer_freq, packed=packed,
                split=bs, fanout_cap=cfg.max_kmer_fanout, hit_cap=H,
                max_cmrs=C) / HBM_BYTES_PER_S,
            # a partial yardstick: one sort of [B, 2H] int32 votes
            "sort_ms": device_ms(lambda v=votes: torch.sort(v, dim=1)),
            "counters": counters})
        timings[shape] = t
        rows.append(f"{shape}: rule {rule}; " + "; ".join(
            f"{route} device {v['device_ms'] * 1e3:.2f} us, call "
            f"{v['call_ms'] * 1e3:.2f} us, {v['threads']} threads a read, "
            f"{v['reads_a_block']} reads a block, {v['smem_bytes']} B "
            f"shared" + (f", scratch {v['scratch_bytes']} B"
                         if route == "global" else "")
            for route, v in by_route.items())
            + f"; bound {t['bound_ms'] * 1e3:.3f} us (bytes), share "
            f"{t['bound_ms'] / t['device_ms']:.3f}; plain call "
            f"{t['plain_ms']:.3f} ms; torch.sort of [{B},{2 * H}] int32 "
            f"{t['sort_ms'] * 1e3:.2f} us; counters (fanout, hit, cmr) "
            f"{counters}")
    print(f"[4d K6 cand_search] exact in every Candidates field on both "
          f"routes at every shape ({card}; bound: bytes at 3.35 TB/s; "
          f"sensitivity {cfg.sensitivity} on the card); " + "; ".join(rows))
    return err, timings


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
    import torch

    from nextgenmap_tpu_torch.ops.row_gather import (
        plan, row_gather, row_gather_plain,
    )
    from nextgenmap_tpu_torch.tools import probe_dyngather
    from nextgenmap_tpu_torch.tools.timing import call_ms, device_ms

    gathers_per_s = 132 * 32 * sm_clock_hz()   # a warp-wide load a clock
    empty_ms = device_ms(lambda: torch.cuda._sleep(0))
    rng = np.random.default_rng(3)
    err, timing = 0, {}
    for R, W in K3_SHAPES:
        x = torch.from_numpy(
            rng.integers(0, 1 << 20, (R, W), dtype=np.int32)).cuda()
        for dim in (0, 1):
            idx = torch.from_numpy(rng.integers(0, (R, W)[dim], (R, W),
                                                dtype=np.int32)).cuda()
            k = lambda: row_gather(x, idx, K3_REP, dim)  # noqa: E731
            p = lambda: row_gather_plain(x, idx, K3_REP, dim)  # noqa: E731
            got, ref = k(), p()
            torch.cuda.synchronize()
            shape = f"{R}x{W} REP {K3_REP} dim {dim}"
            check(torch.equal(got, ref), f"K3 differs from plain at {shape}")
            err = max(err, max_abs_err([got], [ref]))
            idx64 = idx.long()
            lib = lambda: torch.gather(x, dim, idx64)  # noqa: E731
            timing[shape] = {
                "variant": plan(R, W, dim).variant,
                "device_ms": device_ms(k), "call_ms": call_ms(k, 20),
                "plain_ms": call_ms(p, 5),
                # REP = 1: the one call that computes it
                "gather_rep1_ms": device_ms(lib),
                "bound_ms": 1e3 * 3 * R * W * 4 / HBM_BYTES_PER_S,
                "gather_floor_ms": 1e3 * K3_REP * R * W / gathers_per_s}
    # the probe's own entry point is the path that launches K3
    row_gather.launches = 0
    probes = {}
    for R, W in K3_SHAPES:
        for dim in (0, 1):
            res = probe_dyngather.probe(dim, W, R, K3_REP)
            check(res["ok"] and res["correct"], f"the K3 probe failed: {res}")
            probes[f"{R}x{W} REP {K3_REP} dim {dim}"] = res
    launches = row_gather.launches
    check(launches > 0, "the probe never launched K3")
    line = "; ".join(
        f"{shape} ({t['variant']}): " + timing_row(
            t["device_ms"], t["call_ms"], t["bound_ms"],
            f", gather floor {t['gather_floor_ms'] * 1e3:.3f} us, "
            f"torch.gather (REP 1) {t['gather_rep1_ms'] * 1e3:.2f} us, "
            f"plain call {t['plain_ms'] * 1e3:.2f} us")
        + f", probe {probes[shape]['ns_per_elem']:.5f} ns/elem = "
        f"{probes[shape]['gelem_per_s']:.1f} Gelem/s"
        for shape, t in timing.items())
    print(f"[5 K3 row_gather] exact at every shape ({card}); an empty kernel "
          f"{empty_ms * 1e3:.2f} us; {line}; probe launches {launches}")
    return err, timing, launches, empty_ms


def map_argv(workdir, device="cuda"):
    """The main path's command line: default settings (k=13, B=4096)."""
    return ["map", "-r", os.path.join(workdir, "ref.fa"),
            "-q", os.path.join(workdir, "reads.fq"),
            "-o", os.path.join(workdir, "out.sam"),
            "--device", device, "--no-progress"]


def run_cli(path, argv):
    """The port's CLI on argv; (stats, {kernel: launches in this run}, wall s).
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
    t0 = time.perf_counter()
    stats = run()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    check_launched(launches, f"the {path} path", topn=path == "top-n")
    check(stats.slots_scored > 0, f"K1 scored no real candidate ({path})")
    check(stats.alignments_computed > 0 and stats.gcups() > 0,
          f"the {path} run counted no alignment (GCUPS {stats.gcups()})")
    check(len(stats.step_device_ms) > 0, f"no device step time ({path})")
    return stats, launches, wall


def summary(stats, n_batches, launches, wall):
    phases = {k: round(v, 3) for k, v in sorted(stats.timing.items())}
    step = stats.step_device_ms
    return (f"{stats.reads_per_sec():.0f} reads/s after the index build "
            f"(streaming {stats.streaming_reads_per_sec():.0f}), "
            f"{stats.gcups():.3f} GCUPS; device step (CUDA events) "
            f"{sum(step) / max(1, n_batches):.1f} ms per batch over "
            f"{len(step)} dispatch(es); launches {launches}; step graph "
            f"replays {stats.graph_replays}, captures {stats.graph_captures}; "
            f"real slots "
            f"scored {stats.slots_scored}; phase s {phases}; wall "
            f"{wall:.2f} s")


def steps(stats, n_batches, k=1):
    """The steps a run ran on the card: its batches (with --megabatch K the
    tail group padded to K), and the eager warm-up step of each step graph
    it captured.  Each launches its path's kernels once per node."""
    return -(-n_batches // k) * k + stats.graph_captures


FORMER_CALLS = 20


def score_pass_timing(call, what):
    """The fused score pass on one call's inputs, exact against its plain
    version on CPU copies of them; (max abs err, timings): its device time
    (the plan and the pass kernels), call time, the plain version's wall
    time on the CPU, the former card path's device time and records a call
    on the same inputs (torch's compaction, K2, K1: all its device records
    in a window of FORMER_CALLS calls, over the calls, since some of its
    kernels run more than once a call), and K1's operations bound over the
    slots the pass scores (each read's slots under the cap)."""
    import torch

    from nextgenmap_tpu_torch.ops.score_pass_kernel import (
        score_pass, score_pass_plain,
    )
    from nextgenmap_tpu_torch.tools.timing import (
        call_ms, device_ms, device_profile,
    )

    a, kw = call
    k = lambda: score_pass(*a, **kw)  # noqa: E731
    got = [x.cpu() for x in k()]
    cpu = [x.cpu() if torch.is_tensor(x) else x for x in a]
    t0 = time.perf_counter()
    want = score_pass(*cpu, **kw)                 # the plain version
    plain_ms = 1e3 * (time.perf_counter() - t0)
    for nm, x, y in zip(want._fields, got, want):
        check(torch.equal(x, y),
              f"score pass {nm} differs from its plain version at {what}")
    reads, lens, corr_start = cpu[1], cpu[3], cpu[4]
    (B, L), C = reads.shape, corr_start.shape[1]
    S, W = kw["slot_cap"], kw["band"]
    taken = (S - want.base).clamp(min=0).minimum(want.n_sc).long()
    real = int(taken.sum())
    cells = int((taken * lens.clamp(0, L).long()).sum()) * W
    # the former card path takes the mask a read
    fa = list(a)
    if kw.get("pairs"):
        fa[7] = a[7].repeat_interleave(2)
    fkw = {key: v for key, v in kw.items() if key != "pairs"}
    former = lambda: score_pass_plain(*fa, **fkw)  # noqa: E731
    former()
    f = device_profile(lambda: [former() for _ in range(FORMER_CALLS)])
    t = {"device_ms": device_ms(k), "call_ms": call_ms(k, 20),
         "plain_ms": plain_ms,
         "former_device_ms": f["device_ms"] / FORMER_CALLS,
         "former_records": f["records"] / FORMER_CALLS,
         "bound_ms": 1e3 * OPS_PER_CELL * cells / (INT32_LANES
                                                   * sm_clock_hz()),
         "real_slots": real,
         "shape": (f"{kw.get('mode', 'local')} {B} reads x {L}, C {C}, W "
                   f"{W}, {S} slots ({real} real): {what}")}
    t["gcups"] = cells / (t["device_ms"] * 1e-3) / 1e9
    return max_abs_err(got, want), t


def finish_pass_check(call, what, save_to):
    """The finish pass on one call's inputs, exact against its plain
    version on CPU copies of them; (max abs err, figures): the plain
    version's wall time on the CPU and K4's bound there (every read is
    aligned, qlen x W cells at K4_OPS_PER_CELL, or the bytes: the winner's
    candidates and fields read, its query and corridor, the op buffer and
    the fields written, whichever is larger).  The CPU copies of the
    inputs are saved to `save_to`, for finish_timing_child to time."""
    import torch

    from nextgenmap_tpu_torch.ops.finish_kernel import finish_pass

    def on_cpu(x):
        if isinstance(x, tuple):
            return tuple(map(on_cpu, x))
        return x.cpu() if torch.is_tensor(x) else x

    a, kw = call
    got = [x.cpu() for x in finish_pass(*a, **kw)]
    cpu = [on_cpu(x) for x in a]
    t0 = time.perf_counter()
    want = finish_pass(*cpu, **kw)                # the plain version
    plain_ms = 1e3 * (time.perf_counter() - t0)
    for nm, x, y in zip(want._fields, got, want):
        check(torch.equal(x, y),
              f"finish pass {nm} differs from its plain version at {what}")
    torch.save((cpu, kw), save_to)
    sw, reads, lens = cpu[1], cpu[6], cpu[8]
    (B, L), C = reads.shape, sw.shape[1]
    W, mode = kw["band"], kw.get("mode", "local")
    cells = int(lens.clamp(0, L).long().sum()) * W
    # a1, C x (sw, start, strand, valid), lengths, proper; query, corridor;
    # ops, 11 int32 fields and 2 flags
    n_bytes = B * (8 + 13 * C + 5 + L + (L + W) + (L + W) + 46)
    bound_ops = 1e3 * K4_OPS_PER_CELL[mode] * cells / (INT32_LANES
                                                       * sm_clock_hz())
    bound_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t = {"plain_ms": plain_ms, "bound_ms": max(bound_ops, bound_bytes),
         "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
         "mapped": int(want.mapped.sum()), "inputs": save_to,
         "shape": f"{mode} {B} reads x {L}, C {C}, W {W}: {what}"}
    return max_abs_err(got, want), t


FINISH_TIMEOUT_S = 300   # the finish timings' process, set-up included


def finish_timing_child(paths):
    """The finish pass's timings in a process of its own (this script with
    --finish-timing FILE ...; late in the smoke's process torch.profiler
    stops recording some kernels, as for phase 19): for each file of
    finish_pass_check's saved inputs, on the card, its device time (its
    memset and kernel), call time, and the former card path's device time
    and records a call on the same inputs (finish_plain on the card:
    torch's gathers, the second best and the start, K2, the strand select,
    K4, the filters and MAPQ: all its device records in a window of
    FORMER_CALLS calls, over the calls); one JSON line {file: figures}."""
    import torch

    from nextgenmap_tpu_torch.ops.finish_kernel import (
        finish_pass, finish_plain,
    )
    from nextgenmap_tpu_torch.tools.timing import (
        call_ms, device_ms, device_profile,
    )

    def on_card(x):
        if isinstance(x, tuple):
            return tuple(map(on_card, x))
        return x.cuda() if torch.is_tensor(x) else x

    out = {}
    for path in paths:
        cpu, kw = torch.load(path)
        a = [on_card(x) for x in cpu]
        k = lambda: finish_pass(*a, **kw)  # noqa: E731
        former = lambda: finish_plain(*a, **kw)  # noqa: E731
        former()
        f = device_profile(lambda: [former() for _ in range(FORMER_CALLS)])
        out[path] = {"device_ms": device_ms(k), "call_ms": call_ms(k, 20),
                     "former_device_ms": f["device_ms"] / FORMER_CALLS,
                     "former_records": f["records"] / FORMER_CALLS}
    print(json.dumps(out))
    return 0


def phase_finish_timing(finishes, card):
    """Phase 13b: finish_timing_child on the inputs phases 6, 7 and 13
    saved; adds its figures to `finishes` ({path: (err, figures)}) and
    prints them."""
    repo = os.path.dirname(os.path.abspath(__file__))
    by_file = {t["inputs"]: t for _, t in finishes.values()}
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--finish-timing",
         *by_file], cwd=repo, capture_output=True, text=True,
        timeout=FINISH_TIMEOUT_S)
    check(proc.returncode == 0, f"the finish timings' process exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    for path, figures in json.loads(proc.stdout.splitlines()[-1]).items():
        by_file[path].update(figures)
    print(f"[13b finish pass] in a process of its own ({card}): " + "; ".join(
        finish_pass_line(t) for t in by_file.values()))


def finish_pass_line(t):
    return (f"{t['shape']}: "
            + timing_row(t["device_ms"], t["call_ms"], t["bound_ms"],
                         f" ({t['bound_by']}), former card path "
                         f"{t['former_device_ms'] * 1e3:.2f} us in "
                         f"{t['former_records']:.1f} device records"))


def score_pass_line(t):
    return (f"score pass exact at {t['shape']}: "
            + timing_row(t["device_ms"], t["call_ms"], t["bound_ms"],
                         f", {t['gcups']:.2f} GCUPS, former card path "
                         f"{t['former_device_ms'] * 1e3:.2f} us in "
                         f"{t['former_records']:.1f} device records"))


def phase_main_path(genome, workdir, device="cuda"):
    from nextgenmap_tpu_torch import synthetic

    n = N_BATCHES * BATCH
    codes, pos, strand = synthetic.simulate_reads(genome, n, READ_LEN, 0.02,
                                                  seed=SEED + 1)
    synthetic.write_fastq(os.path.join(workdir, "reads.fq"), codes, pos, strand)
    with Capture(first=("score_pass", "finish_pass")) as cap:
        stats, launches, wall = run_cli("single", map_argv(workdir, device))
    sp = score_pass_timing(cap.calls["score_pass"][0], "the single-end path")
    fp = finish_pass_check(cap.calls["finish_pass"][0], "the single-end path",
                           os.path.join(workdir, "finish_single.pt"))

    records, mapped, correct = synthetic.truth_correct(
        os.path.join(workdir, "out.sam"))
    check(records == n, f"SAM holds {records} records, expected {n}")
    check(mapped >= 0.99 * n, f"only {mapped}/{n} reads mapped")
    check(correct >= 0.95 * n, f"only {correct}/{n} reads truth-correct")
    print(f"[6 single] {n} reads x {READ_LEN} bp, {len(genome)} bp genome: "
          f"mapped {mapped} ({100 * mapped / n:.2f}%), truth-correct {correct} "
          f"({100 * correct / n:.2f}%); "
          + summary(stats, N_BATCHES, launches, wall) + "; "
          + score_pass_line(sp[1]) + "; finish pass exact at "
          + fp[1]["shape"])
    return codes, (launches, steps(stats, N_BATCHES)), sp, fp


def phase_paired_path(genome, workdir, device="cuda"):
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
    with Capture(first=("score_pass", "finish_pass")) as cap:
        stats, launches, wall = run_cli("paired", [
            "map", "-r", os.path.join(workdir, "ref.fa"), "-1", fq1, "-2",
            fq2, "-o", sam, "--device", device, "--no-progress"])
    sp = score_pass_timing(cap.calls["score_pass"][0], "the paired path")
    fp = finish_pass_check(cap.calls["finish_pass"][0], "the paired path",
                           os.path.join(workdir, "finish_paired.pt"))
    check(cap.calls["score_pass"][0][1].get("pairs") is True,
          "the paired path's score pass took no pair mask")

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
          f"broken {stats.pairs_broken}); "
          + summary(stats, N_BATCHES_NEW, launches, wall) + "; "
          + score_pass_line(sp[1]) + "; finish pass exact at "
          + fp[1]["shape"])
    return codes, (launches, steps(stats, N_BATCHES_NEW)), sp, fp


def phase_topn_path(genome, workdir, device="cuda"):
    from nextgenmap_tpu_torch import synthetic

    n = N_BATCHES_NEW * BATCH
    codes, pos, strand = synthetic.simulate_reads(genome, n, READ_LEN, 0.02,
                                                  seed=SEED + 3)
    fq, sam = (os.path.join(workdir, f) for f in ("top.fq", "top.sam"))
    synthetic.write_fastq(fq, codes, pos, strand)
    stats, launches, wall = run_cli("top-n", [
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
          f"{c['secondary']}; " + summary(stats, N_BATCHES_NEW, launches, wall))
    return codes, (launches, steps(stats, N_BATCHES_NEW))


def phase_e2e_path(genome, workdir, device="cuda"):
    from nextgenmap_tpu_torch import synthetic

    n = N_BATCHES_NEW * BATCH
    codes, pos, strand = synthetic.simulate_reads(genome, n, READ_LEN, 0.02,
                                                  seed=SEED + 4)
    fq, sam = (os.path.join(workdir, f) for f in ("e2e.fq", "e2e.sam"))
    synthetic.write_fastq(fq, codes, pos, strand)
    stats, launches, wall = run_cli("end-to-end", [
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
          + summary(stats, N_BATCHES_NEW, launches, wall))
    return codes, (launches, steps(stats, N_BATCHES_NEW))


def phase_bisulfite_path(genome, workdir, device="cuda"):
    from nextgenmap_tpu_torch import synthetic

    n = N_BATCHES_NEW * BATCH
    codes, pos, strand = synthetic.simulate_bisulfite_reads(
        genome, n, READ_LEN, rate=0.8, seed=SEED + 5)
    fq, sam = (os.path.join(workdir, f) for f in ("bs.fq", "bs.sam"))
    synthetic.write_fastq(fq, codes, pos, strand)
    stats, launches, wall = run_cli("bisulfite", [
        "map", "-r", os.path.join(workdir, "ref.fa"), "-q", fq, "-o", sam,
        "--bs-mapping", "--device", device, "--no-progress"])

    c = synthetic.sam_counts(sam)
    check(c["records"] == n, f"SAM holds {c['records']} records, expected {n}")
    check(c["correct"] >= 0.90 * n, f"only {c['correct']}/{n} truth-correct")
    print(f"[10 bisulfite] --bs-mapping, {n} reads (OT/OB, 80% C->T): "
          f"mapped {c['mapped']} ({100 * c['mapped'] / n:.2f}%), "
          f"truth-correct {c['correct']} ({100 * c['correct'] / n:.2f}%); "
          + summary(stats, N_BATCHES_NEW, launches, wall))
    return codes, (launches, steps(stats, N_BATCHES_NEW))


def phase_long_path(genome, workdir, device="cuda"):
    from nextgenmap_tpu_torch import synthetic

    n = N_BATCHES_NEW * LONG_BATCH
    codes, pos, strand = synthetic.simulate_long_reads(
        genome, n, LONG_LEN, 0.03, 0.005, seed=SEED + 6)
    fq, sam = (os.path.join(workdir, f) for f in ("long.fq", "long.sam"))
    synthetic.write_fastq(fq, codes, pos, strand)
    stats, launches, wall = run_cli("long", [
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
          f"consume SEQ and NM = edits on all; "
          + summary(stats, N_BATCHES_NEW, launches, wall))
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
    to the score pass, finish pass, K2 and K6 wrappers, to rerun
    a kernel on exactly the inputs a path gave it.  Of a name in `first`
    only the first call is kept, its tensors copied: a step graph's eager
    warm-up, whose input buffers later batches overwrite."""

    NAMES = ("score_pass", "finish_pass", "gather_genome_windows",
             "candidate_search")

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
    the flattened genome."""
    import torch

    from nextgenmap_tpu_torch.models.mapper import Mapper, shard_tail_cap
    from nextgenmap_tpu_torch.ops.gather import gather_windows, pad_table
    from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
    from nextgenmap_tpu_torch.pipeline.runner import load_reference
    from nextgenmap_tpu_torch.tools.timing import call_ms, device_ms

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
        stats, counts, wall = run_cli(name, [
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
                    f"SAM equal; " + summary(stats, n_batches, counts, wall))

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
    err, k1 = score_pass_timing((a, kw), "the sharded pool")
    (fa, fkw), = cap.calls["finish_pass"]
    errf, fin = finish_pass_check((fa, fkw), "the sharded pool",
                                  os.path.join(workdir, "finish_pool.pt"))
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
    gk = lambda: gather_genome_windows(g_flat, starts, T)  # noqa: E731
    padded = pad_table(g_flat, T, 4)
    gp = lambda: gather_windows(padded, starts, T)  # noqa: E731
    gg, gw = gk(), gp()
    check(torch.equal(gg, gw), "K2 differs from plain at the flat genome")
    err2 = max_abs_err([gg], [gw])
    n = starts.numel()
    k2 = {"device_ms": device_ms(gk), "call_ms": call_ms(gk, 50),
          "plain_ms": call_ms(gp, 20),
          "bound_ms": 1e3 * (2 * n * T + 4 * n) / HBM_BYTES_PER_S,
          "shape": f"{n}x{T} from the flattened [{S}*{Gs}] genome"}
    print(f"[13 sharded] " + "; ".join(rows) + f"; ({card}) "
          + score_pass_line(k1) + "; finish pass exact at " + fin["shape"]
          + f"; K2 exact at {k2['shape']}: " + timing_row(
              k2["device_ms"], k2["call_ms"], k2["bound_ms"]))
    return launches, k1, fin, k2, (err, errf, err2), memory


def phase_gigabase(card, size=GIGA_SIZE, n_shards=GIGA_SHARDS, batch=BATCH,
                   device="cuda"):
    """The 2.28 Gbp genome in 4 shards through Mapper.map_batch; returns
    ({kernel: launches}, number of batches, the stage figures)."""
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
    sec = {}
    t = time.perf_counter()
    g = synthetic.repeat_genome_large(size, n_repeats=120, min_len=1000,
                                      max_len=2000, seed=SEED)
    sec["genome"], t = time.perf_counter() - t, time.perf_counter()
    idx = KmerIndex.build(g, k=cfg.kmer, skip=cfg.kmer_skip,
                          max_freq=cfg.max_kmer_freq, canonical=True,
                          allow_u32=True)
    n_pos = idx.positions.shape[0]
    check(idx.canonical == (size < 2**31),
          "canonical entries past 2^31 bases")
    sec["host index"], t = time.perf_counter() - t, time.perf_counter()
    sidx = ShardedIndex.build(idx, g, n_shards, ShardedIndex.halo_for(cfg))
    del idx
    sec["shard split"], t = time.perf_counter() - t, time.perf_counter()
    host_gb = (sidx.genome.nbytes + sidx.offsets.nbytes
               + sidx.positions.nbytes) / 1e9
    shape = (tuple(sidx.genome.shape), tuple(sidx.positions.shape))

    class Codes:
        codes = g

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mapper = Mapper(cfg, Codes, READ_LEN, sidx, device=device)
    del sidx
    if device == "cuda":
        torch.cuda.synchronize()
    sec["to device"] = time.perf_counter() - t

    n = 2 * batch
    codes, pos, strand = synthetic.simulate_reads(g, n, READ_LEN, 0.02,
                                                  seed=SEED + 8)
    lens = np.full(batch, READ_LEN, np.int32)
    for k in KERNELS.values():
        k.launches = 0
    mapped, gpos, gstrand = [], [], []
    with Capture() as cap:
        for b in range(2):
            t = time.perf_counter()
            res = mapper.map_batch(codes[b * batch:(b + 1) * batch], lens)
            if device == "cuda":
                torch.cuda.synchronize()
            sec[f"batch {b + 1}"] = time.perf_counter() - t
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
          f"launches {launches}; seconds "
          f"{ {k: round(v, 3) for k, v in sec.items()} }; peak device "
          f"memory {peak:.3f} GiB, peak host memory of the process "
          f"{host_peak:.3f} GiB; K6 exact at {k6['shape']} on both routes: "
          + timing_row(k6["device_ms"], k6["call_ms"], k6["bound_ms"],
                       f", global route {k6['global_ms'] * 1e3:.2f} us, "
                       f"plain call {k6['plain_ms']:.3f} ms"))
    return launches, n_steps, {"seconds": sec, "peak_gib": peak, "k6": k6,
                         "host_peak_gib": host_peak,
                         "mapped": int(mapped.sum()),
                         "correct": int(correct.sum()), "past_2_31": past}


def phase_runtime(workdir, device="cuda"):
    """The runtime of the CLI (-t, --megabatch, --bam, --resume, --profile,
    a wide --corridor) on phases 6 and 7's inputs; returns {run: (kernel
    launches, batches)}."""
    from nextgenmap_tpu_torch import cli
    from nextgenmap_tpu_torch.io.bam import read_bam

    path = lambda name: os.path.join(workdir, name)  # noqa: E731
    single = sam_records(path("out.sam"))            # phase 6, -t 1
    body = sam_body(single)
    launches, rows, runs = {}, [], {}

    def run(name, out, *flags, n_batches=N_BATCHES,
            qry=("-q", path("reads.fq")), k=1):
        stats, counts, wall = run_cli(name, [
            "map", "-r", path("ref.fa"), *qry, "-o", path(out), "--device",
            device, "--no-progress", *flags])
        launches[name] = (counts, steps(stats, n_batches, k))
        rows.append(f"{name}: " + summary(stats, n_batches, counts, wall))
        # reads/s as the run ended, and the device step a batch
        runs[name] = (stats.reads_per_sec(),
                      sum(stats.step_device_ms) / n_batches)
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
    rows[-1] += (f"; trace {len(trace) / 2**20:.1f} MiB names the score "
                 f"pass, the finish pass, K5 and K6")
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
    return launches, runs["single -t 1"]


CHILD_TIMEOUT_S = 420    # one phase-16 process, set-up included


def child(argv):
    """One process of phase 16's multi-process runs: the CLI on argv with
    run_cli's checks, then one JSON line of what the parent reads."""
    import torch

    guard_plain_traceback()
    stats, launches, wall = run_cli("child", argv)
    print(json.dumps({
        "launches": launches, "reads_in": stats.reads_in,
        "reads_per_sec": stats.reads_per_sec(), "gcups": stats.gcups(),
        "step_ms": stats.step_device_ms, "timing": stats.timing,
        "graph_captures": stats.graph_captures,
        "graph_replays": stats.graph_replays,
        "wall": wall, "peak_bytes": torch.cuda.max_memory_allocated()}))
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


def phase_parallel(workdir, t1, sharded_memory, device="cuda"):
    """Phase 16: --dist-nprocs 2 (a) and --shard-across-hosts with 2
    processes (c), each a pair of CLI processes on the card, and the dp step
    on two slots of the card (b); returns {run: (kernel launches,
    batches)}."""
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
    t0 = time.perf_counter()
    done = run_children(runs)
    wall = time.perf_counter() - t0
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
            merge = r["timing"].get("merge")
            parts.append(
                f"p{i} {r['reads_in']} reads in {n_b} batch(es), "
                f"{r['graph_replays']} graph replays, "
                f"{r['reads_per_sec']:.0f} reads/s, {r['gcups']:.3f} GCUPS, "
                f"device step {sum(r['step_ms']) / n_b:.1f} ms per batch, "
                f"peak {r['peak_bytes'] / 2**30:.3f} GiB, wall "
                f"{r['wall']:.2f} s"
                + (f", merge {merge:.3f} s" if merge is not None else ""))
        rows.append(f"{name}: " + "; ".join(parts))
    resident, peak = sharded_memory["sharded-2"]
    print(f"[16 parallel a+c] 8 CLI processes on {device} at once "
          f"({wall:.1f} s): --dist-nprocs 2 SAM, --bam and paired equal to "
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
        stats, counts, wall = run_counted(name, lambda: run_mapping(
            cfg, path("ref.fa"), out_path=path(out), device=slots, **qry))
        check(sam_records(path(out)) == want,
              f"{name}: SAM differs from the one-slot run's")
        # a slice is a step: two a batch, one in each capture's warm-up
        n_steps = 2 * n_b + stats.graph_captures
        check(counts == expected(n_steps) and stats.graph_replays == n_b,
              f"{name}: launches {counts} and {stats.graph_replays} graph "
              f"replays, expected 1 score pass, 1 finish pass, 1 K5 and 1 "
              f"K6 "
              f"a slice "
              f"over {n_b} "
              f"batches of 2 slices and {stats.graph_captures} warm-up "
              f"slice(s), and one replay a batch")
        launches[name] = (counts, n_steps)
        rows.append(f"{name}: " + summary(stats, n_b, counts, wall))
    rows.append(f"phase 15's -t 1 on one slot: {t1[0]:.0f} reads/s, device "
                f"step {t1[1]:.1f} ms per batch")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        stats, counts, wall = run_cli("devices 2", [
            "map", "-r", path("ref.fa"), *se, "-o", path("dev2.sam"),
            "--device", device, "--no-progress", "--devices", "2"])
        check(sam_records(path("dev2.sam")) == single,
              "--devices 2: SAM differs from phase 6's")
        launches["devices 2"] = (counts, N_BATCHES)
        rows.append("--devices 2 (CLI): "
                    + summary(stats, N_BATCHES, counts, wall))
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
        t0 = time.perf_counter()
        a = getattr(gpu, step)(batch, lens)
        if gpu.device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        b = getattr(cpu, step)(batch, lens)
        t2 = time.perf_counter()
        ranks = (a, b) if step == "map_batch_topn" else ((a,), (b,))
        for j, (ra, rb) in enumerate(zip(*ranks)):
            for f in ra._fields:
                check(torch.equal(getattr(ra, f).cpu(), getattr(rb, f)),
                      f"{path}: cuda and cpu differ in rank {j} field {f}")
        n_multi = int((ranks[1][0].n_candidates >= 2).sum())
        rows.append(f"{path} ({batch.shape[0]} reads, {len(ranks[0])} "
                    f"rank(s), {n_multi} reads with >= 2 candidates) "
                    f"{t1 - t0:.3f} s cuda / {t2 - t1:.3f} s cpu")
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
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "nextgenmap_tpu_torch.bench"], cwd=repo,
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
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
    on_cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x  # noqa: E731
    w_cpu = w._replace(tables=tuple(map(on_cpu, w.tables)),
                       lens=w.lens.cpu(), matrices=w.matrices.cpu(),
                       scalars=tuple(map(on_cpu, w.scalars)),
                       graphs=StepGraphs("cpu"))
    t1 = time.perf_counter()
    a = bench.step(w, staged[0][0])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    b = bench.step(w_cpu, staged[0][0].cpu())
    t3 = time.perf_counter()
    for f in a._fields:
        check(torch.equal(getattr(a, f).cpu(), getattr(b, f)),
              f"bench batch 0: cuda and cpu differ in {f}")
    span, span_fixed = r["span_fit_ms"]
    print(f"[17 bench] python -m nextgenmap_tpu_torch.bench ({card}), one "
          f"stdout line {lines[0]}; {r['reads_per_sec']:.1f} reads/s, "
          f"{r['gcups']:.3f} GCUPS (step-effective), mapped {r['mapped']}/{n}"
          f", truth-correct {r['truth_correct']}/{n}; marginal "
          f"{r['t_batch'] * 1e3:.3f} ms a batch, fixed {r['fixed'] * 1e3:.1f}"
          f" ms, walls {r['walls']} s; stream span {span:.3f} ms a batch "
          f"(fixed {span_fixed:.1f} ms; {r['spans_ms']} ms); K1 real slots "
          f"{r['k1_real_slots_per_batch']:.2f} a batch; set-up {r['setup_s']}"
          f"; launches {r['launches']} over {r['batches_run']} batches, "
          f"{r['graph_replays']} graph replays (capture "
          f"{r['graph_captures'][0]['seconds']:.3f} s, graph pool "
          f"{r['graph_captures'][0]['pool_bytes'] / 2**20:.1f} MiB); "
          f"process {wall:.1f} s; no sync in a 2-batch sweep; batch 0 all "
          f"{len(a._fields)} fields cuda == cpu ({t2 - t1:.3f} s cuda, "
          f"{t3 - t2:.3f} s cpu)")
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
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    got = fn(*args)
    legs = graft_entry.dryrun_multichip(4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
          f"CPU's, proper {int(legs[0].proper.sum())}/64; launches {launches}"
          f"; {wall:.2f} s")
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
    run again after a pause, at most WINDOWS times (CUPTI now and then
    hands back a window short of records; tools/timing.py).  The counts of
    the last window are returned whatever they are; the caller holds them
    to `want`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nextgenmap_tpu_torch.tools.timing import WINDOWS

    for window in range(1, WINDOWS + 1):
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
    return got, WINDOWS


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
    from nextgenmap_tpu_torch.tools.timing import device_profile

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

    t_all = time.perf_counter()
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
        # the graph's own nodes (a bare replay), and the eager step's
        bare = device_profile(list(graph.graphs._entries.values())[-1]
                              .graph.replay)
        op_by_op = device_profile(lambda: call(eager, codes_d, lens_d))

        # host ms a batch over the same batches, eager and graph in turn
        ms = {"eager": [], "graph": []}
        for r in range(GRAPH_ROUNDS):
            order = ("eager", "graph") if r % 2 == 0 else ("graph", "eager")
            for name in order:
                m = graph if name == "graph" else eager
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if k > 1:
                    call(m, groups[r % 2], lens)
                else:
                    for b in range(n):
                        call(m, reads[b], lens)
                torch.cuda.synchronize()
                ms[name].append(1e3 * (time.perf_counter() - t0) / n)
        cap = graph.graphs.captures[-1]
        rows.append(
            f"{path}: graph == eager in all fields on 2 "
            f"{'groups' if k > 1 else 'batches'}, replay without sync, "
            f"launches a replay {by_graph} (eager step {by_eager}, "
            f"profiled replay {recorded}, window {windows}); a bare replay: "
            f"{bare['records']} device nodes ({bare['kernels']} kernels), "
            f"device busy {bare['busy']:.3f} ({bare['device_ms']:.3f} of "
            f"{bare['wall_ms']:.3f} ms); the eager step: "
            f"{op_by_op['records']} device records ({op_by_op['kernels']} "
            f"kernels), busy {op_by_op['busy']:.3f} "
            f"({op_by_op['device_ms']:.3f} of {op_by_op['wall_ms']:.3f} ms);"
            f" host ms "
            f"a batch eager {[round(x, 3) for x in ms['eager']]}, graph "
            f"{[round(x, 3) for x in ms['graph']]}; capture "
            f"{cap['seconds']:.3f} s, graph pool +"
            f"{cap['pool_bytes'] / 2**20:.1f} MiB")
    mappers.clear()
    kept.clear()
    torch.cuda.empty_cache()
    print(f"[19 graphs] one captured graph per step ({card}; "
          f"{time.perf_counter() - t_all:.1f} s): " + "; ".join(rows))
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


def main():
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "nextgenmap_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(nextgenmap_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    if sys.argv[1:2] == ["--child"]:
        return child(sys.argv[2:])
    if sys.argv[1:2] == ["--finish-timing"]:
        return finish_timing_child(sys.argv[2:])
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
    k2_err, k2 = phase_gather(torch.from_numpy(genome).cuda(), rng, card)
    k1_err, k1_shapes = phase_sw(rng, cfg, card)
    k4_err, k4_shapes = phase_align(rng, cfg, card)
    k4 = k4_shapes[K4_MAIN]
    k5_err, k5_shapes = phase_front(card)
    k5 = k5_shapes[K5_MAIN]
    k6_err, k6_shapes = phase_cand_search(card, genome, cfg)
    k6 = k6_shapes[K6_MAIN]
    torch.cuda.empty_cache()
    k3_err, k3_shapes, k3_launches, empty_ms = phase_row_gather(card)
    k3 = k3_shapes[K3_MAIN]
    guard_plain_traceback()
    guard_plain_front()
    codes, launches = {}, {}     # launches: {path: (counts, batches)}
    passes = {}                  # the score pass's (err, timings) by path
    finishes = {}                # the finish pass's (err, timings) by path
    with tempfile.TemporaryDirectory() as workdir:
        ref_path = os.path.join(workdir, "ref.fa")
        synthetic.write_fasta(ref_path, "chr", genome)
        for path, phase in (("single", phase_main_path),
                            ("paired", phase_paired_path),
                            ("topn", phase_topn_path),
                            ("end-to-end", phase_e2e_path),
                            ("bisulfite", phase_bisulfite_path),
                            ("long", phase_long_path)):
            codes[path], launches[path], *sp = phase(genome, workdir)
            if sp:
                passes[path], finishes[path] = sp
        phase_cuda_equals_cpu(genome, codes, cfg, ref_path)
        (sharded, passes["pool"], fp_pool, k2_flat,
         (sp_pool_err, fp_pool_err, k2_sh_err),
         sharded_memory) = phase_sharded_cli(genome, workdir, codes["single"],
                                             cfg, card)
        launches.update(sharded)
        finishes["pool"] = (fp_pool_err, fp_pool)
        phase_finish_timing(finishes, card)
        giga_counts, giga_batches, giga = phase_gigabase(card)
        k6_err = max(k6_err, giga["k6"].pop("err"))
        k6_shapes[giga["k6"].pop("shape")] = giga["k6"]
        launches["gigabase-4"] = (giga_counts, giga_batches)
        runtime, t1 = phase_runtime(workdir)
        launches.update(runtime)
        launches.update(phase_parallel(workdir, t1, sharded_memory))
    launches["bench"] = phase_bench(card)
    launches["graft"] = phase_graft(card)
    torch.cuda.empty_cache()
    launches.update(phase_graphs_process())
    check("jax" not in sys.modules, "the port imported jax")
    reference = sorted(m for m in sys.modules if m == "nextgenmap_tpu"
                       or m.startswith("nextgenmap_tpu."))
    check(not reference, f"the port imported the JAX package: {reference}")
    passes["pool"] = (sp_pool_err, passes["pool"])
    sp_err = max(err for err, _ in passes.values())
    sp = passes.pop("single")[1]
    fp_err = max(err for err, _ in finishes.values())
    fp = finishes.pop("single")[1]

    def per_step(name):
        return {path: n[name] / b for path, (n, b) in launches.items()}

    def total(name):
        return sum(n[name] for n, _ in launches.values())

    def row(name, source, replaces, err, t, n_launches, by_step, bound_by,
            library_ms, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launches,
                "launches_per_step": by_step, "max_abs_err": err,
                "ms": t["device_ms"], "device_ms": t["device_ms"],
                "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": bound_by,
                "share": t["bound_ms"] / t["device_ms"],
                "library_ms": library_ms, **extra}

    kernels = [
        row("score_pass", "nextgenmap_tpu_torch/csrc/sw_score.cu",
            "nextgenmap_tpu/ops/sw_pallas.py:150", max(k1_err, sp_err), sp,
            total("score_pass"), per_step("score_pass"), "operations", None,
            replaces_kind="the Pallas SW score kernel and, around it, the "
            "XLA-fused slot compaction, corridor gather and scatter of "
            "nextgenmap_tpu/models/mapper.py:214 _score_candidates",
            gcups=sp["gcups"], former_device_ms=sp["former_device_ms"],
            former_records=sp["former_records"],
            real_slots=sp["real_slots"], shape=sp["shape"],
            other_shapes={
                **{t["shape"]: {key: t[key] for key in (
                    "device_ms", "call_ms", "plain_ms", "former_device_ms",
                    "former_records", "bound_ms", "gcups", "real_slots")}
                   | {"share": t["bound_ms"] / t["device_ms"]}
                   for _, t in passes.values()},
                **{f"K1 alone, {shape}": {
                    "device_ms": t["device_ms"], "bound_ms": t["bound_ms"],
                    "share": t["bound_ms"] / t["device_ms"]}
                   for shape, t in k1_shapes.items()}}),
        row("finish_pass", "nextgenmap_tpu_torch/csrc/sw_align.cu",
            "nextgenmap_tpu/models/mapper.py:304", fp_err, fp,
            total("finish_pass"), per_step("finish_pass"), fp["bound_by"],
            None,
            replaces_kind="not a Pallas kernel: the reference's XLA-fused "
            "_finish (the winner's corridor gather, the lax.scan traceback "
            "banded_sw_align, the filters and MAPQ)",
            former_device_ms=fp["former_device_ms"],
            former_records=fp["former_records"], shape=fp["shape"],
            other_shapes={t["shape"]: {key: t[key] for key in (
                "device_ms", "call_ms", "plain_ms", "former_device_ms",
                "former_records", "bound_ms", "bound_by")}
                | {"share": t["bound_ms"] / t["device_ms"]}
                for _, t in finishes.values()}),
        row("gather_windows", "nextgenmap_tpu_torch/csrc/gather_windows.cu",
            "nextgenmap_tpu/ops/gather_pallas.py:124", max(k2_err, k2_sh_err),
            k2, total("gather_windows"), per_step("gather_windows"), "bytes",
            k2["library_ms"], shape="2048x148",
            other_shapes={k2_flat["shape"]: {
                "device_ms": k2_flat["device_ms"],
                "bound_ms": k2_flat["bound_ms"],
                "share": k2_flat["bound_ms"] / k2_flat["device_ms"]}}),
        row("row_gather", "nextgenmap_tpu_torch/csrc/row_gather.cu",
            "tools/probe_dyngather.py:51", k3_err, k3, k3_launches,
            {"probe_dyngather": k3_launches}, "bytes", None,
            variant=k3["variant"], gather_rep1_ms=k3["gather_rep1_ms"],
            gather_floor_ms=k3["gather_floor_ms"], empty_kernel_ms=empty_ms,
            shape=K3_MAIN + ": the probe's default shape",
            other_shapes={
                shape: {key: t[key] for key in (
                    "variant", "device_ms", "call_ms", "plain_ms", "bound_ms",
                    "gather_floor_ms", "gather_rep1_ms")}
                | {"share": t["bound_ms"] / t["device_ms"]}
                for shape, t in k3_shapes.items() if shape != K3_MAIN}),
        row("sw_align", "nextgenmap_tpu_torch/csrc/sw_align.cu",
            "nextgenmap_tpu/ops/sw_ref.py:209", k4_err, k4, total("sw_align"),
            per_step("sw_align"), k4["bound_by"], None,
            replaces_kind="not a Pallas kernel: the reference's lax.scan "
            "traceback (banded_sw_align, scans at :289 and :451)",
            walk_steps=k4["walk_steps"], forward_ms=k4["forward_ms"],
            variant=k4["variant"], routes=k4["routes"],
            shape=K4_MAIN + ": the single-end path's traceback input",
            other_shapes={
                shape: {key: t[key] for key in (
                    "variant", "device_ms", "call_ms", "plain_ms", "bound_ms",
                    "bound_by", "forward_ms", "routes")}
                | {"share": t["bound_ms"] / t["device_ms"]}
                for shape, t in k4_shapes.items() if shape != K4_MAIN}),
        row("read_kmers", "nextgenmap_tpu_torch/csrc/read_kmers.cu",
            "nextgenmap_tpu/models/mapper.py:85", k5_err, k5,
            total("read_kmers"), per_step("read_kmers"), "bytes", None,
            replaces_kind="not a Pallas kernel: XLA-fused code under "
            "jax.jit (_pre_extract with ops/kmer.py:149 "
            "extract_kmers_canonical and :88 extract_kmers)",
            shape=K5_MAIN + ": the single-end path's input",
            other_shapes={
                shape: {key: t[key] for key in (
                    "device_ms", "call_ms", "plain_ms", "bound_ms")}
                | {"share": t["bound_ms"] / t["device_ms"]}
                for shape, t in k5_shapes.items() if shape != K5_MAIN}),
        row("cand_search", "nextgenmap_tpu_torch/csrc/cand_search.cu",
            "nextgenmap_tpu/ops/candidate.py:642", k6_err, k6,
            total("cand_search"), per_step("cand_search"), "bytes", None,
            replaces_kind="not a Pallas kernel: XLA-fused code under "
            "jax.jit (candidate_search_canonical :642 and "
            "candidate_search_dual :560, through _compact_hits :359 and "
            "_select_candidates :487)",
            variant=k6["variant"], routes=k6["routes"],
            sort_ms=k6["sort_ms"], sort_is="a partial yardstick: one "
            "torch.sort of the [B, 2H] int32 votes, one of K6's steps",
            counters=k6["counters"],
            shape=K6_MAIN + ": the bench's input",
            other_shapes={
                shape: {key: t[key] for key in (
                    "variant", "device_ms", "call_ms", "plain_ms",
                    "bound_ms", "sort_ms", "routes", "counters",
                    "global_ms") if key in t}
                | {"share": t["bound_ms"] / t["device_ms"]}
                for shape, t in k6_shapes.items() if shape != K6_MAIN}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
