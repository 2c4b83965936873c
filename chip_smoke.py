#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (nextgenmap_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, and outside a checkout of
the repository).  Phases, one line of output each:

  1. card     the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    nvcc builds the three hand-written kernels from the checkout,
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
  5. K3       the dynamic-gather probe's kernel == its plain version (exact)
              at the probe's default 256 x 1024, REP 32, along dim 0 and 1,
              with its bound (bytes) and torch.gather's time at REP 1; then
              the probe's entry point, which launches it
  6. single   the port's CLI maps 3 x 4096 simulated 100 bp reads (2% SNPs)
              against a 4.6 Mbp genome with planted repeats (E. coli K-12
              scale) on the card; >= 99% mapped, >= 95% truth-correct, K1
              and K2 launched by that run, and K1 scored real candidates
  7. paired   the CLI's -1/-2 maps 2 x 4096 reads (2048 FR pairs a batch,
              insert 350 +- 40) on the same genome; >= 99% mapped, >= 95%
              truth-correct per mate, >= 90% of pairs proper, K1 and K2
              launched, real slots scored
  8. top-n    the CLI's -n 2 maps 2 x 4096 reads; one primary record per
              read, >= 99% mapped and >= 95% truth-correct primaries,
              secondaries present, K1 and K2 launched
  9. e2e      the CLI's --end-to-end maps 2 x 4096 reads (2% SNPs) on the
              same genome; >= 99% mapped, >= 95% truth-correct, no S/H op in
              any mapped CIGAR, K1 (glocal) and K2 launched
 10. bisulfite the CLI's --bs-mapping maps 2 x 4096 bisulfite reads (original
              top and bottom strands, 80% of C read as T) on the same
              genome; >= 90% truth-correct, K1 and K2 launched, real slots
              scored
 11. long     the CLI maps 1000 bp reads (3% SNPs, 0.5% indels) in 2
              batches of the size the runner picks for them (614); >= 90%
              mapped, >= 90% of the mapped within 16 bp of the truth, every
              CIGAR consumes SEQ and every NM equals the edits, K1 at W 184
              and K2 at T 1184 launched
 12. cuda=cpu one batch of each path (single, paired, top-n, end-to-end,
              bisulfite single and paired: 4096 reads; 1000 bp: 614 reads;
              single with --index-shards 4) mapped on the card and on the
              CPU from the same state: all 17 MapResult fields equal, every
              rank of top-n
 13. sharded  the CLI with --index-shards 4 (the cross-shard tail pool of
              8192 rows; K1 at 4096 slots) and 2 (full per-shard tails) on
              phase 6's reads, and -1/-2 --index-shards 4 on phase 7's
              pairs: each SAM equal to the unsharded one byte for byte but
              @PG, K1 and K2 launched as the shard loop predicts; K1 == its
              plain version at the pool's [4096,100]xW48 input with the
              real slots of a batch, K2 at the flattened [S*Gs] genome
 14. gigabase a 2^31 + 2^27 base (2.28 Gbp) genome drawn as uint8 from the
              seed with the same 120 planted repeats, past 2^31 so no
              unsharded path can hold it: host KmerIndex (k 13, skip 2,
              native passes; canonical entries fall away), split into 4
              shards, 2 x 4096 reads (2% SNPs) through Mapper.map_batch on
              the card with full per-shard tails; >= 99% mapped, >= 95%
              truth-correct, some global positions past 2^31, K1 and K2
              launched by every shard's tail; seconds of each stage, the
              peak device memory and the process's peak host memory
 15. runtime  the CLI on phase 6's reads with -t 1, -t 2 and -t 4 (SAMs
              equal to phase 6's, the same alignment and cell counters),
              phase 7's pairs with -t 4 (SAM equal to phase 7's), --megabatch
              4 -t 4, --bam (records, decoded by read_bam, equal to the SAM's
              first 11 fields), an interrupted run (one batch, its sidecar
              marked incomplete, a partial record appended) completed by
              --resume, --profile (the trace names K1 and K2), and
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
              sharded-2, each holding only its shard); K1 once and K2 twice
              a batch in each, and each one's peak device memory against
              phase 13's sharded-2 run.  Then the dp step on the slots
              [cuda:0, cuda:0] (run_mapping; the slices one after the
              other, K1 once a slice) on phases 6 and 7's
              inputs, SAM equal to theirs, reads/s and the device step
              beside phase 15's -t 1; --devices 2 through the CLI where the
              machine has two cards, else a line saying it has one

A kernel's device time (device_ms, also "ms" in the summary) comes from
torch.profiler (nextgenmap_tpu_torch/tools/timing.py): the device time of
the kernels launched in a window of calls, from the kernels' own rows only,
divided by the launches it recorded.  call_ms is the wrapper's wall time per
call (CUDA events around one call: host checks, allocation, the launch).
K1's summary row is the shape the single-end path hands it (2048 slots, ~650
of them real, the rest at length 0); its other shapes are under
"other_shapes", the sharded pool's among them, and K2's flattened-genome
launch under "other_shapes" of K2.
bound_ms is the least time the card could take: for K2 and K3 the bytes
moved (each input byte read once, each output byte written once) over
3.35 TB/s; for K1 the integer instructions its cells need (OPS_PER_CELL per
cell of each real slot's qlen x W) over 132 SMs x 64 INT32 lanes x the
card's maximum SM clock (nvidia-smi).  share = bound_ms / device_ms.

Every CLI run must launch K1 and K2, score real candidates, count
alignments (GCUPS > 0) and time its device steps.  After the last phase
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


def check(ok, what):
    if not ok:
        raise RuntimeError(what)


HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, published peak
INT32_LANES = 132 * 64         # SMs x INT32 lanes per SM per clock (sm_90)
OPS_PER_CELL = 6               # K1: integer instructions per DP cell
                               # (csrc/sw_score.cu's note counts them)
K1_MAIN = "local [2048,100]xW48 (650 real)"   # what the single-end path
                                              # hands K1 (~650 real slots)


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


def phase_row_gather(card):
    import torch

    from nextgenmap_tpu_torch.ops.row_gather import row_gather, row_gather_plain
    from nextgenmap_tpu_torch.tools import probe_dyngather
    from nextgenmap_tpu_torch.tools.timing import call_ms, device_ms

    R, W, REP = 256, 1024, 32           # the probe's defaults
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 1 << 20, (R, W), dtype=np.int32)).cuda()
    err, timing, probes = 0, {}, []
    for dim in (0, 1):
        idx = torch.from_numpy(rng.integers(0, (R, W)[dim], (R, W),
                                            dtype=np.int32)).cuda()
        k = lambda: row_gather(x, idx, REP, dim)  # noqa: E731
        p = lambda: row_gather_plain(x, idx, REP, dim)  # noqa: E731
        got, ref = k(), p()
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"K3 differs from plain along dim {dim}")
        err = max(err, max_abs_err([got], [ref]))
        idx64 = idx.long()
        lib = lambda: torch.gather(x, dim, idx64)  # noqa: E731
        timing[dim] = {"device_ms": device_ms(k), "call_ms": call_ms(k, 50),
                       "plain_ms": call_ms(p, 10),
                       # REP = 1: the one call that computes it
                       "gather_rep1_ms": device_ms(lib),
                       "bound_ms": 1e3 * 3 * R * W * 4 / HBM_BYTES_PER_S}
    # the probe's own entry point is the path that launches K3
    row_gather.launches = 0
    for dim in (0, 1):
        res = probe_dyngather.probe(dim, W, R, REP)
        check(res["ok"] and res["correct"], f"the K3 probe failed: {res}")
        probes.append(res)
    launches = row_gather.launches
    check(launches > 0, "the probe never launched K3")
    line = "; ".join(
        f"dim {d}: " + timing_row(
            t["device_ms"], t["call_ms"], t["bound_ms"],
            f", torch.gather (REP 1) {t['gather_rep1_ms'] * 1e3:.2f} us, "
            f"plain call {t['plain_ms'] * 1e3:.2f} us")
        + f", probe {probes[d]['ns_per_elem']:.5f} ns/elem = "
        f"{probes[d]['gelem_per_s']:.1f} Gelem/s"
        for d, t in timing.items())
    print(f"[5 K3 row_gather] exact at {R}x{W} REP {REP} ({card}); {line}; "
          f"probe launches {launches}")
    return err, timing[1], launches


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


def run_counted(path, run):
    """run() -> RunStats of one mapping run, with run_cli's checks."""
    from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
    from nextgenmap_tpu_torch.ops.sw_kernel import sw_score

    sw_score.launches = 0
    gather_genome_windows.launches = 0
    t0 = time.perf_counter()
    stats = run()
    wall = time.perf_counter() - t0
    launches = {"sw_score": sw_score.launches,
                "gather_windows": gather_genome_windows.launches}
    check(launches["sw_score"] > 0, f"the {path} path never launched K1")
    check(launches["gather_windows"] > 0,
          f"the {path} path never launched K2")
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
            f"{len(step)} dispatch(es); launches {launches}; real slots "
            f"scored {stats.slots_scored}; phase s {phases}; wall "
            f"{wall:.2f} s")


def phase_main_path(genome, workdir, device="cuda"):
    from nextgenmap_tpu_torch import synthetic

    n = N_BATCHES * BATCH
    codes, pos, strand = synthetic.simulate_reads(genome, n, READ_LEN, 0.02,
                                                  seed=SEED + 1)
    synthetic.write_fastq(os.path.join(workdir, "reads.fq"), codes, pos, strand)
    stats, launches, wall = run_cli("single", map_argv(workdir, device))

    records, mapped, correct = synthetic.truth_correct(
        os.path.join(workdir, "out.sam"))
    check(records == n, f"SAM holds {records} records, expected {n}")
    check(mapped >= 0.99 * n, f"only {mapped}/{n} reads mapped")
    check(correct >= 0.95 * n, f"only {correct}/{n} reads truth-correct")
    print(f"[6 single] {n} reads x {READ_LEN} bp, {len(genome)} bp genome: "
          f"mapped {mapped} ({100 * mapped / n:.2f}%), truth-correct {correct} "
          f"({100 * correct / n:.2f}%); "
          + summary(stats, N_BATCHES, launches, wall))
    return codes, launches


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
    stats, launches, wall = run_cli("paired", [
        "map", "-r", os.path.join(workdir, "ref.fa"), "-1", fq1, "-2", fq2,
        "-o", sam, "--device", device, "--no-progress"])

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
          + summary(stats, N_BATCHES_NEW, launches, wall))
    return codes, launches


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
    return codes, launches


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
    return codes, launches


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
    return codes, launches


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
    # one score pass (K1) and two corridor fetches (K2) per batch
    check(launches == {"sw_score": N_BATCHES_NEW,
                       "gather_windows": 2 * N_BATCHES_NEW},
          f"long-read launches {launches}")
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
    return codes, launches


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
    to the K1 and K2 wrappers (which it still calls), to rerun a kernel on
    exactly the inputs a path gave it."""

    def __enter__(self):
        from nextgenmap_tpu_torch.models import mapper

        self.mod, self.calls = mapper, {"sw_score": [], "gather_windows": []}
        self.orig = (mapper.sw_score, mapper.gather_genome_windows)

        def rec(name, fn):
            def call(*a, **k):
                self.calls[name].append((a, k))
                return fn(*a, **k)
            return call

        mapper.sw_score = rec("sw_score", self.orig[0])
        mapper.gather_genome_windows = rec("gather_windows", self.orig[1])
        return self

    def __exit__(self, *exc):
        self.mod.sw_score, self.mod.gather_genome_windows = self.orig


def phase_sharded_cli(genome, workdir, single_codes, cfg, card,
                      device="cuda"):
    """The CLI with --index-shards on phases 6 and 7's inputs, SAM against
    theirs; then K1 and K2 on the inputs one pooled batch gives them."""
    import torch

    from nextgenmap_tpu_torch.models.mapper import Mapper, shard_tail_cap
    from nextgenmap_tpu_torch.ops.gather import gather_windows, pad_table
    from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
    from nextgenmap_tpu_torch.ops.sw_kernel import sw_score
    from nextgenmap_tpu_torch.ops.sw_ref import banded_sw_score
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
        check(counts == {"sw_score": per * n_batches,
                         "gather_windows": 2 * per * n_batches},
              f"{name}: launches {counts}, expected {per} K1 and {2 * per} "
              f"K2 per batch")
        launches[name] = (counts, n_batches)
        rows.append(f"{name} ({'pool' if per == 1 else f'{S} tails'}): "
                    f"SAM equal; " + summary(stats, n_batches, counts, wall))

    # K1 and K2 on the inputs one --index-shards 4 batch gives them
    c4 = cfg.replace(index_shards=4)
    genome_obj, sidx = load_reference(c4, ref)
    mapper = Mapper(c4, genome_obj, READ_LEN, sidx, device=device)
    with Capture() as cap:
        mapper.map_batch(single_codes[:BATCH],
                         np.full(BATCH, READ_LEN, np.int32))
        torch.cuda.synchronize()
    (a, kw), = cap.calls["sw_score"]
    q, lens = a[0], a[1]
    S, Gs = sidx.genome.shape
    real = int((lens > 0).sum())
    check(tuple(q.shape) == (4096, READ_LEN) and kw["band"] == 48,
          f"the pool handed K1 {tuple(q.shape)}xW{kw['band']}")
    k = lambda: sw_score(*a, **kw)  # noqa: E731
    p = lambda: banded_sw_score(*a, **kw)  # noqa: E731
    got, want = k(), p()
    for nm, x, y in zip(("score", "end_i", "end_o"), got, want):
        check(torch.equal(x, y), f"K1 {nm} differs from plain at the pool")
    err = max_abs_err(got, want)
    cells = int(lens.clamp(0, READ_LEN).long().sum()) * kw["band"]
    k1 = {"device_ms": device_ms(k), "call_ms": call_ms(k, 20),
          "plain_ms": call_ms(p, 3, warmup=1),
          "bound_ms": 1e3 * OPS_PER_CELL * cells / (INT32_LANES
                                                    * sm_clock_hz())}
    k1["shape"] = f"local [4096,100]xW48 ({real} real), the sharded pool"
    (ga, _), *_ = cap.calls["gather_windows"]
    g_flat, starts, T = ga
    check(g_flat.shape[0] == S * Gs, "K2 did not gather from the flattened "
          "stacked genome")
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
    print(f"[13 sharded] " + "; ".join(rows) + f"; K1 exact at {k1['shape']}"
          f" ({card}): " + timing_row(k1["device_ms"], k1["call_ms"],
                                      k1["bound_ms"],
                                      f", plain call {k1['plain_ms']:.3f} ms")
          + f"; K2 exact at {k2['shape']}: " + timing_row(
              k2["device_ms"], k2["call_ms"], k2["bound_ms"]))
    return launches, k1, k2, (err, err2), memory


def phase_gigabase(card, size=GIGA_SIZE, n_shards=GIGA_SHARDS, batch=BATCH,
                   device="cuda"):
    """The 2.28 Gbp genome in 4 shards through Mapper.map_batch; returns
    ({kernel: launches}, number of batches, the stage figures)."""
    import torch

    from nextgenmap_tpu_torch import synthetic
    from nextgenmap_tpu_torch.config import NgmConfig
    from nextgenmap_tpu_torch.index.kmer_index import KmerIndex
    from nextgenmap_tpu_torch.models.mapper import Mapper
    from nextgenmap_tpu_torch.native import hostio
    from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
    from nextgenmap_tpu_torch.ops.sw_kernel import sw_score
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
    sw_score.launches = 0
    gather_genome_windows.launches = 0
    mapped, gpos, gstrand = [], [], []
    for b in range(2):
        t = time.perf_counter()
        res = mapper.map_batch(codes[b * batch:(b + 1) * batch], lens)
        if device == "cuda":
            torch.cuda.synchronize()
        sec[f"batch {b + 1}"] = time.perf_counter() - t
        mapped.append(res.mapped.cpu().numpy())
        gpos.append(res.pos.cpu().numpy())
        gstrand.append(res.strand.cpu().numpy())
    launches = {"sw_score": sw_score.launches,
                "gather_windows": gather_genome_windows.launches}
    mapped, gpos, gstrand = (np.concatenate(x) for x in
                             (mapped, gpos, gstrand))
    correct = mapped & (np.abs(gpos - pos) <= 5) & (gstrand == strand)
    past = int((mapped & (gpos >= 2**31)).sum())
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else float("nan"))
    host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    # past S * Gs = 2^31 the tails run per shard: K1 once and K2 twice each
    per = (1 if mapper.tail_cap(batch)
           and mapper.shards.genome.numel() < 2**31 else n_shards)
    check(launches == {"sw_score": 2 * per, "gather_windows": 4 * per},
          f"gigabase launches {launches}, expected {per} K1 and {2 * per} "
          f"K2 per batch")
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
          f"{host_peak:.3f} GiB")
    return launches, 2, {"seconds": sec, "peak_gib": peak,
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
            qry=("-q", path("reads.fq"))):
        stats, counts, wall = run_cli(name, [
            "map", "-r", path("ref.fa"), *qry, "-o", path(out), "--device",
            device, "--no-progress", *flags])
        launches[name] = (counts, n_batches)
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
    run("megabatch 4 -t 4", "mb.sam", "--megabatch", "4", "-t", "4")
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
    for kern in ("sw_score_kernel", "gather_windows_kernel"):
        check(kern in trace, f"the trace names no {kern}")
    rows[-1] += f"; trace {len(trace) / 2**20:.1f} MiB names K1 and K2"
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

    stats, launches, wall = run_cli("child", argv)
    print(json.dumps({
        "launches": launches, "reads_in": stats.reads_in,
        "reads_per_sec": stats.reads_per_sec(), "gcups": stats.gcups(),
        "step_ms": stats.step_device_ms, "timing": stats.timing,
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
            per = r["launches"]
            check(per == {"sw_score": n_b, "gather_windows": 2 * n_b},
                  f"{name} process {i}: launches {per} for {n_b} batches")
            launches[f"{name} p{i}"] = (per, n_b)
            if name == "shard-across-hosts":
                check(f"this host holds shards [{i}]" in err,
                      f"process {i} does not hold only shard {i}")
            merge = r["timing"].get("merge")
            parts.append(
                f"p{i} {r['reads_in']} reads in {n_b} batch(es), "
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
        check(counts == {"sw_score": 2 * n_b, "gather_windows": 4 * n_b},
              f"{name}: launches {counts}, expected 2 K1 and 4 K2 a batch")
        launches[name] = (counts, n_b)
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
    print("[16 parallel b] the dp step on the slots [cuda:0, cuda:0], the "
          "slices one after the other, SAM equal to phases 6 and 7: "
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


def main():
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "nextgenmap_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(nextgenmap_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    if sys.argv[1:2] == ["--child"]:
        return child(sys.argv[2:])
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
    k1 = k1_shapes[K1_MAIN]
    k3_err, k3, k3_launches = phase_row_gather(card)
    codes, launches = {}, {}     # launches: {path: (counts, batches)}
    with tempfile.TemporaryDirectory() as workdir:
        ref_path = os.path.join(workdir, "ref.fa")
        synthetic.write_fasta(ref_path, "chr", genome)
        for path, phase in (("single", phase_main_path),
                            ("paired", phase_paired_path),
                            ("topn", phase_topn_path),
                            ("end-to-end", phase_e2e_path),
                            ("bisulfite", phase_bisulfite_path),
                            ("long", phase_long_path)):
            codes[path], counts = phase(genome, workdir)
            launches[path] = (counts, N_BATCHES if path == "single"
                              else N_BATCHES_NEW)
        phase_cuda_equals_cpu(genome, codes, cfg, ref_path)
        (sharded, k1_pool, k2_flat, (k1_sh_err, k2_sh_err),
         sharded_memory) = phase_sharded_cli(genome, workdir, codes["single"],
                                             cfg, card)
        launches.update(sharded)
        giga_counts, giga_batches, _ = phase_gigabase(card)
        launches["gigabase-4"] = (giga_counts, giga_batches)
        runtime, t1 = phase_runtime(workdir)
        launches.update(runtime)
        launches.update(phase_parallel(workdir, t1, sharded_memory))
    check("jax" not in sys.modules, "the port imported jax")
    reference = sorted(m for m in sys.modules if m == "nextgenmap_tpu"
                       or m.startswith("nextgenmap_tpu."))
    check(not reference, f"the port imported the JAX package: {reference}")
    k1_shapes[k1_pool.pop("shape")] = k1_pool

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
        row("sw_score", "nextgenmap_tpu_torch/csrc/sw_score.cu",
            "nextgenmap_tpu/ops/sw_pallas.py:150", max(k1_err, k1_sh_err), k1,
            total("sw_score"), per_step("sw_score"), "operations", None,
            gcups=k1["gcups"],
            shape=K1_MAIN + ": the single-end path's input",
            other_shapes={
                shape: {"device_ms": t["device_ms"], "bound_ms": t["bound_ms"],
                        "share": t["bound_ms"] / t["device_ms"]}
                for shape, t in k1_shapes.items() if shape != K1_MAIN}),
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
            gather_rep1_ms=k3["gather_rep1_ms"],
            shape="256x1024 REP 32 dim 1"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
