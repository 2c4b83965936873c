#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (nextgenmap_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, and outside a checkout of
the repository).  Phases, one line of output each:

  1. card     the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    nvcc builds both hand-written kernels from the checkout
  3. K2       gather kernel == its plain PyTorch version on the card (exact),
              at 2048x148, 4096x148 and 4096x206 with windows past the end
  4. K1       SW score kernel == its plain version on the card (exact) at
              the main path's shapes and the long-read bands, with GCUPS
  5. main     the port's CLI maps 3 x 4096 simulated 100 bp reads (2% SNPs)
              against a 4.6 Mbp genome with planted repeats (E. coli K-12
              scale) on the card; >= 99% mapped, >= 95% truth-correct, both
              kernels launched by that run, and K1 scored real candidates
  6. cuda=cpu one 4096-read batch mapped on the card and on the CPU from the
              same state: all 17 MapResult fields equal

Any failure raises and ends the run without the final line.  The line
before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Everything is made from fixed seeds; nothing is fetched.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

READ_LEN = 100
BATCH = 4096
N_BATCHES = 3
GENOME_SIZE = 4_600_000
SEED = 2026


def check(ok, what):
    if not ok:
        raise RuntimeError(what)


def median_ms(fn, reps, warmup=2):
    """Median per-call time in ms over `reps` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def phase_build():
    from nextgenmap_tpu_torch.native import build

    t0 = time.perf_counter()
    cached = os.path.exists(build.library_path())
    path = build.build()
    build.load()
    print(f"[2 build] {time.perf_counter() - t0:.2f} s "
          f"({'cached' if cached else 'nvcc'}) -> "
          f"{os.path.relpath(path, os.path.dirname(os.path.abspath(__file__)))}")


def phase_gather(genome_dev, rng):
    import torch

    from nextgenmap_tpu_torch.ops.gather import gather_windows, pad_table
    from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows

    G = genome_dev.shape[0]
    err = 0
    timing = {}
    for n, T in ((2048, 148), (4096, 148), (4096, 206)):
        s = rng.integers(0, G + 1, n).astype(np.int32)
        s[:6] = [0, G - T, G - T + 1, G - T // 2, G - 1, G]   # past the end too
        starts = torch.from_numpy(s).cuda()
        k = lambda: gather_genome_windows(genome_dev, starts, T)  # noqa: E731
        p = lambda: gather_windows(pad_table(genome_dev, T, 4), starts, T)  # noqa: E731
        got, ref = k(), p()
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"K2 differs from plain at {n}x{T}")
        err = max(err, max_abs_err([got], [ref]))
        timing[(n, T)] = (median_ms(k, 50), median_ms(p, 50))
    line = ", ".join(f"{n}x{T}: kernel {a:.4f} ms / plain {b:.4f} ms"
                     for (n, T), (a, b) in timing.items())
    print(f"[3 K2 gather] exact at every shape; {line}")
    return err, timing[(2048, 148)]


def _sw_inputs(rng, S, L, W):
    """Queries, and corridors holding each query with ~2% SNPs and a short
    indel at a random offset; every 16th slot is an all-4 (invalid) one."""
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
    msel = rng.integers(0, 2, S).astype(np.int32)
    return q, lens.astype(np.int32), r, msel


def _general_matrices(rng):
    """Two asymmetric [8, 8] matrices: positive ACGT diagonal, random
    off-diagonal scores, N scored as a mismatch."""
    m = rng.integers(-20, 4, (2, 8, 8)).astype(np.int32)
    for c in range(4):
        m[:, c, c] = rng.integers(6, 13, 2)
    m[:, 4, :] = m[:, :, 4] = -15
    return m


def phase_sw(rng, cfg):
    import torch

    from nextgenmap_tpu_torch.models.mapper import score_matrices
    from nextgenmap_tpu_torch.ops.sw_kernel import sw_score
    from nextgenmap_tpu_torch.ops.sw_ref import banded_sw_score

    shapes = [  # (S, L, W, general matrices)
        (2048, 100, 48, False), (2048, 150, 56, False), (1000, 100, 48, True),
        (777, 100, 48, False), (64, 500, 120, False), (32, 1000, 184, False),
    ]
    err = 0
    rows = []
    main = None
    for S, L, W, general in shapes:
        q, lens, r, msel = _sw_inputs(rng, S, L, W)
        mats = _general_matrices(rng) if general else score_matrices(cfg)
        args = [torch.from_numpy(a).cuda() for a in (q, lens, r, mats)]
        gaps = (30, 25, 7) if general else (cfg.gap_read_penalty,
                                            cfg.gap_ref_penalty,
                                            cfg.gap_extend_penalty)
        ms = torch.from_numpy(msel).cuda()
        k = lambda: sw_score(*args, *gaps, ms, band=W)  # noqa: E731
        p = lambda: banded_sw_score(*args, *gaps, ms, band=W)  # noqa: E731
        got, ref = k(), p()
        torch.cuda.synchronize()
        for name, a, b in zip(("score", "end_i", "end_o"), got, ref):
            check(torch.equal(a, b), f"K1 {name} differs from plain at "
                                     f"[{S},{L}]xW{W}")
        check(int(got.score.max()) > 0, f"K1 scored nothing at [{S},{L}]xW{W}")
        err = max(err, max_abs_err(got, ref))
        t_k = median_ms(k, 20)
        t_p = median_ms(p, 3, warmup=1)
        cells = S * L * W
        rows.append(f"[{S},{L}]xW{W}{' 2 general mats' if general else ''}: "
                    f"kernel {t_k:.3f} ms ({cells / t_k / 1e6:.2f} GCUPS) / "
                    f"plain {t_p:.3f} ms ({cells / t_p / 1e6:.3f} GCUPS)")
        if main is None:
            main = (t_k, t_p)
    print("[4 K1 sw_score] exact at every shape; " + "; ".join(rows))
    return err, main


def map_argv(workdir, device="cuda"):
    """The main path's command line: default settings (k=13, B=4096)."""
    return ["map", "-r", os.path.join(workdir, "ref.fa"),
            "-q", os.path.join(workdir, "reads.fq"),
            "-o", os.path.join(workdir, "out.sam"),
            "--device", device, "--no-progress"]


def phase_main_path(genome, workdir, device="cuda"):
    from nextgenmap_tpu_torch import cli, synthetic
    from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
    from nextgenmap_tpu_torch.ops.sw_kernel import sw_score

    fa = os.path.join(workdir, "ref.fa")
    fq = os.path.join(workdir, "reads.fq")
    sam = os.path.join(workdir, "out.sam")
    synthetic.write_fasta(fa, "chr", genome)
    n = N_BATCHES * BATCH
    codes, pos, strand = synthetic.simulate_reads(genome, n, READ_LEN, 0.02,
                                                  seed=SEED + 1)
    synthetic.write_fastq(fq, codes, pos, strand)

    sw_score.launches = 0
    gather_genome_windows.launches = 0
    t0 = time.perf_counter()
    stats = cli.run(map_argv(workdir, device))
    wall = time.perf_counter() - t0
    reads_per_s = stats.reads_per_sec()
    launches = {"sw_score": sw_score.launches,
                "gather_windows": gather_genome_windows.launches}

    records, mapped, correct = synthetic.truth_correct(sam)
    check(records == n, f"SAM holds {records} records, expected {n}")
    check(mapped >= 0.99 * n, f"only {mapped}/{n} reads mapped")
    check(correct >= 0.95 * n, f"only {correct}/{n} reads truth-correct")
    check(launches["sw_score"] > 0, "the main path never launched K1")
    check(launches["gather_windows"] > 0, "the main path never launched K2")
    check(stats.slots_scored > 0, "K1 scored no real candidate on the main path")
    phases = {k: round(v, 3) for k, v in sorted(stats.timing.items())}
    print(f"[5 main path] {n} reads x {READ_LEN} bp, {GENOME_SIZE} bp genome: "
          f"mapped {mapped} ({100 * mapped / n:.2f}%), truth-correct {correct} "
          f"({100 * correct / n:.2f}%); {reads_per_s:.0f} reads/s after the "
          f"index build; launches {launches}; real slots scored "
          f"{stats.slots_scored}; phase s {phases}; wall {wall:.2f} s")
    return codes, launches


def phase_cuda_equals_cpu(genome, codes, cfg, device="cuda"):
    import torch

    from nextgenmap_tpu_torch.models.mapper import Mapper

    class Codes:
        pass

    g = Codes()
    g.codes = genome
    lens = np.full(BATCH, READ_LEN, np.int32)
    batch = codes[:BATCH]
    gpu = Mapper(cfg, g, READ_LEN, device=device)
    index = (gpu.state.offsets.cpu().numpy(), gpu.state.positions.cpu().numpy())
    cpu = Mapper(cfg, g, READ_LEN, index, device="cpu")
    t0 = time.perf_counter()
    a = gpu.map_batch(batch, lens)
    if gpu.device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    b = cpu.map_batch(batch, lens)
    t2 = time.perf_counter()
    for f in a._fields:
        check(torch.equal(getattr(a, f).cpu(), getattr(b, f)),
              f"cuda and cpu MapResult differ in {f}")
    n_multi = int((b.n_candidates >= 2).sum())
    print(f"[6 cuda=cpu] all {len(a._fields)} MapResult fields equal on "
          f"{BATCH} reads ({n_multi} with >= 2 candidates); one batch "
          f"{t1 - t0:.3f} s on cuda, {t2 - t1:.3f} s on cpu")


def main():
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "nextgenmap_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(nextgenmap_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    phase_card()
    import torch

    from nextgenmap_tpu_torch import cli, synthetic

    phase_build()
    cfg = cli.parse(map_argv("."))[2]
    rng = np.random.default_rng(SEED)
    genome = synthetic.repeat_genome(GENOME_SIZE, n_repeats=120, min_len=1000,
                                     max_len=2000, seed=SEED)
    k2_err, k2_ms = phase_gather(torch.from_numpy(genome).cuda(), rng)
    k1_err, k1_ms = phase_sw(rng, cfg)
    with tempfile.TemporaryDirectory() as workdir:
        codes, launches = phase_main_path(genome, workdir)
    phase_cuda_equals_cpu(genome, codes, cfg)
    check("jax" not in sys.modules, "the port imported jax")

    kernels = [
        {"name": "sw_score", "route": "cuda",
         "source": "nextgenmap_tpu_torch/csrc/sw_score.cu",
         "replaces": "nextgenmap_tpu/ops/sw_pallas.py:150",
         "launches": launches["sw_score"], "max_abs_err": k1_err,
         "ms": k1_ms[0], "plain_ms": k1_ms[1]},
        {"name": "gather_windows", "route": "cuda",
         "source": "nextgenmap_tpu_torch/csrc/gather_windows.cu",
         "replaces": "nextgenmap_tpu/ops/gather_pallas.py:124",
         "launches": launches["gather_windows"], "max_abs_err": k2_err,
         "ms": k2_ms[0], "plain_ms": k2_ms[1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
