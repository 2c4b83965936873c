"""The port's benchmark: reads/s per card and GCUPS on BASELINE config-1.

    python -m nextgenmap_tpu_torch.bench [--device cuda|cpu]

Counterpart of the repository's root ``bench.py``, with its workload,
counters and output line: a 4.6 Mbp random genome (E. coli K-12 scale,
seed 1), 36 batches of 4096 simulated 100 bp single-end reads at 2% SNPs
(seed 2; warm-up reads seed 3), mapped through the single-end step
``models/mapper.py::map_step`` (candidate search -> score -> select ->
traceback) with the canonical index built on the device and packed
offsets.  Host SAM formatting is not part of it.

The protocol, written for CUDA:

  * every batch of reads and its truth is staged on the device as one
    [N, B, L] tensor before any timing; the step takes slices of it, its
    integer scalars as Python numbers and its float ones as float32
    tensors made once on the device (no copy and no sync a batch);
  * the step is one captured CUDA graph (``models/step_graph.py``, K = 1),
    as root bench.py calls the jitted ``map_step``: a call copies the batch
    into the graph's static input, replays it and clones its outputs.  The
    capture (with its eager warm-up step) is set-up, reported apart as the
    JAX bench's compile is;
  * each batch adds its counters (mapped, truth-correct: within 5 bp of the
    simulated origin on the right strand, candidates, and K1's real slots)
    to a device tensor; one fetch after the sweep brings them back;
  * each timed sweep follows a warm sweep of the same length on the
    warm-up reads (the caching allocator, K4's plan cache);
  * a timed window runs from the first dispatch to the fetched counters,
    closed by a synchronise, on the host clock; CUDA events around it give
    the stream's span;
  * the metric is the marginal time a batch, from a two-point fit over
    N1 = 12 and N = 36 batches, so the fixed cost of a sweep falls out.

GCUPS is root bench.py's step-effective rate: (candidates + reads) x L x W
cells over the marginal time of the N sweep.  ``vs_baseline`` divides by
root bench.py's 15,000 reads/s, its stand-in for a 2013 CPU deployment of
the reference.

stdout holds exactly one JSON line (metric, value, unit, vs_baseline);
the log goes to stderr: the card's name and power limit, the set-up
seconds, the figures, and one ``bench-json:`` line of the run's details.
``--device cuda`` (the default) without a card raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.device import resolve_device
from nextgenmap_tpu_torch.index.device_build import build_index_device
from nextgenmap_tpu_torch.io.simulate import random_genome, simulate_reads_fast
from nextgenmap_tpu_torch.models.mapper import (
    MapResult, default_slot_cap, map_step, score_matrices,
)
from nextgenmap_tpu_torch.models.step_graph import StepGraphs, take
from nextgenmap_tpu_torch.native import build
from nextgenmap_tpu_torch.ops.candidate import pack_offsets
from nextgenmap_tpu_torch.ops.candidate_kernel import candidate_search
from nextgenmap_tpu_torch.ops.finish_kernel import finish_pass
from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
from nextgenmap_tpu_torch.ops.kmer_kernel import read_kmers
from nextgenmap_tpu_torch.ops.score_pass_kernel import score_pass
from nextgenmap_tpu_torch.ops.sw_align_kernel import sw_align

GENOME_SIZE = 4_600_000   # E. coli K-12 scale
READ_LEN = 100
BATCH = 4096
N_BATCHES = 36            # two-point fit: walls at 12 and 36 batches
SNP_RATE = 0.02
BASELINE_READS_PER_SEC = 15_000.0
GENOME_SEED, READS_SEED, WARM_SEED = 1, 2, 3
TRUTH_TOL = 5             # bp between the mapped and the simulated position
# the per-batch counters, in the columns of run()'s "counters"
COUNTERS = ("mapped", "truth_correct", "n_candidates", "k1_real_slots")
KERNELS = {"score_pass": score_pass, "finish_pass": finish_pass,
           "gather_windows": gather_genome_windows, "sw_align": sw_align,
           "read_kmers": read_kmers, "cand_search": candidate_search}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Workload(NamedTuple):
    """The device state and arguments of the bench's step."""

    genome: np.ndarray        # [G] uint8 codes, on the host
    tables: tuple             # (genome, offsets, positions) on the device
    lens: torch.Tensor        # [B] int32
    matrices: torch.Tensor    # [2, 8, 8] int32
    scalars: tuple            # gap penalties, sensitivity, max_freq, filters
    statics: dict             # map_step's keyword arguments
    slot_cap: int             # the score pass's slots (the default cap)
    graphs: StepGraphs        # the step's graph (eager on the CPU)


def workload(genome_size: int, batch: int, device,
             read_len: int = READ_LEN) -> Workload:
    """Root bench.py's set-up (:56-90): the genome on the device, the
    canonical index built there and packed, and the step's statics."""
    dev = resolve_device(device)
    cfg = NgmConfig()
    g = random_genome(genome_size, seed=GENOME_SEED)
    genome_d = torch.from_numpy(g).to(dev)
    off, pos = build_index_device(genome_d, k=cfg.kmer, skip=cfg.kmer_skip,
                                  canonical=True)
    packed = pack_offsets(off, cfg.max_kmer_freq, cfg.max_kmer_fanout)
    if packed is not None:
        off = packed
    statics = dict(
        k=cfg.kmer, fanout_cap=cfg.max_kmer_fanout,
        hit_cap=cfg.resolved_read_hits(int(pos.shape[0]), read_len),
        max_cmrs=cfg.max_cmrs, diag_bin_log2=cfg.diag_bin_log2,
        band=cfg.corridor_for(read_len), min_kmer_hits=1,
        read_stride=cfg.read_kmer_skip, packed_offsets=packed is not None,
        canonical=True,
    )
    # the integers as Python numbers (map_step takes int() of them, a sync
    # on a device scalar), the floats as float32 scalars made once on the
    # device (from a Python number map_step copies one to the device, a
    # sync on every call)
    f32 = partial(torch.tensor, dtype=torch.float32, device=dev)
    scalars = (cfg.gap_read_penalty, cfg.gap_ref_penalty,
               cfg.gap_extend_penalty, f32(cfg.sensitivity),
               cfg.max_kmer_freq, f32(cfg.min_identity),
               f32(cfg.min_residues))
    return Workload(
        g, (genome_d, off, pos),
        torch.full((batch,), read_len, dtype=torch.int32, device=dev),
        torch.from_numpy(score_matrices(cfg)).to(dev), scalars, statics,
        default_slot_cap(batch), StepGraphs(dev))


def stage_reads(w: Workload, n_batches: int, seed: int,
                read_len: int = READ_LEN, snp_rate: float = SNP_RATE):
    """(reads [N, B, L] uint8, truth pos [N, B] int64, truth strand [N, B]
    int8) of simulate_reads_fast on the device."""
    batch = w.lens.shape[0]
    codes, pos, strand = simulate_reads_fast(
        w.genome, batch * n_batches, read_len=read_len, snp_rate=snp_rate,
        seed=seed)
    dev = w.lens.device
    return (torch.from_numpy(codes.reshape(n_batches, batch, read_len)).to(dev),
            torch.from_numpy(pos.reshape(n_batches, batch)).to(dev),
            torch.from_numpy(strand.reshape(n_batches, batch)).to(dev))


def step(w: Workload, reads: torch.Tensor) -> MapResult:
    """map_step on one [B, L] batch of reads, through the graph."""
    def one(r, lens):
        return map_step(*w.tables, r, lens, w.matrices, *w.scalars,
                        **w.statics)

    return take(w.graphs.run("map_step", one, reads[None], w.lens[None],
                             **w.statics), 0)


def batch_counters(w: Workload, r: MapResult, truth_pos: torch.Tensor,
                   truth_strand: torch.Tensor) -> torch.Tensor:
    """[4] int64 on the device: COUNTERS of one batch (root bench.py
    :121-127, and the real slots K1 scored: the candidates of reads with
    two or more, up to the slot cap).  Sums only, so no tie order enters."""
    ok = (r.mapped & ((r.pos.long() - truth_pos).abs() <= TRUTH_TOL)
          & (r.strand == truth_strand))
    n = r.n_candidates
    real = torch.where(n >= 2, n, 0).sum().clamp(max=w.slot_cap)
    return torch.stack([r.mapped.sum(), ok.sum(), n.sum(dtype=torch.int64),
                        real])


def sweep(w: Workload, reads, truth_pos, truth_strand, n: int) -> torch.Tensor:
    """[n, 4] int64 counters of the first n batches, on the device: every
    batch is dispatched with no sync between them."""
    out = torch.empty((n, len(COUNTERS)), dtype=torch.int64,
                      device=w.lens.device)
    for i in range(n):
        out[i] = batch_counters(w, step(w, reads[i]), truth_pos[i],
                                truth_strand[i])
    return out


def timed_sweep(w: Workload, staged, n: int):
    """(counters [n, 4] on the host, wall s, stream span ms or None): the
    wall from the first dispatch to the fetched counters, closed by a
    synchronise; the span between CUDA events on the stream around it."""
    cuda = w.lens.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    t0 = time.perf_counter()
    if cuda:
        start.record()
    counters = sweep(w, *staged, n)
    if cuda:
        end.record()
    host = counters.cpu().numpy()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return host, wall, start.elapsed_time(end) if cuda else None


def fit(walls: dict, n1: int, n: int) -> tuple[float, float]:
    """(marginal s a batch, fixed s a sweep) of the two-point fit through
    the walls of the n1- and n-batch sweeps (root bench.py :161-162)."""
    t_batch = (walls[n] - walls[n1]) / (n - n1)
    return t_batch, walls[n1] - n1 * t_batch


def summarize(counters: np.ndarray, walls: dict, n1: int, batch: int,
              band: int, read_len: int = READ_LEN) -> dict:
    """The figures of a run from the N sweep's per-batch counters ([N, 4],
    columns COUNTERS) and the walls of the n1- and N-batch sweeps: the fit,
    reads/s (a batch over the marginal time) and the step-effective GCUPS,
    (candidates + reads) x L x W cells over the marginal time of the sweep
    (root bench.py :161-172); NaN where the fit is not positive."""
    n_batches = counters.shape[0]
    t_batch, fixed = fit(walls, n1, n_batches)
    n_reads = batch * n_batches
    n_cands = int(counters[:, 2].sum())
    cells = (n_cands + n_reads) * read_len * band
    ok = t_batch > 0
    return {
        "batch": batch, "n_batches": n_batches, "n1": n1, "band": band,
        "walls": walls, "t_batch": t_batch, "fixed": fixed,
        "reads_per_sec": batch / t_batch if ok else float("nan"),
        "gcups": cells / (t_batch * n_batches) / 1e9 if ok else float("nan"),
        "n_reads": n_reads, "mapped": int(counters[:, 0].sum()),
        "truth_correct": int(counters[:, 1].sum()), "n_candidates": n_cands,
        "k1_real_slots_per_batch": float(counters[:, 3].mean()),
    }


def result_line(rps: float) -> str:
    """The one stdout line, with root bench.py's four keys."""
    return json.dumps({
        "metric": "reads_per_sec_per_chip",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / BASELINE_READS_PER_SEC, 3),
    })


def run(genome_size: int = GENOME_SIZE, batch: int = BATCH,
        n_batches: int = N_BATCHES, device="cuda") -> dict:
    """The bench at the given size.  Returns summarize()'s figures, and the
    per-batch counters of the N sweep ([N, 4] int64, columns COUNTERS) and
    of the n1 sweep, the walls and stream spans of both timed sweeps, the
    set-up seconds (the graph's capture among them), each kernel's launches
    and the graph's replays over every sweep, warm ones included."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    setup = {}
    t0 = time.perf_counter()
    if cuda:
        build.load()    # nvcc at first use, else the cached library
    setup["kernel_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    w = workload(genome_size, batch, dev)
    if cuda:
        torch.cuda.synchronize()
    setup["index_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    staged = stage_reads(w, n_batches, READS_SEED)
    warm = stage_reads(w, n_batches, WARM_SEED)
    if cuda:
        torch.cuda.synchronize()
    setup["reads_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    step(w, warm[0][0])     # the capture, with its eager warm-up step
    if cuda:
        torch.cuda.synchronize()
    setup["capture_s"] = time.perf_counter() - t0

    for k in KERNELS.values():
        k.launches = 0
    replays0 = w.graphs.replays
    n1 = n_batches // 3
    walls, spans, counters, warm_walls = {}, {}, {}, {}
    for n in (n1, n_batches):
        t0 = time.perf_counter()
        sweep(w, *warm, n).cpu()
        warm_walls[n] = time.perf_counter() - t0
        counters[n], walls[n], spans[n] = timed_sweep(w, staged, n)
    res = summarize(counters[n_batches], walls, n1, batch, w.statics["band"])
    res.update(
        genome_size=genome_size, counters=counters[n_batches],
        counters_n1=counters[n1], warm_walls=warm_walls, spans_ms=spans,
        setup_s=setup, batches_run=2 * (n1 + n_batches),
        launches={name: k.launches for name, k in KERNELS.items()},
        graph_replays=w.graphs.replays - replays0,
        graph_captures=w.graphs.captures)
    if cuda:
        res["span_fit_ms"] = fit(spans, n1, n_batches)
    return res


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m nextgenmap_tpu_torch.bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        log(f"card: {card_line()}")
    r = run(device=dev)
    s = r["setup_s"]
    log(f"set-up: kernel build {s['kernel_build_s']:.2f} s, index on the "
        f"device {s['index_s']:.2f} s, reads simulated and staged "
        f"{s['reads_s']:.2f} s, step graph captured {s['capture_s']:.2f} s")
    if r["t_batch"] <= 0:
        log(f"the fit is not positive: walls {r['walls']}")
        return 1
    n1, n = r["n1"], r["n_batches"]
    log(f"reads/s: {r['reads_per_sec']:.0f}  GCUPS(step-effective): "
        f"{r['gcups']:.2f}  mapped: {r['mapped']}/{r['n_reads']}  truth "
        f"accuracy (all batches): {r['truth_correct']}/{r['n_reads']}  "
        f"marginal: {r['t_batch'] * 1e3:.2f} ms/batch  fixed: "
        f"{r['fixed'] * 1e3:.0f} ms  walls: {r['walls'][n1] * 1e3:.1f}/"
        f"{r['walls'][n] * 1e3:.1f} ms")
    if "span_fit_ms" in r:
        span, span_fixed = r["span_fit_ms"]
        log(f"stream span (CUDA events): {span:.3f} ms/batch marginal, fixed "
            f"{span_fixed:.1f} ms; spans {r['spans_ms'][n1]:.1f}/"
            f"{r['spans_ms'][n]:.1f} ms against host walls "
            f"{r['walls'][n1] * 1e3:.1f}/{r['walls'][n] * 1e3:.1f} ms")
    log(f"K1 real slots: {r['k1_real_slots_per_batch']:.1f} per batch; "
        f"launches over {r['batches_run']} batches: {r['launches']}")
    log("bench-json: " + json.dumps(
        {k: v for k, v in r.items() if k not in ("counters", "counters_n1")}))
    print(result_line(r["reads_per_sec"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
