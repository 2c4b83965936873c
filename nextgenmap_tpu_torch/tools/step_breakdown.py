"""Where a mapping step's time goes, per cell, on one CUDA card.

    python -m nextgenmap_tpu_torch.tools.step_breakdown [--cells single sharded-4 ...] [--plain-traceback]

Cells (the inputs of ``chip_smoke.py``, seeded the same way):

  single      the 4.6 Mbp genome with 120 planted repeats, 100 bp reads at
              2% SNPs, B = 4096, index built on the device (phase 6)
  sharded-4   the same with --index-shards 4 (the cross-shard tail pool)
  sharded-2   the same with --index-shards 2 (full per-shard tails)
  long        the same genome, 1000 bp reads at 3% SNPs and 0.5% indels,
              B = 614, W = 184 (phase 11)
  gigabase-4  the 2^31 + 2^27 base genome in 4 shards (phase 14: k 13,
              index skip 2, read stride 1; full per-shard tails)
  dp-2        single's input on the slots [cuda:0, cuda:0] (the dp step:
              two slices of 2048, one graph of K = 2 on one card)
  grid-2x2    single's input with --index-shards 2 on four slots of
              cuda:0 (the ("dp", "ish") grid [2, 2]: two rows of 2048,
              each the shard loop with full per-shard tails, one graph)
  paired      the single cell's genome, 2048 FR pairs a batch (insert
              350 +- 40, phase 7), through Mapper.map_batch_paired
  topn        single's input with -n 2, through Mapper.map_batch_topn
  e2e         single's input with --end-to-end (phase 9)
  bisulfite   --bs-mapping on the same genome, bisulfite reads (original
              top and bottom strands, 80% of C read as T; phase 10)

The traceback runs as the mapper calls it: the finish pass
(``ops/finish_kernel.py``, K4's forward pass and walk with the filters and
MAPQ in one launch), and top-n's K4 (``ops/sw_align_kernel.py``);
``--plain-traceback`` puts the plain versions in their place (the
finish's torch ops and K2 around ``ops/sw_ref.py::banded_sw_align``, a
loop of torch calls a row), so both can be measured in one process on one
card.

For each cell, through ``Mapper.map_batch`` (or the cell's own step), in
two forms on the same
batches: "graph" (each step one captured CUDA graph, ``models/
step_graph.py``, as the mapper runs it by default; its first batch
captures) and "eager" (the same Mapper with ``StepGraphs(...,
eager=True)``, the step launched op by op).  Per form: the step time (host
clock, synchronised) of WARM batches, median, min and max; the device's
busy share over PROFILED batches (kernel rows of torch.profiler over the
window's wall time; "not measured" where the profiler recorded no kernel),
the kernel launches and graph replays a batch there; for the graph, a
bare replay of its last capture under torch.profiler (its device nodes:
kernels, memsets and copies, the kernels among them, and the device's
busy share of that replay, ``tools/timing.py::device_profile``).  Eager only (a
synchronise inside a graph cannot be): the traceback's share of the step
(a synchronise on each side of the finish pass, or top-n's
``sw_align``) and the score pass's real
slots per batch (its asked-for slots, capped) over TIMED batches.  And the peak device memory of
the cell (state, steps and the graph's pool).  Prints the card's name and
power limit, one line per cell, and one JSON object as the last line.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from nextgenmap_tpu_torch import synthetic
from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.index.kmer_index import KmerIndex
from nextgenmap_tpu_torch.models import mapper as mapper_mod
from nextgenmap_tpu_torch.models.step_graph import StepGraphs
from nextgenmap_tpu_torch.ops import finish_kernel
from nextgenmap_tpu_torch.ops.sw_ref import banded_sw_align
from nextgenmap_tpu_torch.parallel.index_shard import ShardedIndex
from nextgenmap_tpu_torch.tools.timing import device_profile

SEED = 2026            # chip_smoke.py's
WARM, TIMED, PROFILED = 6, 3, 2
CELLS = {   # name: (genome size, shards, config changes, read length, batch,
            #        slots of the card, the Mapper's step)
    "single": (4_600_000, 1, {}, 100, 4096, 1, "map_batch"),
    "sharded-4": (4_600_000, 4, {}, 100, 4096, 1, "map_batch"),
    "sharded-2": (4_600_000, 2, {}, 100, 4096, 1, "map_batch"),
    "long": (4_600_000, 1, {}, 1000, 614, 1, "map_batch"),
    "gigabase-4": ((1 << 31) + (1 << 27), 4,
                   dict(kmer_skip=2, read_kmer_skip=1), 100, 4096, 1,
                   "map_batch"),
    "dp-2": (4_600_000, 1, {}, 100, 4096, 2, "map_batch"),
    "grid-2x2": (4_600_000, 2, {}, 100, 4096, 4, "map_batch"),
    "paired": (4_600_000, 1, {}, 100, 4096, 1, "map_batch_paired"),
    "topn": (4_600_000, 1, dict(topn=2), 100, 4096, 1, "map_batch_topn"),
    "e2e": (4_600_000, 1, dict(end_to_end=True), 100, 4096, 1, "map_batch"),
    "bisulfite": (4_600_000, 1, dict(bs_mapping=True), 100, 4096, 1,
                  "map_batch"),
}


def make_mapper(size: int, shards: int, changes: dict, read_len: int,
                device):
    """(Mapper, genome codes) of a cell: the genome and index as
    chip_smoke.py builds them.  `device` is a device or a list of slots."""
    cfg = NgmConfig(index_shards=shards, **changes)
    gen = (synthetic.repeat_genome if size < 1 << 28
           else synthetic.repeat_genome_large)
    g = gen(size, n_repeats=120, min_len=1000, max_len=2000, seed=SEED)
    index = None
    if shards > 1:
        host = KmerIndex.build(g, k=cfg.kmer, skip=cfg.kmer_skip,
                               max_freq=cfg.max_kmer_freq, canonical=True,
                               allow_u32=True)
        index = ShardedIndex.build(host, g, shards, ShardedIndex.halo_for(cfg))
        del host

    class Codes:
        codes = g

    return mapper_mod.Mapper(cfg, Codes, read_len, index, device=device), g


class Instrument:
    """Within `with`: a synchronise on each side of every traceback call
    (the finish pass, or top-n's K4; their seconds summed) and the score
    pass's real slots counted, by wrapping the functions the mapper module
    calls."""

    NAMES = ("finish_pass", "sw_align", "score_pass")

    def __enter__(self):
        self.tb_s, self.slots = 0.0, 0
        self.orig = {n: getattr(mapper_mod, n) for n in self.NAMES}

        def timed(fn):
            def call(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                self.tb_s += time.perf_counter() - t
                return out
            return call

        def score(*a, **k):
            out = self.orig["score_pass"](*a, **k)
            self.slots += min(int(out.n_sc.sum()), k["slot_cap"])
            return out

        mapper_mod.finish_pass = timed(self.orig["finish_pass"])
        mapper_mod.sw_align = timed(self.orig["sw_align"])
        mapper_mod.score_pass = score
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(mapper_mod, n, fn)


def run_cell(name: str, device="cuda") -> dict:
    size, shards, changes, read_len, batch, slots, method = CELLS[name]
    torch.cuda.reset_peak_memory_stats()
    m, g = make_mapper(size, shards, changes, read_len,
                       [torch.device(device, 0)] * slots if slots > 1
                       else device)
    step = getattr(m, method)
    n = 1 + WARM + max(TIMED, PROFILED)
    if read_len > 250:
        codes, _, _ = synthetic.simulate_long_reads(
            g, n * batch, read_len, 0.03, 0.005, seed=SEED + 6)
    elif method == "map_batch_paired":
        codes, _, _ = synthetic.simulate_pairs(
            g, n * batch // 2, read_len, 0.02, insert_mean=350,
            insert_sd=40, seed=SEED + 2)
    elif changes.get("bs_mapping"):
        codes, _, _ = synthetic.simulate_bisulfite_reads(
            g, n * batch, read_len, seed=SEED + 5)
    else:
        codes, _, _ = synthetic.simulate_reads(g, n * batch, read_len, 0.02,
                                               seed=SEED + 1)
    lens = np.full(batch, read_len, np.int32)
    forms = {"graph": m.graphs, "eager": StepGraphs(m.device, eager=True)}

    def steps(first: int, count: int) -> list:
        out = []
        for i in range(first, first + count):
            t = time.perf_counter()
            step(codes[i * batch:(i + 1) * batch], lens)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
        return out

    res = {}
    for form, graphs in forms.items():
        m.graphs = graphs
        steps(0, 1)         # the graph's capture; the eager allocator
        warm = steps(1, WARM)
        replays, launched = graphs.replays, mapper_mod.score_pass.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = sum(steps(1 + WARM, PROFILED))
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        res[form] = {
            "step_ms": 1e3 * statistics.median(warm),
            "step_ms_min": 1e3 * min(warm), "step_ms_max": 1e3 * max(warm),
            "device_busy": busy_us / 1e6 / wall if busy_us else None,
            "kernel_launches_per_batch": kernels / PROFILED,
            "score_pass_launches_per_batch": (
                mapper_mod.score_pass.launches - launched) / PROFILED,
            "graph_replays_per_batch": (graphs.replays - replays) / PROFILED,
        }
        if not graphs.eager:    # the graph's own nodes: a bare replay
            bare = device_profile(
                list(graphs._entries.values())[-1].graph.replay)
            res[form].update(graph_nodes=bare["records"],
                             graph_kernels=bare["kernels"],
                             bare_replay_busy=bare["busy"])
    with Instrument() as ins:       # eager, as the loop above left it
        timed = sum(steps(1 + WARM, TIMED))
    m.graphs = forms["graph"]
    res.update(
        traceback_share=ins.tb_s / timed,
        k1_real_slots_per_batch=ins.slots / TIMED,
        captures=forms["graph"].captures,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cells", nargs="+", default=list(CELLS),
                   choices=list(CELLS))
    p.add_argument("--plain-traceback", action="store_true",
                   help="run the traceback's plain version in place of K4")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_breakdown: no CUDA card", file=sys.stderr)
        return 2
    kernels = (mapper_mod.finish_pass, mapper_mod.sw_align,
               finish_kernel.sw_align)
    if a.plain_traceback:
        mapper_mod.finish_pass = finish_kernel.finish_plain
        mapper_mod.sw_align = finish_kernel.sw_align = banded_sw_align
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"traceback: "
          f"{'plain' if a.plain_traceback else 'the finish pass and K4'}")
    out = {}
    try:
        for name in a.cells:
            out[name] = run_cell(name)
            print_cell(name, out[name])
    finally:
        (mapper_mod.finish_pass, mapper_mod.sw_align,
         finish_kernel.sw_align) = kernels
    print(json.dumps({"card": card, "plain_traceback": a.plain_traceback,
                      "cells": out}))
    return 0


def print_cell(name: str, r: dict) -> None:
    forms = []
    for form in ("graph", "eager"):
        f = r[form]
        busy = ("not measured" if f["device_busy"] is None
                else f"{100 * f['device_busy']:.1f}%")
        forms.append(
            f"{form}: step {f['step_ms']:.2f} ms median of {WARM} "
            f"({f['step_ms_min']:.2f}-{f['step_ms_max']:.2f}), device busy "
            f"{busy} over {PROFILED} steps, "
            f"{f['kernel_launches_per_batch']:.0f} kernels, score pass "
            f"{f['score_pass_launches_per_batch']:.0f} and "
            f"{f['graph_replays_per_batch']:.0f} graph replays a batch"
            + (f", a bare replay {f['graph_nodes']} device nodes "
               f"({f['graph_kernels']} kernels), busy "
               f"{100 * f['bare_replay_busy']:.1f}%" if "graph_nodes" in f
               else ""))
    print(f"[{name}] " + "; ".join(forms) + f"; traceback "
          f"{100 * r['traceback_share']:.1f}% of {TIMED} eager steps; K1 "
          f"real slots {r['k1_real_slots_per_batch']:.0f} per batch; peak "
          f"{r['peak_gib']:.3f} GiB", flush=True)


if __name__ == "__main__":
    sys.exit(main())
