"""Where a mapping step's time goes, per cell, on one CUDA card.

    python -m nextgenmap_tpu_torch.tools.step_breakdown [--cells single sharded-4 ...]

Cells (the inputs of ``chip_smoke.py``, seeded the same way):

  single      the 4.6 Mbp genome with 120 planted repeats, 100 bp reads at
              2% SNPs, B = 4096, index built on the device (phase 6)
  sharded-4   the same with --index-shards 4 (the cross-shard tail pool)
  sharded-2   the same with --index-shards 2 (full per-shard tails)
  gigabase-4  the 2^31 + 2^27 base genome in 4 shards (phase 14: k 13,
              index skip 2, read stride 1; full per-shard tails)

For each cell, through ``Mapper.map_batch`` after one warm-up batch: the
step time (host clock, synchronised) of WARM batches, median, min and max;
the traceback's share of the step (a synchronise on each side of
``banded_sw_align``) and K1's real slots per batch (slots of length > 0)
over TIMED batches; the device's busy share over PROFILED batches (kernel
rows of torch.profiler over the window's wall time); the peak device memory
of the cell (state and steps).  Prints the card's name and power limit, one
line per cell, and one JSON object as the last line.  Needs a CUDA card.
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
from nextgenmap_tpu_torch.parallel.index_shard import ShardedIndex

SEED = 2026            # chip_smoke.py's
BATCH = 4096
READ_LEN = 100
WARM, TIMED, PROFILED = 6, 3, 2
CELLS = {   # name: (genome size, shards, config changes)
    "single": (4_600_000, 1, {}),
    "sharded-4": (4_600_000, 4, {}),
    "sharded-2": (4_600_000, 2, {}),
    "gigabase-4": ((1 << 31) + (1 << 27), 4,
                   dict(kmer_skip=2, read_kmer_skip=1)),
}


def make_mapper(size: int, shards: int, changes: dict, device):
    """(Mapper, genome codes) of a cell: the genome and index as
    chip_smoke.py builds them."""
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

    return mapper_mod.Mapper(cfg, Codes, READ_LEN, index, device=device), g


class Instrument:
    """Within `with`: a synchronise on each side of every traceback call
    (its seconds summed) and K1's real slots counted, by wrapping the two
    functions the mapper module calls."""

    def __enter__(self):
        self.tb_s, self.slots = 0.0, 0
        self.orig = (mapper_mod.banded_sw_align, mapper_mod.sw_score)

        def align(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = self.orig[0](*a, **k)
            torch.cuda.synchronize()
            self.tb_s += time.perf_counter() - t
            return out

        def score(*a, **k):
            self.slots += int((a[1] > 0).sum())
            return self.orig[1](*a, **k)

        mapper_mod.banded_sw_align, mapper_mod.sw_score = align, score
        return self

    def __exit__(self, *exc):
        mapper_mod.banded_sw_align, mapper_mod.sw_score = self.orig


def run_cell(name: str, device="cuda") -> dict:
    size, shards, changes = CELLS[name]
    torch.cuda.reset_peak_memory_stats()
    m, g = make_mapper(size, shards, changes, device)
    n = 1 + WARM + TIMED + PROFILED
    codes, _, _ = synthetic.simulate_reads(g, n * BATCH, READ_LEN, 0.02,
                                           seed=SEED + 1)
    lens = np.full(BATCH, READ_LEN, np.int32)
    batches = iter(codes[i * BATCH:(i + 1) * BATCH] for i in range(n))

    def step():
        t = time.perf_counter()
        m.map_batch(next(batches), lens)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    step()
    warm = [step() for _ in range(WARM)]
    with Instrument() as ins:
        timed = sum(step() for _ in range(TIMED))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = sum(step() for _ in range(PROFILED))
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return {
        "step_ms": 1e3 * statistics.median(warm),
        "step_ms_min": 1e3 * min(warm), "step_ms_max": 1e3 * max(warm),
        "traceback_share": ins.tb_s / timed,
        "k1_real_slots_per_batch": ins.slots / TIMED,
        "device_busy": busy_us / 1e6 / wall,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cells", nargs="+", default=list(CELLS),
                   choices=list(CELLS))
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_breakdown: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    out = {}
    for name in a.cells:
        out[name] = r = run_cell(name)
        print(f"[{name}] step {r['step_ms']:.2f} ms median of {WARM} "
              f"({r['step_ms_min']:.2f}-{r['step_ms_max']:.2f}); traceback "
              f"{100 * r['traceback_share']:.1f}% of {TIMED} steps; K1 real "
              f"slots {r['k1_real_slots_per_batch']:.0f} per batch; device "
              f"busy {100 * r['device_busy']:.1f}% over {PROFILED} steps; "
              f"peak {r['peak_gib']:.3f} GiB", flush=True)
    print(json.dumps({"card": card, "cells": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
