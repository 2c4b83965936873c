"""What two slices of a batch on two slots of one card cost, run in worker
threads or one after the other, against the whole batch on one slot.

    python -m nextgenmap_tpu_torch.tools.dp_overlap [--rounds 4] [--batches 3]

The input is chip_smoke.py's phase 6: the 4.6 Mbp genome with 120 planted
repeats, its index built on the device, and `--batches` batches of 4096
100 bp reads at 2% SNPs, seeded the same way.  Three variants map every
batch through ``Mapper.map_batch``:

  one slot   the Mapper on [cuda:0]
  threads    the Mapper on [cuda:0, cuda:0], each slice in a worker thread
             under a CUDA stream of its own (``ThreadedRunner`` below, the
             port's first runner of the slices)
  loop       the same Mapper, the slices one after the other on the
             current stream (the port's ``parallel/dp.py::SliceRunner``)

Each variant maps one warm-up batch, then in every round all batches; the
order of the variants turns around every round.  Per batch: the wall time
(synchronised) and the device step from CUDA events around the call.  The
results of both two-slot variants must equal the one slot's, field for
field.  Prints the card's name and power limit, one line per round and
variant, and one JSON object as the last line: the median, min and max of
each variant's ms per batch.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from nextgenmap_tpu_torch import synthetic
from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.models import mapper as mapper_mod
from nextgenmap_tpu_torch.parallel.dp import SliceRunner

SEED = 2026            # chip_smoke.py's
GENOME_SIZE = 4_600_000
BATCH = 4096
READ_LEN = 100


class ThreadedRunner:
    """fn(i) for each row in a worker thread of its own, on a CUDA stream of
    its own; the caller's stream waits on each row's event, and every result
    tensor is recorded on the caller's stream for the allocator."""

    def __init__(self, rows):
        self.rows = rows
        self.pool = ThreadPoolExecutor(max_workers=len(rows))
        self.streams = [torch.cuda.Stream(device=r[0]) for r in rows]

    def _task(self, fn, i, caller):
        s = self.streams[i]
        s.wait_stream(caller)
        with torch.cuda.stream(s), torch.cuda.device(s.device):
            out = fn(i)
            ev = torch.cuda.Event()
            ev.record(s)
        return out, ev

    def run(self, fn) -> list:
        futures = [self.pool.submit(self._task, fn, i,
                                    torch.cuda.current_stream(s.device))
                   for i, s in enumerate(self.streams)]
        outs = []
        for f in futures:
            out, ev = f.result()
            torch.cuda.current_stream(ev.device).wait_event(ev)
            for t in out:
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(torch.cuda.current_stream(t.device))
            outs.append(out)
        return outs


def time_batch(mapper, codes, lengths):
    """(result, wall ms, device ms) of one map_batch."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    r = mapper.map_batch(codes, lengths)
    end.record()
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--batches", type=int, default=3)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dp_overlap needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    g = synthetic.repeat_genome(GENOME_SIZE, n_repeats=120, min_len=1000,
                                max_len=2000, seed=SEED)
    codes, _, _ = synthetic.simulate_reads(g, a.batches * BATCH, READ_LEN,
                                           0.02, seed=SEED + 1)
    codes = np.asarray(codes, np.uint8)
    lengths = np.full(codes.shape[0], READ_LEN, np.int32)

    class Genome:
        pass

    Genome.codes = g
    cfg = NgmConfig()
    dev = torch.device("cuda", 0)
    one = mapper_mod.Mapper(cfg, Genome, READ_LEN, device=dev)
    two = mapper_mod.Mapper(cfg, Genome, READ_LEN, device=[dev, dev])
    rows = [[dev], [dev]]
    runners = {"threads": ThreadedRunner(rows), "loop": SliceRunner(rows)}

    def use(name):
        if name != "one slot":
            two._runner = runners[name]
            return two
        return one

    batches = [(codes[i * BATCH:(i + 1) * BATCH],
                lengths[i * BATCH:(i + 1) * BATCH]) for i in range(a.batches)]
    names = ["one slot", "threads", "loop"]
    want = []
    for name in names:                  # warm-up, and the one slot's results
        for b, (c, n) in enumerate(batches[:1] if name != "one slot"
                                   else batches):
            r, _, _ = time_batch(use(name), c, n)
            if name == "one slot":
                want.append([t.cpu() for t in r])
    wall = {n: [] for n in names}
    device = {n: [] for n in names}
    for rnd in range(a.rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            w_ms, d_ms = [], []
            for b, (c, n) in enumerate(batches):
                r, w, d = time_batch(use(name), c, n)
                if not all(torch.equal(x.cpu(), y)
                           for x, y in zip(r, want[b])):
                    raise RuntimeError(f"{name}: batch {b} differs from the "
                                       "one slot's result")
                w_ms.append(w)
                d_ms.append(d)
            wall[name] += w_ms
            device[name] += d_ms
            print(f"round {rnd + 1} {name}: wall ms per batch "
                  f"{[round(x, 1) for x in w_ms]}, device step ms "
                  f"{[round(x, 1) for x in d_ms]}", flush=True)

    def stat(v):
        return {"median": statistics.median(v), "min": min(v), "max": max(v)}

    print(json.dumps({n: {"wall_ms": stat(wall[n]),
                          "device_ms": stat(device[n])} for n in names}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
