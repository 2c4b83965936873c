"""Where the bench's step time goes, on one CUDA card.

    python -m nextgenmap_tpu_torch.tools.bench_breakdown [--rounds 3]

On the bench's workload (``nextgenmap_tpu_torch/bench.py``: the 4.6 Mbp
random genome, B = 4096, 100 bp reads), for the step's float scalars in
two forms: "device" (float32 tensors made once on the card, as the bench
passes them) and "python" (Python floats, as ``Mapper._common_args``
passes them, which ``map_step`` copies to the card on every call):

  syncs      the synchronising operations torch reports in a 2-batch
             sweep and its one fetch (``set_sync_debug_mode("warn")``);
  marginal   ms a batch from the bench's fit over 12 and 36 batches, the
             two forms in turns for --rounds rounds;
  profile    6 batches under torch.profiler, after one window that pays
             the profiler's start-up: kernel time and kernel launches a
             batch, the host's ``cudaLaunchKernel`` time a batch, and the
             largest kernels by device time.

Prints the card's name and power limit, a line per form, and one JSON
object as the last line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import warnings

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from nextgenmap_tpu_torch import bench
from nextgenmap_tpu_torch.config import NgmConfig

PROFILED = 6


def sync_count(w, staged) -> int:
    """Synchronising operations torch reports in a 2-batch sweep and its
    fetch."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            bench.sweep(w, *staged, 2).cpu()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(r.message) for r in rec)


def profiled(w, staged) -> dict:
    """Kernel time, kernel launches and cudaLaunchKernel's host time a
    batch over PROFILED batches, and the five largest kernels."""
    for n in (2, PROFILED):     # the first window pays CUPTI's start-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bench.sweep(w, *staged, n).cpu()
            torch.cuda.synchronize()
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    launch = [e for e in ka if e.key == "cudaLaunchKernel"]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "kernel_ms": sum(e.self_device_time_total for e in kernels)
        / 1e3 / PROFILED,
        "kernels": sum(e.count for e in kernels) / PROFILED,
        "launch_host_ms": sum(e.self_cpu_time_total for e in launch)
        / 1e3 / PROFILED,
        "top_us": {e.key[:60]: e.self_device_time_total / PROFILED
                   for e in top},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=3)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_breakdown: no CUDA card", file=sys.stderr)
        return 2
    card = bench.card_line()
    print(card)
    cfg = NgmConfig()
    w = bench.workload(bench.GENOME_SIZE, bench.BATCH, "cuda")
    forms = {"device": w, "python": w._replace(scalars=(
        cfg.gap_read_penalty, cfg.gap_ref_penalty, cfg.gap_extend_penalty,
        cfg.sensitivity, cfg.max_kmer_freq, cfg.min_identity,
        cfg.min_residues))}
    staged = bench.stage_reads(w, bench.N_BATCHES, bench.READS_SEED)
    n1 = bench.N_BATCHES // 3
    for f in forms.values():
        bench.sweep(f, *staged, 4).cpu()    # K4's plan, the allocator
    out = {name: {"syncs": sync_count(f, staged), "marginal_ms": []}
           for name, f in forms.items()}
    for r in range(a.rounds):
        for name in (list(forms) if r % 2 == 0 else list(forms)[::-1]):
            walls = {n: bench.timed_sweep(forms[name], staged, n)[1]
                     for n in (n1, bench.N_BATCHES)}
            out[name]["marginal_ms"].append(
                1e3 * bench.fit(walls, n1, bench.N_BATCHES)[0])
    for name, f in forms.items():
        out[name].update(profiled(f, staged))
        r = out[name]
        print(f"[{name} scalars] {r['syncs']} syncs in a 2-batch sweep and "
              f"its fetch; marginal ms a batch in turns {r['marginal_ms']}; "
              f"{r['kernel_ms']:.3f} ms of kernels in {r['kernels']:.0f} "
              f"launches a batch, cudaLaunchKernel {r['launch_host_ms']:.3f}"
              f" ms of host time a batch; largest kernels (us a batch) "
              f"{r['top_us']}", flush=True)
    print(json.dumps({"card": card, "forms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
