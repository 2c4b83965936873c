"""Where the bench's step time goes, on one CUDA card: eager against graph.

    python -m nextgenmap_tpu_torch.tools.bench_breakdown [--rounds 3]

On the bench's workload (``nextgenmap_tpu_torch/bench.py``: the 4.6 Mbp
random genome, B = 4096, 100 bp reads), for the step in two forms:
"graph" (one captured CUDA graph, ``models/step_graph.py``, as the bench
runs it) and "eager" (the same step launched op by op, ``StepGraphs(...,
eager=True)``):

  syncs      the synchronising operations torch reports in a 2-batch
             sweep and its one fetch (``set_sync_debug_mode("warn")``);
  marginal   ms a batch from the bench's fit over 12 and 36 batches, the
             two forms in turns for --rounds rounds;
  profile    6 batches under torch.profiler, after one window that pays
             the profiler's start-up: kernel time and kernel launches a
             batch, graph replays a batch, the host time a batch of
             ``cudaLaunchKernel`` and ``cudaGraphLaunch``, the device's
             busy share (kernel time over the window's wall time), and the
             largest kernels by device time; for the graph, a bare replay
             of it (its device nodes, the kernels among them, and the
             device's busy share of that replay);
  clone      the graph's output copy a call makes: host ms and wall ms
             (synchronised at the end) a call of its one clone of the
             packed output buffer, against a clone of each field apart
             (the same bytes, one copy a field), CLONES calls each.

Prints the card's name and power limit, a line per form, and one JSON
object as the last line.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from nextgenmap_tpu_torch import bench
from nextgenmap_tpu_torch.models.step_graph import StepGraphs, leaves
from nextgenmap_tpu_torch.tools.timing import device_profile

PROFILED = 6
CLONES = 200
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaGraphLaunch")


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
    """Kernel time, kernel launches, graph replays and the launch calls'
    host time a batch over PROFILED batches, the device's busy share, and
    the five largest kernels."""
    for n in (2, PROFILED):     # the first window pays CUPTI's start-up
        replays = w.graphs.replays
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bench.sweep(w, *staged, n).cpu()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        replays = w.graphs.replays - replays
    ka = prof.key_averages()
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    kernel_us = sum(e.self_device_time_total for e in kernels)
    nodes = {}
    if not w.graphs.eager:      # the graph's own nodes: a bare replay
        (entry,) = w.graphs._entries.values()
        bare = device_profile(entry.graph.replay)
        nodes = {"graph_nodes": bare["records"],
                 "graph_kernels": bare["kernels"],
                 "bare_replay_busy": bare["busy"]}
    return {**nodes,
        "kernel_ms": kernel_us / 1e3 / PROFILED,
        "kernels": sum(e.count for e in kernels) / PROFILED,
        "graph_replays": replays / PROFILED,
        "launch_host_ms": {
            call: sum(e.self_cpu_time_total for e in ka if e.key == call)
            / 1e3 / PROFILED for call in LAUNCH_CALLS},
        "wall_ms": 1e3 * wall / PROFILED,
        # None where the profiler recorded no kernel (not measured)
        "device_busy": kernel_us / 1e6 / wall if kernel_us else None,
        "top_us": {e.key[:60]: e.self_device_time_total / PROFILED
                   for e in top},
    }


def clone_ms(graphs: StepGraphs) -> dict:
    """Host ms and wall ms a call of the packed clone and of the per-field
    clones of the bench graph's outputs."""
    (entry,) = graphs._entries.values()
    fields = leaves(entry.layout.unpack(entry.out))
    forms = {"packed": lambda: entry.out.clone(),
             "per_field": lambda: [t.clone() for t in fields]}
    out = {"fields": len(fields), "bytes": entry.layout.nbytes}
    for name, fn in forms.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CLONES):
            fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[name] = {"host_ms": 1e3 * host / CLONES,
                     "wall_ms": 1e3 * wall / CLONES}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=3)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_breakdown: no CUDA card", file=sys.stderr)
        return 2
    card = bench.card_line()
    print(card)
    w = bench.workload(bench.GENOME_SIZE, bench.BATCH, "cuda")
    dev = w.lens.device
    forms = {"graph": w, "eager": w._replace(graphs=StepGraphs(dev,
                                                              eager=True))}
    staged = bench.stage_reads(w, bench.N_BATCHES, bench.READS_SEED)
    n1 = bench.N_BATCHES // 3
    capture_s = {}
    for name, f in forms.items():   # the capture, K4's plan, the allocator
        t0 = time.perf_counter()
        bench.sweep(f, *staged, 4).cpu()
        capture_s[name] = time.perf_counter() - t0
    out = {name: {"syncs": sync_count(f, staged), "marginal_ms": [],
                  "first_sweep_s": capture_s[name]}
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
        busy = ("not measured" if r["device_busy"] is None
                else f"{100 * r['device_busy']:.1f}%")
        print(f"[{name}] {r['syncs']} syncs in a 2-batch sweep and its "
              f"fetch; marginal ms a batch in turns {r['marginal_ms']}; "
              f"{r['kernel_ms']:.3f} ms of kernels in {r['kernels']:.0f} "
              f"launches and {r['graph_replays']:.0f} graph replays a batch, "
              f"device busy {busy} of {r['wall_ms']:.3f} ms a batch; host "
              f"ms a batch {r['launch_host_ms']}; largest kernels (us a "
              f"batch) {r['top_us']}"
              + (f"; a bare replay {r['graph_nodes']} device nodes "
                 f"({r['graph_kernels']} kernels), busy "
                 f"{100 * r['bare_replay_busy']:.1f}%"
                 if "graph_nodes" in r else ""), flush=True)
    clone = clone_ms(w.graphs)
    print(f"[clone] the packed buffer ({clone['bytes']} bytes) against its "
          f"{clone['fields']} fields apart, ms a call: {clone['packed']} / "
          f"{clone['per_field']}", flush=True)
    print(json.dumps({"card": card, "captures": w.graphs.captures,
                      "forms": out, "clone": clone}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
