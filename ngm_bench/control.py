#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from.

    python3 ngm_bench/control.py --workload <cell> --seeds <n> [<n> ...]
                                 [--seconds 1]

For each seed, in one process: the cell's set-up and a short window at
the cell's own load (``--seconds``), the same sample of the window's
batches as a run draws, and then, with the program freed, the reference
and the controls on that sample.  One JSON line a seed on standard output:

  program   what a run compares: the reads (and batch counters) in which
            the program differs from the reference (the lower reading);
  bf16      the control of the configuration's stated precision: the
            reference with its float32 steps (the sensitivity threshold,
            the identity and residue filters, MAPQ, the pair cutoff) in
            bfloat16, against the reference;
  skip2     the control of a stated guarantee (every locus indexed): the
            reference over an index of every second genome window
            (NextGenMap's own --kmer-skip 2 default, which halves the
            index) while reads keep their k-mer stride 2, against the
            reference.

A control's reading is the upper one where it is three times the lower
or more.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ngmb import harness, manifest  # noqa: E402
from ngmb.reference import Reference  # noqa: E402


# the controls: the reference's knobs each one turns
CONTROLS = {"bf16": {"gate_dtype": torch.bfloat16}, "skip2": {"index_skip": 2}}


def against(st, sample, ref: Reference, other: Reference) -> dict:
    """The comparison a run makes, with `other`'s outputs in the program's
    place."""
    got = {(g, k): other.map(st.pool.reads[g * st.K + k],
                             st.pool.lengths[g * st.K + k], st.paired)
           for g, k in sample.picks}
    return harness.compare(st, got, ref)


def reading(cmp: dict) -> dict:
    return {k: cmp[k] for k in ("reads_differing", "counters_differing",
                                "sampled_reads", "per_field")}


def run_control(cell: manifest.Cell, seed: int, seconds: float, dev,
                program) -> dict:
    st = harness.set_up(cell, seed, dev, program)
    sample = harness.warm_up(st, seed)
    harness.timed_window(st, seconds, sample)
    st = harness.free_program(st)
    ref = Reference(st.genome, st.settings, st.L)
    out = {"cell": cell.name, "seed": seed,
           "program": reading(harness.compare(st, sample.outputs(), ref))}
    for name, knobs in CONTROLS.items():
        other = Reference(st.genome, st.settings, st.L, **knobs)
        out[name] = reading(against(st, sample, ref, other))
        del other
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ngm_bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    cell = manifest.find_cell(manifest.load_manifest(), args.workload)
    program = harness.import_program()
    program[3].load()
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = run_control(cell, seed, args.seconds, dev, program)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
