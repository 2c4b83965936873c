"""Host-inclusive reads/s of the port's CLI for several -t values and
--megabatch 4 at -t 1, and optionally of another checkout's CLI, in
alternating rounds on one card.

    python -m nextgenmap_tpu_torch.tools.runtime_sweep [--threads 1 2 4]
        [--rounds 3] [--batches 4] [--other NAME=DIR ...]

The input is chip_smoke.py's phase 6: the 4.6 Mbp genome with 120 planted
repeats and 100 bp reads at 2% SNPs, seeded the same way, here `--batches`
batches of 4096.  Each variant is one `map` run of the CLI in a fresh
process (`python -m nextgenmap_tpu_torch.cli`, from this checkout or from
DIR), after one warm-up run that memoizes the genome and index files; the
order of the variants turns around every round.  Reads/s is the CLI's own
figure (after the index build, to the last record written), read from its
log, beside the seconds its step graphs took to capture (their eager
warm-up steps included; 0 for a checkout without them), also from the
log.  Prints the card's name and power limit, one line per run, and one JSON
object as the last line: the median, min and max reads/s of each variant.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

from nextgenmap_tpu_torch import synthetic

SEED = 2026                 # chip_smoke.py's
GENOME_SIZE = 4_600_000
BATCH = 4096
MEGABATCH = 4               # the --megabatch variant's K, at -t 1
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_cli(checkout: str, workdir: str, threads: int,
            flags: tuple = ()) -> tuple[float, float, float]:
    """(reads/s the CLI reports, wall seconds, graph capture seconds) of
    one map run."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "nextgenmap_tpu_torch.cli", "map", "-r",
         os.path.join(workdir, "ref.fa"), "-q",
         os.path.join(workdir, "reads.fq"), "-o",
         os.path.join(workdir, "out.sam"), "-t", str(threads),
         "--device", "cuda", "--no-progress", *flags],
        env=dict(os.environ, PYTHONPATH=checkout), cwd=checkout,
        capture_output=True, text=True, timeout=900,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout} -t {threads}: {proc.stderr[-2000:]}")
    m = re.search(r"R/S: (\d+)", proc.stderr)
    if m is None:
        raise RuntimeError(f"no R/S in the log of {checkout}")
    capture = sum(map(float, re.findall(r"warm-up and capture ([\d.]+) s",
                                        proc.stderr)))
    return float(m.group(1)), wall, capture


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--other", nargs="*", default=[], metavar="NAME=DIR",
                    help="another checkout, run at -t 1 (its own default)")
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("runtime_sweep needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    variants = [(f"-t {t}", REPO, t, ()) for t in a.threads]
    variants.append((f"-t 1 --megabatch {MEGABATCH}", REPO, 1,
                     ("--megabatch", str(MEGABATCH))))
    variants += [(name, os.path.abspath(d), 1, ()) for name, d in
                 (o.split("=", 1) for o in a.other)]
    runs: dict[str, list[float]] = {name: [] for name, *_ in variants}
    with tempfile.TemporaryDirectory() as wd:
        genome = synthetic.repeat_genome(GENOME_SIZE, n_repeats=120,
                                         min_len=1000, max_len=2000, seed=SEED)
        synthetic.write_fasta(os.path.join(wd, "ref.fa"), "chr", genome)
        codes, pos, strand = synthetic.simulate_reads(
            genome, a.batches * BATCH, 100, 0.02, seed=SEED + 1)
        synthetic.write_fastq(os.path.join(wd, "reads.fq"), codes, pos,
                              strand)
        for _, checkout, t, flags in variants:   # builds and memoizes
            run_cli(checkout, wd, t, flags)
        for r in range(a.rounds):
            for name, checkout, t, flags in (variants if r % 2 == 0
                                             else variants[::-1]):
                rps, wall, capture = run_cli(checkout, wd, t, flags)
                runs[name].append(rps)
                print(f"round {r + 1} {name}: {rps:.0f} reads/s, wall "
                      f"{wall:.2f} s, graph capture {capture:.3f} s",
                      flush=True)
    print(json.dumps({name: {"median": statistics.median(v), "min": min(v),
                             "max": max(v), "runs": v}
                      for name, v in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
