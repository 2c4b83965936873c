"""Side-by-side device times of K1 (SW score) and K2 (window gather) built
from several source trees, in one process on one CUDA card.

    python -m nextgenmap_tpu_torch.tools.kernel_ab [NAME=CSRC_DIR ...] [--rounds 2]

Each CSRC_DIR is a copy of the port's ``csrc/`` (another commit's, or a
variant of one); ``repo`` (the port's own ``csrc/``) is always included.
Each tree is built by nvcc into its own library, and its kernels' outputs
are checked equal to the plain PyTorch versions at every shape.  Then each
kernel is timed by ``tools/timing.py::device_ms`` (torch.profiler device
time per launch) at the chip smoke's main shapes: K1 local [2048,100]xW48
with all slots real and with 650 real (the rest at length 0, as the mapper
passes them), [2048,150]xW56, [512,1000]xW184 and glocal [2048,100]xW48; K2
at 2048x148, 4096x148, 4096x206 and 614x1184, beside ``unfold`` +
``index_select``.  Rounds alternate the trees' order (A B ..., then ... B A)
so that a drift of the card's clock favours none.

Prints the card's name and power limit, one line per kernel and shape, and
one JSON object as the last line: {"card": ..., "k1": {shape: {tree: [ms per
round]}}, "k2": {...}}.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.models.mapper import score_matrices
from nextgenmap_tpu_torch.native import build
from nextgenmap_tpu_torch.ops.gather import gather_windows, pad_table
from nextgenmap_tpu_torch.ops.sw_ref import banded_sw_score
from nextgenmap_tpu_torch.tools.timing import device_ms

GENOME = 4_600_000
# (label, S, L, W, real slots, local)
K1_SHAPES = [
    ("local [2048,100]xW48", 2048, 100, 48, 2048, True),
    ("local [2048,100]xW48, 650 real", 2048, 100, 48, 650, True),
    ("local [2048,150]xW56", 2048, 150, 56, 2048, True),
    ("local [512,1000]xW184", 512, 1000, 184, 512, True),
    ("glocal [2048,100]xW48", 2048, 100, 48, 2048, False),
]
K2_SHAPES = [(2048, 148), (4096, 148), (4096, 206), (614, 1184)]


def sw_inputs(rng: np.random.Generator, S: int, L: int, W: int, real: int):
    """Queries at full length, each planted at a random offset of its
    corridor with 2% SNPs; slots past `real` have length 0 and an all-4
    corridor."""
    q = rng.integers(0, 4, (S, L), dtype=np.uint8)
    r = rng.integers(0, 4, (S, L + W), dtype=np.uint8)
    seg = np.where(rng.random((S, L)) < 0.02, (q + 1) % 4, q).astype(np.uint8)
    off = rng.integers(0, W // 2 + 1, S)
    r[np.arange(S)[:, None], off[:, None] + np.arange(L)] = seg
    lens = np.full(S, L, np.int32)
    lens[real:] = 0
    r[real:] = 4
    return q, lens, r


def sw_launcher(lib, args, gaps, msel, W: int, local: bool):
    q, lens, r, mats = args
    S, L = q.shape
    out = [torch.empty(S, dtype=torch.int32, device=q.device)
           for _ in range(3)]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        code = lib.ngm_sw_score(
            q.data_ptr(), lens.data_ptr(), r.data_ptr(), mats.data_ptr(),
            msel.data_ptr(), S, L, W, mats.shape[0], *gaps, int(local),
            *(o.data_ptr() for o in out), stream)
        build.check(code, "sw_score")
        return out
    return launch


def gather_launcher(lib, genome, starts, T: int):
    out = torch.empty((starts.shape[0], T), dtype=torch.uint8,
                      device=genome.device)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        code = lib.ngm_gather_windows(genome.data_ptr(), genome.shape[0],
                                      starts.data_ptr(), starts.shape[0], T,
                                      out.data_ptr(), stream)
        build.check(code, "gather_windows")
        return out
    return launch


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=CSRC_DIR")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    trees = {"repo": build.CSRC_DIR}
    for spec in args.trees:
        name, _, path = spec.partition("=")
        if not path or not os.path.isdir(path):
            ap.error(f"{spec}: expected NAME=CSRC_DIR")
        trees[name] = os.path.abspath(path)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    libs = {name: build.bind(build.build(path)) for name, path in trees.items()}

    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    cfg = NgmConfig()
    gaps = (cfg.gap_read_penalty, cfg.gap_ref_penalty, cfg.gap_extend_penalty)
    mats = torch.from_numpy(score_matrices(cfg)).to(dev)
    cases = {}   # (kernel, label) -> {tree: launch}
    for label, S, L, W, real, local in K1_SHAPES:
        q, lens, r = (torch.from_numpy(a).to(dev)
                      for a in sw_inputs(rng, S, L, W, real))
        msel = torch.from_numpy(rng.integers(0, 2, S, dtype=np.int32)).to(dev)
        ref = banded_sw_score(q, lens, r, mats, *gaps, msel, band=W,
                              mode="local" if local else "glocal")
        cases["k1", label] = {}
        for name, lib in libs.items():
            fn = sw_launcher(lib, (q, lens, r, mats), gaps, msel, W, local)
            got = fn()
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise RuntimeError(f"K1 of {name} differs from plain at {label}")
            cases["k1", label][name] = fn
    genome = torch.from_numpy(rng.integers(0, 4, GENOME, dtype=np.uint8)).to(dev)
    for n, T in K2_SHAPES:
        starts = torch.from_numpy(
            rng.integers(0, GENOME + 1, n).astype(np.int32)).to(dev)
        padded = pad_table(genome, T, 4)
        ref = gather_windows(padded, starts, T)
        label = f"{n}x{T}"
        cases["k2", label] = {
            "unfold+index_select":
                lambda p=padded, s=starts, T=T: p.unfold(0, T, 1).index_select(0, s)}
        for name, lib in libs.items():
            fn = gather_launcher(lib, genome, starts, T)
            if not torch.equal(fn(), ref):
                raise RuntimeError(f"K2 of {name} differs from plain at {label}")
            cases["k2", label][name] = fn
    torch.cuda.synchronize()

    result = {"card": card, "k1": {}, "k2": {}}
    for rnd in range(args.rounds):
        for (kernel, label), fns in cases.items():
            order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for name in order:
                result[kernel].setdefault(label, {}).setdefault(
                    name, []).append(device_ms(fns[name]))
    for kernel in ("k1", "k2"):
        for label, by_tree in result[kernel].items():
            print(f"{kernel} {label}: " + "; ".join(
                f"{name} {statistics.median(ms) * 1e3:.2f} us ("
                + ", ".join(f"{m * 1e3:.2f}" for m in ms) + ")"
                for name, ms in by_tree.items()))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
