"""Side-by-side device times of K1 (SW score), K2 (window gather), K3
(the dynamic-gather probe's kernel), K4 (SW with traceback), K5 (the read
front end), K6 (candidate search) and the pair select built from several
source trees, in one process on one CUDA card.

    python -m nextgenmap_tpu_torch.tools.kernel_ab [NAME=CSRC_DIR ...] [--rounds 2] [--only k4] [--only k5 --only k6] [--only pair_select]

Each CSRC_DIR is a copy of the port's ``csrc/`` (another commit's, or a
variant of one); ``repo`` (the port's own ``csrc/``) is always included.
Each tree is built by nvcc into its own library, and its kernels' outputs
are checked equal to the plain PyTorch versions at every shape.  Then each
kernel is timed by ``tools/timing.py::device_ms`` (torch.profiler device
time per launch) at the card tests' main shapes: K1 local [2048,100]xW48
with all slots real and with 650 real (the rest at length 0, as the mapper
passes them), [2048,150]xW56, [512,1000]xW184 and glocal [2048,100]xW48; K2
at 2048x148, 4096x148, 4096x206 and 614x1184, beside ``unfold`` +
``index_select``; K3 along dim 0 and dim 1 at the probe's default 256x1024
and at 4096x2048 (the probe's use case at the mapper's batch), REP 32,
beside ``torch.gather`` at REP 1 and an empty kernel (``torch.cuda._sleep(0)``:
one thread, no work), the floor of any launch; K4 at K4_SHAPES
([4096,100]xW48, [2048,150]xW56, [614,1000]xW184, [2048,100]xW264), local
and glocal, through each tree's own
``ngm_sw_align``: a tree with routes (``ngm_sw_align_plan``) on each route
that takes the shape ("NAME smem", "NAME global"), without the direction
bytes, as its mapping path calls it; an older tree without them with the
[L, S, W] direction bytes its mapping path wrote.  Every K4 result is held
equal to the plain ``banded_sw_align`` in all 11 fields first.  K5 at
K5_SHAPES and K6 at K6_SHAPES (on the bench's 4.6 Mbp random genome and
its packed tables, K6 on each route that takes the shape: "NAME smem",
"NAME global"), each held equal to its plain version in every output; a
tree without them (older than K5 and K6) is left out of their rows.  The
pair select at PAIR_SHAPES (2048 pairs, C 32: every pair gridded, every
candidate valid; a third of the pairs gridded) beside its plain version's
torch ops on the card ("torch (plain)", the paired tail before the
kernel), each tree's held equal to it; a tree without it is left out.  Rounds
alternate the trees' order (A B ..., then ... B A) so that a drift of the
card's clock favours none.

Prints the card's name and power limit, one line per kernel and shape, and
one JSON object as the last line: {"card": ..., "k1": {shape: {tree: [ms per
round]}}, "k2": {...}, "k3": {...}, "k4": {...}, "k5": {...}, "k6": {...},
"k3_floors": {shape:
{"bytes_ms": ..., "gather_ms": ...}}, "k4_bounds": {shape: ms},
"k4_plans": {shape: {tree route: plan}}, "k6_plans": {...},
"pair_select": {...}, "pair_bounds": {shape: ms}}.  K3's
floors are its bytes (12 R
W over 3.35 TB/s) and its gathers from shared memory without bank conflicts
(REP R W loads, a warp of 32 a clock on each of 132 SMs at the card's
maximum SM clock).  K4's bound: 20 (local) or 18 (glocal) int ops per
cell of each real slot's qlen x W over 132 SMs x 64 INT32 lanes at that
clock.  A K4 plan is ``ngm_sw_align_plan``'s (route,
lanes, cells per lane, packed row bytes, threads a block and its shared
memory bytes as launched, blocks of that size an SM holds, the route's
capacity in warps an SM); a K6 plan ``ngm_cand_search_plan``'s (route,
threads a read, reads a block, shared memory a block, blocks, the padded
vote array, the global route's scratch, the card's shared memory a
block).  The pair select's bound: the larger of its bytes (13 a
candidate and 4 a read in, 9 a read out) over 3.35 TB/s and
PAIR_OPS_PER_TEST int ops for each combination of a gridded pair's C x C
over 132 SMs x 64 INT32 lanes at the card's maximum SM clock.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
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
from nextgenmap_tpu_torch.index.device_build import (
    build_index_device, concat_tables,
)
from nextgenmap_tpu_torch.io.simulate import random_genome
from nextgenmap_tpu_torch.ops.candidate import (
    candidate_search_canonical, candidate_search_dual, pack_offsets,
)
from nextgenmap_tpu_torch.ops.candidate_kernel import ROUTES as CS_ROUTES
from nextgenmap_tpu_torch.ops.gather import gather_windows, pad_table
from nextgenmap_tpu_torch.ops.kmer_kernel import (
    FORM_BISULFITE, FORM_CANONICAL, n_windows, read_kmers_plain,
)
from nextgenmap_tpu_torch.ops.pair_kernel import pair_select_plain
from nextgenmap_tpu_torch.ops.row_gather import row_gather_plain
from nextgenmap_tpu_torch.ops.sw_align_kernel import N_FIELDS, ROUTES
from nextgenmap_tpu_torch.ops.sw_ref import banded_sw_align, banded_sw_score
from nextgenmap_tpu_torch.tools.timing import device_ms, launches_per_call

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
K3_SHAPES = [(256, 1024), (4096, 2048)]
K3_REP = 32
# K4: the card tests' main shapes; its integer instructions per DP cell,
# by mode (csrc/sw_align.cu's note counts them)
K4_SHAPES = [(4096, 100, 48), (2048, 150, 56), (614, 1000, 184),
             (2048, 100, 264)]
K4_OPS_PER_CELL = {"local": 20, "glocal": 18}
# K5: (label, B, L, form, --bs-cutoff); K6: (label, B, L, bisulfite, H)
# on the bench's 4.6 Mbp random genome, packed tables
K5_SHAPES = [("canonical [4096,100]", 4096, 100, FORM_CANONICAL, 0),
             ("canonical [4096,150]", 4096, 150, FORM_CANONICAL, 0),
             ("canonical [614,1000]", 614, 1000, FORM_CANONICAL, 0),
             ("bisulfite [4096,100] cutoff 3", 4096, 100, FORM_BISULFITE,
              3)]
K6_SHAPES = [("canonical [4096,100] H128", 4096, 100, False, 128),
             ("canonical [614,1000] H1280", 614, 1000, False, 1280),
             ("bisulfite [4096,100] H320", 4096, 100, True, 320)]
# the pair select: (label, pairs, C, share of the pairs gridded) at the
# paired cell's read length, band 56 and bins of 16; its int ops a
# combination of the grid (csrc/pair_select.cu's note)
PAIR_SHAPES = [("2048 pairs C32, all gridded", 2048, 32, 1.0),
               ("2048 pairs C32, a third gridded", 2048, 32, 1 / 3)]
PAIR_OPS_PER_TEST = 15
PAIR_L, PAIR_SLACK, PAIR_MARGIN = 150, 12, 32
KERNELS = ("k1", "k2", "k3", "k4", "k5", "k6", "pair_select")
# the H100's published peaks: device memory bytes a second, and SMs x
# INT32 lanes an SM a clock (sm_90)
HBM_BYTES_PER_S = 3.35e12
INT32_LANES = 132 * 64
P, I32 = build.P, build.I32
# ngm_sw_align of an older tree without routes: the [L, S, W] direction
# bytes where the routed one takes (route, scratch, dirs)
SW_ALIGN_DIRS_ONLY = (P, P, P, P, P, I32, I32, I32, I32, I32, I32, I32, I32,
                      I32, P, P, P, P, P)


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


def row_gather_launcher(lib, x, idx, rep: int, dim: int):
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    R, W = x.shape

    def launch():
        code = lib.ngm_row_gather(x.data_ptr(), idx.data_ptr(), R, W, rep,
                                  dim, out.data_ptr(), stream)
        build.check(code, "row_gather")
        return out
    return launch


def align_inputs(rng: np.random.Generator, S: int, L: int, W: int):
    """sw_inputs's queries, each with a 1-3 base insertion at a random cut
    before it is planted, and one in ten shorter than L."""
    q, lens, r = sw_inputs(rng, S, L, W, S)
    for i in range(S):
        cut = int(rng.integers(L // 4, 3 * L // 4))
        ins = rng.integers(0, 4, int(rng.integers(1, 4)), dtype=np.uint8)
        off = int(rng.integers(0, W // 2 + 1))
        seg = np.concatenate([q[i, :cut], ins, q[i, cut:]])[:L + W - off]
        r[i, off:off + seg.shape[0]] = seg
    short = rng.random(S) < 0.1
    lens[short] = rng.integers(1, L, int(short.sum()))
    return q, lens, r


def align_launcher(lib, args, gaps, msel, W: int, local: bool,
                   route: str | None):
    """(launch, plan) of `lib`'s K4 on `route` (None: a tree without routes,
    with its direction bytes); launch() returns (out, ops, trunc).  (None,
    None) where the route cannot take the shape."""
    q, lens, r, mats = args
    S, L = q.shape
    dev = q.device
    mo = L + W
    out = torch.empty((N_FIELDS, S), dtype=torch.int32, device=dev)
    ops = torch.empty((S, mo), dtype=torch.uint8, device=dev)
    trunc = torch.empty(S, dtype=torch.bool, device=dev)
    plan = None
    if route is None:
        dirs = torch.empty((L, S, W), dtype=torch.uint8, device=dev)

        def middle():
            return (dirs.data_ptr(),)
    else:
        plan = (ctypes.c_int * 8)()
        build.check(lib.ngm_sw_align_plan(S, L, W, int(local),
                                          ROUTES.index(route), plan),
                    "sw_align plan")
        if plan[6] == 0 or ROUTES[plan[0]] != route:
            return None, None
        scratch = (torch.empty(max(S * L * plan[3], 16), dtype=torch.uint8,
                               device=dev)
                   if route == "global" else None)

        def middle():
            return (ROUTES.index(route), plan[4],
                    None if scratch is None else scratch.data_ptr(), None)

    def launch():
        build.check(lib.ngm_sw_align(
            q.data_ptr(), lens.data_ptr(), r.data_ptr(), mats.data_ptr(),
            msel.data_ptr(), S, L, W, mats.shape[0], *gaps, int(local), mo,
            *middle(), out.data_ptr(), ops.data_ptr(), trunc.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "sw_align")
        return out, ops, trunc
    return launch, (None if plan is None else list(plan))


def front_launcher(lib, reads, lens, form: int, cut: int):
    """`lib`'s K5 on reads [B, L] at k 13, stride 2, in `form`
    (ops/kmer_kernel.py's FORM_*); launch() returns its outputs."""
    B, L = reads.shape
    Q = n_windows(L, 13, 2)
    dev = reads.device
    rc = torch.empty((B, L), dtype=torch.uint8, device=dev)
    kms = [torch.empty((B, Q), dtype=d, device=dev)
           for d in (torch.int32, torch.int32, torch.bool, torch.int32,
                     torch.bool)]
    if form == FORM_CANONICAL:
        outs = [kms[0], kms[1], kms[2], None, None]
    else:
        outs = [kms[0], None, kms[2], kms[3], kms[4]]

    def launch():
        build.check(lib.ngm_read_kmers(
            reads.data_ptr(), lens.data_ptr(), B, L, Q, 13, 2, form, cut,
            rc.data_ptr(), *(None if t is None else t.data_ptr()
                             for t in outs),
            torch.cuda.current_stream().cuda_stream), "read_kmers")
        return [rc, *(t for t in outs if t is not None)]
    return launch


def cand_launcher(lib, kms, lens, off, pos, sens, H: int, route: str,
                  packed: bool, split: bool):
    """(launch, plan) of `lib`'s K6 on `route` with the bench's statics (k
    13, stride 2, K 32, C 32, bins of 16); launch() returns (bucket, score,
    strand, best, extra, counters).  (None, None) where the route cannot
    take the shape."""
    dual = len(kms) == 4
    B, Q = kms[0].shape
    dev = kms[0].device
    plan = (ctypes.c_longlong * 8)()
    if lib.ngm_cand_search_plan(B, Q, int(dual), H, CS_ROUTES.index(route),
                                plan) != 0:
        return None, None
    scratch = (torch.empty(max(plan[6], 1), dtype=torch.int32, device=dev)
               if route == "global" else None)
    Cw = min(32, 2 * H)
    out = torch.empty((3, B, Cw), dtype=torch.int32, device=dev)
    per = torch.empty((2, B), dtype=torch.int32, device=dev)
    cnt = torch.empty(3, dtype=torch.int32, device=dev)
    km0, km1 = (kms[0], kms[2]) if dual else (kms[0], kms[1])
    ok0, ok1 = (kms[1], kms[3]) if dual else (kms[2], None)

    def launch():
        build.check(lib.ngm_cand_search(
            km0.data_ptr(), km1.data_ptr(), ok0.data_ptr(),
            None if ok1 is None else ok1.data_ptr(), lens.data_ptr(),
            off.data_ptr(), off.numel(), pos.data_ptr(), pos.numel(),
            sens.data_ptr(), B, Q, int(dual), 13, 2, 32, H, 32, 4, 1000,
            int(packed), int(split), CS_ROUTES.index(route), plan[1],
            None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.numel(), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), per[0].data_ptr(),
            per[1].data_ptr(), cnt.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "cand_search")
        return out[0], out[1], out[2], per[0], per[1], cnt
    return launch, list(plan)


def pair_inputs(rng: np.random.Generator, P: int, C: int, gridded: float,
                dev) -> tuple:
    """(pair_select's inputs, the gridded pairs) of P FR pairs with C
    candidates a mate: in a gridded pair every candidate valid and scored
    20-150, mate 2's within 600 of mate 1's on both strands; in the others
    one candidate a mate, unscored."""
    B = 2 * P
    multi = rng.random(P) < gridded
    n = np.where(multi, C, 1).repeat(2).astype(np.int32)
    valid = np.arange(C)[None] < n[:, None]
    sw = np.where(valid & multi.repeat(2)[:, None],
                  rng.integers(20, 150, (B, C)), 0).astype(np.int32)
    corr = (rng.integers(0, 60_000_000, P).repeat(2)[:, None]
            + rng.integers(0, 600, (B, C))).astype(np.int32)
    strand = rng.integers(0, 2, (B, C)).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    scal = (torch.tensor(200, dtype=torch.int32, device=dev),
            torch.tensor(500, dtype=torch.int32, device=dev),
            torch.tensor(0.9, dtype=torch.float32, device=dev))
    return ((t(sw), t(corr), t(strand), t(valid), t(n), *scal),
            int(multi.sum()))


def pair_launcher(lib, args):
    """`lib`'s pair select on `args`; launch() returns (a1, proper)."""
    sw = args[0]
    B, C = sw.shape
    a1 = torch.empty(B, dtype=torch.int64, device=sw.device)
    proper = torch.empty(B, dtype=torch.bool, device=sw.device)

    def launch():
        build.check(lib.ngm_pair_select(
            *(x.data_ptr() for x in args), B // 2, C, PAIR_L, PAIR_SLACK,
            PAIR_MARGIN, None, a1.data_ptr(), proper.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "pair_select")
        return a1, proper
    return launch


def pair_cases(libs, only, dev, rng, cases, bounds, per_call) -> None:
    """The pair select of each tree that has it, held equal to the plain
    version, beside the plain version's torch ops, into `cases`; its
    bounds into `bounds`, the plain version's launches a call (of its most
    launched kernel) into `per_call`."""
    if "pair_select" not in only:
        return
    ops_per_s = INT32_LANES * sm_clock_hz()
    for label, P, C, share in PAIR_SHAPES:
        args, gridded = pair_inputs(rng, P, C, share, dev)

        def plain(args=args):
            return pair_select_plain(*args, read_len=PAIR_L,
                                     slack=PAIR_SLACK, margin=PAIR_MARGIN)
        want = plain()
        per_call[label] = launches_per_call(plain)
        cases["pair_select", label] = {"torch (plain)": plain}
        for name, lib in libs.items():
            if not hasattr(lib, "ngm_pair_select"):
                continue
            fn = pair_launcher(lib, args)
            if not all(torch.equal(a, b) for a, b in zip(fn(), want)):
                raise RuntimeError(f"the pair select of {name} differs from "
                                   f"plain at {label}")
            cases["pair_select", label][name] = fn
        B = 2 * P
        bytes_ = B * C * 13 + B * 4 + B * 9
        bounds[label] = 1e3 * max(
            bytes_ / HBM_BYTES_PER_S,
            PAIR_OPS_PER_TEST * gridded * C * C / ops_per_s)


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def front_cases(libs, only, dev, rng, cases, plans) -> None:
    """K5 and K6 of each tree that has them, held equal to the plain
    versions, into `cases` (and K6's plans into `plans`)."""
    if not only & {"k5", "k6"}:
        return
    g = random_genome(GENOME, seed=1)
    gd = torch.from_numpy(g).to(dev)
    for label, B, L, form, cut in K5_SHAPES if "k5" in only else ():
        codes = np.ascontiguousarray(g[rng.integers(0, GENOME - L, B)[:, None]
                                       + np.arange(L)])
        lens = np.full(B, L, np.int32)
        lens[::10] = rng.integers(0, L + 1, lens[::10].shape[0])
        codes[np.arange(L)[None, :] >= lens[:, None]] = 4
        r, n = torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev)
        rc, kms = read_kmers_plain(r, n, k=13, stride=2,
                                   bs=form == FORM_BISULFITE, bs_cutoff=cut,
                                   canonical=form == FORM_CANONICAL)
        want = [rc, *kms]
        cases["k5", label] = {}
        for name, lib in libs.items():
            if not hasattr(lib, "ngm_read_kmers"):
                continue
            fn = front_launcher(lib, r, n, form, cut)
            if not all(torch.equal(a, b) for a, b in zip(fn(), want)):
                raise RuntimeError(f"K5 of {name} differs from plain at "
                                   f"{label}")
            cases["k5", label][name] = fn
    tables = {}
    sens = torch.tensor(0.5, dtype=torch.float32, device=dev)
    for label, B, L, bs, H in K6_SHAPES if "k6" in only else ():
        if bs not in tables:
            off, pos = (concat_tables(
                *build_index_device(gd, k=13, skip=1, collapse="ct",
                                    canonical=False),
                *build_index_device(gd, k=13, skip=1, collapse="ga",
                                    canonical=False)) if bs
                else build_index_device(gd, k=13, skip=1))
            tables[bs] = (pack_offsets(off, 1000, 32), pos)
        off, pos = tables[bs]
        codes = np.ascontiguousarray(g[rng.integers(0, GENOME - L, B)[:, None]
                                       + np.arange(L)])
        r = torch.from_numpy(codes).to(dev)
        n = torch.full((B,), L, dtype=torch.int32, device=dev)
        _, kms = read_kmers_plain(r, n, k=13, stride=2, bs=bs,
                                  canonical=not bs)
        kw = dict(fanout_cap=32, hit_cap=H, max_cmrs=32, diag_bin_log2=4,
                  stride=2, packed_offsets=True)
        want = (candidate_search_dual(*kms, off, pos, sens, 1000,
                                      dual_tables=True, **kw) if bs
                else candidate_search_canonical(*kms, n, off, pos, sens,
                                                1000, k=13, **kw))
        want = [want.bucket, want.score, want.strand, want.best_score,
                want.extra_score, torch.stack([want.fanout_overflow,
                                               want.hit_overflow,
                                               want.cmr_overflow])]
        cases["k6", label], plans[label] = {}, {}
        for name, lib in libs.items():
            if not hasattr(lib, "ngm_cand_search"):
                continue
            for route in CS_ROUTES:
                fn, p = cand_launcher(lib, kms, n, off, pos, sens, H, route,
                                      True, bs)
                if fn is None:
                    continue
                tree = f"{name} {route}"
                if not all(torch.equal(a, b) for a, b in zip(fn(), want)):
                    raise RuntimeError(f"K6 of {tree} differs from plain at "
                                       f"{label}")
                cases["k6", label][tree] = fn
                plans[label][tree] = p


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="NAME=CSRC_DIR")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", choices=KERNELS, action="append",
                    help="time only these kernels (repeatable; default all)")
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
    for lib in libs.values():
        if not hasattr(lib, "ngm_sw_align_plan"):
            lib.ngm_sw_align.argtypes = list(SW_ALIGN_DIRS_ONLY)

    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    cfg = NgmConfig()
    gaps = (cfg.gap_read_penalty, cfg.gap_ref_penalty, cfg.gap_extend_penalty)
    mats = torch.from_numpy(score_matrices(cfg)).to(dev)
    only = set(args.only or KERNELS)
    cases = {}   # (kernel, label) -> {tree: launch}
    for label, S, L, W, real, local in K1_SHAPES if "k1" in only else ():
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
    for n, T in K2_SHAPES if "k2" in only else ():
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
    floors = {}
    gathers_per_s = 132 * 32 * sm_clock_hz()
    for R, W in K3_SHAPES if "k3" in only else ():
        x = torch.from_numpy(
            rng.integers(0, 1 << 20, (R, W), dtype=np.int32)).to(dev)
        for dim in (0, 1):
            idx = torch.from_numpy(rng.integers(0, (R, W)[dim], (R, W),
                                                dtype=np.int32)).to(dev)
            ref = row_gather_plain(x, idx, K3_REP, dim)
            label = f"{R}x{W} REP {K3_REP} dim {dim}"
            idx64 = idx.long()
            cases["k3", label] = {
                "torch.gather (REP 1)":
                    lambda x=x, i=idx64, d=dim: torch.gather(x, d, i),
                "empty kernel": lambda: torch.cuda._sleep(0)}
            for name, lib in libs.items():
                fn = row_gather_launcher(lib, x, idx, K3_REP, dim)
                if not torch.equal(fn(), ref):
                    raise RuntimeError(f"K3 of {name} differs from plain at "
                                       f"{label}")
                cases["k3", label][name] = fn
        floors[f"{R}x{W} REP {K3_REP}"] = {
            "bytes_ms": 1e3 * 12 * R * W / HBM_BYTES_PER_S,
            "gather_ms": 1e3 * K3_REP * R * W / gathers_per_s}
    bounds, plans = {}, {}
    ops_per_s = INT32_LANES * sm_clock_hz()
    for S, L, W in K4_SHAPES if "k4" in only else ():
        q, lens, r = (torch.from_numpy(a).to(dev)
                      for a in align_inputs(rng, S, L, W))
        msel = torch.from_numpy(rng.integers(0, 2, S, dtype=np.int32)).to(dev)
        for mode in ("local", "glocal"):
            label = f"{mode} [{S},{L}]xW{W}"
            want = banded_sw_align(q, lens, r, mats, *gaps, msel, band=W,
                                   mode=mode)
            cells = int(lens.clamp(0, L).sum()) * W
            bounds[label] = 1e3 * K4_OPS_PER_CELL[mode] * cells / ops_per_s
            cases["k4", label], plans[label] = {}, {}
            for name, lib in libs.items():
                routes = (ROUTES if hasattr(lib, "ngm_sw_align_plan")
                          else (None,))
                for route in routes:
                    fn, p = align_launcher(lib, (q, lens, r, mats), gaps,
                                           msel, W, mode == "local", route)
                    if fn is None:
                        continue
                    tree = name if route is None else f"{name} {route}"
                    out, ops, trunc = fn()
                    got = (*out, ops, trunc)
                    fields = ("score", "q_start", "q_end", "r_start", "r_end",
                              "n_ops", "matches", "mismatches", "indels",
                              "ops", "trunc")
                    for f, g in zip(fields, got):
                        if not torch.equal(g, getattr(want, f)):
                            raise RuntimeError(f"K4 of {tree} differs from "
                                               f"plain in {f} at {label}")
                    cases["k4", label][tree] = fn
                    plans[label][tree] = p
    k6_plans = {}
    front_cases(libs, only, dev, rng, cases, k6_plans)
    pair_bounds, per_call = {}, {}
    pair_cases(libs, only, dev, rng, cases, pair_bounds, per_call)
    torch.cuda.synchronize()

    result = {"card": card, "k1": {}, "k2": {}, "k3": {}, "k4": {},
              "k5": {}, "k6": {}, "pair_select": {}, "k3_floors": floors,
              "k4_bounds": bounds, "k4_plans": plans, "k6_plans": k6_plans,
              "pair_bounds": pair_bounds}
    for rnd in range(args.rounds):
        for (kernel, label), fns in cases.items():
            order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for name in order:
                n = per_call.get(label, 1) if name == "torch (plain)" else 1
                result[kernel].setdefault(label, {}).setdefault(
                    name, []).append(device_ms(fns[name], per_call=n))
    for kernel in KERNELS:
        for label, by_tree in result[kernel].items():
            print(f"{kernel} {label}: " + "; ".join(
                f"{name} {statistics.median(ms) * 1e3:.2f} us ("
                + ", ".join(f"{m * 1e3:.2f}" for m in ms) + ")"
                for name, ms in by_tree.items()))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
