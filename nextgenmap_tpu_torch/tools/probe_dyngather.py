"""Dynamic-gather probe on a CUDA card: kernel K3 (``csrc/row_gather.cu``).

Port of ``tools/probe_dyngather.py``, which probed Mosaic's
tpu.dynamic_gather on the TPU.  On int32 [R, W] arrays,
out[r, j] = sum over i < REP of x gathered along DIM at (idx + 7 i) mod
extent; the result is checked against the probe's own numpy expectation,
then 16 launches on fresh indices are timed with CUDA events.

    python -m nextgenmap_tpu_torch.tools.probe_dyngather --dim 1 --w 1024 --r 256 --rep 32

Prints one JSON line with the reference probe's fields: dim, w, r, ok,
correct, compile_s (the nvcc build, 0 when cached), ns_per_elem and
gelem_per_s (gathered elements: 16 x REP x R x W over the timed launches),
plus the card's name.  Needs a CUDA card: without one it prints ok false
and exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from nextgenmap_tpu_torch.native import build
from nextgenmap_tpu_torch.ops.row_gather import row_gather

K = 16   # timed launches, each on its own index array


def expected(x: np.ndarray, idx: np.ndarray, rep: int, dim: int) -> np.ndarray:
    """The reference probe's numpy expectation (int64 sum)."""
    extent = x.shape[dim]
    exp = np.zeros(x.shape, np.int64)
    for i in range(rep):
        ix = (idx.astype(np.int64) + i * 7) % extent if i else idx
        exp += np.take_along_axis(x, ix, axis=dim)
    return exp


def probe(dim: int, w: int, r: int, rep: int) -> dict:
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 20, size=(r, w), dtype=np.int32)
    extent = r if dim == 0 else w
    idx = rng.integers(0, extent, size=(r, w), dtype=np.int32)
    head = {"dim": dim, "w": w, "r": r}
    if not torch.cuda.is_available():
        return dict(head, ok=False, err="no CUDA card: K3 runs only there")
    t0 = time.perf_counter()
    cached = os.path.exists(build.library_path())
    try:
        build.load()
        compile_s = 0.0 if cached else time.perf_counter() - t0
        x_d = torch.from_numpy(x).cuda()
        out = row_gather(x_d, torch.from_numpy(idx).cuda(), rep, dim)
        torch.cuda.synchronize()
    except (RuntimeError, ValueError) as e:
        return dict(head, ok=False, err=str(e).splitlines()[0][:300])
    correct = bool(np.array_equal(out.cpu().numpy().astype(np.int64),
                                  expected(x, idx, rep, dim)))

    idxs = torch.from_numpy(
        rng.integers(0, extent, size=(2 * K, r, w), dtype=np.int32)).cuda()
    for k in range(K):                        # warm-up on the first K
        row_gather(x_d, idxs[k], rep, dim)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for k in range(K, 2 * K):
        row_gather(x_d, idxs[k], rep, dim)
    b.record()
    b.synchronize()
    dt = a.elapsed_time(b) / 1e3
    n = K * rep * r * w
    return dict(head, ok=True, correct=correct, compile_s=round(compile_s, 1),
                ns_per_elem=dt / n * 1e9, gelem_per_s=n / dt / 1e9,
                device=torch.cuda.get_device_name(0))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m nextgenmap_tpu_torch.tools.probe_dyngather",
        description="time K3, the same-shape gather-accumulate, on the card")
    p.add_argument("--dim", type=int, choices=(0, 1), default=1,
                   help="gather along rows (0) or within a row (1)")
    p.add_argument("--w", type=int, default=1024, help="minor extent W")
    p.add_argument("--r", type=int, default=256, help="rows R")
    p.add_argument("--rep", type=int, default=32,
                   help="gathers summed per output element")
    a = p.parse_args(argv)
    res = probe(a.dim, a.w, a.r, a.rep)
    print(json.dumps(res))
    if not res["ok"]:
        return 2
    return 0 if res["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
