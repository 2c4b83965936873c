"""K3's plain PyTorch version (the dynamic-gather probe's kernel) against
the probe's own numpy expectation (tools/probe_dyngather.py), for dim 0 and
1; the JAX package's Pallas kernel itself, run by that probe in interpret
mode on the CPU, against the same expectation on the same draws; the
wrapper's shape rule (ops/row_gather.plan) at each variant's boundaries,
and its refusals.  Tolerance: exact (integer sums).
The kernel itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nextgenmap_tpu_torch.ops.row_gather import (
    plan, row_gather, row_gather_plain,
)
from nextgenmap_tpu_torch.tools import probe_dyngather

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(dim, r, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 20, size=(r, w), dtype=np.int32)
    idx = rng.integers(0, r if dim == 0 else w, size=(r, w), dtype=np.int32)
    return x, idx


@pytest.mark.parametrize("dim,r,w,rep", [
    (1, 32, 256, 32), (0, 32, 256, 32), (1, 3, 5, 9), (0, 5, 3, 11),
    (1, 8, 64, 0), (0, 7, 40, 1),
])
def test_plain_equals_probe_expectation(dim, r, w, rep):
    x, idx = _inputs(dim, r, w, seed=r * 100 + w + dim)
    exp = probe_dyngather.expected(x, idx, rep, dim)
    got = row_gather(torch.from_numpy(x), torch.from_numpy(idx), rep, dim)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), exp)


@pytest.mark.parametrize("dim,r,w,rep", [
    (0, 8, 128, 4), (1, 8, 128, 4), (1, 4, 96, 9),
])
def test_pallas_probe_and_plain_agree(dim, r, w, rep):
    """The JAX package's probe (tools/probe_dyngather.py) runs its Pallas
    kernel in interpret mode and checks it against its numpy expectation;
    the port's plain version must equal that expectation on the probe's own
    draws (default_rng(3): x, then idx)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", NGM_DG_INTERP="1",
               NGM_DG_DIM=str(dim), NGM_DG_R=str(r), NGM_DG_W=str(w),
               NGM_DG_REP=str(rep))
    proc = subprocess.run([sys.executable, "tools/probe_dyngather.py"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["correct"], res
    assert (res["dim"], res["r"], res["w"]) == (dim, r, w)

    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 20, size=(r, w), dtype=np.int32)
    idx = rng.integers(0, (r, w)[dim], size=(r, w), dtype=np.int32)
    got = row_gather_plain(torch.from_numpy(x), torch.from_numpy(idx), rep,
                           dim)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  probe_dyngather.expected(x, idx, rep, dim))


def test_plain_floors_out_of_range_indices():
    """Indices outside [0, extent) are taken modulo the extent, floored."""
    x, idx = _inputs(1, 4, 16, seed=1)
    shifted = torch.from_numpy(idx) + 16 * torch.tensor([[-3], [2], [0], [-1]],
                                                        dtype=torch.int32)
    a = row_gather_plain(torch.from_numpy(x), shifted, 5, 1)
    b = row_gather_plain(torch.from_numpy(x), torch.from_numpy(idx), 5, 1)
    assert torch.equal(a, b)


def test_plain_wraps_in_int32():
    x = torch.full((2, 4), 2**30, dtype=torch.int32)
    idx = torch.zeros((2, 4), dtype=torch.int32)
    assert torch.equal(row_gather(x, idx, 4, 1),
                       torch.zeros((2, 4), dtype=torch.int32))   # 2^32 wraps


@pytest.mark.parametrize("R,strip", [
    (1, 32), (256, 32), (1767, 32), (1768, 16), (3534, 16), (3535, 8),
    (4096, 8), (7068, 8), (7069, 4), (14_136, 4), (14_137, 2), (28_272, 2),
    (28_273, 1), (56_544, 1),
])
def test_plan_dim0_strip_width(R, strip):
    """dim 0 stages a strip of the widest C (32 ... 1) whose R rows and
    extension of 7 Q x 7 rows fit in a block's shared memory."""
    p = plan(R, 2048, 0)
    assert (p.variant, p.strip) == ("strip", strip)
    assert p.shared_bytes == 4 * R * strip + 4 * 7 * 32 * 7 <= 232_448
    assert p.grid[0] == -(-2048 // strip)
    assert p.grid[1] * p.per_block >= R > (p.grid[1] - 1) * p.per_block


@pytest.mark.parametrize("R", [56_545, 65_535])
def test_plan_dim0_walks_past_the_strips(R):
    p = plan(R, 100, 0)
    assert (p.variant, p.grid, p.shared_bytes) == ("walk", (1, R), 0)


def test_plan_dim0_splits_rows_only_while_the_card_has_room():
    """At 256 x 1024 (32 strips of 32 columns, two 39 KB blocks an SM) the
    rows go to 9 blocks a strip; at 4096 x 2048 (one 137 KB block an SM,
    256 strips) each strip is one block."""
    assert plan(256, 1024, 0).grid == (32, 9)
    assert plan(4096, 2048, 0).grid == (256, 1)


@pytest.mark.parametrize("W,variant", [
    (1, "rotated"), (2048, "rotated"), (56_615, "rotated"),
    (56_616, "staged"), (58_112, "staged"),
])
def test_plan_dim1_variant(W, variant):
    """dim 1 rotates its gathers while the row, its 7 x 31 word extension
    and a chunk of 1024 indices fit; the parent's staged kernel serves
    rows up to the shared memory itself."""
    p = plan(2, W, 1)
    assert p.variant == variant
    assert p.shared_bytes <= 232_448 - (1024 if variant == "rotated" else 0)


def test_plan_dim1_blocks():
    """A block serves a whole row where rows fill the card (4096 x 2048),
    else a part of it (256 x 1024: one chunk; 2 x 20000: 20 parts)."""
    assert plan(4096, 2048, 1)[2:] == ((4096, 1), 512, 4 * (2268 + 2048),
                                       2048)
    assert plan(256, 1024, 1).grid == (256, 1)
    p = plan(2, 20_000, 1)
    assert (p.grid, p.per_block) == ((2, 20), 1024)


@pytest.mark.parametrize("R,W,dim", [(4, 58_113, 1), (65_536, 4, 0)])
def test_plan_refuses(R, W, dim):
    with pytest.raises(ValueError):
        plan(R, W, dim)


@pytest.mark.parametrize("bad", [
    dict(dim=2), dict(rep=-1), dict(dtype=torch.int64), dict(shape=(4, 8)),
])
def test_wrapper_refuses(bad):
    x = torch.zeros((4, 4), dtype=bad.get("dtype", torch.int32))
    idx = torch.zeros(bad.get("shape", (4, 4)), dtype=torch.int32)
    with pytest.raises(ValueError):
        row_gather(x, idx, bad.get("rep", 2), bad.get("dim", 1))


def test_probe_without_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_dyngather.main(["--dim", "0", "--w", "64", "--r", "8"]) == 2
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["ok"] is False and res["dim"] == 0 and res["w"] == 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tensors here are small, and the test
    workers run side by side, so a thread per core in each worker only
    contends (the tests run ~4x faster under pytest-xdist this way).
    Every CPU test file of the port imports it; this file needs no JAX."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
