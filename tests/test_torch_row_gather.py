"""K3's plain PyTorch version (the dynamic-gather probe's kernel) against
the probe's own numpy expectation (tools/probe_dyngather.py), for dim 0 and
1, and the wrapper's refusals.  Tolerance: exact (integer sums).
The kernel itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import json

import numpy as np
import pytest
import torch

from nextgenmap_tpu_torch.ops.row_gather import row_gather, row_gather_plain
from nextgenmap_tpu_torch.tools import probe_dyngather


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
