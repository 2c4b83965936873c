"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: every test needs a CUDA card and skips without one (the
kernels have no CPU mode).  Run on the card with
    python -m pytest tests/test_torch_kernels_cuda.py -q
chip_smoke.py repeats these checks at the main path's full shapes.
Tolerance: exact equality (integer DP, bytes).
"""

import numpy as np
import pytest
import torch

from nextgenmap_tpu.config import NgmConfig
from nextgenmap_tpu.ops.scoring import score_matrix
from nextgenmap_tpu_torch.models.mapper import Mapper
from nextgenmap_tpu_torch.ops.gather import gather_windows, pad_table
from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
from nextgenmap_tpu_torch.ops.sw_kernel import sw_score
from nextgenmap_tpu_torch.ops.sw_ref import banded_sw_score
from nextgenmap_tpu_torch.synthetic import repeat_genome, simulate_reads

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("T", [1, 148, 206, 1300])
def test_gather_kernel_equals_plain(dev, T):
    rng = np.random.default_rng(T)
    G = 50_000
    g = torch.from_numpy(rng.integers(0, 5, G).astype(np.uint8)).to(dev)
    s = rng.integers(-5, G + 5, 999).astype(np.int32)
    s[:4] = [0, G - T, G - 1, G]
    starts = torch.from_numpy(s).to(dev)
    before = gather_genome_windows.launches
    got = gather_genome_windows(g, starts, T)
    torch.cuda.synchronize()
    assert gather_genome_windows.launches == before + 1
    ref = gather_windows(pad_table(g, T, 4), starts, T)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("S,L,W,general", [
    (37, 100, 48, False), (64, 150, 56, False), (33, 100, 48, True),
    (5, 73, 1, False), (16, 200, 120, False), (8, 300, 184, True),
    (4, 120, 256, False),
])
def test_sw_kernel_equals_plain(dev, S, L, W, general):
    rng = np.random.default_rng(S * 1000 + W)
    cfg = NgmConfig(bs_mapping=general)
    mats = np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])
    q = rng.integers(0, 5, (S, L)).astype(np.uint8)
    r = rng.integers(0, 5, (S, L + W)).astype(np.uint8)
    for i in range(0, S, 2):
        o = int(rng.integers(0, W))
        r[i, o:o + L] = q[i]
        r[i, o + L // 2:o + L // 2 + 3] = 4     # a short N run
    lens = rng.integers(0, L + 1, S).astype(np.int32)
    msel = rng.integers(0, 2, S).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (q, lens, r, mats)]
    gaps = (25, 30, 7) if general else (20, 20, 20)
    msel_t = torch.from_numpy(msel).to(dev)
    got = sw_score(*args, *gaps, msel_t, band=W)
    torch.cuda.synchronize()
    ref = banded_sw_score(*args, *gaps, msel_t, band=W)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    assert int(got.score.max()) > 0


def test_mapper_cuda_equals_cpu(dev):
    cfg = NgmConfig(kmer=11)
    g = repeat_genome(60_000, n_repeats=12, min_len=800, max_len=2000, seed=5)
    codes, _, _ = simulate_reads(g, 256, 100, 0.02, seed=6)
    lens = np.full(256, 100, np.int32)

    class _G:
        codes = g

    gpu = Mapper(cfg, _G(), 100, device=dev)
    cpu = Mapper(cfg, _G(), 100, device="cpu")
    launches = (sw_score.launches, gather_genome_windows.launches)
    a = gpu.map_batch(codes, lens)
    torch.cuda.synchronize()
    assert sw_score.launches == launches[0] + 1
    assert gather_genome_windows.launches == launches[1] + 2
    b = cpu.map_batch(codes, lens)
    for f in a._fields:
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    assert int((b.n_candidates >= 2).sum()) > 0
