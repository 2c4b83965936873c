"""The port's CUDA kernels against their plain PyTorch versions, on the card
(K1 and K4 in local and glocal mode), and the single-end, paired and top-n
steps, also under --end-to-end and --bs-mapping, on the card against the
CPU (their tracebacks through K4).

K1 is checked at every band width that crosses a boundary of its (lanes per
alignment, cells per lane) templates, with S not a multiple of the
alignments per warp, qlen 0, 1, L and > L, 1 to 8 matrices, invalid all-4
slots, tie-heavy periodic inputs (many cells share the maximum, so the
deferred argmax must pick the first in (i, o)), and matrices large enough
that the kernel keeps (value, o) unpacked.  K4 is checked in every
AlignResult field and in its direction bytes at the main path's shapes
([4096,100]xW48, [2048,150]xW56, [614,1000]xW184, [2048,100]xW264), at W
512 (one warp), 520, 1024, 2048 and 8192 (a block), W 1, 2 and 17, with
ties, cheap gaps, length-0 slots and an op buffer that truncates.  K2 is
checked at T around the 16-byte store width, at starts 0, G - T, G - 1, G and beyond, and on a
genome of more than 2^31 bytes.  K3 is checked on each side of its
variants' boundaries (ops/row_gather.plan), at W not a multiple of 32, W 1
and R 1, REP 0, 1 and 33, indices from -3 to 3 times the extent, rows off
a 16-byte boundary and 4096 x 2048, and its Python shape rule against the
library's.  K5 (the read front end) is checked at the
main path's [4096,100], [4096,150] and [614,1000] canonical batches, two
strands and bisulfite with and without a cutoff, and a batch of L = k; K6
(candidate search) on both routes at the bench's input, plain CSR, 1000 bp
at H 1280, bisulfite with two tables at H 4608 and H 8200 (the global
route only), with a tandem-repeat read that moves its three overflow
counters; its plan against what the library launches, and both kernels
replayed in one captured graph.  The index-shard loop (single, paired, the
cross-shard tail pool and top-n) runs on the card against the CPU, and so
do the dp step and the ("dp", "ish") grid on two and four slots of card 0;
with two cards or more, K1 and K2 run on tensors of the last card while
card 0 is current.  The mapping paths launch the fused score pass
(tests/test_torch_score_pass.py holds it against its plain version) once a
tail, and the finish pass (tests/test_torch_finish_pass.py) once a tail of
the single and paired steps, where top-n launches K2 and K4.

Marked `cuda`: every test needs a CUDA card and skips without one (the
kernels have no CPU mode).  Run on the card with
    python -m pytest tests/test_torch_kernels_cuda.py -q
chip_smoke.py repeats these checks at the main path's full shapes.
Tolerance: exact equality (integer DP, bytes).
"""

import numpy as np
import pytest
import torch

from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.models.mapper import Mapper
from nextgenmap_tpu_torch.models.step_graph import StepGraphs
from nextgenmap_tpu_torch.ops.candidate_kernel import candidate_search
from nextgenmap_tpu_torch.ops.finish_kernel import finish_pass
from nextgenmap_tpu_torch.ops.gather import gather_windows, pad_table
from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
from nextgenmap_tpu_torch.ops.kmer_kernel import read_kmers
from nextgenmap_tpu_torch.ops.row_gather import row_gather, row_gather_plain
from nextgenmap_tpu_torch.ops.score_pass_kernel import score_pass
from nextgenmap_tpu_torch.ops.scoring import score_matrix
from nextgenmap_tpu_torch.ops.sw_align_kernel import (
    sw_align, sw_align_with_dirs,
)
from nextgenmap_tpu_torch.ops.sw_kernel import sw_score
from nextgenmap_tpu_torch.ops.sw_ref import (
    _backwalk_rows, banded_sw_forward, banded_sw_score,
)
from nextgenmap_tpu_torch.synthetic import (
    front_genome, front_reads, repeat_genome, simulate_long_reads,
    simulate_pairs, simulate_reads,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("T", [1, 15, 16, 17, 148, 206, 1184, 1300])
def test_gather_kernel_equals_plain(dev, T):
    rng = np.random.default_rng(T)
    G = 50_000
    g = torch.from_numpy(rng.integers(0, 5, G).astype(np.uint8)).to(dev)
    s = rng.integers(-5, G + 5, 999).astype(np.int32)
    s[:7] = [0, G - T, G - 1, G, G + 1, G + 3 * T, -1]
    starts = torch.from_numpy(s).to(dev)
    before = gather_genome_windows.launches
    got = gather_genome_windows(g, starts, T)
    torch.cuda.synchronize()
    assert gather_genome_windows.launches == before + 1
    ref = gather_windows(pad_table(g, T, 4), starts, T)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("T", [148, 1184])
def test_gather_kernel_genome_past_2_31(dev, T):
    """A genome of more than 2^31 bytes: windows that start below 2^31 and
    reach past it, and windows past the end."""
    G = (1 << 31) + 4096
    g = torch.arange(G, dtype=torch.int64, device=dev).remainder_(5).to(
        torch.uint8)
    top = (1 << 31) - 1
    s = np.array([0, top - T, top - 1, top, 12345, top - 2 * T + 7],
                 np.int32)
    starts = torch.from_numpy(s).to(dev)
    got = gather_genome_windows(g, starts, T)
    torch.cuda.synchronize()
    want = torch.stack([g[int(x):int(x) + T] for x in s])
    assert torch.equal(got, want)
    small = g[G - 3 * T:].contiguous()       # the same code on a short tail
    s2 = torch.tensor([0, 2 * T, 3 * T - 1, 3 * T], dtype=torch.int32,
                      device=dev)
    assert torch.equal(gather_genome_windows(small, s2, T),
                       gather_windows(pad_table(small, T, 4), s2, T))


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


@pytest.mark.parametrize("S,L,W,general", [
    (2048, 100, 48, False), (2048, 100, 48, True), (32, 1000, 184, False),
])
def test_sw_kernel_glocal_equals_plain(dev, S, L, W, general):
    """K1's glocal variant at chip_smoke.py's glocal shapes, with reads
    shorter than L and N-padded (their last row competes) among them."""
    rng = np.random.default_rng(S + L + W)
    cfg = NgmConfig(bs_mapping=general)
    mats = np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])
    q = rng.integers(0, 4, (S, L)).astype(np.uint8)
    r = rng.integers(0, 5, (S, L + W)).astype(np.uint8)
    for i in range(0, S, 2):
        o = int(rng.integers(0, W // 2))
        r[i, o:o + L] = q[i]
        r[i, o + L // 3] = (r[i, o + L // 3] + 1) % 4     # a mismatch
    lens = np.where(rng.random(S) < 0.2, rng.integers(0, L + 1, S), L)
    lens = lens.astype(np.int32)
    for i in range(S):
        q[i, lens[i]:] = 4
    msel = rng.integers(0, 2, S).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (q, lens, r, mats)]
    gaps = (25, 30, 7) if general else (20, 20, 20)
    msel_t = torch.from_numpy(msel).to(dev)
    before = sw_score.launches
    got = sw_score(*args, *gaps, msel_t, band=W, mode="glocal")
    torch.cuda.synchronize()
    assert sw_score.launches == before + 1
    ref = banded_sw_score(*args, *gaps, msel_t, band=W, mode="glocal")
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    assert int(got.score.max()) > 0
    hit = got.score > 0
    assert torch.equal(got.end_i[hit], args[1][hit] - 1)   # the last row


# every band width on each side of a template boundary of csrc/sw_score.cu,
# the warp kernel's wide templates (32 x 12, 32 x 16), the block kernel's
# warp counts (W > 512: 8 cells a thread, 256 a warp) and its limit
BANDS = [1, 2, 15, 16, 17, 31, 32, 33, 47, 48, 49, 63, 64, 65, 95, 96, 97,
         127, 128, 129, 191, 192, 193, 255, 256, 257, 264, 383, 384, 385,
         488, 511, 512, 513, 520, 767, 768, 769, 1024, 2048, 8192]


def _sw_case(rng, S, L, W, n_mats):
    """Queries, corridors holding most queries at a random offset, lengths
    0, 1, L and > L among random ones, every 7th slot an invalid all-4 one,
    and n_mats asymmetric matrices with a random one per slot."""
    q = rng.integers(0, 5, (S, L)).astype(np.uint8)
    r = rng.integers(0, 5, (S, L + W)).astype(np.uint8)
    for i in range(S):
        if i % 3:
            o = int(rng.integers(0, W))
            seg = q[i, :L + W - o]
            r[i, o:o + seg.shape[0]] = seg
    r[::7] = 4
    lens = rng.integers(0, L + 1, S).astype(np.int32)
    lens[:4] = [0, 1, L, L + 5]
    mats = rng.integers(-20, 4, (n_mats, 8, 8)).astype(np.int32)
    for c in range(4):
        mats[:, c, c] = rng.integers(6, 13, n_mats)
    msel = rng.integers(-1, n_mats + 1, S).astype(np.int32)   # clamped
    return q, lens, r, mats, msel


def _check_sw(dev, q, lens, r, mats, msel, gaps, W, mode):
    args = [torch.from_numpy(a).to(dev) for a in (q, lens, r, mats)]
    ms = torch.from_numpy(msel).to(dev)
    before = sw_score.launches
    got = sw_score(*args, *gaps, ms, band=W, mode=mode)
    torch.cuda.synchronize()
    assert sw_score.launches == before + 1
    # the plain version indexes matrices by msel unclamped
    ref = banded_sw_score(*args, *gaps, ms.clamp(0, mats.shape[0] - 1),
                          band=W, mode=mode)
    for name, a, b in zip(("score", "end_i", "end_o"), ref, got):
        assert torch.equal(a, b), (name, W, mode)
    return got


@pytest.mark.parametrize("mode", ["local", "glocal"])
@pytest.mark.parametrize("W", BANDS)
def test_sw_kernel_bands(dev, W, mode):
    rng = np.random.default_rng(W * 2 + (mode == "local"))
    S, L = 37, 60          # 37: not a multiple of 4, 2 or 1 per warp
    n_mats = 1 + W % 8
    got = _check_sw(dev, *_sw_case(rng, S, L, W, n_mats), (22, 25, 7), W,
                    mode)
    assert int(got.score[0]) == 0          # qlen 0
    assert int(got.score.max()) > 0


@pytest.mark.parametrize("mode", ["local", "glocal"])
@pytest.mark.parametrize("W", [48, 56, 184, 264, 488, 520, 1024, 2048])
def test_sw_kernel_ties(dev, W, mode):
    """Periodic ACAC... queries over periodic corridors: many cells share
    the maximum, so the first one in (i, o) order must win."""
    S, L = 66, 100
    q = np.tile(np.array([0, 1], np.uint8), (S, L // 2))
    r = np.tile(np.array([0, 1], np.uint8), (S, (L + W + 1) // 2))[:, :L + W]
    r = r.copy()
    r[1::3] = 1 - r[1::3]                   # out of phase by one base
    r[2::3, ::9] = 2                         # and a few breaks
    lens = np.full(S, L, np.int32)
    lens[::5] = np.arange(1, L + 1, 5)[:len(lens[::5])]
    mats = np.stack([score_matrix(NgmConfig(), 0)])
    got = _check_sw(dev, q, lens, r, mats, np.zeros(S, np.int32),
                    (20, 20, 20), W, mode)
    assert int(got.score.max()) > 0


@pytest.mark.parametrize("mode", ["local", "glocal"])
@pytest.mark.parametrize("S,L,W", [
    (2048, 100, 264), (256, 1500, 264), (128, 3000, 488), (64, 100, 512),
    (64, 300, 520), (32, 500, 1024), (16, 1000, 2048),
])
def test_sw_kernel_wide_bands(dev, S, L, W, mode):
    """The wide bands a run reaches: --corridor 225 (W 264), reads of 1500
    and 3000 bp, and the block kernel's widths, on reads that sit in the
    corridor with SNPs and a short indel."""
    rng = np.random.default_rng(S + L + W)
    q = rng.integers(0, 4, (S, L)).astype(np.uint8)
    r = rng.integers(0, 4, (S, L + W)).astype(np.uint8)
    for i in range(S):
        o = int(rng.integers(0, W))
        seg = q[i].copy()
        snp = rng.random(L) < 0.03
        seg[snp] = (seg[snp] + 1) % 4
        cut = int(rng.integers(L // 4, 3 * L // 4))
        seg = np.concatenate([seg[:cut], seg[cut + 2:]])[:L + W - o]
        r[i, o:o + seg.shape[0]] = seg
    lens = np.full(S, L, np.int32)
    lens[:3] = [0, 1, L]
    lens[3::9] = rng.integers(2, L, len(lens[3::9]))
    mats = np.stack([score_matrix(NgmConfig(), 0)])
    got = _check_sw(dev, q, lens, r, mats, np.zeros(S, np.int32),
                    (20, 20, 20), W, mode)
    assert int(got.score[0]) == 0
    assert int((got.score > 0).sum()) >= S // 2


def test_sw_kernel_refuses_past_max_band(dev):
    from nextgenmap_tpu_torch.ops.sw_kernel import MAX_BAND

    S, L, W = 4, 20, MAX_BAND + 1
    args = [torch.zeros((S, L), dtype=torch.uint8, device=dev),
            torch.full((S,), L, dtype=torch.int32, device=dev),
            torch.zeros((S, L + W), dtype=torch.uint8, device=dev),
            torch.from_numpy(score_matrix(NgmConfig(), 0)).to(dev)]
    with pytest.raises(ValueError, match="band"):
        sw_score(*args, 20, 20, 20, band=W)


@pytest.mark.parametrize("mode", ["local", "glocal"])
def test_sw_kernel_large_scores(dev, mode):
    """Scores in the millions (|H| >= 2^21 possible), far past any read's:
    the int32 DP and the argmax stay exact."""
    rng = np.random.default_rng(17)
    q, lens, r, mats, msel = _sw_case(rng, 45, 100, 48, 2)
    mats = mats * 3000
    _check_sw(dev, q, lens, r, mats, msel, (60_000, 70_000, 20_000), 48,
              mode)


def _align_case(rng, S, L, W):
    """K4's input: two in five queries planted in their corridors with 3%
    SNPs and a 1-3 bp insertion and deletion, one in five tie-heavy
    (ACAC... over ACAC..., some out of phase), the rest random; N codes;
    lengths 0 (every 11th, with an all-4 corridor, as the top-n tail's
    invalid slots), 1, short ones and L; a matrix per slot."""
    q = rng.integers(0, 4, (S, L)).astype(np.uint8)
    r = rng.integers(0, 4, (S, L + W)).astype(np.uint8)
    for i in range(S):
        kind = i % 5
        if kind in (0, 3):
            o = int(rng.integers(0, W))
            seg = q[i].copy()
            snp = rng.random(L) < 0.03
            seg[snp] = (seg[snp] + 1) % 4
            cut = int(rng.integers(1, L)) if L > 1 else 0
            seg = np.concatenate([seg[:cut], rng.integers(0, 4, 1 + i % 3),
                                  seg[cut:]])
            cut = int(rng.integers(0, seg.shape[0]))
            seg = np.delete(seg, slice(cut, cut + 1 + i % 3))[:L + W - o]
            r[i, o:o + seg.shape[0]] = seg
        elif kind == 1:
            q[i] = np.resize(np.array([0, 1], np.uint8), L)
            r[i] = np.resize(np.array([0, 1] if i % 2 else [1, 0], np.uint8),
                             L + W)
    q[rng.random((S, L)) < 0.01] = 4
    lens = np.full(S, L, np.int32)
    lens[2::7] = rng.integers(1, L + 1, len(lens[2::7]))
    lens[1::13] = 1
    lens[::11] = 0
    r[::11] = 4
    msel = rng.integers(0, 2, S).astype(np.int32)
    return q, lens, r, msel


def _check_align(dev, q, lens, r, mats, msel, gaps, W, mode, max_ops=0,
                 route=None):
    """K4 == banded_sw_forward's bytes, then _backwalk_rows's every
    AlignResult field; and without the bytes (the mapping path's call) the
    same fields."""
    args = [torch.from_numpy(a).to(dev) for a in (q, lens, r, mats, msel)]
    before = sw_align.launches
    got, dirs = sw_align_with_dirs(*args[:4], *gaps, args[4], band=W,
                                   max_ops=max_ops, mode=mode, route=route)
    bare = sw_align(*args[:4], *gaps, args[4], band=W, max_ops=max_ops,
                    mode=mode, route=route)
    torch.cuda.synchronize()
    assert sw_align.launches == before + 2
    pdirs, best, bi, bo = banded_sw_forward(*args[:4], *gaps, args[4],
                                            band=W, mode=mode)
    assert torch.equal(dirs, pdirs), ("dirs", W, mode, route)
    ref = _backwalk_rows(pdirs, best, bi, bo, max_ops or q.shape[1] + W)
    for f in ref._fields:
        assert torch.equal(getattr(ref, f), getattr(got, f)), (f, W, mode,
                                                               route)
        assert torch.equal(getattr(ref, f), getattr(bare, f)), (f, W, mode,
                                                                route)
    return got


# (S, L, W) of the main path (single-end, 150 bp, 1000 bp, --corridor
# 225), then one warp of 32 x 16 cells and band 1, 2 and 17: both routes
ALIGN_WARP_SHAPES = [
    (4096, 100, 48), (2048, 150, 56), (614, 1000, 184), (2048, 100, 264),
    (64, 100, 512), (37, 60, 1), (37, 60, 2), (45, 70, 17),
]
# the block form (W > 512): the global route only
ALIGN_BLOCK_SHAPES = [(64, 100, 520), (32, 200, 1024), (16, 200, 2048),
                      (4, 100, 8192)]


@pytest.mark.parametrize("gaps", [(20, 20, 20), (5, 7, 1)])
@pytest.mark.parametrize("mode", ["local", "glocal"])
@pytest.mark.parametrize("S,L,W,route", [
    (*shape, route) for shape in ALIGN_WARP_SHAPES
    for route in ("smem", "global")
] + [(*shape, "global") for shape in ALIGN_BLOCK_SHAPES])
def test_sw_align_kernel_equals_plain(dev, S, L, W, route, mode, gaps):
    """K4 on each route at the main path's shapes and the band's edges,
    with the bisulfite [2, 8, 8] matrices, in every AlignResult field and in
    the direction bytes; then with an op buffer of 12 that truncates."""
    rng = np.random.default_rng(S + L + W + gaps[2])
    q, lens, r, msel = _align_case(rng, S, L, W)
    cfg = NgmConfig(bs_mapping=True)
    mats = np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])
    got = _check_align(dev, q, lens, r, mats, msel, gaps, W, mode,
                       route=route)
    assert int(got.score.max()) > 0
    zero = torch.from_numpy(lens == 0).to(dev)
    assert int(got.n_ops[zero].max()) == 0
    short = _check_align(dev, q, lens, r, mats, msel, gaps, W, mode,
                         max_ops=12, route=route)
    assert bool(short.trunc.any())


@pytest.mark.parametrize("mode", ["local", "glocal"])
@pytest.mark.parametrize("W", [48, 184, 264])
def test_sw_align_route_threshold_edge(dev, W, mode):
    """The longest L at which the shape rule still takes the smem route,
    and the next: both routes exact on each side, and the rule's pick."""
    from nextgenmap_tpu_torch.ops.sw_align_kernel import plan

    def rule(L):
        return plan(24, L, W, mode).route

    lo, hi = 1, 4096
    assert rule(lo) == "smem" and rule(hi) == "global"
    while hi - lo > 1:                     # rule(lo) smem, rule(hi) global
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if rule(mid) == "smem" else (lo, mid)
    for L, want in ((lo, "smem"), (hi, "global")):
        assert plan(24, L, W, mode).warps_per_sm >= 1
        rng = np.random.default_rng(L + W)
        q, lens, r, msel = _align_case(rng, 24, L, W)
        mats = np.stack([score_matrix(NgmConfig(), 0)])
        for route in ("smem", "global", None):
            if route == "smem" and L > lo:
                try:
                    plan(24, L, W, mode, "smem")
                except ValueError:
                    continue                # past what the route can hold
            got = _check_align(dev, q, lens, r, mats, msel * 0, (5, 7, 1), W,
                               mode, route=route)
            assert int(got.score.max()) > 0
        assert rule(L) == want


def test_sw_align_kernel_refuses(dev):
    """A band past 8192, nine matrices, an unknown route and a route that
    cannot take the shape (smem past W 512, or rows past the shared memory
    of one block) raise before any launch."""
    from nextgenmap_tpu_torch.ops.sw_align_kernel import plan
    from nextgenmap_tpu_torch.ops.sw_kernel import MAX_BAND

    S, L = 4, 20
    mats = torch.from_numpy(score_matrix(NgmConfig(), 0)).to(dev)

    def args(W, L=L):
        return [torch.zeros((S, L), dtype=torch.uint8, device=dev),
                torch.full((S,), L, dtype=torch.int32, device=dev),
                torch.zeros((S, L + W), dtype=torch.uint8, device=dev)]

    before = sw_align.launches
    with pytest.raises(ValueError, match="band"):
        sw_align(*args(MAX_BAND + 1), mats, 20, 20, 20, band=MAX_BAND + 1)
    with pytest.raises(ValueError, match="matrices"):
        sw_align(*args(48), mats.expand(9, 8, 8).contiguous(), 20, 20, 20,
                 torch.zeros(S, dtype=torch.int32, device=dev), band=48)
    with pytest.raises(ValueError, match="route"):
        sw_align(*args(48), mats, 20, 20, 20, band=48, route="shared")
    for W, L2 in ((520, 20), (8192, 20), (184, 3000), (48, 20_000)):
        with pytest.raises(ValueError, match="cannot take"):
            plan(S, L2, W, "local", "smem")
        for fn in (sw_align, sw_align_with_dirs):
            with pytest.raises(ValueError, match="cannot take"):
                fn(*args(W, L2), mats, 20, 20, 20, band=W, route="smem")
        assert plan(S, L2, W, "local").route == "global"
        assert plan(S, L2, W, "local", "global").blocks_per_sm >= 1
    assert sw_align.launches == before


def test_sw_align_plan_is_the_launch(dev):
    """The plan reports the block K4 launches: fewer warps a block for a
    few hundred alignments of one warp each, up to 4 for thousands, the
    route's capacity apart; the library launches only a block the plan
    gives, and a planned launch is exact."""
    from nextgenmap_tpu_torch.native import build
    from nextgenmap_tpu_torch.ops.sw_align_kernel import ROUTES, plan

    big = plan(4096, 100, 48, "local")
    assert big.route == "smem" and big.threads == 128
    assert big.route_warps_per_sm >= big.warps_per_sm >= 4
    few = plan(614, 1000, 184, "local")
    assert few.route == "global" and few.threads < 128
    assert few.warps_per_sm >= 1 and few.route_warps_per_sm >= 4
    assert few.smem_bytes * 128 == plan(4096, 1000, 184, "local").smem_bytes \
        * few.threads
    blk = plan(4, 20, 1024, "glocal")
    assert blk.route == "global" and blk.threads == 128

    rng = np.random.default_rng(7)
    S, L, W = 40, 60, 48
    q, lens, r, msel = _align_case(rng, S, L, W)
    mats = np.stack([score_matrix(NgmConfig(), 0)])
    _check_align(dev, q, lens, r, mats, msel * 0, (5, 7, 1), W, "local")
    lib = build.load()
    t = [torch.from_numpy(a).to(dev) for a in (q, lens, r, mats, msel * 0)]
    out = torch.empty((9, S), dtype=torch.int32, device=dev)
    ops = torch.empty((S, L + W), dtype=torch.uint8, device=dev)
    trunc = torch.empty(S, dtype=torch.bool, device=dev)
    p = plan(S, L, W, "local", "smem")
    for threads in (p.threads + 16, 5 * 32, 0):
        code = lib.ngm_sw_align(
            *(a.data_ptr() for a in t), S, L, W, 1, 5, 7, 1, 1, L + W,
            ROUTES.index("smem"), threads, None, None, out.data_ptr(),
            ops.data_ptr(), trunc.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        assert code != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("route", [None, "smem", "global"])
def test_sw_align_allocates_no_direction_bytes(dev, route):
    """The mapping path's call at [614,1000]xW184 allocates less than the
    L x S x W direction bytes over its inputs (the global route's packed
    rows, S x L x 128 bytes, are the largest of what it allocates)."""
    S, L, W = 614, 1000, 184
    rng = np.random.default_rng(7)
    q, lens, r, msel = _align_case(rng, S, L, W)
    cfg = NgmConfig(bs_mapping=True)
    mats = np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])
    args = [torch.from_numpy(a).to(dev) for a in (q, lens, r, mats, msel)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = sw_align(*args[:4], 20, 20, 20, args[4], band=W, route=route)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak < L * S * W, (peak, L * S * W)
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
    launches = (score_pass.launches, gather_genome_windows.launches,
                sw_align.launches, *front_launches(), finish_pass.launches)
    a, n = steps_run(gpu, lambda: gpu.map_batch(codes, lens))
    assert score_pass.launches == launches[0] + n
    # the finish pass, and no K2 or K4 of their own
    assert finish_pass.launches == launches[5] + n
    assert gather_genome_windows.launches == launches[1]
    assert sw_align.launches == launches[2]
    assert front_launches() == (launches[3] + n, launches[4] + n)
    b = cpu.map_batch(codes, lens)
    for f in a._fields:
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    assert int((b.n_candidates >= 2).sum()) > 0


@pytest.mark.parametrize("dim,r,w,rep", [
    (1, 256, 1024, 32), (0, 256, 1024, 32), (1, 3, 5, 9), (0, 5, 3, 11),
    (1, 4, 20_000, 3), (0, 300, 77, 0),
    # K3's variants on each side of their boundaries (ops/row_gather.plan)
    (0, 1767, 40, 33), (0, 1768, 40, 33), (0, 3534, 21, 5),
    (0, 3535, 21, 5), (0, 7068, 9, 4), (0, 7069, 9, 4), (0, 56_544, 3, 2),
    (0, 56_545, 3, 2), (1, 2, 56_615, 33), (1, 2, 56_616, 33),
    (1, 2, 58_112, 3), (1, 1100, 300, 32), (1, 600, 20_000, 33),
    # W not a multiple of 32 (and not of 4: no bulk copy), W 1, R 1
    (1, 9, 77, 33), (0, 77, 45, 70), (1, 5, 1, 7), (0, 1, 5, 7),
    (1, 1, 600, 64), (0, 1, 1, 3), (1, 1, 1, 0),
    # REP 0 and 1, and the use-case shape
    (1, 64, 2048, 0), (0, 64, 2048, 1), (1, 64, 2048, 1),
    (1, 4096, 2048, 32), (0, 4096, 2048, 32),
])
def test_row_gather_kernel_equals_plain(dev, dim, r, w, rep):
    """Indices run from -3 extent to 3 extent, so the floored modulo is
    exercised on both sides."""
    rng = np.random.default_rng(r + w + dim)
    extent = (r, w)[dim]
    x = torch.from_numpy(
        rng.integers(-(1 << 30), 1 << 30, (r, w), dtype=np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(-3 * extent, 3 * extent, (r, w),
                                        dtype=np.int32)).to(dev)
    before = row_gather.launches
    got = row_gather(x, idx, rep, dim)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert torch.equal(got, row_gather_plain(x, idx, rep, dim))


@pytest.mark.parametrize("dim", [0, 1])
def test_row_gather_unaligned_rows(dev, dim):
    """x 4 bytes past a 16-byte boundary: dim 1 cannot take its bulk copy
    and loads the row itself."""
    rng = np.random.default_rng(11)
    r, w = 40, 256
    flat = torch.from_numpy(rng.integers(0, 1 << 20, r * w + 1,
                                         dtype=np.int32)).to(dev)
    x = flat[1:].view(r, w)
    assert x.data_ptr() % 16 == 4
    idx = torch.from_numpy(rng.integers(0, (r, w)[dim], (r, w),
                                        dtype=np.int32)).to(dev)
    got = row_gather(x, idx, 32, dim)
    torch.cuda.synchronize()
    assert torch.equal(got, row_gather_plain(x, idx, 32, dim))


def test_row_gather_plan_matches_the_kernels(dev):
    """The Python shape rule and the library's own are one rule."""
    import ctypes

    from nextgenmap_tpu_torch.native import build
    from nextgenmap_tpu_torch.ops import row_gather as rg

    lib = build.load()
    buf = (ctypes.c_int * 7)()
    for dim, R, W in [(0, r, w) for r in (1, 256, 1767, 1768, 3534, 3535,
                                          4096, 7068, 7069, 56_544, 56_545,
                                          65_535)
                      for w in (1, 77, 1024, 2048)] + [
            (1, r, w) for r in (1, 2, 256, 4096, 10_000)
            for w in (1, 77, 1024, 1025, 2048, 20_000, 56_615, 56_616,
                      58_112)]:
        p = rg.plan(R, W, dim)
        assert lib.ngm_row_gather_plan(R, W, dim, buf) == 0
        assert list(buf) == [rg.VARIANTS.index(p.variant), p.strip, *p.grid,
                             p.threads, p.shared_bytes, p.per_block], \
            (dim, R, W)
    assert lib.ngm_row_gather_plan(65_536, 4, 0, buf) == -1
    assert lib.ngm_row_gather_plan(4, 58_113, 1, buf) == -1


def front_launches() -> tuple:
    """The launch counts of K5 and K6."""
    return read_kmers.launches, candidate_search.launches


def steps_run(m, call):
    """(call(), the steps it ran on the card): the batch's, and the eager
    warm-up step of each step graph it captured (models/step_graph.py), so
    a path's kernels launch that many times each per node."""
    c0 = len(m.graphs.captures)
    out = call()
    torch.cuda.synchronize()
    return out, 1 + len(m.graphs.captures) - c0


def _mappers(dev, cfg, g, read_len=100):
    class _G:
        codes = g

    gpu = Mapper(cfg, _G(), read_len, device=dev)
    index = (gpu.state.offsets.cpu().numpy(), gpu.state.positions.cpu().numpy())
    return gpu, Mapper(cfg, _G(), read_len, index, device="cpu")


def test_paired_and_topn_cuda_equal_cpu(dev):
    """Both paths launch the fused score pass on the card, the paired one
    the finish pass and top-n K2, and equal the CPU."""
    g = repeat_genome(60_000, n_repeats=12, min_len=800, max_len=2000, seed=7)
    lens = np.full(256, 100, np.int32)
    gpu, cpu = _mappers(dev, NgmConfig(kmer=11, topn=2), g)

    codes, _, _ = simulate_pairs(g, 128, 100, 0.02, seed=8)
    launches = (score_pass.launches, finish_pass.launches,
                *front_launches(), gather_genome_windows.launches)
    a, n = steps_run(gpu, lambda: gpu.map_batch_paired(codes, lens))
    assert score_pass.launches == launches[0] + n
    assert finish_pass.launches == launches[1] + n
    assert gather_genome_windows.launches == launches[4]
    assert front_launches() == (launches[2] + n, launches[3] + n)
    b = cpu.map_batch_paired(codes, lens)
    for f in a._fields:
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    assert int(b.proper.sum()) > 200

    codes, _, _ = simulate_reads(g, 256, 100, 0.02, seed=9)
    launches = (score_pass.launches, gather_genome_windows.launches,
                *front_launches(), finish_pass.launches)
    a, n = steps_run(gpu, lambda: gpu.map_batch_topn(codes, lens))
    assert score_pass.launches == launches[0] + n
    assert gather_genome_windows.launches == launches[1] + n
    assert finish_pass.launches == launches[4]
    assert front_launches() == (launches[2] + n, launches[3] + n)
    b = cpu.map_batch_topn(codes, lens)
    for j, (ra, rb) in enumerate(zip(a, b)):
        for f in ra._fields:
            assert torch.equal(getattr(ra, f).cpu(), getattr(rb, f)), (j, f)
    assert int(b[1].mapped.sum()) > 0


@pytest.mark.parametrize("change,read_len", [
    (dict(end_to_end=True), 100), (dict(bs_mapping=True), 100),
    (dict(bs_mapping=True, end_to_end=True), 100), (dict(), 1000),
    (dict(end_to_end=True), 500),
])
def test_modes_cuda_equal_cpu(dev, change, read_len):
    """Single, paired and top-n steps in each mode, and for long reads,
    launch the fused score pass and the finish pass (top-n: K2) on the
    card and equal the CPU from the same state."""
    g = repeat_genome(60_000, n_repeats=12, min_len=800, max_len=2000, seed=10)
    gpu, cpu = _mappers(dev, NgmConfig(kmer=11, topn=2).replace(**change), g,
                        read_len)
    B = 256 if read_len == 100 else 64
    lens = np.full(B, read_len, np.int32)
    codes, _, _ = simulate_long_reads(g, B, read_len, 0.02, 0.004, seed=11)
    for step in ("map_batch", "map_batch_paired", "map_batch_topn"):
        launches = (score_pass.launches, gather_genome_windows.launches,
                    *front_launches(), finish_pass.launches)
        a, n = steps_run(gpu, lambda: getattr(gpu, step)(codes, lens))
        topn = step == "map_batch_topn"
        assert score_pass.launches == launches[0] + n
        assert gather_genome_windows.launches == launches[1] + n * topn
        assert finish_pass.launches == launches[4] + n * (not topn)
        assert front_launches() == (launches[2] + n, launches[3] + n)
        b = getattr(cpu, step)(codes, lens)
        ranks = (a, b) if step == "map_batch_topn" else ((a,), (b,))
        for j, (ra, rb) in enumerate(zip(*ranks)):
            for f in ra._fields:
                assert torch.equal(getattr(ra, f).cpu(), getattr(rb, f)), \
                    (step, j, f)


@pytest.mark.parametrize("step,compact_cap", [
    ("single", 0), ("single", 512), ("paired", 0), ("paired", 512),
    ("topn", 0),
])
def test_sharded_step_cuda_equals_cpu(dev, step, compact_cap):
    """The shard loop over 3 shards on the card == on the CPU, from the same
    ShardedIndex: full per-shard tails launch the score pass and the finish
    pass once each per shard, the cross-shard pool (512 rows < 3 x 256) once
    each in all, top-n the score pass and K2 once each per shard."""
    from nextgenmap_tpu_torch.index.kmer_index import KmerIndex
    from nextgenmap_tpu_torch.models.mapper import map_step_sharded
    from nextgenmap_tpu_torch.parallel.index_shard import ShardedIndex

    g = repeat_genome(90_000, n_repeats=16, min_len=800, max_len=2000,
                      seed=12)
    cfg = NgmConfig(kmer=11, index_shards=3, topn=2)
    # every indexed position: the reads' k-mers are taken at stride 2
    # (read_kmer_skip), so an index at stride 2 would miss half the reads
    idx = KmerIndex.build(g, k=11, skip=cfg.kmer_skip, max_freq=1000,
                          canonical=True, allow_u32=True)
    sidx = ShardedIndex.build(idx, g, 3, ShardedIndex.halo_for(cfg))

    class _G:
        codes = g

    gpu, cpu = (Mapper(cfg, _G(), 100, sidx, device=d) for d in (dev, "cpu"))
    if step == "paired":
        codes, _, _ = simulate_pairs(g, 128, 100, 0.02, seed=13)
    else:
        codes, _, _ = simulate_reads(g, 256, 100, 0.02, seed=13)
    lens = np.full(256, 100, np.int32)
    pair = ((cfg.min_insert_size, cfg.max_insert_size, cfg.pair_score_cutoff)
            if step == "paired" else ())

    def run(m):
        if step == "topn":
            return m.map_batch_topn(codes, lens)
        return (map_step_sharded(
            *m._common_args(codes, lens), *pair, paired=step == "paired",
            read_len=100, compact_cap=compact_cap, **m.statics()),)

    launches = (score_pass.launches, gather_genome_windows.launches,
                finish_pass.launches)
    a, steps = steps_run(gpu, lambda: run(gpu))
    n = (1 if compact_cap else 3) * steps
    topn = step == "topn"
    assert score_pass.launches == launches[0] + n
    assert gather_genome_windows.launches == launches[1] + n * topn
    assert finish_pass.launches == launches[2] + n * (not topn)
    b = run(cpu)
    for j, (ra, rb) in enumerate(zip(a, b)):
        for f in ra._fields:
            assert torch.equal(getattr(ra, f).cpu(), getattr(rb, f)), (j, f)
    assert int(b[0].mapped.sum()) > 240


def test_kernels_on_the_last_card(dev):
    """K1 and K2 on tensors of the last card while the current device is
    card 0: each wrapper launches on its tensors' own card (the dp slices
    of --devices call them from every card)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"{n} CUDA card: needs two to put the tensors on another")
    last = torch.device("cuda", n - 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(7)
    G, T = 50_000, 148
    g = torch.from_numpy(rng.integers(0, 5, G).astype(np.uint8)).to(last)
    starts = torch.from_numpy(
        rng.integers(-5, G + 5, 999).astype(np.int32)).to(last)
    got = gather_genome_windows(g, starts, T)
    torch.cuda.synchronize(last)
    assert got.device == last
    assert torch.equal(got, gather_windows(pad_table(g, T, 4), starts, T))
    S, L, W = 64, 100, 48
    cfg = NgmConfig()
    mats = np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])
    q = rng.integers(0, 4, (S, L)).astype(np.uint8)
    r = rng.integers(0, 5, (S, L + W)).astype(np.uint8)
    r[::2, 10:10 + L] = q[::2]
    lens = np.full(S, L, np.int32)
    args = [torch.from_numpy(a).to(last) for a in (q, lens, r, mats)]
    msel = torch.zeros(S, dtype=torch.int32, device=last)
    got = sw_score(*args, 20, 20, 20, msel, band=W)
    torch.cuda.synchronize(last)
    want = banded_sw_score(*args, 20, 20, 20, msel, band=W)
    for a, b in zip(want, got):
        assert a.device == b.device == last and torch.equal(a, b)
    assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("shards", [1, 2])
def test_two_slots_on_one_card_equal_cpu(dev, shards):
    """--devices on the slots [cuda:0] x 2 (the dp step, its two slices one
    graph) and [cuda:0] x 4 with 2 shards (the ("dp", "ish") grid, its two
    rows one graph) equal the CPU's one-device run, with the score pass
    and the finish pass launched once each per shard of each step run (and
    no K2): the two slices (rows) of the batch, and the one slice of each
    capture's eager warm-up."""
    from nextgenmap_tpu_torch.index.kmer_index import KmerIndex
    from nextgenmap_tpu_torch.parallel.index_shard import ShardedIndex

    cfg = NgmConfig(kmer=11, index_shards=shards)
    g = repeat_genome(60_000, n_repeats=12, min_len=800, max_len=2000, seed=5)

    class _G:
        codes = g

    index = None
    if shards > 1:
        host = KmerIndex.build(g, k=11, skip=1, max_freq=cfg.max_kmer_freq,
                               canonical=True, allow_u32=True)
        index = ShardedIndex.build(host, g, shards, ShardedIndex.halo_for(cfg))
    slots = [torch.device("cuda", 0)] * (2 * shards)
    gpu = Mapper(cfg, _G(), 100, index, device=slots)
    cpu = Mapper(cfg, _G(), 100, index, device="cpu")
    for step, seed in (("map_batch", 6), ("map_batch_paired", 8)):
        if step == "map_batch":
            codes, _, _ = simulate_reads(g, 256, 100, 0.02, seed=seed)
        else:
            codes, _, _ = simulate_pairs(g, 128, 100, 0.02, seed=seed)
        lens = np.full(256, 100, np.int32)
        launches = (score_pass.launches, gather_genome_windows.launches,
                    finish_pass.launches)
        c0 = len(gpu.graphs.captures)
        a = getattr(gpu, step)(codes, lens)
        torch.cuda.synchronize()
        n = (2 + len(gpu.graphs.captures) - c0) * shards
        assert score_pass.launches == launches[0] + n
        assert gather_genome_windows.launches == launches[1]
        assert finish_pass.launches == launches[2] + n
        b = getattr(cpu, step)(codes, lens)
        for f in a._fields:
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), (step, f)


# the step paths through their step graphs: (config changes,
# the Mapper method, K batches a call)
GRAPH_PATHS = {
    "single": (dict(), "map_batch", 1),
    "paired": (dict(), "map_batch_paired", 1),
    "topn": (dict(topn=2), "map_batch_topn", 1),
    "sharded-4-pool": (dict(index_shards=4), "map_batch", 1),
    "sharded-4-pool-paired": (dict(index_shards=4), "map_batch_paired", 1),
    "sharded-2-tails": (dict(index_shards=2), "map_batch", 1),
    "sharded-2-topn": (dict(index_shards=2, topn=2), "map_batch_topn", 1),
    "megabatch-3": (dict(), "map_batch_scan", 3),
    "megabatch-3-paired": (dict(), "map_batch_scan", 3),
    "dp-2": (dict(), "map_batch", 1),
    "dp-2-paired": (dict(), "map_batch_paired", 1),
    "grid-2x2": (dict(index_shards=2), "map_batch", 1),
    "grid-2x2-paired": (dict(index_shards=2), "map_batch_paired", 1),
}
# the paths on several slots of the card: the dp step ([cuda:0] x 2, one
# graph of its two slices) and the grid [2, 2] (one graph of its two rows)
GRAPH_SLOTS = {"dp-2": 2, "dp-2-paired": 2, "grid-2x2": 4,
               "grid-2x2-paired": 4}


def _fields(res) -> list:
    ranks = (res,) if hasattr(res, "_fields") else res
    return [(j, f, getattr(r, f)) for j, r in enumerate(ranks)
            for f in r._fields]


@pytest.mark.parametrize("path", sorted(GRAPH_PATHS))
def test_step_graph_equals_eager_on_card(dev, path):
    """Each path through its captured graph (the default; the dp step and
    the grid on several slots of the card, each one graph a batch) ==
    the same Mapper state's eager step (its graphs replaced by
    StepGraphs(..., eager=True)) on two successive batches,
    in every field and rank; the second call replays the first call's
    graph with no sync (set_sync_debug_mode("error"), inputs already on
    the card; the eager step makes none either), launches each kernel as
    often as the eager step does, and
    leaves the first call's result unchanged (the clone)."""
    from nextgenmap_tpu_torch.index.kmer_index import KmerIndex
    from nextgenmap_tpu_torch.parallel.index_shard import ShardedIndex

    changes, call, K = GRAPH_PATHS[path]
    paired = path.endswith("paired")
    g = repeat_genome(200_000, n_repeats=16, min_len=800, max_len=2000,
                      seed=21)
    cfg = NgmConfig(kmer=11, **changes)
    B = 512
    if cfg.index_shards > 1:
        host = KmerIndex.build(g, k=11, skip=cfg.kmer_skip, max_freq=1000,
                               canonical=True, allow_u32=True)
        index = ShardedIndex.build(host, g, cfg.index_shards,
                                   ShardedIndex.halo_for(cfg))
    else:
        index = None

    class _G:
        codes = g

    slots = [dev] * GRAPH_SLOTS.get(path, 1)
    graph = Mapper(cfg, _G(), 100, index, device=slots)
    if index is None:
        index = (graph.state.offsets.cpu().numpy(),
                 graph.state.positions.cpu().numpy())
    eager = Mapper(cfg, _G(), 100, index, device=slots)
    eager.graphs = StepGraphs(eager.device, eager=True)
    assert not graph.graphs.eager
    sim = simulate_pairs if paired else simulate_reads
    n = B // 2 if paired else B
    batches = [sim(g, K * n, 100, 0.02, seed=22 + i)[0].reshape(K, B, 100)
               for i in range(2)]
    lens = np.full((K, B), 100, np.int32)
    if K == 1:
        batches, lens = [b[0] for b in batches], lens[0]

    def run(m, codes, lengths):
        if call == "map_batch_scan":
            return m.map_batch_scan(codes, lengths, paired=paired)
        return getattr(m, call)(codes, lengths)

    def counts():
        return [k.launches for k in (score_pass, gather_genome_windows,
                                     sw_align, read_kmers, candidate_search,
                                     finish_pass)]

    first = run(graph, batches[0], lens)
    kept = [(j, f, t.clone()) for j, f, t in _fields(first)]
    assert len(graph.graphs.captures) == 1 and graph.graphs.replays == 1
    codes_d = torch.from_numpy(batches[1]).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    torch.cuda.synchronize()
    c0 = counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = run(graph, codes_d, lens_d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    c1 = counts()
    assert len(graph.graphs.captures) == 1 and graph.graphs.replays == 2
    for (j, f, t), (_, _, now) in zip(kept, _fields(first)):
        assert torch.equal(t, now), (j, f)
    run(eager, batches[0], lens)
    torch.cuda.synchronize()
    c2 = counts()
    torch.cuda.set_sync_debug_mode("error")     # the eager step makes none
    try:
        want = run(eager, codes_d, lens_d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert [b - a for a, b in zip(c0, c1)] == [b - a for a, b in
                                                zip(c2, counts())]
    # the traceback: K4 (top-n) or the finish pass
    assert c1[0] > c0[0] and c1[2] + c1[5] > c0[2] + c0[5]
    assert c1[3] > c0[3] and c1[4] > c0[4]
    for got, ref in ((first, run(eager, batches[0], lens)), (second, want)):
        for (j, f, a), (_, _, b) in zip(_fields(got), _fields(ref)):
            assert a.device == b.device
            assert torch.equal(a, b), (path, j, f)
    mapped = (second if hasattr(second, "_fields") else second[0]).mapped
    assert int(mapped.sum()) >= 0.9 * mapped.numel()


# K5 and K6: the read front end and the candidate search

# (B, L, form, bs_cutoff): the main path's 100 and 150 bp batches and the
# 1000 bp one, canonical; two strands; bisulfite with and without a
# cutoff; a batch whose L is k
FRONT_SHAPES = [(4096, 100, "canonical", 0), (4096, 150, "canonical", 0),
                (614, 1000, "canonical", 0), (4096, 100, "strands", 0),
                (4096, 100, "bisulfite", 0), (4096, 100, "bisulfite", 3),
                (37, 13, "strands", 0)]


@pytest.mark.parametrize("B,L,form,cutoff", FRONT_SHAPES)
def test_read_kmers_kernel_equals_plain(dev, B, L, form, cutoff):
    from nextgenmap_tpu_torch.ops.kmer_kernel import read_kmers_plain

    g, runs = front_genome(200_000, seed=L)
    codes, lens = front_reads(g, B, L, runs=runs if L >= 100 else (),
                              seed=B + L, bisulfite=form == "bisulfite")
    r, n = torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev)
    kw = dict(k=13, stride=2, bs=form == "bisulfite", bs_cutoff=cutoff,
              canonical=form == "canonical")
    before = read_kmers.launches
    got = read_kmers(r, n, **kw)
    torch.cuda.synchronize()
    assert read_kmers.launches == before + 1
    want = read_kmers_plain(r, n, **kw)
    for a, b in zip([got[0], *got[1]], [want[0], *want[1]]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert bool(got[1][-1].any()) and not bool(got[1][-1].all())


def _front_tables(dev, g, bisulfite, packed, k=13):
    """(offsets, positions) of `g` built on the card as the Mapper builds
    them: the canonical table, or the two collapsed ones; packed or plain
    CSR."""
    from nextgenmap_tpu_torch.index.device_build import (
        build_index_device, concat_tables,
    )
    from nextgenmap_tpu_torch.ops.candidate import pack_offsets

    gd = torch.from_numpy(g).to(dev)
    if bisulfite:
        off, pos = concat_tables(
            *build_index_device(gd, k=k, skip=1, collapse="ct",
                                canonical=False),
            *build_index_device(gd, k=k, skip=1, collapse="ga",
                                canonical=False))
    else:
        off, pos = build_index_device(gd, k=k, skip=1)
    return (pack_offsets(off, 1000, 32) if packed else off), pos


def _cand_plain(kms, lens, off, pos, sens, **kw):
    from nextgenmap_tpu_torch.ops.candidate import (
        candidate_search_canonical, candidate_search_dual,
    )

    kw = dict(kw)
    k, dual_tables = kw.pop("k"), kw.pop("dual_tables")
    if len(kms) == 4:
        return candidate_search_dual(*kms, off, pos, sens, 1000,
                                     dual_tables=dual_tables, **kw)
    return candidate_search_canonical(*kms, lens, off, pos, sens, 1000, k=k,
                                      **kw)


def _check_cand_search(dev, B, L, form, packed, H, C, size, route):
    """K6 against the plain version on read_kmers' k-mers of front_reads
    on front_genome; returns K6's Candidates, or None where the named
    route cannot take the shape (and the plan refuses it)."""
    from nextgenmap_tpu_torch.ops.candidate_kernel import plan

    bs = form == "bisulfite"
    g, runs = front_genome(size, seed=7)
    off, pos = _front_tables(dev, g, bs, packed)
    codes, lens = front_reads(g, B, L, runs=runs, seed=H, bisulfite=bs)
    r, n = torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev)
    _, kms = read_kmers(r, n, k=13, stride=2, bs=bs,
                        canonical=form == "canonical")
    Q, dual = kms[0].shape[1], len(kms) == 4
    assert plan(B, Q, dual, H).route == ("global" if H > 8192 else "smem")
    if route == "smem" and H > 8192:
        with pytest.raises(ValueError, match="cannot take"):
            plan(B, Q, dual, H, route)
        return None
    sens = torch.tensor(0.5, dtype=torch.float32, device=dev)
    kw = dict(k=13, fanout_cap=32, hit_cap=H, max_cmrs=C, diag_bin_log2=4,
              stride=2, packed_offsets=packed, dual_tables=bs)
    before = candidate_search.launches
    got = candidate_search(kms, n, off, pos, sens, 1000, route=route, **kw)
    torch.cuda.synchronize()
    assert candidate_search.launches == before + 1
    want = _cand_plain(kms, n, off, pos, sens, **kw)
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    valid = got.score > 0
    assert set(got.strand[valid].tolist()) == {0, 1}
    if not bs:      # the reads at positions 1..k
        assert bool((got.bucket[valid] < 0).any())
    return got


# (B, L, form, packed, H, genome size): the bench's 4.6 Mbp packed input
# at H 128, plain CSR, 1000 bp at H 1280, bisulfite dual with two tables
# at the collapsed ceiling 4608, and an H past the smem route (8200)
CS_SHAPES = [(4096, 100, "canonical", True, 128, 4_600_000),
             (4096, 100, "canonical", False, 128, 1_000_000),
             (614, 1000, "canonical", True, 1280, 1_000_000),
             (1024, 100, "bisulfite", True, 4608, 1_000_000),
             (512, 100, "strands", False, 8200, 1_000_000)]


@pytest.mark.parametrize("route", [None, "smem", "global"])
@pytest.mark.parametrize("B,L,form,packed,H,size", CS_SHAPES)
def test_cand_search_kernel_equals_plain(dev, B, L, form, packed, H, size,
                                         route):
    _check_cand_search(dev, B, L, form, packed, H, 32, size, route)


@pytest.mark.parametrize("route", ["smem", "global"])
@pytest.mark.parametrize("form", ["canonical", "bisulfite"])
def test_cand_search_kernel_counters(dev, form, route):
    """The tandem-repeat read moves all three overflow counters (C = 2)."""
    got = _check_cand_search(dev, 64, 100, form, True, 128, 2, 1_000_000,
                             route)
    assert int(got.fanout_overflow) > 0 and int(got.hit_overflow) > 0
    assert int(got.cmr_overflow) > 0


def test_cand_search_plan_is_the_launch(dev):
    """The plan reports what K6 launches: a warp a read and 4 reads a
    block at H 128, 128 and 256 threads at larger H, the smem route up to
    what a block holds, the global route past it with its scratch; the
    library launches only the plan's block, and refuses a scratch smaller
    than the plan's."""
    from nextgenmap_tpu_torch.native import build
    from nextgenmap_tpu_torch.ops.candidate_kernel import ROUTES, plan

    main = plan(4096, 44, False, 128)
    assert (main.route, main.threads, main.reads, main.np) == ("smem", 32, 4,
                                                               256)
    assert main.blocks == 1024 and main.scratch == 0
    assert plan(614, 494, False, 1280).threads == 128
    big = plan(1024, 44, True, 4608)
    assert big.route == "smem" and big.threads == 256 and big.np == 16384
    assert big.smem_bytes <= big.smem_limit
    past = plan(512, 44, True, 8200)
    assert past.route == "global" and past.np == 32768
    assert past.scratch == 2 * past.np * past.blocks
    glob = plan(4096, 44, False, 128, "global")
    assert glob.route == "global" and glob.reads == 1
    assert glob.scratch == 2 * 256 * glob.blocks

    B, Q, H = 8, 10, 16
    km = torch.zeros((B, Q), dtype=torch.int32, device=dev)
    ok = torch.ones((B, Q), dtype=torch.bool, device=dev)
    lens = torch.full((B,), 30, dtype=torch.int32, device=dev)
    off = torch.zeros(17, dtype=torch.int32, device=dev)
    pos = torch.zeros(4, dtype=torch.int32, device=dev)
    sens = torch.tensor(0.5, dtype=torch.float32, device=dev)
    out = torch.empty((3, B, 2), dtype=torch.int32, device=dev)
    per = torch.empty((2, B), dtype=torch.int32, device=dev)
    cnt = torch.empty(3, dtype=torch.int32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream

    def launch(route, threads, scratch=None, n=0):
        return lib.ngm_cand_search(
            km.data_ptr(), km.data_ptr(), ok.data_ptr(), None,
            lens.data_ptr(), off.data_ptr(), 17, pos.data_ptr(), 4,
            sens.data_ptr(), B, Q, 0, 3, 1, 4, H, 2, 4, 10, 0, 0,
            ROUTES.index(route), threads, scratch, n, out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), per[0].data_ptr(),
            per[1].data_ptr(), cnt.data_ptr(), stream)

    p = plan(B, Q, False, H)
    assert launch("smem", p.threads) == 0
    for threads in (p.threads * 2, 0):
        assert launch("smem", threads) != 0
    g = plan(B, Q, False, H, "global")
    scratch = torch.empty(g.scratch, dtype=torch.int32, device=dev)
    assert launch("global", g.threads) != 0           # no scratch
    assert launch("global", g.threads, scratch.data_ptr(), g.scratch - 1) != 0
    assert launch("global", g.threads, scratch.data_ptr(), g.scratch) == 0
    torch.cuda.synchronize()
    assert int(cnt.sum()) == 0 and int(per[0].sum()) == 0


def test_cand_search_plans_of_two_sizes(dev):
    """A plan for a smaller H past 48 KB of shared memory (the same kernel
    instance, 256 threads a read) leaves an earlier, larger one
    launchable, and both equal the plain version."""
    from nextgenmap_tpu_torch.ops.candidate_kernel import plan

    rng = np.random.default_rng(3)
    B, Q = 8, 44
    km = torch.from_numpy(rng.integers(0, 16, (B, Q)).astype(np.int32))
    ok = torch.from_numpy(rng.random((B, Q)) < 0.9)
    off = torch.from_numpy(np.arange(17, dtype=np.int32) * 3)
    pos = torch.from_numpy(rng.integers(0, 5000, 51).astype(np.int32))
    lens = torch.full((B,), 100, dtype=torch.int32)
    sens = torch.tensor(0.5, dtype=torch.float32)
    kms = (km, ok, km.flip(1).contiguous(), ok.flip(1).contiguous())
    kw = dict(k=13, fanout_cap=32, max_cmrs=32, diag_bin_log2=4, stride=2)
    for H in (4608, 2100, 4608):
        assert plan(B, Q, True, H).smem_bytes > 48 * 1024
        got = candidate_search(tuple(t.to(dev) for t in kms), lens.to(dev),
                               off.to(dev), pos.to(dev), sens.to(dev), 1000,
                               hit_cap=H, **kw)
        want = candidate_search(kms, lens, off, pos, sens, 1000, hit_cap=H,
                                **kw)
        for f in want._fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def test_front_kernels_in_a_captured_graph(dev):
    """K5 then K6 captured in one CUDA graph, replayed on new reads: the
    same outputs as the eager calls, and the counters zeroed by the
    graph's own memset at each replay."""
    g, runs = front_genome(1_000_000, seed=7)
    off, pos = _front_tables(dev, g, False, True)
    batches = [front_reads(g, 1024, 100, runs=runs, seed=31 + i)
               for i in range(2)]
    r = torch.from_numpy(batches[0][0]).to(dev)
    n = torch.from_numpy(batches[0][1]).to(dev)
    sens = torch.tensor(0.5, dtype=torch.float32, device=dev)

    def step():
        _, kms = read_kmers(r, n, k=13, stride=2)
        c = candidate_search(kms, n, off, pos, sens, 1000, k=13,
                             fanout_cap=32, hit_cap=128, max_cmrs=32,
                             diag_bin_log2=4, stride=2, packed_offsets=True)
        return [*kms, *c]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for codes, lens in batches + batches[:1]:
        r.copy_(torch.from_numpy(codes))
        n.copy_(torch.from_numpy(lens))
        graph.replay()
        torch.cuda.synchronize()
        want = step()
        for a, b in zip(out, want):
            assert torch.equal(a, b)
    assert int(out[-4]) > 0     # fanout_overflow, not summed over replays
