"""The port's CUDA kernels against their plain PyTorch versions, on the card
(K1 in local and glocal mode), and the single-end, paired and top-n steps,
also under --end-to-end and --bs-mapping, on the card against the CPU.

K1 is checked at every band width that crosses a boundary of its (lanes per
alignment, cells per lane) templates, with S not a multiple of the
alignments per warp, qlen 0, 1, L and > L, 1 to 8 matrices, invalid all-4
slots, tie-heavy periodic inputs (many cells share the maximum, so the
deferred argmax must pick the first in (i, o)), and matrices large enough
that the kernel keeps (value, o) unpacked.  K2 is checked at T around the
16-byte store width, at starts 0, G - T, G - 1, G and beyond, and on a
genome of more than 2^31 bytes.  The index-shard loop (single, paired, the
cross-shard tail pool and top-n) runs on the card against the CPU, and so
do the dp step and the ("dp", "ish") grid on two and four slots of card 0;
with two cards or more, K1 and K2 run on tensors of the last card while
card 0 is current.

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
from nextgenmap_tpu_torch.ops.gather import gather_windows, pad_table
from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
from nextgenmap_tpu_torch.ops.row_gather import row_gather, row_gather_plain
from nextgenmap_tpu_torch.ops.scoring import score_matrix
from nextgenmap_tpu_torch.ops.sw_kernel import sw_score
from nextgenmap_tpu_torch.ops.sw_ref import banded_sw_score
from nextgenmap_tpu_torch.synthetic import (
    repeat_genome, simulate_long_reads, simulate_pairs, simulate_reads,
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


@pytest.mark.parametrize("dim,r,w,rep", [
    (1, 256, 1024, 32), (0, 256, 1024, 32), (1, 3, 5, 9), (0, 5, 3, 11),
    (1, 4, 20_000, 3), (0, 300, 77, 0),
])
def test_row_gather_kernel_equals_plain(dev, dim, r, w, rep):
    rng = np.random.default_rng(r + w + dim)
    x = torch.from_numpy(
        rng.integers(-(1 << 30), 1 << 30, (r, w), dtype=np.int32)).to(dev)
    idx = torch.from_numpy(
        rng.integers(-3 * w, 3 * w, (r, w), dtype=np.int32)).to(dev)
    before = row_gather.launches
    got = row_gather(x, idx, rep, dim)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert torch.equal(got, row_gather_plain(x, idx, rep, dim))


def _mappers(dev, cfg, g, read_len=100):
    class _G:
        codes = g

    gpu = Mapper(cfg, _G(), read_len, device=dev)
    index = (gpu.state.offsets.cpu().numpy(), gpu.state.positions.cpu().numpy())
    return gpu, Mapper(cfg, _G(), read_len, index, device="cpu")


def test_paired_and_topn_cuda_equal_cpu(dev):
    """Both new paths launch K1 and K2 on the card and equal the CPU."""
    g = repeat_genome(60_000, n_repeats=12, min_len=800, max_len=2000, seed=7)
    lens = np.full(256, 100, np.int32)
    gpu, cpu = _mappers(dev, NgmConfig(kmer=11, topn=2), g)

    codes, _, _ = simulate_pairs(g, 128, 100, 0.02, seed=8)
    launches = (sw_score.launches, gather_genome_windows.launches)
    a = gpu.map_batch_paired(codes, lens)
    torch.cuda.synchronize()
    assert sw_score.launches == launches[0] + 1
    assert gather_genome_windows.launches == launches[1] + 2
    b = cpu.map_batch_paired(codes, lens)
    for f in a._fields:
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    assert int(b.proper.sum()) > 200

    codes, _, _ = simulate_reads(g, 256, 100, 0.02, seed=9)
    launches = (sw_score.launches, gather_genome_windows.launches)
    a = gpu.map_batch_topn(codes, lens)
    torch.cuda.synchronize()
    assert sw_score.launches == launches[0] + 1
    assert gather_genome_windows.launches == launches[1] + 2
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
    launch K1 and K2 on the card and equal the CPU from the same state."""
    g = repeat_genome(60_000, n_repeats=12, min_len=800, max_len=2000, seed=10)
    gpu, cpu = _mappers(dev, NgmConfig(kmer=11, topn=2).replace(**change), g,
                        read_len)
    B = 256 if read_len == 100 else 64
    lens = np.full(B, read_len, np.int32)
    codes, _, _ = simulate_long_reads(g, B, read_len, 0.02, 0.004, seed=11)
    for step in ("map_batch", "map_batch_paired", "map_batch_topn"):
        launches = (sw_score.launches, gather_genome_windows.launches)
        a = getattr(gpu, step)(codes, lens)
        torch.cuda.synchronize()
        assert sw_score.launches == launches[0] + 1
        assert gather_genome_windows.launches == launches[1] + 2
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
    ShardedIndex: full per-shard tails launch K1 once and K2 twice per
    shard, the cross-shard pool (512 rows < 3 x 256) once and twice in all,
    top-n once and twice per shard."""
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

    launches = (sw_score.launches, gather_genome_windows.launches)
    a = run(gpu)
    torch.cuda.synchronize()
    n = 1 if compact_cap else 3
    assert sw_score.launches == launches[0] + n
    assert gather_genome_windows.launches == launches[1] + 2 * n
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
    """--devices on the slots [cuda:0] x 2 (the dp step, the slices in
    turn) and [cuda:0] x 4 with 2 shards (the
    ("dp", "ish") grid) equal the CPU's one-device run, with K1 and K2
    launched once and twice per slice and shard."""
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
        launches = (sw_score.launches, gather_genome_windows.launches)
        a = getattr(gpu, step)(codes, lens)
        torch.cuda.synchronize()
        n = 2 * shards
        assert sw_score.launches == launches[0] + n
        assert gather_genome_windows.launches == launches[1] + 2 * n
        b = getattr(cpu, step)(codes, lens)
        for f in a._fields:
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), (step, f)
