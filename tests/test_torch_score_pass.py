"""The score pass (ops/score_pass_kernel.py): its plain version on the CPU,
and the fused pass (csrc/sw_score.cu: score_plan_kernel, then
score_pass_kernel or score_pass_block_kernel) on the card against it.

On the CPU:
  * the plain pass equals a read-by-read loop that scores each masked
    read's candidates one alignment at a time, in read order, until the
    slots run out (a read straddling the cap keeps its first ones), under
    the single, paired (per read, and one entry a pair, `pairs=True`) and
    top-n masks, with no real slot, fewer than the
    slots, exactly the slots and more, in local and glocal mode;
  * a Python transcription of score_plan_kernel (each thread a run of
    reads, a block-wide exclusive scan, the slot map) equals the plain
    pass's compaction (its searchsorted slot owners);
  * on CPU tensors the wrapper never loads the kernel library;
  * a mask whose length is not the form `pairs` names raises.
On the card (marked `cuda`, skipped without one): the fused pass equals the
plain pass in every output (sw, slot_overflow, n_sc, base) under the
masks, at each slot regime, local and glocal, one and two matrices (the
bisulfite msel), at bands that run every (lanes, cells) template of K1 and
the block form, with corridor starts unaligned, at G - T, past the genome's
end and below 0, and candidates that do not form a prefix; on a genome past
2^31 bases; inside a captured CUDA graph; and it launches only its own
kernels (score_pass.launches, no K1 or K2 launch).
Tolerance: exact equality (integer DP).
"""

import numpy as np
import pytest
import torch

from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.native import build
from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
from nextgenmap_tpu_torch.ops.score_pass_kernel import (
    score_pass, score_pass_plain,
)
from nextgenmap_tpu_torch.ops.scoring import score_matrix
from nextgenmap_tpu_torch.ops.sw_kernel import sw_score
from nextgenmap_tpu_torch.ops.sw_ref import banded_sw_score

GAPS = (20, 20, 20)
FIELDS = ("sw", "slot_overflow", "n_sc", "base")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(seed, B, L, C, W, *, G=20_000, n_mats=1, prefix=True,
              max_n=None):
    """A batch of reads and candidates: lengths from 0 to L, valid
    candidates a prefix of each row (or scattered), corridors at random
    starts (unaligned), a few at G - T, G - 1, G, past G and below 0, and
    every third valid candidate planted in the genome so that it scores
    high.  Returns a dict of CPU tensors."""
    rng = np.random.default_rng(seed)
    T = L + W
    genome = rng.integers(0, 4, G).astype(np.uint8)
    genome[rng.integers(0, G, G // 50)] = 4                 # Ns
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    rc = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[:4] = [L, 0, 1, L]
    n = rng.integers(0, (C if max_n is None else max_n) + 1, B)
    n[:4] = [C, 2, 3, 1]
    if prefix:
        valid = np.arange(C)[None, :] < n[:, None]
    else:
        valid = rng.random((B, C)) < 0.5
    strand = rng.integers(0, 2, (B, C)).astype(np.int32)
    start = rng.integers(0, G - T, (B, C)).astype(np.int64)
    start.flat[:6] = [G - T, G - T + 5, G - 1, G, G + 9, -7]
    for b, j in zip(*np.nonzero(valid)):
        if (b + j) % 3 == 0 and 0 <= start[b, j] <= G - T:
            q = rc[b] if strand[b, j] == 1 else reads[b]
            o = int(start[b, j]) + int(rng.integers(0, W))
            m = min(int(lengths[b]), G - o)
            genome[o:o + m] = q[:m]
    cfg = NgmConfig(bs_mapping=n_mats == 2)
    mats = np.stack([score_matrix(cfg, i) for i in range(n_mats)])
    t = torch.from_numpy
    return dict(genome=t(genome), reads=t(reads), rc=t(rc),
                lengths=t(lengths), corr_start=t(start.astype(np.int32)),
                strand=t(strand), cand_valid=t(valid), n=n,
                matrices=t(mats.astype(np.int32)))


def mask_of(kind, n_cands):
    """The score mask of the single (>= 2 candidates), paired (either mate
    >= 2; "pairs": the same as one entry a pair, the paired step's form)
    and top-n (every read) passes."""
    n = torch.as_tensor(n_cands)
    if kind == "single":
        return n >= 2
    if kind == "pairs":
        return n.reshape(-1, 2).amax(dim=1) >= 2
    if kind == "paired":
        return (n.reshape(-1, 2) >= 2).any(dim=1).repeat_interleave(2)
    return torch.ones(n.shape[0], dtype=torch.bool)


def per_read(mask, B):
    """A pair mask ([B / 2]) as the [B] mask of its rows."""
    return mask.repeat_interleave(2) if mask.shape[0] != B else mask


def slot_cap(regime, case, mask):
    """S for the regime: 'none' (no read masked), 'below' (S past the
    total), 'at' (S the total) or 'above' (S inside a read's slots, with
    that read straddling the cap)."""
    mask = per_read(mask, case["reads"].shape[0])
    eff = (case["cand_valid"] & mask[:, None]).sum(dim=1).numpy()
    total = int(eff.sum())
    if regime == "below":
        return total + 37
    if regime == "at":
        return total
    if regime == "above":
        end = np.cumsum(eff)
        b = int(np.flatnonzero(eff >= 2)[len(np.flatnonzero(eff >= 2)) // 2])
        return int(end[b]) - 1          # read b keeps all but its last
    return 64


def run(fn, case, mask, S, W, mode, device="cpu"):
    keys = ("genome", "reads", "rc", "lengths", "corr_start", "strand",
            "cand_valid")
    args = [case[k].to(device) for k in keys]
    # a [B / 2] mask is the pair form, which the wrapper is told of
    kw = {"pairs": mask.shape[0] != args[1].shape[0]}
    if fn is score_pass_plain:          # the plain pass takes a [B] mask
        mask, kw = per_read(mask, args[1].shape[0]), {}
    return fn(*args, mask.to(device), case["matrices"].to(device), *GAPS,
              band=W, slot_cap=S, mode=mode, **kw)


def loop_reference(case, mask, S, W, mode):
    """Read by read, candidate by candidate, one alignment at a time: the
    pass's meaning, written apart from its compaction."""
    B, L = case["reads"].shape
    C = case["corr_start"].shape[1]
    G = case["genome"].shape[0]
    T = L + W
    mask = per_read(mask, B)
    padded = torch.cat([case["genome"],
                        torch.full((T,), 4, dtype=torch.uint8)])
    sw = torch.zeros((B, C), dtype=torch.int32)
    used = 0
    for b in range(B):
        if not mask[b]:
            continue
        n_b = int(case["cand_valid"][b].sum())
        for j in range(n_b):           # slot base + j scores column j
            if used >= S:
                break
            used += 1
            if not case["cand_valid"][b, j]:
                continue
            st = int(case["strand"][b, j])
            s = min(max(int(case["corr_start"][b, j]), 0), G)
            q = (case["rc"] if st == 1 else case["reads"])[b:b + 1]
            r = padded[s:s + T][None]
            res = banded_sw_score(
                q, case["lengths"][b:b + 1], r, case["matrices"], *GAPS,
                torch.tensor([st], dtype=torch.int32), band=W, mode=mode)
            sw[b, j] = res.score[0]
    total = int((case["cand_valid"] & mask[:, None]).sum())
    return sw, int(total > S)


@pytest.mark.parametrize("mode", ["local", "glocal"])
@pytest.mark.parametrize("regime", ["none", "below", "at", "above"])
@pytest.mark.parametrize("kind", ["single", "paired", "pairs", "topn"])
def test_plain_pass_equals_a_loop_over_reads(kind, regime, mode):
    W = 16
    case = make_case(11, 24, 30, 6, W, G=3_000, n_mats=2)
    mask = (torch.zeros(24, dtype=torch.bool) if regime == "none"
            else mask_of(kind, case["n"]))
    S = slot_cap(regime, case, mask)
    got = run(score_pass, case, mask, S, W, mode)
    want_sw, want_ovf = loop_reference(case, mask, S, W, mode)
    assert torch.equal(got.sw, want_sw)
    assert int(got.slot_overflow) == want_ovf
    assert got.slot_overflow.shape == () and got.sw.dtype == torch.int32
    rows = per_read(mask, 24)
    eff = (case["cand_valid"] & rows[:, None]).sum(dim=1, dtype=torch.int32)
    assert torch.equal(got.n_sc, eff)
    assert torch.equal(got.base, torch.cumsum(eff, 0, dtype=torch.int32) - eff)
    if regime == "above":
        assert want_ovf == 1 and int((want_sw > 0).sum()) > 0
    if regime == "none":
        assert not want_sw.any()


def plan_transcription(cand_valid, score_mask, S, threads=1024, per=1):
    """score_plan_kernel's block 0 in Python: in rounds of threads x per
    reads, thread t counts the reads [r0 + per t, r0 + per t + per) (the
    kernel: one read a thread), an exclusive scan of the threads' sums plus
    the rounds before gives each thread's first slot, and each read's slots
    map to b * C + r."""
    B, C = cand_valid.shape
    valid = cand_valid.numpy()
    mask = score_mask.numpy()
    n_sc = np.zeros(B, np.int64)
    base = np.zeros(B, np.int64)
    slot_flat = np.full(S, -1, np.int64)
    carry = 0
    for r0 in range(0, B, threads * per):
        sums = np.zeros(threads, np.int64)
        for t in range(threads):
            for b in range(r0 + t * per, min(r0 + t * per + per, B)):
                n_sc[b] = valid[b].sum() if mask[b] else 0
                sums[t] += n_sc[b]
        first = carry + np.cumsum(sums) - sums
        for t in range(threads):
            run_ = int(first[t])
            for b in range(r0 + t * per, min(r0 + t * per + per, B)):
                base[b] = run_
                for r in range(int(n_sc[b])):
                    if run_ + r >= S:
                        break
                    slot_flat[run_ + r] = b * C + r
                run_ += int(n_sc[b])
        carry += int(sums.sum())
    return n_sc, base, slot_flat, carry, int(carry > S)


@pytest.mark.parametrize("B,C,threads,per,regime", [
    (4096, 32, 1024, 1, "above"), (300, 7, 1024, 1, "below"),
    (3000, 8, 64, 1, "at"), (1000, 5, 32, 1, "above"),
    (9000, 4, 1024, 1, "above"), (4096, 32, 1024, 4, "above"),
])
def test_plan_transcription_equals_the_plain_compaction(B, C, threads, per,
                                                        regime):
    rng = np.random.default_rng(B + C)
    n = rng.integers(0, C + 1, B)
    valid = torch.from_numpy(np.arange(C)[None, :] < n[:, None])
    mask = torch.from_numpy(rng.random(B) < 0.6)
    eff = (valid & mask[:, None]).sum(dim=1)
    total = int(eff.sum())
    S = {"above": total // 2, "below": total + 5, "at": total}[regime]
    n_sc, base, slot_flat, t_total, ovf = plan_transcription(valid, mask, S,
                                                             threads, per)
    # the plain pass's compaction (ops/score_pass_kernel.py)
    base_p = torch.cumsum(eff, 0) - eff
    sar = torch.arange(S)
    b_of = torch.searchsorted(base_p, sar, right=True) - 1
    live = sar < min(total, S)
    flat = torch.where(live, b_of * C + sar - base_p[b_of], -1)
    assert np.array_equal(n_sc, eff.numpy())
    assert np.array_equal(base, base_p.numpy())
    assert np.array_equal(slot_flat, flat.numpy())
    assert t_total == total and ovf == int(total > S)


def test_cpu_pass_loads_no_library(monkeypatch):
    def no_library():
        raise AssertionError("the plain pass loaded the kernel library")

    monkeypatch.setattr(build, "load", no_library)
    case = make_case(3, 16, 30, 4, 16, G=2_000)
    mask = mask_of("single", case["n"])
    before = score_pass.launches
    got = run(score_pass, case, mask, 20, 16, "local")
    assert score_pass.launches == before
    want = run(score_pass_plain, case, mask, 20, 16, "local")
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("form", ["pairs_unsaid", "reads_as_pairs",
                                  "odd_batch"])
def test_mask_form_is_explicit(form):
    """The mask's form is the caller's `pairs`, never read from its shape:
    a mask of the other form's length, or pairs of an odd batch, raise."""
    keys = ("genome", "reads", "rc", "lengths", "corr_start", "strand",
            "cand_valid")
    B = 15 if form == "odd_batch" else 16
    case = make_case(4, B, 30, 4, 16, G=2_000)
    n = torch.as_tensor(case["n"])
    single = mask_of("single", n)
    if form == "pairs_unsaid":
        mask, pairs = mask_of("pairs", n), False
    else:
        mask, pairs = (single if form == "reads_as_pairs"
                       else single[:B // 2]), True
    with pytest.raises(ValueError, match="pairs"):
        score_pass(*(case[k] for k in keys), mask, case["matrices"], *GAPS,
                   band=16, slot_cap=20, pairs=pairs)


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the fused pass runs only there")
    return torch.device("cuda")


def assert_same(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.shape == b.shape, f
        assert torch.equal(a.cpu(), b.cpu()), f


def launches():
    return (score_pass.launches, sw_score.launches,
            gather_genome_windows.launches)


# bands on each side of K1's (lanes, cells) template boundaries, and the
# block form past 512
CARD_BANDS = [16, 32, 48, 56, 96, 128, 184, 256, 264, 488, 520]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["local", "glocal"])
@pytest.mark.parametrize("W", CARD_BANDS)
def test_fused_pass_bands(dev, W, mode):
    L = 150 if W <= 264 else 200
    B = 256 if W <= 264 else 64
    case = make_case(W, B, L, 8, W, n_mats=2)
    for kind in ("single", "paired", "pairs", "topn"):
        mask = mask_of(kind, case["n"])
        for regime in ("below", "above"):
            S = slot_cap(regime, case, mask)
            c0 = launches()
            got = run(score_pass, case, mask, S, W, mode, dev)
            torch.cuda.synchronize()
            assert launches() == (c0[0] + 1, c0[1], c0[2])
            # the former card path: K2, K1 and the torch compaction
            assert_same(got, run(score_pass_plain, case, mask, S, W, mode,
                                 dev))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["local", "glocal"])
@pytest.mark.parametrize("regime", ["none", "below", "at", "above"])
@pytest.mark.parametrize("kind", ["single", "pairs", "topn"])
def test_fused_pass_main_path(dev, kind, regime, mode):
    """The main path's shape: 4096 reads of 150, C 32, W 56, one matrix;
    slot caps around the real slots, and S = 2048."""
    case = make_case(7, 4096, 150, 32, 56, G=400_000, max_n=4)
    mask = (torch.zeros(4096, dtype=torch.bool) if regime == "none"
            else mask_of(kind, case["n"]))
    S = 2048 if regime == "none" else slot_cap(regime, case, mask)
    got = run(score_pass, case, mask, S, 56, mode, dev)
    want = run(score_pass_plain, case, mask, S, 56, mode, dev)   # K2 + K1
    assert_same(got, want)
    if S <= 4096:
        assert_same(got, run(score_pass_plain, case, mask, S, 56, mode))


@pytest.mark.cuda
def test_fused_pass_scattered_candidates(dev):
    """Valid candidates that do not form a prefix: slot base + j still
    scores column j, which lands only where it is valid."""
    case = make_case(5, 512, 100, 10, 48, prefix=False, n_mats=2)
    for kind in ("single", "topn"):
        mask = mask_of(kind, case["cand_valid"].sum(dim=1).numpy())
        for S in (slot_cap("below", case, mask),
                  slot_cap("above", case, mask)):
            assert_same(run(score_pass, case, mask, S, 48, "local", dev),
                        run(score_pass_plain, case, mask, S, 48, "local"))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [56, 520])
def test_fused_pass_genome_past_2_31(dev, W):
    """A genome of more than 2^31 bases: corridors that start below 2^31
    and reach past it, and corridors at the end."""
    G = (1 << 31) + 4096
    L, B, C = 150, 64, 4
    g = torch.arange(G, dtype=torch.int64, device=dev).remainder_(5).to(
        torch.uint8)
    case = make_case(W + 1, B, L, C, W, G=5_000)
    top = (1 << 31) - 1
    T = L + W
    starts = np.array([0, top - T, top - 1, top, 12345, top - 2 * T + 7,
                       top - T // 2, top - 3], np.int64)
    start = np.resize(starts, B * C).reshape(B, C).astype(np.int32)
    case["corr_start"] = torch.from_numpy(start)
    case = {k: (v.to(dev) if torch.is_tensor(v) else v)
            for k, v in case.items()}
    case["genome"] = g
    mask = mask_of("topn", case["n"]).to(dev)
    S = 2 * B
    got = run(score_pass, case, mask, S, W, "local", dev)
    want = run(score_pass_plain, case, mask, S, W, "local", dev)  # K2 + K1
    assert_same(got, want)
    assert int(got.sw.max()) > 0


@pytest.mark.cuda
def test_fused_pass_in_a_captured_graph(dev):
    """Captured once, replayed on new contents of the same input buffers:
    each replay equals the plain pass on those contents."""
    W, S = 56, 300
    cases = [make_case(40 + i, 512, 150, 8, W, G=50_000) for i in range(3)]
    keys = ("genome", "reads", "rc", "lengths", "corr_start", "strand",
            "cand_valid")
    static = {k: cases[0][k].to(dev) for k in keys}
    static["mask"] = mask_of("single", cases[0]["n"]).to(dev)
    mats = cases[0]["matrices"].to(dev)

    def step():
        return score_pass(*(static[k] for k in keys), static["mask"], mats,
                          *GAPS, band=W, slot_cap=S)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()                                  # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    c0 = launches()
    with torch.cuda.graph(graph):
        out = step()
    assert launches() == (c0[0] + 1, c0[1], c0[2])
    for case in cases[1:] + cases[:1]:
        for k in keys:
            static[k].copy_(case[k])
        mask = mask_of("single", case["n"])
        static["mask"].copy_(mask)
        graph.replay()
        torch.cuda.synchronize()
        assert_same(out, run(score_pass_plain, case, mask, S, W, "local"))


@pytest.mark.cuda
def test_fused_pass_refuses(dev):
    """A wrong dtype, shape, layout or device, or a band past K1's, raises
    before any launch."""
    keys = ("genome", "reads", "rc", "lengths", "corr_start", "strand",
            "cand_valid")
    case = make_case(2, 32, 50, 4, 16, G=2_000)
    good = {k: case[k].to(dev) for k in keys}
    mask = mask_of("single", case["n"]).to(dev)
    mats = case["matrices"].to(dev)
    bad = [("reads", good["reads"][:, :40]),           # not [B, L] with rc
           ("strand", good["strand"].to(torch.int64)),
           ("cand_valid", good["cand_valid"].to(torch.uint8)),
           ("corr_start", good["corr_start"].t().contiguous().t()),
           ("lengths", good["lengths"].cpu()),
           ("genome", good["genome"][None])]
    before = score_pass.launches
    for name, t in bad:
        args = dict(good, **{name: t})
        with pytest.raises(ValueError):
            score_pass(*(args[k] for k in keys), mask, mats, *GAPS, band=16,
                       slot_cap=20)
    with pytest.raises(ValueError):
        score_pass(*(good[k] for k in keys), mask, mats, *GAPS, band=8193,
                   slot_cap=20)
    assert score_pass.launches == before
