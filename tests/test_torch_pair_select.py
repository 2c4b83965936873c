"""The pair select (ops/pair_kernel.py): its plain version on the CPU,
and the kernel (csrc/pair_select.cu) on the card against it.

On the CPU:
  * pair_select_plain on hand-built pairs with known answers: equal pair
    sums at several (c1, c2), the first in c1 then c2 order taken (ROADMAP
    C5); a best pair sum exactly at pair_cutoff x (best1 + best2) in
    float32, which float64 would break (C6); no valid combination; single
    x single; a mate with no candidate; reversed strands on either side of
    fwd_left's margin; the span at both insert limits;
  * on CPU tensors pair_select is pair_select_plain and loads no library;
  * its counters, and a traced map_step_paired's `pairs_gridded` and
    `pairs_broken`, equal the sums over the pairs.
On the card (marked `cuda`, skipped without one): the kernel equals the
plain version field by field on random pairs (with int32 extremes) and on
the hand-built ones, at C 1, 8, 32, 33, 64 and P 1, 7, 2048; inside a
captured graph; with its counters; it refuses wrong inputs before any
launch; a whole map_step_paired equals the same step with the plain
version on the card; and a traced paired replay runs exactly one device
record, the kernel, between each step's `score` and `select` marks.
This file imports no JAX, so it runs on the card too.  Tolerance: exact
equality (int32 arithmetic, one float32 product).
"""

import re

import numpy as np
import pytest
import torch

from nextgenmap_tpu_torch import synthetic
from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.models import mapper as tmapper
from nextgenmap_tpu_torch.native import build
from nextgenmap_tpu_torch.ops.pair_kernel import (
    Pairing, pair_select, pair_select_plain,
)
from nextgenmap_tpu_torch.utils import trace

L, SLACK, MARGIN = 100, 12, 32
MIN_INSERT, MAX_INSERT = 150, 500          # span in [118, 532]
LO, HI = MIN_INSERT - MARGIN, MAX_INSERT + MARGIN
MARK = re.compile(r"ngm_mark_kernel<(\d)>")


@pytest.fixture(autouse=True)
def one_thread_tracing_off_after():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    trace.disable()


class Pairs:
    """P pairs of C candidates a mate, none valid; `mate` fills one."""

    def __init__(self, P, C=4, cutoff=0.9):
        B = 2 * P
        self.sw = np.zeros((B, C), np.int32)
        self.corr = np.zeros((B, C), np.int32)
        self.strand = np.zeros((B, C), np.int32)
        self.valid = np.zeros((B, C), bool)
        self.n = np.zeros(B, np.int32)
        self.min_insert, self.max_insert = MIN_INSERT, MAX_INSERT
        self.cutoff = np.float32(cutoff)

    def mate(self, row, cands):
        """cands: [(column, score, position, strand)], valid; n_cands
        their count."""
        for c, s, p, st in cands:
            self.sw[row, c] = s
            self.corr[row, c] = p - SLACK      # so that pos = p
            self.strand[row, c] = st
            self.valid[row, c] = True
        self.n[row] = len(cands)
        return self

    def args(self, dev="cpu"):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        return (t(self.sw), t(self.corr), t(self.strand), t(self.valid),
                t(self.n),
                torch.tensor(self.min_insert, dtype=torch.int32, device=dev),
                torch.tensor(self.max_insert, dtype=torch.int32, device=dev),
                torch.tensor(self.cutoff, dtype=torch.float32, device=dev))


def run(fn, c: Pairs, dev="cpu", counters=None) -> Pairing:
    return fn(*c.args(dev), read_len=L, slack=SLACK, margin=MARGIN,
              counters=counters)


def verdict(res: Pairing):
    """[(a1 mate 1, a1 mate 2, proper)] a pair."""
    a1 = res.a1.reshape(-1, 2).tolist()
    pr = res.proper.reshape(-1, 2)
    assert torch.equal(pr[:, 0], pr[:, 1])
    return [(x, y, bool(p)) for (x, y), p in zip(a1, pr[:, 0].tolist())]


# ---- hand-built pairs -----------------------------------------------------
# each: (Pairs, [(a1 mate 1, a1 mate 2, proper)], (gridded, broken))

def case_ties():
    """Equal sums: at (1, 0), (1, 3), (2, 0), (2, 3) -> (1, 0); with
    c1 = 1 on mate 2's strand -> (2, 0); with mate 2's column 0 on mate
    1's strand too -> (2, 3)."""
    c = Pairs(3)
    for i in range(3):
        t1 = [0, 1 if i else 0, 0, 0]
        c.mate(2 * i, [(1, 50, 1000, t1[1]), (2, 50, 1000, 0)])
        c.mate(2 * i + 1, [(0, 60, 1250, 0 if i == 2 else 1),
                           (3, 60, 1250, 1)])
    return c, [(1, 0, True), (2, 0, True), (2, 3, True)], (3, 0)


def case_cutoff_exact():
    """best1 + best2 = 1000 (at column 0, same strands: no pair) and the
    one valid pair (1, 1) sums 300; float32(0.3) x 1000 rounds to 300.0 in
    float32 (proper) but is 300.0000119 in float64 (would break).  Pair 1
    sums 299: broken, each mate's best single (column 0)."""
    c = Pairs(2, cutoff=0.3)
    for i, s in enumerate((150, 149)):
        c.mate(2 * i, [(0, 500, 5000, 0), (1, s, 1000, 0)])
        c.mate(2 * i + 1, [(0, 500, 9000, 0), (1, 150, 1300, 1)])
    return c, [(1, 1, True), (0, 0, False)], (2, 1)


def case_no_valid():
    """Both mates multi, every combination fails (strands, insert, score
    <= 0): pair_best -1, the singles' first best columns (2 and 1; ties
    go to the lower column)."""
    c = Pairs(1)
    c.mate(0, [(0, 10, 1000, 0), (1, 0, 1000, 0), (2, 40, 1000, 0),
               (3, 40, 9000, 0)])
    c.mate(1, [(0, 30, 1000, 0), (1, 70, 1300, 0), (2, -5, 1300, 1),
               (3, 70, 99000, 1)])
    return c, [(2, 1, False)], (1, 1)


def case_single_single():
    """One candidate a mate, unscored (0): proper by geometry alone; then
    the same strands: not proper, candidate 0 each (all-zero rows)."""
    c = Pairs(2)
    c.mate(0, [(0, 0, 1000, 0)]).mate(1, [(0, 0, 1300, 1)])
    c.mate(2, [(0, 0, 1000, 0)]).mate(3, [(0, 0, 1300, 0)])
    return c, [(0, 0, True), (0, 0, False)], (0, 0)


def case_empty_mate():
    """Mate 1 without candidates: against a single mate 2 (not gridded,
    not proper) and against a multi one (gridded, broken); mate 2's
    singles then take its best column."""
    c = Pairs(2)
    c.mate(1, [(0, 0, 1300, 1)])
    c.mate(3, [(0, 20, 1300, 1), (1, 80, 1400, 1)])
    return c, [(0, 0, False), (0, 1, False)], (1, 1)


def case_fwd_left():
    """Singles on opposite strands, the forward mate right of the reverse
    one by exactly the margin (proper) and by margin + 1 (not), with the
    forward mate first and second."""
    c = Pairs(4)
    for i, (fwd_first, d) in enumerate(((True, MARGIN), (True, MARGIN + 1),
                                        (False, MARGIN),
                                        (False, MARGIN + 1))):
        fwd, rev = (1000 + d, 0), (1000, 1)
        m1, m2 = (fwd, rev) if fwd_first else (rev, fwd)
        c.mate(2 * i, [(0, 0, *m1)]).mate(2 * i + 1, [(0, 0, *m2)])
    return c, [(0, 0, True), (0, 0, False), (0, 0, True), (0, 0, False)], \
        (0, 0)


def case_insert_limits():
    """Forward mate left, span |p2 - p1| + L at LO, LO - 1, HI, HI + 1;
    then mate 2 multi, its pairable column at HI beside one at HI + 1 with
    a higher score."""
    c = Pairs(5)
    for i, span in enumerate((LO, LO - 1, HI, HI + 1)):
        c.mate(2 * i, [(0, 0, 1000, 0)])
        c.mate(2 * i + 1, [(0, 0, 1000 + span - L, 1)])
    c.mate(8, [(0, 90, 1000, 0)])
    c.mate(9, [(0, 95, 1000 + HI + 1 - L, 1), (1, 85, 1000 + HI - L, 1)])
    return c, [(0, 0, True), (0, 0, False), (0, 0, True), (0, 0, False),
               (0, 1, True)], (1, 0)


CASES = {f.__name__[5:]: f for f in (
    case_ties, case_cutoff_exact, case_no_valid, case_single_single,
    case_empty_mate, case_fwd_left, case_insert_limits)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_hand_built(name):
    c, want, (gridded, broken) = CASES[name]()
    counters = torch.zeros(2, dtype=torch.int64)
    got = run(pair_select_plain, c, counters=counters)
    assert got.a1.dtype == torch.int64 and got.proper.dtype == torch.bool
    assert verdict(got) == want
    assert counters.tolist() == [gridded, broken]


def test_cutoff_is_float32():
    """The exact-cutoff case breaks if the product is taken in float64:
    the test above holds the float32 rule, not a coincidence."""
    assert np.float32(0.3) * np.float32(1000) == np.float32(300)
    assert float(np.float32(0.3)) * 1000 > 300


def test_cpu_pair_select_loads_no_library(monkeypatch):
    def no_library():
        raise AssertionError("the plain pair select loaded the kernel "
                             "library")

    monkeypatch.setattr(build, "load", no_library)
    c, want, _ = case_ties()
    before = pair_select.launches
    got = run(pair_select, c)
    assert pair_select.launches == before
    assert verdict(got) == want
    plain = run(pair_select_plain, c)
    assert torch.equal(got.a1, plain.a1)
    assert torch.equal(got.proper, plain.proper)


class _G:
    codes = synthetic.repeat_genome(50_000, n_repeats=12, min_len=800,
                                    max_len=2000, seed=231)


def test_traced_step_counts_the_pairs(monkeypatch):
    """A traced map_step_paired on the CPU: `pairs_gridded` and
    `pairs_broken` equal the sums over the pairs its pair select saw, and
    some pairs are gridded and some of those broken (the first 16 pairs
    take the second mate of another pair)."""
    seen = []

    def spy(*a, **k):
        res = pair_select(*a, **k)
        seen.append((a[4].clone(), res.proper.clone()))
        return res

    monkeypatch.setattr(tmapper, "pair_select", spy)
    m = tmapper.Mapper(NgmConfig(kmer=11), _G(), L, device="cpu")
    codes, _, _ = synthetic.simulate_pairs(_G.codes, 64, L, 0.02, seed=232)
    codes[1:32:2] = codes[65:96:2].copy()
    lens = np.full(128, L, np.int32)
    untraced = m.map_batch_paired(codes, lens)
    trace.enable("cpu")
    traced = m.map_batch_paired(codes, lens)
    got = trace.read()
    n, proper = seen[-1]
    multi = n.reshape(-1, 2).amax(dim=1) >= 2
    broken = multi & ~proper[0::2]
    assert got["pairs_gridded"] == int(multi.sum()) > 0
    assert got["pairs_broken"] == int(broken.sum()) > 0
    for f in traced._fields:
        assert torch.equal(getattr(traced, f), getattr(untraced, f)), f


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the pair-select kernel runs only there")
    return torch.device("cuda")


def random_pairs(seed, P, C):
    """Random pairs as the tails hand them over, and some that are not:
    n_cands 0..C (valid not always a prefix), scores -5..200 with zeros,
    positions clustered so that pairs form, both strands; a tenth of the
    pairs at int32 extremes (positions that wrap with the slack, sums that
    wrap, ties); insert limits that wrap in one of three seeds."""
    rng = np.random.default_rng(seed)
    B = 2 * P
    c = Pairs(P, C, cutoff=rng.choice([0.0, 0.3, 0.9, 1.0]))
    c.n = rng.integers(0, C + 1, B).astype(np.int32)
    c.n[rng.random(B) < 0.3] = 1
    prefix = np.arange(C)[None] < c.n[:, None]
    c.valid = np.where(rng.random(B)[:, None] < 0.9, prefix,
                       rng.random((B, C)) < 0.5)
    c.sw = np.where(rng.random((B, C)) < 0.2, 0,
                    rng.integers(-5, 200, (B, C))).astype(np.int32)
    c.sw[rng.random((B, C)) < 0.1] = 100           # ties
    base = rng.integers(0, 1_000_000, P).repeat(2)[:, None]
    c.corr = (base + rng.integers(-600, 600, (B, C))).astype(np.int32)
    c.strand = rng.integers(0, 2, (B, C)).astype(np.int32)
    odd = rng.random(P).repeat(2) < 0.1
    big = np.iinfo(np.int32)
    ext = rng.choice([big.max, big.max - 5, big.min, big.min + 3, 0],
                     (B, C)).astype(np.int32)
    c.corr = np.where(odd[:, None], ext, c.corr)
    c.sw = np.where(odd[:, None] & (rng.random((B, C)) < 0.5),
                    rng.choice([big.max, big.max - 1, 1], (B, C)),
                    c.sw).astype(np.int32)
    c.strand = np.where(odd[:, None] & (rng.random((B, C)) < 0.3),
                        rng.integers(-3, 4, (B, C)), c.strand
                        ).astype(np.int32)
    if seed % 3 == 0:
        c.min_insert, c.max_insert = big.min + 5, big.max - 5
    return c


def assert_same(got: Pairing, want: Pairing, what=""):
    for f in Pairing._fields:
        a, b = getattr(got, f).cpu(), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert torch.equal(a, b), (what, f)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 8, 32, 33, 64])
@pytest.mark.parametrize("P", [1, 7, 2048])
def test_kernel_equals_plain(dev, P, C):
    for seed in range(3):
        c = random_pairs(100 * P + C + seed, P, C)
        before = pair_select.launches
        got = run(pair_select, c, dev)
        torch.cuda.synchronize()
        assert pair_select.launches == before + 1
        assert_same(got, run(pair_select_plain, c), (P, C, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_hand_built(dev, name):
    c, want, counts = CASES[name]()
    counters = torch.zeros(2, dtype=torch.int64, device=dev)
    got = run(pair_select, c, dev, counters=counters)
    assert verdict(got) == want
    assert counters.tolist() == list(counts)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 32, 33])
def test_kernel_counters_equal_plain(dev, C):
    c = random_pairs(3 * C + 1, 2048, C)      # insert limits that pair
    on_card = torch.full((2,), 5, dtype=torch.int64, device=dev)
    plain = torch.full((2,), 5, dtype=torch.int64)
    got = run(pair_select, c, dev, counters=on_card)
    want = run(pair_select_plain, c, counters=plain)
    assert_same(got, want)
    assert on_card.tolist() == plain.tolist()
    if C == 1:                  # no mate has two candidates: no grid
        assert plain.tolist() == [5, 5]
    else:
        assert plain[0] > plain[1] > 5


@pytest.mark.cuda
def test_kernel_in_a_captured_graph(dev):
    """Captured once, replayed on new contents of the same inputs (the
    scalars included, read on the device): each replay equals the plain
    version."""
    cases = [random_pairs(40 + i, 2048, 32) for i in range(3)]
    static = cases[0].args(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pair_select(*static, read_len=L, slack=SLACK, margin=MARGIN)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pair_select(*static, read_len=L, slack=SLACK, margin=MARGIN)
    for c in cases[1:] + cases[:1]:
        for x, y in zip(static, c.args(dev)):
            x.copy_(y)
        graph.replay()
        torch.cuda.synchronize()
        assert_same(out, run(pair_select_plain, c))


@pytest.mark.cuda
def test_kernel_refuses(dev):
    """A wrong dtype, shape, layout or device raises before any launch."""
    good = list(random_pairs(3, 64, 8).args(dev))
    bad = [(0, good[0].to(torch.int64)),             # sw int32
           (0, good[0][:-1]),                        # an odd B
           (1, good[1][:, :4]),                      # not [B, C]
           (3, good[3].to(torch.uint8)),             # cand_valid bool
           (2, good[2].t().contiguous().t()),        # not contiguous
           (4, good[4].cpu()),                       # another device
           (5, good[5].reshape(1)),                  # min_insert []
           (7, good[7].to(torch.float64))]           # pair_cutoff float32
    before = pair_select.launches
    for i, t in bad:
        args = list(good)
        args[i] = t
        with pytest.raises(ValueError):
            pair_select(*args, read_len=L, slack=SLACK, margin=MARGIN)
    with pytest.raises(ValueError):
        pair_select(*good, read_len=L, slack=SLACK, margin=MARGIN,
                    counters=torch.zeros(2, dtype=torch.int32, device=dev))
    assert pair_select.launches == before


def card_mapper(dev):
    g = synthetic.repeat_genome(4_000_000, n_repeats=200, min_len=300,
                                max_len=3000, seed=31)

    class G:
        codes = g

    return tmapper.Mapper(NgmConfig(), G(), 150, device=dev), g


@pytest.mark.cuda
def test_paired_step_equals_the_plain_select(dev, monkeypatch):
    """A whole traced map_step_paired at 2048 pairs x 150 bp on a seeded
    repeat genome (the first 256 pairs given the second mate of another
    pair) equals the same step with the plain pair select on the card,
    field for field and in the two pair counters, and launches the kernel
    once."""
    m, g = card_mapper(dev)
    codes = synthetic.simulate_pairs(g, 2048, 150, 0.02, insert_mean=350,
                                     insert_sd=40, seed=32)[0]
    codes[1:512:2] = codes[2049:2560:2].copy()
    args = m._common_args(codes, np.full(4096, 150, np.int32), paired=True)
    statics = m.statics()
    pairs = ("pairs_gridded", "pairs_broken")
    before = pair_select.launches
    trace.enable(dev)
    got = tmapper.map_step_paired(*args, **statics)
    kernel = [trace.read()[c] for c in pairs]
    assert pair_select.launches == before + 1
    monkeypatch.setattr(tmapper, "pair_select", pair_select_plain)
    trace.enable(dev)           # zeroed
    want = tmapper.map_step_paired(*args, **statics)
    plain = [trace.read()[c] for c in pairs]
    assert pair_select.launches == before + 1
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(want.proper.sum()) > 0.5 * 4096
    assert kernel == plain and plain[0] > plain[1] > 0


@pytest.mark.cuda
def test_select_phase_is_one_kernel(dev):
    """A traced paired replay of K steps: between each step's `score` and
    `select` marks the device runs exactly one record, the pair-select
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    K = 2
    m, g = card_mapper(dev)
    codes = synthetic.simulate_pairs(g, K * 2048, 150, 0.02,
                                     insert_mean=350, insert_sd=40,
                                     seed=33)[0].reshape(K, 4096, 150)
    lens = np.full((K, 4096), 150, np.int32)
    trace.enable(dev)
    m.map_batch_scan(codes, lens, paired=True)       # the traced capture
    for _ in range(3):          # CUPTI may drop records from a window
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            m.map_batch_scan(codes, lens, paired=True)
            torch.cuda.synchronize()
        recs = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and not e.name.startswith("ngm.")),
                      key=lambda e: e.time_range.start)
        phases, cur = [], None
        for e in recs:
            hit = MARK.search(e.name)
            if hit and hit.group(1) == "2":
                cur = []
            elif hit and hit.group(1) == "3" and cur is not None:
                phases.append(cur)
                cur = None
            elif cur is not None:
                cur.append(e.name)
        if len(phases) == K:
            break
    assert len(phases) == K
    for names in phases:
        assert len(names) == 1 and "pair_select_kernel" in names[0], names
