"""The finish pass (ops/finish_kernel.py): its plain version on the CPU,
and the kernel (csrc/sw_align.cu: sw_align_finish_kernel, or
sw_align_finish_block_kernel past W = 512) on the card against it.

On the CPU:
  * finish_plain equals the JAX reference's _finish
    (nextgenmap_tpu/models/mapper.py:304) in every MapResult field on
    hand-built batches of 8 reads: a winner on an invalid candidate; the
    second best among near (|d| = L) and far (|d| = L + 1) candidates, and
    with every candidate near; winners' starts clamped at the genome's end;
    strand-1 winners on bisulfite matrices; op buffers that truncate (cheap
    gaps: cmr_overflow counts them, mapped is false); an identity exactly
    at min_identity; MAPQ at half-way values (2.5 -> 2, 3.5 -> 4); paired
    `proper` gated by mapped; a flattened two-row genome with windows that
    end at each row's end.  One jitted reference serves every case (the
    same shapes; gaps and thresholds are arrays);
  * on CPU tensors finish_pass is finish_plain and loads no library.
On the card (marked `cuda`, skipped without one): finish_pass equals
finish_plain on CPU copies in every field at [4096, 150] x W 56 (the smem
route), [614, 1000] x W 184 (the global route) and [64, 300] x W 520 (the
block form), local and glocal, single-end and paired, with one bisulfite
pair of matrices and a batch with cheap gaps (whose op buffers truncate at
W 56 and 184); it launches once
and runs no K2 or K4; it replays inside a captured graph; it refuses wrong
inputs before any launch; and whole map_step and map_step_paired runs on a
seeded repeat genome equal the card path before it (finish_plain on the
card: torch ops, K2 and K4) field for field.
Tolerance: exact equality (integer DP; float32 filters and MAPQ).
"""

import functools

import numpy as np
import pytest
import torch

from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.native import build
from nextgenmap_tpu_torch.ops import finish_kernel
from nextgenmap_tpu_torch.ops.finish_kernel import (
    MapResult, finish_pass, finish_plain,
)
from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
from nextgenmap_tpu_torch.ops.scoring import score_matrix
from nextgenmap_tpu_torch.ops.sw_align_kernel import sw_align

B, C, L, W = 8, 4, 24, 8
T = L + W
GS = 200                 # a row of the flattened two-row genome
G = 2 * GS
GAPS = (20, 20, 20)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def revcomp(codes):
    return (3 - codes[..., ::-1]).astype(np.uint8)


def mats_of(bs=False):
    cfg = NgmConfig(bs_mapping=bs)
    return np.stack([score_matrix(cfg, s) for s in range(2)]).astype(np.int32)


def plant(c, b, start, off=3, mutate=()):
    """Read b's winner query (by its strand) into the genome at start +
    off, with mismatches at `mutate`."""
    q = (c["rc"] if c["strand"][b, c["a1"][b]] == 1 else c["reads"])[b]
    q = q[:c["lengths"][b]].copy()
    for i in mutate:
        q[i] = (q[i] + 1) % 4
    s = start + off
    c["genome"][s:s + q.shape[0]] = q[:G - s]


def base(seed=0):
    """Eight reads, each winner (candidate 0) planted in the genome at its
    corridor start; the other candidates far from it with lower scores."""
    rng = np.random.default_rng(seed)
    c = dict(
        genome=rng.integers(0, 4, G).astype(np.uint8),
        reads=rng.integers(0, 4, (B, L)).astype(np.uint8),
        lengths=np.full(B, L, np.int32),
        a1=np.zeros(B, np.int64),
        strand=np.zeros((B, C), np.int32),
        valid=np.ones((B, C), bool),
        proper=np.zeros(B, bool),
        overflow=(np.int32(3), np.int32(5)),
        mats=mats_of(),
        gaps=GAPS,
        min_identity=np.float32(0.65),
        min_residues=np.float32(0.5),
    )
    c["lengths"][7] = 20
    c["rc"] = revcomp(c["reads"])
    start = 20 + 40 * np.arange(B)
    c["corr"] = (start[:, None] + np.array([0, 101, 150, 190])[None]) % (G - T)
    c["corr"][:, 0] = start
    c["corr"] = c["corr"].astype(np.int32)
    c["sw"] = np.tile(np.array([200, 120, 90, 60], np.int32), (B, 1))
    c["valid"][6, 2:] = False
    for b in range(B):
        plant(c, b, int(start[b]))
    return c


def case_invalid_winner():
    c = base(1)
    c["a1"][[1, 3]] = 3
    c["valid"][[1, 3], 3] = False
    c["corr"][1, 3] = 77      # pos stays the raw start; the window is at 0
    return c


def case_second_near_far():
    c = base(2)
    s = c["corr"][:, 0]
    c["corr"][:, 1] = s + L            # |d| = L: near
    c["corr"][:, 2] = s + L + 1        # far
    c["corr"][:, 3] = np.maximum(s - L - 1, 0)
    c["sw"][:, 1:] = [[190, 150, 170]]
    c["sw"][4, 3] = 155
    return c


def case_all_near():
    c = base(3)
    s = c["corr"][:, 0]
    c["corr"][:, 1:] = s[:, None] + np.array([[-L, L, 5]])
    return c


def case_clamped_start():
    c = base(4)
    for b, s in ((2, G - 10), (5, G), (6, G - T + 1)):
        c["corr"][b, 0] = s
        plant(c, b, G - T)
    return c


def case_strand1_bisulfite():
    c = base(5)
    c["mats"] = mats_of(bs=True)
    c["strand"][1::2, 0] = 1
    c["strand"][::2, 2] = 1
    for b in range(1, B, 2):
        plant(c, b, int(c["corr"][b, 0]), off=5)
    return c


def case_truncated():
    c = base(6)
    rng = np.random.default_rng(60)
    c["genome"] = rng.integers(0, 2, G).astype(np.uint8)
    c["reads"] = rng.integers(0, 2, (B, L)).astype(np.uint8)
    c["rc"] = revcomp(c["reads"])
    c["gaps"] = (1, 1, 0)
    return c


def case_identity_at_min():
    c = base(7)
    plant(c, 0, int(c["corr"][0, 0]), mutate=(5, 10, 15, 20))
    c["min_identity"] = np.float32(20) / np.float32(24)
    return c


def case_mapq_half():
    c = base(8)
    c["sw"][0, 1], c["sw"][1, 1], c["sw"][2, 1] = 230, 226, 234
    return c


def case_paired_proper():
    c = base(9)
    c["proper"][:] = [True, True, False, True, True, False, True, True]
    c["genome"][c["corr"][3, 0]:c["corr"][3, 0] + T] = 4   # read 3 unmapped
    return c


def case_two_rows():
    """The pooled shard tail's genome: two rows of GS bases, each read's
    candidates in one row, reads 4 and 7 at their row's last window."""
    c = base(10)
    for b, s in ((4, GS - T), (7, G - T)):
        c["corr"][b, 0] = s
        plant(c, b, s)
    row = (c["corr"][:, :1] >= GS) * GS
    c["corr"][:, 1:] = row + np.array([[0, 60, 110]])
    return c


CASES = {f.__name__[5:]: f for f in (
    case_invalid_winner, case_second_near_far, case_all_near,
    case_clamped_start, case_strand1_bisulfite, case_truncated,
    case_identity_at_min, case_mapq_half, case_paired_proper,
    case_two_rows)}


def torch_args(c, device="cpu"):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return ((t(c["a1"]), t(c["sw"]), t(c["corr"]), t(c["strand"]),
             t(c["valid"]), t(c["genome"]), t(c["reads"]), t(c["rc"]),
             t(c["lengths"]), t(c["mats"]), *c["gaps"],
             torch.tensor(c["min_identity"], device=device),
             torch.tensor(c["min_residues"], device=device),
             t(c["valid"].sum(axis=1).astype(np.int32)),
             tuple(torch.tensor(x, device=device) for x in c["overflow"]),
             t(c["proper"])))


@pytest.fixture(scope="module")
def jax_finish():
    """The reference's _finish, jitted once for every case."""
    jax = pytest.importorskip("jax")
    from nextgenmap_tpu.models.mapper import _finish

    return jax.jit(functools.partial(_finish, band=W))


def jax_result(fn, c):
    import jax.numpy as jnp

    a = jnp.asarray
    res = fn(a(c["a1"].astype(np.int32)), a(c["sw"]), a(c["corr"]),
             a(c["strand"]), a(c["valid"]), a(c["genome"]), a(c["reads"]),
             a(c["rc"]), a(c["lengths"]), a(c["mats"]),
             *(a(np.int32(g)) for g in c["gaps"]), a(c["min_identity"]),
             a(c["min_residues"]), a(c["valid"].sum(axis=1).astype(np.int32)),
             tuple(a(x) for x in c["overflow"]), a(c["proper"]))
    return {f: np.asarray(v) for f, v in zip(res._fields, res)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_finish_equals_jax(jax_finish, name):
    c = CASES[name]()
    got = finish_plain(*torch_args(c), band=W)
    want = jax_result(jax_finish, c)
    assert list(want) == list(MapResult._fields)
    for f in MapResult._fields:
        x = getattr(got, f).numpy()
        assert x.dtype == want[f].dtype, f
        assert np.array_equal(x, want[f]), (name, f, x, want[f])
    # each case reaches what it was built for
    if name == "invalid_winner":
        assert not got.mapped[[1, 3]].any() and int(got.score[1]) == 0
        assert int(got.pos[1]) >= 77
    if name == "second_near_far":
        # read 0's third candidate, clipped to 0, lies within L
        assert got.second.tolist() == [150] + [170] * 3 + [155] + [170] * 3
    if name == "all_near":
        assert not got.second.any()
    if name == "truncated":
        n = int(torch.as_tensor(got.n_ops == L + W).sum())
        assert n > 0 and int(got.cmr_overflow) > 5
        assert not got.mapped[got.n_ops == L + W].any()
    if name == "identity_at_min":
        ident = np.float32(got.matches[0]) / np.float32(got.n_ops[0])
        assert ident == c["min_identity"] and bool(got.mapped[0])
    if name == "mapq_half":
        assert got.score[:3].tolist() == [240] * 3
        assert got.mapq[:3].tolist() == [2, 4, 2]
    if name == "paired_proper":
        assert not got.mapped[3] and not got.proper[3]
        assert got.proper.tolist() == (got.mapped & torch.from_numpy(
            c["proper"])).tolist()
        assert int(got.proper.sum()) >= 4
    if name == "two_rows":
        assert bool(got.mapped.all())
    if name in ("mapq_half", "strand1_bisulfite", "clamped_start"):
        assert int(got.mapped.sum()) >= 6


def test_cpu_finish_loads_no_library(monkeypatch):
    def no_library():
        raise AssertionError("the plain finish loaded the kernel library")

    monkeypatch.setattr(build, "load", no_library)
    c = case_paired_proper()
    before = finish_pass.launches
    got = finish_pass(*torch_args(c), band=W)
    assert finish_pass.launches == before
    want = finish_plain(*torch_args(c), band=W)
    for f in MapResult._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the finish pass runs only there")
    return torch.device("cuda")


def card_case(seed, Bn, Ln, Wn, *, n_mats=1, Cn=32, Gn=400_000,
              cheap=False):
    """A batch as the tails hand it over: lengths 0..L (most L), valid
    candidates a prefix, a1 anywhere in [0, C) (invalid ones too), starts
    random and at G - T, G - 1 and G; most winners planted with a few
    mismatches, by their strand; sw with negative entries (glocal)."""
    rng = np.random.default_rng(seed)
    Tn = Ln + Wn
    genome = rng.integers(0, 4, Gn).astype(np.uint8)
    genome[rng.integers(0, Gn, Gn // 100)] = 4
    alphabet = 2 if cheap else 4
    reads = rng.integers(0, alphabet, (Bn, Ln)).astype(np.uint8)
    if cheap:
        genome = rng.integers(0, 2, Gn).astype(np.uint8)
    rc = revcomp(reads)
    lengths = np.where(rng.random(Bn) < 0.9, Ln,
                       rng.integers(0, Ln + 1, Bn)).astype(np.int32)
    lengths[:3] = [0, 1, Ln]
    n = rng.integers(1, Cn + 1, Bn)
    valid = np.arange(Cn)[None] < n[:, None]
    a1 = np.where(rng.random(Bn) < 0.9, rng.integers(0, n),
                  rng.integers(0, Cn, Bn)).astype(np.int64)
    strand = rng.integers(0, 2, (Bn, Cn)).astype(np.int32)
    corr = rng.integers(0, Gn - Tn, (Bn, Cn)).astype(np.int32)
    near = rng.random((Bn, Cn)) < 0.3
    win = corr[np.arange(Bn), a1]
    corr = np.where(near, np.clip(win[:, None] + rng.integers(
        -Ln - 2, Ln + 3, (Bn, Cn)), 0, Gn - Tn), corr).astype(np.int32)
    corr.flat[:4] = [Gn - Tn, Gn - 1, Gn, Gn - Tn + 3]
    sw = rng.integers(-50, 10 * Ln, (Bn, Cn)).astype(np.int32)
    for b in range(Bn):
        s = int(corr[b, a1[b]])
        if rng.random() < 0.85 and 0 <= s <= Gn - Tn:
            q = (rc if strand[b, a1[b]] == 1 else reads)[b, :lengths[b]]
            q = q.copy()
            snp = rng.random(q.shape[0]) < 0.03
            q[snp] = (q[snp] + 1) % 4
            o = int(rng.integers(0, Wn))
            genome[s + o:s + o + q.shape[0]] = q
    cfg = NgmConfig(bs_mapping=n_mats == 2)
    mats = np.stack([score_matrix(cfg, i) for i in range(n_mats)])
    return dict(genome=genome, reads=reads, rc=rc, lengths=lengths, a1=a1,
                strand=strand, valid=valid, corr=corr, sw=sw,
                mats=mats.astype(np.int32),
                gaps=(1, 1, 0) if cheap else GAPS,
                min_identity=np.float32(0.65), min_residues=np.float32(0.5),
                overflow=(np.int32(7), np.int32(11)),
                proper=rng.random(Bn) < 0.7)


def assert_same(got, want, what=""):
    for f in MapResult._fields:
        a, b = getattr(got, f).cpu(), getattr(want, f).cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert torch.equal(a, b), (what, f)


def launches():
    return (finish_pass.launches, gather_genome_windows.launches,
            sw_align.launches)


# (B, L, W): the smem route, the global route, the block form
CARD_SHAPES = [(4096, 150, 56), (614, 1000, 184), (64, 300, 520)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["local", "glocal"])
@pytest.mark.parametrize("Bn,Ln,Wn", CARD_SHAPES)
def test_finish_pass_equals_plain(dev, Bn, Ln, Wn, mode):
    route = finish_kernel.plan(Bn, Ln, Wn, mode, dev).route
    assert route == ("smem" if Wn == 56 else "global")
    for kind, kw in (("single", {}), ("bisulfite", dict(n_mats=2)),
                     ("truncating", dict(cheap=True))):
        c = card_case(Bn + Wn, Bn, Ln, Wn, **kw)
        if kind == "single":
            c["proper"][:] = False
        c0 = launches()
        got = finish_pass(*torch_args(c, dev), band=Wn, mode=mode)
        torch.cuda.synchronize()
        assert launches() == (c0[0] + 1, c0[1], c0[2])
        want = finish_plain(*torch_args(c), band=Wn, mode=mode)
        assert_same(got, want, (kind, mode))
        assert int(want.mapped.sum()) > 0 or kind == "truncating"
        if kind == "truncating" and mode == "local" and Wn < 512:
            # (at W 520 the op buffer, L + W, holds every walk)
            assert int(want.cmr_overflow) > 11


@pytest.mark.cuda
def test_finish_pass_in_a_captured_graph(dev):
    """Captured once, replayed on new contents of the same inputs: each
    replay equals the plain version (the counter's memset replays too)."""
    cases = [card_case(70 + i, 512, 150, 56, cheap=i == 1) for i in range(3)]
    static = torch_args(cases[0], dev)
    flat = [x for x in static if torch.is_tensor(x)] + list(static[16])

    def step():
        return finish_pass(*static, band=56)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for c in cases[1:] + cases[:1]:
        new = torch_args(c, dev)
        for x, y in zip(flat, [x for x in new if torch.is_tensor(x)]
                        + list(new[16])):
            x.copy_(y)
        if c["gaps"] != GAPS:       # the gaps are launch arguments
            continue
        graph.replay()
        torch.cuda.synchronize()
        assert_same(out, finish_plain(*torch_args(c), band=56))


@pytest.mark.cuda
def test_finish_pass_refuses(dev):
    """A wrong dtype, shape, layout or device raises before any launch."""
    c = card_case(3, 64, 100, 48, Cn=4, Gn=5_000)
    good = list(torch_args(c, dev))
    bad = [(0, good[0].to(torch.int32)),            # a1 int64
           (1, good[1][:, :3]),                     # sw not [B, C]
           (4, good[4].to(torch.uint8)),            # cand_valid bool
           (2, good[2].t().contiguous().t()),       # not contiguous
           (8, good[8].cpu()),                      # another device
           (13, good[13].to(torch.float64))]        # min_identity float32
    before = finish_pass.launches
    for i, t in bad:
        args = list(good)
        args[i] = t
        with pytest.raises(ValueError):
            finish_pass(*args, band=48)
    assert finish_pass.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [False, True])
def test_mapping_step_equals_the_former_card_path(dev, paired, monkeypatch):
    """A whole map_step / map_step_paired at [4096, 150] x W 56 on a seeded
    repeat genome equals the same step with the finish's plain version on
    the card (torch ops, K2 and K4, the card path before the finish pass),
    field for field."""
    from nextgenmap_tpu_torch import synthetic
    from nextgenmap_tpu_torch.models import mapper as tmapper

    g = synthetic.repeat_genome(4_000_000, n_repeats=200, min_len=300,
                                max_len=3000, seed=31)

    class _G:
        codes = g

    m = tmapper.Mapper(NgmConfig(), _G(), 150, device=dev)
    if paired:
        codes = synthetic.simulate_pairs(g, 2048, 150, 0.02, insert_mean=350,
                                         insert_sd=40, seed=32)[0]
    else:
        codes = synthetic.simulate_reads(g, 4096, 150, 0.02, seed=32)[0]
    lens = np.full(4096, 150, np.int32)
    step = tmapper.map_step_paired if paired else tmapper.map_step
    args = m._common_args(codes, lens, paired=paired)
    statics = m.statics()
    c0 = launches()
    got = step(*args, **statics)
    torch.cuda.synchronize()
    assert launches() == (c0[0] + 1, c0[1], c0[2])
    monkeypatch.setattr(tmapper, "finish_pass", finish_plain)
    want = step(*args, **statics)
    torch.cuda.synchronize()
    assert launches() == (c0[0] + 1, c0[1] + 1, c0[2] + 1)
    assert_same(got, want, "paired" if paired else "single")
    assert int(want.mapped.sum()) > 0.9 * 4096
    if paired:
        assert int(want.proper.sum()) > 0.5 * 4096
