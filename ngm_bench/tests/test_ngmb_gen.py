"""The generators: deterministic per seed, and true to their parameters."""

import copy

import pytest
import torch

from ngmb import gen, manifest

SPEC = manifest.load_json("configs", "chr20_se150")["genome"] | {
    "length": 400_000}
SE = {"length": 150, "paired": False}
PE = {"length": 150, "paired": True, "insert_mean": 350, "insert_sd": 40}
CPU = torch.device("cpu")
WGS = manifest.load_json("traffic", "wgs")


def traffic(error=0.0, mutation=0.0, indel_fraction=0.0, extend=0.0,
            region="uniform"):
    return {"region": region, "error_rate": error, "mutation_rate": mutation,
            "indel_fraction": indel_fraction, "indel_extend": extend}


def genome(seed=5, spec=SPEC):
    return gen.make_genome(spec, gen.generator(seed, CPU), CPU)


def pool(t, reads=SE, seed=5, n=4, b=256):
    g = gen.generator(seed, CPU)
    gn, cover = gen.make_genome(SPEC, g, CPU)
    return gn, cover, gen.make_pool(gn, cover, reads, t, n, b, g)


def revcomp(x):
    return (3 - x).flip(-1)


def forward(p):
    """The reads on the forward strand."""
    r = p.reads.reshape(-1, p.reads.shape[-1])
    s = p.truth_strand.reshape(-1)
    return torch.where(s[:, None] == 1, revcomp(r), r)


def test_same_seed_same_inputs_large_seeds():
    for seed in (2**31 + 7, 2**33 + 1):
        a = pool(WGS, seed=seed)
        b = pool(WGS, seed=seed)
        for x, y in zip(a[2], b[2]):
            assert torch.equal(x, y)
        assert torch.equal(a[0], b[0])
    c = pool(WGS, seed=2**31 + 8)
    assert not torch.equal(a[0], c[0])


def test_genome_codes_gc_and_repeat_shares():
    g, cover = genome()
    assert g.dtype == torch.uint8 and int(g.max()) <= 3
    assert g.shape[0] == SPEC["length"]
    gc = ((g == 1) | (g == 2)).float().mean().item()
    assert abs(gc - SPEC["gc"]) < 0.01
    planted = sum(f["share"] for f in SPEC["families"])
    dup = SPEC["duplications"]["share"]
    share = cover.float().mean().item()
    # the families' shares, and the duplications' sources and copies: two
    # of up to 20 kbp on 400 kbp
    assert planted - 0.02 < share < planted + 2 * dup + 0.05


def test_families_take_their_shares():
    """Each family alone, on a genome of its own: its copies cover its
    share (within the spread of its lengths)."""
    for f in SPEC["families"]:
        spec = {"length": 2_000_000, "gc": SPEC["gc"], "families": [f]}
        _, cover = genome(spec=spec)
        share = cover.float().mean().item()
        assert abs(share - f["share"]) < 0.15 * f["share"], (f["name"], share)


def test_copies_share_kmers():
    """Repeats make the k-mer rows skewed: some 13-mer rows of a 400 kbp
    genome hold tens of entries, which random bases never give."""
    g, _ = genome()
    k = 13
    w = g.unfold(0, k, 1).to(torch.int64)
    key = (w * 4 ** torch.arange(k, dtype=torch.int64)).sum(1)
    counts = torch.bincount(key)
    assert int(counts.max()) > 50
    rnd = torch.randint(0, 4, (SPEC["length"],),
                        generator=torch.Generator().manual_seed(1))
    wr = rnd.unfold(0, k, 1).to(torch.int64)
    assert int(torch.bincount((wr * 4 ** torch.arange(k)).sum(1)).max()) < 10


def test_bad_family_is_refused():
    bad = copy.deepcopy(SPEC)
    bad["families"][0]["mean"] = bad["families"][0]["max"] + 1
    with pytest.raises(ValueError):
        genome(spec=bad)
    bad = copy.deepcopy(SPEC)
    bad["families"][0]["truncation"] = "3p"
    with pytest.raises(ValueError):
        genome(spec=bad)


@pytest.mark.parametrize("error,mutation", [(0.02, 0.0), (0.02, 0.07)])
def test_substitution_rate(error, mutation):
    g, _, p = pool(traffic(error, mutation))
    f = forward(p)
    pos = p.truth_pos.reshape(-1)
    ref = g[pos[:, None] + torch.arange(150)]
    rate = (f != ref).float().mean().item()
    want = error + mutation
    assert abs(rate - want) < 0.1 * want


def test_wgsim_rates():
    assert gen.rates(WGS) == pytest.approx((0.02 + 0.001 * 0.85,
                                            0.001 * 0.15, 0.3))
    div = manifest.load_json("traffic", "div10")
    sub, indel, _ = gen.rates(div)
    assert sub == pytest.approx(0.09) and indel == pytest.approx(0.01)


def test_reads_without_errors_are_the_genome():
    g, _, p = pool(traffic())
    pos = p.truth_pos.reshape(-1)
    assert torch.equal(forward(p), g[pos[:, None] + torch.arange(150)])
    s = p.truth_strand.float().mean().item()
    assert 0.4 < s < 0.6
    assert torch.all(p.lengths == 150)


def test_indel_rate():
    """Indels starting at rate r a base, no substitutions: a read whose
    first ~150 source bases start no indel equals its window."""
    r = 0.01
    g, _, p = pool(traffic(0.0, r, 1.0), n=8)
    f = forward(p)
    pos = p.truth_pos.reshape(-1)
    ref = g[pos[:, None] + torch.arange(150)]
    clean = (f == ref).all(1).float().mean().item()
    # P(no indel in the first ~150 source bases) = (1 - r)^150 ~ 0.22
    assert abs(clean - (1 - r) ** 150) < 0.05


def test_indel_lengths_are_geometric():
    """On windows of distinct symbols (10, 11, ...), kept bases read in
    order: a deletion is a jump, an insertion a run of symbols under 10.
    Lengths are 1 + Geometric(extend): mean 1 / (1 - extend)."""
    n, width, L, x = 4000, 200, 150, 0.3
    win = (10 + torch.arange(width)).expand(n, width).contiguous()
    out = gen._indels(win, L, 0.02, x, gen.generator(3, CPU))
    ins_runs, del_lens = [], []
    for row in out.tolist():
        run, last = 0, 9
        for v in row:
            if v < 10:
                run += 1
                continue
            if run:
                ins_runs.append(run)
                run = 0
            if v - last > 1 and last >= 10:
                del_lens.append(v - last - 1)
            last = v
    for lens in (ins_runs, del_lens):
        mean = sum(lens) / len(lens)
        assert abs(mean - 1 / (1 - x)) < 0.1, mean
        assert max(lens) <= gen.MAX_INDEL
    # as many insertions as deletions
    assert abs(len(ins_runs) - len(del_lens)) < 0.15 * len(del_lens)


def test_indels_keep_length_and_codes():
    _, _, p = pool(manifest.load_json("traffic", "div10"))
    assert p.reads.shape[-1] == 150 and int(p.reads.max()) <= 3


def test_pairs_fr_insert():
    g, _, p = pool(traffic(), reads=PE, n=8)
    pos = p.truth_pos.reshape(-1, 2)
    st = p.truth_strand.reshape(-1, 2)
    assert torch.all(st[:, 0] != st[:, 1])
    left = torch.where(st[:, 0] == 0, pos[:, 0], pos[:, 1])
    right = torch.where(st[:, 0] == 0, pos[:, 1], pos[:, 0])
    ins = (right - left + 150).float()
    assert abs(ins.mean().item() - 350) < 3
    assert abs(ins.std().item() - 40) < 3
    first_rev = (st[:, 0] == 1).float().mean().item()
    assert 0.4 < first_rev < 0.6
    f = forward(p)
    assert torch.equal(f, g[p.truth_pos.reshape(-1)[:, None]
                            + torch.arange(150)])


def test_unique_windows_touch_no_repeat():
    g, cover, p = pool(traffic(0.02, region="unique"))
    pos = p.truth_pos.reshape(-1)
    assert not cover[pos[:, None] + torch.arange(150)].any()
    _, _, q = pool(WGS)
    qpos = q.truth_pos.reshape(-1)
    assert cover[qpos[:, None] + torch.arange(150)].any(1).float().mean() > 0.5


def test_unknown_region_is_refused():
    with pytest.raises(ValueError):
        pool(traffic(0.02, region="exome"))
