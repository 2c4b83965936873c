"""Port's index sharding (device cpu) == the JAX reference.

  * ShardedIndex.build / build_dual: every array and flag for S = 2, 3, 4,
    raw and canonical entries, and the bisulfite (CT, GA) pair; the native
    shard passes against the numpy route;
  * map_step_sharded against the JAX map_step_sharded_scan, single-end and
    paired, S = 2, 3, 4, with the cross-shard tail pool off (compact_cap 0:
    full per-shard tails) and on (compact_cap 2B), every MapResult field;
    and against the port's own unsharded map_step;
  * a pair straddling a shard core boundary, where the port keeps both
    mates as the unsharded step does and the JAX merge drops mate 2
    (ROADMAP C7: the one place the port departs from the reference);
  * a skewed batch (every read from shard 0's core at S = 4): the pool of
    2B rows is exact, and a pool of 32 rows counts what it drops;
  * the top-n rank merge (Mapper.map_batch_topn, S = 2 and 3) and
    bisulfite with 2 shards (single and paired), against the JAX Mapper.
Workload: a 64 kbp random genome, k = 11, B = 64, 100 bp reads with SNPs
and indels, FR pairs of 300 +- 30 bp inserts (tests/test_sharding.py's),
and a 60 kbp genome with planted repeats for top-n and bisulfite.
Tolerance: none.  Every field is an integer or a flag and is compared
exactly; global positions (uint32 in JAX, int64 in the port) as int64.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nextgenmap_tpu import native as jnative  # noqa: E402
from nextgenmap_tpu.config import NgmConfig  # noqa: E402
from nextgenmap_tpu.index.kmer_index import KmerIndex  # noqa: E402
from nextgenmap_tpu.io.simulate import (  # noqa: E402
    random_genome, simulate_pairs, simulate_reads,
)
from nextgenmap_tpu.models import mapper as jmapper  # noqa: E402
from nextgenmap_tpu.ops.scoring import score_matrix  # noqa: E402
from nextgenmap_tpu.parallel import index_shard as jshard  # noqa: E402
from nextgenmap_tpu_torch import synthetic  # noqa: E402
from nextgenmap_tpu_torch.convert import (  # noqa: E402
    config_from_reference, index_from_reference,
)
from nextgenmap_tpu_torch.models import mapper as tmapper  # noqa: E402
from nextgenmap_tpu_torch.native import hostio  # noqa: E402
from nextgenmap_tpu_torch.parallel import index_shard as tshard  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

K = 11
CFG = NgmConfig(kmer=K)
B = 64
L = 100
STATICS = dict(k=K, fanout_cap=CFG.max_kmer_fanout, max_cmrs=CFG.max_cmrs,
               diag_bin_log2=CFG.diag_bin_log2, band=CFG.corridor_for(L),
               min_kmer_hits=1)
SCALARS = (20, 20, 20, 0.5, 1000, 0.65, 0.5)
PAIR = (0, 1000, 0.9)
HALO = jshard.ShardedIndex.halo_for(CFG, L)


def assert_equal(ref, got, skip=()):
    """Every field of a JAX MapResult and the port's, exactly; `pos` as
    int64, every other field in the reference's dtype."""
    assert ref._fields == got._fields
    for f in ref._fields:
        if f in skip:
            continue
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).cpu().numpy()
        if f == "pos":
            a, b = a.astype(np.int64), b.astype(np.int64)
        else:
            assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(scope="module")
def uniform():
    g = random_genome(64_000, seed=77)
    reads = simulate_reads(g, B, read_len=L, snp_rate=0.03,
                           indel_rate=0.003, seed=13)
    pairs = simulate_pairs(g, B // 2, read_len=L, insert_mean=300,
                           insert_sd=30, snp_rate=0.02, seed=14)
    return dict(
        g=g,
        index={c: KmerIndex.build(g, k=K, skip=2, max_freq=1000, canonical=c)
               for c in (False, True)},
        codes=np.stack([r.codes for r in reads]),
        pcodes=np.stack([m.codes for p in pairs for m in p]),
        mats=np.stack([score_matrix(CFG, 0), score_matrix(CFG, 1)]),
    )


def _jax_scan(sidx, codes, mats, *, paired, compact_cap, canonical):
    pair = (jnp.int32(PAIR[0]), jnp.int32(PAIR[1]), jnp.float32(PAIR[2]))
    return jmapper.map_step_sharded_scan(
        *(jnp.asarray(getattr(sidx, f)) for f in
          ("genome", "offsets", "positions", "base", "core_lo", "core_hi")),
        jnp.asarray(codes), jnp.full(codes.shape[0], L, jnp.int32),
        jnp.asarray(mats), jnp.int32(20), jnp.int32(20), jnp.int32(20),
        jnp.float32(0.5), jnp.int32(1000), jnp.float32(0.65),
        jnp.float32(0.5), *(pair if paired else ()), paired=paired,
        read_len=L, compact_cap=compact_cap, canonical=canonical, **STATICS,
    )


def _port_step(tables, codes, mats, *, paired, compact_cap, canonical):
    return tmapper.map_step_sharded(
        *tables, torch.from_numpy(codes),
        torch.full((codes.shape[0],), L, dtype=torch.int32),
        torch.from_numpy(mats), *SCALARS, *(PAIR if paired else ()),
        paired=paired, read_len=L, compact_cap=compact_cap,
        canonical=canonical, **STATICS,
    )


@pytest.mark.parametrize("S", [2, 3, 4])
@pytest.mark.parametrize("kind", ["raw", "canonical", "dual"])
def test_sharded_index_arrays(uniform, S, kind):
    g = uniform["g"]
    if kind == "dual":
        pair = tuple(KmerIndex.build(g, k=K, skip=2, max_freq=1000,
                                     collapse=c) for c in ("ct", "ga"))
        ref = jshard.ShardedIndex.build_dual(*pair, g, S, HALO)
        got = tshard.ShardedIndex.build_dual(
            *index_from_reference(pair), g, S, HALO)
    else:
        idx = uniform["index"][kind == "canonical"]
        ref = jshard.ShardedIndex.build(idx, g, S, HALO)
        got = tshard.ShardedIndex.build(index_from_reference(idx), g, S, HALO)
    for f in ("genome", "offsets", "positions", "base", "core_lo",
              "core_hi"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("n_shards", "max_freq", "dual", "canonical", "shard_ids"):
        assert getattr(ref, f) == getattr(got, f), f
    assert tshard.shard_ranges(g.shape[0], S, HALO) == jshard.shard_ranges(
        g.shape[0], S, HALO)
    assert tshard.ShardedIndex.halo_for(config_from_reference(CFG)) == HALO


def test_shard_slicing_native_matches_numpy(uniform, monkeypatch):
    """The native shard passes == the numpy route, array for array, and
    both == the JAX package's, canonical entries included."""
    assert hostio.lib() is not None
    idx = index_from_reference(uniform["index"][True])
    native = tshard.ShardedIndex.build(idx, uniform["g"], 3, HALO)
    monkeypatch.setattr(hostio, "lib", lambda: None)
    plain = tshard.ShardedIndex.build(idx, uniform["g"], 3, HALO)
    monkeypatch.setattr(jnative, "lib", lambda: None)
    ref = jshard.ShardedIndex.build(uniform["index"][True], uniform["g"], 3,
                                    HALO)
    for f in ("genome", "offsets", "positions", "base", "core_lo",
              "core_hi"):
        np.testing.assert_array_equal(getattr(native, f), getattr(plain, f))
        np.testing.assert_array_equal(getattr(ref, f), getattr(plain, f))


@pytest.mark.parametrize("paired,S,compact_cap", [
    (False, 2, 0), (False, 3, 2 * B), (False, 4, 0),
    (True, 2, 0), (True, 3, 0), (True, 4, 2 * B),
])
def test_sharded_step_equals_jax_and_unsharded(uniform, paired, S,
                                               compact_cap):
    """The shard loop == JAX's map_step_sharded_scan in every field (the
    pool at 2B = 128 < S * B rows, or the full per-shard tails; at S = 2,
    2B is S * B and the pool never runs), and == the port's unsharded step
    on the global index: nothing overflows here.  Each of S = 2, 3, 4 runs
    single-end and paired, and each input runs with and without the pool
    (every case is one compile of the JAX scan, which sets the file's
    time)."""
    canonical = S != 2
    idx = uniform["index"][canonical]
    codes = uniform["pcodes" if paired else "codes"]
    ref_sidx = jshard.ShardedIndex.build(idx, uniform["g"], S, HALO)
    ref = _jax_scan(ref_sidx, codes, uniform["mats"], paired=paired,
                    compact_cap=compact_cap, canonical=canonical)
    sidx = tshard.ShardedIndex.build(index_from_reference(idx), uniform["g"],
                                     S, HALO)
    tables = tshard.ShardTables.from_index(sidx, "cpu")
    got = _port_step(tables, codes, uniform["mats"], paired=paired,
                     compact_cap=compact_cap, canonical=canonical)
    assert_equal(ref, got)
    assert got.pos.dtype == torch.int64
    assert int(got.mapped.sum()) >= 60
    if paired:
        assert int(got.proper.sum()) >= 56

    off, pos = idx.device_arrays()
    single = (tmapper.map_step_paired if paired else tmapper.map_step)(
        torch.from_numpy(uniform["g"]), torch.from_numpy(off),
        torch.from_numpy(pos), torch.from_numpy(codes),
        torch.full((B,), L, dtype=torch.int32),
        torch.from_numpy(uniform["mats"]), *SCALARS,
        *(PAIR if paired else ()), canonical=canonical, **STATICS,
    )
    # a read's candidate count is its winner shard's; the fan-out counter
    # counts per-shard row truncations
    for f in single._fields:
        if f in ("n_candidates", "fanout_overflow"):
            continue
        np.testing.assert_array_equal(
            getattr(single, f).numpy().astype(np.int64)
            if f == "pos" else getattr(single, f).numpy(),
            getattr(got, f).numpy(), err_msg=f)


def test_pair_straddling_a_core_boundary(uniform):
    """A proper pair whose mate 1 lies in shard 1's core and mate 2 in shard
    0's (both mates in either shard's halo) is taken whole from shard 1 and
    keeps both mates mapped, as the unsharded step maps them.  The JAX
    merge reads mate 2's score through shard 1's ownership mask and
    unmaps it (ROADMAP C7); the port differs from it in that mate only."""
    g = uniform["g"]
    codes = uniform["pcodes"].copy()
    codes[0] = (3 - g[16_050:16_150])[::-1]      # mate 1, reverse strand
    codes[1] = g[15_750:15_850]                  # mate 2, forward strand
    idx = uniform["index"][True]
    sidx = tshard.ShardedIndex.build(index_from_reference(idx), g, 4, HALO)
    got = _port_step(tshard.ShardTables.from_index(sidx, "cpu"), codes,
                     uniform["mats"], paired=True, compact_cap=2 * B,
                     canonical=True)
    assert got.mapped[:2].all() and got.proper[:2].all()
    assert got.pos[:2].tolist() == [16_050, 15_750]
    off, pos = idx.device_arrays()
    single = tmapper.map_step_paired(
        torch.from_numpy(g), torch.from_numpy(off), torch.from_numpy(pos),
        torch.from_numpy(codes), torch.full((B,), L, dtype=torch.int32),
        torch.from_numpy(uniform["mats"]), *SCALARS, *PAIR, canonical=True,
        **STATICS)
    for f in ("mapped", "proper", "strand", "score", "second", "mapq",
              "ops"):
        assert torch.equal(getattr(single, f), getattr(got, f)), f
    ref = _jax_scan(jshard.ShardedIndex.build(idx, g, 4, HALO), codes,
                    uniform["mats"], paired=True, compact_cap=2 * B,
                    canonical=True)
    assert not bool(ref.mapped[1]) and int(ref.mapq[1]) == 0
    rest = np.arange(B) != 1
    for f in ("mapped", "proper", "second", "mapq"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f))[rest],
                                      getattr(got, f).numpy()[rest])
    assert_equal(ref, got, skip=("mapped", "proper", "second", "mapq"))


@pytest.fixture(scope="module")
def skew():
    """Every read from the first quarter of the genome: shard 0's core at
    S = 4, the position-sorted worst case for per-shard tail budgets."""
    g = random_genome(64_000, seed=91)
    idx = KmerIndex.build(g, k=K, skip=2, max_freq=1000)
    reads = simulate_reads(g[:16_000], B, read_len=L, snp_rate=0.03,
                           indel_rate=0.003, seed=92)
    pairs = simulate_pairs(g[:16_000], B // 2, read_len=L, insert_mean=300,
                           insert_sd=30, snp_rate=0.02, seed=93)
    sidx = tshard.ShardedIndex.build(index_from_reference(idx), g, 4, HALO)
    return dict(g=g, idx=idx, ref_sidx=jshard.ShardedIndex.build(idx, g, 4,
                                                                 HALO),
                tables=tshard.ShardTables.from_index(sidx, "cpu"),
                codes=np.stack([r.codes for r in reads]),
                pcodes=np.stack([m.codes for p in pairs for m in p]),
                mats=np.stack([score_matrix(CFG, 0), score_matrix(CFG, 1)]))


@pytest.mark.parametrize("paired", [False, True])
def test_skewed_batch_pool_exact(skew, paired):
    """A pool of 2B rows covers a batch that lies wholly in one shard: it
    equals the full per-shard tails, and the unsharded step."""
    codes = skew["pcodes" if paired else "codes"]
    run = lambda cap: _port_step(  # noqa: E731
        skew["tables"], codes, skew["mats"], paired=paired,
        compact_cap=cap, canonical=False)
    pool, full = run(2 * B), run(0)
    for f in pool._fields:
        assert torch.equal(getattr(full, f), getattr(pool, f)), f
    assert int(pool.mapped.sum()) >= (56 if paired else 60)
    off, pos = skew["idx"].device_arrays()
    single = (tmapper.map_step_paired if paired else tmapper.map_step)(
        torch.from_numpy(skew["g"]), torch.from_numpy(off),
        torch.from_numpy(pos), torch.from_numpy(codes),
        torch.full((B,), L, dtype=torch.int32), torch.from_numpy(skew["mats"]),
        *SCALARS, *(PAIR if paired else ()), canonical=False, **STATICS)
    for f in ("mapped", "strand", "score", "mapq", "second", "proper",
              "cmr_overflow"):
        assert torch.equal(getattr(single, f), getattr(pool, f)), f
    assert torch.equal(single.pos.long(), pool.pos)


def test_skewed_batch_overflow_counted(skew):
    """A pool of 32 rows drops groups of the skewed batch and counts every
    dropped one in cmr_overflow, as JAX's scan does, field for field."""
    run = lambda cap: _port_step(  # noqa: E731
        skew["tables"], skew["codes"], skew["mats"], paired=False,
        compact_cap=cap, canonical=False)
    tiny, full = run(32), run(0)
    assert_equal(_jax_scan(skew["ref_sidx"], skew["codes"], skew["mats"],
                           paired=False, compact_cap=32, canonical=False),
                 tiny)
    lost = int(full.mapped.sum()) - int(tiny.mapped.sum())
    assert lost > 0
    assert int(tiny.cmr_overflow) - int(full.cmr_overflow) >= lost


@pytest.fixture(scope="module")
def repeats():
    g = synthetic.repeat_genome(60_000, n_repeats=14, min_len=800,
                                max_len=2000, seed=81)
    codes, _, _ = synthetic.simulate_reads(g, B, L, 0.02, seed=82)
    pcodes, _, _ = synthetic.simulate_pairs(g, B // 2, L, 0.02,
                                            insert_mean=300, insert_sd=30,
                                            seed=83)

    class _G:
        pass

    gen = _G()
    gen.codes = g
    return dict(g=g, gen=gen, codes=codes, pcodes=pcodes)


def _mappers(cfg, gen, index):
    return (jmapper.Mapper(cfg, gen, L, index=index),
            tmapper.Mapper(config_from_reference(cfg), gen, L,
                           index_from_reference(index), device="cpu"))


@pytest.mark.parametrize("S", [2, 3])
def test_topn_merge_per_rank(repeats, S):
    """-n 3 with --index-shards: every rank of the port's merge equals the
    JAX Mapper's, and its alignments are the port's unsharded ones."""
    cfg = NgmConfig(kmer=K, topn=3, index_shards=S)
    idx = KmerIndex.build(repeats["g"], k=K, skip=2, max_freq=1000,
                          canonical=True)
    ref_m, port_m = _mappers(cfg, repeats["gen"], idx)
    lens = np.full(B, L, np.int32)
    ref = ref_m.map_batch_topn(repeats["codes"], lens)
    got = port_m.map_batch_topn(repeats["codes"], lens)
    assert len(ref) == len(got) == 3
    for r, g in zip(ref, got):
        assert_equal(r, g)
    assert int(got[1].mapped.sum()) > 0

    # the unsharded ranks: the same alignments (the merge's MAPQ second
    # best sees each shard's top ranks only, so MAPQ may differ)
    flat = tmapper.Mapper(config_from_reference(cfg.replace(index_shards=1)),
                          repeats["gen"], L, index_from_reference(idx),
                          device="cpu")
    for r, g in zip(flat.map_batch_topn(repeats["codes"], lens), got):
        assert torch.equal(r.mapped, g.mapped)
        m = r.mapped
        for f in ("strand", "score", "ops", "n_ops", "q_start", "q_end"):
            assert torch.equal(getattr(r, f)[m], getattr(g, f)[m]), f
        assert torch.equal(r.pos[m].long(), g.pos[m])


@pytest.mark.parametrize("step", ["map_batch", "map_batch_paired"])
def test_bisulfite_two_shards(repeats, step):
    """--bs-mapping with 2 shards: the dual (CT, GA) tables slice by the
    same ranges and run full per-shard tails, as the reference's default
    loop does."""
    g = repeats["g"]
    if step == "map_batch_paired":
        codes = synthetic.bisulfite_convert(repeats["pcodes"], 0.8,
                                            np.random.default_rng(84))
    else:
        codes, _, _ = synthetic.simulate_bisulfite_reads(g, B, L, 0.8,
                                                         seed=84)
    cfg = NgmConfig(kmer=K, bs_mapping=True, index_shards=2)
    pair = tuple(KmerIndex.build(g, k=K, skip=2, max_freq=1000, collapse=c)
                 for c in ("ct", "ga"))
    ref_m, port_m = _mappers(cfg, repeats["gen"], pair)
    assert port_m.tail_cap(B) == 0 and port_m.hit_cap == ref_m.hit_cap
    lens = np.full(B, L, np.int32)
    got = getattr(port_m, step)(codes, lens)
    assert_equal(getattr(ref_m, step)(codes, lens), got)
    assert int(got.mapped.sum()) >= (50 if step == "map_batch" else 40)


def test_repeat_genome_large_draws_uint8_chunks():
    """The gigabase phase's genome generator: uint8 codes 0..3 drawn in
    chunks (two here), the same bytes for the same seed, and its planted
    repeats (the exact, even-numbered copies) found again."""
    size = (1 << 26) + 4096
    g = synthetic.repeat_genome_large(size, n_repeats=2, min_len=500,
                                      max_len=600, seed=5)
    assert g.dtype == np.uint8 and g.shape == (size,) and int(g.max()) == 3
    np.testing.assert_array_equal(
        g, synthetic.repeat_genome_large(size, n_repeats=2, min_len=500,
                                         max_len=600, seed=5))
    rng = np.random.default_rng(5)
    for i in range(0, size, 1 << 26):      # the draws the chunks consumed
        rng.integers(0, 4, min(1 << 26, size - i), dtype=np.uint8)
    n = int(rng.integers(500, 601))
    src, dst = rng.integers(0, size - n, 2)
    np.testing.assert_array_equal(g[dst:dst + n], g[src:src + n])
