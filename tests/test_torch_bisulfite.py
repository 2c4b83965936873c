"""Port's bisulfite mode and two-strand candidate search (device cpu) == the
JAX reference.

  * extract_kmers for collapse none/ct/ga, with and without the
    --bs-cutoff drop, at strides 1 and 2;
  * build_index_device for the CT and GA tables and the non-canonical plain
    one, and their concatenation;
  * candidate_search_dual with one table and with two (bisulfite), packed
    and unpacked, and at a hit cap small enough to overflow;
  * map_step, map_step_paired and map_step_topn with bs, and with bs and
    end_to_end together;
  * Mapper with bs_mapping (the same state as the JAX Mapper's, from a
    device build and from a (CT, GA) pair of host indexes) and with a
    non-canonical host KmerIndex;
  * the CLI's SAM against the JAX CLI's for --bs-mapping, --bs-cutoff 3,
    --bs-mapping -n 2 and --bs-mapping -1/-2, and with memoized CT and GA
    host indexes, which both runners load.
Workload: bisulfite-converted reads (original top and bottom strands, 80%
of C read as T) from a 60 kbp genome with planted repeats and a poly-T run.
Tolerance: exact equality of every output, all 17 MapResult fields of
every rank, and SAM byte-identical apart from the @PG line.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nextgenmap_tpu.cli import main as jax_main  # noqa: E402
from nextgenmap_tpu.config import NgmConfig  # noqa: E402
from nextgenmap_tpu.index.device_build import build_index_device as j_build  # noqa: E402
from nextgenmap_tpu.index.kmer_index import KmerIndex  # noqa: E402
from nextgenmap_tpu.models import mapper as jmapper  # noqa: E402
from nextgenmap_tpu.ops import candidate as jcand  # noqa: E402
from nextgenmap_tpu.ops.kmer import extract_kmers as j_kmers  # noqa: E402
from nextgenmap_tpu.ops.scoring import matrices_are_simple  # noqa: E402
from nextgenmap_tpu_torch import cli as tcli  # noqa: E402
from nextgenmap_tpu_torch import synthetic  # noqa: E402
from nextgenmap_tpu_torch.convert import (  # noqa: E402
    config_from_reference, index_from_reference, state_from_numpy,
)
from nextgenmap_tpu_torch.index.device_build import (  # noqa: E402
    build_index_device, concat_tables,
)
from nextgenmap_tpu_torch.models import mapper as tmapper  # noqa: E402
from nextgenmap_tpu_torch.ops import candidate as tcand  # noqa: E402
from nextgenmap_tpu_torch.ops.kmer import extract_kmers  # noqa: E402
from nextgenmap_tpu_torch.pipeline import runner as trunner  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

K = 11
L = 100
B = 64
POLY_T = (40_000, 40_400)


def t(a):
    return torch.from_numpy(np.array(a))


def assert_fields_equal(ref, got, what=""):
    assert ref._fields == got._fields
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).cpu().numpy()
        assert a.dtype == b.dtype, (what, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")


@pytest.fixture(scope="module")
def genome():
    g = synthetic.repeat_genome(60_000, n_repeats=12, min_len=800,
                                max_len=2000, seed=81)
    g[POLY_T[0]:POLY_T[1]] = 3
    g[5000:5004] = 4                      # an N run inside the genome
    return g


@pytest.fixture(scope="module")
def reads(genome):
    """B bisulfite reads: 6 from the poly-T run (hit-cap overflow), one
    with N bases, three short."""
    codes, _, _ = synthetic.simulate_bisulfite_reads(genome, B, L, seed=82)
    for i in range(6):
        p = POLY_T[0] + 40 * i
        codes[B - 10 + i] = genome[p:p + L]
    codes[3, 20:23] = 4
    lens = np.full(B, L, np.int32)
    lens[-3:] = [70, 45, 9]               # 9 < k: no k-mer at all
    for i in (1, 2, 3):
        codes[-i, lens[-i]:] = 4
    return codes, lens


def _jax_tables(g):
    """The JAX Mapper's bisulfite layout: CT table, then GA shifted."""
    o1, p1 = j_build(jnp.asarray(g), k=K, skip=1, collapse="ct")
    o2, p2 = j_build(jnp.asarray(g), k=K, skip=1, collapse="ga")
    return (jnp.concatenate([o1, o2 + p1.shape[0]]),
            jnp.concatenate([p1, p2]))


@pytest.mark.parametrize("collapse,cutoff", [
    ("none", 0), ("ct", 0), ("ct", 3), ("ga", 0), ("ga", 3),
])
@pytest.mark.parametrize("stride", [1, 2])
def test_extract_kmers_equal_jax(reads, collapse, cutoff, stride):
    codes, lens = reads
    ref = j_kmers(jnp.asarray(codes), jnp.asarray(lens), K, stride=stride,
                  collapse=collapse, max_collapsed=cutoff)
    got = extract_kmers(t(codes), t(lens), K, stride=stride,
                        collapse=collapse, max_collapsed=cutoff)
    for a, b in zip(ref, got):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ok = got[1].numpy()
    assert not ok[3].all() and not ok[-1].any()      # N bases, 9 bp read
    if cutoff:   # the drop removed windows the plain collapse keeps
        full = extract_kmers(t(codes), t(lens), K, stride=stride,
                             collapse=collapse)[1].numpy()
        assert (full & ~ok).any()


@pytest.mark.parametrize("collapse", ["ct", "ga", "none"])
def test_index_build_equals_jax(genome, collapse):
    ref = j_build(jnp.asarray(genome), k=K, skip=2, collapse=collapse,
                  canonical=False)
    got = build_index_device(t(genome), k=K, skip=2, collapse=collapse,
                             canonical=False)
    for a, b in zip(ref, got):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_concat_tables_equal_jax_layout(genome):
    ref = _jax_tables(genome)
    got = concat_tables(
        *build_index_device(t(genome), k=K, skip=1, collapse="ct",
                            canonical=False),
        *build_index_device(t(genome), k=K, skip=1, collapse="ga",
                            canonical=False),
    )
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with pytest.raises(ValueError):
        build_index_device(t(genome), k=K, skip=1, collapse="ct")


@pytest.mark.parametrize("dual,packed,hit_cap", [
    (True, False, 256), (True, True, 256), (True, True, 64),
    (False, False, 128), (False, True, 320),
])
def test_candidate_search_dual_equals_jax(genome, reads, dual, packed,
                                          hit_cap):
    """Two tables (bisulfite) or one (the plain non-canonical index);
    hit_cap 64 overflows on the poly-T reads."""
    codes, lens = reads
    if dual:
        off, pos = _jax_tables(genome)
    else:
        off, pos = j_build(jnp.asarray(genome), k=K, skip=1)
    cut = 6 if dual else 0
    rc = jmapper._shifted_rc(jnp.asarray(codes), jnp.asarray(lens))
    kf = j_kmers(jnp.asarray(codes), jnp.asarray(lens), K, stride=2,
                 collapse="ct" if dual else "none", max_collapsed=cut)
    kr = j_kmers(rc, jnp.asarray(lens), K, stride=2,
                 collapse="ga" if dual else "none", max_collapsed=cut)
    j_tab = jcand.pack_offsets(off, 1000, 32) if packed else off
    kw = dict(fanout_cap=32, hit_cap=hit_cap, max_cmrs=3, diag_bin_log2=4,
              stride=2, dual_tables=dual, packed_offsets=packed)
    ref = jcand.candidate_search_dual(*kf, *kr, j_tab, pos, jnp.float32(0.3),
                                      jnp.int32(1000), **kw)
    tab = tcand.pack_offsets(t(off), 1000, 32) if packed else t(off)
    got = tcand.candidate_search_dual(
        *(t(a) for a in (*kf, *kr)), tab, t(pos),
        torch.tensor(0.3, dtype=torch.float32), 1000, **kw,
    )
    assert_fields_equal(ref, got, "dual")
    if hit_cap == 64:
        assert int(got.hit_overflow) > 0
    valid = got.score.numpy() > 0
    assert set(got.strand.numpy()[valid]) == {0, 1}    # both passes hit


@pytest.fixture(scope="module")
def bs_state(genome):
    """(cfg, JAX args, port state, packed port offsets, statics)."""
    cfg = NgmConfig(kmer=K, bs_mapping=True)
    off, pos = _jax_tables(genome)
    mats = tmapper.score_matrices(config_from_reference(cfg))
    statics = dict(
        k=K, fanout_cap=cfg.max_kmer_fanout,
        hit_cap=cfg.resolved_read_hits(pos.shape[0] // 2, L),
        max_cmrs=cfg.max_cmrs, diag_bin_log2=cfg.diag_bin_log2,
        band=cfg.corridor_for(L), min_kmer_hits=1,
        read_stride=cfg.read_kmer_skip, packed_offsets=True,
        simple_matrix=matrices_are_simple(mats), bs=True,
        bs_cutoff=cfg.bs_cutoff,
    )
    jargs = (
        jnp.asarray(genome), jcand.pack_offsets(off, 1000, 32), pos,
        jnp.asarray(mats),
    )
    state = state_from_numpy(genome, off, pos, mats, "cpu")
    packed = tcand.pack_offsets(state.offsets, 1000, cfg.max_kmer_fanout)
    return cfg, jargs, state, packed, statics


SCALARS = (20, 20, 20, 0.5, 1000, 0.65, 0.5)


def _jscalars():
    return (jnp.int32(20), jnp.int32(20), jnp.int32(20), jnp.float32(0.5),
            jnp.int32(1000), jnp.float32(0.65), jnp.float32(0.5))


@pytest.mark.parametrize("end_to_end", [False, True])
@pytest.mark.parametrize("step", ["single", "paired", "topn"])
def test_map_steps_equal_jax_under_bs(genome, reads, bs_state, step,
                                      end_to_end):
    cfg, (jg, joff, jpos, jmats), state, packed, statics = bs_state
    codes, lens = reads
    statics = dict(statics, end_to_end=end_to_end)
    if step == "paired":   # FR pairs, both mates bisulfite-converted
        pc, _, _ = synthetic.simulate_pairs(genome, B // 2, L, 0.01, seed=83)
        codes = synthetic.bisulfite_convert(pc, 0.8,
                                            np.random.default_rng(84))
        lens = np.full(B, L, np.int32)
    jfront = (jg, joff, jpos, jnp.asarray(codes), jnp.asarray(lens), jmats,
              *_jscalars())
    front = (state.genome, packed, state.positions, t(codes), t(lens),
             state.matrices, *SCALARS)
    if step == "single":
        ref = jmapper.map_step(*jfront, **statics)
        got = tmapper.map_step(*front, **statics)
        assert_fields_equal(ref, got, step)
        results = [got]
    elif step == "paired":
        pair = (0, 500, 0.9)
        ref = jmapper.map_step_paired(*jfront, jnp.int32(0), jnp.int32(500),
                                      jnp.float32(0.9), **statics)
        got = tmapper.map_step_paired(*front, *pair, **statics)
        assert_fields_equal(ref, got, step)
        assert int(got.proper.sum()) >= B // 2
        results = [got]
    else:
        ref = jmapper.map_step_topn(*jfront, **statics, topn=2)
        results = tmapper.map_step_topn(*front, **statics, topn=2)
        for j, (r, g) in enumerate(zip(ref, results)):
            assert_fields_equal(r, g, f"rank {j}")
    top = results[0]
    assert int(top.mapped.sum()) >= 0.8 * B
    # both strands map, and some read had a second candidate scored
    assert set(top.strand.numpy()[top.mapped.numpy()]) == {0, 1}
    assert int((top.n_candidates >= 2).sum()) > 0


@pytest.mark.parametrize("host_pair", [False, True])
def test_mapper_bs_state_and_results_equal_jax(genome, reads, host_pair):
    """index=None: both build the two collapsed tables on the device; a
    (CT, GA) pair of host KmerIndexes is carried across by both."""
    cfg = NgmConfig(kmer=K, bs_mapping=True)
    codes, lens = reads

    class _G:
        pass

    g = _G()
    g.codes = genome
    index = None
    if host_pair:
        index = tuple(
            KmerIndex.build(genome, K, 1, cfg.max_kmer_freq, c, "x")
            for c in ("ct", "ga"))
    ref = jmapper.Mapper(cfg, g, L, index)
    port = tmapper.Mapper(config_from_reference(cfg), g, L,
                          index and index_from_reference(index), device="cpu")
    assert not port.canonical and port.packed_offsets
    assert port.hit_cap == ref.hit_cap
    np.testing.assert_array_equal(np.asarray(ref._off_dev).astype(np.int64),
                                  port._offsets.numpy())
    n = port.state.positions.shape[0]
    jpos = np.asarray(ref._pos_dev)          # padded to a multiple of 8
    np.testing.assert_array_equal(jpos[:n], port.state.positions.numpy())
    assert not jpos[n:].any()
    assert_fields_equal(ref.map_batch(codes, lens),
                        port.map_batch(codes, lens))


def test_mapper_non_canonical_host_index_equals_jax(genome, reads):
    """A host KmerIndex built without canonical entries takes the
    two-strand path with one table, in both packages."""
    cfg = NgmConfig(kmer=K)
    codes, lens = reads
    idx = KmerIndex.build(genome, K, 1, cfg.max_kmer_freq, "none", "x")
    assert not idx.canonical

    class _G:
        pass

    g = _G()
    g.codes = genome
    ref = jmapper.Mapper(cfg, g, L, idx)
    port = tmapper.Mapper(config_from_reference(cfg), g, L,
                          index_from_reference(idx), device="cpu")
    assert not port.canonical and not port.statics()["bs"]
    assert_fields_equal(ref.map_batch(codes, lens),
                        port.map_batch(codes, lens))
    for j, (r, p) in enumerate(zip(ref.map_batch_topn(codes, lens),
                                   port.map_batch_topn(codes, lens))):
        assert_fields_equal(r, p, f"rank {j}")


@pytest.fixture(scope="module")
def bs_files(tmp_path_factory):
    """A genome with few repeats, so truth accuracy means something."""
    d = tmp_path_factory.mktemp("torch_bs")
    genome = synthetic.repeat_genome(60_000, n_repeats=3, min_len=800,
                                     max_len=1500, seed=88)
    synthetic.write_fasta(str(d / "ref.fa"), "chrB", genome)
    codes, pos, strand = synthetic.simulate_bisulfite_reads(genome, 80, L,
                                                            seed=85)
    synthetic.write_fastq(str(d / "bs.fq"), codes, pos, strand)
    pc, pp, ps = synthetic.simulate_pairs(genome, 30, L, 0.01, seed=86)
    pc = synthetic.bisulfite_convert(pc, 0.8, np.random.default_rng(87))
    for m in (0, 1):
        synthetic.write_fastq(str(d / f"r{m + 1}.fq"), pc[m::2], pp[m::2],
                              ps[m::2], prefix="simpair")
    return d


def _records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


@pytest.mark.parametrize("name,extra", [
    ("bs", ("--bs-mapping",)),
    ("bs_cutoff3", ("--bs-mapping", "--bs-cutoff", "3")),
    ("bs_n2", ("--bs-mapping", "-n", "2")),
    ("bs_pe", ("--bs-mapping",)),
])
def test_sam_identical_to_jax_cli(bs_files, name, extra):
    d = bs_files
    reads = (["-1", str(d / "r1.fq"), "-2", str(d / "r2.fq")]
             if name == "bs_pe" else ["-q", str(d / "bs.fq")])
    common = ["map", "-r", str(d / "ref.fa"), *reads, "-k", str(K),
              "--batch-size", "32", "--no-progress", "--skip-save", *extra]
    assert jax_main(common + ["-o", str(d / f"jax_{name}.sam")]) == 0
    tcli.run(common + ["-o", str(d / f"torch_{name}.sam"), "--device", "cpu"])
    got = _records(d / f"torch_{name}.sam")
    assert got == _records(d / f"jax_{name}.sam")
    if name != "bs_pe":
        c = synthetic.sam_counts(str(d / f"torch_{name}.sam"))
        assert c["correct"] >= 0.9 * 80, c


def test_memoized_tables_sam_identical_to_jax_cli(tmp_path):
    """A (CT, GA) pair of memoized host indexes is what both runners load in
    bisulfite mode; the SAM stays byte-identical."""
    g = synthetic.repeat_genome(40_000, n_repeats=2, min_len=800,
                                max_len=1200, seed=89)
    ref = str(tmp_path / "ref.fa")
    synthetic.write_fasta(ref, "chrM", g)
    codes, pos, strand = synthetic.simulate_bisulfite_reads(g, 40, L, seed=90)
    synthetic.write_fastq(str(tmp_path / "bs.fq"), codes, pos, strand)
    cfg = NgmConfig(kmer=K, bs_mapping=True)
    genome, index = trunner.load_reference(config_from_reference(cfg), ref)
    assert index is None                   # nothing memoized yet
    for c in ("ct", "ga"):
        KmerIndex.open(ref, genome.codes, genome.sha1(), k=K, skip=1,
                       max_freq=cfg.max_kmer_freq, collapse=c)
    _, index = trunner.load_reference(config_from_reference(cfg), ref)
    assert [i.collapse for i in index] == ["ct", "ga"]
    common = ["map", "-r", ref, "-q", str(tmp_path / "bs.fq"), "-k", str(K),
              "--batch-size", "32", "--bs-mapping", "--no-progress"]
    assert jax_main(common + ["-o", str(tmp_path / "jax.sam")]) == 0
    tcli.run(common + ["-o", str(tmp_path / "torch.sam"), "--device", "cpu"])
    assert _records(tmp_path / "torch.sam") == _records(tmp_path / "jax.sam")
    assert synthetic.sam_counts(str(tmp_path / "torch.sam"))["correct"] >= 36
