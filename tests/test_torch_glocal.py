"""Port's glocal (--end-to-end) mode (device cpu) == the JAX reference.

  * banded_sw_score and banded_sw_align with mode="glocal" against the JAX
    functions on every field and against tests/oracle_sw.py, on the cases
    of tests/test_end_to_end_mode.py (including the N tail), on reads
    shorter than the batch's L, and at the long-read band W = 184 with two
    general matrices;
  * K1's wrapper on a CPU tensor runs the plain glocal version;
  * map_step, map_step_paired and map_step_topn with end_to_end;
  * the CLI's SAM against the JAX CLI's for --end-to-end, single-end and
    -1/-2, with no soft clip in any record.
Tolerance: exact equality (integer DP; the filters' float32 arithmetic is
the same op sequence), and SAM byte-identical apart from the @PG line.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nextgenmap_tpu.cli import main as jax_main  # noqa: E402
from nextgenmap_tpu.config import NgmConfig  # noqa: E402
from nextgenmap_tpu.index.device_build import build_index_device  # noqa: E402
from nextgenmap_tpu.models import mapper as jmapper  # noqa: E402
from nextgenmap_tpu.ops import sw_ref as jsw  # noqa: E402
from nextgenmap_tpu.ops.candidate import pack_offsets  # noqa: E402
from nextgenmap_tpu.ops.scoring import matrices_are_simple, score_matrix  # noqa: E402
from nextgenmap_tpu_torch import cli as tcli  # noqa: E402
from nextgenmap_tpu_torch import synthetic  # noqa: E402
from nextgenmap_tpu_torch.convert import (  # noqa: E402
    config_from_reference, state_from_numpy,
)
from nextgenmap_tpu_torch.models import mapper as tmapper  # noqa: E402
from nextgenmap_tpu_torch.ops import candidate as tcand  # noqa: E402
from nextgenmap_tpu_torch.ops import sw_ref as tsw  # noqa: E402
from nextgenmap_tpu_torch.ops.sw_kernel import sw_score  # noqa: E402
from tests.oracle_sw import banded_sw_oracle  # noqa: E402
from tests.test_end_to_end_mode import MAT, _rand_batch  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

L = 100
B = 64


def assert_fields_equal(ref, got, what=""):
    assert ref._fields == got._fields
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).cpu().numpy()
        assert a.dtype == b.dtype, (what, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")


def case(name):
    """(query, qlen, corridor, matrices, msel, gaps, W) for one named case."""
    if name == "score_l40":        # test_glocal_score_matches_oracle
        q, r = _rand_batch(np.random.default_rng(31), 24, 40, 16)
        return q, np.full(24, 40, np.int32), r, MAT, None, (20, 20, 20), 16
    if name == "align_l32":        # test_glocal_align_matches_oracle_...
        q, r = _rand_batch(np.random.default_rng(32), 16, 32, 16, mutate=0.15)
        return q, np.full(16, 32, np.int32), r, MAT, None, (20, 20, 20), 16
    if name == "n_tail":           # test_glocal_vs_local_on_bad_tail
        rng = np.random.default_rng(33)
        q = rng.integers(0, 4, (1, 50)).astype(np.uint8)
        r = rng.integers(0, 4, (1, 66)).astype(np.uint8)
        r[0, 4:54] = q[0]
        q[0, 40:] = 4
        return q, np.full(1, 50, np.int32), r, MAT, None, (20, 20, 20), 16
    if name == "short_qlen":       # reads shorter than L, N-padded, and empty
        q, r = _rand_batch(np.random.default_rng(34), 12, 40, 16)
        lens = np.array([40, 39, 25, 8, 1, 0, 40, 33, 17, 40, 2, 30], np.int32)
        for i, n in enumerate(lens):
            q[i, n:] = 4
        return q, lens, r, MAT, None, (20, 20, 20), 16
    if name == "wide184_bs":       # long-read band, two general matrices
        rng = np.random.default_rng(35)
        S, Lw, W = 6, 200, 184
        q = rng.integers(0, 4, (S, Lw)).astype(np.uint8)
        r = rng.integers(0, 4, (S, Lw + W)).astype(np.uint8)
        for i in range(S):
            o = int(rng.integers(0, W - 8))
            r[i, o:o + Lw // 2] = q[i, :Lw // 2]
            r[i, o + Lw // 2 + 3:o + Lw + 3] = q[i, Lw // 2:]   # a deletion
        cfg = NgmConfig(bs_mapping=True)
        mats = np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])
        msel = (np.arange(S) % 2).astype(np.int32)
        return q, np.full(S, Lw, np.int32), r, mats, msel, (25, 30, 7), W
    raise KeyError(name)


CASES = ["score_l40", "align_l32", "n_tail", "short_qlen", "wide184_bs"]


def _jax_args(q, lens, r, mats, msel, gaps):
    return (jnp.asarray(q), jnp.asarray(lens), jnp.asarray(r),
            jnp.asarray(mats), *(jnp.int32(g) for g in gaps),
            None if msel is None else jnp.asarray(msel))


def _torch_args(q, lens, r, mats, msel, gaps):
    return (torch.from_numpy(q), torch.from_numpy(lens), torch.from_numpy(r),
            torch.from_numpy(mats), *gaps,
            None if msel is None else torch.from_numpy(msel))


@pytest.mark.parametrize("name", CASES)
def test_glocal_sw_equals_jax_and_oracle(name):
    q, lens, r, mats, msel, gaps, W = case(name)
    ja, ta = _jax_args(q, lens, r, mats, msel, gaps), _torch_args(
        q, lens, r, mats, msel, gaps)
    score = tsw.banded_sw_score(*ta, band=W, mode="glocal")
    assert_fields_equal(jsw.banded_sw_score(*ja, band=W, mode="glocal"),
                        score, "score")
    align = tsw.banded_sw_align(*ta, band=W, mode="glocal")
    assert_fields_equal(jsw.banded_sw_align(*ja, band=W, mode="glocal"),
                        align, "align")
    np.testing.assert_array_equal(score.score.numpy(), align.score.numpy())
    got = align.score.numpy() > 0
    assert got.any()
    # the whole read is consumed: no clipping
    np.testing.assert_array_equal(align.q_start.numpy()[got], 0)
    np.testing.assert_array_equal(align.q_end.numpy()[got], lens[got] - 1)
    if msel is not None:
        return
    for i in range(q.shape[0]):
        n = int(lens[i])
        if n == 0:
            assert int(align.score[i]) == 0
            continue
        o = banded_sw_oracle(q[i, :n], n, r[i], MAT, *gaps, W, mode="glocal")
        assert int(score.score[i]) == o["score"], i
        if o["score"] > 0:
            assert int(score.end_i[i]) == o["end_i"] == n - 1
            assert int(score.end_o[i]) == o["end_o"]
            no = int(align.n_ops[i])
            assert list(align.ops[i, :no].numpy()) == o["ops"], i
            assert int(align.matches[i]) == o["matches"]
            assert int(align.indels[i]) == o["indels"]


def test_glocal_aligns_through_the_n_tail():
    """Local mode clips the N tail; glocal aligns it, at a lower score."""
    q, lens, r, mats, msel, gaps, W = case("n_tail")
    ta = _torch_args(q, lens, r, mats, msel, gaps)
    loc = tsw.banded_sw_align(*ta, band=W, mode="local")
    glo = tsw.banded_sw_align(*ta, band=W, mode="glocal")
    assert int(loc.q_end[0]) < 49 and int(glo.q_end[0]) == 49
    assert int(glo.score[0]) < int(loc.score[0])
    assert int(glo.mismatches[0]) >= 10


def test_kernel_wrapper_glocal_on_cpu_runs_plain_version():
    q, lens, r, mats, msel, gaps, W = case("wide184_bs")
    ta = _torch_args(q, lens, r, mats, msel, gaps)
    before = sw_score.launches
    assert_fields_equal(tsw.banded_sw_score(*ta, band=W, mode="glocal"),
                        sw_score(*ta, band=W, mode="glocal"))
    assert sw_score.launches == before


@pytest.fixture(scope="module")
def repeats():
    """(cfg, genome, JAX state args, port state, packed offsets, statics)."""
    cfg = NgmConfig(kmer=11, end_to_end=True)
    g = synthetic.repeat_genome(50_000, n_repeats=12, min_len=800,
                                max_len=2000, seed=71)
    off, pos = build_index_device(jnp.asarray(g), k=11, skip=1, canonical=True)
    mats = tmapper.score_matrices(config_from_reference(cfg))
    statics = dict(
        k=11, fanout_cap=cfg.max_kmer_fanout,
        hit_cap=cfg.resolved_read_hits(pos.shape[0], L),
        max_cmrs=cfg.max_cmrs, diag_bin_log2=cfg.diag_bin_log2,
        band=cfg.corridor_for(L), min_kmer_hits=1,
        read_stride=cfg.read_kmer_skip, packed_offsets=True,
        end_to_end=True,
    )
    jstate = (jnp.asarray(g), pack_offsets(off, 1000, cfg.max_kmer_fanout),
              pos, jnp.asarray(mats))
    state = state_from_numpy(g, off, pos, mats, "cpu")
    packed = tcand.pack_offsets(state.offsets, 1000, cfg.max_kmer_fanout)
    return cfg, g, jstate, state, packed, statics


@pytest.mark.parametrize("step", ["single", "paired", "topn"])
def test_map_steps_equal_jax_under_end_to_end(repeats, step):
    cfg, g, (jg, joff, jpos, jmats), state, packed, statics = repeats
    if step == "paired":
        codes, _, _ = synthetic.simulate_pairs(g, B // 2, L, 0.02, seed=72)
        lens = np.full(B, L, np.int32)
    else:
        codes, _, _ = synthetic.simulate_reads(g, B, L, 0.02, seed=73)
        codes[5, 90:] = 4                      # an N tail
        lens = np.full(B, L, np.int32)
        lens[-2:] = [70, 40]
        codes[-2, 70:] = codes[-1, 40:] = 4
    jfront = (jg, joff, jpos, jnp.asarray(codes), jnp.asarray(lens), jmats,
              jnp.int32(20), jnp.int32(20), jnp.int32(20), jnp.float32(0.5),
              jnp.int32(1000), jnp.float32(0.65), jnp.float32(0.5))
    front = (state.genome, packed, state.positions, torch.from_numpy(codes),
             torch.from_numpy(lens), state.matrices,
             20, 20, 20, 0.5, 1000, 0.65, 0.5)
    jstatics = dict(statics, canonical=True,
                    simple_matrix=matrices_are_simple(jmats))
    if step == "single":
        results = [tmapper.map_step(*front, **statics)]
        refs = [jmapper.map_step(*jfront, **jstatics)]
    elif step == "paired":
        results = [tmapper.map_step_paired(*front, 0, 1000, 0.9, **statics)]
        refs = [jmapper.map_step_paired(
            *jfront, jnp.int32(0), jnp.int32(1000), jnp.float32(0.9),
            **jstatics)]
    else:
        results = tmapper.map_step_topn(*front, **statics, topn=2)
        refs = jmapper.map_step_topn(*jfront, **jstatics, topn=2)
    for j, (r, got) in enumerate(zip(refs, results)):
        assert_fields_equal(r, got, f"rank {j}")
    top = results[0]
    m = top.mapped.numpy()
    assert m.sum() >= 0.9 * B
    # no clipping: every mapped read is aligned from its first base to its last
    np.testing.assert_array_equal(top.q_start.numpy()[m], 0)
    np.testing.assert_array_equal(top.q_end.numpy()[m], lens[m] - 1)
    assert int((top.n_candidates >= 2).sum()) > 0


@pytest.fixture(scope="module")
def e2e_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_e2e")
    g = synthetic.repeat_genome(40_000, n_repeats=6, min_len=600,
                                max_len=1500, seed=74)
    synthetic.write_fasta(str(d / "ref.fa"), "chrE", g)
    codes, pos, strand = synthetic.simulate_reads(g, 90, L, 0.03, seed=75)
    synthetic.write_fastq(str(d / "se.fq"), codes, pos, strand)
    pc, pp, ps = synthetic.simulate_pairs(g, 40, L, 0.02, seed=76)
    for m in (0, 1):
        synthetic.write_fastq(str(d / f"r{m + 1}.fq"), pc[m::2], pp[m::2],
                              ps[m::2], prefix="simpair")
    return d


def _records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


@pytest.mark.parametrize("name", ["single", "paired"])
def test_sam_identical_to_jax_cli(e2e_files, name):
    d = e2e_files
    reads = (["-1", str(d / "r1.fq"), "-2", str(d / "r2.fq")]
             if name == "paired" else ["-q", str(d / "se.fq")])
    common = ["map", "-r", str(d / "ref.fa"), *reads, "-k", "11",
              "--batch-size", "32", "--end-to-end", "--no-progress",
              "--skip-save"]
    assert jax_main(common + ["-o", str(d / f"jax_{name}.sam")]) == 0
    tcli.run(common + ["-o", str(d / f"torch_{name}.sam"), "--device", "cpu"])
    got = _records(d / f"torch_{name}.sam")
    assert got == _records(d / f"jax_{name}.sam")
    body = [ln.split("\t") for ln in got if not ln.startswith("@")]
    mapped = [f for f in body if not int(f[1]) & 4]
    assert len(mapped) >= 0.95 * len(body)
    assert not any("S" in f[5] or "H" in f[5] for f in mapped)
