"""Port's top-n / --strata path (device cpu) == the JAX reference.

  * map_step_topn for topn 2 and 3, and with a slot_cap below the number
    of candidates (score-slot and traceback-slot overflow), compared rank
    by rank;
  * the rank order on tied scores: top_ranks == jax.lax.top_k;
  * Mapper.map_batch_topn against the JAX Mapper;
  * the port's CLI SAM against the JAX CLI's for -n 2, -n 3 --strata and
    -n 2 --no-unal with the Python SamWriter, and against
    tests/golden/se_topn2.sam.
Tolerance: exact equality of all 17 MapResult fields of every rank, and SAM
byte-identical apart from the @PG line.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nextgenmap_tpu import native  # noqa: E402
from nextgenmap_tpu.cli import main as jax_main  # noqa: E402
from nextgenmap_tpu.config import NgmConfig  # noqa: E402
from nextgenmap_tpu.index.device_build import build_index_device  # noqa: E402
from nextgenmap_tpu.io.encode import decode_seq  # noqa: E402
from nextgenmap_tpu.io.fasta import write_fasta  # noqa: E402
from nextgenmap_tpu.io.simulate import (  # noqa: E402
    random_genome, simulate_reads as jsimulate_reads, write_fastq,
)
from nextgenmap_tpu.models import mapper as jmapper  # noqa: E402
from nextgenmap_tpu.ops.candidate import pack_offsets  # noqa: E402
from nextgenmap_tpu.ops.scoring import matrices_are_simple, score_matrix  # noqa: E402
from nextgenmap_tpu_torch import cli as tcli  # noqa: E402
from nextgenmap_tpu_torch.convert import (  # noqa: E402
    config_from_reference, state_from_numpy,
)
from nextgenmap_tpu_torch.models import mapper as tmapper  # noqa: E402
from nextgenmap_tpu_torch.ops import candidate as tcand  # noqa: E402
from nextgenmap_tpu_torch.synthetic import repeat_genome, simulate_reads  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

L = 100
B = 64
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def assert_ranks_equal(ref, got):
    assert len(ref) == len(got)
    for j, (r, g) in enumerate(zip(ref, got)):
        assert r._fields == g._fields
        for f in r._fields:
            a, b = np.asarray(getattr(r, f)), getattr(g, f).cpu().numpy()
            assert a.dtype == b.dtype, (j, f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"rank {j} {f}")


@pytest.fixture(scope="module")
def repeats():
    """(cfg, genome, reads, lens, offsets, JAX args, statics): reads from a
    60 kbp genome with planted exact and diverged repeats, three short."""
    cfg = NgmConfig(kmer=11)
    g = repeat_genome(60_000, n_repeats=16, min_len=800, max_len=2000, seed=61)
    reads, _, _ = simulate_reads(g, B, L, 0.02, seed=62)
    lens = np.full(B, L, np.int32)
    lens[-3:] = [70, 55, 40]
    for i in range(1, 4):
        reads[-i, lens[-i]:] = 4
    off, pos = build_index_device(jnp.asarray(g), k=11, skip=1, canonical=True)
    mats = np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])
    statics = dict(
        k=11, fanout_cap=cfg.max_kmer_fanout,
        hit_cap=cfg.resolved_read_hits(pos.shape[0], L),
        max_cmrs=cfg.max_cmrs, diag_bin_log2=cfg.diag_bin_log2,
        band=cfg.corridor_for(L), min_kmer_hits=1,
        read_stride=cfg.read_kmer_skip, packed_offsets=True,
        simple_matrix=matrices_are_simple(mats),
    )
    jargs = (
        jnp.asarray(g), pack_offsets(off, 1000, cfg.max_kmer_fanout), pos,
        jnp.asarray(reads), jnp.asarray(lens), jnp.asarray(mats),
        jnp.int32(20), jnp.int32(20), jnp.int32(20), jnp.float32(0.5),
        jnp.int32(1000), jnp.float32(0.65), jnp.float32(0.5),
    )
    return cfg, g, reads, lens, np.asarray(off), jargs, statics


@pytest.mark.parametrize("topn,slot_cap", [(2, 0), (3, 0), (2, 48)])
def test_map_step_topn_equals_jax(repeats, topn, slot_cap):
    cfg, g, reads, lens, off, jargs, statics = repeats
    ref = jmapper.map_step_topn(*jargs, **statics, canonical=True,
                                topn=topn, slot_cap=slot_cap)
    state = state_from_numpy(g, off, jargs[2], jargs[5], "cpu")
    packed = tcand.pack_offsets(state.offsets, 1000, cfg.max_kmer_fanout)
    got = tmapper.map_step_topn(
        state.genome, packed, state.positions, torch.from_numpy(reads),
        torch.from_numpy(lens), state.matrices,
        20, 20, 20, 0.5, 1000, 0.65, 0.5, **statics, topn=topn,
        slot_cap=slot_cap,
    )
    assert_ranks_equal(ref, got)
    nc = got[0].n_candidates
    if slot_cap:
        assert int(nc.sum()) > slot_cap and int(got[0].cmr_overflow) > 0
    else:
        assert int(got[0].mapped.sum()) >= 0.9 * B
        # repeat reads have a valid second rank
        assert int((got[1].mapped & (got[1].score > 0)).sum()) >= 4


def test_top_ranks_tie_order_matches_lax_top_k():
    """Equal scores in a [B, C] grid: ties go to the lower column."""
    rng = np.random.default_rng(63)
    sw = rng.integers(0, 4, (64, 8)).astype(np.int32)
    sw[:8] = 0                                   # all-tied rows
    sw[8:16] = 7
    for r in range(1, 9):
        ref = np.asarray(jax.lax.top_k(jnp.asarray(sw), r)[1])
        got = tmapper.top_ranks(torch.from_numpy(sw), r).numpy()
        np.testing.assert_array_equal(ref, got, err_msg=f"r={r}")


def test_mapper_topn_equals_jax(repeats):
    cfg, g, reads, lens, _, _, _ = repeats
    cfg = cfg.replace(topn=2)

    class _G:
        codes = g

    ref = jmapper.Mapper(cfg, _G(), L).map_batch_topn(reads, lens)
    port = tmapper.Mapper(config_from_reference(cfg), _G(), L, device="cpu")
    assert port.topn() == 2
    assert_ranks_equal(ref, port.map_batch_topn(reads, lens))


@pytest.fixture(scope="module")
def se_workload(tmp_path_factory):
    """Two chromosomes with planted repeats; reads with SNPs and indels."""
    d = tmp_path_factory.mktemp("torch_topn")
    g = repeat_genome(40_000, n_repeats=14, min_len=600, max_len=1500, seed=64)
    write_fasta(str(d / "ref.fa"), [("chrA", decode_seq(g[:25_000])),
                                    ("chrB", decode_seq(g[25_000:]))])
    reads = jsimulate_reads(g[:25_000], 70, read_len=100, snp_rate=0.02,
                            indel_rate=0.004, seed=65)
    reads += jsimulate_reads(g[25_000:], 50, read_len=100, snp_rate=0.03,
                             indel_rate=0.004, seed=66, prefix="chrB")
    write_fastq(str(d / "reads.fq"), reads)
    return d


def _records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


@pytest.mark.parametrize("name,extra,python_emit", [
    ("n2", ("-n", "2"), False),
    ("n3_strata", ("-n", "3", "--strata"), False),
    ("n2_no_unal_python", ("-n", "2", "--no-unal"), True),
])
def test_sam_identical_to_jax_cli(se_workload, monkeypatch, name, extra,
                                  python_emit):
    if python_emit:   # both CLIs format with the Python SamWriter
        monkeypatch.setattr(native, "lib", lambda: None)
    d = se_workload
    common = ["map", "-r", str(d / "ref.fa"), "-q", str(d / "reads.fq"),
              "-k", "11", "--batch-size", "64", "--no-progress", *extra]
    assert jax_main(common + ["-o", str(d / f"jax_{name}.sam")]) == 0
    stats = tcli.run(common + ["-o", str(d / f"torch_{name}.sam"),
                               "--device", "cpu"])
    ref = _records(d / f"jax_{name}.sam")
    got = _records(d / f"torch_{name}.sam")
    assert got == ref
    body = [ln.split("\t") for ln in got if not ln.startswith("@")]
    flags = np.array([int(f[1]) for f in body])
    primary = flags & 0x100 == 0
    assert len({f[0] for f in body}) == int(primary.sum())   # one per read
    assert int((flags & 0x100 != 0).sum()) > 0               # secondaries
    assert all(int(f[4]) == 0 for f, p in zip(body, primary) if not p)
    # eager scoring: every candidate of every read took a slot
    assert stats.slots_scored >= stats.reads_in


def test_golden_topn(tmp_path):
    """tests/test_golden_sam.py's single-end -n 2 workload through the
    port's CLI."""
    g = random_genome(60_000, seed=77)
    write_fasta(str(tmp_path / "ref.fa"), [("chrG", decode_seq(g))])
    write_fastq(str(tmp_path / "se.fq"),
                jsimulate_reads(g, 400, read_len=100, snp_rate=0.03,
                                indel_rate=0.005, seed=78))
    assert tcli.main([
        "map", "-r", str(tmp_path / "ref.fa"), "-q", str(tmp_path / "se.fq"),
        "-o", str(tmp_path / "se.sam"), "-k", "11", "--batch-size", "128",
        "-n", "2", "--rg-id", "rg0", "--rg-sm", "sampleA",
        "--no-progress", "--skip-save", "--device", "cpu",
    ]) == 0
    assert (_records(tmp_path / "se.sam")
            == _records(os.path.join(GOLDEN, "se_topn2.sam")))
