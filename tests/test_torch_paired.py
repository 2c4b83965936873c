"""Port's paired-end path (device cpu) == the JAX reference.

  * map_step_paired on FR pairs from a genome with planted repeats, with
    the default slot_cap and with 8 slots (slot overflow), and with a tight
    -X so that the broken-pair fallback fires;
  * Mapper.map_batch_paired against the JAX Mapper;
  * the port's CLI SAM against the JAX CLI's for -1/-2, -p, -I/-X edges and
    --no-unal with the Python SamWriter, and against tests/golden/pe.sam.
Tolerance: exact equality of all 17 MapResult fields, and SAM byte-identical
apart from the @PG line.
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
    random_genome, simulate_pairs as jsimulate_pairs, write_fastq,
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
from nextgenmap_tpu_torch.synthetic import repeat_genome, simulate_pairs  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

L = 100
B = 96
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def assert_results_equal(ref, got):
    assert ref._fields == got._fields
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).cpu().numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(scope="module")
def pairs():
    """(cfg, genome, reads, lens, offsets, JAX args, statics): 48 FR pairs
    on a 50 kbp genome with planted repeats; the last pair is short."""
    cfg = NgmConfig(kmer=11)
    g = repeat_genome(50_000, n_repeats=12, min_len=800, max_len=2000, seed=51)
    reads, _, _ = simulate_pairs(g, B // 2, L, 0.02, seed=52)
    lens = np.full(B, L, np.int32)
    lens[-2:] = [80, 60]
    for i in (1, 2):
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


@pytest.mark.parametrize("slot_cap,max_insert", [(0, 500), (8, 500), (0, 250)])
def test_map_step_paired_equals_jax(pairs, slot_cap, max_insert):
    cfg, g, reads, lens, off, jargs, statics = pairs
    pair_args = (100, max_insert, 0.9)
    ref = jmapper.map_step_paired(
        *jargs, jnp.int32(pair_args[0]), jnp.int32(pair_args[1]),
        jnp.float32(pair_args[2]), **statics, canonical=True,
        slot_cap=slot_cap,
    )
    state = state_from_numpy(g, off, jargs[2], jargs[5], "cpu")
    packed = tcand.pack_offsets(state.offsets, 1000, cfg.max_kmer_fanout)
    got = tmapper.map_step_paired(
        state.genome, packed, state.positions,
        torch.from_numpy(reads), torch.from_numpy(lens),
        state.matrices, 20, 20, 20, 0.5, 1000, 0.65, 0.5, *pair_args,
        **statics, slot_cap=slot_cap,
    )
    assert_results_equal(ref, got)
    nc = got.n_candidates.numpy().reshape(-1, 2)
    assert int((nc >= 2).any(axis=1).sum()) >= 4   # scored pairs
    n_proper = int(got.proper.sum())
    if slot_cap:      # unscored pairs fall back to their singletons
        assert int(got.cmr_overflow) > 0
    elif max_insert == 500:
        assert n_proper >= 0.8 * B
    else:   # every insert > 250: every pair with a choice is broken
        assert n_proper < 0.2 * B and int(got.mapped.sum()) >= 0.9 * B


def test_mapper_paired_equals_jax(pairs):
    cfg, g, reads, lens, _, _, _ = pairs

    class _G:
        codes = g

    ref = jmapper.Mapper(cfg, _G(), L).map_batch_paired(reads, lens)
    port = tmapper.Mapper(config_from_reference(cfg), _G(), L, device="cpu")
    got = port.map_batch_paired(reads, lens)
    assert_results_equal(ref, got)
    assert int(got.proper.sum()) >= 0.8 * B


@pytest.fixture(scope="module")
def pe_workload(tmp_path_factory):
    """Two chromosomes with planted repeats; FR pairs with SNPs and indels
    from both, as -1/-2 files and as one interleaved file."""
    d = tmp_path_factory.mktemp("torch_pe")
    g = repeat_genome(40_000, n_repeats=10, min_len=600, max_len=1500, seed=53)
    write_fasta(str(d / "ref.fa"), [("chrA", decode_seq(g[:25_000])),
                                    ("chrB", decode_seq(g[25_000:]))])
    prs = jsimulate_pairs(g[:25_000], 40, read_len=100, snp_rate=0.02,
                          indel_rate=0.004, seed=54)
    prs += jsimulate_pairs(g[25_000:], 24, read_len=100, snp_rate=0.03,
                           indel_rate=0.004, seed=55, prefix="chrB")
    write_fastq(str(d / "r1.fq"), [p[0] for p in prs])
    write_fastq(str(d / "r2.fq"), [p[1] for p in prs])
    write_fastq(str(d / "il.fq"), [m for p in prs for m in p])
    return d


def _records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


@pytest.mark.parametrize("name,extra,python_emit", [
    ("r12", ("-1", "r1.fq", "-2", "r2.fq"), False),
    ("interleaved", ("-q", "il.fq", "-p"), False),
    ("insert_edges", ("-1", "r1.fq", "-2", "r2.fq", "-I", "330", "-X", "370"),
     False),
    ("no_unal_python", ("-1", "r1.fq", "-2", "r2.fq", "--no-unal", "-X", "300"),
     True),
])
def test_sam_identical_to_jax_cli(pe_workload, monkeypatch, name, extra,
                                  python_emit):
    if python_emit:   # both CLIs format with the Python SamWriter
        monkeypatch.setattr(native, "lib", lambda: None)
    d = pe_workload
    extra = [str(d / a) if a.endswith(".fq") else a for a in extra]
    common = ["map", "-r", str(d / "ref.fa"), "-k", "11", "--batch-size", "64",
              "--no-progress", *extra]
    assert jax_main(common + ["-o", str(d / f"jax_{name}.sam")]) == 0
    stats = tcli.run(common + ["-o", str(d / f"torch_{name}.sam"),
                               "--device", "cpu"])
    ref = _records(d / f"jax_{name}.sam")
    got = _records(d / f"torch_{name}.sam")
    assert got == ref
    body = [ln.split("\t") for ln in got if not ln.startswith("@")]
    flags = [int(f[1]) for f in body]
    assert all(f & 0x1 for f in flags)
    if name in ("r12", "interleaved"):
        assert len(body) == 128
        assert sum(f & 0x2 != 0 for f in flags) >= 0.8 * 128
        assert stats.pairs_proper + stats.pairs_broken <= 64
    if name == "no_unal_python":
        assert all(f & 0x4 == 0 for f in flags)
    assert stats.slots_scored > 0


def test_interleaved_equals_two_files(pe_workload):
    d = pe_workload
    for name, extra in (("a", ["-1", "r1.fq", "-2", "r2.fq"]),
                        ("b", ["-q", "il.fq", "-p"])):
        extra = [str(d / a) if a.endswith(".fq") else a for a in extra]
        assert tcli.main(["map", "-r", str(d / "ref.fa"), "-k", "11",
                           "--batch-size", "32", "--no-progress", *extra,
                           "-o", str(d / f"il_{name}.sam"),
                           "--device", "cpu"]) == 0
    assert _records(d / "il_a.sam") == _records(d / "il_b.sam")


@pytest.mark.parametrize("flags", [
    ["-1", "r1.fq"], ["-1", "r1.fq", "-2", "r2.fq", "-p"],
])
def test_paired_argument_errors(pe_workload, flags):
    d = pe_workload
    flags = [str(d / a) if a.endswith(".fq") else a for a in flags]
    with pytest.raises(SystemExit):
        tcli.main(["map", "-r", str(d / "ref.fa"), "-o", str(d / "x.sam"),
                    "--device", "cpu", *flags])


def test_paired_odd_qry_start_raises(pe_workload):
    d = pe_workload
    with pytest.raises(ValueError, match="even"):
        tcli.main(["map", "-r", str(d / "ref.fa"), "-1", str(d / "r1.fq"),
                    "-2", str(d / "r2.fq"), "--qry-start", "3",
                    "-o", str(d / "x.sam"), "--device", "cpu"])


def test_golden_paired_end(tmp_path):
    """tests/test_golden_sam.py's paired workload through the port's CLI."""
    g = random_genome(60_000, seed=77)
    write_fasta(str(tmp_path / "ref.fa"), [("chrG", decode_seq(g))])
    prs = jsimulate_pairs(g, 150, read_len=100, snp_rate=0.02,
                          insert_mean=350, insert_sd=40, seed=79)
    write_fastq(str(tmp_path / "pe1.fq"), [p[0] for p in prs])
    write_fastq(str(tmp_path / "pe2.fq"), [p[1] for p in prs])
    assert tcli.main([
        "map", "-r", str(tmp_path / "ref.fa"),
        "-1", str(tmp_path / "pe1.fq"), "-2", str(tmp_path / "pe2.fq"),
        "-o", str(tmp_path / "pe.sam"), "-k", "11", "--batch-size", "128",
        "-X", "600", "--no-progress", "--skip-save", "--device", "cpu",
    ]) == 0
    assert _records(tmp_path / "pe.sam") == _records(os.path.join(GOLDEN, "pe.sam"))
