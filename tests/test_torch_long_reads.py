"""Port's long reads (device cpu) == the JAX reference.

  * the CLI's SAM against the JAX CLI's for 500 and 1000 bp reads with
    SNPs and indels (bands W = 112 and 184, corridors of 612 and 1184),
    and for 500 bp pairs; every CIGAR consumes SEQ and every NM equals the
    edits the CIGAR shows against the genome;
  * map_step_topn at 500 bp in both modes against the JAX step;
  * the runner's batch size for long reads: the default batch shrinks as
    the JAX runner shrinks it (600 bp reads: 1024; 1000 bp: 614), a batch
    the user set is kept, and reads up to 250 bp keep the default.
Tolerance: exact equality of every field and SAM byte-identical apart from
the @PG line.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import nextgenmap_tpu.pipeline.runner as jrunner  # noqa: E402
from nextgenmap_tpu.cli import main as jax_main  # noqa: E402
from nextgenmap_tpu.config import NgmConfig  # noqa: E402
from nextgenmap_tpu.index.device_build import build_index_device  # noqa: E402
from nextgenmap_tpu.io.encode import decode_seq  # noqa: E402
from nextgenmap_tpu.io.fasta import write_fasta  # noqa: E402
from nextgenmap_tpu.io.simulate import (  # noqa: E402
    random_genome, simulate_reads, write_fastq,
)
from nextgenmap_tpu.models import mapper as jmapper  # noqa: E402
from nextgenmap_tpu.ops.candidate import pack_offsets  # noqa: E402
from nextgenmap_tpu.ops.scoring import matrices_are_simple  # noqa: E402
from nextgenmap_tpu_torch import cli as tcli  # noqa: E402
from nextgenmap_tpu_torch import synthetic  # noqa: E402
from nextgenmap_tpu_torch.convert import (  # noqa: E402
    config_from_reference, state_from_numpy,
)
from nextgenmap_tpu_torch.models import mapper as tmapper  # noqa: E402
from nextgenmap_tpu_torch.ops import candidate as tcand  # noqa: E402
from nextgenmap_tpu_torch.pipeline import runner as trunner  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401


def _records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


@pytest.mark.parametrize("read_len", [500, 1000])
def test_sam_identical_to_jax_cli(tmp_path, read_len):
    """tests/test_long_reads.py's workload at k = 11, in two batches."""
    g = random_genome(120_000, seed=read_len)
    write_fasta(str(tmp_path / "ref.fa"), [("chr1", decode_seq(g))])
    write_fastq(str(tmp_path / "r.fq"),
                simulate_reads(g, 24, read_len=read_len, snp_rate=0.03,
                               indel_rate=0.005, seed=read_len + 1))
    common = ["map", "-r", str(tmp_path / "ref.fa"), "-q",
              str(tmp_path / "r.fq"), "-k", "11", "--batch-size", "12",
              "--no-progress", "--skip-save"]
    assert jax_main(common + ["-o", str(tmp_path / "jax.sam")]) == 0
    tcli.run(common + ["-o", str(tmp_path / "torch.sam"), "--device", "cpu"])
    assert _records(tmp_path / "torch.sam") == _records(tmp_path / "jax.sam")
    c = synthetic.alignment_counts(str(tmp_path / "torch.sam"), g, tol=16)
    assert c["records"] == 24 and c["mapped"] >= 22
    assert c["correct"] >= 0.9 * c["mapped"]
    assert c["seq_mismatch"] == 0 and c["nm_mismatch"] == 0


def test_paired_sam_identical_to_jax_cli(tmp_path):
    g = synthetic.repeat_genome(80_000, n_repeats=4, min_len=1000,
                                max_len=2000, seed=91)
    synthetic.write_fasta(str(tmp_path / "ref.fa"), "chrL", g)
    codes, pos, strand = synthetic.simulate_pairs(
        g, 12, 500, 0.02, insert_mean=1200, insert_sd=100, seed=92)
    for m in (0, 1):
        synthetic.write_fastq(str(tmp_path / f"r{m + 1}.fq"), codes[m::2],
                              pos[m::2], strand[m::2], prefix="simpair")
    common = ["map", "-r", str(tmp_path / "ref.fa"), "-1",
              str(tmp_path / "r1.fq"), "-2", str(tmp_path / "r2.fq"),
              "-k", "11", "-X", "2000", "--batch-size", "8", "--no-progress",
              "--skip-save"]
    assert jax_main(common + ["-o", str(tmp_path / "jax.sam")]) == 0
    stats = tcli.run(common + ["-o", str(tmp_path / "torch.sam"),
                               "--device", "cpu"])
    assert _records(tmp_path / "torch.sam") == _records(tmp_path / "jax.sam")
    assert stats.pairs_proper >= 10


@pytest.mark.parametrize("end_to_end", [False, True])
def test_topn_step_equals_jax_at_500bp(end_to_end):
    L, B = 500, 12
    cfg = NgmConfig(kmer=11)
    g = synthetic.repeat_genome(60_000, n_repeats=8, min_len=1500,
                                max_len=3000, seed=93)
    codes, _, _ = synthetic.simulate_long_reads(g, B, L, 0.02, 0.004, seed=94)
    lens = np.full(B, L, np.int32)
    lens[-1] = 300
    codes[-1, 300:] = 4
    off, pos = build_index_device(jnp.asarray(g), k=11, skip=1, canonical=True)
    mats = tmapper.score_matrices(config_from_reference(cfg))
    statics = dict(
        k=11, fanout_cap=cfg.max_kmer_fanout,
        hit_cap=cfg.resolved_read_hits(pos.shape[0], L),
        max_cmrs=cfg.max_cmrs, diag_bin_log2=cfg.diag_bin_log2,
        band=cfg.corridor_for(L), min_kmer_hits=1,
        read_stride=cfg.read_kmer_skip, packed_offsets=True,
        end_to_end=end_to_end,
    )
    assert statics["band"] == 112
    ref = jmapper.map_step_topn(
        jnp.asarray(g), pack_offsets(off, 1000, 32), pos, jnp.asarray(codes),
        jnp.asarray(lens), jnp.asarray(mats), jnp.int32(20), jnp.int32(20),
        jnp.int32(20), jnp.float32(0.5), jnp.int32(1000), jnp.float32(0.65),
        jnp.float32(0.5), **statics, canonical=True, topn=2,
        simple_matrix=matrices_are_simple(mats),
    )
    state = state_from_numpy(g, off, pos, mats, "cpu")
    got = tmapper.map_step_topn(
        state.genome, tcand.pack_offsets(state.offsets, 1000, 32),
        state.positions, torch.from_numpy(codes), torch.from_numpy(lens),
        state.matrices, 20, 20, 20, 0.5, 1000, 0.65, 0.5, **statics, topn=2,
    )
    for j, (r, p) in enumerate(zip(ref, got)):
        for f in r._fields:
            a, b = np.asarray(getattr(r, f)), getattr(p, f).numpy()
            assert a.dtype == b.dtype, (j, f)
            np.testing.assert_array_equal(a, b, err_msg=f"rank {j} {f}")
    assert int(got[0].mapped.sum()) == B
    assert int((got[1].score > 0).sum()) > 0       # repeats give a rank 1


class _Built(Exception):
    """Raised by the spy once the Mapper's config is seen."""


def _spy_batch(monkeypatch, module, base, dataclass):
    """Spy on `module.Mapper`: the returned dict gets the batch size of the
    config the next run builds its Mapper with, and the run stops there."""
    seen = {}

    class Spy(base):
        if dataclass:                              # the JAX Mapper
            def __post_init__(self):
                seen["batch"] = self.cfg.batch_size
                raise _Built
        else:
            def __init__(self, cfg, *a, **kw):
                seen["batch"] = cfg.batch_size
                raise _Built

    monkeypatch.setattr(module, "Mapper", Spy)
    return seen


def test_runner_batch_size_for_600bp_reads_equals_jax(tmp_path, monkeypatch):
    g = random_genome(60_000, seed=3)
    write_fasta(str(tmp_path / "ref.fa"), [("chr1", decode_seq(g))])
    write_fastq(str(tmp_path / "r.fq"),
                simulate_reads(g, 8, read_len=600, snp_rate=0.01, seed=4))
    common = ["map", "-r", str(tmp_path / "ref.fa"), "-q",
              str(tmp_path / "r.fq"), "-k", "11", "--no-progress",
              "--skip-save"]
    jseen = _spy_batch(monkeypatch, jrunner, jmapper.Mapper, True)
    with pytest.raises(_Built):
        jax_main(common + ["-o", str(tmp_path / "jax.sam")])
    tseen = _spy_batch(monkeypatch, trunner, tmapper.Mapper, False)
    with pytest.raises(_Built):
        tcli.run(common + ["-o", str(tmp_path / "torch.sam"),
                           "--device", "cpu"])
    assert tseen["batch"] == jseen["batch"] == 1024


@pytest.mark.parametrize("read_len,batch,expect", [
    (1000, 4096, 614), (600, 4096, 1024), (251, 4096, 2446),
    (250, 4096, 4096), (150, 4096, 4096), (1000, 64, 64),
])
def test_long_read_batch_size(read_len, batch, expect):
    cfg = NgmConfig(batch_size=batch)
    assert trunner.long_read_batch_size(config_from_reference(cfg), read_len) == expect
