"""The port's CLI with --index-shards N, and its `index` verb, against the
JAX package's (the cases of tests/test_cli_sharded.py on one device).

  * SAM of `map --index-shards 2|3` (single-end, -1/-2, --kmer-min 3, and
    -n 2) byte-identical apart from @PG to the JAX CLI's with the same
    flags, and (not for -n) to the port's own unsharded SAM;
  * the flag combinations the reference refuses are refused;
  * `index --index-shards 2` of either package writes the host index, the
    .ngmt-shards artifact and one artifact per shard, which the other
    package's `map --index-shards 2` loads without building anything;
  * the shard artifact is memoized, reloaded, and keyed by --max-freq.
Workload: two chromosomes (40 and 25 kbp), 96 reads of 100 bp with SNPs and
indels, 48 FR pairs; k = 11, batches of 32 (three per run).
Tolerance: byte equality of the SAM records.
"""

import glob
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")

from nextgenmap_tpu.cli import main as jax_main  # noqa: E402
from nextgenmap_tpu.index.genome import Genome  # noqa: E402
from nextgenmap_tpu.io.encode import decode_seq  # noqa: E402
from nextgenmap_tpu.io.fasta import write_fasta  # noqa: E402
from nextgenmap_tpu.io.simulate import (  # noqa: E402
    random_genome, simulate_pairs, simulate_reads, write_fastq,
)
from nextgenmap_tpu.parallel import index_shard as jshard  # noqa: E402
from nextgenmap_tpu_torch.cli import main as torch_main  # noqa: E402
from nextgenmap_tpu_torch.config import NgmConfig  # noqa: E402
from nextgenmap_tpu_torch.parallel import index_shard as tshard  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

N_READS = 96
INPUTS = ("ref.fa", "reads.fq", "r1.fq", "r2.fq")


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_shard")
    g1 = random_genome(40_000, seed=31)
    g2 = random_genome(25_000, seed=32)
    write_fasta(str(d / "ref.fa"), [("chr1", decode_seq(g1)),
                                    ("chr2", decode_seq(g2))])
    reads = simulate_reads(g1, N_READS // 2, read_len=100, snp_rate=0.03,
                           indel_rate=0.003, seed=33)
    reads += simulate_reads(g2, N_READS // 2, read_len=100, snp_rate=0.03,
                            indel_rate=0.003, seed=34, prefix="c2")
    write_fastq(str(d / "reads.fq"), reads)
    pairs = simulate_pairs(g1, N_READS // 2, read_len=100, insert_mean=300,
                           insert_sd=30, snp_rate=0.02, seed=35)
    write_fastq(str(d / "r1.fq"), [p[0] for p in pairs])
    write_fastq(str(d / "r2.fq"), [p[1] for p in pairs])
    return d


def _copy_inputs(src, dst):
    for f in INPUTS:
        shutil.copy(src / f, dst / f)
    return dst


def run_map(main, d, out, extra=(), paired=False):
    """SAM records (no @PG) of one `map` run of `main` in directory d."""
    qry = (["-1", str(d / "r1.fq"), "-2", str(d / "r2.fq")] if paired
           else ["-q", str(d / "reads.fq")])
    device = ["--device", "cpu"] if main is torch_main else []
    assert main(["map", "-r", str(d / "ref.fa"), *qry, "-o", str(d / out),
                 "-k", "11", "--batch-size", "32", "--no-progress",
                 *device, *extra]) == 0
    with open(d / out) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


@pytest.mark.parametrize("paired,flags", [
    (False, ("--index-shards", "2")),
    (True, ("--index-shards", "2")),
    (False, ("--kmer-min", "3", "--index-shards", "3")),
    (False, ("-n", "2", "--index-shards", "2")),
])
def test_sharded_sam_equals_jax_and_unsharded(shard_dir, tmp_path, paired,
                                              flags):
    d = _copy_inputs(shard_dir, tmp_path)
    flags = ("--skip-save", *flags)
    ref = run_map(jax_main, d, "jax.sam", flags, paired)
    got = run_map(torch_main, d, "torch.sam", flags, paired)
    assert got == ref
    body = [ln for ln in got if not ln.startswith("@")]
    assert len(body) >= N_READS
    assert sum(int(ln.split("\t")[1]) & 4 == 0 for ln in body) >= 0.9 * N_READS
    if paired:
        proper = sum(int(ln.split("\t")[1]) & 2 != 0 for ln in body)
        assert proper >= 0.9 * N_READS
    if "-n" not in flags:
        # DESIGN.md rule 15: the shard count never changes the output
        cut = flags.index("--index-shards")
        plain = flags[:cut] + flags[cut + 2:]
        assert run_map(torch_main, d, "flat.sam", plain, paired) == got


@pytest.mark.parametrize("flags", [
    # what the reference refuses of these flags with --index-shards
    ["--index-shards", "2", "--devices", "3"],
    ["--index-shards", "2", "--shard-across-hosts"],
    ["--index-shards", "2", "--dist-nprocs", "2", "--shard-across-hosts"],
])
def test_rejected_combos(shard_dir, tmp_path, flags):
    with pytest.raises(ValueError):
        torch_main(["map", "-r", str(shard_dir / "ref.fa"), "-q",
                    str(shard_dir / "reads.fq"), "-o", str(tmp_path / "x.sam"),
                    "-k", "11", "--device", "cpu", *flags])
    assert not os.path.exists(tmp_path / "x.sam")
    with pytest.raises(ValueError):
        # -n with shards runs on the one-device shard loop only
        NgmConfig(index_shards=2, topn=3, devices=4).validate()
    NgmConfig(index_shards=2, bs_mapping=True).validate()
    NgmConfig(index_shards=2, topn=3).validate()


def _artifacts(d):
    return sorted(glob.glob(str(d / "ref.fa.ngmt-*")))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_index_verb_artifacts_load_in_both(shard_dir, tmp_path, writer):
    """One package's `index --index-shards 2` writes the encoded genome, the
    host index, the shard artifact and the two per-shard ones; both
    packages' `map --index-shards 2` then load them, write nothing, and
    give the same SAM."""
    d = _copy_inputs(shard_dir, tmp_path)
    main = torch_main if writer == "torch" else jax_main
    assert main(["index", "-r", str(d / "ref.fa"), "-k", "11",
                 "--index-shards", "2"]) == 0
    arts = _artifacts(d)
    names = [os.path.basename(p) for p in arts]
    assert len(glob.glob(str(d / "ref.fa.ngmt-shards-*"))) == 1
    assert len(glob.glob(str(d / "ref.fa.ngmt-ht-*"))) == 1
    assert sum(n.startswith("ref.fa.ngmt-shard0of2") for n in names) == 1
    assert sum(n.startswith("ref.fa.ngmt-shard1of2") for n in names) == 1
    mtimes = {p: os.path.getmtime(p) for p in arts}

    # the stacked artifact as each package reads it, and its per-shard rows
    (cache,) = glob.glob(str(d / "ref.fa.ngmt-shards-*"))
    sha = Genome.open(str(d / "ref.fa")).sha1()
    a = jshard.ShardedIndex.load(cache, sha)
    b = tshard.ShardedIndex.load(cache, sha)
    assert a.canonical and b.canonical and b.n_shards == 2
    for f in ("genome", "offsets", "positions", "base", "core_lo",
              "core_hi"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for s in range(2):
        (part,) = glob.glob(str(d / f"ref.fa.ngmt-shard{s}of2-*"))
        with np.load(part) as z:
            assert int(z["shard"]) == s
            np.testing.assert_array_equal(z["positions"], b.positions[s])
            np.testing.assert_array_equal(z["offsets"], b.offsets[s])

    ref = run_map(jax_main, d, "jax.sam", ("--index-shards", "2"))
    got = run_map(torch_main, d, "torch.sam", ("--index-shards", "2"))
    assert got == ref
    assert _artifacts(d) == arts
    for p, t in mtimes.items():
        assert os.path.getmtime(p) == t, f"{p} was rebuilt"


def test_sharded_index_memoization(shard_dir, tmp_path):
    """The port's run memoizes the shard artifact, a second run loads it
    with the same output, and another --max-freq keys another artifact."""
    d = _copy_inputs(shard_dir, tmp_path)
    a = run_map(torch_main, d, "a.sam", ("--index-shards", "2"))
    caches = glob.glob(str(d / "ref.fa.ngmt-shards-*"))
    assert len(caches) == 1
    t = os.path.getmtime(caches[0])
    assert run_map(torch_main, d, "b.sam", ("--index-shards", "2")) == a
    assert os.path.getmtime(caches[0]) == t
    run_map(torch_main, d, "c.sam", ("--index-shards", "2", "--max-freq", "7"))
    assert len(glob.glob(str(d / "ref.fa.ngmt-shards-*"))) == 2
