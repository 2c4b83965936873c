"""The port's CLI: SAM byte-identical to the JAX CLI's (apart from @PG),
a jax-free import, and the reference's refusals of flag combinations (the
paired and top-n paths are held in tests/test_torch_paired.py and
tests/test_torch_topn.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from nextgenmap_tpu import native  # noqa: E402
from nextgenmap_tpu.cli import main as jax_main  # noqa: E402
from nextgenmap_tpu.io.encode import decode_seq  # noqa: E402
from nextgenmap_tpu.io.fasta import write_fasta  # noqa: E402
from nextgenmap_tpu.io.simulate import simulate_reads, write_fastq  # noqa: E402
from nextgenmap_tpu_torch.cli import main as torch_main  # noqa: E402
from nextgenmap_tpu_torch.native import hostio  # noqa: E402
from nextgenmap_tpu_torch.synthetic import repeat_genome  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """Two chromosomes with planted repeats; reads with SNPs and indels."""
    d = tmp_path_factory.mktemp("torch_cli")
    g = repeat_genome(40_000, n_repeats=10, min_len=600, max_len=1500, seed=41)
    write_fasta(str(d / "ref.fa"), [("chrA", decode_seq(g[:25_000])),
                                    ("chrB", decode_seq(g[25_000:]))])
    reads = simulate_reads(g[:25_000], 70, read_len=100, snp_rate=0.02,
                           indel_rate=0.004, seed=42)
    reads += simulate_reads(g[25_000:], 50, read_len=100, snp_rate=0.03,
                            indel_rate=0.004, seed=43, prefix="chrB")
    write_fastq(str(d / "reads.fq"), reads)
    return d


def _records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


@pytest.mark.parametrize("extra,python_emit", [
    ((), False),
    (("--hard-clip", "--no-unal", "--batch-size", "48"), True),
    (("--silent-clip", "--rg-id", "grp1", "-s", "0.3", "--kmer-skip", "2",
      "--kmer-min", "2", "--slam-seq", "2", "--match-bonus", "8",
      "--gap-extend-penalty", "10", "--read-len", "110", "--qry-start", "5",
      "--qry-count", "100", "--max-read-hits", "192"), False),
])
def test_sam_identical_to_jax_cli(workload, monkeypatch, extra, python_emit):
    if python_emit:   # both CLIs format with the Python SamWriter
        monkeypatch.setattr(native, "lib", lambda: None)
        monkeypatch.setattr(hostio, "lib", lambda: None)
    d = workload
    tag = f"{len(extra)}{int(python_emit)}"
    n_reads = 100 if "--qry-count" in extra else 120
    common = ["map", "-r", str(d / "ref.fa"), "-q", str(d / "reads.fq"),
              "-k", "11", "--batch-size", "64", "--no-progress", *extra]
    assert jax_main(common + ["-o", str(d / f"jax{tag}.sam")]) == 0
    assert torch_main(common + ["-o", str(d / f"torch{tag}.sam"),
                                "--device", "cpu"]) == 0
    ref = _records(d / f"jax{tag}.sam")
    got = _records(d / f"torch{tag}.sam")
    assert got == ref
    body = [ln for ln in got if not ln.startswith("@")]
    assert sum(int(ln.split("\t")[1]) & 4 == 0 for ln in body) >= 0.8 * n_reads
    with open(d / f"torch{tag}.sam") as f:
        assert "@PG\tID:ngm-torch" in f.read()


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import nextgenmap_tpu_torch, nextgenmap_tpu_torch.cli\n"
        "import nextgenmap_tpu_torch.models.mapper\n"
        "import nextgenmap_tpu_torch.pipeline.runner\n"
        "import nextgenmap_tpu_torch.ops.sw_kernel\n"
        "import nextgenmap_tpu_torch.ops.gather_kernel\n"
        "import nextgenmap_tpu_torch.ops.row_gather\n"
        "import nextgenmap_tpu_torch.pair.resolve\n"
        "import nextgenmap_tpu_torch.tools.probe_dyngather\n"
        "import nextgenmap_tpu_torch.synthetic\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_device_cuda_raises_without_card(workload, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = workload
    with pytest.raises(RuntimeError, match="cuda"):
        torch_main(["map", "-r", str(d / "ref.fa"), "-q", str(d / "reads.fq"),
                    "-o", str(d / "never.sam"), "-k", "11"])


@pytest.mark.parametrize("flags", [
    # combinations of the several-device and several-process flags that the
    # reference refuses too (every one of the flags maps on its own)
    ["--devices", "2", "--index-shards", "3"],
    ["--dist-nprocs", "2", "--shard-across-hosts", "--index-shards", "2"],
    ["--shard-across-hosts"], ["--index-shards", "2", "--devices", "2",
                               "-n", "2"],
])
def test_out_of_slice_flags_raise(workload, flags):
    d = workload
    with pytest.raises(ValueError):
        torch_main(["map", "-r", str(d / "ref.fa"), "-q", str(d / "reads.fq"),
                    "-o", str(d / "never.sam"), "-k", "11", "--device", "cpu",
                    *flags])
    assert not os.path.exists(d / "never.sam")


def test_synthetic_reads_carry_truth(tmp_path):
    """The seeded simulator the chip smoke uses: names carry the truth and
    a perfect record for each read counts as truth-correct."""
    from nextgenmap_tpu_torch import synthetic

    g = synthetic.repeat_genome(5_000, n_repeats=2, min_len=100, max_len=200)
    codes, pos, strand = synthetic.simulate_reads(g, 20, 50, 0.0, seed=1)
    win = g[pos[:, None] + np.arange(50)]
    fwd = np.where(strand[:, None] == 1, (3 - codes)[:, ::-1], codes)
    np.testing.assert_array_equal(fwd, win)
    synthetic.write_fastq(str(tmp_path / "r.fq"), codes, pos, strand)
    sam = tmp_path / "r.sam"
    with open(sam, "w") as f:
        for i in range(20):
            f.write(f"simread_{i}_{pos[i]}_{strand[i]}\t{16 * int(strand[i])}"
                    f"\tchr\t{pos[i] + 1}\t60\n")
    assert synthetic.truth_correct(str(sam)) == (20, 20, 20)
