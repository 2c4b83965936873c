"""The port imports nothing of the JAX package, and no JAX, at any of its
entry points.

Each case runs in a fresh interpreter and asserts afterwards that no key of
sys.modules is ``nextgenmap_tpu`` or starts with ``nextgenmap_tpu.``, and
that ``jax`` is absent: the CLI on the CPU (single-end, ``-1/-2`` and
``-n 2``, ``--index-shards 2``; ``--bam -t 4 --megabatch 2``, then BAM
input with ``--resume --profile``; ``--devices 2``, the two processes of
``--dist-nprocs 2`` one after the other, ``--shard-across-hosts`` in one
process), the ``index --index-shards 2`` verb, importing the mapper, the
index-shard module and the other parallel modules (mesh, dp,
distributed), the K3 probe tool (which exits 2 without a card), and
importing the kernel timing tools.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from nextgenmap_tpu_torch import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = (
    "import sys\n"
    "bad = sorted(m for m in sys.modules if m == 'nextgenmap_tpu'\n"
    "             or m.startswith('nextgenmap_tpu.'))\n"
    "assert not bad, f'the port imported the JAX package: {bad}'\n"
    "assert 'jax' not in sys.modules, 'the port imported jax'\n"
)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("noref")
    g = synthetic.repeat_genome(20_000, n_repeats=4, min_len=300,
                                max_len=600, seed=51)
    synthetic.write_fasta(str(d / "ref.fa"), "chr", g)
    synthetic.write_fasta(str(d / "idx.fa"), "chr", g)
    codes, pos, strand = synthetic.simulate_reads(g, 24, 100, 0.02, seed=52)
    synthetic.write_fastq(str(d / "r.fq"), codes, pos, strand)
    codes, pos, strand = synthetic.simulate_pairs(g, 12, 100, 0.02, seed=53)
    for m in (0, 1):
        synthetic.write_fastq(str(d / f"r{m + 1}.fq"), codes[m::2],
                              pos[m::2], strand[m::2], prefix="simpair")
    return d


def _cli(d, out, *args):
    argv = ["map", "-r", str(d / "ref.fa"), "-o", str(d / out), "-k",
            "11", "--device", "cpu", "--no-progress", *args]
    return (f"from nextgenmap_tpu_torch import cli\n"
            f"cli.run({argv!r})\n")


CASES = {
    "cli_single": lambda d: _cli(d, "cli_single.sam", "-q", str(d / "r.fq")),
    "cli_paired": lambda d: _cli(d, "cli_paired.sam", "-1", str(d / "r1.fq"),
                                 "-2", str(d / "r2.fq")),
    "cli_topn": lambda d: _cli(d, "cli_topn.sam", "-q", str(d / "r.fq"),
                               "-n", "2"),
    "cli_sharded": lambda d: _cli(d, "cli_sharded.sam", "-q",
                                  str(d / "r.fq"), "--index-shards", "2",
                                  "--skip-save"),
    "cli_runtime": lambda d: (
        _cli(d, "cli_runtime.bam", "-q", str(d / "r.fq"), "--bam", "-t", "4",
             "--megabatch", "2", "--batch-size", "8")
        + _cli(d, "cli_runtime.sam", "-q", str(d / "cli_runtime.bam"),
               "--resume", "--profile", str(d / "prof"), "--batch-size",
               "24")
        + "import nextgenmap_tpu_torch.io.bam\n"
    ),
    "index_verb": lambda d: (
        "from nextgenmap_tpu_torch import cli\n"
        f"cli.run(['index', '-r', {str(d / 'idx.fa')!r}, '-k', '11',\n"
        "         '--index-shards', '2'])\n"
        "import glob\n"
        f"assert len(glob.glob({str(d / 'idx.fa')!r} + '.ngmt-shard*')) == 3\n"
    ),
    "cli_parallel": lambda d: (
        _cli(d, "cli_parallel.sam", "-q", str(d / "r.fq"), "--devices", "2")
        + "".join(
            _cli(d, "cli_dist.sam", "-q", str(d / "r.fq"), "--dist-nprocs",
                 "2", "--dist-procid", i, "--batch-size", "8", *extra)
            for i, extra in (("1", ("--no-merge",)), ("0", ())))
        + _cli(d, "cli_hosts.sam", "-q", str(d / "r.fq"), "--index-shards",
               "2", "--shard-across-hosts", "--devices", "2", "--skip-save")
    ),
    "import_mapper": lambda d: "import nextgenmap_tpu_torch.models.mapper\n",
    "import_parallel": lambda d: (
        "import nextgenmap_tpu_torch.parallel.distributed\n"
        "import nextgenmap_tpu_torch.parallel.dp\n"
        "import nextgenmap_tpu_torch.parallel.mesh\n"),
    "import_index_shard": lambda d: (
        "import nextgenmap_tpu_torch.parallel.index_shard\n"),
    "import_kernel_ab": lambda d: "import nextgenmap_tpu_torch.tools.kernel_ab\n",
    "import_dp_overlap": lambda d: (
        "import nextgenmap_tpu_torch.tools.dp_overlap\n"),
    "probe_tool": lambda d: (
        "import sys\n"
        "from nextgenmap_tpu_torch.tools import probe_dyngather\n"
        "sys.argv = ['probe_dyngather', '--dim', '1']\n"
        "try:\n"
        "    probe_dyngather.main()\n"
        "except SystemExit:\n"
        "    pass\n"
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_entry_point_imports_no_reference(files, case):
    # one intra-op thread, as the one_torch_thread fixture gives the other
    # torch test files: a thread per core in each fresh interpreter, beside
    # the other xdist workers, made a case ~50x slower than alone
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", CASES[case](files) + CHECK], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    if case.startswith("cli"):
        assert (case != "cli_runtime"
                or os.listdir(files / "prof")[0].endswith(".pt.trace.json"))
        outs = (("cli_parallel", "cli_dist", "cli_hosts")
                if case == "cli_parallel" else (case,))
        for out in outs:
            with open(files / f"{out}.sam") as f:
                body = [ln for ln in f if not ln.startswith("@")]
            assert len(body) >= 24
            assert np.mean([int(ln.split("\t")[1]) & 4 == 0
                            for ln in body]) > 0.8
