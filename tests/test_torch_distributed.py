"""Read sharding across processes (--dist-nprocs) == the JAX package.

The cases of tests/test_distributed.py (:60, :75, :96, :121, :140), for the
port's CLI on --device cpu:
  * two real processes, each mapping its round-robin share of the batches
    into a part file, process 0 merging: the SAM equals the JAX CLI's
    single-process SAM byte for byte but @PG, and the parts are gone;
  * the same through a torch.distributed (gloo) group on localhost;
  * paired input (-1/-2) in two processes, against the JAX CLI's pairs;
  * --no-merge leaves a part and its manifest; the manifest's keys, its
    per-batch ledger and its counters, and the part's progress sidecar's
    keys, equal those of the JAX CLI's part for the same argv;
  * --bam: the parts stay SAM text and the merge writes BAM, whose
    records equal the single-process SAM's;
  * one process stopped after two of its batches, its sidecar marked
    incomplete and a partial record appended, then --resume: the merged
    SAM still equals the JAX CLI's.
The resume, BAM and paired cases run their processes one after the other
in this interpreter (the processes of a --dist-nprocs run without a
coordinator never talk to each other).  Workload: a 40 kbp genome, 350
reads of 100 bp (six batches of 64, the last partial), 175 FR pairs; k 11.
Tolerance: byte equality of the SAM records.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

pytest.importorskip("jax")

from nextgenmap_tpu.cli import main as jax_main  # noqa: E402
from nextgenmap_tpu.io.encode import decode_seq  # noqa: E402
from nextgenmap_tpu.io.fasta import write_fasta  # noqa: E402
from nextgenmap_tpu.io.simulate import (  # noqa: E402
    random_genome, simulate_pairs, simulate_reads, write_fastq,
)
from nextgenmap_tpu_torch.cli import main as torch_main  # noqa: E402
from nextgenmap_tpu_torch.cli import run as torch_run  # noqa: E402
from nextgenmap_tpu_torch.io.bam import read_bam  # noqa: E402
from nextgenmap_tpu_torch.parallel.distributed import merge_parts  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SE = ("-q", "reads.fq")
PE = ("-1", "r1.fq", "-2", "r2.fq")


def _argv(d, qry, out, extra=()):
    qry = [str(d / q) if q.endswith(".fq") else q for q in qry]
    return ["map", "-r", str(d / "ref.fa"), *qry, "-o", str(d / out),
            "-k", "11", "--batch-size", "64", "--no-progress", "--skip-save",
            *extra]


def _body(path):
    """(non-@PG header lines, record lines)."""
    hdr, recs = [], []
    with open(path) as f:
        for line in f:
            (hdr if line.startswith("@") else recs).append(line)
    return [h for h in hdr if not h.startswith("@PG")], recs


@pytest.fixture(scope="module")
def dist_dir(tmp_path_factory):
    """The inputs, and the JAX CLI's single-process SAMs (single-end and
    paired) and its --no-merge parts 0 and 1 of 2."""
    d = tmp_path_factory.mktemp("torch_dist")
    g = random_genome(40_000, seed=21)
    write_fasta(str(d / "ref.fa"), [("chrD", decode_seq(g))])
    write_fastq(str(d / "reads.fq"),
                simulate_reads(g, 350, read_len=100, snp_rate=0.02, seed=22))
    pairs = simulate_pairs(g, 175, read_len=100, insert_mean=300,
                           insert_sd=30, snp_rate=0.02, seed=23)
    write_fastq(str(d / "r1.fq"), [p[0] for p in pairs])
    write_fastq(str(d / "r2.fq"), [p[1] for p in pairs])
    (d / "jax").mkdir()
    assert jax_main(_argv(d, SE, "jax/single.sam")) == 0
    assert jax_main(_argv(d, PE, "jax/pe.sam")) == 0
    for i in range(2):
        assert jax_main(_argv(d, SE, "jax/nm.sam", (
            "--no-merge", "--dist-nprocs", "2", "--dist-procid", str(i)))) == 0
    return d


def _port(d, qry, out, procid, nprocs=2, extra=()):
    assert torch_main(_argv(d, qry, out, (
        "--device", "cpu", "--dist-nprocs", str(nprocs),
        "--dist-procid", str(procid), *extra))) == 0


def _spawn(d, procid, out, extra=()):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "nextgenmap_tpu_torch.cli",
         *_argv(d, SE, out, ("--device", "cpu", "--dist-nprocs", "2",
                             "--dist-procid", str(procid), *extra))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _wait(procs):
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    return outs


def test_two_process_shard_and_merge(dist_dir):
    d = dist_dir
    _wait([_spawn(d, i, "dist.sam") for i in range(2)])
    assert _body(d / "dist.sam") == _body(d / "jax/single.sam")
    assert not os.path.exists(str(d / "dist.sam") + ".part0-of-2")


def test_two_process_with_torch_distributed(dist_dir):
    d = dist_dir
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = _wait([_spawn(d, i, "distg.sam",
                         ("--dist-coordinator", f"127.0.0.1:{port}"))
                  for i in range(2)])
    assert "torch.distributed up: process 0/2" in outs[0]
    assert "torch.distributed up: process 1/2" in outs[1]
    assert _body(d / "distg.sam")[1] == _body(d / "jax/single.sam")[1]


def test_dist_paired(dist_dir):
    d = dist_dir
    _port(d, PE, "pe.sam", 1, extra=("--no-merge",))
    _port(d, PE, "pe.sam", 0)
    assert _body(d / "pe.sam") == _body(d / "jax/pe.sam")


def test_part_and_manifest_shapes(dist_dir):
    """Only process 1 runs: its part is complete and self-describing, and
    its manifest and sidecar are the JAX CLI's."""
    d = dist_dir
    _port(d, SE, "nm.sam", 1, extra=("--no-merge",))
    part = str(d / "nm.sam") + ".part1-of-2"
    ref_part = str(d / "jax/nm.sam") + ".part1-of-2"
    with open(part + ".manifest.json") as f:
        man = json.load(f)
    with open(ref_part + ".manifest.json") as f:
        ref = json.load(f)
    assert man.keys() == ref.keys() and man["stats"].keys() == ref["stats"].keys()
    for k in ("procid", "nprocs", "header_lines", "batch_lines",
              "batch_bytes", "complete"):
        assert man[k] == ref[k], k
    for k in ("reads_in", "reads_mapped", "reads_unmapped",
              "alignments_computed", "cells_computed",
              "kmer_fanout_overflow", "cmr_overflow"):
        assert man["stats"][k] == ref["stats"][k], k
    # process 1 owns batches 1, 3, 5 of ceil(350 / 64) = 6: 64 + 64 + 30
    assert man["stats"]["reads_in"] == 158
    assert _body(part)[1] == _body(ref_part)[1]
    assert sum(man["batch_lines"]) == len(_body(part)[1]) >= 158
    with open(part + ".ngmt-progress.json") as f:
        prog = json.load(f)
    with open(ref_part + ".ngmt-progress.json") as f:
        ref_prog = json.load(f)
    assert prog.keys() == ref_prog.keys()
    assert prog["batch_lines"] == man["batch_lines"] and prog["complete"]


def test_dist_bam_output(dist_dir):
    d = dist_dir
    _port(d, SE, "dist.bam", 1, extra=("--bam", "--no-merge"))
    _port(d, SE, "dist.bam", 0, extra=("--bam",))
    _, _, recs = read_bam(str(d / "dist.bam"))
    want = [ln.rstrip("\n").split("\t")[:11]
            for ln in _body(d / "jax/single.sam")[1]]
    assert recs == want


def test_dist_resume_after_kill(dist_dir):
    """Process 1 completes; process 0 stops after 3 global batches (2 of
    its own), as if killed; --resume maps only its other batch (64 reads),
    and its part's ledger equals the JAX CLI's part 0; the merge of the two
    parts equals the JAX CLI's single-process SAM."""
    d = dist_dir
    out = "distr.sam"
    _port(d, SE, out, 1, extra=("--no-merge",))
    _port(d, SE, out, 0, extra=("--no-merge", "--qry-count", "192"))
    part0 = str(d / out) + ".part0-of-2"
    prog = part0 + ".ngmt-progress.json"
    with open(prog) as f:
        doc = json.load(f)
    assert doc["reads_emitted"] == 128 and len(doc["batch_lines"]) == 2
    doc["complete"] = False          # as a kill would have left it
    with open(prog, "w") as f:
        json.dump(doc, f)
    with open(part0, "ab") as f:     # a partial in-flight record
        f.write(b"GARBAGE\tpartial")
    stats = torch_run(_argv(d, SE, out, (
        "--device", "cpu", "--dist-nprocs", "2", "--dist-procid", "0",
        "--resume", "--no-merge")))
    assert stats.reads_in == 64      # batch 4 only: the part resumed
    with open(str(d / "jax/nm.sam") + ".part0-of-2.manifest.json") as f:
        ref = json.load(f)
    with open(prog) as f:
        doc = json.load(f)
    with open(part0 + ".manifest.json") as f:
        man = json.load(f)
    assert len(ref["batch_lines"]) == 3
    for k in ("batch_lines", "batch_bytes", "header_lines"):
        assert doc[k] == man[k] == ref[k], k
    merge_parts(str(d / out), 2)
    assert _body(d / out) == _body(d / "jax/single.sam")
