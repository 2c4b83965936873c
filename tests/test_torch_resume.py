"""The port's progress sidecar, --resume and --qry-start/--qry-count, on
--device cpu: the four cases of tests/test_resume.py, and the sidecar's
config hash equal to the JAX CLI's for the same argv.

Tolerance: exact equality (SAM records, bytes, the hash).
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from nextgenmap_tpu_torch import synthetic
from nextgenmap_tpu_torch.cli import main
from tests.test_torch_row_gather import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 150
B = 32


@pytest.fixture(scope="module")
def rdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_resume")
    g = synthetic.repeat_genome(30_000, n_repeats=4, min_len=500,
                                max_len=1000, seed=14)
    synthetic.write_fasta(str(d / "ref.fa"), "chr1", g)
    codes, pos, strand = synthetic.simulate_reads(g, N, 100, 0.02, seed=15)
    synthetic.write_fastq(str(d / "reads.fq"), codes, pos, strand)
    return d


def _argv(d, out, extra=()):
    return ["map", "-r", str(d / "ref.fa"), "-q", str(d / "reads.fq"),
            "-o", str(d / out), "-k", "11", "--batch-size", str(B),
            "--no-progress", *extra]


def _map(d, out, extra=()):
    assert main(_argv(d, out, extra) + ["--device", "cpu"]) == 0
    return [ln for ln in (d / out).read_text().splitlines()
            if not ln.startswith("@")]


@pytest.fixture(scope="module")
def full(rdir):
    """The records of one uninterrupted run."""
    return _map(rdir, "full.sam")


def test_qry_window(rdir, full):
    part = _map(rdir, "win.sam", ("--qry-start", "50", "--qry-count", "40"))
    assert len(part) == 40
    assert part == full[50:90]


def test_resume_completes_interrupted_run(rdir, full):
    # phase 1: map only the first 64 reads (stands in for an interrupted run)
    _map(rdir, "resumed.sam", ("--qry-count", "64"))
    prog = rdir / "resumed.sam.ngmt-progress.json"
    p = json.loads(prog.read_text())
    assert p["reads_emitted"] == 64 and p["complete"] is True
    phase1 = (rdir / "resumed.sam").read_bytes()
    assert p["out_bytes"] == len(phase1)
    # mark the checkpoint incomplete, as a killed run would have left it,
    # and add the partial record a kill leaves past the checkpoint
    p["complete"] = False
    prog.write_text(json.dumps(p))
    with open(rdir / "resumed.sam", "ab") as f:
        f.write(b"GARBAGE\ttruncated-in-flight-rec")
    # phase 2: resume drops the partial tail and appends the other reads
    resumed = _map(rdir, "resumed.sam", ("--resume", "-t", "4"))
    final = (rdir / "resumed.sam").read_bytes()
    assert final.startswith(phase1)      # phase 1's header and @PG kept
    assert b"GARBAGE" not in final
    assert resumed == full
    assert json.loads(prog.read_text())["complete"] is True


def test_sigkill_mid_run_then_resume(rdir, full):
    """SIGKILL the port's CLI (a subprocess, by its PID) once a batch is
    checkpointed, then resume: the records equal an uninterrupted run's."""
    out = rdir / "killed.sam"
    prog = rdir / "killed.sam.ngmt-progress.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "nextgenmap_tpu_torch.cli",
         *_argv(rdir, "killed.sam", ("--skip-save",)), "--device", "cpu"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    deadline = time.time() + 300
    emitted = 0
    try:
        while time.time() < deadline and proc.poll() is None:
            if prog.exists():
                try:
                    emitted = json.loads(prog.read_text()).get(
                        "reads_emitted", 0)
                except ValueError:
                    emitted = 0
                if 0 < emitted < N:
                    break
            time.sleep(0.02)
    finally:
        killed = proc.poll() is None
        if killed:
            proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    if killed and 0 < emitted < N:
        assert proc.returncode == -signal.SIGKILL
        assert _map(rdir, "killed.sam", ("--resume",)) == full
    else:
        # the run ended before a kill window opened: nothing to resume
        assert proc.returncode == 0
        assert [ln for ln in out.read_text().splitlines()
                if not ln.startswith("@")] == full


def test_resume_ignores_mismatched_config(rdir):
    _map(rdir, "cfg.sam", ("--qry-count", "64"))
    prog = rdir / "cfg.sam.ngmt-progress.json"
    p = json.loads(prog.read_text())
    p["complete"] = False
    prog.write_text(json.dumps(p))
    # another sensitivity: another config hash, so a fresh full run
    out = _map(rdir, "cfg.sam", ("--resume", "-s", "0.4"))
    assert len(out) == N


def test_config_sha_equals_reference(rdir):
    """The sidecar's config hash is the reference's for the same argv, so
    either CLI can tell whether a sidecar belongs to its configuration."""
    pytest.importorskip("jax")
    from nextgenmap_tpu.cli import main as jax_main

    flags = ("--qry-count", "32", "-t", "3", "--corridor", "40",
             "--rg-id", "g")
    assert jax_main(_argv(rdir, "sha_jax.sam", flags)) == 0
    port = _map(rdir, "sha_port.sam", flags)
    read = lambda n: json.loads(  # noqa: E731
        (rdir / f"{n}.ngmt-progress.json").read_text())
    ref, got = read("sha_jax.sam"), read("sha_port.sam")
    assert got["config_sha"] == ref["config_sha"]
    assert got["reads_emitted"] == ref["reads_emitted"] == 32
    assert port == [ln for ln in (rdir / "sha_jax.sam").read_text()
                    .splitlines() if not ln.startswith("@")]


def test_bam_never_resumes_and_stdout_has_no_sidecar(rdir, full, capsys,
                                                    monkeypatch):
    """BGZF cannot be appended record-wise: --bam --resume starts fresh;
    `-o -` writes no sidecar."""
    from nextgenmap_tpu_torch.io.bam import read_bam

    def bam(*extra):
        argv = _argv(rdir, "part.bam", ("--bam", *extra))
        assert main(argv + ["--device", "cpu"]) == 0

    bam("--qry-count", "64")
    prog = rdir / "part.bam.ngmt-progress.json"
    p = json.loads(prog.read_text())
    assert p["reads_emitted"] == 64 and p["out_bytes"] is None
    p["complete"] = False
    prog.write_text(json.dumps(p))
    bam("--resume")
    recs = ["\t".join(r) for r in read_bam(str(rdir / "part.bam"))[2]]
    assert recs == ["\t".join(ln.split("\t")[:11]) for ln in full]

    monkeypatch.chdir(rdir)
    argv = _argv(rdir, "x", ("--qry-count", "32"))
    argv[argv.index("-o") + 1] = "-"
    assert main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert sum(not ln.startswith("@") for ln in out.splitlines()) == 32
    assert not list(rdir.glob("-*")) and not (rdir / "x").exists()
