"""Index shards across processes (--shard-across-hosts) == the JAX package.

The cases of tests/test_cross_host_shard.py (:31, :47, :84, :118, :151)
for the port on --device cpu:
  * a build of one shard equals that row of the full build (and the JAX
    package's subset build), every array;
  * per-shard artifacts round-trip, all or nothing, and each package loads
    the other's;
  * one process with --shard-across-hosts on 4 CPU slots (dp 2 x ish 2):
    the SAM equals the JAX CLI's --index-shards 2 SAM byte for byte but @PG;
  * two processes, one CPU slot and one shard each, joined by a gloo group
    on localhost: the same SAM, each process's log shows it holds only its
    shard, the first run memoizes the per-shard artifacts and the second
    loads them;
  * two processes of two CPU slots each (dp 2 x ish 2 across processes);
  * the refusals of config.py (no coordinator, -n > 1), the runner's
    (--resume) and the layout's (shards per process, local slots), each
    before any process waits for another; and a process whose peer exits
    early ends with an error, not in a hang.
Workload: a 40 kbp genome, 350 reads of 100 bp (batches of 64), k 11.
Tolerance: byte equality of the SAM records; exact arrays.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from nextgenmap_tpu.cli import main as jax_main  # noqa: E402
from nextgenmap_tpu.index.kmer_index import KmerIndex as JKmerIndex  # noqa: E402
from nextgenmap_tpu.io.encode import decode_seq  # noqa: E402
from nextgenmap_tpu.io.fasta import write_fasta  # noqa: E402
from nextgenmap_tpu.io.simulate import (  # noqa: E402
    random_genome, simulate_reads, write_fastq,
)
from nextgenmap_tpu.parallel import index_shard as jshard  # noqa: E402
from nextgenmap_tpu_torch.cli import main as torch_main  # noqa: E402
from nextgenmap_tpu_torch.config import NgmConfig  # noqa: E402
from nextgenmap_tpu_torch.convert import index_from_reference  # noqa: E402
from nextgenmap_tpu_torch.parallel import index_shard as tshard  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_build_local_matches_full():
    g = random_genome(30_000, seed=5)
    jidx = JKmerIndex.build(g, k=11, skip=1, max_freq=100, canonical=False)
    idx = index_from_reference(jidx)
    full = tshard.ShardedIndex.build(idx, g, 3, 2000)
    for s in range(3):
        sub = tshard.ShardedIndex.build(idx, g, 3, 2000, shard_ids=[s])
        ref = jshard.ShardedIndex.build(jidx, g, 3, 2000, shard_ids=[s])
        assert sub.genome.shape == (1,) + full.genome.shape[1:]
        assert sub.positions.shape == (1,) + full.positions.shape[1:]
        np.testing.assert_array_equal(sub.genome[0], full.genome[s])
        np.testing.assert_array_equal(sub.offsets[0], full.offsets[s])
        np.testing.assert_array_equal(sub.positions[0], full.positions[s])
        np.testing.assert_array_equal(sub.base, full.base)
        np.testing.assert_array_equal(sub.core_hi, full.core_hi)
        for f in ("genome", "offsets", "positions", "base", "core_lo",
                  "core_hi", "shard_ids"):
            np.testing.assert_array_equal(getattr(sub, f), getattr(ref, f))
        assert sub.own_ids() == [s]


def test_shard_artifacts_roundtrip(tmp_path):
    g = random_genome(20_000, seed=6)
    jidx = JKmerIndex.build(g, k=11, skip=1, max_freq=100, canonical=False)
    sub = tshard.ShardedIndex.build(index_from_reference(jidx), g, 2, 1500,
                                    shard_ids=[1])
    path_for = lambda s: str(tmp_path / f"shard{s}.npz")  # noqa: E731
    sub.save_shards(path_for, "sha")
    back = tshard.ShardedIndex.load_shards([path_for(1)], [1], "sha",
                                           max_freq=100)
    assert back is not None and back.n_shards == 2
    np.testing.assert_array_equal(back.positions, sub.positions)
    np.testing.assert_array_equal(back.shard_ids, [1])
    # wrong genome hash / missing file / other max_freq -> None
    assert tshard.ShardedIndex.load_shards([path_for(1)], [1], "other") is None
    assert tshard.ShardedIndex.load_shards([path_for(0)], [0], "sha") is None
    assert tshard.ShardedIndex.load_shards([path_for(1)], [1], "sha",
                                           max_freq=99) is None
    # each package reads the other's artifacts
    jback = jshard.ShardedIndex.load_shards([path_for(1)], [1], "sha")
    jpath = lambda s: str(tmp_path / f"j{s}.npz")  # noqa: E731
    jshard.ShardedIndex.build(jidx, g, 2, 1500, shard_ids=[0]).save_shards(
        jpath, "sha")
    tback = tshard.ShardedIndex.load_shards([jpath(0)], [0], "sha")
    full = tshard.ShardedIndex.build(index_from_reference(jidx), g, 2, 1500)
    for f in ("genome", "offsets", "positions"):
        np.testing.assert_array_equal(getattr(jback, f), getattr(sub, f))
        np.testing.assert_array_equal(getattr(tback, f)[0],
                                      getattr(full, f)[0])


@pytest.fixture(scope="module")
def xh_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_xhost")
    g = random_genome(40_000, seed=31)
    write_fasta(str(d / "ref.fa"), [("chrX", decode_seq(g))])
    write_fastq(str(d / "reads.fq"),
                simulate_reads(g, 350, read_len=100, snp_rate=0.02, seed=32))
    # the JAX CLI's sequential shard loop in one process
    assert jax_main(_argv(d, "jax.sam", ("--index-shards", "2",
                                         "--skip-save"))) == 0
    return d


def _argv(d, out, extra=()):
    return ["map", "-r", str(d / "ref.fa"), "-q", str(d / "reads.fq"),
            "-o", str(d / out), "-k", "11", "--batch-size", "64",
            "--no-progress", *extra]


def _records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_xh(d, procid, port, out, slots=1, extra=()):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "nextgenmap_tpu_torch.cli",
         *_argv(d, out, ("--index-shards", "2", "--shard-across-hosts",
                         "--dist-nprocs", "2", "--dist-procid", str(procid),
                         "--dist-coordinator", f"127.0.0.1:{port}",
                         "--device", "cpu", "--devices", str(slots),
                         *extra))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _wait(procs):
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    return outs


def test_single_process_shard_hosts(xh_dir):
    d = xh_dir
    assert torch_main(_argv(d, "sh1.sam", (
        "--index-shards", "2", "--shard-across-hosts", "--skip-save",
        "--device", "cpu", "--devices", "4"))) == 0
    assert _records(d / "sh1.sam") == _records(d / "jax.sam")


def test_two_process_cross_host(xh_dir):
    d = xh_dir
    port = _free_port()
    outs = _wait([_spawn_xh(d, i, port, "xh.sam") for i in range(2)])
    assert "this host holds shards [0]" in outs[0]
    assert "this host holds shards [1]" in outs[1]
    assert "memoized own index shards [0]" in outs[0]
    assert _records(d / "xh.sam") == _records(d / "jax.sam")

    # second run: the per-shard artifacts, no global index
    port = _free_port()
    outs = _wait([_spawn_xh(d, i, port, "xh2.sam") for i in range(2)])
    assert "loaded own index shards [1]" in outs[1]
    assert _records(d / "xh2.sam") == _records(d / "jax.sam")


def test_two_process_dp2_ish2(xh_dir):
    d = xh_dir
    port = _free_port()
    outs = _wait([_spawn_xh(d, i, port, "xh_dp2.sam", slots=2)
                  for i in range(2)])
    assert "this host holds shards [0]" in outs[0]
    assert "this host holds shards [1]" in outs[1]
    assert _records(d / "xh_dp2.sam") == _records(d / "jax.sam")


def test_peer_exit_ends_with_error(xh_dir):
    """Process 1 maps one batch and leaves; process 0 meets its second
    batch's collective without a peer and raises."""
    d = xh_dir
    port = _free_port()
    p0 = _spawn_xh(d, 0, port, "peer.sam")
    p1 = _spawn_xh(d, 1, port, "peer.sam", extra=("--qry-count", "64"))
    out1 = p1.communicate(timeout=600)[0].decode()
    out0 = p0.communicate(timeout=600)[0].decode()
    assert p1.returncode == 0, out1
    assert p0.returncode != 0, out0


@pytest.mark.parametrize("extra,match", [
    (("--dist-nprocs", "2"), "--dist-coordinator"),
    (("--dist-nprocs", "2", "--dist-coordinator", "127.0.0.1:1", "-n", "2"),
     "-n/--topn"),
    (("--dist-nprocs", "2", "--dist-coordinator", "127.0.0.1:1",
      "--resume"), "--resume is not supported"),
    (("--dist-nprocs", "3", "--dist-coordinator", "127.0.0.1:1"),
     "must be a multiple of the process count 3"),
    ((), "local device count 1 not divisible by shards-per-host 2"),
])
def test_refusals(xh_dir, tmp_path, extra, match):
    d = xh_dir
    with pytest.raises(ValueError, match=match):
        torch_main(["map", "-r", str(d / "ref.fa"), "-q", str(d / "reads.fq"),
                    "-o", str(tmp_path / "x.sam"), "-k", "11",
                    "--index-shards", "2", "--shard-across-hosts",
                    "--device", "cpu", *extra])
    assert not os.path.exists(tmp_path / "x.sam")
    NgmConfig(index_shards=2, shard_hosts=True, dist_nprocs=2,
              dist_coordinator="h:1").validate()
