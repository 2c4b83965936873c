"""Several devices in one process (--devices N) == the JAX package.

  * the dp step (the port's Mapper on a list of N CPU slots, each batch in
    N contiguous slices mapped in turn) against the JAX Mapper's
    make_dp_map_step on a CPU mesh of N devices (tests/test_sharding.py's
    :72 and :81): single-end at N = 2 and 8, paired at N = 8, every
    MapResult field;
  * the ("dp", "ish") step on 8 slots against the JAX Mapper's
    make_index_sharded_map_step on make_mesh(8, index_shards=S)
    (test_sharding.py :91, :115, :136): single-end at S = 2 and 4, paired
    at S = 4, and the same output for S = 2, 4 and 8;
  * the CLI's `--device cpu --devices 2|4` SAM against the JAX CLI's
    `--devices 2|4` (test_e2e.py:165);
  * the lazy slot cap of each slice: a batch whose reads all have six
    candidates overflows the 512 slots of one whole-batch step, but not
    those of each half, so a cap sized from the whole batch would leave the
    reference's output;
  * -n 2 with two slots maps the whole batch on the first device (the
    JAX Mapper's map_batch_topn), --megabatch is off with several slots;
  * the refusals of the reference's mesh.py and Mapper, and the one grid
    layout of the runner and the Mapper against the reference's meshes.
Workload: tests/test_sharding.py's (a 64 kbp random genome, k = 11, 64
reads of 100 bp with SNPs and indels, 32 FR pairs); a 40 kbp genome for the
CLI; six diverged copies of a 3 kbp unit for the slot cap.
Tolerance: none; every field exact (global positions as int64).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from nextgenmap_tpu.cli import main as jax_main  # noqa: E402
from nextgenmap_tpu.config import NgmConfig  # noqa: E402
from nextgenmap_tpu.index.kmer_index import KmerIndex  # noqa: E402
from nextgenmap_tpu.io.simulate import (  # noqa: E402
    random_genome, simulate_pairs, simulate_reads,
)
from nextgenmap_tpu.models import mapper as jmapper  # noqa: E402
from nextgenmap_tpu_torch import synthetic  # noqa: E402
from nextgenmap_tpu_torch.cli import main as torch_main  # noqa: E402
from nextgenmap_tpu_torch.convert import (  # noqa: E402
    config_from_reference, index_from_reference,
)
from nextgenmap_tpu_torch.models import mapper as tmapper  # noqa: E402
from nextgenmap_tpu_torch.parallel import mesh  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401
from tests.test_torch_sharding import assert_equal  # noqa: E402

K = 11
CFG = NgmConfig(kmer=K)
L = 100


class _G:
    def __init__(self, codes):
        self.codes = codes


@pytest.fixture(scope="module")
def data():
    g = random_genome(64_000, seed=77)
    reads = simulate_reads(g, 64, read_len=L, snp_rate=0.03,
                           indel_rate=0.003, seed=13)
    pairs = simulate_pairs(g, 32, read_len=L, insert_mean=300, insert_sd=30,
                           snp_rate=0.02, seed=14)
    return dict(
        g=g, index=KmerIndex.build(g, k=K, skip=2, max_freq=1000,
                                   canonical=True),
        codes=np.stack([r.codes for r in reads]),
        pcodes=np.stack([m.codes for p in pairs for m in p]),
        lens=np.full(64, L, np.int32),
    )


def _pair(cfg, g, index, n):
    """(JAX Mapper over a CPU mesh of n devices, port Mapper on n slots)."""
    c = cfg.replace(devices=n)
    ref = jmapper.Mapper(c, _G(g), L, index)
    port = tmapper.Mapper(config_from_reference(c), _G(g), L,
                          None if index is None else index_from_reference(index),
                          device=["cpu"] * n)
    return ref, port


@pytest.mark.parametrize("n", [2, 8])
def test_dp_single_end_identical(data, n):
    ref, port = _pair(CFG, data["g"], None, n)
    assert ref.n_devices == n and len(port.slots) == n
    got = port.map_batch(data["codes"], data["lens"])
    assert_equal(ref.map_batch(data["codes"], data["lens"]), got)
    assert int(got.mapped.sum()) >= 60


def test_dp_paired_identical(data):
    ref, port = _pair(CFG, data["g"], None, 8)
    got = port.map_batch_paired(data["pcodes"], data["lens"])
    assert_equal(ref.map_batch_paired(data["pcodes"], data["lens"]), got)
    assert int(got.proper.sum()) >= 56


def _grid_mapper(data, S, jax=False):
    """The JAX Mapper on make_mesh(8, index_shards=S), or the port's on 8
    CPU slots."""
    c = CFG.replace(devices=8, index_shards=S)
    if jax:
        return jmapper.Mapper(c, _G(data["g"]), L, data["index"])
    return tmapper.Mapper(config_from_reference(c), _G(data["g"]), L,
                          index_from_reference(data["index"]),
                          device=["cpu"] * 8)


@pytest.fixture(scope="module")
def grid_runs(data):
    """Results of the ("dp", "ish") step on 8 slots, by (package, S,
    paired), each computed once."""
    out = {}

    def get(pkg, S, paired):
        if (pkg, S, paired) not in out:
            m = _grid_mapper(data, S, jax=pkg == "jax")
            if pkg == "port":
                assert len(m._grid) == 8 // S and len(m._grid[0]) == S
            step = m.map_batch_paired if paired else m.map_batch
            out[pkg, S, paired] = step(data["pcodes" if paired else "codes"],
                                       data["lens"])
        return out[pkg, S, paired]
    return get


@pytest.mark.parametrize("S", [2, 4])
def test_index_sharded_single_end(grid_runs, S):
    assert_equal(grid_runs("jax", S, False), grid_runs("port", S, False))


def test_index_sharded_paired(grid_runs):
    assert_equal(grid_runs("jax", 4, True), grid_runs("port", 4, True))


def test_shard_count_invariance(grid_runs):
    """DESIGN.md rule 15 over the grid: S = 2, 4 and 8 on 8 slots place
    and score every read as the reference's S = 2 (the reference's own
    invariance test compares these fields: n_candidates counts the winner
    shard's candidates, which S may split)."""
    want = grid_runs("jax", 2, False)
    for S in (2, 4, 8):
        got = grid_runs("port", S, False)
        for f in ("mapped", "pos", "strand", "score", "mapq", "ops"):
            np.testing.assert_array_equal(
                np.asarray(getattr(want, f)).astype(np.int64),
                getattr(got, f).numpy().astype(np.int64), err_msg=f)


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    from nextgenmap_tpu.io.encode import decode_seq
    from nextgenmap_tpu.io.fasta import write_fasta
    from nextgenmap_tpu.io.simulate import write_fastq

    d = tmp_path_factory.mktemp("torch_dp_cli")
    g = random_genome(40_000, seed=3)
    write_fasta(str(d / "ref.fa"), [("chr1", decode_seq(g))])
    write_fastq(str(d / "reads.fq"), simulate_reads(
        g, 150, read_len=L, snp_rate=0.02, seed=5))
    return d


def _run(main, d, out, extra):
    device = ["--device", "cpu"] if main is torch_main else []
    assert main(["map", "-r", str(d / "ref.fa"), "-q", str(d / "reads.fq"),
                 "-o", str(d / out), "-k", "11", "--batch-size", "50",
                 "--no-progress", "--skip-save", *device, *extra]) == 0
    with open(d / out) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


@pytest.fixture(scope="module")
def one_device_sam(cli_dir):
    return _run(torch_main, cli_dir, "torch_dp1.sam", ())


@pytest.mark.parametrize("n", ["2", "4"])
def test_multi_device_cli_identical(cli_dir, one_device_sam, n):
    """--devices N rounds the batch (50 -> 52 or 56) as the reference does,
    and the SAM equals the JAX CLI's byte for byte but @PG (and the port's
    one-device SAM)."""
    want = _run(jax_main, cli_dir, f"jax_dp{n}.sam", ("--devices", n))
    got = _run(torch_main, cli_dir, f"torch_dp{n}.sam", ("--devices", n))
    assert got == want == one_device_sam


def test_slot_cap_per_slice():
    """Every read has six candidates: 128 reads fill 768 score slots, over
    one step's max(512, 128 // 2); each 64-read slice's 384 fit its own
    512.  The reference sizes the cap from the slice (shard_map's local
    batch), and so does the port: a cap taken from the whole batch would
    give the one-device output, which differs."""
    rng = np.random.default_rng(41)
    unit = rng.integers(0, 4, 3000).astype(np.uint8)
    parts = []
    for _ in range(6):
        copy = unit.copy()
        snp = rng.random(3000) < 0.01
        copy[snp] = (copy[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
        parts += [copy, rng.integers(0, 4, 2000).astype(np.uint8)]
    g = np.concatenate(parts)
    codes, _, _ = synthetic.simulate_reads(unit, 128, L, 0.0, seed=42)
    lens = np.full(128, L, np.int32)
    ref, port = _pair(CFG, g, None, 2)
    got = port.map_batch(codes, lens)
    assert_equal(ref.map_batch(codes, lens), got)
    one = tmapper.Mapper(config_from_reference(CFG), _G(g), L, device="cpu")
    whole = one.map_batch(codes, lens)
    assert int(whole.cmr_overflow) > 0 == int(got.cmr_overflow)
    assert not torch.equal(whole.score, got.score)


def test_topn_and_megabatch_with_devices(data):
    """-n 2 with two slots: the whole batch on the first device, as the
    JAX Mapper's map_batch_topn; --megabatch does not apply."""
    c = CFG.replace(topn=2)
    ref, port = _pair(c, data["g"], None, 2)
    want = ref.map_batch_topn(data["codes"], data["lens"])
    got = port.map_batch_topn(data["codes"], data["lens"])
    for a, b in zip(want, got):
        assert_equal(a, b)
    assert not port.supports_megabatch()


def test_device_refusals(data, monkeypatch):
    """The reference's refusals: more devices than there are, a device
    count the shards do not divide, -n on the grid."""
    with monkeypatch.context() as m:   # a machine with two cards
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 2)
        with pytest.raises(ValueError, match="requested 3 devices, have 2"):
            mesh.device_slots("cuda", 3)
        assert mesh.device_slots("cuda", 0) == [torch.device("cuda", i)
                                                for i in range(2)]
        assert mesh.device_slots("cuda:1", 1) == [torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="4 devices not divisible by 3"):
        mesh.make_mesh(["cpu"] * 4, index_shards=3)
    assert mesh.make_mesh(["cpu"] * 4, index_shards=2).shape == (2, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mesh.device_slots("cuda", 2)
    assert mesh.device_slots("cpu", 0) == [torch.device("cpu")]
    c = config_from_reference(CFG.replace(index_shards=3, devices=4))
    with pytest.raises(ValueError, match="divisible by 3, got 4"):
        tmapper.Mapper(c, _G(data["g"]), L,
                       index_from_reference(data["index"]), device="cpu")
    port = _grid_mapper(data, 2)
    with pytest.raises(ValueError, match="single device"):
        port.map_batch_topn(data["codes"], data["lens"])
    with pytest.raises(ValueError, match="does not split over 4 devices"):
        port.map_batch(data["codes"][:62], data["lens"][:62])


@pytest.mark.parametrize("hosts", [False, True])
@pytest.mark.parametrize("S", [2, 4])
def test_grid_layout_matches_reference_mesh(S, hosts):
    """parallel/index_shard.py::grid_layout, the one layout the runner
    loads shards by and the Mapper places them by, puts slot i where the
    reference's mesh puts device i: make_mesh(8, index_shards=S) in one
    process, global_ish_mesh(S) with --shard-across-hosts; and process 1 of
    2 with 4 slots holds the upper half of the shards."""
    import jax
    from nextgenmap_tpu.parallel import index_shard as jshard
    from nextgenmap_tpu.parallel import mesh as jmesh

    from nextgenmap_tpu_torch.config import NgmConfig as TConfig
    from nextgenmap_tpu_torch.parallel.index_shard import grid_layout

    slots = [torch.device("cuda", i) for i in range(8)]
    cfg = TConfig(index_shards=S, shard_hosts=hosts)
    rows, own = grid_layout(cfg, slots)
    ref = (jshard.global_ish_mesh(S) if hosts
           else jmesh.make_mesh(8, index_shards=S, devices=jax.devices()))
    assert own == list(range(S))
    assert [[d.index for d in r] for r in rows] == [
        [d.id for d in r] for r in np.asarray(ref.devices)]
    rows, own = grid_layout(
        TConfig(index_shards=S, shard_hosts=True, dist_nprocs=2,
                dist_procid=1), slots[:4])
    assert own == list(range(S // 2, S))
    assert sorted(d.index for r in rows for d in r) == [0, 1, 2, 3]
    assert grid_layout(TConfig(index_shards=S), slots[:1]) is None
