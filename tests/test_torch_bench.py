"""The port's bench (nextgenmap_tpu_torch/bench.py) == root bench.py's
workload through the JAX map_step.

  * bench.run(genome_size=200_000, batch=256, n_batches=3, device="cpu"):
    the per-batch (mapped, truth-correct, n_candidates) of its 3-batch and
    1-batch sweeps equal the JAX map_step's on the same genome, index and
    reads, with root bench.py's statics (:80-90) and sw_backend "xla" (its
    plain reference on the CPU); K1's real slots equal the candidates of
    the reads with two or more;
  * batch 0 of that workload: all 17 MapResult fields, and the device
    index (genome, packed offsets, positions) equal the JAX build's;
  * the constants and seeds equal root bench.py's;
  * the fit, reads/s, GCUPS and the one stdout line (exactly bench.py's
    four keys) on given walls, through main();
  * --device cuda without a card raises, and the step makes no host copy
    or fetch inside a sweep (the counters come back once).
One JAX compile (B = 256) serves every case.
Tolerance: exact (integers); the arithmetic to float rounding.
"""

import json
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import bench as jbench  # noqa: E402
from nextgenmap_tpu.config import NgmConfig  # noqa: E402
from nextgenmap_tpu.index.device_build import build_index_device  # noqa: E402
from nextgenmap_tpu.io.simulate import random_genome, simulate_reads_fast  # noqa: E402
from nextgenmap_tpu.models import mapper as jmapper  # noqa: E402
from nextgenmap_tpu.ops.candidate import pack_offsets  # noqa: E402
from nextgenmap_tpu.ops.scoring import score_matrix  # noqa: E402
from nextgenmap_tpu_torch import bench  # noqa: E402
from tests.test_torch_mapper import assert_results_equal  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

SIZE, B, N = 200_000, 256, 3


@pytest.fixture(scope="module")
def reference():
    """Root bench.py's set-up and step at SIZE, B, N, through the JAX
    package: (per-batch counters [N, 3], batch 0's MapResult, the index)."""
    cfg = NgmConfig()
    g = random_genome(SIZE, seed=1)
    genome_d = jnp.asarray(g)
    off, pos = build_index_device(genome_d, k=cfg.kmer, skip=cfg.kmer_skip,
                                  canonical=True)
    packed = pack_offsets(off, cfg.max_kmer_freq, cfg.max_kmer_fanout)
    assert packed is not None
    codes, truth_pos, truth_strand = simulate_reads_fast(
        g, B * N, read_len=100, snp_rate=0.02, seed=2)
    mats = jnp.asarray(np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)]))
    statics = dict(
        k=cfg.kmer, fanout_cap=cfg.max_kmer_fanout,
        hit_cap=cfg.resolved_read_hits(int(pos.shape[0]), 100),
        max_cmrs=cfg.max_cmrs, diag_bin_log2=cfg.diag_bin_log2,
        band=cfg.corridor_for(100), min_kmer_hits=1,
        read_stride=cfg.read_kmer_skip, packed_offsets=True, canonical=True,
        sw_backend="xla", simple_matrix=True,
    )
    scal = (
        jnp.int32(cfg.gap_read_penalty), jnp.int32(cfg.gap_ref_penalty),
        jnp.int32(cfg.gap_extend_penalty), jnp.float32(cfg.sensitivity),
        jnp.int32(cfg.max_kmer_freq),
        jnp.float32(cfg.min_identity), jnp.float32(cfg.min_residues),
    )
    lens = jnp.full(B, 100, jnp.int32)
    rows, first = [], None
    for b in range(N):
        sl = slice(b * B, (b + 1) * B)
        r = jmapper.map_step(genome_d, packed, pos, jnp.asarray(codes[sl]),
                             lens, mats, *scal, **statics)
        mapped = np.asarray(r.mapped)
        ok = (mapped & (np.abs(np.asarray(r.pos) - truth_pos[sl]) <= 5)
              & (np.asarray(r.strand) == truth_strand[sl]))
        rows.append((mapped.sum(), ok.sum(), np.asarray(r.n_candidates).sum()))
        if b == 0:
            first = r
    return np.array(rows, np.int64), first, (g, packed, pos)


@pytest.fixture(scope="module")
def port_run():
    return bench.run(genome_size=SIZE, batch=B, n_batches=N, device="cpu")


def test_counters_equal_jax_map_step(reference, port_run):
    want = reference[0]
    got = port_run["counters"]
    assert got.shape == (N, len(bench.COUNTERS)) and got.dtype == np.int64
    np.testing.assert_array_equal(got[:, :3], want)
    np.testing.assert_array_equal(port_run["counters_n1"][:, :3], want[:1])
    assert port_run["mapped"] == want[:, 0].sum() >= 0.99 * B * N
    assert port_run["truth_correct"] == want[:, 1].sum() >= 0.95 * B * N
    assert port_run["n_candidates"] == want[:, 2].sum()
    # the launches are counted on the card only; the CPU runs plain versions
    assert port_run["launches"] == {name: 0 for name in bench.KERNELS}
    assert port_run["batches_run"] == 2 * (1 + N)


def test_batch0_all_fields_equal_jax(reference):
    _, ref, (g, packed, pos) = reference
    w = bench.workload(SIZE, B, "cpu")
    np.testing.assert_array_equal(w.genome, g)
    genome, off, positions = w.tables
    np.testing.assert_array_equal(genome.numpy(), g)
    np.testing.assert_array_equal(off.numpy(), np.asarray(packed))
    np.testing.assert_array_equal(positions.numpy(), np.asarray(pos))
    assert w.statics["packed_offsets"] and w.statics["canonical"]
    reads, truth_pos, truth_strand = bench.stage_reads(w, N, bench.READS_SEED)
    assert reads.shape == (N, B, 100) and reads.dtype == torch.uint8
    got = bench.step(w, reads[0])
    assert_results_equal(ref, got)
    # K1's real slots: the candidates of reads with two or more, capped
    row = bench.batch_counters(w, got, truth_pos[0], truth_strand[0])
    n = got.n_candidates.long()
    assert int(row[3]) == min(int(n[n >= 2].sum()), w.slot_cap)


def test_constants_and_seeds_equal_root_bench():
    for name in ("GENOME_SIZE", "READ_LEN", "BATCH", "N_BATCHES", "SNP_RATE",
                 "BASELINE_READS_PER_SEC"):
        assert getattr(bench, name) == getattr(jbench, name), name
    # the seeds of root bench.py's genome (:56), reads (:75), warm-up (:140)
    assert (bench.GENOME_SEED, bench.READS_SEED, bench.WARM_SEED) == (1, 2, 3)
    assert bench.TRUTH_TOL == 5
    assert bench.run.__defaults__[:3] == (jbench.GENOME_SIZE, jbench.BATCH,
                                          jbench.N_BATCHES)


def test_fit_and_stdout_line_on_given_walls(monkeypatch, capsys):
    walls = {12: 0.130, 36: 0.250}
    counters = np.tile(np.array([[4090, 4000, 4100, 7]], np.int64), (36, 1))
    r = bench.summarize(counters, walls, 12, 4096, 48)
    t_batch = (0.250 - 0.130) / 24
    assert math.isclose(r["t_batch"], t_batch)
    assert math.isclose(r["fixed"], 0.130 - 12 * t_batch)
    assert math.isclose(r["reads_per_sec"], 4096 / t_batch)
    cells = (4100 * 36 + 4096 * 36) * 100 * 48
    assert math.isclose(r["gcups"], cells / (t_batch * 36) / 1e9)
    assert (r["mapped"], r["truth_correct"], r["n_candidates"]) == (
        4090 * 36, 4000 * 36, 4100 * 36)
    assert r["k1_real_slots_per_batch"] == 7.0
    bad = bench.summarize(counters, {12: 0.2, 36: 0.2}, 12, 4096, 48)
    assert math.isnan(bad["reads_per_sec"]) and math.isnan(bad["gcups"])

    full = dict(r, counters=counters, counters_n1=counters[:12],
                genome_size=4_600_000, warm_walls=walls,
                spans_ms={12: None, 36: None}, batches_run=96,
                setup_s={"kernel_build_s": 0.0, "index_s": 1.0,
                         "reads_s": 0.5, "capture_s": 0.25},
                launches={name: 0 for name in bench.KERNELS})
    monkeypatch.setattr(bench, "run", lambda device: full)
    assert bench.main(["--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line == {"metric": "reads_per_sec_per_chip",
                    "value": round(4096 / t_batch, 1), "unit": "reads/s",
                    "vs_baseline": round(4096 / t_batch / 15_000.0, 3)}
    assert "reads/s:" in err and "set-up:" in err and "bench-json:" in err

    monkeypatch.setattr(bench, "run", lambda device: dict(full, **bad))
    assert bench.main(["--device", "cpu"]) == 1
    assert capsys.readouterr().out == ""


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main([])
    with pytest.raises(RuntimeError, match="is_available"):
        bench.run(genome_size=SIZE, batch=B, n_batches=N)


def test_sweep_fetches_nothing_per_batch(monkeypatch):
    """Inside a sweep no tensor is copied to or read back by the host: the
    counters stay on the device until the one fetch after it."""
    w = bench.workload(20_000, 32, "cpu")
    staged = bench.stage_reads(w, 2, bench.READS_SEED)
    calls = []
    for name in ("cpu", "numpy", "item", "tolist", "__int__", "__bool__",
                 "__float__"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _name=name, _orig=orig, **k):
            calls.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    out = bench.sweep(w, *staged, 2)
    monkeypatch.undo()
    assert calls == []
    assert out.shape == (2, 4) and int(out[:, 0].sum()) > 0
