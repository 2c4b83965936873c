"""The port's runtime (pipeline/runner.py) against the JAX package's.

  * -t 1, 2 and 4 (the one-late emitter on the main thread, the emitter
    thread, the pool of -t - 1 render workers): SAM equal to the JAX CLI's
    for single-end, paired and -n 2, with spies on the emitter kinds;
  * --megabatch 2 and 3 (a group of batches per map_batch_scan call, the
    short tail group padded) at -t 1 and 4 against the JAX CLI's
    --megabatch, and --megabatch 2 -t 4 --index-shards 2 (the pool renders
    whole groups) against the port's -t 1 run;
  * an error in the emitter thread, in a render worker and in the parse
    thread ends the run with that error;
  * the alignment and cell counters behind GCUPS equal the JAX run's, for
    single-end, paired, -n 2 and --index-shards 2;
  * --profile writes a trace that parses as JSON;
  * --corridor 225 (W = 264, K1's wide band on the card; its plain version
    here) equals the JAX CLI's.
Tolerance: exact equality (SAM bytes apart from @PG, integer counters).
"""

import json
import os

import pytest

pytest.importorskip("jax")

from nextgenmap_tpu import cli as jcli  # noqa: E402
from nextgenmap_tpu.pipeline import runner as jrunner  # noqa: E402
from nextgenmap_tpu_torch import synthetic  # noqa: E402
from nextgenmap_tpu_torch.cli import run as torch_run  # noqa: E402
from nextgenmap_tpu_torch.pipeline import runner  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

N_SINGLE, N_PAIRS, B = 150, 60, 32     # 5 single-end batches, 4 paired

QRY = {"single": ("-q", "r.fq"), "paired": ("-1", "r1.fq", "-2", "r2.fq"),
       "topn": ("-q", "r.fq", "-n", "2")}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("runtime")
    g = synthetic.repeat_genome(40_000, n_repeats=8, min_len=500,
                                max_len=1500, seed=71)
    synthetic.write_fasta(str(d / "ref.fa"), "chr", g)
    codes, pos, strand = synthetic.simulate_reads(g, N_SINGLE, 100, 0.02,
                                                  seed=72)
    synthetic.write_fastq(str(d / "r.fq"), codes, pos, strand)
    codes, pos, strand = synthetic.simulate_pairs(g, N_PAIRS, 100, 0.02,
                                                  seed=73)
    for m in (0, 1):
        synthetic.write_fastq(str(d / f"r{m + 1}.fq"), codes[m::2],
                              pos[m::2], strand[m::2], prefix="simpair")
    return d


def argv(d, case, out, *extra):
    q = [str(d / x) if x.endswith(".fq") else x for x in QRY[case]]
    return ["map", "-r", str(d / "ref.fa"), *q, "-o", str(d / out), "-k",
            "11", "--batch-size", str(B), "--no-progress", *extra]


def records(path):
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@PG")]


@pytest.fixture(scope="module")
def jax_ref(data):
    """(records but @PG, MappingStats) of the JAX package's run_mapping on
    a case's argv, one run per (case, flags) for the whole module."""
    cache = {}

    def get(case, *extra):
        key = (case, extra)
        if key not in cache:
            out = f"jax{len(cache)}.sam"
            a = jcli.build_parser()[0].parse_args(argv(data, case, out, *extra))
            stats = jrunner.run_mapping(
                jcli.config_from_args(a), a.reference, qry=a.qry,
                qry1=a.qry1, qry2=a.qry2, out_path=a.output)
            cache[key] = (records(data / out), stats)
        return cache[key]

    return get


def port(data, case, out, *extra):
    """(records but @PG, RunStats) of the port's CLI on the CPU."""
    stats = torch_run(argv(data, case, out, *extra, "--device", "cpu"))
    return records(data / out), stats


@pytest.fixture
def spies(monkeypatch):
    """Record each emitter the runner builds: ("emitter", threaded) or
    ("pool", workers), the batches each dispatch emits, and the batches
    each Mapper.map_batch_scan call maps (a padded tail group counts its
    padding)."""
    made, groups, scans = [], [], []

    class Emitter(runner._Emitter):
        def __init__(self, emit, threaded):
            made.append(("emitter", threaded))
            super().__init__(emit, threaded)

    class Pool(runner._PoolEmitter):
        def __init__(self, workers, render, commit):
            made.append(("pool", workers))
            super().__init__(workers, render, commit)

    class Fetch(runner.Fetch):
        def __init__(self, results, device, start, rows=0):
            groups.append(rows or len(results))
            super().__init__(results, device, start, rows)

    scan = runner.Mapper.map_batch_scan

    def map_batch_scan(self, codes_k, lengths_k, paired=False):
        scans.append(len(codes_k))
        return scan(self, codes_k, lengths_k, paired)

    monkeypatch.setattr(runner, "_Emitter", Emitter)
    monkeypatch.setattr(runner, "_PoolEmitter", Pool)
    monkeypatch.setattr(runner, "Fetch", Fetch)
    monkeypatch.setattr(runner.Mapper, "map_batch_scan", map_batch_scan)
    return made, groups, scans


@pytest.mark.parametrize("case", ["single", "paired", "topn"])
def test_threads_sam_equals_jax(data, jax_ref, spies, case):
    made, groups, scans = spies
    want, _ = jax_ref(case)
    for t in ("1", "2", "4"):
        got, stats = port(data, case, f"{case}_t{t}.sam", "-t", t)
        assert got == want, t
        assert stats.reads_in == (N_SINGLE if case != "paired"
                                  else 2 * N_PAIRS)
    assert made == [("emitter", False), ("emitter", True), ("pool", 3)]
    assert set(groups) == {1} and scans == []


@pytest.mark.parametrize("case,k,threads", [
    pytest.param("single", 2, "1", id="single"),
    pytest.param("paired", 2, "1", id="paired"),
    pytest.param("single", 2, "4", id="single-tail1-t4"),
    pytest.param("single", 3, "1", id="single-tail2of3"),
])
def test_megabatch_equals_jax(data, jax_ref, spies, case, k, threads):
    """--megabatch K: each group is one map_batch_scan call of K batches,
    the short tail group padded with copies of its last batch; SAM equal
    to the JAX CLI's --megabatch K (which pads its tail the same way), and
    no padding emitted."""
    _, groups, scans = spies
    want, _ = jax_ref(case, "--megabatch", str(k))
    got, stats = port(data, case, f"{case}_mb{k}_t{threads}.sam",
                      "--megabatch", str(k), "-t", threads)
    assert got == want
    n = -(-(N_SINGLE if case == "single" else 2 * N_PAIRS) // B)
    tail = [n % k] if n % k else []
    assert groups == [k] * (n // k) + tail
    assert scans == [k] * len(groups)
    assert stats.reads_in == (N_SINGLE if case == "single" else 2 * N_PAIRS)


def test_megabatch_pool_sharded_equals_serial(data, spies):
    """--megabatch 2 -t 4 --index-shards 2: the pool renders groups of two
    batches; the SAM equals the port's -t 1 run (the reference's pool
    breaks on a mapper that cannot megabatch, so no JAX run here)."""
    made, groups, scans = spies
    base, _ = port(data, "single", "sh.sam", "--index-shards", "2")
    got, _ = port(data, "single", "sh_mb.sam", "--index-shards", "2",
                  "--megabatch", "2", "-t", "4")
    assert got == base
    assert made == [("emitter", False), ("pool", 3)]
    assert groups == [1] * 5 + [2, 2, 1]
    assert scans == [2, 2, 2]


def test_megabatch_off_for_topn_and_bisulfite_shards():
    """The one predicate for --megabatch: never -n > 1, not the bisulfite
    shard loop, and not with several device slots or the shard grid."""
    from types import SimpleNamespace

    from nextgenmap_tpu_torch.config import NgmConfig
    from nextgenmap_tpu_torch.models.mapper import Mapper

    for shards, bs, mode, want, slots, grid in (
            (None, False, "single", True, 1, None),
            (None, True, "paired", True, 1, None),
            (object(), False, "paired", True, 1, None),
            (object(), True, "single", False, 1, None),
            (None, False, "topn", False, 1, None),
            (None, False, "single", False, 2, None),
            (None, False, "single", False, 1, [[object()]])):
        cfg = NgmConfig(megabatch=2, bs_mapping=bs)
        m = SimpleNamespace(shards=shards, cfg=cfg, slots=[None] * slots,
                            _grid=grid)
        m.supports_megabatch = lambda m=m: Mapper.supports_megabatch(m)
        assert runner.runs_megabatched(cfg, mode, m) == want
        assert not runner.runs_megabatched(cfg.replace(megabatch=1), mode, m)


class Boom(RuntimeError):
    pass


@pytest.mark.parametrize("where,threads", [
    ("emitter", "1"), ("emitter", "2"), ("worker", "4"), ("parse", "1"),
    ("parse", "4"),
])
def test_error_in_any_thread_ends_the_run(data, monkeypatch, where,
                                          threads):
    if where == "parse":
        real = runner.batch_single

        def batches(*a, **k):
            it = real(*a, **k)
            yield next(it)
            raise Boom("parse")

        monkeypatch.setattr(runner, "batch_single", batches)
    else:
        real, calls = runner.emit_single, []

        def emit(*a, **k):
            calls.append(1)
            if len(calls) == 2:
                raise Boom(where)
            return real(*a, **k)

        monkeypatch.setattr(runner, "emit_single", emit)
    with pytest.raises(Boom):
        torch_run(argv(data, "single", f"boom_{where}{threads}.sam", "-t",
                       threads, "--device", "cpu"))


@pytest.mark.parametrize("case,extra", [
    ("single", ()), ("paired", ()), ("topn", ()),
    ("single", ("--index-shards", "2")),
])
def test_counters_equal_jax(data, jax_ref, case, extra):
    """C8: alignments_computed and cells_computed (GCUPS) per run equal the
    JAX run_mapping's; so do the read counters."""
    want_recs, want = jax_ref(case, *extra)
    got_recs, got = port(data, case, f"{case}_cnt{len(extra)}.sam", *extra)
    assert got_recs == want_recs
    for f in ("alignments_computed", "cells_computed", "reads_in",
              "reads_mapped", "reads_unmapped", "pairs_proper"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.alignments_computed > 0 and got.cells_computed > 0
    assert got.gcups() > 0


def test_profile_writes_a_json_trace(data, tmp_path):
    prof = tmp_path / "prof"
    got, _ = port(data, "single", "prof.sam", "--profile", str(prof),
                  "--qry-count", "8", "--batch-size", "8")
    assert len(got) == 8 + 2          # @HD, @SQ
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(prof / traces[0]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]


def test_wide_corridor_equals_jax(data, jax_ref):
    """--corridor 225: W = 32 + 232 = 264, past K1's old 256-cell limit."""
    flags = ("--corridor", "225", "--qry-count", "64")
    want, _ = jax_ref("single", *flags)
    got, _ = port(data, "single", "corridor.sam", *flags)
    assert got == want
