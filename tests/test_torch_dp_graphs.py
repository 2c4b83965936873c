"""The dp and ("dp", "ish") grid steps through StepGraphs == the JAX package.

  * parallel/dp.py's slices_by_device groups the slots [cuda:0, cuda:1,
    cuda:0, cuda:1], [cuda:0] x 3 and [cuda:1, cuda:0] by device (plain
    torch.device values, no card), and join_slices puts per-device stacked
    results back in slot order with the overflow counters summed;
  * a spy on StepGraphs.run: the dp step on 2 and 4 CPU slots calls it once
    a batch with K = slots, on the slots [cpu:0, cpu:1, cpu:0, cpu:1] once
    per device with K = 2; the grid at S = 2 on 4 and 8 CPU slots once a
    batch (K = rows, the shard loop with full tails), and on two CPU
    devices once per device and phase;
  * the dp step on 4 slots single-end and on 2 and 4 slots paired against
    the JAX Mapper's make_dp_map_step (tests/test_torch_dp.py has 2 and 8
    single-end, 8 paired), and the grid at S = 2 and 4 on 8 slots,
    single-end, paired and --bs-mapping, against the JAX Mapper's
    make_index_sharded_map_step, every MapResult field.  Each runs on CPU
    slots of one device (the one-device forms: one graph of K slices, one
    graph of the grid's rows) and on slots alternating between cpu:0 and
    cpu:1, which the Mapper takes as two devices: the forms of several
    cards (a graph per device; the grid's phase-1 and phase-2 steps per
    device with the cross-shard best maxed between them), whose host code
    runs here as it runs across cards.  Each JAX result is computed once
    and held against both.
Workload: tests/test_torch_dp.py's (a 64 kbp random genome, k = 11, 64
reads of 100 bp with SNPs and indels, 32 FR pairs); for --bs-mapping a
60 kbp genome with planted repeats, a (CT, GA) host index pair and 64
bisulfite reads (80% C->T, both original strands).
Tolerance: none; every field exact (global positions as int64).
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from nextgenmap_tpu.config import NgmConfig  # noqa: E402
from nextgenmap_tpu.index.kmer_index import KmerIndex  # noqa: E402
from nextgenmap_tpu.io.simulate import (  # noqa: E402
    random_genome, simulate_pairs, simulate_reads,
)
from nextgenmap_tpu.models import mapper as jmapper  # noqa: E402
from nextgenmap_tpu_torch import synthetic  # noqa: E402
from nextgenmap_tpu_torch.convert import (  # noqa: E402
    config_from_reference, index_from_reference,
)
from nextgenmap_tpu_torch.models import mapper as tmapper  # noqa: E402
from nextgenmap_tpu_torch.models.mapper import MapResult  # noqa: E402
from nextgenmap_tpu_torch.models.step_graph import StepGraphs  # noqa: E402
from nextgenmap_tpu_torch.parallel import dp  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401
from tests.test_torch_sharding import assert_equal  # noqa: E402

K = 11
CFG = NgmConfig(kmer=K)
L = 100
B = 64


class _G:
    def __init__(self, codes):
        self.codes = codes


def _slots(n: int, two: bool) -> list:
    """n CPU slots: all of one device, or alternating cpu:0 and cpu:1."""
    return [torch.device("cpu", i % 2) if two else torch.device("cpu")
            for i in range(n)]


@pytest.fixture(scope="module")
def data():
    g = random_genome(64_000, seed=77)
    reads = simulate_reads(g, B, read_len=L, snp_rate=0.03,
                           indel_rate=0.003, seed=13)
    pairs = simulate_pairs(g, B // 2, read_len=L, insert_mean=300,
                           insert_sd=30, snp_rate=0.02, seed=14)
    rg = synthetic.repeat_genome(60_000, n_repeats=14, min_len=800,
                                 max_len=2000, seed=81)
    return dict(
        g=g, index=KmerIndex.build(g, k=K, skip=2, max_freq=1000,
                                   canonical=True),
        single=np.stack([r.codes for r in reads]),
        paired=np.stack([m.codes for p in pairs for m in p]),
        bs_g=rg,
        bs_index=tuple(KmerIndex.build(rg, k=K, skip=2, max_freq=1000,
                                       collapse=c) for c in ("ct", "ga")),
        bs=synthetic.simulate_bisulfite_reads(rg, B, L, 0.8, seed=84)[0],
        lens=np.full(B, L, np.int32),
    )


def _cfg_index(data, mode, n, S):
    """(reference config, genome, host index or None, reads) of a case."""
    c = CFG.replace(devices=n, index_shards=S)
    if mode == "bs":
        return (c.replace(bs_mapping=True), data["bs_g"], data["bs_index"],
                data["bs"])
    return (c, data["g"], data["index"] if S > 1 else None, data[mode])


def _port(data, mode, n, S, two):
    c, g, index, _ = _cfg_index(data, mode, n, S)
    if index is not None:
        index = index_from_reference(index)
    return tmapper.Mapper(config_from_reference(c), _G(g), L, index,
                          device=_slots(n, two))


def _map(m, data, mode, n, S):
    codes = _cfg_index(data, mode, n, S)[3]
    step = m.map_batch_paired if mode == "paired" else m.map_batch
    return step(codes, data["lens"])


@pytest.fixture(scope="module")
def jax_runs(data):
    """The JAX Mapper's result of a (mode, devices, shards) case, each
    computed (and compiled) once."""
    out = {}

    def get(mode, n, S):
        if (mode, n, S) not in out:
            c, g, index, _ = _cfg_index(data, mode, n, S)
            m = jmapper.Mapper(c, _G(g), L, index)
            assert m.n_devices == n
            out[mode, n, S] = _map(m, data, mode, n, S)
        return out[mode, n, S]
    return get


@pytest.mark.parametrize("slots,want", [
    (["cuda:0", "cuda:1", "cuda:0", "cuda:1"],
     {"cuda:0": [0, 2], "cuda:1": [1, 3]}),
    (["cuda:0"] * 3, {"cuda:0": [0, 1, 2]}),
    (["cuda:1", "cuda:0"], {"cuda:1": [0], "cuda:0": [1]}),
])
def test_slices_by_device(slots, want):
    """The slots grouped by device, devices in order of first appearance,
    each one's slices in slot order; join_slices puts stacked per-device
    results (slice i's reads hold i) back in slot order and sums the
    overflow counters."""
    slots = [torch.device(s) for s in slots]
    groups = dp.slices_by_device(slots)
    assert list(groups) == [torch.device(d) for d in want]
    assert {str(d): ix for d, ix in groups.items()} == want
    b = 3

    def result(ix):             # slot i's b reads all hold i, overflow i+1
        k = len(ix)
        per = torch.tensor(ix, dtype=torch.int32)[:, None].expand(k, b)
        fields = {f: (per[:, 0] + 1 if f.endswith("overflow")
                      else per.clone()) for f in MapResult._fields}
        return MapResult(**fields)

    got = dp.join_slices({d: result(ix) for d, ix in groups.items()}, groups,
                         torch.device("cpu"))
    n = len(slots)
    for f in MapResult._fields:
        t = getattr(got, f)
        if f.endswith("overflow"):
            assert t.dtype == torch.int32 and int(t) == n * (n + 1) // 2
        else:
            assert t.tolist() == [i for i in range(n) for _ in range(b)], f


@pytest.fixture
def spy(monkeypatch):
    """[(step name, K, device)] of every StepGraphs.run call."""
    calls = []
    run = StepGraphs.run

    def spied(self, name, step, *inputs, device=None, **statics):
        calls.append((name, inputs[0].shape[0],
                      str(self.device if device is None else device)))
        return run(self, name, step, *inputs, device=device, **statics)

    monkeypatch.setattr(StepGraphs, "run", spied)
    return calls


@pytest.mark.parametrize("n,two", [(2, False), (4, False), (4, True)])
def test_dp_one_run_per_device_a_batch(data, spy, n, two):
    m = _port(data, "single", n, 1, two)
    for _ in range(2):
        m.map_batch(data["single"], data["lens"])
    per_batch = ([("map_step", 2, "cpu:0"), ("map_step", 2, "cpu:1")] if two
                 else [("map_step", n, "cpu")])
    assert spy == 2 * per_batch


@pytest.mark.parametrize("n,two", [(4, False), (8, False), (8, True)])
def test_grid_one_run_a_batch(data, spy, n, two):
    """S = 2: on one device one call of the shard loop with K = rows; on
    two devices a phase-1 and a phase-2 call per device."""
    m = _port(data, "single", n, 2, two)
    assert len(m._grid) == n // 2
    for _ in range(2):
        m.map_batch(data["single"], data["lens"])
    if two:
        per_batch = [("grid_phase1", 1, "cpu:0"), ("grid_phase1", 1, "cpu:1"),
                     ("grid_phase2", 1, "cpu:0"), ("grid_phase2", 1, "cpu:1")]
    else:
        per_batch = [("map_step_sharded", n // 2, "cpu")]
    assert spy == 2 * per_batch


@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("mode,n", [("single", 4), ("paired", 2),
                                    ("paired", 4)])
def test_dp_equals_jax(data, jax_runs, mode, n, two):
    got = _map(_port(data, mode, n, 1, two), data, mode, n, 1)
    assert_equal(jax_runs(mode, n, 1), got)
    assert int(got.mapped.sum()) >= 56


@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("mode", ["single", "paired", "bs"])
def test_grid_equals_jax(data, jax_runs, mode, S, two):
    """The grid on 8 slots, every field, the overflow counters included
    (the host index's k-mer skip of 2 leaves about a third of these reads
    unmapped, in both packages)."""
    got = _map(_port(data, mode, 8, S, two), data, mode, 8, S)
    assert_equal(jax_runs(mode, 8, S), got)
    assert int(got.mapped.sum()) >= B // 2
