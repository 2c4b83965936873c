"""The one-dispatch step (models/step_graph.py) on the CPU, where StepGraphs
runs the step eagerly over the K slices, against the eager steps and the
JAX package's map_step_scan.

  * StepGraphs at K = 1 and K = 3, through the Mapper, equals the eager
    map_step / map_step_paired / map_step_topn of each batch, field by
    field and rank by rank;
  * Mapper.map_batch_scan at K = 3 equals the JAX Mapper.map_batch_scan
    (its map_step_scan), single-end and paired, on the same numpy inputs;
  * a tail group of 2 batches padded to K = 3 emits the two batches'
    results through the runtime's Fetch, and no padding row;
  * the packed output buffer a graph writes (one byte buffer, typed views
    out of it) gives back every tensor of a single-end, top-n and sharded
    result exactly: the layout the card's graphs use, run on CPU tensors;
  * Mapper._common_args hands the float scalars as float32 and the insert
    bounds as int32 tensors on the mapper's device, and no Python float.
The card's graphs are held against the eager step in
tests/test_torch_kernels_cuda.py.  One JAX scan compile per mode.
Tolerance: exact equality of every field.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from nextgenmap_tpu.config import NgmConfig  # noqa: E402
from nextgenmap_tpu.models import mapper as jmapper  # noqa: E402
from nextgenmap_tpu_torch.convert import config_from_reference  # noqa: E402
from nextgenmap_tpu_torch.index.kmer_index import KmerIndex  # noqa: E402
from nextgenmap_tpu_torch.models import mapper as tmapper  # noqa: E402
from nextgenmap_tpu_torch.models import step_graph  # noqa: E402
from nextgenmap_tpu_torch.pipeline.runner import Fetch, RunStats  # noqa: E402
from nextgenmap_tpu_torch.synthetic import (  # noqa: E402
    repeat_genome, simulate_pairs, simulate_reads,
)
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

L, B, K = 100, 64, 3


def assert_equal(ref, got):
    """Every field of two results (a MapResult or a tuple of them), the
    reference's as numpy arrays or tensors."""
    if not hasattr(ref, "_fields"):
        assert len(ref) == len(got)
        for r, g in zip(ref, got):
            assert_equal(r, g)
        return
    assert ref._fields == got._fields
    for f in ref._fields:
        a = np.asarray(getattr(ref, f))
        b = np.asarray(getattr(got, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(scope="module")
def data():
    """A 50 kbp genome with planted repeats, K batches of B single-end
    reads and K batches of B / 2 pairs (the last batch's last reads
    short), and the port's Mapper on the CPU."""
    cfg = NgmConfig(kmer=11, topn=2)
    g = repeat_genome(50_000, n_repeats=12, min_len=800, max_len=2000,
                      seed=91)
    single, _, _ = simulate_reads(g, K * B, L, 0.02, seed=92)
    paired, _, _ = simulate_pairs(g, K * B // 2, L, 0.02, seed=93)
    lens = np.full((K, B), L, np.int32)
    lens[-1, -3:] = [70, 55, 40]
    single = single.reshape(K, B, L)
    paired = paired.reshape(K, B, L)
    for i in range(1, 4):
        single[-1, -i, lens[-1, -i]:] = 4
        paired[-1, -i, lens[-1, -i]:] = 4

    class _G:
        codes = g

    port = tmapper.Mapper(config_from_reference(cfg), _G(), L, device="cpu")
    return dict(cfg=cfg, gen=_G(), single=single, paired=paired, lens=lens,
                port=port)


def eager(port, codes, lens, kind):
    """The eager step of one batch, as the Mapper's arguments give it."""
    args = port._common_args(codes, lens, paired=kind == "paired")
    if kind == "topn":
        return tmapper.map_step_topn(*args, topn=port.topn(),
                                     **port.statics())
    step = tmapper.map_step_paired if kind == "paired" else tmapper.map_step
    return step(*args, **port.statics())


@pytest.mark.parametrize("k", [1, K])
@pytest.mark.parametrize("kind", ["single", "paired", "topn"])
def test_graphs_equal_eager_steps(data, kind, k):
    port = data["port"]
    codes = data["paired" if kind == "paired" else "single"][:k]
    lens = data["lens"][:k]
    got = port._run_steps(codes, lens, paired=kind == "paired",
                          topn=port.topn() if kind == "topn" else 0)
    for i in range(k):
        assert_equal(eager(port, codes[i], lens[i], kind),
                     step_graph.take(got, i))
    # and the one-batch entry points, which take row 0 of a K = 1 call
    one = {"single": port.map_batch, "paired": port.map_batch_paired,
           "topn": port.map_batch_topn}[kind](codes[0], lens[0])
    assert_equal(eager(port, codes[0], lens[0], kind), one)
    first = one[0] if kind == "topn" else one
    assert int(first.mapped.sum()) >= 0.9 * B


@pytest.mark.parametrize("paired", [False, True])
def test_map_batch_scan_equals_jax(data, paired):
    codes = data["paired" if paired else "single"]
    ref = jmapper.Mapper(data["cfg"], data["gen"], L).map_batch_scan(
        codes, data["lens"], paired=paired)
    got = data["port"].map_batch_scan(codes, data["lens"], paired=paired)
    assert got.mapped.shape == (K, B)
    assert_equal(ref, got)
    if paired:
        assert int(got.proper.sum()) >= 0.8 * K * B


def test_padded_tail_group_emits_no_padding(data):
    """The runner's tail group: batches 1 and 2 padded with a copy of
    batch 2 to K = 3; its Fetch emits two results, each batch's own."""
    port, codes, lens = data["port"], data["single"], data["lens"]
    rows = [1, 2, 2]
    res = port.map_batch_scan(codes[rows], lens[rows])
    out = Fetch([res], [torch.device("cpu")], None, rows=2).wait(RunStats())
    assert len(out) == 2
    for got, i in zip(out, (1, 2)):
        assert got.mapped.shape == (B,)
        assert_equal(port.map_batch(codes[i], lens[i]), got)


def sharded_port(data):
    cfg = config_from_reference(data["cfg"].replace(index_shards=2))
    idx = KmerIndex.build(data["gen"].codes, k=11, skip=cfg.kmer_skip,
                          max_freq=cfg.max_kmer_freq, canonical=True)
    return tmapper.Mapper(cfg, data["gen"], L, idx, device="cpu")


@pytest.mark.parametrize("kind", ["single", "topn", "sharded"])
def test_packed_outputs_round_trip(data, kind):
    """The graphs' output buffer: the K steps' output tensors (strided
    views of a rank grid among them) concatenated as bytes, leaves in
    order of falling item size (bool, uint8, int32 and the sharded int64
    positions, 0-d counters), read back as typed [K, ...] views, equal
    the stacked results."""
    port = sharded_port(data) if kind == "sharded" else data["port"]
    per = []
    for i in range(K):     # the steps' own outputs, strided views among them
        codes, lens = data["single"][i], data["lens"][i]
        if kind == "sharded":
            per.append(tmapper.map_step_sharded(
                *port._common_args(codes, lens), read_len=L,
                compact_cap=port.tail_cap(B), **port.statics()))
        else:
            per.append(eager(port, codes, lens, kind))
    if kind == "topn":
        assert not per[0][1].score.is_contiguous()
    layout = step_graph._Layout.of(per[0], K)
    offsets = [off for off, _, _ in layout.slots]
    sizes = [torch.empty((), dtype=dt).element_size()
             for _, dt, _ in layout.slots]
    assert all(o % s == 0 for o, s in zip(offsets, sizes))
    buf = torch.empty(layout.nbytes, dtype=torch.uint8)
    layout.pack(per, buf)
    got = layout.unpack(buf.clone())
    assert_equal(step_graph.stack_results(per), got)
    if kind == "sharded":
        assert got.pos.dtype == torch.int64


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("paired", [False, True])
def test_common_args_scalars_are_device_tensors(data, sharded, paired):
    port = sharded_port(data) if sharded else data["port"]
    cfg = port.cfg
    args = port._common_args(data["single"][0], data["lens"][0],
                             paired=paired)
    assert not any(isinstance(a, float) for a in args)
    head = len(port._tables(port.device)[0]) + 3     # tables, reads, lens, mats
    gq, gr, ge, sens, max_freq, min_id, min_res, *pair = args[head:]
    assert (gq, gr, ge, max_freq) == (
        cfg.gap_read_penalty, cfg.gap_ref_penalty, cfg.gap_extend_penalty,
        cfg.max_kmer_freq)
    assert all(type(x) is int for x in (gq, gr, ge, max_freq))
    want = [(sens, torch.float32, cfg.sensitivity),
            (min_id, torch.float32, cfg.min_identity),
            (min_res, torch.float32, cfg.min_residues)]
    if paired:
        want += [(pair[0], torch.int32, cfg.min_insert_size),
                 (pair[1], torch.int32, cfg.max_insert_size),
                 (pair[2], torch.float32, cfg.pair_score_cutoff)]
    else:
        assert pair == []
    for t, dtype, value in want:
        assert isinstance(t, torch.Tensor)
        assert t.dtype == dtype and t.device == port.device and t.dim() == 0
        assert t == torch.tensor(value, dtype=dtype)
    # made once: the same tensors on every call
    again = port._common_args(data["single"][1], data["lens"][1],
                              paired=paired)
    assert all(a is b for a, b in zip(args[head:], again[head:])
               if isinstance(a, torch.Tensor))
