"""Port's map_step and Mapper (device cpu) == the JAX reference, field by field.

The JAX state (genome, CSR index, matrices) is carried across with
nextgenmap_tpu_torch.convert.state_from_numpy.  Three workloads:
  (a) __graft_entry__._setup(64, canonical=True): random genome, every read
      has one candidate;
  (b) a genome with planted exact and ~1%-diverged repeats, where >= 8
      reads have two or more candidates, so the score pass scores real
      slots;
  (c) the same with a small slot_cap, so the slot overflow counter moves.
Tolerance: exact equality of all 17 MapResult fields (integer DP; the
float32 filter and MAPQ arithmetic is the same op sequence).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from nextgenmap_tpu.config import NgmConfig  # noqa: E402
from nextgenmap_tpu.index.device_build import build_index_device  # noqa: E402
from nextgenmap_tpu.models import mapper as jmapper  # noqa: E402
from nextgenmap_tpu.ops.candidate import pack_offsets  # noqa: E402
from nextgenmap_tpu.ops.scoring import matrices_are_simple, score_matrix  # noqa: E402
from nextgenmap_tpu_torch.convert import (  # noqa: E402
    config_from_reference, state_from_numpy,
)
from nextgenmap_tpu_torch.models import mapper as tmapper  # noqa: E402
from nextgenmap_tpu_torch.ops import candidate as tcand  # noqa: E402
from nextgenmap_tpu_torch.synthetic import repeat_genome, simulate_reads  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

L = 100
B = 96


def assert_results_equal(ref, got):
    assert ref._fields == got._fields
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).cpu().numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


def _port_step(state, offsets, reads, lens, scalars, statics):
    return tmapper.map_step(
        state.genome, offsets, state.positions, torch.from_numpy(np.array(reads)),
        torch.from_numpy(np.array(lens)), state.matrices, *scalars, **statics,
    )


def test_graft_workload_equals_jax():
    cfg, g, idx, args, statics = graft._setup(64, canonical=True)
    ref = jmapper.map_step(*args, **statics)
    off, pos = idx.device_arrays()
    state = state_from_numpy(g, off, pos, np.asarray(args[5]), "cpu")
    assert statics.pop("canonical")
    statics.pop("simple_matrix")      # the reference's option alone
    got = _port_step(state, state.offsets, np.asarray(args[3]),
                     np.asarray(args[4]), (20, 20, 20, 0.5, 1000, 0.65, 0.5),
                     statics)
    assert_results_equal(ref, got)
    assert int(got.mapped.sum()) >= 60


@pytest.fixture(scope="module")
def repeats():
    """(cfg, genome, reads, lens, offsets, JAX args, statics) of (b)."""
    cfg = NgmConfig(kmer=11)
    g = repeat_genome(50_000, n_repeats=12, min_len=800, max_len=2000, seed=31)
    reads, _, _ = simulate_reads(g, B, L, 0.02, seed=32)
    lens = np.full(B, L, np.int32)
    lens[-3:] = [70, 55, 40]                  # short reads in the batch
    for i in range(1, 4):
        reads[-i, lens[-i]:] = 4
    off, pos = build_index_device(jnp.asarray(g), k=11, skip=1, canonical=True)
    mats = np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])
    statics = dict(
        k=11, fanout_cap=cfg.max_kmer_fanout,
        hit_cap=cfg.resolved_read_hits(pos.shape[0], L),
        max_cmrs=cfg.max_cmrs, diag_bin_log2=cfg.diag_bin_log2,
        band=cfg.corridor_for(L), min_kmer_hits=1,
        read_stride=cfg.read_kmer_skip, packed_offsets=True,
    )
    jargs = (
        jnp.asarray(g), pack_offsets(off, 1000, cfg.max_kmer_fanout), pos,
        jnp.asarray(reads), jnp.asarray(lens), jnp.asarray(mats),
        jnp.int32(20), jnp.int32(20), jnp.int32(20), jnp.float32(0.5),
        jnp.int32(1000), jnp.float32(0.65), jnp.float32(0.5),
    )
    return cfg, g, reads, lens, np.asarray(off), jargs, statics


@pytest.mark.parametrize("slot_cap", [0, 8])
def test_repeat_workload_equals_jax(repeats, slot_cap):
    cfg, g, reads, lens, off, jargs, statics = repeats
    ref = jmapper.map_step(*jargs, **statics, canonical=True, slot_cap=slot_cap,
                           simple_matrix=matrices_are_simple(jargs[5]))
    state = state_from_numpy(g, off, jargs[2], jargs[5], "cpu")
    packed = tcand.pack_offsets(state.offsets, 1000, cfg.max_kmer_fanout)
    got = _port_step(state, packed, reads, lens,
                     (20, 20, 20, 0.5, 1000, 0.65, 0.5),
                     dict(statics, slot_cap=slot_cap))
    assert_results_equal(ref, got)
    n_multi = int((got.n_candidates >= 2).sum())
    assert n_multi >= 8, n_multi
    multi_slots = int(got.n_candidates[got.n_candidates >= 2].sum())
    if slot_cap:
        assert multi_slots > slot_cap and int(got.cmr_overflow) > 0
    # the score pass decided: some multi-candidate read's second score is > 0
    assert int(got.second[got.n_candidates >= 2].max()) > 0


def test_mapper_builds_same_state_and_results_as_jax(repeats):
    cfg, g, reads, lens, _, _, _ = repeats

    class _G:
        codes = g

    ref = jmapper.Mapper(cfg, _G(), L).map_batch(reads, lens)
    port = tmapper.Mapper(config_from_reference(cfg), _G(), L, device="cpu")
    assert port.packed_offsets and port.device.type == "cpu"
    assert_results_equal(ref, port.map_batch(reads, lens))


@pytest.mark.parametrize("change", [
    # the device layouts the reference's Mapper refuses (several devices
    # map, index shards the devices do not divide do not), and index
    # sharding without a host index
    dict(bs_mapping=True, index_shards=2, devices=2),
    dict(end_to_end=True, devices=2, index_shards=4),
    dict(devices=0, index_shards=2, shard_hosts=True),
    dict(index_shards=2, devices=3),
    dict(devices=2, index_shards=3, shard_hosts=True, dist_nprocs=2),
    dict(megabatch=2, devices=4, index_shards=3),
])
def test_out_of_slice_config_raises(change):
    class _G:
        codes = np.zeros(1000, np.uint8)

    with pytest.raises(ValueError):
        tmapper.Mapper(config_from_reference(NgmConfig(kmer=11).replace(**change)), _G(), L,
                       device="cpu")


def test_mapper_cuda_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class _G:
        codes = np.zeros(1000, np.uint8)

    with pytest.raises(RuntimeError):
        tmapper.Mapper(config_from_reference(NgmConfig(kmer=11)), _G(), L,
                       device="cuda")
