"""The port's graft entry (nextgenmap_tpu_torch/graft_entry.py) == the JAX
package's __graft_entry__.py.

  * _setup: the same genome, host index, reads (single-end and the
    vectorised FR pairs), matrices, scalars and statics (the port has no
    sw_backend);
  * entry(device="cpu"): the port's step on its example args equals the
    jitted JAX entry() in all 17 MapResult fields, >= 60 of 64 mapped;
  * dryrun_multichip(4, device="cpu") on four CPU slots: both legs (the
    local ("dp", "ish") grid and the --shard-across-hosts layout in one
    process) equal the JAX Mapper's at devices=4, index_shards=2 in the
    same two layouts, on the 8 CPU devices of tests/conftest.py, in every
    field of every read but ROADMAP C7's (mate 2 of the one pair that
    straddles the shard core boundary, where the port equals its own
    unsharded step); ish = 1 and no second leg below four slots;
  * device="cuda" without a card raises.
Tolerance: exact, every field (global positions as int64), C7 apart.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import __graft_entry__ as jgraft  # noqa: E402
from nextgenmap_tpu.models.mapper import Mapper as JMapper  # noqa: E402
from nextgenmap_tpu_torch import graft_entry  # noqa: E402
from nextgenmap_tpu_torch.config import NgmConfig  # noqa: E402
from nextgenmap_tpu_torch.models.mapper import Mapper  # noqa: E402
from nextgenmap_tpu_torch.parallel.index_shard import ShardedIndex  # noqa: E402
from tests.test_torch_mapper import assert_results_equal  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401
from tests.test_torch_sharding import assert_equal  # noqa: E402


@pytest.mark.parametrize("paired,canonical,seed", [
    (False, True, 0), (True, False, 3)])
def test_setup_equals_reference(paired, canonical, seed):
    _, g, idx, args, statics = jgraft._setup(64, seed=seed, paired=paired,
                                             canonical=canonical)
    _, tg, tidx, targs, tstatics = graft_entry._setup(
        64, seed=seed, paired=paired, canonical=canonical, device="cpu")
    np.testing.assert_array_equal(tg, g)
    for a, b in zip(idx.device_arrays(), tidx.device_arrays()):
        np.testing.assert_array_equal(a, b)
    assert len(targs) == len(args) == 13
    for a, b in zip(args[:6], targs[:6]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    for a, b in zip(args[6:], targs[6:]):
        assert np.float32(a) == np.float32(b) and isinstance(b, (int, float))
    # the port's statics are the reference's without its simple_matrix
    # option, which no output of the port's steps depends on
    statics.pop("simple_matrix")
    assert tstatics == statics


def test_entry_equals_jitted_reference():
    fn, args = jgraft.entry()
    ref = jax.jit(fn)(*args)
    tfn, targs = graft_entry.entry(device="cpu")
    got = tfn(*targs)
    assert_results_equal(ref, got)
    assert int(got.mapped.sum()) >= 60


@pytest.fixture(scope="module")
def reference_legs():
    """The JAX package's dryrun_multichip(4) Mappers (devices=4,
    index_shards=2, sw_backend "xla"): (local mesh result, cross-host)."""
    cfg, g, idx, args, _ = jgraft._setup(64, seed=3, paired=True)
    cfg = cfg.replace(devices=4, index_shards=2, sw_backend="xla")

    class _G:
        codes = g

    codes, lens = np.asarray(args[3]), np.asarray(args[4])
    return tuple(JMapper(c, _G(), 100, index=idx).map_batch_paired(codes, lens)
                 for c in (cfg, cfg.replace(shard_hosts=True)))


# the fields in which ROADMAP C7 departs from the reference
C7_FIELDS = ("mapped", "proper", "second", "mapq")


def test_dryrun_multichip_four_slots_equals_reference(reference_legs, capsys):
    """Both legs equal the reference's in every field of every read, but
    for ROADMAP C7, the one intended departure: mate 2 of a proper pair
    that straddles the shard core boundary (pair 21 here: 24,751 and
    25,116 about the boundary at 25,000), which the reference's merge
    unmaps and the port keeps as the unsharded step maps it."""
    local, cross = graft_entry.dryrun_multichip(4, device="cpu")
    assert cross is not None
    _, g, idx, args, _ = graft_entry._setup(64, seed=3, paired=True,
                                            device="cpu")
    unsharded = Mapper(NgmConfig(kmer=11), SimpleNamespace(codes=g), 100,
                       index=idx, device="cpu").map_batch_paired(
        args[3].numpy(), args[4].numpy())
    sidx = ShardedIndex.build(idx, g, 2, ShardedIndex.halo_for(
        NgmConfig(kmer=11)))
    core = unsharded.pos.long() >= int(sidx.core_lo[1])
    straddles = core[0::2] != core[1::2]
    c7 = torch.zeros(64, dtype=torch.bool)
    c7[1::2] = straddles & unsharded.proper[1::2]
    assert c7.nonzero().flatten().tolist() == [43]
    rest = (~c7).numpy()
    for ref, got in zip(reference_legs, (local, cross)):
        assert_equal(ref, got, skip=C7_FIELDS)
        for f in C7_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(ref, f))[rest],
                                          getattr(got, f).numpy()[rest],
                                          err_msg=f)
        assert not np.asarray(ref.mapped)[~rest].any()
        for f in got._fields:
            assert torch.equal(getattr(got, f).long(),
                               getattr(unsharded, f).long()), f
    assert int(local.proper.sum()) >= 32
    out = capsys.readouterr().out
    assert "[local (dp,ish) grid]" in out and "ish=2" in out
    assert "[cross-host global ish grid]" in out


def test_dryrun_below_four_slots_has_one_leg(capsys):
    assert graft_entry.slots(3, "cpu") == [torch.device("cpu")] * 3
    local, cross = graft_entry.dryrun_multichip(2, device="cpu")
    assert cross is None and int(local.proper.sum()) >= 32
    assert "ish=1" in capsys.readouterr().out


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="is_available"):
        graft_entry.dryrun_multichip(4)
