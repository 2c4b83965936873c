"""Port's banded SW (plain PyTorch) == the JAX reference and its Pallas kernel.

K1's plain version (nextgenmap_tpu_torch/ops/sw_ref.py::banded_sw_score) is
held bit for bit against nextgenmap_tpu's banded_sw_score and against the
TPU kernel banded_sw_score_pallas run in interpret mode, on the cases of
tests/test_sw_pallas.py.  The traceback banded_sw_align is held against the
JAX one on every AlignResult field.  Tolerance: exact equality (int DP).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nextgenmap_tpu.config import NgmConfig  # noqa: E402
from nextgenmap_tpu.ops import sw_ref as jsw  # noqa: E402
from nextgenmap_tpu.ops.scoring import matrices_are_simple, score_matrix  # noqa: E402
from nextgenmap_tpu.ops.sw_pallas import banded_sw_score_pallas  # noqa: E402
from nextgenmap_tpu_torch.ops import sw_ref as tsw  # noqa: E402
from nextgenmap_tpu_torch.ops.sw_kernel import sw_score  # noqa: E402


def _mats(cfg, n=2):
    return np.stack([score_matrix(cfg, s) for s in range(n)])


def _random_w48(seed=0, S=16, L=100, W=48, codes=4):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, codes, (S, L)).astype(np.uint8)
    r = rng.integers(0, 5, (S, L + W)).astype(np.uint8)
    for i in range(0, S, 2):  # plant exact hits so real alignments exist
        o = int(rng.integers(0, W))
        r[i, o:o + L] = q[i]
    lens = rng.integers(20, L + 1, S).astype(np.int32)
    msel = rng.integers(0, 2, S).astype(np.int32)
    return q, lens, r, msel


def case(name):
    """(query, qlen, corridor, matrices, msel, gaps, W) for one named case."""
    cfg = NgmConfig()
    if name == "random_w48":
        q, lens, r, msel = _random_w48()
        return q, lens, r, _mats(cfg), msel, (20, 20, 20), 48
    if name == "simple_with_n":   # N codes in the queries, simple matrices
        q, lens, r, msel = _random_w48(seed=7, codes=5)
        return q, lens, r, _mats(cfg), msel, (20, 20, 20), 48
    if name == "odd_sizes":
        rng = np.random.default_rng(1)
        S, L, W = 5, 73, 48
        q = rng.integers(0, 4, (S, L)).astype(np.uint8)
        r = rng.integers(0, 4, (S, L + W)).astype(np.uint8)
        r[0, 10:10 + L] = q[0]
        lens = np.array([L, 0, 31, L, 8], np.int32)
        mats = _mats(NgmConfig(match_bonus=7, mismatch_penalty=11), 1)
        return q, lens, r, mats, np.zeros(S, np.int32), (20, 20, 20), W
    if name == "asymmetric_gaps":
        rng = np.random.default_rng(2)
        S, L, W = 8, 64, 48
        q = rng.integers(0, 4, (S, L)).astype(np.uint8)
        r = rng.integers(0, 4, (S, L + W)).astype(np.uint8)
        for i in range(S):
            r[i, 5:5 + L - 6] = q[i, :L - 6]
        gcfg = NgmConfig(gap_read_penalty=25, gap_ref_penalty=30,
                         gap_extend_penalty=12)
        msel = rng.integers(0, 2, S).astype(np.int32)
        return q, np.full(S, L, np.int32), r, _mats(gcfg), msel, (25, 30, 12), W
    if name == "two_general_matrices":   # bisulfite matrices: not simple
        q, lens, r, msel = _random_w48(seed=3)
        return q, lens, r, _mats(cfg.replace(bs_mapping=True)), msel, (20, 20, 20), 48
    if name.startswith("wide"):   # long gap runs across the whole band
        W = int(name[4:])
        rng = np.random.default_rng(11)
        S, L = 4, 200
        q = rng.integers(0, 4, (S, L)).astype(np.uint8)
        r = rng.integers(0, 4, (S, L + W)).astype(np.uint8)
        for i in range(S):
            o2 = W - 8  # second anchor nearly a full band away
            r[i, :L // 2] = q[i, :L // 2]
            r[i, o2 + L // 2:o2 + L] = q[i, L // 2:]
        return q, np.full(S, L, np.int32), r, _mats(cfg, 1), np.zeros(S, np.int32), (20, 20, 3), W
    raise KeyError(name)


CASES = ["random_w48", "simple_with_n", "odd_sizes", "asymmetric_gaps",
         "two_general_matrices", "wide120", "wide184"]


def _jax_args(q, lens, r, mats, msel, gaps):
    return (jnp.asarray(q), jnp.asarray(lens), jnp.asarray(r),
            jnp.asarray(mats), *(jnp.int32(g) for g in gaps),
            jnp.asarray(msel))


def _torch_args(q, lens, r, mats, msel, gaps):
    return (torch.from_numpy(q), torch.from_numpy(lens), torch.from_numpy(r),
            torch.from_numpy(mats), *gaps, torch.from_numpy(msel))


def _assert_fields_equal(ref, got):
    for f in ref._fields:
        a = np.asarray(getattr(ref, f))
        b = getattr(got, f).numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name", CASES)
def test_score_equals_jax_and_pallas(name):
    q, lens, r, mats, msel, gaps, W = case(name)
    ja = _jax_args(q, lens, r, mats, msel, gaps)
    simple = matrices_are_simple(mats)   # as the mapper chooses it
    ref = jsw.banded_sw_score(*ja, band=W)
    pal = banded_sw_score_pallas(*ja, band=W, interpret=True, simple=simple)
    got = tsw.banded_sw_score(*_torch_args(q, lens, r, mats, msel, gaps), band=W)
    _assert_fields_equal(ref, got)
    _assert_fields_equal(pal, got)
    assert int(got.score.max()) > 0


@pytest.mark.parametrize("name", ["simple_with_n", "asymmetric_gaps",
                                  "two_general_matrices", "wide184"])
def test_align_equals_jax(name):
    q, lens, r, mats, msel, gaps, W = case(name)
    ref = jsw.banded_sw_align(*_jax_args(q, lens, r, mats, msel, gaps), band=W)
    got = tsw.banded_sw_align(*_torch_args(q, lens, r, mats, msel, gaps), band=W)
    _assert_fields_equal(ref, got)


def test_align_op_buffer_clamp_equals_jax():
    """A walk longer than max_ops clamps n_ops and raises trunc, as in JAX."""
    q, lens, r, mats, msel, gaps, W = case("random_w48")
    ref = jsw.banded_sw_align(*_jax_args(q, lens, r, mats, msel, gaps),
                              band=W, max_ops=20)
    got = tsw.banded_sw_align(*_torch_args(q, lens, r, mats, msel, gaps),
                              band=W, max_ops=20)
    _assert_fields_equal(ref, got)
    assert bool(got.trunc.any())


def test_kernel_wrapper_on_cpu_runs_plain_version():
    q, lens, r, mats, msel, gaps, W = case("odd_sizes")
    ta = _torch_args(q, lens, r, mats, msel, gaps)
    before = sw_score.launches
    _assert_fields_equal(tsw.banded_sw_score(*ta, band=W), sw_score(*ta, band=W))
    assert sw_score.launches == before


def test_glocal_mode_not_ported():
    q, lens, r, mats, msel, gaps, W = case("odd_sizes")
    with pytest.raises(NotImplementedError):
        tsw.banded_sw_score(*_torch_args(q, lens, r, mats, msel, gaps),
                            band=W, mode="glocal")
