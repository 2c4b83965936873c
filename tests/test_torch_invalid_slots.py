"""The plain score pass hands its invalid slots to K1 at length 0.

The lazy (single, paired) and eager (top-n) score passes compact the real
(read, candidate) pairs into the first slots; the rest are invalid.  The
plain pass (ops/score_pass_kernel.py::score_pass_plain, the CPU's) scores
them at length 0, so K1 runs no DP row for them (the fused pass on a card
never runs them at all), and every
MapResult field of the three steps still equals the JAX package's.  The
plain banded_sw_score returns (0, 0, 0) for a slot of length 0 in both
modes, whatever its query and corridor hold.
Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from nextgenmap_tpu.models import mapper as jmapper  # noqa: E402
from nextgenmap_tpu_torch.convert import config_from_reference  # noqa: E402
from nextgenmap_tpu_torch.models import mapper as tmapper  # noqa: E402
from nextgenmap_tpu_torch.ops import score_pass_kernel  # noqa: E402
from nextgenmap_tpu_torch.ops.sw_ref import banded_sw_score  # noqa: E402
from nextgenmap_tpu_torch.pipeline.runner import slots_scored  # noqa: E402
from tests.test_torch_mapper import L, assert_results_equal, repeats  # noqa: E402,F401
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401


@pytest.mark.parametrize("mode", ["local", "glocal"])
def test_plain_score_of_length_zero_is_zero(mode):
    rng = np.random.default_rng(71)
    q = torch.from_numpy(rng.integers(0, 4, (6, 30)).astype(np.uint8))
    r = torch.cat([q, q[:, :8]], dim=1)              # a perfect corridor
    lens = torch.tensor([0, 0, 30, 0, 12, 0], dtype=torch.int32)
    mats = torch.full((8, 8), -15, dtype=torch.int32)
    mats[:4, :4].fill_diagonal_(10)
    got = banded_sw_score(q, lens, r, mats, 20, 20, 20, band=8, mode=mode)
    zero = lens == 0
    for t in got:
        assert not t[zero].any()
    assert (got.score[~zero] > 0).all()


@pytest.mark.parametrize("step,kind", [
    ("map_batch", "single"), ("map_batch_paired", "paired"),
    ("map_batch_topn", "topn"),
])
def test_invalid_slots_scored_at_length_zero(repeats, monkeypatch, step,
                                             kind):
    cfg, g, reads, lens, _, _, _ = repeats
    cfg = cfg.replace(topn=2)
    # 16 empty reads, so that even the eager pass leaves slots empty
    reads, lens = reads.copy(), lens.copy()
    reads[-16:], lens[-16:] = 4, 0
    seen = []
    score = score_pass_kernel.sw_score

    def spy(q, qlen, corr, *args, **kw):
        seen.append(qlen.clone())
        return score(q, qlen, corr, *args, **kw)

    monkeypatch.setattr(score_pass_kernel, "sw_score", spy)

    class _G:
        codes = g

    ref = getattr(jmapper.Mapper(cfg, _G(), L), step)(reads, lens)
    port = getattr(tmapper.Mapper(config_from_reference(cfg), _G(), L,
                                  device="cpu"), step)(reads, lens)
    ranks = (ref, port) if kind == "topn" else ((ref,), (port,))
    for r, p in zip(*ranks):
        assert_results_equal(r, p)
    (qlen,) = seen
    first = port[0] if kind == "topn" else port
    n_real = slots_scored(kind, first.n_candidates.numpy(), reads.shape[0])
    assert 0 < n_real < qlen.shape[0]
    assert (qlen[:n_real] > 0).all() and not qlen[n_real:].any()
