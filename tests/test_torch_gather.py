"""Port's window gather (K2's plain version) == the JAX gather and DMA kernel.

gather_windows(pad_table(genome, T, 4), starts, T) in the port is held
against nextgenmap_tpu's gather_windows and against the TPU kernel
dma_gather_windows run in interpret mode (legal starts [0, G-T]), and the
kernel wrapper's CPU dispatch against both, including windows that reach
past the genome end.  Tolerance: exact equality (bytes).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nextgenmap_tpu.ops import gather as jgather  # noqa: E402
from nextgenmap_tpu.ops.gather_pallas import (  # noqa: E402
    as_dma_table, dma_gather_windows,
)
from nextgenmap_tpu_torch.ops.gather import gather_windows, pad_table  # noqa: E402
from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

G = 20_000


@pytest.fixture(scope="module")
def genome():
    return np.random.default_rng(5).integers(0, 5, G).astype(np.uint8)


def _starts(rng, T, n, reach_pad):
    hi = G if reach_pad else G - T
    s = rng.integers(0, hi + 1, n).astype(np.int32)
    s[0], s[1] = 0, G - T           # first and last legal start
    if reach_pad:
        s[2:6] = [G - T + 1, G - 1, G, G - T // 2]
    return s


@pytest.mark.parametrize("T", [148, 206])
def test_plain_equals_dma_kernel_and_jax(genome, T):
    starts = _starts(np.random.default_rng(T), T, 300, reach_pad=False)
    got = gather_windows(pad_table(torch.from_numpy(genome), T, 4),
                         torch.from_numpy(starts), T).numpy()
    dma = dma_gather_windows(as_dma_table(jnp.asarray(genome)),
                             jnp.asarray(starts), T, interpret=True)
    ref = jgather.gather_windows(jgather.pad_table(jnp.asarray(genome), T, 4),
                                 jnp.asarray(starts), T)
    np.testing.assert_array_equal(np.asarray(dma), got)
    np.testing.assert_array_equal(np.asarray(ref), got)


@pytest.mark.parametrize("T", [148, 206])
def test_wrapper_reaches_pad_like_jax(genome, T):
    starts = _starts(np.random.default_rng(T + 1), T, 300, reach_pad=True)
    starts2d = starts.reshape(30, 10)       # any shape of starts
    before = gather_genome_windows.launches
    got = gather_genome_windows(torch.from_numpy(genome),
                                torch.from_numpy(starts2d), T).numpy()
    assert gather_genome_windows.launches == before   # CPU: plain version
    ref = jgather.gather_windows(jgather.pad_table(jnp.asarray(genome), T, 4),
                                 jnp.asarray(starts2d), T)
    assert got.shape == (30, 10, T)
    np.testing.assert_array_equal(np.asarray(ref), got)
    tail = got.reshape(-1, T)[3]            # start G-1: one base, then pad
    assert tail[0] == genome[-1] and (tail[1:] == 4).all()


def test_wrapper_raises_off_cpu_without_fallback(genome):
    """A tensor that is not on the CPU never takes the plain version."""
    g = torch.from_numpy(genome).to("meta")
    with pytest.raises(ValueError):
        gather_genome_windows(g, torch.zeros(4, dtype=torch.int32, device="meta"), 8)
