"""Port's index build, k-mer extraction and candidate search == the JAX ones.

Workload: a 50 kbp genome with planted exact and ~1%-diverged repeats and a
poly-A run, and reads that include N bases, short reads, reads from the
poly-A run (so the fan-out, hit-cap and CMR overflow counters move) and
reads at genome positions 0..k shifted left so their diagonals are
negative (an arithmetic shift must floor them).  Tolerance: exact equality
of every output.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nextgenmap_tpu.index.device_build import build_index_device as j_build  # noqa: E402
from nextgenmap_tpu.ops import candidate as jcand  # noqa: E402
from nextgenmap_tpu.ops.kmer import extract_kmers_canonical as j_kmers  # noqa: E402
from nextgenmap_tpu_torch.index.device_build import build_index_device  # noqa: E402
from nextgenmap_tpu_torch.ops import candidate as tcand  # noqa: E402
from nextgenmap_tpu_torch.ops.kmer import extract_kmers_canonical  # noqa: E402
from nextgenmap_tpu_torch.synthetic import repeat_genome, simulate_reads  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

K = 11
L = 100
STRIDE = 2
POLY_A = (30_000, 30_600)


@pytest.fixture(scope="module")
def genome():
    g = repeat_genome(50_000, n_repeats=8, min_len=600, max_len=1500, seed=21)
    g[POLY_A[0]:POLY_A[1]] = 0
    g[1000:1003] = 4      # an N run inside the genome
    return g


@pytest.fixture(scope="module")
def reads(genome):
    rng = np.random.default_rng(22)
    codes, _, _ = simulate_reads(genome, 40, L, 0.02, seed=23)
    lens = np.full(64, L, np.int32)
    out = np.full((64, L), 4, np.uint8)
    out[:40] = codes
    for i in range(8):                        # inside the poly-A run
        p = POLY_A[0] + 50 * i
        out[40 + i] = genome[p:p + L]
    for d in range(1, K + 1):                 # reads at positions 0..k
        row = np.concatenate([rng.integers(0, 4, d), genome[:L - d]])
        if d % 2:
            row = (3 - row)[::-1]             # reverse strand
        out[47 + d] = row
    out[59:64] = codes[:5]
    out[59, 10:13] = 4                        # N bases
    out[60, 50] = 4
    lens[61:64] = [60, 37, 9]                 # short reads (9 < k)
    for i in (61, 62, 63):
        out[i, lens[i]:] = 4
    return out, lens


def test_index_build_and_pack_equal_jax(genome):
    j_off, j_pos = j_build(jnp.asarray(genome), k=K, skip=1, canonical=True)
    off, pos = build_index_device(torch.from_numpy(genome), k=K, skip=1)
    np.testing.assert_array_equal(np.asarray(j_off), off.numpy())
    np.testing.assert_array_equal(np.asarray(j_pos), pos.numpy())
    assert off.dtype == torch.int32 and pos.dtype == torch.int32
    j_packed = jcand.pack_offsets(j_off, 1000, 32)
    packed = tcand.pack_offsets(off, 1000, 32)
    np.testing.assert_array_equal(np.asarray(j_packed).astype(np.int64),
                                  packed.numpy())
    assert tcand.pack_offsets(off, 1000, 63) is None


def test_pack_offsets_past_int32_equals_jax():
    """o0 << 6 reaches 2^32 for large indexes: packed in int64 it must equal
    the reference's uint32 table, not wrap negative."""
    off = np.array([0, 5, 40_000_000, 40_000_070, 60_000_000,
                    (1 << 26) - 3, (1 << 26) - 1], np.int32)
    ref = np.asarray(jcand.pack_offsets(jnp.asarray(off), 1000, 32))
    got = tcand.pack_offsets(torch.from_numpy(off), 1000, 32).numpy()
    np.testing.assert_array_equal(ref.astype(np.int64), got)
    assert got.max() >= 2**31


def test_kmers_equal_jax(reads):
    codes, lens = reads
    ref = j_kmers(jnp.asarray(codes), jnp.asarray(lens), K, stride=STRIDE)
    got = extract_kmers_canonical(torch.from_numpy(codes),
                                  torch.from_numpy(lens), K, stride=STRIDE)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ok = got[2].numpy()
    assert not ok[59].all() and not ok[63].any()   # N bases, short read


@pytest.mark.parametrize("hit_cap,packed", [(128, False), (320, True)])
def test_candidate_search_equals_jax(genome, reads, hit_cap, packed):
    """H <= 256 runs JAX's dense slot ownership, H > 256 its sorted one."""
    codes, lens = reads
    j_off, j_pos = j_build(jnp.asarray(genome), k=K, skip=1, canonical=True)
    j_tab = jcand.pack_offsets(j_off, 1000, 32) if packed else j_off
    canon, flip, ok = j_kmers(jnp.asarray(codes), jnp.asarray(lens), K,
                              stride=STRIDE)
    kw = dict(k=K, fanout_cap=32, hit_cap=hit_cap, max_cmrs=2,
              diag_bin_log2=4, stride=STRIDE, packed_offsets=packed)
    ref = jcand.candidate_search_canonical(
        canon, flip, ok, jnp.asarray(lens), j_tab, j_pos,
        jnp.float32(0.3), jnp.int32(1000), **kw,
    )
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tab = tcand.pack_offsets(t(j_off), 1000, 32) if packed else t(j_off)
    got = tcand.candidate_search_canonical(
        t(canon), t(flip), t(ok), t(lens), tab, t(j_pos),
        torch.tensor(0.3, dtype=torch.float32), 1000, **kw,
    )
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(got.fanout_overflow) > 0
    assert int(got.hit_overflow) > 0
    assert int(got.cmr_overflow) > 0
    valid = got.score.numpy() > 0
    assert (got.bucket.numpy()[valid] < 0).any()   # floored negative diagonals


def test_select_candidates_ties_equal_jax():
    """Many equal bucket scores: the stable descending sort must order ties
    like lax.top_k (lower index first)."""
    rng = np.random.default_rng(9)
    votes = rng.integers(0, 24, (32, 96)).astype(np.int32)
    votes[:, -8:] = tcand.SENTINEL
    sens = 0.3
    ref = jcand._select_candidates(jnp.asarray(votes), jnp.float32(sens), 6, None)
    got = tcand._select_candidates(torch.from_numpy(votes),
                                   torch.tensor(sens, dtype=torch.float32), 6)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
