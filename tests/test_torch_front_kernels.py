"""The front kernels' wrappers on CPU tensors == the JAX reference, and
Python transcriptions of the kernels' algorithms == the plain versions.

K5 (``ops/kmer_kernel.py::read_kmers``, ``csrc/read_kmers.cu``) against
the reference's ``models/mapper.py::_pre_extract``: canonical, two strands,
and bisulfite (``ct`` / ``ga``) with and without a --bs-cutoff, at strides
1 and 2.  K6 (``ops/candidate_kernel.py::candidate_search``,
``csrc/cand_search.cu``) against the reference's
``candidate_search_canonical`` and ``candidate_search_dual``: packed and
plain CSR offsets, two tables (``table_split``, bisulfite), H at 128, 320
and 8200 (past what the kernel's shared-memory route holds: its vote array
pads to 32768), a tie-heavy index, and the three overflow counters.  On a
CPU tensor each wrapper runs its plain version, so these hold the plain
versions and the wrappers' argument handling to the reference; the card
tests (``tests/test_torch_kernels_cuda.py``) and ``chip_smoke.py`` phases
4c and 4d hold the kernels to the plain versions.

The transcriptions follow the CUDA sources step by step, one read at a
time: K5's per-(read, column) formulas, and K6's lookups, chunked scan,
the votes of the real slots only padded with SENTINEL to a power of two,
the run keys from a binary search for each run's start, and the top C + 1
by repeated argmax of (key, lowest position).  A change to either kernel's
algorithm should change its transcription too.

Also the wrappers' refusals (dtype, shape, contiguity, device, k, route)
on CPU tensors.  Workload: a 50 kbp genome with planted repeats, a poly-A
run and an N run; 64 reads of 100 bp with N bases, short reads, reads from
the poly-A run (all three counters move) and reads at positions 0..k
(negative diagonals); bisulfite reads on a second genome for the two
tables.  The JAX functions are compiled once per static case (module
fixtures).  Tolerance: exact equality of every output.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nextgenmap_tpu.index.device_build import build_index_device as j_build  # noqa: E402
from nextgenmap_tpu.models import mapper as jmapper  # noqa: E402
from nextgenmap_tpu.ops import candidate as jcand  # noqa: E402
from nextgenmap_tpu_torch import synthetic  # noqa: E402
from nextgenmap_tpu_torch.ops import candidate as tcand  # noqa: E402
from nextgenmap_tpu_torch.ops.candidate_kernel import candidate_search  # noqa: E402
from nextgenmap_tpu_torch.ops.kmer_kernel import (  # noqa: E402
    n_windows, read_kmers, read_kmers_plain,
)
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401

K = 11
L = 100
STRIDE = 2
POLY_A = (30_000, 30_600)
SENS = 0.3
MAX_FREQ = 1000
FANOUT = 32
SENTINEL = 2**31 - 1
SMEM_PAST = 8200    # 2H = 16400 pads to 32768 votes: 256 KiB, past a block


def t(a):
    return torch.from_numpy(np.array(a))


def sens():
    return torch.tensor(SENS, dtype=torch.float32)


@pytest.fixture(scope="module")
def genome():
    g = synthetic.repeat_genome(50_000, n_repeats=8, min_len=600,
                                max_len=1500, seed=21)
    g[POLY_A[0]:POLY_A[1]] = 0
    g[1000:1003] = 4      # an N run inside the genome
    return g


@pytest.fixture(scope="module")
def reads(genome):
    rng = np.random.default_rng(22)
    codes, _, _ = synthetic.simulate_reads(genome, 40, L, 0.02, seed=23)
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
    out[62, lens[62] + 3] = 2                 # a base past the length
    return out, lens


@pytest.fixture(scope="module")
def bs_case():
    """(genome, reads, lengths) of bisulfite reads, 6 from a poly-T run."""
    g = synthetic.repeat_genome(60_000, n_repeats=12, min_len=800,
                                max_len=2000, seed=81)
    g[40_000:40_400] = 3
    codes, _, _ = synthetic.simulate_bisulfite_reads(g, 64, L, seed=82)
    for i in range(6):
        p = 40_000 + 40 * i
        codes[54 + i] = g[p:p + L]
    codes[3, 20:23] = 4
    lens = np.full(64, L, np.int32)
    lens[-3:] = [70, 45, 9]
    for i in (1, 2, 3):
        codes[-i, lens[-i]:] = 4
    return g, codes, lens


@pytest.fixture(scope="module")
def tables(genome, bs_case):
    """numpy (offsets, positions) of the canonical table, the plain
    (non-canonical) one, and the bisulfite pair (CT, then GA shifted), as
    the JAX package builds them."""
    canon = j_build(jnp.asarray(genome), k=K, skip=1, canonical=True)
    plain = j_build(jnp.asarray(genome), k=K, skip=1)
    g = jnp.asarray(bs_case[0])
    o1, p1 = j_build(g, k=K, skip=1, collapse="ct")
    o2, p2 = j_build(g, k=K, skip=1, collapse="ga")
    bs = (jnp.concatenate([o1, o2 + p1.shape[0]]), jnp.concatenate([p1, p2]))
    return {name: tuple(np.asarray(a) for a in tab)
            for name, tab in (("canonical", canon), ("plain", plain),
                              ("bisulfite", bs))}


# ---------------------------------------------------------------- K5


FRONT = [   # (canonical, bs, bs_cutoff)
    (True, False, 0), (False, False, 0), (True, True, 0), (False, True, 3),
]


@pytest.mark.parametrize("stride", [1, STRIDE])
@pytest.mark.parametrize("canonical,bs,cutoff", FRONT)
def test_read_kmers_equals_jax(reads, bs_case, canonical, bs, cutoff,
                               stride):
    codes, lens = bs_case[1:] if bs else reads
    ref = jmapper._pre_extract(jnp.asarray(codes), jnp.asarray(lens), k=K,
                               read_stride=stride, bs=bs, bs_cutoff=cutoff,
                               canonical=canonical)
    got = read_kmers(t(codes), t(lens), k=K, stride=stride, bs=bs,
                     bs_cutoff=cutoff, canonical=canonical)
    want = [ref[0], *ref[1]]
    have = [got[0], *got[1]]
    assert len(have) == (4 if canonical and not bs else 5)
    for a, b in zip(want, have):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if cutoff:   # the drop removed windows the collapse alone keeps
        full = read_kmers(t(codes), t(lens), k=K, stride=stride, bs=True,
                          canonical=canonical)[1]
        assert (full[1].numpy() & ~have[2].numpy()).any()


def k5_transcription(codes, lens, *, k, stride, bs, cutoff, canonical):
    """csrc/read_kmers.cu, one (read, column) at a time."""
    B, L_ = codes.shape
    Q = n_windows(L_, k, stride)

    def rc_code(b, p):
        j = lens[b] - 1 - p
        if p >= lens[b] or j >= L_:
            return 4
        c = int(codes[b, j])
        return 3 - c if c < 4 else c

    rc = np.array([[rc_code(b, p) for p in range(L_)] for b in range(B)],
                  np.uint8)
    i32 = lambda x: (x + 2**31) % 2**32 - 2**31  # noqa: E731
    form = 0 if canonical and not bs else (2 if bs else 1)
    outs = [np.zeros((B, Q), np.int32), np.zeros((B, Q), np.int32)]
    oks = [np.zeros((B, Q), bool), np.zeros((B, Q), bool)]
    for b in range(B):
        for q in range(Q):
            q0 = q * stride
            fits = q0 + k <= lens[b]
            if form == 0:
                v = r = 0
                ok = True
                for j in range(k):
                    w = int(codes[b, q0 + j])
                    v = ((v << 2) | (w & 3)) & 0xffffffff
                    r |= (3 - (w & 3)) << (2 * j)
                    ok &= w < 4
                vi, ri = i32(v), i32(r & 0xffffffff)
                outs[0][b, q], outs[1][b, q] = min(vi, ri), int(ri < vi)
                oks[0][b, q] = ok and fits
                continue
            for s in range(2):
                v, ok, n = 0, True, 0
                for j in range(k):
                    c = (int(codes[b, q0 + j]) if s == 0
                         else rc_code(b, q0 + j))
                    x = c
                    if form == 2:
                        frm, to = ((1, 3), (2, 0))[s]   # C->T, G->A
                        x = to if c == frm else c
                        n += c == frm
                    v = ((v << 2) | (x & 3)) & 0xffffffff
                    ok &= x < 4
                if form == 2 and cutoff > 0:
                    ok &= n <= cutoff
                outs[s][b, q] = i32(v)
                oks[s][b, q] = ok and fits
    if form == 0:
        return rc, (outs[0], outs[1], oks[0])
    return rc, (outs[0], oks[0], outs[1], oks[1])


@pytest.mark.parametrize("canonical,bs,cutoff", FRONT)
def test_read_kmers_transcription_equals_plain(reads, bs_case, canonical, bs,
                                               cutoff):
    codes, lens = bs_case[1:] if bs else reads
    codes, lens = codes[::3], lens[::3]
    got = k5_transcription(codes, lens, k=K, stride=STRIDE, bs=bs,
                           cutoff=cutoff, canonical=canonical)
    want = read_kmers_plain(t(codes), t(lens), k=K, stride=STRIDE, bs=bs,
                            bs_cutoff=cutoff, canonical=canonical)
    for a, b in zip([got[0], *got[1]], [want[0], *want[1]]):
        np.testing.assert_array_equal(a, b.numpy())


def test_read_kmers_refuses():
    r = torch.zeros((4, 30), dtype=torch.uint8)
    n = torch.full((4,), 30, dtype=torch.int32)
    bad = [
        (r.to(torch.int32), n, {}, "uint8"),
        (r[0], n[:1], {}, "uint8"),
        (r, n.long(), {}, "int32"),
        (r, n[:3], {}, "int32"),
        (r.t().contiguous().t(), n, {}, "contiguous"),
        (r, torch.empty(4, dtype=torch.int32, device="meta"), {}, "on meta"),
        (r, n, dict(k=17), "outside"),
        (r[:, :10].contiguous(), n, dict(k=11), "outside"),
        (r, n, dict(stride=0), "stride"),
    ]
    for reads_, lens_, kw, msg in bad:
        with pytest.raises(ValueError, match=msg):
            read_kmers(reads_, lens_, **{"k": 11, **kw})
    before = read_kmers.launches
    read_kmers(r, n, k=11)
    assert read_kmers.launches == before          # CPU: the plain version


# ---------------------------------------------------------------- K6


def _kms(codes, lens, *, canonical, bs, cutoff=0):
    """The JAX front's k-mers of a batch, as numpy."""
    _, kms = jmapper._pre_extract(jnp.asarray(codes), jnp.asarray(lens), k=K,
                                  read_stride=STRIDE, bs=bs,
                                  bs_cutoff=cutoff, canonical=canonical)
    return tuple(np.asarray(a) for a in kms)


# (form, packed, hit_cap, max_cmrs): form canonical, plain (two strands,
# one table) or bisulfite (two strands, two tables)
CS_CASES = [
    ("canonical", False, 128, 2), ("canonical", True, 128, 2),
    ("canonical", True, 320, 2), ("canonical", False, SMEM_PAST, 2),
    ("plain", True, 128, 2), ("plain", False, 320, 2),
    ("bisulfite", False, 128, 2), ("bisulfite", True, 320, 2),
    ("bisulfite", True, SMEM_PAST, 2),
]


def _cs_inputs(reads, bs_case, tables, form, packed):
    bs = form == "bisulfite"
    codes, lens = bs_case[1:] if bs else reads
    kms = _kms(codes, lens, canonical=form == "canonical", bs=bs,
               cutoff=6 if bs else 0)
    off, pos = tables[form]
    tab = (np.asarray(jcand.pack_offsets(jnp.asarray(off), MAX_FREQ, FANOUT))
           if packed else off)
    return kms, lens, tab, pos


def _jax_cs(kms, lens, tab, pos, *, form, packed, hit_cap, max_cmrs):
    kw = dict(fanout_cap=FANOUT, hit_cap=hit_cap, max_cmrs=max_cmrs,
              diag_bin_log2=4, stride=STRIDE, packed_offsets=packed)
    j = [jnp.asarray(a) for a in kms]
    if form == "canonical":
        return jcand.candidate_search_canonical(
            *j, jnp.asarray(lens), jnp.asarray(tab), jnp.asarray(pos),
            jnp.float32(SENS), jnp.int32(MAX_FREQ), k=K, **kw)
    return jcand.candidate_search_dual(
        *j, jnp.asarray(tab), jnp.asarray(pos), jnp.float32(SENS),
        jnp.int32(MAX_FREQ), dual_tables=form == "bisulfite", **kw)


def _port_cs(kms, lens, tab, pos, *, form, packed, hit_cap, max_cmrs,
             search=candidate_search):
    table = t(tab).to(torch.int64 if packed else torch.int32)
    return search(tuple(t(a) for a in kms), t(lens), table, t(pos), sens(),
                  MAX_FREQ, k=K, fanout_cap=FANOUT, hit_cap=hit_cap,
                  max_cmrs=max_cmrs, diag_bin_log2=4, stride=STRIDE,
                  packed_offsets=packed, dual_tables=form == "bisulfite")


def assert_cands_equal(ref, got, what=""):
    for f in tcand.Candidates._fields:
        a, b = np.asarray(getattr(ref, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype, (what, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")


@pytest.mark.parametrize("form,packed,hit_cap,max_cmrs", CS_CASES)
def test_candidate_search_equals_jax(reads, bs_case, tables, form, packed,
                                     hit_cap, max_cmrs):
    kms, lens, tab, pos = _cs_inputs(reads, bs_case, tables, form, packed)
    kw = dict(form=form, packed=packed, hit_cap=hit_cap, max_cmrs=max_cmrs)
    ref = _jax_cs(kms, lens, tab, pos, **kw)
    got = _port_cs(kms, lens, tab, pos, **kw)
    got = got._replace(**{f: getattr(got, f).numpy() for f in got._fields})
    assert_cands_equal(ref, got, form)
    assert int(got.fanout_overflow) > 0
    assert int(got.cmr_overflow) > 0
    assert (int(got.hit_overflow) > 0) == (hit_cap < SMEM_PAST)
    valid = got.score > 0
    assert set(got.strand[valid]) == {0, 1}
    if form != "bisulfite":   # the reads at positions 0..k
        assert (got.bucket[valid] < 0).any()      # floored negative diagonals


def _tie_case(rng, B=48, Q=30, rows=64, hits=6):
    """Two-strand k-mers over a hand-made index whose positions fall into
    few diagonal buckets, so that many buckets tie on their count."""
    offsets = np.arange(rows + 1, dtype=np.int32) * hits
    positions = rng.integers(0, 8, rows * hits).astype(np.int32) * 16 + 40
    km = rng.integers(0, rows, (B, Q)).astype(np.int32)
    ok = rng.random((B, Q)) < 0.8
    kms = (km, ok, km[:, ::-1].copy(), ok[:, ::-1].copy())
    return kms, np.full(B, 100, np.int32), offsets, positions


@pytest.mark.parametrize("max_cmrs", [1, 3, 64])
def test_candidate_search_ties_equal_jax(max_cmrs):
    """Equal counts over many buckets: the top C must take them in the
    order of their position in the sorted votes (lax.top_k's)."""
    kms, lens, off, pos = _tie_case(np.random.default_rng(5))
    kw = dict(form="plain", packed=False, hit_cap=128, max_cmrs=max_cmrs)
    ref = _jax_cs(kms, lens, off, pos, **kw)
    got = _port_cs(kms, lens, off, pos, **kw)
    assert_cands_equal(ref, got, "ties")
    score = got.score.numpy()
    ties = (score[:, :-1] == score[:, 1:]) & (score[:, 1:] > 0)
    # C = 1: most reads have several eligible buckets to choose among
    assert ties.sum() > 20 or int(got.cmr_overflow) > 20


def k6_transcription(kms, lens, offsets, positions, sensitivity, max_freq, *,
                     k, fanout_cap, hit_cap, max_cmrs, diag_bin_log2, stride,
                     packed_offsets, dual_tables):
    """csrc/cand_search.cu, one read at a time (search_read)."""
    kms = [a.numpy() for a in kms]
    lens, off, pos = lens.numpy(), offsets.numpy(), positions.numpy()
    s32 = np.float32(float(sensitivity))
    dual = len(kms) == 4
    B, Q = kms[0].shape
    Qt = 2 * Q if dual else Q
    H, C, K_ = hit_cap, max_cmrs, fanout_cap
    Cw = min(C, 2 * H)
    i32 = lambda x: (x + 2**31) % 2**32 - 2**31  # noqa: E731
    u32 = lambda x: x % 2**32  # noqa: E731
    bucket = np.full((B, Cw), SENTINEL, np.int32)
    score = np.zeros((B, Cw), np.int32)
    strand = np.zeros((B, Cw), np.int32)
    best_out = np.zeros(B, np.int32)
    extra_out = np.zeros(B, np.int32)
    counters = [0, 0, 0]
    for b in range(B):
        cnt, base = [0] * Qt, [0] * Qt
        for c in range(Qt):                  # 1-2. the lookups
            q, rc = (c >> 1, c & 1) if dual else (c, 0)
            ok = bool(kms[3 if rc else 1][b, q] if dual else kms[2][b, q])
            kw = int(kms[2 if rc else 0][b, q]) if ok else 0
            if dual_tables and c & 1:
                kw += off.shape[0] // 2
            if packed_offsets:
                pw = int(off[kw])
                o0, n = pw >> 6, (pw & 63) if ok else 0
            else:
                o0 = int(off[kw])
                n = int(off[kw + 1]) - o0 if ok else 0
                n = 0 if n > max_freq else n
            counters[0] += n > K_
            cnt[c], base[c] = min(n, K_), o0
        T = 32                               # 3. the chunked scan
        ch = -(-Qt // T)
        parts = [sum(cnt[min(i * ch, Qt):min(i * ch + ch, Qt)])
                 for i in range(T)]
        total = sum(parts)
        cum = [0] * Qt
        for i in range(T):
            run = sum(parts[:i])
            for c in range(min(i * ch, Qt), min(i * ch + ch, Qt)):
                cum[c] = run
                base[c] -= run
                run += cnt[c]
        counters[1] += total > H
        nv = min(total, H)                   # 4-5. the real slots' votes
        M = 2 * nv
        Mp = 1 << max(0, (M - 1).bit_length())
        votes = [SENTINEL] * Mp
        for h in range(nv):
            q = int(np.searchsorted(cum, h, side="right")) - 1
            pe = int(pos[base[q] + h])
            if dual:
                st, diag = q & 1, pe - (q >> 1) * stride
            else:
                st = int(kms[1][b, q]) ^ (pe & 1)
                p, qoff = pe >> 1, q * stride
                diag = p - qoff if st == 0 else p - (int(lens[b]) - k - qoff)
            v = u32(u32(st << 28) + u32(diag >> diag_bin_log2) + (1 << 16))
            votes[2 * h] = i32(u32(2 * v + 1))
            votes[2 * h + 1] = i32(u32(2 * (v - 1)))
        votes.sort()                         # 6. (a bitonic sort there)
        sb = [v >> 1 for v in votes]
        keys = [0] * M
        for i in range(M):
            end = i + 1 == Mp or sb[i + 1] != sb[i]
            if end and sb[i] != SENTINEL >> 1 and votes[i] & 1:
                keys[i] = i - int(np.searchsorted(sb, sb[i], side="left")) + 1
        best = max(keys, default=0)
        th = np.ceil(np.float32(best) * s32)  # 7. float32, as the kernel
        thresh = int(max(th, np.float32(1.0)))
        n_cands = sum(key >= thresh for key in keys)
        counters[2] += n_cands > C
        extra = 0
        for r in range(min(n_cands, C + 1)):  # 8. repeated argmax
            key, neg = max((kk, -i) for i, kk in enumerate(keys)
                           if kk >= thresh)
            idx = -neg
            keys[idx] = 0
            if r == C:
                extra = key
                continue
            tv = votes[idx] >> 1
            st = tv >> 28
            bucket[b, r] = i32(u32(tv - (st << 28) - (1 << 16)))
            strand[b, r], score[b, r] = st, key
        best_out[b], extra_out[b] = best, extra
    return tcand.Candidates(
        bucket=t(bucket), score=t(score), strand=t(strand),
        best_score=t(best_out),
        fanout_overflow=torch.tensor(counters[0], dtype=torch.int32),
        hit_overflow=torch.tensor(counters[1], dtype=torch.int32),
        cmr_overflow=torch.tensor(counters[2], dtype=torch.int32),
        extra_score=t(extra_out))


def _plain(kms, lens, offsets, positions, sensitivity, max_freq, *, k,
           dual_tables, **kw):
    if len(kms) == 4:
        return tcand.candidate_search_dual(*kms, offsets, positions,
                                           sensitivity, max_freq,
                                           dual_tables=dual_tables, **kw)
    return tcand.candidate_search_canonical(*kms, lens, offsets, positions,
                                            sensitivity, max_freq, k=k, **kw)


@pytest.mark.parametrize("form,packed,hit_cap,max_cmrs", [
    ("canonical", True, 128, 3), ("canonical", False, 8, 40),
    ("plain", False, 320, 2), ("bisulfite", True, 128, 3),
    ("bisulfite", False, 24, 1),
])
def test_cand_search_transcription_equals_plain(reads, bs_case, tables, form,
                                                packed, hit_cap, max_cmrs):
    """H = 8 and 24: every read overflows, C = 40 > 2H."""
    kms, lens, tab, pos = _cs_inputs(reads, bs_case, tables, form, packed)
    kw = dict(form=form, packed=packed, hit_cap=hit_cap, max_cmrs=max_cmrs)
    want = _port_cs(kms, lens, tab, pos, search=_plain, **kw)
    got = _port_cs(kms, lens, tab, pos, search=k6_transcription, **kw)
    assert_cands_equal(want, got, form)


def test_cand_search_transcription_ties():
    kms, lens, off, pos = _tie_case(np.random.default_rng(6), B=16)
    for C in (1, 3):
        kw = dict(form="plain", packed=False, hit_cap=128, max_cmrs=C)
        want = _port_cs(kms, lens, off, pos, search=_plain, **kw)
        got = _port_cs(kms, lens, off, pos, search=k6_transcription, **kw)
        assert_cands_equal(want, got, f"ties C {C}")


def test_candidate_search_refuses():
    B, Q = 4, 10
    km = torch.zeros((B, Q), dtype=torch.int32)
    ok = torch.ones((B, Q), dtype=torch.bool)
    lens = torch.full((B,), 30, dtype=torch.int32)
    off = torch.zeros(17, dtype=torch.int32)
    pos = torch.zeros(5, dtype=torch.int32)
    kw = dict(k=3, fanout_cap=4, hit_cap=16, max_cmrs=2, diag_bin_log2=4)
    canon = (km, km, ok)
    bad = [
        ((km, ok), lens, off, pos, sens(), {}, "expected 3"),
        ((km.long(), km, ok), lens, off, pos, sens(), {}, "canon must be"),
        ((km, km, ok.int()), lens, off, pos, sens(), {}, "ok must be"),
        ((km, km[:, :5], ok), lens, off, pos, sens(), {}, "flip must be"),
        ((km.t().contiguous().t(), km, ok), lens, off, pos, sens(), {},
         "contiguous"),
        (canon, lens.long(), off, pos, sens(), {}, "lengths must be"),
        (canon, lens, off, pos, sens(), dict(packed_offsets=True),
         "offsets must be"),
        (canon, lens, off.long(), pos, sens(), {}, "offsets must be"),
        (canon, lens, off, pos.long(), sens(), {}, "positions must be"),
        (canon, lens, off, pos, sens().double(), {}, "sensitivity must be"),
        (canon, lens, off, pos, torch.ones(2), {}, "sensitivity must be"),
        (canon, lens, off.to("meta"), pos, sens(), {}, "on meta"),
        (canon, lens, off, pos, sens(), dict(dual_tables=True),
         "dual_tables"),
        (canon, lens, off, pos, sens(), dict(hit_cap=0), "hit_cap"),
        (canon, lens, off, pos, sens(), dict(route="fast"), "route"),
    ]
    for kms, n, o, p, s, extra, msg in bad:
        with pytest.raises(ValueError, match=msg):
            candidate_search(kms, n, o, p, s, 10, **{**kw, **extra})
    before = candidate_search.launches
    got = candidate_search((km, ok, km, ok), lens, off, pos, sens(), 10,
                           **kw)
    assert candidate_search.launches == before    # CPU: the plain version
    assert tuple(got.score.shape) == (B, 2)
    assert math.isclose(float(got.best_score.sum()), 0.0)
