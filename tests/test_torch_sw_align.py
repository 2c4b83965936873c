"""K4's traceback (csrc/sw_align.cu) held on the CPU before it reaches a card.

  * the wrapper ops/sw_align_kernel.py::sw_align on CPU tensors returns the
    plain banded_sw_align exactly and never builds or loads the kernel
    library;
  * the plain version split in two (banded_sw_forward, then the row walk
    _backwalk_rows) equals the JAX banded_sw_align in every field, local
    and glocal, with general matrices and a matrix per slot (one shared
    JAX run per mode);
  * a transcription of the kernel's walk (one alignment, one cell a step)
    over the kernel's packed rows (`pack`: each cell's 4-bit code, NPL
    cells a lane word, bit 4 dropped) equals _backwalk_rows in every field;
    it recomputes bit 4 (sub > 0, which splits matches from mismatches)
    from the clamped codes and the slot's matrix, as the kernel does.  On
    480 seeded alignments (W 1, 2, 8, 48, 184 and 264; local and glocal;
    cheap gaps, so I and D runs are common, with runs off the band's edges;
    tie-heavy periodic inputs; qlen 0; a max_ops that truncates), over
    random direction bytes, where D runs fall off the left edge (also in
    the block form's layout, W 520 and 1024), and on bisulfite matrices
    with N bases and pad codes.
The kernel's forward pass is held byte for byte against banded_sw_forward
on the card (tests/test_torch_kernels_cuda.py).
Tolerance: exact equality (integer DP and bytes).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from nextgenmap_tpu.ops import sw_ref as jsw  # noqa: E402
from nextgenmap_tpu_torch.native import build  # noqa: E402
from nextgenmap_tpu_torch.ops import sw_ref as tsw  # noqa: E402
from nextgenmap_tpu_torch.ops.scoring import score_matrix  # noqa: E402
from nextgenmap_tpu_torch.config import NgmConfig  # noqa: E402
from nextgenmap_tpu_torch.ops.sw_align_kernel import sw_align  # noqa: E402
from tests.test_torch_row_gather import one_torch_thread  # noqa: E402,F401
from tests.test_torch_sw import (  # noqa: E402
    _assert_fields_equal, _jax_args, _torch_args,
)

OP_M, OP_I, OP_D, OP_NONE = 0, 1, 2, 255
PH_H, PH_E, PH_F = 0, 1, 2
BANDS = (1, 2, 8, 48, 184, 264)
GAPS = {"default": (20, 20, 20), "cheap": (4, 6, 1)}
MODES = ("local", "glocal")


def _mats(rng, general):
    """[2, 8, 8]: the default matrices, or two random asymmetric ones."""
    if not general:
        return np.stack([score_matrix(NgmConfig(), s) for s in range(2)])
    m = rng.integers(-20, 4, (2, 8, 8)).astype(np.int32)
    for c in range(4):
        m[:, c, c] = rng.integers(6, 13, 2)
    return m


def _inputs(rng, B, L, W):
    """Queries planted in their corridors with SNPs and short indels at a
    random offset, every third one tie-heavy (ACAC... over ACAC...), some
    random, some N codes, lengths 0, short and L."""
    q = rng.integers(0, 4, (B, L)).astype(np.uint8)
    r = rng.integers(0, 4, (B, L + W)).astype(np.uint8)
    for b in range(B):
        kind = b % 5
        if kind in (0, 3):
            o = int(rng.integers(0, W))
            seg = q[b].copy()
            snp = rng.random(L) < 0.04
            seg[snp] = (seg[snp] + 1) % 4
            for _ in range(2):                 # an insertion, a deletion
                cut = int(rng.integers(1, L))
                if rng.random() < 0.5:
                    seg = np.delete(seg, cut)
                else:
                    seg = np.insert(seg, cut, rng.integers(0, 4, 2))
            seg = seg[:L + W - o]
            r[b, o:o + seg.shape[0]] = seg
        elif kind == 1:
            q[b] = np.resize(np.array([0, 1], np.uint8), L)
            r[b] = np.resize(np.array([0, 1] if b % 2 else [1, 0], np.uint8),
                             L + W)
    q[rng.random((B, L)) < 0.01] = 4
    lens = np.full(B, L, np.int32)
    lens[2::7] = rng.integers(1, L + 1, lens[2::7].shape[0])
    lens[4::9] = 0
    msel = rng.integers(0, 2, B).astype(np.int32)
    return q, lens, r, msel


def _fields(res):
    return {f: getattr(res, f).numpy() for f in res._fields}


# ---- a transcription of the kernel's walk (csrc/sw_align.cu) ----

# run_band's (largest W, lanes per alignment, cells per lane) table; past
# W 512 a block of 32 * ceil(W / 256) threads, 8 cells each
K4_TABLE = ((16, 8, 2), (32, 8, 4), (48, 16, 3), (64, 16, 4), (96, 16, 6),
            (128, 16, 8), (192, 32, 6), (256, 32, 8), (384, 32, 12),
            (512, 32, 16))
PAD = 5   # kPadCode: codes >= 5 are clamped to it and score 0


def k4_layout(W):
    """(lanes, cells per lane) of the kernel's packed rows at band W."""
    for top, lanes, npl in K4_TABLE:
        if W <= top:
            return lanes, npl
    return 32 * -(-W // 256), 8


def pack(dirs, lanes, npl):
    """The kernel's packed rows of the direction bytes dirs [L, B, W]:
    [B, L, lanes] words, cell o in word o // npl at bits 4 (o % npl) to
    4 (o % npl) + 3, its byte's bits 0-3 (bit 4 dropped); cells past W 0."""
    L, B, W = dirs.shape
    codes = np.zeros((B, L, lanes * npl), np.uint64)
    codes[:, :, :W] = (dirs & 15).transpose(1, 0, 2)
    shifts = 4 * np.arange(npl, dtype=np.uint64)
    return (codes.reshape(B, L, lanes, npl) << shifts).sum(-1,
                                                          dtype=np.uint64)


def positive_mask(mat):
    """Bit 8q + r set where the matrix [8, 8] scores (q, r) > 0, the
    entries of a code >= 5 zeroed: the kernel's positive_mask."""
    return sum(1 << (8 * q + r) for q in range(PAD) for r in range(PAD)
               if mat[q, r] > 0)


def k4_walk(words, npl, qc, rc, pos, W, best, bi, bo, max_ops):
    """The kernel's walk_back over one alignment's packed rows words
    [L, lanes]; qc [L] and rc [L + W] its codes clamped to 5, pos the
    positive_mask of its matrix (bit 4 of an M cell)."""
    i, o, ph, c = bi, bo, PH_H, 0
    qs, rs, nm, nmm, nid, tr = bi, bi + bo, 0, 0, 0, False
    ops = np.full(max_ops, OP_NONE, np.uint8)
    if best > 0:
        while i >= 0 and 0 <= o < W:
            v = (int(words[i, o // npl]) >> (4 * (o % npl))) & 15
            src = (v & 3) if ph == PH_H else (2 if ph == PH_E else 3)
            if src == 0:
                break
            if src == 1:
                op = OP_M
                hit = (pos >> (8 * int(qc[i]) + int(rc[i + o]))) & 1
                nm, nmm = (nm + 1, nmm) if hit else (nm, nmm + 1)
                qs, rs, i = i, i + o, i - 1
            elif src == 2:
                op, nid, qs = OP_I, nid + 1, i
                ph = PH_E if v & 4 else PH_H
                i, o = i - 1, o + 1
            else:
                op, nid, rs = OP_D, nid + 1, i + o
                ph = PH_F if v & 8 else PH_H
                o -= 1
            if c < max_ops:
                ops[c] = op
                c += 1
            else:
                tr = True
    return {"score": best, "q_start": qs, "q_end": bi, "r_start": rs,
            "r_end": bi + bo, "ops": ops, "n_ops": c, "matches": nm,
            "mismatches": nmm, "indels": nid, "trunc": tr}


def _assert_walks_equal(dirs, best, bi, bo, max_ops, what, q, r, mats,
                        msel):
    """k4_walk over the packed rows of every alignment == _backwalk_rows
    over the bytes of the batch (q [B, L], r [B, L + W] the codes, mats
    [M, 8, 8] and msel [B] the slot's matrix, clamped as the kernel does)."""
    ref = _fields(tsw._backwalk_rows(torch.from_numpy(dirs),
                                     torch.from_numpy(best),
                                     torch.from_numpy(bi),
                                     torch.from_numpy(bo), max_ops))
    W = dirs.shape[2]
    lanes, npl = k4_layout(W)
    words = pack(dirs, lanes, npl)
    qc, rc = np.minimum(q, PAD), np.minimum(r, PAD)
    masks = [positive_mask(m) for m in mats]
    for b in range(dirs.shape[1]):
        m = 0 if len(mats) == 1 else min(max(int(msel[b]), 0), len(mats) - 1)
        got = k4_walk(words[b], npl, qc[b], rc[b], masks[m], W,
                      int(best[b]), int(bi[b]), int(bo[b]), max_ops)
        for f, v in got.items():
            np.testing.assert_array_equal(ref[f][b], v,
                                          err_msg=f"{what} slot {b} {f}")
    return ref


# ---- tests ----

def test_wrapper_on_cpu_runs_plain_version_without_the_library(monkeypatch):
    rng = np.random.default_rng(5)
    q, lens, r, msel = _inputs(rng, 12, 40, 48)
    ta = _torch_args(q, lens, r, _mats(rng, True), msel, (20, 20, 20))

    def refuse(*a, **k):
        raise AssertionError("the kernel library was built or loaded")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build", refuse)
    before = sw_align.launches
    for mode in MODES:
        for max_ops in (0, 9):
            want = tsw.banded_sw_align(*ta, band=48, max_ops=max_ops,
                                       mode=mode)
            for route in (None, "smem", "global"):   # no routes on the CPU
                got = sw_align(*ta, band=48, max_ops=max_ops, mode=mode,
                               route=route)
                for f in want._fields:
                    assert torch.equal(getattr(want, f), getattr(got, f)), f
    assert sw_align.launches == before
    with pytest.raises(ValueError, match="semiglobal"):
        sw_align(*ta, band=48, mode="semiglobal")
    with pytest.raises(ValueError, match="route"):
        sw_align(*ta, band=48, route="shared")


@pytest.fixture(scope="module")
def jax_case():
    """One input, general matrices with a matrix per slot; the JAX
    traceback of it in each mode, run once for the module."""
    rng = np.random.default_rng(17)
    q, lens, r, msel = _inputs(rng, 24, 64, 48)
    mats, gaps = _mats(rng, True), (9, 11, 2)
    ja = _jax_args(q, lens, r, mats, msel, gaps)
    ref = {mode: jsw.banded_sw_align(*ja, band=48, mode=mode)
           for mode in MODES}
    return (q, lens, r, mats, msel, gaps), ref


@pytest.mark.parametrize("mode", MODES)
def test_split_forward_and_row_walk_equal_jax(jax_case, mode):
    args, ref = jax_case
    ta = _torch_args(*args)
    dirs, best, bi, bo = tsw.banded_sw_forward(*ta, band=48, mode=mode)
    assert dirs.shape == (64, 24, 48) and dirs.dtype == torch.uint8
    got = tsw._backwalk_rows(dirs, best, bi, bo, 64 + 48)
    _assert_fields_equal(ref[mode], got)
    _assert_fields_equal(ref[mode], tsw.banded_sw_align(*ta, band=48,
                                                         mode=mode))
    assert int(got.score.max()) > 0 and int(got.indels.sum()) > 0


@pytest.mark.parametrize("gaps", list(GAPS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("W", BANDS)
def test_kernel_walk_transcription_equals_row_walk(W, mode, gaps):
    """20 alignments a case, 24 cases in all: the walk over the plain
    forward's bytes at the full op buffer and at one that truncates."""
    rng = np.random.default_rng(W * 10 + MODES.index(mode) * 3
                                + list(GAPS).index(gaps))
    L = 60
    q, lens, r, msel = _inputs(rng, 20, L, W)
    mats = _mats(rng, W in (8, 184))
    ta = _torch_args(q, lens, r, mats, msel, GAPS[gaps])
    dirs, best, bi, bo = (x.numpy() for x in
                          tsw.banded_sw_forward(*ta, band=W, mode=mode))
    case = (q, r, mats, msel)
    full = _assert_walks_equal(dirs, best, bi, bo, L + W, f"W{W} {mode}",
                               *case)
    assert (full["score"] > 0).any()
    assert (lens == 0).any() and (full["n_ops"][lens == 0] == 0).all()
    short = _assert_walks_equal(dirs, best, bi, bo, 7, f"W{W} {mode} MO 7",
                                *case)
    assert short["trunc"].any()
    if gaps == "cheap" and W >= 8:
        assert full["indels"].sum() > 0


@pytest.mark.parametrize("W", BANDS + (520, 1024))
def test_walk_over_random_bytes_equals_row_walk(W):
    """Random direction bytes: every H source and gap bit anywhere, so
    walks leave the band on both sides (a D run off the left edge sets
    r_start = i) and stop anywhere.  Bit 4 follows random codes (pad codes
    up to 7 among them) and a random matrix, as the forward pass sets it;
    W 520 and 1024 take the block form's layout."""
    rng = np.random.default_rng(100 + W)
    B, L = 64, 30
    dirs = rng.integers(0, 16, (L, B, W)).astype(np.uint8)
    dirs[:, ::4] |= 3                        # long D runs (H source F)
    dirs[:, 1::4] = (dirs[:, 1::4] & 0xc) | 2    # I runs, up and right
    q = rng.integers(0, 8, (B, L)).astype(np.uint8)
    r = rng.integers(0, 8, (B, L + W)).astype(np.uint8)
    mats = rng.integers(-3, 4, (1, 8, 8)).astype(np.int32)
    qc, rc = np.minimum(q, PAD), np.minimum(r, PAD)
    sub = np.where(mats[0] > 0, 1, 0)
    sub[PAD:, :] = sub[:, PAD:] = 0
    win = rc[:, np.arange(L)[:, None] + np.arange(W)]        # [B, L, W]
    dirs |= (sub[qc[:, :, None], win] << 4).transpose(1, 0, 2).astype(
        np.uint8)
    best = rng.integers(0, 3, B).astype(np.int32)
    bi = rng.integers(0, L, B).astype(np.int32)
    bo = rng.integers(0, W, B).astype(np.int32)
    case = (q, r, mats, np.zeros(B, np.int32))
    full = _assert_walks_equal(dirs, best, bi, bo, L + W, f"W{W}", *case)
    _assert_walks_equal(dirs, best, bi, bo, 5, f"W{W} MO 5", *case)
    walked = full["score"] > 0
    assert walked.any() and (full["n_ops"][~walked] == 0).all()


@pytest.mark.parametrize("mode", MODES)
def test_packed_walk_bisulfite_with_n(mode):
    """Bisulfite matrices (a T over a C, or an A over a G, scores as a
    match on one strand only) and reads and corridors with N bases and pad
    codes: the walk's recomputed bit 4 splits matches from mismatches as
    the forward pass's byte does."""
    rng = np.random.default_rng(31 + MODES.index(mode))
    B, L, W = 40, 80, 48
    q, lens, r, msel = _inputs(rng, B, L, W)
    conv = rng.random((B, L)) < 0.5                    # C read as T
    q = np.where((q == 1) & conv & (msel[:, None] == 0), 3, q)
    q = np.where((q == 2) & conv & (msel[:, None] == 1), 0, q)
    q[rng.random((B, L)) < 0.05] = 4                   # N in the reads
    r[rng.random((B, L + W)) < 0.03] = 4               # and the corridors
    r[::9, -W // 2:] = 6                               # pad codes past 5
    cfg = NgmConfig(bs_mapping=True)
    mats = np.stack([score_matrix(cfg, 0), score_matrix(cfg, 1)])
    ta = _torch_args(q, lens, r, mats, msel, GAPS["cheap"])
    dirs, best, bi, bo = (x.numpy() for x in
                          tsw.banded_sw_forward(*ta, band=W, mode=mode))
    full = _assert_walks_equal(dirs, best, bi, bo, L + W, f"bs {mode}",
                               q, r, mats, msel)
    assert full["matches"].sum() > 0 and full["indels"].sum() > 0
    _assert_walks_equal(dirs, best, bi, bo, 9, f"bs {mode} MO 9", q, r,
                        mats, msel)


def test_pack_places_cell_o_at_its_lane_and_nibble():
    """pack: cell o of row i in word o // NPL, nibble o % NPL, for every
    layout of the table and the block form."""
    rng = np.random.default_rng(3)
    for W in (1, 16, 17, 48, 184, 264, 512, 520):
        lanes, npl = k4_layout(W)
        assert lanes * npl >= W and npl <= 16
        dirs = rng.integers(0, 32, (3, 2, W)).astype(np.uint8)
        words = pack(dirs, lanes, npl)
        assert words.shape == (2, 3, lanes)
        for i in range(3):
            for o in range(W):
                v = (int(words[1, i, o // npl]) >> (4 * (o % npl))) & 15
                assert v == dirs[i, 1, o] & 15, (W, i, o)
