"""Native host IO of the port: FASTQ/FASTA chunk parsing, SAM formatting,
the k-mer index build passes and the CSR shard passes (``ngmio.cpp``).

Copy of ``nextgenmap_tpu/native/__init__.py``.  ``lib()`` compiles
``ngmio.cpp`` with g++ at first use into ``nextgenmap_tpu_torch/_build/``
(listed in .gitignore), keyed by a hash of the source, and returns a ctypes
handle, or None when no g++ is available: callers then take the pure-Python
paths, which produce byte-identical output (tests/test_torch_host_copies.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from nextgenmap_tpu_torch.utils.logging import get_logger

log = get_logger("ngm-torch.native")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ngmio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_SRC)), "_build")
# no -march=native: the library lives in the checkout, which other machines
# may share
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
_LIB = None
_TRIED = False


def library_path() -> str:
    """The keyed path of the built library (source and flags hashed)."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"ngmio-{h.hexdigest()[:16]}.so")


def lib():
    """ctypes CDLL of the native helpers, or None if g++ is unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        so_path = library_path()
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            # build in a private directory, then rename: concurrent first
            # uses (test workers) never load a half-written library
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
                tmp_so = os.path.join(td, "ngmio.so")
                subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", tmp_so],
                               check=True, capture_output=True)
                os.replace(tmp_so, so_path)
            log.info("built native IO helpers: %s", so_path)
        L = ctypes.CDLL(so_path)
        L.ngm_parse_reads.restype = ctypes.c_int
        L.ngm_format_sam.restype = ctypes.c_int64
        L.ngm_index_count.restype = None
        L.ngm_index_fill.restype = None
        L.ngm_shard_count.restype = None
        L.ngm_shard_fill.restype = None
        _LIB = L
    except (OSError, subprocess.CalledProcessError) as e:
        log.warning("native IO unavailable (%s); using Python paths", e)
        _LIB = None
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def parse_reads(buf: bytes, final: bool, max_reads: int, lmax: int):
    """Parse up to max_reads records from a text chunk via the native parser.

    Returns (n, codes [max,Lmax] u8, lengths i32, names list[str],
    quals list[bytes|None], consumed_bytes).
    """
    L = lib()
    assert L is not None
    codes = np.empty((max_reads, lmax), np.uint8)
    lengths = np.empty(max_reads, np.int32)
    name_cap = max_reads * 256 + 16
    qual_cap = max_reads * (lmax + 1) + 16
    name_arena = np.empty(name_cap, np.uint8)
    qual_arena = np.empty(qual_cap, np.uint8)
    name_off = np.empty(max_reads, np.int64)
    qual_off = np.empty(max_reads, np.int64)
    consumed = ctypes.c_int64(0)
    n = L.ngm_parse_reads(
        buf, ctypes.c_int64(len(buf)), ctypes.c_int(1 if final else 0),
        ctypes.c_int(max_reads), ctypes.c_int(lmax),
        _ptr(codes), _ptr(lengths),
        _ptr(name_arena), ctypes.c_int64(name_cap), _ptr(name_off),
        _ptr(qual_arena), ctypes.c_int64(qual_cap), _ptr(qual_off),
        ctypes.byref(consumed),
    )
    names, quals = [], []
    nb = name_arena.tobytes()
    qb = qual_arena.tobytes()
    for i in range(n):
        o = int(name_off[i])
        names.append(nb[o : nb.index(b"\x00", o)].decode("ascii"))
        o = int(qual_off[i])
        q = qb[o : qb.index(b"\x00", o)]
        quals.append(q if q else None)
    return n, codes, lengths, names, quals, int(consumed.value)


_COLLAPSE = {"none": 0, "ct": 1, "ga": 2}


def index_count(codes: np.ndarray, k: int, skip: int, collapse: str,
                canonical: bool) -> np.ndarray:
    """Pass 1 of the CSR build: per-k-mer occurrence counts (int64 [4^k])."""
    L = lib()
    assert L is not None
    counts = np.zeros(4 ** k, np.int64)
    codes = np.ascontiguousarray(codes, np.uint8)
    L.ngm_index_count(
        _ptr(codes), ctypes.c_int64(codes.shape[0]), ctypes.c_int(k),
        ctypes.c_int(skip), ctypes.c_int(_COLLAPSE[collapse]),
        ctypes.c_int(1 if canonical else 0), _ptr(counts),
    )
    return counts


def index_fill(codes: np.ndarray, k: int, skip: int, collapse: str,
               canonical: bool, dropped: np.ndarray,
               offsets: np.ndarray, total: int) -> np.ndarray:
    """Pass 2: fill the CSR positions array (genome-ascending per row)."""
    L = lib()
    assert L is not None
    positions = np.empty(total, np.uint32)
    cursor = offsets[:-1].copy()
    codes = np.ascontiguousarray(codes, np.uint8)
    L.ngm_index_fill(
        _ptr(codes), ctypes.c_int64(codes.shape[0]), ctypes.c_int(k),
        ctypes.c_int(skip), ctypes.c_int(_COLLAPSE[collapse]),
        ctypes.c_int(1 if canonical else 0),
        _ptr(np.ascontiguousarray(dropped, np.uint8)),
        _ptr(cursor), _ptr(positions),
    )
    assert np.array_equal(cursor, offsets[1:]), "native CSR fill mismatch"
    return positions


def shard_csr(offsets: np.ndarray, positions: np.ndarray,
              lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
    """Slice one position-range shard out of a global CSR: returns
    (offsets int64 [nb+1], local positions int32 rebased to lo)."""
    L = lib()
    assert L is not None
    nb = offsets.shape[0] - 1
    offsets = np.ascontiguousarray(offsets, np.int64)
    positions = np.ascontiguousarray(positions, np.uint32)
    counts = np.empty(nb, np.int64)
    L.ngm_shard_count(
        _ptr(offsets), ctypes.c_int64(nb), _ptr(positions),
        ctypes.c_int64(lo), ctypes.c_int64(hi), _ptr(counts),
    )
    out_off = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=out_off[1:])
    out_pos = np.empty(int(out_off[-1]), np.int32)
    L.ngm_shard_fill(
        _ptr(offsets), ctypes.c_int64(nb), _ptr(positions),
        ctypes.c_int64(lo), ctypes.c_int64(hi), _ptr(out_off), _ptr(out_pos),
    )
    return out_off, out_pos


def format_sam(
    names: list[str], aligned_codes: np.ndarray, read_len: np.ndarray,
    quals: list[bytes | None], qual_rev: np.ndarray,
    flag: np.ndarray, chrom_pos: np.ndarray, rnames: list[str],
    mapq: np.ndarray, score: np.ndarray,
    ops: np.ndarray, n_ops: np.ndarray,
    q_start: np.ndarray, q_end: np.ndarray,
    genome_codes: np.ndarray, gpos_abs: np.ndarray,
    rnexts: list[str], pnext: np.ndarray, tlen: np.ndarray,
    identity: np.ndarray, rg_suffix: str, clip_mode: int,
    is_mapped: np.ndarray | None = None,
) -> bytes:
    """Format a whole batch (mapped AND unmapped rows, in row order) into one
    SAM text blob via the native writer.  clip_mode 0 soft / 1 hard / 2
    silent; is_mapped=None means all rows mapped."""
    L = lib()
    assert L is not None
    n = len(names)
    if is_mapped is None:
        is_mapped = np.ones(n, np.uint8)

    def arena(strings):
        # one join + a cumsum instead of a per-record Python loop (the
        # emitter thread's hot spot at 4096 records x 4 arenas per batch)
        if strings and isinstance(strings[0], str):
            blob = ("\x00".join(strings) + "\x00").encode("ascii")
            lens = np.fromiter((len(s) + 1 for s in strings), np.int64, n)
        else:
            bs = [(s if isinstance(s, (bytes, bytearray)) else
                   (s.encode("ascii") if s else b"")) for s in strings]
            blob = b"\x00".join(bs) + b"\x00"
            lens = np.fromiter((len(b) + 1 for b in bs), np.int64, n)
        offs = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        return blob, offs

    name_a, name_o = arena(names)
    qual_a, qual_o = arena(quals)
    rname_a, rname_o = arena(rnames)
    rnext_a, rnext_o = arena(rnexts)

    lmax = aligned_codes.shape[1]
    cap = max(1 << 16, n * (2 * lmax + ops.shape[1] * 4 + 320))
    for _ in range(4):
        out = ctypes.create_string_buffer(cap)
        wrote = L.ngm_format_sam(
            ctypes.c_int(n),
            name_a, _ptr(name_o),
            _ptr(np.ascontiguousarray(aligned_codes, np.uint8)),
            _ptr(np.ascontiguousarray(read_len, np.int32)),
            ctypes.c_int(lmax),
            qual_a, _ptr(qual_o),
            _ptr(np.ascontiguousarray(qual_rev, np.uint8)),
            _ptr(np.ascontiguousarray(flag, np.int32)),
            _ptr(np.ascontiguousarray(is_mapped, np.uint8)),
            _ptr(np.ascontiguousarray(chrom_pos, np.int64)),
            rname_a, _ptr(rname_o),
            _ptr(np.ascontiguousarray(mapq, np.int32)),
            _ptr(np.ascontiguousarray(score, np.int32)),
            _ptr(np.ascontiguousarray(ops, np.uint8)),
            _ptr(np.ascontiguousarray(n_ops, np.int32)),
            ctypes.c_int(ops.shape[1]),
            _ptr(np.ascontiguousarray(q_start, np.int32)),
            _ptr(np.ascontiguousarray(q_end, np.int32)),
            _ptr(np.ascontiguousarray(genome_codes, np.uint8)),
            _ptr(np.ascontiguousarray(gpos_abs, np.int64)),
            rnext_a, _ptr(rnext_o),
            _ptr(np.ascontiguousarray(pnext, np.int64)),
            _ptr(np.ascontiguousarray(tlen, np.int64)),
            _ptr(np.ascontiguousarray(identity, np.float32)),
            rg_suffix.encode("ascii"), ctypes.c_int(clip_mode),
            out, ctypes.c_int64(cap),
        )
        if wrote >= 0:
            return out.raw[:wrote]
        cap *= 4
    raise RuntimeError("native SAM formatting buffer overflow")
