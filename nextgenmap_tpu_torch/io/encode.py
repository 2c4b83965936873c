"""Base encoding: ASCII nucleotides <-> small integer codes.

Copy of ``nextgenmap_tpu/io/encode.py``.  One code per byte (uint8), so
device gathers and substitution lookups stay a single cheap index.

Codes: A=0 C=1 G=2 T=3, anything else (N, IUPAC) = 4.  Code 4 doubles as the
padding sentinel: k-mers containing it are skipped, and the substitution
matrix scores it as a hard mismatch so alignments cannot productively cross
padding or N runs.
"""

from __future__ import annotations

import numpy as np

CODE_A, CODE_C, CODE_G, CODE_T, CODE_N = 0, 1, 2, 3, 4
PAD = CODE_N

_ENC_LUT = np.full(256, CODE_N, dtype=np.uint8)
for _c, _v in (("A", CODE_A), ("C", CODE_C), ("G", CODE_G), ("T", CODE_T)):
    _ENC_LUT[ord(_c)] = _v
    _ENC_LUT[ord(_c.lower())] = _v

_DEC_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode_seq(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> uint8 code array."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _ENC_LUT[raw]


def decode_seq(codes: np.ndarray) -> str:
    """uint8 code array -> ASCII string (pads/N decode to 'N')."""
    return _DEC_LUT[np.minimum(codes, CODE_N)].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space: A<->T (0<->3), C<->G (1<->2), N->N."""
    comp = np.where(codes < 4, 3 - codes.astype(np.int16), codes.astype(np.int16))
    return comp[::-1].astype(np.uint8)
