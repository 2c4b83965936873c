"""Substitution matrices — normal, bisulfite, SLAM-seq.

Copy of ``nextgenmap_tpu/ops/scoring.py``: --bs-mapping selects one of two
asymmetric matrices by strand; --slam-seq tweaks T->C tolerance.  The matrix
is a kernel *argument* (an [8, 8] int32 array), so every mode shares one
compiled kernel.

Matrix layout: S[q_code, r_code] for codes A0 C1 G2 T3 N4 (5..7 unused, kept
so the flat lookup index q*8+r is a cheap shift-or).  Any pairing involving
N/pad scores as a mismatch so alignments cannot gain through N runs or
chromosome-gap padding.
"""

from __future__ import annotations

import numpy as np

from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.io.encode import CODE_A, CODE_C, CODE_G, CODE_T


def score_matrix(cfg: NgmConfig, strand: int = 0) -> np.ndarray:
    """[8, 8] int32 substitution matrix for the configured mode.

    strand matters only for bisulfite mode: 0 = C->T-converted (top/OT)
    strand, 1 = G->A-converted (bottom/OB) strand.
    """
    m = np.full((8, 8), -cfg.mismatch_penalty, dtype=np.int32)
    for c in (CODE_A, CODE_C, CODE_G, CODE_T):
        m[c, c] = cfg.match_bonus
    if cfg.bs_mapping:
        # bisulfite: unmethylated C reads as T. On the original-top strand a
        # read T over a reference C is expected, scored as a (slightly
        # discounted) match; symmetric G->A on the bottom strand.
        tol = max(1, cfg.match_bonus - 1)
        if strand == 0:
            m[CODE_T, CODE_C] = tol
        else:
            m[CODE_A, CODE_G] = tol
    if cfg.slam_seq:
        # SLAM-seq: 4sU labeling reads T sites as C. slam_seq=1 tolerates
        # (score 0), slam_seq=2 rewards as a discounted match.
        m[CODE_C, CODE_T] = 0 if cfg.slam_seq == 1 else max(1, cfg.match_bonus - 1)
    return m
