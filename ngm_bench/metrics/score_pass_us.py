"""score_pass_us: device us a batch of the score pass (slot compaction,
K2, K1, the scatter back), from the program's phase marks over the second
traced window (``ngmb/program_window.py``)."""

from ngmb import program_window


def read(ctx):
    pt = program_window.of(ctx)
    return None if pt is None else program_window.phase_us(pt, "score")
