"""front_us: device us a batch from a step's start to the end of its front
(K5, K6, the candidates' sort and gathers), from the program's phase marks
(``nextgenmap_tpu_torch/utils/trace.py``) over the second traced window
(``ngmb/program_window.py``)."""

from ngmb import program_window


def read(ctx):
    pt = program_window.of(ctx)
    return None if pt is None else program_window.phase_us(pt, "front")
