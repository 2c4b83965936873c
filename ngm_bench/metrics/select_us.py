"""select_us: device us a batch of selection (single-end: the argmax;
paired: the C x C grid and the pair resolution), from the program's phase
marks over the second traced window (``ngmb/program_window.py``)."""

from ngmb import program_window


def read(ctx):
    pt = program_window.of(ctx)
    return None if pt is None else program_window.phase_us(pt, "select")
