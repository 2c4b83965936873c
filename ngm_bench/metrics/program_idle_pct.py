"""program_idle_pct: the device's idle time whose gap starts while the host
is inside one of the program's spans (``ngm.map_batch_scan``,
``ngm.graph.*``), as a share of the second traced window's wall
(``ngmb/program_window.py``); the rest of ``device_idle_pct`` falls in the
harness or between calls."""

from ngmb import program_window


def read(ctx):
    pt = program_window.of(ctx)
    return None if pt is None else program_window.program_idle_pct(pt)
