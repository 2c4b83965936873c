"""graph_gap_pct: 100 x (1 - device busy / wall) between each step's start
mark and its finish mark, over every step of the second traced window
(``ngmb/program_window.py``): the device records split by the program's
mark records, so the idle share inside the step graph's nodes, apart from
the input copy, the pack, the clone and the host."""

from ngmb import program_window


def read(ctx):
    pt = program_window.of(ctx)
    return None if pt is None else program_window.graph_gap_pct(
        pt["device_ops"])
