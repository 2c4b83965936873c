"""traceback_roofline_pct: the least time of a batch's traceback work (20
int ops a real cell: query length x W of each read with a candidate) over
the traceback kernel's (K4) device time a batch in the traced window."""

from ngmb import trace, yardstick

PATTERN = r"sw_align"


def read(ctx):
    us, records = trace.kernel_us(ctx["device_ops"], PATTERN)
    if not records or us <= 0:
        return None
    return 100.0 * yardstick.k4_s(ctx["work"]) / (us / 1e6 / ctx["batches"])
