"""align_roofline_pct: the least time of a batch's traceback work (the
yardstick's K4: 20 int ops a real cell, query length x W of each read
with a candidate) over ``align_us``, the traceback's device time a batch
from the program's inner marks (K2, the query select and K4)."""

from ngmb import manifest, yardstick


def read(ctx):
    us = manifest.metric_reader("align_us")(ctx)
    if not us or us <= 0:
        return None
    return 100.0 * yardstick.k4_s(ctx["work"]) / (us / 1e6)
