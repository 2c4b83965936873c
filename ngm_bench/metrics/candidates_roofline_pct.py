"""candidates_roofline_pct: the least time of a batch's candidate-search
bytes (read k-mers, two offsets a valid k-mer, an index entry a hit, the
candidates written) over the candidate-search kernel's (K6) device time a
batch in the traced window."""

from ngmb import trace, yardstick

PATTERN = r"cand_search"


def read(ctx):
    us, records = trace.kernel_us(ctx["device_ops"], PATTERN)
    if not records or us <= 0:
        return None
    return 100.0 * yardstick.k6_s(ctx["work"]) / (us / 1e6 / ctx["batches"])
