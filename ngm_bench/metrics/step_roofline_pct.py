"""step_roofline_pct: the least time of a batch's work (the sum of the
yardstick's least times of K1, K2, K4, K5 and K6 for the cell's reads and
candidates) over the device time a batch, replay_ms / K."""

from ngmb import yardstick


def read(ctx):
    ms = ctx["replay_ms"]
    if not ms:
        return None
    per_batch_s = sum(ms) / len(ms) / 1e3 / ctx["K"]
    return 100.0 * yardstick.step_s(ctx["work"]) / per_batch_s
