"""replay_ms: device ms of one ``Mapper.map_batch_scan`` call (one replay
of the cell's graph of K steps, its input copy and output clone), from
CUDA events on the stream before each call and as soon as it returns,
before the harness reduces its outputs, over the traced window: all event
time over all replays."""


def read(ctx):
    ms = ctx["replay_ms"]
    return sum(ms) / len(ms) if ms else None
