"""Reading a torch.profiler window: device intervals, busy time, kernel time
by name pattern, and the breakdown the result line carries."""

from __future__ import annotations

import re
from typing import NamedTuple


class DeviceOp(NamedTuple):
    name: str
    start_us: float
    end_us: float


class HostOp(NamedTuple):
    name: str
    start_us: float
    end_us: float


def split_events(events) -> tuple[list, list]:
    """(device ops, host ops) of a profiler's ``events()``: device ops are
    the records of kernels, copies and memsets on the card."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append(DeviceOp(e.name, tr.start, tr.end))
        elif e.device_type == DeviceType.CPU:
            host.append(HostOp(e.name, tr.start, tr.end))
    return dev, host


def merged(ops: list) -> list[tuple[float, float]]:
    """The union of the ops' intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted((o.start_us, o.end_us) for o in ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(ops: list) -> float:
    return sum(e - s for s, e in merged(ops))


def kernel_us(ops: list, pattern: str) -> tuple[float, int]:
    """(total device time, records) of the ops whose name matches
    `pattern` (a regular expression)."""
    rx = re.compile(pattern)
    hit = [o for o in ops if rx.search(o.name)]
    return sum(o.end_us - o.start_us for o in hit), len(hit)


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:>-]+", "_", name)[:64]


def top_ops(ops: list, n: int = 10) -> list:
    """[[name, seconds]] of the n names with the most device time."""
    tot: dict[str, float] = {}
    for o in ops:
        k = _short(o.name)
        tot[k] = tot.get(k, 0.0) + (o.end_us - o.start_us)
    return [[k, v / 1e6] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(dev_ops: list, host_ops: list, n: int = 10) -> list:
    """[[what the host was doing, seconds]] of the n longest gaps between
    device activity: the innermost host op that spans the gap's start."""
    iv = merged(dev_ops)
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(iv, iv[1:])),
                  reverse=True)[:n]
    out = []
    for length, at in gaps:
        spans = [h for h in host_ops if h.start_us <= at < h.end_us]
        what = (min(spans, key=lambda h: h.end_us - h.start_us).name
                if spans else "no profiled op")
        out.append(["host:" + _short(what), length / 1e6])
    return out
