"""The second traced window of a ``--trace 1`` run: the program's own
tracing on (``nextgenmap_tpu_torch/utils/trace.py``).

The first traced window (``harness.traced_window``) profiles the cell's
graph as the timed runs replay it, with the program's tracing off, and
everything the harness reports from it stays as it is.  The per-layer
metrics that read the program's phase marks, score counters and host spans
call ``of(ctx)``; the first of them runs this window once, after the
harness has read the peak memory and compared the sample, and keeps what
it saw in ``ctx["program_trace"]``:

  * a set-up of its own from the run's ``--seed`` (the program's first
    mapper is freed by then): the same genome and pool, a new ``Mapper``;
  * the program's tracing turned on, and one pass over the pool, which
    captures the graph with its marks and counters;
  * TRACE_PASSES passes over the pool under torch.profiler and a
    ``harness.Guard`` (no capture and no new allocator segment inside),
    CUDA events around each replay, the harness's counters beside the
    program's; tried again (TRACE_TRIES) where the profiler recorded no
    mark;
  * on stderr: the window's replay ms against the first window's (the cost
    of tracing), the phases a batch and their share of a step, the
    counters, and the 10 longest idle gaps, each labelled with the
    ``ngm.*`` spans that cover its start, the outermost first.

A program without ``utils/trace.py`` (any before it) has nothing to read:
``of`` returns None at once and sets nothing up, and its metrics are left
out of the line.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import re
import statistics
import sys
import time

import torch

from ngmb import harness, manifest, trace

SPAN = "ngm."                               # the program's host spans
MARK = re.compile(r"ngm_mark_kernel<(\d)>")  # phase p's mark, p in PHASES
PHASES = ("start", "front", "score", "select", "finish")
KEY = "program_trace"


def run_seed(argv=None) -> int:
    """The run's --seed (the harness hands the readers no seed)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:] if argv is None else argv)[0].seed


def program_tracing():
    """The program's tracing module, or None where it has none."""
    try:
        from nextgenmap_tpu_torch.utils import trace as program
    except ImportError:
        return None
    return program


def split(events) -> tuple[list, list]:
    """(device ops, host ops) of a profiler's ``events()``, leaving out the
    device-side copies of the program's spans (user annotations), which
    are no device work."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(SPAN)):
                dev.append(trace.DeviceOp(e.name, tr.start, tr.end))
        elif e.device_type == DeviceType.CPU:
            host.append(trace.HostOp(e.name, tr.start, tr.end))
    return dev, host


def window(cell: manifest.Cell, seed: int, dev) -> dict | None:
    """Run the second window on `cell` (see the module); None where the
    program has no tracing."""
    from torch.profiler import ProfilerActivity, profile

    program = program_tracing()
    if program is None:
        harness.log("program trace: the program has no utils/trace.py; "
                    "its metrics are left out")
        return None
    st = harness.set_up(cell, seed, dev, harness.import_program())
    groups = harness.groups(st)
    R = harness.TRACE_PASSES * groups
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    program.enable(dev)
    try:
        warm = harness.Counters(st)
        for g in range(groups):             # the marked graph's capture
            harness.replay(st, g, warm, None)
        with profile(activities=acts):      # CUPTI's start-up
            for g in range(2):
                harness.replay(st, g, warm, None)
            harness.sync(dev)
        for attempt in range(harness.TRACE_TRIES):
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(R)]
            counters = harness.Counters(st)
            program.reset()
            with harness.Guard(st), profile(activities=acts) as prof:
                harness.sync(dev)
                t0 = time.perf_counter()
                for i in range(R):
                    if i >= 2:
                        harness.spin(ev[i - 2][1])
                    ev[i][0].record()
                    harness.replay(st, i % groups, counters, None,
                                   end=ev[i][1])
                harness.sync(dev)
                window_s = time.perf_counter() - t0
            dev_ops, host_ops = split(prof.events())
            if any(MARK.search(o.name) for o in dev_ops):
                break
            harness.log(f"program trace: window {attempt + 1} recorded no "
                        "mark; tried again")
        reading = program.read()
    finally:
        program.disable()
    out = {"K": st.K, "replays": R, "batches": R * st.K,
           "reads": R * st.K * st.B, "window_s": window_s,
           "replay_ms": [a.elapsed_time(b) for a, b in ev],
           "device_ops": dev_ops, "host_ops": host_ops, "marks": reading,
           "score_slots": counters.fetch()["score_slots"]}
    del st
    gc.collect()
    torch.cuda.empty_cache()
    return out


def of(ctx: dict) -> dict | None:
    """The second window's readings, run at the first call for `ctx`."""
    if KEY not in ctx:
        pt = None
        if program_tracing() is not None and torch.cuda.is_available():
            cell = manifest.find_cell(manifest.load_manifest(), ctx["cell"])
            pt = window(cell, run_seed(), torch.device("cuda", 0))
        ctx[KEY] = pt
        report(pt, ctx.get("replay_ms") or [])
    return ctx[KEY]


def phase_us(pt: dict, phase: str) -> float | None:
    """Mean device us a batch of `phase`, from the program's marks."""
    marks = pt["marks"]["phase_marks"].get(phase, 0)
    return pt["marks"]["phase_ns"][phase] / marks / 1e3 if marks else None


def steps(ops: list) -> list[tuple[float, float]]:
    """(start, end) us of each step: its start mark's start to its finish
    mark's end, from the device records."""
    out, start = [], None
    for o in sorted((o for o in ops if MARK.search(o.name)),
                    key=lambda o: o.start_us):
        p = int(MARK.search(o.name).group(1))
        if p == 0:
            start = o.start_us
        elif p == len(PHASES) - 1 and start is not None:
            out.append((start, o.end_us))
            start = None
    return out


def _covered(iv: list, starts: list, a: float, b: float) -> float:
    """us of [a, b) covered by the sorted disjoint intervals `iv` (their
    `starts`)."""
    i = max(0, bisect.bisect_right(starts, a) - 1)
    got = 0.0
    while i < len(iv) and iv[i][0] < b:
        got += max(0.0, min(iv[i][1], b) - max(iv[i][0], a))
        i += 1
    return got


def graph_gap_pct(ops: list) -> float | None:
    """100 x (1 - device busy / wall) between each step's first and last
    mark, over every step."""
    st = steps(ops)
    if not st:
        return None
    iv = trace.merged(ops)
    starts = [s for s, _ in iv]
    wall = sum(b - a for a, b in st)
    busy = sum(_covered(iv, starts, a, b) for a, b in st)
    return 100.0 * (1.0 - busy / wall)


def gaps(dev_ops: list) -> list[tuple[float, float]]:
    """(start, length) us of each gap between device activity."""
    iv = trace.merged(dev_ops)
    return [(a[1], b[0] - a[1]) for a, b in zip(iv, iv[1:])]


def covering(host_ops: list, at: float) -> list:
    """The program's spans that cover time `at`, outermost first."""
    return sorted((h for h in host_ops if h.name.startswith(SPAN)
                   and h.start_us <= at < h.end_us),
                  key=lambda h: h.start_us - h.end_us)


def program_idle_pct(pt: dict) -> float | None:
    """Device idle us whose gap starts inside a span of the program's, as a
    share of the window's wall."""
    if not pt["device_ops"] or pt["window_s"] <= 0:
        return None
    spans = trace.merged([h for h in pt["host_ops"]
                          if h.name.startswith(SPAN)])
    starts = [s for s, _ in spans]
    idle = 0.0
    for at, length in gaps(pt["device_ops"]):
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at < spans[i][1]:
            idle += length
    return 100.0 * idle / (pt["window_s"] * 1e6)


def report(pt: dict | None, first: list) -> None:
    """What the window saw, on stderr; `first` the first window's replay
    ms."""
    if pt is None:
        return
    log = harness.log
    ms = statistics.mean(pt["replay_ms"])
    if first:
        f = statistics.mean(first)
        log(f"program trace: replay {ms:.4f} ms traced against {f:.4f} ms "
            f"in the first window ({100 * (ms / f - 1):+.2f}%)")
    us = {p: phase_us(pt, p) for p in PHASES[1:]}
    if all(v is not None for v in us.values()):
        share = 100 * sum(us.values()) / (ms * 1e3 / pt["K"])
        log(f"program trace: phases us a batch {us}, together {share:.1f}% "
            "of replay_ms / K")
    m = pt["marks"]
    log("program trace: counters " + ", ".join(
        f"{c} {m[c]}" for c in ("score_slots_demanded", "score_slots_scored",
                                "reads_unscored"))
        + f"; the harness's score_slots {pt['score_slots']} ("
        + ("equal" if m["score_slots_scored"] == pt["score_slots"]
           else "NOT equal") + ")")
    busy = trace.busy_us(pt["device_ops"])
    log(f"program trace: device idle "
        f"{100 * (1 - busy / (pt['window_s'] * 1e6)):.2f}% of the wall, "
        f"{program_idle_pct(pt)}% in the program's spans; graph gaps "
        f"{graph_gap_pct(pt['device_ops'])}%")
    for at, length in sorted(gaps(pt["device_ops"]),
                             key=lambda g: -g[1])[:10]:
        spans = covering(pt["host_ops"], at)
        inner = [h for h in pt["host_ops"] if h.start_us <= at < h.end_us]
        what = (min(inner, key=lambda h: h.end_us - h.start_us).name
                if inner else "no profiled op")
        where = (" > ".join(h.name for h in spans) if spans
                 else "no span of the program")
        log(f"program trace: gap {length:.1f} us in {where} (innermost "
            f"host op {what})")
