"""Kernel timing on a CUDA card: device time and wall time per call.

``device_ms`` is what the kernel takes on the card; ``call_ms`` is what a
caller waits for one call, the wrapper's host work included;
``device_profile`` counts what one call (a step, a graph's replay) puts on
the device and how busy it keeps it.  All need a CUDA card;
``chip_smoke.py`` and the tools use them.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

WINDOWS = 6   # profiler windows tried before giving up: CUPTI now and then
              # hands back windows without their kernel records (three in a
              # row once, on an H100)


def call_ms(fn: Callable[[], object], reps: int, warmup: int = 2) -> float:
    """Median wall time per call in ms over `reps` calls: CUDA events
    recorded before and after ONE call, so host work inside the call
    (argument checks, allocation, the launch) is in it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn: Callable[[], object], calls: int = 20,
              warmup: int = 2) -> float:
    """Device time per call in ms, from torch.profiler over a window of
    `calls` calls.

    Only the rows of device type CUDA (the kernels themselves) are summed:
    the row of an aten op that launched a kernel carries that kernel's time
    as its own self device time too, and would count it twice.  The sum is
    divided by the launches recorded of the most launched kernel (a call
    launches each of its kernels once; counting recorded launches, not
    calls, keeps a dropped record from reading as a faster kernel).  A
    window that recorded no kernel at all is run again, in a new profiler
    session after a pause; after WINDOWS such windows it raises: no other
    clock stands in for the device's (CUDA events around back-to-back calls
    read the launch rate for a kernel shorter than its launch).
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total_us, launches = 0.0, 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            if us > 0:
                total_us += us
                launches = max(launches, e.count)
        if total_us > 0:
            return total_us / launches / 1e3
        time.sleep(0.5)
    raise RuntimeError(f"torch.profiler recorded no kernel in {WINDOWS} "
                       "windows")


def device_profile(fn: Callable[[], object]) -> dict:
    """One fn() under torch.profiler, synchronised at its end: the device
    records it left (kernels, memsets and copies; for a captured graph's
    bare replay, the graph's nodes that run on the device), the kernels
    among them, their device time, the window's wall time and the device's
    busy share of it.  A window without a device record is run again, as
    device_ms does."""
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if rows:
            us = sum(getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0) for e in rows)
            return {"records": sum(e.count for e in rows),
                    "kernels": sum(e.count for e in rows if not
                                   e.key.startswith(("Memset", "Memcpy"))),
                    "device_ms": us / 1e3, "wall_ms": wall_ms,
                    "busy": us / 1e3 / wall_ms}
        time.sleep(0.5)
    raise RuntimeError(f"torch.profiler recorded no device activity in "
                       f"{WINDOWS} windows")
