"""Kernel timing on a CUDA card: device time and wall time per call.

``device_ms`` is what the kernel takes on the card; ``call_ms`` is what a
caller waits for one call, the wrapper's host work included.  Both need a
CUDA card; ``chip_smoke.py`` and ``tools/kernel_ab.py`` use them.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

WINDOWS = 3   # profiler windows tried before giving up: CUPTI now and then
              # hands back a window without its kernel records


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
    window that recorded no kernel at all is run again.
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
    raise RuntimeError(f"torch.profiler recorded no kernel in {WINDOWS} "
                       "windows")
