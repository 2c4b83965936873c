"""Kernel timing on a CUDA card: ``device_ms``, what a kernel takes on the
card per launch (``tools/kernel_ab.py`` times the kernels with it).  Needs
a CUDA card.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

WINDOWS = 6   # profiler windows tried before giving up: CUPTI now and then
              # hands back windows without their kernel records (three in a
              # row once, on an H100)


def device_ms(fn: Callable[[], object], calls: int = 20,
              warmup: int = 2, per_call: int = 1) -> float:
    """Device time per call in ms, from torch.profiler over a window of
    `calls` calls.

    Only the rows of device type CUDA (the kernels themselves) are summed:
    the row of an aten op that launched a kernel carries that kernel's time
    as its own self device time too, and would count it twice.  The sum is
    divided by the launches recorded of the most launched kernel over
    `per_call`, its launches in one call (1 for a kernel; a call of torch
    ops may launch one kernel more than once: ``launches_per_call``);
    counting recorded launches, not calls, keeps a dropped record from
    reading as a faster kernel.  A window that recorded no kernel at all
    is run again, in a new profiler session after a pause; after WINDOWS
    such windows it raises: no other clock stands in for the device's
    (CUDA events around back-to-back calls read the launch rate for a
    kernel shorter than its launch).
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(WINDOWS):
        total_us, launches = _window(fn, calls)
        if total_us > 0:
            return total_us / (launches / per_call) / 1e3
        time.sleep(0.5)
    raise RuntimeError(f"torch.profiler recorded no kernel in {WINDOWS} "
                       "windows")


def launches_per_call(fn: Callable[[], object]) -> int:
    """The launches of fn's most launched kernel in one call, from
    torch.profiler windows of one call each (after a warm-up call): the
    most any of WINDOWS windows recorded."""
    fn()
    torch.cuda.synchronize()
    return max(_window(fn, 1)[1] for _ in range(WINDOWS))


def _window(fn: Callable[[], object], calls: int) -> tuple[float, int]:
    """(device us, launches of the most launched kernel) of `calls` calls
    under torch.profiler, only the rows of device type CUDA."""
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
    return total_us, launches
