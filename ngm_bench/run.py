#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port, one run of one cell.

    python3 ngm_bench/run.py --workload <config>.<traffic> --seed <n>
                             --seconds <s> --trace <0|1>

Run from the root of a checkout; ``ngmb/harness.py`` says what a run does.
The last line of standard output is the result, one JSON object.
"""

import os
import sys
import time


def process_start() -> float:
    """The process's start on the time.time() clock (to a clock tick),
    from /proc; where that is unreadable, now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ngmb import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
