"""Mapping statistics and progress counters.

Copy of ``nextgenmap_tpu/utils/stats.py`` (``MappingStats``): counters for
reads processed, cap overflows and reads/s, updated per batch on the host.
Every static cap of the device step returns its overflow count, so no cap
can silently lose candidates without being counted.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class MappingStats:
    reads_in: int = 0
    reads_mapped: int = 0
    reads_unmapped: int = 0
    reads_multimapped: int = 0
    pairs_proper: int = 0
    pairs_broken: int = 0
    # overflow audits: every static cap gets a counter
    kmer_fanout_overflow: int = 0   # k-mer hits truncated by max_kmer_fanout
    cmr_overflow: int = 0           # candidate regions truncated by max_cmrs
    alignments_computed: int = 0
    cells_computed: int = 0         # SW DP cells (for GCUPS)
    start_time: float = field(default_factory=time.time)
    # steady-state window: set when the FIRST batch lands (index build
    # behind it), so streaming_reads_per_sec excludes one-time costs
    first_batch_time: float = 0.0
    first_batch_reads: int = 0
    # host phase timers (seconds, cumulative), by phase name
    timing: dict = field(default_factory=dict)

    def add_time(self, phase: str, dt: float) -> None:
        self.timing[phase] = self.timing.get(phase, 0.0) + dt

    # counter fields a parallel render worker accumulates locally and the
    # ordered committer folds back (pipeline/runner.py::_PoolEmitter)
    _COUNTERS = (
        "reads_in", "reads_mapped", "reads_unmapped", "reads_multimapped",
        "pairs_proper", "pairs_broken", "kmer_fanout_overflow",
        "cmr_overflow", "alignments_computed", "cells_computed",
    )

    def merge_counters(self, other: "MappingStats") -> None:
        for f in self._COUNTERS:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for k, v in other.timing.items():
            self.add_time(k, v)

    def mark_batch(self) -> None:
        if self.first_batch_time == 0.0:
            self.first_batch_time = time.time()
            self.first_batch_reads = self.reads_in

    def reads_per_sec(self) -> float:
        dt = time.time() - self.start_time
        return self.reads_in / dt if dt > 0 else 0.0

    def streaming_reads_per_sec(self) -> float:
        if self.first_batch_time == 0.0:
            return 0.0
        dt = time.time() - self.first_batch_time
        n = self.reads_in - self.first_batch_reads
        return n / dt if dt > 0 else 0.0

    def gcups(self) -> float:
        dt = time.time() - self.start_time
        return self.cells_computed / dt / 1e9 if dt > 0 else 0.0

    def summary(self) -> str:
        total = max(1, self.reads_in)
        return (
            f"reads: {self.reads_in}  mapped: {self.reads_mapped} "
            f"({100.0 * self.reads_mapped / total:.2f}%)  "
            f"unmapped: {self.reads_unmapped}  "
            f"R/S: {self.reads_per_sec():.0f} "
            f"(streaming: {self.streaming_reads_per_sec():.0f})  "
            f"GCUPS: {self.gcups():.2f}  "
            f"overflows(kmer/cmr): {self.kmer_fanout_overflow}/{self.cmr_overflow}"
        )
