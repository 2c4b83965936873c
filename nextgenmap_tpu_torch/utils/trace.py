"""The program's own tracing: phase marks inside the step graph, score-pass
and hit-cap counters and host spans.

Off by default.  ``enable(device)`` turns it on for the process, for the
steps run on `device`; ``disable()`` turns it off.  Off,
the program runs as it does without this module: no mark, no counter, no
span, and the graphs it captures hold no node of it.  On:

  * Phase marks.  ``map_step`` and ``map_step_paired``
    (``models/mapper.py``) mark five points of each step: its start and
    the ends of ``front`` (K5, K6, the candidates' sort and gathers),
    ``score`` (the fused score pass: slot compaction, K1, the scatter
    back), ``select`` (the argmax; paired: the pair select, the C x C
    grid and the pair resolution in one kernel) and ``finish`` (the
    finish pass: K4, the filters, MAPQ).
    On a card a mark is one launch of a one-thread kernel
    (``csrc/mark.cu``) that adds the ns since the previous mark, on the
    device's clock, to its phase's sum and counts it; its profiler record
    names the phase (``ngm_mark_kernel<p>``, p the index in PHASES).  On
    the CPU a mark does nothing.
  * Inner marks.  ``_finish`` opens and closes ``align`` (INNER) around
    the traceback: on a card the finish pass (the memset of its overflow
    counter and its one kernel).  Its ns and
    marks sum on a chain of their own (``ngm_inner_mark_kernel<c>``, c 0
    open, 1 close), so the five phases read as they do without it:
    ``finish`` still runs from the ``select`` mark to the ``finish`` mark.
  * Score-pass counters.  Each score pass of those steps adds the slots it
    was asked for (before the slot cap), the slots it scored and the reads
    it left wholly or partly unscored into a device buffer: one counter
    kernel on a card, torch reductions on the CPU.
  * Hit-cap counter.  Each candidate search of those steps adds K6's
    count of the reads whose hits passed the per-read cap H
    (``reads_hit_capped``; the step's ``fanout_overflow`` holds it summed
    with the k-mer rows cut by the fan-out cap): one one-thread kernel on
    a card, a torch add on the CPU.
  * Pair counters.  The pair select of ``map_step_paired`` adds the pairs
    whose C x C grid it searched (a mate with >= 2 candidates,
    ``pairs_gridded``) and those of them that no combination made proper,
    so that the mates fell back to their singletons (``pairs_broken``):
    one atomic each a block of the pair-select kernel on a card, torch
    sums on the CPU.  Off, the kernel gets no counter and runs no atomic.
  * Host spans.  ``span(name)`` is a ``torch.profiler.record_function``
    range (``ngm.map_batch_scan``, ``ngm.graph.*``), so that in a profiler
    window every idle gap of the device falls inside a span of the
    program's or outside all of them.

``StepGraphs`` (``models/step_graph.py``) keys its graphs by ``on(device)``:
a graph captured while tracing is on holds the marks and the counter
kernels, one captured while it is off holds none.  A traced graph writes
to its device's accumulators at every replay, so they are allocated once
a device and kept for the process; ``enable`` zeroes them.  The eager
warm-up before a capture counts nothing (``save`` / ``restore``), so the
accumulators hold exactly the steps that ran: a graph's replays on a
card, the eager steps on the CPU.  The host reads them with ``read()``,
which waits for the device.

The dp step, the shard loop, the grid and top-n are not marked: their
steps run other tails, or on other devices than the accumulators'.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from nextgenmap_tpu_torch.native import build

PHASES = ("start", "front", "score", "select", "finish")
INNER = ("align",)      # phases inside another, each on a chain of its own
COUNTERS = ("score_slots_demanded", "score_slots_scored", "reads_unscored",
            "reads_hit_capped", "pairs_gridded", "pairs_broken")
_MARKS = 1 + 2 * len(PHASES)    # csrc/mark.cu's layout; then 3 an inner phase
_NO_SPAN = contextlib.nullcontext()


class _State(NamedTuple):
    device: torch.device
    marks: torch.Tensor      # int64 [_MARKS + 3 len(INNER)]
    counters: torch.Tensor   # int64 [len(COUNTERS)]


_state: _State | None = None    # the traced device and its accumulators
_kept: dict = {}                # every device's accumulators, once made


def enable(device) -> None:
    """Trace the steps run on `device` from now on, its accumulators
    zeroed.  Graphs captured before hold no marks; their keys stay
    untraced."""
    global _state
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _kept:
        _kept[dev] = _State(
            dev, torch.zeros(_MARKS + 3 * len(INNER), dtype=torch.int64,
                             device=dev),
            torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev))
    _state = _kept[dev]
    reset()


def disable() -> None:
    global _state
    _state = None


def on(device) -> bool:
    """Whether the steps run on `device` (a torch.device) are traced."""
    return _state is not None and _state.device == device


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def mark(phase: str, device) -> None:
    """Mark the end of `phase` ("start": a step's start) on `device`'s
    current stream; nothing on the CPU or while `device` is not traced."""
    if not on(device) or device.type != "cuda":
        return
    code = build.load().ngm_mark(_state.marks.data_ptr(),
                                 PHASES.index(phase), _stream(device))
    build.check(code, "mark")


def mark_inner(phase: str, device, *, close: bool) -> None:
    """Open (or close) the inner `phase` on `device`'s current stream;
    nothing on the CPU or while `device` is not traced."""
    if not on(device) or device.type != "cuda":
        return
    chain = _state.marks.data_ptr() + 8 * (_MARKS + 3 * INNER.index(phase))
    code = build.load().ngm_inner_mark(chain, int(close), _stream(device))
    build.check(code, "inner mark")


def count_hits(capped: torch.Tensor) -> None:
    """Add one candidate search's count of hit-capped reads (a [] int32
    on the device) to ``reads_hit_capped``.  Nothing while its device is
    not traced."""
    if not on(capped.device):
        return
    if capped.dtype != torch.int32 or capped.numel() != 1:
        raise ValueError("capped must be one int32")
    at = COUNTERS.index("reads_hit_capped")
    out = _state.counters
    if capped.device.type == "cuda":
        code = build.load().ngm_hit_counts(
            capped.data_ptr(), out.data_ptr() + 8 * at,
            _stream(capped.device))
        build.check(code, "hit_counts")
        return
    out[at] += capped.reshape(())


def count_scores(n_sc: torch.Tensor, base: torch.Tensor,
                 slot_cap: int) -> None:
    """Add one score pass to the counters: n_sc [B] int32 the real slots
    each read asks for, base [B] int32 their exclusive prefix sum,
    `slot_cap` the slots the pass has.  Nothing while their device is not
    traced."""
    if not on(n_sc.device):
        return
    if n_sc.dtype != torch.int32 or base.dtype != torch.int32:
        raise ValueError("n_sc and base must be int32")
    out = _state.counters
    if n_sc.device.type == "cuda":
        code = build.load().ngm_score_counts(
            n_sc.contiguous().data_ptr(), base.contiguous().data_ptr(),
            n_sc.shape[0], slot_cap, out.data_ptr(), _stream(n_sc.device))
        build.check(code, "score_counts")
        return
    asked = n_sc.sum(dtype=torch.int64)
    out[:3] += torch.stack([asked, asked.clamp(max=slot_cap),
                            ((n_sc > 0) & (base + n_sc > slot_cap)).sum()])


def pair_counters(device) -> torch.Tensor | None:
    """The [2] int64 view of ``pairs_gridded`` and ``pairs_broken`` that
    a pair select on `device` adds to, or None while `device` is not
    traced."""
    if not on(device):
        return None
    at = COUNTERS.index("pairs_gridded")
    return _state.counters[at:at + 2]


def span(name: str):
    """A torch.profiler range named `name` while tracing is on; otherwise
    a context that does nothing."""
    return _NO_SPAN if _state is None else torch.profiler.record_function(name)


def reset() -> None:
    """Zero the accumulators (in the device's stream order)."""
    if _state is not None:
        _state.marks.zero_()
        _state.counters.zero_()


def save(device):
    """A copy of the accumulators while `device` is traced, else None: what
    ``restore`` puts back after a step that must not count."""
    if not on(device):
        return None
    return _state.marks.clone(), _state.counters.clone()


def restore(saved) -> None:
    if saved is not None and _state is not None:
        _state.marks.copy_(saved[0])
        _state.counters.copy_(saved[1])


def read() -> dict:
    """The accumulators on the host (waits for the device): ``phase_ns``
    and ``phase_marks`` {phase: int} of PHASES (``start`` has marks only),
    ``inner_ns`` and ``inner_marks`` {phase: int} of INNER, and the
    COUNTERS.  Empty while tracing is off."""
    if _state is None:
        return {}
    m = _state.marks.tolist()
    out = {"phase_ns": {p: m[1 + 2 * i] for i, p in enumerate(PHASES) if i},
           "phase_marks": {p: m[2 + 2 * i] for i, p in enumerate(PHASES)},
           "inner_ns": {p: m[_MARKS + 3 * i + 1]
                        for i, p in enumerate(INNER)},
           "inner_marks": {p: m[_MARKS + 3 * i + 2]
                           for i, p in enumerate(INNER)}}
    out.update(zip(COUNTERS, _state.counters.tolist()))
    return out


def phase_us(reading: dict) -> dict:
    """{phase: mean us a step} of the marked phases, and then the inner
    ones, of a ``read()``."""
    out = {}
    for kind in ("phase", "inner"):
        marks = reading.get(f"{kind}_marks", {})
        out.update((p, ns / marks[p] / 1e3)
                   for p, ns in reading.get(f"{kind}_ns", {}).items()
                   if marks[p])
    return out
