"""One captured CUDA graph per mapping step: the port's counterpart of the
reference's ``jax.jit`` on its steps (``nextgenmap_tpu/models/mapper.py``:
``map_step``, ``map_step_paired``, ``map_step_topn``, the sharded steps),
of ``map_step_scan`` (``--megabatch K``: K batches as one program, a
``lax.scan`` whose body is ``map_step``), and of the jitted ``shard_map``
steps over several devices (``nextgenmap_tpu/parallel/dp.py``'s dp step,
``nextgenmap_tpu/parallel/index_shard.py``'s ("dp", "ish") step).

Eagerly a step is a few hundred small launches, and the host's dispatch of
them, not the card, sets its pace.  On a card ``StepGraphs`` captures K
calls of a step, on the K slices of its static inputs, into one
``torch.cuda.CUDAGraph``, keyed as ``jax.jit`` keys its cache: the step's
name, K, B, L (the first input, the reads, is [K, B, L]), the shapes of
any further inputs, its statics (``topn``, ``paired``, ``compact_cap``
where they apply) and the device.  One ``StepGraphs`` serves every device
of a ``Mapper``: ``run`` takes the device (default: the first), so the dp
step is one replay per distinct device, its slices there stacked K, and
the ("dp", "ish") grid one replay on one device, or one per device and
phase across devices (``models/mapper.py``).

A new key, on its first call:

  * allocates the static inputs on the device, ``reads [K, B, L]`` uint8,
    ``lengths [K, B]`` int32 and any further [K, ...] input, and copies
    the inputs in;
  * runs the step once eagerly on a side stream (the ``torch.cuda.graphs``
    warm-up): the kernels build (``native/build.py``), K4's plan cache
    fills (its ``cudaFuncSetAttribute``), and the caching allocator sizes
    cub's sort workspaces, so that the capture records the step's work
    and nothing of its first-call set-up;
  * captures the K steps, and one copy of their outputs, stacked [K, ...]
    as ``map_step_scan``'s results are, into one packed byte buffer
    (``capture_error_mode="thread_local"``: the runner's parse, emitter and
    render threads may touch CUDA meanwhile).

A call, under ``torch.cuda.device(d)`` and on d's current stream, copies
the inputs into the static ones (non-blocking: from the host the copy is
staged, so the caller may reuse its array at once; from another card it
is ordered after that card's stream), replays the graph, and clones the
packed buffer: one copy, whose typed views are the fields it returns.
Nothing in a call waits for the card, so calls on several devices, queued
one after the other from one thread, run on their cards at once.  The
clone is what lets a result outlive the next replay.  Two consumers would
be safe without it, because they read a result on the same stream before
the next replay is queued behind it: the bench (its counters are computed
from the outputs right away) and the runtime's ``Fetch`` (its copies to
pinned memory are queued at once).  A result a caller holds across calls,
as the tests and ``Mapper.map_batch``'s users do, is not; the clone stays
everywhere, since it costs one copy of the packed buffer.

The graphs of one device share one private memory pool
(``torch.cuda.graph_pool_handle()``, one per device).  That is safe: each
graph's outputs stay alive in its entry, so no capture reuses them, and a
device's replays are serialised on its stream, so one graph's
intermediates are dead when another's overwrite them.  Each capture logs
its seconds and the pool memory it added (``captures``).

The graphs are keyed by the program's tracing state too
(``utils/trace.py``): a graph captured while tracing is on holds its phase
marks and score counters, one captured while it is off none of them.
While tracing is on, a call's host phases are profiler spans:
``ngm.graph.capture`` (a new key's warm-up and capture), or
``ngm.graph.inputs`` (the static inputs' copies), then
``ngm.graph.replay`` and ``ngm.graph.outputs`` (the clone and its typed
views).

The kernel wrappers count their launches where they launch.  Under a
graph the wrapper runs only at capture, which executes nothing, so the
counts a capture added are taken back, kept as the graph's nodes, and
added again at every replay, which launches them; the warm-up counts as
the eager step it is.

``eager=True``, and every device but a card, runs the step eagerly over
the K slices and stacks the results: on the CPU, which the caller must ask
for, that is the device's way of running a step, not a fallback.  On a
card a failed capture or replay raises; nothing runs the eager step in its
place.  Only the tools and the tests ask for ``eager`` on a card.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from nextgenmap_tpu_torch.ops.candidate_kernel import candidate_search
from nextgenmap_tpu_torch.ops.finish_kernel import finish_pass
from nextgenmap_tpu_torch.ops.gather_kernel import gather_genome_windows
from nextgenmap_tpu_torch.ops.kmer_kernel import read_kmers
from nextgenmap_tpu_torch.ops.pair_kernel import pair_select
from nextgenmap_tpu_torch.ops.score_pass_kernel import score_pass
from nextgenmap_tpu_torch.ops.sw_align_kernel import sw_align
from nextgenmap_tpu_torch.utils import trace
from nextgenmap_tpu_torch.utils.logging import get_logger

log = get_logger("ngm-torch.graph")

# the kernel wrappers a mapping step calls (the fused score pass, the
# finish pass, K2 and K4 (the top-n traceback), K5, K6, the pair select)
KERNELS = (score_pass, finish_pass, gather_genome_windows, sw_align,
           read_kmers, candidate_search, pair_select)


def leaves(tree) -> list:
    """The tensors of a result (a MapResult, or a tuple of them), in
    order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in leaves(sub)]


def rebuild(tree, it):
    """A result of `tree`'s structure with its tensors taken from `it`."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    vals = [rebuild(sub, it) for sub in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


def stack_results(results: list):
    """K results of one structure -> one, every tensor stacked [K, ...]
    (at K = 1 views of the result, no copy)."""
    if len(results) == 1:
        return rebuild(results[0], (t[None] for t in leaves(results[0])))
    it = iter(torch.stack(ts) for ts in zip(*(leaves(r) for r in results)))
    return rebuild(results[0], it)


def take(stacked, k: int):
    """Batch k of a stacked result (views)."""
    return rebuild(stacked, (t[k] for t in leaves(stacked)))


class _Layout(NamedTuple):
    """Where each stacked output lies in the packed byte buffer: leaves in
    order of falling item size, so every offset is aligned for its type."""

    tree: object          # the step's result structure, empty leaves
    order: list           # leaf indices in packing order
    slots: list           # per leaf: (byte offset, dtype, [K, ...] shape)
    nbytes: int

    @classmethod
    def of(cls, result, K: int) -> "_Layout":
        ls = leaves(result)
        order = sorted(range(len(ls)), key=lambda i: -ls[i].element_size())
        slots, off = [None] * len(ls), 0
        for i in order:
            t = ls[i]
            slots[i] = (off, t.dtype, (K, *t.shape))
            off += K * t.numel() * t.element_size()
        return cls(rebuild(result, (torch.empty(0) for _ in ls)), order,
                   slots, off)

    def pack(self, results: list, out: torch.Tensor) -> None:
        """The K results' tensors into `out`, one concatenation."""
        per = [leaves(r) for r in results]
        torch.cat([per[k][i].contiguous().view(-1).view(torch.uint8)
                   for i in self.order for k in range(len(results))],
                  out=out)

    def unpack(self, flat: torch.Tensor):
        """Typed [K, ...] views of a packed buffer, in the result's
        structure."""
        return rebuild(self.tree, (
            flat[off:off + torch.Size(shape).numel() * dt.itemsize]
            .view(dt).view(shape) for off, dt, shape in self.slots))


class _Entry(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: tuple             # static: reads [K, B, L] uint8, lengths
                              # [K, B] int32, then any further [K, ...]
    out: torch.Tensor         # the packed outputs, static
    layout: _Layout
    nodes: tuple              # (wrapper, kernel nodes in the graph)


def _counts() -> list:
    return [k.launches for k in KERNELS]


def _resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class StepGraphs:
    """The captured steps of a Mapper's devices (see the module)."""

    def __init__(self, device, *, eager: bool = False):
        self.device = _resolve(device)
        self.eager = eager or self.device.type != "cuda"
        self._pools: dict = {}      # device -> its graphs' memory pool
        self._entries: dict = {}
        self.replays = 0
        # one dict per capture: key, seconds (warm-up and capture), bytes
        # the graph pool grew by
        self.captures: list = []

    def run(self, name: str, step, *inputs_k: torch.Tensor, device=None,
            **statics):
        """step(reads [B, L], lengths [B], ...) on each of the K batches of
        its inputs: reads_k [K, B, L] (uint8), lengths_k [K, B] (int32) and
        any further [K, ...] tensors, on any device: the results stacked
        [K, ...] on `device` (default: this StepGraphs' device).
        `statics` are whatever else the step closes over that shapes its
        program (its keyword arguments)."""
        dev = self.device if device is None else _resolve(device)
        K, B, L = inputs_k[0].shape
        if self.eager or dev.type != "cuda":
            on = [x.to(dev) for x in inputs_k]
            return stack_results([step(*(x[k] for x in on))
                                  for k in range(K)])
        key = (name, K, B, L, tuple(sorted(statics.items())), dev,
               tuple(tuple(x.shape) for x in inputs_k[2:]), trace.on(dev))
        entry = self._entries.get(key)
        with torch.cuda.device(dev):
            if entry is None:
                with trace.span("ngm.graph.capture"):
                    entry = self._capture(key, dev, step, inputs_k)
            else:
                with trace.span("ngm.graph.inputs"):
                    for x, x_k in zip(entry.inputs, inputs_k):
                        x.copy_(x_k, non_blocking=True)
            with trace.span("ngm.graph.replay"):
                entry.graph.replay()
            with trace.span("ngm.graph.outputs"):
                flat = entry.out.clone()
                out = entry.layout.unpack(flat)
        for k, n in entry.nodes:
            k.launches += n
        self.replays += 1
        return out

    def _capture(self, key, dev, step, inputs_k) -> _Entry:
        K, B, L = inputs_k[0].shape
        t0 = time.perf_counter()
        inputs = tuple(torch.empty(x.shape, dtype=x.dtype, device=dev)
                       for x in inputs_k)
        for x, x_k in zip(inputs, inputs_k):
            x.copy_(x_k)
        saved = trace.save(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            probe = step(*(x[0] for x in inputs))
        torch.cuda.current_stream(dev).wait_stream(side)
        trace.restore(saved)     # the warm-up is no step of the run
        layout = _Layout.of(probe, K)
        del probe
        if dev not in self._pools:
            self._pools[dev] = torch.cuda.graph_pool_handle()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        try:
            with torch.cuda.graph(graph, pool=self._pools[dev],
                                  capture_error_mode="thread_local"):
                results = [step(*(x[k] for x in inputs)) for k in range(K)]
                out = torch.empty(layout.nbytes, dtype=torch.uint8,
                                  device=dev)
                layout.pack(results, out)
                del results
        finally:
            after = _counts()
            for k, n in zip(KERNELS, before):
                k.launches = n
        grown = torch.cuda.memory_reserved(dev) - reserved
        sec = time.perf_counter() - t0
        self.captures.append({"key": key[:4], "device": str(dev),
                              "seconds": sec, "pool_bytes": grown})
        log.info("step graph %s K=%d B=%d L=%d on %s: warm-up and capture "
                 "%.3f s, graph pool +%.1f MiB", key[0], K, B, L, dev, sec,
                 grown / 2**20)
        entry = _Entry(graph, inputs, out, layout, tuple(
            (k, a - b) for k, a, b in zip(KERNELS, after, before) if a > b))
        self._entries[key] = entry
        return entry
