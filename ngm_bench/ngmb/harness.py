"""One run of one cell: set-up, the timed (or traced) window, the check.

    python3 ngm_bench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Set-up (``setup_s``: from the process's start to the first timed
dispatch): the genome and a pool of ``pool_batches`` batches of reads with
their truth are drawn on the card from ``--seed``; the ``Mapper`` is built
as the CLI builds it (``NgmConfig`` of the configuration's settings, the
index built on the card: ``index_build_s``); one pass over the pool warms
the cell's one graph of K steps (its capture: ``capture_s``), the
allocator and the counters.

The window drives ``Mapper.map_batch_scan`` on groups of K staged batches,
cycling the pool: no host-to-device copy, no host read a replay.  Each
replay's outputs are reduced on the card at once into running counters
(mapped, truth-correct, proper pairs, aligned reads, score slots); the
host waits, polling, before dispatching replay i + 2, on an event recorded
after replay i, so it runs at most two replays ahead; the counters are fetched
once after the window.  The window runs from the first dispatch to the
synchronise after the last replay dispatched within ``--seconds``.  A
capture or a new allocator segment inside the window fails the run.

``--trace 1`` profiles TRACE_PASSES passes over the pool instead (CUDA
events around each replay, ``torch.profiler`` over the whole), and
reports the per-layer metrics that ``metrics/<name>.py`` read from it.

Either way, once the window has closed and the peak memory is read, the
program is freed and the plain reference (``reference.py``) maps a sample
of the window's batches drawn from the seed; ``correct`` holds when every
field of every sampled read equals the reference's.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import random
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ngmb import gen, manifest, trace
from ngmb.reference import (
    FIELDS, Reference, Settings, canonical_kmers, slot_cap_for,
)
from ngmb.yardstick import Work

FORBIDDEN = ("jax", "jaxlib", "flax", "nextgenmap_tpu")
PROGRAM = "nextgenmap_tpu_torch"
TRUTH_TOL = 5          # bp between the mapped and the simulated position
SAMPLE_BATCHES = 4     # batches of the window the reference maps
TRACE_PASSES = 4       # passes over the pool in the traced window
TRACE_TRIES = 3        # traced windows tried before the run fails
K4_PATTERN = "sw_align"
K6_PATTERN = "cand_search"
# the running counters' columns
COUNTERS = ("mapped", "truth_correct", "proper_pairs", "aligned",
            "score_slots")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names of the loaded modules that the benchmark's process
    may not hold, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def import_program(root: str = manifest.ROOT):
    """The program's package, from the checkout at `root` and nowhere
    else."""
    if root not in sys.path:
        sys.path.insert(0, root)
    import nextgenmap_tpu_torch as pkg
    where = os.path.dirname(os.path.abspath(pkg.__file__))
    if where != os.path.join(root, PROGRAM):
        raise ImportError(f"{PROGRAM} imported from {where}, not from the "
                          f"checkout at {root}")
    from nextgenmap_tpu_torch.config import NgmConfig
    from nextgenmap_tpu_torch.index.genome import Genome
    from nextgenmap_tpu_torch.models.mapper import Mapper
    from nextgenmap_tpu_torch.native import build
    return NgmConfig, Genome, Mapper, build


def card_facts() -> str:
    q = "name,power.limit,clocks.sm,clocks.max.sm"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return f"card ({q}): " + out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"card ({q}): nvidia-smi unavailable ({e})"


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def spin(event) -> None:
    """Wait for a CUDA event by polling it: the host thread stays awake, as
    CUDA's default wait keeps it on a host with cores to spare."""
    while not event.query():
        pass


class State(NamedTuple):
    """What set-up hands to the window."""

    mapper: object
    genome: torch.Tensor
    pool: gen.Pool
    settings: Settings
    K: int
    B: int
    L: int
    paired: bool
    slot_cap: int
    index_build_s: float


def set_up(cell: manifest.Cell, seed: int, dev, program) -> State:
    NgmConfig, Genome, Mapper, _ = program
    c = cell.config
    K, B = int(c["megabatch"]), int(c["batch"])
    L = int(c["reads"]["length"])
    t0 = time.perf_counter()
    g = gen.generator(seed, dev)
    genome, cover = gen.make_genome(c["genome"], g, dev)
    pool = gen.make_pool(genome, cover, c["reads"], cell.traffic,
                         int(c["pool_batches"]), B, g)
    del cover
    if pool.reads.shape[0] % K:
        raise ValueError("pool_batches must be a multiple of megabatch")
    codes = genome.cpu().numpy()
    G = codes.shape[0]
    log(f"set-up: genome and {pool.reads.shape[0]} batches of reads drawn "
        f"in {time.perf_counter() - t0:.2f} s")
    unmodelled = sorted(set(c["ngm"]) - set(Settings._fields))
    if unmodelled:
        raise ValueError(f"the reference models no {unmodelled}: a "
                         "configuration with them needs a reference of its "
                         "own")
    cfg = NgmConfig(**c["ngm"], batch_size=B, megabatch=K)
    cfg.validate()
    sync(dev)
    t0 = time.perf_counter()
    mapper = Mapper(cfg, Genome(codes, ["chr"], np.array([0]), np.array([G])),
                    L, device=dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    return State(mapper, genome, pool, Settings.of(c["ngm"]), K, B, L,
                 bool(c["reads"].get("paired")), slot_cap_for(B), build_s)


def groups(st: State) -> int:
    return st.pool.reads.shape[0] // st.K


def group(st: State, g: int):
    s = slice(g * st.K, (g + 1) * st.K)
    return (st.pool.reads[s], st.pool.lengths[s], st.pool.truth_pos[s],
            st.pool.truth_strand[s])


class Counters:
    """Running counters on the device (COUNTERS), added to a replay at a
    time; nothing of a replay's outputs outlives the next one."""

    def __init__(self, st: State):
        self.st = st
        self.c = torch.zeros(len(COUNTERS), dtype=torch.int64,
                             device=st.pool.reads.device)

    def add(self, res, tpos, tstrand) -> None:
        st = self.st
        ok = (res.mapped & ((res.pos.long() - tpos).abs() <= TRUTH_TOL)
              & (res.strand == tstrand))
        n = res.n_candidates
        if st.paired:
            multi = (n.reshape(st.K, -1, 2) >= 2).any(-1)
            mask = multi.repeat_interleave(2, dim=1)
        else:
            mask = n >= 2
        slots = torch.where(mask, n, 0).sum(1).clamp(max=st.slot_cap)
        self.c += torch.stack([
            res.mapped.sum(), ok.sum(),
            res.proper.reshape(st.K, -1, 2).all(-1).sum(),
            (n >= 1).sum(), slots.sum()])

    def fetch(self) -> dict:
        return dict(zip(COUNTERS, self.c.tolist()))


class Sample:
    """The outputs of the sampled batches, copied on the first replay of
    their group into buffers made in set-up."""

    def __init__(self, st: State, seed: int, template):
        rng = random.Random(int(seed) ^ 0x5A3D)
        n = min(SAMPLE_BATCHES, groups(st))
        self.picks = sorted((g, rng.randrange(st.K))
                            for g in rng.sample(range(groups(st)), n))
        self.bufs = {p: {f: torch.empty_like(getattr(template, f)[0])
                         for f in FIELDS} for p in self.picks}
        self.done: set = set()

    def keep(self, g: int, res) -> None:
        for (pg, k), buf in self.bufs.items():
            if pg == g and (pg, k) not in self.done:
                for f, t in buf.items():
                    t.copy_(getattr(res, f)[k])
                self.done.add((pg, k))

    def reset(self) -> None:
        self.done = set()

    def outputs(self) -> dict:
        """{(group, k): {field: tensor}} of the sampled batches, each of
        which has to have run."""
        for g, k in self.bufs:
            if (g, k) not in self.done:
                raise RuntimeError(f"batch {g} x {k} of the sample never ran "
                                   "in the window")
        return self.bufs


def replay(st: State, g: int, counters: Counters, sample: Sample | None,
           end=None):
    """One call of the timed entry on group g; `end`, a CUDA event, is
    recorded as soon as the call returns, before the harness's own work on
    its outputs."""
    reads, lens, tpos, tstrand = group(st, g)
    res = st.mapper.map_batch_scan(reads, lens, paired=st.paired)
    if end is not None:
        end.record()
    counters.add(res, tpos, tstrand)
    if sample is not None:
        sample.keep(g, res)
    return res


def warm_up(st: State, seed: int) -> Sample:
    """One pass over the pool (the graph's capture at its first replay) and
    two replays more; the sample's buffers are made here."""
    counters = Counters(st)
    res = replay(st, 0, counters, None)
    sample = Sample(st, seed, res)
    sample.keep(0, res)
    for i in range(1, groups(st) + 2):
        replay(st, i % groups(st), counters, sample)
    counters.fetch()
    sync(st.pool.reads.device)
    sample.reset()
    return sample


def _alloc_state(dev) -> tuple:
    if dev.type != "cuda":
        return (0, 0)
    s = torch.cuda.memory_stats(dev)
    return (s.get("segment.all.allocated", 0), s.get("num_alloc_retries", 0))


class Guard:
    """Fails the run on a capture or a new allocator segment (or an
    allocation retry) between enter and leave."""

    def __init__(self, st: State):
        self.st = st
        self.dev = st.pool.reads.device

    def __enter__(self):
        self.caps = len(self.st.mapper.graphs.captures)
        self.alloc = _alloc_state(self.dev)
        return self

    def __exit__(self, *exc):
        if exc[0] is not None:
            return False
        caps = len(self.st.mapper.graphs.captures) - self.caps
        seg, retry = (a - b for a, b in zip(_alloc_state(self.dev),
                                             self.alloc))
        if caps or seg or retry:
            raise RuntimeError(
                f"set-up inside the window: {caps} graph captures, {seg} new "
                f"allocator segments, {retry} allocation retries")
        return False


def timed_window(st: State, seconds: float, sample: Sample):
    """(counters, replays, window s, first dispatch's time.time())."""
    dev = st.pool.reads.device
    cuda = dev.type == "cuda"
    ring = [torch.cuda.Event() for _ in range(3)] if cuda else None
    counters = Counters(st)
    sync(dev)
    with Guard(st):
        t_wall = time.time()
        t0 = time.perf_counter()
        i = 0
        while True:
            if cuda and i >= 2:
                spin(ring[(i - 2) % 3])
            if i >= groups(st) and time.perf_counter() - t0 >= seconds:
                break
            replay(st, i % groups(st), counters, sample)
            if cuda:
                ring[i % 3].record()
            i += 1
        sync(dev)
        window = time.perf_counter() - t0
    return counters.fetch(), i, window, t_wall


class Traced(NamedTuple):
    counters: dict
    replays: int
    window_s: float
    replay_ms: list
    device_ops: list
    host_ops: list


def traced_window(st: State, sample: Sample) -> Traced:
    """TRACE_PASSES passes over the pool under torch.profiler, CUDA events
    around each replay; tried again (TRACE_TRIES) where the profiler
    recorded no traceback (K4) or candidate-search (K6) kernel."""
    from torch.profiler import ProfilerActivity, profile

    dev = st.pool.reads.device
    R = TRACE_PASSES * groups(st)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(R)]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):      # CUPTI's start-up, not measured
        for i in range(2):
            replay(st, i, Counters(st), sample)
        sync(dev)
    for attempt in range(TRACE_TRIES):
        sample.reset()
        counters = Counters(st)
        with Guard(st), profile(activities=acts) as prof:
            sync(dev)
            t0 = time.perf_counter()
            for i in range(R):
                if i >= 2:
                    spin(ev[i - 2][1])
                ev[i][0].record()
                replay(st, i % groups(st), counters, sample, end=ev[i][1])
            sync(dev)
            window = time.perf_counter() - t0
        dev_ops, host_ops = trace.split_events(prof.events())
        k4 = trace.kernel_us(dev_ops, K4_PATTERN)[1]
        k6 = trace.kernel_us(dev_ops, K6_PATTERN)[1]
        if k4 and k6:
            return Traced(counters.fetch(), R, window,
                          [a.elapsed_time(b) for a, b in ev], dev_ops,
                          host_ops)
        log(f"traced window {attempt + 1}: {k4} traceback and {k6} "
            f"candidate-search kernel records; tried again")
    raise RuntimeError(f"torch.profiler recorded no traceback or no "
                       f"candidate-search kernel in {TRACE_TRIES} windows")


def compare(st: State, outputs: dict, ref: Reference) -> dict:
    """Every field of every read of `outputs` ({(group, k): {field:
    tensor}}) against the reference's: the reads that differ in any field,
    the batch counters that differ, and the differing reads per field."""
    per_field = {f: 0 for f in FIELDS}
    reads = counters = 0
    for (g, k), got in outputs.items():
        b = g * st.K + k
        want = ref.map(st.pool.reads[b], st.pool.lengths[b], st.paired)
        bad_read = torch.zeros(st.B, dtype=torch.bool,
                               device=st.pool.reads.device)
        for f in FIELDS:
            x, y = got[f], want[f]
            if x.dim() == 0:
                d = bool(x.shape != y.shape or x.long() != y.long())
                counters += d
                per_field[f] += d
                continue
            if x.shape != y.shape:
                d = torch.ones(st.B, dtype=torch.bool, device=bad_read.device)
            else:
                d = (x.long() != y.long()).reshape(st.B, -1).any(1)
            per_field[f] += int(d.sum())
            bad_read |= d
        reads += int(bad_read.sum())
    return {"reads_differing": reads, "counters_differing": counters,
            "sampled_reads": len(outputs) * st.B,
            "per_field": {f: n for f, n in per_field.items() if n}}


def index_work(st: State, ref: Reference) -> tuple[float, float]:
    """(valid read k-mers, index entries read) a batch, averaged over the
    pool: what candidate search must read of the index (rows past
    max_freq dropped, each row capped at the fan-out, each read at H)."""
    s = st.settings
    valid = hits = 0
    for b in range(st.pool.reads.shape[0]):
        canon, _, ok = canonical_kmers(st.pool.reads[b], st.pool.lengths[b],
                                       s.kmer, s.read_kmer_skip)
        kw = torch.where(ok, canon, 0).long()
        cnt = torch.where(ok, ref.offsets[kw + 1] - ref.offsets[kw], 0)
        cnt = torch.where(cnt > s.max_kmer_freq, 0, cnt)
        per_read = cnt.clamp(max=s.max_kmer_fanout).sum(1).clamp(
            max=ref.hit_cap)
        valid += int(ok.sum())
        hits += int(per_read.sum())
    n = st.pool.reads.shape[0]
    return valid / n, hits / n


def work(st: State, tr: Traced, ref: Reference) -> Work:
    batches = tr.replays * st.K
    c = tr.counters
    W = ref.band
    valid, hits = index_work(st, ref)
    s = st.settings
    return Work(
        reads=st.B, read_len=st.L, band=W,
        kmers=max(1, (st.L - s.kmer) // s.read_kmer_skip + 1),
        cmrs=s.max_cmrs, score_slots=c["score_slots"] / batches,
        score_cells=c["score_slots"] / batches * st.L * W,
        aligned=c["aligned"] / batches,
        align_cells=c["aligned"] / batches * st.L * W,
        valid_kmers=valid, hits=hits)


def free_program(st: State) -> State:
    st = st._replace(mapper=None)
    gc.collect()
    if st.pool.reads.device.type == "cuda":
        torch.cuda.empty_cache()
    return st


def metric(value, unit: str) -> dict:
    return {"value": value, "unit": unit}


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
             dev, program, t_start: float) -> dict:
    """One run; returns the result object (its "checks" key last)."""
    st = set_up(cell, seed, dev, program)
    t0 = time.perf_counter()
    sample = warm_up(st, seed)
    log(f"set-up: mapper and index {st.index_build_s:.2f} s, warm-up pass "
        f"{time.perf_counter() - t0:.2f} s")
    captures = list(st.mapper.graphs.captures)
    out: dict = {}
    if traced:
        tr = traced_window(st, sample)
        reads = tr.replays * st.K * st.B
        window_s, counts = tr.window_s, tr.counters
    else:
        counts, replays, window_s, t_first = timed_window(st, seconds, sample)
        reads = replays * st.K * st.B
        setup_s = t_first - t_start
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    st = free_program(st)
    t0 = time.perf_counter()
    ref = Reference(st.genome, st.settings, st.L)
    cmp = compare(st, sample.outputs(), ref)
    log(f"reference: {len(sample.picks)} batches in "
        f"{time.perf_counter() - t0:.2f} s")
    correct = cmp["reads_differing"] == 0 and cmp["counters_differing"] == 0
    if traced:
        busy = trace.busy_us(tr.device_ops) / 1e6
        ctx = {
            "cell": cell.name, "K": st.K, "batch": st.B,
            "replays": tr.replays, "batches": tr.replays * st.K,
            "reads": reads, "replay_ms": tr.replay_ms, "captures": captures,
            "window_s": tr.window_s, "busy_s": busy,
            "device_ops": tr.device_ops, "counters": counts,
            "work": work(st, tr, ref), "index_build_s": st.index_build_s,
        }
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"])(ctx)
            if v is not None:
                out[m["name"]] = metric(v, m["unit"])
    else:
        pairs = reads // 2
        values = {
            "reads_per_s": reads / window_s,
            "truth_correct_pct": 100.0 * counts["truth_correct"] / reads,
            "proper_pct": 100.0 * counts["proper_pairs"] / max(1, pairs),
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            out[m["name"]] = metric(values[m["name"]], m["unit"])
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(reads),
              "failed": int(cmp["reads_differing"]), "metrics": out,
              "device": device}
    if traced:
        device["busy_s"] = busy
        device["window_s"] = tr.window_s
        result["breakdown"] = {
            "device_ops": trace.top_ops(tr.device_ops),
            "idle_gaps": trace.idle_gaps(tr.device_ops, tr.host_ops)}
    log(f"window: {reads} reads in {window_s:.3f} s; counters {counts}; "
        f"captures {captures}; sample {sample.picks}; per field "
        f"{cmp['per_field']}")
    result["checks"] = {
        "reads_differing": {"value": cmp["reads_differing"], "limit": 0},
        "counters_differing": {"value": cmp["counters_differing"],
                               "limit": 0},
    }
    return result


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="ngm_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    if not torch.cuda.is_available():
        log("no CUDA card: torch.cuda.is_available() is False")
        return 2
    cell = manifest.find_cell(manifest.load_manifest(), args.workload)
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2
    program = import_program()
    log(f"set-up: torch and the program imported "
        f"{time.time() - t_start:.2f} s after the process started")
    facts = card_facts()
    print(facts, flush=True)
    log(facts)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    program[3].load()       # the kernels: nvcc at a checkout's first run
    log(f"kernel library ready in {time.perf_counter() - t0:.2f} s")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                      program, t_start)
    bad = forbidden_modules()
    if bad:
        log(f"the run's process holds {bad}: no result")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
