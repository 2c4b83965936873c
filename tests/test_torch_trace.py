"""The program's tracing (utils/trace.py): phase marks, the traceback's
inner marks, score-pass and hit-cap counters and host spans.

On the CPU:
  * map_step and map_step_paired give the same outputs, field by field,
    with tracing on and off;
  * on batches whose score pass overflows a small slot cap, the three
    score counters equal a count made apart from the program, from the
    outputs' n_candidates and the cap, with a read only partly scored;
  * at 150 and 1000 bp, at the rule's hit cap H and at a small one,
    `reads_hit_capped` equals the hit_overflow of a plain candidate search
    on the step's reads, and the step's outputs equal the untraced ones;
  * under torch.profiler the ngm.* spans appear while tracing is on and
    not while it is off;
  * a mark does nothing on the CPU, and nothing anywhere while tracing is
    off;
  * `ngm map --profile` logs the counters with its summary.
On the card (marked `cuda`, skipped without one), single-end and paired:
an untraced graph's profiled records hold no mark, a traced graph's hold
exactly 5 K marks (K of each phase), K pairs of inner marks and K of each
counter kernel more and otherwise the same records; the traced outputs
equal the untraced ones; the accumulators count K marks of each phase and
K of `align` a replay and nothing of the warm-up; the counters equal the
count from the outputs; the graph spans appear only while tracing.  At
[614, 1000] x W 184: the finish pass (K4 with its prologue and epilogue)
takes K4's global route, a traced graph has one `align` pair a step around
the step's one finish-pass kernel and at most the memset of its overflow
counter, and `align` reads within a few us of those records.
Tolerance: exact equality; `align` against its records: 0 to 12 us a step.
"""

import collections
import logging
import re

import numpy as np
import pytest
import torch

from nextgenmap_tpu_torch import synthetic
from nextgenmap_tpu_torch.cli import run as torch_run
from nextgenmap_tpu_torch.config import NgmConfig
from nextgenmap_tpu_torch.models import mapper as tmapper
from nextgenmap_tpu_torch.native import build
from nextgenmap_tpu_torch.utils import trace

L, B, K = 100, 64, 2
CPU = torch.device("cpu")
MARK = re.compile(r"ngm_mark_kernel<(\d)>")
INNER = re.compile(r"ngm_inner_mark_kernel<(\d)>")
COUNT = "ngm_score_counts_kernel"
HITS = "ngm_hit_counts_kernel"
SCORE = ("score_slots_demanded", "score_slots_scored", "reads_unscored")


def tracing_record(name: str) -> bool:
    """Whether a device record is one of the tracing's own kernels."""
    return bool(MARK.search(name) or INNER.search(name) or COUNT in name
                or HITS in name)


@pytest.fixture(autouse=True)
def one_thread_tracing_off_after():
    """One intra-op thread (the test workers run side by side), and the
    process's tracing off after each test.  This file imports no JAX, and
    nothing of the other test files, so that it runs on the card too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    trace.disable()


class _G:
    codes = synthetic.repeat_genome(50_000, n_repeats=12, min_len=800,
                                    max_len=2000, seed=191)


@pytest.fixture(scope="module")
def data():
    single, _, _ = synthetic.simulate_reads(_G.codes, K * B, L, 0.02,
                                            seed=192)
    paired, _, _ = synthetic.simulate_pairs(_G.codes, K * B // 2, L, 0.02,
                                            seed=193)
    return {False: single.reshape(K, B, L), True: paired.reshape(K, B, L),
            "lens": np.full((K, B), L, np.int32)}


@pytest.fixture(scope="module")
def port():
    return tmapper.Mapper(NgmConfig(kmer=11), _G(), L, device="cpu")


def fields(res) -> dict:
    return {f: getattr(res, f) for f in res._fields}


def assert_equal(a, b):
    for f, t in fields(a).items():
        assert torch.equal(t, getattr(b, f)), f


def expected_counts(n_candidates, paired: bool, slot_cap: int) -> list:
    """(slots asked, slots scored, reads left wholly or partly unscored)
    of one batch, from its outputs' n_candidates: the score pass takes the
    candidates of reads with >= 2 (paired: of both mates where either has
    >= 2) in read order until the cap."""
    n = np.asarray(n_candidates, dtype=np.int64)
    mask = ((n.reshape(-1, 2) >= 2).any(1).repeat(2) if paired
            else n >= 2)
    n_sc = np.where(mask, n, 0)
    end = np.cumsum(n_sc)
    total = int(end[-1])
    return [total, min(total, slot_cap),
            int(((n_sc > 0) & (end > slot_cap)).sum())]


def step(port, codes, lens, paired, **kw):
    args = port._common_args(codes, lens, paired=paired)
    fn = tmapper.map_step_paired if paired else tmapper.map_step
    return fn(*args, **{**port.statics(), **kw})


@pytest.mark.parametrize("paired", [False, True])
def test_steps_equal_with_tracing_on_and_off(data, port, paired):
    off = port.map_batch_scan(data[paired], data["lens"], paired=paired)
    trace.enable("cpu")
    on = port.map_batch_scan(data[paired], data["lens"], paired=paired)
    assert_equal(off, on)
    got = trace.read()
    assert got["score_slots_scored"] > 0
    assert set(got["phase_marks"].values()) == {0}


@pytest.mark.parametrize("paired", [False, True])
def test_score_counters_equal_a_count_from_the_outputs(data, port, paired):
    codes, lens = data[paired][0], data["lens"][0]
    n = step(port, codes, lens, paired).n_candidates
    # a cap that ends inside a read's slots, with reads after it
    nn = np.asarray(n, dtype=np.int64)
    mask = ((nn.reshape(-1, 2) >= 2).any(1).repeat(2) if paired
            else nn >= 2)
    multi = np.flatnonzero(mask & (nn >= 2))
    assert len(multi) >= 4
    j = multi[len(multi) // 2]
    end = np.cumsum(np.where(mask, nn, 0))
    cap = int(end[j]) - 1
    assert end[j] - nn[j] < cap < end[j]        # read j is partly scored
    trace.enable("cpu")
    res = step(port, codes, lens, paired, slot_cap=cap)
    got = trace.read()
    want = expected_counts(res.n_candidates, paired, cap)
    assert [got[c] for c in SCORE] == want
    assert want[0] > want[1] and want[2] >= len(multi) - len(multi) // 2


def test_spans_only_while_tracing(data, port):
    from torch.profiler import ProfilerActivity, profile

    def names():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            port.map_batch_scan(data[False], data["lens"])
        return {e.name for e in prof.events()}

    assert not {n for n in names() if n.startswith("ngm.")}
    trace.enable("cpu")
    assert "ngm.map_batch_scan" in names()


def test_mark_is_a_no_op_on_the_cpu(monkeypatch):
    def no_library():
        raise AssertionError("a mark on the CPU loaded the kernels")

    monkeypatch.setattr(build, "load", no_library)
    for p in trace.PHASES:          # tracing off: nothing, on any device
        trace.mark(p, torch.device("cuda", 0))
    for close in (False, True):
        trace.mark_inner("align", torch.device("cuda", 0), close=close)
    trace.enable("cpu")
    for p in trace.PHASES:
        trace.mark(p, CPU)
    for close in (False, True):
        trace.mark_inner("align", CPU, close=close)
    got = trace.read()
    assert set(got["phase_ns"].values()) == {0}
    assert set(got["phase_marks"].values()) == {0}
    assert got["inner_ns"] == got["inner_marks"] == {"align": 0}
    assert trace.phase_us(got) == {}


@pytest.fixture(scope="module")
def long_ports():
    """Mappers of 150 and 1000 bp reads on the repeat genome (the rule's
    band and hit cap for each length)."""
    return {n: tmapper.Mapper(NgmConfig(kmer=11), _G(), n, device="cpu")
            for n in (150, 1000)}


def plain_hits_capped(port, codes, lens, hit_cap) -> int:
    """K6's hit_overflow of a plain candidate search (the wrapper on CPU
    tensors) over the reads a step of `port` takes."""
    from nextgenmap_tpu_torch.ops.candidate_kernel import candidate_search

    (_, offsets, positions, reads, lengths, _, _, _, _, sensitivity,
     max_freq, _, _) = port._common_args(codes, lens)
    st = port.statics()
    _, kms = tmapper._pre_extract(reads, lengths, k=st["k"],
                                  read_stride=st["read_stride"])
    cand = candidate_search(
        kms, lengths, offsets, positions, sensitivity, max_freq, k=st["k"],
        fanout_cap=st["fanout_cap"], hit_cap=hit_cap,
        max_cmrs=st["max_cmrs"], diag_bin_log2=st["diag_bin_log2"],
        stride=st["read_stride"], packed_offsets=st["packed_offsets"])
    return int(cand.hit_overflow)


@pytest.mark.parametrize("cap", ["rule", 128])
@pytest.mark.parametrize("length", [150, 1000])
def test_hit_capped_reads_equal_the_plain_search(long_ports, length, cap):
    port = long_ports[length]
    n = 16 if length == 1000 else 32
    codes, _, _ = synthetic.simulate_reads(_G.codes, n, length, 0.02,
                                           seed=195 + length)
    lens = np.full(n, length, np.int32)
    h = port.hit_cap if cap == "rule" else cap
    kw = {} if cap == "rule" else {"hit_cap": cap}
    want = plain_hits_capped(port, codes, lens, h)
    off = step(port, codes, lens, False, **kw)
    trace.enable("cpu")
    on = step(port, codes, lens, False, **kw)
    got = trace.read()
    assert_equal(off, on)
    assert got["reads_hit_capped"] == want
    assert int(on.fanout_overflow) >= want     # summed with the fan-out's
    if cap != "rule":
        assert want > 0


def test_profile_logs_the_score_counters(tmp_path):
    g = _G.codes
    synthetic.write_fasta(str(tmp_path / "ref.fa"), "chr", g)
    codes, pos, strand = synthetic.simulate_reads(g, 40, L, 0.02, seed=194)
    synthetic.write_fastq(str(tmp_path / "r.fq"), codes, pos, strand)
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log = logging.getLogger("ngm-torch.run")
    h = Keep()
    log.addHandler(h)
    try:
        stats = torch_run([
            "map", "-r", str(tmp_path / "ref.fa"),
            "-q", str(tmp_path / "r.fq"), "-o", str(tmp_path / "out.sam"),
            "-k", "11", "--batch-size", "16", "--no-progress",
            "--profile", str(tmp_path / "prof"), "--device", "cpu"])
    finally:
        log.removeHandler(h)
    (line,) = [ln for ln in lines if ln.startswith("program trace:")]
    got = {c: int(re.search(c + r" (\d+)", line).group(1))
           for c in trace.COUNTERS}
    assert got["score_slots_scored"] == stats.slots_scored > 0
    assert got["score_slots_demanded"] == stats.slots_scored
    assert got["reads_unscored"] == 0
    assert not trace.on(CPU)


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the marks and counters run only there")
    return torch.device("cuda", 0)


def profiled(m, codes, lens, paired):
    """(device record names, host op names) of a map_batch_scan call under
    torch.profiler, user annotations left out.  Two calls run in the
    window and only the second's records count: CUPTI has been seen to drop
    the first record of a window.  The calls are synchronised, so the
    second's records all start after a host range put between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        m.map_batch_scan(codes, lens, paired=paired)
        torch.cuda.synchronize()
        with record_function("between_calls"):
            pass
        m.map_batch_scan(codes, lens, paired=paired)
        torch.cuda.synchronize()
    events = prof.events()
    (cut,) = [e.time_range.start for e in events
              if e.name == "between_calls"
              and e.device_type != DeviceType.CUDA]
    dev, host = collections.Counter(), set()
    for e in events:
        if e.time_range.start < cut:
            continue
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("ngm.")
                    or e.name == "between_calls"):
                dev[e.name] += 1
        else:
            host.add(e.name)
    return dev, host


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [False, True])
def test_traced_graph_on_card(card, data, paired):
    m = tmapper.Mapper(NgmConfig(kmer=11), _G(), L, device=card)
    codes, lens = data[paired], data["lens"]
    off = m.map_batch_scan(codes, lens, paired=paired)
    trace.enable(card)
    on = m.map_batch_scan(codes, lens, paired=paired)
    assert len(m.graphs.captures) == 2
    assert_equal(off, on)
    # the traced call's capture counted nothing of its warm-up
    first = trace.read()
    assert first["phase_marks"] == {p: K for p in trace.PHASES}
    assert first["inner_marks"] == {"align": K}
    want = np.sum([expected_counts(on.n_candidates[k].cpu(), paired,
                                   tmapper.default_slot_cap(B))
                   for k in range(K)], axis=0)
    assert [first[c] for c in SCORE] == want.tolist()

    for _ in range(3):          # CUPTI may drop records from a window
        trace.disable()
        rec_off, host_off = profiled(m, codes, lens, paired)
        trace.enable(card)      # zeroed: two replays follow
        rec_on, host_on = profiled(m, codes, lens, paired)
        marks, inner = collections.Counter(), collections.Counter()
        for name, n in rec_on.items():
            for regex, got in ((MARK, marks), (INNER, inner)):
                hit = regex.search(name)
                if hit:
                    got[int(hit.group(1))] += n
        counts = sum(n for name, n in rec_on.items() if COUNT in name)
        hits = sum(n for name, n in rec_on.items() if HITS in name)
        rest = collections.Counter({name: n for name, n in rec_on.items()
                                    if not tracing_record(name)})
        if (marks == {p: K for p in range(len(trace.PHASES))}
                and inner == {0: K, 1: K} and counts == hits == K
                and rest == rec_off):
            break
    assert not any(tracing_record(n) for n in rec_off)
    assert marks == {p: K for p in range(len(trace.PHASES))}
    assert inner == {0: K, 1: K}
    assert counts == hits == K
    assert rest == rec_off
    assert not {n for n in host_off if n.startswith("ngm.")}
    assert {"ngm.map_batch_scan", "ngm.graph.inputs", "ngm.graph.replay",
            "ngm.graph.outputs"} <= host_on
    got = trace.read()
    assert got["phase_marks"] == {p: 2 * K for p in trace.PHASES}
    assert all(got["phase_ns"][p] > 0 for p in trace.PHASES[1:])
    assert got["inner_marks"] == {"align": 2 * K}
    assert 0 < got["inner_ns"]["align"] < got["phase_ns"]["finish"]
    assert [got[c] for c in SCORE] == (2 * want).tolist()
    assert len(m.graphs.captures) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [False, True])
def test_fused_pass_counters_equal_the_plain_pass(card, data, port, paired):
    """The three score counters of one step with a slot cap that ends
    inside a read: the card's fused pass (score_plan_kernel's n_sc and
    base) counts what the CPU's plain pass counts on the same reads."""
    codes, lens = data[paired][0], data["lens"][0]
    n = np.asarray(step(port, codes, lens, paired).n_candidates)
    cap = int(expected_counts(n, paired, 1 << 30)[0]) // 2
    trace.enable("cpu")
    want = step(port, codes, lens, paired, slot_cap=cap)
    plain = trace.read()
    m = tmapper.Mapper(NgmConfig(kmer=11), _G(), L, device=card)
    trace.enable(card)
    got = step(m, codes, lens, paired, slot_cap=cap)
    fused = trace.read()
    assert_equal(want, got._replace(**{f: getattr(got, f).cpu()
                                       for f in got._fields}))
    assert [fused[c] for c in trace.COUNTERS] == \
        [plain[c] for c in trace.COUNTERS]
    assert [plain[c] for c in SCORE] == expected_counts(
        want.n_candidates, paired, cap)
    assert plain["reads_unscored"] > 0


def ordered_records(m, codes, lens, paired):
    """The device records of one map_batch_scan replay in the order they
    ran (user annotations left out), after a first call as in
    `profiled`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        m.map_batch_scan(codes, lens, paired=paired)
        torch.cuda.synchronize()
        with record_function("between_calls"):
            pass
        m.map_batch_scan(codes, lens, paired=paired)
        torch.cuda.synchronize()
    events = prof.events()
    (cut,) = [e.time_range.start for e in events
              if e.name == "between_calls"
              and e.device_type != DeviceType.CUDA]
    return [e.name for e in sorted(events, key=lambda e: e.time_range.start)
            if e.device_type == DeviceType.CUDA and e.time_range.start >= cut
            and not (getattr(e, "is_user_annotation", False)
                     or e.name.startswith("ngm.")
                     or e.name == "between_calls")]


@pytest.mark.cuda
@pytest.mark.parametrize("paired", [False, True])
def test_score_pass_records_on_card(card, data, paired):
    """The score pass of a replay is at most 4 device records a step: the
    records between each step's `front` and `score` marks (the counter
    kernel left out) hold the plan and the fused kernel and no K1 or K2;
    the untraced replay's records are the traced ones without the marks
    and the counters, so it holds the same few."""
    m = tmapper.Mapper(NgmConfig(kmer=11), _G(), L, device=card)
    codes, lens = data[paired], data["lens"]
    m.map_batch_scan(codes, lens, paired=paired)
    trace.enable(card)
    m.map_batch_scan(codes, lens, paired=paired)
    for _ in range(3):          # CUPTI may drop records from a window
        trace.enable(card)
        on = ordered_records(m, codes, lens, paired)
        trace.disable()
        off = ordered_records(m, codes, lens, paired)
        phases = [[]]
        for name in on:
            hit = MARK.search(name)
            if hit:
                phases[-1].append(int(hit.group(1)))
                phases.append([])
            elif not tracing_record(name):
                phases[-1].append(name)
        # phases[i] ends with the index of the mark that closed it
        score = [p[:-1] for p in phases if p and p[-1] == 2]
        rest = collections.Counter(n for n in on if not tracing_record(n))
        if len(score) == K and rest == collections.Counter(off):
            break
    assert len(score) == K
    assert rest == collections.Counter(off)
    for names in score:
        assert len(names) <= 4, names
        assert sum("score_plan_kernel" in n for n in names) == 1, names
        assert sum("score_pass_kernel" in n for n in names) == 1, names
        assert not any("sw_score_kernel" in n or "gather_windows" in n
                       for n in names), names


@pytest.mark.cuda
def test_align_marks_at_1000bp_on_card(card):
    """[614, 1000] x W 184, the 1000 bp cell's step: K4's rule takes the
    global route, for K4 and for the finish pass; each traced step holds
    one `align` pair with exactly the step's one finish-pass kernel (its
    name holds sw_align) and at most the memset of its overflow counter
    between its marks; the five phases keep K marks a replay; `align` a
    step reads within 12 us above those records' profiled time (the gaps
    between the graph's nodes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nextgenmap_tpu_torch.ops import finish_kernel, sw_align_kernel

    n, length = 614, 1000

    class Long:
        codes = synthetic.repeat_genome(2_000_000, n_repeats=40,
                                        min_len=800, max_len=3000, seed=196)

    m = tmapper.Mapper(NgmConfig(), Long(), length, device=card)
    assert m.band == 184
    assert sw_align_kernel.plan(n, length, m.band, "local",
                                device=card).route == "global"
    assert finish_kernel.plan(n, length, m.band, "local",
                              device=card).route == "global"
    codes, _, _ = synthetic.simulate_reads(Long.codes, K * n, length, 0.02,
                                           seed=197)
    codes = codes.reshape(K, n, length)
    lens = np.full((K, n), length, np.int32)
    off = m.map_batch_scan(codes, lens)
    trace.enable(card)
    on = m.map_batch_scan(codes, lens)
    assert_equal(off, on)
    first = trace.read()
    assert first["phase_marks"] == {p: K for p in trace.PHASES}
    assert first["inner_marks"] == {"align": K}

    for _ in range(3):          # CUPTI may drop records from a window
        trace.enable(card)      # zeroed: two replays follow
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                m.map_batch_scan(codes, lens)
            torch.cuda.synchronize()
        got = trace.read()
        recs = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)
                       and not e.name.startswith("ngm.")),
                      key=lambda e: e.time_range.start)
        inside, spans = None, []
        for e in recs:
            hit = INNER.search(e.name)
            if hit and hit.group(1) == "0":
                inside = []
            elif hit:
                spans.append(inside)
                inside = None
            elif inside is not None:
                inside.append(e)
        if len(spans) == 2 * K and all(s is not None for s in spans):
            break
    assert got["phase_marks"] == {p: 2 * K for p in trace.PHASES}
    assert got["inner_marks"] == {"align": 2 * K}
    assert len(spans) == 2 * K
    for s in spans:
        # the finish pass: its kernel, after the memset of its counter
        names = [e.name for e in s]
        assert 1 <= len(s) <= 2, names
        assert sum("sw_align" in n for n in names) == 1, names
        assert all("sw_align" in n or "memset" in n.lower()
                   for n in names), names
    busy = sum(e.time_range.end - e.time_range.start
               for s in spans for e in s) / (2 * K)
    align_us = got["inner_ns"]["align"] / got["inner_marks"]["align"] / 1e3
    assert 0 <= align_us - busy <= 12, (align_us, busy)
    assert trace.phase_us(got)["align"] == align_us
