"""The readers of the program's own tracing (``ngmb/program_window.py``) on
a hand-made second window, their silence where the program has no tracing,
and, on the card, a real second window whose program counter of scored
slots equals the harness's own count."""

import pytest

from conftest import tiny_cell
from ngmb import harness, manifest, program_window
from ngmb.trace import DeviceOp, HostOp

NEW = ("front_us", "score_pass_us", "select_us", "finish_us",
       "graph_gap_pct", "score_slots_demanded_per_read",
       "unscored_reads_pct", "program_idle_pct")


def mark(p, t):
    return DeviceOp(f"void (anonymous namespace)::ngm_mark_kernel<{p}>"
                    "(long long*)", t, t + 1.0)


def window():
    """One step, 0 to 151 us: kernels between its marks, idle 50-52 and
    91-95 inside it, then a clone at 300 after a gap the harness holds."""
    ops = [mark(0, 0.0), DeviceOp("void cand_search_kernel<32>", 1.0, 50.0),
           mark(1, 52.0), DeviceOp("void sw_score_kernel<16>", 53.0, 90.0),
           mark(2, 90.0), mark(3, 95.0),
           DeviceOp("void sw_align_kernel<16>", 96.0, 150.0), mark(4, 150.0),
           DeviceOp("Memcpy DtoD", 300.0, 310.0)]
    host = [HostOp("ngm.map_batch_scan", 0.0, 120.0),
            HostOp("ngm.graph.replay", 40.0, 100.0),
            HostOp("aten::sum", 200.0, 290.0)]
    marks = {"phase_ns": {"front": 52_000, "score": 38_000, "select": 5_000,
                          "finish": 55_000},
             "phase_marks": {p: 1 for p in program_window.PHASES},
             "score_slots_demanded": 3_000, "score_slots_scored": 2_048,
             "reads_unscored": 700}
    return {"K": 1, "replays": 1, "batches": 1, "reads": 4_096,
            "window_s": 400e-6, "replay_ms": [0.4], "device_ops": ops,
            "host_ops": host, "marks": marks, "score_slots": 2_048}


def readers():
    return {n: manifest.metric_reader(n) for n in NEW}


def test_readers_on_a_window():
    ctx = {"cell": "chr20_se150.wgs", program_window.KEY: window()}
    got = {n: r(ctx) for n, r in readers().items()}
    assert got["front_us"] == 52.0
    assert got["score_pass_us"] == 38.0
    assert got["select_us"] == 5.0
    assert got["finish_us"] == 55.0
    # 6 us idle inside the step's 151
    assert got["graph_gap_pct"] == pytest.approx(100 * 6 / 151)
    assert got["score_slots_demanded_per_read"] == 3_000 / 4_096
    assert got["unscored_reads_pct"] == pytest.approx(100 * 700 / 4_096)
    # gaps at 50 and 91 start inside ngm.* spans; 151-300 starts outside
    assert got["program_idle_pct"] == pytest.approx(100 * 6 / 400)
    assert all(n in {m["name"] for m in manifest.load_manifest()["per_layer"]}
               for n in NEW)


def test_spans_and_steps():
    w = window()
    assert program_window.steps(w["device_ops"]) == [(0.0, 151.0)]
    assert [h.name for h in program_window.covering(w["host_ops"], 50.0)] \
        == ["ngm.map_batch_scan", "ngm.graph.replay"]
    assert program_window.covering(w["host_ops"], 151.0) == []
    assert program_window.graph_gap_pct(w["device_ops"][1:]) is None
    assert program_window.run_seed(["--workload", "x", "--seed", "2147483659",
                                    "--trace", "1"]) == 2147483659


def test_readers_are_silent_without_the_programs_tracing(monkeypatch):
    """A program without utils/trace.py: nothing is set up, nothing read."""
    def no_set_up(*a, **k):
        raise AssertionError("a second window was set up")

    monkeypatch.setattr(program_window, "program_tracing", lambda: None)
    monkeypatch.setattr(harness, "set_up", no_set_up)
    ctx = {"cell": "chr20_se150.wgs", "replay_ms": [1.0]}
    assert all(r(ctx) is None for r in readers().values())
    assert ctx[program_window.KEY] is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["chr20_se150.wgs", "chr20_pe150.wgs"])
def test_second_window_on_the_card(card, program, cell):
    """The program's scored slots equal the harness's score_slots, every
    step is marked, and every reader reads a number."""
    program[3].load()
    pt = program_window.window(tiny_cell(cell), 2**31 + 7, card)
    m = pt["marks"]
    assert m["score_slots_scored"] == pt["score_slots"] > 0
    assert m["score_slots_demanded"] >= m["score_slots_scored"]
    assert m["phase_marks"] == {p: pt["batches"]
                                for p in program_window.PHASES}
    assert len(program_window.steps(pt["device_ops"])) == pt["batches"]
    ctx = {"cell": cell, "replay_ms": pt["replay_ms"], program_window.KEY: pt}
    got = {n: r(ctx) for n, r in readers().items()}
    assert all(v is not None for v in got.values()), got
    assert 0 <= got["graph_gap_pct"] < 100
