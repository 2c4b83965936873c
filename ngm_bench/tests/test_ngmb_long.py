"""The 1000 bp cell (`chr20_se1000.wgs`): the readers of its three metrics
on hand-made second windows, with and without what they read, and the
band, hit cap and slot cap its configuration derives."""

import pytest

from ngmb import manifest, program_window, yardstick
from ngmb.reference import Settings, band_for, hit_cap_for, slot_cap_for

CELL = "chr20_se1000.wgs"
NEW = ("align_us", "align_roofline_pct", "hit_capped_reads_pct")
WORK = yardstick.Work(reads=614, read_len=1000, band=184, kmers=494,
                      cmrs=32, score_slots=512.0,
                      score_cells=512.0 * 1000 * 184, aligned=614.0,
                      align_cells=614.0 * 1000 * 184,
                      valid_kmers=614 * 494.0, hits=614 * 1200.0)


def reading(program_has_them: bool) -> dict:
    """A second window of 8 batches; the marks and counters a program with
    the traceback's inner marks and the hit-cap counter reads, or those a
    program before them reads."""
    marks = {"phase_ns": {"front": 8 * 300_000, "score": 8 * 250_000,
                          "select": 8 * 9_000, "finish": 8 * 900_000},
             "phase_marks": {p: 8 for p in program_window.PHASES},
             "score_slots_demanded": 8 * 900, "score_slots_scored": 8 * 512,
             "reads_unscored": 8 * 100}
    if program_has_them:
        marks.update(inner_ns={"align": 8 * 760_000},
                     inner_marks={"align": 8}, reads_hit_capped=8 * 61)
    return {"K": 8, "replays": 1, "batches": 8, "reads": 8 * 614,
            "window_s": 0.012, "replay_ms": [11.0], "device_ops": [],
            "host_ops": [], "marks": marks, "score_slots": 8 * 512}


def ctx(pt):
    return {"cell": CELL, "work": WORK, "replay_ms": [11.0],
            program_window.KEY: pt}


def readers():
    return {n: manifest.metric_reader(n) for n in NEW}


def test_readers_read_a_window():
    got = {n: r(ctx(reading(True))) for n, r in readers().items()}
    assert got["align_us"] == 760.0
    assert got["align_roofline_pct"] == pytest.approx(
        100 * yardstick.k4_s(WORK) / 760e-6)
    assert 0 < got["align_roofline_pct"] < 100
    assert got["hit_capped_reads_pct"] == pytest.approx(100 * 61 / 614)


def test_readers_are_silent_on_a_program_without_them():
    """The parent's program: its window has no inner marks and no hit-cap
    counter; a program without tracing has no window at all."""
    for pt in (reading(False), None):
        assert all(r(ctx(pt)) is None for r in readers().values())
    pt = reading(True)
    pt["marks"]["inner_marks"]["align"] = 0
    assert readers()["align_us"](ctx(pt)) is None
    assert readers()["align_roofline_pct"](ctx(pt)) is None


def test_metrics_are_scoped_to_the_cell():
    man = manifest.load_manifest()
    per_layer = {m["name"]: m for m in man["per_layer"]}
    for n in NEW:
        assert per_layer[n]["workloads"] == [CELL]
    cell = manifest.find_cell(man, CELL)
    assert [m["name"] for m in cell.per_layer] == list(NEW)
    assert {m["name"] for m in cell.end_to_end} == {
        "reads_per_s", "truth_correct_pct", "setup_s"}


def test_derived_band_hit_cap_and_slot_cap(program):
    cell = manifest.find_cell(manifest.load_manifest(), CELL)
    c = cell.config
    L, B = c["reads"]["length"], c["batch"]
    assert (L, B, c["megabatch"]) == (1000, 614, 8)
    s = Settings.of(c["ngm"])
    n_pos = c["genome"]["length"] - s.kmer + 1
    assert band_for(s, L) == 184
    assert hit_cap_for(s, n_pos, L) == 1280
    assert slot_cap_for(B) == 512
    # the program's own rules give the same, and the runner's batch rule
    # for 1000 bp reads gives the cell's batch
    NgmConfig = program[0]
    from nextgenmap_tpu_torch.models.mapper import default_slot_cap
    from nextgenmap_tpu_torch.pipeline.runner import long_read_batch_size
    cfg = NgmConfig(**c["ngm"])
    assert cfg.corridor_for(L) == 184
    assert cfg.resolved_read_hits(n_pos, L) == 1280
    assert default_slot_cap(B) == 512
    assert long_read_batch_size(NgmConfig(), L) == B
