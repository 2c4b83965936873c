"""The comparison that decides `correct`: true on a tiny CPU run of the
port, false with the timed path broken underneath the harness."""

import time

import pytest
import torch

from conftest import tiny_cell
from ngmb import harness

CPU = torch.device("cpu")


def run(program, name="chr20_se150.wgs", seed=2**31 + 11):
    return harness.run_cell(tiny_cell(name), seed, 0.01, False, CPU, program,
                            time.time())


@pytest.mark.parametrize("name", ["chr20_se150.wgs", "chr20_pe150.wgs"])
def test_sound_run_is_correct(program, name):
    r = run(program, name)
    assert r["correct"] and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["reads_differing"] == {"value": 0, "limit": 0}
    m = r["metrics"]
    assert set(m) >= {"reads_per_s", "truth_correct_pct", "setup_s"}
    assert ("proper_pct" in m) == (name == "chr20_pe150.wgs")
    assert m["truth_correct_pct"]["value"] > 80
    assert r["device"]["platform"] == "cpu"


def _altered(field, how):
    def fault(res):
        return res._replace(**{field: how(getattr(res, field).clone())})
    return fault


def _one(t):
    t[:, 3] += 1
    return t


def _half_left_out(res):
    """The second half of every batch never mapped: its rows read as
    unmapped reads with nothing found."""
    out = {}
    for f in res._fields:
        t = getattr(res, f).clone()
        if t.dim() >= 2:
            t[:, t.shape[1] // 2:] = 0
        out[f] = t
    return res._replace(**out)


FAULTS = {
    "pos_altered": _altered("pos", _one),
    "ops_altered": _altered("ops", lambda t: (t.__setitem__(
        (slice(None), 5, 0), t[:, 5, 0] ^ 1), t)[1]),
    "half_left_out": _half_left_out,
}


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["unchanged"])
def test_broken_timed_path_is_not_correct(program, monkeypatch, fault):
    Mapper = program[2]
    real = Mapper.map_batch_scan
    last = {}

    def broken(self, codes_k, lengths_k, paired=False):
        res = real(self, codes_k, lengths_k, paired)
        if fault == "unchanged":
            # a step that hands back its last state: the previous call's
            # outputs after the first call
            out = last.get("res", res)
            last["res"] = res
            return out
        return FAULTS[fault](res)

    monkeypatch.setattr(Mapper, "map_batch_scan", broken)
    r = run(program)
    assert r["correct"] is False
    assert r["checks"]["reads_differing"]["value"] > 0
    assert r["failed"] == r["checks"]["reads_differing"]["value"]


def test_compare_counts_fields_and_counters(program):
    """Per-read and per-batch differences are counted apart."""
    st = harness.set_up(tiny_cell("chr20_se150.wgs"), 9, CPU, program)
    sample = harness.warm_up(st, 9)
    harness.timed_window(st, 0.0, sample)
    st = harness.free_program(st)
    from ngmb.reference import Reference
    ref = Reference(st.genome, st.settings, st.L)
    assert harness.compare(st, sample.outputs(), ref)["reads_differing"] == 0
    (g, k), buf = next(iter(sample.outputs().items()))
    buf["mapq"][0] += 1
    buf["cmr_overflow"] += 1
    cmp = harness.compare(st, sample.outputs(), ref)
    assert cmp["reads_differing"] == 1 and cmp["counters_differing"] == 1
    assert cmp["per_field"] == {"mapq": 1, "cmr_overflow": 1}
    sample.done.discard((g, k))
    with pytest.raises(RuntimeError):
        sample.outputs()


def test_setting_the_reference_does_not_model_is_refused(program):
    """A configuration whose settings the reference does not model (a mode
    of its own) is refused before anything runs, naming the settings."""
    cell = tiny_cell("chr20_se150.wgs")
    cell.config["ngm"]["bs_mapping"] = True
    with pytest.raises(ValueError, match="bs_mapping"):
        harness.set_up(cell, 9, CPU, program)
