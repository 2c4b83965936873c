"""The controls: the reference computed below the configuration's stated
precision, or with a stated guarantee broken, must come out not correct."""

import os
import sys

import pytest
import torch

from conftest import BENCH, tiny_cell
from ngmb import manifest

sys.path.insert(0, BENCH)
import control  # noqa: E402


def test_controls_on_the_cpu(program):
    r = control.run_control(tiny_cell("chr20_se150.wgs", batch=128), 77,
                            0.0, torch.device("cpu"), program)
    assert r["program"]["reads_differing"] == 0
    assert r["program"]["counters_differing"] == 0
    assert r["skip2"]["reads_differing"] > 0
    assert r["bf16"]["reads_differing"] >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell,controls", [
    ("chr20_se150.wgs", ("bf16", "skip2")),
    ("chr20_pe150.wgs", ("bf16", "skip2")),
    ("chr20_se150.div10", ("bf16", "skip2")),
    ("chr20_se150.unique", ("skip2",)),
])
def test_controls_at_the_cells_size(card, program, cell, controls):
    """On the card, at the cell's own size: the program reads 0, and each
    control that failed on every seed it was read on reads more (bf16 can
    change no gate of `unique`, where a read has one candidate)."""
    program[3].load()
    c = manifest.find_cell(manifest.load_manifest(), cell)
    r = control.run_control(c, 2**31 + 101, 1.0, card, program)
    assert r["program"]["reads_differing"] == 0
    for name in controls:
        assert r[name]["reads_differing"] > 0, (name, r)


def test_control_script_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert control.main(["--workload", "chr20_se150.wgs", "--seeds", "1"]) == 2
    assert os.path.exists(os.path.join(BENCH, "control.py"))
