"""The benchmark's 1000 bp cell (`chr20_se1000.wgs`) through its harness on
the CPU: the cell as the manifest names it, its genome and batches cut so
that one thread maps it in seconds (genome 150 kbp, B 16, K 2, a pool of
2 batches), one untraced run of ``harness.run_cell``.  The run maps the
pool through ``Mapper.map_batch_scan`` and compares every field of the
sampled reads with the benchmark's frozen plain reference, at the band
W 184 that 1000 bp reads take.  Tolerance: exact equality (`correct`, no
read and no batch counter differing)."""

import copy
import os
import sys
import time

import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ngm_bench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from ngmb import harness, manifest  # noqa: E402
from ngmb.reference import Reference  # noqa: E402

CELL = "chr20_se1000.wgs"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(cell):
    c = copy.deepcopy(cell.config)
    c["genome"].update(length=150_000)
    c.update(batch=16, megabatch=2, pool_batches=2)
    return cell._replace(config=c)


def test_long_cell_is_correct_on_the_cpu(monkeypatch):
    cell = manifest.find_cell(manifest.load_manifest(), CELL)
    assert cell.config["reads"] == {"length": 1000, "paired": False}
    assert cell.config["batch"] == 614
    bands = []

    class Seen(Reference):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            bands.append(self.band)

    monkeypatch.setattr(harness, "Reference", Seen)
    r = harness.run_cell(tiny(cell), 2**31 + 23, 0.01, False, CPU,
                         harness.import_program(), time.time())
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["reads_differing"] == {"value": 0, "limit": 0}
    assert r["checks"]["counters_differing"] == {"value": 0, "limit": 0}
    assert bands == [184]
    m = r["metrics"]
    assert set(m) == {"reads_per_s", "truth_correct_pct", "setup_s"}
    assert m["truth_correct_pct"]["value"] > 80
