"""The manifest against the contract's shape, and cells, configurations,
mixes and metrics found by file name."""

import json
import os
import re
import shutil

import pytest

from conftest import BENCH
from ngmb import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def man():
    return manifest.load_manifest()


def test_top_level_keys(man):
    assert set(man) == TOP
    assert man["command"] == ["python3", "ngm_bench/run.py"]
    assert man["paths"] == ["ngm_bench"]
    assert 1 <= man["run_seconds"] <= 51
    size = os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json"))
    assert size <= 64 * 1024


def test_run_seconds_fit_a_full_check(man):
    rs = man["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(man):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                    assert "\t" not in e[key]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [e["name"] for e in man[group]]
        assert len(ns) == len(set(ns)), group
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for c in man["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://")
        assert c["file"] == f"ngm_bench/configs/{c['name']}.json"
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
        assert m["better"] in ("lower", "higher")
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in man["end_to_end"]]
    assert "setup_s" in names


def test_cells_in_the_issues_order(man):
    assert [w["name"] for w in man["workloads"]][:2] == [
        "chr20_se150.wgs", "chr20_pe150.wgs"]


def test_every_cell_reports_what_its_metrics_move(man):
    cells = [w["name"] for w in man["workloads"]]
    for cell in cells:
        c = manifest.find_cell(man, cell)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in e2e, (cell, m["name"])
    for m in man["per_layer"] + man["end_to_end"]:
        assert set(m.get("workloads", cells)) <= set(cells)


def test_every_file_a_cell_names_exists(man):
    for w in man["workloads"]:
        c = manifest.find_cell(man, w["name"])
        assert c.config["name"] == w["config"]
        assert c.traffic["name"] == w["traffic"]
    for c in man["configs"]:
        assert os.path.exists(os.path.join(manifest.ROOT, c["file"]))
        cfg = json.load(open(os.path.join(manifest.ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"]
    for m in man["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))


def test_added_files_are_found_with_no_edit(tmp_path, man):
    """A new configuration, mix and metric are picked up from their files
    and the manifest's entries alone."""
    bench = tmp_path / "ngm_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = json.load(open(bench / "configs" / "chr20_se150.json"))
    cfg["name"] = "other_se100"
    cfg["reads"]["length"] = 100
    json.dump(cfg, open(bench / "configs" / "other_se100.json", "w"))
    json.dump({"name": "burst", "region": "uniform", "error_rate": 0.01,
               "mutation_rate": 0.0, "indel_fraction": 0.0,
               "indel_extend": 0.0},
              open(bench / "traffic" / "burst.json", "w"))
    (bench / "metrics" / "reads_seen.py").write_text(
        "def read(ctx):\n    return float(ctx['reads'])\n")
    man = json.loads(json.dumps(man))
    man["workloads"].append({"name": "other_se100.burst",
                             "config": "other_se100", "traffic": "burst",
                             "chips": 1, "why": "a later cell"})
    man["per_layer"].append({"name": "reads_seen", "unit": "reads",
                             "better": "higher", "source": "program_counter",
                             "layer": "device", "moves": "reads_per_s",
                             "workloads": ["other_se100.burst"]})
    cell = manifest.find_cell(man, "other_se100.burst", str(bench))
    assert cell.config["reads"]["length"] == 100
    assert cell.traffic["error_rate"] == 0.01
    assert [m["name"] for m in cell.per_layer] == ["reads_seen"]
    assert manifest.metric_reader("reads_seen", str(bench))({"reads": 7}) == 7


def test_unknown_cell_is_refused(man):
    with pytest.raises(KeyError):
        manifest.find_cell(man, "chr20_se150.nothing")
