"""The benchmark's manifest (``BENCHMARK.json``) and the files it names.

A cell ``<config>.<traffic>`` is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``,
and each per-layer metric in ``metrics/<metric>.py`` (a module with
``read(ctx) -> float | None``).  Adding a cell, a configuration, a mix or
a metric is adding files and manifest entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list     # the manifest's entries this cell reports
    per_layer: list


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(kind: str, name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, kind, f"{name}.json")) as f:
        return json.load(f)


def find_cell(manifest: dict, name: str, bench_dir: str = BENCH_DIR) -> Cell:
    """The workload `name` of the manifest with its files loaded."""
    for w in manifest["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return Cell(name, int(w["chips"]),
                load_json("configs", w["config"], bench_dir),
                load_json("traffic", w["traffic"], bench_dir),
                [m for m in manifest["end_to_end"] if _reports(m, name)],
                [m for m in manifest["per_layer"] if _reports(m, name)])


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"ngm_bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
