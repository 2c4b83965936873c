"""What the benchmark imports: no JAX and no JAX package anywhere it runs,
nothing of the program in the yardstick and the reference, and a run that
refuses without a card."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH
from ngmb import harness, manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "nextgenmap_tpu"}
PROGRAM = "nextgenmap_tpu_torch"
# the benchmark's own yardstick, and what each may import
INDEPENDENT = ("ngmb/reference.py", "ngmb/gen.py", "ngmb/yardstick.py",
               "ngmb/trace.py", "ngmb/manifest.py")
ALLOWED = {"__future__", "typing", "math", "re", "os", "json", "importlib",
           "torch", "numpy", "ngmb"}


def top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere_in_the_benchmark():
    for path in sources():
        assert not top_level_imports(path) & FORBIDDEN, path


def test_yardstick_and_reference_import_nothing_of_the_program():
    for rel in INDEPENDENT:
        path = os.path.join(BENCH, rel)
        assert top_level_imports(path) <= ALLOWED, rel
        assert "import_module" not in open(path).read(), rel
    for path in sources():
        if os.sep + "metrics" + os.sep in path:
            assert PROGRAM not in top_level_imports(path), path


def test_whole_names_are_compared():
    """The program's name begins with the JAX package's; only whole
    top-level names count."""
    sys.modules.setdefault("nextgenmap_tpu_torch_lookalike", sys)
    try:
        assert "nextgenmap_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["nextgenmap_tpu_torch_lookalike"]


def test_a_run_process_loads_no_jax():
    """The harness, the program and a tiny run in a fresh interpreter leave
    no forbidden module in sys.modules."""
    code = (
        "import sys, time, torch; sys.path[:0] = [%r, %r]\n"
        "from conftest import tiny_cell\n"
        "from ngmb import harness\n"
        "p = harness.import_program()\n"
        "r = harness.run_cell(tiny_cell('chr20_se150.wgs'), 3, 0.01, False,"
        " torch.device('cpu'), p, time.time())\n"
        "assert r['correct'], r\n"
        "print(harness.forbidden_modules())\n"
    ) % (BENCH, os.path.join(BENCH, "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "ngm_bench/run.py", "--workload", "chr20_se150.wgs",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=manifest.ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_in_a_bare_directory_fails(tmp_path):
    """A directory with only BENCHMARK.json and ngm_bench/ holds no
    program: the run exits non-zero with no result (here already at the
    card check, on the card at the program's import)."""
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "ngm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "ngm_bench/run.py", "--workload", "chr20_se150.wgs",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # the program this process holds is not the bare directory's
    try:
        with pytest.raises(ImportError):
            harness.import_program(str(tmp_path))
    finally:
        sys.path.remove(str(tmp_path))
