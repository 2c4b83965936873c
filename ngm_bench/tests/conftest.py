"""Shared helpers of the benchmark's tests: the harness's package on the
path, one intra-op thread, and cells cut to a size the CPU maps in
seconds."""

import copy
import os
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from ngmb import harness, manifest  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell(name: str, *, length: int = 200_000, batch: int = 64,
              megabatch: int = 2, pool: int = 4):
    """A manifest cell with its genome and batches cut for the CPU (its
    repeat families at their shares of the shorter genome)."""
    cell = manifest.find_cell(manifest.load_manifest(), name)
    c = copy.deepcopy(cell.config)
    c["genome"].update(length=length)
    c.update(batch=batch, megabatch=megabatch, pool_batches=pool)
    return cell._replace(config=c)


@pytest.fixture(scope="session")
def program():
    return harness.import_program()


@pytest.fixture
def card():
    """The card, for tests marked cuda; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
