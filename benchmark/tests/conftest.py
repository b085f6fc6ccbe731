"""CPU tests of the benchmark. Run from the root of a checkout:

    python -m pytest -q benchmark/tests

Tests marked ``card`` need an NVIDIA card and skip without one (the test
decides, not the module's import).
"""

import os
import sys
import tempfile

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


TINY_USERS = 60


@pytest.fixture
def tiny_user_file(tmp_path):
    """The first users of the configuration's user file."""
    with open(os.path.join(BENCH, "configs", "ml-1M.user")) as f:
        lines = f.read().splitlines()[:TINY_USERS + 1]
    path = tmp_path / "tiny.user"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture
def tiny_cell(tiny_user_file):
    """``tiny_cell(workload)``: the manifest's cell at a size the CPU runs
    in seconds (widths of the catalog cut too: this is a test of the
    harness, not a measurement)."""
    from harness import manifest

    def make(workload):
        cell = manifest.load_cell(workload)
        if "data" in cell.config:
            cell.config["data"].update({"user_file": tiny_user_file, "n_users": TINY_USERS,
                                        "n_items": 200, "n_inter": 2500})
            cell.config["settings"]["train_batch_size"] = 256
        else:
            cell.config.update({"n_users": 300, "n_items": 5000, "train_batch_size": 512})
            cell.config["settings"]["embedding_size"] = 16
        cell.traffic.update({"trace_seconds": 0.5, "sample_from": 32, "sample_requests": 8})
        return cell

    return make


@pytest.fixture
def execute(tmp_path):
    """``execute(cell, seed, seconds=0.5, calibrate=False)`` on the CPU."""
    import time

    import torch

    from harness import runner

    def go(cell, seed, seconds=0.5, trace=False, calibrate=False):
        work = tempfile.mkdtemp(dir=tmp_path)
        return runner.execute(cell, seed, seconds, trace, torch.device("cpu"), work,
                              time.perf_counter(), calibrate=calibrate)

    return go
