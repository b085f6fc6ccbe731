"""On the card, at each cell's own size: a run of one seed is correct, and
the control (the reference in the precision below the configuration's, in
the program's place) fails one of the cell's limits. Skips without a card.

    python -m pytest -q -m card benchmark/tests/test_bench_card.py
"""

import json
import os
import subprocess
import sys

import pytest

from harness import manifest
from harness.checks import judge

CELLS = [w["name"] for w in json.load(open(os.path.join(manifest.ROOT, "BENCHMARK.json")))
         ["workloads"]]
SECONDS = {"bprmf-catalog2m.retrieval": 8}


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no card: this test runs on the H100")
    out = subprocess.run(
        [sys.executable, "benchmark/calibrate.py", "--workload", workload, "--seconds",
         str(SECONDS.get(workload, 1)), "--seeds", str(2**31 + 77)],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = manifest.load_cell(workload).limits
    assert judge(line["program"], limits)[0], line
    for name, numbers in line["calibration"].items():
        if name.startswith("control"):
            merged = {k: numbers.get(k, 0.0) for k in limits}
            assert not judge(merged, limits)[0], (name, numbers)
