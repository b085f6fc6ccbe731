"""A timed run without a card fails and prints no result: it never falls
back to the CPU. So does a run in a directory that holds only the
benchmark's own files."""

import json
import os
import shutil
import subprocess
import sys

from harness import manifest

CELLS = [w["name"] for w in json.load(open(os.path.join(manifest.ROOT, "BENCHMARK.json")))
         ["workloads"]]


def _run(root, workload, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    out = _run(manifest.ROOT, CELLS[0])
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path), CELLS[0])
    assert out.returncode != 0
    assert out.stdout.strip() == ""
