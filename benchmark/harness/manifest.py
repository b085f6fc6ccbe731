"""The manifest (``BENCHMARK.json``) and the files a cell names.

A cell names a configuration (``configs[].file``) and a traffic mix; the mix
is ``traffic/<traffic>.json``, which names its driver
(``drivers/<driver>.py``); the limits of the comparison that decides
``correct`` are ``limits/<cell>.json``; a per-layer metric ``<name>`` is read
by ``metrics/<name>.py``; ``held_out.json`` holds cells left out of the
manifest, which run by name all the same. Everything is found by name, so
a later change adds a cell, a mix, a configuration or a metric as new
files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
HELD_OUT = os.path.join(BENCH_DIR, "held_out.json")


def load_module(path, name):
    """Import the file ``path`` as a module named ``name`` (file names may
    hold dots, so they are loaded by path, not by import name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    manifest: dict = field(repr=False)

    def driver(self):
        path = os.path.join(BENCH_DIR, "drivers", f"{self.traffic['driver']}.py")
        return load_module(path, f"bench_driver_{self.traffic['driver']}")

    def reader(self, metric):
        path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
        return load_module(path, f"bench_metric_{metric.replace('.', '_')}")


def _reports(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def held_out_cells():
    """The cells of ``held_out.json`` by name: defined and tested here, left
    out of ``BENCHMARK.json`` (PERF.md says why); each entry holds the
    metric entries it reports, as ``BENCHMARK.json`` would."""
    return {w["name"]: w for w in _read_json(HELD_OUT)["workloads"]}


def load_cell(workload, root=ROOT):
    """Resolve the cell ``workload`` of ``root``'s manifest (or of
    ``held_out.json``) into its configuration, traffic mix, limits and
    metrics."""
    manifest = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload in cells:
        entry = cells[workload]
        end_to_end = [m for m in manifest["end_to_end"] if _reports(m, workload)]
        reported = {m["name"] for m in end_to_end}
        per_layer = [m for m in manifest["per_layer"]
                     if _reports(m, workload) and m["moves"] in reported]
    else:
        held = held_out_cells()
        if workload not in held:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}, "
                           f"nor held out: {sorted(held)}")
        entry = held[workload]
        end_to_end, per_layer = entry["end_to_end"], entry["per_layer"]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _read_json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = _read_json(os.path.join(BENCH_DIR, "traffic", f"{entry['traffic']}.json"))
    limits = _read_json(os.path.join(BENCH_DIR, "limits", f"{workload}.json"))
    return Cell(workload, entry["chips"], config, traffic, limits, end_to_end, per_layer,
                manifest)
