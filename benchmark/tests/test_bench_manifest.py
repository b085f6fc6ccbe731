"""Every cell of BENCHMARK.json resolves its configuration, traffic, driver,
limits and metric readers by name, and the manifest keeps the contract's
shapes."""

import json
import os
import re

import pytest

from harness import manifest

MANIFEST = json.load(open(os.path.join(manifest.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
HELD_OUT = sorted(manifest.held_out_cells())


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51


@pytest.mark.parametrize("workload", CELLS + HELD_OUT)
def test_cell_resolves(workload):
    cell = manifest.load_cell(workload)
    driver = cell.driver()
    for hook in ("setup", "window", "end_to_end", "check"):
        assert callable(getattr(driver, hook)), hook
    assert cell.limits, "a cell compares at least one number"
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    assert cell.chips == 1


def test_names_units_and_entries():
    names = [c["name"] for c in MANIFEST["configs"]] + CELLS + \
        [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names)) or len(set(CELLS)) == len(CELLS)
    for name in names:
        assert NAME.match(name), name
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    reported = {m["name"]: set(m.get("workloads", CELLS)) for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m["workloads"]) <= reported[m["moves"]], m["name"]
    for c in MANIFEST["configs"]:
        path = os.path.join(manifest.ROOT, c["file"])
        assert c["file"].startswith("benchmark/") and os.path.exists(path)
        assert json.load(open(path))["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_full_check_fits_the_day():
    # 2 + 14 runs a cell, each run_seconds + 60, 2 x 90 s compile a cell,
    # 1,200 s spare, with the full 24 cells
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("workload", HELD_OUT)
def test_held_out_cell_matches_the_manifest(workload):
    """A held-out cell is not in BENCHMARK.json, uses one of its
    configurations, and reports metrics whose entries agree with the
    manifest's entries of the same name (bound and cells aside), so that
    re-admitting it is adding entries."""
    assert workload not in CELLS
    entry = manifest.held_out_cells()[workload]
    assert entry["config"] in {c["name"] for c in MANIFEST["configs"]}
    assert NAME.match(workload) and entry["chips"] == 1
    known = {m["name"]: m for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]}
    assert any(m["name"] == "setup_s" for m in entry["end_to_end"])
    for m in entry["end_to_end"] + entry["per_layer"]:
        assert "bound" not in m and "workloads" not in m, m
        assert NAME.match(m["name"]) and re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        if m["name"] in known:
            mine = {k: v for k, v in known[m["name"]].items() if k not in ("bound", "workloads")}
            assert m == mine, m["name"]
    reported = {m["name"] for m in entry["end_to_end"]}
    assert all(m["moves"] in reported for m in entry["per_layer"])
