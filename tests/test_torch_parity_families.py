"""Whole-run parity of the port for every run key of the JAX package's records.

The port's runner (``recbole_fairrec_tpu_torch/scripts/parity_runs.py``)
runs each run key at the seeds of the JAX package's ``ours`` records of it
and writes ``PARITY_TORCH.md``. Here: each of the run keys beyond FOCF,
NFCF, FairGo_PMF and PFCN_PMF_sm_ga writes the original runner's config
file and trains for a short run on the CPU into a record of the JAX
records' nested form; the report, fed the JAX package's own records as
the port's side, holds the multi-attribute PFCN keys subset by subset,
holds each ``_refbn`` key directly (no EXPLAINED row) against its parent's
reference records as PARITY_RUNS.md does, and gives FairGo_GCN a section
without a reference table; and the committed records cover every
(run key, seed) of the JAX package's and reproduce ``PARITY_TORCH.md``.
"""

import enum
import glob
import importlib.util
import json
import os
import re
import subprocess

import pytest
import torch

from recbole_fairrec_tpu.config import Config as JaxConfig

from recbole_fairrec_tpu_torch.config import Config
from recbole_fairrec_tpu_torch.scripts import parity_runs as port

from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_KEYS = ["PFCN_PMF_cm", "PFCN_PMF_sm", "PFCN_MLP", "PFCN_DMF", "PFCN_BiasedMF",
            "PFCN_PMF_cm_ga", "PFCN_MLP_ga", "FairGo_PMF_ga", "FairGo_GCN",
            "PFCN_PMF_cm_refbn", "PFCN_PMF_sm_refbn", "PFCN_DMF_refbn", "PFCN_MLP_refbn"]
REFBN = sorted(port._REFBN_PARENTS)


def _load_original():
    spec = importlib.util.spec_from_file_location(
        "scripts_parity_runs", os.path.join(REPO, "scripts", "parity_runs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


orig = _load_original()


def _jax_paths(run_key, framework="ours"):
    """The JAX package's record files of one run key and framework."""
    return sorted(p for p in glob.glob(os.path.join(port.JAX_RUNS_DIR, f"{run_key}_{framework}_*"))
                  if re.fullmatch(rf"{run_key}_{framework}_\d+(_tpu)?\.json", os.path.basename(p)))


def _jax_ours_keys():
    keys = set()
    for path in glob.glob(os.path.join(port.JAX_RUNS_DIR, "*_ours_*.json")):
        with open(path) as f:
            keys.add(json.load(f)["run"])
    return sorted(keys)


def _as_port_records(run_keys, runs_dir):
    """The JAX package's ``ours`` records of ``run_keys`` written as the port's."""
    runs_dir.mkdir(exist_ok=True)
    for run_key in run_keys:
        for path in _jax_paths(run_key):
            with open(path) as f:
                p = json.load(f)
            p.update(framework="torch", card="test", valid_curve=[0.1], epochs_trained=1)
            (runs_dir / os.path.basename(path)).write_text(json.dumps(p))


def _sections(text):
    """{run key: its section's text} of a report."""
    out = {}
    for part in text.split("\n## ")[1:]:
        out[part.split()[0]] = part
    return out


def _table_rows(section, title):
    """The data rows of the table ``#### {title}...`` in a section."""
    body = section.split(f"#### {title}")[1].split("\n#### ")[0]
    return [line for line in body.splitlines() if line.startswith("| ")][1:]


# ------------------------------------------------------------------ the matrix

def test_matrix_and_report_order_cover_every_run_key_of_the_jax_records():
    keys = _jax_ours_keys()
    assert len(keys) == 18
    assert set(port.REPORT_ORDER) == set(keys) | set(port.PORT_RUNS)
    # NFCF trains NFCF_pre first
    assert set(port.MATRIX) == set(keys) - {"NFCF_pre"} | set(port.PORT_RUNS)
    assert len(port.MATRIX) == len(set(port.MATRIX))


@pytest.mark.parametrize("run_key", NEW_KEYS + ["FairGo_PMF_bf16prop", "NFCF_pre"])
def test_seeds_are_the_jax_records_seeds(run_key):
    want = sorted(int(re.search(r"_ours_(\d+)", os.path.basename(p)).group(1))
                  for p in _jax_paths(port._parent_run(run_key)))
    assert port.jax_seeds(run_key) == want
    assert want == (list(range(2020, 2030)) if run_key == "PFCN_MLP_refbn" else port.SEEDS)


def test_matrix_runs_each_key_at_its_own_seeds(tmp_path, monkeypatch):
    calls = []

    def fake_call(cmd, **kwargs):
        calls.append((cmd[cmd.index("--run") + 1], int(cmd[cmd.index("--seed") + 1])))
        return 0

    monkeypatch.setattr(subprocess, "call", fake_call)
    (tmp_path / "PFCN_MLP_refbn_torch_2027.json").write_text("{}")
    assert port.run_matrix(["PFCN_MLP_refbn", "FairGo_GCN"], None, "cpu", str(tmp_path)) == []
    assert calls == ([("PFCN_MLP_refbn", s) for s in range(2020, 2030) if s != 2027]
                     + [("FairGo_GCN", s) for s in range(2020, 2025)])


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("run_key", NEW_KEYS)
def test_config_file_byte_for_byte(run_key, device, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    mine = port._write_cfg(run_key, 2020, ckpt, None, device)
    theirs = orig._write_cfg(run_key, "ours", 2020, ckpt, None,
                             device="tpu" if device == "cuda" else "cpu")
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def _plain(value):
    """Config values with each package's enums reduced to (class name, value)."""
    if isinstance(value, enum.Enum):
        return (type(value).__name__, value.value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


@pytest.mark.parametrize("run_key", NEW_KEYS)
def test_config_resolves_as_in_the_jax_package(run_key, tmp_path):
    path = port._write_cfg(run_key, 2020, str(tmp_path / "ckpt"), None, "cpu")
    model = port._model_name(run_key)
    jc = JaxConfig(model=model, dataset=port.DATASET, config_file_list=[path]).final_config_dict
    tc = Config(model=model, dataset=port.DATASET, config_file_list=[path]).final_config_dict
    skip = {"device", "backend", "use_gpu", "data_path", "checkpoint_dir", "log_root"}
    assert set(jc) == set(tc)
    shared = set(jc) - skip
    assert {k: _plain(tc[k]) for k in shared} == {k: _plain(jc[k]) for k in shared}
    assert tc["reference_bn_eval_emulation"] is (run_key in port._REFBN_PARENTS)


# ------------------------------------------------------------------ short runs

def _shape(result):
    """Keys of a test result, nested one level for PFCN's subsets."""
    return {k: sorted(v) if isinstance(v, dict) else None for k, v in result.items()}


@pytest.fixture(scope="module")
def small_fair(tmp_path_factory):
    """ml-100k-fair cut to its first 200 users (19,747 ratings; both
    genders and all seven age buckets), under the same name, as a
    ``data_path`` for short runs."""
    root = tmp_path_factory.mktemp("data")
    src = os.path.join(REPO, "dataset", port.DATASET)
    (root / port.DATASET).mkdir()
    for suffix in ("inter", "user"):
        with open(os.path.join(src, f"{port.DATASET}.{suffix}")) as f:
            header, *rows = f.read().splitlines()
        kept = [row for row in rows if int(row.split("\t")[0]) <= 200]
        (root / port.DATASET / f"{port.DATASET}.{suffix}").write_text(
            "\n".join([header] + kept) + "\n")
    return str(root)


@pytest.fixture
def one_thread():
    """One intra-op thread for a whole run: these runs are many small ops,
    and a test worker that takes every core for them starves the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("run_key", NEW_KEYS)
def test_short_run_record_has_the_jax_records_form(run_key, tmp_path, small_fair, one_thread):
    """``run_one`` on the CPU, 1 epoch (FairGo 1 + 1) on ml-100k-fair's first
    200 users: the record has every key of the JAX record and its test
    result's nested shape."""
    overrides = {"epochs": 1, "log_root": str(tmp_path / "log"), "data_path": small_fair}
    fairgo = run_key.startswith("FairGo")
    if fairgo:
        overrides["pretrain_epochs"] = 1
    rec = port.run_one(run_key, 2020, "cpu", str(tmp_path), overrides)
    with open(_jax_paths(run_key)[0]) as f:
        jax_rec = json.load(f)
    assert set(jax_rec) <= set(rec)
    assert (rec["run"], rec["framework"], rec["seed"], rec["device"]) == (
        run_key, "torch", 2020, "cpu")
    assert _shape(rec["test_result"]) == _shape(jax_rec["test_result"])
    assert _shape(rec["best_valid_result"]) == _shape(jax_rec["best_valid_result"])
    assert rec["epochs_trained"] == 1 and len(rec["valid_curve"]) == 1
    assert rec["launches"] == {"fused_topk": 0}
    if fairgo:
        assert rec["pretrain_epochs_trained"] == 1 and len(rec["pretrain_valid_curve"]) == 1
    with open(tmp_path / f"{run_key}_torch_2020.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec))


# ------------------------------------------------------------------ the report

@pytest.fixture(scope="module")
def jax_as_port(tmp_path_factory):
    """PARITY_TORCH.md written with the JAX package's records of every run
    key as the port's: (its text, its DIVERGENT rows)."""
    root = tmp_path_factory.mktemp("report")
    _as_port_records(_jax_ours_keys(), root / "runs")
    out = root / "PARITY_TORCH.md"
    divergent = port.report(str(root / "runs"), port.JAX_RUNS_DIR, str(out))
    return out.read_text(), divergent


@pytest.mark.parametrize("run_key", ["PFCN_PMF_cm_ga", "PFCN_MLP_ga", "PFCN_PMF_sm_ga"])
def test_multi_attribute_pfcn_held_against_ours_subset_by_subset(jax_as_port, run_key):
    text, _ = jax_as_port
    section = _sections(text)[run_key]
    mode = "cm" if "_cm" in run_key else "sm"
    subsets = [f"{mode}-['age']", f"{mode}-['gender']", f"{mode}-['gender', 'age']"]
    titles = re.findall(r"#### torch against ours: subset `([^`]+)`", section)
    assert titles == subsets
    assert "#### torch against ours\n" not in section
    for sub in subsets:
        rows = _table_rows(section, f"torch against ours: subset `{sub}`")
        assert len(rows) == 12  # the age rows too
        assert all(line.endswith("| 0.0000 | 1.000 | PASS |") for line in rows)


@pytest.mark.parametrize("run_key", REFBN)
def test_refbn_held_directly_against_the_parents_reference(jax_as_port, run_key):
    """The table against the parent's reference records has no EXPLAINED
    row and equals the JAX report's emulated-eval table row for row."""
    text, _ = jax_as_port
    parent = port._REFBN_PARENTS[run_key]
    section = _sections(text)[run_key]
    n_ref = len(port.load_records(port.JAX_RUNS_DIR, "ref")[parent])
    assert section.startswith(f"{run_key}  (torch ×{len(_jax_paths(run_key))}, ours ×"
                              f"{len(_jax_paths(run_key))}, ref of {parent} ×{n_ref})")
    rows = _table_rows(section, f"torch against ref of `{parent}`: DIRECT")
    assert rows and not any("EXPLAINED" in line for line in rows)
    with open(os.path.join(REPO, "PARITY_RUNS.md"), encoding="utf-8") as f:
        theirs = f.read().split(f"\n### {parent} — emulated-defect eval")[1]
    theirs = theirs.split("\n## ")[0].split("\n### ")[0]
    assert [line for line in rows if "NaN runs" not in line] == [
        line for line in theirs.splitlines() if line.startswith("| ")][1:]
    own = _table_rows(section, "torch against ours")
    assert own and all(line.endswith("| 0.0000 | 1.000 | PASS |") for line in own)


def test_refbn_failing_sample_reads_divergent(tmp_path):
    """A refbn sample far from the parent's reference reads DIVERGENT, where
    the parent's own rows would read EXPLAINED."""
    parent = "PFCN_PMF_cm"
    runs_dir = tmp_path / "runs"
    runs_dir.mkdir()
    for path in _jax_paths("PFCN_PMF_cm_refbn"):
        with open(path) as f:
            p = json.load(f)
        (sub,) = p["test_result"]
        p["test_result"][sub]["ndcg@5"] += 0.5
        p.update(framework="torch", card="test", valid_curve=[0.1], epochs_trained=1)
        (runs_dir / os.path.basename(path)).write_text(json.dumps(p))
    divergent = port.report(str(runs_dir), port.JAX_RUNS_DIR, str(tmp_path / "P.md"))
    title = f"torch against ref of `{parent}`: DIRECT"
    assert ("PFCN_PMF_cm_refbn", "ref", "ndcg@5") in {(k, y, m) for k, y, t, m in divergent
                                                     if t.startswith(title)}
    ref = port.load_records(port.JAX_RUNS_DIR, "ref")[parent]
    runs = port.load_records(str(runs_dir), "torch")["PFCN_PMF_cm_refbn"]
    assert port.compare(ref, runs, explain_model=parent)[0]["verdict"] == "EXPLAINED"
    assert port.compare(ref, runs)[0]["verdict"] == "DIVERGENT"


def test_fairgo_gcn_has_an_ours_only_section(jax_as_port):
    text, _ = jax_as_port
    section = _sections(text)["FairGo_GCN"]
    assert section.startswith("FairGo_GCN  (torch ×5, ours ×5, ref ×0)")
    assert "No reference records: the reference's FairGo_GCN imports `torch_geometric`" in section
    assert "torch against ref" not in section
    rows = _table_rows(section, "torch against ours")
    assert len(rows) == 10 and all(line.endswith("| PASS |") for line in rows)


def test_fairgo_pmf_ga_takes_the_small_batch_reference_values(jax_as_port):
    text, _ = jax_as_port
    section = _sections(text)["FairGo_PMF_ga"]
    rows = _table_rows(section, "torch against ref (`*sb`: small-batch values)")
    tagged = [line for line in rows if "*sb |" in line]
    assert len(tagged) == 3
    assert len(_jax_paths("FairGo_PMF_ga_sb", "ref")) == 3


def test_jax_records_as_the_port_have_no_divergent_row(jax_as_port):
    text, divergent = jax_as_port
    assert divergent == []
    assert "\n| ours | " in text and "No DIVERGENT row." in text
    assert list(_sections(text))[:-1] == [k for k in port.REPORT_ORDER
                                          if k not in port.PORT_RUNS]


# ------------------------------------------------------------------ completeness

def test_committed_records_cover_every_jax_run_and_reproduce_the_report(tmp_path):
    """Every (run key, seed) of the JAX package's ``ours`` records has a
    record of the port from the card, and ``report`` reproduces the
    committed PARITY_TORCH.md."""
    port_runs = port.load_records(port.RUNS_DIR, "torch")
    for run_key in _jax_ours_keys() + list(port.PORT_RUNS):
        seeds = [p["seed"] for p in port_runs.get(run_key, [])]
        assert seeds == port.jax_seeds(run_key), run_key
        for p in port_runs[run_key]:
            assert p["device"] == "cuda" and p["card"] and "launches" in p, (run_key, p["seed"])
    out = tmp_path / "PARITY_TORCH.md"
    port.report(port.RUNS_DIR, port.JAX_RUNS_DIR, str(out))
    with open(port.REPORT, encoding="utf-8") as f:
        assert out.read_text() == f.read()
