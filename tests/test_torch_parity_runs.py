"""The port's whole-run parity runner against the repository's.

``recbole_fairrec_tpu_torch/scripts/parity_runs.py`` keeps its own copy of
``scripts/parity_runs.py``'s protocol and criterion. Here the copies equal
the originals; the config file it writes is, byte for byte, the original's;
both packages' ``Config`` resolve it to the same values; its comparer,
fed the JAX package's records as the port's side, gives the original's
means, p values and verdicts and PARITY_RUNS.md's rows; and short whole runs
on the CPU (1 epoch; FairGo 1 pretrain + 1 finetune) write records of the
JAX records' nested form.
"""

import enum
import glob
import importlib.util
import json
import math
import os

import pytest

from recbole_fairrec_tpu.config import Config as JaxConfig

from recbole_fairrec_tpu_torch.config import Config
from recbole_fairrec_tpu_torch.scripts import parity_runs as port

from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["FOCF", "NFCF", "FairGo_PMF", "PFCN_PMF_sm_ga"]
COMPARED = ["FOCF", "NFCF", "FairGo_PMF"]


def _load_original():
    spec = importlib.util.spec_from_file_location(
        "scripts_parity_runs", os.path.join(REPO, "scripts", "parity_runs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


orig = _load_original()


def _extra(run_key, tmp_path):
    return {"pretrain_path": str(tmp_path / "pre" / "NFCF-1.pth")} if run_key == "NFCF" else None


# ------------------------------------------------------------------ (a) copies

@pytest.mark.parametrize("name", ["HEADLINE", "BASE_CFG", "SEEDS", "DATASET"])
def test_protocol_constant_equals_the_original(name):
    assert getattr(port, name) == getattr(orig, name)


def test_model_cfg_equals_the_original():
    assert list(port.MODEL_CFG) == list(orig.MODEL_CFG)
    for key, text in orig.MODEL_CFG.items():
        assert port.MODEL_CFG[key] == text, key


def test_explained_equals_the_original():
    assert port.EXPLAINED == orig.EXPLAINED
    for model in list(orig.MODEL_CFG) + ["FairGo_PMF_sb"]:
        for metric in orig.HEADLINE:
            assert port._is_explained(model, metric) == orig._is_explained(model, metric)


def test_model_name_equals_the_original_over_every_run_key():
    for key in list(orig.MODEL_CFG) + ["FairGo_PMF_sb"]:
        assert port._model_name(key) == orig._model_name(key), key


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("run_key", FAMILIES)
def test_config_file_byte_for_byte(run_key, device, tmp_path):
    """The card's file is the original's for an accelerator (``tpu``), the
    CPU's the original's for the CPU."""
    ckpt = str(tmp_path / "ckpt")
    mine = port._write_cfg(run_key, 2020, ckpt, _extra(run_key, tmp_path), device)
    theirs = orig._write_cfg(run_key, "ours", 2020, ckpt, _extra(run_key, tmp_path),
                             device="tpu" if device == "cuda" else "cpu")
    assert os.path.basename(mine) == f"{run_key}_torch_2020.yaml"
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_bf16prop_is_fairgo_pmf_with_bfloat16_propagation(tmp_path):
    mine = port._write_cfg("FairGo_PMF_bf16prop", 2021, str(tmp_path / "a"), device="cuda")
    theirs = orig._write_cfg("FairGo_PMF", "ours", 2021, str(tmp_path / "a"), device="tpu")
    with open(mine) as a, open(theirs) as b:
        assert a.read() == b.read() + "propagation_dtype: bfloat16\n"
    assert port._model_name(port._parent_run("FairGo_PMF_bf16prop")) == "FairGo_PMF"


# ------------------------------------------------------------------ (b) Config

def _plain(value):
    """Config values with each package's enums reduced to (class name, value)."""
    if isinstance(value, enum.Enum):
        return (type(value).__name__, value.value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


@pytest.mark.parametrize("run_key", FAMILIES + ["FairGo_PMF_bf16prop"])
def test_config_resolves_as_in_the_jax_package(run_key, tmp_path):
    """Both packages read the same keys, and each resolves to the same value
    from the run's file (the CPU's; the card's differs only in ``use_gpu``)
    but the device and the paths."""
    path = port._write_cfg(run_key, 2020, str(tmp_path / "ckpt"), _extra(run_key, tmp_path),
                           "cpu")
    model = port._model_name(port._parent_run(run_key))
    jc = JaxConfig(model=model, dataset=port.DATASET, config_file_list=[path]).final_config_dict
    tc = Config(model=model, dataset=port.DATASET, config_file_list=[path]).final_config_dict
    skip = {"device", "backend", "use_gpu", "data_path", "checkpoint_dir", "log_root"}
    assert set(jc) == set(tc)
    shared = set(jc) - skip
    assert {k: _plain(tc[k]) for k in shared} == {k: _plain(jc[k]) for k in shared}
    if run_key == "FairGo_PMF_bf16prop":
        assert tc["propagation_dtype"] == jc["propagation_dtype"] == "bfloat16"


# ------------------------------------------------------------------ (c) criterion

def _original_rows(model):
    """(metric, tag, rv, ov) as scripts/parity_runs.py's report() forms them."""
    ours = port.load_records(port.JAX_RUNS_DIR, "ours")[model]
    ref = [p for p in port.load_records(port.JAX_RUNS_DIR, "ref")[model] if p["device"] == "cpu"]
    sb = port.load_records(port.JAX_RUNS_DIR, "ref").get(f"{model}_sb", [])
    out = []
    for metric in orig.HEADLINE:
        src, tag = ref, ""
        if sb and any(s in metric for s in ("Value Unfairness", "Absolute Unfairness",
                                            "Underestimation Unfairness")):
            src, tag = sb, "*sb"
        rv = [orig._flat_test_result(p).get(metric) for p in src]
        ov = [orig._flat_test_result(p).get(metric) for p in ours]
        rv = [v for v in rv if v is not None and v == v]
        ov = [v for v in ov if v is not None and v == v]
        if rv and ov:
            out.append((metric, tag, rv, ov))
    return ref, ours, sb, out


@pytest.mark.parametrize("model", COMPARED)
def test_comparer_equals_the_original_criterion(model):
    ref, ours, sb, expected = _original_rows(model)
    rows = [r for r in port.compare(ref, ours, explain_model=model, sb_runs=sb or None)
            if "nan" not in r]
    assert [(r["metric"], r["tag"]) for r in rows] == [(m, t) for m, t, _, _ in expected]
    for row, (metric, _, rv, ov) in zip(rows, expected):
        assert row["yard"] == rv and row["torch"] == ov
        assert row["yard_mean_sd"] == orig._mean_sd(rv)
        assert row["torch_mean_sd"] == orig._mean_sd(ov)
        p_val = orig._rank_sum_p(rv, ov)
        assert row["p"] == p_val
        delta = abs(orig._mean_sd(rv)[0] - orig._mean_sd(ov)[0])
        assert row["delta"] == delta
        # scripts/parity_runs.py's verdict rule
        p_floor = 2.0 / math.comb(len(rv) + len(ov), len(rv))
        if p_val >= 0.05 or delta <= 0.01:
            want = "PASS (desc.)" if p_floor > 0.05 and delta > 0.01 else "PASS"
        elif orig._is_explained(model, metric):
            want = "EXPLAINED"
        else:
            want = "DIVERGENT"
        assert row["verdict"] == want, metric


@pytest.mark.parametrize("model", COMPARED)
def test_comparer_rows_are_parity_runs_md_rows(model):
    """Each row, formatted, is the line PARITY_RUNS.md has for it."""
    with open(os.path.join(REPO, "PARITY_RUNS.md"), encoding="utf-8") as f:
        text = f.read()
    section = text.split(f"\n## {model}  (seeds:")[1].split("\nmean wall-clock")[0]
    table = [line for line in section.splitlines() if line.startswith("| ")][1:]
    ref, ours, sb, _ = _original_rows(model)
    rows = port.compare(ref, ours, explain_model=model, sb_runs=sb or None)
    assert [port.format_row(r) for r in rows] == table


def test_no_row_against_the_jax_package_reads_explained():
    """The same failing sample against the JAX package reads DIVERGENT, where
    against the reference it reads EXPLAINED."""
    low, high = [0.001, 0.002, 0.001, 0.003, 0.002], [0.4, 0.5, 0.45, 0.41, 0.48]
    assert port.verdict(low, high, explained=True)[2] == "EXPLAINED"
    assert port.verdict(low, high)[2] == "DIVERGENT"
    runs = [{"test_result": {"ndcg@5": v}} for v in low]
    others = [{"test_result": {"ndcg@5": v}} for v in high]
    assert port.compare(runs, others)[0]["verdict"] == "DIVERGENT"
    assert port.compare(runs, others, explain_model="FairGo_PMF")[0]["verdict"] == "DIVERGENT"
    assert port.compare(runs, others, explain_model="PFCN_PMF_sm_ga")[0]["verdict"] == "EXPLAINED"


def test_report_holds_pfcn_against_ours_subset_by_subset(tmp_path):
    """The JAX package's own PFCN_PMF_sm_ga, FOCF and FairGo_PMF records as
    the port's: one torch-against-ours table per subset for PFCN, every
    row PASS with Δ 0, no EXPLAINED row against the JAX package."""
    runs_dir = tmp_path / "runs"
    runs_dir.mkdir()
    for name in ("PFCN_PMF_sm_ga_ours_*_tpu", "FOCF_ours_*", "FairGo_PMF_ours_*_tpu"):
        for path in glob.glob(os.path.join(port.JAX_RUNS_DIR, name + ".json")):
            with open(path) as f:
                p = json.load(f)
            p.update(framework="torch", card="test", valid_curve=[0.1], epochs_trained=1)
            (runs_dir / os.path.basename(path)).write_text(json.dumps(p))
    out = tmp_path / "PARITY_TORCH.md"
    assert port.report(str(runs_dir), port.JAX_RUNS_DIR, str(out)) == []
    text = out.read_text()
    for sub in ("sm-['gender']", "sm-['age']", "sm-['gender', 'age']"):
        assert f"#### torch against ours: subset `{sub}`" in text
    for section in text.split("#### ")[1:]:
        if section.startswith("torch against ours"):
            rows = [line for line in section.splitlines() if line.startswith("| ")][2:]
            assert rows and all(line.endswith("| 0.0000 | 1.000 | PASS |") for line in rows)
    assert "#### torch against ref" in text


# ------------------------------------------------------------------ (d) whole runs

def _shape(result):
    """Keys of a test result, nested one level for PFCN's subsets."""
    return {k: sorted(v) if isinstance(v, dict) else None for k, v in result.items()}


@pytest.fixture(scope="module")
def short_runs(tmp_path_factory):
    """run_one on the CPU for each family, 1 epoch (FairGo 1 + 1)."""
    root = tmp_path_factory.mktemp("parity_torch")
    records = {}
    for run_key in FAMILIES:
        overrides = {"epochs": 1, "log_root": str(root / "log")}
        if run_key == "FairGo_PMF":
            overrides["pretrain_epochs"] = 1
        records[run_key] = port.run_one(run_key, 2020, "cpu", str(root), overrides)
    return root, records


@pytest.mark.parametrize("run_key", FAMILIES)
def test_short_run_record_has_the_jax_records_form(short_runs, run_key):
    root, records = short_runs
    rec = records[run_key]
    with open(os.path.join(port.JAX_RUNS_DIR, f"{run_key}_ours_2020"
                           + ("_tpu" if run_key in ("FairGo_PMF", "PFCN_PMF_sm_ga") else "")
                           + ".json")) as f:
        jax_rec = json.load(f)
    assert set(jax_rec) <= set(rec)
    assert (rec["run"], rec["framework"], rec["seed"], rec["device"]) == (
        run_key, "torch", 2020, "cpu")
    assert _shape(rec["test_result"]) == _shape(jax_rec["test_result"])
    assert sorted(rec["best_valid_result"]) == sorted(jax_rec["best_valid_result"])
    assert rec["card"] is None and rec["torch"]
    assert rec["epochs_trained"] == 1 and len(rec["valid_curve"]) == 1
    assert rec["best_valid_score"] == rec["valid_curve"][0]
    if run_key == "FairGo_PMF":
        assert rec["pretrain_epochs_trained"] == 1 and len(rec["pretrain_valid_curve"]) == 1
        assert any(k.startswith("pretrain-") for k in rec["test_result"])
        assert any(k.startswith("finetune-") for k in rec["test_result"])
    with open(os.path.join(root, f"{run_key}_torch_2020.json")) as f:
        assert json.load(f) == json.loads(json.dumps(rec))


def test_nfcf_finetunes_from_its_own_pretrain(short_runs):
    root, records = short_runs
    pre = os.path.join(root, "NFCF_pre_torch_2020.json")
    assert os.path.exists(pre)
    ckpts = glob.glob(os.path.join(root, "ckpt", "NFCF_pre_torch_2020", "NFCF-*.pth"))
    assert len(ckpts) == 1
    with open(os.path.join(root, "ckpt", "NFCF_torch_2020", "NFCF_torch_2020.yaml")) as f:
        assert f"load_pretrain_path: '{ckpts[0]}'" in f.read()


def test_matrix_skips_records_that_exist(short_runs, capsys):
    root, _ = short_runs
    assert port.run_matrix(["FOCF"], [2020], "cpu", str(root)) == []
    assert "[parity] skip FOCF_torch_2020 (exists)" in capsys.readouterr().out


# ------------------------------------------------------- chip_smoke's phase

def _phase_with(monkeypatch, record, returncode=0):
    """chip_smoke.parity_run with its child process replaced by one that printed
    ``record``; returns the phase's result."""
    import subprocess
    import sys

    sys.path.insert(0, REPO)
    import chip_smoke

    def fake_run(cmd, **kwargs):
        assert cmd[1:7] == ["-m", "recbole_fairrec_tpu_torch.scripts.parity_runs", "--run",
                            "FOCF", "--seed", "2020"] and cmd[7] == "--out"
        out = f"[parity] record {json.dumps(record)}\n"
        return subprocess.CompletedProcess(cmd, returncode, out, "")

    monkeypatch.setattr(subprocess, "run", fake_run)
    return chip_smoke.parity_run("NVIDIA H100 80GB HBM3, 700.00 W")


def test_chip_smoke_parity_phase_accepts_a_whole_record(short_runs, monkeypatch, capsys):
    rec = dict(short_runs[1]["FOCF"], card="NVIDIA H100 80GB HBM3, 700.00 W")
    assert _phase_with(monkeypatch, rec) == {"fused_topk": 0}
    assert "parity: FOCF seed 2020 in " in capsys.readouterr().out


@pytest.mark.parametrize("fault", ["card", "nan", "missing", "rc"])
def test_chip_smoke_parity_phase_fails(short_runs, monkeypatch, fault):
    rec = json.loads(json.dumps(dict(short_runs[1]["FOCF"],
                                     card="NVIDIA H100 80GB HBM3, 700.00 W")))
    if fault == "card":
        rec["card"] = None
    elif fault == "nan":
        rec["test_result"]["ndcg@5"] = float("nan")
    elif fault == "missing":
        del rec["test_result"]["NonParity Unfairness of sensitive attribute gender"]
    with pytest.raises(SystemExit):
        _phase_with(monkeypatch, rec, returncode=1 if fault == "rc" else 0)


def test_chip_smoke_main_runs_the_parity_phase():
    """``main`` calls the phase, and no name it assigns hides a function of
    the module (a local ``parity`` once hid the phase's function)."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    funcs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    assigned = {x.id for n in ast.walk(main) if isinstance(n, ast.Assign)
                for target in n.targets for x in ast.walk(target) if isinstance(x, ast.Name)}
    called = {n.func.id for n in ast.walk(main)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    assert "parity_run" in called
    assert not assigned & funcs


def _phase_run_with(monkeypatch, run, record):
    """chip_smoke.parity_run for ``run`` with its child process replaced by
    one that printed ``record``; returns the phase's result."""
    import subprocess
    import sys

    sys.path.insert(0, REPO)
    import chip_smoke

    def fake_run(cmd, **kwargs):
        assert cmd[1:7] == ["-m", "recbole_fairrec_tpu_torch.scripts.parity_runs", "--run",
                            run[0], "--seed", str(run[1])] and cmd[7] == "--out"
        return subprocess.CompletedProcess(cmd, 0, f"[parity] record {json.dumps(record)}\n", "")

    monkeypatch.setattr(subprocess, "run", fake_run)
    return chip_smoke.parity_run("NVIDIA H100 80GB HBM3, 700.00 W", run)


def _cm_refbn_record():
    """The JAX package's PFCN_PMF_cm_refbn record of seed 2020 as the port's
    from the card: a test result nested under its one subset."""
    with open(os.path.join(port.JAX_RUNS_DIR, "PFCN_PMF_cm_refbn_ours_2020.json")) as f:
        rec = json.load(f)
    rec.update(framework="torch", device="cuda", card="NVIDIA H100 80GB HBM3, 700.00 W",
               epochs_trained=30, valid_curve=[0.1], launches={"fused_topk": 0})
    return rec


def test_chip_smoke_parity_phase_runs_focf_then_pfcn_cm_refbn():
    import sys

    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke.PARITY_RUNS == (("FOCF", 2020), ("PFCN_PMF_cm_refbn", 2020))
    assert chip_smoke.parity_run.__defaults__ == (("FOCF", 2020),)
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        assert "for run in PARITY_RUNS:\n        for name, n in parity_run(card, run)" in f.read()


def test_chip_smoke_parity_phase_flattens_a_pfcn_record(monkeypatch, capsys):
    rec = _cm_refbn_record()
    assert list(rec["test_result"]) == ["cm-['gender']"]
    assert _phase_run_with(monkeypatch, ("PFCN_PMF_cm_refbn", 2020), rec) == {"fused_topk": 0}
    out = capsys.readouterr().out
    assert "parity: PFCN_PMF_cm_refbn seed 2020 in " in out
    assert f"test ndcg@5 {rec['test_result']['cm-[' + repr('gender') + ']']['ndcg@5']}" in out


@pytest.mark.parametrize("fault", ["nan", "missing", "two_subsets"])
def test_chip_smoke_parity_phase_fails_on_a_bad_pfcn_record(monkeypatch, fault):
    rec = _cm_refbn_record()
    sub = rec["test_result"]["cm-['gender']"]
    if fault == "nan":
        sub["NonParity Unfairness of sensitive attribute gender"] = float("nan")
    elif fault == "missing":
        del sub["ndcg@5"]
    else:  # the headline subset lacks the gender rows
        rec["test_result"]["cm-['gender', 'age']"] = {k.replace("gender", "age"): v
                                                      for k, v in sub.items()}
    with pytest.raises(SystemExit):
        _phase_run_with(monkeypatch, ("PFCN_PMF_cm_refbn", 2020), rec)
