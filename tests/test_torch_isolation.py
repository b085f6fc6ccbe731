"""The port stands alone: it imports neither JAX nor the JAX package (nor
pandas, nor PyYAML outside the lazy reader of user config files), runs on
the card unless the caller asks for the CPU, and ``chip_smoke.py`` refuses
to run where there is no card or no package beside it, and refuses a
trainer that landed on the CPU.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from recbole_fairrec_tpu_torch import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE_DIR = os.path.join(REPO, "recbole_fairrec_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "chex", "pandas", "yaml", "recbole_fairrec_tpu")
# the one allowed lazy import: PyYAML for user config files
LAZY_YAML = ("config/configurator.py", "_load_user_yaml")


def _port_sources():
    for dirpath, dirnames, files in os.walk(PACKAGE_DIR):
        dirnames[:] = [d for d in dirnames if d != "_build"]  # build outputs, not sources
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _imported_roots(node):
    if isinstance(node, ast.Import):
        return [alias.name.split(".")[0] for alias in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        return [node.module.split(".")[0]]
    return []


def _imports_with_scope(tree):
    """(root module, enclosing function name or None) for every import."""
    out = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            scope = func
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = child.name
            for root in _imported_roots(child):
                out.append((root, scope))
            visit(child, scope)

    visit(tree, None)
    return out


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, PACKAGE_DIR))
def test_no_forbidden_import(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    rel = os.path.relpath(path, PACKAGE_DIR).replace(os.sep, "/")
    for root, scope in _imports_with_scope(tree):
        if root not in FORBIDDEN:
            continue
        assert (root, (rel, scope)) == ("yaml", LAZY_YAML), (
            f"{rel} imports {root} (in {scope or 'module scope'})"
        )


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    roots = {root for root, _ in _imports_with_scope(tree)}
    assert not roots & set(FORBIDDEN)


def test_new_training_modules_are_checked():
    """The modules of the training and adversarial slices are among the
    sources the import check walks."""
    rel = {os.path.relpath(p, PACKAGE_DIR).replace(os.sep, "/") for p in _port_sources()}
    assert {"ops/neg_sampling.py", "models/losses.py", "utils/loggers.py", "trainer/optim.py",
            "trainer/adversarial.py", "trainer/trainer.py", "quick_start.py",
            "models/layers.py", "models/pfcn_base.py", "models/pfcn_mlp.py",
            "models/pfcn_dmf.py", "models/pfcn_biasedmf.py", "utils/jax_params.py",
            "models/focf.py", "models/nfcf.py", "data/dataloader.py", "data/utils.py",
            "ops/eval_fused.py", "ops/spmm.py", "models/gcn.py", "models/fairgo_base.py",
            "models/fairgo_pmf.py", "models/fairgo_gcn.py"} <= rel


def test_remaining_single_device_modules_are_checked():
    """The modules of the resident-epoch and tools slice (the search, the
    case study, the URL helpers, the command line) are among the sources the
    import check walks."""
    rel = {os.path.relpath(p, PACKAGE_DIR).replace(os.sep, "/") for p in _port_sources()}
    assert {"trainer/hyper_tuning.py", "utils/case_study.py", "utils/url.py", "cli.py",
            "ops/topk.py", "scripts/__init__.py", "scripts/run_recbole.py",
            "scripts/run_hyper.py", "scripts/resume_run_recbole.py"} <= rel


def test_catalog_scale_and_surface_modules_are_checked():
    """The modules of the catalog-scale slice (the bf16 kernel's wrapper,
    retrieval, the samplers, loaders and helpers that complete the public
    surface) are among the sources the import check walks."""
    rel = {os.path.relpath(p, PACKAGE_DIR).replace(os.sep, "/") for p in _port_sources()}
    assert {"ops/fused_topk.py", "ops/topk.py", "models/layers.py", "sampler/sampler.py",
            "sampler/__init__.py", "data/dataloader.py", "data/utils.py", "data/__init__.py",
            "utils/common.py", "utils/__init__.py"} <= rel


def test_kernel_sweep_imports_no_jax():
    with open(os.path.join(REPO, "kernel_sweep.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    roots = {root for root, _ in _imports_with_scope(tree)}
    assert not roots & set(FORBIDDEN)


def test_bench_torch_imports_no_jax_nor_bench_py():
    """``bench_torch.py`` keeps its own copy of what it needs from
    ``bench.py``: it imports neither it nor JAX, the JAX package, pandas or
    PyYAML, at any scope."""
    with open(os.path.join(REPO, "bench_torch.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    roots = {root for root, _ in _imports_with_scope(tree)}
    assert "recbole_fairrec_tpu_torch" in roots
    assert not roots & (set(FORBIDDEN) | {"bench"})


_TRAIN_AND_SERVE_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
from recbole_fairrec_tpu_torch import load_data_and_model, run_recbole
work = sys.argv[2]
root = chip_smoke.write_dataset(work + "/data", n_users=60, n_items=80, n_inter=1500)
cfg = chip_smoke.train_config(root, work, {"use_gpu": False, "train_batch_size": 256})
result = run_recbole(model="PFCN_PMF", dataset=chip_smoke.DATASET, config_dict=cfg)
assert list(result["test_result"]) == ["none"], result
import glob
ckpt = glob.glob(work + "/saved/PFCN_PMF-*.pth")[0]
config, model, trainer, _, _, _, test_data = load_data_and_model(ckpt, {"use_gpu": False})
assert type(trainer).__name__ == "PFCN_PMFTrainer" and str(trainer.device) == "cpu"
assert trainer.evaluate(test_data) == result["test_result"]
assert trainer._last_eval_path == "streaming", trainer._last_eval_path
config["streaming_eval"] = False
trainer.evaluate(test_data)
assert trainer._last_eval_path == "fused", trainer._last_eval_path
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "pandas", "yaml",
                                       "recbole_fairrec_tpu"))
print("LEAKED", leaked)
"""

_ADVERSARIAL_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
from recbole_fairrec_tpu_torch import load_data_and_model, run_recbole
work = sys.argv[2]
root = chip_smoke.write_dataset(work + "/data", n_users=60, n_items=80, n_inter=1500,
                                name=chip_smoke.ADV_DATASET, attributes=True)
for model in ("PFCN_PMF", "PFCN_MLP", "PFCN_DMF", "PFCN_BiasedMF"):
    cfg = chip_smoke.adversarial_config(root, work + "/" + model, {
        "use_gpu": False, "train_batch_size": 256, "epochs": 2, "train_epoch_interval": 2,
        "save_sst_embed": False})
    result = run_recbole(model=model, dataset=chip_smoke.ADV_DATASET, config_dict=cfg)
    keys = chip_smoke._subset_keys("sm", chip_smoke.ADV_ATTRS)
    assert list(result["test_result"]) == keys, result["test_result"]
    import glob
    ckpt = glob.glob(work + "/" + model + "/saved/" + model + "-*.pth")[0]
    _, _, trainer, _, _, _, test_data = load_data_and_model(ckpt, {"use_gpu": False})
    assert type(trainer).__name__ == model + "Trainer" and str(trainer.device) == "cpu"
    assert trainer.evaluate(test_data) == result["test_result"]
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "pandas", "yaml",
                                       "recbole_fairrec_tpu"))
print("LEAKED", leaked)
"""

_PUBLISHED_SCRIPT = r"""
import glob, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
from recbole_fairrec_tpu_torch import run_recbole
work = sys.argv[2]
root = chip_smoke.write_dataset(work + "/data", n_users=60, n_items=80, n_inter=1500,
                                name=chip_smoke.ADV_DATASET, attributes=True)
runs = [("PFCN_PMF", {"filter_mode": "sm", "sst_attr_list": ["gender", "age"], "epochs": 2,
                      "save_sst_embed": False}),
        ("FOCF", {"fair_objective": "value", "epochs": 1}),
        ("NFCF", {"epochs": 1})]
for model, extra in runs:
    cfg = chip_smoke.published_config(root, work + "/" + model, model,
                                      {**extra, "use_gpu": False, "train_batch_size": 256})
    result = run_recbole(model=model, dataset=chip_smoke.ADV_DATASET, config_dict=cfg)
    tests = result["test_result"]
    for res in (tests.values() if model == "PFCN_PMF" else [tests]):
        chip_smoke._check_families(model, res, extra.get("sst_attr_list", ["gender"]))
pre = glob.glob(work + "/NFCF/saved/NFCF-*.pth")[0]
cfg = chip_smoke.published_config(root, work + "/NFCF", "NFCF", {
    "epochs": 1, "use_gpu": False, "train_batch_size": 256, "load_pretrain_path": pre})
chip_smoke._check_families("NFCF finetune", run_recbole(
    model="NFCF", dataset=chip_smoke.ADV_DATASET, config_dict=cfg)["test_result"], ["gender"])
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "pandas", "yaml",
                                       "recbole_fairrec_tpu"))
print("LEAKED", leaked)
"""

_FAIRGO_SCRIPT = r"""
import sys
for blocked in ("jax", "jaxlib", "optax", "recbole_fairrec_tpu"):
    sys.modules[blocked] = None  # importing any of them raises ImportError
sys.path.insert(0, sys.argv[1])
import chip_smoke
from recbole_fairrec_tpu_torch import load_data_and_model, run_recbole
work = sys.argv[2]
root = chip_smoke.write_dataset(work + "/data", n_users=60, n_items=80, n_inter=1500,
                                name=chip_smoke.ADV_DATASET, attributes=True)
for model in chip_smoke.FAIRGO_MODELS:
    cfg = chip_smoke.fairgo_config(root, work + "/" + model, model,
                                   {"use_gpu": False, "train_batch_size": 256})
    result = run_recbole(model=model, dataset=chip_smoke.ADV_DATASET, config_dict=cfg)
    tests = result["test_result"]
    for stage in ("pretrain", "finetune"):
        half = {k[len(stage) + 1:]: v for k, v in tests.items() if k.startswith(stage + "-")}
        chip_smoke._check_families(model + " " + stage, half, ["gender"])
    import glob
    pre = glob.glob(work + "/" + model + "/saved/*-pretrain.pth")[0]
    fine = [p for p in glob.glob(work + "/" + model + "/saved/" + model + "-*.pth")
            if p != pre and "_embed" not in p]
    _, _, trainer, _, _, _, test_data = load_data_and_model(
        fine[0], {"use_gpu": False, "pretrain_model_file_path": pre})
    assert type(trainer).__name__ == model + "Trainer" and str(trainer.device) == "cpu"
    assert trainer.model.train_stage == "finetune"
    assert list(trainer.evaluate(test_data)) == list(tests)
leaked = sorted(m for m in sys.modules
                if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "optax", "pandas", "yaml",
                                        "recbole_fairrec_tpu"))
print("LEAKED", leaked)
"""

_RESIDENT_AND_TOOLS_SCRIPT = r"""
import sys
for blocked in ("jax", "jaxlib", "optax", "recbole_fairrec_tpu"):
    sys.modules[blocked] = None  # importing any of them raises ImportError
sys.path.insert(0, sys.argv[1])
import chip_smoke
import torch
from recbole_fairrec_tpu_torch import cli, load_data_and_model, objective_function, run_recbole
from recbole_fairrec_tpu_torch.ops.topk import certified_topk_scores
from recbole_fairrec_tpu_torch.trainer.hyper_tuning import HyperTuning
from recbole_fairrec_tpu_torch.utils.case_study import full_sort_topk
work = sys.argv[2]
root = chip_smoke.write_dataset(work + "/data", n_users=60, n_items=80, n_inter=1500)
cfg = chip_smoke.train_config(root, work, {"use_gpu": False, "train_batch_size": 256,
                                           "device_epoch_shuffle": True})
result = run_recbole(model="PFCN_PMF", dataset=chip_smoke.DATASET, config_dict=cfg)
assert list(result["test_result"]) == ["none"], result
base = {**cfg, "model": "PFCN_PMF", "dataset": chip_smoke.DATASET, "epochs": 1}
hp = HyperTuning(lambda c, files: objective_function({**base, **c}, files, saved=False),
                 params_dict={"choice": {"learning_rate": [0.01, 0.002]}}, algo="exhaustive")
hp.run()
assert len(hp.params2result) == 2, hp.params2result
import glob
ckpt = glob.glob(work + "/saved/PFCN_PMF-*.pth")[0]
_, _, trainer, _, _, _, test_data = load_data_and_model(ckpt, {"use_gpu": False})
scores, items = full_sort_topk(test_data.uid_list[:4], trainer, test_data, 5)
assert items.shape == (4, 5) and (items != 0).all()
u, t = torch.randn(6, 8), torch.randn(30, 8)
s, i = certified_topk_scores(u, t, 4)
assert i.shape == (6, 4)
leaked = sorted(m for m in sys.modules
                if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "optax", "pandas", "yaml",
                                        "recbole_fairrec_tpu"))
print("LEAKED", leaked)
"""

_SCALE_AND_SURFACE_SCRIPT = r"""
import sys
for blocked in ("jax", "jaxlib", "optax", "recbole_fairrec_tpu"):
    sys.modules[blocked] = None  # importing any of them raises ImportError
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke
from recbole_fairrec_tpu_torch import Config
from recbole_fairrec_tpu_torch.data import Dataset, UserDataLoader
from recbole_fairrec_tpu_torch.data.utils import _get_AE_dataloader
from recbole_fairrec_tpu_torch.ops.topk import approx_topk_scores, certified_topk_scores
from recbole_fairrec_tpu_torch.sampler import KGSampler, SeqSampler
from recbole_fairrec_tpu_torch.utils import get_environment_info
from recbole_fairrec_tpu_torch.utils.common import get_flops_estimate
work = sys.argv[2]
root = chip_smoke.write_dataset(work + "/data", n_users=60, n_items=80, n_inter=1500)
cfg = chip_smoke.serving_config(root, work, {"use_gpu": False, "train_batch_size": 16})
config = Config(model="PFCN_PMF", dataset=chip_smoke.DATASET, config_dict=cfg)
ds = Dataset(config)
assert _get_AE_dataloader(config, "train") is UserDataLoader
users = np.concatenate([b["user_id"].numpy() for b in UserDataLoader(config, ds, None)])
assert sorted(users.tolist()) == list(range(ds.user_num))
pos = np.asarray(ds.inter_feat["item_id"])[:40]
assert (SeqSampler(ds).sample_neg_sequence(pos) != pos).all()
class KG:
    head_entity_field, tail_entity_field = "head_id", "tail_id"
    head_entities, tail_entities, entity_num = [1, 2], [2, 3], 9
assert len(KGSampler(KG()).sample_by_entity_ids([1, 2], num=3)) == 6
assert get_environment_info()["backend"] == "cpu" and get_flops_estimate(3) == 6
u, t = torch.randn(6, 16).bfloat16(), torch.randn(300, 16).bfloat16()
s, i, ok = approx_topk_scores(u, t, 4, verify=True)
assert s.dtype == torch.float32 and i.dtype == torch.int32 and bool(ok.all())
assert torch.equal(certified_topk_scores(u, t, 4)[1], i)
trainer = chip_smoke.scale_trainer(work + "/scale", 200, 400, 16, {"use_gpu": False})
batch = {k: torch.from_numpy(v).long() for k, v in chip_smoke.scale_batches(200, 400, 64)[0].items()}
assert np.isfinite(float(trainer._train_step(batch, "calculate_loss", None, trainer.optimizer)))
leaked = sorted(m for m in sys.modules
                if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "optax", "pandas", "yaml",
                                        "recbole_fairrec_tpu"))
print("LEAKED", leaked)
"""

_BENCH_SCRIPT = r"""
import sys
for blocked in ("jax", "jaxlib", "optax", "recbole_fairrec_tpu", "bench", "pandas", "yaml"):
    sys.modules[blocked] = None  # importing any of them raises ImportError
sys.path.insert(0, sys.argv[1])
import torch
import bench_torch
cpu, size = torch.device("cpu"), bench_torch.Size(60, 80, 1500, 256)
data = sys.argv[2] + "/data"
trainer, train_data, valid_data = bench_torch.build(cpu, data, size)
bench_torch.bench_train_step(trainer, train_data, cpu, size)
assert bench_torch.bench_eval(trainer, valid_data, cpu, repeats=1)["eval_variants_agree"]
bench_torch.bench_fairgo_finetune_epoch(cpu, "bfloat16", data, size, repeats=1)
bench_torch.bench_pallas_topk(cpu, (16, 512, 8, 10), repeats=1)
leaked = sorted(m for m in sys.modules
                if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "optax", "pandas", "yaml",
                                        "recbole_fairrec_tpu", "bench"))
print("LEAKED", leaked)
"""

_SERVE_ON_CPU_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
work = sys.argv[2]
root = chip_smoke.write_dataset(work + "/data", n_users=60, n_items=80, n_inter=1500)
chip_smoke.serve(root, work, {"use_gpu": False})
print("SERVED")
"""


def _run_script(script, tmp_path):
    return subprocess.run(
        [sys.executable, "-c", script, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )


def test_serving_path_runs_without_jax(tmp_path):
    """The tiny training and serving path (``run_recbole`` with chip_smoke's
    training settings, then ``load_data_and_model`` and ``evaluate`` on both
    paths, on the CPU) in a fresh interpreter: afterwards no JAX, optax,
    JAX-package, pandas or yaml module is loaded."""
    proc = _run_script(_TRAIN_AND_SERVE_SCRIPT, tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout, proc.stdout[-2000:]


def test_adversarial_path_runs_without_jax(tmp_path):
    """The four adversarial backbones (``filter_mode: sm`` over gender, age
    and occupation, chip_smoke's settings at a tiny size) through
    ``run_recbole`` and back through ``load_data_and_model`` on the CPU, in
    a fresh interpreter: afterwards no JAX, optax, JAX-package, pandas or
    yaml module is loaded."""
    proc = _run_script(_ADVERSARIAL_SCRIPT, tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout, proc.stdout[-2000:]


def test_published_protocol_runs_without_jax(tmp_path):
    """PFCN_PMF (sm over gender and age), FOCF (value) and NFCF (pretrain,
    then finetune) with their published YAMLs (uni100, the 12 metrics, the
    rating threshold), chip_smoke's configurations at a tiny size, on the
    CPU in a fresh interpreter: every metric family in every test dict, and
    afterwards no JAX, optax, JAX-package, pandas or yaml module is
    loaded."""
    proc = _run_script(_PUBLISHED_SCRIPT, tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout, proc.stdout[-2000:]


def test_fairgo_runs_with_jax_blocked(tmp_path):
    """FairGo_PMF and FairGo_GCN with their published YAMLs (chip_smoke's
    FairGo configurations at a tiny size) pretrain, finetune and read back
    on the CPU in a fresh interpreter where importing JAX, optax or the JAX
    package raises: both stages' metric families, the registry's trainers,
    and afterwards no JAX, optax, JAX-package, pandas or yaml module is
    loaded."""
    proc = _run_script(_FAIRGO_SCRIPT, tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout, proc.stdout[-2000:]


def test_resident_training_and_tools_run_with_jax_blocked(tmp_path):
    """Resident epochs through ``run_recbole`` (chip_smoke's training
    settings with ``device_epoch_shuffle`` at a tiny size), a 2-trial
    exhaustive search through ``objective_function``, the case study on the
    checkpoint read back and the certified top-k, on the CPU in a fresh
    interpreter where importing JAX, optax or the JAX package raises;
    afterwards no JAX, optax, JAX-package, pandas or yaml module is
    loaded."""
    proc = _run_script(_RESIDENT_AND_TOOLS_SCRIPT, tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout, proc.stdout[-2000:]


def test_scale_and_surface_run_with_jax_blocked(tmp_path):
    """The catalog-scale slice and the last of the public surface on the CPU
    in a fresh interpreter where importing JAX, optax or the JAX package
    raises: ``UserDataLoader`` through ``_get_AE_dataloader``,
    ``SeqSampler``, ``KGSampler``, the environment helpers, the bf16-table
    retrieval, and the scale step (chip_smoke's trainer at a tiny size);
    afterwards no JAX, optax, JAX-package, pandas or yaml module is
    loaded."""
    proc = _run_script(_SCALE_AND_SURFACE_SCRIPT, tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout, proc.stdout[-2000:]


def test_bench_torch_legs_run_with_jax_blocked(tmp_path):
    """bench_torch's pipeline, train step, both evaluation variants, the
    bf16 FairGo finetune epoch and the top-k comparison at a tiny size on
    the CPU, in a fresh interpreter where importing JAX, optax, the JAX
    package, bench.py, pandas or PyYAML raises; afterwards none is
    loaded."""
    proc = _run_script(_BENCH_SCRIPT, tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout, proc.stdout[-2000:]


def test_chip_smoke_serve_refuses_a_cpu_trainer(tmp_path):
    """A configuration that lands on the CPU must not pass the serve phase
    without the kernel."""
    proc = _run_script(_SERVE_ON_CPU_SCRIPT, tmp_path)
    assert proc.returncode != 0
    assert "SERVED" not in proc.stdout
    assert "not on the card" in proc.stderr, proc.stderr[-2000:]


def test_config_without_cuda_raises(monkeypatch, tiny_data_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="use_gpu: False"):
        Config(model="PFCN_PMF", dataset="tiny", config_dict={"data_path": tiny_data_path})
    cfg = Config(model="PFCN_PMF", dataset="tiny",
                 config_dict={"data_path": tiny_data_path, "use_gpu": False})
    assert cfg["device"] == torch.device("cpu")


def test_config_with_cuda_picks_the_card(monkeypatch, tiny_data_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = Config(model="PFCN_PMF", dataset="tiny", config_dict={"data_path": tiny_data_path})
    assert cfg["device"] == torch.device("cuda")


def _run_chip_smoke(cwd, script):
    return subprocess.run(
        [sys.executable, script], capture_output=True, text=True, timeout=300, cwd=cwd,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )


def test_chip_smoke_fails_without_a_card(tmp_path):
    proc = _run_chip_smoke(str(tmp_path), os.path.join(REPO, "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_chip_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
