"""The port stands alone: it imports neither JAX nor the JAX package (nor
pandas, nor PyYAML outside the lazy reader of user config files), runs on
the card unless the caller asks for the CPU, and ``chip_smoke.py`` refuses
to run where there is no card or no package beside it.
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
FORBIDDEN = ("jax", "jaxlib", "pandas", "yaml", "recbole_fairrec_tpu")
# the one allowed lazy import: PyYAML for user config files
LAZY_YAML = ("config/configurator.py", "_load_user_yaml")


def _port_sources():
    for dirpath, _, files in os.walk(PACKAGE_DIR):
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
    assert not roots & {"jax", "jaxlib", "pandas", "yaml", "recbole_fairrec_tpu"}


_SERVE_SCRIPT = r"""
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
import recbole_fairrec_tpu_torch
work = sys.argv[2]
root = chip_smoke.write_dataset(work + "/data", n_users=60, n_items=80, n_inter=1500)
launches, trainer, test_data = chip_smoke.serve(root, work, {"use_gpu": False})
assert trainer._last_eval_path == "fused", trainer._last_eval_path
assert str(trainer.device) == "cpu"
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "pandas", "yaml", "recbole_fairrec_tpu"))
print("LEAKED", leaked)
"""


def test_serving_path_runs_without_jax(tmp_path):
    """The tiny serving path (chip_smoke's, on the CPU) in a fresh
    interpreter: afterwards no JAX, JAX-package, pandas or yaml module is
    loaded."""
    proc = subprocess.run(
        [sys.executable, "-c", _SERVE_SCRIPT, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout, proc.stdout[-2000:]
    assert "streaming" in proc.stdout and "dense" in proc.stdout


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
