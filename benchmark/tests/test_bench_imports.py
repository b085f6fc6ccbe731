"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port, ``recbole_fairrec_tpu_torch``, is allowed),
nor the repository's older measurement scripts; the references import
nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

from harness import device, manifest

SOURCES = sorted(glob.glob(os.path.join(manifest.BENCH_DIR, "**", "*.py"), recursive=True))
OLD_SCRIPTS = {"bench", "bench_torch", "chip_smoke", "kernel_sweep"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_forbidden_names_compare_whole_top_level_names():
    names = ["recbole_fairrec_tpu_torch", "recbole_fairrec_tpu_torch.ops", "jaxtyping",
             "numpy", "recbole_fairrec_tpu", "recbole_fairrec_tpu.data", "jax.numpy", "flax"]
    assert device.forbidden_modules(names) == ["flax", "jax.numpy", "recbole_fairrec_tpu",
                                               "recbole_fairrec_tpu.data"]


def test_sources_name_no_forbidden_module():
    for path in SOURCES:
        tops = set(_imports(path))
        assert not tops & set(device.FORBIDDEN), path
        assert not tops & OLD_SCRIPTS, path
        if os.sep + "reference" + os.sep in path:
            assert "recbole_fairrec_tpu_torch" not in tops, path


def test_a_run_loads_no_jax():
    code = (
        "import sys, glob, os\n"
        f"sys.path[:0] = [{manifest.BENCH_DIR!r}, {manifest.ROOT!r}]\n"
        "from harness import device, manifest, runner, pfcn\n"
        "import recbole_fairrec_tpu_torch, recbole_fairrec_tpu_torch.trainer\n"
        "names = [c['name'] for c in manifest.load_cell('bprmf-catalog2m.train')"
        ".manifest['workloads']]\n"
        "for name in names + sorted(manifest.held_out_cells()):\n"
        "    cell = manifest.load_cell(name); cell.driver()\n"
        "    [cell.reader(m['name']) for m in cell.per_layer]\n"
        "import reference.mf_train, reference.topk, reference.uni100\n"
        "print(device.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
