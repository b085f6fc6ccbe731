"""``bench_torch.py``, the port's counterpart of ``bench.py``, on the CPU.

The port's dataset recipe writes bench.py's rows; the output carries
bench.py's keys (read from its source) and ``device``; the modeled roofline
demands are bench.py's formulas (executed from its source); every leg runs
through the port's real trainer at a tiny size and returns finite positive
rates; the legs' checks catch a trainer that took another path; ``main``
refuses to run without a card.
"""

import ast
import math
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import bench
import bench_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TINY = bench_torch.Size(users=60, items=80, inter=1500, batch=256)
TINY_SCALE = bench_torch.ScaleSize(items=4096, dim=16, block=8, block2=32, users=512, batch=256,
                                   steps=2)


def _bench_py_tree():
    with open(os.path.join(REPO, "bench.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    return {node.name: node for node in tree.body if isinstance(node, ast.FunctionDef)}


# ----------------------------------------------------------------- dataset

@pytest.fixture(scope="module")
def both_datasets(tmp_path_factory):
    """bench.py's ``_ensure_dataset`` and the port's recipe, each into a
    directory of its own."""
    root = tmp_path_factory.mktemp("bench_data")
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    old = bench.DATA_DIR
    bench.DATA_DIR = jax_dir
    try:
        assert bench._ensure_dataset() == jax_dir
    finally:
        bench.DATA_DIR = old
    assert bench_torch.ensure_dataset(port_dir) == port_dir
    return jax_dir, port_dir


@pytest.mark.parametrize("ext", ["inter", "user"])
def test_dataset_recipe_equals_bench_py(both_datasets, ext):
    jax_dir, port_dir = both_datasets
    name = f"{bench.DS}/{bench.DS}.{ext}"
    want = pd.read_csv(os.path.join(jax_dir, name), sep="\t")
    got = pd.read_csv(os.path.join(port_dir, name), sep="\t")
    assert list(got.columns) == list(want.columns)
    assert len(got) == (bench.N_INTER if ext == "inter" else bench.N_USERS)
    for col in want.columns:
        assert np.array_equal(got[col].to_numpy(), want[col].to_numpy()), col


def test_dataset_is_written_once(tmp_path):
    """A second call keeps the files of the first (and their ETL caches)."""
    root = str(tmp_path)
    assert bench_torch.ensure_dataset(root, TINY) == root
    inter = os.path.join(root, bench_torch.DS, f"{bench_torch.DS}.inter")
    mtime = os.path.getmtime(inter)
    assert len(pd.read_csv(inter, sep="\t")) == TINY.inter
    bench_torch.ensure_dataset(root, TINY)
    assert os.path.getmtime(inter) == mtime


# -------------------------------------------------------------------- keys

def _bench_py_keys():
    """Every key bench.py prints: the ``out`` literal of ``main``, the dicts
    its legs return or build as ``out``, ``out[...]`` assignments, and the
    f-string keys of ``bench_roofline``'s ``path`` for each path it names."""
    funcs = _bench_py_tree()
    keys = set()

    def literal_keys(node):
        if isinstance(node, ast.Dict):
            keys.update(k.value for k in node.keys if isinstance(k, ast.Constant))
        elif isinstance(node, ast.Tuple):
            for elt in node.elts:
                literal_keys(elt)

    for name in ("main", "bench_train_epoch", "bench_resident_epoch", "bench_eval",
                 "bench_uni100_eval", "bench_adversarial_epoch", "bench_roofline", "bench_scale"):
        for node in ast.walk(funcs[name]):
            if isinstance(node, ast.Return) and node.value is not None:
                literal_keys(node.value)
            elif isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Name) and target.id == "out":
                        literal_keys(node.value)
                    elif (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
                          and target.value.id == "out"):
                        keys.add(target.slice.value)
    roof = funcs["bench_roofline"]
    path_fn = next(n for n in ast.walk(roof) if isinstance(n, ast.FunctionDef) and n.name == "path")
    templates = [k for n in ast.walk(path_fn) if isinstance(n, ast.Dict) for k in n.keys
                 if isinstance(k, ast.JoinedStr)]
    paths = [c.args[0].value for c in ast.walk(roof) if isinstance(c, ast.Call)
             and isinstance(c.func, ast.Name) and c.func.id == "path"]
    assert len(templates) == 3 and len(paths) == 3
    for path in paths:
        for t in templates:
            keys.add("".join(p.value if isinstance(p, ast.Constant) else path for p in t.values))
    return keys


def test_output_keys_are_bench_py_keys():
    want = _bench_py_keys()
    assert len(want) == 72
    assert len(bench_torch.KEYS) == len(set(bench_torch.KEYS))
    assert set(bench_torch.KEYS) == want
    assert "device" not in want


def test_output_keys_follow_bench_py_order():
    """The keys of bench.py's ``out`` literal come in its order."""
    main = _bench_py_tree()["main"]
    out = next(n.value for n in ast.walk(main) if isinstance(n, ast.Assign)
               and isinstance(n.targets[0], ast.Name) and n.targets[0].id == "out")
    literal = [k.value for k in out.keys if k is not None]
    assert [k for k in bench_torch.KEYS if k in literal] == literal


# ----------------------------------------------------------------- roofline

def _exec_assignments(func, names, namespace):
    """Run ``func``'s top-level assignments to ``names``, in its order, in
    ``namespace``."""
    for node in func.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name) and node.targets[0].id in names):
            exec(compile(ast.Module([node], []), "bench.py", "exec"), {}, namespace)
    missing = set(names) - set(namespace)
    assert not missing, missing
    return namespace


ML1M_SIZES = [bench_torch.Size(), bench_torch.Size(users=1000, items=500, inter=20000)]
SCALE_SIZES = [bench_torch.ScaleSize(), TINY_SCALE._replace(batch=4096)]


@pytest.mark.parametrize("size", ML1M_SIZES, ids=["ml1m", "small"])
def test_modeled_demands_equal_bench_py_ml1m(size):
    names = ("valid_users", "d", "steps", "p_bytes", "train_bytes", "train_flops", "eval_flops",
             "eval_bytes", "uni_rows", "uni_flops", "uni_bytes")
    ns = _exec_assignments(_bench_py_tree()["bench_roofline"], names, {
        "N_USERS": size.users, "N_ITEMS": size.items, "N_INTER": size.inter, "EMB": bench.EMB})
    got = bench_torch.modeled_demands(size, bench_torch.EMB)
    for name in ("train_bytes", "train_flops", "eval_flops", "eval_bytes", "uni_flops",
                 "uni_bytes"):
        assert got[name] == ns[name], name


@pytest.mark.parametrize("scale", SCALE_SIZES, ids=["scale", "small"])
def test_modeled_demands_equal_bench_py_scale(scale):
    func = _bench_py_tree()["bench_scale"]
    ns = _exec_assignments(func, ("table_bytes", "flops", "approx_bytes", "p_rows", "step_bytes"), {
        "I": scale.items, "D": scale.dim, "B": scale.block, "N_U": scale.users,
        "N_I": scale.items, "batch_size": scale.batch})
    got = bench_torch.modeled_demands(scale=scale)
    for name in ("table_bytes", "flops", "approx_bytes", "step_bytes"):
        assert got[name] == ns[name], name
    # the B 1024 block's products, inline in bench.py's return
    assert any(isinstance(n, ast.BinOp) and ast.unparse(n) == "2 * B2 * I * D"
               for n in ast.walk(func))
    assert got["b1024_flops"] == 2 * scale.block2 * scale.items * scale.dim


def test_roofline_sizes_are_bench_py_sizes():
    assert (bench_torch.N_USERS, bench_torch.N_ITEMS, bench_torch.N_INTER, bench_torch.EMB) == (
        bench.N_USERS, bench.N_ITEMS, bench.N_INTER, bench.EMB)
    assert bench_torch.Size().batch == 2048
    assert bench_torch.TRAIN_BASELINE_EX_S == bench.TRAIN_BASELINE_EX_S
    assert bench_torch.EVAL_BASELINE_ITEMS_S == bench.EVAL_BASELINE_ITEMS_S
    s = bench_torch.ScaleSize()
    assert (s.items, s.dim, s.block, s.block2, s.users, s.batch, s.steps) == (
        2 * 1024 * 1024, 128, 128, 1024, 1024 * 1024, 65536, 10)
    assert bench_torch.PROBE == (4096, 64, 64 * 1024 * 1024)
    assert bench_torch.PALLAS == (1024, 65536, 64, 10)


@pytest.mark.parametrize("wall, side", [(1e3, "host"), (1e-9, "device")])
def test_binding_side_reads_the_share_of_the_wall(wall, side):
    dem = bench_torch.modeled_demands()
    walls = [("train_epoch", (dem["train_flops"], dem["train_bytes"]), wall),
             ("fullsort_eval", (dem["eval_flops"], dem["eval_bytes"]), wall)]
    text = bench_torch.binding_side(dem, walls)
    assert text.startswith(f"{side}:") and "train_epoch" in text and "fullsort_eval" in text


# -------------------------------------------------------------- agreement

@pytest.mark.parametrize("stream, agree", [
    ({"recall@10": 0.5, "hit@10": 0.9, "ndcg@10": 0.3}, True),
    ({"recall@10": 0.5, "hit@10": 0.9, "ndcg@10": 0.3 + 1.9e-3}, True),
    ({"recall@10": 0.5, "hit@10": 0.9, "ndcg@10": 0.3 + 2.1e-3}, False),
    ({"recall@10": 0.5 + 1e-12, "hit@10": 0.9, "ndcg@10": 0.3}, False),
    ({"recall@10": 0.5, "hit@10": 0.9}, False),
])
def test_variants_agree_is_bench_py_rule(stream, agree):
    dense = {"recall@10": 0.5, "hit@10": 0.9, "ndcg@10": 0.3}
    assert bench_torch.variants_agree(dense, stream) is agree


def test_timed_stats_and_cap():
    times = iter([3.0, 1.0, 2.0, 5.0, 4.0])
    assert bench_torch.timed_stats(lambda: next(times), 5) == (1.0, 3.0, 5.0, 5)
    assert bench_torch._cap(8, None) == 8 and bench_torch._cap(8, 1) == 1
    assert bench_torch._cap(8, 20) == 8


# --------------------------------------------------------------- the legs

def _finite_positive(result):
    rates = {k: v for k, v in result.items() if "per_s" in k or k == "value"
             or k.endswith(("_s", "_ms", "_tflops", "_gbps"))}
    assert rates
    for key, v in rates.items():
        assert isinstance(v, float) and math.isfinite(v) and v > 0, (key, v)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A data directory and a working directory (the trainers write
    ``log_tensorboard/`` under it)."""
    root = tmp_path_factory.mktemp("bench")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        yield str(root / "data")
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def bpr(work):
    trainer, train_data, valid_data = bench_torch.build(CPU, work, TINY)
    assert type(trainer).__name__ == "Trainer" and trainer.device.type == "cpu"
    assert trainer.config["device_neg_sampling"] and trainer.model.embedding_size == 64
    return trainer, train_data, valid_data


def test_leg_train_step(bpr):
    trainer, train_data, _ = bpr
    _finite_positive(bench_torch.bench_train_step(trainer, train_data, CPU, TINY))


def test_leg_train_step_refuses_replaced_negatives(bpr, monkeypatch):
    trainer, train_data, _ = bpr

    def redraw(batch, loss_name):
        return {**batch, "neg_item_id": batch["neg_item_id"].clone()}

    monkeypatch.setattr(trainer, "_inject_negatives", redraw)
    with pytest.raises(RuntimeError, match="replaced the batch's own negatives"):
        bench_torch.bench_train_step(trainer, train_data, CPU, TINY)


def test_leg_train_epoch(bpr):
    trainer, train_data, _ = bpr
    res = bench_torch.bench_train_epoch(trainer, train_data, CPU, repeats=2)
    _finite_positive(res)
    assert res["train_epoch_timing_n"] == 2
    assert res["train_epoch_s"] <= res["train_epoch_s_p50"] <= res["train_epoch_s_max"]


def test_leg_resident_epoch(bpr):
    trainer, train_data, _ = bpr
    res = bench_torch.bench_resident_epoch(trainer, train_data, CPU, repeats=2)
    _finite_positive(res)
    assert not trainer.config["device_epoch_shuffle"] and trainer._resident_cache is not None


def test_leg_resident_epoch_refuses_the_per_step_path(bpr, monkeypatch):
    trainer, train_data, _ = bpr
    monkeypatch.setattr(trainer, "_resident_epoch_ok", lambda *args: False)
    with pytest.raises(RuntimeError, match="epochs were resident"):
        bench_torch.bench_resident_epoch(trainer, train_data, CPU, repeats=1)


def test_leg_eval(bpr):
    trainer, _, valid_data = bpr
    launches = {"fused_topk": 0}
    res = bench_torch.bench_eval(trainer, valid_data, CPU, repeats=2, launches=launches)
    _finite_positive({k: v for k, v in res.items() if k != "eval_variants_agree"})
    assert res["eval_variants_agree"] is True
    assert launches == {"fused_topk": 0}  # the CPU takes the kernel's plain version
    assert not trainer.config["streaming_eval"]


def test_leg_uni100_eval(work):
    res = bench_torch.bench_uni100_eval(CPU, work, TINY, repeats=2)
    _finite_positive(res)
    assert res["uni100_timing_n"] == 2


def test_leg_adversarial_epoch(work):
    _finite_positive(bench_torch.bench_adversarial_epoch(CPU, work, TINY, repeats=1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leg_fairgo_finetune_epoch(work, dtype):
    ex_s, dt = bench_torch.bench_fairgo_finetune_epoch(CPU, dtype, work, TINY, repeats=1)
    _finite_positive({"examples_per_s": ex_s, "epoch_s": dt})


def test_leg_roofline():
    res = bench_torch.bench_roofline(CPU, 0.5, 0.1, 0.2, TINY, probe=(64, 2, 4096))
    assert res["chip"] == "cpu" and res["roofline_binding_side"].startswith("host:")
    _finite_positive({k: v for k, v in res.items() if k not in ("chip", "roofline_binding_side")})


def test_leg_scale(work):
    launches = {"fused_topk": 0}
    res = bench_torch.bench_scale(CPU, 100.0, 1.0, TINY_SCALE, work, repeats=1,
                                  launches=launches)
    assert res["scale_fullsort_approx_recall_vs_exact"] == 1.0
    assert res["scale_train_tables_rows"] == TINY_SCALE.users + TINY_SCALE.items
    assert res["scale_fullsort_binder"].startswith("not measured")
    _finite_positive({k: v for k, v in res.items() if k != "scale_fullsort_binder"})


def test_leg_pallas_topk():
    exact, fused_ms, dense_ms, err, near = bench_torch.bench_pallas_topk(
        CPU, (32, 1024, 16, 10), repeats=2)
    assert exact is True and err <= 1e-5 and near == 0
    _finite_positive({"pallas_topk_ms": fused_ms, "dense_topk_ms": dense_ms})


def test_pallas_rule_flags_a_wrong_index():
    """The rule the pallas leg applies (chip_smoke.py's) finds a swapped
    index that is no near tie."""
    import chip_smoke

    gen = torch.Generator().manual_seed(0)
    U, T = torch.randn(4, 8, generator=gen), torch.randn(50, 8, generator=gen)
    s = U @ T.T
    s[:, 0] = float("-inf")
    s_p, i_p = torch.topk(s, 3)
    bad = i_p.int().clone()
    bad[0, 0] = int(i_p[0, 2])
    problem, _, _ = chip_smoke.topk_disagreement(U, T, 3, s_p, bad, s_p, i_p.int())
    assert problem.startswith("index")
    assert chip_smoke.topk_disagreement(U, T, 3, s_p, i_p.int(), s_p, i_p.int())[0] is None


# -------------------------------------------------------------------- main

def test_main_refuses_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py"), "--repeats", "1"],
                          capture_output=True, text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
    assert proc.stdout == ""


def test_main_refuses_a_zero_repeat():
    with pytest.raises(SystemExit) as exc:
        bench_torch.main(["--repeats", "0"])
    assert exc.value.code == 2
