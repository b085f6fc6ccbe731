"""The port's remaining single-device modules on the CPU: deferred collector
emits, the hyper-parameter search, the case study, the approximate and
certified top-k, optimizer-state resume from the JAX package's Adagrad and
RMSprop, the URL helpers and the command-line tools.

Each is held against the JAX package where the JAX package has the same
function: the search's trial sequence exactly (the same numpy stream), the
case study's scores to 1e-6 abs (float32 sigmoid of the same products) with
the same −inf cells and top-k ids, the top-k as sets per row with scores to
1e-6 abs, the resumed step's loss to 1e-6 rel and parameters to 1e-6 abs.
Deferred and immediate emits are held against each other: identical dicts.
"""

import contextlib
import os
import pickle
import zipfile

import jax
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from recbole_fairrec_tpu.ops.topk import approx_topk_scores as jax_approx_topk
from recbole_fairrec_tpu.ops.topk import certified_topk_scores as jax_certified_topk
from recbole_fairrec_tpu.trainer.hyper_tuning import HyperTuning as JaxHyperTuning
from recbole_fairrec_tpu.utils.case_study import full_sort_scores as jax_full_sort_scores
from recbole_fairrec_tpu.utils.case_study import full_sort_topk as jax_full_sort_topk

from recbole_fairrec_tpu_torch import Config, objective_function
from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
from recbole_fairrec_tpu_torch.ops.topk import approx_topk_scores, certified_topk_scores
from recbole_fairrec_tpu_torch.quick_start import load_checkpoint
from recbole_fairrec_tpu_torch.trainer.hyper_tuning import HyperTuning
from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed
from recbole_fairrec_tpu_torch.utils import url
from recbole_fairrec_tpu_torch.utils.case_study import full_sort_scores, full_sort_topk
from recbole_fairrec_tpu_torch.utils.jax_params import load_jax_opt_state
from test_torch_training import (
    _assert_params_close,
    _cfg,
    _host_batches,
    _jax_steps,
    _np_tree,
    _port_params,
    _port_steps,
)
from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)

# ------------------------------------------------------------ deferred emits


def _port_trainer(cfg, model, dataset):
    config = Config(model=model, dataset=dataset, config_dict=cfg)
    init_seed(config["seed"], True)
    train, valid, test = data_preparation(config, create_dataset(config))
    trainer = get_trainer(config["MODEL_TYPE"], model)(
        config, get_model(model)(config, train.dataset))
    trainer.eval_collector.data_collect(train)
    return trainer, valid, test


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("deferred"))
    chip_smoke.write_dataset(root, n_users=50, n_items=70, n_inter=1200)
    chip_smoke.write_dataset(root, n_users=50, n_items=70, n_inter=1200,
                             name=chip_smoke.ADV_DATASET, attributes=True)
    return root


# small dispatch budgets, so that every evaluation has several macro batches
MANY_BATCHES = {"use_gpu": False, "eval_macro_scores": 20 * 71, "eval_macro_rows_sampled": 1500}


@pytest.fixture(scope="module")
def dense_bpr(data_root):
    cfg = chip_smoke.train_config(data_root, os.path.join(data_root, "bpr"),
                                  {**MANY_BATCHES, "streaming_eval": False,
                                   "eval_batch_size": 10 * 71})
    return _port_trainer(cfg, "PFCN_PMF", chip_smoke.DATASET)


@pytest.fixture(scope="module")
def sampled_pfcn(data_root):
    cfg = chip_smoke.published_config(data_root, os.path.join(data_root, "pfcn"), "PFCN_PMF", {
        **MANY_BATCHES, "filter_mode": "sm", "sst_attr_list": ["gender", "age"]})
    return _port_trainer(cfg, "PFCN_PMF", chip_smoke.ADV_DATASET)


@pytest.fixture(scope="module")
def sampled_fairgo(data_root):
    cfg = chip_smoke.fairgo_config(data_root, os.path.join(data_root, "fairgo"), "FairGo_PMF",
                                   MANY_BATCHES)
    return _port_trainer(cfg, "FairGo_PMF", chip_smoke.ADV_DATASET)


@contextlib.contextmanager
def emit_log(trainer, immediate=False):
    """Log every ``_collect_batch`` launch and emit as (event, batch number,
    subset); with ``immediate`` each emit runs inside its own call, as before
    deferral."""
    log, current = [], [None, -1]  # the batch being collected, its number
    collect = trainer._collect_batch

    def run(kind, batched_data, sst_list=None):
        if batched_data is not current[0]:
            current[:] = [batched_data, current[1] + 1]
        key = (current[1], sst_list)
        emit = collect(kind, batched_data, sst_list)
        log.append(("launch", key, emit is not None))
        if emit is None:
            return None

        def logged():
            log.append(("emit", key, True))
            emit()

        if immediate:
            logged()
            return None
        return logged

    trainer._collect_batch = run
    try:
        yield log
    finally:
        del trainer._collect_batch


def _evaluate_both_ways(trainer, evaluate):
    """``evaluate()`` with immediate emits, then deferred (numpy seeded alike
    before each: the sampled loaders draw from it)."""
    out = {}
    for mode in ("immediate", "deferred"):
        with emit_log(trainer, immediate=mode == "immediate") as log:
            np.random.seed(21)
            out[mode] = (evaluate(), log)
    return out


def _assert_deferred(log):
    launches = [key for event, key, deferred in log if event == "launch"]
    emits = [key for event, key, _ in log if event == "emit"]
    assert all(deferred for event, _, deferred in log), "a device path fed the collector itself"
    assert len(set(k[0] for k in launches)) > 1, "a single macro batch proves no order"
    n = len(launches)
    assert [e for e, _, _ in log] == ["launch"] * n + ["emit"] * n
    assert emits == launches


def test_dense_full_sort_defers_its_emits(dense_bpr):
    trainer, valid, _ = dense_bpr
    runs = _evaluate_both_ways(trainer, lambda: trainer.evaluate(valid, load_best_model=False))
    assert trainer._last_eval_path == "fused"
    assert runs["deferred"][0] == runs["immediate"][0]
    _assert_deferred(runs["deferred"][1])


def test_sampled_subsets_drain_in_batch_then_subset_order(sampled_pfcn):
    """PFCN's validation collects all subsets of a batch before the next
    batch; the drain keeps that order, so the collector's concatenation and
    the dict are those of immediate emits."""
    trainer, valid, test = sampled_pfcn
    subsets = trainer._sst_subsets()
    runs = _evaluate_both_ways(
        trainer, lambda: trainer.pfcn_evaluate(valid, load_best_model=False))
    assert trainer._last_eval_path == "sampled-fused"
    assert runs["deferred"][0] == runs["immediate"][0]
    log = runs["deferred"][1]
    _assert_deferred(log)
    keys = [key for event, key, _ in log if event == "emit"]
    n_batches = len(keys) // len(subsets)
    assert keys == [(b, s) for b in range(n_batches) for s in subsets]
    per_subset = _evaluate_both_ways(
        trainer, lambda: trainer.evaluate(test, load_best_model=False))
    assert per_subset["deferred"][0] == per_subset["immediate"][0]
    assert list(per_subset["deferred"][0]) == [f"sm-{list(s)}" for s in subsets]


def test_fairgo_evaluate_defers_its_emits(sampled_fairgo):
    trainer, valid, _ = sampled_fairgo
    runs = _evaluate_both_ways(trainer, lambda: trainer.evaluate(valid, load_best_model=False))
    assert trainer._last_eval_path == "sampled-fused"
    assert runs["deferred"][0] == runs["immediate"][0]
    _assert_deferred(runs["deferred"][1])


def test_drain_calls_in_order_and_empties():
    from recbole_fairrec_tpu_torch.trainer import Trainer

    seen = []
    pending = [lambda: seen.append(1), None, lambda: seen.append(2)]
    Trainer._drain_collect(pending)
    assert seen == [1, 2] and pending == []


# ------------------------------------------------------ hyper-parameter search


def _stub_objective(config_dict, fixed_config_file_list):
    score = -sum((float(v) if not isinstance(v, str) else len(v)) ** 2 * (i + 1)
                 for i, (_, v) in enumerate(sorted(config_dict.items())))
    return {"best_valid_score": score, "valid_score_bigger": True,
            "best_valid_result": {"s": score}, "test_result": {"s": score}}


MIXED = {"choice": {"c": [1, 2, 3], "embedding": ["a", "bb"]}, "uniform": {"x": [0.0, 1.0]},
         "quniform": {"q": [0.0, 10.0, 2.0]}, "loguniform": {"lr": [-8.0, -2.0]}}


@pytest.mark.parametrize("algo,space,max_evals", [
    ("exhaustive", {"choice": {"c": [1, 2, 3], "embedding": ["a", "bb"]}}, 100),
    ("random", MIXED, 12),
    ("anneal", MIXED, 25),
    ("bayes", MIXED, 25),
])
def test_hyper_tuning_trials_match_jax(algo, space, max_evals):
    runs = []
    for cls in (JaxHyperTuning, HyperTuning):
        hp = cls(_stub_objective, params_dict=space, algo=algo, max_evals=max_evals, seed=5)
        hp.run()
        runs.append(hp)
    ref, ours = runs
    assert [p for p, _, _ in ours._history] == [p for p, _, _ in ref._history]
    assert ours.best_params == ref.best_params and ours.best_score == ref.best_score
    assert list(ours.params2result) == list(ref.params2result)
    assert len(ours._history) == (6 if algo == "exhaustive" else max_evals)


def test_hyper_tuning_params_file_matches_jax(tmp_path):
    path = tmp_path / "space.hyper"
    path.write_text("learning_rate loguniform -8 0\nembedding_size choice [16,32]\n"
                    "dropout uniform 0 0.5\nlayers quniform 1 4 1\n")
    ours = HyperTuning._build_space_from_file(str(path))
    ref = JaxHyperTuning._build_space_from_file(str(path))
    assert {n: (d.kind, d.spec) for n, d in ours.items()} == \
        {n: (d.kind, d.spec) for n, d in ref.items()}


def _tiny_cfg(tiny_data_path, tmp_path, **extra):
    cfg = _cfg(tiny_data_path, str(tmp_path / "saved"), "tiny")
    cfg.update({"model": "PFCN_PMF", "dataset": "tiny", "use_gpu": False, "epochs": 1,
                "save_sst_embed": False, **extra})
    return cfg


def test_exhaustive_search_through_objective_function(tiny_data_path, tmp_path):
    """Two trials (two learning rates) of the port's ``objective_function``
    on resident epochs; the result file lists both."""
    base = _tiny_cfg(tiny_data_path, tmp_path, device_neg_sampling=True,
                     device_epoch_shuffle=True)
    hp = HyperTuning(lambda cfg, files: objective_function({**base, **cfg}, files, saved=False),
                     params_dict={"choice": {"learning_rate": [0.01, 0.005]}},
                     algo="exhaustive")
    hp.run()
    assert list(hp.params2result) == ["learning_rate:0.01", "learning_rate:0.005"]
    for result in hp.params2result.values():
        assert list(result["test_result"]) == ["none"]
    assert hp.best_params["learning_rate"] in (0.01, 0.005)
    out = tmp_path / "hyper.result"
    hp.export_result(str(out))
    assert out.read_text().count("Test result:") == 2


# --------------------------------------------------------------- case study


@pytest.fixture(scope="module")
def tiny_env(tmp_path_factory):
    from conftest import make_tiny_dataset

    from test_torch_training import _Env

    root = tmp_path_factory.mktemp("auxtiny")
    return _Env(_cfg(make_tiny_dataset(str(root)), str(root / "saved"), "tiny"), "tiny")


def test_case_study_matches_jax(tiny_env):
    jt, pt = tiny_env.pair()
    jax_test, test = tiny_env.jax_loaders[2], tiny_env.loaders[2]
    uids = test.uid_list[:6]
    np.testing.assert_array_equal(uids, jax_test.uid_list[:6])
    ours, ref = full_sort_scores(uids, pt, test), jax_full_sort_scores(uids, jt, jax_test)
    assert ours.dtype == np.float64 and ours.shape == ref.shape
    np.testing.assert_array_equal(np.isneginf(ours), np.isneginf(ref))
    assert np.isneginf(ours[:, 0]).all()
    finite = ~np.isneginf(ref)
    np.testing.assert_allclose(ours[finite], ref[finite], rtol=0, atol=1e-6)
    (s, i), (rs, ri) = full_sort_topk(uids, pt, test, 5), jax_full_sort_topk(uids, jt, jax_test, 5)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(s, rs, rtol=0, atol=1e-6)


# -------------------------------------------------------------------- top-k


@pytest.mark.parametrize("k", [1, 10, 49])
def test_approx_and_certified_topk_match_jax(k):
    rng = np.random.RandomState(k)
    U = rng.randn(7, 16).astype(np.float32)
    T = rng.randn(50, 16).astype(np.float32)
    ref_s, ref_i, ref_cert = (np.asarray(x) for x in jax_approx_topk(U, T, k, verify=True))
    s, i, cert = approx_topk_scores(torch.from_numpy(U), torch.from_numpy(T), k, verify=True)
    assert cert.dtype == torch.bool and bool(cert.all()) and ref_cert.all()
    assert i.dtype == torch.int32 and tuple(i.shape) == (7, k)
    cert_s, cert_i = certified_topk_scores(torch.from_numpy(U), torch.from_numpy(T), k)
    jc_s, jc_i = (np.asarray(x) for x in jax_certified_topk(U, T, k))
    for ours_s, ours_i, rs, ri in ((s, i, ref_s, ref_i), (cert_s, cert_i, jc_s, jc_i)):
        ours_s, ours_i = ours_s.numpy(), ours_i.numpy()
        assert (ours_i != 0).all()  # PAD never wins
        for row in range(7):
            assert set(ours_i[row].tolist()) == set(ri[row].tolist())
        np.testing.assert_allclose(ours_s, -np.sort(-rs, axis=1), rtol=0, atol=1e-6)
    assert approx_topk_scores(torch.from_numpy(U), torch.from_numpy(T), k)[1].shape == (7, k)


# ------------------------------------------------- optimizer-state resume


@pytest.mark.parametrize("route", ["tree", "checkpoint"])
@pytest.mark.parametrize("clip", [None, 0.05], ids=["noclip", "clip"])
@pytest.mark.parametrize("learner", ["adagrad", "rmsprop"])
def test_jax_adagrad_and_rmsprop_state_carried_over(tiny_env, learner, clip, route, tmp_path):
    """Two JAX steps, then the parameters and the optimizer state go over to
    the port (as the optax tree, or through a checkpoint the JAX trainer
    wrote): the accumulators equal the JAX package's, and the third step is
    the same in both."""
    overrides = {"learner": learner, "learning_rate": 0.01,
                 "clip_grad_norm": {"max_norm": clip} if clip else None}
    jt, _ = tiny_env.pair(**overrides)
    jax_batches, port_batches = _host_batches(tiny_env, 3)
    _jax_steps(jt, jax_batches[:2])
    if route == "tree":
        pt = tiny_env.port_trainer(_np_tree(jt.params), **overrides)
        load_jax_opt_state(pt.optimizer, pt.model, _np_tree(jt.opt_state))
    else:
        ckpt = str(tmp_path / "jax-trained.pth")
        jt._save_checkpoint(1, verbose=False, saved_model_file=ckpt)
        pt = tiny_env.port_trainer(_np_tree(tiny_env.jax_trainer(**overrides).params),
                                   **overrides)
        pt.resume_checkpoint(ckpt)
        assert pt.start_epoch == 2
    states = [s for s in jax.tree_util.tree_leaves(
        jt.opt_state, is_leaf=lambda n: type(n).__name__.startswith("ScaleByR"))
        if type(s).__name__.startswith("ScaleByR")]
    acc = np.asarray(states[0][-1]["user_embedding"])
    np.testing.assert_array_equal(
        pt.optimizer.state[pt.model.user_embedding.weight]["acc"].numpy(), acc)
    ref_loss = _jax_steps(jt, jax_batches[2:])
    loss = _port_steps(pt, port_batches[2:])
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
    _assert_params_close(jt.params, _port_params(pt), atol=1e-6)


def test_sgd_state_carries_nothing(tiny_env):
    jt, _ = tiny_env.pair(learner="sgd")
    pt = tiny_env.port_trainer(_np_tree(jt.params), learner="sgd")
    assert load_jax_opt_state(pt.optimizer, pt.model, _np_tree(jt.opt_state)) is pt.optimizer
    jt_adagrad, _ = tiny_env.pair(learner="adagrad")
    with pytest.raises(NotImplementedError, match="adagrad"):
        load_jax_opt_state(pt.optimizer, pt.model, _np_tree(jt_adagrad.opt_state))


# ------------------------------------------------------------- URL helpers


def test_url_helpers_on_a_local_zip(tmp_path, monkeypatch):
    archive = tmp_path / "dl" / "ml-x.zip"
    url.makedirs(str(tmp_path / "dl"))
    with zipfile.ZipFile(archive, "w") as z:
        z.writestr("old.inter", "user_id:token\n1\n")
        z.writestr("old.user", "user_id:token\n1\n")
        z.writestr("other.item", "item_id:token\n1\n")
    # the file is there: no download is tried
    assert url.download_url("http://example.invalid/ml-x.zip", str(tmp_path / "dl")) == \
        str(archive)
    folder = tmp_path / "data"
    url.makedirs(str(folder))
    url.extract_zip(str(archive), str(folder))
    (folder / "old.dir").mkdir()
    url.rename_atomic_files(str(folder), "old", "new")
    assert sorted(os.listdir(folder)) == ["new.inter", "new.user", "old.dir", "other.item"]
    assert (folder / "new.inter").read_text() == "user_id:token\n1\n"
    monkeypatch.setattr("builtins.input", lambda prompt: "Y ")
    assert url.decide_download("http://example.invalid/x.zip")
    monkeypatch.setattr("builtins.input", lambda prompt: "")
    assert not url.decide_download("http://example.invalid/x.zip")


# ------------------------------------------------------------ command line


def _write_yaml(path, cfg):
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def test_cli_and_scripts_run_tiny_on_the_cpu(tiny_data_path, tmp_path, capsys):
    from recbole_fairrec_tpu_torch import cli
    from recbole_fairrec_tpu_torch.scripts import resume_run_recbole, run_hyper

    cfg = _tiny_cfg(tiny_data_path, tmp_path)
    cfg.pop("model"), cfg.pop("dataset")
    config_file = _write_yaml(tmp_path / "fixed.yaml", cfg)
    result = cli.main(["-m", "PFCN_PMF", "-d", "tiny", "-c", config_file, "--ignored"])
    assert list(result["test_result"]) == ["none"]
    ckpt = [f for f in os.listdir(tmp_path / "saved") if f.startswith("PFCN_PMF-")]
    assert len(ckpt) == 1
    ckpt = str(tmp_path / "saved" / ckpt[0])
    assert load_checkpoint(ckpt)["config"]["model"] == "PFCN_PMF"

    served = resume_run_recbole.main(["-f", ckpt])
    assert dict(served["none"]) == dict(result["test_result"]["none"])
    assert "test result:" in capsys.readouterr().out

    params = tmp_path / "space.hyper"
    params.write_text("learning_rate choice [0.01,0.002]\n")
    hp = run_hyper.main(["--config_files", _write_yaml(tmp_path / "hyper.yaml",
                                                       {**cfg, "model": "PFCN_PMF",
                                                        "dataset": "tiny"}),
                         "--params_file", str(params),
                         "--output_file", str(tmp_path / "hyper.result")])
    assert list(hp.params2result) == ["learning_rate:0.01", "learning_rate:0.002"]
    assert "best params:" in capsys.readouterr().out


def test_console_entry_is_declared():
    import tomllib

    from recbole_fairrec_tpu_torch import cli

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "pyproject.toml"), "rb") as fh:
        scripts = tomllib.load(fh)["project"]["scripts"]
    assert scripts["run_recbole_torch"] == "recbole_fairrec_tpu_torch.cli:main"
    assert callable(cli.main)


def test_scripts_run_as_modules(tiny_data_path, tmp_path):
    """``python -m ...scripts.run_recbole``: the flags, and ``--key=value``
    overrides that beat the config file (``--epochs=1`` over 2)."""
    import subprocess
    import sys

    cfg = _tiny_cfg(tiny_data_path, tmp_path, epochs=2)
    cfg.pop("model"), cfg.pop("dataset")
    config_file = _write_yaml(tmp_path / "fixed.yaml", cfg)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "recbole_fairrec_tpu_torch.scripts.run_recbole",
         "-m", "PFCN_PMF", "-d", "tiny", "-c", config_file, "--epochs=1"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": repo, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ckpt = [f for f in os.listdir(tmp_path / "saved") if f.startswith("PFCN_PMF-")]
    with open(tmp_path / "saved" / ckpt[0], "rb") as f:
        checkpoint = pickle.load(f)
    assert checkpoint["config"]["epochs"] == 1 and checkpoint["epoch"] == 0
