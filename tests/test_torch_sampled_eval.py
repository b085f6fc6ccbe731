"""The fair models' published evaluation protocol in the port against the
JAX package, on the CPU: sampled (``uni100`` / ``pop100``) and labeled
loaders, ``sampled_topk_from_scores``, and ``evaluate`` on the device path
and on the host paths, with all 12 published metrics.

Both packages read the same data; weights and BatchNorm state are the JAX
package's, carried over with ``load_jax_params``; both draw the negatives
from numpy's global generator, seeded alike before each pass.

Tolerances: loader batches and top-k ids exact; top-k scores and positive
scores exact (the same float32 inputs are scattered and gathered). Metric
dicts are compared unrounded (``metric_decimal_place: 10``): the metrics
that only count ranks (NDCG, Recall, Hit, MRR, GiniIndex,
PopularityPercentage, GAUC) to 1e-9 abs; the ones that average scores
(the fairness gaps, AUC, LogLoss, MAE, RMSE) to 1e-5 rel + 1e-7 abs, as the
two packages' float32 scores differ in the last bits (the filters' MLPs sum
in other orders).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from recbole_fairrec_tpu.config import Config as JaxConfig
from recbole_fairrec_tpu.data import create_dataset as jax_create_dataset
from recbole_fairrec_tpu.data import data_preparation as jax_data_preparation
from recbole_fairrec_tpu.ops import eval_fused as jax_eval_fused
from recbole_fairrec_tpu.utils import get_model as jax_get_model
from recbole_fairrec_tpu.utils import get_trainer as jax_get_trainer
from recbole_fairrec_tpu.utils import init_seed as jax_init_seed

import recbole_fairrec_tpu_torch as port_pkg
from recbole_fairrec_tpu_torch import Config
from recbole_fairrec_tpu_torch.data import NegSampleEvalDataLoader, create_dataset, data_preparation
from recbole_fairrec_tpu_torch.ops import eval_fused
from recbole_fairrec_tpu_torch.trainer import Trainer as PortTrainer
from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed
from recbole_fairrec_tpu_torch.utils.jax_params import load_jax_params
from test_torch_adversarial import perturb
from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_USERS, N_ITEMS = 48, 120
RANK_ATOL, VALUE_RTOL, VALUE_ATOL = 1e-9, 1e-5, 1e-7
RANK_METRICS = ("ndcg@", "recall@", "hit@", "mrr@", "giniindex@", "popularitypercentage@",
                "gauc")

# what every fair model's YAML sets for evaluation (checked against the
# YAMLs below); a dataset's own settings override the YAML's label and
# columns, so a run on another dataset passes these as they are
PUBLISHED = {
    "eval_args": {"split": {"RS": [8, 1, 1]}, "group_by": "user", "order": "RO",
                  "mode": "uni100"},
    "metrics": ["NDCG", "Recall", "Hit", "MRR", "DifferentialFairness", "GiniIndex",
                "PopularityPercentage", "ValueUnfairness", "AbsoluteUnfairness",
                "UnderUnfairness", "OverUnfairness", "NonParityUnfairness"],
    "topk": [5],
    "valid_metric": "NDCG@5",
    "LABEL_FIELD": "label",
    "threshold": {"rating": 3.0},
}
# the 12 metric families, by the prefix of their result keys; the fairness
# families carry one key per attribute
FAMILIES = ["ndcg@5", "recall@5", "hit@5", "mrr@5", "Differential Fairness",
            "giniindex@5", "popularitypercentage@5", "Value Unfairness",
            "Absolute Unfairness", "Underestimation Unfairness", "Overestimation Unfairness",
            "NonParity Unfairness"]
PER_ATTRIBUTE = ("Differential Fairness", "NonParity Unfairness")


def write_dataset(root, name="fair", seed=11):
    """Every user rates 10-20 random items with ratings 1-5; ``gender`` =
    u mod 2, ``age`` = u mod 3."""
    ddir = os.path.join(root, name)
    os.makedirs(ddir, exist_ok=True)
    rng = np.random.RandomState(seed)
    with open(os.path.join(ddir, f"{name}.inter"), "w") as f:
        f.write("user_id:token\titem_id:token\trating:float\ttimestamp:float\n")
        t = 0
        for u in range(1, N_USERS + 1):
            items = rng.choice(np.arange(1, N_ITEMS + 1), rng.randint(10, 21), replace=False)
            for i in items:
                f.write(f"{u}\t{i}\t{rng.randint(1, 6)}\t{t}\n")
                t += 1
    with open(os.path.join(ddir, f"{name}.user"), "w") as f:
        f.write("user_id:token\tgender:float\tage:float\n")
        for u in range(1, N_USERS + 1):
            f.write(f"{u}\t{u % 2}\t{u % 3}\n")
    return root


def published_config(data_path, ckpt_dir, extra=None):
    return {
        "data_path": data_path,
        "load_col": {"inter": ["user_id", "item_id", "rating"],
                     "user": ["user_id", "gender", "age"]},
        **PUBLISHED,
        "embedding_size": 16, "dis_hidden_size_list": [16, 8], "mlp_hidden_size": [24, 12],
        "dropout": 0.0, "dis_dropout": 0.0,
        "train_batch_size": 128, "eval_batch_size": 2000,
        "metric_decimal_place": 10,
        "show_progress": False, "save_sst_embed": False, "state": "ERROR",
        "checkpoint_dir": ckpt_dir, "log_root": os.path.join(ckpt_dir, "log"),
        **(extra or {}),
    }


def assert_families(result, attrs):
    """Every one of the 12 published metric families, finite, with one
    key per attribute for the per-attribute ones."""
    for family in FAMILIES:
        keys = [k for k in result if k.startswith(family)]
        want = len(attrs) if family in PER_ATTRIBUTE else 1
        assert len(keys) == want, (family, list(result))
        assert all(np.isfinite(result[k]) for k in keys), (family, result)


def assert_same_result(ours, ref):
    assert list(ours) == list(ref)
    for key in ref:
        if key.startswith(RANK_METRICS):
            assert ours[key] == pytest.approx(ref[key], abs=RANK_ATOL), key
        else:
            assert ours[key] == pytest.approx(ref[key], rel=VALUE_RTOL, abs=VALUE_ATOL), key


class Env:
    """Both packages' configs and loaders over one dataset, and a JAX and a
    port trainer with the same weights (``pair``)."""

    def __init__(self, root, model="PFCN_PMF", extra=None):
        self.name = model
        self.cfg = published_config(write_dataset(root), os.path.join(root, "saved"), extra)
        self.jax_config = JaxConfig(model=model, dataset="fair", config_dict=self.cfg)
        jax_init_seed(self.jax_config["seed"], True)
        self.jax_loaders = jax_data_preparation(self.jax_config,
                                                jax_create_dataset(self.jax_config))
        self.jax_model = jax_get_model(model)(self.jax_config, self.jax_loaders[0].dataset)
        self.config = Config(model=model, dataset="fair",
                             config_dict={**self.cfg, "use_gpu": False})
        init_seed(self.config["seed"], True)
        self.loaders = data_preparation(self.config, create_dataset(self.config))
        params, state = perturb(*self.jax_model.init_params(jax.random.PRNGKey(1)))
        for key in ("item_embedding", "user_embedding"):
            if key in params:  # scores where float32 sigmoid keeps them apart
                params[key] = params[key] * np.float32(0.3)
        self.params, self.state = params, state

    def pair(self):
        jt = jax_get_trainer(self.jax_config["MODEL_TYPE"], self.name)(
            self.jax_config, self.jax_model)
        jt.params = jax.tree_util.tree_map(jnp.asarray, self.params)
        jt.model_state = jax.tree_util.tree_map(jnp.asarray, self.state)
        model = get_model(self.name)(self.config, self.loaders[0].dataset)
        load_jax_params(model, self.params, self.state)
        pt = get_trainer(self.config["MODEL_TYPE"], self.name)(self.config, model)
        for t, loaders in ((jt, self.jax_loaders), (pt, self.loaders)):
            t.eval_collector.data_collect(loaders[0])
        return jt, pt


@pytest.fixture(scope="module")
def none_env(tmp_path_factory):
    return Env(str(tmp_path_factory.mktemp("sampled_none")), extra={"filter_mode": "none"})


@pytest.fixture(scope="module")
def sm_env(tmp_path_factory):
    return Env(str(tmp_path_factory.mktemp("sampled_sm")),
               extra={"filter_mode": "sm", "sst_attr_list": ["gender", "age"]})


# -------------------------------------------------------------- protocol


@pytest.mark.parametrize("model", ["PFCN_PMF", "FOCF", "NFCF"])
def test_published_protocol_is_the_yamls(model):
    """The protocol these tests and chip_smoke.py run is each YAML's own, in
    the JAX package's files and in the port's copy of them."""
    path = os.path.join(REPO, "recbole_fairrec_tpu", "config", "properties", "model",
                        f"{model}.yaml")
    with open(path) as f:
        jax_yaml = yaml.safe_load(f)
    with open(os.path.join(REPO, "recbole_fairrec_tpu_torch", "config",
                           "properties.json")) as f:
        port_props = json.load(f)[f"model/{model}"]
    for key, value in PUBLISHED.items():
        assert jax_yaml[key] == value, key
        assert port_props[key] == value, key


# ---------------------------------------------------------------- loaders


def _assert_same_batches(jax_loader, port_loader, seed):
    np.random.seed(seed)
    jax_batches = list(jax_loader)
    np.random.seed(seed)
    port_batches = list(port_loader)
    assert len(jax_batches) == len(port_batches) > 0
    for jb, pb in zip(jax_batches, port_batches):
        assert sorted(jb[0].columns) == sorted(pb[0].columns)
        for col in jb[0].columns:
            ref, ours = np.asarray(jb[0][col]), pb[0][col].numpy()
            assert ours.dtype == ref.dtype, col
            np.testing.assert_array_equal(ours, ref, err_msg=col)
        for ref, ours in zip(jb[1:], pb[1:]):
            if ref is None:
                assert ours is None
            else:
                np.testing.assert_array_equal(ours, ref)
    return len(port_batches)


@pytest.mark.parametrize("phase", [1, 2], ids=["valid", "test"])
@pytest.mark.parametrize("mode", ["uni100", "pop100"])
def test_sampled_loader_batches_match_jax(tmp_path, mode, phase):
    """The same negatives, labels, row ids and positives, bit for bit, under
    one numpy seed: with the config's batches, macro-sized, and sized back."""
    env = Env(str(tmp_path), extra={"filter_mode": "none",
                                    "eval_args": {**PUBLISHED["eval_args"], "mode": mode}})
    jl, pl = env.jax_loaders[phase], env.loaders[phase]
    assert isinstance(pl, NegSampleEvalDataLoader)
    assert (pl.step, pl.batch_size) == (jl.step, jl.batch_size)
    n_plain = _assert_same_batches(jl, pl, 3)
    jl.set_macro_rows(6000)
    pl.set_macro_rows(6000)
    assert (pl.step, pl.batch_size, pl._macro_sized) == (jl.step, jl.batch_size, True)
    n_macro = _assert_same_batches(jl, pl, 4)
    assert n_macro < n_plain
    jl.reset_macro_rows()
    pl.reset_macro_rows()
    assert (pl.step, pl.batch_size, pl._macro_sized) == (jl.step, jl.batch_size, False)
    assert _assert_same_batches(jl, pl, 5) == n_plain


def test_labeled_batches_match_jax(tmp_path):
    env = Env(str(tmp_path), extra={
        "filter_mode": "none", "eval_args": {**PUBLISHED["eval_args"], "mode": "labeled"},
        "metrics": ["AUC", "LogLoss"], "valid_metric": "AUC", "eval_batch_size": 50})
    for phase in (1, 2):
        assert _assert_same_batches(env.jax_loaders[phase], env.loaders[phase], 6) > 1


# ------------------------------------------------------------------ top-k


def _topk_case(kind, seed=0):
    rng = np.random.RandomState(seed)
    n_users, n_items, per_user = 6, 30, 8
    row_idx = np.repeat(np.arange(n_users), per_user)
    col_idx = np.concatenate([rng.choice(np.arange(1, n_items), per_user, replace=False)
                              for _ in range(n_users)])
    if kind == "random":
        scores = rng.randn(len(row_idx)).astype(np.float32)
    elif kind == "equal":  # every row one value: the order is the index order
        scores = np.full(len(row_idx), 0.5, np.float32)
    else:  # FOCF's clamp: most scores exactly 0
        scores = np.maximum(rng.randn(len(row_idx)), 0).astype(np.float32)
    valid = np.ones(len(row_idx), np.float32)
    valid[-3:] = 0.0  # padding rows land in the scrap row
    pos_u = np.arange(n_users).repeat(2)
    pos_i = col_idx.reshape(n_users, per_user)[:, :2].reshape(-1)
    pos_w = np.ones(len(pos_u), np.float32)
    return scores, row_idx, col_idx, valid, pos_u, pos_i, pos_w, n_users, n_items


@pytest.mark.parametrize("kind", ["random", "equal", "clamped"])
def test_sampled_topk_matches_jax(kind):
    """Ids exact, ties to the lowest item index, as ``lax.top_k`` orders."""
    (scores, row_idx, col_idx, valid, pos_u, pos_i, pos_w,
     n_users, n_items) = _topk_case(kind)
    ref = jax_eval_fused.sampled_eval_step(
        jnp.asarray(scores), jnp.asarray(row_idx), jnp.asarray(col_idx), jnp.asarray(valid),
        jnp.asarray(pos_u), jnp.asarray(pos_i), jnp.asarray(pos_w),
        n_users=n_users, n_items=n_items, top_k=5)
    ours = eval_fused.sampled_topk_from_scores(
        torch.from_numpy(scores), torch.from_numpy(row_idx), torch.from_numpy(col_idx),
        torch.from_numpy(valid), torch.from_numpy(pos_u), torch.from_numpy(pos_i),
        torch.from_numpy(pos_w), n_users, n_items, 5)
    for r, o in zip(ref, ours):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    if kind == "equal":
        first = col_idx.reshape(n_users, -1).copy()
        first[-1, -3:] = n_items  # the padding rows were not scattered
        np.testing.assert_array_equal(ours[0].numpy(), np.sort(first, axis=1)[:, :5])


# --------------------------------------------------------------- evaluate


def _both(jt, pt, call, seed):
    np.random.seed(seed)
    ref = call(jt)
    np.random.seed(seed)
    return ref, call(pt)


@pytest.mark.parametrize("env_name", ["none_env", "sm_env"])
def test_evaluate_matches_jax(request, env_name):
    """Validation (every subset in one dict, one pass over the loader) and
    test (one dict per subset, one pass each) on uni100 with the 12
    published metrics, through the device path."""
    env = request.getfixturevalue(env_name)
    jt, pt = env.pair()
    ref, ours = _both(jt, pt, lambda t: t._valid_epoch(env_loader(t, env, 1)), 7)
    assert ours[0] == pytest.approx(ref[0], abs=RANK_ATOL)
    assert_same_result(ours[1], ref[1])
    assert pt._last_eval_path == "sampled-fused"
    ref, ours = _both(jt, pt, lambda t: t.evaluate(env_loader(t, env, 2),
                                                   load_best_model=False), 8)
    assert list(ours) == list(ref)
    attrs = env.config["sst_attr_list"] if env_name == "sm_env" else ["gender"]
    for key in ref:
        assert_same_result(ours[key], ref[key])
        assert_families(ours[key], attrs)
    assert len(ours) == (3 if env_name == "sm_env" else 1)


def env_loader(trainer, env, phase):
    loaders = env.loaders if isinstance(trainer, PortTrainer) else env.jax_loaders
    return loaders[phase]


def test_device_path_equals_host_path_on_the_same_batches(none_env):
    """The port's sampled device path and its host path
    (``_neg_sample_batch_eval``) on one list of batches give one dict."""
    _, pt = none_env.pair()
    loader = none_env.loaders[1]
    kind = pt._prepare_eval(loader)
    np.random.seed(9)
    batches = list(pt._macro_batches(loader, kind))
    pt.model.eval()
    results = []
    with torch.no_grad():
        for path in ("fused", "host"):
            for batch in batches:
                if path == "fused":
                    pt._collect_batch(kind, batch)
                else:
                    _, scores, pu, pi = pt._neg_sample_batch_eval(batch)
                    pt.eval_collector.eval_batch_collect(scores, batch[0], pu, pi)
            results.append(pt.evaluator.evaluate(pt.eval_collector.get_data_struct()))
    assert_same_result(results[1], results[0])


@pytest.mark.parametrize("env_name", ["none_env", "sm_env"])
def test_sampled_host_path_matches_jax(request, env_name):
    """With GAUC beside the 12 metrics the rank curve is needed, so both
    packages score uni100 batches through the host path."""
    env = request.getfixturevalue(env_name)
    for config in (env.jax_config, env.config):
        config["metrics"] = PUBLISHED["metrics"] + ["GAUC"]
    try:
        jt, pt = env.pair()
        assert not pt._fused_eval_ok()
        ref, ours = _both(jt, pt, lambda t: t._valid_epoch(env_loader(t, env, 1)), 10)
        assert_same_result(ours[1], ref[1])
        assert "gauc" in ours[1]
        assert pt._last_eval_path == "sampled-host"
    finally:
        for config in (env.jax_config, env.config):
            config["metrics"] = PUBLISHED["metrics"]


def test_base_trainer_sizes_the_loader_back_for_the_host_path(none_env):
    """A loader that a device evaluation macro-sized is sized back by the
    base Trainer before a host evaluation, and left as it is by
    PFCNTrainer (as in the JAX package; the results do not depend on it)."""
    _, pt = none_env.pair()
    loader = none_env.loaders[1]
    pt._prepare_eval(loader)
    assert loader._macro_sized
    base = PortTrainer(pt.config, pt.model)
    pt.config["metrics"] = PUBLISHED["metrics"] + ["GAUC"]
    try:
        pt.eval_collector = type(pt.eval_collector)(pt.config)
        base.eval_collector = type(base.eval_collector)(pt.config)
        pt._prepare_eval(loader, reset_macro_rows=False)
        assert loader._macro_sized
        base._prepare_eval(loader)
        assert not loader._macro_sized
    finally:
        pt.config["metrics"] = PUBLISHED["metrics"]


@pytest.fixture(scope="module")
def labeled_env(tmp_path_factory):
    return Env(str(tmp_path_factory.mktemp("labeled")), extra={
        "filter_mode": "none", "eval_args": {**PUBLISHED["eval_args"], "mode": "labeled"},
        "metrics": ["AUC", "LogLoss", "MAE", "RMSE"], "valid_metric": "AUC",
        "eval_batch_size": 64})


def _columns_for_jax_loss_metrics(jt):
    """The JAX package's loss metrics squeeze the last axis with numpy,
    which raises on the [N] scores its labeled path collects (PyTorch's
    squeeze(-1), which the reference calls, leaves such an axis); the port
    repairs that in ``LossMetric.used_info``. The reference's numbers come
    from the same metric classes over the same collected values, given as
    [N, 1] columns."""
    evaluate = jt.evaluator.evaluate

    def on_columns(struct):
        for key in ("rec.score", "data.label"):
            struct.set(key, np.asarray(struct.get(key)).reshape(-1, 1))
        return evaluate(struct)

    jt.evaluator.evaluate = on_columns


def test_labeled_value_metrics_match_jax(labeled_env):
    """AUC, LogLoss, MAE and RMSE over the labeled rows (host path)."""
    jt, pt = labeled_env.pair()
    _columns_for_jax_loss_metrics(jt)
    for phase in (1, 2):
        ref, ours = _both(jt, pt, lambda t: t.evaluate(env_loader(t, labeled_env, phase),
                                                       load_best_model=False), 11)
        assert list(ours) == ["none"]
        assert_same_result(ours["none"], ref["none"])
        assert set(ours["none"]) == {"auc", "logloss", "mae", "rmse"}
    assert pt._last_eval_path == "sampled-host"


@pytest.fixture(scope="module")
def full_env(tmp_path_factory):
    return Env(str(tmp_path_factory.mktemp("full")), extra={
        "filter_mode": "none", "eval_args": {**PUBLISHED["eval_args"], "mode": "full"},
        "metrics": ["GAUC", "NDCG", "Recall"], "valid_metric": "NDCG@5"})


def test_full_sort_gauc_matches_jax(full_env):
    jt, pt = full_env.pair()
    for phase in (1, 2):
        ref = jt.evaluate(full_env.jax_loaders[phase], load_best_model=False)
        ours = pt.evaluate(full_env.loaders[phase], load_best_model=False)
        assert_same_result(ours["none"], ref["none"])
        assert "gauc" in ours["none"]
    assert pt._last_eval_path == "host"


def test_full_sort_host_path_scores_through_predict_without_full_sort_predict(
        full_env, monkeypatch):
    """A model without ``full_sort_predict`` is scored item by item through
    ``predict`` (``_predict_all_items_fallback``), in blocks of
    ``eval_batch_size`` rows: the same result."""
    _, pt = full_env.pair()
    expected = pt.evaluate(full_env.loaders[2], load_best_model=False)

    def missing(batch, sst_list=None):
        raise NotImplementedError

    monkeypatch.setattr(pt.model, "full_sort_predict", missing)
    monkeypatch.setattr(pt, "test_batch_size", 500)
    assert_same_result(pt.evaluate(full_env.loaders[2], load_best_model=False)["none"],
                       expected["none"])


def test_run_recbole_pfcn_published_protocol(tmp_path):
    """PFCN_PMF, ``sm`` over gender and age, trained and tested through
    ``run_recbole`` with the published protocol: one dict per subset, each
    with the 12 metric families."""
    cfg = published_config(write_dataset(str(tmp_path)), str(tmp_path / "saved"), {
        "filter_mode": "sm", "sst_attr_list": ["gender", "age"], "epochs": 2,
        "train_epoch_interval": 1, "use_gpu": False})
    result = port_pkg.run_recbole("PFCN_PMF", "fair", config_dict=cfg)
    assert list(result["test_result"]) == ["sm-['gender']", "sm-['age']",
                                           "sm-['gender', 'age']"]
    for res in result["test_result"].values():
        assert_families(res, ["gender", "age"])
    assert_families(result["best_valid_result"], ["gender", "age"])
