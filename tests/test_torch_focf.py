"""FOCF in the port against the JAX package, on the CPU: the loss and its
gradient for every ``fair_objective``, the item-grouped train loader,
training steps through ``fit`` and ``run_recbole`` with the published
protocol.

Both packages read the same data and start from the JAX package's initial
weights (carried over with ``load_jax_params``); batch order and negatives
come from numpy's global generator, seeded alike.

Tolerances (float32; the JAX side pads its batches and takes a weighted
mean, the port takes the plain mean, and the two sum in different orders):
one batch — loss rel 1e-6, gradients abs 1e-6; two epochs of ``fit`` —
epoch losses rel 1e-5, parameters abs 1e-5; metric dicts as in
``test_torch_sampled_eval.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recbole_fairrec_tpu as jax_pkg
import recbole_fairrec_tpu.trainer.trainer as jax_trainer_module

import recbole_fairrec_tpu_torch as port_pkg
import recbole_fairrec_tpu_torch.quick_start as port_quick_start
from recbole_fairrec_tpu_torch.data import FOCFDataLoader
from recbole_fairrec_tpu_torch.models.focf import FAIR_OBJECTIVES
from recbole_fairrec_tpu_torch.trainer import Trainer
from recbole_fairrec_tpu_torch.utils.jax_params import load_jax_params, to_jax_params
from test_torch_sampled_eval import (
    Env,
    assert_families,
    assert_same_result,
    published_config,
    write_dataset,
)
from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)

LOSS_RTOL, GRAD_ATOL = 1e-6, 1e-6
TRAJ_RTOL, TRAJ_ATOL = 1e-5, 1e-5
FOCF_EXTRA = {"train_batch_size": 128, "load_col": {
    "inter": ["user_id", "item_id", "rating"], "user": ["user_id", "gender"]}}


@pytest.fixture(scope="module")
def focf_env(tmp_path_factory):
    return Env(str(tmp_path_factory.mktemp("focf")), "FOCF",
               extra={**FOCF_EXTRA, "fair_objective": "value"})


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _first_batches(env, n, seed=3):
    out = []
    for loaders in (env.jax_loaders, env.loaders):
        np.random.seed(seed)
        it = iter(loaders[0])
        out.append([next(it) for _ in range(n)])
        loaders[0].pr = 0
    return out


def test_focf_loader_batches_match_jax(focf_env):
    """Every train batch holds whole item groups, drawn with
    ``np.random.permutation``; both packages draw the same ones."""
    jl, pl = focf_env.jax_loaders[0], focf_env.loaders[0]
    assert isinstance(pl, FOCFDataLoader)
    assert pl.max_batch_rows == jl.max_batch_rows
    jax_batches, port_batches = _first_batches(focf_env, len(pl))
    items = np.asarray(pl.dataset.inter_feat["item_id"])
    for jb, pb in zip(jax_batches, port_batches):
        assert sorted(jb.columns) == sorted(pb.columns)
        for col in jb.columns:
            np.testing.assert_array_equal(pb[col].numpy(), np.asarray(jb[col]), err_msg=col)
        batch_items, counts = np.unique(pb["item_id"].numpy(), return_counts=True)
        for item, count in zip(batch_items, counts):
            assert count == np.count_nonzero(items == item)  # the whole group


@pytest.mark.parametrize("objective", FAIR_OBJECTIVES)
def test_focf_loss_and_gradient_match_jax(focf_env, objective):
    cfgs = (focf_env.jax_config, focf_env.config)
    for config in cfgs:
        config["fair_objective"] = objective
    try:
        jax_model = type(focf_env.jax_model)(focf_env.jax_config,
                                             focf_env.jax_loaders[0].dataset)
        port_model = port_pkg.utils.get_model("FOCF")(focf_env.config,
                                                      focf_env.loaders[0].dataset)
        load_jax_params(port_model, focf_env.params)
        (jb,), (pb,) = _first_batches(focf_env, 1)
        batch = {k: jnp.asarray(np.asarray(jb[k]))
                 for k in jax_model.loss_batch_fields("calculate_loss") if k in jb}

        def jax_loss(params):
            return jax_model.calculate_loss(params, {}, batch)[0]

        params = jax.tree_util.tree_map(jnp.asarray, focf_env.params)
        ref_loss, ref_grads = jax.value_and_grad(jax_loss)(params)
        loss = port_model.calculate_loss(
            {k: pb[k] for k in port_model.loss_batch_fields("calculate_loss") if k in pb})
        loss.backward()
        assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=LOSS_RTOL)
        for key in ("user_embedding", "item_embedding"):
            np.testing.assert_allclose(getattr(port_model, key).weight.grad.numpy(),
                                       np.asarray(ref_grads[key]), rtol=0, atol=GRAD_ATOL,
                                       err_msg=key)
    finally:
        for config in cfgs:
            config["fair_objective"] = "value"


def test_focf_fit_matches_jax(focf_env):
    """Two epochs of ``fit`` (Adam, weight decay 1e-3), a uni100 validation
    after each, on the same initial weights and the same batches."""
    for config in (focf_env.jax_config, focf_env.config):
        config["epochs"] = 2
    jt, pt = focf_env.pair()
    assert type(pt) is Trainer
    np.random.seed(12)
    jt.fit(focf_env.jax_loaders[0], focf_env.jax_loaders[1], saved=False, verbose=False)
    np.random.seed(12)
    pt.fit(focf_env.loaders[0], focf_env.loaders[1], saved=False, verbose=False)
    assert sorted(pt.train_loss_dict) == [0, 1]
    for epoch, ref in jt.train_loss_dict.items():
        assert pt.train_loss_dict[epoch] == pytest.approx(ref, rel=TRAJ_RTOL)
    ours = to_jax_params(pt.model)
    for key, ref in _np_tree(jt.params).items():
        np.testing.assert_allclose(ours[key], ref, rtol=0, atol=TRAJ_ATOL, err_msg=key)
    assert_same_result(pt.best_valid_result, jt.best_valid_result)
    assert pt._last_eval_path == "sampled-fused"


def _capture_jax_init(monkeypatch):
    """Record the initial parameters of every JAX trainer built."""
    inits = []
    init = jax_trainer_module.Trainer.__init__

    def recording(self, config, model):
        init(self, config, model)
        inits.append(_np_tree(self.params))

    monkeypatch.setattr(jax_trainer_module.Trainer, "__init__", recording)
    return inits


def _port_models_start_from(monkeypatch, params_list):
    """The port's ``run_recbole`` builds each model and then gives it the
    next parameters of ``params_list``."""
    get_model = port_quick_start.get_model

    def patched(name):
        cls = get_model(name)

        def build(*args, **kwargs):
            model = cls(*args, **kwargs)
            load_jax_params(model, params_list.pop(0))
            return model

        return build

    monkeypatch.setattr(port_quick_start, "get_model", patched)


def test_focf_run_recbole_matches_jax(tmp_path, monkeypatch):
    """``run_recbole`` of FOCF with ``fair_objective: value`` and the
    published protocol: the same result as the JAX package's from the same
    initial weights, every one of the 12 metric families."""
    root = write_dataset(str(tmp_path))
    cfg = published_config(root, str(tmp_path / "saved"),
                           {**FOCF_EXTRA, "fair_objective": "value", "epochs": 2})
    inits = _capture_jax_init(monkeypatch)
    ref = jax_pkg.run_recbole("FOCF", "fair", config_dict=dict(cfg))
    _port_models_start_from(monkeypatch, list(inits))
    ours = port_pkg.run_recbole("FOCF", "fair", config_dict={**cfg, "use_gpu": False})
    assert ours["best_valid_score"] == pytest.approx(ref["best_valid_score"], abs=1e-9)
    assert_same_result(ours["best_valid_result"], ref["best_valid_result"])
    assert_same_result(ours["test_result"], ref["test_result"])
    assert_families(ours["test_result"], ["gender"])
