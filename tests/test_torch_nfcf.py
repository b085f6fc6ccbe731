"""NFCF in the port against the JAX package, on the CPU: the scorer, its
BCE loss and the ε-differential-fairness penalty, the debiased finetune
built from a pretrain checkpoint of either package, the frozen user table,
and the two-stage ``run_recbole`` with the published protocol.

Both packages read the same data and start from the JAX package's weights
(``load_jax_params``); batch order and negatives come from numpy's global
generator, seeded alike. Dropout is 0: the two packages' generators cannot
match draw for draw.

Tolerances (float32): one batch — loss rel 1e-6, gradients and scores abs
1e-6; the debiased user table exact (the same numpy float32 arithmetic);
one finetune epoch — loss rel 1e-5, parameters abs 1e-5; metric dicts as
in ``test_torch_sampled_eval.py``.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recbole_fairrec_tpu as jax_pkg
from recbole_fairrec_tpu.utils import get_trainer as jax_get_trainer

import recbole_fairrec_tpu_torch as port_pkg
from recbole_fairrec_tpu_torch.trainer import Trainer
from recbole_fairrec_tpu_torch.utils import get_model, get_trainer
from recbole_fairrec_tpu_torch.utils.jax_params import _flatten, load_jax_params, to_jax_params
from test_torch_focf import _capture_jax_init, _np_tree, _port_models_start_from
from test_torch_sampled_eval import (
    Env,
    assert_families,
    assert_same_result,
    published_config,
    write_dataset,
)
from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)

LOSS_RTOL, ATOL = 1e-6, 1e-6
TRAJ_RTOL, TRAJ_ATOL = 1e-5, 1e-5
NFCF_EXTRA = {"train_batch_size": 128, "load_col": {
    "inter": ["user_id", "item_id", "rating"], "user": ["user_id", "gender"]}}


@pytest.fixture(scope="module")
def nfcf_env(tmp_path_factory):
    return Env(str(tmp_path_factory.mktemp("nfcf")), "NFCF", extra=NFCF_EXTRA)


def _set_pretrain(env, path):
    for config in (env.jax_config, env.config):
        config["load_pretrain_path"] = path


def _write_checkpoint(env, writer, path):
    """A checkpoint holding ``env.params``, written by either package."""
    _set_pretrain(env, None)
    jt, pt = env.pair()
    (jt if writer == "jax" else pt)._save_checkpoint(0, verbose=False, saved_model_file=path)


def _finetune_pair(env, path):
    """The JAX package's finetune initialisation from ``path`` (its own
    key) and a port model built from the same checkpoint."""
    _set_pretrain(env, path)
    jax_model = type(env.jax_model)(env.jax_config, env.jax_loaders[0].dataset)
    jax_params, _ = jax_model.init_params(jax.random.PRNGKey(1))
    port_model = get_model("NFCF")(env.config, env.loaders[0].dataset)
    return jax_model, _np_tree(jax_params), port_model


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_debias_from_pretrain_matches_jax(nfcf_env, tmp_path, writer):
    """The gender direction projected out of every user embedding, exactly
    as the JAX package does it, from a checkpoint of either package; the MLP
    is the pretrained one; the item table is the fresh initialisation."""
    path = str(tmp_path / f"pretrain-{writer}.pth")
    _write_checkpoint(nfcf_env, writer, path)
    try:
        _, jax_params, port_model = _finetune_pair(nfcf_env, path)
        ours = to_jax_params(port_model)
        np.testing.assert_array_equal(ours["user_embedding"], jax_params["user_embedding"])
        assert not np.array_equal(ours["user_embedding"], nfcf_env.params["user_embedding"])
        for key, value in _flatten(nfcf_env.params["mlp"]).items():
            np.testing.assert_array_equal(_flatten(ours["mlp"])[key], value)
        _set_pretrain(nfcf_env, None)
        fresh = get_model("NFCF")(nfcf_env.config, nfcf_env.loaders[0].dataset)
        np.testing.assert_array_equal(ours["item_embedding"],
                                      fresh.item_embedding.weight.detach().numpy())
        assert not np.array_equal(ours["item_embedding"], nfcf_env.params["item_embedding"])
        assert port_model.frozen_param_keys() == ["user_embedding"]
        assert fresh.frozen_param_keys() == []
    finally:
        _set_pretrain(nfcf_env, None)


def _one_batch(env):
    out = []
    for loaders in (env.jax_loaders, env.loaders):
        np.random.seed(3)
        out.append(next(iter(loaders[0])))
        loaders[0].pr = 0
    return out


@pytest.mark.parametrize("stage", ["pretrain", "finetune"])
def test_nfcf_forward_loss_and_penalty_match_jax(nfcf_env, tmp_path, stage):
    """Scores, BCE (pretrain) or BCE + fair_weight · ε-DF (finetune), and
    the gradients, on one batch of positives and sampled negatives."""
    path = str(tmp_path / "pretrain.pth")
    _write_checkpoint(nfcf_env, "port", path)
    try:
        if stage == "finetune":
            jax_model, params, port_model = _finetune_pair(nfcf_env, path)
            load_jax_params(port_model, params)
        else:
            jax_model, params = nfcf_env.jax_model, nfcf_env.params
            port_model = get_model("NFCF")(nfcf_env.config, nfcf_env.loaders[0].dataset)
            load_jax_params(port_model, params)
        jb, pb = _one_batch(nfcf_env)
        fields = port_model.loss_batch_fields("calculate_loss")
        batch = {k: jnp.asarray(np.asarray(jb[k])) for k in fields if k in jb}
        jparams = jax.tree_util.tree_map(jnp.asarray, params)

        def jax_loss(p):
            return jax_model.calculate_loss(p, {}, batch)[0]

        ref_loss, ref_grads = jax.value_and_grad(jax_loss)(jparams)
        port_model.train()
        loss = port_model.calculate_loss({k: pb[k] for k in fields if k in pb})
        loss.backward()
        assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=LOSS_RTOL)
        grads = _flatten({"user_embedding": port_model.user_embedding.weight.grad,
                          "item_embedding": port_model.item_embedding.weight.grad,
                          "mlp": {"linear": [{"w": lin.w.grad, "b": lin.b.grad}
                                             for lin in port_model.mlp.linear]}})
        for key, ref in _flatten(_np_tree(ref_grads)).items():
            np.testing.assert_allclose(grads[key].numpy(), ref, rtol=0, atol=ATOL, err_msg=key)

        ref_fair = jax_model._differential_fairness(batch, jax_model.forward(
            jparams, batch["user_id"], batch["item_id"]), jnp.ones(len(pb)))
        with torch.no_grad():
            out = port_model.forward(pb["user_id"], pb["item_id"])
            fair = port_model._differential_fairness(
                {k: pb[k] for k in fields if k in pb}, out, torch.ones(len(pb)))
            scores = port_model.predict({"user_id": pb["user_id"], "item_id": pb["item_id"]})
        assert float(fair) == pytest.approx(float(ref_fair), rel=LOSS_RTOL)
        ref_scores = jax_model.predict(jparams, {}, batch)
        np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=0, atol=ATOL)
    finally:
        _set_pretrain(nfcf_env, None)


def test_user_table_stays_frozen_through_finetune(nfcf_env, tmp_path):
    """One finetune epoch: the user table is the debiased one bit for bit,
    the item table and the MLP moved, and both equal the JAX package's."""
    path = str(tmp_path / "pretrain.pth")
    _write_checkpoint(nfcf_env, "port", path)
    try:
        jax_model, params, port_model = _finetune_pair(nfcf_env, path)
        load_jax_params(port_model, params)
        pt = get_trainer(nfcf_env.config["MODEL_TYPE"], "NFCF")(nfcf_env.config, port_model)
        assert type(pt) is Trainer
        jt = jax_get_trainer(nfcf_env.jax_config["MODEL_TYPE"], "NFCF")(
            nfcf_env.jax_config, jax_model)
        jt.params = jax.tree_util.tree_map(jnp.asarray, params)
        jt.opt_state = jt.optimizer.init(jt.params)
        before = to_jax_params(port_model)
        np.random.seed(5)
        ref = jt._run_epoch(nfcf_env.jax_loaders[0])
        np.random.seed(5)
        loss = pt._run_epoch(nfcf_env.loaders[0])
        assert loss == pytest.approx(ref, rel=TRAJ_RTOL)
        after = to_jax_params(port_model)
        np.testing.assert_array_equal(after["user_embedding"], before["user_embedding"])
        assert not port_model.user_embedding.weight.requires_grad
        assert not np.array_equal(after["item_embedding"], before["item_embedding"])
        for key, value in _flatten(_np_tree(jt.params)).items():
            np.testing.assert_allclose(_flatten(after)[key], value, rtol=0, atol=TRAJ_ATOL,
                                       err_msg=key)
    finally:
        _set_pretrain(nfcf_env, None)


def test_nfcf_two_stage_run_recbole_matches_jax(tmp_path, monkeypatch):
    """Pretrain, then finetune from that stage's checkpoint, each through
    ``run_recbole`` with the published protocol; each stage starts from the
    JAX package's initial weights for it and returns its result."""
    root = write_dataset(str(tmp_path))
    results = {}
    for side in ("jax", "port"):
        work = tmp_path / side
        cfg = published_config(root, str(work / "saved"), {**NFCF_EXTRA, "epochs": 2})
        if side == "port":
            cfg["use_gpu"] = False
        run = jax_pkg.run_recbole if side == "jax" else port_pkg.run_recbole
        if side == "jax":
            inits = _capture_jax_init(monkeypatch)
        else:
            _port_models_start_from(monkeypatch, inits)
        pre = run("NFCF", "fair", config_dict=dict(cfg))
        pretrain_ckpt = glob.glob(str(work / "saved" / "NFCF-*.pth"))
        assert len(pretrain_ckpt) == 1
        fine = run("NFCF", "fair", config_dict={**cfg,
                                                "load_pretrain_path": pretrain_ckpt[0]})
        results[side] = (pre, fine)
        if side == "jax":
            inits = list(inits)
    for ref, ours in zip(results["jax"], results["port"]):
        assert_same_result(ours["best_valid_result"], ref["best_valid_result"])
        assert_same_result(ours["test_result"], ref["test_result"])
        assert_families(ours["test_result"], ["gender"])
