"""The training slice as a whole: BPR-MF (PFCN_PMF, ``filter_mode: none``)
trained by the port on the CPU against the JAX package.

Both sides read the same data; weights are carried over with
``load_jax_params`` (never compared by seed), and both draw batch order and
host negatives from numpy's global generator, seeded alike before each run.

Tolerances (float32; the JAX side pads its batches and takes a weighted
mean, the port takes the plain mean, and the two sum in different orders):
one step — loss rtol 1e-6, parameters atol 1e-6 (5e-6 for Adagrad with weight
decay, see ``test_steps_match_jax``); three epochs — per-epoch
loss rtol 1e-4 (measured gap 5e-7 relative), final parameters atol 1e-4
(measured 2.1e-6 on ml-100k), validation scores and results equal to 1e-6.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recbole_fairrec_tpu as jax_pkg
from recbole_fairrec_tpu.config import Config as JaxConfig
from recbole_fairrec_tpu.data import create_dataset as jax_create_dataset
from recbole_fairrec_tpu.data import data_preparation as jax_data_preparation
from recbole_fairrec_tpu.trainer import PFCN_PMFTrainer as JaxPFCNPMFTrainer
from recbole_fairrec_tpu.trainer import Trainer as JaxBaseTrainer
from recbole_fairrec_tpu.utils import get_model as jax_get_model
from recbole_fairrec_tpu.utils import get_trainer as jax_get_trainer
from recbole_fairrec_tpu.utils import init_seed as jax_init_seed

import recbole_fairrec_tpu_torch as port_pkg
from recbole_fairrec_tpu_torch import Config, load_data_and_model
from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
from recbole_fairrec_tpu_torch.quick_start import load_checkpoint
from recbole_fairrec_tpu_torch.trainer import PFCN_PMFTrainer, PFCNTrainer, Trainer
from recbole_fairrec_tpu_torch.trainer.optim import clip_by_global_norm
from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed
from recbole_fairrec_tpu_torch.utils.jax_params import (
    load_jax_opt_state,
    load_jax_params,
    to_jax_params,
)
from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)

TRAINER_DEFAULTS = {
    "learner": "adam", "learning_rate": 0.001, "weight_decay": 0.0, "clip_grad_norm": None,
    "epochs": 3, "eval_step": 1, "stopping_step": 10, "reg_weight": None,
    "neg_sampling": {"uniform": 1}, "device_neg_sampling": False,
}


def _cfg(data_path, ckpt_dir, dataset):
    cfg = {
        "data_path": data_path,
        "load_col": {"inter": ["user_id", "item_id", "rating"], "user": ["user_id", "gender"]},
        "filter_mode": "none",
        "embedding_size": 16,
        "train_batch_size": 64 if dataset == "tiny" else 2048,
        "eval_args": {"split": {"RS": [8, 1, 1]}, "order": "RO",
                      "group_by": "user", "mode": "full"},
        "metrics": ["NDCG", "Recall", "Hit", "MRR"],
        "topk": [10],
        "valid_metric": "NDCG@10",
        "show_progress": False,
        "save_sst_embed": False,
        "state": "ERROR",
        "checkpoint_dir": ckpt_dir,
        "log_root": os.path.join(ckpt_dir, "log"),
        **TRAINER_DEFAULTS,
    }
    if dataset == "tiny":
        cfg["threshold"] = {"rating": 3.0}
    return cfg


class _Env:
    """Both packages' configs, loaders and model descriptors over one
    dataset. ``pair`` makes a fresh trainer on each side with the same
    weights and with both train sets back in their first order."""

    def __init__(self, cfg, dataset):
        self.dataset = dataset
        self.jax_config = JaxConfig(model="PFCN_PMF", dataset=dataset, config_dict=cfg)
        jax_init_seed(self.jax_config["seed"], True)
        self.jax_loaders = jax_data_preparation(self.jax_config, jax_create_dataset(self.jax_config))
        self.jax_model = jax_get_model("PFCN_PMF")(self.jax_config, self.jax_loaders[0].dataset)

        self.config = Config(model="PFCN_PMF", dataset=dataset,
                             config_dict={**cfg, "use_gpu": False})
        self.generator = init_seed(self.config["seed"], True)
        self.loaders = data_preparation(self.config, create_dataset(self.config))
        self._order = [dict(l[0].dataset.inter_feat.interaction)
                       for l in (self.jax_loaders, self.loaders)]

    def reset_order(self):
        for loaders, order in zip((self.jax_loaders, self.loaders), self._order):
            loaders[0].dataset.inter_feat.interaction = dict(order)
            loaders[0].pr = 0

    def _set(self, overrides):
        for config in (self.jax_config, self.config):
            for key, value in {**TRAINER_DEFAULTS, **overrides}.items():
                config[key] = value
            config["eval_step"] = min(config["eval_step"], config["epochs"])

    def jax_trainer(self, base=False, **overrides):
        self._set(overrides)
        if base:
            return JaxBaseTrainer(self.jax_config, self.jax_model)
        return jax_get_trainer(self.jax_config["MODEL_TYPE"], "PFCN_PMF")(
            self.jax_config, self.jax_model)

    def port_trainer(self, params, base=False, **overrides):
        self._set(overrides)
        model = get_model("PFCN_PMF")(self.config, self.loaders[0].dataset,
                                      generator=self.generator)
        load_jax_params(model, params)
        cls = Trainer if base else get_trainer(self.config["MODEL_TYPE"], "PFCN_PMF")
        return cls(self.config, model)

    def pair(self, **overrides):
        self.reset_order()
        jt = self.jax_trainer(**overrides)
        return jt, self.port_trainer(_np_tree(jt.params), **overrides)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_params(trainer):
    return to_jax_params(trainer.model)


def _assert_params_close(jax_params, port_params, atol):
    jax_params = _np_tree(jax_params)
    assert set(jax_params) == set(port_params)
    for name, value in jax_params.items():
        np.testing.assert_allclose(port_params[name], value, rtol=0, atol=atol, err_msg=name)


@pytest.fixture(scope="module", params=["tiny", "ml-100k"])
def env(request, tmp_path_factory):
    from conftest import REPO_ROOT, make_tiny_dataset

    root = tmp_path_factory.mktemp("train" + request.param.replace("-", ""))
    if request.param == "tiny":
        data_path = make_tiny_dataset(str(root))
    else:
        data_path = os.path.join(REPO_ROOT, "dataset")
    return _Env(_cfg(data_path, str(root / "saved"), request.param), request.param)


@pytest.fixture(scope="module")
def tiny_env(tmp_path_factory):
    from conftest import make_tiny_dataset

    root = tmp_path_factory.mktemp("traintinyonly")
    return _Env(_cfg(make_tiny_dataset(str(root)), str(root / "saved"), "tiny"), "tiny")


# ------------------------------------------------------------------ one step


def _host_batches(env, n):
    """The first ``n`` train batches with host negatives, as each package's
    loader yields them from the same numpy seed."""
    env.reset_order()
    out = []
    for loaders in (env.jax_loaders, env.loaders):
        np.random.seed(3)
        it = iter(loaders[0])
        out.append([next(it) for _ in range(n)])
        loaders[0].pr = 0
    return out


def _jax_steps(jt, interactions):
    step = jt._make_step("calculate_loss", None, jt.optimizer)
    losses = []
    for interaction in interactions:
        batch = {k: jnp.asarray(v) for k, v in jt._to_batch(interaction).items()}
        loss, jt.params, jt.model_state, jt.opt_state = step(
            jt.params, jt.model_state, jt.opt_state, jax.random.PRNGKey(0), batch)
        losses.append(float(loss))
    return losses


def _port_steps(pt, interactions):
    pt.model.train()
    return [
        float(pt._train_step(pt._train_batch(i), "calculate_loss", None, pt.optimizer))
        for i in interactions
    ]


@pytest.mark.parametrize("clip", [None, 0.05], ids=["noclip", "clip"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01], ids=["nowd", "wd"])
@pytest.mark.parametrize("learner", ["adam", "sgd", "adagrad", "rmsprop", "sparse_adam"])
def test_steps_match_jax(tiny_env, learner, weight_decay, clip):
    """Three steps (so that the moments and accumulators count) on the same
    batches with the same negatives. The N(0, 1) tables give a gradient norm
    far above 0.05, so the clipped cases do clip.

    Adagrad with weight decay and no clipping gets atol 5e-6 (measured gap
    2.7e-6 on one element of 656): there the loss gradient and the decay term
    cancel to 5e-6 of 4e-3, so float32 noise of 3e-7 relative in the gradient
    is 1e-3 relative in their sum, and Adagrad's first step, lr * g /
    sqrt(g^2 + 1e-10) with g^2 below eps, carries that on in full."""
    overrides = {"learner": learner, "weight_decay": weight_decay, "learning_rate": 0.01,
                 "clip_grad_norm": {"max_norm": clip} if clip else None}
    jt, pt = tiny_env.pair(**overrides)
    jax_batches, port_batches = _host_batches(tiny_env, 3)
    for a, b in zip(jax_batches, port_batches):
        for key in ("user_id", "item_id", "neg_item_id"):
            np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy())
    before = _port_params(pt)
    ref_losses = _jax_steps(jt, jax_batches)
    losses = _port_steps(pt, port_batches)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    cancelling = (learner, weight_decay, clip) == ("adagrad", 0.01, None)
    _assert_params_close(jt.params, _port_params(pt), atol=5e-6 if cancelling else 1e-6)
    assert np.abs(_port_params(pt)["user_embedding"] - before["user_embedding"]).max() > 1e-4


def test_clip_by_global_norm_leaves_small_gradients_alone():
    p = torch.nn.Parameter(torch.ones(4))
    p.grad = torch.full((4,), 0.1)
    norm = clip_by_global_norm([p], 1.0)
    assert float(norm) == pytest.approx(0.2)
    assert torch.equal(p.grad, torch.full((4,), 0.1))
    clip_by_global_norm([p], 0.1)
    assert float(torch.linalg.vector_norm(p.grad)) == pytest.approx(0.1, rel=1e-6)


def test_optimizer_warnings(tiny_env, caplog):
    jt, _ = tiny_env.pair()
    params = _np_tree(jt.params)
    with caplog.at_level("WARNING"):
        pt = tiny_env.port_trainer(params, learner="sparse_adam", weight_decay=0.1)
        assert "Sparse Adam" in caplog.text
        assert pt.optimizer.param_groups[0]["weight_decay"] == 0.0
        caplog.clear()
        pt = tiny_env.port_trainer(params, learner="lion")
        assert "unrecognized optimizer" in caplog.text and isinstance(pt.optimizer, torch.optim.Adam)
        caplog.clear()
        tiny_env.port_trainer(params, weight_decay=0.1, reg_weight=0.1)
        assert "double regularization" in caplog.text


def test_masked_and_frozen_optimizers(tiny_env):
    jt, pt = tiny_env.pair()
    masked = pt._masked_tx(["item_embedding"], learner="sgd")
    assert [p is pt.model.item_embedding.weight for g in masked.param_groups
            for p in g["params"]] == [True]
    pt.model.frozen_param_keys = lambda: ["user_embedding"]
    opt = pt._build_optimizer()
    assert [p is pt.model.item_embedding.weight for g in opt.param_groups
            for p in g["params"]] == [True]
    assert not pt.model.user_embedding.weight.requires_grad


# ---------------------------------------------------------------- trajectory


def _fit(trainer, loaders, seed=5, saved=True):
    scores = []
    np.random.seed(seed)
    best = trainer.fit(loaders[0], loaders[1], saved=saved, verbose=False,
                       callback_fn=lambda epoch, score: scores.append(score))
    return best, scores


def test_three_epoch_trajectory_matches_jax(env):
    jt, pt = env.pair()
    (ref_score, ref_result), ref_scores = _fit(jt, env.jax_loaders)
    (score, result), scores = _fit(pt, env.loaders)
    assert sorted(pt.train_loss_dict) == sorted(jt.train_loss_dict) == [0, 1, 2]
    np.testing.assert_allclose(
        [pt.train_loss_dict[e] for e in range(3)], [jt.train_loss_dict[e] for e in range(3)],
        rtol=1e-4)
    _assert_params_close(jt.params, _port_params(pt), atol=1e-4)
    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-6)
    assert score == pytest.approx(ref_score, abs=1e-6)
    assert dict(result) == pytest.approx(dict(ref_result), abs=1e-6)
    ours, ref = pt.evaluate(env.loaders[2]), jt.evaluate(env.jax_loaders[2])
    assert list(ours) == list(ref) == ["none"]
    assert dict(ours["none"]) == pytest.approx(dict(ref["none"]), abs=1e-6)


def test_dynamic_negatives_trajectory_matches_jax(tiny_env):
    overrides = {"neg_sampling": {"uniform": 1, "dynamic": 2}, "epochs": 2}
    tiny_env.reset_order()
    for config in (tiny_env.jax_config, tiny_env.config):
        config["train_neg_sample_args"] = {"strategy": "by", "by": 1,
                                           "distribution": "uniform", "dynamic": 2}
    try:
        tiny_env.jax_loaders[0].update_config(tiny_env.jax_config)
        tiny_env.loaders[0].update_config(tiny_env.config)
        jt, pt = tiny_env.pair(**overrides)
        _fit(jt, tiny_env.jax_loaders, saved=False)
        _fit(pt, tiny_env.loaders, saved=False)
        np.testing.assert_allclose(
            [pt.train_loss_dict[e] for e in range(2)], [jt.train_loss_dict[e] for e in range(2)],
            rtol=1e-4)
        _assert_params_close(jt.params, _port_params(pt), atol=1e-4)
    finally:
        for config, loaders in ((tiny_env.jax_config, tiny_env.jax_loaders),
                                (tiny_env.config, tiny_env.loaders)):
            config["train_neg_sample_args"] = {"strategy": "by", "by": 1,
                                               "distribution": "uniform", "dynamic": "none"}
            loaders[0].update_config(config)


def test_early_stopping_stops_at_the_same_epoch(tiny_env):
    jt, pt = tiny_env.pair(epochs=8, stopping_step=1)
    (ref_score, _), ref_scores = _fit(jt, tiny_env.jax_loaders, saved=False)
    (score, _), scores = _fit(pt, tiny_env.loaders, saved=False)
    assert len(scores) == len(ref_scores) < 8  # stopped early, after the same validation
    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-6)
    assert (score, pt.cur_step) == (pytest.approx(ref_score, abs=1e-6), jt.cur_step)
    assert sorted(pt.train_loss_dict) == sorted(jt.train_loss_dict)


def test_device_negatives_train_on_cpu(tiny_env):
    """``device_neg_sampling``: the loader ships raw positives and the step
    draws the negatives from the trainer's own generator; no drawn pair is a
    train pair, and a second trainer with the same seed repeats the run."""
    tiny_env.reset_order()
    tiny_env.config["device_neg_sampling"] = True
    loader = tiny_env.loaders[0]
    try:
        loader.update_config(tiny_env.config)
        assert loader.device_neg_sampling
        params = _np_tree(tiny_env.jax_trainer().params)
        runs = []
        for _ in range(2):
            tiny_env.reset_order()
            pt = tiny_env.port_trainer(params, device_neg_sampling=True, epochs=4,
                                       learning_rate=0.05)
            seen = []
            inject = pt._inject_negatives
            pt._inject_negatives = lambda batch, name: seen.append(inject(batch, name)) or seen[-1]
            np.random.seed(5)
            pt.fit(loader, None, saved=False, verbose=False)
            runs.append([pt.train_loss_dict[e] for e in range(4)])
        assert runs[0] == runs[1]
        assert runs[0][-1] < runs[0][0]
        ds = loader.dataset
        taken = set(zip(np.asarray(ds.inter_feat[ds.uid_field]).tolist(),
                        np.asarray(ds.inter_feat[ds.iid_field]).tolist()))
        for batch in seen:
            assert "neg_item_id" in batch and batch["neg_item_id"].shape == batch["user_id"].shape
            pairs = zip(batch["user_id"].tolist(), batch["neg_item_id"].tolist())
            assert not any(p in taken for p in pairs)
            assert int(batch["neg_item_id"].min()) >= 1
    finally:
        tiny_env.config["device_neg_sampling"] = False
        loader.update_config(tiny_env.config)


# -------------------------------------------------------- resume, checkpoints


def test_resume_continues_the_straight_run(tiny_env):
    """Two epochs, a checkpoint, ``resume_checkpoint`` in a new trainer, one
    more epoch: the third epoch's loss and the final parameters equal the
    straight three-epoch run's exactly (same device, same operations)."""
    jt, straight = tiny_env.pair(epochs=3)
    params = _np_tree(jt.params)
    _fit(straight, tiny_env.loaders, saved=False)

    tiny_env.reset_order()
    first = tiny_env.port_trainer(params, epochs=2)
    _fit(first, tiny_env.loaders, saved=False)
    rng_state = np.random.get_state()
    ckpt = os.path.join(first.checkpoint_dir, "resume-me.pth")
    first._save_checkpoint(1, verbose=False, saved_model_file=ckpt)

    second = tiny_env.port_trainer(params, epochs=3)
    second.resume_checkpoint(ckpt)
    assert (second.start_epoch, second.cur_step) == (2, first.cur_step)
    assert second.best_valid_score == first.best_valid_score
    np.random.set_state(rng_state)
    second.fit(tiny_env.loaders[0], tiny_env.loaders[1], saved=False, verbose=False)
    assert list(second.train_loss_dict) == [2]
    assert second.train_loss_dict[2] == straight.train_loss_dict[2]
    for name, value in _port_params(straight).items():
        np.testing.assert_array_equal(_port_params(second)[name], value)


@pytest.mark.parametrize("route", ["tree", "checkpoint"])
@pytest.mark.parametrize("weight_decay,clip", [(0.0, None), (0.01, 0.05)], ids=["plain", "wd-clip"])
def test_jax_adam_state_carried_over(tiny_env, route, weight_decay, clip, tmp_path):
    """Two JAX steps, then the parameters and the Adam state go over to the
    port (as the optax tree, or through a checkpoint the JAX trainer wrote):
    the third step is the same in both."""
    overrides = {"weight_decay": weight_decay, "learning_rate": 0.01,
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
        pt = tiny_env.port_trainer(_np_tree(tiny_env.jax_trainer(**overrides).params), **overrides)
        pt.resume_checkpoint(ckpt)
        assert pt.start_epoch == 2
    state = pt.optimizer.state[pt.model.user_embedding.weight]
    assert float(state["step"]) == 2.0
    ref_loss = _jax_steps(jt, jax_batches[2:])
    loss = _port_steps(pt, port_batches[2:])
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
    _assert_params_close(jt.params, _port_params(pt), atol=1e-6)


@pytest.mark.parametrize("learner", ["adagrad", "rmsprop"])
def test_other_jax_optimizer_state_is_refused(tiny_env, learner, tmp_path):
    """A JAX Adagrad or RMSprop state goes only into the same learner (the
    carry-over itself: ``tests/test_torch_aux.py``); into the port's Adam it
    is refused by name."""
    jt, _ = tiny_env.pair(learner=learner)
    ckpt = str(tmp_path / "jax-other.pth")
    jt._save_checkpoint(0, verbose=False, saved_model_file=ckpt)
    pt = tiny_env.port_trainer(_np_tree(jt.params), learner="adam")
    with pytest.raises(NotImplementedError, match=learner):
        pt.resume_checkpoint(ckpt)
    with pytest.raises(NotImplementedError, match=learner):
        load_jax_opt_state(pt.optimizer, pt.model, _np_tree(jt.opt_state))


def test_adam_state_into_another_optimizer_is_refused(tiny_env):
    jt, _ = tiny_env.pair()
    pt = tiny_env.port_trainer(_np_tree(jt.params), learner="sgd")
    with pytest.raises(NotImplementedError, match="adam"):
        load_jax_opt_state(pt.optimizer, pt.model, _np_tree(jt.opt_state))


def test_port_checkpoint_loads_into_jax_trainer(env):
    """A checkpoint the port wrote after training holds no torch object and
    its ``params`` are keyed as the JAX package keys them: the JAX trainer
    loads it and evaluates to the same dict."""
    _, pt = env.pair(epochs=1)
    _fit(pt, env.loaders, saved=True)
    with open(pt.saved_model_file, "rb") as f:
        checkpoint = pickle.load(f)
    assert set(checkpoint["params"]) == {"user_embedding", "item_embedding"}
    assert {"optimizer", "optimizer_filter", "optimizer_dis"} <= set(checkpoint)
    assert checkpoint["optimizer_filter"] is None and checkpoint["optimizer_dis"] is None
    assert isinstance(checkpoint["optimizer"]["state"][0]["exp_avg"], np.ndarray)

    jt = env.jax_trainer()
    jt.eval_collector.data_collect(env.jax_loaders[0])
    ref = jt.evaluate(env.jax_loaders[2], load_best_model=True, model_file=pt.saved_model_file)
    ours = pt.evaluate(env.loaders[2])  # load_best_model defaults to True
    assert dict(ours["none"]) == dict(ref["none"])
    for name, value in _np_tree(jt.params).items():
        np.testing.assert_array_equal(value, checkpoint["params"][name])


def test_to_jax_params_round_trip(tiny_env):
    _, pt = tiny_env.pair()
    tree = to_jax_params(pt.model)
    assert set(tree) == {"user_embedding", "item_embedding"}
    other = tiny_env.port_trainer({k: np.zeros_like(v) for k, v in tree.items()})
    load_jax_params(other.model, tree)
    for name, value in tree.items():
        np.testing.assert_array_equal(to_jax_params(other.model)[name], value)


# -------------------------------------------------------------- entry points


def _nesting(value):
    if isinstance(value, dict):
        return {k: _nesting(v) for k, v in value.items()}
    return type(value).__name__ if not isinstance(value, (float, np.floating)) else "float"


@pytest.mark.parametrize("saved", [True, False], ids=["saved", "unsaved"])
def test_run_recbole_returns_the_jax_structure(tiny_data_path, tmp_path, saved):
    cfg = _cfg(tiny_data_path, str(tmp_path / "saved"), "tiny")
    cfg["epochs"] = 2
    ref = jax_pkg.run_recbole("PFCN_PMF", "tiny", config_dict=dict(cfg), saved=saved)
    ours = port_pkg.run_recbole("PFCN_PMF", "tiny", config_dict={**cfg, "use_gpu": False},
                                saved=saved)
    assert _nesting(ours) == _nesting(ref)
    assert list(ours["test_result"]) == ["none"]
    assert all(0.0 <= v <= 1.0 for v in ours["test_result"]["none"].values())
    ckpts = [f for f in os.listdir(tmp_path / "saved") if f.endswith(".pth")]
    assert bool(ckpts) == saved


def test_run_recbole_default_exports_sst_embeddings(tiny_data_path, tmp_path):
    """PFCN_PMF's own default is ``save_sst_embed: True``: the export of the
    best checkpoint's user embeddings equals the JAX package's layout."""
    cfg = _cfg(tiny_data_path, str(tmp_path / "saved"), "tiny")
    cfg.update(epochs=1, save_sst_embed=True)
    port_pkg.run_recbole("PFCN_PMF", "tiny", config_dict={**cfg, "use_gpu": False})
    with open(tmp_path / "saved" / "PFCN_PMF_embed-none.pth", "rb") as f:
        stored = pickle.load(f)
    ckpt = [f for f in os.listdir(tmp_path / "saved") if f.startswith("PFCN_PMF-")]
    params = load_checkpoint(str(tmp_path / "saved" / ckpt[0]))["params"]
    np.testing.assert_array_equal(stored["embedding"], params["user_embedding"][1:])
    assert set(stored) == {"gender", "embedding"}
    assert len(stored["gender"]) == len(stored["embedding"])

    jcfg = JaxConfig(model="PFCN_PMF", dataset="tiny", config_dict=dict(cfg))
    jl = jax_data_preparation(jcfg, jax_create_dataset(jcfg))
    jm = jax_get_model("PFCN_PMF")(jcfg, jl[0].dataset)
    ref = jm.get_sst_embed({k: jnp.asarray(v) for k, v in params.items()}, {},
                           jl[0].dataset.get_user_feature()[1:])
    assert set(ref) == set(stored)
    np.testing.assert_array_equal(np.asarray(ref["gender"]), stored["gender"])
    np.testing.assert_array_equal(np.asarray(ref["embedding"]), stored["embedding"])


def test_objective_function(tiny_data_path, tmp_path):
    cfg = _cfg(tiny_data_path, str(tmp_path / "saved"), "tiny")
    cfg.update(epochs=1, model="PFCN_PMF", dataset="tiny", use_gpu=False)
    out = port_pkg.objective_function(config_dict=cfg, saved=False)
    assert set(out) == {"model", "best_valid_score", "valid_score_bigger",
                        "best_valid_result", "test_result"}
    assert out["model"] == "PFCN_PMF" and list(out["test_result"]) == ["none"]


def test_get_trainer_gives_pfcn_pmf_its_trainer(tiny_env):
    assert jax_get_trainer(tiny_env.jax_config["MODEL_TYPE"], "PFCN_PMF") is JaxPFCNPMFTrainer
    cls = get_trainer(tiny_env.config["MODEL_TYPE"], "PFCN_PMF")
    assert cls is PFCN_PMFTrainer and issubclass(cls, PFCNTrainer) and issubclass(cls, Trainer)


def test_load_data_and_model_gives_the_pfcn_trainer(tiny_env):
    _, pt = tiny_env.pair(epochs=1)
    _fit(pt, tiny_env.loaders, saved=True)
    expected = pt.evaluate(tiny_env.loaders[2])
    _, _, trainer, _, _, _, test_data = load_data_and_model(
        pt.saved_model_file, config_dict={"use_gpu": False})
    assert isinstance(trainer, PFCN_PMFTrainer)
    assert trainer.evaluate(test_data) == expected


# ------------------------------------------------- settings not covered yet


def test_uncovered_settings_raise(tiny_env, tiny_data_path, tmp_path):
    jt, pt = tiny_env.pair()
    params = _np_tree(jt.params)
    loader = tiny_env.loaders[0]
    try:  # device_epoch_shuffle is ported: it trains (tests/test_torch_resident.py)
        tiny_env.config["device_epoch_shuffle"] = True
        tiny_env.config["device_neg_sampling"] = True
        loader.update_config(tiny_env.config)
        pt.fit(loader, tiny_env.loaders[1], saved=False, verbose=False)
        assert sorted(pt.train_loss_dict) == [0, 1, 2]
        assert pt._resident_cache is not None
    finally:
        tiny_env.config["device_epoch_shuffle"] = False
        tiny_env.config["device_neg_sampling"] = False
        loader.update_config(tiny_env.config)
    try:
        tiny_env.config["mesh_shape"] = [1, 1]
        with pytest.raises(NotImplementedError, match="mesh_shape"):
            tiny_env.port_trainer(params)
    finally:
        tiny_env.config["mesh_shape"] = None
    try:
        tiny_env.config["save_sst_embed"] = True
        base = tiny_env.port_trainer(params, base=True)
        with pytest.raises(NotImplementedError, match="save_sst_embed"):
            base.fit(tiny_env.loaders[0], tiny_env.loaders[1], saved=False, verbose=False)
        assert base.train_loss_dict == {}  # refused before training, not after
    finally:
        tiny_env.config["save_sst_embed"] = False
    cfg = _cfg(tiny_data_path, str(tmp_path / "saved"), "tiny")
    with pytest.raises(NotImplementedError, match="multihost"):
        port_pkg.run_recbole("PFCN_PMF", "tiny",
                             config_dict={**cfg, "use_gpu": False, "multihost": True})


def test_profile_dir_writes_a_trace(tiny_env, tmp_path):
    tiny_env.config["profile_dir"] = str(tmp_path / "prof")
    try:
        _, pt = tiny_env.pair(epochs=2)
        _fit(pt, tiny_env.loaders, saved=False)
    finally:
        tiny_env.config["profile_dir"] = None
    assert os.listdir(tmp_path / "prof") == ["train_epoch_0.json"]
