"""The adversarial training slice as a whole: the filter/discriminator
alternation of ``PFCNTrainer`` for PFCN_PMF, PFCN_MLP, PFCN_BiasedMF and
PFCN_DMF, trained by the port on the CPU against the JAX package.

Both sides read the same data; weights and BatchNorm state are carried over
with ``load_jax_params``; both draw the subsets, the batch order and the
host negatives from numpy's global generator, seeded alike before each run.
Dropout is 0 (the generators cannot match draw for draw).

Tolerances (float32): one step — loss rel 1e-6, parameters and BatchNorm
statistics abs 1e-5; three epochs — per-epoch losses rel 1e-4, parameters
and statistics abs 1e-4, validation scores and result dicts abs 1e-6.

One exception, a property of the model rather than of either package: the
bias of a linear layer that feeds a BatchNorm has a gradient of exactly 0
(BN subtracts the batch mean), so both packages compute float32 noise for
it, and Adam's m / sqrt(v) turns that noise into a step of up to
(1 − β1) / sqrt(1 − β2) = 3.16 learning rates of either sign. Adam steps
compare these biases within twice that and set the port's to the JAX
package's before each step, so that the BN statistics, which they shift,
compare at 1e-5. The trajectories run SGD, whose step lr · noise is far
below the tolerance.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recbole_fairrec_tpu as jax_pkg
import recbole_fairrec_tpu.trainer.adversarial as jax_adversarial
from recbole_fairrec_tpu.config import Config as JaxConfig
from recbole_fairrec_tpu.data import create_dataset as jax_create_dataset
from recbole_fairrec_tpu.data import data_preparation as jax_data_preparation
from recbole_fairrec_tpu.utils import get_model as jax_get_model
from recbole_fairrec_tpu.utils import get_trainer as jax_get_trainer
from recbole_fairrec_tpu.utils import init_seed as jax_init_seed

import recbole_fairrec_tpu_torch as port_pkg
import recbole_fairrec_tpu_torch.trainer.adversarial as port_adversarial
from recbole_fairrec_tpu_torch import Config, load_data_and_model
from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
from recbole_fairrec_tpu_torch.quick_start import load_checkpoint
from recbole_fairrec_tpu_torch.trainer import (
    PFCN_BiasedMFTrainer,
    PFCN_DMFTrainer,
    PFCN_MLPTrainer,
    PFCN_PMFTrainer,
)
from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed
from recbole_fairrec_tpu_torch.utils.jax_params import (
    _flatten,
    load_jax_opt_state,
    load_jax_params,
    to_jax_params,
    to_jax_state,
)
from test_torch_adversarial import case_config, perturb, write_dataset
from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)

TRAINER_DEFAULTS = {
    "learner": "adam", "learning_rate": 0.01, "weight_decay": 1e-4, "clip_grad_norm": None,
    "epochs": 3, "eval_step": 1, "stopping_step": 10, "train_epoch_interval": 2,
    "train_batch_size": 64, "neg_sampling": {"uniform": 1}, "device_neg_sampling": False,
    "save_sst_embed": False,
}
SGD = {"learner": "sgd", "learning_rate": 0.05}
STEP_RTOL, STEP_ATOL = 1e-6, 1e-5
ADAM_STEP_BOUND = (1 - 0.9) / np.sqrt(1 - 0.999)  # the largest |m_hat / sqrt(v_hat)|
TRAJ_RTOL, TRAJ_ATOL, METRIC_ATOL = 1e-4, 1e-4, 1e-6

BACKBONE_CASES = [
    ("PFCN_PMF", "sm", ["gender", "age"]),
    ("PFCN_MLP", "cm", ["gender", "age"]),
    ("PFCN_BiasedMF", "sm", ["gender", "age"]),
    ("PFCN_DMF", "cm", ["gender", "age"]),
]
CASE_IDS = [f"{m}-{f}" for m, f, _ in BACKBONE_CASES]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Env:
    """Both packages' configs, loaders and models over the adversarial test
    dataset; ``pair`` makes a JAX trainer and a port trainer with the same
    weights and BatchNorm state, both train sets back in their first
    order."""

    def __init__(self, root, model, mode, attrs):
        self.name, self.attrs = model, tuple(attrs)
        self.cfg = {**case_config(write_dataset(root), os.path.join(root, "saved"), model, mode,
                                  attrs), **TRAINER_DEFAULTS}
        self.jax_config = JaxConfig(model=model, dataset="adv", config_dict=self.cfg)
        jax_init_seed(self.jax_config["seed"], True)
        self.jax_loaders = jax_data_preparation(self.jax_config,
                                                jax_create_dataset(self.jax_config))
        self.jax_model = jax_get_model(model)(self.jax_config, self.jax_loaders[0].dataset)
        self.config = Config(model=model, dataset="adv", config_dict={**self.cfg, "use_gpu": False})
        init_seed(self.config["seed"], True)
        self.loaders = data_preparation(self.config, create_dataset(self.config))
        self._order = [dict(l[0].dataset.inter_feat.interaction)
                       for l in (self.jax_loaders, self.loaders)]
        params, state = perturb(*self.jax_model.init_params(jax.random.PRNGKey(1)))
        # item tables at std 0.3: scores stay where float32 sigmoid keeps them apart
        for key in ("item_embedding", "user_embedding"):
            params[key] = params[key] * np.float32(0.3)
        self.params, self.state = params, state

    def reset_order(self):
        for loaders, order in zip((self.jax_loaders, self.loaders), self._order):
            loaders[0].dataset.inter_feat.interaction = dict(order)
            loaders[0].pr = 0

    def set(self, **overrides):
        for config in (self.jax_config, self.config):
            for key, value in {**TRAINER_DEFAULTS, **overrides}.items():
                config[key] = value
            config["eval_step"] = min(config["eval_step"], config["epochs"])

    def jax_trainer(self, **overrides):
        self.set(**overrides)
        jt = jax_get_trainer(self.jax_config["MODEL_TYPE"], self.name)(
            self.jax_config, self.jax_model)
        jt.params = jax.tree_util.tree_map(jnp.asarray, self.params)
        jt.model_state = jax.tree_util.tree_map(jnp.asarray, self.state)
        return jt

    def port_trainer(self, **overrides):
        self.set(**overrides)
        model = get_model(self.name)(self.config, self.loaders[0].dataset)
        load_jax_params(model, self.params, self.state)
        return get_trainer(self.config["MODEL_TYPE"], self.name)(self.config, model)

    def pair(self, **overrides):
        self.reset_order()
        return self.jax_trainer(**overrides), self.port_trainer(**overrides)


@pytest.fixture(scope="module", params=BACKBONE_CASES, ids=CASE_IDS)
def env(request, tmp_path_factory):
    return Env(str(tmp_path_factory.mktemp("advtrain")), *request.param)


@pytest.fixture(scope="module")
def pmf_env(tmp_path_factory):
    return Env(str(tmp_path_factory.mktemp("advpmf")), *BACKBONE_CASES[0])


def _pre_bn_bias(name):
    """``filters.f1.linear.0.b``: a bias of a linear layer that feeds a
    BatchNorm (every layer of a filter or a discriminator)."""
    parts = name.split(".")
    return parts[0] in ("filters", "discriminators") and parts[-3:-2] == ["linear"] \
        and parts[-1] == "b"


def assert_close_to_jax(jt, pt, atol, bias_atol=None):
    """Parameters and BatchNorm statistics of the two trainers; the biases
    before a BatchNorm within ``bias_atol`` when given."""
    for ref, ours, what in ((jt.params, to_jax_params(pt.model), "param"),
                            (jt.model_state, to_jax_state(pt.model), "state")):
        ref, ours = _flatten(_np_tree(ref)), _flatten(ours)
        assert sorted(ref) == sorted(ours)
        for key, value in ref.items():
            tol = bias_atol if bias_atol is not None and _pre_bn_bias(key) else atol
            np.testing.assert_allclose(ours[key], value, rtol=0, atol=tol,
                                       err_msg=f"{what} {key}")


def _bias_atol(pt):
    return 2 * ADAM_STEP_BOUND * pt.config["learning_rate"] + STEP_ATOL


def sync_pre_bn_biases(jt, pt):
    """Give the port the JAX package's pre-BN biases (see the module doc)."""
    own = dict(pt.model.named_parameters())
    with torch.no_grad():
        for name, value in _flatten(_np_tree(jt.params)).items():
            if _pre_bn_bias(name):
                own[name].copy_(torch.from_numpy(np.array(value)))


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


def _jax_step(jt, interaction, loss_name, sst, tag):
    step = jt._make_step(loss_name, sst, jt._tx_by_tag(tag))
    batch = {k: jnp.asarray(v) for k, v in jt._to_batch(interaction).items()}
    loss, jt.params, jt.model_state, opt = step(
        jt.params, jt.model_state, jt._opt_state_by_tag(tag), jax.random.PRNGKey(0), batch)
    jt._set_opt_state_by_tag(tag, opt)
    return float(loss)


def _port_step(pt, interaction, loss_name, sst, tag):
    pt.model.train()
    return float(pt._train_step(pt._train_batch(interaction), loss_name, sst, pt._tx_by_tag(tag)))


STEPS = [("calculate_loss", "filter"), ("calculate_dis_loss", "dis"),
         ("calculate_loss", "filter"), ("calculate_dis_loss", "dis")]


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
def test_filter_and_dis_steps_match_jax(env, clip):
    """Filter, dis, filter, dis steps on the same batches, weight decay on,
    clipping off and on (the norm is the group's own). Each step moves only
    its own group's parameters; the filter step moves the BatchNorm
    statistics of both the filters and the discriminators."""
    jt, pt = env.pair(clip_grad_norm={"max_norm": clip} if clip else None)
    jax_batches, port_batches = _host_batches(env, len(STEPS))
    groups = pt.model.param_groups()
    sst = env.attrs
    for (loss_name, tag), jb, pb in zip(STEPS, jax_batches, port_batches):
        sync_pre_bn_biases(jt, pt)
        before = _flatten(to_jax_params(pt.model))
        ref = _jax_step(jt, jb, loss_name, sst, tag)
        loss = _port_step(pt, pb, loss_name, sst, tag)
        assert loss == pytest.approx(ref, rel=STEP_RTOL), (loss_name, tag)
        assert_close_to_jax(jt, pt, STEP_ATOL, bias_atol=_bias_atol(pt))
        moved = {name.split(".")[0] for name, value in _flatten(to_jax_params(pt.model)).items()
                 if not np.array_equal(value, before[name])}
        assert moved and moved <= set(groups[tag]), (tag, moved)


def test_every_filter_steps_with_a_zero_gradient(pmf_env):
    """In ``sm`` mode a filter step reaches one filter; the others still take
    the Adam step of a zero gradient (weight decay, moment decay), as the
    masked optax chain does, so every filter's step count advances."""
    jt, pt = pmf_env.pair()
    jax_batches, port_batches = _host_batches(pmf_env, 2)
    for jb, pb, sst in zip(jax_batches, port_batches, [("gender",), ("age",)]):
        sync_pre_bn_biases(jt, pt)
        _jax_step(jt, jb, "calculate_loss", sst, "filter")
        _port_step(pt, pb, "calculate_loss", sst, "filter")
    assert_close_to_jax(jt, pt, STEP_ATOL, bias_atol=_bias_atol(pt))
    for name, p in pt.model.filters.named_parameters():
        assert float(pt.tx_filter.state[p]["step"]) == 2.0, name


# ---------------------------------------------------------------- trajectory


def _record_subsets(monkeypatch):
    drawn = {"jax": [], "port": []}
    for key, module in (("jax", jax_adversarial), ("port", port_adversarial)):
        draw = module._draw_sst_mask

        def recording(attrs, draw=draw, key=key):
            out = draw(attrs)
            drawn[key].append(out)
            return out

        monkeypatch.setattr(module, "_draw_sst_mask", recording)
    return drawn


def _record_epoch_losses(monkeypatch, trainer):
    losses = []
    run = trainer._train_epoch

    def recording(*args, **kwargs):
        out = run(*args, **kwargs)
        losses.append(out)
        return out

    monkeypatch.setattr(trainer, "_train_epoch", recording)
    return losses


def _fit(trainer, loaders, seed=5, saved=True):
    scores = []
    np.random.seed(seed)
    best = trainer.fit(loaders[0], loaders[1], saved=saved, verbose=False,
                       callback_fn=lambda epoch, score: scores.append(score))
    return best, scores


def test_three_epoch_alternation_matches_jax(env, monkeypatch):
    """Three epochs of SGD with ``train_epoch_interval: 2``: epochs 0 and 2 run the
    filter pass and the dis pass, epoch 1 the dis pass alone (its filter
    loss is 0.0). The subsets drawn, the per-epoch (filter, dis) losses,
    the parameters, the BatchNorm statistics, the per-subset validations
    and the test dicts follow the JAX package's."""
    drawn = _record_subsets(monkeypatch)
    jt, pt = env.pair(**SGD)
    ref_losses = _record_epoch_losses(monkeypatch, jt)
    losses = _record_epoch_losses(monkeypatch, pt)
    (ref_score, ref_result), ref_scores = _fit(jt, env.jax_loaders)
    (score, result), scores = _fit(pt, env.loaders)
    assert drawn["port"] == drawn["jax"] and len(drawn["port"]) == 3
    assert [l[0] == 0.0 for l in losses] == [False, True, False]
    np.testing.assert_allclose(np.array(losses), np.array(ref_losses), rtol=TRAJ_RTOL)
    assert_close_to_jax(jt, pt, TRAJ_ATOL)
    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=METRIC_ATOL)
    assert score == pytest.approx(ref_score, abs=METRIC_ATOL)
    assert dict(result) == pytest.approx(dict(ref_result), abs=METRIC_ATOL)
    ours, ref = pt.evaluate(env.loaders[2]), jt.evaluate(env.jax_loaders[2])
    mode = env.config["filter_mode"]
    assert list(ours) == list(ref) == [f"{mode}-['gender']", f"{mode}-['age']",
                                       f"{mode}-['gender', 'age']"]
    for key in ref:
        assert dict(ours[key]) == pytest.approx(dict(ref[key]), abs=METRIC_ATOL), key


def test_streaming_validation_equals_dense_on_filtered_users(pmf_env):
    """``streaming_eval`` takes the retrieval form of the filtered user
    representation per subset; with these weights no two scores tie, so it
    gives the dense path's dicts."""
    _, pt = pmf_env.pair(epochs=1)
    _fit(pt, pmf_env.loaders, saved=True)
    dense = pt.evaluate(pmf_env.loaders[2])
    assert pt._last_eval_path == "fused"
    pmf_env.config["streaming_eval"] = True
    try:
        streaming = pt.evaluate(pmf_env.loaders[2])
        assert pt._last_eval_path == "streaming"
    finally:
        pmf_env.config["streaming_eval"] = False
    assert {k: dict(v) for k, v in streaming.items()} == {k: dict(v) for k, v in dense.items()}


# -------------------------------------------------------- resume, checkpoints


def test_port_checkpoint_evaluates_in_jax_trainer(env):
    """A checkpoint the port wrote holds the parameters and the BatchNorm
    statistics in the JAX layout: the JAX ``PFCNTrainer`` loads it and
    evaluates every subset to the port's dicts."""
    _, pt = env.pair(epochs=1)
    _fit(pt, env.loaders, saved=True)
    checkpoint = load_checkpoint(pt.saved_model_file)
    assert isinstance(checkpoint["model_state"]["filters"]["f1"]["bn"], list)
    assert isinstance(checkpoint["optimizer_filter"]["state"][0]["exp_avg"], np.ndarray)
    jt = env.jax_trainer(epochs=1)
    jt.eval_collector.data_collect(env.jax_loaders[0])
    ref = jt.evaluate(env.jax_loaders[2], load_best_model=True, model_file=pt.saved_model_file)
    ours = pt.evaluate(env.loaders[2])
    assert list(ours) == list(ref)
    for key in ref:
        assert dict(ours[key]) == pytest.approx(dict(ref[key]), abs=METRIC_ATOL), key


def test_jax_checkpoint_serves_and_resumes_in_the_port(pmf_env, tmp_path):
    """A checkpoint the JAX trainer wrote after one epoch: the port serves it
    through ``load_data_and_model`` (every subset's dict equal to JAX's), and
    a port trainer resumed from it (parameters, statistics, the masked
    filter and dis Adam states) takes the next filter and dis steps as the
    JAX trainer resumed from it does."""
    jt, _ = pmf_env.pair(epochs=1, train_epoch_interval=1)
    _fit(jt, pmf_env.jax_loaders, saved=True)
    ckpt = jt.saved_model_file
    ref = jt.evaluate(pmf_env.jax_loaders[2], load_best_model=True)
    _, _, trainer, _, _, _, test_data = load_data_and_model(ckpt, config_dict={"use_gpu": False})
    assert isinstance(trainer, PFCN_PMFTrainer)
    ours = trainer.evaluate(test_data)
    for key in ref:
        assert dict(ours[key]) == pytest.approx(dict(ref[key]), abs=METRIC_ATOL), key

    jt2, pt2 = pmf_env.pair(epochs=2, train_epoch_interval=1)
    jt2.resume_checkpoint(ckpt)
    pt2.resume_checkpoint(ckpt)
    assert pt2.start_epoch == 1
    step = float(pt2.tx_filter.state[pt2.model.user_embedding.weight]["step"])
    assert step == float(np.asarray(_adam_count(jt2.opt_state_filter))) > 0
    assert_close_to_jax(jt2, pt2, 0.0)
    jax_batches, port_batches = _host_batches(pmf_env, 2)
    _steps_match(jt2, pt2, jax_batches, port_batches, pmf_env.attrs)


def _adam_count(opt_state):
    leaves = [x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda n: type(n).__name__ == "ScaleByAdamState")
        if type(x).__name__ == "ScaleByAdamState"]
    assert len(leaves) == 1
    return leaves[0].count


def test_jax_masked_adam_states_carried_over(pmf_env):
    """Two JAX filter and dis steps, then the parameters, the statistics and
    the two masked Adam states go over as trees: the next filter and dis
    steps are the same in both packages."""
    jt, pt = pmf_env.pair()
    jax_batches, port_batches = _host_batches(pmf_env, 4)
    for jb, (loss_name, tag) in zip(jax_batches, STEPS):
        _jax_step(jt, jb, loss_name, pmf_env.attrs, tag)
    load_jax_params(pt.model, _np_tree(jt.params), _np_tree(jt.model_state))
    load_jax_opt_state(pt.tx_filter, pt.model, _np_tree(jt.opt_state_filter))
    load_jax_opt_state(pt.tx_dis, pt.model, _np_tree(jt.opt_state_dis))
    _steps_match(jt, pt, jax_batches[:2], port_batches[:2], pmf_env.attrs)


def _steps_match(jt, pt, jax_batches, port_batches, sst):
    """A filter step and a dis step give the same losses, parameters and
    statistics in both trainers."""
    for jb, pb, (loss_name, tag) in zip(jax_batches, port_batches, STEPS):
        sync_pre_bn_biases(jt, pt)
        ref = _jax_step(jt, jb, loss_name, sst, tag)
        assert _port_step(pt, pb, loss_name, sst, tag) == pytest.approx(ref, rel=STEP_RTOL)
        assert_close_to_jax(jt, pt, STEP_ATOL,
                            bias_atol=_bias_atol(pt))


def test_resume_continues_the_straight_run(pmf_env):
    """Two epochs, a checkpoint, ``resume_checkpoint`` in a new trainer, one
    more epoch: equal to the straight three-epoch run exactly."""
    _, straight = pmf_env.pair(epochs=3)
    _fit(straight, pmf_env.loaders, saved=False)
    _, first = pmf_env.pair(epochs=2)
    _fit(first, pmf_env.loaders, saved=False)
    rng_state = np.random.get_state()
    ckpt = os.path.join(first.checkpoint_dir, "adv-resume-me.pth")
    first._save_checkpoint(1, verbose=False, saved_model_file=ckpt)
    second = pmf_env.port_trainer(epochs=3)
    second.resume_checkpoint(ckpt)
    np.random.set_state(rng_state)
    second.fit(pmf_env.loaders[0], pmf_env.loaders[1], saved=False, verbose=False)
    assert list(second.train_loss_dict) == [2]
    assert second.train_loss_dict[2] == straight.train_loss_dict[2]
    for (name, value), (_, other) in zip(straight.model.state_dict().items(),
                                         second.model.state_dict().items()):
        assert torch.equal(value, other), name


# -------------------------------------------------------------- entry points


def _nesting(value):
    if isinstance(value, dict):
        return {k: _nesting(v) for k, v in value.items()}
    return type(value).__name__ if not isinstance(value, (float, np.floating)) else "float"


@pytest.mark.parametrize("mode", ["cm", "sm"])
@pytest.mark.parametrize("model", ["PFCN_PMF", "PFCN_MLP", "PFCN_DMF", "PFCN_BiasedMF"])
def test_run_recbole_returns_the_jax_structure(tmp_path, model, mode):
    """``run_recbole`` trains every backbone in both modes on the CPU and
    returns the JAX package's structure, per-subset keys equal as strings."""
    root = write_dataset(str(tmp_path))
    cfg = {**case_config(root, str(tmp_path / "saved"), model, mode, ["gender", "age"]),
           **TRAINER_DEFAULTS, "epochs": 1}
    ref = jax_pkg.run_recbole(model, "adv", config_dict=dict(cfg))
    ours = port_pkg.run_recbole(model, "adv", config_dict={**cfg, "use_gpu": False})
    assert _nesting(ours) == _nesting(ref)
    assert list(ours["test_result"]) == list(ref["test_result"])
    assert f"{mode}-['gender', 'age']" in ours["test_result"]


def test_registry_gives_each_backbone_its_trainer(pmf_env):
    for name, cls in (("PFCN_PMF", PFCN_PMFTrainer), ("PFCN_MLP", PFCN_MLPTrainer),
                      ("PFCN_DMF", PFCN_DMFTrainer), ("PFCN_BiasedMF", PFCN_BiasedMFTrainer)):
        assert get_trainer(pmf_env.config["MODEL_TYPE"], name) is cls
        assert get_model(name).__name__ == name


def test_save_sst_embed_files_match_jax(pmf_env, tmp_path):
    """``save_sst_embed`` after one epoch of SGD writes one file per subset, named
    and filled as the JAX package's (embeddings within the trajectory
    tolerance)."""
    dirs = {side: str(tmp_path / side) for side in ("jax", "port")}
    pmf_env.reset_order()
    try:
        jt = pmf_env.jax_trainer(epochs=1, save_sst_embed=True, checkpoint_dir=dirs["jax"], **SGD)
        pt = pmf_env.port_trainer(epochs=1, save_sst_embed=True, checkpoint_dir=dirs["port"],
                                  **SGD)
        _fit(jt, pmf_env.jax_loaders)
        _fit(pt, pmf_env.loaders)
    finally:
        pmf_env.set(checkpoint_dir=pmf_env.cfg["checkpoint_dir"])
    names = sorted(f for f in os.listdir(dirs["port"]) if "_embed-" in f)
    assert names == sorted(f for f in os.listdir(dirs["jax"]) if "_embed-" in f) == [
        "PFCN_PMF_embed-sm-[age].pth", "PFCN_PMF_embed-sm-[gender].pth",
        "PFCN_PMF_embed-sm-[gender_age].pth"]
    for name in names:
        with open(os.path.join(dirs["jax"], name), "rb") as f:
            ref = pickle.load(f)
        with open(os.path.join(dirs["port"], name), "rb") as f:
            ours = pickle.load(f)
        assert sorted(ours) == sorted(ref)
        for key, value in ref.items():
            if key == "embedding":
                np.testing.assert_allclose(ours[key], np.asarray(value), rtol=0, atol=TRAJ_ATOL)
            else:
                np.testing.assert_array_equal(ours[key], np.asarray(value))
