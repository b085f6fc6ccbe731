"""FairGo (FairGo_PMF, FairGo_GCN) in the port against the JAX package, on
the CPU: the propagation matrices and products, the GCN backbone, the
losses and their gradients for every aggregation, the predictions, the
pretrain → finetune trainer (single steps, ``run_recbole`` with the
published YAMLs on small data and on ml-100k), checkpoints both ways and
preloaded embedding tables.

Both packages read the same data; the port's models take the JAX package's
initial parameters through ``load_jax_params``; batch order, the drawn
attribute subsets and the evaluation negatives come from numpy's global
generator, seeded alike. The GCN's dropout is 0 wherever the two are
compared (the generators cannot match draw for draw).

Tolerances (float32; the two packages sum in different orders):
* the normalised matrices (COO arrays and dense): exact;
* one propagation hop or GCN output: abs 1e-6; dense against COO: abs 1e-6;
* bfloat16 propagation: forward abs 1e-6 (bfloat16 products are exact in
  float32); its gradient, which both packages round to bfloat16, rel 2^-7
  (one bfloat16 step) per element;
* losses rel 1e-6, gradients abs 1e-6; predictions abs 1e-6;
* one optimizer step: loss rel 1e-6, parameters abs 1e-5;
* metric dicts as in ``test_torch_sampled_eval.py`` (rank metrics 1e-9 abs,
  score-averaged ones 1e-5 rel + 1e-7 abs), except after ``run_recbole`` at
  the published widths (d 64): there the two packages' parameters part in
  the last float32 bits over the run, and the score-averaged fairness gaps,
  differences of group means of clamped scores, amplify that to ~1e-5 rel;
  they are held at ``RUN_VALUE_RTOL`` 1e-4 rel + 1e-7 abs, the rank metrics
  at 1e-9 still.
"""

import glob
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import recbole_fairrec_tpu as jax_pkg
from recbole_fairrec_tpu.config import Config as JaxConfig
from recbole_fairrec_tpu.data import create_dataset as jax_create_dataset
from recbole_fairrec_tpu.data import data_preparation as jax_data_preparation
from recbole_fairrec_tpu.models import gcn as jax_gcn
from recbole_fairrec_tpu.ops import spmm as jax_spmm
from recbole_fairrec_tpu.utils import get_model as jax_get_model
from recbole_fairrec_tpu.utils import get_trainer as jax_get_trainer
from recbole_fairrec_tpu.utils import init_seed as jax_init_seed

import recbole_fairrec_tpu_torch as port_pkg
from recbole_fairrec_tpu_torch import Config, load_data_and_model
from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
from recbole_fairrec_tpu_torch.models.gcn import GCN
from recbole_fairrec_tpu_torch.ops import spmm
from recbole_fairrec_tpu_torch.quick_start import load_checkpoint
from recbole_fairrec_tpu_torch.trainer import FairGo_GCNTrainer, FairGo_PMFTrainer
from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed, tracing
from recbole_fairrec_tpu_torch.utils.jax_params import (
    _flatten,
    _jax_name,
    _tables,
    load_jax_params,
    to_jax_params,
    to_jax_state,
)
from test_torch_focf import _capture_jax_init, _port_models_start_from
from test_torch_sampled_eval import (
    assert_families,
    assert_same_result,
    published_config,
    write_dataset,
)
from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROP_ATOL = 1e-6
BF16_GRAD_RTOL = 2.0 ** -7
LOSS_RTOL, GRAD_ATOL, PRED_ATOL = 1e-6, 1e-6, 1e-6
STEP_RTOL, STEP_ATOL = 1e-6, 1e-5
RANK_ATOL, RUN_VALUE_RTOL, VALUE_ATOL = 1e-9, 1e-4, 1e-7
RANK_METRICS = ("ndcg@", "recall@", "hit@", "mrr@", "giniindex@", "popularitypercentage@")
MODELS = ["FairGo_PMF", "FairGo_GCN"]
AGGRS = ["WAP", "LBA", "LVA"]
# narrow widths; gender is binary (BCE), age has three values (CE)
FAIRGO = {"embedding_size": 16, "filter_hidden_size_list": [24, 16],
          "dis_hidden_size_list": [16, 8], "hidden_channels": 8, "gcn_dropout": 0.0,
          "n_layers": 2, "sst_attr_list": ["gender", "age"], "vs_weights": [4, 1],
          "train_batch_size": 128}
SUBSETS = [("gender",), ("age",), ("gender", "age")]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _published_yaml(model):
    with open(os.path.join(REPO, "recbole_fairrec_tpu_torch", "config",
                           "properties.json")) as f:
        return json.load(f)[f"model/{model}"]


class Env:
    """Both packages' configs, loaders and models over the small fair
    dataset, the JAX package's initial parameters (``params``) and state
    (``jax_state``, which holds the dense matrices), and trainer pairs."""

    def __init__(self, root, model, extra=None):
        self.name = model
        self.root = root
        self.cfg = published_config(write_dataset(root), os.path.join(root, "saved"),
                                    {**FAIRGO, **(extra or {})})
        self.jax_config = JaxConfig(model=model, dataset="fair", config_dict=self.cfg)
        jax_init_seed(self.jax_config["seed"], True)
        self.jax_loaders = jax_data_preparation(self.jax_config,
                                                jax_create_dataset(self.jax_config))
        self.jax_model = jax_get_model(model)(self.jax_config, self.jax_loaders[0].dataset)
        self.config = Config(model=model, dataset="fair",
                             config_dict={**self.cfg, "use_gpu": False})
        init_seed(self.config["seed"], True)
        self.loaders = data_preparation(self.config, create_dataset(self.config))
        params, self.jax_state = self.jax_model.init_params(jax.random.PRNGKey(0))
        self.params = _np_tree(params)
        self._order = [dict(l[0].dataset.inter_feat.interaction)
                       for l in (self.jax_loaders, self.loaders)]

    def port_model(self, stage=None, params=None):
        model = get_model(self.name)(self.config, self.loaders[0].dataset)
        load_jax_params(model, self.params if params is None else params)
        model.train_stage = stage
        return model

    def reset_order(self):
        for loaders, order in zip((self.jax_loaders, self.loaders), self._order):
            loaders[0].dataset.inter_feat.interaction = dict(order)
            loaders[0].pr = 0

    def pair(self, **overrides):
        """A JAX trainer and a port trainer from the same parameters, each
        writing checkpoints into a directory of its own."""
        self.reset_order()
        for side, config in (("jax", self.jax_config), ("port", self.config)):
            for key, value in {"checkpoint_dir": os.path.join(self.root, side),
                               **overrides}.items():
                config[key] = value
            config["eval_step"] = min(config["eval_step"], config["epochs"])
        jt = jax_get_trainer(self.jax_config["MODEL_TYPE"], self.name)(
            self.jax_config, self.jax_model)
        jt.params = jax.tree_util.tree_map(jnp.asarray, self.params)
        pt = get_trainer(self.config["MODEL_TYPE"], self.name)(self.config, self.port_model())
        for t, loaders in ((jt, self.jax_loaders), (pt, self.loaders)):
            t.eval_collector.data_collect(loaders[0])
        return jt, pt

    def batches(self):
        """The first train batch as each package's loader yields it."""
        self.reset_order()
        out = []
        for loaders in (self.jax_loaders, self.loaders):
            np.random.seed(3)
            out.append(next(iter(loaders[0])))
            loaders[0].pr = 0
        return out


@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    """One ``Env`` per (model, aggregation), built when first asked for."""
    built = {}

    def get(model, aggr="LBA"):
        if (model, aggr) not in built:
            root = str(tmp_path_factory.mktemp(f"{model}_{aggr}".lower()))
            built[(model, aggr)] = Env(root, model, {"aggr_method": aggr})
        return built[(model, aggr)]

    return get


@pytest.fixture(scope="module", params=[(m, a) for m in MODELS for a in AGGRS],
                ids=[f"{m}-{a}" for m in MODELS for a in AGGRS])
def env(request, envs):
    return envs(*request.param)


@pytest.fixture(scope="module", params=MODELS)
def lba_env(request, envs):
    return envs(request.param)


# ------------------------------------------------------------ propagation


def _rating_coo(seed=0, n_users=7, n_items=9, nnz=40):
    """A rating matrix in COO form with repeated (user, item) entries."""
    rng = np.random.RandomState(seed)
    rows, cols = rng.randint(0, n_users, nnz), rng.randint(0, n_items, nnz)
    assert len(set(zip(rows.tolist(), cols.tolist()))) < nnz  # repeats present
    data = rng.randint(1, 6, nnz).astype(np.float32)
    return sp.coo_matrix((data, (rows, cols)), shape=(n_users, n_items))


@pytest.mark.parametrize("build", ["build_bipartite_norm_coo", "build_gcn_norm_coo"])
def test_norm_coo_match_jax(build):
    coo = _rating_coo()
    ours = getattr(spmm, build)(coo, 7, 9)
    ref = getattr(jax_spmm, build)(coo, 7, 9)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(spmm.coo_to_dense(*ours, 16),
                                  jax_spmm.coo_to_dense(*ref, 16))


def test_bipartite_norm_keeps_the_last_duplicate():
    """D⁻¹A built entry by entry, a later rating of a (user, item) pair
    overwriting an earlier one, as the reference's dict does."""
    coo = _rating_coo()
    A = np.zeros((16, 16), dtype=np.float64)
    for u, i, r in zip(coo.row, coo.col, coo.data):
        A[u, 7 + i] = A[7 + i, u] = r
    expected = A / (A.sum(axis=1, keepdims=True) + 1e-7)
    ours = spmm.coo_to_dense(*spmm.build_bipartite_norm_coo(coo, 7, 9), 16)
    np.testing.assert_allclose(ours, expected, rtol=1e-6, atol=0)


def _tensors(coo_arrays):
    return tuple(torch.from_numpy(a) for a in coo_arrays)


@pytest.mark.parametrize("build", ["build_bipartite_norm_coo", "build_gcn_norm_coo"])
def test_dense_and_coo_propagation_agree_with_jax(build):
    coo = _rating_coo()
    coo.sum_duplicates()  # the dense form keeps one of repeated entries, COO sums them
    arrays = getattr(spmm, build)(coo, 7, 9)
    dense = spmm.coo_to_dense(*arrays, 16)
    x = np.random.RandomState(1).randn(16, 5).astype(np.float32)
    xt = torch.from_numpy(x)
    ours_coo = spmm.propagate(xt, *_tensors(arrays), 16)
    ours_dense = spmm.propagate(xt, *_tensors(arrays), 16, dense=torch.from_numpy(dense))
    jarrays = [jnp.asarray(a) for a in arrays]
    ref_coo = jax_spmm.propagate(jnp.asarray(x), *jarrays, 16)
    ref_dense = jax_spmm.propagate(jnp.asarray(x), *jarrays, 16, dense=jnp.asarray(dense))
    assert ours_coo.dtype == ours_dense.dtype == torch.float32
    np.testing.assert_allclose(ours_dense.numpy(), ours_coo.numpy(), rtol=0, atol=PROP_ATOL)
    np.testing.assert_allclose(ours_coo.numpy(), np.asarray(ref_coo), rtol=0, atol=PROP_ATOL)
    np.testing.assert_allclose(ours_dense.numpy(), np.asarray(ref_dense), rtol=0,
                               atol=PROP_ATOL)


def test_bf16_propagation_matches_jax():
    """bfloat16 operands, a float32 result (not rounded to bfloat16), and the
    gradient in ``x`` as the JAX package's bfloat16 path gives them."""
    arrays = spmm.build_bipartite_norm_coo(_rating_coo(), 7, 9)
    dense = spmm.coo_to_dense(*arrays, 16)
    rng = np.random.RandomState(2)
    x = rng.randn(16, 5).astype(np.float32)
    g = rng.randn(16, 5).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    dense_bf16 = torch.from_numpy(dense).to(torch.bfloat16)
    out = spmm.propagate(xt, *_tensors(arrays), 16, dense=dense_bf16)
    (out * torch.from_numpy(g)).sum().backward()
    jdense = jnp.asarray(dense, dtype=jnp.bfloat16)

    def ref_fn(v):
        return jax_spmm.propagate(v, None, None, None, 16, dense=jdense)

    ref = ref_fn(jnp.asarray(x))
    ref_grad = jax.grad(lambda v: jnp.sum(ref_fn(v) * jnp.asarray(g)))(jnp.asarray(x))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=PROP_ATOL)
    assert not torch.equal(out, out.to(torch.bfloat16).float())  # float32, not bfloat16
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_grad), rtol=BF16_GRAD_RTOL,
                               atol=0)
    # the float32 product of the same matrix differs by bfloat16's rounding
    f32 = spmm.propagate(torch.from_numpy(x), *_tensors(arrays), 16, dense=torch.from_numpy(dense))
    gap = float((out.detach() - f32).norm() / f32.norm())
    assert 0 < gap < 2.0 ** -7


# ------------------------------------------------------------------- GCN


@pytest.mark.parametrize("dense", [False, True], ids=["coo", "dense"])
@pytest.mark.parametrize("layers", [1, 2, 3])
def test_gcn_matches_jax(layers, dense):
    coo = _rating_coo()
    coo.sum_duplicates()
    arrays = spmm.build_gcn_norm_coo(coo, 7, 9)
    A = spmm.coo_to_dense(*arrays, 16)
    params = _np_tree(jax_gcn.init_gcn(jax.random.PRNGKey(layers), 6, 5, 6, layers))
    gcn = load_jax_params(GCN(6, 5, 6, layers, torch.Generator().manual_seed(0)), params)
    x = np.random.RandomState(3).randn(16, 6).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = gcn(xt, *_tensors(arrays), act="relu",
              dense=torch.from_numpy(A) if dense else None)
    out.square().sum().backward()
    jarrays = [jnp.asarray(a) for a in arrays]

    def ref_fn(p, v):
        return jax_gcn.apply_gcn(p, v, *jarrays, act="relu",
                                 dense=jnp.asarray(A) if dense else None)

    ref = ref_fn(params, jnp.asarray(x))
    gp, gx = jax.grad(lambda p, v: jnp.sum(ref_fn(p, v) ** 2), argnums=(0, 1))(
        params, jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=PROP_ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=GRAD_ATOL)
    for name, p in gcn.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _flatten(_np_tree(gp))[name], rtol=1e-5,
                                   atol=GRAD_ATOL, err_msg=name)


def test_gcn_dropout_draws_from_the_generator():
    """Between convolutions only, in training only, with masks from the
    generator passed in."""
    arrays = _tensors(spmm.build_gcn_norm_coo(_rating_coo(), 7, 9))
    gcn = GCN(6, 5, 6, 2, torch.Generator().manual_seed(0))
    x = torch.randn(16, 6, generator=torch.Generator().manual_seed(1))

    def run(seed, train=True):
        return gcn(x, *arrays, dropout=0.5, train=train,
                   generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    assert torch.equal(run(5, train=False), gcn(x, *arrays))


# ------------------------------------------------------------------ model


def _jax_batch(interaction, fields):
    return {k: jnp.asarray(interaction[k].numpy()) for k in fields}


def _port_batch(interaction, fields):
    return {k: interaction[k] for k in fields}


def _assert_grads(model, jax_grads):
    ref = _flatten(_np_tree(jax_grads))
    tables = _tables(model)
    for name, p in model.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        np.testing.assert_allclose(g, ref[_jax_name(name, tables)], rtol=0, atol=GRAD_ATOL,
                                   err_msg=name)


def test_losses_and_gradients_match_jax(env):
    """MSE in pretrain; MSE − fair_weight · dis and the discriminator loss in
    finetune, for each attribute subset (gender: BCE heads; age: CE heads,
    the local one through the reference's sigmoid), with every gradient."""
    fields = ("user_id", "item_id", "rating", "gender", "age")
    interaction = env.batches()[1]
    jb, pb = _jax_batch(interaction, fields), _port_batch(interaction, fields)
    params = jax.tree_util.tree_map(jnp.asarray, env.params)
    for stage in ("pretrain", "finetune"):
        model = env.port_model(stage)
        env.jax_model.train_stage = stage
        cases = [("calculate_loss", None)] if stage == "pretrain" else [
            (name, sst) for name in ("calculate_loss", "calculate_dis_loss") for sst in SUBSETS]
        for name, sst in cases:
            def ref_fn(p):
                return getattr(env.jax_model, name)(p, env.jax_state, jb, rng=None,
                                                    sst_list=sst)[0]

            ref, grads = jax.value_and_grad(ref_fn)(params)
            model.zero_grad(set_to_none=True)
            loss = getattr(model, name)(pb, sst_list=sst)
            loss.backward()
            assert float(loss.detach()) == pytest.approx(float(ref), rel=LOSS_RTOL), \
                (stage, name, sst)
            _assert_grads(model, grads)


def test_predictions_match_jax(lba_env):
    env = lba_env
    users = np.repeat(np.arange(1, 9), 5)
    items = np.tile(np.arange(1, 6), 8)
    for stage in ("pretrain", "finetune"):
        model = env.port_model(stage)
        env.jax_model.train_stage = stage
        params = jax.tree_util.tree_map(jnp.asarray, env.params)
        ours = model.predict({"user_id": torch.from_numpy(users),
                              "item_id": torch.from_numpy(items)})
        ref = env.jax_model.predict(params, env.jax_state,
                                    {"user_id": jnp.asarray(users), "item_id": jnp.asarray(items)})
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=0, atol=PRED_ATOL)
        uid = torch.arange(1, 9)
        ours = model.full_sort_predict({"user_id": uid})
        ref = env.jax_model.full_sort_predict(params, env.jax_state,
                                              {"user_id": jnp.asarray(uid.numpy())})
        assert ours.shape == (len(uid) * model.n_items,)
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=0,
                                   atol=PRED_ATOL)
        assert float(ours.detach().min()) >= 0.0 and float(ours.detach().max()) <= 1.0
        user_data = env.loaders[0].dataset.get_user_feature()[1:]
        for sst in SUBSETS:
            mine = model.get_sst_embed(user_data, sst)
            theirs = env.jax_model.get_sst_embed(params, env.jax_state, user_data, sst)
            assert sorted(mine) == sorted(theirs)
            np.testing.assert_allclose(mine["embedding"], np.asarray(theirs["embedding"]),
                                       rtol=0, atol=PRED_ATOL)
            for key in sst:
                np.testing.assert_array_equal(mine[key], theirs[key])


def test_structure_matches_jax(lba_env):
    """The parameter tree, the optimizer groups, no persistent state, and the
    propagation matrices as buffers outside the state dict."""
    env = lba_env
    model = env.port_model()
    ours = _flatten(to_jax_params(model))
    ref = _flatten(env.params)
    assert sorted(ours) == sorted(ref)
    assert all(ours[k].shape == ref[k].shape for k in ref)
    assert model.param_groups() == env.jax_model.param_groups()
    assert to_jax_state(model) == {}
    buffers = dict(model.named_buffers())
    assert "prop_dense" in buffers and not set(buffers) & set(model.state_dict())
    np.testing.assert_array_equal(buffers["prop_dense"].numpy(),
                                  np.asarray(env.jax_state["prop_dense"]))
    if env.name == "FairGo_GCN":
        np.testing.assert_array_equal(buffers["gcn_dense"].numpy(),
                                      np.asarray(env.jax_state["gcn_dense"]))


def test_dense_and_coo_losses_agree(lba_env):
    """``dense_propagation: False`` (every hop through the CSR pair,
    ``CsrHop``: its spans read ``csr``) against the dense matrix, in finetune
    (D⁻¹A) and, for FairGo_GCN, in pretrain (the GCN's Â)."""
    env = lba_env
    interaction = env.batches()[1]
    pb = _port_batch(interaction, ("user_id", "item_id", "rating", "gender", "age"))
    env.config["dense_propagation"] = False
    try:
        coo_model = env.port_model("finetune")
    finally:
        env.config["dense_propagation"] = None
    assert "prop_dense" not in dict(coo_model.named_buffers())
    model = env.port_model("finetune")
    cases = [("finetune", "calculate_loss"), ("finetune", "calculate_dis_loss")]
    if env.name == "FairGo_GCN":
        assert "gcn_dense" not in dict(coo_model.named_buffers())
        cases.append(("pretrain", "calculate_loss"))
    for stage, name in cases:
        model.train_stage = coo_model.train_stage = stage
        tracing.reset()
        tracing.enable()
        try:
            with torch.no_grad():
                b = getattr(coo_model, name)(pb, sst_list=("gender", "age"))
        finally:
            tracing.disable()
        paths = [r.attrs["path"] for r in tracing.records() if r.name == "spmm.propagate"]
        tracing.reset()
        assert paths and set(paths) == {"csr"}, (stage, name, paths)
        with torch.no_grad():
            a = getattr(model, name)(pb, sst_list=("gender", "age"))
        assert float(a) == pytest.approx(float(b), rel=LOSS_RTOL)


# ---------------------------------------------------------------- trainer


def _jax_step(jt, interaction, loss_name, sst, tag):
    step = jt._make_step(loss_name, sst, jt._tx_by_tag(tag))
    batch = {k: jnp.asarray(v) for k, v in jt._to_batch(interaction).items()}
    loss, jt.params, jt.model_state, opt = step(
        jt.params, jt.model_state, jt._opt_state_by_tag(tag), jax.random.PRNGKey(0), batch)
    jt._set_opt_state_by_tag(tag, opt)
    return float(loss)


def _port_step(pt, interaction, loss_name, sst, tag):
    pt.model.train()
    fields = pt.model.loss_batch_fields(loss_name, sst)
    return float(pt._train_step(pt._train_batch(interaction, fields), loss_name, sst,
                                pt._tx_by_tag(tag)))


def _assert_params(jt, pt, atol=STEP_ATOL):
    ref, ours = _flatten(_np_tree(jt.params)), _flatten(to_jax_params(pt.model))
    for key, value in ref.items():
        np.testing.assert_allclose(ours[key], value, rtol=0, atol=atol, err_msg=key)


STAGED_STEPS = [("pretrain", "calculate_loss", None, "pretrain"),
                ("finetune", "calculate_loss", ("gender", "age"), "filter"),
                ("finetune", "calculate_dis_loss", ("gender", "age"), "dis"),
                ("finetune", "calculate_loss", ("age",), "filter"),
                ("finetune", "calculate_dis_loss", ("gender",), "dis")]


def test_pretrain_filter_and_dis_steps_match_jax(env):
    """A pretrain step, then filter and discriminator steps (weight decay
    on), each with its own masked Adam; only the group's gradients are
    computed."""
    jt, pt = env.pair(weight_decay=1e-4)
    assert pt.model.train_stage == jt.model.train_stage == "pretrain"
    jb, pb = env.batches()
    groups = pt.model.param_groups()
    try:
        for stage, loss_name, sst, tag in STAGED_STEPS:
            jt.model.train_stage = pt.model.train_stage = stage
            ref = _jax_step(jt, jb, loss_name, sst, tag)
            assert _port_step(pt, pb, loss_name, sst, tag) == pytest.approx(ref, rel=STEP_RTOL)
            _assert_params(jt, pt)
            for name, p in pt.model.named_parameters():
                assert (p.grad is not None) == (name.split(".")[0] in groups[tag]), (tag, name)
    finally:
        env.jax_model.train_stage = None


def _fit(trainer, loaders, saved=True, seed=12):
    np.random.seed(seed)
    trainer.fit(loaders[0], loaders[1], saved=saved, verbose=False)


def test_fit_and_evaluate_match_jax(lba_env):
    """One pretrain epoch then two finetune epochs (filter + dis, then dis
    only): the epoch losses, the parameters and both halves of the
    evaluation."""
    env = lba_env
    jt, pt = env.pair(pretrain_epochs=1, epochs=2, train_epoch_interval=2)
    seen = []
    train_epoch = pt._train_epoch

    def recording(*args, **kwargs):
        seen.append(train_epoch(*args, **kwargs))
        return seen[-1]

    pt._train_epoch = recording
    _fit(jt, env.jax_loaders)
    _fit(pt, env.loaders)
    assert len(seen) == 2 and seen[0][1] != 0.0 and seen[1][1] == 0.0  # (dis, filter)
    assert all(s[0] != 0.0 for s in seen)
    for epoch, ref in jt.train_loss_dict.items():
        assert pt.train_loss_dict[epoch] == pytest.approx(ref, rel=1e-5)
    _assert_params(jt, pt)
    np.random.seed(4)
    ref = jt.evaluate(env.jax_loaders[2])
    np.random.seed(4)
    ours = pt.evaluate(env.loaders[2])
    assert_same_result(ours, ref)
    assert {k.split("-")[0] for k in ours} == {"pretrain", "finetune"}
    assert pt.model.train_stage == "finetune"
    assert os.path.isfile(pt.saved_pretrain_model_file)


def test_checkpoints_hold_no_propagation_matrix(lba_env):
    """The port's pretrain and finetune checkpoints: parameters and the
    three optimizers' states, no array of the matrices' sizes; the JAX
    trainer evaluates them to the port's dicts."""
    env = lba_env
    jt, pt = env.pair(pretrain_epochs=1, epochs=1)
    _fit(pt, env.loaders)
    n = pt.model.n_users + pt.model.n_items
    for path in (pt.saved_pretrain_model_file, pt.saved_model_file):
        checkpoint = load_checkpoint(path)
        assert checkpoint["model_state"] == {}
        assert {"optimizer", "optimizer_filter", "optimizer_dis"} <= set(checkpoint)
        arrays = [v for v in _flatten(checkpoint).values() if isinstance(v, np.ndarray)]
        assert all(a.size < n * n for a in arrays), path
        held = _flatten({"params": checkpoint["params"]})
        assert not any("dense" in k or "norm_" in k or "gcn_" in k for k in held)
    assert load_checkpoint(pt.saved_pretrain_model_file)["train_stage"] == "pretrain"
    assert load_checkpoint(pt.saved_model_file)["train_stage"] == "finetune"
    jt.saved_pretrain_model_file = pt.saved_pretrain_model_file
    np.random.seed(5)
    ref = jt.evaluate(env.jax_loaders[2], model_file=pt.saved_model_file)
    np.random.seed(5)
    assert_same_result(pt.evaluate(env.loaders[2]), ref)


def test_jax_checkpoints_serve_and_resume_in_the_port(lba_env):
    """Checkpoints the JAX trainer wrote: the port serves them through
    ``load_data_and_model`` (the pretrain one given as
    ``pretrain_model_file_path``) to the JAX dicts, and a port trainer
    resumed from the finetune one (its masked filter and dis Adam states
    included) takes the next steps as the resumed JAX trainer does."""
    env = lba_env
    jt, _ = env.pair(pretrain_epochs=1, epochs=1, train_epoch_interval=1)
    _fit(jt, env.jax_loaders)
    ckpt, pre = jt.saved_model_file, jt.saved_pretrain_model_file
    np.random.seed(6)
    ref = jt.evaluate(env.jax_loaders[2])
    _, _, trainer, _, _, _, test_data = load_data_and_model(
        ckpt, {"use_gpu": False, "pretrain_model_file_path": pre})
    assert type(trainer) is {"FairGo_PMF": FairGo_PMFTrainer,
                             "FairGo_GCN": FairGo_GCNTrainer}[env.name]
    assert trainer.model.train_stage == "finetune"
    np.random.seed(6)
    assert_same_result(trainer.evaluate(test_data), ref)

    jt2, pt2 = env.pair(pretrain_epochs=1, epochs=2, train_epoch_interval=1)
    jt2.resume_checkpoint(ckpt)
    pt2.resume_checkpoint(ckpt)
    assert pt2.start_epoch == jt2.start_epoch == 1
    assert pt2.model.train_stage == "finetune"
    _assert_params(jt2, pt2, atol=0.0)
    jb, pb = env.batches()
    for _, loss_name, sst, tag in STAGED_STEPS[1:3]:
        ref = _jax_step(jt2, jb, loss_name, sst, tag)
        assert _port_step(pt2, pb, loss_name, sst, tag) == pytest.approx(ref, rel=STEP_RTOL)
        _assert_params(jt2, pt2)


def test_stage_resolution_and_sst_embed_files(lba_env, tmp_path):
    """``pretrain_model_file_path`` loads that checkpoint and finetunes; a
    plain config pretrains first; ``save_sst_embed`` writes the pretrained
    and the finetuned users as the JAX package does."""
    env = lba_env
    _, pt = env.pair(pretrain_epochs=1, epochs=1, save_sst_embed=True)
    _fit(pt, env.loaders)
    model, aggr = env.name, env.config["aggr_method"]
    files = {os.path.basename(p) for p in glob.glob(os.path.join(pt.checkpoint_dir, "*embed*"))}
    assert files == {f"{model}-fair-pretrain_embed[none].pth",
                     f"{model}-{aggr}_embed-[gender_age].pth"}
    with open(pt.saved_sst_embed_file, "rb") as f:
        stored = pickle.load(f)
    assert stored["embedding"].shape == (pt.model.n_users - 1, FAIRGO["embedding_size"])
    env.config["pretrain_model_file_path"] = pt.saved_pretrain_model_file
    try:
        _, finetuner = env.pair(save_sst_embed=False)
    finally:
        env.config["pretrain_model_file_path"] = None
        env.config["save_sst_embed"] = False
    assert finetuner.model.train_stage == "finetune"
    pre = load_checkpoint(pt.saved_pretrain_model_file)["params"]
    np.testing.assert_array_equal(finetuner.model.user_embedding.weight.detach().numpy(),
                                  pre["user_embedding"])


@pytest.mark.parametrize("model", MODELS)
def test_registry_resolves_fairgo(model):
    assert get_model(model).__name__ == model
    trainer = get_trainer(None, model)
    assert trainer.__name__ == f"{model}Trainer"
    assert trainer.__name__ == jax_get_trainer(None, model).__name__


# ---------------------------------------------------------- entry points


def assert_same_run(ours, ref):
    """Result dicts of two ``run_recbole`` calls (keys ``pretrain-*`` and
    ``finetune-*``) within the run tolerances of the module doc."""
    assert list(ours) == list(ref)
    for key in ref:
        if key.split("-", 1)[-1].startswith(RANK_METRICS):
            assert ours[key] == pytest.approx(ref[key], abs=RANK_ATOL), key
        else:
            assert ours[key] == pytest.approx(ref[key], rel=RUN_VALUE_RTOL, abs=VALUE_ATOL), key


@pytest.mark.parametrize("model", MODELS)
def test_run_recbole_matches_jax(model, tmp_path, monkeypatch):
    """``run_recbole`` pretrain → finetune with the model's published YAML
    (the columns, label and threshold passed as the YAML gives them; one
    pretrain and one finetune epoch of 5 batches; the GCN's dropout 0): the same
    ``pretrain-*`` and ``finetune-*`` results as the JAX package's from the
    same initial weights, every one of the 12 metric families."""
    yaml = _published_yaml(model)
    root = write_dataset(str(tmp_path))
    results = {}
    for side in ("jax", "port"):
        cfg = {"data_path": root, **{k: yaml[k] for k in ("load_col", "LABEL_FIELD", "threshold")},
               "pretrain_epochs": 1, "epochs": 1, "train_batch_size": 128, "gcn_dropout": 0.0,
               "metric_decimal_place": 10, "show_progress": False, "state": "ERROR",
               "checkpoint_dir": str(tmp_path / side), "log_root": str(tmp_path / side / "log")}
        if side == "jax":
            inits = _capture_jax_init(monkeypatch)
            results[side] = jax_pkg.run_recbole(model, "fair", config_dict=cfg)
        else:
            _port_models_start_from(monkeypatch, list(inits))
            results[side] = port_pkg.run_recbole(model, "fair",
                                                 config_dict={**cfg, "use_gpu": False})
    ref, ours = results["jax"], results["port"]
    assert ours["best_valid_score"] == pytest.approx(ref["best_valid_score"], abs=RANK_ATOL)
    assert_same_run(ours["best_valid_result"], ref["best_valid_result"])
    assert_same_run(ours["test_result"], ref["test_result"])
    for stage in ("pretrain", "finetune"):
        half = {k[len(stage) + 1:]: v for k, v in ours["test_result"].items()
                if k.startswith(stage + "-")}
        assert_families(half, yaml["sst_attr_list"])


def test_run_recbole_on_ml100k_matches_jax(tmp_path, monkeypatch):
    """FairGo_PMF on ``dataset/ml-100k-fair`` with its published YAML, cut
    to a few steps (one pretrain and one finetune epoch of 5 batches)."""
    yaml = _published_yaml("FairGo_PMF")
    results = {}
    for side in ("jax", "port"):
        cfg = {"data_path": os.path.join(REPO, "dataset"),
               **{k: yaml[k] for k in ("load_col", "LABEL_FIELD", "threshold")},
               "pretrain_epochs": 1, "epochs": 1, "train_batch_size": 16384,
               "metric_decimal_place": 10, "show_progress": False, "state": "ERROR",
               "save_sst_embed": False,
               "checkpoint_dir": str(tmp_path / side), "log_root": str(tmp_path / side / "log")}
        if side == "jax":
            inits = _capture_jax_init(monkeypatch)
            results[side] = jax_pkg.run_recbole("FairGo_PMF", "ml-100k-fair", config_dict=cfg)
        else:
            _port_models_start_from(monkeypatch, list(inits))
            results[side] = port_pkg.run_recbole("FairGo_PMF", "ml-100k-fair",
                                                 config_dict={**cfg, "use_gpu": False})
    assert_same_run(results["port"]["test_result"], results["jax"]["test_result"])


def _write_preload(root, name, dim, seed=9):
    """``.user_emb`` / ``.item_emb`` atomic files of random tables for every
    user and item token of the dataset."""
    rng = np.random.RandomState(seed)
    for suffix, field, column in (("user_emb", "uid", "user_id"), ("item_emb", "iid", "item_id")):
        with open(os.path.join(root, name, f"{name}.inter")) as f:
            header = f.readline().rstrip("\n").split("\t")
            col = [h.split(":")[0] for h in header].index(column)
            tokens = sorted({line.split("\t")[col] for line in f}, key=int)
        with open(os.path.join(root, name, f"{name}.{suffix}"), "w") as f:
            f.write(f"{field}:token\t{suffix}:float_seq\n")
            for t in tokens:
                f.write(f"{t}\t{' '.join(f'{v:.6f}' for v in rng.randn(dim))}\n")


PRELOAD = {"additional_feat_suffix": ["user_emb", "item_emb"],
           "alias_of_user_id": ["uid"], "alias_of_item_id": ["iid"],
           "preload_weight": {"uid": "user_emb", "iid": "item_emb"},
           "load_pretrain_weight": True}


def test_load_pretrain_weight_matches_jax(tmp_path, monkeypatch):
    """Finetune from preloaded ``.user_emb`` / ``.item_emb`` tables (the
    files written here): the port's tables are the JAX package's, the run
    skips pretraining, and the ``finetune-*`` results match."""
    root = write_dataset(str(tmp_path))
    _write_preload(root, "fair", FAIRGO["embedding_size"])
    load_col = {"inter": ["user_id", "item_id", "rating"], "user": ["user_id", "gender", "age"],
                "user_emb": ["uid", "user_emb"], "item_emb": ["iid", "item_emb"]}
    results, tables = {}, {}
    for side in ("jax", "port"):
        cfg = published_config(root, str(tmp_path / side), {
            **FAIRGO, **PRELOAD, "load_col": load_col, "epochs": 2, "train_epoch_interval": 1})
        if side == "jax":
            inits = _capture_jax_init(monkeypatch)
            results[side] = jax_pkg.run_recbole("FairGo_PMF", "fair", config_dict=cfg)
            tables[side] = inits[0]
        else:
            built = []
            get_model_fn = port_pkg.quick_start.get_model

            def recording(name):
                cls = get_model_fn(name)

                def build(*args, **kwargs):
                    built.append(cls(*args, **kwargs))
                    preloaded = to_jax_params(built[-1])
                    load_jax_params(built[-1], {**inits[0], "user_embedding":
                                                preloaded["user_embedding"], "item_embedding":
                                                preloaded["item_embedding"]})
                    return built[-1]

                return build

            monkeypatch.setattr(port_pkg.quick_start, "get_model", recording)
            results[side] = port_pkg.run_recbole("FairGo_PMF", "fair",
                                                 config_dict={**cfg, "use_gpu": False})
            tables[side] = to_jax_params(built[0])
    for key in ("user_embedding", "item_embedding"):
        assert np.abs(tables["port"][key]).max() > 0
        np.testing.assert_array_equal(tables["port"][key], tables["jax"][key])
    ours, ref = results["port"]["test_result"], results["jax"]["test_result"]
    assert all(k.startswith("finetune-") for k in ours)
    assert_same_run(ours, ref)

