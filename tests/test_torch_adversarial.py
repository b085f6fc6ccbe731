"""The adversarial PFCN models of the port against the JAX package's, on the
CPU: the MLP stack, the filters and the discriminators of PFCN_PMF,
PFCN_MLP, PFCN_BiasedMF and PFCN_DMF in ``cm`` and ``sm`` mode.

Both packages build the model over the same small dataset (a binary
``gender`` for the BCE head, a three-valued ``age`` for the CE head); the
JAX package's initial parameters and BatchNorm state, perturbed so that no
gamma is 1 and no running statistic is at its start, go to the port through
``load_jax_params``. Dropout is 0 in both (their generators cannot match
draw for draw).

Tolerances (float32; the two packages sum in different orders): losses rel
1e-6; gradients, BatchNorm running statistics and eval outputs abs 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recbole_fairrec_tpu.config import Config as JaxConfig
from recbole_fairrec_tpu.data import create_dataset as jax_create_dataset
from recbole_fairrec_tpu.data import data_preparation as jax_data_preparation
from recbole_fairrec_tpu.models import layers as jax_layers
from recbole_fairrec_tpu.utils import get_model as jax_get_model
from recbole_fairrec_tpu.utils import init_seed as jax_init_seed

from recbole_fairrec_tpu_torch import Config
from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
from recbole_fairrec_tpu_torch.models import layers
from recbole_fairrec_tpu_torch.utils import get_model, init_seed
from recbole_fairrec_tpu_torch.utils.jax_params import (
    _flatten,
    _jax_name,
    _tables,
    load_jax_params,
    to_jax_params,
    to_jax_state,
)
from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)

N_USERS, N_ITEMS, BATCH = 32, 40, 64
LOSS_RTOL, ATOL = 1e-6, 1e-5

# the cases of tests/test_loss_parity.py, and the backbones' missing modes
PFCN_CASES = [
    ("PFCN_PMF", "cm", ["gender"]),
    ("PFCN_PMF", "sm", ["gender", "age"]),
    ("PFCN_MLP", "sm", ["gender"]),
    ("PFCN_MLP", "cm", ["gender", "age"]),
    ("PFCN_BiasedMF", "cm", ["gender"]),
    ("PFCN_DMF", "cm", ["gender", "age"]),
    ("PFCN_BiasedMF", "sm", ["gender", "age"]),
    ("PFCN_DMF", "sm", ["gender"]),
]
CASE_IDS = [f"{m}-{f}-{len(a)}" for m, f, a in PFCN_CASES]


def write_dataset(root, name="adv", seed=5):
    """Every user rates 10 random items, every item is rated; ``gender`` =
    u mod 2, ``age`` = u mod 3."""
    ddir = os.path.join(root, name)
    os.makedirs(ddir, exist_ok=True)
    rng = np.random.RandomState(seed)
    rows = set()
    for u in range(1, N_USERS + 1):
        rows.update((u, int(i)) for i in rng.choice(np.arange(1, N_ITEMS + 1), 10, replace=False))
    rows.update((1 + i % N_USERS, i) for i in range(1, N_ITEMS + 1))
    with open(os.path.join(ddir, f"{name}.inter"), "w") as f:
        f.write("user_id:token\titem_id:token\trating:float\ttimestamp:float\n")
        for t, (u, i) in enumerate(sorted(rows)):
            f.write(f"{u}\t{i}\t{1 + (u * i) % 5}\t{t}\n")
    with open(os.path.join(ddir, f"{name}.user"), "w") as f:
        f.write("user_id:token\tgender:float\tage:float\n")
        for u in range(1, N_USERS + 1):
            f.write(f"{u}\t{u % 2}\t{u % 3}\n")
    return root


def case_config(data_path, ckpt_dir, model, mode, attrs):
    return {
        "data_path": data_path,
        "load_col": {"inter": ["user_id", "item_id", "rating"],
                     "user": ["user_id", "gender", "age"]},
        "filter_mode": mode, "sst_attr_list": list(attrs),
        "embedding_size": 16, "mlp_hidden_size_list": [24, 12], "dis_hidden_size_list": [16, 8],
        "num_layers": 2, "dis_weight": 10.0,
        "dropout": 0.0, "dis_dropout": 0.0, "mlp_dropout": 0.0,
        "eval_args": {"split": {"RS": [8, 1, 1]}, "order": "RO", "group_by": "user",
                      "mode": "full"},
        "metrics": ["NDCG", "Recall", "Hit", "MRR"], "topk": [10], "valid_metric": "NDCG@10",
        "show_progress": False, "save_sst_embed": False, "state": "ERROR",
        "checkpoint_dir": ckpt_dir, "log_root": os.path.join(ckpt_dir, "log"),
    }


def perturb(params, state, seed=0):
    """The JAX init trees with every normal(0, 0.01) weight scaled to std
    0.3 (PFCN_MLP's scorer keeps its nn.Linear-default init), gamma
    and beta moved off 1 and 0, and the running statistics off their
    start (numpy trees)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x, dtype=np.float32)
        name = getattr(path[-1], "key", None)
        if name == "w" and x.std() < 0.05:  # normal(0, 0.01) init: filters, discriminators, towers
            return x * 30.0
        if name == "gamma":
            return x + 0.2 * rng.randn(*x.shape).astype(np.float32)
        if name in ("beta", "mean"):
            return 0.2 * rng.randn(*x.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x.copy()

    return (jax.tree_util.tree_map_with_path(leaf, params),
            jax.tree_util.tree_map_with_path(leaf, state))


class Pair:
    """One case built in both packages over the same data, with the same
    weights; ``port(...)`` gives a fresh port model from them."""

    def __init__(self, root, model, mode, attrs):
        self.name = model
        cfg = case_config(write_dataset(root), os.path.join(root, "saved"), model, mode, attrs)
        self.jax_config = JaxConfig(model=model, dataset="adv", config_dict=cfg)
        jax_init_seed(self.jax_config["seed"], True)
        jax_ds = jax_data_preparation(self.jax_config, jax_create_dataset(self.jax_config))[0].dataset
        self.jax_model = jax_get_model(model)(self.jax_config, jax_ds)
        self.config = Config(model=model, dataset="adv", config_dict={**cfg, "use_gpu": False})
        init_seed(self.config["seed"], True)
        self.dataset = data_preparation(self.config, create_dataset(self.config))[0].dataset
        for field in ("user_id", "item_id"):
            np.testing.assert_array_equal(np.asarray(jax_ds.inter_feat[field]),
                                          np.asarray(self.dataset.inter_feat[field]))
        self.params, self.state = perturb(*self.jax_model.init_params(jax.random.PRNGKey(0)))
        self.attrs = tuple(attrs)

    def port(self, params=None, state=None):
        model = get_model(self.name)(self.config, self.dataset)
        load_jax_params(model, self.params if params is None else params,
                        self.state if state is None else state)
        return model

    def jax_params(self):
        return jax.tree_util.tree_map(jnp.asarray, self.params)

    def jax_state(self):
        return jax.tree_util.tree_map(jnp.asarray, self.state)

    def batch(self, n=BATCH, seed=3):
        """(numpy batch, JAX batch, torch batch) of ``n`` train rows."""
        feat = self.dataset.inter_feat
        users = self.dataset.get_user_feature()
        rng = np.random.RandomState(seed)
        rows = rng.choice(len(feat), n, replace=False)
        uid = np.asarray(feat["user_id"])[rows].astype(np.int64)
        batch = {
            "user_id": uid,
            "item_id": np.asarray(feat["item_id"])[rows].astype(np.int64),
            "neg_item_id": rng.randint(1, N_ITEMS + 1, n).astype(np.int64),
        }
        for sst in self.attrs:
            batch[sst] = np.asarray(users[sst])[uid].astype(np.float32)
        return (batch, {k: jnp.asarray(v) for k, v in batch.items()},
                {k: torch.from_numpy(v) for k, v in batch.items()})

    def subsets(self):
        return [self.attrs[:1], self.attrs[1:], self.attrs] if len(self.attrs) == 2 \
            else [self.attrs]


@pytest.fixture(scope="module", params=PFCN_CASES, ids=CASE_IDS)
def pair(request, tmp_path_factory):
    return Pair(str(tmp_path_factory.mktemp("adv")), *request.param)


def assert_trees_close(ref, ours, atol, what):
    ref, ours = _flatten(jax.tree_util.tree_map(np.asarray, ref)), _flatten(ours)
    assert sorted(ref) == sorted(ours), what
    for key, value in ref.items():
        np.testing.assert_allclose(ours[key], value, rtol=0, atol=atol, err_msg=f"{what} {key}")


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("loss_name", ["calculate_loss", "calculate_dis_loss"])
def test_losses_gradients_and_bn_statistics_match_jax(pair, loss_name):
    """Loss, gradient of every parameter and the BatchNorm running statistics
    after the call, for every subset. The filter loss runs the filters twice
    (BPR, then the discriminator term), so their statistics move twice."""
    _, jbatch, tbatch = pair.batch()
    for sst in pair.subsets():
        def jax_loss(p):
            return getattr(pair.jax_model, loss_name)(p, pair.jax_state(), jbatch, None, sst)

        (ref, ref_state), ref_grads = jax.value_and_grad(jax_loss, has_aux=True)(
            pair.jax_params())
        model = pair.port()
        loss = getattr(model, loss_name)(tbatch, sst_list=sst)
        loss.backward()
        assert float(loss.detach()) == pytest.approx(float(ref), rel=LOSS_RTOL), sst
        ours = {}
        for name, p in model.named_parameters():
            ours[name] = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        ref_flat = _flatten(jax.tree_util.tree_map(np.asarray, ref_grads))
        ours = dict(_flatten({n: ours[t] for n, t in _jax_to_port_names(model).items()}))
        assert sorted(ref_flat) == sorted(ours)
        for key, value in ref_flat.items():
            np.testing.assert_allclose(ours[key], value, rtol=0, atol=ATOL, err_msg=f"grad {key}")
        assert_trees_close(ref_state, to_jax_state(model), ATOL, f"BN state {sst}")


def _jax_to_port_names(model):
    tables = _tables(model)
    return {_jax_name(name, tables): name for name, _ in model.named_parameters()}


def test_filter_loss_moves_filter_statistics_twice(pair):
    """One filter-loss call equals two filter forwards' worth of momentum on
    the selected filter's first BatchNorm."""
    _, _, tbatch = pair.batch()
    model = pair.port()
    sst = pair.attrs
    key = (f"f{sum(model.sst_dict[s] for s in sst)}" if model.filter_mode == "sm"
           else f"f{model.sst_dict[sst[0]]}")
    bn = model.filters[key].bn[0]
    start = bn.mean.clone()
    model.calculate_loss(tbatch, sst_list=sst)
    once = pair.port()
    once._user_item_embed(tbatch["user_id"], None, sst, train=True,
                          sample_weight=torch.ones(BATCH))
    moved_once = once.filters[key].bn[0].mean
    # m2 = 0.9 m1 + 0.1 b = 0.81 m0 + 0.19 b, with m1 = 0.9 m0 + 0.1 b
    batch_mean = (moved_once - 0.9 * start) / 0.1
    torch.testing.assert_close(bn.mean, 0.81 * start + 0.19 * batch_mean, rtol=0, atol=1e-5)


def test_one_row_batch(pair):
    """A one-row training batch: BatchNorm returns beta (the JAX package's
    semantics; ``F.batch_norm`` would raise)."""
    _, jbatch, tbatch = pair.batch(n=1)
    for loss_name in ("calculate_loss", "calculate_dis_loss"):
        ref, ref_state = getattr(pair.jax_model, loss_name)(
            pair.jax_params(), pair.jax_state(), jbatch, None, pair.attrs)
        model = pair.port()
        loss = getattr(model, loss_name)(tbatch, sst_list=pair.attrs).detach()
        assert np.isfinite(float(loss))
        assert float(loss) == pytest.approx(float(ref), rel=LOSS_RTOL, abs=1e-6)
        assert_trees_close(ref_state, to_jax_state(model), ATOL, loss_name)


# ------------------------------------------------------------------ eval


def _eval_batch(n=12):
    users = np.arange(1, n + 1, dtype=np.int64)
    return {"user_id": jnp.asarray(users)}, {"user_id": torch.from_numpy(users)}


@pytest.mark.parametrize("emulation", [False, True], ids=["running-stats", "bn-emulation"])
def test_eval_outputs_match_jax(pair, emulation):
    """``full_sort_predict``, ``retrieval_embeddings`` (where the model has
    them) and ``get_sst_embed`` per subset, on the running statistics and in
    the ``reference_bn_eval_emulation`` mode (per-user batch statistics);
    evaluation leaves the running statistics alone."""
    jbatch, tbatch = _eval_batch()
    pair.jax_model._ref_bn_emulation = emulation
    model = pair.port()
    model._ref_bn_emulation = emulation
    model.eval()
    user_feat = pair.dataset.get_user_feature()[1:]
    try:
        for sst in pair.subsets():
            ref = pair.jax_model.full_sort_predict(pair.jax_params(), pair.jax_state(), jbatch, sst)
            with torch.no_grad():
                ours = model.full_sort_predict(tbatch, sst)
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
            if hasattr(pair.jax_model, "retrieval_embeddings"):
                ref_u, ref_t = pair.jax_model.retrieval_embeddings(
                    pair.jax_params(), pair.jax_state(), jbatch, sst)
                with torch.no_grad():
                    u, t = model.retrieval_embeddings(tbatch, sst)
                np.testing.assert_allclose(u.detach().numpy(), np.asarray(ref_u), rtol=0, atol=ATOL)
                np.testing.assert_allclose(t.detach().numpy(), np.asarray(ref_t), rtol=0, atol=ATOL)
            ref_e = pair.jax_model.get_sst_embed(
                pair.jax_params(), pair.jax_state(),
                {k: np.asarray(user_feat[k]) for k in pair.attrs}, sst)
            ours_e = model.get_sst_embed(user_feat, sst)
            assert sorted(ours_e) == sorted(ref_e)
            for key in sst:
                np.testing.assert_array_equal(ours_e[key], np.asarray(ref_e[key]))
            np.testing.assert_allclose(ours_e["embedding"], np.asarray(ref_e["embedding"]),
                                       rtol=0, atol=ATOL)
    finally:
        pair.jax_model._ref_bn_emulation = False
    assert_trees_close(pair.state, to_jax_state(model), 0.0, "eval moved the statistics")


def test_bn_emulation_is_beta_for_single_users(pair):
    """With one row per user, per-user statistics normalise every row to
    beta: the filtered representation no longer depends on the user."""
    _, tbatch = _eval_batch()
    model = pair.port()
    model._ref_bn_emulation = True
    x = torch.randn(12, model.embedding_size, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model._apply_filters(x, pair.attrs, False, segments=tbatch["user_id"])
    assert torch.allclose(out, out[:1].expand_as(out), atol=1e-6)


# ------------------------------------------------------------ parameters


def test_param_tree_round_trip(pair):
    """``to_jax_params`` / ``to_jax_state`` give back the JAX trees the model
    was loaded from (lists and all), and ``param_groups`` names every
    parameter once."""
    model = pair.port()
    assert_trees_close(pair.params, to_jax_params(model), 0.0, "params")
    assert_trees_close(pair.state, to_jax_state(model), 0.0, "state")
    assert isinstance(to_jax_params(model)["filters"]["f1"]["linear"], list)
    groups = model.param_groups()
    assert sorted(groups["filter"] + groups["dis"]) == sorted(to_jax_params(model))
    assert groups == pair.jax_model.param_groups()


def test_load_jax_params_requires_the_state(pair):
    model = get_model(pair.name)(pair.config, pair.dataset)
    with pytest.raises(KeyError, match="filters.f1.bn.0.mean"):
        load_jax_params(model, pair.params)


# ------------------------------------------------------------- the stack


def _jax_mlp(sizes, bn, seed=0):
    p = jax_layers.init_mlp(jax.random.PRNGKey(seed), sizes, init_method="norm", bn=bn)
    s = jax_layers.init_mlp_state(sizes, bn=bn)
    return perturb(p, s, seed)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("activation", ["leakyrelu", "relu", "sigmoid", "tanh", "none"])
def test_mlp_matches_apply_mlp(activation, weighted):
    """Train (batch statistics, weighted by a 1/0 row mask) and eval
    (running statistics) forwards and the statistics' update."""
    sizes = [6, 10, 4]
    params, state = _jax_mlp(sizes, bn=True)
    x = np.random.RandomState(1).randn(9, 6).astype(np.float32)
    w = np.array([1, 1, 1, 0, 1, 1, 0, 1, 1], np.float32) if weighted else None
    mlp = layers.MLP(sizes, bn=True)
    load_jax_params(mlp, params, state)
    for train in (True, False):
        ref, ref_state = jax_layers.apply_mlp(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), activation=activation,
            state=jax.tree_util.tree_map(jnp.asarray, state), train=train,
            sample_weight=None if w is None else jnp.asarray(w))
        out = mlp(torch.from_numpy(x), activation=activation, train=train,
                  sample_weight=None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=ATOL)
        assert_trees_close(ref_state, to_jax_state(mlp), ATOL, f"train={train}")
        load_jax_params(mlp, params, state)


def test_mlp_one_row_and_inits():
    sizes = [5, 7, 3]
    mlp = layers.MLP(sizes, bn=True)
    out = mlp(torch.randn(1, 5), train=True, activation="none")
    torch.testing.assert_close(out, mlp.bn[-1].beta.detach()[None])
    # one row: the unbiased variance's divisor is max(n - 1, 1), so var moves toward 0
    torch.testing.assert_close(mlp.bn[0].var, torch.full((7,), 0.9))
    gen = torch.Generator().manual_seed(0)
    lin = layers.MLP([400, 300], "torch_linear", generator=gen).linear[0].requires_grad_(False)
    bound = 1 / 20.0
    assert float(lin.w.abs().max()) <= bound and float(lin.b.abs().max()) <= bound
    assert float(lin.b.abs().max()) > 0.9 * bound  # the bias is drawn, not zero
    norm = layers.MLP([400, 300], "norm", generator=gen).linear[0].requires_grad_(False)
    assert abs(float(norm.w.std()) - 0.01) < 5e-4 and float(norm.b.abs().max()) == 0.0


def test_dropout_masks_come_from_the_generator():
    """Same seed, same masks; kept share and 1/keep scaling within stated
    bounds: 200,000 draws at keep 0.7 lie within 5 standard deviations
    (5 · sqrt(0.21 / 200,000) = 0.0051) of 0.7."""
    mlp = layers.MLP([1000, 1], "norm")
    with torch.no_grad():
        mlp.linear[0].w.fill_(0.0)
    captured = []
    mlp.linear[0].register_forward_pre_hook(lambda mod, args: captured.append(args[0]))
    x = torch.ones(200, 1000)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(11)
        outs.append(mlp(x, activation="none", dropout=0.3, train=True, generator=gen))
    torch.testing.assert_close(captured[0], captured[1], rtol=0, atol=0)
    kept = captured[0] != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.0051
    torch.testing.assert_close(captured[0][kept], torch.full((int(kept.sum()),), 1 / 0.7))
    other = mlp(x, activation="none", dropout=0.3, train=True,
                generator=torch.Generator().manual_seed(12))
    assert not torch.equal(captured[-1], captured[0]) and other.shape == (200, 1)
    mlp(x, activation="none", dropout=0.3, train=False)
    assert torch.equal(captured[-1], x)  # no dropout at eval
