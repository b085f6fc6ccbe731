"""FairGo_PMF's adversarial finetune in the port against the benchmark's
plain reference (``benchmark/reference/fairgo.py``, loaded by path: plain
PyTorch, nothing of the port), on the CPU at a small size: 60 users and 40
items (PAD rows besides), d 8, gender (binary) and a 7-group age, seeded
random weights. Both step kinds for every attribute subset, through the COO
and the dense propagation: the losses, the gradients of each optimizer's
group, and one Adam step through ``Trainer._train_step``. Two faults
planted in the reference (a hop dropped, the sigmoid before the multiclass
local cross-entropy removed) must fail the same comparisons.

Tolerances (the port in float32, the reference in float64 over at most 102
nodes; the gap is the port's own rounding):
* losses: rel 1e-6 (float32 sums of a few hundred terms of order 1);
* gradients: per leaf of the step's group, the norm of the gap within 1e-5
  of the reference's norm of that leaf or of the median leaf the loss
  reaches, whichever is larger (float32 products and sums through two hops, the LBA
  head and the MLPs). The LBA head's gradients are ~1e-6 in size and sums
  over rows that cancel, so an element-wise absolute tolerance would pass
  any of them, and against their own norms the port's float32 reads up to
  ~2e-5 there;
* one Adam step: parameters abs 1e-6 (the step is ±lr = 1e-3 on every
  element whose gradient is far from 0, the float32 parameter's own
  rounding is ~1e-8); the moments, which hold 0.1 g and 0.001 g² after one
  step, as the gradient they hold, element-wise at abs 1e-6 + rel 1e-5.
"""

import importlib.util
import itertools
import os
import statistics

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recbole_fairrec_tpu_torch import Config
from recbole_fairrec_tpu_torch.trainer import FairGo_PMFTrainer
from recbole_fairrec_tpu_torch.utils import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_USERS, N_ITEMS, DEGREE, D = 61, 41, 8, 8
ATTRS = {"gender": [0, 1], "age": [0, 1, 2, 3, 4, 5, 6]}
SETTINGS = {"embedding_size": D, "n_layers": 2, "aggr_method": "LBA", "vs_weights": [4, 1],
            "filter_hidden_size_list": [16, 8], "dis_hidden_size_list": [8, 4],
            "activation": "leakyrelu", "fair_weight": 0.1, "sst_attr_list": list(ATTRS),
            "learning_rate": 1e-3, "weight_decay": 1e-4, "load_pretrain_weight": True,
            "use_gpu": False, "seed": 7}
SUBSETS = [("gender",), ("age",), ("gender", "age")]
KINDS = {"filter": ("calculate_loss", "tx_filter"), "dis": ("calculate_dis_loss", "tx_dis")}
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL, PARAM_ATOL = 1e-6, 1e-5, 1e-6, 1e-6


def _load_reference():
    path = os.path.join(REPO, "benchmark", "reference", "fairgo.py")
    spec = importlib.util.spec_from_file_location("fairgo_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load_reference()


class _Data:
    """The dataset object the model's constructor reads."""

    def __init__(self, users, items, ratings, features, tables):
        self.users, self.items, self.ratings = users, items, ratings
        self.inter_feat = {"rating": ratings}
        self.features, self.tables = features, tables

    def num(self, field):
        return {"user_id": N_USERS, "item_id": N_ITEMS}[field]

    def inter_matrix(self, form="coo", value_field=None):
        return sp.coo_matrix((self.ratings, (self.users, self.items)),
                             shape=(N_USERS, N_ITEMS))

    def get_user_feature(self):
        return self.features

    def get_preload_weight(self, field):
        return self.tables[field]


class World:
    """The data, the reference's spec, initial state, graph edges and
    labels, and batches of both halves (training rows, then negatives
    carrying their rows' ratings)."""

    def __init__(self, root, seed=0):
        self.root = root
        rng = np.random.RandomState(seed)
        users = np.repeat(np.arange(1, N_USERS), DEGREE)
        items = np.concatenate([rng.choice(np.arange(1, N_ITEMS), DEGREE, replace=False)
                                for _ in range(N_USERS - 1)])
        ratings = rng.randint(1, 6, len(users)).astype(np.float32)
        self.features = {a: np.concatenate([[0], rng.choice(v, N_USERS - 1)])
                         for a, v in ATTRS.items()}
        self.spec = REF.Spec(N_USERS, N_ITEMS, D, {a: len(v) for a, v in ATTRS.items()},
                             [16, 8], [8, 4], 2, 0.1, 1e-3, 1e-4)
        self.initial = REF.initial_state(self.spec, 11, torch.device("cpu"))
        self.edges = tuple(torch.from_numpy(a) for a in (users, items, ratings))
        self.labels = {a: torch.arange(len(v)) for a, v in ATTRS.items()}
        self.data = _Data(users, items, ratings, self.features,
                          {"uid": self.initial["user_embedding.weight"].numpy(),
                           "iid": self.initial["item_embedding.weight"].numpy()})
        self.rng = rng

    def batch(self, rows=48):
        idx = self.rng.choice(len(self.data.users), rows, replace=False)
        u = torch.from_numpy(self.data.users[idx])
        i = torch.from_numpy(self.data.items[idx])
        r = torch.from_numpy(self.data.ratings[idx])
        users = torch.cat([u, u])
        out = {"user_id": users,
               "item_id": torch.cat([i, torch.from_numpy(self.rng.randint(1, N_ITEMS, rows))]),
               "rating": torch.cat([r, r])}
        for a, values in self.features.items():
            out[a] = torch.from_numpy(values)[users]
        return out

    def port(self, dense, trainer=False):
        config = Config(model="FairGo_PMF", dataset="fairgo_tiny",
                        config_dict={**SETTINGS, "dense_propagation": dense,
                                     "checkpoint_dir": os.path.join(self.root, "saved"),
                                     "log_root": os.path.join(self.root, "log")})
        model = get_model("FairGo_PMF")(config, self.data)
        model.load_state_dict(self.initial, strict=True)
        assert model.dense_propagation == dense
        if not trainer:
            model.train_stage = "finetune"
            return model
        tr = FairGo_PMFTrainer(config, model)
        assert model.train_stage == "finetune"
        return tr

    def reference(self, **faults):
        graph = REF.Graph(self.spec, *self.edges)
        state = {n: t.double().requires_grad_(True) for n, t in self.initial.items()}
        return REF.Model(self.spec, state, graph, self.labels, **faults), state


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(str(tmp_path_factory.mktemp("fairgo_reference")))


def _port_loss_and_grads(world, dense, kind, subset, batch):
    model = world.port(dense)
    names = world.spec.group(kind)
    params = dict(model.named_parameters())
    loss = getattr(model, KINDS[kind][0])(batch, sst_list=subset)
    grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    return float(loss.detach()), {n: (g if g is not None else torch.zeros_like(params[n]))
                         for n, g in zip(names, grads)}


def _reference_loss_and_grads(world, kind, subset, batch, **faults):
    model, state = world.reference(**faults)
    names = world.spec.group(kind)
    loss = model.loss(batch, kind, subset)
    grads = torch.autograd.grad(loss, [state[n] for n in names], allow_unused=True)
    return float(loss.detach()), {n: (g if g is not None else torch.zeros_like(state[n]))
                         for n, g in zip(names, grads)}


def _grad_gap(port, ref):
    """Per leaf, the norm of the gap over the reference's norm of that leaf
    or of the median leaf the loss reaches, whichever is larger."""
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in ref.items()}
    median = statistics.median(v for v in norms.values() if v > 0)
    return {n: float(torch.linalg.vector_norm(port[n].double() - g)) / max(norms[n], median)
            for n, g in ref.items()}


def _agree(port, ref):
    """Whether the port's (loss, grads) agree with the reference's."""
    (pl, pg), (rl, rg) = port, ref
    if abs(pl - rl) > LOSS_RTOL * abs(rl):
        return False
    return max(_grad_gap(pg, rg).values()) <= GRAD_RTOL


@pytest.mark.parametrize("dense", [False, True], ids=["coo", "dense"])
@pytest.mark.parametrize("kind", ["filter", "dis"])
@pytest.mark.parametrize("subset", SUBSETS, ids=["+".join(s) for s in SUBSETS])
def test_loss_and_group_gradients_equal_the_reference(world, dense, kind, subset):
    batch = world.batch()
    port = _port_loss_and_grads(world, dense, kind, subset, batch)
    ref = _reference_loss_and_grads(world, kind, subset, batch)
    assert abs(port[0] - ref[0]) <= LOSS_RTOL * abs(ref[0]), (port[0], ref[0])
    gaps = _grad_gap(port[1], ref[1])
    assert max(gaps.values()) <= GRAD_RTOL, gaps
    # the loss reaches the subset's filters or discriminators (and the LBA head) alone
    reached = {n for n, g in ref[1].items() if float(g.abs().sum()) > 0}
    assert reached == {n for n in ref[1] if n.startswith("aggr.") or any(
        n.startswith(f"{p}.{a}.") for p in ("filters", "discriminators") for a in subset)}


def test_the_reference_matrix_is_the_ports(world):
    """The reference builds D⁻¹A from the edge list on its own; the port's
    COO arrays and dense matrix hold the same matrix."""
    ref = REF.Graph(world.spec, *world.edges).matrix.to_dense()
    for dense in (False, True):
        model = world.port(dense)
        n = N_USERS + N_ITEMS
        coo = torch.zeros(n, n, dtype=torch.float64)
        coo[model.norm_rows, model.norm_cols] = model.norm_vals.double()
        torch.testing.assert_close(coo, ref, rtol=1e-6, atol=1e-9)
        if dense:
            torch.testing.assert_close(model.prop_dense.double(), ref, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("dense", [False, True], ids=["coo", "dense"])
@pytest.mark.parametrize("kind", ["filter", "dis"])
def test_one_adam_step_equals_the_reference(world, dense, kind):
    """One ``Trainer._train_step`` with the kind's optimizer against the
    reference's step from the same state: every parameter, and the moments
    of the stepped group."""
    trainer = world.port(dense, trainer=True)
    model, tx = trainer.model, getattr(trainer, KINDS[kind][1])
    subset = ("gender", "age")
    batch = world.batch()
    before = {"model": {n: t.detach().clone() for n, t in model.state_dict().items()},
              "opt": {}}
    trainer._train_step({k: v.clone() for k, v in batch.items()}, KINDS[kind][0], subset, tx)
    ref = REF.train_steps(world.spec, world.edges, world.labels, [(batch, kind, subset)],
                          [before])
    after = ref["passages"][0]["after"]
    for n, t in model.state_dict().items():
        torch.testing.assert_close(t, after["model"][n], rtol=0, atol=PARAM_ATOL,
                                   msg=lambda m, n=n: f"{n}: {m}")
    names = {id(p): n for n, p in model.named_parameters()}
    moved = 0
    for group in tx.param_groups:
        for p in group["params"]:
            st = tx.state[p]
            m, v, t = after["opt"][kind][names[id(p)]]
            # after one step the moments hold 0.1 g and 0.001 g²: compared as the gradient
            torch.testing.assert_close(st["exp_avg"] / 0.1, m / 0.1, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL)
            torch.testing.assert_close((st["exp_avg_sq"] / 0.001).sqrt(), (v / 0.001).sqrt(),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
            assert float(st["step"]) == t == 1.0
            moved += 1
    assert moved == len(world.spec.group(kind))


# fault → (what it plants, the steps (kind, subset) in which it shows). Both show in
# every discriminator step that reaches them: the LBA head's gradient reads each hop
# directly, and the quirk is the multiclass (age) local term. A filter step reaches
# them only through the discriminators' local term, weighted by fair_weight 0.1 and
# squashed by the quirk's own sigmoid; at these random weights each hop is a mean of
# near-equal rows, so a dropped hop or quirk moves a filter step's gradients by 1e-3
# of the median leaf with age alone, but by ~1e-6 to ~1e-5 when gender's terms are
# there too, against the port's own ~2e-7 there: those steps are left out.
FAULTS = {
    "hop_dropped": ({"one_hop": True},
                    [("dis", s) for s in SUBSETS] + [("filter", ("age",))]),
    "sigmoid_quirk_removed": ({"quirk": False},
                              [("dis", ("age",)), ("dis", ("gender", "age")),
                               ("filter", ("age",))]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_fail_the_comparison(world, fault):
    """A reference with the fault disagrees with the port in every step in
    which it shows, through either propagation, where the sound reference
    agrees."""
    faults, steps = FAULTS[fault]
    for dense, (kind, subset) in itertools.product((False, True), steps):
        batch = world.batch()
        port = _port_loss_and_grads(world, dense, kind, subset, batch)
        assert _agree(port, _reference_loss_and_grads(world, kind, subset, batch))
        assert not _agree(port, _reference_loss_and_grads(world, kind, subset, batch, **faults)), \
            (fault, dense, kind, subset)
