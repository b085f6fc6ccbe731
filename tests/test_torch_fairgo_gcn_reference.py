"""FairGo_GCN's pretrain in the port against the benchmark's plain reference
(``benchmark/reference/fairgo_gcn.py``, loaded by path: plain PyTorch,
nothing of the port), on the CPU at a small size: 60 users and 40 items
(PAD rows besides), d 8, hidden 4, two convolutions, seeded random weights.
Dropout 0.2 (the reference draws the program's masks from the state its
dropout generator had before the step) and 0, through the CSR and the dense
propagation: the pretrain loss, the gradient of every leaf of the pretrain
group, and one Adam step through ``Trainer._train_step``. Faults planted in
the reference (a hop dropped, dropout off) and the reference's hops in
bfloat16 must fail the same comparisons.

Tolerances (the port in float32, the reference in float64 over 102 nodes;
the gap is the port's own rounding):
* loss: rel 1e-6 (float32 sums of a few hundred terms of order 1-10);
* gradients: per leaf, the norm of the gap within 1e-5 of the reference's
  norm of that leaf or of the median leaf, whichever is larger (float32
  products and sums through two hops and two GEMMs each way; the port reads
  ~1e-7). A bfloat16 hop moves them by ~1e-4 to 1e-3 and fails;
* one Adam step: parameters abs 1e-6 (the step is about ±lr = 1e-3 on every
  element, the float32 parameter's own rounding ~1e-7 for N(0, 1) tables);
  the moments, which hold 0.1 g and 0.001 g² after one step, compared as the
  gradient they hold, element-wise at abs 1e-6 + rel 1e-5.
"""

import importlib.util
import os
import statistics

import pytest
import torch

from recbole_fairrec_tpu_torch import Config
from recbole_fairrec_tpu_torch.trainer import FairGo_GCNTrainer
from recbole_fairrec_tpu_torch.utils import get_model
from test_torch_fairgo_reference import N_ITEMS, N_USERS
from test_torch_fairgo_reference import World as FairGoWorld

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, HIDDEN = 8, 4
SETTINGS = {"embedding_size": D, "hidden_channels": HIDDEN, "gcn_n_layers": 2, "gcn_act": "relu",
            "n_layers": 2, "aggr_method": "LBA", "vs_weights": [4, 1],
            "filter_hidden_size_list": [16, 8], "dis_hidden_size_list": [8, 4],
            "activation": "leakyrelu", "fair_weight": 0.1, "sst_attr_list": ["gender", "age"],
            "learning_rate": 1e-3, "weight_decay": 1e-4, "load_pretrain_weight": False,
            "use_gpu": False, "seed": 7}
# the parameters the pretrain never reads, left at the program's init
UNREAD = ("filters.", "discriminators.", "aggr.")
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL, PARAM_ATOL = 1e-6, 1e-5, 1e-6, 1e-6
CPU = torch.device("cpu")


def _load_reference():
    path = os.path.join(REPO, "benchmark", "reference", "fairgo_gcn.py")
    spec = importlib.util.spec_from_file_location("fairgo_gcn_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load_reference()


class World:
    """FairGo's small graph and batches (``test_torch_fairgo_reference``),
    the reference's spec for a dropout rate and the GCN's initial state."""

    def __init__(self, root, seed=0):
        self.base = FairGoWorld(root, seed)
        self.root, self.data, self.edges = root, self.base.data, self.base.edges
        self.initial = REF.initial_state(self.spec(0.2), 13, CPU)

    def spec(self, p):
        return REF.Spec(N_USERS, N_ITEMS, D, HIDDEN, 2, p, 1e-3, 1e-4)

    def batch(self):
        return self.base.batch()

    def port(self, dense, p, trainer=False):
        config = Config(model="FairGo_GCN", dataset="fairgo_gcn_tiny",
                        config_dict={**SETTINGS, "gcn_dropout": p, "dense_propagation": dense,
                                     "checkpoint_dir": os.path.join(self.root, "saved"),
                                     "log_root": os.path.join(self.root, "log")})
        model = get_model("FairGo_GCN")(config, self.data)
        missing, unexpected = model.load_state_dict(self.initial, strict=False)
        assert not unexpected and all(k.startswith(UNREAD) for k in missing)
        assert model.dense_propagation == dense
        if not trainer:
            model.train_stage = "pretrain"
            return model
        tr = FairGo_GCNTrainer(config, model)
        assert model.train_stage == "pretrain"
        return tr


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(str(tmp_path_factory.mktemp("fairgo_gcn_reference")))


def _port_loss_and_grads(world, dense, p, batch):
    """The port's loss and pretrain-group gradients, and its dropout
    generator's state before the step."""
    model = world.port(dense, p)
    state = model.dropout_generator(CPU).get_state()
    names = world.spec(p).group()
    params = dict(model.named_parameters())
    loss = model.calculate_loss(batch)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    return (float(loss.detach()), dict(zip(names, grads))), state


def _reference_loss_and_grads(world, p, batch, generator_state, **faults):
    spec = world.spec(p)
    graph = REF.Graph(spec, *world.edges, bfloat16=faults.get("precision") == "bfloat16")
    state = {n: t.double().requires_grad_(True) for n, t in world.initial.items()}
    model = REF.Model(spec, state, graph, generator_state, **faults)
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, [state[n] for n in spec.group()])
    return float(loss.detach()), dict(zip(spec.group(), grads))


def _grad_gap(port, ref):
    """Per leaf, the norm of the gap over the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in ref.items()}
    median = statistics.median(norms.values())
    return {n: float(torch.linalg.vector_norm(port[n].double() - g)) / max(norms[n], median)
            for n, g in ref.items()}


def _gaps(port, ref):
    """(the loss's relative gap, the worst leaf's gradient gap)."""
    (pl, pg), (rl, rg) = port, ref
    return abs(pl - rl) / abs(rl), max(_grad_gap(pg, rg).values())


def _agree(port, ref):
    loss_gap, grad_gap = _gaps(port, ref)
    return loss_gap <= LOSS_RTOL and grad_gap <= GRAD_RTOL


def test_the_reference_matrix_is_the_ports(world):
    """The reference builds Â from the edge list on its own; the port's COO
    arrays and dense matrix hold the same matrix."""
    ref = REF.Graph(world.spec(0.2), *world.edges).matrix.to_dense()
    n = N_USERS + N_ITEMS
    for dense in (False, True):
        model = world.port(dense, 0.2)
        coo = torch.zeros(n, n, dtype=torch.float64)
        coo.index_put_((model.gcn_rows, model.gcn_cols), model.gcn_vals.double(), accumulate=True)
        torch.testing.assert_close(coo, ref, rtol=1e-6, atol=1e-9)
        if dense:
            torch.testing.assert_close(model.gcn_dense.double(), ref, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("dense", [False, True], ids=["csr", "dense"])
@pytest.mark.parametrize("p", [0.2, 0.0], ids=["dropout", "no_dropout"])
def test_loss_and_gradients_equal_the_reference(world, dense, p):
    batch = world.batch()
    port, state = _port_loss_and_grads(world, dense, p, batch)
    ref = _reference_loss_and_grads(world, p, batch, state)
    loss_gap, grad_gap = _gaps(port, ref)
    assert loss_gap <= LOSS_RTOL, (port[0], ref[0])
    assert grad_gap <= GRAD_RTOL, _grad_gap(port[1], ref[1])
    # the loss reaches every leaf: both tables through two hops, both convolutions
    assert all(float(g.abs().sum()) > 0 for g in ref[1].values())


@pytest.mark.parametrize("dense", [False, True], ids=["csr", "dense"])
@pytest.mark.parametrize("p", [0.2, 0.0], ids=["dropout", "no_dropout"])
def test_one_adam_step_equals_the_reference(world, dense, p):
    """One ``Trainer._train_step`` with the pretrain optimizer against the
    reference's step from the same state and dropout generator state: every
    parameter (the ones the pretrain does not step unmoved), and the
    moments."""
    trainer = world.port(dense, p, trainer=True)
    model, tx = trainer.model, trainer.tx_pretrain
    batch = world.batch()
    before = {"model": {n: t.detach().clone() for n, t in model.state_dict().items()},
              "opt": {}}
    generator_state = model.dropout_generator(CPU).get_state()
    trainer._train_step({k: v.clone() for k, v in batch.items()}, "calculate_loss", None, tx)
    ref = REF.train_steps(world.spec(p), world.edges, [(batch, generator_state)], [before])
    after = ref["passages"][0]["after"]
    for n, t in model.state_dict().items():
        torch.testing.assert_close(t, after["model"][n], rtol=0, atol=PARAM_ATOL,
                                   msg=lambda m, n=n: f"{n}: {m}")
        if n.startswith(UNREAD):
            assert torch.equal(t, before["model"][n]), n
    names = {id(p): n for n, p in model.named_parameters()}
    stepped = []
    for group in tx.param_groups:
        for param in group["params"]:
            st = tx.state[param]
            m, v, t = after["opt"]["pretrain"][names[id(param)]]
            # after one step the moments hold 0.1 g and 0.001 g²: compared as the gradient
            torch.testing.assert_close(st["exp_avg"] / 0.1, m / 0.1, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL)
            torch.testing.assert_close((st["exp_avg_sq"] / 0.001).sqrt(), (v / 0.001).sqrt(),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
            assert float(st["step"]) == t == 1.0
            stepped.append(names[id(param)])
    assert sorted(stepped) == sorted(world.spec(p).group())


# fault → (what it plants in the reference, the dropout rates at which it shows): the
# last convolution's hop left out, the masks left out where the port draws them, the
# hops' matrix, inputs and incoming gradients rounded to bfloat16
FAULTS = {
    "hop_dropped": ({"one_hop": True}, [0.2, 0.0]),
    "dropout_off": ({"dropout": 0.0}, [0.2]),
    "bfloat16_hops": ({"precision": "bfloat16"}, [0.2, 0.0]),
}


@pytest.mark.parametrize("dense", [False, True], ids=["csr", "dense"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_fail_the_comparison(world, fault, dense):
    """A reference with the fault disagrees with the port where the sound
    reference agrees, through either propagation."""
    faults, rates = FAULTS[fault]
    for p in rates:
        batch = world.batch()
        port, state = _port_loss_and_grads(world, dense, p, batch)
        assert _agree(port, _reference_loss_and_grads(world, p, batch, state))
        assert not _agree(port, _reference_loss_and_grads(world, p, batch, state, **faults)), \
            (fault, dense, p)
