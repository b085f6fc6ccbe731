"""FairGo keeps the filtered table and its hops across discriminator steps
(``models/fairgo_base.py::calculate_dis_loss``) while the tables and the
filters stay unchanged; ``Trainer._train_step`` lets the model see which
parameters a step differentiates by clearing ``requires_grad`` on the others
while the loss runs.

At the small size of ``test_torch_fairgo_reference.py`` (60 users, 40 items,
d 8, gender and a 7-group age), FairGo_PMF and FairGo_GCN in finetune, through
the CSR and the dense propagation: two cycles of a filter step and five
discriminator steps through ``_train_step``, on ("gender", "age") and then
("age",), against a twin trainer loaded with the same parameters and Adam
state before every step (its kept hops are then stale, so it computes them
anew). Every loss, parameter and Adam moment must be the twin's bit for bit,
a discriminator step's loss also that of the loss with every parameter
requiring grad (which keeps nothing), and each cycle must count 1 miss and
4 hits. Then what must not hit: an in-place write to a filter,
``load_state_dict``, another subset; and a loss that differentiates the
filters, which must get their gradients. The card test runs one cycle of
each on a CUDA card (marked ``gpu``; it skips without one).
"""

import copy
import os

import pytest
import torch

from recbole_fairrec_tpu_torch import Config
from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, tracing
from test_torch_fairgo_reference import KINDS, SETTINGS, World

MODELS = ["FairGo_PMF", "FairGo_GCN"]
CYCLE = ["filter"] + ["dis"] * 5
SUBSETS = [("gender", "age"), ("age",)]


@pytest.fixture(autouse=True)
def clean_tracer():
    tracing.disable()
    tracing.reset()
    tracing.enable()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(str(tmp_path_factory.mktemp("fairgo_hop_cache")))


def _trainer(world, model_name, dense, device):
    """A trainer of ``model_name`` in finetune on ``device`` from the world's
    initial tables, filters and discriminators (FairGo_GCN's convolutions
    from its own seeded init)."""
    config = Config(model=model_name, dataset="fairgo_tiny",
                    config_dict={**SETTINGS, "dense_propagation": dense,
                                 "use_gpu": device.type == "cuda",
                                 "checkpoint_dir": os.path.join(world.root, "saved"),
                                 "log_root": os.path.join(world.root, "log")})
    model = get_model(model_name)(config, world.data)
    missing, unexpected = model.load_state_dict(world.initial, strict=False)
    assert not unexpected and all(k.startswith("gcn.") for k in missing), missing
    trainer = get_trainer(config["MODEL_TYPE"], model_name)(config, model)
    assert model.train_stage == "finetune" and model.dense_propagation == dense
    assert trainer.device.type == device.type
    return trainer


def _batch(world, device):
    return {k: v.to(device) for k, v in world.batch().items()}


def _counts():
    c = tracing.counters()
    return c.get("fairgo.hop_cache_hits", 0), c.get("fairgo.hop_cache_misses", 0)


def _step(trainer, batch, kind, subset):
    """One ``_train_step`` of ``kind``; returns (loss, (hits, misses) it
    counted)."""
    before = _counts()
    loss = trainer._train_step(dict(batch), KINDS[kind][0], subset,
                               getattr(trainer, KINDS[kind][1]))
    after = _counts()
    return loss, (after[0] - before[0], after[1] - before[1])


def _load_twin(twin, trainer):
    twin.model.load_state_dict(trainer.model.state_dict())
    for _, attr in KINDS.values():
        getattr(twin, attr).load_state_dict(copy.deepcopy(getattr(trainer, attr).state_dict()))


def _assert_same_state(a, b, label):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), (label, name)
    for _, attr in KINDS.values():
        sa, sb = getattr(a, attr).state_dict()["state"], getattr(b, attr).state_dict()["state"]
        assert sa.keys() == sb.keys(), (label, attr)
        for i in sa:
            for slot in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[i][slot], sb[i][slot]), (label, attr, i, slot)


def run_cycles(world, model_name, dense, device, subsets=SUBSETS):
    """The cycles of ``subsets`` on a trainer and its twin (see the module
    doc); returns the (hits, misses) of each cycle."""
    trainer = _trainer(world, model_name, dense, device)
    twin = _trainer(world, model_name, dense, device)
    trainer.model.train()
    twin.model.train()
    cycles = []
    for subset in subsets:
        hits = misses = 0
        for k, kind in enumerate(CYCLE):
            label = (model_name, dense, subset, k)
            _load_twin(twin, trainer)
            batch = _batch(world, device)
            if kind == "dis":  # every parameter requires grad here: nothing is kept
                plain = twin.model.calculate_dis_loss(dict(batch), subset).detach()
            loss, counted = _step(trainer, batch, kind, subset)
            twin_loss, twin_counted = _step(twin, batch, kind, subset)
            expected = (0, 0) if kind == "filter" else (0, 1) if k == 1 else (1, 0)
            assert counted == expected, label
            assert twin_counted == ((0, 0) if kind == "filter" else (0, 1)), label
            assert torch.equal(loss, twin_loss), label
            if kind == "dis":
                assert torch.equal(loss, plain), label
            _assert_same_state(trainer, twin, label)
            hits, misses = hits + counted[0], misses + counted[1]
        cycles.append((hits, misses))
    return cycles


@pytest.mark.parametrize("dense", [False, True], ids=["csr", "dense"])
@pytest.mark.parametrize("model_name", MODELS)
def test_cycles_equal_cold_cache_steps_bit_for_bit(world, model_name, dense):
    assert run_cycles(world, model_name, dense, torch.device("cpu")) == [(4, 1), (4, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dense", [False, True], ids=["csr", "dense"])
@pytest.mark.parametrize("model_name", MODELS)
def test_card_cycle_equals_cold_cache_steps_bit_for_bit(world, model_name, dense):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert run_cycles(world, model_name, dense, torch.device("cuda"),
                      subsets=SUBSETS[:1]) == [(4, 1)]


def _dis(trainer, world, subset=SUBSETS[0]):
    return _step(trainer, _batch(world, trainer.device), "dis", subset)[1]


@pytest.mark.parametrize("dense", [False, True], ids=["csr", "dense"])
def test_a_write_a_load_or_another_subset_misses(world, dense):
    trainer = _trainer(world, "FairGo_PMF", dense, torch.device("cpu"))
    model = trainer.model
    assert _dis(trainer, world) == (0, 1)
    assert _dis(trainer, world) == (1, 0)
    with torch.no_grad():  # the same values, a new version
        model.filters["gender"].linear[0].w.mul_(1.0)
    assert _dis(trainer, world) == (0, 1)
    assert _dis(trainer, world) == (1, 0)
    model.load_state_dict(model.state_dict())
    assert _dis(trainer, world) == (0, 1)
    assert _dis(trainer, world, ("age", "gender")) == (0, 1)  # the order of the sum
    assert _dis(trainer, world, ("age",)) == (0, 1)
    assert _dis(trainer, world) == (0, 1)  # one entry: the last subset's
    assert _dis(trainer, world) == (1, 0)


def test_a_filter_write_changes_the_next_loss(world):
    """After an in-place write to a filter the kept hops are not read: the
    loss is that of the changed filter."""
    trainer = _trainer(world, "FairGo_PMF", False, torch.device("cpu"))
    model, batch = trainer.model, world.batch()
    with torch.no_grad():
        before = model.calculate_dis_loss(dict(batch), SUBSETS[0])
        model.filters["age"].linear[0].w.add_(0.25)
        after = model.calculate_dis_loss(dict(batch), SUBSETS[0])
    plain = model.calculate_dis_loss(dict(batch), SUBSETS[0]).detach()
    assert torch.equal(after, plain) and not torch.equal(before, after)
    assert _counts() == (0, 2)


def test_a_loss_that_differentiates_the_filters_gets_their_gradients(world):
    trainer = _trainer(world, "FairGo_PMF", False, torch.device("cpu"))
    model, batch = trainer.model, world.batch()
    _dis(trainer, world)  # an entry is kept
    model.zero_grad(set_to_none=True)
    model.calculate_dis_loss(dict(batch), SUBSETS[0]).backward()
    assert _counts() == (0, 1)  # the direct call neither read nor counted
    for sst in SUBSETS[0]:
        grads = [p.grad for p in model.filters[sst].parameters()]
        assert all(g is not None and bool(g.abs().sum() > 0) for g in grads), sst
    assert model.user_embedding.weight.grad is not None


def test_the_filter_step_neither_reads_nor_fills_the_entry(world):
    trainer = _trainer(world, "FairGo_PMF", False, torch.device("cpu"))
    model = trainer.model
    _dis(trainer, world)
    kept = model.__dict__["_hop_cache"]
    _step(trainer, _batch(world, trainer.device), "filter", SUBSETS[0])
    assert model.__dict__["_hop_cache"] is kept and _counts() == (0, 1)
    assert _dis(trainer, world) == (0, 1)  # the filters moved


def test_grad_mode_off_takes_the_kept_hops(world):
    model = _trainer(world, "FairGo_PMF", True, torch.device("cpu")).model
    batch = world.batch()
    with torch.no_grad():
        first = model.calculate_dis_loss(dict(batch), SUBSETS[1])
        second = model.calculate_dis_loss(dict(batch), SUBSETS[1])
    assert torch.equal(first, second) and _counts() == (1, 1)


@pytest.mark.parametrize("kind", ["filter", "dis"])
def test_the_step_gives_each_parameter_its_own_flag_back(world, kind):
    trainer = _trainer(world, "FairGo_PMF", False, torch.device("cpu"))
    model = trainer.model
    model.item_embedding.weight.requires_grad_(False)  # a frozen key
    flags = {n: p.requires_grad for n, p in model.named_parameters()}
    _step(trainer, _batch(world, trainer.device), kind, SUBSETS[0])
    assert {n: p.requires_grad for n, p in model.named_parameters()} == flags
    broken = _batch(world, trainer.device)
    del broken["gender"]
    with pytest.raises(KeyError):
        _step(trainer, broken, kind, SUBSETS[0])
    assert {n: p.requires_grad for n, p in model.named_parameters()} == flags
