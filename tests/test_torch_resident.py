"""Resident epochs (``device_epoch_shuffle``) in the port on the CPU: against
the JAX package's resident epoch, against the port's own per-step path, and
with the port's own draws.

Random streams cannot match draw for draw (threefry against torch), so the
parity tests replay the JAX package's key chain for an epoch with its own
functions — ``rng → (rng, perm_rng)``, the permutation of the padded table,
then per step ``split → (loss_rng, neg_rng)`` and the vmapped
``sample_negatives`` — and inject that permutation and those negatives into
the port's resident epoch (its test seam). Weights and BatchNorm state are
carried over with ``load_jax_params``.

Tolerances (float32; both sides take weighted means over the same padded
batches and sum in different orders): BPR-MF with Adam — epoch loss rel
1e-6, parameters abs 1e-6 after 1 epoch and 1e-5 after 3; PFCN_PMF ``sm``
with SGD (Adam turns the float32 noise in a pre-BatchNorm bias into steps
of up to 3.16 lr, see ``test_torch_adversarial_training.py``) — filter and
discriminator pass losses rel 1e-5, parameters and BatchNorm statistics abs
1e-5 after 1 and 3 epochs. Resident against the port's per-step path on the
real rows of the same batches: losses rel 1e-6, parameters abs 1e-6 (only
the reduction order of the weighted and the plain mean differ).
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from recbole_fairrec_tpu.ops.neg_sampling import sample_negatives as jax_sample_negatives

from recbole_fairrec_tpu_torch.utils.jax_params import _flatten, to_jax_params
from test_torch_adversarial_training import Env as AdvEnv
from test_torch_adversarial_training import assert_close_to_jax
from test_torch_training import _assert_params_close, _cfg, _Env, _np_tree
from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)

RESIDENT = {"device_neg_sampling": True, "device_epoch_shuffle": True}
PFCN_SGD = {"learner": "sgd", "learning_rate": 0.05, **RESIDENT}
SUBSETS = [("gender", "age"), ("gender",), ("age",)]


def _switch_loaders(env, config_objects):
    """Rebind the train loaders to the configs' current sampling mode."""
    for loaders, config in zip((env.jax_loaders, env.loaders), config_objects):
        loaders[0].update_config(config)


@pytest.fixture(scope="module")
def bpr_env(tmp_path_factory):
    from conftest import make_tiny_dataset

    root = tmp_path_factory.mktemp("resident")
    env = _Env(_cfg(make_tiny_dataset(str(root)), str(root / "saved"), "tiny"), "tiny")
    env._set(RESIDENT)
    _switch_loaders(env, (env.jax_config, env.config))
    return env


@pytest.fixture(scope="module")
def pfcn_env(tmp_path_factory):
    env = AdvEnv(str(tmp_path_factory.mktemp("residentadv")), "PFCN_PMF", "sm",
                 ["gender", "age"])
    env.set(**PFCN_SGD)
    _switch_loaders(env, (env.jax_config, env.config))
    return env


def jax_epoch_draws(jt, train_data, loss_name, sst_list):
    """The permutation ([n_pad]) and negatives ([n_steps · batch], or None
    for a pass that draws none) that ``jt``'s next resident epoch draws,
    from its current key, with the JAX package's own functions."""
    jt._maybe_enable_device_sampling(train_data)
    model = jt.model
    fields = set(model.loss_batch_fields(loss_name, sst_list))
    fields -= {model.NEG_ITEM_ID, "__weight__"}
    tables, n_steps, batch, n_pad = jt._resident_tables(train_data, fields)
    rng, perm_rng = jax.random.split(jt.rng)
    perm = jax.random.permutation(perm_rng, n_pad)
    if loss_name != "calculate_loss":
        return np.array(perm), None

    def split_body(k, _):
        k, s = jax.random.split(k)
        return k, s

    _, step_keys = jax.lax.scan(split_body, rng, None, length=n_steps)
    neg_keys = jax.vmap(jax.random.split)(step_keys)[:, 1]
    users = tables[model.USER_ID][perm.reshape(n_steps, batch)]
    negs = jax.vmap(lambda k, u: jax_sample_negatives(
        k, u, jt._device_used_keys, model.n_items, num_neg=1))(neg_keys, users)
    return np.array(perm), np.array(negs).reshape(-1)


def _both_epochs(jt, pt, env, loss_name, sst, tag):
    """One resident pass on each side, the port's on the JAX draws; returns
    (jax loss, port loss)."""
    perm, negs = jax_epoch_draws(jt, env.jax_loaders[0], loss_name, sst)
    ref = jt._run_epoch_resident(env.jax_loaders[0], loss_name, sst, tag)
    ours = pt._run_epoch_resident(env.loaders[0], loss_name, sst, tag, perm=perm,
                                  negatives=negs)
    return ref, ours


@pytest.mark.parametrize("epochs,atol", [(1, 1e-6), (3, 1e-5)])
def test_bpr_resident_epochs_match_jax(bpr_env, epochs, atol):
    jt, pt = bpr_env.pair(**RESIDENT)
    for _ in range(epochs):
        ref, ours = _both_epochs(jt, pt, bpr_env, "calculate_loss", None, "main")
        assert ours == pytest.approx(ref, rel=1e-6)
    _assert_params_close(jt.params, to_jax_params(pt.model), atol=atol)


@pytest.mark.parametrize("epochs", [1, 3])
def test_pfcn_resident_filter_and_dis_epochs_match_jax(pfcn_env, epochs):
    """Each epoch a filter pass (BPR − dis_weight · discriminators, negatives
    drawn) and a discriminator pass (no negatives) over one subset."""
    jt, pt = pfcn_env.pair(**PFCN_SGD)
    for sst in SUBSETS[:epochs]:
        for loss_name, tag in (("calculate_loss", "filter"), ("calculate_dis_loss", "dis")):
            ref, ours = _both_epochs(jt, pt, pfcn_env, loss_name, sst, tag)
            assert ours == pytest.approx(ref, rel=1e-5), (sst, tag)
    assert_close_to_jax(jt, pt, 1e-5)


def _capture_steps(trainer):
    """Record every batch the trainer's steps receive (device tensors)."""
    seen = []
    step = trainer._train_step

    def run(batch, loss_name, sst_list, optimizer):
        seen.append({k: v.clone() for k, v in batch.items()})
        return step(batch, loss_name, sst_list, optimizer)

    trainer._train_step = run
    return seen


@pytest.mark.parametrize("case", ["bpr", "pfcn"])
def test_resident_equals_the_per_step_path(bpr_env, pfcn_env, case):
    """The same permutation and negatives through the resident epoch and
    through the per-step loop over the real rows of each batch: pad rows
    carry weight 0, so the two take the same steps."""
    env = bpr_env if case == "bpr" else pfcn_env
    overrides = RESIDENT if case == "bpr" else PFCN_SGD
    passes = [("calculate_loss", None, "main")] if case == "bpr" else [
        ("calculate_loss", SUBSETS[0], "filter"), ("calculate_dis_loss", SUBSETS[0], "dis")]
    jt, resident = env.pair(**overrides)
    per_step = env.port_trainer(_np_tree(jt.params), **overrides) if case == "bpr" \
        else env.port_trainer(**overrides)
    loader = env.loaders[0]
    rng = np.random.RandomState(4)
    for loss_name, sst, tag in passes:
        n_pad = -(-len(loader.dataset) // loader.batch_size) * loader.batch_size
        perm = rng.permutation(n_pad)
        negs = rng.randint(1, loader.dataset.item_num, n_pad)
        ours = resident._run_epoch_resident(loader, loss_name, sst, tag, perm=perm,
                                            negatives=negs)
        fields = set(per_step.model.loss_batch_fields(loss_name, sst))
        fields -= {per_step.model.NEG_ITEM_ID, "__weight__"}
        batches = chip_smoke._real_row_batches(loader, fields, perm, negs)
        ref = per_step._run_epoch(batches, loss_name, sst, tag)
        assert ours == pytest.approx(ref, rel=1e-6), tag
    mine = _flatten(to_jax_params(resident.model))
    for name, value in _flatten(to_jax_params(per_step.model)).items():
        np.testing.assert_allclose(mine[name], value, rtol=0, atol=1e-6, err_msg=name)


def test_own_draws_cover_every_row_once(bpr_env):
    """With the trainer's own generator: every batch has ``batch`` rows,
    every real row is in exactly one of them with weight 1, the pad rows
    carry weight 0, and every negative of a real row is an unused pair."""
    jt, pt = bpr_env.pair(**RESIDENT)
    loader = bpr_env.loaders[0]
    seen = _capture_steps(pt)
    loss = pt._run_epoch(loader, "calculate_loss", None, "main")
    assert np.isfinite(loss)
    ds = loader.dataset
    n, batch = len(ds), loader.batch_size
    assert len(seen) == -(-n // batch)
    users = torch.cat([b["user_id"] for b in seen])
    items = torch.cat([b["item_id"] for b in seen])
    negs = torch.cat([b["neg_item_id"] for b in seen])
    weight = torch.cat([b["__weight__"] for b in seen])
    assert all(len(b["user_id"]) == batch for b in seen)
    real = weight == 1.0
    assert int(real.sum()) == n and int((weight == 0.0).sum()) == len(seen) * batch - n
    pairs = sorted(zip(users[real].tolist(), items[real].tolist()))
    taken = sorted(zip(np.asarray(ds.inter_feat[ds.uid_field]).tolist(),
                       np.asarray(ds.inter_feat[ds.iid_field]).tolist()))
    assert pairs == taken
    assert int(users[~real].abs().sum()) == 0 and int(items[~real].abs().sum()) == 0
    used = set(taken)
    assert not any(p in used for p in zip(users[real].tolist(), negs[real].tolist()))
    assert int(negs.min()) >= 1 and int(negs.max()) < ds.item_num
    # the loader was not iterated, so its in-place shuffle did not run
    assert torch.equal(ds.inter_feat[ds.uid_field], bpr_env._order[1][ds.uid_field])


def test_resident_fit_is_repeatable_and_learns(bpr_env):
    """Two trainers with the same seed give the same losses; the loss falls
    over 4 epochs; the table is built once."""
    runs = []
    for _ in range(2):
        jt, pt = bpr_env.pair(epochs=4, learning_rate=0.05, **RESIDENT)
        pt.fit(bpr_env.loaders[0], None, saved=False, verbose=False)
        runs.append([pt.train_loss_dict[e] for e in range(4)])
        tables, _, _ = pt._resident_cache
        fields = set(pt.model.loss_batch_fields("calculate_loss")) - {"neg_item_id"}
        assert set(tables) == fields and "__weight__" in tables
    assert runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0]


def test_eligibility_follows_jax(bpr_env):
    """On only with the option, a loader in device_neg_sampling mode and a
    model with negatives and declared fields; the JAX trainer agrees."""
    jt, pt = bpr_env.pair(**RESIDENT)
    loader = bpr_env.loaders[0]
    assert pt._resident_epoch_ok(loader, "calculate_loss", None)
    assert jt._resident_epoch_ok(bpr_env.jax_loaders[0], "calculate_loss", None, "main")

    class HostLoader:
        device_neg_sampling = False

    assert not pt._resident_epoch_ok(HostLoader(), "calculate_loss", None)
    pt.model.loss_batch_fields = lambda loss_name, sst_list=None: None
    assert not pt._resident_epoch_ok(loader, "calculate_loss", None)
    del pt.model.loss_batch_fields
    bpr_env.config["device_epoch_shuffle"] = False
    try:
        assert not pt._resident_epoch_ok(loader, "calculate_loss", None)
    finally:
        bpr_env.config["device_epoch_shuffle"] = True


def test_pointwise_models_keep_the_loader_loop(tmp_path):
    """FOCF's loader is pointwise (never in device_neg_sampling mode): with
    the option on it still trains through the loader, as in JAX."""
    from recbole_fairrec_tpu_torch import run_recbole

    root = chip_smoke.write_dataset(str(tmp_path / "data"), n_users=40, n_items=60,
                                    n_inter=800, name=chip_smoke.ADV_DATASET, attributes=True)
    cfg = chip_smoke.published_config(root, str(tmp_path / "work"), "FOCF", {
        "fair_objective": "value", "epochs": 1, "use_gpu": False,
        "device_epoch_shuffle": True, "device_neg_sampling": True})
    from recbole_fairrec_tpu_torch.trainer import Trainer

    calls = []
    resident = Trainer._run_epoch_resident
    Trainer._run_epoch_resident = lambda self, *a, **k: calls.append(1) or resident(self, *a, **k)
    try:
        result = run_recbole(model="FOCF", dataset=chip_smoke.ADV_DATASET, config_dict=cfg)
    finally:
        Trainer._run_epoch_resident = resident
    assert calls == [] and result["test_result"]
