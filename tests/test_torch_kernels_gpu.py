"""The port's CUDA kernels against their plain versions, and the training
step's device code (negative sampling, one optimizer step) against the CPU,
on the card.

Every test here is marked ``gpu`` and skips where no CUDA device is
present. The file imports neither JAX nor the JAX package, so on a machine
with a card and without JAX it runs with the repository's conftest left out:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from recbole_fairrec_tpu_torch import Config
from recbole_fairrec_tpu_torch.models.pfcn_pmf import PFCN_PMF
from recbole_fairrec_tpu_torch.ops import fused_topk, neg_sampling
from recbole_fairrec_tpu_torch.trainer import PFCN_PMFTrainer


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _check_slot_for_slot(U, T, k):
    before = fused_topk.launches
    s, i = fused_topk.fused_topk_scores(U, T, k)
    torch.cuda.synchronize()
    assert fused_topk.launches == before + 1
    s_ref, i_ref = fused_topk.fused_topk_scores_reference(U, T, k)
    assert torch.equal(i, i_ref)
    assert torch.equal(s, s_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("B,I,d,k", [
    (6144, 3630, 64, 173),   # the serving shape at ml-1M scale
    (300, 5000, 32, 4096),   # the largest k'
    (77, 1001, 30, 50),      # d not a multiple of 4: scalar copies and reads
    (5, 9, 8, 12),           # k' beyond the catalogue: (-inf, 0) slots
    (6144, 3630, 64, 1),     # k' = 1: products with almost no selection
    (1024, 3630, 64, 2048),  # real ml-1M's k': every chunk's list is the whole chunk
    (1000, 3630, 64, 173),   # B not a multiple of the 64 users of a block
    (2000, 3001, 64, 300),   # I not a multiple of the chunk: a short last chunk
    (64, 50000, 8, 4096),    # lists too long for shared memory: the merge reads them in place
    (6144, 6176, 64, 480),   # the keys would fill the opt-in limit but for the static bytes
])
def test_fused_topk_matches_plain(card, B, I, d, k):
    """Integer inputs make every score exact, so the kernel must agree with
    the plain version slot for slot, ties included."""
    gen = torch.Generator().manual_seed(0)
    U = torch.randint(-2, 3, (B, d), generator=gen).float().to(card)
    T = torch.randint(-2, 3, (I, d), generator=gen).float().to(card)
    _check_slot_for_slot(U, T, k)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [7, 173])
def test_fused_topk_zero_scores_tie_by_index(card, k):
    """Many scores are exactly 0, from zero user rows and from products that
    cancel (+0.0 and -0.0 alike): the order key must treat them as one value
    and rank them by item index."""
    gen = torch.Generator().manual_seed(1)
    B, I, d = 700, 3630, 64
    U = torch.randint(-1, 2, (B, d), generator=gen).float()
    U[::3] = 0.0   # every score of these rows is 0
    U[1::3] = -U[1::3].abs()
    T = torch.randint(-1, 2, (I, d), generator=gen).float()
    T[::2, d // 2:] = -T[::2, : d // 2]  # u . t cancels for users constant over the halves
    U[2::3, d // 2:] = U[2::3, : d // 2]
    U, T = U.to(card), T.to(card)
    scores = U @ T.T
    assert int((scores == 0).sum()) > B * I // 3  # the case is tie-heavy at 0
    _check_slot_for_slot(U, T, k)


@pytest.mark.gpu
def test_fused_topk_rejects_non_float32_on_card(card):
    U = torch.zeros(4, 8, device=card, dtype=torch.float64)
    T = torch.zeros(10, 8, device=card, dtype=torch.float64)
    with pytest.raises(TypeError):
        fused_topk.fused_topk_scores(U, T, 3)


# ------------------------------------------------- negative sampling, on card

N_USERS, N_ITEMS = 500, 3630


def _used_pairs(seed=3, n=60_000):
    r = np.random.RandomState(seed)
    keys = np.unique(r.randint(1, N_USERS, n).astype(np.int64) * N_ITEMS
                     + r.randint(1, N_ITEMS, n))
    return keys // N_ITEMS, keys % N_ITEMS, keys


def _used_table(kind, u, i, device):
    if kind == "bitmap":
        return neg_sampling.build_used_bitmap(u, i, N_USERS, N_ITEMS, device=device)
    return neg_sampling.build_used_keys(u, i, N_ITEMS, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bitmap", "keys"])
@pytest.mark.parametrize("num_neg", [1, 3])
def test_sample_negatives_on_card(card, kind, num_neg):
    u, i, keys = _used_pairs()
    used = _used_table(kind, u, i, card)
    users = torch.from_numpy(np.random.RandomState(5).randint(1, N_USERS, 2048)).to(card)
    gen = torch.Generator(device=card).manual_seed(7)
    out = neg_sampling.sample_negatives(gen, users, used, N_ITEMS, num_neg=num_neg)
    assert out.device.type == "cuda" and out.shape == (2048 * num_neg,)
    assert int(out.min()) >= 1 and int(out.max()) < N_ITEMS
    drawn = users.repeat(num_neg).cpu().numpy() * N_ITEMS + out.cpu().numpy()
    assert not np.isin(drawn, keys).any()
    again = neg_sampling.sample_negatives(
        torch.Generator(device=card).manual_seed(7), users, used, N_ITEMS, num_neg=num_neg)
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_sample_negatives_refuses_a_cpu_generator_on_card(card):
    u, i, _ = _used_pairs()
    used = _used_table("bitmap", u, i, card)
    users = torch.ones(16, dtype=torch.int64, device=card)
    with pytest.raises(RuntimeError):
        neg_sampling.sample_negatives(torch.Generator().manual_seed(0), users, used, N_ITEMS)


# ------------------------------------------------------ one train step, on card


class _Sizes:
    """The two numbers a PFCN_PMF reads from its dataset."""

    def num(self, field):
        return {"user_id": N_USERS, "item_id": N_ITEMS}[field]


def _trainer(tmp_path, use_gpu, learner, state):
    config = Config(model="PFCN_PMF", dataset="none", config_dict={
        "use_gpu": use_gpu, "filter_mode": "none", "sst_attr_list": [], "embedding_size": 64,
        "learner": learner, "weight_decay": 0.01, "clip_grad_norm": {"max_norm": 0.5},
        "learning_rate": 0.01, "metrics": ["NDCG"], "topk": [10], "valid_metric": "NDCG@10",
        "checkpoint_dir": str(tmp_path / "saved"), "state": "ERROR",
    })
    model = PFCN_PMF(config, _Sizes())
    model.load_state_dict(state)
    return PFCN_PMFTrainer(config, model)


@pytest.mark.gpu
@pytest.mark.parametrize("learner", ["adam", "sgd", "adagrad", "rmsprop", "sparse_adam"])
def test_train_steps_on_card_match_cpu(card, tmp_path, learner, monkeypatch):
    """Two steps from the same weights, batches and negatives: parameters
    within 1e-5 (abs) and losses within 1e-6 (rel) of the CPU's."""
    monkeypatch.chdir(tmp_path)  # the scalar log lands beside the test's files
    gen = torch.Generator().manual_seed(0)
    state = {"user_embedding.weight": torch.randn(N_USERS, 64, generator=gen) * 0.3,
             "item_embedding.weight": torch.randn(N_ITEMS, 64, generator=gen) * 0.3}
    on_card = _trainer(tmp_path, True, learner, state)
    on_cpu = _trainer(tmp_path, False, learner, state)
    assert on_card.device.type == "cuda" and on_cpu.device.type == "cpu"
    for _ in range(2):
        batch = {
            "user_id": torch.randint(1, N_USERS, (2048,), generator=gen),
            "item_id": torch.randint(1, N_ITEMS, (2048,), generator=gen),
            "neg_item_id": torch.randint(1, N_ITEMS, (2048,), generator=gen),
        }
        losses = []
        for trainer in (on_card, on_cpu):
            trainer.model.train()
            moved = {k: v.to(trainer.device) for k, v in batch.items()}
            losses.append(float(trainer._train_step(moved, "calculate_loss", None,
                                                    trainer.optimizer)))
        assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    for p, q in zip(on_card.model.parameters(), on_cpu.model.parameters()):
        assert float((p.detach().cpu() - q.detach()).abs().max()) <= 1e-5


# ------------------------------------------- the adversarial PFCN path, on card


class _AttrSizes(_Sizes):
    """Sizes plus a user table with a binary ``gender`` and a seven-valued
    ``age`` (row 0 is PAD)."""

    def get_user_feature(self):
        users = np.arange(N_USERS)
        return {"gender": users % 2, "age": users % 7}


def _adv_config(tmp_path, use_gpu, model, mode, attrs):
    return Config(model=model, dataset="none", config_dict={
        "use_gpu": use_gpu, "filter_mode": mode, "sst_attr_list": attrs, "embedding_size": 64,
        "dis_hidden_size_list": [128, 256, 128, 128, 64, 32], "dis_dropout": 0.0,
        "mlp_dropout": 0.0, "learner": "adam", "learning_rate": 0.001, "weight_decay": 1e-4,
        "metrics": ["NDCG"], "topk": [10], "valid_metric": "NDCG@10",
        "checkpoint_dir": str(tmp_path / "saved"), "state": "ERROR",
    })


def _pre_bn_bias(name):
    parts = name.split(".")
    return parts[0] in ("filters", "discriminators") and parts[-3:-2] == ["linear"] \
        and parts[-1] == "b"


@pytest.mark.gpu
@pytest.mark.parametrize("loss_name,tag", [("calculate_loss", "filter"),
                                           ("calculate_dis_loss", "dis")])
def test_adversarial_steps_on_card_match_cpu(card, tmp_path, loss_name, tag, monkeypatch):
    """PFCN_PMF, sm over gender and age, full widths: one filter step and
    one dis step from the same weights and batch. Losses within 1e-6 (rel);
    parameters and BatchNorm running statistics within 1e-5 (abs). A bias
    that feeds a BatchNorm has a zero gradient, whose float32 noise Adam
    turns into a step of up to (1 - b1) / sqrt(1 - b2) = 3.16 lr of either
    sign: within twice that + 1e-5."""
    monkeypatch.chdir(tmp_path)
    from recbole_fairrec_tpu_torch.models.pfcn_pmf import PFCN_PMF
    from recbole_fairrec_tpu_torch.trainer import PFCN_PMFTrainer as Cls

    attrs = ["gender", "age"]
    state = PFCN_PMF(_adv_config(tmp_path, False, "PFCN_PMF", "sm", attrs), _AttrSizes(),
                     generator=torch.Generator().manual_seed(0)).state_dict()
    trainers = []
    for use_gpu in (True, False):
        config = _adv_config(tmp_path, use_gpu, "PFCN_PMF", "sm", attrs)
        model = PFCN_PMF(config, _AttrSizes())
        model.load_state_dict(state)
        trainers.append(Cls(config, model))
    gen = torch.Generator().manual_seed(1)
    users = torch.randint(1, N_USERS, (2048,), generator=gen)
    batch = {"user_id": users, "item_id": torch.randint(1, N_ITEMS, (2048,), generator=gen),
             "neg_item_id": torch.randint(1, N_ITEMS, (2048,), generator=gen),
             "gender": users % 2, "age": users % 7}
    losses = []
    for trainer in trainers:
        trainer.model.train()
        moved = {k: v.to(trainer.device) for k, v in batch.items()}
        losses.append(float(trainer._train_step(moved, loss_name, tuple(attrs),
                                                trainer._tx_by_tag(tag))))
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    cpu_state = trainers[1].model.state_dict()
    for name, value in trainers[0].model.state_dict().items():
        limit = 2 * 3.1623 * 0.001 + 1e-5 if _pre_bn_bias(name) else 1e-5
        assert float((value.cpu() - cpu_state[name]).abs().max()) <= limit, name


def _near_tie_equal(U, T, k):
    """The kernel against its plain version on float inputs: scores within
    rtol 1e-5 plus twice the float32 bound of a length-d dot product in any
    order; indices equal except where the plain version's neighbours lie
    within that bound of each other."""
    before = fused_topk.launches
    s, i = fused_topk.fused_topk_scores(U, T, k)
    torch.cuda.synchronize()
    assert fused_topk.launches == before + 1
    s_ref, i_ref = fused_topk.fused_topk_scores_reference(U, T, k)
    tol = 2 * U.shape[1] * 2.0 ** -24 * torch.gather(U.abs() @ T.abs().T, 1, i_ref.long())
    assert bool(((s - s_ref).abs() <= 1e-5 * s_ref.abs() + tol).all())
    gap = (s_ref[:, 1:] - s_ref[:, :-1]).abs() <= torch.maximum(1e-6 * s_ref[:, 1:].abs(),
                                                                tol[:, 1:])
    near = torch.zeros_like(gap[:, :1]).expand(-1, k).clone()
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert not bool(((i != i_ref) & ~near).any())


@pytest.mark.gpu
@pytest.mark.parametrize("model_name,mode,attrs,width", [
    ("PFCN_PMF", "sm", ["gender", "age"], 64),   # filtered user representations
    ("PFCN_BiasedMF", "cm", ["gender"], 65),     # user ++ [1] . item ++ [b_i]: d 65
    ("PFCN_DMF", "sm", ["gender"], 64),          # unit vectors
])
def test_fused_topk_on_filtered_retrieval_inputs(card, tmp_path, model_name, mode, attrs, width,
                                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    from recbole_fairrec_tpu_torch.utils import get_model

    config = _adv_config(tmp_path, True, model_name, mode, attrs)
    model = get_model(model_name)(config, _AttrSizes()).to(card).eval()
    users = torch.arange(1, N_USERS, device=card)
    with torch.no_grad():
        U, T = model.retrieval_embeddings({"user_id": users}, tuple(attrs))
    U, T = U.contiguous(), T.contiguous()
    assert U.shape == (N_USERS - 1, width) and T.shape == (N_ITEMS, width)
    if model_name == "PFCN_DMF":
        torch.testing.assert_close(U.norm(dim=1), torch.ones(N_USERS - 1, device=card))
    _near_tie_equal(U, T, 173)


# ---------------------------------- the published evaluation protocol, on card


def _write_fair_dataset(root, n_users=120, n_items=300, seed=4):
    """Every user rates 10-30 random items with ratings 1-5; ``gender`` =
    u mod 2, ``age`` = u mod 3."""
    ddir = root / "fair"
    ddir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    with open(ddir / "fair.inter", "w") as f:
        f.write("user_id:token\titem_id:token\trating:float\n")
        for u in range(1, n_users + 1):
            for i in rng.choice(np.arange(1, n_items + 1), rng.randint(10, 31), replace=False):
                f.write(f"{u}\t{i}\t{rng.randint(1, 6)}\n")
    with open(ddir / "fair.user", "w") as f:
        f.write("user_id:token\tgender:float\tage:float\n")
        for u in range(1, n_users + 1):
            f.write(f"{u}\t{u % 2}\t{u % 3}\n")
    return str(root)


def _published(tmp_path, use_gpu, model, extra=None):
    return Config(model=model, dataset="fair", config_dict={
        "use_gpu": use_gpu, "data_path": _write_fair_dataset(tmp_path / "data"),
        "load_col": {"inter": ["user_id", "item_id", "rating"],
                     "user": ["user_id", "gender", "age"]},
        "LABEL_FIELD": "label", "threshold": {"rating": 3.0},
        "checkpoint_dir": str(tmp_path / "saved"), "state": "ERROR", "dropout": 0.0,
        **(extra or {}),
    })


@pytest.mark.gpu
@pytest.mark.parametrize("mode,attrs", [("none", []), ("sm", ["gender", "age"])])
def test_sampled_device_path_equals_host_path_on_card(card, tmp_path, mode, attrs,
                                                      monkeypatch):
    """PFCN_PMF with its published uni100 protocol (12 metrics, top 5): on
    one list of uni100 batches, the device path (scatter + sort on the card)
    and the host path (``predict`` on the card, ranking in numpy) give one
    dict per subset."""
    monkeypatch.chdir(tmp_path)
    from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
    from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed

    config = _published(tmp_path, True, "PFCN_PMF", {
        "filter_mode": mode, "sst_attr_list": attrs or ["gender"], "dis_dropout": 0.0})
    generator = init_seed(config["seed"], True)
    train, valid, _ = data_preparation(config, create_dataset(config))
    model = get_model("PFCN_PMF")(config, train.dataset, generator=generator)
    with torch.no_grad():  # scores where float32 sigmoid keeps them apart
        for emb in (model.user_embedding, model.item_embedding):
            emb.weight.mul_(0.3)
    trainer = get_trainer(config["MODEL_TYPE"], "PFCN_PMF")(config, model)
    assert trainer.device.type == "cuda"
    trainer.eval_collector.data_collect(train)
    kind = trainer._prepare_eval(valid)
    np.random.seed(9)
    batches = list(trainer._macro_batches(valid, kind))
    trainer.model.eval()
    for sst in [tuple(attrs)] if attrs else [None]:
        results = []
        with torch.no_grad():
            for path in ("device", "host"):
                for batch in batches:
                    if path == "device":
                        trainer._collect_batch(kind, batch, sst)
                        assert trainer._last_eval_path == "sampled-fused"
                    else:
                        _, scores, pu, pi = trainer._neg_sample_batch_eval(batch, sst)
                        trainer.eval_collector.eval_batch_collect(scores, batch[0], pu, pi)
                results.append(trainer.evaluator.evaluate(trainer.eval_collector.get_data_struct()))
        assert results[0] == results[1]
        assert len(results[0]) >= 12


@pytest.mark.gpu
@pytest.mark.parametrize("model_name,extra", [
    ("FOCF", {"fair_objective": "value"}),
    ("FOCF", {"fair_objective": "nonparity"}),
    ("NFCF", {}),
])
def test_fair_model_losses_on_card_match_cpu(card, tmp_path, model_name, extra, monkeypatch):
    """FOCF's rating loss + fairness term and NFCF's BCE + ε-DF penalty on
    one train batch, the same weights on the card and on the CPU: losses
    within 1e-6 (rel), gradients within 1e-6 (abs), the float32 error of
    summing in another order."""
    monkeypatch.chdir(tmp_path)
    from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
    from recbole_fairrec_tpu_torch.utils import get_model, init_seed

    losses, grads = [], []
    for use_gpu in (True, False):
        config = _published(tmp_path, use_gpu, model_name, extra)
        init_seed(config["seed"], True)
        train = data_preparation(config, create_dataset(config))[0]
        model = get_model(model_name)(config, train.dataset,
                                      generator=torch.Generator().manual_seed(0))
        model = model.to(config["device"]).train()
        np.random.seed(3)
        batch = next(iter(train))
        fields = model.loss_batch_fields("calculate_loss")
        moved = {k: v.to(config["device"]) for k, v in batch.interaction.items() if k in fields}
        loss = model.calculate_loss(moved)
        if model_name == "NFCF":  # the finetune stage's penalty, on the same rows
            out = model.forward(moved["user_id"], moved["item_id"], train=True)
            loss = loss + model._differential_fairness(moved, out, torch.ones_like(out))
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    for name, g in grads[1].items():
        assert float((grads[0][name] - g).abs().max()) <= 1e-6, name
