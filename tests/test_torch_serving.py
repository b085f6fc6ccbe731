"""The serving slice as a whole: full-sort evaluation of BPR-MF (PFCN_PMF,
``filter_mode: none``, ``embedding_size: 64``) in the port against the JAX
package's ``Trainer.evaluate``: the base ``Trainer`` (as ``bench.py`` builds
it) and the ``PFCNTrainer`` that both registries give PFCN_PMF, whose
``evaluate`` loads the best checkpoint by default and returns the result
nested under ``"none"``.

Both sides read the same data; the port runs on the CPU (``use_gpu: False``)
with the JAX parameters carried over by ``load_jax_params`` or read from a
checkpoint the JAX trainer wrote. The metric dicts must be identical, on the
dense path (``streaming_eval: False``) and on the streaming path (``True``).

The streaming path ranks raw dot products and the dense path ranks
sigmoid(dot); in float32 sigmoid merges scores that differ by less than its
resolution (and saturates at 1.0 for the N(0, 1) init tables), so the two
paths agree exactly only where that cannot happen. ``_exact_weights`` makes
such tables, as ``chip_smoke.py`` does, and there streaming must equal dense
in both packages.
"""

import os

import jax
import numpy as np
import pytest

from recbole_fairrec_tpu.config import Config as JaxConfig
from recbole_fairrec_tpu.data import create_dataset as jax_create_dataset
from recbole_fairrec_tpu.data import data_preparation as jax_data_preparation
from recbole_fairrec_tpu.trainer import Trainer as JaxTrainer
from recbole_fairrec_tpu.utils import get_model as jax_get_model
from recbole_fairrec_tpu.utils import get_trainer as jax_get_trainer
from recbole_fairrec_tpu.utils import init_seed as jax_init_seed

from recbole_fairrec_tpu_torch import Config, load_data_and_model
from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
from recbole_fairrec_tpu_torch.ops import fused_topk
from recbole_fairrec_tpu_torch.trainer import PFCN_PMFTrainer, Trainer
from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed
from recbole_fairrec_tpu_torch.utils.jax_params import load_jax_params
from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)

METRICS = ["NDCG", "Recall", "Hit", "MRR", "GiniIndex", "PopularityPercentage"]


def _cfg(data_path, ckpt_dir, dataset):
    cfg = {
        "data_path": data_path,
        "load_col": {"inter": ["user_id", "item_id", "rating"], "user": ["user_id", "gender"]},
        "filter_mode": "none",
        "embedding_size": 64,
        "eval_args": {"split": {"RS": [8, 1, 1]}, "order": "RO",
                      "group_by": "user", "mode": "full"},
        "metrics": METRICS,
        "topk": [10],
        "valid_metric": "NDCG@10",
        "show_progress": False,
        "state": "ERROR",
        "checkpoint_dir": ckpt_dir,
    }
    if dataset == "tiny":
        cfg["threshold"] = {"rating": 3.0}
    return cfg


class _Side:
    def __init__(self, config, trainer, loaders):
        self.config, self.trainer, self.loaders = config, trainer, loaders

    def evaluate(self, split, streaming):
        self.config["streaming_eval"] = streaming
        return dict(self.trainer.evaluate(self.loaders[split]))

    def registry_trainer(self, get_trainer_fn):
        """The trainer the package's registry gives PFCN_PMF (a
        ``PFCNTrainer``), over this side's model and loaders."""
        trainer = get_trainer_fn(self.config["MODEL_TYPE"], "PFCN_PMF")(
            self.config, self.trainer.model)
        trainer.eval_collector.data_collect(self.loaders[0])
        return trainer


def _build_jax(cfg, dataset):
    config = JaxConfig(model="PFCN_PMF", dataset=dataset, config_dict=cfg)
    jax_init_seed(config["seed"], config["reproducibility"])
    ds = jax_create_dataset(config)
    loaders = jax_data_preparation(config, ds)
    model = jax_get_model("PFCN_PMF")(config, loaders[0].dataset)
    trainer = JaxTrainer(config, model)  # base Trainer, as bench.py builds it
    trainer.eval_collector.data_collect(loaders[0])
    return _Side(config, trainer, loaders)


def _build_torch(cfg, dataset, params):
    config = Config(model="PFCN_PMF", dataset=dataset, config_dict={**cfg, "use_gpu": False})
    generator = init_seed(config["seed"], config["reproducibility"])
    ds = create_dataset(config)
    loaders = data_preparation(config, ds)
    model = get_model("PFCN_PMF")(config, loaders[0].dataset, generator=generator)
    load_jax_params(model, params)
    trainer = Trainer(config, model)  # the base Trainer on this side too
    trainer.eval_collector.data_collect(loaders[0])
    return _Side(config, trainer, loaders)


def _jax_params(side):
    return jax.tree_util.tree_map(np.asarray, side.trainer.params)


def _exact_weights(shapes, seed=0, std=0.3, quantum=1.0 / 64):
    """N(0, std^2) tables rounded to multiples of ``quantum``: every score is
    exact in float32 and distinct scores stay distinct through sigmoid."""
    rng = np.random.RandomState(seed)
    return {name: (np.round(rng.randn(*shape) * std / quantum) * quantum).astype(np.float32)
            for name, shape in shapes.items()}


@pytest.fixture(scope="module", params=["tiny", "ml-100k"])
def sides(request, tmp_path_factory):
    from conftest import REPO_ROOT, make_tiny_dataset

    root = tmp_path_factory.mktemp(request.param.replace("-", ""))
    if request.param == "tiny":
        data_path = make_tiny_dataset(str(root))
    else:
        data_path = os.path.join(REPO_ROOT, "dataset")
    cfg = _cfg(data_path, str(root / "saved"), request.param)
    jax_side = _build_jax(cfg, request.param)
    torch_side = _build_torch(cfg, request.param, _jax_params(jax_side))
    return jax_side, torch_side, root


@pytest.mark.parametrize("split", [1, 2], ids=["valid", "test"])
@pytest.mark.parametrize("streaming", [False, True], ids=["dense", "streaming"])
def test_evaluate_matches_jax(sides, streaming, split):
    jax_side, torch_side, _ = sides
    load_jax_params(torch_side.trainer.model, _jax_params(jax_side))
    ours = torch_side.evaluate(split, streaming)
    ref = jax_side.evaluate(split, streaming)
    assert ours == ref
    assert torch_side.trainer._last_eval_path == ("streaming" if streaming else "fused")
    assert all(np.isfinite(v) for v in ours.values())


@pytest.mark.parametrize("split", [1, 2], ids=["valid", "test"])
@pytest.mark.parametrize("streaming", [False, True], ids=["dense", "streaming"])
def test_registry_trainer_evaluate_matches_jax(sides, streaming, split):
    """Through ``get_trainer`` both packages give PFCN_PMF a ``PFCNTrainer``:
    ``evaluate`` reads the best checkpoint by default and nests the result
    under ``"none"``."""
    jax_side, torch_side, root = sides
    ckpt = str(root / "registry-best.pth")
    jax_side.trainer._save_checkpoint(0, verbose=False, saved_model_file=ckpt)
    ref_trainer = jax_side.registry_trainer(jax_get_trainer)
    trainer = torch_side.registry_trainer(get_trainer)
    assert type(ref_trainer).__name__ == type(trainer).__name__ == "PFCN_PMFTrainer"
    assert isinstance(trainer, PFCN_PMFTrainer)
    # other weights in memory than in the checkpoint: the default must reload
    load_jax_params(trainer.model, {k: np.zeros_like(v) for k, v in _jax_params(jax_side).items()})
    ref_trainer.saved_model_file = trainer.saved_model_file = ckpt
    jax_side.config["streaming_eval"] = torch_side.config["streaming_eval"] = streaming
    ours = trainer.evaluate(torch_side.loaders[split])
    ref = ref_trainer.evaluate(jax_side.loaders[split])
    assert list(ours) == list(ref) == ["none"]
    assert dict(ours["none"]) == dict(ref["none"])
    flat = jax_side.evaluate(split, streaming)  # the base Trainer's flat dict
    assert dict(ours["none"]) == flat
    assert dict(trainer.evaluate(torch_side.loaders[split], load_best_model=False)["none"]) == flat


def test_streaming_equals_dense_on_exact_weights(sides):
    jax_side, torch_side, _ = sides
    params = _jax_params(jax_side)
    exact = _exact_weights({k: v.shape for k, v in params.items()})
    jax_side.trainer.params = jax.tree_util.tree_map(jax.numpy.asarray, exact)
    load_jax_params(torch_side.trainer.model, exact)
    try:
        for split in (1, 2):
            dense = torch_side.evaluate(split, False)
            assert torch_side.evaluate(split, True) == dense
            assert jax_side.evaluate(split, False) == dense
            assert jax_side.evaluate(split, True) == dense
    finally:
        jax_side.trainer.params = jax.tree_util.tree_map(jax.numpy.asarray, params)


def test_use_pallas_false_takes_the_plain_streaming_path(sides, monkeypatch):
    """On the CPU, ``use_pallas: False`` routes streaming evaluation through
    the plain tiled ``ops.topk.streaming_topk_scores`` and never calls the
    fused top-k's wrapper; the default calls the wrapper and never the tiled
    version. On untied scores (``_exact_weights``) both give the dense
    path's metrics, as the JAX package's plain streaming path does. (On the
    card the key is refused: tests/test_torch_kernels_gpu.py.)"""
    from recbole_fairrec_tpu_torch.ops import topk

    jax_side, torch_side, _ = sides
    params = _jax_params(jax_side)
    exact = _exact_weights({k: v.shape for k, v in params.items()})
    jax_side.trainer.params = jax.tree_util.tree_map(jax.numpy.asarray, exact)
    load_jax_params(torch_side.trainer.model, exact)
    calls = {"wrapper": 0, "tiled": 0}

    def counting(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(fused_topk, "fused_topk_scores",
                        counting("wrapper", fused_topk.fused_topk_scores))
    monkeypatch.setattr(topk, "streaming_topk_scores",
                        counting("tiled", topk.streaming_topk_scores))
    try:
        for split in (1, 2):
            dense = torch_side.evaluate(split, False)
            for use_pallas, route in ((True, "wrapper"), (False, "tiled")):
                torch_side.config["use_pallas"] = use_pallas
                before = dict(calls)
                assert torch_side.evaluate(split, True) == dense
                assert torch_side.trainer._last_eval_path == "streaming"
                assert {k: calls[k] > before[k] for k in calls} == \
                    {k: k == route for k in calls}
            jax_side.config["use_pallas"] = False
            assert jax_side.evaluate(split, True) == dense
    finally:
        torch_side.config["use_pallas"] = jax_side.config["use_pallas"] = True
        jax_side.trainer.params = jax.tree_util.tree_map(jax.numpy.asarray, params)


def test_load_data_and_model_reads_jax_checkpoint(sides):
    jax_side, _, root = sides
    ckpt = str(root / "jax-written.pth")
    jax_side.trainer._save_checkpoint(0, verbose=False, saved_model_file=ckpt)
    before = fused_topk.launches
    config, model, trainer, _, _, valid_data, test_data = load_data_and_model(
        ckpt, config_dict={"use_gpu": False, "log_root": str(root / "log")}
    )
    assert isinstance(trainer, PFCN_PMFTrainer) and str(config["device"]) == "cpu"
    for name, value in _jax_params(jax_side).items():
        np.testing.assert_array_equal(getattr(model, name).weight.detach().numpy(), value)
    for streaming in (False, True):
        config["streaming_eval"] = streaming
        ours = trainer.evaluate(test_data)  # reloads the JAX-written checkpoint
        assert list(ours) == ["none"]
        assert dict(ours["none"]) == jax_side.evaluate(2, streaming)
    assert fused_topk.launches == before  # CPU tensors take the plain version


def test_port_checkpoint_round_trip(sides):
    _, torch_side, root = sides
    ckpt = str(root / "port-written.pth")
    torch_side.trainer._save_checkpoint(0, verbose=False, saved_model_file=ckpt)
    expected = torch_side.evaluate(2, True)
    config, _, trainer, _, _, _, test_data = load_data_and_model(
        ckpt, config_dict={"use_gpu": False, "streaming_eval": True,
                           "log_root": str(root / "log")}
    )
    assert dict(trainer.evaluate(test_data)["none"]) == expected


def test_load_jax_params_rejects_mismatch(sides):
    jax_side, torch_side, _ = sides
    params = _jax_params(jax_side)
    model = torch_side.trainer.model
    with pytest.raises(KeyError):
        load_jax_params(model, {**params, "extra": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        load_jax_params(model, {"user_embedding": params["user_embedding"]})
    bad = dict(params, item_embedding=params["item_embedding"][:-1])
    with pytest.raises(ValueError):
        load_jax_params(model, bad)
