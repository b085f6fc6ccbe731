"""The port's config and data layer against the JAX package's.

Both packages read the same atomic files with the same settings; the port
runs on the CPU (``use_gpu: False``). Remapped ids, the ETL's columns, the
RS [8, 1, 1] splits, the full-sort loaders' batches (history and positives)
and ``max_history_len`` must be identical, and the port's shipped property
defaults must equal what the JAX configurator's YAML loader reads.
"""

import enum
import glob
import json
import os

import numpy as np
import pytest
import torch

from recbole_fairrec_tpu.config import Config as JaxConfig
from recbole_fairrec_tpu.config.configurator import _build_yaml_loader
from recbole_fairrec_tpu.data import create_dataset as jax_create_dataset
from recbole_fairrec_tpu.data import data_preparation as jax_data_preparation
from recbole_fairrec_tpu.utils import init_seed as jax_init_seed

from recbole_fairrec_tpu_torch.config import Config
from recbole_fairrec_tpu_torch.config.configurator import _PROPERTIES_FILE
from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
from recbole_fairrec_tpu_torch.data.dataset import factorize
from recbole_fairrec_tpu_torch.utils import init_seed

import yaml
from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PROPERTIES = os.path.join(REPO, "recbole_fairrec_tpu", "config", "properties")


def _cfg(data_path, ckpt_dir, dataset):
    cfg = {
        "data_path": data_path,
        "load_col": {"inter": ["user_id", "item_id", "rating"], "user": ["user_id", "gender"]},
        "filter_mode": "none",
        "embedding_size": 64,
        "eval_args": {"split": {"RS": [8, 1, 1]}, "order": "RO",
                      "group_by": "user", "mode": "full"},
        "metrics": ["NDCG", "Recall", "Hit", "MRR"],
        "topk": [10],
        "valid_metric": "NDCG@10",
        "show_progress": False,
        "state": "ERROR",
        "checkpoint_dir": ckpt_dir,
    }
    if dataset == "tiny":
        cfg["threshold"] = {"rating": 3.0}
    return cfg


def _build_both(data_path, ckpt_dir, dataset):
    cfg = _cfg(data_path, ckpt_dir, dataset)
    jc = JaxConfig(model="PFCN_PMF", dataset=dataset, config_dict=cfg)
    jax_init_seed(jc["seed"], jc["reproducibility"])
    jd = jax_create_dataset(jc)
    jax_loaders = jax_data_preparation(jc, jd)

    tc = Config(model="PFCN_PMF", dataset=dataset, config_dict={**cfg, "use_gpu": False})
    init_seed(tc["seed"], tc["reproducibility"])
    td = create_dataset(tc)
    torch_loaders = data_preparation(tc, td)
    return (jc, jd, jax_loaders), (tc, td, torch_loaders)


@pytest.fixture(scope="module", params=["tiny", "ml-100k"])
def both(request, tmp_path_factory):
    from conftest import REPO_ROOT, make_tiny_dataset

    root = tmp_path_factory.mktemp(request.param.replace("-", ""))
    if request.param == "tiny":
        data_path = make_tiny_dataset(str(root))
    else:
        data_path = os.path.join(REPO_ROOT, "dataset")
    return _build_both(data_path, str(root / "saved"), request.param)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _assert_inter_equal(jax_inter, torch_inter):
    assert sorted(jax_inter.columns) == sorted(torch_inter.columns)
    for col in jax_inter.columns:
        np.testing.assert_array_equal(_np(torch_inter[col]), _np(jax_inter[col]), err_msg=col)


def _plain(value):
    """Config values with each package's enums reduced to (class name, value)."""
    if isinstance(value, enum.Enum):
        return (type(value).__name__, value.value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


def test_final_config_equal(both):
    (jc, _, _), (tc, _, _) = both
    skip = {"device", "backend", "use_gpu"}
    jax_cfg = {k: _plain(v) for k, v in jc.final_config_dict.items() if k not in skip}
    torch_cfg = {k: _plain(v) for k, v in tc.final_config_dict.items() if k not in skip}
    assert torch_cfg == jax_cfg
    assert tc["device"] == torch.device("cpu")


def test_remapped_ids_equal(both):
    (jc, jd, _), (tc, td, _) = both
    for field in (jd.uid_field, jd.iid_field):
        np.testing.assert_array_equal(
            np.asarray(td.field2id_token[field]), np.asarray(jd.field2id_token[field])
        )
        assert td.field2token_id[field] == jd.field2token_id[field]
    assert (td.user_num, td.item_num) == (jd.user_num, jd.item_num)


def test_inter_and_user_feat_equal(both):
    (_, jd, _), (_, td, _) = both
    _assert_inter_equal(jd.inter_feat, td.inter_feat)
    _assert_inter_equal(jd.get_user_feature(), td.get_user_feature())


@pytest.mark.parametrize("split", [0, 1, 2], ids=["train", "valid", "test"])
def test_split_equal(both, split):
    (_, _, jax_loaders), (_, _, torch_loaders) = both
    _assert_inter_equal(jax_loaders[split].dataset.inter_feat,
                        torch_loaders[split].dataset.inter_feat)


@pytest.mark.parametrize("split", [1, 2], ids=["valid", "test"])
def test_full_sort_loader_batches_equal(both, split):
    (_, _, jax_loaders), (_, _, torch_loaders) = both
    jl, tl = jax_loaders[split], torch_loaders[split]
    assert type(tl).__name__ == "FullSortEvalDataLoader"
    assert tl.max_history_len == jl.max_history_len > 0
    assert tl.step == jl.step
    n_batches = 0
    for jb, tb in zip(jl, tl, strict=True):
        j_inter, (j_hu, j_hi), j_pu, j_pi = jb
        t_inter, (t_hu, t_hi), t_pu, t_pi = tb
        _assert_inter_equal(j_inter, t_inter)
        for a, b in ((j_hu, t_hu), (j_hi, t_hi), (j_pu, t_pu), (j_pi, t_pi)):
            np.testing.assert_array_equal(_np(b), _np(a))
        n_batches += 1
    assert n_batches > 0


def test_train_loader_builds(both):
    (_, _, jax_loaders), (_, _, torch_loaders) = both
    assert type(torch_loaders[0]).__name__ == "TrainDataLoader"
    assert len(torch_loaders[0]) == len(jax_loaders[0])


def _jax_yaml_properties():
    loader = _build_yaml_loader()
    out = {}
    for path in sorted(glob.glob(os.path.join(JAX_PROPERTIES, "**", "*.yaml"), recursive=True)):
        key = os.path.relpath(path, JAX_PROPERTIES)[: -len(".yaml")]
        with open(path, "r", encoding="utf-8") as f:
            out[key] = yaml.load(f.read(), Loader=loader)
    return out


def test_property_defaults_equal_jax_yaml():
    with open(_PROPERTIES_FILE, "r", encoding="utf-8") as f:
        shipped = json.load(f)
    expected = _jax_yaml_properties()
    assert sorted(shipped) == sorted(expected)
    for key in expected:
        assert shipped[key] == expected[key], key


def test_user_yaml_keeps_scientific_floats(tmp_path, tiny_data_path):
    path = tmp_path / "user.yaml"
    path.write_text("learning_rate: 1e-3\nweight_decay: 5E-4\nepochs: 3\n")
    cfg = Config(model="PFCN_PMF", dataset="tiny", config_file_list=[str(path)],
                 config_dict={"data_path": tiny_data_path, "use_gpu": False})
    assert cfg["learning_rate"] == 1e-3 and isinstance(cfg["learning_rate"], float)
    assert cfg["weight_decay"] == 5e-4 and cfg["epochs"] == 3


@pytest.mark.parametrize("values", [
    ["b", "a", "b", None, "c", "a"],
    [3.0, 1.0, float("nan"), 3.0, 2.0],
    ["10", "9", "10", "100"],
])
def test_factorize_first_appearance(values):
    import pandas as pd

    arr = np.array(values, dtype=object)
    codes, uniques = factorize(arr)
    pd_codes, pd_uniques = pd.factorize(arr)
    np.testing.assert_array_equal(codes, pd_codes)
    assert list(uniques) == list(pd_uniques)


@pytest.mark.parametrize("name,cols,tokens", [
    ("ml-100k.inter", [0, 1, 2, 3], [True, True, False, False]),
    ("ml-100k.user", [0, 1, 2, 3, 4], [True, False, True, True, True]),
])
def test_native_reader_equals_python_reader(ml100k_path, name, cols, tokens):
    from recbole_fairrec_tpu_torch.data import fast_tsv

    path = os.path.join(ml100k_path, "ml-100k", name)
    native = fast_tsv.read_columns(path, "\t", cols, tokens)
    if native is None:
        pytest.skip("no C++ compiler for the native reader")
    plain = fast_tsv.read_columns_python(path, "\t", cols, tokens)
    for a, b, is_token in zip(native, plain, tokens):
        if is_token:
            assert a.tolist() == b.tolist()
        else:
            np.testing.assert_array_equal(a, b)


def test_python_reader_path_matches_jax(tmp_path, tiny_data_path):
    """``fast_io: False`` takes the pure-Python reader; the ETL result is
    the same as the JAX package's."""
    cfg = {**_cfg(tiny_data_path, str(tmp_path / "saved"), "tiny"), "fast_io": False}
    jc = JaxConfig(model="PFCN_PMF", dataset="tiny", config_dict=cfg)
    jd = jax_create_dataset(jc)
    td = create_dataset(Config(model="PFCN_PMF", dataset="tiny",
                               config_dict={**cfg, "use_gpu": False}))
    _assert_inter_equal(jd.inter_feat, td.inter_feat)


def test_user_yaml_without_pyyaml_says_so(tmp_path, tiny_data_path, monkeypatch):
    import sys

    path = tmp_path / "user.yaml"
    path.write_text("epochs: 3\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        Config(model="PFCN_PMF", dataset="tiny", config_file_list=[str(path)],
               config_dict={"data_path": tiny_data_path, "use_gpu": False})
