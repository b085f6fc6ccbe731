"""``compute_dtype: bfloat16``: the full-sort score products of PFCN_PMF,
PFCN_BiasedMF, FOCF and FairGo_PMF take bfloat16 operands into a float32
product, as the JAX package's ``jnp.dot(..., preferred_element_type=float32)``
does; parameters stay float32 and the retrieval tables stay float32.

Both packages build each model on the same small fair dataset from the same
JAX initial parameters. Bounds (the scores after their sigmoid or clamp,
both 1-Lipschitz or flatter):

* against the JAX package under bfloat16: 1e-5 (the same bfloat16 operands,
  float32 products and sums; only the order of the sums may differ);
* against the port's float32 scores: each operand rounds to bfloat16 with a
  relative error of at most 2^-8, so a product moves by at most about 2^-7
  of its size and a score by ``2^-7 · (|U| @ |T|ᵀ)`` (+ 1e-6), where U and
  T are the user and item representations the score multiplies; the two
  must also differ somewhere, or bfloat16 was not used.
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
from recbole_fairrec_tpu.utils import get_model as jax_get_model
from recbole_fairrec_tpu.utils import init_seed as jax_init_seed

import chip_smoke
from recbole_fairrec_tpu_torch import Config
from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
from recbole_fairrec_tpu_torch.utils import get_model, init_seed
from recbole_fairrec_tpu_torch.utils.jax_params import load_jax_params
from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)

MODELS = ["PFCN_PMF", "PFCN_BiasedMF", "FOCF", "FairGo_PMF"]
USERS = np.arange(1, 13)
SST = ("gender",)


def _config(root, model):
    work = os.path.join(root, model)
    if model.startswith("PFCN"):
        return chip_smoke.adversarial_config(root, work, {
            "sst_attr_list": ["gender", "age"], "embedding_size": 16,
            "load_col": {"inter": ["user_id", "item_id", "rating"],
                         "user": ["user_id", "gender", "age"]},
            "save_dataset": False, "save_dataloaders": False})
    if model == "FOCF":
        return chip_smoke.published_config(root, work, model, {"fair_objective": "value"})
    return chip_smoke.fairgo_config(root, work, model)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bf16"))
    chip_smoke.write_dataset(root, n_users=60, n_items=80, n_inter=1500,
                             name=chip_smoke.ADV_DATASET, attributes=True)
    return root


def _models(root, model, dtype):
    cfg = {**_config(root, model), "compute_dtype": dtype}
    jax_config = JaxConfig(model=model, dataset=chip_smoke.ADV_DATASET, config_dict=cfg)
    jax_init_seed(jax_config["seed"], True)
    jax_loaders = jax_data_preparation(jax_config, jax_create_dataset(jax_config))
    jax_model = jax_get_model(model)(jax_config, jax_loaders[0].dataset)
    params, state = jax_model.init_params(jax.random.PRNGKey(0))

    config = Config(model=model, dataset=chip_smoke.ADV_DATASET,
                    config_dict={**cfg, "use_gpu": False})
    init_seed(config["seed"], True)
    loaders = data_preparation(config, create_dataset(config))
    port = get_model(model)(config, loaders[0].dataset)
    load_jax_params(port, jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, state))
    if model.startswith("FairGo"):
        jax_model.train_stage = port.train_stage = "finetune"
    return jax_model, params, state, port


def _sst(model):
    return SST if model.startswith("PFCN") else None


def _operands(port, model):
    """The user and item representations that the score multiplies."""
    users = torch.from_numpy(USERS)
    with torch.no_grad():
        if model.startswith("PFCN"):
            u, _ = port._user_item_embed(users, None, SST)
            return u, port.item_embedding.weight
        if model == "FOCF":
            return port.user_embedding(users), port.item_embedding.weight
        user_all, item_all = port.forward(tuple(port.sst_attrs))
        return user_all[users], item_all


@pytest.mark.parametrize("model", MODELS)
def test_bf16_full_sort_matches_jax_and_the_bound(data_root, model):
    jax_model, params, state, port = _models(data_root, model, "bfloat16")
    assert port.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port.parameters())
    batch = {"user_id": torch.from_numpy(USERS)}
    with torch.no_grad():
        ours = port.full_sort_predict(batch, sst_list=_sst(model)).numpy()
    ref = np.asarray(jax_model.full_sort_predict(
        params, state, {"user_id": jnp.asarray(USERS)}, sst_list=_sst(model)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)

    port.compute_dtype = torch.float32
    with torch.no_grad():
        f32 = port.full_sort_predict(batch, sst_list=_sst(model)).numpy()
    u, t = (x.detach().numpy() for x in _operands(port, model))
    bound = (2.0 ** -7 * (np.abs(u) @ np.abs(t).T)).reshape(-1) + 1e-6
    assert (np.abs(ours - f32) <= bound).all()
    assert (ours != f32).any()


def test_retrieval_stays_float32(data_root):
    _, _, _, port = _models(data_root, "PFCN_PMF", "bfloat16")
    u, t = port.retrieval_embeddings({"user_id": torch.from_numpy(USERS)}, sst_list=SST)
    assert u.dtype == torch.float32 and t.dtype == torch.float32


def test_unknown_compute_dtype_is_refused(data_root):
    with pytest.raises(ValueError, match="compute_dtype"):
        _models(data_root, "FOCF", "float16")
