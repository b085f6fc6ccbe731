"""The port's parallel layer (``recbole_fairrec_tpu_torch/parallel/``) on
CPU worlds of gloo processes, held against the JAX package's own parallel
functions on its simulated 8-device CPU mesh and against the meshless port.

Two worlds start once for the module, side by side, from
``tests/torch_parallel_worker.py``; each rank runs every scenario of its
world and writes its results, and each check below is one test case over
them:

* four processes (``init_process_group`` on a file store): the lookups at
  model 4 (``[1, 4]``) and model 2 (``[2, 2]``, also the ``data_axis``
  form), ``distributed_topk_scores`` and ``sharded_propagate`` at model 2
  and 4, a FOCF step over ``[2, 2]``, steps of PFCN_MLP, PFCN_DMF,
  PFCN_BiasedMF, NFCF (finetune), FairGo_PMF (finetune) and FairGo_GCN
  (pretrain) over ``[2, 2]``, and ``run_recbole`` of FOCF over ``[2, 2]``
  with its checkpoint;
* two processes started by ``quick_start.init_multihost`` with a
  coordinator address: the world they see, a FOCF step over ``[2, 1]``,
  PFCN_PMF ``sm`` filter and discriminator steps over ``[2, 1]`` (BatchNorm,
  dropout, weight-0 pad rows), and ``run_recbole`` of PFCN_PMF over ``[1, 2]``
  with ``distributed_eval: True``.

The JAX mesh covers all 8 simulated devices, so JAX runs at ``(4, 2)`` /
``(2, 4)`` and the port's world at the same MODEL-axis size. Tolerances
(float32): lookups, propagation and top-k scores 1e-5 (two hops 1e-4, as
``tests/test_parallel.py``); the FOCF step against JAX's single-device step
1e-5 (loss, tables, as ``tests/test_parallel.py``); the PFCN_PMF steps and
the other six models' steps against the meshless port 1e-5 of each tensor's
largest magnitude (at least 1e-5; losses, parameters and BatchNorm
statistics: float32 sums over a split batch round differently in proportion
to the size of their terms, which can exceed that of the result). These
steps run SGD (learning rate 1e-3), whose step lr · g keeps float32 noise in
a gradient far below the tolerance: a linear bias that feeds a BatchNorm has
an analytic gradient of 0, and Adam's first step, about lr · g / |g|, would
turn its noise into up to 2 lr either way
(``tests/test_torch_adversarial_training.py``'s module doc; its trajectories
run SGD for the same reason). Whole runs: the dicts of the meshless run, and
under ``distributed_eval`` recall / hit exactly and the rest within 2e-3
(``tests/test_parallel.py``).
"""

import json
import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_tiny_dataset
from recbole_fairrec_tpu.parallel import make_mesh as jax_make_mesh
from recbole_fairrec_tpu.parallel.embedding import bucket_allgather_lookup as jax_lookup
from recbole_fairrec_tpu.parallel.embedding import pad_table_rows as jax_pad_table_rows
from recbole_fairrec_tpu.parallel.embedding import shard_table as jax_shard_table
from recbole_fairrec_tpu.parallel.eval import distributed_topk_scores as jax_topk
from recbole_fairrec_tpu.parallel.spmm import shard_propagation_matrix as jax_shard_prop
from recbole_fairrec_tpu.parallel.spmm import sharded_propagate as jax_propagate

import chip_smoke
from recbole_fairrec_tpu_torch import load_data_and_model, run_recbole
from recbole_fairrec_tpu_torch.ops.topk import streaming_topk_scores
from recbole_fairrec_tpu_torch.parallel import local_candidates, merge_candidates
from recbole_fairrec_tpu_torch.parallel import pad_table_rows as port_pad_table_rows
from recbole_fairrec_tpu_torch.quick_start import init_multihost
from recbole_fairrec_tpu_torch.trainer import Trainer
from torch_jax_native_cache import private_jax_native_cache  # noqa: F401 (autouse fixture)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
WORLD_DEADLINE_S = 240
TOPK_CASES = ("plain", "valid", "mask", "mask_dense", "tiny")
JAX_MESH = {2: (4, 2), 4: (2, 4)}  # the JAX mesh with the same model axis
W4_MESHES = ([1, 4], [2, 2])


# ------------------------------------------------------------------- inputs


def _inputs():
    """Every array the worlds and the JAX references read, from numpy seeds
    (the lookups, top-k and propagation inputs are ``tests/test_parallel.py``'s)."""
    x = {}
    rng = np.random.RandomState(0)
    x["lookup_table"] = rng.randn(64, 16).astype(np.float32)
    x["lookup_ids"] = rng.randint(0, 64, 37)
    x["lookup_ids_probe"] = rng.randn(37, 16).astype(np.float32)
    rng = np.random.RandomState(5)
    x["lookup_ids_data"] = rng.randint(0, 64, 40)
    x["lookup_ids_data_probe"] = rng.randn(40, 16).astype(np.float32)

    def case(name, seed, n_users, n_items, k, mask=None):
        rng = np.random.RandomState(seed)
        x[f"topk_{name}_users"] = rng.randn(n_users, 8).astype(np.float32)
        x[f"topk_{name}_items"] = rng.randn(n_items, 8).astype(np.float32)
        x[f"topk_{name}_k"] = k
        if mask is not None:
            x[f"topk_{name}_mask"] = mask(rng, n_users, n_items)

    def half(rng, b, n):
        m = np.zeros((b, n), dtype=bool)
        m[:, :16] = True
        return m

    def dense(rng, b, n):  # most columns forbidden: −inf slots inside every shard
        m = rng.rand(b, n) < 0.85
        m[0] = True
        return m

    case("plain", 1, 12, 64, 5)
    case("valid", 6, 6, 31, 5)  # 31 real rows: one padding row at model 2 and 4
    case("mask", 2, 4, 32, 3, half)
    case("mask_dense", 3, 5, 16, 6, dense)
    case("tiny", 7, 5, 7, 10)  # fewer candidates than k: sentinel slots

    rng = np.random.RandomState(5)
    n = 37  # not divisible by the model axis
    x["prop_A"] = (rng.rand(n, n) * (rng.rand(n, n) < 0.2)).astype(np.float32)
    x["prop_x"] = rng.randn(n, 16).astype(np.float32)
    return x


def _focf_setup():
    """tests/test_parallel.py's FOCF step: the JAX model, its initial
    parameters, the batch and the port worker's view of them."""
    from recbole_fairrec_tpu.models.focf import FOCF

    class _Cfg(dict):
        def __getitem__(self, k):
            return self.get(k)

    class _Feat(dict):
        @property
        def columns(self):
            return list(self.keys())

    n_users, n_items = 64, 96
    rng = np.random.RandomState(3)
    ratings = rng.randint(1, 6, 500).astype(np.float32)
    gender = np.r_[0, rng.randint(1, 3, n_users - 1)]

    class _DS:
        user_num, item_num = n_users, n_items
        inter_feat = {"rating": ratings}

        def num(self, field):
            return {"user_id": n_users, "item_id": n_items}[field]

        def get_user_feature(self):
            return _Feat(user_id=np.arange(n_users), gender=gender)

    cfg = _Cfg(USER_ID_FIELD="user_id", ITEM_ID_FIELD="item_id", NEG_PREFIX="neg_",
               RATING_FIELD="rating", sst_attr_list=["gender"], embedding_size=16,
               fair_weight=1.0, fair_objective="value")
    model = FOCF(cfg, _DS())
    params, _ = model.init_params(jax.random.PRNGKey(0))
    batch = {
        "user_id": rng.randint(1, n_users, 32),
        "item_id": rng.randint(1, n_items, 32),
        "rating": rng.randint(1, 6, 32).astype(np.float32),
        "gender": rng.randint(1, 3, 32),
    }
    port = {"focf_n_users": n_users, "focf_n_items": n_items, "focf_ratings": ratings,
            "focf_gender": gender, "focf_batch": batch,
            "focf_params": jax.tree_util.tree_map(np.asarray, params)}
    return model, params, batch, port


def _focf_run_cfg(data_path, work, mesh=None):
    cfg = {
        "use_gpu": False, "data_path": data_path,
        "load_col": {"inter": ["user_id", "item_id", "rating"], "user": ["user_id", "gender"]},
        "epochs": 2, "train_batch_size": 128, "eval_batch_size": 2048,
        "show_progress": False, "state": "ERROR", "fair_objective": "value",
        "checkpoint_dir": os.path.join(work, "saved"), "log_root": os.path.join(work, "log"),
    }
    if mesh:
        cfg["mesh_shape"] = mesh
    return cfg


def _pfcn_run_cfg(data_path, work, mesh=None):
    cfg = {
        "use_gpu": False, "data_path": data_path,
        "load_col": {"inter": ["user_id", "item_id", "rating"], "user": ["user_id", "gender"]},
        "filter_mode": "none", "metrics": ["NDCG", "Recall", "Hit", "MRR"], "topk": [5],
        "valid_metric": "NDCG@5", "epochs": 2, "train_batch_size": 64,
        "eval_args": {"split": {"RS": [0.8, 0.1, 0.1]}, "order": "RO", "group_by": "user",
                      "mode": "full"},
        "show_progress": False, "state": "ERROR",
        "checkpoint_dir": os.path.join(work, "saved"), "log_root": os.path.join(work, "log"),
    }
    if mesh:
        cfg.update(mesh_shape=mesh, distributed_eval=True)
    return cfg


def _pfcn_step_cfg(data_root, work, extra=None):
    return chip_smoke.adversarial_config(data_root, work, {
        **STEP_LEARNER, "use_gpu": False, "sst_attr_list": ["gender", "age"],
        "load_col": {"inter": ["user_id", "item_id", "rating"],
                     "user": ["user_id", "gender", "age"]},
        "device_neg_sampling": False, "train_batch_size": 64, "state": "ERROR",
        "save_dataset": False, "save_dataloaders": False, **(extra or {}),
    })


# steps compared with the meshless port run SGD (see the module doc)
STEP_LEARNER = {"learner": "sgd", "learning_rate": 1e-3}
PFCN_SST = ["gender", "age"]
PFCN_PASSES = [["calculate_loss", "filter", PFCN_SST], ["calculate_dis_loss", "dis", PFCN_SST]]
# the other six models, one or two steps each over [2, 2]: (name, model,
# stage, steps of (loss, optimizer tag, attribute subset))
STEP_MODELS = [
    ("PFCN_MLP", "PFCN_MLP", None, PFCN_PASSES),
    ("PFCN_DMF", "PFCN_DMF", None, PFCN_PASSES),
    ("PFCN_BiasedMF", "PFCN_BiasedMF", None, PFCN_PASSES),
    ("NFCF", "NFCF", None, [["calculate_loss", "main", None]]),
    ("FairGo_PMF", "FairGo_PMF", "finetune", [["calculate_loss", "filter", ["gender"]],
                                              ["calculate_dis_loss", "dis", ["gender"]]]),
    ("FairGo_GCN", "FairGo_GCN", "pretrain", [["calculate_loss", "pretrain", None]]),
]


def _step_cfg(data_root, work, model, nfcf_pretrain):
    extra = {**STEP_LEARNER, "use_gpu": False, "state": "ERROR"}
    if model.startswith("PFCN"):
        return _pfcn_step_cfg(data_root, work, {"filter_mode": "cm"}
                              if model == "PFCN_BiasedMF" else None)
    if model == "NFCF":
        return chip_smoke.published_config(data_root, work, model,
                                           {**extra, "load_pretrain_path": nfcf_pretrain})
    if model == "FairGo_PMF":  # clipped by the norm of the whole (sharded) parameter set
        extra["clip_grad_norm"] = {"max_norm": 1e-2}
    return chip_smoke.fairgo_config(data_root, work, model, extra)


def _first_batch(train_data):
    """The first train batch and weight-0 pad rows (at least 8, to a
    multiple of 4 rows, so that it splits over any data axis here)."""
    np.random.seed(3)
    inter = next(iter(train_data))
    batch = {k: v.numpy() for k, v in inter.interaction.items()}
    n = len(next(iter(batch.values())))
    pad = 8 + (-(n + 8)) % 4
    out = {k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)]) for k, v in batch.items()}
    out["__weight__"] = np.r_[np.ones(n), np.zeros(pad)].astype(np.float32)
    return out


def _build(cfg, model):
    from recbole_fairrec_tpu_torch import Config
    from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
    from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed

    config = Config(model=model, dataset=chip_smoke.ADV_DATASET, config_dict=cfg)
    init_seed(config["seed"], config["reproducibility"])
    ds = create_dataset(config)
    train_data, _, _ = data_preparation(config, ds)
    generator = init_seed(config["seed"], config["reproducibility"])
    built = get_model(model)(config, train_data.dataset, generator=generator)
    return get_trainer(config["MODEL_TYPE"], model)(config, built), train_data


def _run_steps(trainer, batch, steps):
    from recbole_fairrec_tpu_torch.utils.jax_params import _flatten, to_jax_params, to_jax_state

    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for loss_name, tag, sst in steps:
        loss = trainer._train_step(dict(batch), loss_name, tuple(sst) if sst else None,
                                   trainer._tx_by_tag(tag))
        out.append({"loss": float(loss), "params": _flatten(to_jax_params(trainer.model)),
                    "state": _flatten(to_jax_state(trainer.model))})
    return out


# ------------------------------------------------------------------- worlds


def _start_world(root, name, world, init, scenarios, inputs, extra):
    tmp = os.path.join(root, name)
    out = os.path.join(tmp, "out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    spec = {"world": world, "init": init, "store": os.path.join(tmp, "store"), "tmp": tmp,
            "out": out, "inputs": os.path.join(tmp, "inputs.pkl"), "scenarios": scenarios,
            **extra}
    spec_path = os.path.join(tmp, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen([sys.executable, WORKER, spec_path, str(r)], env=env,
                                          stdout=log, stderr=subprocess.STDOUT))
    return procs, out


def _finish_world(procs, out, deadline):
    """Wait for every rank; when one fails or the deadline passes, end the
    others (they may wait in a collective for it)."""
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.2)
    logs = []
    for r, p in enumerate(procs):
        p.wait()
        with open(os.path.join(out, f"rank{r}.log")) as f:
            logs.append(f.read())
    if not all(p.returncode == 0 and "WORKER_OK" in log for p, log in zip(procs, logs)):
        pytest.fail("\n".join(f"rank {r} (exit {p.returncode}):\n{log[-4000:]}"
                               for r, (p, log) in enumerate(zip(procs, logs))))
    ranks = []
    for r in range(len(procs)):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds, started together, and while they run the meshless
    port's steps and runs on the same inputs; every rank's results."""
    root = str(tmp_path_factory.mktemp("parallel"))
    inputs = _inputs()
    _, _, _, focf = _focf_setup()
    inputs.update(focf)

    tiny = make_tiny_dataset(os.path.join(root, "data"), n_users=31, n_items=39)
    # 59 users and 79 items: 60 and 80 rows with PAD, which divide 2 and 4
    adv = os.path.join(root, "adv-data")
    chip_smoke.write_dataset(adv, n_users=59, n_items=79, n_inter=1500,
                             name=chip_smoke.ADV_DATASET, attributes=True)
    meshless = {}
    meshless["pfcn"], train_data = _build(_pfcn_step_cfg(adv, os.path.join(root, "pfcn")),
                                          "PFCN_PMF")
    inputs["pfcn_batch"] = _first_batch(train_data)
    nfcf_pretrain = os.path.join(root, "nfcf-pretrain.pth")
    pre, _ = _build(chip_smoke.published_config(adv, os.path.join(root, "nfcf-pre"), "NFCF",
                                                {"use_gpu": False, "state": "ERROR"}), "NFCF")
    pre._save_checkpoint(0, verbose=False, saved_model_file=nfcf_pretrain)
    step_specs = []
    for name, model, stage, steps in STEP_MODELS:
        cfg = _step_cfg(adv, os.path.join(root, f"steps-{name}"), model, nfcf_pretrain)
        meshless[name], train_data = _build(cfg, model)
        if stage:
            meshless[name].model.train_stage = stage
        inputs[f"steps_{name}"] = _first_batch(train_data)
        mesh_cfg = {**_step_cfg(adv, os.path.join(root, f"mesh-steps-{name}"), model,
                                nfcf_pretrain), "mesh_shape": [2, 2]}
        step_specs.append([name, model, mesh_cfg, stage, steps])

    w4 = _start_world(root, "w4", 4, "file", ["lookup", "topk", "propagate", "focf_step",
                                              "model_steps", "runs"], inputs, {
        "meshes": list(W4_MESHES), "topk_cases": list(TOPK_CASES), "focf_mesh": [2, 2],
        "model_steps": step_specs, "steps_dataset": chip_smoke.ADV_DATASET,
        "runs": [["focf", "FOCF", "tiny", _focf_run_cfg(tiny, os.path.join(root, "w4run"),
                                                         [2, 2])]],
    })
    w2 = _start_world(root, "w2", 2, "multihost", ["startup", "focf_step", "pfcn_steps",
                                                   "runs"], inputs, {
        "focf_mesh": [2, 1],
        "pfcn_config": {**_pfcn_step_cfg(adv, os.path.join(root, "pfcn-mesh")),
                        "mesh_shape": [2, 1]},
        "pfcn_dataset": chip_smoke.ADV_DATASET, "pfcn_sst": PFCN_SST,
        "runs": [["pfcn", "PFCN_PMF", "tiny", _pfcn_run_cfg(tiny, os.path.join(root, "w2run"),
                                                             [1, 2])]],
    })
    deadline = time.monotonic() + WORLD_DEADLINE_S
    try:
        return _meshless_and_finish(inputs, root, tiny, meshless, w4, w2, deadline)
    finally:
        for p in w4[0] + w2[0]:
            if p.poll() is None:
                p.kill()


def _meshless_and_finish(inputs, root, tiny, meshless, w4, w2, deadline):
    """The meshless references, while the worlds run, then the worlds'
    results."""
    ref_steps = {"pfcn": _run_steps(meshless["pfcn"], inputs["pfcn_batch"], PFCN_PASSES)}
    for name, _, _, steps in STEP_MODELS:
        ref_steps[name] = _run_steps(meshless[name], inputs[f"steps_{name}"], steps)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        ref_runs = {
            "focf": run_recbole("FOCF", "tiny", config_dict=_focf_run_cfg(
                tiny, os.path.join(root, "focf"))),
            "pfcn": run_recbole("PFCN_PMF", "tiny", config_dict=_pfcn_run_cfg(
                tiny, os.path.join(root, "pfcn-run"))),
        }
    finally:
        os.chdir(cwd)

    return {"inputs": inputs, "ref_steps": ref_steps, "ref_runs": ref_runs,
            "w4": _finish_world(*w4, deadline), "w2": _finish_world(*w2, deadline)}


# ------------------------------------------------------------------ lookups


def _jax_lookup(inputs, model_size, form):
    mesh = jax_make_mesh(JAX_MESH[model_size])
    table = jnp.asarray(inputs["lookup_table"])
    ids_key = "lookup_ids" if form == "model" else "lookup_ids_data"
    ids = jnp.asarray(inputs[ids_key])
    probe = jnp.asarray(inputs[f"{ids_key}_probe"])
    data_axis = "data" if form == "data" else None

    def loss(t):
        return jnp.sum(jax_lookup(mesh, t, ids, data_axis=data_axis) * probe)

    sharded = jax_shard_table(mesh, table)
    out = jax_lookup(mesh, sharded, ids, data_axis=data_axis)
    return np.asarray(out), np.asarray(jax.grad(loss)(sharded))


@pytest.mark.parametrize("shape,form", [((1, 4), "model"), ((2, 2), "model"),
                                        ((2, 2), "data")])
def test_lookup_matches_dense_and_jax(worlds, shape, form):
    inputs = worlds["inputs"]
    ids_key = "lookup_ids" if form == "model" else "lookup_ids_data"
    ids, probe = inputs[ids_key], inputs[f"{ids_key}_probe"]
    dense = inputs["lookup_table"][ids]
    dense_grad = np.zeros_like(inputs["lookup_table"])
    np.add.at(dense_grad, ids, probe)
    jax_out, jax_grad = _jax_lookup(inputs, shape[1], form)
    np.testing.assert_allclose(jax_grad, dense_grad, rtol=1e-6, atol=1e-6)
    rows = 64 // shape[1]
    for r, res in enumerate(worlds["w4"]):
        got = res["lookup"][(shape, form)]
        expect = dense
        if form == "data":  # rank (d, m) returns its data slice of the ids
            n = len(ids) // shape[0]
            d = r // shape[1]
            expect, jax_part = dense[d * n:(d + 1) * n], jax_out[d * n:(d + 1) * n]
        else:
            jax_part = jax_out
        np.testing.assert_allclose(got["out"], expect, rtol=1e-6, atol=0)
        np.testing.assert_allclose(got["out"], jax_part, rtol=1e-6, atol=0)
        m = got["model_index"]
        np.testing.assert_allclose(got["grad"], dense_grad[m * rows:(m + 1) * rows],
                                   rtol=1e-6, atol=1e-6)


def test_pad_table_rows_and_make_mesh_errors_as_jax():
    for rows, n in ((10, 8), (30, 2), (31, 2), (7, 4)):
        t = np.ones((rows, 4), dtype=np.float32)
        jp, jn = jax_pad_table_rows(jnp.asarray(t), n)
        pp, pn = port_pad_table_rows(torch.from_numpy(t), n)
        assert tuple(pp.shape) == tuple(jp.shape) and pn == jn
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh((3, 2))
    assert str(jax_err.value) == "mesh_shape (3, 2) does not cover 8 devices"


def test_make_mesh_refuses_without_a_group_and_a_bad_shape_on_a_world_of_one(tmp_path):
    from recbole_fairrec_tpu_torch.parallel import make_mesh

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh((1, 1))
    assert init_multihost({"multihost": True, "use_gpu": False, "num_processes": 1,
                           "process_id": 0,
                           "coordinator_address": f"file://{tmp_path / 'store'}"})
    try:
        assert init_multihost({"multihost": True})  # the group exists: a no-op
        with pytest.raises(ValueError) as err:
            make_mesh((2, 1))
        assert str(err.value) == "mesh_shape (2, 1) does not cover 1 devices"
        mesh = make_mesh()
        assert mesh.shape == {"data": 1, "model": 1}
    finally:
        torch.distributed.destroy_process_group()


# -------------------------------------------------------------------- top-k


def _jax_topk_case(inputs, case, model_size):
    mesh = jax_make_mesh(JAX_MESH[model_size])
    users = jnp.asarray(inputs[f"topk_{case}_users"])
    items, valid = jax_pad_table_rows(jnp.asarray(inputs[f"topk_{case}_items"]), model_size)
    mask = inputs.get(f"topk_{case}_mask")
    if mask is not None:
        mask = np.concatenate([mask, np.zeros((mask.shape[0], items.shape[0] - mask.shape[1]),
                                              dtype=bool)], axis=1)
        mask = jnp.asarray(mask)
    s, i = jax_topk(mesh, users, items, int(inputs[f"topk_{case}_k"]), mask_cols=mask,
                    valid_rows=valid if valid < items.shape[0] else None)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("case", TOPK_CASES)
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["model2", "model4"])
def test_distributed_topk_matches_jax(worlds, shape, case):
    inputs = worlds["inputs"]
    js, ji = _jax_topk_case(inputs, case, shape[1])
    if case == "tiny":  # the sentinel slots are there
        assert (ji == 8).any() and np.isneginf(js).any()
    for res in worlds["w4"]:
        s, i = res["topk"][(shape, case)]
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_shards,k", [(4, 173), (3, 7), (5, 40)])
def test_shard_mode_plain_path_matches_streaming_topk(n_shards, k):
    """local_candidates per shard (the plain version of the kernel's shard
    mode: offset indices, PAD selectable) then merge_candidates equal
    ``streaming_topk_scores`` over the whole table, PAD not masked."""
    rng = np.random.RandomState(n_shards)
    users = torch.from_numpy(rng.randn(33, 16).astype(np.float32))
    table = torch.from_numpy(rng.randn(181, 16).astype(np.float32))
    users[0] = 10 * table[0]  # row 0 (PAD in a catalogue) is user 0's best
    padded, valid = port_pad_table_rows(table, n_shards)
    rows = padded.shape[0] // n_shards
    parts = [local_candidates(users, padded[s * rows:(s + 1) * rows], k, s * rows, valid)
             for s in range(n_shards)]
    s, i = merge_candidates([p[0] for p in parts], [p[1] for p in parts], k, padded.shape[0])
    es, ei = streaming_topk_scores(users, table, k, mask_pad=False)
    np.testing.assert_array_equal(i.numpy(), ei.numpy())
    np.testing.assert_allclose(s.numpy(), es.numpy(), rtol=1e-6, atol=0)
    assert int(i[0, 0]) == 0  # not masked in the shard mode


# ------------------------------------------------------------- propagation


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["model2", "model4"])
def test_sharded_propagate_matches_jax_and_dense(worlds, shape):
    inputs = worlds["inputs"]
    a, x = inputs["prop_A"], inputs["prop_x"]
    mesh = jax_make_mesh(JAX_MESH[shape[1]])
    a_sharded = jax_shard_prop(mesh, jnp.asarray(a))
    j1 = np.asarray(jax_propagate(mesh, a_sharded, jnp.asarray(x)))
    j2 = np.asarray(jax_propagate(mesh, a_sharded, jnp.asarray(j1)))
    for res in worlds["w4"]:
        one, two, stripe = res["propagate"][shape]
        assert stripe == (-(-37 // shape[1]), 37)
        np.testing.assert_allclose(one, a @ x, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(one, j1, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(two, a @ (a @ x), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(two, j2, rtol=1e-4, atol=1e-4)


# -------------------------------------------------------------- train steps


@pytest.fixture(scope="module")
def jax_focf_step():
    import optax

    model, params, batch, _ = _focf_setup()
    tx = optax.chain(optax.scale_by_adam(eps=1e-8), optax.scale(-1e-3))

    def step(p, o, b):
        def loss_fn(pp):
            loss, _ = model.calculate_loss(pp, {}, b)
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, o = tx.update(grads, o, p)
        return loss, optax.apply_updates(p, updates)

    loss, new = jax.jit(step)(params, tx.init(params),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree_util.tree_map(np.asarray, new)


@pytest.mark.parametrize("world,shape", [("w4", (2, 2)), ("w2", (2, 1))])
def test_focf_step_matches_jax_single_device(worlds, jax_focf_step, world, shape):
    loss, params = jax_focf_step
    for res in worlds[world]:
        got = res["focf_step"]
        assert got["local_rows"] == 64 // shape[1]  # the user table is row-sharded
        assert abs(got["loss"] - loss) < 1e-5
        for key in ("user_embedding", "item_embedding"):
            np.testing.assert_allclose(got[key], params[key], atol=1e-5, rtol=0)


def _assert_steps_close(got, ref, label):
    """Meshed steps against the meshless ones: losses, parameters and
    BatchNorm statistics after each step."""
    from recbole_fairrec_tpu_torch.utils.jax_params import _flatten

    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert abs(g["loss"] - r["loss"]) <= 1e-5 * max(1.0, abs(r["loss"])), (label, i)
        params, state = _flatten(g["params"]), _flatten(g["state"])
        assert set(params) == set(r["params"]) and set(state) == set(r["state"])
        for name, value in {**r["params"], **r["state"]}.items():
            atol = 1e-5 * max(1.0, float(np.abs(value).max(initial=0.0)))
            np.testing.assert_allclose({**params, **state}[name], value, rtol=0, atol=atol,
                                       err_msg=f"{label} step {i} {name}")


def test_pfcn_sm_steps_match_meshless(worlds):
    """PFCN_PMF sm over gender and age, [2, 1]: a filter step, then a
    discriminator step (BatchNorm, dropout, weight-0 pad rows)."""
    for res in worlds["w2"]:
        got = [res["pfcn_steps"][tag] for tag in ("filter", "dis")]
        _assert_steps_close(got, worlds["ref_steps"]["pfcn"], "PFCN_PMF")


@pytest.mark.parametrize("name", [m[0] for m in STEP_MODELS])
def test_model_steps_match_meshless(worlds, name):
    """The other six models over [2, 2] (batch split over data, both tables
    row-sharded over model) against the meshless port's steps."""
    for res in worlds["w4"]:
        got = res["model_steps"][name]
        assert got["row_shards"] == {"user_embedding": 2, "item_embedding": 2}
        _assert_steps_close(got["steps"], worlds["ref_steps"][name], name)


# --------------------------------------------------------------- whole runs


def _flat(d):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def test_meshed_focf_run_gives_the_meshless_dicts(worlds):
    ref = worlds["ref_runs"]["focf"]
    for res in worlds["w4"]:
        got = res["runs"]["focf"]
        assert got["mesh"] == {"data": 2, "model": 2}
        assert got["row_shards"] == {"user_embedding": 2, "item_embedding": 2}
        for key, ref_key in (("test", "test_result"), ("valid", "best_valid_result")):
            a, b = _flat(got[key]), _flat(dict(ref[ref_key]))
            assert set(a) == set(b)
            for k in a:
                assert a[k] == pytest.approx(b[k], abs=1e-6), (key, k)


def test_distributed_eval_run_matches_the_single_device_path(worlds):
    ref = _flat(dict(worlds["ref_runs"]["pfcn"]["test_result"]))
    for res in worlds["w2"]:
        got = res["runs"]["pfcn"]
        assert got["mesh"] == {"data": 1, "model": 2}
        assert got["path"] == "distributed"
        test = _flat(got["test"])
        assert set(test) == set(ref)
        for k in ref:
            if "recall" in k or "hit" in k:
                assert test[k] == ref[k], k
            else:
                assert abs(test[k] - ref[k]) < 2e-3, k


def test_meshed_checkpoint_loads_into_a_meshless_trainer(worlds, tmp_path):
    got = worlds["w4"][0]["runs"]["focf"]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        _, _, trainer, _, _, _, test_data = load_data_and_model(
            got["checkpoint"], {"use_gpu": False, "mesh_shape": None})
        assert trainer.mesh is None and isinstance(trainer, Trainer)
        assert trainer.model.user_embedding.weight.shape[0] == trainer.model.n_users
        result = trainer.evaluate(test_data)
    finally:
        os.chdir(cwd)
    assert got["reloaded_mesh"] == {"data": 2, "model": 2}
    assert dict(result) == got["reloaded"]


# ------------------------------------------------------ multi-process start


def test_init_multihost_off():
    assert init_multihost({}) is False
    assert init_multihost(None) is False
    assert init_multihost({"multihost": False}) is False


def test_two_processes_with_a_coordinator_see_a_world_of_two(worlds):
    for r, res in enumerate(worlds["w2"]):
        assert res["startup"] == {"world": 2, "rank_sum": 1.0, "backend": "gloo"}, r
    l0, l1 = (res["focf_step"]["loss"] for res in worlds["w2"])
    assert l0 == l1
