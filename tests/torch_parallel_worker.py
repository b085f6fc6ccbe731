"""One rank of a CPU (gloo) world for ``tests/test_torch_parallel.py``.

    python torch_parallel_worker.py <spec.json> <rank>

The spec names the world (size, rendezvous file, how the group starts), the
inputs (a pickle of numpy arrays written by the test) and the scenarios to
run in order. Each scenario runs the port's parallel layer over the whole
world and returns numpy values; the rank writes them all to
``<out>/rank<r>.pkl``. The test holds them against the JAX package and the
meshless port. This module imports torch and the port only.
"""

import datetime
import faulthandler
import json
import os
import pickle
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=60)


def _np(t):
    return t.detach().cpu().numpy().copy()


# ------------------------------------------------------------------ lookups


def lookup(spec, inputs):
    """``bucket_allgather_lookup`` forward and gradient (the loss is
    ``sum(out * probe)``) at every mesh of the spec, and its ``data_axis``
    form where the mesh has a data axis."""
    from recbole_fairrec_tpu_torch.parallel import bucket_allgather_lookup, make_mesh, shard_table

    out = {}
    for shape in spec["meshes"]:
        mesh = make_mesh(shape)
        for form, ids_key in (("model", "lookup_ids"), ("data", "lookup_ids_data")):
            if form == "data" and mesh.shape["data"] == 1:
                continue
            table = torch.from_numpy(inputs["lookup_table"])
            shard = shard_table(mesh, table).clone().requires_grad_(True)
            ids = torch.from_numpy(inputs[ids_key])
            res = bucket_allgather_lookup(mesh, shard, ids,
                                          data_axis="data" if form == "data" else None)
            probe = torch.from_numpy(inputs[f"{ids_key}_probe"])
            if form == "data":
                n = res.shape[0]
                probe = probe[mesh.index("data") * n:(mesh.index("data") + 1) * n]
            (grad,) = torch.autograd.grad((res * probe).sum(), shard)
            if form == "data":  # the table's gradient is the data ranks' sum
                dist.all_reduce(grad, group=mesh.group("data"))
            out[(tuple(shape), form)] = {"out": _np(res), "grad": _np(grad),
                                         "model_index": mesh.index("model")}
    return out


# -------------------------------------------------------------------- top-k


def topk(spec, inputs):
    """``distributed_topk_scores`` in every case of the spec at every mesh,
    each rank passing its rows of the (padded) table and of the mask."""
    from recbole_fairrec_tpu_torch.parallel import (
        distributed_topk_scores,
        make_mesh,
        pad_table_rows,
        shard_table,
    )

    out = {}
    for shape in spec["meshes"]:
        mesh = make_mesh(shape)
        n = mesh.shape["model"]
        for case in spec["topk_cases"]:
            users = torch.from_numpy(inputs[f"topk_{case}_users"])
            items, valid = pad_table_rows(torch.from_numpy(inputs[f"topk_{case}_items"]), n)
            mask = inputs.get(f"topk_{case}_mask")
            if mask is not None:
                mask = shard_table(mesh, torch.from_numpy(mask).T).T
            scores, idx = distributed_topk_scores(
                mesh, users, shard_table(mesh, items), int(inputs[f"topk_{case}_k"]),
                mask_cols=mask, valid_rows=valid if valid < items.shape[0] else None,
            )
            out[(tuple(shape), case)] = (_np(scores), _np(idx))
    return out


def propagate(spec, inputs):
    """``sharded_propagate``, one hop and two, at every mesh."""
    from recbole_fairrec_tpu_torch.parallel import (
        make_mesh,
        shard_propagation_matrix,
        sharded_propagate,
    )

    out = {}
    a = torch.from_numpy(inputs["prop_A"])
    x = torch.from_numpy(inputs["prop_x"])
    for shape in spec["meshes"]:
        mesh = make_mesh(shape)
        stripe = shard_propagation_matrix(mesh, a)
        one = sharded_propagate(mesh, stripe, x)
        two = sharded_propagate(mesh, stripe, one)
        out[tuple(shape)] = (_np(one), _np(two), tuple(stripe.shape))
    return out


# ------------------------------------------------------------- train steps


class _Feat(dict):
    @property
    def columns(self):
        return list(self.keys())


class _FocfData:
    """The dataset surface FOCF reads, from the test's arrays."""

    def __init__(self, inputs):
        self.n_users = int(inputs["focf_n_users"])
        self.n_items = int(inputs["focf_n_items"])
        self.user_num, self.item_num = self.n_users, self.n_items
        self.inter_feat = {"rating": inputs["focf_ratings"]}
        self._gender = inputs["focf_gender"]

    def num(self, field):
        return {"user_id": self.n_users, "item_id": self.n_items}[field]

    def get_user_feature(self):
        return _Feat(user_id=np.arange(self.n_users), gender=self._gender)


def focf_step(spec, inputs):
    """One FOCF step of ``Trainer._train_step`` under the spec's mesh from
    the JAX package's initial weights: the loss and the whole tables."""
    from recbole_fairrec_tpu_torch import Config
    from recbole_fairrec_tpu_torch.models.focf import FOCF
    from recbole_fairrec_tpu_torch.trainer import Trainer
    from recbole_fairrec_tpu_torch.utils.jax_params import load_jax_params, to_jax_params

    config = Config(model="FOCF", dataset="focf-step", config_dict={
        "use_gpu": False, "data_path": spec["tmp"], "embedding_size": 16,
        "sst_attr_list": ["gender"], "fair_weight": 1.0, "fair_objective": "value",
        "learner": "adam", "learning_rate": 1e-3, "weight_decay": 0.0,
        "checkpoint_dir": os.path.join(spec["tmp"], "focf-step"),
        "mesh_shape": spec["focf_mesh"],
    })
    model = FOCF(config, _FocfData(inputs))
    load_jax_params(model, inputs["focf_params"])
    trainer = Trainer(config, model)
    batch = {k: torch.from_numpy(v) for k, v in inputs["focf_batch"].items()}
    loss = trainer._train_step(batch, "calculate_loss", None, trainer.optimizer)
    params = to_jax_params(model)
    return {"loss": float(loss), "user_embedding": params["user_embedding"],
            "item_embedding": params["item_embedding"],
            "local_rows": model.user_embedding.weight.shape[0]}


def pfcn_steps(spec, inputs):
    """A PFCN_PMF ``sm`` filter step, then a discriminator step, on the
    test's batch (with weight-0 pad rows) under the spec's mesh; the losses,
    the parameters and the BatchNorm statistics after each."""
    from recbole_fairrec_tpu_torch.utils.jax_params import to_jax_params, to_jax_state

    trainer = _build(spec["pfcn_config"], "PFCN_PMF", spec["pfcn_dataset"])
    batch = {k: torch.from_numpy(v) for k, v in inputs["pfcn_batch"].items()}
    sst = tuple(spec["pfcn_sst"])
    out = {}
    for loss_name, tag in (("calculate_loss", "filter"), ("calculate_dis_loss", "dis")):
        loss = trainer._train_step(dict(batch), loss_name, sst, trainer._tx_by_tag(tag))
        out[tag] = {"loss": float(loss), "params": to_jax_params(trainer.model),
                    "state": to_jax_state(trainer.model)}
    return out


def model_steps(spec, inputs):
    """For each model of the spec (name, model, config, stage, steps): a
    fresh trainer under the config's mesh, in ``stage`` where given, then
    each step (loss, optimizer tag, attribute subset) on the test's batch;
    the loss, the parameters and the BatchNorm statistics after each, and
    which tables are row-sharded (and over how many ranks)."""
    from recbole_fairrec_tpu_torch.utils.jax_params import to_jax_params, to_jax_state

    out = {}
    for name, model, cfg, stage, steps in spec["model_steps"]:
        print(f"model_steps: {name}", file=sys.stderr, flush=True)
        trainer = _build(cfg, model, spec["steps_dataset"])
        if stage:
            trainer.model.train_stage = stage
        batch = {k: torch.from_numpy(v) for k, v in inputs[f"steps_{name}"].items()}
        res = []
        for loss_name, tag, sst in steps:
            loss = trainer._train_step(dict(batch), loss_name, tuple(sst) if sst else None,
                                       trainer._tx_by_tag(tag))
            res.append({"loss": float(loss), "params": to_jax_params(trainer.model),
                        "state": to_jax_state(trainer.model)})
        out[name] = {"steps": res, "row_shards": {
            k: v.rows // (v.hi - v.lo) for k, v in trainer.model.row_shards.items()}}
    return out


def _build(cfg, model_name, dataset):
    from recbole_fairrec_tpu_torch import Config
    from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
    from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed

    config = Config(model=model_name, dataset=dataset, config_dict=cfg)
    init_seed(config["seed"], config["reproducibility"])
    ds = create_dataset(config)
    train_data, _, _ = data_preparation(config, ds)
    generator = init_seed(config["seed"], config["reproducibility"])
    model = get_model(model_name)(config, train_data.dataset, generator=generator)
    return get_trainer(config["MODEL_TYPE"], model_name)(config, model)


# ------------------------------------------------------------- whole runs


def runs(spec, inputs):
    """``run_recbole`` of each run of the spec (name, model, dataset,
    config); the result dicts, the evaluation path, the checkpoint and the
    test dict of that checkpoint read back by ``load_data_and_model`` (under
    the mesh its config names)."""
    from recbole_fairrec_tpu_torch import load_data_and_model, run_recbole
    from recbole_fairrec_tpu_torch.trainer import Trainer

    out = {}
    init = Trainer.__init__
    for name, model, dataset, cfg in spec["runs"]:
        seen = []

        def spy(self, *a, **k):
            seen.append(self)
            init(self, *a, **k)

        Trainer.__init__ = spy
        try:
            res = run_recbole(model=model, dataset=dataset, config_dict=cfg)
        finally:
            Trainer.__init__ = init
        trainer = seen[-1]
        _, _, again, _, _, _, test_data = load_data_and_model(trainer.saved_model_file,
                                                              {"use_gpu": False})
        shards = trainer.model.row_shards
        out[name] = {"test": dict(res["test_result"]),
                     "valid": dict(res["best_valid_result"] or {}),
                     "path": trainer._last_eval_path,
                     "checkpoint": trainer.saved_model_file,
                     "reloaded": dict(again.evaluate(test_data)),
                     "reloaded_mesh": dict(again.mesh.shape),
                     "mesh": dict(trainer.mesh.shape),
                     "row_shards": {k: s.rows // (s.hi - s.lo) for k, s in shards.items()}}
    return out


def startup(spec, inputs):
    """The world as ``init_multihost`` made it: its size, the sum of the
    ranks, and the backend."""
    t = torch.tensor([float(dist.get_rank())])
    dist.all_reduce(t)
    return {"world": dist.get_world_size(), "rank_sum": float(t), "backend": dist.get_backend()}


SCENARIOS = {"lookup": lookup, "topk": topk, "propagate": propagate, "focf_step": focf_step,
             "pfcn_steps": pfcn_steps, "model_steps": model_steps, "runs": runs,
             "startup": startup}


def main():
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank = int(sys.argv[2])
    # a rank that hangs prints where every thread is, and exits
    faulthandler.dump_traceback_later(spec.get("hang_s", 150), exit=True)
    torch.set_num_threads(1)
    os.chdir(spec["tmp"])  # trainers write log_tensorboard/ under the current directory
    store = "file://" + spec["store"]
    if spec.get("init") == "multihost":
        from recbole_fairrec_tpu_torch.quick_start import init_multihost

        assert init_multihost({"multihost": True, "coordinator_address": store,
                               "num_processes": spec["world"], "process_id": rank,
                               "use_gpu": False})
    else:
        dist.init_process_group("gloo", init_method=store, rank=rank,
                                world_size=spec["world"], timeout=TIMEOUT)
    with open(spec["inputs"], "rb") as f:
        inputs = pickle.load(f)
    results = {}
    for name in spec["scenarios"]:
        try:
            results[name] = SCENARIOS[name](spec, inputs)
        except Exception:  # noqa: BLE001  (the test prints the trace)
            print(f"scenario {name} failed:\n{traceback.format_exc()}", file=sys.stderr,
                  flush=True)
            os._exit(3)  # the other ranks may wait in a collective: the test ends them
        dist.barrier()
    with open(os.path.join(spec["out"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
