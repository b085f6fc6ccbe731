"""Set-up shared by the cells of a PFCN_PMF configuration on ML-1M-scale
data: the data written from the seed, the program's ``Config``, dataset,
loaders, model and trainer as ``run_recbole`` builds them, and the
benchmark's initial weights loaded into the model."""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from . import ml1m
from .seeds import derive


@dataclass
class System:
    config: object
    dataset: object
    train: object
    valid: object
    model: object
    trainer: object
    spec: object
    labels: dict
    model_seed: int
    weight_seed: int


def program_config(run, dataset_name, extra=None):
    """The program's ``Config`` for the run's configuration file."""
    from recbole_fairrec_tpu_torch import Config

    cfg = run.config
    settings = dict(cfg["settings"])
    settings.update({
        "data_path": run.work_dir,
        "checkpoint_dir": os.path.join(run.work_dir, "saved"),
        "log_root": os.path.join(run.work_dir, "log"),
        "seed": derive(run.seed, "program"),
        "use_gpu": run.device.type == "cuda",
        "show_progress": False,
        "state": "WARNING",
        "save_dataset": False,
        "save_dataloaders": False,
        **(extra or {}),
    })
    return Config(model=cfg["model"], dataset=dataset_name, config_dict=settings)


def reference_spec(cfg, n_users, n_items, classes):
    from reference.mf_train import Spec

    s = cfg["settings"]
    return Spec(n_users, n_items, s["embedding_size"], s["filter_mode"],
                {a: classes[a][1] for a in s.get("sst_attr_list", [])},
                s.get("dis_hidden_size_list", ()), s.get("dis_dropout", 0.0),
                s.get("dis_weight", 0.0), s["learning_rate"], s["weight_decay"])


def build(run):
    """Data, loaders, model and trainer of the run's configuration, with the
    benchmark's initial weights."""
    from recbole_fairrec_tpu_torch.data import create_dataset, data_preparation
    from recbole_fairrec_tpu_torch.utils import get_model, get_trainer, init_seed
    from reference.mf_train import initial_state

    cfg = run.config
    data = cfg["data"]
    _, items, _ = ml1m.write(run.work_dir, data["name"], data, derive(run.seed, "data"))
    config = program_config(run, data["name"])
    init_seed(config["seed"], config["reproducibility"])
    dataset = create_dataset(config)
    train, valid, _ = data_preparation(config, dataset)
    model = get_model(cfg["model"])(config, train.dataset)
    trainer = get_trainer(config["MODEL_TYPE"], cfg["model"])(config, model)
    attrs = cfg["settings"].get("sst_attr_list", [])
    classes = ml1m.attribute_classes(data, attrs)
    n_users = len(ml1m.read_users(data)["user_id"]) + 1
    n_items = len(np.unique(items)) + 1
    spec = reference_spec(cfg, n_users, n_items, classes)
    weight_seed = derive(run.seed, "weights")
    with torch.no_grad():
        model.load_state_dict(initial_state(spec, weight_seed, run.device), strict=True)
    labels = {a: torch.from_numpy(classes[a][0]).to(run.device) for a in attrs}
    return System(config, dataset, train, valid, model, trainer, spec, labels,
                  int(config["seed"]), weight_seed)
