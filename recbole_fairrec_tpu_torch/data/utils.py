"""Dataset/dataloader factory functions.

Counterpart of ``recbole_fairrec_tpu/data/utils.py``: pickle caches for the
filtered dataset and the split loaders (invalidated when a dataset argument
changes; the file names end in ``-torch.pkl`` so the two packages never
read each other's caches), phase-accumulating sampler creation and the
loader classes by model and evaluation mode: full-sort, sampled
(``uni100``/``pop100``) and labeled evaluation, and FOCF's item-grouped
train loader.
"""

from __future__ import annotations

import os
import pickle
from logging import getLogger

from ..sampler import RepeatableSampler, Sampler
from ..utils import ensure_dir, pickle_to, set_color
from .dataloader import (
    AbstractDataLoader,
    FOCFDataLoader,
    FullSortEvalDataLoader,
    NegSampleEvalDataLoader,
    TrainDataLoader,
    UserDataLoader,
)
from .dataset import Dataset

# config keys whose change invalidates a cached dataset
_DATASET_ARGS = [
    "field_separator", "seq_separator", "USER_ID_FIELD", "ITEM_ID_FIELD",
    "RATING_FIELD", "TIME_FIELD", "LABEL_FIELD", "threshold", "NEG_PREFIX",
    "load_col", "unload_col", "unused_col", "additional_feat_suffix",
    "rm_dup_inter", "val_interval", "filter_inter_by_user_or_item",
    "user_inter_num_interval", "item_inter_num_interval", "alias_of_user_id",
    "alias_of_item_id", "preload_weight", "normalize_field", "normalize_all",
    "benchmark_filename",
]


def create_dataset(config) -> Dataset:
    default_file = os.path.join(
        config["checkpoint_dir"], f'{config["dataset"]}-Dataset-torch.pkl'
    )
    file = config["dataset_save_path"] or default_file
    if os.path.exists(file):
        with open(file, "rb") as f:
            dataset = pickle.load(f)
        unchanged = isinstance(dataset, Dataset) and all(
            config[arg] == dataset.config[arg] for arg in _DATASET_ARGS + ["seed", "repeatable"]
        )
        if unchanged:
            getLogger().info(set_color("Load filtered dataset from", "pink") + f": [{file}]")
            dataset.config = config
            return dataset

    dataset = Dataset(config)
    if config["save_dataset"]:
        dataset.save()
    return dataset


def save_split_dataloaders(config, dataloaders):
    ensure_dir(config["checkpoint_dir"])
    path = os.path.join(
        config["checkpoint_dir"], f'{config["dataset"]}-for-{config["model"]}-dataloader-torch.pkl'
    )
    getLogger().info(set_color("Saving split dataloaders into", "pink") + f": [{path}]")
    pickle_to(path, dataloaders)


def load_split_dataloaders(config):
    default_file = os.path.join(
        config["checkpoint_dir"], f'{config["dataset"]}-for-{config["model"]}-dataloader-torch.pkl'
    )
    path = config["dataloaders_save_path"] or default_file
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        loaders = pickle.load(f)
    if not all(isinstance(d, AbstractDataLoader) for d in loaders):
        return None
    train_data, valid_data, test_data = loaders
    for arg in _DATASET_ARGS + ["seed", "repeatable", "eval_args"]:
        if config[arg] != train_data.config[arg]:
            return None
    train_data.update_config(config)
    valid_data.update_config(config)
    test_data.update_config(config)
    getLogger().info(set_color("Load split dataloaders from", "pink") + f": [{path}]")
    return train_data, valid_data, test_data


def data_preparation(config, dataset):
    """Build → sample → wrap into (train, valid, test) dataloaders."""
    dataloaders = load_split_dataloaders(config)
    if dataloaders is not None:
        train_data, valid_data, test_data = dataloaders
    else:
        built_datasets = dataset.build()
        train_dataset, valid_dataset, test_dataset = built_datasets
        train_sampler, valid_sampler, test_sampler = create_samplers(
            config, dataset, built_datasets
        )
        train_data = get_dataloader(config, "train")(
            config, train_dataset, train_sampler, shuffle=True
        )
        valid_data = get_dataloader(config, "evaluation")(
            config, valid_dataset, valid_sampler, shuffle=False
        )
        test_data = get_dataloader(config, "evaluation")(
            config, test_dataset, test_sampler, shuffle=False
        )
        if config["save_dataloaders"]:
            save_split_dataloaders(config, dataloaders=(train_data, valid_data, test_data))

    logger = getLogger()
    logger.info(
        set_color("[Training]: ", "pink")
        + set_color("train_batch_size", "cyan")
        + f' = [{config["train_batch_size"]}] negative sampling: [{config["neg_sampling"]}]'
    )
    logger.info(
        set_color("[Evaluation]: ", "pink")
        + set_color("eval_batch_size", "cyan")
        + f' = [{config["eval_batch_size"]}] eval_args: [{config["eval_args"]}]'
    )
    return train_data, valid_data, test_data


def _eval_loader_class(config):
    strategy = config["eval_neg_sample_args"]["strategy"]
    if strategy in ("none", "by"):
        return NegSampleEvalDataLoader
    if strategy == "full":
        return FullSortEvalDataLoader
    raise ValueError(f"eval strategy [{strategy}] not supported")


def get_dataloader(config, phase):
    register_table = {"FOCF": _get_FOCF_dataloader}
    if config["model"] in register_table:
        return register_table[config["model"]](config, phase)
    if phase == "train":
        return TrainDataLoader
    return _eval_loader_class(config)


def _get_AE_dataloader(config, phase):
    if phase == "train":
        return UserDataLoader
    return _eval_loader_class(config)


def _get_FOCF_dataloader(config, phase):
    if phase == "train":
        return FOCFDataLoader
    return _eval_loader_class(config)


def create_samplers(config, dataset, built_datasets):
    phases = ["train", "valid", "test"]
    train_args = config["train_neg_sample_args"]
    eval_args = config["eval_neg_sample_args"]
    sampler = None
    train_sampler = valid_sampler = test_sampler = None

    if train_args["strategy"] != "none":
        if not config["repeatable"]:
            sampler = Sampler(phases, built_datasets, train_args["distribution"])
        else:
            sampler = RepeatableSampler(phases, dataset, train_args["distribution"])
        train_sampler = sampler.set_phase("train")

    if eval_args["strategy"] != "none":
        if sampler is None:
            if not config["repeatable"]:
                sampler = Sampler(phases, built_datasets, eval_args["distribution"])
            else:
                sampler = RepeatableSampler(phases, dataset, eval_args["distribution"])
        else:
            sampler.set_distribution(eval_args["distribution"])
        valid_sampler = sampler.set_phase("valid")
        test_sampler = sampler.set_phase("test")

    return train_sampler, valid_sampler, test_sampler
