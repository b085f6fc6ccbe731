"""Public entry points.

Counterpart of ``recbole_fairrec_tpu/quick_start.py``. ``run_recbole``
trains a model from a config, reloads the best checkpoint and tests it;
``objective_function`` is one such trial for a hyperparameter search. The
serving entry point is ``load_data_and_model(model_file)`` followed by
``trainer.evaluate(test_data)``; it reads checkpoints written by this
package or by the JAX package. Every entry point runs on the card unless
the config says ``use_gpu: False``. ``init_multihost`` starts
``torch.distributed`` for a run over several processes (``multihost:
True``); ``run_recbole`` calls it before anything else of the run, as the
JAX package's does.
"""

from __future__ import annotations

import logging
import os
import pickle
from logging import getLogger

from .config import Config
from .data import create_dataset, data_preparation
from .utils import get_model, get_trainer, init_logger, init_seed, set_color

_JAX_PACKAGE = "recbole_fairrec_tpu"
_PORT_PACKAGE = "recbole_fairrec_tpu_torch"
# libraries of the JAX stack whose objects a JAX checkpoint may hold (the
# optimizer state); serving never reads them, so they load as inert tuples
_FOREIGN_ROOTS = ("optax", "jax", "jaxlib", "flax", "chex")


class _ForeignObject(tuple):
    """Stand-in for an object of a library the port does not import: keeps
    the constructor arguments (and state, if any) and nothing else."""

    def __new__(cls, *args):
        return super().__new__(cls, args)

    def __setstate__(self, state):
        self.__dict__["state"] = state


class _CheckpointUnpickler(pickle.Unpickler):
    """Maps ``recbole_fairrec_tpu.*`` classes onto their port counterparts
    and JAX-stack classes onto :class:`_ForeignObject`, so a JAX-written
    checkpoint loads without importing JAX."""

    _foreign = {}

    def find_class(self, module, name):
        if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + "."):
            module = _PORT_PACKAGE + module[len(_JAX_PACKAGE):]
        elif module.split(".")[0] in _FOREIGN_ROOTS:
            key = f"{module}.{name}"
            if key not in self._foreign:
                self._foreign[key] = type(name, (_ForeignObject,), {"__module__": module})
            return self._foreign[key]
        return super().find_class(module, name)


def load_checkpoint(model_file):
    """Read a checkpoint written by either package (a pickle: load only
    files this program or the JAX package wrote)."""
    with open(model_file, "rb") as f:
        return _CheckpointUnpickler(f).load()


def init_multihost(config_dict=None):
    """Start the default process group of a run over several processes, one
    per device; the counterpart of the JAX package's
    ``jax.distributed.initialize`` bootstrap, with its return contract.

    Off (False) unless ``config_dict['multihost']`` is set; a no-op (True)
    where the group already exists. ``coordinator_address`` ``"host:port"``
    becomes ``tcp://host:port`` (an address with a scheme, such as
    ``file://<path>``, is used as it is), ``num_processes`` the world size
    and ``process_id`` the rank; without a coordinator the group reads
    torchrun's environment (``env://``). The backend is NCCL on the card,
    with ``LOCAL_RANK`` (else the rank) choosing the card, and gloo under
    ``use_gpu: False``. A failure is ``torch.distributed``'s own error.
    """
    cfg = config_dict or {}
    if not cfg.get("multihost"):
        return False
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    kwargs = {"init_method": "env://"}
    address = cfg.get("coordinator_address")
    if address is not None:
        kwargs["init_method"] = address if "://" in address else f"tcp://{address}"
        kwargs["world_size"] = cfg.get("num_processes")
        kwargs["rank"] = cfg.get("process_id")
    cpu = cfg.get("use_gpu") is False
    if not cpu:
        local = os.environ.get("LOCAL_RANK", kwargs.get("rank") or 0)
        torch.cuda.set_device(int(local) % torch.cuda.device_count())
    dist.init_process_group("gloo" if cpu else "nccl", **kwargs)
    return True


def _train_and_test(config, saved, verbose, callback_fn=None):
    """Data → model → trainer → fit → test, shared by the two training
    entry points."""
    dataset = create_dataset(config)
    getLogger().info(dataset)
    train_data, valid_data, test_data = data_preparation(config, dataset)

    generator = init_seed(config["seed"], config["reproducibility"])
    model_obj = get_model(config["model"])(config, train_data.dataset, generator=generator)
    getLogger().info(model_obj)
    trainer = get_trainer(config["MODEL_TYPE"], config["model"])(config, model_obj)

    best_valid_score, best_valid_result = trainer.fit(
        train_data, valid_data, verbose=verbose, saved=saved,
        show_progress=config["show_progress"], callback_fn=callback_fn,
    )
    test_result = trainer.evaluate(
        test_data, load_best_model=saved, show_progress=config["show_progress"]
    )
    return {
        "best_valid_score": best_valid_score,
        "valid_score_bigger": config["valid_metric_bigger"],
        "best_valid_result": best_valid_result,
        "test_result": test_result,
    }


def run_recbole(model=None, dataset=None, config_file_list=None, config_dict=None,
                saved=True, callback_fn=None):
    """Train and test a model from config (after ``init_multihost``).

    ``callback_fn(epoch_idx, valid_score)`` is forwarded to ``Trainer.fit``
    (a hook after every validation).

    Returns a dict with best_valid_score / valid_score_bigger /
    best_valid_result / test_result.
    """
    config = Config(
        model=model, dataset=dataset, config_file_list=config_file_list, config_dict=config_dict
    )
    # the resolved config, so that --multihost=True on the command line counts too
    init_multihost(config.final_config_dict)
    init_seed(config["seed"], config["reproducibility"])
    init_logger(config)
    logger = getLogger()
    logger.info(config)

    result = _train_and_test(config, saved, verbose=True, callback_fn=callback_fn)
    logger.info(set_color("best valid ", "yellow") + f": {result['best_valid_result']}")
    logger.info(set_color("test result", "yellow") + f": {result['test_result']}")
    return result


def objective_function(config_dict=None, config_file_list=None, saved=True):
    """One train+test trial for hyperparameter search (``multihost`` is not
    read, as in the JAX package)."""
    config = Config(config_dict=config_dict, config_file_list=config_file_list)
    init_seed(config["seed"], config["reproducibility"])
    logging.basicConfig(level=logging.ERROR)
    return {"model": config["model"], **_train_and_test(config, saved, verbose=False)}


def load_data_and_model(model_file, config_dict=None):
    """Rebuild (config, model, trainer, dataset, loaders) from a checkpoint.

    ``config_dict`` overrides saved settings (e.g. ``use_gpu: False``,
    ``streaming_eval``).
    """
    checkpoint = load_checkpoint(model_file)
    saved_cfg = dict(checkpoint["config"])
    # data_path was already joined with the dataset name when the checkpoint
    # was written; Config would join again
    saved_cfg["data_path"] = os.path.dirname(saved_cfg["data_path"])
    for key in ("device", "backend"):
        saved_cfg.pop(key, None)
    saved_cfg.update(config_dict or {})
    config = Config(config_dict=saved_cfg)
    init_seed(config["seed"], config["reproducibility"])
    init_logger(config)
    logger = getLogger()
    logger.info(config)

    dataset = create_dataset(config)
    logger.info(dataset)
    train_data, valid_data, test_data = data_preparation(config, dataset)

    generator = init_seed(config["seed"], config["reproducibility"])
    model_obj = get_model(config["model"])(config, train_data.dataset, generator=generator)
    trainer = get_trainer(config["MODEL_TYPE"], config["model"])(config, model_obj)
    trainer._load_params_from_checkpoint(checkpoint)
    trainer.saved_model_file = str(model_file)
    # eval-only flows never run fit(), which is what normally feeds the
    # collector its train-side resources (num_items, popularity counters)
    trainer.eval_collector.data_collect(train_data)

    return config, model_obj, trainer, dataset, train_data, valid_data, test_data
