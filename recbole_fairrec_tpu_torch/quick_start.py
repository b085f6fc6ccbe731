"""Public entry points.

Counterpart of ``recbole_fairrec_tpu/quick_start.py``. The serving entry
point is ``load_data_and_model(model_file)`` followed by
``trainer.evaluate(test_data)``; it reads checkpoints written by this
package or by the JAX package. ``run_recbole`` and ``objective_function``
train, and come with the training slice of the port.
"""

from __future__ import annotations

import os
import pickle
from logging import getLogger

from .config import Config
from .data import create_dataset, data_preparation
from .utils import get_model, get_trainer, init_logger, init_seed

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
