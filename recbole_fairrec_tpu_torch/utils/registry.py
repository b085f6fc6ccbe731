"""Model / trainer registries.

Counterpart of ``recbole_fairrec_tpu/utils/registry.py``: models resolve by
importing ``models.<name.lower()>`` and fetching the class of that name;
trainers resolve ``<ModelName>Trainer`` (``PFCN_PMFTrainer`` for PFCN_PMF)
with a fallback to the base ``Trainer`` (FOCF and NFCF train with it, as
in the JAX package).
"""

from __future__ import annotations

import importlib

_MODEL_MODULE_ROOT = "recbole_fairrec_tpu_torch.models"
_TRAINER_MODULE = "recbole_fairrec_tpu_torch.trainer"


def get_model(model_name: str):
    """Resolve a model class by name.

    Raises:
        ValueError: when the port has no model of that name.
    """
    module_path = f"{_MODEL_MODULE_ROOT}.{model_name.lower()}"
    try:
        module = importlib.import_module(module_path)
    except ModuleNotFoundError as e:
        raise ValueError(
            f"`model_name` [{model_name}] is not the name of an existing model."
        ) from e
    if not hasattr(module, model_name):
        raise ValueError(
            f"module [{module_path}] exists but lacks class [{model_name}]"
        )
    return getattr(module, model_name)


def get_trainer(model_type, model_name: str):
    """Resolve ``<ModelName>Trainer``, falling back to the base Trainer."""
    trainer_mod = importlib.import_module(_TRAINER_MODULE)
    name = f"{model_name}Trainer"
    if hasattr(trainer_mod, name):
        return getattr(trainer_mod, name)
    return getattr(trainer_mod, "Trainer")
