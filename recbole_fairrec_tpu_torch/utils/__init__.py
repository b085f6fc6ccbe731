from .enums import (
    EvaluatorType,
    FeatureSource,
    FeatureType,
    InputType,
    KGDataLoaderState,
    ModelType,
)
from .common import (
    _bucket,
    dict2str,
    ensure_dir,
    get_local_time,
    init_seed,
    set_color,
)
from .logger import init_logger
from .registry import get_model, get_trainer

__all__ = [
    "EvaluatorType",
    "FeatureSource",
    "FeatureType",
    "InputType",
    "KGDataLoaderState",
    "ModelType",
    "_bucket",
    "dict2str",
    "ensure_dir",
    "get_local_time",
    "init_seed",
    "set_color",
    "init_logger",
    "get_model",
    "get_trainer",
]
