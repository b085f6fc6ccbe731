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
    calculate_valid_score,
    dict2str,
    early_stopping,
    ensure_dir,
    get_local_time,
    init_seed,
    pickle_to,
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
    "calculate_valid_score",
    "dict2str",
    "early_stopping",
    "ensure_dir",
    "get_local_time",
    "init_seed",
    "pickle_to",
    "set_color",
    "init_logger",
    "get_model",
    "get_trainer",
]
