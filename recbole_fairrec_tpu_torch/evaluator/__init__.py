from .base_metric import AbstractMetric, LossMetric, TopkMetric
from .collector import Collector, DataStruct
from .evaluator import Evaluator
from .register import Register, metric_information, metric_types, metrics_dict, smaller_metrics

__all__ = [
    "AbstractMetric",
    "LossMetric",
    "TopkMetric",
    "Collector",
    "DataStruct",
    "Evaluator",
    "Register",
    "metric_information",
    "metric_types",
    "metrics_dict",
    "smaller_metrics",
]
