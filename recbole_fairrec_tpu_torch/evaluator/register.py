"""Metric registry via module introspection.

Counterpart of ``recbole_fairrec_tpu/evaluator/register.py``: ``cluster_info``
scans the metrics module for AbstractMetric subclasses producing
``metrics_dict``, ``metric_information`` (resource needs), ``metric_types``
and ``smaller_metrics``; :class:`Register` turns a config's metric list into
need-flags for the Collector.
"""

from __future__ import annotations

import inspect

from . import metrics as metrics_module
from .base_metric import AbstractMetric


def cluster_info(module):
    smaller_m = []
    m_dict, m_info, m_types = {}, {}, {}
    for name, cls in inspect.getmembers(module, inspect.isclass):
        if not issubclass(cls, AbstractMetric) or cls.__name__.startswith("_"):
            continue
        if cls in (AbstractMetric,) or inspect.isabstract(cls):
            continue
        name_lower = name.lower()
        m_dict[name_lower] = cls
        if hasattr(cls, "metric_need"):
            m_info[name_lower] = cls.metric_need
        if getattr(cls, "smaller", False):
            smaller_m.append(name_lower)
        if hasattr(cls, "metric_type"):
            m_types[name_lower] = cls.metric_type
    return smaller_m, m_dict, m_info, m_types


smaller_metrics, metrics_dict, metric_information, metric_types = cluster_info(metrics_module)

# scaffolding bases are not user-selectable metrics
for _base in ("abstractmetric", "topkmetric", "lossmetric", "_yaohuangunfairness"):
    metrics_dict.pop(_base, None)
    metric_types.pop(_base, None)


class Register:
    """Need-flag accumulator for the configured metric list."""

    def __init__(self, config):
        self.config = config
        self.metrics = [m.lower() for m in self.config["metrics"]]
        self._build_register()

    def _build_register(self):
        for metric in self.metrics:
            if metric not in metric_information:
                raise ValueError(f"Metric {metric} not be registered correctly")
            for info in metric_information[metric]:
                setattr(self, info, True)

    def has_metric(self, metric: str) -> bool:
        return metric.lower() in self.metrics

    def need(self, key: str) -> bool:
        if hasattr(self, key):
            return getattr(self, key)
        return False
