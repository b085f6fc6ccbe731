"""Evaluator: instantiate configured metrics, run them over a DataStruct.

Counterpart of ``recbole_fairrec_tpu/evaluator/evaluator.py``.
"""

from __future__ import annotations

from collections import OrderedDict

from ..utils import tracing
from .register import metrics_dict


class Evaluator:
    def __init__(self, config):
        self.config = config
        self.metrics = [metric.lower() for metric in self.config["metrics"]]
        self.metric_class = {
            metric: metrics_dict[metric](self.config) for metric in self.metrics
        }

    @tracing.traced("evaluator.run")
    def evaluate(self, dataobject) -> OrderedDict:
        result_dict = OrderedDict()
        for metric in self.metrics:
            with tracing.span("evaluator.metric") as sp:
                sp.set("metric", metric)
                metric_val = self.metric_class[metric].calculate_metric(dataobject)
            result_dict.update(metric_val)
        return result_dict
