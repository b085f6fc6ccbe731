"""Metric base classes (host numpy).

Counterpart of ``recbole_fairrec_tpu/evaluator/base_metric.py``: TopkMetric
splits the collected ``rec.topk`` matrix into a bool hit matrix plus per-user
positive counts and averages per-user curves at each configured k;
LossMetric consumes (rec.score, data.label) pairs.
"""

from __future__ import annotations

import numpy as np

from ..utils import EvaluatorType


class AbstractMetric:
    smaller = False

    def __init__(self, config):
        self.decimal_place = config["metric_decimal_place"]

    def calculate_metric(self, dataobject):
        raise NotImplementedError("Method [calculate_metric] should be implemented.")


class TopkMetric(AbstractMetric):
    metric_type = EvaluatorType.RANKING
    metric_need = ["rec.topk"]

    def __init__(self, config):
        super().__init__(config)
        self.topk = config["topk"]

    def used_info(self, dataobject):
        rec_mat = np.asarray(dataobject.get("rec.topk"))
        topk_idx, pos_len_list = rec_mat[:, :-1], rec_mat[:, -1]
        return topk_idx.astype(bool), pos_len_list

    def topk_result(self, metric, value):
        metric_dict = {}
        avg_result = value.mean(axis=0)
        for k in self.topk:
            key = f"{metric}@{k}"
            metric_dict[key] = round(float(avg_result[k - 1]), self.decimal_place)
        return metric_dict

    def metric_info(self, pos_index, pos_len=None):
        raise NotImplementedError(
            "Method [metric_info] of top-k metric should be implemented."
        )


def _squeeze_last(values):
    values = np.asarray(values)
    return values.squeeze(-1) if values.ndim and values.shape[-1] == 1 else values


class LossMetric(AbstractMetric):
    metric_type = EvaluatorType.VALUE
    metric_need = ["rec.score", "data.label"]

    def __init__(self, config):
        super().__init__(config)

    def used_info(self, dataobject):
        # the last axis goes only where it has size 1 (torch's squeeze(-1),
        # which the reference calls): the labeled path collects [N] scores,
        # on which numpy's squeeze(-1) raises
        preds = _squeeze_last(dataobject.get("rec.score"))
        trues = _squeeze_last(dataobject.get("data.label"))
        return preds, trues

    def output_metric(self, metric, dataobject):
        preds, trues = self.used_info(dataobject)
        result = self.metric_info(preds, trues)
        return {metric: round(float(result), self.decimal_place)}

    def metric_info(self, preds, trues):
        raise NotImplementedError(
            "Method [metric_info] of loss-based metric should be implemented."
        )
