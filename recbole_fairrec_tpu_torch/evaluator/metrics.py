"""Metrics catalog — 22 metric classes (host numpy).

Copy of ``recbole_fairrec_tpu/evaluator/metrics.py``: the same class names,
metric keys and formulas, computed in float64 on the host from the collected
payloads.
"""

from __future__ import annotations

from logging import getLogger

import numpy as np

from ..utils import EvaluatorType
from .base_metric import AbstractMetric, LossMetric, TopkMetric
from .utils import _binary_clf_curve


# ----------------------------------------------------------------- topk

class Hit(TopkMetric):
    """Truncated hit ratio (reference :40-65)."""

    def calculate_metric(self, dataobject):
        pos_index, _ = self.used_info(dataobject)
        result = self.metric_info(pos_index)
        return self.topk_result("hit", result)

    def metric_info(self, pos_index):
        result = np.cumsum(pos_index, axis=1)
        return (result > 0).astype(int)


class MRR(TopkMetric):
    """Mean reciprocal rank of the first hit (reference :68-97)."""

    def calculate_metric(self, dataobject):
        pos_index, _ = self.used_info(dataobject)
        result = self.metric_info(pos_index)
        return self.topk_result("mrr", result)

    def metric_info(self, pos_index):
        n_users, k = pos_index.shape
        first_hit = pos_index.argmax(axis=1)
        has_hit = pos_index[np.arange(n_users), first_hit] > 0
        cols = np.arange(k)[None, :]
        rr = np.where(has_hit[:, None], 1.0 / (first_hit[:, None] + 1), 0.0)
        return np.where(cols >= first_hit[:, None], rr, 0.0)


class MAP(TopkMetric):
    """Mean average precision with min(|R|,K) normalization (reference :100-137)."""

    def calculate_metric(self, dataobject):
        pos_index, pos_len = self.used_info(dataobject)
        result = self.metric_info(pos_index, pos_len)
        return self.topk_result("map", result)

    def metric_info(self, pos_index, pos_len):
        n_users, k = pos_index.shape
        pre = pos_index.cumsum(axis=1) / np.arange(1, k + 1)
        sum_pre = np.cumsum(pre * pos_index.astype(np.float64), axis=1)
        actual_len = np.minimum(pos_len, k).astype(np.int64)
        # denominator ranges: 1..K but clamped at the user's actual_len
        ranges = np.minimum(np.arange(1, k + 1)[None, :], np.maximum(actual_len, 1)[:, None])
        return sum_pre / ranges


class Recall(TopkMetric):
    """(reference :140-161)."""

    def calculate_metric(self, dataobject):
        pos_index, pos_len = self.used_info(dataobject)
        result = self.metric_info(pos_index, pos_len)
        return self.topk_result("recall", result)

    def metric_info(self, pos_index, pos_len):
        return np.cumsum(pos_index, axis=1) / pos_len.reshape(-1, 1)


class NDCG(TopkMetric):
    """log2-discounted nDCG with per-user idcg truncation (reference :164-203)."""

    def calculate_metric(self, dataobject):
        pos_index, pos_len = self.used_info(dataobject)
        result = self.metric_info(pos_index, pos_len)
        return self.topk_result("ndcg", result)

    def metric_info(self, pos_index, pos_len):
        n_users, k = pos_index.shape
        idcg_len = np.minimum(pos_len, k).astype(np.int64)

        ranks = np.tile(np.arange(1, k + 1), (n_users, 1)).astype(np.float64)
        idcg_curve = np.cumsum(1.0 / np.log2(ranks + 1), axis=1)
        # clamp each user's idcg at its truncation point
        col = np.arange(k)[None, :]
        clamp_at = np.maximum(idcg_len - 1, 0)[:, None]
        idcg = np.where(
            col >= idcg_len[:, None],
            np.take_along_axis(idcg_curve, clamp_at, axis=1),
            idcg_curve,
        )
        dcg = np.cumsum(np.where(pos_index, 1.0 / np.log2(ranks + 1), 0.0), axis=1)
        return dcg / idcg


class Precision(TopkMetric):
    """(reference :206-228)."""

    def calculate_metric(self, dataobject):
        pos_index, _ = self.used_info(dataobject)
        result = self.metric_info(pos_index)
        return self.topk_result("precision", result)

    def metric_info(self, pos_index):
        return pos_index.cumsum(axis=1) / np.arange(1, pos_index.shape[1] + 1)


# ------------------------------------------------------------------ rank/AUC

class GAUC(AbstractMetric):
    """Grouped AUC from tie-averaged mean ranks (reference :234-309)."""

    metric_type = EvaluatorType.RANKING
    metric_need = ["rec.meanrank"]

    def __init__(self, config):
        super().__init__(config)

    def calculate_metric(self, dataobject):
        mean_rank = np.asarray(dataobject.get("rec.meanrank"))
        pos_rank_sum, user_len_list, pos_len_list = np.split(mean_rank, 3, axis=1)
        user_len_list = user_len_list.squeeze(-1)
        pos_len_list = pos_len_list.squeeze(-1)
        result = self.metric_info(pos_rank_sum, user_len_list, pos_len_list)
        return {"gauc": round(float(result), self.decimal_place)}

    def metric_info(self, pos_rank_sum, user_len_list, pos_len_list):
        neg_len_list = user_len_list - pos_len_list
        keep = np.full(len(user_len_list), True, dtype=bool)
        if np.any(pos_len_list == 0):
            getLogger().warning(
                "No positive samples in some users, "
                "true positive value should be meaningless, "
                "these users have been removed from GAUC calculation"
            )
            keep &= pos_len_list != 0
        if np.any(neg_len_list == 0):
            getLogger().warning(
                "No negative samples in some users, "
                "false positive value should be meaningless, "
                "these users have been removed from GAUC calculation"
            )
            keep &= neg_len_list != 0
        user_len_list, neg_len_list, pos_len_list, pos_rank_sum = (
            user_len_list[keep], neg_len_list[keep], pos_len_list[keep], pos_rank_sum[keep],
        )
        pair_num = (
            (user_len_list + 1) * pos_len_list
            - pos_len_list * (pos_len_list + 1) / 2
            - np.squeeze(pos_rank_sum)
        )
        user_auc = pair_num / (neg_len_list * pos_len_list)
        return (user_auc * pos_len_list).sum() / pos_len_list.sum()


class AUC(LossMetric):
    """Whole-set AUC via the trapezoid over the clf curve (reference :312-364)."""

    def calculate_metric(self, dataobject):
        return self.output_metric("auc", dataobject)

    def metric_info(self, preds, trues):
        fps, tps = _binary_clf_curve(trues, preds)
        if len(fps) > 2:
            optimal_idxs = np.where(
                np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
            )[0]
            fps, tps = fps[optimal_idxs], tps[optimal_idxs]
        tps = np.r_[0, tps]
        fps = np.r_[0, fps]
        if fps[-1] <= 0:
            getLogger().warning("No negative samples in y_true, false positive value should be meaningless")
            fpr = np.repeat(np.nan, fps.shape)
        else:
            fpr = fps / fps[-1]
        if tps[-1] <= 0:
            getLogger().warning("No positive samples in y_true, true positive value should be meaningless")
            tpr = np.repeat(np.nan, tps.shape)
        else:
            tpr = tps / tps[-1]
        return np.trapezoid(tpr, fpr)


# ---------------------------------------------------------------- loss-based

class MAE(LossMetric):
    smaller = True

    def calculate_metric(self, dataobject):
        return self.output_metric("mae", dataobject)

    def metric_info(self, preds, trues):
        return np.abs(trues - preds).mean()


class RMSE(LossMetric):
    smaller = True

    def calculate_metric(self, dataobject):
        return self.output_metric("rmse", dataobject)

    def metric_info(self, preds, trues):
        return np.sqrt(((trues - preds) ** 2).mean())


class LogLoss(LossMetric):
    smaller = True

    def calculate_metric(self, dataobject):
        return self.output_metric("logloss", dataobject)

    def metric_info(self, preds, trues):
        eps = 1e-15
        preds = np.clip(np.float64(preds), eps, 1 - eps)
        loss = np.sum(-trues * np.log(preds) - (1 - trues) * np.log(1 - preds))
        return loss / len(preds)


# ------------------------------------------------------------- item-centric

class ItemCoverage(AbstractMetric):
    """|∪ rec lists| / |I| (reference :438-481)."""

    metric_type = EvaluatorType.RANKING
    metric_need = ["rec.items", "data.num_items"]

    def __init__(self, config):
        super().__init__(config)
        self.topk = config["topk"]

    def used_info(self, dataobject):
        return np.asarray(dataobject.get("rec.items")), dataobject.get("data.num_items")

    def calculate_metric(self, dataobject):
        item_matrix, num_items = self.used_info(dataobject)
        metric_dict = {}
        for k in self.topk:
            metric_dict[f"itemcoverage@{k}"] = round(
                self.get_coverage(item_matrix[:, :k], num_items), self.decimal_place
            )
        return metric_dict

    def get_coverage(self, item_matrix, num_items):
        return np.unique(item_matrix).shape[0] / num_items


class AveragePopularity(AbstractMetric):
    """Mean train-popularity of recommended items (reference :484-550)."""

    metric_type = EvaluatorType.RANKING
    smaller = True
    metric_need = ["rec.items", "data.count_items"]

    def __init__(self, config):
        super().__init__(config)
        self.topk = config["topk"]

    def used_info(self, dataobject):
        item_counter = dataobject.get("data.count_items")
        item_matrix = np.asarray(dataobject.get("rec.items"))
        return item_matrix, dict(item_counter)

    def calculate_metric(self, dataobject):
        item_matrix, item_count = self.used_info(dataobject)
        value = self.get_pop(item_matrix, item_count)
        result = value.cumsum(axis=1) / np.arange(1, value.shape[1] + 1)
        avg_result = result.mean(axis=0)
        return {
            f"averagepopularity@{k}": round(float(avg_result[k - 1]), self.decimal_place)
            for k in self.topk
        }

    def get_pop(self, item_matrix, item_count):
        max_item = int(item_matrix.max()) + 1
        lut = np.zeros(max_item, dtype=np.float64)
        for item, cnt in item_count.items():
            if 0 <= item < max_item:
                lut[item] = cnt
        return lut[item_matrix]


class ShannonEntropy(AbstractMetric):
    """Entropy of the rec-list item distribution / #distinct (reference :553-605)."""

    metric_type = EvaluatorType.RANKING
    metric_need = ["rec.items"]

    def __init__(self, config):
        super().__init__(config)
        self.topk = config["topk"]

    def calculate_metric(self, dataobject):
        item_matrix = np.asarray(dataobject.get("rec.items"))
        return {
            f"shannonentropy@{k}": round(self.get_entropy(item_matrix[:, :k]), self.decimal_place)
            for k in self.topk
        }

    def get_entropy(self, item_matrix):
        _, counts = np.unique(item_matrix, return_counts=True)
        total_num = item_matrix.shape[0] * item_matrix.shape[1]
        p = counts / total_num
        return float((-p * np.log(p)).sum() / len(counts))


class GiniIndex(AbstractMetric):
    """Inequality of recommendation exposure (reference :608-661)."""

    metric_type = EvaluatorType.RANKING
    smaller = True
    metric_need = ["rec.items", "data.num_items"]

    def __init__(self, config):
        super().__init__(config)
        self.topk = config["topk"]

    def calculate_metric(self, dataobject):
        item_matrix = np.asarray(dataobject.get("rec.items"))
        num_items = dataobject.get("data.num_items")
        return {
            f"giniindex@{k}": round(self.get_gini(item_matrix[:, :k], num_items), self.decimal_place)
            for k in self.topk
        }

    def get_gini(self, item_matrix, num_items):
        _, counts = np.unique(item_matrix, return_counts=True)
        sorted_count = np.sort(counts)
        num_recommended = len(sorted_count)
        total_num = item_matrix.shape[0] * item_matrix.shape[1]
        idx = np.arange(num_items - num_recommended + 1, num_items + 1)
        gini = np.sum((2 * idx - num_items - 1) * sorted_count) / total_num
        return float(gini / num_items)


class TailPercentage(AbstractMetric):
    """Share of long-tail items in rec lists (reference :664-746)."""

    metric_type = EvaluatorType.RANKING
    metric_need = ["rec.items", "data.count_items"]

    def __init__(self, config):
        super().__init__(config)
        self.topk = config["topk"]
        self.tail = config["tail_ratio"]
        if self.tail is None or self.tail <= 0:
            self.tail = 0.1

    def calculate_metric(self, dataobject):
        item_matrix = np.asarray(dataobject.get("rec.items"))
        count_items = dict(dataobject.get("data.count_items"))
        value = self.get_tail(item_matrix, count_items)
        result = value.cumsum(axis=1) / np.arange(1, value.shape[1] + 1)
        avg_result = result.mean(axis=0)
        return {
            f"tailpercentage@{k}": round(float(avg_result[k - 1]), self.decimal_place)
            for k in self.topk
        }

    def get_tail(self, item_matrix, count_items):
        if self.tail > 1:
            tail_items = {item for item, cnt in count_items.items() if cnt <= self.tail}
        else:
            sorted_items = sorted(count_items.items(), key=lambda kv: (kv[1], kv[0]))
            cut = max(int(len(sorted_items) * self.tail), 1)
            tail_items = {item for item, _ in sorted_items[:cut]}
        return np.isin(item_matrix, list(tail_items)).astype(np.float64)


class PopularityPercentage(AbstractMetric):
    """Share of popular items in rec lists — exposure fairness (reference :749-820)."""

    metric_type = EvaluatorType.RANKING
    metric_need = ["rec.items", "data.count_items"]

    def __init__(self, config):
        super().__init__(config)
        self.topk = config["topk"]
        self.popularity = config["popularity_ratio"]
        if self.popularity is None or self.popularity <= 0:
            self.popularity = 0.1

    def calculate_metric(self, dataobject):
        item_matrix = np.asarray(dataobject.get("rec.items"))
        count_items = dict(dataobject.get("data.count_items"))
        value = self.get_popularity(item_matrix, count_items)
        result = value.cumsum(axis=1) / np.arange(1, value.shape[1] + 1)
        avg_result = result.mean(axis=0)
        return {
            f"popularitypercentage@{k}": round(float(avg_result[k - 1]), self.decimal_place)
            for k in self.topk
        }

    def get_popularity(self, item_matrix, count_items):
        if self.popularity > 1:
            pop_items = {item for item, cnt in count_items.items() if cnt >= self.popularity}
        else:
            sorted_items = sorted(count_items.items(), key=lambda kv: (kv[1], kv[0]), reverse=True)
            cut = max(int(len(sorted_items) * self.popularity), 1)
            pop_items = {item for item, _ in sorted_items[:cut]}
        return np.isin(item_matrix, list(pop_items)).astype(np.float64)


# ------------------------------------------------------------ fairness

class NonParityUnfairness(AbstractMetric):
    """|E_g[y] − E_¬g[y]| for binary attributes, std for multi-valued
    (reference :823-881)."""

    smaller = True
    metric_type = EvaluatorType.RANKING
    metric_need = ["rec.positive_score", "data.sst"]

    def __init__(self, config):
        super().__init__(config)
        self.sst_attr_list = config["sst_attr_list"]

    def calculate_metric(self, dataobject):
        score = np.asarray(dataobject.get("rec.positive_score"), dtype=np.float64)
        metric_dict = {}
        for sst in self.sst_attr_list:
            sst_value = np.asarray(dataobject.get("data." + sst))
            key = f"NonParity Unfairness of sensitive attribute {sst}"
            metric_dict[key] = round(self.get_nonparity(score, sst, sst_value), self.decimal_place)
        return metric_dict

    def get_nonparity(self, score, sst, sst_value):
        unique_value = np.unique(sst_value)
        if len(unique_value) < 2:
            raise ValueError(f"there is only one value for {sst} sensitive attribute")
        sst_avg_score = [score[sst_value == s].mean() for s in unique_value]
        if len(unique_value) == 2:
            return float(np.abs(sst_avg_score[0] - sst_avg_score[1]))
        return float(np.std(sst_avg_score))


def _grouped_pred_true(pos_score, pos_iids, neg_score, neg_iids, sst_value, sampled):
    """Shared accumulation for the four Yao&Huang unfairness metrics
    (reference :935-978): per-(item, group) mean predicted score and mean
    "true" score, where true=1 for positives and 0 for sampled negatives.

    ``sst_value`` covers the positive rows; in sampled mode negative row i is
    the same user as positive row i (reference collector layout), so groups
    are indexed by ``sst_indices`` for both halves.
    """
    sst_unique, sst_indices = np.unique(sst_value, return_inverse=True)
    if sampled:
        all_iids = np.concatenate((pos_iids, neg_iids))
    else:
        all_iids = pos_iids
    iid_unique, iid_indices = np.unique(all_iids, return_inverse=True)
    if len(sst_unique) != 2:
        raise ValueError("sensitive attribute must be binary")

    pos_len = len(pos_iids)
    n_items = len(iid_unique)
    avg_pred = np.zeros((n_items, 2))
    sst_num = np.zeros((n_items, 2))
    avg_true = np.zeros((n_items, 2))

    np.add.at(avg_pred, (iid_indices[:pos_len], sst_indices), pos_score)
    np.add.at(sst_num, (iid_indices[:pos_len], sst_indices), 1.0)
    np.add.at(avg_true, (iid_indices[:pos_len], sst_indices), 1.0)
    if sampled:
        np.add.at(avg_pred, (iid_indices[pos_len:], sst_indices), neg_score)
        np.add.at(sst_num, (iid_indices[pos_len:], sst_indices), 1.0)

    sst_num += 1e-5
    return avg_pred / sst_num, avg_true / sst_num


class _YaoHuangUnfairness(AbstractMetric):
    """Common scaffolding for Value/Absolute/Under/Over unfairness."""

    smaller = True
    metric_type = EvaluatorType.RANKING
    metric_need = [
        "data.positive_i", "rec.positive_score", "data.negative_i",
        "rec.negative_score", "data.sst",
    ]
    key_name = ""

    def __init__(self, config):
        super().__init__(config)
        self.sst_key = config["sst_attr_list"][0]
        self.mode = config["eval_args"]["mode"]

    def calculate_metric(self, dataobject):
        sampled = self.mode != "full"
        pos_score = np.asarray(dataobject.get("rec.positive_score"), dtype=np.float64)
        pos_iids = np.asarray(dataobject.get("data.positive_i"))
        sst_value = np.asarray(dataobject.get("data." + self.sst_key))
        if sampled:
            neg_score = np.asarray(dataobject.get("rec.negative_score"), dtype=np.float64)
            neg_iids = np.asarray(dataobject.get("data.negative_i"))
        else:
            neg_score = neg_iids = None
        avg_pred, avg_true = _grouped_pred_true(
            pos_score, pos_iids, neg_score, neg_iids, sst_value, sampled
        )
        value = self._gap(avg_pred, avg_true)
        key = f"{self.key_name} of sensitive attribute {self.sst_key}"
        return {key: round(float(value), self.decimal_place)}

    def _gap(self, avg_pred, avg_true):
        raise NotImplementedError


class ValueUnfairness(_YaoHuangUnfairness):
    """mean |(E_g[y]−E_g[r]) − (E_¬g[y]−E_¬g[r])| per item (reference :884-978)."""

    key_name = "Value Unfairness"

    def _gap(self, avg_pred, avg_true):
        diff = avg_pred - avg_true
        return np.mean(np.abs(diff[:, 0] - diff[:, 1]))


class AbsoluteUnfairness(_YaoHuangUnfairness):
    """mean ||E_g[y]−E_g[r]| − |E_¬g[y]−E_¬g[r]|| (reference :981-1074)."""

    key_name = "Absolute Unfairness"

    def _gap(self, avg_pred, avg_true):
        diff = np.abs(avg_pred - avg_true)
        return np.mean(np.abs(diff[:, 0] - diff[:, 1]))


class UnderUnfairness(_YaoHuangUnfairness):
    """underestimation gaps: max(0, true−pred) (reference :1077-1170)."""

    key_name = "Underestimation Unfairness"

    def _gap(self, avg_pred, avg_true):
        diff = np.maximum(avg_true - avg_pred, 0)
        return np.mean(np.abs(diff[:, 0] - diff[:, 1]))


class OverUnfairness(_YaoHuangUnfairness):
    """overestimation gaps: max(0, pred−true) (reference :1173-1266)."""

    key_name = "Overestimation Unfairness"

    def _gap(self, avg_pred, avg_true):
        diff = np.maximum(avg_pred - avg_true, 0)
        return np.mean(np.abs(diff[:, 0] - diff[:, 1]))


class DifferentialFairness(AbstractMetric):
    """ε-differential fairness with Dirichlet smoothing (reference :1269-1342):
    per-item smoothed group mean scores, ε = mean over items of the max
    pairwise |log p_i − log p_j|."""

    smaller = True
    metric_type = EvaluatorType.RANKING
    metric_need = ["data.positive_i", "rec.positive_score", "data.sst"]

    def __init__(self, config):
        super().__init__(config)
        self.sst_key_list = config["sst_attr_list"]

    def calculate_metric(self, dataobject):
        score = np.asarray(dataobject.get("rec.positive_score"), dtype=np.float64)
        iids = np.asarray(dataobject.get("data.positive_i"))
        metric_dict = {}
        for sst_key in self.sst_key_list:
            sst_value = np.asarray(dataobject.get("data." + sst_key))
            key = f"Differential Fairness of sensitive attribute {sst_key}"
            metric_dict[key] = round(
                self.get_differential_fairness(score, iids, sst_value), self.decimal_place
            )
        return metric_dict

    def get_differential_fairness(self, score, iids, sst_value):
        sst_unique, sst_indices = np.unique(sst_value, return_inverse=True)
        iid_unique, iid_indices = np.unique(iids, return_inverse=True)
        n_items, n_groups = len(iid_unique), len(sst_unique)

        concentration_parameter = 1.0
        dirichlet_alpha = concentration_parameter / n_items

        score_sum = np.zeros((n_items, n_groups), dtype=np.float64)
        counts = np.zeros((n_items, n_groups), dtype=np.float64)
        np.add.at(score_sum, (iid_indices, sst_indices), score)
        np.add.at(counts, (iid_indices, sst_indices), 1.0)
        score_matrix = ((score_sum + dirichlet_alpha) / (counts + concentration_parameter)).astype(
            np.float32
        )

        epsilon_values = np.zeros(n_items, dtype=np.float32)
        log_p = np.log(score_matrix)
        for i in range(n_groups):
            for j in range(i + 1, n_groups):
                epsilon = np.abs(log_p[:, i] - log_p[:, j])
                epsilon_values = np.maximum(epsilon_values, epsilon)
        return float(epsilon_values.mean())
