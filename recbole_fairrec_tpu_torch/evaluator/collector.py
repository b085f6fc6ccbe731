"""Collector: accumulates per-batch eval resources guided by metric needs.

Counterpart of ``recbole_fairrec_tpu/evaluator/collector.py`` (host numpy).
The trainer hands numpy arrays or torch tensors; tensors are copied to the
host at the accumulation boundary (``_np``), so metrics never see a device
tensor.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..utils import tracing
from .register import Register


def _np(value):
    """Host numpy view of an array-like (a torch tensor may live on the card;
    reading one from there counts as a host sync)."""
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.device.type != "cpu":
            value = tracing.to_host(value)
        return value.numpy()
    return np.asarray(value)


class DataStruct:
    def __init__(self):
        self._data_dict = {}

    def __getitem__(self, name):
        return self._data_dict[name]

    def __setitem__(self, name, value):
        self._data_dict[name] = value

    def __delitem__(self, name):
        self._data_dict.pop(name)

    def __contains__(self, key):
        return key in self._data_dict

    def get(self, name):
        if name not in self._data_dict:
            raise IndexError("Can not load the data without registration !")
        return self[name]

    def set(self, name, value):
        self._data_dict[name] = value

    def update_tensor(self, name, value):
        value = _np(value)
        if name not in self._data_dict:
            self._data_dict[name] = value.copy()
        else:
            self._data_dict[name] = np.concatenate((self._data_dict[name], value), axis=0)

    def __str__(self):
        return "\nContaining:\n" + "\n".join(self._data_dict.keys()) + "\n"


def _average_rank(scores):
    """Row-wise tie-averaged descending ranks, 1-based (reference :97-129;
    scipy rankdata semantics). Rows must already be descending-sorted.

    Fully vectorized: per row, each tie group [s, e) gets rank (s+1+e)/2.
    Group starts propagate rightward via a running max over column indices;
    group ends come from the same trick on the reversed rows.
    """
    length, width = scores.shape
    cols = np.broadcast_to(np.arange(width), (length, width))
    is_start = np.ones((length, width), dtype=bool)
    is_start[:, 1:] = scores[:, 1:] != scores[:, :-1]
    # start index of each element's tie group: running max of start positions
    start = np.maximum.accumulate(np.where(is_start, cols, 0), axis=1)
    # end (exclusive): first start position to the right, found on the
    # reversed array with a running minimum
    nxt = np.where(is_start, cols, width)[:, ::-1]
    end = np.minimum.accumulate(np.r_["1", np.full((length, 1), width), nxt][:, :-1], axis=1)[:, ::-1]
    return 0.5 * (start + 1 + end)


class Collector:
    def __init__(self, config):
        self.config = config
        self.data_struct = DataStruct()
        self.register = Register(config)
        self.full = "full" in config["eval_args"]["mode"]
        self.topk = self.config["topk"]
        self.ugf_rerank = self.config["ugf_metric"] is not None

    def data_collect(self, train_data):
        if self.register.need("data.num_items"):
            item_id = self.config["ITEM_ID_FIELD"]
            self.data_struct.set("data.num_items", train_data.dataset.num(item_id))
        if self.register.need("data.num_users"):
            user_id = self.config["USER_ID_FIELD"]
            self.data_struct.set("data.num_users", train_data.dataset.num(user_id))
        if self.register.need("data.count_items"):
            self.data_struct.set("data.count_items", train_data.dataset.item_counter)
        if self.register.need("data.count_users"):
            self.data_struct.set("data.count_items", train_data.dataset.user_counter)

    def eval_batch_collect(self, scores_tensor, interaction, positive_u, positive_i):
        """Standard path: compute needs from the [B, n_items] score matrix."""
        scores = _np(scores_tensor)
        positive_u = _np(positive_u)
        positive_i = _np(positive_i)
        max_k = max(self.topk)

        topk_idx = None
        if self.register.need("rec.items") or self.register.need("rec.topk"):
            # argpartition + in-bucket sort == torch.topk ordering
            part = np.argpartition(-scores, max_k - 1, axis=1)[:, :max_k]
            part_scores = np.take_along_axis(scores, part, axis=1)
            order = np.argsort(-part_scores, axis=1, kind="stable")
            topk_idx = np.take_along_axis(part, order, axis=1)

        if self.register.need("rec.items"):
            self.data_struct.update_tensor("rec.items", topk_idx)

        if self.register.need("rec.topk"):
            pos_matrix = np.zeros_like(scores, dtype=np.int64)
            pos_matrix[positive_u, positive_i] = 1
            pos_len_list = pos_matrix.sum(axis=1, keepdims=True)
            pos_idx = np.take_along_axis(pos_matrix, topk_idx, axis=1)
            result = np.concatenate((pos_idx, pos_len_list), axis=1)
            self.data_struct.update_tensor("rec.topk", result)

        if self.register.need("rec.meanrank"):
            desc_index = np.argsort(-scores, axis=1, kind="stable")
            desc_scores = np.take_along_axis(scores, desc_index, axis=1)
            pos_matrix = np.zeros_like(scores)
            pos_matrix[positive_u, positive_i] = 1
            pos_index = np.take_along_axis(pos_matrix, desc_index, axis=1)
            avg_rank = _average_rank(desc_scores)
            pos_rank_sum = np.where(pos_index == 1, avg_rank, 0).sum(axis=-1, keepdims=True)
            pos_len_list = pos_matrix.sum(axis=1, keepdims=True)
            user_len_list = desc_scores.argmin(axis=1).reshape(-1, 1)
            result = np.concatenate((pos_rank_sum, user_len_list, pos_len_list), axis=1)
            self.data_struct.update_tensor("rec.meanrank", result)

        if self.register.need("rec.score"):
            self.data_struct.update_tensor("rec.score", scores)

        if self.register.need("data.label"):
            label_field = self.config["LABEL_FIELD"]
            self.data_struct.update_tensor("data.label", _np(interaction[label_field]))

        if self.register.need("rec.positive_score"):
            self.data_struct.update_tensor(
                "rec.positive_score", scores[positive_u, positive_i]
            )

        if self.register.need("data.positive_i"):
            self.data_struct.update_tensor("data.positive_i", positive_i)

        if self.full:
            if self.register.need("data.sst"):
                for sst in self.config["sst_attr_list"]:
                    assert sst in interaction.columns, f"{sst} is not in interaction"
                    self.data_struct.update_tensor(
                        "data." + sst, _np(interaction[sst])[positive_u]
                    )
        else:
            need_neg = self.register.need("rec.negative_score") or self.register.need(
                "data.negative_i"
            )
            if need_neg:
                neg_items = self._first_negative_block(interaction, positive_u)
            if self.register.need("rec.negative_score"):
                neg_score = scores[positive_u, neg_items]
                self.data_struct.update_tensor("rec.negative_score", neg_score)
            if self.register.need("data.negative_i"):
                self.data_struct.update_tensor("data.negative_i", neg_items)
            if self.register.need("data.sst"):
                # the reference slices the first len(positive_u) rows
                # (collector.py:205) — only correct for single-user batches;
                # the per-user positive-block rows generalize it
                pos_rows = self._block_positions(len(interaction), positive_u, "pos")
                for sst in self.config["sst_attr_list"]:
                    assert sst in interaction.columns, f"{sst} is not in interaction"
                    self.data_struct.update_tensor(
                        "data." + sst, _np(interaction[sst])[pos_rows]
                    )

    def eval_batch_collect_topk(self, payload: dict, interaction, positive_u, positive_i):
        """Fused path: the jitted eval step already computed per-batch
        resources on device; just accumulate them. ``payload`` may contain
        any of the rec.* keys plus positive/negative score gathers."""
        for key, value in payload.items():
            self.data_struct.update_tensor(key, _np(value))
        positive_u = _np(positive_u)
        if self.register.need("data.positive_i"):
            self.data_struct.update_tensor("data.positive_i", _np(positive_i))
        if self.register.need("data.label") and interaction is not None:
            label_field = self.config["LABEL_FIELD"]
            self.data_struct.update_tensor("data.label", _np(interaction[label_field]))
        if self.register.need("data.sst") and interaction is not None:
            if self.full:
                idx = positive_u
            else:
                idx = self._block_positions(len(interaction), positive_u, "pos")
            for sst in self.config["sst_attr_list"]:
                col = _np(interaction[sst])
                self.data_struct.update_tensor("data." + sst, col[idx])

    @staticmethod
    def _block_positions(n_rows, positive_u, which):
        """Row positions of each user's positive block ("pos") or first
        negative block ("neg") in the per-user [positives ⧺ negatives×m]
        layout of sampled-eval interactions."""
        k = np.bincount(positive_u)
        k = k[k > 0]
        times = n_rows // max(k.sum(), 1)  # 1 + neg_sample_num
        block_starts = np.concatenate([[0], np.cumsum(k * times)])[:-1]
        if which == "pos":
            return np.concatenate(
                [np.arange(s, s + kj) for s, kj in zip(block_starts, k)]
            )
        return np.concatenate(
            [np.arange(s + kj, s + 2 * kj) for s, kj in zip(block_starts, k)]
        )

    def _first_negative_block(self, interaction, positive_u):
        """One sampled negative item per positive row.

        The reference slices ``interaction[item_id][pos_len:2*pos_len]``
        (collector.py:191-200), which is only the negatives when a batch holds
        a single user (the common case: one big user forces step=1). For
        multi-user batches that global slice crosses user blocks and pairs
        unscored (u, i) cells (−inf scores → NaN metrics). Here the first
        negative block of EACH user's rows is taken — identical to the
        reference in its well-defined regime, correct beyond it.
        """
        items = _np(interaction[self.config["ITEM_ID_FIELD"]])
        idx = self._block_positions(len(items), positive_u, "neg")
        return items[idx]

    def model_collect(self, model):
        """Hook for model-side resources (unused, kept for parity)."""

    def eval_collect(self, eval_pred, data_label):
        if self.register.need("rec.score"):
            self.data_struct.update_tensor("rec.score", _np(eval_pred))
        if self.register.need("data.label"):
            self.data_struct.update_tensor("data.label", _np(data_label))

    def get_data_struct(self):
        returned = copy.deepcopy(self.data_struct)
        for key in [
            "rec.topk", "rec.meanrank", "rec.score", "rec.items", "data.label",
            "rec.positive_score", "data.positive_i", "rec.negative_score", "data.negative_i",
        ]:
            if key in self.data_struct:
                del self.data_struct[key]
        if self.register.need("data.sst"):
            for key in self.config["sst_attr_list"]:
                if ("data." + key) in self.data_struct:
                    del self.data_struct["data." + key]
        return returned
