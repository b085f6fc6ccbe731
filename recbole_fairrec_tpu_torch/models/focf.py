"""FOCF: fairness objectives for collaborative filtering (Yao & Huang, NIPS'17).

Counterpart of ``recbole_fairrec_tpu/models/focf.py``: an MF backbone with
an MSE rating loss, one of five fairness regularizers computed per batch
over item × group mean matrices, and predictions clamped to
[0, max_rating] / max_rating.

The item × group means are sums over ``n_items × n_groups`` segments
(``index_add_``) with a presence mask for the items the batch holds and a
count offset of 1e-5, as in the JAX package; the item-grouped FOCF loader
gives each batch every row of its items. Under a batch split over the data
axis the segment sums are those of the whole batch (``parallel/``).
"""

from __future__ import annotations

import torch

from ..parallel.collectives import batch_sum
from ..utils import InputType
from .base import FairRecommender, batch_weights, wmean
from .layers import init_embedding
from .losses import masked_smooth_l1_loss, smooth_l1_loss

FAIR_OBJECTIVES = ("none", "value", "absolute", "under", "over", "nonparity")


class FOCF(FairRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, config, dataset, generator=None):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.RATING = config["RATING_FIELD"]
        self.SST_FIELD = config["sst_attr_list"][0]
        self.fair_weight = config["fair_weight"]
        self.max_rating = float(torch.as_tensor(dataset.inter_feat[self.RATING]).max())
        self.fair_objective = (config["fair_objective"] or "none").strip().lower()
        if self.fair_objective not in FAIR_OBJECTIVES:
            raise ValueError(
                "you must set config['fair_objective'] be one of (none,"
                "value,absolute,under,over,nonparity)"
            )
        self.sst_lut, self.n_groups = self._sst_code_map(dataset, self.SST_FIELD)
        if generator is None:
            generator = torch.Generator().manual_seed(self._seed)
        self.user_embedding = init_embedding(self.n_users, self.embedding_size,
                                             generator=generator)
        self.item_embedding = init_embedding(self.n_items, self.embedding_size,
                                             generator=generator)

    def forward(self, user, item):
        user_e = self.lookup(self.user_embedding, user)
        item_e = self.lookup(self.item_embedding, item)
        return (user_e * item_e).sum(-1)

    def _groups(self, batch):
        sst = batch[self.SST_FIELD]
        return self._on_device("sst", self.sst_lut, sst.device)[sst.long()]

    def _item_group_means(self, pred_scores, batch, w):
        """Per-(item, group) mean predicted and true scores, and a mask of
        the items with a real row in the batch (padding rows, w = 0, add
        nothing)."""
        seg = batch[self.ITEM_ID].long() * self.n_groups + self._groups(batch)
        n_seg = self.n_items * self.n_groups

        def segment_sum(values):
            out = torch.zeros(n_seg, dtype=values.dtype, device=values.device)
            out = batch_sum(out.index_add_(0, seg, values))
            return out.reshape(self.n_items, self.n_groups)

        pred_sum = segment_sum(pred_scores * w)
        true_sum = segment_sum(batch[self.RATING].float() * w)
        cnt = segment_sum(w) + 1e-5
        present = (cnt.sum(dim=1) > 1.0).to(pred_sum.dtype)
        return pred_sum / cnt, true_sum / cnt, present

    def _fair_loss(self, pred_scores, batch, w):
        obj = self.fair_objective
        if obj == "nonparity":
            groups = self._groups(batch)
            mask0 = (groups == 0).to(pred_scores.dtype) * w
            mask1 = (groups == 1).to(pred_scores.dtype) * w
            avg0 = (batch_sum(torch.sum(pred_scores * mask0))
                    / batch_sum(mask0.sum()).clamp_min(1.0))
            avg1 = (batch_sum(torch.sum(pred_scores * mask1))
                    / batch_sum(mask1.sum()).clamp_min(1.0))
            return smooth_l1_loss(avg0, avg1)

        avg_pred, avg_true, present = self._item_group_means(pred_scores, batch, w)
        if obj == "value":
            diff = avg_pred - avg_true
        elif obj == "absolute":
            diff = torch.abs(avg_pred - avg_true)
        elif obj == "under":
            diff = (avg_true - avg_pred).clamp_min(0.0)
        else:  # over
            diff = (avg_pred - avg_true).clamp_min(0.0)
        gap = torch.abs(diff[:, 0] - diff[:, 1])
        return masked_smooth_l1_loss(gap, torch.zeros_like(gap), present)

    # ------------------------------------------------------------------ API

    def loss_batch_fields(self, loss_name, sst_list=None):
        return (self.USER_ID, self.ITEM_ID, self.RATING, self.SST_FIELD, "__weight__")

    def calculate_loss(self, batch, sst_list=None):
        pred_scores = self.forward(batch[self.USER_ID], batch[self.ITEM_ID])
        w = batch_weights(batch)
        rating_loss = wmean((pred_scores - batch[self.RATING].float()) ** 2, w)
        if self.fair_objective == "none":
            return rating_loss
        ones = torch.ones_like(pred_scores) if w is None else w
        return rating_loss + self.fair_weight * self._fair_loss(pred_scores, batch, ones)

    def predict(self, batch, sst_list=None):
        pred = self.forward(batch[self.USER_ID], batch[self.ITEM_ID])
        return pred.clamp(0.0, self.max_rating) / self.max_rating

    def full_sort_predict(self, batch, sst_list=None):
        user_e = self.lookup(self.user_embedding, batch[self.USER_ID])
        scores = self.score_matmul(user_e, self.full_weight(self.item_embedding).T)
        return scores.clamp(0.0, self.max_rating).reshape(-1) / self.max_rating
