"""PFCN_PMF — counterfactual filters over a plain MF backbone.

Counterpart of ``recbole_fairrec_tpu/models/pfcn_pmf.py``: dot-product
scores, sigmoid at predict, BPR training; the filters act on the user
embedding (with ``filter_mode: none`` the model is BPR-MF).
"""

from __future__ import annotations

import torch

from .layers import init_embedding
from .pfcn_base import PFCNBase


class PFCN_PMF(PFCNBase):
    retrieval_monotone = True  # sigmoid preserves dot-product rank

    def __init__(self, config, dataset, generator=None):
        super().__init__(config, dataset)
        generator = self._generator(generator)
        self.user_embedding = init_embedding(
            self.n_users, self.embedding_size, "normal", generator
        )
        self.item_embedding = init_embedding(
            self.n_items, self.embedding_size, "normal", generator
        )
        self._init_adversarial(generator)

    def _backbone_param_keys(self):
        return ["user_embedding", "item_embedding"]

    def _user_item_embed(self, user, item, sst_list, train=False, sample_weight=None):
        user_e = self.lookup(self.user_embedding, user)
        item_e = self.lookup(self.item_embedding, item) if item is not None else None
        user_e = self._apply_filters(user_e, sst_list, train, sample_weight,
                                     self._segments(user, train))
        return user_e, item_e

    def _pairwise_scores(self, batch, user, pos_item, neg_item, sst_list, train=False,
                         sample_weight=None):
        user_e, pos_e = self._user_item_embed(user, pos_item, sst_list, train, sample_weight)
        neg_e = self.lookup(self.item_embedding, neg_item)
        return (user_e * pos_e).sum(-1), (user_e * neg_e).sum(-1)

    def predict(self, batch, sst_list=None):
        user_e, item_e = self._user_item_embed(
            batch[self.USER_ID], batch[self.ITEM_ID], sst_list
        )
        return torch.sigmoid((user_e * item_e).sum(-1))

    def retrieval_embeddings(self, batch, sst_list=None):
        """(user_repr, item_table) whose dot product ranks identically to
        full_sort_predict (sigmoid is strictly monotone)."""
        user_e, _ = self._user_item_embed(batch[self.USER_ID], None, sst_list)
        return user_e, self.full_weight(self.item_embedding)

    def full_sort_predict(self, batch, sst_list=None):
        user_e, _ = self._user_item_embed(batch[self.USER_ID], None, sst_list)
        items = self.full_weight(self.item_embedding)
        return torch.sigmoid(self.score_matmul(user_e, items.T)).reshape(-1)
