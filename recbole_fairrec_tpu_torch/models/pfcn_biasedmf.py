"""PFCN_BiasedMF — filters over MF with user, item and global biases.

Counterpart of ``recbole_fairrec_tpu/models/pfcn_biasedmf.py``: score =
u·i + b_u + b_i + b_g with a sigmoid head; the global bias is a 0-d
parameter that starts at 0.1.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.collectives import gather_batch
from .layers import init_embedding
from .pfcn_base import PFCNBase


class PFCN_BiasedMF(PFCNBase):
    retrieval_monotone = True  # sigmoid preserves the rank of u·i + b_i per user

    def __init__(self, config, dataset, generator=None):
        super().__init__(config, dataset)
        generator = self._generator(generator)
        d = self.embedding_size
        self.user_embedding = init_embedding(self.n_users, d, "normal", generator)
        self.item_embedding = init_embedding(self.n_items, d, "normal", generator)
        self.user_bias = init_embedding(self.n_users, 1, "normal", generator)
        self.item_bias = init_embedding(self.n_items, 1, "normal", generator)
        self.global_bias = nn.Parameter(torch.tensor(0.1))
        self._init_adversarial(generator)

    def _backbone_param_keys(self):
        return ["user_embedding", "item_embedding", "user_bias", "item_bias", "global_bias"]

    def _user_item_embed(self, user, item, sst_list, train=False, sample_weight=None):
        user_e = self.lookup(self.user_embedding, user)
        item_e = self.lookup(self.item_embedding, item) if item is not None else None
        user_e = self._apply_filters(user_e, sst_list, train, sample_weight,
                                     self._segments(user, train))
        return user_e, item_e

    def _pairwise_scores(self, batch, user, pos_item, neg_item, sst_list, train=False,
                         sample_weight=None):
        """The reference's quirk, reproduced: the [B] dot scores are summed
        with the [B, 1] biases, so the sum broadcasts to [B, B] — element
        (i, j) = dot(j) + b_u(i) + b_item(i) + b_g — and BPR averages over
        all B² cross pairs. Under a data split the rows are this rank's and
        the columns the whole batch's."""
        user_e, pos_e = self._user_item_embed(user, pos_item, sst_list, train, sample_weight)
        neg_e = self.lookup(self.item_embedding, neg_item)
        user_b = self.user_bias(user)  # [B, 1]
        gb = self.global_bias
        pos_dot = (user_e * pos_e).sum(-1)
        neg_dot = (user_e * neg_e).sum(-1)
        pos_s = gather_batch(pos_dot)[None, :] + user_b + self.item_bias(pos_item) + gb
        neg_s = gather_batch(neg_dot)[None, :] + user_b + self.item_bias(neg_item) + gb
        return pos_s, neg_s

    def predict(self, batch, sst_list=None):
        user, item = batch[self.USER_ID], batch[self.ITEM_ID]
        user_e, item_e = self._user_item_embed(user, item, sst_list)
        score = ((user_e * item_e).sum(-1) + self.user_bias(user)[:, 0]
                 + self.item_bias(item)[:, 0] + self.global_bias)
        return torch.sigmoid(score)

    def retrieval_embeddings(self, batch, sst_list=None):
        """Bias-augmented retrieval form, d + 1 wide: user⧺[1] · item⧺[b_i]
        differs from the sigmoid's argument only by the per-row constant
        b_u + b_g, so the per-user ranking is identical."""
        user_e, _ = self._user_item_embed(batch[self.USER_ID], None, sst_list)
        u = torch.cat([user_e, torch.ones_like(user_e[:, :1])], dim=1)
        t = torch.cat([self.full_weight(self.item_embedding), self.item_bias.weight], dim=1)
        return u, t

    def full_sort_predict(self, batch, sst_list=None):
        user = batch[self.USER_ID]
        user_e, _ = self._user_item_embed(user, None, sst_list)
        items = self.full_weight(self.item_embedding)
        scores = (self.score_matmul(user_e, items.T) + self.user_bias(user)
                  + self.item_bias.weight[:, 0][None, :] + self.global_bias)
        return torch.sigmoid(scores).reshape(-1)
