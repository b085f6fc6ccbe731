"""PFCN_DMF — filters over DMF-style towers with a cosine head.

Counterpart of ``recbole_fairrec_tpu/models/pfcn_dmf.py``: user and item
towers of ``num_layers`` equal-width layers with normal(0, .01) init, the
filters applied to the user TOWER OUTPUT, BPR over cosine · 10, sigmoid of
the cosine at predict.
"""

from __future__ import annotations

import torch

from .layers import MLP, init_embedding
from .pfcn_base import PFCNBase


def _cosine(a, b, eps=1e-8):
    """nn.CosineSimilarity semantics: per row, each norm clamped at eps."""
    na = torch.linalg.vector_norm(a, dim=-1).clamp_min(eps)
    nb = torch.linalg.vector_norm(b, dim=-1).clamp_min(eps)
    return (a * b).sum(-1) / (na * nb)


def _unit(x, eps=1e-8):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


class PFCN_DMF(PFCNBase):
    retrieval_monotone = True  # sigmoid of the cosine = sigmoid of a unit-vector dot

    def __init__(self, config, dataset, generator=None):
        super().__init__(config, dataset)
        self.num_layers = config["num_layers"]
        self.mlp_dropout = config["mlp_dropout"]
        self.mlp_activation = config["mlp_activation"]
        self.dis_activation_name = config["dis_activation"]
        # PFCN_DMF.yaml has no generic `activation`; the filters use the dis one
        if self.activation is None:
            self.activation = self.dis_activation_name
        generator = self._generator(generator)
        d = self.embedding_size
        self.user_embedding = init_embedding(self.n_users, d, "normal", generator)
        self.item_embedding = init_embedding(self.n_items, d, "normal", generator)
        tower = [d] * (self.num_layers + 1)
        self.user_mlp = MLP(tower, "norm", generator=generator)
        self.item_mlp = MLP(tower, "norm", generator=generator)
        self._init_adversarial(generator)

    def _dis_activation(self):
        return self.dis_activation_name

    def _backbone_param_keys(self):
        return ["user_embedding", "item_embedding", "user_mlp", "item_mlp"]

    def _tower(self, mlp, x, train):
        return mlp(x, activation=self.mlp_activation, dropout=self.mlp_dropout, train=train,
                   generator=self.dropout_generator(x.device))

    def _user_item_embed(self, user, item, sst_list, train=False, sample_weight=None):
        user_e = self._tower(self.user_mlp, self.lookup(self.user_embedding, user), train)
        item_e = None
        if item is not None:
            item_e = self._tower(self.item_mlp, self.lookup(self.item_embedding, item), train)
        user_e = self._apply_filters(user_e, sst_list, train, sample_weight,
                                     self._segments(user, train))
        return user_e, item_e

    def _pairwise_scores(self, batch, user, pos_item, neg_item, sst_list, train=False,
                         sample_weight=None):
        user_e, pos_e = self._user_item_embed(user, pos_item, sst_list, train, sample_weight)
        neg_e = self._tower(self.item_mlp, self.lookup(self.item_embedding, neg_item), train)
        return _cosine(user_e, pos_e) * 10, _cosine(user_e, neg_e) * 10

    def predict(self, batch, sst_list=None):
        user_e, item_e = self._user_item_embed(
            batch[self.USER_ID], batch[self.ITEM_ID], sst_list
        )
        return torch.sigmoid(_cosine(user_e, item_e))

    def retrieval_embeddings(self, batch, sst_list=None):
        """Unit tower outputs: their dot product is the cosine."""
        user_e, _ = self._user_item_embed(batch[self.USER_ID], None, sst_list)
        items = self._tower(self.item_mlp, self.full_weight(self.item_embedding), False)
        return _unit(user_e), _unit(items)

    def full_sort_predict(self, batch, sst_list=None):
        un, inorm = self.retrieval_embeddings(batch, sst_list)
        return torch.sigmoid(un @ inorm.T).reshape(-1)
