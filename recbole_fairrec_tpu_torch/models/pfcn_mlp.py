"""PFCN_MLP — filters over an MLP interaction scorer.

Counterpart of ``recbole_fairrec_tpu/models/pfcn_mlp.py``: score =
MLP([2d] + mlp_hidden + [1]) over concat(user, item), ReLU after every layer,
sigmoid at predict, BPR on the raw MLP outputs. The score is not a monotone
function of a dot product, so full-sort evaluation takes the dense path.
"""

from __future__ import annotations

import torch

from .layers import MLP, init_embedding
from .pfcn_base import PFCNBase

# full_sort_predict scores this many (user, item) rows at a time at most:
# one [rows, 2d] input and its hidden activations, not [B·|I|, 2d] at once
_SCORE_ROWS = 1 << 22


class PFCN_MLP(PFCNBase):
    def __init__(self, config, dataset, generator=None):
        super().__init__(config, dataset)
        self.dropout = config["dropout"]
        self.mlp_hidden_size_list = list(config["mlp_hidden_size_list"])
        generator = self._generator(generator)
        d = self.embedding_size
        self.user_embedding = init_embedding(self.n_users, d, "normal", generator)
        self.item_embedding = init_embedding(self.n_items, d, "normal", generator)
        self.mlp = MLP([2 * d] + self.mlp_hidden_size_list + [1], "torch_linear",
                       generator=generator)
        self._init_adversarial(generator)

    def _backbone_param_keys(self):
        return ["user_embedding", "item_embedding", "mlp"]

    def _user_item_embed(self, user, item, sst_list, train=False, sample_weight=None):
        user_e = self.lookup(self.user_embedding, user)
        item_e = self.lookup(self.item_embedding, item) if item is not None else None
        user_e = self._apply_filters(user_e, sst_list, train, sample_weight,
                                     self._segments(user, train))
        return user_e, item_e

    def _mlp_score(self, user_e, item_e, train):
        x = torch.cat([user_e, item_e], dim=-1)
        out = self.mlp(x, activation="relu", dropout=self.dropout, train=train,
                       generator=self.dropout_generator(x.device))
        return out[:, 0]

    def _pairwise_scores(self, batch, user, pos_item, neg_item, sst_list, train=False,
                         sample_weight=None):
        user_e, pos_e = self._user_item_embed(user, pos_item, sst_list, train, sample_weight)
        neg_e = self.lookup(self.item_embedding, neg_item)
        return self._mlp_score(user_e, pos_e, train), self._mlp_score(user_e, neg_e, train)

    def predict(self, batch, sst_list=None):
        user_e, item_e = self._user_item_embed(
            batch[self.USER_ID], batch[self.ITEM_ID], sst_list
        )
        return torch.sigmoid(self._mlp_score(user_e, item_e, False))

    def full_sort_predict(self, batch, sst_list=None):
        """Every item for each batch user: [B·|I|] pairs through the MLP,
        in blocks of whole users (each row is scored on its own, so the
        blocking changes no score)."""
        user_e, _ = self._user_item_embed(batch[self.USER_ID], None, sst_list)
        items = self.full_weight(self.item_embedding)
        n_items = items.shape[0]
        per_block = max(1, _SCORE_ROWS // n_items)
        out = []
        for start in range(0, user_e.shape[0], per_block):
            u = user_e[start:start + per_block]
            pairs_u = u.repeat_interleave(n_items, dim=0)
            pairs_i = items.repeat(u.shape[0], 1)
            out.append(torch.sigmoid(self._mlp_score(pairs_u, pairs_i, False)))
        return torch.cat(out)
