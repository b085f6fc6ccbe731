"""PFCN_PMF — plain MF backbone (BPR-MF with ``filter_mode: none``).

Counterpart of ``recbole_fairrec_tpu/models/pfcn_pmf.py``: dot-product
scores, sigmoid at predict. The BPR training step comes with the training
slice of the port.
"""

from __future__ import annotations

import torch

from .layers import init_embedding
from .pfcn_base import PFCNBase


class PFCN_PMF(PFCNBase):
    retrieval_monotone = True  # sigmoid preserves dot-product rank

    def __init__(self, config, dataset, generator=None):
        super().__init__(config, dataset)
        if generator is None:
            generator = torch.Generator().manual_seed(int(config["seed"] or 0))
        self.user_embedding = init_embedding(
            self.n_users, self.embedding_size, "normal", generator
        )
        self.item_embedding = init_embedding(
            self.n_items, self.embedding_size, "normal", generator
        )

    def _user_item_embed(self, user, item, sst_list):
        user_e = self.lookup(self.user_embedding, user)
        item_e = self.lookup(self.item_embedding, item) if item is not None else None
        return user_e, item_e

    def predict(self, batch, sst_list=None):
        user_e, item_e = self._user_item_embed(
            batch[self.USER_ID], batch[self.ITEM_ID], sst_list
        )
        return torch.sigmoid((user_e * item_e).sum(-1))

    def retrieval_embeddings(self, batch, sst_list=None):
        """(user_repr, item_table) whose dot product ranks identically to
        full_sort_predict (sigmoid is strictly monotone)."""
        user_e, _ = self._user_item_embed(batch[self.USER_ID], None, sst_list)
        return user_e, self.item_embedding.weight

    def full_sort_predict(self, batch, sst_list=None):
        user_e, _ = self._user_item_embed(batch[self.USER_ID], None, sst_list)
        return torch.sigmoid(user_e @ self.item_embedding.weight.T).reshape(-1)
