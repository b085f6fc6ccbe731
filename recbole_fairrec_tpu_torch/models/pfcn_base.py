"""Shared machinery of the PFCN family, ``filter_mode: none`` only.

Counterpart of ``recbole_fairrec_tpu/models/pfcn_base.py``. With
``filter_mode: none`` a PFCN model is its plain backbone trained with BPR
(PFCN_PMF is then BPR-MF). The counterfactual filters and discriminators
(``cm``/``sm``) come with the adversarial slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import InputType
from .base import FairRecommender, batch_weights, wmean


class PFCNBase(FairRecommender):
    input_type = InputType.PAIRWISE

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.sst_attrs = list(config["sst_attr_list"])
        self.filter_mode = config["filter_mode"].lower()
        if self.filter_mode not in ("cm", "sm", "none"):
            raise AssertionError("filter_mode must be cm, sm or none")
        if self.filter_mode != "none":
            raise NotImplementedError(
                f"filter_mode [{self.filter_mode}] needs the counterfactual filters, "
                "which come with the adversarial PFCN slice of the port; use "
                "filter_mode: none"
            )
        self.activation = config["activation"]
        self.sst_lut = {}
        self.sst_size = {}
        for sst in self.sst_attrs:
            lut, k = self._sst_code_map(dataset, sst)
            self.sst_lut[sst] = lut
            self.sst_size[sst] = k

    # ----------------------------------------------------- model API pieces

    def _user_item_embed(self, user, item, sst_list):
        """Backbone-specific: returns (user_repr, item_repr)."""
        raise NotImplementedError

    def _pairwise_scores(self, batch, user, pos_item, neg_item, sst_list):
        """Backbone-specific raw (pos_score, neg_score) for BPR."""
        raise NotImplementedError

    def loss_batch_fields(self, loss_name, sst_list=None):
        return (self.USER_ID, self.ITEM_ID, self.POS_ITEM_ID, self.NEG_ITEM_ID,
                *self.sst_attrs, "__weight__")

    def calculate_loss(self, batch, sst_list=None):
        """BPR over the batch's (user, positive, negative) rows: the mean of
        −log(1e-10 + σ(pos − neg)), weighted by ``__weight__`` when the batch
        carries one."""
        user = batch[self.USER_ID]
        pos_s, neg_s = self._pairwise_scores(
            batch, user, batch[self.POS_ITEM_ID], batch[self.NEG_ITEM_ID], sst_list
        )
        elem = -torch.log(1e-10 + torch.sigmoid(pos_s - neg_s))
        if "__weight__" not in batch:
            return elem.mean()
        return wmean(elem, batch_weights(batch, user))

    @torch.no_grad()
    def get_sst_embed(self, user_data, sst_list=None):
        """User representations of users 1..n−1 and their sensitive
        attributes (``user_data`` is the user feature table without its PAD
        row), for offline attacker evaluation."""
        device = next(self.parameters()).device
        user_indices = torch.arange(1, self.n_users, device=device)
        sst_list = tuple(self.sst_attrs)  # filter_mode none: every attribute
        ret = {sst: np.asarray(user_data[sst])[: self.n_users - 1] for sst in sst_list}
        user_repr, _ = self._user_item_embed(user_indices, None, sst_list)
        ret["embedding"] = user_repr.cpu().numpy()
        return ret
