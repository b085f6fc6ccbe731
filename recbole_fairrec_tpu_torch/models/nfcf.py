"""NFCF: neural fair collaborative filtering (Islam et al., WWW'21).

Counterpart of ``recbole_fairrec_tpu/models/nfcf.py``: an NCF-style scorer
(user and item embeddings concatenated → MLP → sigmoid, BCE loss) trained
in two stages:

* pretrain (``load_pretrain_path`` unset): plain NCF training;
* debiased finetune: the pretrain checkpoint is read (a checkpoint of either
  package, through ``quick_start.load_checkpoint``), the gender direction
  mean(g1) − mean(g2) over the user embeddings is projected out of every
  user embedding, the item table keeps its fresh initialisation (the JAX
  package re-draws it from the key of its first draw), and the user table
  is frozen (``frozen_param_keys``); the loss gains ``fair_weight`` times
  the ε-differential-fairness penalty: per item and group the
  Dirichlet-smoothed mean score of the positive rows, ε = the largest
  |log p_i − log p_j| between groups, averaged over the items present.

The penalty's per-item group sums are ``index_add_`` over
``n_items × n_groups`` segments with an item-presence mask (those of the
whole batch under a batch split over the data axis, ``parallel/``). Dropout masks
come from the model's generator (``dropout_generator``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import batch_sum
from ..utils import InputType
from .base import FairRecommender, batch_weights, wmean
from .layers import MLP, init_embedding
from .losses import bce_elementwise


class NFCF(FairRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, config, dataset, generator=None):
        super().__init__(config, dataset)
        self.LABEL = config["LABEL_FIELD"]
        self.embedding_size = config["embedding_size"]
        self.mlp_hidden_size = list(config["mlp_hidden_size"])
        self.dropout = config["dropout"]
        self.sst_attr = config["sst_attr_list"][0]
        self.fair_weight = config["fair_weight"]
        self.load_pretrain_path = config["load_pretrain_path"]
        self.sst_lut, self.n_groups = self._sst_code_map(dataset, self.sst_attr)
        if generator is None:
            generator = torch.Generator().manual_seed(self._seed)
        d = self.embedding_size
        self.user_embedding = init_embedding(self.n_users, d, "normal", generator)
        self.item_embedding = init_embedding(self.n_items, d, "normal", generator)
        self.mlp = MLP([2 * d] + self.mlp_hidden_size + [1], "torch_linear", generator=generator)
        if self.load_pretrain_path is not None:
            self._debias_from_pretrain(dataset.get_user_feature())

    @torch.no_grad()
    def _debias_from_pretrain(self, user_feature):
        """Load the pretrained weights but the item table, and remove the
        gender direction from the user embeddings (rows 1.., numpy float32
        arithmetic as in the JAX package)."""
        from ..quick_start import load_checkpoint
        from ..utils.jax_params import load_jax_params

        fresh_items = self.item_embedding.weight.detach().clone()
        load_jax_params(self, load_checkpoint(self.load_pretrain_path)["params"])
        self.item_embedding.weight.copy_(fresh_items)

        sst_value = np.asarray(user_feature[self.sst_attr])[1:]
        sst_unique = np.unique(sst_value)
        g1 = sst_value == sst_unique[0]
        g2 = sst_value == sst_unique[1]
        table = self.user_embedding.weight.detach().cpu().numpy()
        users = table[1:].copy()
        e1 = users[g1].mean(axis=0)
        e2 = users[g2].mean(axis=0)
        bias_dir = (e1 - e2) / np.linalg.norm(e1 - e2)
        users = users - (users @ bias_dir)[:, None] * bias_dir[None, :]
        table = table.copy()
        table[1:] = users
        self.user_embedding.weight.copy_(torch.from_numpy(table))

    def frozen_param_keys(self):
        return ["user_embedding"] if self.load_pretrain_path is not None else []

    # --------------------------------------------------------------- forward

    def forward(self, user, item, train=False):
        u = self.lookup(self.user_embedding, user)
        i = self.lookup(self.item_embedding, item)
        out = self.mlp(torch.cat([u, i], dim=-1), activation="relu", dropout=self.dropout,
                       train=train, generator=self.dropout_generator(u.device))
        return torch.sigmoid(out[:, 0])

    def _differential_fairness(self, batch, score, w):
        """ε-DF penalty over the positive rows."""
        pos_w = w * (batch[self.LABEL] == 1).to(w.dtype)
        sst = batch[self.sst_attr]
        groups = self._on_device("sst", self.sst_lut, sst.device)[sst.long()]
        seg = batch[self.ITEM_ID].long() * self.n_groups + groups
        n_seg = self.n_items * self.n_groups

        def segment_sum(values):
            out = torch.zeros(n_seg, dtype=values.dtype, device=values.device)
            out = batch_sum(out.index_add_(0, seg, values))
            return out.reshape(self.n_items, self.n_groups)

        score_sum = segment_sum(score * pos_w)
        counts = segment_sum(pos_w)
        present = (counts.sum(dim=1) > 0).to(score.dtype)
        n_unique = present.sum().clamp_min(1.0)

        concentration = 1.0
        alpha = concentration / n_unique
        log_p = torch.log((score_sum + alpha) / (counts + concentration))
        eps = torch.zeros(self.n_items, dtype=score.dtype, device=score.device)
        for i in range(self.n_groups):
            for j in range(i + 1, self.n_groups):
                eps = torch.maximum(eps, torch.abs(log_p[:, i] - log_p[:, j]))
        return torch.sum(eps * present) / n_unique

    # ------------------------------------------------------------------- API

    def loss_batch_fields(self, loss_name, sst_list=None):
        return (self.USER_ID, self.ITEM_ID, self.LABEL, self.sst_attr, "__weight__")

    def calculate_loss(self, batch, sst_list=None):
        output = self.forward(batch[self.USER_ID], batch[self.ITEM_ID], train=True)
        w = batch_weights(batch)
        rec_loss = wmean(bce_elementwise(output, batch[self.LABEL].float()), w)
        if self.load_pretrain_path is None:
            return rec_loss
        ones = torch.ones_like(output) if w is None else w
        return rec_loss + self.fair_weight * self._differential_fairness(batch, output, ones)

    def predict(self, batch, sst_list=None):
        return self.forward(batch[self.USER_ID], batch[self.ITEM_ID])

    def full_sort_predict(self, batch, sst_list=None):
        """Every user of the batch against every item through the MLP."""
        u = self.lookup(self.user_embedding, batch[self.USER_ID])
        items = self.full_weight(self.item_embedding)
        uu = u.repeat_interleave(self.n_items, dim=0)
        ii = items.repeat(u.shape[0], 1)
        out = self.mlp(torch.cat([uu, ii], dim=-1), activation="relu")
        return torch.sigmoid(out[:, 0]).reshape(-1)
