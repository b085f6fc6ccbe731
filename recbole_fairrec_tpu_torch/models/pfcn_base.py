"""Shared machinery of the PFCN family (counterfactual filter networks).

Counterpart of ``recbole_fairrec_tpu/models/pfcn_base.py``:

* filter modes: ``cm`` = one filter per attribute (outputs summed, then
  divided by the TOTAL filter count), ``sm`` = one filter per attribute
  subset, indexed by Σ 2^i, ``none`` = the raw embeddings (PFCN_PMF is then
  BPR-MF);
* filter MLPs ``[d, 2d, d]`` with BatchNorm and normal(0, .01) init;
* one discriminator MLP per attribute, ``[d] + dis_hidden + [1 | n_classes]``
  with BatchNorm, sigmoid + BCE for a binary attribute and softmax CE
  otherwise; group labels go through a lookup table;
* adversarial loss = BPR − dis_weight · discriminator loss; the filters run
  a second time for the discriminator term, so their BatchNorm running
  statistics move twice per filter step, as in the JAX package;
* ``get_sst_embed`` exports the filtered user representations.

Where the JAX package threads ``state`` (the BN running statistics) through
each call, the filters and discriminators here hold them as buffers and a
training forward moves them in place.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..parallel.collectives import batch_rows, batch_sum, gather_batch
from ..utils import InputType
from .base import FairRecommender, batch_weights, wmean
from .layers import MLP
from .losses import bce_elementwise


def _weighted_bce(probs, targets, w):
    elem = bce_elementwise(probs, targets)
    return wmean(elem.reshape(elem.shape[0], -1).mean(dim=-1), w)


def _weighted_ce(logits, labels, w):
    logp = torch.log_softmax(logits, dim=-1)
    elem = -torch.gather(logp, -1, labels[:, None]).squeeze(-1)
    return wmean(elem, w)


class PFCNBase(FairRecommender):
    input_type = InputType.PAIRWISE

    def __init__(self, config, dataset):
        super().__init__(config, dataset)
        self.embedding_size = config["embedding_size"]
        self.sst_attrs = list(config["sst_attr_list"])
        self.filter_mode = config["filter_mode"].lower()
        if self.filter_mode not in ("cm", "sm", "none"):
            raise AssertionError("filter_mode must be cm, sm or none")
        self.filter_num, self.sst_dict = self._get_filter_info()
        self._ref_bn_emulation = bool(config["reference_bn_eval_emulation"])
        if self.filter_mode != "none":
            self.dis_drop_out = config["dis_dropout"]
            self.dis_weight = config["dis_weight"]
            self.dis_hidden_size_list = list(config["dis_hidden_size_list"])
        self.activation = config["activation"]
        self.sst_lut = {}
        self.sst_size = {}
        for sst in self.sst_attrs:
            lut, k = self._sst_code_map(dataset, sst)
            self.sst_lut[sst] = lut
            self.sst_size[sst] = k

    # ------------------------------------------------------------ structure

    def _get_filter_info(self):
        if self.filter_mode == "cm":
            return len(self.sst_attrs), {s: i + 1 for i, s in enumerate(self.sst_attrs)}
        if self.filter_mode == "sm":
            return 2 ** len(self.sst_attrs) - 1, {
                s: 2**i for i, s in enumerate(self.sst_attrs)
            }
        return 0, {}

    def _filter_sizes(self):
        d = self.embedding_size
        return [d, 2 * d, d]

    def _dis_sizes(self, sst):
        out = self.sst_size[sst]
        if out == 2:
            out = 1
        return [self.embedding_size] + self.dis_hidden_size_list + [out]

    def _dis_activation(self):
        return self.activation

    def _generator(self, generator):
        """The init generator: the caller's, or one seeded from the config."""
        if generator is None:
            generator = torch.Generator().manual_seed(self._seed)
        return generator

    def _init_adversarial(self, generator):
        """The filters ``f1 … f<filter_num>`` and one discriminator per
        attribute (nothing with ``filter_mode: none``)."""
        if self.filter_mode == "none":
            return
        self.filters = nn.ModuleDict({
            f"f{i + 1}": MLP(self._filter_sizes(), "norm", bn=True, generator=generator)
            for i in range(self.filter_num)
        })
        self.discriminators = nn.ModuleDict({
            sst: MLP(self._dis_sizes(sst), "norm", bn=True, generator=generator)
            for sst in self.sst_attrs
        })

    def _device_lut(self, sst, device):
        return self._on_device(sst, self.sst_lut[sst], device)

    # -------------------------------------------------------------- filters

    def _apply_filters(self, user_embed, sst_list, train, sample_weight=None, segments=None):
        """The filtered user representation for ``sst_list``. ``segments``
        (eval only; row → user id) switches the filters' BN to per-user
        statistics: the reference-defect emulation mode."""
        if self.filter_mode == "none" or not sst_list:
            return user_embed
        kw = {"activation": self.activation, "train": train, "sample_weight": sample_weight}
        if segments is not None:
            kw.update(segments=segments.long(), num_segments=self.n_users)
        if self.filter_mode == "sm":
            idx = sum(self.sst_dict[s] for s in sst_list)
            return self.filters[f"f{idx}"](user_embed, **kw)
        out = None
        for s in sst_list:
            o = self.filters[f"f{self.sst_dict[s]}"](user_embed, **kw)
            out = o if out is None else out + o
        return out / self.filter_num

    # ------------------------------------------------------- discriminators

    def _dis_loss(self, user_embed, batch, sst_list, train, w):
        """Σ over the attributes of the discriminator objective."""
        total = 0.0
        generator = self.dropout_generator(user_embed.device)
        for sst in sst_list:
            labels = self._device_lut(sst, user_embed.device)[batch[sst].long()]
            out = self.discriminators[sst](
                user_embed, activation=self._dis_activation(), dropout=self.dis_drop_out,
                train=train, generator=generator, sample_weight=w,
            )
            if self.sst_size[sst] == 2:
                total = total + _weighted_bce(torch.sigmoid(out), labels.float()[:, None], w)
            else:
                total = total + _weighted_ce(out, labels, w)
        return total

    # ----------------------------------------------------- model API pieces

    def _user_item_embed(self, user, item, sst_list, train=False, sample_weight=None):
        """Backbone-specific: returns (user_repr, item_repr)."""
        raise NotImplementedError

    def _pairwise_scores(self, batch, user, pos_item, neg_item, sst_list, train=False,
                         sample_weight=None):
        """Backbone-specific raw (pos_score, neg_score) for BPR."""
        raise NotImplementedError

    def _segments(self, user, train):
        """Row → user ids for the filters' BN in the emulation mode (eval
        only), else None."""
        return user if (self._ref_bn_emulation and not train) else None

    def loss_batch_fields(self, loss_name, sst_list=None):
        return (self.USER_ID, self.ITEM_ID, self.POS_ITEM_ID, self.NEG_ITEM_ID,
                *self.sst_attrs, "__weight__")

    def calculate_loss(self, batch, sst_list=None):
        """BPR over the batch's (user, positive, negative) rows — the mean of
        −log(1e-10 + σ(pos − neg)), weighted by ``__weight__`` when the batch
        carries one — minus ``dis_weight`` times the discriminators' loss
        when the model has filters."""
        user = batch[self.USER_ID]
        w = batch_weights(batch)
        pos_s, neg_s = self._pairwise_scores(
            batch, user, batch[self.POS_ITEM_ID], batch[self.NEG_ITEM_ID], sst_list,
            train=True, sample_weight=w,
        )
        elem = -torch.log(1e-10 + torch.sigmoid(pos_s - neg_s))
        if w is None:
            if batch_rows(1) == 1:
                loss = elem.mean()
            else:  # split over the data axis: rows here, columns the whole batch's
                loss = wmean(elem.mean(dim=-1) if elem.dim() == 2 else elem, None)
        elif elem.dim() == 2:
            # [B, B] cross-pair scores (PFCN_BiasedMF): each pair weighs w_i·w_j
            w2 = w[:, None] * gather_batch(w)[None, :]
            loss = batch_sum(torch.sum(elem * w2)) / batch_sum(torch.sum(w2)).clamp_min(1.0)
        else:
            loss = wmean(elem, w)
        if self.filter_mode != "none":
            return loss - self.dis_weight * self._dis_from_batch(batch, sst_list, w)
        return loss

    def calculate_dis_loss(self, batch, sst_list=None):
        return self._dis_from_batch(batch, sst_list, batch_weights(batch))

    def _dis_from_batch(self, batch, sst_list, w):
        user_repr, _ = self._user_item_embed(
            batch[self.USER_ID], None, sst_list, train=True, sample_weight=w
        )
        return self._dis_loss(user_repr, batch, sst_list, True, w)

    @torch.no_grad()
    def get_sst_embed(self, user_data, sst_list=None):
        """User representations of users 1..n−1 for ``sst_list`` (every
        attribute with ``filter_mode: none``) and their sensitive attributes
        (``user_data`` is the user feature table without its PAD row), for
        offline attacker evaluation."""
        device = next(self.parameters()).device
        user_indices = torch.arange(1, self.n_users, device=device)
        sst_list = tuple(self.sst_attrs) if self.filter_mode == "none" else sst_list
        ret = {sst: np.asarray(user_data[sst])[: self.n_users - 1] for sst in sst_list}
        user_repr, _ = self._user_item_embed(user_indices, None, sst_list)
        ret["embedding"] = user_repr.cpu().numpy()
        return ret

    def param_groups(self):
        """The reference trainers' two optimizers: ``filter`` covers the
        backbone and the filters, ``dis`` the discriminators."""
        if self.filter_mode == "none":
            return {}
        return {"filter": self._backbone_param_keys() + ["filters"], "dis": ["discriminators"]}

    def _backbone_param_keys(self):
        raise NotImplementedError
