"""Shared FairGo machinery (Wu et al., WWW'21: graph-based fair embeddings).

Counterpart of ``recbole_fairrec_tpu/models/fairgo_base.py``:

* a two-stage ``train_stage`` flag, set by the trainer: ``pretrain`` trains
  the backbone; ``finetune`` passes the WHOLE (U+I) embedding table through
  the per-attribute filter MLPs of the drawn subset, sums them and divides by
  the number of ALL attributes, before scoring;
* the discriminator loss propagates the filtered table ``n_layers`` hops
  through the row-normalised bipartite rating matrix D⁻¹A, aggregates the
  hops per ``aggr_method`` (WAP: their mean; LBA: a learned MLP over the
  concatenated hops; LVA: one loss per hop, weighted by ``vs_weights``
  normalised to sum 1), then attacks both the node embedding and this local
  one with one discriminator per attribute (BCE for a binary attribute, CE
  otherwise). The multiclass local logits go through a sigmoid before the
  CE, a quirk of the reference kept on purpose;
* model loss = MSE, minus ``fair_weight`` times the discriminator loss in
  finetune;
* predictions clamped to [0, max_rating] / max_rating.

Parameters follow the JAX package's tree: ``user_embedding`` /
``item_embedding`` (N(0, 1), PAD row 0, or the dataset's preloaded
``.user_emb`` / ``.item_emb`` under ``load_pretrain_weight``),
``filters.<sst>`` and ``discriminators.<sst>`` (MLPs with nn.Linear's
default init, the activation after every layer) and ``aggr.l1/l2/l3``. The
propagation matrix (COO arrays, and the dense ``[n, n]`` matrix while it
stays under 2 GB in float32, or when ``dense_propagation`` says so) lives in
non-persistent buffers: it moves with the model to its device and never
enters a checkpoint, the port's form of the JAX package's
``attach_state_constants`` / ``strip_state_constants``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.spmm import build_bipartite_norm_coo, coo_to_dense, propagate
from ..utils import InputType
from .base import FairRecommender, batch_weights, wmean
from .layers import MLP, Linear, apply_activation, init_embedding
from .pfcn_base import _weighted_bce, _weighted_ce


class FairGoBase(FairRecommender):
    input_type = InputType.POINTWISE

    def __init__(self, config, dataset, generator=None):
        super().__init__(config, dataset)
        if generator is None:
            generator = torch.Generator().manual_seed(self._seed)
        self.RATING = config["RATING_FIELD"]
        self.n_layers = config["n_layers"]
        self.act = config["activation"]
        self.embedding_size = config["embedding_size"]
        self.dis_hidden_size_list = list(config["dis_hidden_size_list"])
        self.filter_hidden_size_list = list(config["filter_hidden_size_list"])
        self.sst_attrs = list(config["sst_attr_list"])
        self.fair_weight = config["fair_weight"]
        self.load_pretrain_weight = config["load_pretrain_weight"]
        self.train_stage = None  # set by the FairGo trainers
        self.aggr_method = config["aggr_method"].upper()
        if config["vs_weights"] is not None:
            vs = np.asarray(config["vs_weights"], dtype=np.float32)
            self.vs_weights = [float(v) for v in vs / vs.sum()]
            if self.aggr_method == "LVA" and self.n_layers != len(vs):
                raise ValueError("n_layers should be equal to length of vs_weights")

        self.max_rating = float(np.asarray(dataset.inter_feat[self.RATING]).max())
        self.rating_matrix = dataset.inter_matrix(form="coo", value_field=self.RATING).astype(
            np.float32
        )
        self.sst_lut, self.sst_size = {}, {}
        for sst in self.sst_attrs:
            self.sst_lut[sst], self.sst_size[sst] = self._sst_code_map(dataset, sst)

        n = self.n_users + self.n_items
        cfg_dense = config["dense_propagation"]
        self.dense_propagation = bool(n * n * 4 <= (2 << 30) if cfg_dense is None else cfg_dense)
        self.propagation_dtype = (
            torch.bfloat16 if (config["propagation_dtype"] or "float32") == "bfloat16"
            else torch.float32
        )
        self._constant_buffers("norm", build_bipartite_norm_coo(
            self.rating_matrix, self.n_users, self.n_items), "prop_dense",
            self.propagation_dtype)

        d = self.embedding_size
        self.user_embedding = init_embedding(self.n_users, d, "normal", generator, padding_idx=0)
        self.item_embedding = init_embedding(self.n_items, d, "normal", generator, padding_idx=0)
        if self.load_pretrain_weight:
            with torch.no_grad():
                for table, field in ((self.user_embedding, "uid"), (self.item_embedding, "iid")):
                    table.weight.copy_(torch.as_tensor(
                        np.asarray(dataset.get_preload_weight(field)), dtype=torch.float32))
        self.filters = nn.ModuleDict({
            sst: MLP(self._filter_sizes(), "torch_linear", generator=generator)
            for sst in self.sst_attrs
        })
        self.discriminators = nn.ModuleDict({
            sst: MLP(self._dis_sizes(sst), "torch_linear", generator=generator)
            for sst in self.sst_attrs
        })
        # LBA head: Linear(L·d → d) → act → Linear(d → d) → act → Linear(d → d)
        self.aggr = nn.ModuleDict({
            "l1": Linear(self.n_layers * d, d, "torch_linear", generator),
            "l2": Linear(d, d, "torch_linear", generator),
            "l3": Linear(d, d, "torch_linear", generator),
        })

    def _constant_buffers(self, prefix, coo, dense_name, dense_dtype):
        """The COO arrays ``<prefix>_rows/cols/vals`` and, under dense
        propagation, the dense matrix ``dense_name``, as non-persistent
        buffers."""
        rows, cols, vals = coo
        for name, array in (("rows", rows), ("cols", cols), ("vals", vals)):
            self.register_buffer(f"{prefix}_{name}", torch.from_numpy(array), persistent=False)
        if self.dense_propagation:
            dense = coo_to_dense(rows, cols, vals, self.n_users + self.n_items)
            self.register_buffer(dense_name, torch.from_numpy(dense).to(dense_dtype),
                                 persistent=False)

    # ---------------------------------------------------------------- params

    def _filter_sizes(self):
        d = self.embedding_size
        return [d] + self.filter_hidden_size_list + [d]

    def _dis_sizes(self, sst):
        out = self.sst_size[sst]
        if out == 2:
            out = 1
        return [self.embedding_size] + self.dis_hidden_size_list + [out]

    def param_groups(self):
        """The reference trainers' three optimizers: ``pretrain`` = the
        backbone; ``filter`` = the filters; ``dis`` = the discriminators (and
        the aggregation head under LBA)."""
        return {
            "pretrain": self._backbone_param_keys(),
            "filter": ["filters"],
            "dis": ["discriminators"] + (["aggr"] if self.aggr_method == "LBA" else []),
        }

    def _backbone_param_keys(self):
        return ["user_embedding", "item_embedding"]

    # --------------------------------------------------------------- forward

    def _ego_embeddings(self, train):
        """Backbone representation of all U+I nodes (stage-aware)."""
        return torch.cat([self.full_weight(self.user_embedding),
                          self.full_weight(self.item_embedding)], dim=0)

    def forward(self, sst_list=None, train=False):
        """(user table, item table): the backbone's, filtered in finetune."""
        all_embedding = self._ego_embeddings(train)
        if self.train_stage == "finetune":
            temp = None
            for sst in sst_list or self.sst_attrs:
                out = self.filters[sst](all_embedding, activation=self.act)
                temp = out if temp is None else temp + out
            all_embedding = temp / len(self.sst_attrs)
        return all_embedding[: self.n_users], all_embedding[self.n_users:]

    def _aggr(self, hops):
        x = torch.cat(hops, dim=1)
        x = apply_activation(self.act, self.aggr["l1"](x))
        x = apply_activation(self.act, self.aggr["l2"](x))
        return self.aggr["l3"](x)

    # ------------------------------------------------------------------ loss

    def loss_batch_fields(self, loss_name, sst_list=None):
        return (self.USER_ID, self.ITEM_ID, self.RATING, *self.sst_attrs, "__weight__")

    def calculate_loss(self, batch, sst_list=None):
        """Weighted MSE of the rating; in finetune minus ``fair_weight``
        times the discriminator loss over the same filtered tables."""
        user_all, item_all = self.forward(sst_list, train=True)
        pred = (user_all[batch[self.USER_ID]] * item_all[batch[self.ITEM_ID]]).sum(-1)
        w = batch_weights(batch)
        mse = wmean((pred - batch[self.RATING].float()) ** 2, w)
        if self.train_stage == "finetune":
            return mse - self.fair_weight * self._dis_loss(user_all, item_all, batch, sst_list, w)
        return mse

    def calculate_dis_loss(self, batch, sst_list=None):
        user_all, item_all = self.forward(sst_list, train=True)
        return self._dis_loss(user_all, item_all, batch, sst_list, batch_weights(batch))

    def _dis_loss(self, user_all, item_all, batch, sst_list, w):
        """Node + local discriminator losses over ``sst_list`` (every
        attribute when empty)."""
        sst_list = sst_list or tuple(self.sst_attrs)
        user = batch[self.USER_ID]
        user_node = user_all[user]
        n = self.n_users + self.n_items
        dense = self._buffers.get("prop_dense")
        x = torch.cat([user_all, item_all], dim=0)
        hops = []
        for _ in range(self.n_layers):
            x = propagate(x, self.norm_rows, self.norm_cols, self.norm_vals, n, dense=dense)
            hops.append(x)

        lva_mode = self.aggr_method == "LVA" and self.n_layers > 1
        if self.n_layers == 1:
            locals_ = [hops[0][: self.n_users][user]]
        elif self.aggr_method == "WAP":
            locals_ = [torch.stack(hops, dim=1).mean(dim=1)[: self.n_users][user]]
        elif self.aggr_method == "LBA":
            locals_ = [self._aggr(hops)[: self.n_users][user]]
        elif lva_mode:
            locals_ = [h[: self.n_users][user] for h in hops]
        else:
            raise ValueError(f"aggr_method [{self.aggr_method}] not supported")
        local_weights = self.vs_weights if lva_mode else [None]

        node_loss = 0.0
        local_loss = 0.0
        for sst in sst_list:
            labels = self._on_device(sst, self.sst_lut[sst], user.device)[batch[sst].long()]
            dis = self.discriminators[sst]
            if self.sst_size[sst] == 2:
                t = labels.float()[:, None]
                node_loss = node_loss + _weighted_bce(
                    torch.sigmoid(dis(user_node, activation=self.act)), t, w)
                for vs, local in zip(local_weights, locals_):
                    term = _weighted_bce(torch.sigmoid(dis(local, activation=self.act)), t, w)
                    local_loss = local_loss + (term if vs is None else vs * term)
            else:
                node_loss = node_loss + _weighted_ce(dis(user_node, activation=self.act),
                                                     labels, w)
                for vs, local in zip(local_weights, locals_):
                    # the reference wraps these logits in a sigmoid: kept
                    term = _weighted_ce(torch.sigmoid(dis(local, activation=self.act)),
                                        labels, w)
                    local_loss = local_loss + (term if vs is None else vs * term)
        return node_loss + local_loss

    # ------------------------------------------------------------------- API

    def _clamped(self, scores):
        return torch.clamp(scores.reshape(-1), 0.0, self.max_rating) / self.max_rating

    def predict(self, batch, sst_list=None):
        user_all, item_all = self.forward(tuple(self.sst_attrs))
        return self._clamped(
            (user_all[batch[self.USER_ID]] * item_all[batch[self.ITEM_ID]]).sum(-1))

    def full_sort_predict(self, batch, sst_list=None):
        user_all, item_all = self.forward(tuple(self.sst_attrs))
        return self._clamped(self.score_matmul(user_all[batch[self.USER_ID]], item_all.T))

    @torch.no_grad()
    def get_sst_embed(self, user_data, sst_list=None):
        """The representations of users 1..n−1 for ``sst_list`` (every
        attribute when None) and their sensitive attributes (``user_data`` is
        the user feature table without its PAD row)."""
        sst_list = tuple(self.sst_attrs) if sst_list is None else tuple(sst_list)
        ret = {sst: np.asarray(user_data[sst])[: self.n_users - 1] for sst in sst_list}
        user_all, _ = self.forward(sst_list)
        ret["embedding"] = user_all[1:].cpu().numpy()
        return ret
