"""FairGo_GCN — FairGo over a GCN backbone.

Counterpart of ``recbole_fairrec_tpu/models/fairgo_gcn.py``: in PRETRAIN the
ego table goes through a GCN over the rating-weighted bipartite graph
(``models/gcn.py``, Â = D̃^-½ (A + I) D̃^-½); finetune filters the raw
tables as FairGo_PMF does and bypasses the GCN. The GCN's matrix is a second
set of non-persistent buffers (``gcn_rows/cols/vals`` and, under dense
propagation, a float32 ``gcn_dense``). Dropout between the convolutions
draws from the model's dropout generator on the table's device.
"""

from __future__ import annotations

import torch

from ..ops.spmm import build_gcn_norm_coo
from .fairgo_base import FairGoBase
from .gcn import GCN


class FairGo_GCN(FairGoBase):
    def __init__(self, config, dataset, generator=None):
        if generator is None:
            generator = torch.Generator().manual_seed(int(config["seed"] or 0))
        super().__init__(config, dataset, generator)
        self.gcn_n_layers = config["gcn_n_layers"]
        self.hidden_channels = config["hidden_channels"]
        self.gcn_dropout = config["gcn_dropout"]
        self.gcn_act = config["gcn_act"]
        self._constant_buffers("gcn", build_gcn_norm_coo(
            self.rating_matrix, self.n_users, self.n_items), "gcn_dense", torch.float32)
        self.gcn = GCN(self.embedding_size, self.hidden_channels, self.embedding_size,
                       self.gcn_n_layers, generator)

    def _backbone_param_keys(self):
        return ["user_embedding", "item_embedding", "gcn"]

    def _ego_embeddings(self, train):
        all_embedding = super()._ego_embeddings(train)
        if self.train_stage == "pretrain":
            dense = self._buffers.get("gcn_dense")
            all_embedding = self.gcn(
                all_embedding, self.gcn_rows, self.gcn_cols, self.gcn_vals,
                act=self.gcn_act, dropout=self.gcn_dropout, train=train,
                generator=self.dropout_generator(all_embedding.device),
                dense=dense, csr=None if dense is not None else self._csr("gcn"),
            )
        return all_embedding
