"""Model base classes.

Counterpart of ``recbole_fairrec_tpu/models/base.py``. The JAX package keeps
models stateless and threads a parameter pytree through pure methods; here a
model is an ``nn.Module`` that owns its tables, and the contract methods take
only the batch:

    loss = model.calculate_loss(batch, sst_list)
    scores = model.predict(batch, sst_list)
    scores = model.full_sort_predict(batch, sst_list)

``batch`` is a dict of tensors on the model's device. Parameter names match
the JAX param-tree keys (``user_embedding`` …) so a JAX checkpoint loads with
``utils.jax_params.load_jax_params``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils import InputType, ModelType, set_color


class AbstractRecommender(nn.Module):
    type = ModelType.GENERAL
    input_type = InputType.POINTWISE
    # True iff the model exposes ``retrieval_embeddings`` AND its full-sort
    # score is a rank-preserving (monotone) transform of the retrieval dot
    # product; the trainer refuses the retrieval eval path otherwise.
    retrieval_monotone = False

    def __init__(self):
        super().__init__()
        self.other_parameter_name = []

    # ---------------------------------------------------------- contract

    def calculate_loss(self, batch, sst_list=None):
        raise NotImplementedError

    def predict(self, batch, sst_list=None):
        raise NotImplementedError

    def full_sort_predict(self, batch, sst_list=None):
        raise NotImplementedError

    # ------------------------------------------------------------- extras

    def other_parameter(self):
        return {key: getattr(self, key) for key in self.other_parameter_name}

    def load_other_parameter(self, para):
        if para is None:
            return
        for key, value in para.items():
            setattr(self, key, value)

    def count_parameters(self):
        return sum(p.numel() for p in self.parameters())

    def __str__(self):
        return set_color(self.__class__.__name__, "blue")


class FairRecommender(AbstractRecommender):
    """Base for fairness-aware models."""

    type = ModelType.GENERAL

    def __init__(self, config, dataset):
        super().__init__()
        self.USER_ID = config["USER_ID_FIELD"]
        self.ITEM_ID = config["ITEM_ID_FIELD"]
        self.NEG_ITEM_ID = config["NEG_PREFIX"] + self.ITEM_ID
        self.POS_ITEM_ID = self.ITEM_ID
        self.n_users = dataset.num(self.USER_ID)
        self.n_items = dataset.num(self.ITEM_ID)
        self.config = config
        # float32 means float32: the ranking paths never run in TF32
        if config["compute_dtype"] not in (None, "float32"):
            raise NotImplementedError(
                f"compute_dtype [{config['compute_dtype']}] is not ported yet"
            )

    def calculate_dis_loss(self, batch, sst_list=None):
        """Discriminator objective for adversarial models."""
        raise NotImplementedError

    @staticmethod
    def lookup(table: nn.Embedding, ids):
        """Embedding-table row lookup."""
        return table(ids)

    def get_sst_embed(self, user_data, sst_list=None):
        raise NotImplementedError

    # ------------------------------------------------------------ helpers

    @staticmethod
    def _sst_code_map(dataset, sst_field):
        """Global value→column mapping for a sensitive attribute: sorted
        non-PAD values → 0..k-1, as a lookup tensor, and k."""
        feat = dataset.get_user_feature()
        if sst_field not in feat:
            raise ValueError(
                f"{sst_field} sensitive attribute not in user feature"
            )
        values = np.asarray(feat[sst_field])[1:]  # drop PAD row
        uniq = np.unique(values)
        lut = np.zeros(int(max(uniq.max(), 0)) + 1, dtype=np.int64)
        for i, v in enumerate(uniq):
            lut[int(v)] = i
        return torch.from_numpy(lut), len(uniq)
