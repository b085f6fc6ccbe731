"""Model base classes.

Counterpart of ``recbole_fairrec_tpu/models/base.py``. The JAX package keeps
models stateless and threads a parameter pytree through pure methods; here a
model is an ``nn.Module`` that owns its tables, and the contract methods take
only the batch:

    loss = model.calculate_loss(batch, sst_list)   # a scalar tensor with grad
    scores = model.predict(batch, sst_list)
    scores = model.full_sort_predict(batch, sst_list)

``batch`` is a dict of tensors on the model's device. Parameter names match
the JAX param-tree keys (``user_embedding`` …) so a JAX checkpoint loads with
``utils.jax_params.load_jax_params``.

Under a mesh (``parallel/``; the trainer calls ``parallel.shard_params``) a
model holds only its rank's rows of the row-sharded tables
(``row_shards``): :meth:`FairRecommender.lookup` goes through the exchange
and :meth:`FairRecommender.full_weight` gathers a whole table, and while a
batch is split over the data axis :func:`wmean` is the mean of the whole
batch.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..parallel.collectives import batch_rows, batch_sum, gather_rows
from ..utils import InputType, ModelType, set_color


def batch_weights(batch):
    """The batch's ``__weight__`` validity column (1.0 for real rows, 0.0
    for padding rows), or None for a batch without padding."""
    w = batch.get("__weight__")
    return None if w is None else w.float()


def wmean(values, weights):
    """Mean of ``values`` weighted by ``weights``; the plain mean when
    ``weights`` is None. Over the whole batch while it is split over the
    data axis (``parallel/collectives.py``)."""
    if weights is None:
        n = batch_rows(values.numel())
        if n == values.numel():
            return values.mean()
        return batch_sum(values.sum()) / n
    return batch_sum(torch.sum(values * weights)) / batch_sum(torch.sum(weights)).clamp_min(1.0)


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
        self._seed = int(config["seed"] or 0)
        self._dropout_generators = {}
        self._device_copies = {}
        # float32 means float32: the ranking paths never run in TF32.
        # compute_dtype: bfloat16 opts the full-sort score products into
        # bfloat16 operands with float32 accumulation (parameters stay f32)
        if config["compute_dtype"] not in (None, "float32", "bfloat16"):
            raise ValueError(f"compute_dtype [{config['compute_dtype']}] is not supported")
        self.compute_dtype = (
            torch.bfloat16 if config["compute_dtype"] == "bfloat16" else torch.float32
        )
        self.mesh = None
        self.row_shards = {}  # set by parallel.shard_params

    def calculate_dis_loss(self, batch, sst_list=None):
        """Discriminator objective for adversarial models."""
        raise NotImplementedError

    def loss_batch_fields(self, loss_name, sst_list=None):
        """Batch columns the given loss reads; the trainer moves only those
        to the card. None = every column."""
        return None

    def frozen_param_keys(self):
        """Top-level parameter names the optimizer must leave untouched."""
        return []

    def param_groups(self):
        """Adversarial optimizer groups: group name → top-level parameter
        names. Default: no groups."""
        return {}

    def dropout_generator(self, device):
        """The generator of this model's dropout masks on ``device``, seeded
        from the config's seed when first asked for."""
        key = str(device)
        if key not in self._dropout_generators:
            self._dropout_generators[key] = torch.Generator(device=device).manual_seed(self._seed)
        return self._dropout_generators[key]

    def _on_device(self, name, tensor, device):
        """``tensor`` (a lookup table that is not a parameter or a buffer, so
        that the state dict stays the JAX package's tree) on ``device``,
        copied there once."""
        key = (name, str(device))
        if key not in self._device_copies:
            self._device_copies[key] = tensor.to(device)
        return self._device_copies[key]

    def _row_shard(self, table):
        for name, shard in self.row_shards.items():
            if getattr(self, name) is table:
                return shard
        return None

    def lookup(self, table: nn.Embedding, ids):
        """Embedding-table row lookup; the exchange over the model axis for
        a row-sharded table (``parallel.embedding.sharded_gather``)."""
        if self._row_shard(table) is None:
            return table(ids)
        from ..parallel.embedding import sharded_gather

        return sharded_gather(self.mesh, table.weight, ids)

    def full_weight(self, table: nn.Embedding):
        """The whole table: the weight, or for a row-sharded table its rows
        gathered over the model axis (differentiable)."""
        shard = self._row_shard(table)
        if shard is None:
            return table.weight
        return gather_rows(table.weight, self.mesh.group(shard.axis),
                           self.mesh.index(shard.axis))

    def score_matmul(self, a, b):
        """``a @ b`` of a full-sort score: float32, or under ``compute_dtype:
        bfloat16`` bfloat16 operands into a float32 product
        (``torch.mm(..., out_dtype=float32)`` on the card; on the CPU, which
        has no kernel for it, the bfloat16 operands widened to float32,
        whose products are exact there)."""
        if self.compute_dtype != torch.bfloat16:
            return a @ b
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
        if a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()

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
