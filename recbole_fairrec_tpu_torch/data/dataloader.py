"""Batch producers for training and full-sort evaluation.

Counterpart of ``recbole_fairrec_tpu/data/dataloader.py``, with the same
payloads, batch-size rules and numpy RNG call order:

* ``TrainDataLoader`` — raw-row batches of ``train_batch_size // times``
  rows, expanded by the negative-sampling strategy (pairwise ``neg_*``
  columns / pointwise pos+neg stacking with 1/0 labels);
* ``FullSortEvalDataLoader`` — yields (user_df, (history_u, history_i),
  positive_u, positive_i) with history = used − positive, from flat CSR
  (indptr, values) structures built once at construction.

Batches are :class:`Interaction` objects of CPU tensors; the trainer moves
them to the card. Index payloads (positives, histories) stay numpy, since
the collector that consumes them is host numpy. The sampled-eval, FOCF and
user loaders are not ported yet.
"""

from __future__ import annotations

import math
from logging import getLogger

import numpy as np
import torch

from ..utils import FeatureSource, FeatureType, InputType, ModelType
from .interaction import Interaction


class _NegSpec:
    """Resolved negative-sampling strategy for one loader: the expansion
    factor (``times``) and the block-expansion layout."""

    def __init__(self, config, dataset, dl_format, neg_sample_args):
        self.dl_format = dl_format
        self.args = neg_sample_args
        self.strategy = neg_sample_args.get("strategy", "none")
        self.times = 1
        if self.strategy == "by":
            self.sample_num = neg_sample_args["by"]
            if dl_format == InputType.POINTWISE:
                self.times = 1 + self.sample_num
                self.label_field = config["LABEL_FIELD"]
                dataset.set_field_property(
                    self.label_field, FeatureType.FLOAT, FeatureSource.INTERACTION, 1
                )
            elif dl_format == InputType.PAIRWISE:
                self.times = self.sample_num
                self.neg_prefix = config["NEG_PREFIX"]
                item_cols = (
                    [dataset.iid_field]
                    if dataset.item_feat is None
                    else list(dataset.item_feat.columns)
                )
                for col in item_cols:
                    dataset.copy_field_property(self.neg_prefix + col, col)
            else:
                raise ValueError(
                    f"`neg sampling by` with dl_format [{dl_format}] not been implemented."
                )
        elif self.strategy != "none":
            raise ValueError(f"`neg_sample_args` [{self.strategy}] is not supported!")

    def expand(self, dataset, block, neg_item_ids):
        if self.dl_format == InputType.PAIRWISE:
            return self._pairwise(dataset, block, neg_item_ids)
        return self._pointwise(dataset, block, neg_item_ids)

    def _pairwise(self, dataset, block, neg_item_ids):
        out = block.repeat(self.times)
        neg_feat = dataset.join(Interaction({dataset.iid_field: neg_item_ids}))
        neg_feat.add_prefix(self.neg_prefix)
        out.update(neg_feat)
        return out

    def _pointwise(self, dataset, block, neg_item_ids):
        n_pos = len(block)
        out = block.repeat(self.times)
        out[dataset.iid_field][n_pos:] = torch.from_numpy(np.asarray(neg_item_ids))
        out = dataset.join(out)
        labels = np.zeros(n_pos * self.times, dtype=np.float32)
        labels[:n_pos] = 1.0
        out.update(Interaction({self.label_field: labels}))
        return out


class AbstractDataLoader:
    """pr/step cursor protocol."""

    def __init__(self, config, dataset, sampler, shuffle=False):
        self.config = config
        self.logger = getLogger()
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = self.step = self.model = None
        self.shuffle = shuffle
        self.pr = 0
        self._init_batch_size_and_step()

    def _init_batch_size_and_step(self):
        raise NotImplementedError

    def update_config(self, config):
        self.config = config
        self._init_batch_size_and_step()

    def set_batch_size(self, batch_size):
        if self.pr != 0:
            raise PermissionError("Cannot change dataloader's batch_size while iterating")
        self.batch_size = batch_size

    def __len__(self):
        return math.ceil(self.pr_end / self.step)

    def __iter__(self):
        if self.shuffle:
            self._shuffle()
        return self

    def __next__(self):
        if self.pr >= self.pr_end:
            self.pr = 0
            raise StopIteration()
        return self._next_batch_data()

    @property
    def pr_end(self):
        raise NotImplementedError

    def _shuffle(self):
        raise NotImplementedError

    def _next_batch_data(self):
        raise NotImplementedError

    def get_model(self, model):
        """Register the live model (dynamic negative sampling hook)."""
        self.model = model

    @property
    def max_batch_rows(self):
        """Upper bound on rows any batch of this loader can produce."""
        return self.batch_size


class TrainDataLoader(AbstractDataLoader):
    def __init__(self, config, dataset, sampler, shuffle=False):
        self._bind_neg_spec(config, dataset)
        super().__init__(config, dataset, sampler, shuffle=shuffle)

    def _bind_neg_spec(self, config, dataset):
        self.uid_field = dataset.uid_field
        self.iid_field = dataset.iid_field
        self.neg_spec = _NegSpec(
            config, dataset, config["MODEL_INPUT_TYPE"], config["train_neg_sample_args"]
        )

    @property
    def dl_format(self):
        return self.neg_spec.dl_format

    @property
    def times(self):
        return self.neg_spec.times

    @property
    def neg_sample_args(self):
        return self.neg_spec.args

    @property
    def neg_sample_num(self):
        return self.neg_spec.sample_num

    @property
    def neg_item_id(self):
        return self.neg_spec.neg_prefix + self.iid_field

    def _init_batch_size_and_step(self):
        budget = self.config["train_batch_size"]
        if self.neg_spec.strategy == "by":
            # raw rows per batch so the EXPANDED batch fits the budget
            self.step = max(budget // self.neg_spec.times, 1)
            self.set_batch_size(self.step * self.neg_spec.times)
        else:
            self.step = budget
            self.set_batch_size(budget)

    def update_config(self, config):
        self._bind_neg_spec(config, self.dataset)
        super().update_config(config)

    @property
    def pr_end(self):
        return len(self.dataset)

    def _shuffle(self):
        self.dataset.shuffle()

    def _neg_sampling(self, block: Interaction) -> Interaction:
        if self.neg_spec.args.get("dynamic", "none") not in (None, "none"):
            raise NotImplementedError(
                "dynamic (hard) negative sampling comes with the training slice of the port"
            )
        if self.neg_spec.strategy == "by":
            users = np.asarray(block[self.uid_field])
            items = np.asarray(block[self.iid_field])
            negs = self.sampler.sample_by_user_ids(users, items, self.neg_spec.sample_num)
            return self.neg_spec.expand(self.dataset, block, negs)
        return block

    def _next_batch_data(self):
        cur_data = self._neg_sampling(self.dataset[self.pr : self.pr + self.step])
        self.pr += self.step
        return cur_data


class FullSortEvalDataLoader(AbstractDataLoader):
    """Full-catalog eval over CSR-flat positive/history structures: a
    batch's payload is four contiguous slices."""

    def __init__(self, config, dataset, sampler, shuffle=False):
        self.uid_field = dataset.uid_field
        self.iid_field = dataset.iid_field
        self.is_sequential = config["MODEL_TYPE"] == ModelType.SEQUENTIAL
        if not self.is_sequential:
            dataset.sort(by=self.uid_field, ascending=True)
            uids = np.asarray(dataset.inter_feat[self.uid_field])
            iids = np.asarray(dataset.inter_feat[self.iid_field])
            item_num = np.uint64(dataset.item_num)

            # positives: unique (uid, iid) pairs of this split, CSR by user
            pair_keys = np.unique(
                uids.astype(np.uint64) * item_num + iids.astype(np.uint64)
            )
            pos_uid = (pair_keys // item_num).astype(np.int64)
            self._pos_items = (pair_keys % item_num).astype(np.int64)
            self.uid_list = np.unique(pos_uid)
            self._pos_indptr = np.searchsorted(
                pos_uid, np.append(self.uid_list, self.uid_list[-1] + 1)
            )

            # history: the phase sampler's used pairs minus this split's
            # positives, for evaluated users only (sorted-key set difference)
            used_keys = np.asarray(
                getattr(sampler, "_used_keys", np.array([], dtype=np.uint64)),
                dtype=np.uint64,
            )
            if len(used_keys):
                used_uid = (used_keys // item_num).astype(np.int64)
                keep = np.isin(used_uid, self.uid_list)
                pos_hit = np.searchsorted(pair_keys, used_keys)
                pos_hit = np.clip(pos_hit, 0, len(pair_keys) - 1)
                keep &= pair_keys[pos_hit] != used_keys
                hist_keys = used_keys[keep]
            else:
                hist_keys = used_keys
            hist_uid = (hist_keys // item_num).astype(np.int64)
            self._hist_items = (hist_keys % item_num).astype(np.int64)
            self._hist_indptr = np.searchsorted(
                hist_uid, np.append(self.uid_list, self.uid_list[-1] + 1)
            )

            self.user_df = dataset.join(Interaction({self.uid_field: self.uid_list}))
        super().__init__(config, dataset, sampler, shuffle=shuffle)

    def _init_batch_size_and_step(self):
        budget = self.config["eval_batch_size"]
        if not self.is_sequential:
            # one user's full-sort row costs |I| scores
            self.step = max(budget // self.dataset.item_num, 1)
            self.set_batch_size(self.step * self.dataset.item_num)
        else:
            self.step = budget
            self.set_batch_size(budget)

    @property
    def pr_end(self):
        if not self.is_sequential:
            return len(self.uid_list)
        return len(self.dataset)

    @property
    def max_history_len(self):
        """Longest history any evaluated user carries (streaming-eval k')."""
        if self.is_sequential or not len(self.uid_list):
            return 0
        return int(np.diff(self._hist_indptr).max(initial=0))

    def history_items(self, uids):
        """History item arrays for the given user ids."""
        pos = np.searchsorted(self.uid_list, np.asarray(uids))
        return [
            self._hist_items[self._hist_indptr[p] : self._hist_indptr[p + 1]]
            for p in pos
        ]

    def _shuffle(self):
        self.logger.warning("FullSortEvalDataLoader can't shuffle")

    def _next_batch_data(self):
        if self.is_sequential:
            interaction = self.dataset[self.pr : self.pr + self.step]
            positive_u = np.arange(len(interaction), dtype=np.int64)
            positive_i = np.asarray(interaction[self.iid_field])
            self.pr += self.step
            return interaction, None, positive_u, positive_i

        j0, j1 = self.pr, min(self.pr + self.step, len(self.uid_list))
        user_df = self.user_df[j0:j1]
        local = np.arange(j1 - j0, dtype=np.int64)

        p0, p1 = self._pos_indptr[j0], self._pos_indptr[j1]
        positive_u = np.repeat(local, np.diff(self._pos_indptr[j0 : j1 + 1]))
        positive_i = self._pos_items[p0:p1]

        h0, h1 = self._hist_indptr[j0], self._hist_indptr[j1]
        history_u = np.repeat(local, np.diff(self._hist_indptr[j0 : j1 + 1]))
        history_i = self._hist_items[h0:h1]

        self.pr += self.step
        return user_df, (history_u, history_i), positive_u, positive_i
