"""Batch producers for training and evaluation.

Counterpart of ``recbole_fairrec_tpu/data/dataloader.py``, with the same
payloads, batch-size rules and numpy RNG call order:

* ``TrainDataLoader`` — raw-row batches of ``train_batch_size // times``
  rows, expanded by the negative-sampling strategy (pairwise ``neg_*``
  columns / pointwise pos+neg stacking with 1/0 labels). With
  ``device_neg_sampling`` (pairwise, one uniform negative, not dynamic) it
  ships the raw positives and the trainer draws the negatives on its device
  (``ops/neg_sampling.py``); with ``dynamic`` it mines hard negatives
  through the live trainer's ``score_batch``;
* ``NegSampleEvalDataLoader`` — sampled evaluation (``uni100`` /
  ``pop100``): whole-user batches (a user's rows never straddle a batch)
  yielding (Interaction, row_idx, positive_u, positive_i), negatives drawn
  with one sampler call per user in user order; labeled evaluation
  (strategy ``none``) yields plain row slices with ``row_idx = None``;
* ``FullSortEvalDataLoader`` — yields (user_df, (history_u, history_i),
  positive_u, positive_i) with history = used − positive, from flat CSR
  (indptr, values) structures built once at construction;
* ``FOCFDataLoader`` — item-grouped train batches (every row of randomly
  drawn items until the row budget fills);
* ``UserDataLoader`` — every user id once per pass, shuffled, in batches of
  ``train_batch_size`` (the train loader of the autoencoder family, which
  ``data.utils._get_AE_dataloader`` names; no model of this family uses it).

Batches are :class:`Interaction` objects of CPU tensors; the trainer moves
them to the card. Index payloads (positives, histories, row ids) stay numpy,
since the collector that consumes them is host numpy.
"""

from __future__ import annotations

import math
from logging import getLogger

import numpy as np
import torch

from ..utils import FeatureSource, FeatureType, InputType, ModelType, tracing
from .interaction import Interaction


class _UserSegments:
    """Row segments of a table sorted by one id column, as flat arrays:
    ``uid[j]`` owns rows ``lo[j]:hi[j]``."""

    __slots__ = ("uid", "lo", "hi")

    def __init__(self, uid, lo, hi):
        self.uid, self.lo, self.hi = uid, lo, hi

    @classmethod
    def from_sorted(cls, uids):
        if len(uids) == 0:
            z = np.array([], dtype=np.int64)
            return cls(z, z.copy(), z.copy())
        bounds = np.nonzero(np.diff(uids, prepend=uids[0] - 1))[0]
        return cls(
            uids[bounds].astype(np.int64),
            bounds.astype(np.int64),
            np.append(bounds[1:], len(uids)).astype(np.int64),
        )

    def __len__(self):
        return len(self.uid)

    @property
    def rows(self):
        """Row count per segment."""
        return self.hi - self.lo


def _greedy_user_budget(rows_per_user, budget):
    """How many whole users fit a row budget, sized against the worst case:
    per-user costs sorted descending, users taken while the running sum
    stays within ``budget`` (always at least one).

    Returns (users_per_batch, worst_case_rows).
    """
    desc = np.sort(np.asarray(rows_per_user))[::-1]
    cum = np.cumsum(desc)
    n = max(int(np.searchsorted(cum, budget, side="right")), 1)
    return n, int(cum[n - 1])


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


class _NegSamplingLoader(AbstractDataLoader):
    """Negative-sampling plumbing shared by the train and sampled-eval
    cursors."""

    def _bind_neg_spec(self, config, dataset, dl_format, neg_sample_args):
        self.uid_field = dataset.uid_field
        self.iid_field = dataset.iid_field
        self.neg_spec = _NegSpec(config, dataset, dl_format, neg_sample_args)
        # device sampling covers the pairwise 1-negative shape
        self.device_neg_sampling = bool(
            config["device_neg_sampling"]
            and dl_format == InputType.PAIRWISE
            and self.neg_spec.strategy == "by"
            and neg_sample_args.get("by") == 1
            and neg_sample_args.get("dynamic", "none") in (None, "none")
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

    def _neg_sampling(self, block: Interaction) -> Interaction:
        if self.device_neg_sampling:
            # the trainer draws the negatives in its step
            return block
        if self.neg_spec.args.get("dynamic", "none") not in (None, "none"):
            return self._mine_hard_negatives(block)
        if self.neg_spec.strategy == "by":
            users = np.asarray(block[self.uid_field])
            items = np.asarray(block[self.iid_field])
            negs = self.sampler.sample_by_user_ids(users, items, self.neg_spec.sample_num)
            return self.neg_spec.expand(self.dataset, block, negs)
        return block

    def _mine_hard_negatives(self, block: Interaction) -> Interaction:
        """Score candidate_num× candidates with the live model (the trainer
        registered through ``get_model``) and keep the best-scored one."""
        candidate_num = self.neg_spec.args["dynamic"]
        users = np.asarray(block[self.uid_field])
        items = np.asarray(block[self.iid_field])
        n_draw = self.neg_spec.sample_num * candidate_num
        candidates = self.sampler.sample_by_user_ids(users, items, n_draw)
        scored = block.repeat(n_draw)
        scored.update(Interaction({self.iid_field: candidates}))
        scores = np.asarray(self.model.score_batch(scored)).reshape(candidate_num, -1)
        grid = candidates.reshape(candidate_num, -1)
        hardest = grid[scores.argmax(axis=0), np.arange(grid.shape[1])].reshape(-1)
        return self.neg_spec.expand(self.dataset, block, hardest)


class TrainDataLoader(_NegSamplingLoader):
    def __init__(self, config, dataset, sampler, shuffle=False):
        self._bind_neg_spec(
            config, dataset, config["MODEL_INPUT_TYPE"], config["train_neg_sample_args"]
        )
        super().__init__(config, dataset, sampler, shuffle=shuffle)

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
        self._bind_neg_spec(
            config, self.dataset, config["MODEL_INPUT_TYPE"], config["train_neg_sample_args"]
        )
        super().update_config(config)

    @property
    def pr_end(self):
        return len(self.dataset)

    def _shuffle(self):
        self.dataset.shuffle()

    def _next_batch_data(self):
        with tracing.span("dataloader.train_fetch") as sp:
            cur_data = self._neg_sampling(self.dataset[self.pr : self.pr + self.step])
            sp.set("rows", len(cur_data))
        self.pr += self.step
        return cur_data


class NegSampleEvalDataLoader(_NegSamplingLoader):
    """Sampled evaluation: one user's rows never straddle a batch.

    The uid-sorted table is segmented once (:class:`_UserSegments`); a batch
    is the next ``step`` segments. Negatives are drawn with one sampler call
    per user in user order: the numpy RNG stream is what makes the batches
    equal to the JAX package's under one seed, so it is never fused into one
    vectorised draw. With strategy ``none`` (labeled evaluation) a batch is
    the next ``eval_batch_size`` rows, yielded as (Interaction, None, None,
    None).
    """

    def __init__(self, config, dataset, sampler, shuffle=False):
        self._bind_neg_spec(
            config, dataset, InputType.POINTWISE, config["eval_neg_sample_args"]
        )
        if self.neg_spec.strategy == "by":
            dataset.sort(by=dataset.uid_field, ascending=True)
            self.segments = _UserSegments.from_sorted(
                np.asarray(dataset.inter_feat[dataset.uid_field])
            )
            self.uid_list = self.segments.uid
        self._expand_cache = {}
        self._macro_sized = False
        super().__init__(config, dataset, sampler, shuffle=shuffle)

    def _init_batch_size_and_step(self):
        budget = self.config["eval_batch_size"]
        if self.neg_spec.strategy == "by":
            users, worst = _greedy_user_budget(
                self.segments.rows * self.neg_spec.times, budget
            )
            self.step = users
            self.set_batch_size(worst)
        else:
            self.step = budget
            self.set_batch_size(budget)

    def update_config(self, config):
        self._bind_neg_spec(
            config, self.dataset, InputType.POINTWISE, config["eval_neg_sample_args"]
        )
        super().update_config(config)

    def set_macro_rows(self, target_rows):
        """Raise the cursor step so that one batch holds as many whole users
        as fit ``target_rows`` expanded rows (users split into near-equal
        chunks). The per-user draws and the per-user metric math do not
        depend on where batches end, so this changes neither the RNG stream
        nor the metrics; it only cuts the number of batches."""
        if self.neg_spec.strategy != "by" or not len(self.segments):
            return
        rows = self.segments.rows * self.neg_spec.times
        total = int(rows.sum())
        n_chunks = max(1, -(-total // int(target_rows)))
        step = -(-len(self.segments) // n_chunks)
        worst = max(int(rows[k : k + step].sum()) for k in range(0, len(rows), step))
        if step != self.step:
            self._expand_cache.clear()
        self.step = step
        self.set_batch_size(worst)
        # the trainer's macro merger passes such batches through as they are
        self._macro_sized = True

    def reset_macro_rows(self):
        """Undo :meth:`set_macro_rows`: the config-derived step and batch
        size again (the host scoring path is sized for those)."""
        if not self._macro_sized:
            return
        old_step = self.step
        self._init_batch_size_and_step()
        if self.step != old_step:
            self._expand_cache.clear()
        self._macro_sized = False

    @property
    def pr_end(self):
        if self.neg_spec.strategy == "by":
            return len(self.segments)
        return len(self.dataset)

    def _shuffle(self):
        self.logger.warning("NegSampleEvalDataLoader can't shuffle")

    def _skeleton(self, j0, j1):
        """Everything of the batch of users ``j0:j1`` but the negative draws,
        cached per window: per user the positive block tiled ``times`` times
        (positives first, then the copies whose item column the draws
        rewrite), labels 1 for the first block."""
        key = (j0, j1, self.neg_spec.times)
        skel = self._expand_cache.get(key)
        if skel is not None:
            return skel
        lo, hi = self.segments.lo[j0:j1], self.segments.hi[j0:j1]
        base = int(lo[0])
        times = self.neg_spec.times
        counts = (hi - lo).astype(np.int64)
        tbl = self.dataset[base : int(hi[-1])]  # one joined slice
        rows_per_user = counts * times
        total = int(rows_per_user.sum())
        block_off = np.concatenate([[0], np.cumsum(rows_per_user)])[:-1]
        within = np.arange(total) - np.repeat(block_off, rows_per_user)
        cnt_rows = np.repeat(counts, rows_per_user)
        tiles = torch.from_numpy(np.repeat(lo - base, rows_per_user) + within % cnt_rows)
        items_all = tbl[self.iid_field].numpy()
        local = np.arange(j1 - j0, dtype=np.int64)
        skel = {
            "fields": {k: v[tiles] for k, v in tbl.interaction.items()},
            "labels": torch.from_numpy((within < cnt_rows).astype(np.float32)),
            "neg_mask": torch.from_numpy(within >= cnt_rows),
            "row_idx": np.repeat(local, rows_per_user),
            "positive_u": np.repeat(local, counts),
            # rows are uid-sorted: the batch's positives are the slice
            "positive_i": items_all.astype(np.int64),
        }
        # shared by every batch of this window: a write would corrupt the
        # later ones, so the numpy payloads are read-only (the tensors are
        # only ever replaced in the batch, never written)
        for k in ("row_idx", "positive_u", "positive_i"):
            skel[k].setflags(write=False)
        self._expand_cache[key] = skel
        return skel

    def _next_batch_data(self):
        if self.neg_spec.strategy != "by":
            cur_data = self._neg_sampling(self.dataset[self.pr : self.pr + self.step])
            self.pr += self.step
            return cur_data, None, None, None
        with tracing.span("dataloader.sampled_fetch") as sp:
            j0, j1 = self.pr, min(self.pr + self.step, len(self.segments))
            sp.set("users", j1 - j0)
            skel = self._skeleton(j0, j1)
            lo, hi = self.segments.lo[j0:j1], self.segments.hi[j0:j1]
            sample_num = self.neg_spec.sample_num
            # one sampler call per user, in user order (the numpy RNG stream)
            with tracing.span("sampler.draw") as draw:
                negs = [
                    self.sampler.sample_one_key(int(u), int(h - l) * sample_num)
                    for u, l, h in zip(self.segments.uid[j0:j1], lo, hi)
                ]
                if draw:
                    rows = int((hi - lo).sum()) * sample_num
                    draw.set("rows", rows)
                    tracing.count("sampler.rows_drawn", rows)
            fields = dict(skel["fields"])
            item_col = skel["fields"][self.iid_field].clone()
            item_col[skel["neg_mask"]] = torch.from_numpy(np.concatenate(negs)).to(item_col.dtype)
            fields[self.iid_field] = item_col
            out = Interaction(fields)
            out.update(Interaction({self.neg_spec.label_field: skel["labels"]}))
            if self.dataset.item_feat is not None:
                # item features of the rewritten negative ids
                out = self.dataset.join(out)
            self.pr += self.step
            return out, skel["row_idx"], skel["positive_u"], skel["positive_i"]


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


class UserDataLoader(AbstractDataLoader):
    """Every user id (PAD included) once per pass, shuffled by numpy's
    global generator, in batches of ``train_batch_size``."""

    def __init__(self, config, dataset, sampler, shuffle=False):
        if shuffle is False:
            shuffle = True
        self.uid_field = dataset.uid_field
        self.user_list = Interaction({self.uid_field: np.arange(dataset.user_num)})
        super().__init__(config, dataset, sampler, shuffle=shuffle)

    def _init_batch_size_and_step(self):
        self.step = self.config["train_batch_size"]
        self.set_batch_size(self.step)

    @property
    def pr_end(self):
        return len(self.user_list)

    def _shuffle(self):
        self.user_list.shuffle()

    def _next_batch_data(self):
        cur_data = self.user_list[self.pr : self.pr + self.step]
        self.pr += self.step
        return cur_data


class FOCFDataLoader(TrainDataLoader):
    """Item-grouped batches for FOCF's per-item group means.

    Rows are item-sorted and segmented once; each batch takes every row of
    freshly drawn random items (``np.random.permutation``) until at least
    ``step`` rows are gathered, so an item's group means always see all of
    its rows.
    """

    def __init__(self, config, dataset, sampler, shuffle=False):
        super().__init__(config, dataset, sampler, shuffle=False)
        dataset.sort(by=dataset.iid_field, ascending=True)
        self.item_segments = _UserSegments.from_sorted(
            np.asarray(dataset.inter_feat[dataset.iid_field])
        )

    @property
    def max_batch_rows(self):
        # a batch stops once >= step rows are taken: at worst step - 1 rows
        # plus one whole item group
        return self.step - 1 + int(self.item_segments.rows.max(initial=0))

    @property
    def pr_end(self):
        return len(self.dataset)

    def _shuffle(self):
        pass  # the item draw below is random per batch

    def _next_batch_data(self):
        seg = self.item_segments
        order = np.random.permutation(len(seg))
        taken = np.cumsum(seg.rows[order])
        n_groups = int(np.searchsorted(taken, self.step, side="left")) + 1
        chosen = order[:n_groups]
        index = np.concatenate([np.arange(seg.lo[g], seg.hi[g]) for g in chosen])
        cur_data = self._neg_sampling(self.dataset[index])
        self.pr += self.step
        return cur_data
