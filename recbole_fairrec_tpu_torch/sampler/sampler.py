"""Negative samplers (host numpy).

Counterpart of ``recbole_fairrec_tpu/sampler/sampler.py``: the same
rejection sampling against a sorted ``uid * item_num + iid`` key array (or a
packed bitmap of it), the same phase-aware used-id accumulation
(train ⊂ valid ⊂ test) and the same numpy draw order, so one numpy seed gives
the same negatives in both packages. ``SeqSampler`` (a negative for each
position of a sequence) and ``KGSampler`` (negative tail entities of a
knowledge graph) draw in the JAX package's order as well; no model of the
family uses them.
"""

from __future__ import annotations

import copy
import os

import numpy as np


class AliasTable:
    """O(1) sampling from a discrete distribution (Walker's alias method).

    Built once from item counts; matches the reference's prob/alias
    construction (:72-98).
    """

    def __init__(self, candidates: np.ndarray):
        values, counts = np.unique(candidates, return_counts=True)
        prob = counts / counts.sum()
        n = len(values)
        scaled = prob * n
        self.values = values
        self.prob = np.ones(n)
        self.alias = np.arange(n)

        small = [i for i in range(n) if scaled[i] < 1.0]
        large = [i for i in range(n) if scaled[i] > 1.0]
        scaled = scaled.copy()
        while small and large:
            s, l = small.pop(), large.pop()
            self.prob[s] = scaled[s]
            self.alias[s] = l
            scaled[l] = scaled[l] - (1.0 - scaled[s])
            if scaled[l] < 1.0:
                small.append(l)
            elif scaled[l] > 1.0:
                large.append(l)

    def sample(self, num: int) -> np.ndarray:
        idx = np.random.randint(0, len(self.values), num)
        coin = np.random.random(num)
        chosen = np.where(coin < self.prob[idx], idx, self.alias[idx])
        return self.values[chosen]


class AbstractSampler:
    def __init__(self, distribution: str):
        self.distribution = ""
        self.user_group_label = None
        self.item_group_label = None
        self.set_distribution(distribution)
        self.used_ids = self.get_used_ids()

    def set_distribution(self, distribution: str):
        self.distribution = distribution
        if distribution == "popularity":
            self._build_alias_table()

    def _build_alias_table(self):
        self._alias_table = AliasTable(np.asarray(self._get_candidates_list()))

    def _get_candidates_list(self):
        raise NotImplementedError

    def _uni_sampling(self, sample_num: int) -> np.ndarray:
        raise NotImplementedError

    def sampling(self, sample_num: int) -> np.ndarray:
        if self.distribution == "uniform":
            return self._uni_sampling(sample_num)
        if self.distribution == "popularity":
            return self._alias_table.sample(sample_num)
        raise NotImplementedError(
            f"The sampling distribution [{self.distribution}] is not implemented."
        )

    def get_used_ids(self):
        raise NotImplementedError

    # ------------------------------------------------------------ vectorized

    # key spaces up to this many BITS get a packed-bitmap membership table
    # (ml-1M: 6040×3706 ≈ 22 Mbit = 2.8 MB); larger spaces keep the sorted
    # searchsorted path. Capped at 2^28 bits = 32 MB of host RAM per phase
    # (one cached bitmap per train/valid/test phase, so 96 MB worst case) —
    # searchsorted is a perfectly good fallback above that. Override via the
    # RECBOLE_FAIRREC_TORCH_BITMAP_MAX_BITS env var for huge-RAM hosts.
    _BITMAP_MAX_BITS = int(
        os.environ.get("RECBOLE_FAIRREC_TORCH_BITMAP_MAX_BITS", 1 << 28)
    )

    @classmethod
    def _pack_used_bits(cls, keys: np.ndarray, total_bits: int):
        """Sorted uint64 key array → packed uint8 bitmap (None if too big)."""
        if total_bits > cls._BITMAP_MAX_BITS:
            return None
        bits = np.zeros((total_bits + 7) // 8, dtype=np.uint8)
        np.bitwise_or.at(
            bits,
            (keys >> np.uint64(3)).astype(np.int64),
            (np.uint8(1) << (keys & np.uint64(7)).astype(np.uint8)),
        )
        return bits

    def _probe_keys(self, keys: np.ndarray) -> np.ndarray:
        """Membership probe on packed ``key*stride+value`` uint64 keys; bit
        test against the packed bitmap when available (the hot cost of
        host-side uni100 eval sampling), else binary search."""
        bits = getattr(self, "_used_bits", None)
        if bits is not None:
            probe = bits[(keys >> np.uint64(3)).astype(np.int64)]
            return (probe >> (keys & np.uint64(7)).astype(np.uint8)) & np.uint8(1) != 0
        pos = np.searchsorted(self._used_keys, keys)
        pos = np.minimum(pos, len(self._used_keys) - 1) if len(self._used_keys) else pos
        if len(self._used_keys) == 0:
            return np.zeros(len(keys), dtype=bool)
        return self._used_keys[pos] == keys

    def _membership(self, key_ids: np.ndarray, value_ids: np.ndarray) -> np.ndarray:
        """True where (key, value) is in the used set. ``self._used_keys``
        must be a sorted uint64 array of ``key * stride + value``."""
        keys = key_ids.astype(np.uint64) * np.uint64(self._stride) + value_ids.astype(np.uint64)
        return self._probe_keys(keys)

    def _group_violation(self, key_ids: np.ndarray, value_ids: np.ndarray) -> np.ndarray:
        """Fairness group constraint: a negative is illegal when its group
        label conflicts with the user's (reference :185-190). Labels follow
        the reference convention: item label 2 (single-key path) or -1
        (multi-key path) means "unconstrained"."""
        if self.user_group_label is None:
            return np.zeros(len(key_ids), dtype=bool)
        u_lab = np.asarray(self.user_group_label)[key_ids]
        i_lab = np.asarray(self.item_group_label)[value_ids]
        bad = ((u_lab == 0) & (i_lab == 1)) | ((u_lab == 1) & (i_lab == 0)) | (i_lab == -1)
        return bad

    def _probe_int64(self, keys: np.ndarray) -> np.ndarray:
        """Membership probe with int64 keys (no uint64 temporaries) — the
        uni100 hot path makes ~3 probes per user and python/temporary
        overhead dominates the numpy work at that call granularity."""
        bits = getattr(self, "_used_bits", None)
        if bits is not None:
            return (bits[keys >> 3] >> (keys & 7)) & 1 != 0
        return self._probe_keys(keys.astype(np.uint64))

    def sample_one_key(self, key: int, total_num: int) -> np.ndarray:
        """Single-key fast path (uni100 eval: one call per user) — the
        packed key is a scalar offset; the draw sequence is IDENTICAL to
        ``sample_by_key_ids`` (same ``sampling()`` call sizes in the same
        order, pinned by tests/test_sampler.py), only the per-call python
        overhead differs. ``key*stride + value`` stays well inside int64
        (key, value < 2^31)."""
        if self.user_group_label is not None:
            return self.sample_by_key_ids(np.full(1, key), total_num)
        base = int(key) * self._stride
        value_ids = self.sampling(total_num)
        idx = np.nonzero(self._probe_int64(base + value_ids))[0]
        while len(idx):
            resampled = self.sampling(len(idx))
            value_ids[idx] = resampled
            idx = idx[self._probe_int64(base + resampled)]
        return value_ids.astype(np.int64, copy=False)

    def sample_by_key_ids(self, key_ids, num: int) -> np.ndarray:
        """Sample ``num`` value ids per key id, excluding used pairs.

        Output layout matches the reference (:145-197): strided so that
        ``out[i + k*len(key_ids)]`` is the k-th sample for ``key_ids[i]``.
        """
        key_ids = np.asarray(key_ids)
        key_num = len(key_ids)
        total_num = key_num * num
        if (
            self.user_group_label is None
            and key_num
            and (key_ids == key_ids[0]).all()
        ):
            return self.sample_one_key(int(key_ids[0]), total_num)
        tiled_keys = np.tile(key_ids, num)
        value_ids = self.sampling(total_num)
        bad = self._membership(tiled_keys, value_ids) | self._group_violation(
            tiled_keys, value_ids
        )
        while bad.any():
            idx = np.nonzero(bad)[0]
            resampled = self.sampling(len(idx))
            value_ids[idx] = resampled
            still_bad = self._membership(tiled_keys[idx], resampled) | self._group_violation(
                tiled_keys[idx], resampled
            )
            bad = np.zeros(total_num, dtype=bool)
            bad[idx[still_bad]] = True
        return value_ids.astype(np.int64)


class Sampler(AbstractSampler):
    """Phase-aware negative item sampler over (train, valid, test).

    used ids accumulate across phases so valid-phase negatives exclude train
    positives, and test-phase negatives exclude train+valid positives
    (reference :243-264).
    """

    def __init__(self, phases, datasets, distribution="uniform"):
        if not isinstance(phases, list):
            phases = [phases]
        if not isinstance(datasets, list):
            datasets = [datasets]
        if len(phases) != len(datasets):
            raise ValueError(
                f"Phases {phases} and datasets {datasets} should have the same length."
            )
        self.phases = phases
        self.datasets = datasets
        self.uid_field = datasets[0].uid_field
        self.iid_field = datasets[0].iid_field
        self.user_num = datasets[0].user_num
        self.item_num = datasets[0].item_num
        self._stride = self.item_num
        super().__init__(distribution=distribution)

    def _get_candidates_list(self):
        candidates = []
        for dataset in self.datasets:
            candidates.extend(np.asarray(dataset.inter_feat[self.iid_field]).tolist())
        return candidates

    def _uni_sampling(self, sample_num):
        return np.random.randint(1, self.item_num, sample_num)

    def get_used_ids(self):
        """Per-phase sorted key arrays; also checks the all-items-used guard
        (reference :257-263)."""
        used = {}
        cum_keys = np.array([], dtype=np.uint64)
        for phase, dataset in zip(self.phases, self.datasets):
            uids = np.asarray(dataset.inter_feat[self.uid_field], dtype=np.uint64)
            iids = np.asarray(dataset.inter_feat[self.iid_field], dtype=np.uint64)
            keys = uids * np.uint64(self.item_num) + iids
            cum_keys = np.unique(np.concatenate([cum_keys, keys]))
            used[phase] = cum_keys
        last = used[self.phases[-1]]
        if len(last):
            per_user = np.bincount(
                (last // np.uint64(self.item_num)).astype(np.int64), minlength=self.user_num
            )
            if (per_user + 1 >= self.item_num).any():
                raise ValueError(
                    "Some users have interacted with all items, which we can not "
                    "sample negative items for them. Please set "
                    "`user_inter_num_interval` to filter those users."
                )
        return used

    def set_phase(self, phase):
        if phase not in self.phases:
            raise ValueError(f"Phase [{phase}] not exist.")
        new_sampler = copy.copy(self)
        new_sampler.phase = phase
        new_sampler._used_keys = new_sampler.used_ids[phase]
        if not hasattr(self, "_used_bits_by_phase"):
            self._used_bits_by_phase = {}
        if phase not in self._used_bits_by_phase:
            self._used_bits_by_phase[phase] = self._pack_used_bits(
                new_sampler._used_keys, self.user_num * self.item_num
            )
        new_sampler._used_bits = self._used_bits_by_phase[phase]
        return new_sampler

    def sample_by_user_ids(self, user_ids, item_ids, num):
        try:
            return self.sample_by_key_ids(user_ids, num)
        except IndexError:
            for user_id in user_ids:
                if user_id < 0 or user_id >= self.user_num:
                    raise ValueError(f"user_id [{user_id}] not exist.")
            raise


class RepeatableSampler(AbstractSampler):
    """Excludes only the row's own positive item (reference :373-504)."""

    def __init__(self, phases, dataset, distribution="uniform"):
        if not isinstance(phases, list):
            phases = [phases]
        self.phases = phases
        self.dataset = dataset
        self.iid_field = dataset.iid_field
        self.user_num = dataset.user_num
        self.item_num = dataset.item_num
        self._stride = self.item_num
        super().__init__(distribution=distribution)

    def _get_candidates_list(self):
        return np.asarray(self.dataset.inter_feat[self.iid_field]).tolist()

    def _uni_sampling(self, sample_num):
        return np.random.randint(1, self.item_num, sample_num)

    def get_used_ids(self):
        return np.array([set() for _ in range(self.user_num)])

    # not key-ids based: exclusion is the paired positive, so the single-key
    # fast path does not apply (dataloader checks this attribute)
    sample_one_key = None

    def sample_by_user_ids(self, user_ids, item_ids, num):
        """Negatives must only differ from the paired positive."""
        user_ids = np.asarray(user_ids)
        item_ids = np.asarray(item_ids)
        total = len(user_ids) * num
        tiled_pos = np.tile(item_ids, num)
        value_ids = self.sampling(total)
        bad = value_ids == tiled_pos
        while bad.any():
            idx = np.nonzero(bad)[0]
            value_ids[idx] = self.sampling(len(idx))
            bad = np.zeros(total, dtype=bool)
            bad[idx[value_ids[idx] == tiled_pos[idx]]] = True
        return value_ids.astype(np.int64)

    def set_phase(self, phase):
        if phase not in self.phases:
            raise ValueError(f"Phase [{phase}] not exist.")
        new_sampler = copy.copy(self)
        new_sampler.phase = phase
        return new_sampler


class SeqSampler(AbstractSampler):
    """A negative for each position of a sequence, never equal to that
    position's item."""

    def __init__(self, dataset, distribution="uniform"):
        self.dataset = dataset
        self.iid_field = dataset.iid_field
        self.user_num = dataset.user_num
        self.item_num = dataset.item_num
        self._stride = self.item_num
        super().__init__(distribution=distribution)

    def _get_candidates_list(self):
        return np.asarray(self.dataset.inter_feat[self.iid_field]).tolist()

    def _uni_sampling(self, sample_num):
        return np.random.randint(1, self.item_num, sample_num)

    def get_used_ids(self):
        return np.array([set() for _ in range(self.user_num)])

    def sample_neg_sequence(self, pos_sequence):
        pos_sequence = np.asarray(pos_sequence)
        total = len(pos_sequence)
        value_ids = self.sampling(total)
        bad = value_ids == pos_sequence
        while bad.any():
            idx = np.nonzero(bad)[0]
            value_ids[idx] = self.sampling(len(idx))
            bad = np.zeros(total, dtype=bool)
            bad[idx[value_ids[idx] == pos_sequence[idx]]] = True
        return value_ids.astype(np.int64)


class KGSampler(AbstractSampler):
    """Negative tail entities for head entities of a knowledge graph: a
    drawn tail never forms a known (head, tail) triple."""

    def __init__(self, dataset, distribution="uniform"):
        self.dataset = dataset
        self.hid_field = dataset.head_entity_field
        self.tid_field = dataset.tail_entity_field
        self.hid_list = np.asarray(dataset.head_entities)
        self.tid_list = np.asarray(dataset.tail_entities)
        self.head_entities = set(dataset.head_entities)
        self.entity_num = dataset.entity_num
        self._stride = self.entity_num
        super().__init__(distribution=distribution)

    def _get_candidates_list(self):
        return list(self.hid_list) + list(self.tid_list)

    def _uni_sampling(self, sample_num):
        return np.random.randint(1, self.entity_num, sample_num)

    def get_used_ids(self):
        keys = self.hid_list.astype(np.uint64) * np.uint64(self.entity_num) + self.tid_list.astype(
            np.uint64
        )
        self._used_keys = np.unique(keys)
        return self._used_keys

    def sample_by_entity_ids(self, head_entity_ids, num=1):
        try:
            return self.sample_by_key_ids(np.asarray(head_entity_ids), num)
        except IndexError:
            for head_entity_id in head_entity_ids:
                if head_entity_id not in self.head_entities:
                    raise ValueError(f"head_entity_id [{head_entity_id}] not exist.")
            raise
