"""Atomic-file Dataset: TSV loading + ETL + split, in numpy.

Counterpart of ``recbole_fairrec_tpu/data/dataset.py`` with the same ETL
order:

    load → filter (nan ids, dup, value intervals, inter-by-user/item, k-core
    loop) → remap with [PAD]=0 → user/item feat reindex → fillna → threshold
    label → min-max normalize → preload weights

The JAX package holds the raw tables in pandas DataFrames; here they are
:class:`_Frame` objects, an ordered dict of numpy columns with boolean row
filtering. Token columns hold the original strings (object arrays, None for
a missing cell) until the remap, which numbers tokens in order of first
appearance, as ``pandas.factorize`` does, so every remapped id equals the
JAX package's. After ``build()`` the tables are :class:`Interaction` objects
of torch tensors.
"""

from __future__ import annotations

import copy as _copy
import os
import pickle
from collections import Counter
from logging import getLogger

import numpy as np
import scipy.sparse as sp
import torch

from ..utils import FeatureSource, FeatureType, ensure_dir, set_color
from .interaction import Interaction


def _isnull(col):
    """Missing-cell mask: None / NaN in object columns, NaN in float ones."""
    if col.dtype == object:
        return np.fromiter(
            (v is None or (isinstance(v, float) and v != v) for v in col),
            dtype=bool, count=len(col),
        )
    if np.issubdtype(col.dtype, np.floating):
        return np.isnan(col)
    return np.zeros(len(col), dtype=bool)


def factorize(values):
    """``pandas.factorize`` for a 1-D array: codes numbered in order of first
    appearance, -1 for a missing value; returns (codes, uniques).

    ``np.unique`` numbers values in sorted order; its first-occurrence
    indices, argsorted, give back the order of first appearance.
    """
    values = np.asarray(values)
    codes = np.full(len(values), -1, dtype=np.int64)
    valid = ~_isnull(values)
    if not valid.any():
        return codes, values[:0]
    present = values[valid]
    if present.dtype == object and all(isinstance(v, str) for v in present):
        # fixed-width unicode sorts in C; equality and order match str's
        present = present.astype(str)
    uniq, first, inverse = np.unique(present, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[order] = np.arange(len(uniq))
    codes[valid] = rank[inverse.reshape(-1)]
    return codes, uniq[order]


def _isin(values, test):
    """``np.isin`` that stays linear for token (object) columns, where numpy
    compares every element of ``values`` with every element of ``test``."""
    values, test = np.asarray(values), np.asarray(test)
    if values.dtype != object and test.dtype != object:
        return np.isin(values, test)
    members = set(test.tolist())
    return np.fromiter((v in members for v in values.tolist()), dtype=bool,
                       count=len(values))


class _Frame:
    """Ordered dict of equal-length numpy columns — the slice of the
    DataFrame API that the ETL uses."""

    def __init__(self, columns=None):
        self._cols = dict(columns or {})

    def __getitem__(self, name):
        return self._cols[name]

    def __setitem__(self, name, value):
        self._cols[name] = value

    def __contains__(self, name):
        return name in self._cols

    def __iter__(self):
        return iter(list(self._cols))

    def __len__(self):
        return len(next(iter(self._cols.values()))) if self._cols else 0

    @property
    def columns(self):
        return list(self._cols)

    @property
    def empty(self):
        return len(self) == 0

    def keep(self, mask):
        """Drop the rows where ``mask`` is False, in place."""
        mask = np.asarray(mask, dtype=bool)
        if not mask.all():
            self._cols = {k: v[mask] for k, v in self._cols.items()}

    def take(self, index):
        """Reorder/select rows by position, in place."""
        self._cols = {k: v[index] for k, v in self._cols.items()}

    def drop_column(self, name):
        self._cols.pop(name, None)


class Dataset:
    def __init__(self, config):
        self.config = config
        self.dataset_name = config["dataset"]
        self.logger = getLogger()
        self._from_scratch()

    # ------------------------------------------------------------------ load

    def _from_scratch(self):
        self._init_schema()
        self._bind_id_fields()
        self._load_atomic_files(self.dataset_name, self.dataset_path)
        self._init_alias()
        self._run_etl()

    def _init_schema(self):
        cfg = self.config
        self.dataset_path = cfg["data_path"]
        self.field2type, self.field2source = {}, {}
        self.field2id_token, self.field2token_id = {}, {}
        self.field2seqlen = cfg["seq_len"] or {}
        self.alias, self._preloaded_weight = {}, {}
        self.benchmark_filename_list = cfg["benchmark_filename"]

    def _bind_id_fields(self):
        cfg = self.config
        self.uid_field, self.iid_field = cfg["USER_ID_FIELD"], cfg["ITEM_ID_FIELD"]
        self.label_field, self.time_field = cfg["LABEL_FIELD"], cfg["TIME_FIELD"]
        if (self.uid_field is None) ^ (self.iid_field is None):
            raise ValueError(
                "USER_ID_FIELD and ITEM_ID_FIELD need to be set at the same time "
                "or not set at the same time."
            )

    def _load_atomic_files(self, token, dataset_path):
        if not os.path.exists(dataset_path):
            raise FileNotFoundError(
                f"dataset path [{dataset_path}] does not exist; automatic download "
                "is not available in this environment — place the atomic files there"
            )
        if self.benchmark_filename_list is None:
            self.inter_feat = self._load_feat(
                os.path.join(dataset_path, f"{token}.inter"), FeatureSource.INTERACTION
            )
            if self.inter_feat is None:
                raise ValueError(f"File {token}.inter not exist or empty.")
        else:
            parts, sizes = [], []
            for name in self.benchmark_filename_list:
                path = os.path.join(dataset_path, f"{token}.{name}.inter")
                if not os.path.isfile(path):
                    raise ValueError(f"File {path} not exist.")
                part = self._load_feat(path, FeatureSource.INTERACTION)
                parts.append(part)
                sizes.append(len(part))
            self.inter_feat = _Frame(
                {c: np.concatenate([p[c] for p in parts]) for c in parts[0].columns}
            )
            self.file_size_list = sizes
        self.user_feat = self._maybe_load(token, dataset_path, FeatureSource.USER, "user")
        self.item_feat = self._maybe_load(token, dataset_path, FeatureSource.ITEM, "item")
        if self.user_feat is not None and self.uid_field is None:
            raise ValueError("uid_field must be set when user_feat exists")
        if self.item_feat is not None and self.iid_field is None:
            raise ValueError("iid_field must be set when item_feat exists")
        self._load_extra_suffixes(token, dataset_path)

    def _maybe_load(self, token, dataset_path, source, suffix):
        path = os.path.join(dataset_path, f"{token}.{suffix}")
        if not os.path.isfile(path):
            return None
        feat = self._load_feat(path, source)
        if feat is None:
            self.logger.warning(f"No columns loaded from {path}")
        return feat

    def _load_extra_suffixes(self, token, dataset_path):
        if self.config["additional_feat_suffix"] is None:
            return
        for suf in self.config["additional_feat_suffix"]:
            if hasattr(self, f"{suf}_feat"):
                raise ValueError(f"{suf}_feat already exists.")
            path = os.path.join(dataset_path, f"{token}.{suf}")
            if not os.path.isfile(path):
                raise ValueError(f"Additional feature file [{path}] not found.")
            setattr(self, f"{suf}_feat", self._load_feat(path, suf))

    def _column_selection(self, source):
        if isinstance(source, FeatureSource):
            source = source.value
        load_cols = unload_cols = None
        if self.config["load_col"] is not None:
            if source not in self.config["load_col"]:
                load_cols = set()
            elif self.config["load_col"][source] == "*":
                load_cols = None
            else:
                load_cols = set(self.config["load_col"][source])
        if self.config["unload_col"] is not None and source in self.config["unload_col"]:
            unload_cols = set(self.config["unload_col"][source])
        if load_cols is not None and unload_cols is not None:
            raise ValueError(
                f"load_col [{load_cols}] and unload_col [{unload_cols}] "
                "can not be set the same time."
            )
        return load_cols, unload_cols

    def _load_feat(self, filepath, source):
        """Read a headered TSV into a :class:`_Frame`."""
        load_col, unload_col = self._column_selection(source)
        if load_col == set():
            return None

        sep = self.config["field_separator"]
        encoding = self.config["encoding"] or "utf-8"
        with open(filepath, "r", encoding=encoding) as f:
            head = f.readline().rstrip("\n").rstrip("\r")

        header_fields = head.split(sep)
        selected = []  # (bare field name, physical column, FeatureType)
        for pos, cell in enumerate(header_fields):
            field, ftype_str = cell.split(":")
            try:
                ftype = FeatureType(ftype_str)
            except ValueError:
                raise ValueError(f"Type {ftype_str} from field {field} is not supported.")
            skip = (load_col is not None and field not in load_col) or (
                unload_col is not None and field in unload_col
            )
            if skip:
                continue
            if isinstance(source, FeatureSource) or source != "link":
                self.field2type[field], self.field2source[field] = ftype, source
                if not ftype.value.endswith("seq"):
                    self.field2seqlen[field] = 1
            selected.append((field, pos, ftype))

        if not selected:
            self.logger.warning(f"No columns have been loaded from [{source}]")
            return None

        columns = [f for f, _, _ in selected]
        col_indices = [p for _, p, _ in selected]
        col_is_token = [ft != FeatureType.FLOAT for _, _, ft in selected]
        parsed = self._read_table(filepath, sep, encoding, selected, col_indices, col_is_token)
        df = _Frame(dict(zip(columns, parsed)))

        seq_sep = self.config["seq_separator"]
        for field in columns:
            ftype = self.field2type[field]
            if not ftype.value.endswith("seq"):
                continue
            raw = ["" if v is None else str(v) for v in df[field]]
            out = np.empty(len(raw), dtype=object)
            if ftype == FeatureType.TOKEN_SEQ:
                out[:] = [np.array(list(filter(None, v.split(seq_sep)))) for v in raw]
            else:
                out[:] = [np.array(list(map(float, filter(None, v.split(seq_sep)))))
                          for v in raw]
            df[field] = out
            self.field2seqlen[field] = max(map(len, out))
        return df

    def _read_table(self, filepath, sep, encoding, selected, col_indices, col_is_token):
        """Native single-pass reader when it applies, else the Python one.
        Both give the same columns."""
        from .fast_tsv import read_columns, read_columns_python

        use_native = (
            self.config["fast_io"] is not False
            and len(sep) == 1
            and (encoding or "utf-8").lower().replace("-", "") in ("utf8", "ascii")
            and not any(ft.value.endswith("seq") for _, _, ft in selected)
        )
        if use_native:
            parsed = read_columns(filepath, sep, col_indices, col_is_token)
            if parsed is not None:
                return parsed
        return read_columns_python(filepath, sep, col_indices, col_is_token, encoding)

    # ----------------------------------------------------------------- alias

    def _register_alias(self, alias_name, default_value):
        configured = self.config[f"alias_of_{alias_name}"] or []
        merged = np.array([f for f in default_value if f] + list(configured))
        _, first_pos = np.unique(merged, return_index=True)
        self.alias[alias_name] = merged[np.sort(first_pos)]  # appearance order

    def _init_alias(self):
        self._register_alias("user_id", [self.uid_field])
        self._register_alias("item_id", [self.iid_field])
        for n1, a1 in self.alias.items():
            for n2, a2 in self.alias.items():
                if n1 != n2 and len(np.intersect1d(a1, a2, assume_unique=True)):
                    raise ValueError(
                        f"alias_of_{n1} and alias_of_{n2} should not overlap."
                    )
        rest = self.token_like_fields
        for alias in self.alias.values():
            rest = np.setdiff1d(rest, alias, assume_unique=True)
        self._rest_fields = rest

    # ------------------------------------------------------------ processing

    def _run_etl(self):
        self.feat_name_list = list(self._collect_feat_names())
        if self.benchmark_filename_list is None:
            self._apply_filters()
        self._remap_all_ids()
        self._reindex_entity_feats()
        self._fill_nan()
        self._binarize_label()
        self._normalize()
        self._stage_preload_weights()

    def _collect_feat_names(self):
        candidates = ["inter_feat", "user_feat", "item_feat"] + [
            f"{suf}_feat" for suf in (self.config["additional_feat_suffix"] or [])
        ]
        return [n for n in candidates if getattr(self, n, None) is not None]

    def _apply_filters(self):
        self._drop_nan_ids()
        self._dedup_inters()
        self._apply_value_intervals()
        self._restrict_to_known_entities()
        self._kcore_filter()
        self._check_nonempty()

    def _drop_nan_ids(self):
        for field, name in zip([self.uid_field, self.iid_field], ["user", "item"]):
            feat = getattr(self, f"{name}_feat")
            if feat is not None:
                feat.keep(~_isnull(feat[field]))
            if field is not None:
                self.inter_feat.keep(~_isnull(self.inter_feat[field]))

    def _dedup_inters(self):
        keep = self.config["rm_dup_inter"]
        if keep is None:
            return
        if keep not in ("first", "last"):
            raise ValueError(f"rm_dup_inter [{keep}] should be 'first' or 'last'")
        feat = self.inter_feat
        if self.time_field in feat:
            feat.take(np.argsort(feat[self.time_field], kind="stable"))
        _, pair = np.unique(
            np.stack([factorize(feat[self.uid_field])[0],
                      factorize(feat[self.iid_field])[0]], axis=1),
            axis=0, return_inverse=True,
        )
        pair = pair.reshape(-1)
        n = len(pair)
        if keep == "first":
            _, pos = np.unique(pair, return_index=True)
        else:
            _, rpos = np.unique(pair[::-1], return_index=True)
            pos = n - 1 - rpos
        mask = np.zeros(n, dtype=bool)
        mask[pos] = True
        feat.keep(mask)

    @staticmethod
    def _parse_intervals_str(intervals_str):
        """Parse ``"(0,1];[3,4)"`` into endpoint tuples."""
        if intervals_str is None:
            return None
        endpoints = []
        for pair_str in str(intervals_str).split(";"):
            pair_str = pair_str.strip()
            lb, rb = pair_str[0], pair_str[-1]
            pair = pair_str[1:-1].split(",")
            if not (len(pair) == 2 and lb in "([" and rb in ")]"):
                continue
            endpoints.append((lb, float(pair[0]), float(pair[1]), rb))
        return endpoints

    @staticmethod
    def _within_intervals(num, intervals):
        result = None
        for lb, lo, hi, rb in intervals:
            ok = (num >= lo) if lb == "[" else (num > lo)
            ok &= (num <= hi) if rb == "]" else (num < hi)
            result = ok if result is None else (result | ok)
        return result if result is not None else True

    def _apply_value_intervals(self):
        val_intervals = self.config["val_interval"] or {}
        for field, interval in val_intervals.items():
            if field not in self.field2type:
                raise ValueError(f"Field [{field}] not defined in dataset.")
            if self.field2type[field] in (FeatureType.FLOAT, FeatureType.FLOAT_SEQ):
                parsed = self._parse_intervals_str(interval)
                for feat in self.field2feats(field):
                    feat.keep(self._within_intervals(feat[field], parsed))
            else:
                for feat in self.field2feats(field):
                    feat.keep(_isin(feat[field], np.asarray(interval, dtype=object)))

    def _restrict_to_known_entities(self):
        if self.config["filter_inter_by_user_or_item"] is not True:
            return
        keep = np.ones(len(self.inter_feat), dtype=bool)
        for feat, key in ((self.user_feat, self.uid_field),
                          (self.item_feat, self.iid_field)):
            if feat is not None:
                keep &= _isin(self.inter_feat[key], feat[key])
        self.inter_feat.keep(keep)

    def _kcore_filter(self):
        """Iterative k-core filtering."""
        if None in (self.uid_field, self.iid_field):
            return
        user_interval = self._parse_intervals_str(self.config["user_inter_num_interval"])
        item_interval = self._parse_intervals_str(self.config["item_inter_num_interval"])
        if user_interval is None and item_interval is None:
            return

        user_inter_num = (
            Counter(self.inter_feat[self.uid_field]) if user_interval else Counter()
        )
        item_inter_num = (
            Counter(self.inter_feat[self.iid_field]) if item_interval else Counter()
        )

        while True:
            ban_users = self._illegal_ids(
                self.uid_field, self.user_feat, user_inter_num, user_interval
            )
            ban_items = self._illegal_ids(
                self.iid_field, self.item_feat, item_inter_num, item_interval
            )
            if not ban_users and not ban_items:
                break
            ban_u = np.array(sorted(ban_users), dtype=object)
            ban_i = np.array(sorted(ban_items), dtype=object)
            if self.user_feat is not None:
                self.user_feat.keep(~_isin(self.user_feat[self.uid_field], ban_u))
            if self.item_feat is not None:
                self.item_feat.keep(~_isin(self.item_feat[self.iid_field], ban_i))

            u_col, i_col = (self.inter_feat[self.uid_field],
                            self.inter_feat[self.iid_field])
            dropped = _isin(u_col, ban_u) | _isin(i_col, ban_i)
            user_inter_num -= Counter(u_col[dropped])
            item_inter_num -= Counter(i_col[dropped])
            self.inter_feat.keep(~dropped)

    def _illegal_ids(self, field, feat, inter_num, interval):
        if interval is not None:
            ids = {i for i in inter_num if not self._within_intervals(inter_num[i], interval)}
        else:
            ids = set()
        if feat is not None:
            min_num = interval[0][1] if interval else -1
            for i in feat[field]:
                if inter_num[i] < min_num:
                    ids.add(i)
        return ids

    def _check_nonempty(self):
        for name in self.feat_name_list:
            if getattr(self, name).empty:
                raise ValueError(
                    "Some feat is empty, please check the filtering settings."
                )

    # ----------------------------------------------------------------- remap

    def _remap_all_ids(self):
        for alias in self.alias.values():
            self._factorize_remap(self._remap_targets(alias))
        for field in self._rest_fields:
            self._factorize_remap(self._remap_targets(np.array([field])))

    def _remap_targets(self, field_list):
        return [
            (feat, field, self.field2type[field])
            for field in field_list
            for feat in self.field2feats(field)
        ]

    def _factorize_remap(self, remap_list):
        """First-appearance remap with [PAD]=0 over every target column."""
        if not remap_list:
            return
        flat_chunks = []
        for feat, field, ftype in remap_list:
            col = feat[field]
            if ftype == FeatureType.TOKEN:
                flat_chunks.append(col)
            elif ftype == FeatureType.TOKEN_SEQ:
                flat_chunks.append(
                    np.concatenate(list(col)).astype(object) if len(feat)
                    else np.array([], dtype=object)
                )
        chunk_bounds = np.cumsum([len(c) for c in flat_chunks])[:-1]
        codes, vocab = factorize(np.concatenate(flat_chunks).astype(object))
        per_target = np.split(codes + 1, chunk_bounds)  # shift: [PAD] takes 0
        vocab = np.array(["[PAD]", *vocab])
        lookup = {tok: i for i, tok in enumerate(vocab)}

        for (feat, field, ftype), ids in zip(remap_list, per_target):
            self.field2id_token.setdefault(field, vocab)
            self.field2token_id.setdefault(field, lookup)
            if ftype == FeatureType.TOKEN:
                feat[field] = ids
            elif ftype == FeatureType.TOKEN_SEQ:
                row_bounds = np.cumsum([len(v) for v in feat[field]])[:-1]
                out = np.empty(len(feat), dtype=object)
                out[:] = np.split(ids, row_bounds) if len(feat) else []
                feat[field] = out

    def _reindex_entity_feats(self):
        """Reindex user/item feats over the full [0, num) id range: row r
        holds entity id r; ids without a row get missing values (token 0,
        float NaN, empty sequence) for ``_fill_nan`` to settle."""
        for attr, key, count in (("user_feat", self.uid_field, self.user_num),
                                 ("item_feat", self.iid_field, self.item_num)):
            feat = getattr(self, attr)
            if feat is None:
                continue
            ids = np.asarray(feat[key], dtype=np.int64)
            full = _Frame({key: np.arange(count, dtype=np.int64)})
            for field in feat:
                if field == key:
                    continue
                col = feat[field]
                ftype = self.field2type[field]
                if ftype == FeatureType.TOKEN:
                    out = np.zeros(count, dtype=np.int64)
                elif ftype == FeatureType.FLOAT:
                    out = np.full(count, np.nan, dtype=np.float64)
                else:
                    out = np.empty(count, dtype=object)
                    out[:] = [None] * count
                out[ids] = col
                full[field] = out
            setattr(self, attr, full)

    def _fill_nan(self):
        for name in self.feat_name_list:
            feat = getattr(self, name)
            for field in feat:
                ftype = self.field2type[field]
                col = feat[field]
                if ftype == FeatureType.TOKEN:
                    if col.dtype == object:
                        col = np.where(_isnull(col), 0, col).astype(np.int64)
                    feat[field] = col
                elif ftype == FeatureType.FLOAT:
                    col = np.asarray(col, dtype=np.float64)
                    missing = np.isnan(col)
                    if missing.any():
                        col = col.copy()
                        col[missing] = col[~missing].mean() if (~missing).any() else np.nan
                    feat[field] = col
                else:
                    dtype = np.int64 if ftype == FeatureType.TOKEN_SEQ else np.float64
                    out = np.empty(len(col), dtype=object)
                    out[:] = [np.array([], dtype=dtype) if (x is None or isinstance(x, float))
                              else x for x in col]
                    feat[field] = out

    def _binarize_label(self):
        threshold = self.config["threshold"]
        if threshold is None:
            return
        if len(threshold) != 1:
            raise ValueError("Threshold length should be 1.")
        self.set_field_property(
            self.label_field, FeatureType.FLOAT, FeatureSource.INTERACTION, 1
        )
        for field, value in threshold.items():
            if field not in self.inter_feat:
                raise ValueError(f"Field [{field}] not in inter_feat.")
            self.inter_feat[self.label_field] = (
                np.asarray(self.inter_feat[field], dtype=np.float64) >= value
            ).astype(np.int64)

    def _normalize(self):
        if self.config["normalize_field"] is not None and self.config["normalize_all"] is True:
            raise ValueError("normalize_field and normalize_all can't be set at the same time.")
        if self.config["normalize_field"]:
            fields = self.config["normalize_field"]
            for field in fields:
                if field not in self.field2type:
                    raise ValueError(f"Field [{field}] does not exist.")
        elif self.config["normalize_all"]:
            fields = self.float_like_fields
        else:
            return
        for field in fields:
            ftype = self.field2type[field]
            if ftype not in (FeatureType.FLOAT, FeatureType.FLOAT_SEQ):
                continue
            for feat in self.field2feats(field):
                if ftype == FeatureType.FLOAT:
                    arr = np.asarray(feat[field], dtype=np.float64)
                    mx, mn = arr.max(), arr.min()
                    feat[field] = np.ones_like(arr) if mx == mn else (arr - mn) / (mx - mn)
                else:
                    lens = [len(v) for v in feat[field]]
                    flat = np.concatenate(list(feat[field]))
                    mx, mn = flat.max(), flat.min()
                    normed = np.ones_like(flat) if mx == mn else (flat - mn) / (mx - mn)
                    out = np.empty(len(lens), dtype=object)
                    out[:] = np.split(normed, np.cumsum(lens)[:-1])
                    feat[field] = out

    def _stage_preload_weights(self):
        preload_fields = self.config["preload_weight"]
        if preload_fields is None:
            return
        for pid_field, pv_field in preload_fields.items():
            if pid_field not in self.field2source or pv_field not in self.field2source:
                raise ValueError(
                    f"Preload fields [{pid_field}/{pv_field}] must both exist."
                )
            value_ftype = self.field2type[pv_field]
            token_num = self.num(pid_field)
            feat = self.field2feats(pid_field)[0]
            if value_ftype == FeatureType.FLOAT:
                matrix = np.zeros(token_num)
                matrix[np.asarray(feat[pid_field])] = np.asarray(feat[pv_field])
            elif value_ftype == FeatureType.FLOAT_SEQ:
                max_len = self.field2seqlen[pv_field]
                matrix = np.zeros((token_num, max_len))
                for pid, prow in zip(np.asarray(feat[pid_field]), list(feat[pv_field])):
                    matrix[pid, : min(len(prow), max_len)] = prow[:max_len]
            else:
                continue
            self._preloaded_weight[pid_field] = matrix

    # ----------------------------------------------------------- field utils

    def field2feats(self, field):
        if field not in self.field2source:
            raise ValueError(f"Field [{field}] not defined in dataset.")
        source = self.field2source[field]
        entity_feat = {self.uid_field: self.user_feat,
                       self.iid_field: self.item_feat}.get(field)
        if field in (self.uid_field, self.iid_field):
            return ([self.inter_feat, entity_feat] if entity_feat is not None
                    else [self.inter_feat])
        src = source.value if isinstance(source, FeatureSource) else source
        return [getattr(self, "inter_feat" if src == "inter" else f"{src}_feat")]

    def fields(self, ftype=None, source=None):
        ftype = set(ftype) if ftype is not None else set(FeatureType)
        source = set(source) if source is not None else set(
            list(FeatureSource) + [s for s in self.field2source.values() if isinstance(s, str)]
        )
        return [f for f, ft in self.field2type.items()
                if ft in ftype and self.field2source[f] in source]

    @property
    def float_like_fields(self):
        return self.fields(ftype=[FeatureType.FLOAT, FeatureType.FLOAT_SEQ])

    @property
    def token_like_fields(self):
        return self.fields(ftype=[FeatureType.TOKEN, FeatureType.TOKEN_SEQ])

    def set_field_property(self, field, field_type, field_source, field_seqlen):
        meta = (field_type, field_source, field_seqlen)
        (self.field2type[field], self.field2source[field],
         self.field2seqlen[field]) = meta

    def copy_field_property(self, dest_field, source_field):
        self.set_field_property(
            dest_field, self.field2type[source_field],
            self.field2source[source_field], self.field2seqlen[source_field],
        )

    def num(self, field):
        ftype = self.field2type.get(field)
        if ftype is None:
            raise ValueError(f"Field [{field}] not defined in dataset.")
        token_like = ftype in (FeatureType.TOKEN, FeatureType.TOKEN_SEQ)
        return (len(self.field2id_token[field]) if token_like
                else self.field2seqlen[field])

    def token2id(self, field, tokens):
        if isinstance(tokens, str):
            try:
                return self.field2token_id[field][tokens]
            except KeyError:
                raise ValueError(f"token [{tokens}] is not existed in {field}")
        if isinstance(tokens, (list, np.ndarray)):
            return np.array([self.token2id(field, t) for t in tokens])
        raise TypeError(f"The type of tokens [{tokens}] is not supported")

    def id2token(self, field, ids):
        vocab = self.field2id_token[field]
        try:
            return vocab[ids]
        except IndexError:
            kind = ("a one-dimensional list-like of ids"
                    if isinstance(ids, (list, np.ndarray)) else "a valid id")
            raise ValueError(f"[{ids}] is not {kind}.")

    # -------------------------------------------------------------- counters

    def counter(self, field):
        return Counter(np.asarray(self.inter_feat[field]).tolist())

    user_counter = property(lambda self: self.counter(self.uid_field))
    item_counter = property(lambda self: self.counter(self.iid_field))
    user_num = property(lambda self: self.num(self.uid_field))
    item_num = property(lambda self: self.num(self.iid_field))
    inter_num = property(lambda self: len(self.inter_feat))
    sparsity = property(
        lambda self: 1.0 - self.inter_num / (self.user_num * self.item_num)
    )

    def _mean_group_size(self, field):
        ids = np.asarray(self.inter_feat[field])
        return len(ids) / max(len(np.unique(ids)), 1)

    avg_actions_of_users = property(
        lambda self: self._mean_group_size(self.uid_field)
    )
    avg_actions_of_items = property(
        lambda self: self._mean_group_size(self.iid_field)
    )

    # ------------------------------------------------------------- container

    def join(self, df: Interaction) -> Interaction:
        """Attach user/item features onto an interaction batch."""
        for feat, key in ((self.user_feat, self.uid_field),
                          (self.item_feat, self.iid_field)):
            if feat is not None and key in df:
                df.update(feat[df[key]])
        return df

    def __getitem__(self, index):
        df = self.inter_feat[index]
        return self.join(df) if isinstance(df, Interaction) else df

    def __len__(self):
        return len(self.inter_feat)

    def __repr__(self):
        return self.__str__()

    def __str__(self):
        info = [set_color(self.dataset_name, "pink")]
        if self.uid_field:
            info += [
                set_color("The number of users", "blue") + f": {self.user_num}",
                set_color("Average actions of users", "blue") + f": {self.avg_actions_of_users}",
            ]
        if self.iid_field:
            info += [
                set_color("The number of items", "blue") + f": {self.item_num}",
                set_color("Average actions of items", "blue") + f": {self.avg_actions_of_items}",
            ]
        info.append(set_color("The number of inters", "blue") + f": {self.inter_num}")
        if self.uid_field and self.iid_field:
            info.append(set_color("The sparsity of the dataset", "blue") + f": {self.sparsity * 100}%")
        return "\n".join(info)

    def copy(self, new_inter_feat) -> "Dataset":
        clone = _copy.copy(self)
        clone.inter_feat = new_inter_feat
        return clone

    # ----------------------------------------------------------------- build

    def _frame_to_interaction(self, data: _Frame) -> Interaction:
        new_data = {}
        for k in data.columns:
            value = data[k]
            ftype = self.field2type[k]
            if ftype == FeatureType.TOKEN:
                new_data[k] = np.asarray(value, dtype=np.int64)
            elif ftype == FeatureType.FLOAT:
                new_data[k] = np.asarray(value, dtype=np.float32)
            elif ftype == FeatureType.TOKEN_SEQ:
                new_data[k] = [np.asarray(d[: self.field2seqlen[k]], dtype=np.int64)
                               for d in value]
            elif ftype == FeatureType.FLOAT_SEQ:
                new_data[k] = [np.asarray(d[: self.field2seqlen[k]], dtype=np.float32)
                               for d in value]
        return Interaction(new_data)

    def _feats_to_interactions(self):
        for name in self.feat_name_list:
            table = getattr(self, name)
            if isinstance(table, _Frame):
                setattr(self, name, self._frame_to_interaction(table))

    def shuffle(self):
        self.inter_feat.shuffle()

    def sort(self, by, ascending=True):
        self.inter_feat.sort(by=by, ascending=ascending)

    @staticmethod
    def _rows_grouped_by(keys):
        """Row positions per key, groups in order of first appearance and
        rows ascending within each group."""
        keys = np.asarray(keys)
        if not len(keys):
            return []
        order = np.argsort(keys, kind="stable")
        sorted_keys = keys[order]
        starts = np.flatnonzero(np.r_[True, sorted_keys[1:] != sorted_keys[:-1]])
        groups = np.split(order, starts[1:])
        groups.sort(key=lambda g: g[0])
        return [g.tolist() for g in groups]

    @staticmethod
    def _calcu_split_ids(tot, ratios):
        """Per-group split sizes: first part takes the remainder, tiny tail
        ratios are bumped to 1 row."""
        sizes = [int(r * tot) for r in ratios]
        sizes[0] = tot - sum(sizes[1:])
        for back in range(1, len(ratios)):
            if sizes[0] <= 1:
                break
            if 0 < ratios[-back] * tot < 1:
                sizes[-back], sizes[0] = sizes[-back] + 1, sizes[0] - 1
        return list(np.cumsum(sizes)[:-1])

    def split_by_ratio(self, ratios, group_by=None):
        tot_ratio = sum(ratios)
        ratios = [r / tot_ratio for r in ratios]
        if group_by is None:
            tot_cnt = len(self)
            split_ids = self._calcu_split_ids(tot_cnt, ratios)
            next_index = [
                list(range(start, end))
                for start, end in zip([0] + split_ids, split_ids + [tot_cnt])
            ]
        else:
            grouped = self._rows_grouped_by(np.asarray(self.inter_feat[group_by]))
            next_index = [[] for _ in ratios]
            for group in grouped:
                tot_cnt = len(group)
                split_ids = self._calcu_split_ids(tot_cnt, ratios)
                for index, start, end in zip(next_index, [0] + split_ids, split_ids + [tot_cnt]):
                    index.extend(group[start:end])
        self._drop_unused_columns()
        return [self.copy(self.inter_feat[np.array(idx, dtype=np.int64)]) for idx in next_index]

    def _loo_split_indices(self, grouped_index, leave_one_num):
        parts = [[] for _ in range(leave_one_num + 1)]
        for rows in grouped_index:
            rows = list(rows)
            held_out = min(leave_one_num, len(rows) - 1)
            cut = len(rows) - held_out
            parts[0].extend(rows[:cut])
            for offset, row in enumerate(rows[cut:]):
                parts[offset - held_out].append(row)
        return parts

    def leave_one_out(self, group_by, leave_one_mode):
        if group_by is None:
            raise ValueError("leave one out strategy requires a group field")
        grouped = self._rows_grouped_by(np.asarray(self.inter_feat[group_by]))
        if leave_one_mode == "valid_and_test":
            next_index = self._loo_split_indices(grouped, 2)
        elif leave_one_mode == "valid_only":
            next_index = self._loo_split_indices(grouped, 1) + [[]]
        elif leave_one_mode == "test_only":
            idx = self._loo_split_indices(grouped, 1)
            next_index = [idx[0], [], idx[1]]
        else:
            raise NotImplementedError(f"leave_one_mode [{leave_one_mode}] not implemented.")
        self._drop_unused_columns()
        return [self.copy(self.inter_feat[np.array(i, dtype=np.int64)]) for i in next_index]

    def _drop_unused_columns(self):
        unused_col = self.config["unused_col"] or {}
        for feat_name, cols in unused_col.items():
            feat = getattr(self, f"{feat_name}_feat" if feat_name != "inter" else "inter_feat")
            for field in cols:
                if field in feat:
                    if isinstance(feat, Interaction):
                        feat.drop(column=field)
                    else:
                        feat.drop_column(field)

    def build(self):
        """Order → group → split per eval_args."""
        self._feats_to_interactions()

        if self.benchmark_filename_list is not None:
            ends = np.cumsum(self.file_size_list).tolist()
            return [
                self.copy(self.inter_feat[start:end])
                for start, end in zip([0, *ends[:-1]], ends)
            ]

        ordering = self.config["eval_args"]["order"]
        if ordering == "RO":
            self.shuffle()
        elif ordering == "TO":
            self.sort(by=self.time_field)
        else:
            raise NotImplementedError(f"ordering_method [{ordering}] not implemented.")

        split_args = self.config["eval_args"]["split"]
        if not isinstance(split_args, dict) or len(split_args) != 1:
            raise ValueError(f"split_args [{split_args}] should be a single-key dict.")
        split_mode = next(iter(split_args))
        group_by = self.config["eval_args"]["group_by"]
        if split_mode == "RS":
            if not isinstance(split_args["RS"], list):
                raise ValueError(
                    f'The value of "RS" [{split_args}] should be a list.'
                )
            if group_by is None or str(group_by).lower() == "none":
                return self.split_by_ratio(split_args["RS"], group_by=None)
            if group_by == "user":
                return self.split_by_ratio(split_args["RS"], group_by=self.uid_field)
            raise NotImplementedError(f"grouping method [{group_by}] not implemented.")
        if split_mode == "LS":
            return self.leave_one_out(self.uid_field, split_args["LS"])
        raise NotImplementedError(f"splitting_method [{split_mode}] not implemented.")

    # --------------------------------------------------------------- exports

    def get_user_feature(self) -> Interaction:
        if self.user_feat is None:
            return Interaction({self.uid_field: np.arange(self.user_num)})
        if isinstance(self.user_feat, _Frame):
            self.user_feat = self._frame_to_interaction(self.user_feat)
        return self.user_feat

    def get_item_feature(self) -> Interaction:
        if self.item_feat is None:
            return Interaction({self.iid_field: np.arange(self.item_num)})
        if isinstance(self.item_feat, _Frame):
            self.item_feat = self._frame_to_interaction(self.item_feat)
        return self.item_feat

    def get_preload_weight(self, field):
        if field not in self._preloaded_weight:
            raise ValueError(f"Field [{field}] not in preload_weight")
        return self._preloaded_weight[field]

    def inter_matrix(self, form="coo", value_field=None):
        """User×item sparse matrix of the current interactions."""
        if not self.uid_field or not self.iid_field:
            raise ValueError("dataset does not exist uid/iid, thus can not converted to sparse matrix.")
        uids = np.asarray(self.inter_feat[self.uid_field])
        iids = np.asarray(self.inter_feat[self.iid_field])
        if value_field is None:
            data = np.ones(len(uids), dtype=np.float32)
        else:
            if value_field not in self.inter_feat:
                raise ValueError(f"value_field [{value_field}] should be one of inter_feat's features.")
            data = np.asarray(self.inter_feat[value_field], dtype=np.float32)
        mat = sp.coo_matrix((data, (uids, iids)), shape=(self.user_num, self.item_num))
        if form == "coo":
            return mat
        if form == "csr":
            return mat.tocsr()
        raise NotImplementedError(f"sparse matrix format [{form}] has not been implemented.")

    def create_graph(self, source_field, target_field, form="edge_list",
                     value_field=None, feat=None):
        """Relation graph between two token fields: ``edge_list`` gives
        (src, tgt, values|None) numpy arrays, ``torch`` the same as tensors,
        ``coo`` a scipy COO matrix over the two fields' id spaces."""
        feat = self.inter_feat if feat is None else feat
        src = np.asarray(feat[source_field])
        tgt = np.asarray(feat[target_field])
        vals = None
        if value_field is not None:
            if value_field not in feat:
                raise ValueError(f"value_field [{value_field}] not in features")
            vals = np.asarray(feat[value_field], dtype=np.float32)
        if form == "edge_list":
            return src, tgt, vals
        if form == "torch":
            return (
                torch.from_numpy(src.copy()),
                torch.from_numpy(tgt.copy()),
                None if vals is None else torch.from_numpy(vals.copy()),
            )
        if form == "coo":
            data = np.ones(len(src), dtype=np.float32) if vals is None else vals

            def _dim(field, ids):
                if self.field2type.get(field) in (FeatureType.TOKEN, FeatureType.TOKEN_SEQ):
                    return self.num(field)
                return int(ids.max(initial=0)) + 1

            return sp.coo_matrix(
                (data, (src, tgt)),
                shape=(_dim(source_field, src), _dim(target_field, tgt)),
            )
        if form in ("dgl", "pyg"):
            raise NotImplementedError(
                f"graph form [{form}] is not supported; use form='edge_list' "
                "and construct the library object from the index arrays"
            )
        raise NotImplementedError(f"graph form [{form}] has not been implemented.")

    def inter_graph(self, form="edge_list", value_field=None):
        """User→item interaction graph."""
        return self.create_graph(self.uid_field, self.iid_field, form, value_field)

    def history_item_matrix(self, value_field=None):
        """Per-user padded history arrays (history, value, length)."""
        return self._padded_history("item", value_field)

    def history_user_matrix(self, value_field=None):
        return self._padded_history("user", value_field)

    def _padded_history(self, row, value_field=None):
        uids = np.asarray(self.inter_feat[self.uid_field])
        iids = np.asarray(self.inter_feat[self.iid_field])
        if value_field is None:
            values = np.ones(len(uids), dtype=np.float32)
        else:
            values = np.asarray(self.inter_feat[value_field], dtype=np.float32)
        if row == "item":
            row_ids, col_ids = uids, iids
            row_num = self.user_num
        else:
            row_ids, col_ids = iids, uids
            row_num = self.item_num
        history_len = np.bincount(row_ids, minlength=row_num).astype(np.int64)
        max_len = int(history_len.max()) if row_num else 0
        history = np.zeros((row_num, max_len), dtype=np.int64)
        history_value = np.zeros((row_num, max_len), dtype=np.float32)
        order = np.argsort(row_ids, kind="stable")
        seg_starts = np.concatenate([[0], np.cumsum(history_len)])[:-1]
        slots = np.arange(len(row_ids)) - seg_starts[row_ids[order]]
        history[row_ids[order], slots] = col_ids[order]
        history_value[row_ids[order], slots] = values[order]
        return history, history_value, history_len

    def save(self):
        save_dir = self.config["checkpoint_dir"]
        ensure_dir(save_dir)
        path = os.path.join(save_dir, f'{self.config["dataset"]}-Dataset-torch.pkl')
        with open(path, "wb") as f:
            pickle.dump(self, f)

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("logger", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.logger = getLogger()
