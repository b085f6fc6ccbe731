"""Offline inspection helpers.

Counterpart of ``recbole_fairrec_tpu/utils/case_study.py``:
``full_sort_scores(uid_series, trainer, test_data)`` returns every item's
score for the given users with [PAD] and each user's history masked to
−inf, and ``full_sort_topk`` ranks them. As in the JAX package they take the
trainer; the model scores on the trainer's device and the result comes back
to the host as float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.interaction import Interaction


def full_sort_scores(uid_series, trainer, test_data):
    """Masked all-item scores for each user id in ``uid_series``.

    Returns:
        np.ndarray [len(uid_series), n_items] float64
    """
    uid_series = np.asarray(uid_series)
    dataset = test_data.dataset
    input_interaction = dataset.join(Interaction({dataset.uid_field: uid_series}))
    history_item = test_data.history_items(uid_series)
    history_row = np.concatenate(
        [np.full(len(h), i, dtype=np.int64) for i, h in enumerate(history_item)]
    ) if len(history_item) else np.array([], dtype=np.int64)
    history_col = (
        np.concatenate(list(history_item)).astype(np.int64)
        if len(history_item)
        else np.array([], dtype=np.int64)
    )

    model = trainer.model
    model.eval()
    try:
        with torch.no_grad():
            scores = model.full_sort_predict(trainer._to_batch(input_interaction))
        scores = scores.reshape(-1, dataset.item_num).cpu().numpy()
    except NotImplementedError:
        trainer.tot_item_num = dataset.item_num
        trainer.item_tensor = dataset.get_item_feature()
        scores = trainer._predict_all_items_fallback(input_interaction)

    scores = np.asarray(scores, dtype=np.float64)
    scores[:, 0] = -np.inf
    if len(history_row):
        scores[history_row, history_col] = -np.inf
    return scores


def full_sort_topk(uid_series, trainer, test_data, k):
    """(topk_scores, topk_index) over the masked all-item scores."""
    scores = full_sort_scores(uid_series, trainer, test_data)
    part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
    part_scores = np.take_along_axis(scores, part, axis=1)
    order = np.argsort(-part_scores, axis=1, kind="stable")
    topk_index = np.take_along_axis(part, order, axis=1)
    topk_scores = np.take_along_axis(scores, topk_index, axis=1)
    return topk_scores, topk_index
