"""Evaluator helpers (counterpart of ``recbole_fairrec_tpu/evaluator/utils.py``).
"""

from __future__ import annotations

import numpy as np


def _binary_clf_curve(trues, preds):
    """Cumulative (false positives, true positives) along descending score
    order — the sklearn-style curve the AUC metric integrates."""
    trues = trues == 1
    desc_idxs = np.argsort(preds, kind="mergesort")[::-1]
    preds = preds[desc_idxs]
    trues = trues[desc_idxs]

    distinct_value_idxs = np.where(np.diff(preds))[0]
    threshold_idxs = np.r_[distinct_value_idxs, trues.size - 1]

    tps = np.cumsum(trues)[threshold_idxs]
    fps = 1 + threshold_idxs - tps
    return fps, tps


def pad_sequence(sequences, len_list, pad_to=None, padding_value=0.0):
    """Right-pad a flat array of concatenated sequences into a 2-D matrix."""
    max_len = pad_to or max(len_list)
    out = np.full((len(len_list), max_len), padding_value)
    offset = 0
    for i, n in enumerate(len_list):
        out[i, :n] = sequences[offset : offset + n]
        offset += n
    return out


def trunc(scores, method):
    """Round ``scores`` with the given numpy rounding method name."""
    try:
        cut_method = getattr(np, method)
    except AttributeError:
        raise NotImplementedError(f"module 'numpy' has no function named '{method}'")
    return cut_method(scores)
