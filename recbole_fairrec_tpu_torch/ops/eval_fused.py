"""Device evaluation steps (plain PyTorch).

Counterpart of ``recbole_fairrec_tpu/ops/eval_fused.py`` (XLA there, not
Pallas): ``full_sort_eval_step`` masks PAD and history in a dense score
matrix, ``sampled_topk_from_scores`` scatters the scores of sampled
candidates into one; both take the top-k where the matrix lives, and only
the O(B·k) payload leaves the device:

* ``rec.topk``  — top-k positive-hit matrix ⧺ per-user positive count;
* ``rec.items`` — top-k item ids;
* ``rec.positive_score`` — scores gathered at the positive pairs.

Ties rank the lowest item index first (a stable descending sort, then the
first k columns), as ``lax.top_k`` does; ``torch.topk`` promises no tie
order, and ties are common here (FOCF's clamp, saturated sigmoids, rows that
are mostly −inf).
"""

from __future__ import annotations

import torch


def full_sort_eval_step(scores, pos_u, pos_i, pos_w, hist_u, hist_i, top_k):
    """Masked full-sort top-k from a [B, I] score matrix.

    Args:
        scores: [B, I] model scores (PAD column included).
        pos_u, pos_i: padded positive pair indices; pos_w 1/0 validity.
        hist_u, hist_i: padded history pairs (pads → (0, 0), harmless since
            column 0 is force-masked).
        top_k: k.

    Returns:
        (topk_idx [B,k], rec_topk [B,k+1], pos_score [P]).
    """
    scores = scores.clone()
    # the fill value lives on the scores' device: a Python float given to
    # an indexed assignment is copied to the card with a wait for it
    neg_inf = torch.full((), float("-inf"), dtype=scores.dtype, device=scores.device)
    scores[:, 0] = neg_inf
    scores.index_put_((hist_u, hist_i), neg_inf)
    return _ranked(scores, pos_u, pos_i, pos_w, top_k)


def _ranked(scores, pos_u, pos_i, pos_w, top_k):
    """The payload of a masked [B, I] score matrix; ties go to the lowest
    item index (stable descending sort)."""
    pos_matrix = torch.zeros(scores.shape, dtype=torch.int32, device=scores.device)
    pos_matrix.index_put_((pos_u, pos_i), pos_w.to(torch.int32), accumulate=True)
    topk_idx = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :top_k]
    pos_len = pos_matrix.sum(dim=1, keepdim=True)
    pos_hit = torch.gather(pos_matrix, 1, topk_idx)
    rec_topk = torch.cat([pos_hit, pos_len], dim=1)
    pos_score = scores[pos_u, pos_i]
    return topk_idx, rec_topk, pos_score


def sampled_topk_from_scores(origin_scores, row_idx, col_idx, valid, pos_u, pos_i, pos_w,
                             n_users, n_items, top_k):
    """Top-k of sampled evaluation (uni100 / pop100): the candidates' scores
    scattered into a ``[n_users + 1, n_items]`` −inf matrix (row ``n_users``
    takes the rows whose ``valid`` is 0), the positive pairs counted, then
    ranked as in :func:`full_sort_eval_step`.

    Args:
        origin_scores: [R] model scores of the candidate rows.
        row_idx, col_idx: [R] batch-local user slot and item id of each row;
            valid: [R] 1/0.
        pos_u, pos_i: positive pairs; pos_w 1/0 validity.
        n_users, n_items, top_k: the matrix's size and k.

    Returns:
        (topk_idx [n_users, k], rec_topk [n_users, k+1], pos_score [P]).
    """
    scores = torch.full((n_users + 1, n_items), float("-inf"), dtype=origin_scores.dtype,
                        device=origin_scores.device)
    safe_rows = torch.where(valid > 0, row_idx, torch.full_like(row_idx, n_users))
    scores[safe_rows, col_idx] = origin_scores
    return _ranked(scores[:n_users], pos_u, pos_i, pos_w, top_k)


# the JAX package's name for the jitted form; nothing to compile here
sampled_eval_step = sampled_topk_from_scores
