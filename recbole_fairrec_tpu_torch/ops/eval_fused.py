"""Dense full-sort evaluation step (plain PyTorch).

Counterpart of ``recbole_fairrec_tpu/ops/eval_fused.py::full_sort_eval_step``
(XLA there, not Pallas): PAD/history masking and top-k run where the score
matrix lives, and only the O(B·k) payload leaves the device:

* ``rec.topk``  — top-k positive-hit matrix ⧺ per-user positive count;
* ``rec.items`` — top-k item ids;
* ``rec.positive_score`` — scores gathered at the positive pairs.

Ties rank the lowest item index first (a stable descending sort), as
``lax.top_k`` does.
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
    scores[:, 0] = float("-inf")
    scores[hist_u, hist_i] = float("-inf")

    pos_matrix = torch.zeros(scores.shape, dtype=torch.int32, device=scores.device)
    pos_matrix.index_put_((pos_u, pos_i), pos_w.to(torch.int32), accumulate=True)

    topk_idx = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :top_k]
    pos_len = pos_matrix.sum(dim=1, keepdim=True)
    pos_hit = torch.gather(pos_matrix, 1, topk_idx)
    rec_topk = torch.cat([pos_hit, pos_len], dim=1)

    pos_score = scores[pos_u, pos_i]
    return topk_idx, rec_topk, pos_score
