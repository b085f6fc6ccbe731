"""Plain PyTorch reference of retrieval over a whole catalog: the top k of
``users @ items.T`` with item 0 (PAD) never selected, ordered by score
(descending), and the exact score of any (user, item) pair. It imports
nothing of the measured program.

The products are taken in float32 with TF32 off, in blocks of items, over
the tables as stored (bfloat16 values are exact in float32). ``quantize``
rounds users and items to a lower type first: the control.
"""

from __future__ import annotations

import torch


def topk(users, items, k, block=262144, quantize=None):
    """(scores [B, k] float32, ids [B, k] int64) of the best k items a row."""
    def prep(t):
        if quantize is not None:
            t = t.to(quantize)
        return t.float()

    u = prep(users)
    best_s = torch.full((u.shape[0], k), float("-inf"), device=u.device)
    best_i = torch.zeros((u.shape[0], k), dtype=torch.int64, device=u.device)
    for start in range(0, items.shape[0], block):
        s = u @ prep(items[start:start + block]).T
        if start == 0:
            s[:, 0] = float("-inf")
        top_s, top_i = torch.topk(s, min(k, s.shape[1]), dim=1)
        cat_s = torch.cat([best_s, top_s], dim=1)
        cat_i = torch.cat([best_i, top_i + start], dim=1)
        best_s, order = torch.topk(cat_s, k, dim=1)
        best_i = torch.gather(cat_i, 1, order)
    return best_s, best_i


def exact_scores(users, items, ids):
    """float64 score of each (row, id) pair: ``ids`` [B, k]."""
    u = users.double()
    t = items[ids.long().reshape(-1)].double().reshape(ids.shape[0], ids.shape[1], -1)
    return torch.einsum("bd,bkd->bk", u, t)
