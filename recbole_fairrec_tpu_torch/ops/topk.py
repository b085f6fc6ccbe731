"""Full-catalog top-k: streaming (plain PyTorch) and the approximate /
certified entry points.

Counterpart of ``recbole_fairrec_tpu/ops/topk.py``. ``streaming_topk_scores``:
item tiles are scored one at a time and merged into a running ``[B, k]``
top-k, so peak memory is O(B·(tile + k)) instead of O(B·|I|).

Ordering: (score descending, item index ascending). ``lax.top_k`` breaks ties
toward the lowest index and ``torch.topk`` promises no order, so the merge
is a stable descending sort of [running ⧺ tile] — the running entries carry
lower indices than the tile's and come first, hence ties keep index order.

``approx_topk_scores`` / ``certified_topk_scores`` keep the JAX package's
signatures and return contract. There they run the TPU PartialReduce op
(``jax.lax.approx_max_k``) and certify each row; Hopper has no such op, so
the port's selection is exact: the hand-written kernel
(``ops.fused_topk.fused_topk_scores``) on a CUDA tensor, the plain
``streaming_topk_scores`` on the CPU, and every row comes back certified.

Tables and users may be float32, bfloat16 or float16, in any pairing (the
JAX package's serving storage at catalog scale is a bfloat16 table): scores
are float32 sums of the exact products of the widened values, on the card
and on the CPU alike.
"""

from __future__ import annotations

import torch

from ..utils import tracing


def streaming_topk_scores(user_emb, item_table, top_k, tile=4096, mask_pad=False,
                          col_offset=0):
    """Top-k of ``user_emb @ item_table.T`` without materializing all scores.

    Args:
        user_emb: [B, d] float32, bfloat16 or float16.
        item_table: [I, d] float32, bfloat16 or float16 (each tile widened
            to float32).
        top_k: k.
        tile: item-tile width.
        mask_pad: exclude the [PAD] item (row 0).
        col_offset: added to every item index (the table is rows
            ``[col_offset, col_offset + I)`` of a larger one).

    Returns:
        (topk_scores [B, k] float32, topk_idx [B, k] int32). Slots beyond the
        number of items hold (−inf, 0).
    """
    with _select_span(user_emb, item_table, top_k):
        return _streaming_topk(user_emb, item_table, top_k, tile, mask_pad, col_offset)


def _select_span(user_emb, item_table, top_k):
    """The span ``topk.select`` of one call of an entry point."""
    sp = tracing.span("topk.select")
    if sp:
        sp.set("rows", user_emb.shape[0])
        sp.set("items", item_table.shape[0])
        sp.set("k", top_k)
    return sp


def _streaming_topk(user_emb, item_table, top_k, tile, mask_pad, col_offset):
    B = user_emb.shape[0]
    I = item_table.shape[0]
    device = user_emb.device
    best_s = torch.full((B, top_k), float("-inf"), dtype=torch.float32, device=device)
    best_i = torch.zeros((B, top_k), dtype=torch.int64, device=device)
    for col0 in range(0, I, tile):
        block = item_table[col0 : col0 + tile]
        scores = (user_emb.float() @ block.float().T).to(torch.float32)
        idx = torch.arange(col0, col0 + block.shape[0], device=device) + col_offset
        if mask_pad and col0 == 0:
            scores[:, 0] = float("-inf")
        cat_s = torch.cat([best_s, scores], dim=1)
        cat_i = torch.cat([best_i, idx.expand(B, -1)], dim=1)
        order = torch.sort(cat_s, dim=1, descending=True, stable=True).indices[:, :top_k]
        best_s = torch.gather(cat_s, 1, order)
        best_i = torch.gather(cat_i, 1, order)
    return best_s, best_i.to(torch.int32)


def _exact_topk(user_emb, item_table, top_k, tile=4096):
    """Top-k of ``user_emb @ item_table.T`` with PAD (item 0) never
    selected: the fused kernel on a CUDA tensor (it raises outside its
    limits; there is no plain path on the card; a bfloat16 or float16 table
    is read as it is, with no float32 copy), the plain streaming top-k on
    the CPU."""
    if user_emb.device.type == "cuda":
        from .fused_topk import fused_topk_scores

        return fused_topk_scores(user_emb.contiguous(), item_table.contiguous(), top_k)
    return _streaming_topk(user_emb, item_table, top_k, tile, True, 0)


def approx_topk_scores(user_emb, item_table, top_k, recall_target=0.95, verify=False):
    """Top-k of ``user_emb @ item_table.T``, PAD masked, with the JAX
    package's contract: ``(scores [B, k], idx [B, k] int32)``, and with
    ``verify`` a third output, ``certified [B]`` bool (True: the row's
    candidates are an exact top-k set, up to ties at the k-th score).

    The selection is exact (see the module doc), so ``recall_target`` is
    met trivially (recall 1.0) and every row is certified."""
    with _select_span(user_emb, item_table, top_k):
        vals, idx = _exact_topk(user_emb, item_table, top_k)
    if not verify:
        return vals, idx
    return vals, idx, torch.ones(vals.shape[0], dtype=torch.bool, device=vals.device)


def certified_topk_scores(user_emb, item_table, top_k, recall_target=0.95, tile=4096):
    """Exact top-k, ``(scores [B, k], idx [B, k] int32)``, PAD never
    selected. In the JAX package: the approximate top-k, its certificate
    and an exact rescue of the uncertified rows; here every row is
    certified by the exact selection, so no rescue runs. ``tile`` is the
    CPU path's item tile."""
    with _select_span(user_emb, item_table, top_k):
        return _exact_topk(user_emb, item_table, top_k, tile=tile)
