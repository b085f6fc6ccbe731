"""Full-catalogue top-k with the item table split over the model axis.

Counterpart of ``recbole_fairrec_tpu/parallel/eval.py``. Each rank scores
its item shard and keeps a local top-k (:func:`local_candidates`), the
ranks' candidates are all-gathered over the model group, and
:func:`merge_candidates` re-ranks them: O(B·k·S) merge traffic instead of
O(B·|I|) scores. The two stages hold no collective, so one process can run
S shards (``chip_smoke.py`` does).

The local stage of a CUDA tensor is the fused score + top-k kernel in its
shard mode (``ops.fused_topk``: indices offset by the shard's first row,
the PAD mask off); the JAX package scores a shard with ``jnp.dot`` and
``lax.top_k``, which is the function the kernel computes. A CPU tensor
takes the plain version. There is no fallback from the one to the other.

Order and sentinels follow the JAX contract: (score descending, index
ascending); a shard slot past its real candidates holds −inf with the index
``lax.top_k`` gives it (the lowest −inf columns in order); a merged slot
past every candidate holds −inf with the index ``n_shards ·
rows_per_shard``. PAD is not masked: the trainer filters ``cand_i == 0``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _neg_inf_columns(neg, count):
    """For each row of the bool ``[B, n]`` mask ``neg``, its first ``count``
    True columns in ascending order (ties of −inf, as a stable sort ranks
    them)."""
    order = torch.sort((~neg).to(torch.int8), dim=1, stable=True).indices
    return order[:, :count]


def local_candidates(user_emb, shard, top_k, col0=0, valid_rows=None, mask_cols=None):
    """The ``min(top_k, rows)`` best columns of ``user_emb @ shard.T`` per
    row, as GLOBAL indices (``col0`` + column), through ``fused_topk`` in its
    shard mode (the kernel on a CUDA tensor, its plain version on the CPU).
    ``valid_rows``: global row count of the real table; later rows score
    −inf. ``mask_cols``: bool ``[B, rows]``, True columns score −inf (the
    kernel then takes as many more candidates as a row has masked columns,
    a host read)."""
    from ..ops.fused_topk import fused_topk_scores

    rows = shard.shape[0]
    B = user_emb.shape[0]
    local_k = min(top_k, rows)
    n_real = rows if valid_rows is None else max(0, min(rows, valid_rows - col0))
    device = user_emb.device
    extra = 0
    if mask_cols is not None and n_real:
        extra = int(mask_cols[:, :n_real].sum(dim=1).max())
    k_ext = min(local_k + extra, n_real)
    if k_ext > 0:
        s, i = fused_topk_scores(user_emb.contiguous(), shard[:n_real].contiguous(), k_ext,
                                 col_offset=col0, mask_pad=False)
        i = i.long()
        if mask_cols is not None:
            hit = torch.gather(mask_cols, 1, i - col0)
            s = s.masked_fill(hit, float("-inf"))
            order = torch.sort(s, dim=1, descending=True, stable=True).indices
            s, i = torch.gather(s, 1, order), torch.gather(i, 1, order)
    else:
        s = torch.empty((B, 0), dtype=torch.float32, device=device)
        i = torch.empty((B, 0), dtype=torch.long, device=device)
    if s.shape[1] < local_k:
        pad = local_k - s.shape[1]
        s = torch.cat([s, s.new_full((B, pad), float("-inf"))], dim=1)
        i = torch.cat([i, i.new_zeros((B, pad))], dim=1)
    s, i = s[:, :local_k], i[:, :local_k]
    if mask_cols is None:
        # only the slots past the real rows are −inf: their columns, in order
        if n_real < local_k:
            i[:, n_real:] = torch.arange(col0 + n_real, col0 + local_k, device=device)
    else:
        fill = torch.isneginf(s)
        neg = mask_cols.clone()
        neg[:, n_real:] = True
        cols = _neg_inf_columns(neg, local_k) + col0
        slot = torch.arange(local_k, device=device)[None, :] - (~fill).sum(dim=1, keepdim=True)
        i = torch.where(fill, torch.gather(cols, 1, slot.clamp_min(0)), i)
    return s, i.to(torch.int32)


def merge_candidates(scores_list, idx_list, top_k, sentinel):
    """The ``top_k`` best of the shards' candidates (lists in shard order),
    ties to the lower position as ``lax.top_k`` breaks them; slots past
    every candidate hold (−inf, ``sentinel``)."""
    s = torch.cat(list(scores_list), dim=1)
    i = torch.cat([x.to(torch.int32) for x in idx_list], dim=1)
    if s.shape[1] < top_k:
        pad = top_k - s.shape[1]
        s = torch.cat([s, s.new_full((s.shape[0], pad), float("-inf"))], dim=1)
        i = torch.cat([i, i.new_full((i.shape[0], pad), sentinel)], dim=1)
    order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :top_k]
    return torch.gather(s, 1, order), torch.gather(i, 1, order)


def distributed_topk_scores(mesh, user_emb, item_shard, top_k, axis="model", mask_cols=None,
                            valid_rows=None):
    """Top-k of ``user_emb @ item_table.T`` with the table's rows split over
    ``axis``.

    Args:
        mesh: a :class:`~.mesh.Mesh`.
        user_emb: [B, d], the same on every rank of the model group.
        item_shard: this rank's ``[rows_per_shard, d]`` rows of the table
            (the table padded to a multiple of the axis size, see
            :func:`pad_table_rows`).
        top_k: k.
        mask_cols: optional bool ``[B, rows_per_shard]``, this rank's
            columns of the forbidden-item mask.
        valid_rows: optional count of the table's real rows; padding rows
            score −inf.

    Returns:
        (scores [B, k] float32, idx [B, k] int32), global indices, the same
        on every rank of the group.
    """
    n_shards = mesh.shape[axis]
    rows = item_shard.shape[0]
    col0 = mesh.index(axis) * rows
    s, i = local_candidates(user_emb, item_shard, top_k, col0, valid_rows, mask_cols)
    group = mesh.group(axis)
    s_parts = [torch.empty_like(s) for _ in range(n_shards)]
    i_parts = [torch.empty_like(i) for _ in range(n_shards)]
    dist.all_gather(s_parts, s.contiguous(), group=group)
    dist.all_gather(i_parts, i.contiguous(), group=group)
    return merge_candidates(s_parts, i_parts, top_k, n_shards * rows)
