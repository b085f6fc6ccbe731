"""Negative sampling on the trainer's device.

Counterpart of ``recbole_fairrec_tpu/ops/neg_sampling.py``, in plain torch.
The used (user, item) pairs live on the device as a packed bitmap
(``[user_num, ceil(item_num / 32)]`` int32 words, one gather per query) or,
beyond the bitmap budget, as a sorted int64 key array (``user * item_num +
item``, membership by ``searchsorted``). Candidates are drawn from a
``torch.Generator`` on the same device, and rejection is a fixed number of
rounds: a sample takes the draw of the first round in which it does not
collide. The JAX package runs its rounds one after another (draw → keep
where still colliding → membership, a scan); here all rounds are drawn and
tested at once as ``[n_rounds, total]`` tensors and the first good round is
picked per sample, which is the same function of the draws in a dozen device
operations instead of ten per round.

With a per-round collision probability p = used / item_num, a sample still
collides after R rounds with probability p^R; such a sample keeps its last
draw (it is a valid item, just a seen one) rather than branching on data.
PAD item 0 is never drawn. The draws are torch's, so they cannot equal the
JAX package's threefry draws; the distribution and the exclusions are the
same.
"""

from __future__ import annotations

import numpy as np
import torch

# 64 MB of packed bits covers ~537 M (user, item) pairs
_BITMAP_BUDGET_BYTES = 64 * 1024 * 1024


def build_used_keys(user_ids, item_ids, item_num, device=None):
    """Sorted unique int64 keys ``user * item_num + item`` of the used pairs."""
    keys = np.asarray(user_ids, dtype=np.int64) * int(item_num) + np.asarray(
        item_ids, dtype=np.int64
    )
    return torch.from_numpy(np.unique(keys)).to(device)


def build_used_bitmap(user_ids, item_ids, user_num, item_num, device=None):
    """``[user_num, ceil(item_num / 32)]`` packed membership bits. The words
    are int32 (torch has few uint32 ops): bit b of a word is
    ``(word >> b) & 1``, which holds for bit 31 too."""
    words = (int(item_num) + 31) // 32
    bitmap = np.zeros((int(user_num), words), dtype=np.uint32)
    u = np.asarray(user_ids, dtype=np.int64)
    i = np.asarray(item_ids, dtype=np.int64)
    np.bitwise_or.at(bitmap, (u, i >> 5), np.uint32(1) << (i & 31).astype(np.uint32))
    return torch.from_numpy(bitmap.view(np.int32)).to(device)


def build_used_table(user_ids, item_ids, user_num, item_num, device=None):
    """Membership structure for the samplers: the packed bitmap when it fits
    the budget, else sorted keys. The samplers take either (2-D = bitmap,
    1-D = keys)."""
    words = (int(item_num) + 31) // 32
    if int(user_num) * words * 4 <= _BITMAP_BUDGET_BYTES:
        return build_used_bitmap(user_ids, item_ids, user_num, item_num, device)
    return build_used_keys(user_ids, item_ids, item_num, device)


def _is_used(used, item_num, users, items):
    """bool, shaped like ``items``: is (user, item) in ``used`` (bitmap or
    sorted keys). ``users`` broadcasts against ``items``."""
    if used.dim() == 2:
        words = used[users, items >> 5]
        return ((words >> (items & 31).to(torch.int32)) & 1).bool()
    if used.numel() == 0:
        return torch.zeros_like(items, dtype=torch.bool)
    keys = users * item_num + items
    pos = torch.searchsorted(used, keys).clamp_(max=used.numel() - 1)
    return used[pos] == keys


def _first_good_round(draws, bad):
    """``draws``, ``bad``: [n_rounds, total]. Per sample the draw of the
    first round that is not bad; the last round's draw where every round is."""
    good = ~bad
    first = good.to(torch.uint8).argmax(dim=0)  # the first maximum
    pick = torch.where(good.any(dim=0), first, draws.shape[0] - 1)
    return draws.gather(0, pick[None]).squeeze(0)


def sample_negatives(generator, user_ids, used, item_num, num_neg=1, n_rounds=16):
    """Uniform negatives excluding used pairs, strided: ``out[i + k * B]`` is
    the k-th negative of user i.

    Args:
        generator: ``torch.Generator`` on ``user_ids``' device.
        user_ids: [B] integer tensor.
        used: membership structure from :func:`build_used_table`.
        item_num: catalog size (PAD = 0 is never drawn).
        num_neg: negatives per user.
        n_rounds: resample rounds.

    Returns:
        [B * num_neg] int64 item ids on ``user_ids``' device.
    """
    tiled_users = user_ids.long().repeat(num_neg)
    draws = torch.randint(1, item_num, (n_rounds, tiled_users.shape[0]),
                          generator=generator, device=user_ids.device)
    return _first_good_round(draws, _is_used(used, item_num, tiled_users[None], draws))


def sample_negatives_repeatable(generator, pos_item_ids, item_num, num_neg=1, n_rounds=16):
    """Repeatable-sampler semantics: exclude only the paired positive."""
    tiled_pos = pos_item_ids.long().repeat(num_neg)
    draws = torch.randint(1, item_num, (n_rounds, tiled_pos.shape[0]),
                          generator=generator, device=pos_item_ids.device)
    return _first_good_round(draws, draws == tiled_pos[None])


def sample_negatives_popularity(generator, user_ids, used, alias_prob, alias_idx,
                                alias_values, item_num, num_neg=1, n_rounds=16):
    """Popularity-biased negatives through an alias table on the device
    (``sampler.AliasTable``'s ``prob``, ``alias`` and ``values`` as tensors):
    draw a slot, flip the alias coin, reject used pairs. ``item_num`` must be
    the stride the used table was built with."""
    device = user_ids.device
    tiled_users = user_ids.long().repeat(num_neg)
    shape = (n_rounds, tiled_users.shape[0])
    slots = torch.randint(0, alias_prob.shape[0], shape, generator=generator, device=device)
    coins = torch.rand(shape, generator=generator, device=device, dtype=alias_prob.dtype)
    chosen = torch.where(coins < alias_prob[slots], slots, alias_idx[slots])
    draws = alias_values[chosen].long()
    return _first_good_round(draws, _is_used(used, item_num, tiled_users[None], draws))
